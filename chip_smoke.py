#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one line:

  1. the device (torch and nvidia-smi name and power limit); build the CUDA
     kernels from `dynamicrafter_tpu_torch/csrc/` with nvcc;
  2. K1 (spatial flash attention) against its plain version at the 320x512
     shape (32, 2560, 5*64) bf16, a ragged L = 300 case, and fp32 checks;
  3. K2 (temporal attention) against its plain version at the five 320x512
     shapes (bf16) and one fp32 shape;
  4. one full-width UNet forward of configs/inference_512_v1.0.yaml on a
     batched-CFG input (2, 16, 40, 64, 8), bf16, N(0, 0.02) weights,
     through the kernels and through the plain versions, compared; counts
     the kernel launches of one UNet call;
  5. the slice end to end through `dynamicrafter_tpu_torch.inference.main`
     (the `python -m dynamicrafter_tpu_torch.inference` entry point):
     DDIM-50, eta 1, CFG 7.5 batched, guidance rescale 0.7, fs 24,
     per-frame decode, random N(0, 0.02) weights; checks the written frames
     and that both kernels ran on that path;
  6. K3 (flash forward with logsumexp) against its plain version at
     (32, 2560, 5*64) bf16, a ragged L = 300 case, and fp32;
  7. K4a and K4b (flash backward dq, dk/dv) against `flash_bwd_plain` at the
     same shapes; the gradients of the differentiable `flash_attention` and
     `small_t_attention_tmajor` against autograd of their plain versions;
  8. one full-width training forward and backward of
     configs/training_512_v1.0.yaml (batch 2 x 16 frames at 320x512, bf16
     autocast, fp32 trainable weights), through the kernels and through the
     plain versions on the same weights and draws: loss and flattened
     gradient compared, kernel launches per micro-step counted;
  9. the training slice end to end through `dynamicrafter_tpu_torch.train.main`
     (the `python -m dynamicrafter_tpu_torch.train` entry point): 4
     micro-steps at accumulation 2 from N(0, 0.02) weights on synthetic
     clips; checks finite losses, moved trainable and unmoved frozen
     weights, the checkpoint, and the kernel launches.

Then a JSON line with each kernel's launches (K1 and K2 on the phase-5 path,
K3, K4a and K4b on the phase-9 path), error and times, the nvidia-smi line,
and last `{"ok": true, "device": {...}}`.
Any failure raises, so the script exits nonzero; without a CUDA device it
exits 1 before printing any result. Float32 matmuls and convolutions run
without TF32 (both flags set False) in every comparison.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

CONFIG = "configs/inference_512_v1.0.yaml"
TRAIN_CONFIG = "configs/training_512_v1.0.yaml"
PROMPTS = "prompts/512"
STEPS = 50
TRAIN_STEPS = 4
SEED = 123
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(out, ref):
    d = (out.float() - ref.float())
    return d.abs().max().item(), (d.norm() / ref.float().norm()).item()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def counts(*wrappers) -> tuple:
    return tuple(w.launches for w in wrappers)


def reset(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dynamicrafter_tpu_torch import inference
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.models.blocks import SpatialTransformer
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.ops import attention, kernels
    from dynamicrafter_tpu_torch import train
    from dynamicrafter_tpu_torch.config import TrainingConfig
    from dynamicrafter_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd, flash_bwd_dkv, flash_bwd_dq, flash_bwd_plain, flash_fwd,
        flash_fwd_lse, flash_fwd_lse_plain, flash_fwd_plain)
    from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
    from dynamicrafter_tpu_torch.ops.small_attention import (
        small_t_attention_tmajor, small_t_fwd_tmajor, small_t_fwd_tmajor_plain)
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.training.trainer import TrainConfig, Trainer
    from dynamicrafter_tpu_torch.utils.weights import init_normal_
    phase_s = {}

    os.chdir(REPO)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]

    # -- phase 1: device and build --------------------------------------
    t_start = t0 = time.perf_counter()
    kernels.library()
    regs = [ln.split(":", 1)[1].strip() for ln in kernels.build_log.splitlines()
            if "Used" in ln]
    log(f"[1] device {kind!r} | nvidia-smi {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | allow_tf32 matmul=False cudnn=False | "
        f"kernels built in {time.perf_counter() - t0:.2f}s (nvcc "
        f"{kernels.build_seconds:.2f}s) | ptxas: {'; '.join(regs)}")
    phase_s["1"] = time.perf_counter() - t0

    report = {}

    # -- phase 2: K1 ------------------------------------------------------
    t0 = time.perf_counter()
    h1 = 5
    for n, l, dtype, tol in [(32, 2560, torch.bfloat16, 1e-2), (4, 300, torch.bfloat16, 1e-2),
                             (4, 2560, torch.float32, 1e-5), (4, 300, torch.float32, 1e-5)]:
        q, k, v = (torch.randn(n, l, h1 * 64, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        out = flash_fwd(q, k, v, h1, 0.125)
        ref = flash_fwd_plain(q.float(), k.float(), v.float(), h1, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: flash_fwd(q, k, v, h1, 0.125))
        plain_ms = cuda_ms(lambda: flash_fwd_plain(q, k, v, h1, 0.125))
        log(f"[2] K1 flash_fwd ({n}, {l}, {h1}*64) {str(dtype)[6:]}: max_abs {max_abs:.3e} "
            f"rel_l2 {rel:.3e} (tol {tol:g}) | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(rel <= tol, f"K1 rel L2 {rel} > {tol} at {(n, l, dtype)}")
        if (n, l, dtype) == (32, 2560, torch.bfloat16):
            report["flash_fwd"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        del q, k, v, out, ref

    phase_s["2"] = time.perf_counter() - t0

    # -- phase 3: K2 ------------------------------------------------------
    t0 = time.perf_counter()
    for g, h, dtype, tol in [(2560, 5, torch.bfloat16, 1e-2), (2560, 8, torch.bfloat16, 1e-2),
                             (640, 10, torch.bfloat16, 1e-2), (160, 20, torch.bfloat16, 1e-2),
                             (40, 20, torch.bfloat16, 1e-2), (2560, 5, torch.float32, 1e-5)]:
        q, k, v = (torch.randn(2, 16, g, h * 64, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        out = small_t_fwd_tmajor(q, k, v, h, 0.125)
        ref = small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: small_t_fwd_tmajor(q, k, v, h, 0.125), iters=50)
        plain_ms = cuda_ms(lambda: small_t_fwd_tmajor_plain(q, k, v, h, 0.125), iters=50)
        log(f"[3] K2 small_t_fwd_tmajor (2, 16, {g}, {h}*64) {str(dtype)[6:]}: max_abs "
            f"{max_abs:.3e} rel_l2 {rel:.3e} (tol {tol:g}) | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        check(rel <= tol, f"K2 rel L2 {rel} > {tol} at {(g, h, dtype)}")
        if (g, h, dtype) == (2560, 5, torch.bfloat16):
            report["small_t_fwd_tmajor"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        del q, k, v, out, ref

    phase_s["3"] = time.perf_counter() - t0

    # -- phase 4: full-width UNet forward, kernels vs plain ---------------
    t0 = time.perf_counter()
    cfg = ModelConfig.from_yaml(CONFIG)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(cfg.unet))
    unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
    init_normal_(unet.requires_grad_(False), gen, 0.02)
    x = torch.randn(2, 16, 40, 64, 8, device=dev, generator=gen)
    ts = torch.full((2,), 999, dtype=torch.long, device=dev)
    ctx_t = torch.randn(2, 77, 1024, device=dev, generator=gen)
    ctx_i = torch.randn(2, 16, 16, 1024, device=dev, generator=gen)
    fs = torch.full((2,), 24, dtype=torch.long, device=dev)
    run = lambda: unet(x, ts, context_text=ctx_t, context_img=ctx_i, fs=fs)
    with torch.no_grad():
        flash_fwd.launches = small_t_fwd_tmajor.launches = 0
        out = run()
        torch.cuda.synchronize()
        per_call = (flash_fwd.launches, small_t_fwd_tmajor.launches)
        with attention.use_backend("plain"):
            ref = run()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(run, iters=5, warmup=1)
        with attention.use_backend("plain"):
            plain_ms = cuda_ms(run, iters=5, warmup=1)
    n_params = sum(p.numel() for p in unet.parameters())
    log(f"[4] UNet forward (2, 16, 40, 64, 8) bf16, {n_params / 1e9:.3f} B params: "
        f"out {tuple(out.shape)} finite {bool(torch.isfinite(out).all())} std "
        f"{out.float().std().item():.3e} | kernels vs plain max_abs {max_abs:.3e} rel_l2 "
        f"{rel:.3e} (tol 2e-2) | launches per call K1 {per_call[0]} (the 5 level-0 "
        f"spatial transformers), K2 {per_call[1]} (17 temporal transformers x attn1 + "
        f"attn2, both self-attention over T) | {ms:.1f} ms with kernels, "
        f"{plain_ms:.1f} ms plain")
    check(bool(torch.isfinite(out).all()) and out.shape == (2, 16, 40, 64, 4), "UNet output")
    check(rel <= 2e-2, f"UNet kernels vs plain rel L2 {rel} > 2e-2")
    check(per_call == (5, 34), f"launches per UNet call {per_call} != (5, 34)")
    del unet, x, out, ref
    torch.cuda.empty_cache()
    phase_s["4"] = time.perf_counter() - t0

    # -- phase 5: the slice end to end -------------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as savedir:
        flash_fwd.launches = small_t_fwd_tmajor.launches = 0
        t0 = time.perf_counter()
        result = inference.main([
            "--config", CONFIG, "--prompt_dir", PROMPTS, "--savedir", savedir,
            "--random_init", "--bf16", "--height", "320", "--width", "512",
            "--frame_stride", "24", "--timestep_spacing", "uniform_trailing",
            "--guidance_rescale", "0.7", "--perframe_ae",
            "--unconditional_guidance_scale", "7.5", "--text_input",
            "--video_length", "16", "--ddim_steps", str(STEPS), "--ddim_eta", "1.0",
            "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = (flash_fwd.launches, small_t_fwd_tmajor.launches)
        frames = np.load(result["paths"][0])
        videos = result["videos"][0]
    peak = torch.cuda.max_memory_allocated(dev)
    stages = result["timings"][0]
    log(f"[5] slice 320x512 DDIM-{STEPS}: frames {frames.shape} {frames.dtype} "
        f"levels {len(np.unique(frames))} finite {bool(np.isfinite(videos).all())} | "
        + " ".join(f"{k} {v:.2f}s" for k, v in stages.items())
        + f" | {1e3 * stages['ddim'] / STEPS:.1f} ms/step | main() wall {wall:.1f}s | "
        f"peak allocated {peak / 2**30:.2f} GiB | launches K1 {launches[0]} K2 {launches[1]}")
    check(frames.shape == (16, 320, 512, 3) and frames.dtype == np.uint8, "frame file")
    check(bool(np.isfinite(videos).all()), "decoded frames are not finite")
    check(len(np.unique(frames)) > 1, "decoded frames are constant")
    check(launches == (per_call[0] * STEPS, per_call[1] * STEPS),
          f"launches on the slice {launches} != {per_call} x {STEPS} steps")
    del result, frames, videos
    phase_s["5"] = time.perf_counter() - t0

    # -- phase 6: K3 ------------------------------------------------------
    t0 = time.perf_counter()
    for n, l, dtype, tol in [(32, 2560, torch.bfloat16, 1e-2), (4, 300, torch.bfloat16, 1e-2),
                             (4, 2560, torch.float32, 1e-5), (4, 300, torch.float32, 1e-5)]:
        q, k, v = (torch.randn(n, l, h1 * 64, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        out, lse = flash_fwd_lse(q, k, v, h1, 0.125)
        ref, ref_lse = flash_fwd_lse_plain(q.float(), k.float(), v.float(), h1, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        ms = cuda_ms(lambda: flash_fwd_lse(q, k, v, h1, 0.125))
        plain_ms = cuda_ms(lambda: flash_fwd_lse_plain(q, k, v, h1, 0.125))
        log(f"[6] K3 flash_fwd_lse ({n}, {l}, {h1}*64) {str(dtype)[6:]}: o max_abs "
            f"{max_abs:.3e} rel_l2 {rel:.3e} (tol {tol:g}), lse max_abs {lse_err:.3e} "
            f"(tol 1e-3) | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(rel <= tol and lse_err <= 1e-3, f"K3 at {(n, l, dtype)}: o {rel}, lse {lse_err}")
        if (n, l, dtype) == (32, 2560, torch.bfloat16):
            report["flash_fwd_lse"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        del q, k, v, out, lse, ref, ref_lse
    phase_s["6"] = time.perf_counter() - t0

    # -- phase 7: K4a and K4b; the differentiable entries -------------------
    t0 = time.perf_counter()
    for n, l, dtype, tol in [(32, 2560, torch.bfloat16, 2e-2), (4, 300, torch.bfloat16, 2e-2),
                             (4, 2560, torch.float32, 1e-4), (4, 300, torch.float32, 1e-4)]:
        q, k, v, do = (torch.randn(n, l, h1 * 64, device=dev, generator=gen).to(dtype)
                       for _ in range(4))
        o, lse = flash_fwd_lse_plain(q.float(), k.float(), v.float(), h1, 0.125)
        refs = flash_bwd_plain(q.float(), k.float(), v.float(), o, lse, do.float(), h1, 0.125)
        o = o.to(dtype)
        grads = flash_bwd(q, k, v, o, lse, do, h1, 0.125)
        torch.cuda.synchronize()
        errs = [errors(g, r) for g, r in zip(grads, refs)]
        ms_dq = cuda_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, h1, 0.125))
        ms_dkv = cuda_ms(lambda: flash_bwd_dkv(q, k, v, o, lse, do, h1, 0.125))
        plain_ms = cuda_ms(lambda: flash_bwd_plain(q, k, v, o, lse, do, h1, 0.125))
        log(f"[7] K4 flash_bwd ({n}, {l}, {h1}*64) {str(dtype)[6:]}: "
            + ", ".join(f"{name} max_abs {a:.3e} rel_l2 {r:.3e}"
                        for name, (a, r) in zip(("dq", "dk", "dv"), errs))
            + f" (tol {tol:g}) | K4a {ms_dq:.3f} ms + K4b {ms_dkv:.3f} ms, plain "
            f"(dq, dk, dv together) {plain_ms:.3f} ms")
        check(all(r <= tol for _, r in errs), f"K4 at {(n, l, dtype)}: {errs}")
        if (n, l, dtype) == (32, 2560, torch.bfloat16):
            report["flash_bwd_dq"] = dict(max_abs_err=errs[0][0], ms=ms_dq, plain_ms=plain_ms)
            report["flash_bwd_dkv"] = dict(max_abs_err=max(errs[1][0], errs[2][0]),
                                           ms=ms_dkv, plain_ms=plain_ms)
        del q, k, v, do, o, lse, refs, grads

    def grad_check(fn, plain_fn, shape, what):
        xs = [torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
              for _ in range(3)]
        g_out = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        got = torch.autograd.grad(fn(*xs), xs, g_out)
        ref = torch.autograd.grad(plain_fn(*xs), xs, g_out)
        rels = [errors(a, b)[1] for a, b in zip(got, ref)]
        log(f"[7] {what} {shape} bf16 gradients vs autograd of the plain version: rel_l2 "
            f"dq {rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e} (tol 2e-2)")
        check(max(rels) <= 2e-2, f"{what} gradients {rels}")

    grad_check(flash_attention, attention.plain_attention, (32, 2560, h1, 64),
               "flash_attention (K3 + K4a/K4b)")
    flat = lambda x: x.flatten(-2)
    grad_check(small_t_attention_tmajor,
               lambda q, k, v: small_t_fwd_tmajor_plain(flat(q), flat(k), flat(v), h1,
                                                        0.125).unflatten(-1, (h1, 64)),
               (2, 16, 2560, h1, 64), "small_t_attention_tmajor (K2)")
    torch.cuda.empty_cache()
    phase_s["7"] = time.perf_counter() - t0

    # -- phase 8: one full-width training micro-step, kernels vs plain ------
    t0 = time.perf_counter()
    train_wrappers = (flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, small_t_fwd_tmajor,
                      flash_fwd)
    tc = TrainingConfig.from_yaml(TRAIN_CONFIG)
    mc = tc.model
    pipe = DynamiCrafterPipeline.for_training(mc, dev, frozen_dtype=torch.bfloat16)
    pipe.init_random(seed=SEED)
    trainer = Trainer(pipe, TrainConfig(
        accumulate_grad_batches=tc.accumulate_grad_batches, use_ema=False,
        uncond_prob=mc.uncond_prob, rand_cond_frame=mc.rand_cond_frame,
        parameterization=mc.parameterization, bf16=True), seed=SEED)
    bsz, t_len = tc.batch_size, mc.unet["temporal_length"]
    hh, ww = tc.train_data["resolution"]
    batch = {"video": torch.rand(bsz, t_len, hh, ww, 3, device=dev, generator=gen) * 2 - 1,
             "tokens": torch.as_tensor(pipe.tokenizer(["a fox running", "waves at dusk"]),
                                       dtype=torch.long, device=dev),
             "fs": torch.full((bsz,), 8.0, device=dev)}
    draws = trainer.draw(batch)
    reset(*train_wrappers)
    t1 = time.perf_counter()
    loss, _, grads = trainer.loss_and_grads(batch, draws)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    per_step = counts(*train_wrappers)
    g_kern = torch.cat([g.flatten() for g in grads])
    del grads
    with attention.use_backend("plain"):
        t1 = time.perf_counter()
        loss_plain, _, grads = trainer.loss_and_grads(batch, draws)
        torch.cuda.synchronize()
        plain_step_s = time.perf_counter() - t1
    g_plain = torch.cat([g.flatten() for g in grads])
    del grads
    g_abs, g_rel = errors(g_kern, g_plain)
    # the slice of the gradient K4a/K4b feed directly: to_q, to_k, to_v of
    # the level-0 spatial self-attentions (L = 2560)
    level0 = [f"model.diffusion_model.{name}.transformer_blocks.0.attn1.to_"
              for name, m in pipe.unet.named_modules() if isinstance(m, SpatialTransformer)
              and m.proj_in.in_features == pipe.unet_config.model_channels]
    offsets = np.cumsum([0] + [p.numel() for p in trainer.params.values()])
    sel = torch.cat([torch.arange(offsets[i], offsets[i + 1], device=dev)
                     for i, k in enumerate(trainer.params) if k.startswith(tuple(level0))])
    qkv_abs, qkv_rel = errors(g_kern[sel], g_plain[sel])
    n_train = g_kern.numel()
    log(f"[8] training micro-step {TRAIN_CONFIG} (batch {bsz} x {t_len} at {hh}x{ww}, "
        f"{n_train / 1e9:.3f} B trainable): loss kernels {loss.item():.6f} plain "
        f"{loss_plain.item():.6f} | flattened gradient rel_l2 {g_rel:.3e} max_abs "
        f"{g_abs:.3e} (tol 5e-2), norm {g_kern.norm().item():.4e}; of the {len(level0)} "
        f"level-0 spatial attn1 to_q/to_k/to_v weights rel_l2 {qkv_rel:.3e} max_abs "
        f"{qkv_abs:.3e}, norm {g_kern[sel].norm().item():.4e} | launches per "
        f"micro-step K3 {per_step[0]} K4a {per_step[1]} K4b {per_step[2]} K2 {per_step[3]} "
        f"K1 {per_step[4]} | fwd+bwd {step_s:.2f} s with kernels (first call), "
        f"{plain_step_s:.2f} s plain")
    check(bool(torch.isfinite(g_kern).all()) and g_kern.norm().item() > 0, "training gradient")
    check(g_rel <= 5e-2, f"training gradient kernels vs plain rel L2 {g_rel} > 5e-2")
    check(abs(loss.item() - loss_plain.item()) <= 1e-2 * abs(loss_plain.item()),
          f"training loss kernels {loss.item()} vs plain {loss_plain.item()}")
    check(per_step == (5, 5, 5, 68, 0), f"launches per micro-step {per_step} != (5, 5, 5, 68, 0)")
    del pipe, trainer, batch, draws, g_kern, g_plain, sel, loss, loss_plain
    torch.cuda.empty_cache()
    phase_s["8"] = time.perf_counter() - t0

    # -- phase 9: the training slice end to end -----------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(dir=REPO) as logdir:
        reset(*train_wrappers)
        result = train.main([
            "--config", TRAIN_CONFIG, "--synthetic_data", "--bf16",
            "--max_steps", str(TRAIN_STEPS), "--device", "cuda", "--seed", str(SEED),
            "--logdir", logdir, "--name", "smoke", "--log_every", "1"])
        torch.cuda.synchronize()
        train_launches = counts(*train_wrappers)
        train_peak = torch.cuda.max_memory_allocated(dev)
        trainer = result["trainer"]
        hist, secs = result["metrics"], result["step_seconds"]
        saved_step = result["checkpoints"].latest_step()
        state = result["checkpoints"].restore()
        ckpt_bytes = os.path.getsize(result["checkpoints"].path(saved_step))
        reloaded = all(torch.equal(state["weights"][k], p.detach().cpu())
                       for k, p in trainer.params.items())
        del state
    fresh = DynamiCrafterPipeline.for_training(mc, dev, frozen_dtype=torch.bfloat16)
    fresh.init_random(seed=SEED)
    fresh_sd, trained_sd = fresh.net.state_dict(), trainer.pipe.net.state_dict()
    trainable = set(trainer.params)
    updates = int(trainer.opt.optimizer.state[next(iter(trainer.params.values()))]["step"])
    moved = [k for k in trainable if k in fresh_sd
             and not torch.equal(fresh_sd[k], trained_sd[k])]
    frozen_same = all(torch.equal(v, trained_sd[k]) for k, v in fresh_sd.items()
                      if k not in trainable)
    n_trainable = sum(k in fresh_sd for k in trainable)
    delta = sum((trained_sd[k].double() - fresh_sd[k].double()).square().sum().item()
                for k in trainable if k in fresh_sd) ** 0.5
    del fresh, fresh_sd, trained_sd
    finite = all(np.isfinite(v) for m in hist for v in m.values())
    log(f"[9] train.main {TRAIN_CONFIG} --synthetic_data --bf16, {TRAIN_STEPS} micro-steps "
        f"(accumulation {tc.accumulate_grad_batches}, {updates} optimizer updates): loss " + " ".join(f"{m['loss']:.5f}" for m in hist)
        + " | grad_norm " + " ".join(f"{m['grad_norm']:.4e}" for m in hist)
        + " | s/micro-step " + " ".join(f"{s:.3f}" for s in secs)
        + f" (mean after the first {np.mean(secs[1:]):.3f}) | peak allocated "
        f"{train_peak / 2**30:.2f} GiB | trainable weights moved by L2 {delta:.4e} "
        f"({len(moved)}/{n_trainable} tensors; AdamW steps below half an fp32 ulp vanish), "
        f"frozen unchanged {frozen_same} | checkpoint step {saved_step} "
        f"{ckpt_bytes / 2**30:.2f} GiB reloads equal {reloaded} | launches K3 "
        f"{train_launches[0]} K4a {train_launches[1]} K4b {train_launches[2]} K2 "
        f"{train_launches[3]} K1 {train_launches[4]}")
    check(len(hist) == TRAIN_STEPS and finite, "training losses / grad norms not finite")
    check(all(m["grad_norm"] > 0 for m in hist), "zero grad_norm")
    check(delta > 0 and len(moved) >= n_trainable // 2, "trainable weights did not move")
    check(frozen_same, "a frozen weight changed")
    check(saved_step == TRAIN_STEPS and reloaded, "checkpoint missing or does not reload")
    check(train_launches == tuple(TRAIN_STEPS * c for c in per_step),
          f"launches {train_launches} != {TRAIN_STEPS} x {per_step}")
    phase_s["9"] = time.perf_counter() - t0
    log("[wall] " + " ".join(f"phase {k} {v:.1f}s" for k, v in phase_s.items())
        + f" | total {time.perf_counter() - t_start:.1f}s")

    sources = {"flash_fwd": ("dynamicrafter_tpu_torch/csrc/flash_attention.cu",
                             "dynamicrafter_tpu/ops/flash_attention.py:161", launches[0]),
               "small_t_fwd_tmajor": ("dynamicrafter_tpu_torch/csrc/small_attention.cu",
                                      "dynamicrafter_tpu/ops/small_attention.py:134",
                                      launches[1]),
               "flash_fwd_lse": ("dynamicrafter_tpu_torch/csrc/flash_attention.cu",
                                 "dynamicrafter_tpu/ops/flash_attention.py:32",
                                 train_launches[0]),
               "flash_bwd_dq": ("dynamicrafter_tpu_torch/csrc/flash_attention_bwd.cu",
                                "dynamicrafter_tpu/ops/flash_attention.py:304",
                                train_launches[1]),
               "flash_bwd_dkv": ("dynamicrafter_tpu_torch/csrc/flash_attention_bwd.cu",
                                 "dynamicrafter_tpu/ops/flash_attention.py:339",
                                 train_launches[2])}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=n, **report[name])
        for name, (src, rep, n) in sources.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
