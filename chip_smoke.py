#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one line:

  1. the device (torch and nvidia-smi name and power limit); build the CUDA
     kernels from `dynamicrafter_tpu_torch/csrc/` with nvcc;
  2. K1 (spatial flash attention) against its plain version at the 320x512
     shape (32, 2560, 5*64) bf16, a ragged L = 300 case, and fp32 checks;
  3. K2 (temporal attention) against its plain version at the shapes the
     320x512 (B = 2), 256x256 --bs 8 (B = 16) and 576x1024 (B = 1, G up to
     9216) paths give it (bf16) and one fp32 shape;
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
     weights, the checkpoint, and the kernel launches;
 10. K5 (position-major small-sequence attention) against its plain version
     at the 256x256 middle-block shape (256, 16, 20*64) bf16 and fp32 and
     at ragged shapes (G not a multiple of the row tile, T = 8 and 32, other
     head counts); K5 against plain attention at several G;
 11. K1 at the 576x1024 shapes (L = 9216 x 5 heads, L = 2304 x 10 heads)
     at N = 16, every row against its plain version (taken two rows of N at
     a time: the plain logits are N*H*L^2);
 12. one full-width UNet forward of configs/inference_256_v1.0.yaml on the
     batched-CFG input of 8 clips (16, 16, 32, 32, 8), bf16, kernels against
     plain, with the launches of one UNet call;
 13. the 256x256 slice end to end through `inference.main`: 8 prompts in one
     batch (--bs 8), DDIM-50, eta 1, CFG 7.5 batched, fs 3;
 14. the 576x1024 slice end to end through `inference.main`: one prompt,
     sequential CFG (the CLI's default at this width), per-frame encode,
     tiled decode, at a reduced DDIM step count; before it, the full-width
     UNet of that config cut to 2 frames, kernels against plain;
 15. interpolation and looping through `inference.main --interp` / `--loop`
     on the 320x512 model at a reduced step count;
 16. the other samplers through `inference.main` on the 320x512 model at
     full width: `--sampler dpm` at 30 steps, `--sampler unipc --solver_order
     2` at 20, and DDIM-50 with `--deepcache 5` (10 full UNet calls, 40
     shallow ones); frames, stage times and K1/K2 launch counts checked;
 17. the UNet's DeepCache seam at full width (a shallow forward from the
     same call's cache against the full forward, and both timed), and two
     DPM-Solver++ steps under batched CFG, kernels against plain;
 18. K6 (`flash_fwd_packed`), K9 (`flash_attention_pairs`) and K10
     (`run_variant`, modes exp, exp2, nosoftmax) against their plain
     versions in bf16 and fp32: at (32, 2560, 5*64) whole, at (32, 9216,
     5*64) and (32, 2304, 10*64) as one N = 32 launch held against the plain
     version two rows of N at a time, and at ragged shapes; the four
     attention variants and K1 against each other; K9's odd-H guard region;
 19. the bench entry points as K9's and K10's path
     (`experiments/flash_pairs/bench_flash_variants.main`,
     `bench_flash_pairs.main`, the three hot shapes at N = 32) and
     `flash_attention(packed=True)` at the same shapes as K6's, with their
     times beside K1's, the plain version's and the library call's;
 20. K7 (`fused_gn_silu_conv`) and K8 (`fused_gn_silu_conv_tiled`) against
     their plain versions in fp32 and bf16, with and without emb, at small
     and ragged shapes and at Co != C; K7 against K8 on the same fp32 input;
 21. K7's and K8's path, `experiments/fused_conv/bench_fused_conv.main`:
     both kernels, K7's plain version and the library route (group_norm,
     silu, conv2d on a channels-last tensor) timed at the ResBlock shapes of
     the 320x512 UNet (N = 32 frames) and level 0 of the 576x1024 UNet
     (N = 16), bf16 with emb; then each kernel against its plain version at
     those shapes, and the bound;
 22. one full-width ResBlock of the 320x512 UNet (level 0, 320 -> 320, its
     N(0, 0.02) weights): `in_layers(x)` and `out_layers(h + emb_out)`
     through the module and through K7 and K8 fed the module's parameters;
 23. SDS guidance end to end through `generate_guidance.main` on the 320x512
     model (bf16, batched CFG with rescale 0.7, 20 optimisation steps, debug
     dumps every 10): frames, loss curve, moved latents, K1/K2 launches,
     seconds per step and stage peaks; then two steps with fixed draws,
     kernels against plain;
 24. the app backend `Image2Video` at 320x512 with random weights:
     `get_image` at 10 steps in mode i2v and in mode loop (15 frames out).

Then a JSON line with, for each kernel, its launches on its main path (K1 and
K2 phase 5, K3, K4a and K4b phase 9, K5 phase 13, K6, K9 and K10 phase 19, K7
and K8 phase 21; `launches_by_path` has every path), error against the plain
version (K6, K9, K10: the worst over phase 18's bf16 shapes; K7, K8: at the
first shape of phase 21), and times: the kernel, the plain
version, the bound (the larger of bytes over 3.35 TB/s and operations over
the peak rate of the input type, from the shapes) and one library call
(`F.scaled_dot_product_attention`, or for K7 and K8 the group_norm, silu,
conv2d route; timed here and used nowhere in the
package); the nvidia-smi line, and last `{"ok": true, "device": {...}}`.
Any failure raises, so the script exits nonzero; without a CUDA device it
exits 1 before printing any result. Float32 matmuls and convolutions run
without TF32 (both flags set False) in every comparison.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

CONFIG = "configs/inference_512_v1.0.yaml"
TRAIN_CONFIG = "configs/training_512_v1.0.yaml"
CONFIG_256 = "configs/inference_256_v1.0.yaml"
CONFIG_1024 = "configs/inference_1024_v1.0.yaml"
PROMPTS = "prompts/512"
STEPS = 50
STEPS_1024 = 8
STEPS_INTERP = 4
STEPS_DPM = 30
STEPS_UNIPC = 20
DEEPCACHE = 5
TRAIN_STEPS = 4
STEPS_SDS = 20
STEPS_APP = 10
# published peaks of one H100 SXM at 700 W: HBM bytes/s, FLOP/s by input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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


def bound(n_bytes: float, flops: float, dtype) -> dict:
    """The least milliseconds the card could take: every input read and every
    output written once at the memory rate, or the operations at the peak
    rate of the input type, whichever is larger."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES
    by_ops = 1e3 * flops / PEAK_FLOPS[str(dtype)[6:]]
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def attention_bound(n, lq, lk, h, d, dtype, products: int = 2, extra_tensors: int = 0,
                    lse: bool = False) -> dict:
    """Attention over (n, l, h*d) operands: q and o-sized tensors of lq rows,
    k and v of lk rows, `extra_tensors` more of lq rows (do, dq, ...), an
    fp32 lse, and `products` matrix products of 2*n*h*lq*lk*d operations."""
    size = 4 if str(dtype).endswith("float32") else 2
    n_bytes = size * n * h * d * ((2 + extra_tensors) * lq + 2 * lk) + (4 * n * h * lq if lse else 0)
    return bound(n_bytes, products * 2.0 * n * h * lq * lk * d, dtype)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def read_clip(path: str):
    """A clip as `save_clip` wrote it, `.npy` or (where OpenCV imports) `.mp4`,
    as (T, H, W, 3) uint8."""
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path)
    import cv2

    cap, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    check(bool(frames), f"{path}: no frame decodes")
    return np.stack(frames)


def counts(*wrappers) -> tuple:
    return tuple(w.launches for w in wrappers)


def reset(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dynamicrafter_tpu_torch import generate_guidance, inference
    from dynamicrafter_tpu_torch.app import Image2Video
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.experiments.fused_conv import bench_fused_conv
    from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv import (
        fused_gn_silu_conv, fused_gn_silu_conv_plain)
    from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv_tiled import (
        fused_gn_silu_conv_tiled, fused_gn_silu_conv_tiled_plain)
    from dynamicrafter_tpu_torch.models.blocks import ResBlock, SpatialTransformer
    from dynamicrafter_tpu_torch.sds import SDSDraws, SDSGuidancePipeline, SDSSettings
    from dynamicrafter_tpu_torch.utils.video import decode_png
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.ops import attention, kernels
    from dynamicrafter_tpu_torch import train
    from dynamicrafter_tpu_torch.config import TrainingConfig
    from dynamicrafter_tpu_torch.experiments.flash_pairs import (
        bench_flash_pairs, bench_flash_variants)
    from dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants import (
        run_variant, run_variant_plain)
    from dynamicrafter_tpu_torch.experiments.flash_pairs.flash_pairs import (
        flash_attention_pairs)
    from dynamicrafter_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd, flash_bwd_dkv, flash_bwd_dq, flash_bwd_plain, flash_fwd,
        flash_fwd_lse, flash_fwd_lse_plain, flash_fwd_packed, flash_fwd_plain)
    from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
    from dynamicrafter_tpu_torch.ops.small_attention import (
        small_t_attention, small_t_attention_tmajor, small_t_fwd, small_t_fwd_plain,
        small_t_fwd_tmajor, small_t_fwd_tmajor_plain)
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.sampling.ddim import (
        CFGConditioning, SamplerSettings, make_cfg_denoiser)
    from dynamicrafter_tpu_torch.sampling.dpm import dpm_sample
    from dynamicrafter_tpu_torch.schedule import build_ddim_table, build_schedule
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

    def heads_first(x, h):
        """(..., L, h*64) -> the (..., h, L, 64) view the library call takes."""
        return x.unflatten(-1, (h, 64)).transpose(-3, -2)

    def sdpa_ms(q, k, v, h, iters=10):
        """One `F.scaled_dot_product_attention` forward on the same data."""
        qh, kh, vh = (heads_first(x, h) for x in (q, k, v))
        return cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=iters)

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
            report["flash_fwd"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                **attention_bound(n, l, l, h1, 64, dtype), library_ms=sdpa_ms(q, k, v, h1))
        del q, k, v, out, ref

    phase_s["2"] = time.perf_counter() - t0

    # -- phase 3: K2 ------------------------------------------------------
    t0 = time.perf_counter()
    bf16, fp32 = torch.bfloat16, torch.float32
    k2_cases = [
        # 320x512, batched CFG (B = 2): the init attention (8 heads), levels 0-3
        (2, 2560, 5, bf16, 1e-2), (2, 2560, 8, bf16, 1e-2), (2, 640, 10, bf16, 1e-2),
        (2, 160, 20, bf16, 1e-2), (2, 40, 20, bf16, 1e-2), (2, 2560, 5, fp32, 1e-5),
        # 256x256, 8 clips under batched CFG (B = 16)
        (16, 1024, 5, bf16, 1e-2), (16, 1024, 8, bf16, 1e-2), (16, 256, 10, bf16, 1e-2),
        (16, 64, 20, bf16, 1e-2), (16, 16, 20, bf16, 1e-2),
        # 576x1024, one pass of sequential CFG (B = 1)
        (1, 9216, 5, bf16, 1e-2), (1, 9216, 8, bf16, 1e-2), (1, 2304, 10, bf16, 1e-2),
        (1, 576, 20, bf16, 1e-2), (1, 144, 20, bf16, 1e-2)]
    for b, g, h, dtype, tol in k2_cases:
        q, k, v = (torch.randn(b, 16, g, h * 64, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        out = small_t_fwd_tmajor(q, k, v, h, 0.125)
        ref = small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: small_t_fwd_tmajor(q, k, v, h, 0.125), iters=50)
        plain_ms = cuda_ms(lambda: small_t_fwd_tmajor_plain(q, k, v, h, 0.125), iters=50)
        log(f"[3] K2 small_t_fwd_tmajor ({b}, 16, {g}, {h}*64) {str(dtype)[6:]}: max_abs "
            f"{max_abs:.3e} rel_l2 {rel:.3e} (tol {tol:g}) | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        check(rel <= tol, f"K2 rel L2 {rel} > {tol} at {(b, g, h, dtype)}")
        if (b, g, h, dtype) == (2, 2560, 5, bf16):
            # the library call on the (B, G, h, T, 64) view of the same data
            lib_ms = sdpa_ms(*(x.transpose(1, 2) for x in (q, k, v)), h, iters=50)
            report["small_t_fwd_tmajor"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                **attention_bound(b * g, 16, 16, h, 64, dtype), library_ms=lib_ms)
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
    # `sample` restarts the peak count at each stage
    peak = max(result["build_peak"], *result["peaks"][0].values())
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
            report["flash_fwd_lse"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                **attention_bound(n, l, l, h1, 64, dtype, lse=True),
                library_ms=sdpa_ms(q, k, v, h1))
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
            # the library's backward computes dq, dk and dv in one call, as
            # the plain version does: both kernels are held against that time
            leaves = [heads_first(x, h1).detach().requires_grad_() for x in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*leaves)
            lib_do = heads_first(do, h1)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, lib_do,
                                                         retain_graph=True))
            del leaves, lib_out, lib_do
            # K4a reads q, k, v, o, lse, do and writes dq (three products);
            # K4b reads the same and writes dk, dv (four products); Lq = Lk
            report["flash_bwd_dq"] = dict(
                max_abs_err=errs[0][0], ms=ms_dq, plain_ms=plain_ms,
                **attention_bound(n, l, l, h1, 64, dtype, products=3, extra_tensors=2,
                                  lse=True), library_ms=lib_ms, library_covers="dq+dk+dv")
            report["flash_bwd_dkv"] = dict(
                max_abs_err=max(errs[1][0], errs[2][0]), ms=ms_dkv, plain_ms=plain_ms,
                **attention_bound(n, l, l, h1, 64, dtype, products=4, extra_tensors=3,
                                  lse=True), library_ms=lib_ms, library_covers="dq+dk+dv")
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
    del result, trainer, hist, secs
    torch.cuda.empty_cache()

    # -- phase 10: K5 -------------------------------------------------------
    t0 = time.perf_counter()
    for g, tk, h, d, dtype, tol in [
            (256, 16, 20, 64, torch.bfloat16, 2e-2), (256, 16, 20, 64, torch.float32, 1e-4),
            (37, 8, 3, 64, torch.bfloat16, 2e-2), (37, 8, 3, 64, torch.float32, 1e-4),
            (19, 32, 7, 64, torch.bfloat16, 2e-2), (19, 32, 7, 32, torch.float32, 1e-4)]:
        q, k, v = (torch.randn(g, tk, h * d, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        out = small_t_fwd(q, k, v, h, scale)
        ref = small_t_fwd_plain(q.float(), k.float(), v.float(), h, scale)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: small_t_fwd(q, k, v, h, scale), iters=50)
        plain_ms = cuda_ms(lambda: small_t_fwd_plain(q, k, v, h, scale), iters=50)
        log(f"[10] K5 small_t_fwd ({g}, {tk}, {h}*{d}) {str(dtype)[6:]}: max_abs {max_abs:.3e} "
            f"rel_l2 {rel:.3e} (tol {tol:g}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(rel <= tol, f"K5 rel L2 {rel} > {tol} at {(g, tk, h, d, dtype)}")
        if (g, tk, dtype) == (256, 16, torch.bfloat16):
            report["small_t_fwd"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                **attention_bound(g, tk, tk, h, d, dtype),
                library_ms=sdpa_ms(q, k, v, h, iters=50))
        del q, k, v, out, ref
    # why the route has no row threshold (the JAX rule wants 256 rows): K5
    # against plain attention on (rows, 16, 20, 64) bf16, from --bs 2 up
    for g in (32, 64, 256, 1024, 4096):
        q, k, v = (torch.randn(g, 16, 20, 64, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        ms = cuda_ms(lambda: small_t_attention(q, k, v), iters=50)
        plain_ms = cuda_ms(lambda: attention.plain_attention(q, k, v), iters=50)
        rel = errors(small_t_attention(q, k, v), attention.plain_attention(q, k, v))[1]
        log(f"[10] route ({g}, 16, 20, 64) bf16: small_t_attention (K5) {ms:.4f} ms, "
            f"plain_attention {plain_ms:.4f} ms, rel_l2 between them {rel:.3e}")
        check(rel <= 2e-2, f"K5 vs plain_attention rel L2 {rel} at G={g}")
        del q, k, v
    phase_s["10"] = time.perf_counter() - t0

    # -- phase 11: K1 at the 576x1024 shapes ----------------------------------
    t0 = time.perf_counter()
    for l, h in [(9216, 5), (2304, 10)]:
        q, k, v = (torch.randn(16, l, h * 64, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        # one N = 16 launch, as the path makes it, held against the plain
        # version two rows of N at a time (its logits are N*H*L^2)
        full = flash_fwd(q, k, v, h, 0.125)
        torch.cuda.synchronize()
        max_abs = rel = 0.0
        for i in range(0, 16, 2):
            ref = flash_fwd_plain(q[i:i + 2].float(), k[i:i + 2].float(), v[i:i + 2].float(),
                                  h, 0.125)
            a, r = errors(full[i:i + 2], ref)
            max_abs, rel = max(max_abs, a), max(rel, r)
            del ref
        ms = cuda_ms(lambda: flash_fwd(q, k, v, h, 0.125), iters=5, warmup=1)
        lib_ms = sdpa_ms(q, k, v, h, iters=5)
        b = attention_bound(16, l, l, h, 64, torch.bfloat16)
        log(f"[11] K1 flash_fwd (16, {l}, {h}*64) bf16: one N=16 launch vs plain in eight "
            f"N=2 slices, worst slice max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 1e-2) | "
            f"kernel {ms:.3f} ms, library {lib_ms:.3f} ms, bound {b['bound_ms']:.3f} ms by "
            f"{b['bound_by']}")
        check(rel <= 1e-2, f"K1 rel L2 {rel} > 1e-2 at N=16, L={l}")
        del q, k, v, full
    torch.cuda.empty_cache()
    phase_s["11"] = time.perf_counter() - t0

    # -- phase 12: full-width 256x256 UNet forward, kernels vs plain ----------
    t0 = time.perf_counter()
    infer_wrappers = (flash_fwd, small_t_fwd_tmajor, small_t_fwd)
    cfg = ModelConfig.from_yaml(CONFIG_256)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(cfg.unet))
    unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
    init_normal_(unet.requires_grad_(False), gen, 0.02)
    x = torch.randn(16, 16, 32, 32, 8, device=dev, generator=gen)
    ts = torch.full((16,), 999, dtype=torch.long, device=dev)
    ctx_t = torch.randn(16, 77, 1024, device=dev, generator=gen)
    ctx_i = torch.randn(16, 16, 16, 1024, device=dev, generator=gen)
    fs = torch.full((16,), 3, dtype=torch.long, device=dev)
    run = lambda: unet(x, ts, context_text=ctx_t, context_img=ctx_i, fs=fs)
    with torch.no_grad():
        reset(*infer_wrappers)
        out = run()
        torch.cuda.synchronize()
        per_call_256 = counts(*infer_wrappers)
        with attention.use_backend("plain"):
            ref = run()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(run, iters=3, warmup=1)
        with attention.use_backend("plain"):
            plain_ms = cuda_ms(run, iters=3, warmup=1)
    log(f"[12] UNet forward {CONFIG_256} (16, 16, 32, 32, 8) bf16: out {tuple(out.shape)} "
        f"finite {bool(torch.isfinite(out).all())} | kernels vs plain max_abs {max_abs:.3e} "
        f"rel_l2 {rel:.3e} (tol 2e-2) | launches per call K1 {per_call_256[0]} (L = 1024 < "
        f"2048), K2 {per_call_256[1]} (17 temporal transformers x attn1 + attn2), K5 "
        f"{per_call_256[2]} (the middle block's 4 x 4 frame: attn1, and attn2's image "
        f"cross-attention, whose 16 image tokens per frame give k and v the shape of q) | "
        f"{ms:.1f} ms with kernels, {plain_ms:.1f} ms plain")
    check(bool(torch.isfinite(out).all()) and out.shape == (16, 16, 32, 32, 4), "256 UNet output")
    check(rel <= 2e-2, f"256 UNet kernels vs plain rel L2 {rel} > 2e-2")
    check(per_call_256 == (0, 34, 2), f"launches per 256 UNet call {per_call_256} != (0, 34, 2)")
    del unet, x, out, ref
    torch.cuda.empty_cache()
    phase_s["12"] = time.perf_counter() - t0

    def prompt_dir(root, n_prompts, images_per_prompt=1):
        """A prompt dir of copies of the example image (`load_prompt_dir`
        resizes) and as many prompt lines."""
        os.makedirs(root)
        for i in range(n_prompts * images_per_prompt):
            shutil.copy(os.path.join(PROMPTS, "example.png"), os.path.join(root, f"img{i:02d}.png"))
        with open(os.path.join(root, "prompts.txt"), "w") as f:
            f.write("".join(f"a clip of scene {i}, slow camera motion\n"
                            for i in range(n_prompts)))
        return root

    def run_cli(tag, flags, expect_shape, steps, sampler="DDIM"):
        """Drive `inference.main` with the counts at 0; returns (launches,
        stage seconds, peak bytes) after checking the written frames. Flags
        that `flags` repeats override the common ones below."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset(*infer_wrappers)
        t1 = time.perf_counter()
        result = inference.main(["--random_init", "--bf16", "--text_input",
                                 "--unconditional_guidance_scale", "7.5", "--video_length",
                                 "16", "--ddim_steps", str(steps), "--ddim_eta", "1.0",
                                 "--seed", str(SEED), "--device", "cuda", *flags])
        wall = time.perf_counter() - t1
        n = counts(*infer_wrappers)
        videos, stages = result["videos"][0], result["timings"][0]
        stage_peaks = result["peaks"][0]
        peak = max(result["build_peak"], *stage_peaks.values())
        frames = np.stack([np.load(p) for p in result["paths"]])
        log(f"[{tag}] frames {videos.shape} finite {bool(np.isfinite(videos).all())}, files "
            f"{frames.shape} {frames.dtype} levels {len(np.unique(frames))} | {sampler}-{steps} | "
            + " ".join(f"{k} {v:.2f}s (peak {stage_peaks[k] / 2**30:.2f} GiB)"
                       for k, v in stages.items())
            + f" | {1e3 * stages['ddim'] / steps:.1f} ms/step | main() wall {wall:.1f}s | peak "
            f"allocated {peak / 2**30:.2f} GiB (building the pipeline "
            f"{result['build_peak'] / 2**30:.2f}) | launches K1 {n[0]} K2 {n[1]} K5 {n[2]}")
        check(videos.shape == expect_shape, f"{tag}: frames {videos.shape} != {expect_shape}")
        check(bool(np.isfinite(videos).all()), f"{tag}: decoded frames are not finite")
        check(frames.dtype == np.uint8 and frames.shape == (
            expect_shape[0] * expect_shape[1], *expect_shape[2:]), f"{tag}: frame files")
        check(len(np.unique(frames)) > 1, f"{tag}: decoded frames are constant")
        return n, stages, peak

    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        # -- phase 13: the 256x256 slice end to end, 8 prompts in one batch ---
        t0 = time.perf_counter()
        launches_256, _, _ = run_cli("13 slice 256x256 --bs 8", [
            "--config", CONFIG_256, "--prompt_dir", prompt_dir(os.path.join(tmp, "p256"), 8),
            "--savedir", os.path.join(tmp, "o256"), "--height", "256", "--width", "256",
            "--frame_stride", "3", "--timestep_spacing", "uniform", "--bs", "8"],
            (8, 1, 16, 256, 256, 3), STEPS)
        check(launches_256 == tuple(STEPS * c for c in per_call_256),
              f"launches on the 256 slice {launches_256} != {STEPS} x {per_call_256}")
        phase_s["13"] = time.perf_counter() - t0

        # -- phase 14: the 576x1024 slice end to end ----------------------------
        t0 = time.perf_counter()
        # first the full-width UNet, kernels against plain, cut to 2 frames
        # (the plain logits of 16 frames at L = 9216 are 13.6 GB in bf16)
        cfg = ModelConfig.from_yaml(CONFIG_1024)
        with torch.device("meta"):
            unet = UNetModel(UNetConfig.from_dict(cfg.unet))
        unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
        init_normal_(unet.requires_grad_(False), gen, 0.02)
        x = torch.randn(1, 2, 72, 128, 8, device=dev, generator=gen)
        one = lambda v: torch.full((1,), v, dtype=torch.long, device=dev)
        ctx_t = torch.randn(1, 77, 1024, device=dev, generator=gen)
        ctx_i = torch.randn(1, 2, 16, 1024, device=dev, generator=gen)
        run = lambda: unet(x, one(999), context_text=ctx_t, context_img=ctx_i, fs=one(10))
        with torch.no_grad():
            reset(*infer_wrappers)
            out = run()
            per_pass_1024 = counts(*infer_wrappers)
            with attention.use_backend("plain"):
                ref = run()
        max_abs, rel = errors(out, ref)
        log(f"[14] UNet forward {CONFIG_1024} cut to 2 frames (1, 2, 72, 128, 8) bf16: "
            f"kernels vs plain max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 2e-2) | launches "
            f"per pass K1 {per_pass_1024[0]} (5 level-0 spatial transformers at L = 9216, 5 "
            f"level-1 at L = 2304), K2 {per_pass_1024[1]}, K5 {per_pass_1024[2]}")
        check(bool(torch.isfinite(out).all()) and rel <= 2e-2,
              f"1024 UNet kernels vs plain rel L2 {rel} > 2e-2")
        check(per_pass_1024 == (10, 34, 0), f"launches per 1024 pass {per_pass_1024}")
        del unet, x, out, ref
        launches_1024, _, _ = run_cli("14 slice 576x1024 sequential CFG, tiled decode", [
            "--config", CONFIG_1024, "--prompt_dir", prompt_dir(os.path.join(tmp, "p1024"), 1),
            "--savedir", os.path.join(tmp, "o1024"), "--height", "576", "--width", "1024",
            "--frame_stride", "10", "--timestep_spacing", "uniform_trailing",
            "--guidance_rescale", "0.7", "--perframe_ae", "--bs", "1"],
            (1, 1, 16, 576, 1024, 3), STEPS_1024)
        # per pass of 16 frames: K1 at the 5 level-0 (L = 9216, 5 heads) and the
        # 5 level-1 (L = 2304, 10 heads) spatial transformers, K2 as everywhere
        check(launches_1024 == tuple(STEPS_1024 * 2 * c for c in per_pass_1024),
              f"launches on the 1024 slice {launches_1024} != {STEPS_1024} steps x 2 passes "
              f"x {per_pass_1024}")
        phase_s["14"] = time.perf_counter() - t0

        # -- phase 15: interpolation and looping on the 320x512 model -----------
        t0 = time.perf_counter()
        flags_512 = ["--config", CONFIG, "--height", "320", "--width", "512", "--frame_stride",
                     "5", "--timestep_spacing", "uniform_trailing", "--guidance_rescale", "0.7",
                     "--perframe_ae"]
        n_interp, _, _ = run_cli("15 --interp 320x512, two images", [
            *flags_512, "--interp", "--prompt_dir",
            prompt_dir(os.path.join(tmp, "pinterp"), 1, images_per_prompt=2),
            "--savedir", os.path.join(tmp, "ointerp")], (1, 1, 16, 320, 512, 3), STEPS_INTERP)
        n_loop, _, _ = run_cli("15 --loop 320x512, last frame dropped", [
            *flags_512, "--loop", "--prompt_dir", PROMPTS,
            "--savedir", os.path.join(tmp, "oloop")], (1, 1, 15, 320, 512, 3), STEPS_INTERP)
        check(n_interp == n_loop == (STEPS_INTERP * per_call[0], STEPS_INTERP * per_call[1], 0),
              f"launches in interp {n_interp} / loop {n_loop}")
        phase_s["15"] = time.perf_counter() - t0

        # -- phase 16: dpm, unipc and DeepCache on the 320x512 model -------------
        t0 = time.perf_counter()
        frames_512 = (1, 1, 16, 320, 512, 3)
        flags_512 = [*flags_512, "--frame_stride", "24", "--prompt_dir", PROMPTS]
        n_dpm, st_dpm, _ = run_cli("16 --sampler dpm", [
            *flags_512, "--sampler", "dpm", "--savedir", os.path.join(tmp, "odpm")],
            frames_512, STEPS_DPM, sampler="DPM++(2M)")
        n_unipc, st_unipc, _ = run_cli("16 --sampler unipc --solver_order 2", [
            *flags_512, "--sampler", "unipc", "--solver_order", "2",
            "--savedir", os.path.join(tmp, "ounipc")], frames_512, STEPS_UNIPC, sampler="UniPC")
        n_dc, st_dc, _ = run_cli(f"16 --deepcache {DEEPCACHE}", [
            *flags_512, "--deepcache", str(DEEPCACHE), "--savedir", os.path.join(tmp, "odc")],
            frames_512, STEPS, sampler=f"DDIM with DeepCache-{DEEPCACHE}")
        # a shallow call runs the level-0 blocks only: all 5 level-0 spatial
        # transformers (K1), and of the 17 temporal transformers `init_attn`
        # and the 5 of level 0 (K2 twice each: attn1 and attn2)
        shallow = (5, 12, 0)
        n_full = STEPS // DEEPCACHE
        expect_dc = tuple(n_full * f + (STEPS - n_full) * c
                          for f, c in zip((*per_call, 0), shallow))
        log(f"[16] launches: dpm {n_dpm} (expected {STEPS_DPM} x {per_call}), unipc {n_unipc} "
            f"(expected {STEPS_UNIPC} x {per_call}), DeepCache-{DEEPCACHE} {n_dc} (expected "
            f"{n_full} full x {per_call} + {STEPS - n_full} shallow x {shallow[:2]} = "
            f"{expect_dc}) | sampler loop per clip: dpm {st_dpm['ddim']:.2f}s unipc "
            f"{st_unipc['ddim']:.2f}s DeepCache {st_dc['ddim']:.2f}s")
        check(n_dpm == (STEPS_DPM * per_call[0], STEPS_DPM * per_call[1], 0),
              f"launches under dpm {n_dpm}")
        check(n_unipc == (STEPS_UNIPC * per_call[0], STEPS_UNIPC * per_call[1], 0),
              f"launches under unipc {n_unipc}")
        check(n_dc == expect_dc, f"launches under DeepCache {n_dc} != {expect_dc}")
        phase_s["16"] = time.perf_counter() - t0

    # -- phase 17: the DeepCache seam and a dpm step at the full-width UNet ----
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
    kw = dict(context_text=ctx_t, context_img=ctx_i, fs=fs)
    with torch.no_grad():
        full, cache = unet(x, ts, return_cache=True, **kw)
        reset(*infer_wrappers)
        from_cache = unet(x, ts, cache=cache, **kw)
        torch.cuda.synchronize()
        n_shallow = counts(*infer_wrappers)
        max_abs, rel = errors(from_cache, full)
        full_ms = cuda_ms(lambda: unet(x, ts, **kw), iters=5, warmup=1)
        shallow_ms = cuda_ms(lambda: unet(x, ts, cache=cache, **kw), iters=5, warmup=1)
    log(f"[17] DeepCache seam, UNet {CONFIG} (2, 16, 40, 64, 8) bf16: cache "
        f"{tuple(cache.shape)} {str(cache.dtype)[6:]} | shallow(x, t, cache=full_cache(x, t)) "
        f"vs the full forward max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 1e-3), exactly "
        f"equal {bool(torch.equal(from_cache, full))} | launches of a shallow call K1 "
        f"{n_shallow[0]} K2 {n_shallow[1]} K5 {n_shallow[2]} | full call {full_ms:.1f} ms, "
        f"shallow call {shallow_ms:.1f} ms")
    check(cache.shape == (2, 16, 40, 64, 640), f"cache shape {tuple(cache.shape)}")
    check(rel <= 1e-3, f"shallow-from-own-cache vs full rel L2 {rel} > 1e-3")
    check(n_shallow == shallow, f"launches of a shallow call {n_shallow} != {shallow}")
    # two steps of DPM-Solver++(2M) (the second uses the history) under batched
    # CFG with guidance rescale, as the 512 preset samples
    schedule = build_schedule(
        timesteps=cfg.timesteps, beta_schedule=cfg.beta_schedule,
        linear_start=cfg.linear_start, linear_end=cfg.linear_end, cosine_s=cfg.cosine_s,
        parameterization=cfg.parameterization,
        rescale_betas_zero_snr=cfg.rescale_betas_zero_snr,
        use_dynamic_rescale=cfg.use_dynamic_rescale, base_scale=cfg.base_scale,
        turning_step=cfg.turning_step)
    settings = SamplerSettings(steps=2, discretize="uniform_trailing", eta=0.0, cfg_scale=7.5,
                               guidance_rescale=0.7, parameterization=cfg.parameterization,
                               sampler="dpm")
    table = build_ddim_table(schedule, num_steps=2, discretize="uniform_trailing", eta=0.0)
    cond = CFGConditioning(
        context_text=ctx_t[:, None], context_img=ctx_i[:, None],
        concat=torch.randn(2, 1, 16, 40, 64, 4, device=dev, generator=gen), fs=fs[:1])
    x_T = torch.randn(1, 16, 40, 64, 4, device=dev, generator=gen)
    model_fn = make_cfg_denoiser(unet, cond, settings)
    z = dpm_sample(model_fn, x_T, schedule, table, settings)
    with attention.use_backend("plain"):
        z_plain = dpm_sample(model_fn, x_T, schedule, table, settings)
    max_abs, rel = errors(z, z_plain)
    log(f"[17] two DPM-Solver++(2M) steps, batched CFG 7.5 with rescale 0.7, latent "
        f"{tuple(z.shape)}: kernels vs plain max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 2e-2) "
        f"finite {bool(torch.isfinite(z).all())}")
    check(bool(torch.isfinite(z).all()) and rel <= 2e-2, f"dpm kernels vs plain rel L2 {rel}")
    # phase 22 takes one level-0 ResBlock (320 -> 320) of this UNet
    resblock = next(m for m in unet.modules() if isinstance(m, ResBlock)
                    and m.in_layers[2].in_channels == m.in_layers[2].out_channels
                    == unet.config.model_channels)
    del unet, x, full, cache, from_cache, cond, x_T, z, z_plain, model_fn
    torch.cuda.empty_cache()
    phase_s["17"] = time.perf_counter() - t0

    # -- phase 18: K6, K9, K10 against their plain versions --------------------
    t0 = time.perf_counter()
    variants = {
        "K6 flash_fwd_packed": flash_fwd_packed,
        "K9 flash_attention_pairs": flash_attention_pairs,
        "K10 run_variant exp": lambda *a: run_variant(*a, "exp"),
        "K10 run_variant exp2": lambda *a: run_variant(*a, "exp2"),
    }
    nosoftmax = lambda *a: run_variant(*a, "nosoftmax")
    variant_tol = {bf16: 5e-3, fp32: 1e-5}
    worst = {}   # (kernel, dtype) -> (max_abs, rel) over every shape

    def hold(name, out, ref, dtype, what):
        a, r = errors(out, ref)
        w = worst.get((name, dtype), (0.0, 0.0))
        worst[(name, dtype)] = (max(w[0], a), max(w[1], r))
        check(r <= variant_tol[dtype],
              f"{name} rel L2 {r} > {variant_tol[dtype]} at {what} {str(dtype)[6:]}")
        return r

    def draw_qkv(n, lq, lk, h, dtype):
        # q and k scaled as the benches scale them: logits on both sides of +-1
        q = (torch.randn(n, lq, h * 64, device=dev, generator=gen) * 0.6).to(dtype)
        k, v = ((torch.randn(n, lk, h * 64, device=dev, generator=gen) * s).to(dtype)
                for s in (0.6, 1.0))
        return q, k, v

    # whole at the 320x512 shape; ragged L, Lq != Lk, H = 1, 5 and 20, two groups
    for n, lq, lk, h in [(32, 2560, 2560, 5), (4, 300, 300, 5), (3, 130, 77, 1),
                         (2, 200, 333, 20), (2, 97, 150, 7)]:
        for dtype in (bf16, fp32):
            q, k, v = draw_qkv(n, lq, lk, h, dtype)
            ref = flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
            rels = {name: hold(name, fn(q, k, v, h, 0.125), ref, dtype, (n, lq, lk, h))
                    for name, fn in variants.items()}
            ref = run_variant_plain(q.float(), k.float(), v.float(), h, 0.125, "nosoftmax")
            rels["K10 run_variant nosoftmax"] = hold(
                "K10 run_variant nosoftmax", nosoftmax(q, k, v, h, 0.125), ref, dtype,
                (n, lq, lk, h))
            log(f"[18] ({n}, Lq {lq}, Lk {lk}, {h}*64) {str(dtype)[6:]} rel_l2 vs plain: "
                + ", ".join(f"{name} {r:.3e}" for name, r in rels.items())
                + f" (tol {variant_tol[dtype]:g})")
            if (n, lq, dtype) == (32, 2560, bf16):
                outs = {"K1 flash_fwd": flash_fwd(q, k, v, h, 0.125),
                        **{name: fn(q, k, v, h, 0.125) for name, fn in variants.items()}}
                names = list(outs)
                pair_rel = max(errors(outs[a], outs[b])[1]
                               for i, a in enumerate(names) for b in names[i + 1:])
                log(f"[18] K1, K6, K9, K10 exp, K10 exp2 on the same bf16 inputs: largest "
                    f"pairwise rel_l2 {pair_rel:.3e} (tol 5e-3)")
                check(pair_rel <= 5e-3, f"variants disagree pairwise: rel L2 {pair_rel}")
                del outs
            del q, k, v, ref
    # the 576x1024 shapes: one N = 32 launch, held against the plain version
    # two rows of N at a time (its logits at N = 32, L = 9216 are 54 GB in fp32)
    for l, h in [(9216, 5), (2304, 10)]:
        for dtype in (bf16, fp32):
            q, k, v = draw_qkv(32, l, l, h, dtype)
            outs = {name: fn(q, k, v, h, 0.125) for name, fn in variants.items()}
            out_ns = nosoftmax(q, k, v, h, 0.125)
            torch.cuda.synchronize()
            rels = dict.fromkeys([*outs, "K10 run_variant nosoftmax"], 0.0)
            for i in range(0, 32, 2):
                sl = slice(i, i + 2)
                args = (q[sl].float(), k[sl].float(), v[sl].float(), h, 0.125)
                ref = flash_fwd_plain(*args)
                for name, out in outs.items():
                    rels[name] = max(rels[name], hold(name, out[sl], ref, dtype, (32, l, h)))
                ref = run_variant_plain(*args, "nosoftmax")
                rels["K10 run_variant nosoftmax"] = max(
                    rels["K10 run_variant nosoftmax"],
                    hold("K10 run_variant nosoftmax", out_ns[sl], ref, dtype, (32, l, h)))
                del ref
            log(f"[18] (32, {l}, {h}*64) {str(dtype)[6:]}: one N=32 launch vs plain in sixteen "
                f"N=2 slices, worst slice rel_l2: "
                + ", ".join(f"{name} {r:.3e}" for name, r in rels.items())
                + f" (tol {variant_tol[dtype]:g})")
            del q, k, v, outs, out_ns
    # K9 at odd H: a guard region right behind the output keeps its fill
    for h in (1, 5):
        q, k, v = draw_qkv(2, 100, 77, h, bf16)
        buf = torch.full((q.numel() + 4096,), 7.0, device=dev, dtype=bf16)
        out = buf[:q.numel()].view_as(q)
        kernels.check(kernels.library().dct_flash_fwd_pairs(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kernels.DTYPE_CODES[bf16],
            2, 100, 77, h, 0.125, kernels.stream_handle(dev)), "dct_flash_fwd_pairs")
        torch.cuda.synchronize()
        intact = bool((buf[q.numel():] == 7.0).all())
        rel = errors(out, flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125))[1]
        log(f"[18] K9 at H = {h} into the head of a larger buffer: guard region intact "
            f"{intact}, rel_l2 {rel:.3e}")
        check(intact and rel <= 5e-3, f"K9 wrote past H*64 columns at H = {h}")
        del q, k, v, buf, out
    torch.cuda.empty_cache()
    phase_s["18"] = time.perf_counter() - t0

    # -- phase 19: the bench entry points (K9, K10) and packed=True (K6) --------
    t0 = time.perf_counter()
    variant_wrappers = (flash_fwd_packed, flash_attention_pairs, run_variant)
    reset(*variant_wrappers)
    rows = bench_flash_variants.main([]) + bench_flash_pairs.main([])
    bench_ms = {(r["L"], r["heads"], r["row"]): r["ms"] for r in rows}
    by_shape = {name: {} for name in ("flash_fwd_packed", "flash_attention_pairs",
                                      "run_variant")}
    for label, n, l, h in bench_flash_variants.CASES:
        q, k, v = bench_flash_variants.case_inputs(n, l, h, dev)
        q4, k4, v4 = (a.view(n, l, h, 64) for a in (q, k, v))
        k6_ms = cuda_ms(lambda: flash_attention(q4, k4, v4, packed=True), iters=10, warmup=1)
        lib_ms = sdpa_ms(q, k, v, h, iters=10)
        b = attention_bound(n, l, l, h, 64, bf16)
        shape = f"({n}, {l}, {h}*64)"
        common = dict(k1_ms=bench_ms[(l, h, "K1 flash_fwd")], library_ms=lib_ms, **b)
        by_shape["flash_fwd_packed"][shape] = dict(ms=k6_ms, **common)
        by_shape["flash_attention_pairs"][shape] = dict(ms=bench_ms[(l, h, "K9 pairs")], **common)
        by_shape["run_variant"][shape] = dict(
            ms=bench_ms[(l, h, "K10 exp")],
            ms_by_mode={m: bench_ms[(l, h, f"K10 {m}")] for m in ("exp", "exp2", "nosoftmax")},
            **common)
        if l == 2560:
            plain_ms = cuda_ms(lambda: flash_fwd_plain(q, k, v, h, 0.125))
            plain_ns_ms = cuda_ms(lambda: run_variant_plain(q, k, v, h, 0.125, "nosoftmax"))
        modes = by_shape["run_variant"][shape]["ms_by_mode"]
        log(f"[19] {label.strip()} bf16: K1 {common['k1_ms']:.3f} ms | K6 packed {k6_ms:.3f} | "
            f"K9 pairs {bench_ms[(l, h, 'K9 pairs')]:.3f} | K10 exp {modes['exp']:.3f} exp2 "
            f"{modes['exp2']:.3f} nosoftmax {modes['nosoftmax']:.3f} (softmax share of exp2 "
            f"{1 - modes['nosoftmax'] / modes['exp2']:.1%}) | library {lib_ms:.3f} | bound "
            f"{b['bound_ms']:.3f} ms by {b['bound_by']}")
        del q, k, v, q4, k4, v4
    variant_launches = counts(*variant_wrappers)
    first = "(32, 2560, 5*64)"
    for name, label in (("flash_fwd_packed", "K6 flash_fwd_packed"),
                        ("flash_attention_pairs", "K9 flash_attention_pairs"),
                        ("run_variant", "K10 run_variant exp")):
        at = by_shape[name][first]
        report[name] = dict(max_abs_err=worst[(label, bf16)][0], ms=at["ms"], plain_ms=plain_ms,
                            bound_ms=at["bound_ms"], bound_by=at["bound_by"],
                            library_ms=at["library_ms"], by_shape=by_shape[name])
    report["run_variant"].update(
        ms_by_mode=by_shape["run_variant"][first]["ms_by_mode"], plain_ms_nosoftmax=plain_ns_ms,
        max_abs_err_by_mode={m: worst[(f"K10 run_variant {m}", bf16)][0]
                             for m in ("exp", "exp2", "nosoftmax")})
    log(f"[19] launches: K6 {variant_launches[0]} (flash_attention(packed=True) at the three "
        f"shapes), K9 {variant_launches[1]} (bench_flash_pairs.main), K10 "
        f"{variant_launches[2]} (bench_flash_variants.main, three modes) | plain at {first}: "
        f"attention {plain_ms:.3f} ms, nosoftmax {plain_ns_ms:.3f} ms")
    torch.cuda.empty_cache()
    phase_s["19"] = time.perf_counter() - t0


    # -- phase 20: K7 and K8 against their plain versions -----------------------
    t0 = time.perf_counter()
    conv_tol = {fp32: 1e-5, bf16: 1e-2}   # bf16: one rounding of each output, 2^-9 relative

    def conv_check(tag, shape, tile_h, dtype, emb):
        n, h, w, c, co = shape
        ops = list(bench_fused_conv.case_inputs(n, h, w, c, co, dev, dtype))
        if not emb:
            ops[5] = None
        out7 = fused_gn_silu_conv(*ops)
        out8 = fused_gn_silu_conv_tiled(*ops, tile_h=tile_h)
        torch.cuda.synchronize()
        e7 = errors(out7, fused_gn_silu_conv_plain(*ops))
        e8 = errors(out8, fused_gn_silu_conv_tiled_plain(*ops, tile_h=tile_h))
        between = errors(out7, out8)[1]
        log(f"[{tag}] ({n}, {h}, {w}, {c} -> {co}) {str(dtype)[6:]} emb {emb}: K7 max_abs "
            f"{e7[0]:.3e} rel_l2 {e7[1]:.3e}, K8 (tile_h {tile_h}) max_abs {e8[0]:.3e} rel_l2 "
            f"{e8[1]:.3e} (tol {conv_tol[dtype]:g}) | K7 vs K8 rel_l2 {between:.3e}")
        check(e7[1] <= conv_tol[dtype], f"K7 rel L2 {e7[1]} at {shape} {dtype} emb {emb}")
        check(e8[1] <= conv_tol[dtype], f"K8 rel L2 {e8[1]} at {shape} {dtype} emb {emb}")
        if dtype == fp32:
            check(between <= 1e-5, f"K7 vs K8 in fp32 rel L2 {between} at {shape}")
        return e7, e8

    for shape, tile_h in [((2, 8, 12, 64, 64), 8), ((1, 5, 7, 32, 32), 5),
                          ((2, 8, 14, 64, 64), 4), ((2, 20, 32, 320, 640), 4)]:
        for dtype in (fp32, bf16):
            for emb in (False, True):
                conv_check("20", shape, tile_h, dtype, emb)
    phase_s["20"] = time.perf_counter() - t0

    # -- phase 21: K7 and K8 at full width: their bench entry point --------------
    t0 = time.perf_counter()
    conv_wrappers = (fused_gn_silu_conv, fused_gn_silu_conv_tiled)
    reset(*conv_wrappers)
    rows = bench_fused_conv.main([])
    conv_launches = counts(*conv_wrappers)
    conv_ms = {(r["h"], r["c"], r["co"], r["row"]): r["ms"] for r in rows}
    conv_by_shape = {"fused_gn_silu_conv": {}, "fused_gn_silu_conv_tiled": {}}
    first_conv = None
    for label, n, h, w, c, co in bench_fused_conv.CASES:
        e7, e8 = conv_check("21", (n, h, w, c, co), bench_fused_conv.TILE_H[h], bf16, True)
        # x, the kernel, bias and emb read once, the output written once (the
        # norm's 2 C fp32 parameters beside them); 9 products of C x Co per pixel
        b = bound(2 * (n * h * w * (c + co) + 9 * c * co + co + n * c) + 8 * c,
                  2.0 * n * h * w * c * co * 9, bf16)
        shape = f"({n}, {h}, {w}, {c} -> {co})"
        first_conv = first_conv or shape
        at = lambda row: conv_ms[(h, c, co, row)]
        common = dict(plain_ms=at("plain"), library_ms=at("library"), **b)
        conv_by_shape["fused_gn_silu_conv"][shape] = dict(
            ms=at("K7 fused"), max_abs_err=e7[0], rel_l2=e7[1], **common)
        conv_by_shape["fused_gn_silu_conv_tiled"][shape] = dict(
            ms=at("K8 tiled"), max_abs_err=e8[0], rel_l2=e8[1],
            tile_h=bench_fused_conv.TILE_H[h], **common)
        log(f"[21] {label.strip()} bf16: K7 {at('K7 fused'):.3f} ms | K8 {at('K8 tiled'):.3f} | "
            f"plain {at('plain'):.3f} | library (group_norm, silu, conv2d) {at('library'):.3f} "
            f"| bound {b['bound_ms']:.3f} ms by {b['bound_by']}")
    for name in conv_by_shape:
        at = conv_by_shape[name][first_conv]
        report[name] = dict(max_abs_err=at["max_abs_err"], ms=at["ms"], plain_ms=at["plain_ms"],
                            bound_ms=at["bound_ms"], bound_by=at["bound_by"],
                            library_ms=at["library_ms"], by_shape=conv_by_shape[name])
    log(f"[21] launches by bench_fused_conv.main: K7 {conv_launches[0]}, K8 {conv_launches[1]} "
        f"(five shapes x 11 calls each)")
    torch.cuda.empty_cache()
    phase_s["21"] = time.perf_counter() - t0

    # -- phase 22: the kernels compute the model's function ----------------------
    t0 = time.perf_counter()
    n_frames, ch = 32, resblock.in_layers[2].in_channels
    x = torch.randn(n_frames, ch, 40, 64, device=dev, generator=gen).to(bf16).contiguous(
        memory_format=torch.channels_last)
    emb = torch.randn(2, 4 * ch, device=dev, generator=gen).to(bf16)
    nhwc = lambda a: a.permute(0, 2, 3, 1).contiguous()
    hwio = lambda conv: conv.weight.permute(2, 3, 1, 0).contiguous()
    with torch.no_grad():
        gn1, conv1 = resblock.in_layers[0], resblock.in_layers[2]
        gn2, conv2 = resblock.out_layers[0], resblock.out_layers[3]
        h_mod = resblock.in_layers(x)
        emb_out = resblock.emb_layers(emb).to(h_mod.dtype)[:, None].expand(-1, 16, -1)
        emb_out = emb_out.reshape(n_frames, ch).contiguous()
        out_mod = resblock.out_layers(h_mod + emb_out[:, :, None, None])
        rels = {}
        for name, fn in (("K7", fused_gn_silu_conv),
                         ("K8", lambda *a: fused_gn_silu_conv_tiled(*a, tile_h=8))):
            h_k = fn(nhwc(x), hwio(conv1), conv1.bias, gn1.weight, gn1.bias, None)
            out_k = fn(nhwc(h_mod), hwio(conv2), conv2.bias, gn2.weight, gn2.bias, emb_out)
            rels[name] = (errors(h_k, nhwc(h_mod))[1], errors(out_k, nhwc(out_mod))[1])
    log(f"[22] one level-0 ResBlock of {CONFIG} ({ch} -> {ch}, N(0, 0.02) weights) on "
        f"({n_frames}, {ch}, 40, 64) bf16: in_layers(x) and out_layers(h + emb_out) through "
        f"the module vs the kernels fed its parameters, rel_l2 "
        + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in rels.items()) + " (tol 2e-2)")
    check(all(max(r) <= 2e-2 for r in rels.values()), f"ResBlock through K7/K8: {rels}")
    del resblock, x, emb, h_mod, out_mod, emb_out, h_k, out_k
    torch.cuda.empty_cache()
    phase_s["22"] = time.perf_counter() - t0

    # -- phase 23: SDS guidance end to end ----------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset(*infer_wrappers)
        t1 = time.perf_counter()
        result = generate_guidance.main([
            "--config", CONFIG, "--prompt_dir", PROMPTS, "--savedir", tmp, "--resolution",
            "320_512", "--random_init", "--bf16", "--num_steps", str(STEPS_SDS),
            "--debug_save_interval", "10", "--save_results", "--seed", str(SEED),
            "--device", "cuda"])
        wall = time.perf_counter() - t1
        n_sds = counts(*infer_wrappers)
        out = result["outputs"][0]
        frames_file = np.load(os.path.join(tmp, "example.npy"))
        debug_files = sorted(os.listdir(os.path.join(tmp, "debug", "example", "debug")))
    clock, peak = result["timings"][0], result["peaks"][0]
    secs = clock["steps"]
    # the init the pipeline drew: encode noise first, then the latents
    g = torch.Generator(device=dev).manual_seed(SEED)
    torch.randn((16, 40, 64, 4), generator=g, device=dev)
    init = torch.randn((1, 16, 40, 64, 4), generator=g, device=dev).cpu().numpy()
    moved = float(np.abs(out["latents"] - init).mean())
    log(f"[23] SDS {CONFIG} bf16, {STEPS_SDS} steps, lr 0.01, AdamW, weight t: frames "
        f"{out['videos'].shape} finite {bool(np.isfinite(out['videos']).all())}, file "
        f"{frames_file.shape} {frames_file.dtype} | loss " + " ".join(
            f"{v:.4f}" for v in out["loss_curve"][::5]) + f" (every 5th of "
        f"{len(out['loss_curve'])}) | latents moved by mean abs {moved:.4f} | s/step first "
        f"{secs[0]:.3f}, mean after {np.mean(secs[1:]):.4f} | conditioning "
        f"{clock['conditioning']:.2f}s loop {clock['loop']:.2f}s (with 2 debug decodes) decode "
        f"{clock['decode']:.2f}s | peaks " + " ".join(
            f"{k} {v / 2**30:.2f}" for k, v in peak.items())
        + f" GiB, building {result['build_peak'] / 2**30:.2f} | main() wall {wall:.1f}s | "
        f"launches K1 {n_sds[0]} K2 {n_sds[1]} K5 {n_sds[2]} | debug tree {len(debug_files)} "
        f"files")
    check(out["videos"].shape == (1, 16, 320, 512, 3) and bool(np.isfinite(out["videos"]).all()),
          "SDS frames")
    check(frames_file.shape == (16, 320, 512, 3) and frames_file.dtype == np.uint8
          and len(np.unique(frames_file)) > 1, "SDS frame file")
    check(out["loss_curve"].shape == (STEPS_SDS,) and bool(np.isfinite(out["loss_curve"]).all()),
          "SDS loss curve")
    check(0.01 < moved < 0.01 * STEPS_SDS + 0.01, f"SDS latents moved by {moved}")
    check(n_sds == (per_call[0] * STEPS_SDS, per_call[1] * STEPS_SDS, 0),
          f"launches under SDS {n_sds}")
    check({"step_000000_frame.png", "step_000010_frame_00.png"} <= set(debug_files),
          f"SDS debug tree {debug_files}")
    # two steps with fixed draws, kernels against plain
    sds2 = SDSGuidancePipeline(result["pipeline"].pipe, SDSSettings(
        num_steps=2, log_every=2, guidance_rescale=0.7, timestep_spacing="uniform_trailing",
        optimizer_type="AdamW"))
    fixed = SDSDraws(torch.randint(0, len(sds2.t_grid), (2, 1), generator=g, device=dev),
                     torch.randn((2, 1, 16, 40, 64, 4), generator=g, device=dev))
    enc_noise = torch.randn((16, 40, 64, 4), generator=g, device=dev).cpu().numpy()
    video = np.repeat(decode_png(os.path.join(PROMPTS, "example.png"))[None, None]
                      .astype(np.float32) / 127.5 - 1.0, 16, axis=1)
    run2 = lambda: sds2(["a clip"], video, fs=[24], init_latents=init, decode=False,
                        encode_noise=enc_noise, draws=fixed)["latents"]
    lat_k = run2()
    with attention.use_backend("plain"):
        lat_p = run2()
    rel = float(np.linalg.norm(lat_k - lat_p) / np.linalg.norm(lat_p))
    rel_update = float(np.linalg.norm(lat_k - lat_p) / np.linalg.norm(lat_p - init))
    log(f"[23] two SDS steps with fixed draws, kernels vs plain: latents rel_l2 {rel:.3e} "
        f"(tol 2e-2), as a share of the update {rel_update:.3e}")
    check(rel <= 2e-2, f"SDS kernels vs plain rel L2 {rel}")
    del result, out, sds2, fixed
    torch.cuda.empty_cache()
    phase_s["23"] = time.perf_counter() - t0

    # -- phase 24: the app backend --------------------------------------------------
    t0 = time.perf_counter()
    image = decode_png(os.path.join(PROMPTS, "example.png"))
    n_app = {}
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        for mode, n_out in (("i2v", 16), ("loop", 15)):
            backend = Image2Video(os.path.join(tmp, mode), resolution="320_512",
                                  random_init=True, mode=mode)
            sampled = []   # what the pipeline handed the backend, before the uint8 clamp
            sample = backend.pipe.sample
            backend.pipe.sample = lambda *a, **k: sampled.append(sample(*a, **k)) or sampled[-1]
            reset(*infer_wrappers)
            clock = {}
            path = backend.get_image(image, "a fox running through snow", steps=STEPS_APP,
                                     seed=SEED, image2=image if mode == "loop" else None,
                                     timings=clock)
            n_app[mode] = counts(*infer_wrappers)
            frames = read_clip(path)
            finite = bool(np.isfinite(sampled[0].videos).all())
            log(f"[24] Image2Video 320_512 mode {mode}, {STEPS_APP} steps: {os.path.basename(path)} "
                f"({os.path.getsize(path)} bytes) {frames.shape} {frames.dtype} levels "
                f"{len(np.unique(frames))} finite {finite} | "
                + " ".join(f"{k} {v:.2f}s" for k, v in clock.items())
                + f" | launches K1 {n_app[mode][0]} K2 {n_app[mode][1]}")
            check(finite and frames.shape == (n_out, 320, 512, 3) and frames.dtype == np.uint8
                  and len(np.unique(frames)) > 1, f"app {mode}: frames {frames.shape}")
            check(n_app[mode] == (per_call[0] * STEPS_APP, per_call[1] * STEPS_APP, 0),
                  f"launches in app mode {mode}: {n_app[mode]}")
            del backend
            torch.cuda.empty_cache()
    phase_s["24"] = time.perf_counter() - t0

    log("[wall] " + " ".join(f"phase {k} {v:.1f}s" for k, v in phase_s.items())
        + f" | total {time.perf_counter() - t_start:.1f}s")

    src = "dynamicrafter_tpu_torch/csrc/"
    tpu = "dynamicrafter_tpu/ops/"
    exp = "experiments/flash_pairs/"
    # name: (source, TPU kernel, launches on the kernel's main path, on every path)
    sources = {
        "flash_fwd": (src + "flash_attention.cu", tpu + "flash_attention.py:161", launches[0],
                      {"inference_512": launches[0], "inference_256_bs8": launches_256[0],
                       "inference_1024": launches_1024[0], "inference_512_dpm30": n_dpm[0],
                       "inference_512_unipc20": n_unipc[0],
                       "inference_512_deepcache5": n_dc[0], "sds_512": n_sds[0],
                       "app_512": n_app["i2v"][0] + n_app["loop"][0]}),
        "small_t_fwd_tmajor": (src + "small_attention.cu", tpu + "small_attention.py:134",
                               launches[1],
                               {"inference_512": launches[1], "train_512": train_launches[3],
                                "inference_256_bs8": launches_256[1],
                                "inference_1024": launches_1024[1],
                                "inference_512_dpm30": n_dpm[1],
                                "inference_512_unipc20": n_unipc[1],
                                "inference_512_deepcache5": n_dc[1], "sds_512": n_sds[1],
                                "app_512": n_app["i2v"][1] + n_app["loop"][1]}),
        "flash_fwd_lse": (src + "flash_attention.cu", tpu + "flash_attention.py:32",
                          train_launches[0], {"train_512": train_launches[0]}),
        "flash_bwd_dq": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:304",
                         train_launches[1], {"train_512": train_launches[1]}),
        "flash_bwd_dkv": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:339",
                          train_launches[2], {"train_512": train_launches[2]}),
        "small_t_fwd": (src + "small_attention.cu", tpu + "small_attention.py:32",
                        launches_256[2], {"inference_256_bs8": launches_256[2],
                                          "inference_1024": launches_1024[2]}),
        "flash_fwd_packed": (src + "flash_packed.cu", tpu + "flash_attention.py:479",
                             variant_launches[0],
                             {"flash_attention_packed": variant_launches[0]}),
        "flash_attention_pairs": (src + "flash_pairs.cu", exp + "flash_pairs.py:44",
                                  variant_launches[1],
                                  {"bench_flash_pairs": variant_launches[1]}),
        "run_variant": (src + "flash_variants.cu", exp + "bench_flash_variants.py:25",
                        variant_launches[2], {"bench_flash_variants": variant_launches[2]}),
        "fused_gn_silu_conv": (src + "fused_conv.cu", "experiments/fused_conv/fused_conv.py:36",
                               conv_launches[0], {"bench_fused_conv": conv_launches[0]}),
        "fused_gn_silu_conv_tiled": (src + "fused_conv.cu",
                                     "experiments/fused_conv/fused_conv_tiled.py:28",
                                     conv_launches[1], {"bench_fused_conv": conv_launches[1]})}
    for name, (_, _, n, _) in sources.items():
        check(n > 0, f"{name} was launched no time on its main path")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=rep, launches=n,
             launches_by_path=by_path, **report[name])
        for name, (source, rep, n, by_path) in sources.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
