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
     and that both kernels ran on that path.

Then a JSON line with each kernel's launches on the phase-5 path, error and
times, the nvidia-smi line, and last `{"ok": true, "device": {...}}`.
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
PROMPTS = "prompts/512"
STEPS = 50
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dynamicrafter_tpu_torch import inference
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.ops import attention, kernels
    from dynamicrafter_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
    from dynamicrafter_tpu_torch.ops.small_attention import (
        small_t_fwd_tmajor, small_t_fwd_tmajor_plain)
    from dynamicrafter_tpu_torch.utils.weights import init_normal_

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
    t0 = time.perf_counter()
    kernels.library()
    regs = [ln.split(":", 1)[1].strip() for ln in kernels.build_log.splitlines()
            if "Used" in ln]
    log(f"[1] device {kind!r} | nvidia-smi {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | allow_tf32 matmul=False cudnn=False | "
        f"kernels built in {time.perf_counter() - t0:.2f}s (nvcc "
        f"{kernels.build_seconds:.2f}s) | ptxas: {'; '.join(regs)}")

    report = {}

    # -- phase 2: K1 ------------------------------------------------------
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

    # -- phase 3: K2 ------------------------------------------------------
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

    # -- phase 4: full-width UNet forward, kernels vs plain ---------------
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

    # -- phase 5: the slice end to end -------------------------------------
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

    sources = {"flash_fwd": ("dynamicrafter_tpu_torch/csrc/flash_attention.cu",
                             "dynamicrafter_tpu/ops/flash_attention.py:161", launches[0]),
               "small_t_fwd_tmajor": ("dynamicrafter_tpu_torch/csrc/small_attention.cu",
                                      "dynamicrafter_tpu/ops/small_attention.py:134",
                                      launches[1])}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=n, **report[name])
        for name, (src, rep, n) in sources.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
