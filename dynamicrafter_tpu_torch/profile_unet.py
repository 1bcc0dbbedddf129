"""Where one UNet call spends its device time, by kernel family.

    python -m dynamicrafter_tpu_torch.profile_unet \
        --config configs/inference_256_v1.0.yaml --batch 16 --height 256 --width 256

Builds the full-width UNet of `--config` on the card with random N(0, 0.02)
bf16 weights, runs `--iters` forward calls on a (batch, frames, h/8, w/8, 8)
input under `torch.profiler`, and prints per call: the device milliseconds
of each kernel family, the ten largest kernels, and the share of the
window's wall time in which a kernel was running. `--batch` counts clips in
the UNet call: 2 x prompts under batched CFG, the prompts alone under
sequential CFG. With `--shallow` the profiled call is the DeepCache shallow
forward (`cache=` the deep feature of one full call on the same input): the
call that N - 1 of every N sampler steps make under `--deepcache N`. Needs a
CUDA device. `start_trace` / `stop_trace` are the Chrome-trace sessions
of `inference --profile_dir` and `train --profile_steps`; the program's
spans (`utils/trace.py`) recorded meanwhile go into the same trace as a
process of their own.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from dynamicrafter_tpu_torch.utils import trace

# first match wins; copies before elementwise (a copy is an elementwise kernel
# by name), layout transposes before convolutions
FAMILIES = (
    ("K4a flash_bwd_dq", ("flash_bwd_dq",)),
    ("K4b flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("K4 di pre-pass", ("flash_bwd_di",)),
    ("K6 flash_fwd_packed", ("flash_fwd_packed_tc_kernel", "flash_fwd_packed_kernel")),
    ("K9 flash_attention_pairs", ("flash_fwd_pairs_tc_kernel", "flash_fwd_pairs_kernel")),
    ("K10 run_variant", ("flash_variants_tc_kernel", "flash_variants_kernel")),
    ("K1 flash_fwd", ("flash_fwd_tc_kernel", "flash_fwd_fma_kernel")),
    ("K5 small_t_fwd", ("small_t_posmajor_tc_kernel", "small_t_posmajor_kernel")),
    ("K2 small_t_kernel", ("small_t_tc_kernel", "small_t_kernel")),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("conv", "fprop", "xmma", "cudnn", "implicit_gemm")),
    ("GroupNorm + LayerNorm", ("RowwiseMoments", "GroupNorm", "group_norm", "layer_norm",
                               "LayerNorm")),
    ("softmax", ("softmax", "Softmax")),
    ("dtype and layout copies", ("copy", "Copy", "CatArray")),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "cublas")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized")),
)


def family(kernel_name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in kernel_name for k in keys):
            return fam
    return "other"


def profile_families(run: Callable[[], object], iters: int):
    """Run `run` `iters` times under `torch.profiler` (CPU and CUDA
    activity). Returns device milliseconds per run by family and by kernel
    name, the window's wall milliseconds, and the number of kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    by_family, by_kernel = collections.Counter(), collections.Counter()
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        by_family[family(evt.name)] += us / 1e3 / iters
        by_kernel[evt.name] += us / 1e3 / iters
        n_kernels += 1
    return by_family, by_kernel, window_ms, n_kernels


def start_trace(device: torch.device) -> Tuple[torch.profiler.profile, trace.Recording]:
    """A started `torch.profiler` session over the host and, on a CUDA
    device, the card, and a recording of the program's spans."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof, trace.recording()


def stop_trace(session: Tuple[torch.profiler.profile, trace.Recording], device: torch.device,
               out_dir: str) -> str:
    """Stop `start_trace`'s session after the device has finished; write its
    Chrome trace `<out_dir>/trace.json`, the recorded spans in it as a
    process of their own ("spans", a track per thread, on the trace's
    clock), and return that path."""
    prof, rec = session
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    rec.close()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += rec.chrome_events(int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--fs", type=int, default=24)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shallow", action="store_true",
                   help="profile the DeepCache shallow forward instead of the full one")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_unet needs a CUDA device")
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
    from dynamicrafter_tpu_torch.utils.weights import init_normal_

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cfg = ModelConfig.from_yaml(args.config)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(cfg.unet))
    unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
    init_normal_(unet.requires_grad_(False), gen, 0.02)
    b, t = args.batch, args.frames
    x = torch.randn(b, t, args.height // 8, args.width // 8, 8, device=dev, generator=gen)
    ts = torch.full((b,), 500, dtype=torch.long, device=dev)
    ctx_t = torch.randn(b, 77, 1024, device=dev, generator=gen)
    ctx_i = torch.randn(b, t, 16, 1024, device=dev, generator=gen)
    fs = torch.full((b,), args.fs, dtype=torch.long, device=dev)
    kw = dict(context_text=ctx_t, context_img=ctx_i, fs=fs)
    with torch.no_grad():
        if args.shallow:
            kw["cache"] = unet(x, ts, return_cache=True, **kw)[1]
        run = lambda: unet(x, ts, **kw)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
        unprofiled_ms = 1e3 * (time.perf_counter() - t0) / args.iters
        by_family, by_kernel, window_ms, n_kernels = profile_families(run, args.iters)
    total = sum(by_family.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"profile_unet {args.config} {'shallow (DeepCache) ' if args.shallow else ''}input ({b}, {t}, {args.height // 8}, {args.width // 8}, 8) "
          f"bf16 on {smi}: {unprofiled_ms:.1f} ms per call unprofiled; under the profiler "
          f"{window_ms / args.iters:.1f} ms per call, device time {total:.1f} ms per call "
          f"({100 * total * args.iters / window_ms:.1f} % of the window busy), "
          f"{n_kernels // args.iters} kernels per call")
    for fam, ms in by_family.most_common():
        print(f"  {fam:<28s} {ms:9.2f} ms  {100 * ms / total:5.1f} %")
    print("  largest kernels:")
    for name, ms in by_kernel.most_common(10):
        print(f"    {ms:8.2f} ms  {name[:110]}")
    return {"families": dict(by_family), "device_ms": total, "unprofiled_ms": unprofiled_ms}


if __name__ == "__main__":
    main()
