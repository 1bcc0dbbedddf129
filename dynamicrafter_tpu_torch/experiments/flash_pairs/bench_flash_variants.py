"""K10, and where the flash forward's time goes at the model's hot shapes.

`run_variant` computes K1's function (`csrc/flash_variants.cu`) in one of
three modes, any finite scale:

  * `exp`       natural-log logits through `__expf`;
  * `exp2`      log2(e) folded into the scale, `exp2f` (what K1 does);
  * `nosoftmax` the two products only: p = clip(q k^T * scale, -1, 1),
                l = 1. NOT attention: the time of the products on the same
                data movement, which bounds what any change to the softmax
                can gain.

bf16 inputs run both products on the tensor cores through the loop K1, K6
and K9 share (`csrc/flash_tc.cuh`, the mode a switch in its softmax step),
on K1's tile and grid, one head a block: in mode `exp2` the output is K1's
bit for bit, so 1 - nosoftmax / exp2 is the softmax's share of the loop K1
runs. fp32 inputs run the FMA kernel, one block walking all heads as the
Pallas body does.

It replaces `experiments/flash_pairs/bench_flash_variants.py::_kernel` of the
JAX repository (entry `run_variant` there, without the Pallas tile sizes).
On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
`run_variant_plain`.

    python -m dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants

times K1 and the three modes at the three hot self-attention shapes (bf16,
batched-CFG N = 32) with CUDA events and prints milliseconds and TFLOP/s
per row. It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from dynamicrafter_tpu_torch.ops import kernels
from dynamicrafter_tpu_torch.ops.flash_attention import (
    _heads, _unheads, check_qkv, flash_fwd, flash_fwd_plain)
from dynamicrafter_tpu_torch.utils import trace

# the C entry point's mode codes (dct::SoftmaxMode in csrc/flash_tile.cuh)
MODES = {"exp2": 0, "exp": 1, "nosoftmax": 2}

# (label, N, L, H): level 0 at 320x512, levels 0 and 1 at 576x1024, all under
# batched CFG (2 x 16 frames)
CASES = [
    ("512 ds1  L=2560 H=5 ", 32, 2560, 5),
    ("1024 ds1 L=9216 H=5 ", 32, 9216, 5),
    ("1024 ds2 L=2304 H=10", 32, 2304, 10),
]


def run_variant_plain(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float,
                      mode: str) -> Tensor:
    """The plain version of `run_variant`. `exp` and `exp2` are attention
    (`flash_fwd_plain`). `nosoftmax` is o = clip(q k^T * scale, -1, 1) v per
    head: fp32 logits, p rounded to the input dtype, fp32 accumulation, no
    normaliser (l = 1). The plain version has no padded KV positions; the
    kernel gives the positions that pad its last KV tile p = 0, so the two
    agree at every L (the JAX body masks before the clip, which gives
    padding p = -1 and is only meaningful when its tile divides L)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    if mode != "nosoftmax":
        return flash_fwd_plain(q, k, v, heads, scale)
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    sim = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = sim.clamp(-1.0, 1.0).to(v.dtype)
    return _unheads(torch.matmul(p, vh)).to(q.dtype)


def run_variant(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float,
                mode: str) -> Tensor:
    """K10. q: (N, Lq, H*64), k/v: (N, Lk, H*64) -> (N, Lq, H*64)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    if q.device.type == "cpu":
        return run_variant_plain(q, k, v, heads, scale, mode)
    check_qkv("run_variant", q, k, v, heads)
    n, lq, _ = q.shape
    out = torch.empty_like(q)
    with trace.span("K10", n=n, lq=lq, lk=k.shape[1], heads=heads, mode=mode), \
            torch.cuda.device(q.device):
        code = kernels.library().dct_flash_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], MODES[mode], n, lq, k.shape[1], heads,
            float(scale), kernels.stream_handle(q.device))
    kernels.check(code, f"run_variant[{mode}] launch")
    run_variant.launches += 1
    return out


run_variant.launches = 0


def cuda_device(name: str) -> torch.device:
    """The CUDA device `name`; raises when it is not a CUDA device or there
    is none (the benches time kernels: a CPU has nothing to time)."""
    device = torch.device(name)
    if device.type != "cuda":
        raise ValueError(f"--device {name}: the bench times CUDA kernels")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} but CUDA is not available")
    return device


ITERS = 10   # timed calls per row, after one warm-up call


def cuda_ms(fn: Callable[[], object]) -> float:
    """Mean device milliseconds per call over ITERS back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def case_inputs(n: int, length: int, heads: int,
                device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    """bf16 q, k (scaled by 0.3) and v of one case, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(0)
    draw = lambda: torch.randn(n, length, heads * 64, device=device, generator=gen)
    return ((draw() * 0.3).to(torch.bfloat16), (draw() * 0.3).to(torch.bfloat16),
            draw().to(torch.bfloat16))


def bench_cases(rows: Dict[str, Callable], device: torch.device) -> List[dict]:
    """Time every row's function fn(q, k, v, heads, scale) at every case of
    CASES; prints one line per (case, row) and returns them as dicts. The
    first row is the baseline the others' ratios refer to."""
    results = []
    scale = 64 ** -0.5
    for label, n, length, heads in CASES:
        q, k, v = case_inputs(n, length, heads, device)
        flops = 4.0 * n * heads * length * length * 64
        base = None
        for name, fn in rows.items():
            ms = cuda_ms(lambda: fn(q, k, v, heads, scale))
            base = ms if base is None else base
            print(f"{label} {name:13s}: {ms:8.2f} ms  {flops / ms / 1e9:6.1f} TFLOP/s"
                  f"   ({base / ms:.2f}x)", flush=True)
            results.append(dict(case=label.strip(), n=n, L=length, heads=heads, row=name,
                                ms=ms, tflops=flops / ms / 1e9))
        del q, k, v
    return results


def get_parser(module: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"python -m {module}")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = get_parser(f"{__package__}.bench_flash_variants").parse_args(argv)
    device = cuda_device(args.device)
    print("device:", torch.cuda.get_device_name(device), flush=True)
    rows: Dict[str, Callable] = {"K1 flash_fwd": flash_fwd}
    for mode in ("exp", "exp2", "nosoftmax"):
        rows[f"K10 {mode}"] = lambda q, k, v, h, s, mode=mode: run_variant(q, k, v, h, s, mode)
    return bench_cases(rows, device)


if __name__ == "__main__":
    main()
