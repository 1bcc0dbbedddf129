"""The norm kernels at the main path's shapes, beside the island and the library.

    python -m dynamicrafter_tpu_torch.bench_norms [--device cuda]

For each row, the device milliseconds of one call as the mean over replays
of a CUDA graph that holds ITERS calls (so the host's pace is not timed) of:
the kernel (`ops/norms.py`'s `group_norm_act` / `layer_norm`), the fp32
island the port ran before (`group_norm_act_plain` / `layer_norm_plain`:
x.float(), the library norm in fp32, a cast, SiLU and the emb add as passes
of their own) and the library on bf16 (`F.group_norm` + `F.silu`, the add
before them; `F.layer_norm`), used nowhere in the package. The bound is the
input read once and the output written once at 3.35 TB/s (the fp32 affine,
and emb, beside them); `share` is the bound over the kernel's time. GroupNorm
rows come in both layouts the kernel reads: per channel (contiguous, or a
clip's view of that) and channels-last (`cl`: the UNet's and the VAE's
activations as their convs leave them, and a clip's views of those: SVD-XT's
too, the decoder's whole 25-frame clip among them). Each GroupNorm row names
the plan the kernel took (`norms.GN_PLANS`). Inputs of 50 MB or more do not
fit in L2; smaller ones are read warm. Prints one line a row and returns the
rows. It needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from dynamicrafter_tpu_torch.models.blocks import _to_clip
from dynamicrafter_tpu_torch.ops import norms

PEAK_BYTES = 3.35e12   # one H100 SXM's HBM3
ITERS = 20             # calls a graph
REPLAYS = 5

def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


# (label, x maker (device) -> bf16 x, per-frame emb add and SiLU): ResBlock
# and TemporalConvBlock norms (with SiLU), the transformers' (without), the
# VAE decoder's last level at a 512 x 512 tile
GN_CASES = [
    ("frame 32x320 40x64 +emb silu", lambda d: torch.randn(32, 320, 40, 64, device=d), True),
    ("frame 16x320 72x128 +emb silu", lambda d: torch.randn(16, 320, 72, 128, device=d), True),
    ("frame 16x640 72x128 +emb silu", lambda d: torch.randn(16, 640, 72, 128, device=d), True),
    ("frame 16x960 72x128 +emb silu", lambda d: torch.randn(16, 960, 72, 128, device=d), True),
    ("frame 32x1280 5x8 +emb silu", lambda d: torch.randn(32, 1280, 5, 8, device=d), True),
    ("frame 16x320 72x128", lambda d: torch.randn(16, 320, 72, 128, device=d), False),
    ("vae 4x128 512x512 silu", lambda d: torch.randn(4, 128, 512, 512, device=d), None),
    ("clip b1 320 T16 72x128 silu",
     lambda d: _to_clip(torch.randn(16, 320, 72, 128, device=d), 16), None),
    ("clip b1 320 T16 72x128 (transpose)",
     lambda d: torch.randn(1, 16, 320, 72 * 128, device=d).transpose(1, 2), False),
    ("clip b2 320 T16 72x128 (transpose)",
     lambda d: torch.randn(2, 16, 320, 72 * 128, device=d).transpose(1, 2), False),
    ("clip b2 320 T16 40x64 silu",
     lambda d: _to_clip(torch.randn(32, 320, 40, 64, device=d), 16), None),
    ("cl frame 32x320 40x64 +emb silu", lambda d: _cl(torch.randn(32, 320, 40, 64, device=d)),
     True),
    ("cl frame 16x320 72x128 +emb silu", lambda d: _cl(torch.randn(16, 320, 72, 128, device=d)),
     True),
    ("cl frame 16x640 72x128 +emb silu", lambda d: _cl(torch.randn(16, 640, 72, 128, device=d)),
     True),
    ("cl frame 16x960 72x128 +emb silu", lambda d: _cl(torch.randn(16, 960, 72, 128, device=d)),
     True),
    ("cl frame 32x1280 5x8 +emb silu", lambda d: _cl(torch.randn(32, 1280, 5, 8, device=d)), True),
    ("cl frame 16x320 72x128", lambda d: _cl(torch.randn(16, 320, 72, 128, device=d)), False),
    ("cl vae 4x128 512x512 silu", lambda d: _cl(torch.randn(4, 128, 512, 512, device=d)), None),
    ("cl clip b1 320 T16 72x128 silu",
     lambda d: _to_clip(_cl(torch.randn(16, 320, 72, 128, device=d)), 16), None),
    ("cl clip b1 320 T16 72x128 (transpose)",
     lambda d: _cl(torch.randn(16, 320, 72, 128, device=d)).view(1, 16, 320, 72 * 128)
     .transpose(1, 2), False),
    ("cl clip b2 320 T16 40x64 silu",
     lambda d: _to_clip(_cl(torch.randn(32, 320, 40, 64, device=d)), 16), None),
    ("cl clip b2 320 T25 72x128 silu (SVD)",
     lambda d: _to_clip(_cl(torch.randn(50, 320, 72, 128, device=d)), 25), None),
    ("cl clip b1 128 T25 576x1024 silu (SVD decoder)",
     lambda d: _to_clip(torch.empty(25, 128, 576, 1024, device=d, dtype=torch.bfloat16,
                                    memory_format=torch.channels_last).normal_(), 25), None),
]
# (label, rows, width): the transformers' norm1..3 at each level, CLIP's towers
LN_CASES = [
    ("ln 147456x320 (16x72x128)", 16 * 72 * 128, 320),
    ("ln 36864x640 (16x36x64)", 16 * 36 * 64, 640),
    ("ln 9216x1280 (16x18x32)", 16 * 18 * 32, 1280),
    ("ln 81920x320 (32x40x64)", 32 * 40 * 64, 320),
    ("ln 4112x1280 (16x257, CLIP vision)", 16 * 257, 1280),
    ("ln 154x1024 (2x77, CLIP text)", 2 * 77, 1024),
]


def graph_ms(fn: Callable[[], object]) -> float:
    """Mean device ms of one call: ITERS calls captured in a CUDA graph,
    replayed REPLAYS times after a warm-up replay."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (REPLAYS * ITERS)
    del graph
    return ms


def _row(label: str, nbytes: int, fns: Dict[str, Callable[[], object]], **extra) -> dict:
    row = {"case": label, **extra, "bound_ms": 1e3 * nbytes / PEAK_BYTES}
    for name, fn in fns.items():
        row[f"{name}_ms"] = graph_ms(fn)
    row["share_pct"] = 100.0 * row["bound_ms"] / row["kernel_ms"]
    print("  ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items()), flush=True)
    return row


def bench_group_norm(device: torch.device) -> List[dict]:
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for label, make, emb in GN_CASES:
        torch.manual_seed(0)
        x = make(device).to(torch.bfloat16)
        c = x.shape[1]
        w = 1.0 + 0.1 * torch.randn(c, device=device, generator=gen)
        b = 0.1 * torch.randn(c, device=device, generator=gen)
        add = (0.5 * torch.randn(x.shape[0], c, 1, 1, device=device, generator=gen)
               ).to(torch.bfloat16) if emb else None
        silu = emb is not False

        def library(x=x, w=w, b=b, add=add, silu=silu):
            y = F.group_norm(x if add is None else x + add, 32, w.to(x.dtype), b.to(x.dtype), 1e-6)
            return F.silu(y) if silu else y

        fns = {
            "kernel": lambda: norms.group_norm_act(x, w, b, 32, 1e-6, add, silu),
            "plain": lambda: norms.group_norm_act_plain(x, w, b, 32, 1e-6, add, silu),
            "library": library,
        }
        nbytes = 2 * 2 * x.numel() + 8 * c + (2 * add.numel() if add is not None else 0)
        before = dict(norms.group_norm_act.launches_by_plan)
        fns["kernel"]()
        plan = next(k for k, n in norms.group_norm_act.launches_by_plan.items()
                    if n != before.get(k, 0))
        rows.append(_row(label, nbytes, fns, plan=plan))
        del x
    return rows


def bench_layer_norm(device: torch.device) -> List[dict]:
    rows = []
    gen = torch.Generator(device=device).manual_seed(1)
    for label, n_rows, c in LN_CASES:
        x = torch.randn(n_rows, c, device=device, generator=gen).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(c, device=device, generator=gen)
        b = 0.1 * torch.randn(c, device=device, generator=gen)
        fns = {
            "kernel": lambda: norms.layer_norm(x, w, b, 1e-5),
            "plain": lambda: norms.layer_norm_plain(x, w, b, 1e-5),
            "library": lambda: F.layer_norm(x, (c,), w.to(x.dtype), b.to(x.dtype), 1e-5),
        }
        rows.append(_row(label, 2 * 2 * x.numel() + 8 * c, fns))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(prog=f"python -m {__name__}")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: the bench times CUDA kernels on a card")
    print("device:", torch.cuda.get_device_name(device), flush=True)
    with torch.no_grad():
        return bench_group_norm(device) + bench_layer_norm(device)


if __name__ == "__main__":
    main()
