"""K7 and K8 at the UNets' full-width ResBlock shapes, beside the library route.

    python -m dynamicrafter_tpu_torch.experiments.fused_conv.bench_fused_conv

Times, with CUDA events in bf16 with emb, `fused_gn_silu_conv` (K7: `gn_stats`
and the wgmma conv), `fused_gn_silu_conv_tiled` (K8: `gn_stats` in two-pass
mode and the same conv, x + emb rounded inside it) and the library route
(`F.conv2d(F.silu(F.group_norm(x + emb)))` on a channels-last tensor: cuDNN
and PyTorch's own kernels) in turn: ROUNDS rounds of ITERS calls of each,
the median of each row, so that the clock's drift between rounds falls on
all three alike. Then, each in a loop of its own, `gn_stats` alone (moments
and two-pass) beside one `torch.var_mean` over the same groups, `F.conv2d`
alone on the activation the library route feeds it, and K7's plain version;
`gn_stats` also as replays of a CUDA graph (`kernel_ms`), since back to
back its wrapper calls are paced by the host. Prints milliseconds per row and,
for the kernels, TFLOP/s, the share of the
bound (`conv_bound`) and the factor over the library route. The library
calls are timed here and used nowhere in the package; the UNet runs none of
the fused kernels: these entry points are their path, as in the JAX
repository. It needs a CUDA device and raises without one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants import (
    cuda_device, cuda_ms, get_parser)
from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv import (
    fused_gn_silu_conv, fused_gn_silu_conv_plain, gn_stats)
from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv_tiled import (
    fused_gn_silu_conv_tiled)

# (label, N, H, W, C, Co): the ResBlock convs of the 320x512 UNet at its four
# widths with N = 2 x 16 frames (batched CFG), and level 0 of the 576x1024
# UNet with the 16 frames of one pass of sequential CFG
CASES = [
    ("512 ds1 40x64 320->320   ", 32, 40, 64, 320, 320),
    ("512 ds2 20x32 640->640   ", 32, 20, 32, 640, 640),
    ("512 ds4 10x16 1280->1280 ", 32, 10, 16, 1280, 1280),
    ("512 ds2 20x32 320->640   ", 32, 20, 32, 320, 640),
    ("1024 ds1 72x128 320->320 ", 16, 72, 128, 320, 320),
]
TILE_H = {72: 8, 40: 8, 20: 10, 10: 10}   # K8's row tile per image height (a divisor)
ROUNDS = 5                                # rounds of the in-turn timing
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12   # one H100 SXM at 700 W


def conv_bound(n: int, h: int, w: int, c: int, co: int) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time one call could take on
    an H100 in bf16: x, the kernel, bias and emb read once and the output
    written once (the norm's 2 C fp32 parameters beside them), or the nine
    products of C x Co per pixel at the peak rate, whichever is larger."""
    by_bytes = 1e3 * (2 * (n * h * w * (c + co) + 9 * c * co + co + n * c) + 8 * c) / PEAK_BYTES
    by_ops = 1e3 * 2.0 * n * h * w * c * co * 9 / PEAK_BF16_FLOPS
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def stats_bound(n: int, h: int, w: int, c: int) -> float:
    """ms to read x and emb once and write the (N, C) fp32 scale and bias."""
    return 1e3 * (2 * n * h * w * c + 2 * n * c + 8 * n * c + 8 * c) / PEAK_BYTES


def case_inputs(n: int, h: int, w: int, c: int, co: int, device: torch.device,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, ...]:
    """x, kernel, bias, gn_scale, gn_bias, emb of one case, drawn on the
    device; the kernel at the scale of a trained conv (std 1 / sqrt(9 C))."""
    gen = torch.Generator(device=device).manual_seed(0)
    draw = lambda *shape: torch.randn(shape, device=device, generator=gen)
    return (draw(n, h, w, c).to(dtype), (draw(3, 3, c, co) * (9 * c) ** -0.5).to(dtype),
            (draw(co) * 0.1).to(dtype), draw(c) * 0.2 + 1, draw(c) * 0.2,
            draw(n, c).to(dtype))


def library_route(x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor, gn_bias: Tensor,
                  emb: Tensor, groups: int = 32, eps: float = 1e-5, conv_only: bool = False):
    """The same function through PyTorch's own operators, as the UNet's
    ResBlock runs it: NCHW views of channels-last tensors, everything in
    x's dtype. Returns a closure over the prepared operands (the OIHW
    channels-last weight is prepared once, as a module holds it); with
    `conv_only` the closure runs only its `F.conv2d`, on the activation the
    route computes once here."""
    x_nchw, e = x.permute(0, 3, 1, 2), emb[:, :, None, None]
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    gs, gb = gn_scale.to(x.dtype), gn_bias.to(x.dtype)
    act = lambda: F.silu(F.group_norm(x_nchw + e, groups, gs, gb, eps))
    if conv_only:
        a = act()
        return lambda: F.conv2d(a, w_oihw, bias, padding=1)
    return lambda: F.conv2d(act(), w_oihw, bias, padding=1)


def kernel_ms(fn) -> float:
    """Device milliseconds per call of the kernels `fn` launches, timed as
    replays of a CUDA graph of one call: the host's time per wrapper call is
    left out (a `gn_stats` call launches 0.01-0.09 ms of work, less than
    the host takes for a wrapper call)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay)


def in_turn(rows: Dict[str, object], rounds: int = ROUNDS) -> Dict[str, List[float]]:
    """`rounds` rounds of timing every row once (cuda_ms), in turn."""
    times = {name: [] for name in rows}
    for _ in range(rounds):
        for name, fn in rows.items():
            times[name].append(cuda_ms(fn))
    return times


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = get_parser(f"{__package__}.bench_fused_conv").parse_args(argv)
    device = cuda_device(args.device)
    print("device:", torch.cuda.get_device_name(device), flush=True)
    results = []
    for label, n, h, w, c, co in CASES:
        ops = case_inputs(n, h, w, c, co, device)
        x, _, _, gs, gb, emb = ops
        flops = 2.0 * n * h * w * c * co * 9
        bound_ms, bound_by = conv_bound(n, h, w, c, co)
        times = in_turn({"K7 fused": lambda: fused_gn_silu_conv(*ops),
                         "K8 tiled": lambda: fused_gn_silu_conv_tiled(*ops, tile_h=TILE_H[h]),
                         "library": library_route(*ops)})
        ms = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
        grouped = x.view(n, h * w, 32, c // 32)
        for name, fn in (
                ("gn_stats", lambda: gn_stats(x, gs, gb, emb)),
                ("gn_stats two-pass", lambda: gn_stats(x, gs, gb, emb, two_pass=True)),
                ("var_mean", lambda: torch.var_mean(grouped, dim=(1, 3), correction=0)),
                ("conv2d", library_route(*ops, conv_only=True)),
                ("plain", lambda: fused_gn_silu_conv_plain(*ops))):
            ms[name] = cuda_ms(fn)
        for name, t in ms.items():
            line = f"{label} {name:17s}: {t:8.3f} ms"
            row = dict(case=label.strip(), n=n, h=h, w=w, c=c, co=co, row=name, ms=t)
            if name in times:
                line += f" (median of {ROUNDS} in turn; {min(times[name]):.3f}-{max(times[name]):.3f})"
            if name in ("K7 fused", "K8 tiled", "library", "conv2d", "plain"):
                row.update(tflops=flops / t / 1e9, bound_share=bound_ms / t,
                           over_library=t / ms["library"])
                line += (f"  {row['tflops']:6.1f} TFLOP/s, {row['bound_share']:6.1%} of the "
                         f"{bound_ms:.3f} ms bound ({bound_by}), {row['over_library']:.2f}x "
                         "the library route")
            elif name.startswith("gn_stats"):
                two_pass = name.endswith("two-pass")
                dev_ms = kernel_ms(lambda: gn_stats(x, gs, gb, emb, two_pass=two_pass))
                row.update(device_ms=dev_ms, bound_share=stats_bound(n, h, w, c) / dev_ms)
                line += (f" (device {dev_ms:.4f} ms, {row['bound_share']:6.1%} of the "
                         f"{stats_bound(n, h, w, c):.4f} ms bound, bytes)")
            print(line, flush=True)
            results.append(row)
        del ops, x, grouped
    return results


if __name__ == "__main__":
    main()
