"""K7 and K8 at the UNets' full-width ResBlock shapes, beside the library route.

    python -m dynamicrafter_tpu_torch.experiments.fused_conv.bench_fused_conv

times `fused_gn_silu_conv` (K7), `fused_gn_silu_conv_tiled` (K8), K7's plain
version and the library route (`F.conv2d(F.silu(F.group_norm(x + emb)))` on a
channels-last tensor: cuDNN and PyTorch's own kernels, timed here and used
nowhere in the package) with CUDA events, in bf16 with emb, and prints
milliseconds and TFLOP/s per row. The UNet runs none of the fused kernels:
these entry points are their path, as in the JAX repository. It needs a CUDA
device and raises without one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants import (
    cuda_device, cuda_ms, get_parser)
from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv import (
    fused_gn_silu_conv, fused_gn_silu_conv_plain)
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
                  emb: Tensor, groups: int = 32, eps: float = 1e-5):
    """The same function through PyTorch's own operators, as the UNet's
    ResBlock runs it: NCHW views of channels-last tensors, everything in
    x's dtype. Returns a closure over the prepared operands (the OIHW
    channels-last weight is prepared once, as a module holds it)."""
    x_nchw, e = x.permute(0, 3, 1, 2), emb[:, :, None, None]
    w_oihw = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    gs, gb = gn_scale.to(x.dtype), gn_bias.to(x.dtype)

    def run() -> Tensor:
        h = F.group_norm(x_nchw + e, groups, gs, gb, eps)
        return F.conv2d(F.silu(h), w_oihw, bias, padding=1)

    return run


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = get_parser(f"{__package__}.bench_fused_conv").parse_args(argv)
    device = cuda_device(args.device)
    print("device:", torch.cuda.get_device_name(device), flush=True)
    results = []
    for label, n, h, w, c, co in CASES:
        ops = case_inputs(n, h, w, c, co, device)
        flops = 2.0 * n * h * w * c * co * 9
        rows = {
            "K7 fused": lambda: fused_gn_silu_conv(*ops),
            "K8 tiled": lambda: fused_gn_silu_conv_tiled(*ops, tile_h=TILE_H[h]),
            "plain": lambda: fused_gn_silu_conv_plain(*ops),
            "library": library_route(*ops),
        }
        for name, fn in rows.items():
            ms = cuda_ms(fn)
            print(f"{label} {name:9s}: {ms:8.3f} ms  {flops / ms / 1e9:6.1f} TFLOP/s",
                  flush=True)
            results.append(dict(case=label.strip(), n=n, h=h, w=w, c=c, co=co, row=name,
                                ms=ms, tflops=flops / ms / 1e9))
        del ops
    return results


if __name__ == "__main__":
    main()
