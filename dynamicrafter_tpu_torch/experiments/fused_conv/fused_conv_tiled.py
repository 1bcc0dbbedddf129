"""K8: row-tiled fused normalize -> SiLU -> 3x3 same conv + bias, from
GroupNorm statistics taken first.

`fused_gn_silu_conv_tiled` has the signature and operand layouts of
`experiments/fused_conv/fused_conv_tiled.py::fused_gn_silu_conv_tiled` of
the JAX repository (without `interpret`); feed it from the port's NCHW
modules as `fused_conv.py` describes. The statistics are the JAX pre-pass's:
two-pass variance mean((x - mean)^2) in fp32 from the unrounded sum x +
emb, a scale and a bias per (n, c) (`gn_prepass` here, plain PyTorch); the
conv is fed x + emb ROUNDED to the input type (K7 never rounds that sum: in
bf16 the two differ by that rounding). On a CPU tensor the entry runs
`fused_gn_silu_conv_tiled_plain`. On a CUDA tensor, bf16: `gn_stats`
(two-pass, its own kernel) and then `fused_conv_tc_kernel` of
`csrc/fused_conv.cu` (wgmma + TMA), which rounds x + emb inside, so x + emb
is never written to memory; fp32: `gn_prepass` and
`fused_conv_tiled_kernel<float>` on x + emb. Either replaces the Pallas
`_kernel` of that file; a refused launch raises.

`tile_h` must divide H, as in the JAX entry (its `(tile_h * (W + 2)) % 8`
rule served the TPU's slices and is gone). fp32 tiles rows of tile_h with a
one-row halo; bf16 takes tiles of th x tw <= 128 pixels with th dividing
tile_h where that costs no more blocks than K7's tile, else K7's tile
(`pick_tile_tc` says which).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv import (
    MAX_TILE_PIXELS, check_conv_operands, conv3x3_plain, gn_stats, gn_stats_plain, pick_tile,
    pick_tile_tc, tensor_core_route)
from dynamicrafter_tpu_torch.ops import kernels
from dynamicrafter_tpu_torch.utils import trace


def gn_prepass(x: Tensor, gn_scale: Tensor, gn_bias: Tensor, emb: Optional[Tensor],
               groups: int, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(x + emb rounded to x.dtype, scale (N, C) fp32, bias (N, C) fp32):
    groupnorm(x + emb) == (x + emb) * scale + bias per sample and channel."""
    scale, shift = gn_stats_plain(x, gn_scale, gn_bias, emb, groups=groups, eps=eps,
                                  two_pass=True)
    xe = x if emb is None else (x + emb[:, None, None, :]).to(x.dtype)
    return xe, scale, shift


def _check_tile_h(h: int, tile_h: int) -> None:
    if tile_h < 1 or tile_h > MAX_TILE_PIXELS or h % tile_h:
        raise ValueError(f"tile_h {tile_h} must divide H {h} (and be 1..{MAX_TILE_PIXELS})")


def fused_gn_silu_conv_tiled_plain(x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor,
                                   gn_bias: Tensor, emb: Optional[Tensor] = None, *,
                                   groups: int = 32, eps: float = 1e-5,
                                   tile_h: int = 8) -> Tensor:
    """The pre-pass and the Pallas kernel's arithmetic in plain PyTorch ops
    (the row tiles change the order of no sum, so none are cut here)."""
    _check_tile_h(x.shape[1], tile_h)
    xe, scale, shift = gn_prepass(x, gn_scale, gn_bias, emb, groups, eps)
    act = xe.float() * scale[:, None, None] + shift[:, None, None]
    act = (act * torch.sigmoid(act)).to(x.dtype)
    return conv3x3_plain(act, kernel, bias)


def fused_gn_silu_conv_tiled(x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor,
                             gn_bias: Tensor, emb: Optional[Tensor] = None, *,
                             groups: int = 32, eps: float = 1e-5, tile_h: int = 8) -> Tensor:
    """K8: conv3x3(silu(groupnorm(x [+ emb]))) + bias over row tiles of
    `tile_h`. x (N, H, W, C) bf16 or fp32 -> (N, H, W, Co)."""
    if x.device.type == "cpu":
        return fused_gn_silu_conv_tiled_plain(x, kernel, bias, gn_scale, gn_bias, emb,
                                              groups=groups, eps=eps, tile_h=tile_h)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv_tiled: unsupported device {x.device}")
    check_conv_operands("fused_gn_silu_conv_tiled", x, kernel, bias, gn_scale, gn_bias, emb,
                        groups)
    n, h, w, c = x.shape
    co = kernel.shape[-1]
    _check_tile_h(h, tile_h)
    if tensor_core_route(x.dtype):
        scale, shift = gn_stats(x, gn_scale, gn_bias, emb, groups=groups, eps=eps,
                                two_pass=True)
        xin, e = x, emb
        th, tw = pick_tile_tc(n, h, w, tile_h)
    else:
        xin, scale, shift = gn_prepass(x, gn_scale, gn_bias, emb, groups, eps)
        (th, tw), e = pick_tile(h, w, tile_h), None
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    with trace.span("K8", n=n, h=h, w=w, c=c, co=co), \
            torch.cuda.device(x.device):
        code = kernels.library().dct_fused_gn_silu_conv_tiled(
            xin.data_ptr(), scale.data_ptr(), shift.data_ptr(), kernel.data_ptr(),
            bias.data_ptr(), out.data_ptr(), kernels.DTYPE_CODES[x.dtype], n, h, w, c, co,
            th, tw, None if e is None else e.data_ptr(), kernels.stream_handle(x.device))
    kernels.check(code, "fused_gn_silu_conv_tiled launch")
    fused_gn_silu_conv_tiled.launches += 1
    return out


fused_gn_silu_conv_tiled.launches = 0
