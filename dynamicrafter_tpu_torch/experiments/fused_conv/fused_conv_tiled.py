"""K8: row-tiled fused normalize -> SiLU -> 3x3 same conv + bias, from a
GroupNorm statistics pre-pass.

`fused_gn_silu_conv_tiled` has the signature and operand layouts of
`experiments/fused_conv/fused_conv_tiled.py::fused_gn_silu_conv_tiled` of
the JAX repository (without `interpret`); feed it from the port's NCHW
modules as `fused_conv.py` describes. The statistics pre-pass `gn_prepass`
is plain PyTorch, as it is plain XLA there: two-pass variance
mean((x - mean)^2) in fp32 from the unrounded sum x + emb, giving a scale
and a bias per (n, c); the kernel is fed x + emb ROUNDED to the input type
(K7 never rounds that sum: in bf16 the two differ by that rounding). On a
CUDA tensor the entry launches `fused_conv_tiled_kernel` of
`csrc/fused_conv.cu`, which replaces the Pallas `_kernel` of that file, or
raises; on a CPU tensor it runs `fused_gn_silu_conv_tiled_plain`.

`tile_h` rows of the image (with a one-row halo) make a block's tile and
must divide H, as in the JAX entry; its `(tile_h * (W + 2)) % 8` rule
served the TPU's slices and is gone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv import (
    MAX_TILE_PIXELS, check_conv_operands, conv3x3_plain, pick_tile)
from dynamicrafter_tpu_torch.ops import kernels


def gn_prepass(x: Tensor, gn_scale: Tensor, gn_bias: Tensor, emb: Optional[Tensor],
               groups: int, eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(x + emb rounded to x.dtype, scale (N, C) fp32, bias (N, C) fp32):
    groupnorm(x + emb) == (x + emb) * scale + bias per sample and channel."""
    n, h, w, c = x.shape
    cpg = c // groups
    x32 = x.float()
    if emb is not None:
        x32 = x32 + emb.float()[:, None, None, :]
    grp = x32.reshape(n, h * w, groups, cpg)
    mean = grp.mean(dim=(1, 3))
    var = (grp - mean[:, None, :, None]).square().mean(dim=(1, 3))
    inv = torch.rsqrt(var + eps)
    scale = gn_scale.float()[None] * inv.repeat_interleave(cpg, dim=1)
    shift = gn_bias.float()[None] - mean.repeat_interleave(cpg, dim=1) * scale
    xe = x if emb is None else (x + emb[:, None, None, :]).to(x.dtype)
    return xe, scale.contiguous(), shift.contiguous()


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
    xe, scale, shift = gn_prepass(x, gn_scale, gn_bias, emb, groups, eps)
    th, tw = pick_tile(h, w, tile_h)
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = kernels.library().dct_fused_gn_silu_conv_tiled(
            xe.data_ptr(), scale.data_ptr(), shift.data_ptr(), kernel.data_ptr(),
            bias.data_ptr(), out.data_ptr(), kernels.DTYPE_CODES[x.dtype], n, h, w, c, co,
            th, tw, kernels.stream_handle(x.device))
    kernels.check(code, "fused_gn_silu_conv_tiled launch")
    fused_gn_silu_conv_tiled.launches += 1
    return out


fused_gn_silu_conv_tiled.launches = 0
