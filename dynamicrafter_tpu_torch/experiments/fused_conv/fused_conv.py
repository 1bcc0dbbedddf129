"""K7: fused [add-emb] -> GroupNorm (fp32 statistics) -> SiLU -> 3x3 same
conv + bias, the ResBlock's hot path, in one launch from raw x.

`fused_gn_silu_conv` has the signature and operand layouts of
`experiments/fused_conv/fused_conv.py::fused_gn_silu_conv` of the JAX
repository (without `interpret`): x (N, H, W, C), kernel (3, 3, C, Co) HWIO,
bias (Co,), gn_scale and gn_bias (C,), emb (N, C) or None. On a CUDA tensor
it launches `fused_gn_silu_conv_kernel` of `csrc/fused_conv.cu`, which
replaces that file's Pallas `_kernel`, or raises; on a CPU tensor it runs
`fused_gn_silu_conv_plain`, the same arithmetic step by step: the sum x +
emb stays fp32 and is never rounded, the variance is E[x^2] - mean^2, the
activation is rounded to the input type before the nine products and is
zero outside the image (the ring is zeroed after SiLU), the products
accumulate in fp32 and the result is rounded once. The kernel runs the nine
products of bf16 inputs on the tensor cores (mma.sync, fp32 accumulators)
and those of fp32 inputs as fp32 FMAs.

Feeding it from the port's NCHW modules (`models/blocks.py::ResBlock`,
`in_layers` / `out_layers`): with x a channels-last (B*T, C, H, W) tensor,
`x.permute(0, 2, 3, 1)` is the contiguous (N, H, W, C) view, the kernel is
`conv.weight.permute(2, 3, 1, 0).contiguous()`, gn_scale and gn_bias are the
GroupNorm's weight and bias, emb is `emb_out` as (N, C), and the result
permutes back with `.permute(0, 3, 1, 2)`. The UNet does not call it (nor
does the JAX UNet call its counterpart).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from dynamicrafter_tpu_torch.ops import kernels

MAX_TILE_PIXELS = 128   # output pixels per block of csrc/fused_conv.cu
PIXEL_GROUPS = 16       # fp32: a thread owns every 16th pixel of the tile; bf16: a warp owns 16
MAX_CHANNELS = 4608     # K7's per-channel partial sums must fit its shared memory


def conv3x3_plain(act: Tensor, kernel: Tensor, bias: Tensor) -> Tensor:
    """3x3 same conv of an (N, H, W, C) activation as nine shifted matrix
    products in fp32 over a zero ring, plus bias; rounded once to act's dtype."""
    n, h, w, _ = act.shape
    padded = torch.nn.functional.pad(act, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, w, kernel.shape[-1]), dtype=torch.float32, device=act.device)
    for di in range(3):
        for dj in range(3):
            acc += padded[:, di:di + h, dj:dj + w].float() @ kernel[di, dj].float()
    return (acc + bias.float()).to(act.dtype)


def fused_gn_silu_conv_plain(x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor,
                             gn_bias: Tensor, emb: Optional[Tensor] = None, *,
                             groups: int = 32, eps: float = 1e-5) -> Tensor:
    """The Pallas kernel's arithmetic in plain PyTorch ops."""
    n, h, w, c = x.shape
    cpg = c // groups
    full = x.float()
    if emb is not None:
        full = full + emb.float()[:, None, None, :]
    grp = full.reshape(n, h * w, groups, cpg)
    n_el = float(h * w * cpg)
    g1 = grp.sum(dim=(1, 3)) / n_el
    g2 = (grp * grp).sum(dim=(1, 3)) / n_el
    inv = torch.rsqrt(g2 - g1 * g1 + eps)
    scale = gn_scale.float()[None] * inv.repeat_interleave(cpg, dim=1)
    shift = gn_bias.float()[None] - g1.repeat_interleave(cpg, dim=1) * scale
    act = full * scale[:, None, None] + shift[:, None, None]
    act = (act * torch.sigmoid(act)).to(x.dtype)
    return conv3x3_plain(act, kernel, bias)


def supported(x_shape, c_out: int) -> bool:
    """Whether the CUDA kernels (K7 and K8) take x of `x_shape` = (N, H, W, C)
    and `c_out` output channels, in either dtype: 32 groups divide C, a row of
    C or c_out elements is whole 16-byte vectors in bf16 (multiples of 8), N
    fits the launch grid, and K7's per-channel partial sums fit beside its
    tile in shared memory (C <= 4608).

    Differs from the JAX `supported`: that one budgets 96 MB of VMEM for a
    whole padded sample per program and so refuses large images (a
    (16, 576, 1024, 128) VAE feature map); these kernels tile every image, so
    H and W are free. It has no row-width rule; this one refuses c_out not a
    multiple of 8 (the VAE's 3-channel output conv)."""
    n, h, w, c = x_shape
    return (h >= 1 and w >= 1 and 1 <= n <= 65535 and c % 32 == 0
            and c_out >= 8 and c_out % 8 == 0 and c <= MAX_CHANNELS)


@functools.lru_cache(maxsize=None)
def pick_tile(h: int, w: int, tile_h: Optional[int] = None) -> Tuple[int, int]:
    """The block's pixel tile (th, tw), th * tw <= 128, for an H x W image:
    the one that covers the image in the fewest thread-steps (blocks times
    the pixels a thread owns, 16 pixel groups per block), and among those the
    fewest halo pixels. `tile_h` fixes th (K8)."""
    best = None
    for th in ([tile_h] if tile_h is not None else range(1, min(h, 32) + 1)):
        for tw in range(1, min(w, MAX_TILE_PIXELS // th) + 1):
            blocks = -(-h // th) * -(-w // tw)
            key = (blocks * -(-th * tw // PIXEL_GROUPS), blocks * (th + 2) * (tw + 2))
            if best is None or key < best[0]:
                best = (key, (th, tw))
    if best is None:
        raise ValueError(f"no tile for H={h}, W={w}, tile_h={tile_h} "
                         f"(tile_h must be 1..{MAX_TILE_PIXELS})")
    return best[1]


def check_conv_operands(name: str, x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor,
                        gn_bias: Tensor, emb: Optional[Tensor], groups: int) -> None:
    """Shapes and types both kernels require of their CUDA operands."""
    kernels.check_operands(name, x, kernel, bias, *([] if emb is None else [emb]))
    if x.dim() != 4 or kernel.dim() != 4:
        raise ValueError(f"{name}: x must be (N, H, W, C) and kernel (3, 3, C, Co)")
    n, _, _, c = x.shape
    co = kernel.shape[-1]
    if tuple(kernel.shape[:3]) != (3, 3, c) or tuple(bias.shape) != (co,):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit C={c}")
    if tuple(gn_scale.shape) != (c,) or tuple(gn_bias.shape) != (c,):
        raise ValueError(f"{name}: gn_scale and gn_bias must be ({c},)")
    if emb is not None and tuple(emb.shape) != (n, c):
        raise ValueError(f"{name}: emb must be ({n}, {c}), got {tuple(emb.shape)}")
    vec = 16 // x.element_size()
    if c % groups or c % vec or co % vec or n > 65535:
        raise ValueError(f"{name}: C={c} must be a multiple of groups={groups} and, like "
                         f"Co={co}, of {vec} (16-byte rows); N={n} <= 65535")


def fused_gn_silu_conv(x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor,
                       gn_bias: Tensor, emb: Optional[Tensor] = None, *,
                       groups: int = 32, eps: float = 1e-5) -> Tensor:
    """K7: conv3x3(silu(groupnorm(x [+ emb]))) + bias, one launch.
    x (N, H, W, C) bf16 or fp32 -> (N, H, W, Co)."""
    if x.device.type == "cpu":
        return fused_gn_silu_conv_plain(x, kernel, bias, gn_scale, gn_bias, emb,
                                        groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv: unsupported device {x.device}")
    check_conv_operands("fused_gn_silu_conv", x, kernel, bias, gn_scale, gn_bias, emb, groups)
    n, h, w, c = x.shape
    co = kernel.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_gn_silu_conv: C={c} > {MAX_CHANNELS}")
    gs, gb = gn_scale.float().contiguous(), gn_bias.float().contiguous()
    th, tw = pick_tile(h, w)
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = kernels.library().dct_fused_gn_silu_conv(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), gs.data_ptr(), gb.data_ptr(),
            None if emb is None else emb.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[x.dtype], n, h, w, c, co, groups, float(eps), th, tw,
            kernels.stream_handle(x.device))
    kernels.check(code, "fused_gn_silu_conv launch")
    fused_gn_silu_conv.launches += 1
    return out


fused_gn_silu_conv.launches = 0
