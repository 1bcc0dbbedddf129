"""K7: fused [add-emb] -> GroupNorm (fp32 statistics) -> SiLU -> 3x3 same
conv + bias, the ResBlock's hot path, from raw x.

`fused_gn_silu_conv` has the signature and operand layouts of
`experiments/fused_conv/fused_conv.py::fused_gn_silu_conv` of the JAX
repository (without `interpret`): x (N, H, W, C), kernel (3, 3, C, Co) HWIO,
bias (Co,), gn_scale and gn_bias (C,), emb (N, C) or None. On a CPU tensor
it runs `fused_gn_silu_conv_plain`, the Pallas kernel's arithmetic step by
step: the sum x + emb stays fp32 and is never rounded, the variance is
E[x^2] - mean^2, the activation is rounded to the input type before the nine
products and is zero outside the image (the ring is zeroed after SiLU), the
products accumulate in fp32 and the result is rounded once. On a CUDA
tensor it replaces that file's Pallas `_kernel` with hand-written kernels of
`csrc/fused_conv.cu`, or raises; the route is a function of the dtype
(`tensor_core_route`):
  * bf16: two launches. `gn_stats` reads x once per sample (several blocks
    a sample, fixed order of sums) and gives the per-(n, c) scale and bias;
    `fused_conv_tc_kernel` then runs the nine products on `wgmma` (tensor
    cores, fp32 accumulators), x and the kernel brought by TMA, the
    activation made once per 64-channel chunk of a 128-pixel tile
    (`pick_tile_tc`) and 160 output channels;
  * fp32: one launch of `fused_gn_silu_conv_kernel<float>`, statistics per
    block, fp32 FMAs.
`gn_stats` (with `gn_stats_plain`) is also K8's statistics, in two-pass mode.

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
from dynamicrafter_tpu_torch.utils import trace

MAX_TILE_PIXELS = 128   # output pixels per block of csrc/fused_conv.cu
PIXEL_GROUPS = 16       # fp32: a thread owns every 16th pixel of the tile
MAX_CHANNELS = 4608     # fp32 K7's per-channel partial sums must fit its shared memory
MAX_HALO_PIXELS = 300   # bf16: two raw halo tiles and the activation tile beside the weight ring


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


def gn_stats_plain(x: Tensor, gn_scale: Tensor, gn_bias: Tensor, emb: Optional[Tensor] = None,
                   *, groups: int = 32, eps: float = 1e-5,
                   two_pass: bool = False) -> Tuple[Tensor, Tensor]:
    """Per-(n, c) fp32 scale and bias (N, C) with groupnorm(v) = v * scale +
    bias, v = x + emb in fp32: var = E[v^2] - mean^2 (K7's Pallas kernel) or,
    with `two_pass`, mean((v - mean)^2) (K8's pre-pass). The plain versions
    of K7 and K8 take their statistics from here."""
    n, h, w, c = x.shape
    cpg = c // groups
    full = x.float()
    if emb is not None:
        full = full + emb.float()[:, None, None, :]
    grp = full.reshape(n, h * w, groups, cpg)
    if two_pass:
        mean = grp.mean(dim=(1, 3))
        var = (grp - mean[:, None, :, None]).square().mean(dim=(1, 3))
        inv = torch.rsqrt(var + eps)
    else:
        n_el = float(h * w * cpg)
        mean = grp.sum(dim=(1, 3)) / n_el
        g2 = (grp * grp).sum(dim=(1, 3)) / n_el
        inv = torch.rsqrt(g2 - mean * mean + eps)
    scale = gn_scale.float()[None] * inv.repeat_interleave(cpg, dim=1)
    shift = gn_bias.float()[None] - mean.repeat_interleave(cpg, dim=1) * scale
    return scale.contiguous(), shift.contiguous()


def fused_gn_silu_conv_plain(x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor,
                             gn_bias: Tensor, emb: Optional[Tensor] = None, *,
                             groups: int = 32, eps: float = 1e-5) -> Tensor:
    """The Pallas kernel's arithmetic in plain PyTorch ops."""
    scale, shift = gn_stats_plain(x, gn_scale, gn_bias, emb, groups=groups, eps=eps)
    full = x.float()
    if emb is not None:
        full = full + emb.float()[:, None, None, :]
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


def tensor_core_route(dtype: torch.dtype) -> bool:
    """Whether K7 and K8 take the bf16 route (`gn_stats`, then
    `fused_conv_tc_kernel` on wgmma) or the fp32 one (the kernels with the
    statistics per block, fp32 FMAs): a function of the dtype alone."""
    return dtype == torch.bfloat16


def _best_tile_tc(rows: int, w: int, ths) -> Tuple[Tuple[int, int, int], Tuple[int, int]]:
    """((blocks, halo, -tw), (th, tw)) of the best tile with th in `ths`."""
    best = None
    for th in ths:
        for tw in range(1, min(w, MAX_TILE_PIXELS // th) + 1):
            halo = (th + 2) * (tw + 2)
            if halo <= MAX_HALO_PIXELS:
                key = (-(-rows // th) * -(-w // tw), halo, -tw)
                if best is None or key < best[0]:
                    best = (key, (th, tw))
    if best is None:
        raise ValueError(f"no tile of {rows} x {w} pixels with rows in {list(ths)}")
    return best


@functools.lru_cache(maxsize=None)
def pick_tile_tc(n: int, h: int, w: int, tile_h: Optional[int] = None) -> Tuple[int, int]:
    """The bf16 route's pixel tile (th, tw), th * tw <= 128 (two warpgroups
    of 64 rows), over the N*H x W image that stacks the samples (a tile may
    straddle two samples; the kernel zeroes each pixel's taps outside its
    own sample): the fewest blocks, then the fewest halo pixels, then the
    widest; (th + 2) * (tw + 2) <= MAX_HALO_PIXELS. At 10 x 16 (ds4, 160
    pixels a sample) that is 8 x 16: 32 samples are 40 whole tiles.

    K8's `tile_h` fixes the rows where the wgmma tiling allows it: th then
    divides tile_h (no tile straddles a band of tile_h rows), if such a
    tile needs no more blocks than the free choice; otherwise K8 takes the
    free tile. tile_h = 8 at 40 x 64 and 72 x 128 keeps 8 x 16; tile_h = 10
    at 20 x 32 and 10 x 16 would give 10 x 11 or 10 x 8 (1.2x and 1.6x the
    blocks), so K8 takes 8 x 16 there."""
    rows = n * h
    free = _best_tile_tc(rows, w, range(1, min(rows, MAX_TILE_PIXELS) + 1))
    if tile_h is None:
        return free[1]
    banded = _best_tile_tc(rows, w, [d for d in range(1, tile_h + 1) if tile_h % d == 0])
    return banded[1] if banded[0][0] <= free[0][0] else free[1]


def stats_splits(n: int, hw: int, sms: int) -> int:
    """Blocks per sample of `gn_stats_kernel`: at most four blocks an SM over
    the batch (what one wave holds: 17 splits of 32 samples were 544 blocks,
    a second wave of 16), each run of pixels nonempty and at least 32 long."""
    splits = max(1, min(4 * sms // n, -(-hw // 32)))
    return -(-hw // -(-hw // splits))


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index or 0).multi_processor_count


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


def gn_stats(x: Tensor, gn_scale: Tensor, gn_bias: Tensor, emb: Optional[Tensor] = None, *,
             groups: int = 32, eps: float = 1e-5, two_pass: bool = False) -> Tuple[Tensor, Tensor]:
    """GroupNorm statistics of x (N, H, W, C) [+ emb (N, C)], once per
    sample: (scale, bias), each (N, C) fp32, as `gn_stats_plain` defines
    them. On a bf16 CUDA tensor `gn_stats_kernel` (several blocks a sample,
    fixed order of sums) and `gn_stats_finish_kernel`; another CUDA dtype
    raises."""
    if x.device.type == "cpu":
        return gn_stats_plain(x, gn_scale, gn_bias, emb, groups=groups, eps=eps,
                              two_pass=two_pass)
    if x.device.type != "cuda":
        raise ValueError(f"gn_stats: unsupported device {x.device}")
    kernels.check_operands("gn_stats", x, *([] if emb is None else [emb]))
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gn_stats: the kernel takes bfloat16, got {x.dtype} (fp32 K7 and K8 "
                        "take their statistics in their own launches)")
    if x.dim() != 4:
        raise ValueError("gn_stats: x must be (N, H, W, C)")
    n, h, w, c = x.shape
    if tuple(gn_scale.shape) != (c,) or tuple(gn_bias.shape) != (c,):
        raise ValueError(f"gn_stats: gn_scale and gn_bias must be ({c},)")
    if emb is not None and tuple(emb.shape) != (n, c):
        raise ValueError(f"gn_stats: emb must be ({n}, {c}), got {tuple(emb.shape)}")
    if c % groups or c % 8 or n > 65535:
        raise ValueError(f"gn_stats: C={c} must be a multiple of groups={groups} and of 8; "
                         f"N={n} <= 65535")
    gs, gb = gn_scale.float().contiguous(), gn_bias.float().contiguous()
    splits = stats_splits(n, h * w, _sm_count(x.device.index))
    # scale, bias and the per-split partial sums in one allocation
    buf = torch.empty(2 * n * c + n * splits * groups * 2, dtype=torch.float32, device=x.device)
    scale, shift, part = buf[:n * c].view(n, c), buf[n * c:2 * n * c].view(n, c), buf[2 * n * c:]
    with trace.span("gn_stats", n=n, hw=h * w, c=c), \
            torch.cuda.device(x.device):
        code = kernels.library().dct_gn_stats(
            x.data_ptr(), gs.data_ptr(), gb.data_ptr(), None if emb is None else emb.data_ptr(),
            part.data_ptr(), scale.data_ptr(), shift.data_ptr(), kernels.DTYPE_CODES[x.dtype],
            n, h * w, c, groups, float(eps), splits, int(two_pass),
            kernels.stream_handle(x.device))
    kernels.check(code, "gn_stats launch")
    gn_stats.launches += 1
    return scale, shift


gn_stats.launches = 0


def fused_gn_silu_conv(x: Tensor, kernel: Tensor, bias: Tensor, gn_scale: Tensor,
                       gn_bias: Tensor, emb: Optional[Tensor] = None, *,
                       groups: int = 32, eps: float = 1e-5) -> Tensor:
    """K7: conv3x3(silu(groupnorm(x [+ emb]))) + bias. x (N, H, W, C) bf16
    (`gn_stats`, then the wgmma kernel: two launches of hand-written
    kernels) or fp32 (one launch, statistics per block) -> (N, H, W, Co)."""
    if x.device.type == "cpu":
        return fused_gn_silu_conv_plain(x, kernel, bias, gn_scale, gn_bias, emb,
                                        groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv: unsupported device {x.device}")
    check_conv_operands("fused_gn_silu_conv", x, kernel, bias, gn_scale, gn_bias, emb, groups)
    n, h, w, c = x.shape
    co = kernel.shape[-1]
    if tensor_core_route(x.dtype):
        scale, shift = gn_stats(x, gn_scale, gn_bias, emb, groups=groups, eps=eps)
        th, tw = pick_tile_tc(n, h, w)
        stats = (scale.data_ptr(), shift.data_ptr())
    else:
        if c > MAX_CHANNELS:
            raise ValueError(f"fused_gn_silu_conv: C={c} > {MAX_CHANNELS}")
        (th, tw), stats = pick_tile(h, w), (None, None)
    gs, gb = gn_scale.float().contiguous(), gn_bias.float().contiguous()
    out = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    with trace.span("K7", n=n, h=h, w=w, c=c, co=co), \
            torch.cuda.device(x.device):
        code = kernels.library().dct_fused_gn_silu_conv(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), gs.data_ptr(), gb.data_ptr(),
            None if emb is None else emb.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[x.dtype], n, h, w, c, co, groups, float(eps), th, tw, *stats,
            kernels.stream_handle(x.device))
    kernels.check(code, "fused_gn_silu_conv launch")
    fused_gn_silu_conv.launches += 1
    return out


fused_gn_silu_conv.launches = 0
