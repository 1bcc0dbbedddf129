"""Normalization layers: fp32 statistics and affine on half-precision
activations.

The reference keeps GroupNorm in fp32 inside an otherwise half-precision
network (lvdm/basics.py:76-87). The affine parameters stay float32 whatever
the storage dtype of the rest of the model.

Layout follows torch: (N, C, *rest). Which axes the statistics span is the
caller's choice of layout: a (B*T, C, H, W) activation gives per-frame
statistics (the JAX package's `num_batch_axes=2`), a (B, C, T, H, W)
activation gives per-clip statistics (`num_batch_axes=1`). `ClipGroupNorm`
is the per-clip one: where a clip's frames are split over the sp ranks, its
statistics are summed over them.

Two routes, chosen by what a call can see:
  * the kernels (`csrc/norms.cu`): a CUDA tensor, bf16 or fp32, with no
    autograd graph being recorded. `group_norm_act` reads x in place (any
    strides but a contiguous tail, so a clip's transposed view is read
    without a copy; or channels-last, as the convs leave it, and a clip's
    views of that), adds an optional per-(n, c) `add` (ResBlock's
    `emb_out`) and applies an optional SiLU, writing the result once
    (`group_norm_act.launches_by_plan` counts its launches by the plan the
    kernel took, `GN_PLANS`; the `group_norm` span names it in `plan=`);
    `layer_norm` normalises rows in one read and one write.
  * the fp32 island (`group_norm_act_plain`, `layer_norm_plain`): x.float(),
    the library norm in fp32, a cast back, then SiLU. The CPU, a call that
    records a graph (the trainer's UNet forward, whose backward goes through
    autograd), `ClipGroupNorm` with `frames` (its all-reduce), and a
    LayerNorm width the kernel does not take. `island_calls` counts the
    CUDA calls that took it.
The kernel's output differs from the island's by rounding: the island
rounds the norm to the input dtype before SiLU, the kernel rounds once.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dynamicrafter_tpu_torch.ops import kernels
from dynamicrafter_tpu_torch.parallel.sharding import FrameSplit, sp_all_reduce
from dynamicrafter_tpu_torch.utils import trace

LN_MAX_VECTORS = 320      # 16-byte vectors a LayerNorm row may hold
# GroupNorm's plans, as `csrc/norms.cu`'s PlanKind numbers them: per channel
# (a block a group, or cooperative rounds of blocks), channels-last (a block
# a sample, a sample held on chip in several blocks' rings, or streamed past
# what the card holds and partly read again)
GN_PLANS = ("channel", "channel_rounds", "rows_block", "rows_held", "rows_streamed")

island_calls = 0          # CUDA calls that took the fp32 island


def group_norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float, add: Optional[torch.Tensor] = None,
                         silu: bool = False) -> torch.Tensor:
    """The fp32 island: [x + add in x's dtype] -> fp32 group_norm -> x's
    dtype [-> SiLU]."""
    if add is not None:
        x = x + add
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps).to(x.dtype)
    return F.silu(y) if silu else y


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     keep_fp32: bool = False) -> torch.Tensor:
    """The fp32 island over the last axis; `keep_fp32` returns the fp32 result."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return y if keep_fp32 else y.to(x.dtype)


def _rows(x: torch.Tensor):
    """x (N, C, *rest) as (N, C, R, HW): HW the longest contiguous tail of
    rest, R the rest before it if it folds into one stride. Returns (n, c, r,
    hw, sn, sc, sr) in elements, or None."""
    size, stride = x.shape, x.stride()
    if x.dim() < 3 or stride[-1] != 1:
        return None
    i, hw = x.dim() - 1, size[-1]
    while i > 2 and stride[i - 1] == hw:
        i -= 1
        hw *= size[i]
    r, sr = 1, hw
    if i > 2:
        sr = stride[i - 1]
        for j in range(2, i):
            r *= size[j]
        for j in range(2, i - 1):
            if stride[j] != stride[j + 1] * size[j + 1]:
                return None
    return size[0], size[1], r, hw, stride[0], stride[1], sr


def _layout(x: torch.Tensor) -> torch.memory_format:
    """x's channels-last layout if it has one, else contiguous (ATen's
    suggested memory format, the layout of the island's result on the CPU)."""
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    if x.dim() == 5 and x.is_contiguous(memory_format=torch.channels_last_3d):
        return torch.channels_last_3d
    return torch.contiguous_format


_plans = {}   # (dtype, channels-last, n, c, r, hw, groups) -> (floats of scratch, plan name)


def _plan(lib, code: int, channels_last: bool, dims, groups: int):
    """(floats of scratch, plan name) of the kernel's plan for a shape; (-1,
    None) where the kernel does not take it."""
    n, c, r, hw = dims[:4]
    key = (code, channels_last, n, c, r, hw, groups)
    plan = _plans.get(key)
    if plan is None:
        args = (code, int(channels_last), n, c, r, hw, groups)
        kind = lib.dct_group_norm_plan(*args)
        plan = _plans[key] = (lib.dct_group_norm_scratch(*args), GN_PLANS[kind]) \
            if kind >= 0 else (-1, None)
    return plan


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float, add: Optional[torch.Tensor] = None,
                   silu: bool = False) -> torch.Tensor:
    """[silu](groupnorm(x [+ add])) through `csrc/norms.cu` on a CUDA tensor
    (bf16 or fp32; weight and bias fp32; add in x's dtype, one value a (n, c));
    the island on a CPU tensor. The result has x's shape: in x's channels-last
    layout where x has one (the island's layout there), else contiguous."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, weight, bias, groups, eps, add, silu)
    if x.device.type != "cuda" or x.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"group_norm_act: unsupported {x.device} / {x.dtype}")
    code = kernels.DTYPE_CODES[x.dtype]
    lib = kernels.library()
    n, c = x.shape[:2]
    dims, fmt, channels_last, need, plan = _rows(x), torch.contiguous_format, False, -1, None
    if dims is None:
        # a channels-last activation (the UNet's and the VAE's convs keep the
        # layout of their permuted input): each sample a (pixels, C) matrix,
        # read in place where the kernels take its width, else as a
        # contiguous copy; the result in x's layout either way
        fmt = _layout(x)
        if fmt != torch.contiguous_format and x.data_ptr() % 16 == 0 and n * c > 0:
            dims = (n, c, 1, x.numel() // (n * c), x.stride(0) if n > 1 else x.numel(), 1, 0)
            need, plan = _plan(lib, code, True, dims, groups)
            channels_last = need >= 0
        if not channels_last:
            x = x.contiguous()
            dims = _rows(x)
    if not channels_last:
        need, plan = _plan(lib, code, False, dims, groups)
    if need < 0:
        raise ValueError(f"group_norm_act: shape {tuple(x.shape)} with {groups} groups "
                         "is outside the kernel")
    _, _, r, hw, sn, sc, sr = dims
    if add is not None:
        add = add.reshape(n, c)
        if add.dtype != x.dtype or add.stride() != (c, 1) or add.data_ptr() % 16:
            add = add.to(x.dtype).clone()
    w, b = weight.float(), bias.float()
    out = torch.empty_like(x, memory_format=fmt) if channels_last else \
        torch.empty(x.shape, dtype=x.dtype, device=x.device)
    part = torch.empty(need, dtype=torch.float32, device=x.device) if need else None
    with trace.span("group_norm", n=n, c=c, r=r, hw=hw, plan=plan), torch.cuda.device(x.device):
        err = lib.dct_group_norm_act(
            x.data_ptr(), None if add is None else add.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), need, code,
            int(channels_last), n, c, r, hw, sn, sc, sr, groups, float(eps), int(silu),
            kernels.stream_handle(x.device))
    kernels.check(err, "group_norm_act launch")
    group_norm_act.launches += 1
    by_plan = group_norm_act.launches_by_plan
    by_plan[plan] = by_plan.get(plan, 0) + 1
    return out if channels_last or fmt == torch.contiguous_format else \
        out.contiguous(memory_format=fmt)


group_norm_act.launches = 0
group_norm_act.launches_by_plan = {}   # by GN_PLANS name


def layer_norm_fits(x: torch.Tensor) -> bool:
    """Whether `layer_norm`'s kernel takes x's width: whole 16-byte vectors,
    at most `LN_MAX_VECTORS` of them a row."""
    vec = 16 // x.element_size()
    c = x.shape[-1]
    return c % vec == 0 and c // vec <= LN_MAX_VECTORS


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               keep_fp32: bool = False) -> torch.Tensor:
    """LayerNorm over the last axis through `csrc/norms.cu` on a CUDA tensor
    (bf16 or fp32, a width `layer_norm_fits` takes); the island on a CPU
    tensor."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, keep_fp32)
    if x.device.type != "cuda" or x.dtype not in kernels.DTYPE_CODES or not layer_norm_fits(x):
        raise ValueError(f"layer_norm: unsupported {x.device} / {x.dtype} / width {x.shape[-1]}")
    x = x.contiguous()
    c = x.shape[-1]
    rows = x.numel() // c
    out = torch.empty(x.shape, dtype=torch.float32 if keep_fp32 else x.dtype, device=x.device)
    if rows == 0:
        return out
    w, b = weight.float(), bias.float()
    lib = kernels.library()
    with trace.span("layer_norm", rows=rows, c=c), torch.cuda.device(x.device):
        err = lib.dct_layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 kernels.DTYPE_CODES[x.dtype], int(keep_fp32), rows, c,
                                 float(eps), kernels.stream_handle(x.device))
    kernels.check(err, "layer_norm launch")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0


def _kernel_route(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """A CUDA bf16/fp32 tensor with no graph being recorded takes the kernel;
    a CUDA call that does not is counted in `island_calls`."""
    global island_calls
    if not x.is_cuda:
        return False
    if x.dtype in kernels.DTYPE_CODES and not (
            torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad)):
        return True
    island_calls += 1
    return False


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, add: Optional[torch.Tensor] = None,
                silu: bool = False) -> torch.Tensor:
        """[silu](groupnorm(x [+ add])); `add` broadcasts as (N, C, 1, ...)."""
        fn = group_norm_act if _kernel_route(x, self.weight) else group_norm_act_plain
        return fn(x, self.weight, self.bias, self.num_groups, self.eps, add, silu)


class ClipGroupNorm(GroupNorm):
    """GroupNorm over a (B, C, T, ...) clip. With `frames` (this rank holds
    T/sp of each clip's frames) the statistics still span the whole clip:
    fp32 sums of x and x^2 over (C/G, T/sp, ...) are summed over the sp
    group in one all-reduce, then normalize, on the island. Without it,
    GroupNorm's own path, bit for bit."""

    def forward(self, x: torch.Tensor, frames: Optional[FrameSplit] = None,
                silu: bool = False) -> torch.Tensor:
        if frames is None:
            return super().forward(x, silu=silu)
        global island_calls
        if x.is_cuda:
            island_calls += 1
        b, c = x.shape[:2]
        g = x.float().reshape(b, self.num_groups, -1)
        sums = sp_all_reduce(torch.stack([g.sum(-1), g.square().sum(-1)]), frames)
        n = g.shape[-1] * frames.sp
        mean = sums[0] / n
        var = (sums[1] / n - mean.square()).clamp_min(0.0)
        y = (g - mean[..., None]) * torch.rsqrt(var + self.eps)[..., None]
        affine = (1, c) + (1,) * (x.dim() - 2)
        y = y.reshape(x.shape) * self.weight.float().view(affine) + self.bias.float().view(affine)
        y = y.to(x.dtype)
        return F.silu(y) if silu else y


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in fp32. `keep_fp32` returns the fp32
    result (the CLIP text tower's final norm); otherwise it is cast back."""

    def __init__(self, dim: int, eps: float = 1e-5, keep_fp32: bool = False):
        super().__init__()
        self.eps = eps
        self.keep_fp32 = keep_fp32
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and not layer_norm_fits(x):
            global island_calls
            island_calls += 1
            return layer_norm_plain(x, self.weight, self.bias, self.eps, self.keep_fp32)
        fn = layer_norm if _kernel_route(x, self.weight) else layer_norm_plain
        return fn(x, self.weight, self.bias, self.eps, self.keep_fp32)


def keep_norms_fp32(module: nn.Module) -> nn.Module:
    """After `module.to(bfloat16)`: put every norm's affine back in fp32."""
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.float()
    return module
