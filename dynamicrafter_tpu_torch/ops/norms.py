"""Normalization layers with fp32 islands.

The reference keeps GroupNorm in fp32 inside an otherwise half-precision
network (lvdm/basics.py:76-87). Here statistics and affine run in float32
and the result is cast back to the input dtype; the affine parameters stay
float32 whatever the storage dtype of the rest of the model.

Layout follows torch: (N, C, *rest). Which axes the statistics span is the
caller's choice of layout: a (B*T, C, H, W) activation gives per-frame
statistics (the JAX package's `num_batch_axes=2`), a (B, C, T, H, W)
activation gives per-clip statistics (`num_batch_axes=1`). `ClipGroupNorm`
is the per-clip one: where a clip's frames are split over the sp ranks, its
statistics are summed over them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dynamicrafter_tpu_torch.parallel.sharding import FrameSplit, sp_all_reduce


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class ClipGroupNorm(GroupNorm):
    """GroupNorm over a (B, C, T, ...) clip. With `frames` (this rank holds
    T/sp of each clip's frames) the statistics still span the whole clip:
    fp32 sums of x and x^2 over (C/G, T/sp, ...) are summed over the sp
    group in one all-reduce, then normalize. Without it, GroupNorm's own
    path, bit for bit."""

    def forward(self, x: torch.Tensor, frames: Optional[FrameSplit] = None) -> torch.Tensor:
        if frames is None:
            return super().forward(x)
        b, c = x.shape[:2]
        g = x.float().reshape(b, self.num_groups, -1)
        sums = sp_all_reduce(torch.stack([g.sum(-1), g.square().sum(-1)]), frames)
        n = g.shape[-1] * frames.sp
        mean = sums[0] / n
        var = (sums[1] / n - mean.square()).clamp_min(0.0)
        y = (g - mean[..., None]) * torch.rsqrt(var + self.eps)[..., None]
        affine = (1, c) + (1,) * (x.dim() - 2)
        y = y.reshape(x.shape) * self.weight.float().view(affine) + self.bias.float().view(affine)
        return y.to(x.dtype)


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
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y if self.keep_fp32 else y.to(x.dtype)


def keep_norms_fp32(module: nn.Module) -> nn.Module:
    """After `module.to(bfloat16)`: put every norm's affine back in fp32."""
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.float()
    return module
