"""Normalization layers with fp32 islands.

The reference keeps GroupNorm in fp32 inside an otherwise half-precision
network (lvdm/basics.py:76-87). Here statistics and affine run in float32
and the result is cast back to the input dtype; the affine parameters stay
float32 whatever the storage dtype of the rest of the model.

Layout follows torch: (N, C, *rest). Which axes the statistics span is the
caller's choice of layout: a (B*T, C, H, W) activation gives per-frame
statistics (the JAX package's `num_batch_axes=2`), a (B, C, T, H, W)
activation gives per-clip statistics (`num_batch_axes=1`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
