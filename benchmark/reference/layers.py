"""Plain float32 layers of the reference: norms, attention, the timestep
embedding, and the low-precision control.

Attention is softmax(q k^T * scale) v computed in blocks of query rows, so
that the logits of a 9216-token self-attention over 16 frames fit on one
card; the blocks change the order of no sum. `fp8_` turns a reference
model into the control of the correctness check: every weight of a
projection or convolution, and every input it reads, rounded to float8
e4m3 with one scale per tensor (the step below bfloat16).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# bytes of fp32 logits one attention block may hold
_BLOCK_BYTES = 1 << 30
_FP8_MAX = 448.0


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


# GroupNorm over a (B, C, T, ...) clip: statistics span the clip
ClipGroupNorm = GroupNorm


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, keep_fp32: bool = False):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def _rows(qh: torch.Tensor, lk: int) -> int:
    per_row = max(1, qh[..., :1, :1].numel()) * lk * 4
    return max(1, min(qh.shape[-2], _BLOCK_BYTES // per_row))


class _BlockAttention(torch.autograd.Function):
    """softmax(q k^T scale) v over (..., H, L, D) in blocks of query rows,
    keeping only the outputs and the rows' log-sum-exp for the backward,
    which recomputes each block's probabilities (the same arithmetic as
    autograd through the blocks, without holding every block's logits)."""

    @staticmethod
    def forward(ctx, qh, kh, vh, scale):
        rows = _rows(qh, kh.shape[-2])
        outs, lses = [], []
        for i in range(0, qh.shape[-2], rows):
            sim = torch.matmul(qh[..., i:i + rows, :], kh.transpose(-1, -2)) * scale
            lse = torch.logsumexp(sim, dim=-1, keepdim=True)
            outs.append(torch.matmul(torch.exp(sim - lse), vh))
            lses.append(lse)
        out = torch.cat(outs, dim=-2)
        ctx.save_for_backward(qh, kh, vh, out, torch.cat(lses, dim=-2))
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, out, lse = ctx.saved_tensors
        scale = ctx.scale
        rows = _rows(qh, kh.shape[-2])
        di = (dout * out).sum(-1, keepdim=True)
        dq = torch.empty_like(qh)
        dk = torch.zeros(torch.broadcast_shapes(kh.shape[:-2], qh.shape[:-2]) + kh.shape[-2:],
                         dtype=kh.dtype, device=kh.device)
        dv = torch.zeros_like(dk)
        for i in range(0, qh.shape[-2], rows):
            sl = slice(i, i + rows)
            p = torch.exp(torch.matmul(qh[..., sl, :], kh.transpose(-1, -2)) * scale
                          - lse[..., sl, :])
            dv += torch.matmul(p.transpose(-1, -2), dout[..., sl, :])
            ds = p * (torch.matmul(dout[..., sl, :], vh.transpose(-1, -2)) - di[..., sl, :])
            dq[..., sl, :] = torch.matmul(ds, kh) * scale
            dk += torch.matmul(ds.transpose(-1, -2), qh[..., sl, :]) * scale
        reduce = lambda g, like: g.sum_to_size(like.shape)
        return dq, reduce(dk, kh), reduce(dv, vh), None


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Lq, H, D); k, v: (..., Lk, H, D), possibly with fewer leading
    dims than q (broadcast). mask: broadcastable to (..., H, Lq, Lk), False
    masks a position out."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    while k.dim() < q.dim():
        k, v = k.unsqueeze(-4), v.unsqueeze(-4)
    qh, kh, vh = (x.transpose(-3, -2) for x in (q, k, v))   # (..., H, L, D)
    if mask is None:
        return _BlockAttention.apply(qh, kh, vh, scale).transpose(-3, -2)
    rows = _rows(qh, kh.shape[-2])
    outs = []
    for i in range(0, qh.shape[-2], rows):
        sim = torch.matmul(qh[..., i:i + rows, :], kh.transpose(-1, -2)) * scale
        m = mask if mask.shape[-2] == 1 else mask[..., i:i + rows, :]
        sim = sim.masked_fill(~m, -torch.finfo(sim.dtype).max)
        outs.append(torch.matmul(torch.softmax(sim, dim=-1), vh))
    return torch.cat(outs, dim=-2).transpose(-3, -2)


def dot_product_attention(q, k, v, mask=None, scale=None, backend=None):
    return plain_attention(q, k, v, mask=mask, scale=scale)


def attention_axis1(q, k, v, mask=None, scale=None, backend=None):
    """Self-attention over the axis-1 tokens of (B, T, G, H, D)."""
    mv = lambda x: x.movedim(1, -3)
    return plain_attention(mv(q), mv(k), mv(v), mask=mask, scale=scale).movedim(-3, 1)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding [cos | sin], (N, dim), computed in float64."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float64) / half).to(timesteps.device)
    args = timesteps[:, None].double() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.float()


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor, back in x's
    dtype; the gradient passes straight through."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / _FP8_MAX
    q = ((x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s).to(x.dtype)
    return x + (q - x).detach()


def _linear(m: nn.Linear):
    return lambda x: to_fp8(F.linear(to_fp8(x), to_fp8(m.weight), m.bias))


def _conv(m):
    return lambda x: to_fp8(m._conv_forward(to_fp8(x), to_fp8(m.weight), m.bias))


def fp8_(model: nn.Module) -> nn.Module:
    """The control: every Linear and convolution of `model` computes from
    its weight and its input rounded to float8 and stores its output in
    float8 (float32 arithmetic on the rounded values, float32 norms;
    gradients pass straight through the rounding)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.forward = _linear(m)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            m.forward = _conv(m)
        if isinstance(m, (nn.Linear, nn.Conv1d)) or hasattr(m, "in_proj_weight"):
            m.quantize = to_fp8          # read where a projection is computed by hand
    return model
