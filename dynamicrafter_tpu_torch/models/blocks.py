"""UNet building blocks (reference lvdm/modules/attention.py and
lvdm/modules/networks/openaimodel3d.py; JAX twin dynamicrafter_tpu/models/blocks.py).

Layout: the UNet carries activations as (B*T, C, H, W), the reference's own
layout, so spatial convs are plain Conv2d. Temporal blocks view them as
(B, C, T, H, W) (Conv3d, per-clip GroupNorm) or as time-major tokens
(B, T, H*W, C) (temporal attention, read in place by K2). Every block that
mixes frames takes the frame count `t` as an argument.

Submodule names and Sequential indices reproduce the reference checkpoint
keys (to_out.0, ff.net.0.proj, in_layers.2, temopral_conv.conv1.2, ...).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamicrafter_tpu_torch.ops.attention import attention_axis1, dot_product_attention
from dynamicrafter_tpu_torch.ops.norms import GroupNorm, LayerNorm

Context = Optional[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]
# (text context (B, Lt, Cc), image context (B, T, Li, Cc) or None)


def _proj(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A channels-last projection held as Linear or Conv1d(k=1) (the
    reference's module type decides the checkpoint rank)."""
    return F.linear(x, layer.weight.reshape(layer.weight.shape[0], -1), layer.bias)


class CrossAttention(nn.Module):
    """Self- or cross-attention with the optional dual image-K/V branch.

    Queries x: (B, G, L, C) with tokens at -2, or (B, T, G, C) with tokens
    at axis 1 when `tokens_axis1` (temporal self-attention)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64,
                 image_cross_attention: bool = False,
                 image_cross_attention_scale_learnable: bool = False,
                 tokens_axis1: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.tokens_axis1 = tokens_axis1
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))
        self.image_cross_attention = image_cross_attention
        self.learnable = image_cross_attention_scale_learnable
        if image_cross_attention:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)
            if image_cross_attention_scale_learnable:
                self.alpha = nn.Parameter(torch.tensor(0.0))

    def forward(self, x: torch.Tensor, context: Context = None) -> torch.Tensor:
        split = lambda t: t.unflatten(-1, (self.heads, self.dim_head))
        q = split(self.to_q(x))
        if context is None:
            k, v = split(self.to_k(x)), split(self.to_v(x))
            attend = attention_axis1 if self.tokens_axis1 else dot_product_attention
            out = attend(q, k, v).flatten(-2)
        else:
            if self.tokens_axis1:
                raise ValueError("time-major attention is self-attention only")
            text_ctx, img_ctx = context
            k, v = split(self.to_k(text_ctx)), split(self.to_v(text_ctx))
            out = dot_product_attention(q, k, v).flatten(-2)
            if self.image_cross_attention and img_ctx is not None:
                k_ip = split(self.to_k_ip(img_ctx))
                v_ip = split(self.to_v_ip(img_ctx))
                out_ip = dot_product_attention(q, k_ip, v_ip).flatten(-2)
                if self.learnable:
                    out_ip = out_ip * (torch.tanh(self.alpha) + 1.0).to(out.dtype)
                out = out + out_ip
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU MLP: net.0 = GEGLU, net.1 = Dropout, net.2 = Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention -> cross-attention -> FF, each residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 context_dim: Optional[int] = None,
                 image_cross_attention: bool = False,
                 image_cross_attention_scale_learnable: bool = False,
                 tokens_axis1: bool = False):
        super().__init__()
        kw = dict(heads=n_heads, dim_head=d_head, tokens_axis1=tokens_axis1)
        self.attn1 = CrossAttention(dim, **kw)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(
            dim, context_dim=context_dim,
            image_cross_attention=image_cross_attention,
            image_cross_attention_scale_learnable=image_cross_attention_scale_learnable,
            **kw)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: Context = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Per-frame transformer over the H*W tokens of each frame."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 image_cross_attention: bool = False,
                 image_cross_attention_scale_learnable: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(
                inner, n_heads, d_head, context_dim=context_dim,
                image_cross_attention=image_cross_attention,
                image_cross_attention_scale_learnable=image_cross_attention_scale_learnable)
            for _ in range(depth)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: Context, t: int) -> torch.Tensor:
        bt, c, h, w = x.shape
        y = self.norm(x).flatten(2).transpose(1, 2).reshape(bt // t, t, h * w, c)
        y = self.proj_in(y)
        for block in self.transformer_blocks:
            y = block(y, context=context)
        y = self.proj_out(y)
        return y.reshape(bt, h * w, c).transpose(1, 2).reshape(bt, c, h, w) + x


class TemporalTransformer(nn.Module):
    """Per-position transformer over the T axis, in the time-major layout
    (B, T, H*W, C) throughout; GroupNorm statistics are per clip. Only the
    path of the shipped configs (no relative position, not causal).
    `use_linear=False` is init_attn's form: its projections are Conv1d(k=1)
    in the reference checkpoint."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, use_linear: bool = True):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
        proj = (lambda i, o: nn.Linear(i, o)) if use_linear else \
            (lambda i, o: nn.Conv1d(i, o, 1))
        self.proj_in = proj(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, tokens_axis1=True)
            for _ in range(depth)])
        self.proj_out = proj(inner, in_channels)

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        bt, c, h, w = x.shape
        b = bt // t
        y = self.norm(x.view(b, t, c, h * w).transpose(1, 2))   # (B, C, T, HW)
        y = _proj(self.proj_in, y.permute(0, 2, 3, 1))           # (B, T, HW, C)
        for block in self.transformer_blocks:
            y = block(y)
        y = _proj(self.proj_out, y)
        return y.transpose(2, 3).reshape(bt, c, h, w) + x


def _to_clip(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B*T, C, H, W) -> (B, C, T, H, W)."""
    bt, c, h, w = x.shape
    return x.view(bt // t, t, c, h, w).transpose(1, 2)


def _from_clip(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B*T, C, H, W)."""
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


class TemporalConvBlock(nn.Module):
    """Residual block of four (3, 1, 1) temporal convs (openaimodel3d.py:239-279)."""

    def __init__(self, channels: int):
        super().__init__()
        conv = lambda: nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        self.conv1 = nn.Sequential(GroupNorm(32, channels), nn.SiLU(), conv())
        self.conv2 = nn.Sequential(GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())
        self.conv3 = nn.Sequential(GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())
        self.conv4 = nn.Sequential(GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        """x: (B*T, C, H, W)."""
        clip = _to_clip(x, t)
        h = self.conv4(self.conv3(self.conv2(self.conv1(clip))))
        return _from_clip(clip + h)


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class ResBlock(nn.Module):
    """GN-SiLU-conv residual block with the timestep-embedding add and the
    optional temporal-conv tail (openaimodel3d.py:109-236)."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, use_temporal_conv: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.in_layers = nn.Sequential(
            GroupNorm(32, channels), nn.SiLU(), nn.Conv2d(channels, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm(32, out_ch), nn.SiLU(), nn.Dropout(0.0),
            nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else nn.Conv2d(channels, out_ch, 1))
        self.temopral_conv = TemporalConvBlock(out_ch) if use_temporal_conv else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor, t: int) -> torch.Tensor:
        """x: (B*T, C, H, W); emb: (B, E), shared by the T frames of a clip."""
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).to(h.dtype)[:, None].expand(-1, t, -1)
        h = self.out_layers(h + emb_out.reshape(h.shape[0], -1, 1, 1))
        h = self.skip_connection(x) + h
        if self.temopral_conv is not None:
            h = self.temopral_conv(h, t)
        return h
