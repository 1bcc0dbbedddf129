"""UNet building blocks (reference lvdm/modules/attention.py and
lvdm/modules/networks/openaimodel3d.py; JAX twin dynamicrafter_tpu/models/blocks.py).

Layout: the UNet carries activations as (B*T, C, H, W), the reference's own
layout, so spatial convs are plain Conv2d. Temporal blocks view them as
(B, C, T, H, W) (Conv3d, per-clip GroupNorm) or as time-major tokens
(B, T, H*W, C) (temporal attention, read in place by K2). Every block that
mixes frames takes the frame count `t` as an argument.

Under the sp axis (`frames`, a `parallel.sharding.FrameSplit`) the
activations hold this rank's T/sp frames of each clip and `t` is that local
count. Per-frame blocks run as they are. The blocks that mix frames write
out the collectives that JAX's partitioner inserts (its models/blocks.py
307-355, 469-482): TemporalTransformer normalizes with the clip's
statistics, moves to every frame of HW/sp positions and back (two
all-to-alls), and runs replicated where sp does not divide HW; each
temporal conv takes its neighbours' boundary frames (`halo`) in place of
its zero padding along T.

Submodule names and Sequential indices reproduce the reference checkpoint
keys (to_out.0, ff.net.0.proj, in_layers.2, temopral_conv.conv1.2, ...).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamicrafter_tpu_torch.ops.attention import attention_axis1, dot_product_attention
from dynamicrafter_tpu_torch.ops.norms import ClipGroupNorm, GroupNorm, LayerNorm
from dynamicrafter_tpu_torch.parallel import sharding
from dynamicrafter_tpu_torch.parallel.sharding import FrameSplit
from dynamicrafter_tpu_torch.utils import trace

Context = Optional[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]
# (text context (B, Lt, Cc), image context (B, T, Li, Cc) or None)


def _proj(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A channels-last projection held as Linear or Conv1d(k=1) (the
    reference's module type decides the checkpoint rank)."""
    return F.linear(x, layer.weight.reshape(layer.weight.shape[0], -1), layer.bias)


class RelativePosition(nn.Module):
    """Learned relative-position embedding table (reference
    attention.py:20-39): (length_q, length_k) -> (Lq, Lk, num_units), the
    row for each clipped distance k - q."""

    def __init__(self, num_units: int, max_relative_position: int):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(
            torch.empty(max_relative_position * 2 + 1, num_units))

    def forward(self, length_q: int, length_k: int) -> torch.Tensor:
        dev = self.embeddings_table.device
        dist = torch.arange(length_k, device=dev)[None, :] - \
            torch.arange(length_q, device=dev)[:, None]
        m = self.max_relative_position
        return self.embeddings_table[dist.clamp(-m, m) + m]


class CrossAttention(nn.Module):
    """Self- or cross-attention with the optional dual image-K/V branch.

    Queries x: (B, G, L, C) with tokens at -2, or (B, T, G, C) with tokens
    at axis 1 when `tokens_axis1` (temporal self-attention).
    `relative_position` adds the learned relative-position terms to the
    logits and the values of self-attention (tokens at -2, plain path)."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64,
                 relative_position: bool = False,
                 temporal_length: Optional[int] = None,
                 image_cross_attention: bool = False,
                 image_cross_attention_scale_learnable: bool = False,
                 tokens_axis1: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.tokens_axis1 = tokens_axis1
        if relative_position:
            if tokens_axis1 or temporal_length is None:
                raise ValueError("relative_position needs tokens at -2 and a temporal_length")
            self.relative_position_k = RelativePosition(dim_head, temporal_length)
            self.relative_position_v = RelativePosition(dim_head, temporal_length)
        self.relative_position = relative_position
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

    def _relative_attention(self, q, k, v, mask):
        """softmax((q k^T + q k2^T) scale) (v + v2), k2/v2 the relative-position
        rows; logits in the input dtype, fp32 softmax."""
        lq, lk = q.shape[-3], k.shape[-3]
        k2 = self.relative_position_k(lq, lk).to(q.dtype)
        v2 = self.relative_position_v(lq, lk).to(q.dtype)
        scale = self.dim_head ** -0.5
        qh, kh, vh = (t.transpose(-3, -2) for t in (q, k, v))       # (..., H, L, D)
        sim = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        sim = sim + torch.einsum("...hqd,qkd->...hqk", qh, k2) * scale
        if mask is not None:
            sim = sim.masked_fill(~mask, -torch.finfo(sim.dtype).max)
        attn = torch.softmax(sim.float(), dim=-1).to(q.dtype)
        out = torch.matmul(attn, vh) + torch.einsum("...hqk,qkd->...hqd", attn, v2)
        return out.transpose(-3, -2)

    def forward(self, x: torch.Tensor, context: Context = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        split = lambda t: t.unflatten(-1, (self.heads, self.dim_head))
        q = split(self.to_q(x))
        if context is None:
            k, v = split(self.to_k(x)), split(self.to_v(x))
            if self.relative_position:
                out = self._relative_attention(q, k, v, mask).flatten(-2)
            else:
                attend = attention_axis1 if self.tokens_axis1 else dot_product_attention
                out = attend(q, k, v, mask=mask).flatten(-2)
        else:
            if self.tokens_axis1:
                raise ValueError("time-major attention is self-attention only")
            text_ctx, img_ctx = context
            k, v = split(self.to_k(text_ctx)), split(self.to_v(text_ctx))
            out = dot_product_attention(q, k, v, mask=mask).flatten(-2)
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
                 tokens_axis1: bool = False, relative_position: bool = False,
                 temporal_length: Optional[int] = None):
        super().__init__()
        kw = dict(heads=n_heads, dim_head=d_head, tokens_axis1=tokens_axis1,
                  relative_position=relative_position, temporal_length=temporal_length)
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

    def forward(self, x: torch.Tensor, context: Context = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x), mask=mask) + x
        x = self.attn2(self.norm2(x), context=context, mask=mask) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Per-frame transformer over the H*W tokens of each frame."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, context_dim: Optional[int] = None,
                 image_cross_attention: bool = False,
                 image_cross_attention_scale_learnable: bool = False,
                 use_linear: bool = True):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
        # the reference holds these as 1x1 Conv2d without use_linear: the
        # same projection, a rank-4 weight in the checkpoint
        proj = (lambda i, o: nn.Linear(i, o)) if use_linear else \
            (lambda i, o: nn.Conv2d(i, o, 1))
        self.proj_in = proj(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(
                inner, n_heads, d_head, context_dim=context_dim,
                image_cross_attention=image_cross_attention,
                image_cross_attention_scale_learnable=image_cross_attention_scale_learnable)
            for _ in range(depth)])
        self.proj_out = proj(inner, in_channels)

    def forward(self, x: torch.Tensor, context: Context, t: int) -> torch.Tensor:
        with trace.span("spatial"):
            bt, c, h, w = x.shape
            y = self.norm(x).flatten(2).transpose(1, 2).reshape(bt // t, t, h * w, c)
            y = _proj(self.proj_in, y)
            for block in self.transformer_blocks:
                y = block(y, context=context)
            y = _proj(self.proj_out, y)
            return y.reshape(bt, h * w, c).transpose(1, 2).reshape(bt, c, h, w) + x


class TemporalTransformer(nn.Module):
    """Per-position transformer over the T axis; GroupNorm statistics are per
    clip. The shipped configs take the time-major layout (B, T, H*W, C)
    throughout (K2 reads it in place). `relative_position` and
    `causal_attention` take the (B, H*W, T, C) layout with tokens at -2 and
    the plain attention path, as in the JAX package. `use_linear=False` is
    init_attn's form: its projections are Conv1d(k=1) in the reference
    checkpoint."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, use_linear: bool = True,
                 causal_attention: bool = False, relative_position: bool = False,
                 temporal_length: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = ClipGroupNorm(32, in_channels, eps=1e-6)
        proj = (lambda i, o: nn.Linear(i, o)) if use_linear else \
            (lambda i, o: nn.Conv1d(i, o, 1))
        self.proj_in = proj(in_channels, inner)
        self.causal_attention = causal_attention
        self.time_major = not (relative_position or causal_attention)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, n_heads, d_head, tokens_axis1=self.time_major,
                                  relative_position=relative_position,
                                  temporal_length=temporal_length)
            for _ in range(depth)])
        self.proj_out = proj(inner, in_channels)

    def forward(self, x: torch.Tensor, t: int, frames: Optional[FrameSplit] = None) -> torch.Tensor:
        with trace.span("temporal"):
            bt, c, h, w = x.shape
            b = bt // t
            if frames is not None:
                if (h * w) % frames.sp:
                    # HW does not split: gather the clip, run whole, keep this
                    # rank's frames (JAX drops the 'sp' constraint here)
                    whole = sharding.sp_gather_frames(x.view(b, t, c, h, w), frames)
                    y = self.forward(whole.reshape(b * frames.t, c, h, w), frames.t)
                    return frames.slice(y.view(b, frames.t, c, h, w)).reshape(bt, c, h, w)
            # under sp, JAX's order: the norm on this rank's frames with the
            # clip's statistics, the all-to-all to every frame of HW/sp positions
            # (K2 reads that layout in place), the blocks, the all-to-all back
            y = self.norm(x.view(b, t, c, h * w).transpose(1, 2), frames)   # (B, C, T', HW)
            y = y.permute(0, 2, 3, 1)                                # (B, T', HW, C)
            if frames is not None:
                y = sharding.frames_to_tokens(y, frames)             # (B, T, HW/sp, C)
                t = frames.t
            if not self.time_major:
                y = y.transpose(1, 2)                                # (B, HW, T, C)
            y = _proj(self.proj_in, y)
            mask = None
            if self.causal_attention:
                mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
            for block in self.transformer_blocks:
                y = block(y, mask=mask)
            y = _proj(self.proj_out, y)
            if not self.time_major:
                y = y.transpose(1, 2)                                # (B, T, HW, C)
            if frames is not None:
                y = sharding.tokens_to_frames(y, frames)             # (B, T/sp, HW, C)
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
    """Residual block of four (3, 1, 1) temporal convs
    (openaimodel3d.py:239-279); `spatial_aware` widens them to (3, 3, 1)
    and (3, 1, 3) in turn."""

    def __init__(self, channels: int, spatial_aware: bool = False):
        super().__init__()

        def conv(w_axis: bool) -> nn.Conv3d:
            k = (3, 1, 1) if not spatial_aware else ((3, 1, 3) if w_axis else (3, 3, 1))
            return nn.Conv3d(channels, channels, k, padding=tuple(e // 2 for e in k))

        gn = lambda: ClipGroupNorm(32, channels)
        self.conv1 = nn.Sequential(gn(), nn.SiLU(), conv(False))
        self.conv2 = nn.Sequential(gn(), nn.SiLU(), nn.Dropout(0.0), conv(True))
        self.conv3 = nn.Sequential(gn(), nn.SiLU(), nn.Dropout(0.0), conv(False))
        self.conv4 = nn.Sequential(gn(), nn.SiLU(), nn.Dropout(0.0), conv(True))

    def forward(self, x: torch.Tensor, t: int, frames: Optional[FrameSplit] = None) -> torch.Tensor:
        """x: (B*T, C, H, W)."""
        clip = _to_clip(x, t)
        h = clip
        for seq in (self.conv1, self.conv2, self.conv3, self.conv4):
            h = seq[0](h, frames, silu=True)        # the norm takes seq[1]'s SiLU
            for layer in seq[2:-1]:                 # Dropout(0)
                h = layer(h)
            conv = seq[-1]
            if frames is None:
                h = conv(h)
                continue
            # the neighbours' boundary frames stand in for the zero padding
            # along T (zeros at the clip's ends)
            prev, nxt = sharding.halo(h, frames, dim=2)
            h = F.conv3d(torch.cat([prev, h, nxt], dim=2), conv.weight, conv.bias,
                         padding=(0, *conv.padding[1:]))
        return _from_clip(clip + h)


class Downsample(nn.Module):
    """Stride-2 3x3 conv, or a 2x2 average pool without `use_conv`."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.op = (nn.Conv2d(channels, channels, 3, stride=2, padding=1) if use_conv
                   else nn.AvgPool2d(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv unless `use_conv` is off."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        if use_conv:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.use_conv = use_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.use_conv else x


class ResBlock(nn.Module):
    """GN-SiLU-conv residual block with the timestep-embedding add (or
    scale and shift of the second norm, `use_scale_shift_norm`), optional
    2x resampling of both branches (`up` / `down`) and the optional
    temporal-conv tail (openaimodel3d.py:109-236)."""

    def __init__(self, channels: int, emb_channels: int,
                 out_channels: Optional[int] = None, use_temporal_conv: bool = False,
                 use_scale_shift_norm: bool = False, tempspatial_aware: bool = False,
                 up: bool = False, down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            GroupNorm(32, channels), nn.SiLU(), nn.Conv2d(channels, out_ch, 3, padding=1))
        self.resample = (Upsample(channels, use_conv=False) if up
                         else Downsample(channels, use_conv=False) if down else None)
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm(32, out_ch), nn.SiLU(), nn.Dropout(0.0),
            nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else nn.Conv2d(channels, out_ch, 1))
        self.temopral_conv = (TemporalConvBlock(out_ch, spatial_aware=tempspatial_aware)
                              if use_temporal_conv else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, t: int,
                frames: Optional[FrameSplit] = None) -> torch.Tensor:
        """x: (B*T, C, H, W); emb: (B, E), shared by the T frames of a clip.
        `frames` reaches the temporal convs."""
        with trace.span("resblock"):
            # the norms take the SiLU after them (in_layers[1], out_layers[1])
            # and the emb add before the second
            h = self.in_layers[0](x, silu=True)
            if self.resample is not None:
                h = self.resample(h)
                x = self.resample(x)
            h = self.in_layers[2](h)
            emb_out = self.emb_layers(emb).to(h.dtype)[:, None].expand(-1, t, -1)
            emb_out = emb_out.reshape(h.shape[0], -1, 1, 1)
            if self.use_scale_shift_norm:
                scale, shift = emb_out.chunk(2, dim=1)
                h = self.out_layers[1:](self.out_layers[0](h) * (1 + scale) + shift)
            else:
                h = self.out_layers[3](self.out_layers[2](
                    self.out_layers[0](h, add=emb_out, silu=True)))
            h = self.skip_connection(x) + h
            if self.temopral_conv is not None:
                h = self.temopral_conv(h, t, frames)
            return h
