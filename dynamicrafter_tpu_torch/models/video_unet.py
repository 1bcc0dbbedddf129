"""Stable Video Diffusion's spatio-temporal UNet (sgm's `VideoUNet`).

Stability AI's generative-models, sgm/modules/diffusionmodules/video_model.py
and sgm/modules/video_attention.py (Blattmann et al. 2023, arXiv 2311.15127).
Built on the DynamiCrafter UNet's modules: `unet3d.py`'s level plan, and
`blocks.py`'s spatial `ResBlock`, `SpatialTransformer` (its norm,
projections and `BasicTransformerBlock`s), `CrossAttention`, GEGLU
`FeedForward`, `Downsample` and `Upsample`. What SVD adds sits beside each
spatial layer, merged with it by a learned blend (`AlphaBlender`):

  * `VideoResBlock`: the spatial ResBlock, then a `TimeResBlock`
    (GN-SiLU-Conv3d(3,1,1), the emb add, GN-SiLU-Conv3d, identity skip) over
    the clip; x = a x_spatial + (1 - a) x_temporal, a = sigmoid(mix_factor).
  * `SpatialVideoTransformer`: GN, proj_in and the spatial blocks give x;
    x_mix = x + MLP(timestep_embedding(frame index)); a
    `VideoTransformerBlock` on x_mix (ff_in, self-attention over T,
    cross-attention over T to the clip's image token, ff, each pre-LN and
    residual); a x + (1 - a) x_mix, proj_out, plus the input.

Layout as in `unet3d.py`: the public forward takes x (B, T, h, w, C_in)
and returns (B, T, h, w, C_out); inside, (B*T, C, h, w) channels-last.
The temporal layers view a clip as (B, C, T, h, w) (Conv3d, per-clip
GroupNorm) or as time-major tokens (B, T, h*w, C): the temporal
self-attention goes through `attention_axis1` (K2, T <= 32) with no copy.
The cross-attention over T has one key, the clip's image token: each
query's result is that token's value whatever axis the queries lie on, so
it runs on the same layout through `dot_product_attention` (the plain
path). The context and the embeddings are one per clip and broadcast over
its frames, where sgm repeats them per frame: in sampling every frame of a
clip has the same noise level, so the two are the same.

Spans (`utils/trace.py`): `unet` (attrs rows, frames) around a call;
`resblock` around each spatial ResBlock (its own), `spatial` around each
transformer, and `temporal` around each time ResBlock with its blend and
around each frame embedding + `VideoTransformerBlock` + blend (inside
`spatial`: the innermost span takes a kernel's time).

Submodule names are sgm's, so the state_dict keys are the released
checkpoint's `model.diffusion_model.*` keys (time_stack, time_mixer,
time_pos_embed, label_emb.0.0, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from dynamicrafter_tpu_torch import schedule as sched
from dynamicrafter_tpu_torch.models.blocks import (
    CrossAttention,
    Downsample,
    FeedForward,
    ResBlock,
    SpatialTransformer,
    Upsample,
    _from_clip,
    _proj,
    _to_clip,
)
from dynamicrafter_tpu_torch.models.unet3d import _build_level_specs, _time_mlp
from dynamicrafter_tpu_torch.ops.norms import GroupNorm, LayerNorm
from dynamicrafter_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class VideoUNetConfig:
    in_channels: int = 8
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    adm_in_channels: int = 768
    num_classes: str = "sequential"
    extra_ff_mix_layer: bool = True
    use_spatial_context: bool = True
    merge_strategy: str = "learned_with_images"
    video_kernel_size: Tuple[int, ...] = (3, 1, 1)
    use_linear_in_transformer: bool = True
    # the level plan of unet3d.py; the temporal layers live inside the video blocks
    temporal_attention = False

    @classmethod
    def from_dict(cls, d: dict) -> "VideoUNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items() if k in known})
        if cfg.num_classes != "sequential":
            raise ValueError(f"num_classes {cfg.num_classes!r}: only 'sequential' is built")
        if not cfg.use_spatial_context:
            raise ValueError("use_spatial_context false (a separate time context) is not built")
        if cfg.merge_strategy not in ("learned", "learned_with_images"):
            raise ValueError(f"merge_strategy {cfg.merge_strategy!r}: only the learned blends "
                             "are built")
        return cfg


class AlphaBlender(nn.Module):
    """a x_spatial + (1 - a) x_temporal, a = sigmoid(mix_factor): sgm's
    learned strategies (its image_only_indicator is 0 in sampling, so
    learned_with_images blends every frame)."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([0.5]))

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.mix_factor.float()).to(x_spatial.dtype)
        return a * x_spatial + (1.0 - a) * x_temporal


class TimeResBlock(nn.Module):
    """sgm's ResBlock with dims=3 and a (3, 1, 1) kernel over a clip (B, C,
    T, h, w): GN-SiLU-Conv3d, + the emb projected per clip (sgm's
    exchange_temb_dims: one emb a frame, here the same for every frame),
    GN-SiLU-Conv3d, identity skip. `emb_channels` None: no emb
    (`skip_t_emb`, the decoder's). GroupNorm statistics span the clip (the
    (B, C, T, h, w) layout), eps 1e-5."""

    def __init__(self, channels: int, emb_channels: Optional[int],
                 kernel_size: Tuple[int, ...] = (3, 1, 1)):
        super().__init__()
        pad = tuple(k // 2 for k in kernel_size)
        self.in_layers = nn.Sequential(GroupNorm(32, channels), nn.SiLU(),
                                       nn.Conv3d(channels, channels, kernel_size, padding=pad))
        if emb_channels is not None:
            self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, channels))
        self.out_layers = nn.Sequential(GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv3d(channels, channels, kernel_size, padding=pad))

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, C, T, h, w); emb: (B, E). The norms take the SiLU after
        them, the second also the emb add before it."""
        h = self.in_layers[2](self.in_layers[0](x, silu=True))
        add = None
        if emb is not None:
            add = self.emb_layers(emb).to(h.dtype).reshape(h.shape[0], -1, 1, 1, 1)
        h = self.out_layers[0](h, add=add, silu=True)
        return x + self.out_layers[3](h)


class VideoResBlock(ResBlock):
    """The spatial ResBlock, then the clip's TimeResBlock, blended:
    a x_spatial + (1 - a) x_temporal."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 video_kernel_size: Tuple[int, ...] = (3, 1, 1)):
        super().__init__(channels, emb_channels, out_channels=out_channels)
        out_ch = out_channels or channels
        self.time_stack = TimeResBlock(out_ch, emb_channels, video_kernel_size)
        self.time_mixer = AlphaBlender()

    def forward(self, x: torch.Tensor, emb: torch.Tensor, t: int) -> torch.Tensor:
        """x: (B*T, C, h, w); emb: (B, E)."""
        x = super().forward(x, emb, t)
        with trace.span("temporal"):
            clip = _to_clip(x, t)
            return _from_clip(self.time_mixer(clip, self.time_stack(clip, emb)))


class VideoTransformerBlock(nn.Module):
    """sgm's VideoTransformerBlock on time-major tokens (B, T, G, C): pre-LN
    GEGLU ff_in, self-attention over T, cross-attention over T to the
    context, GEGLU ff, each residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: int,
                 ff_in: bool = True):
        super().__init__()
        if ff_in:
            self.norm_in = LayerNorm(dim)
            self.ff_in = FeedForward(dim)
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head, tokens_axis1=True)
        self.norm1 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=n_heads, dim_head=d_head)
        self.norm2 = LayerNorm(dim)
        self.ff = FeedForward(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """x: (B, T, G, C); context: (B, L, Cc), one per clip."""
        if hasattr(self, "ff_in"):
            x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=(context, None)) + x
        return self.ff(self.norm3(x)) + x


class SpatialVideoTransformer(SpatialTransformer):
    """The spatial transformer and its temporal twin (see the module
    docstring); `forward(x, context, t)` as `SpatialTransformer`'s."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: int = 1024, use_linear: bool = True, ff_in: bool = True):
        super().__init__(in_channels, n_heads, d_head, depth=depth, context_dim=context_dim,
                         use_linear=use_linear)
        inner = n_heads * d_head
        self.time_stack = nn.ModuleList([
            VideoTransformerBlock(inner, n_heads, d_head, context_dim, ff_in=ff_in)
            for _ in range(depth)])
        self.time_pos_embed = nn.Sequential(nn.Linear(in_channels, in_channels * 4), nn.SiLU(),
                                            nn.Linear(in_channels * 4, in_channels))
        self.time_mixer = AlphaBlender()

    def forward(self, x: torch.Tensor, context: torch.Tensor, t: int) -> torch.Tensor:
        """x: (B*T, C, h, w); context: (B, L, Cc)."""
        with trace.span("spatial"):
            bt, c, h, w = x.shape
            y = self.norm(x).flatten(2).transpose(1, 2).reshape(bt // t, t, h * w, c)
            y = _proj(self.proj_in, y)                             # (B, T, HW, C)
            frames = torch.arange(t, device=x.device)
            for block, mix in zip(self.transformer_blocks, self.time_stack):
                y = block(y, context=(context, None))
                with trace.span("temporal"):
                    emb = self.time_pos_embed(
                        sched.timestep_embedding(frames, c).to(y.dtype))
                    y_mix = mix(y + emb[None, :, None, :], context)
                    y = self.time_mixer(y, y_mix)
            y = _proj(self.proj_out, y)
            return y.reshape(bt, h * w, c).transpose(1, 2).reshape(bt, c, h, w) + x


class VideoUNet(nn.Module):
    def __init__(self, config: VideoUNetConfig):
        super().__init__()
        cfg = self.config = config
        ted = cfg.model_channels * 4
        self.time_embed = _time_mlp(cfg.model_channels, ted)
        self.label_emb = nn.Sequential(_time_mlp(cfg.adm_in_channels, ted))
        in_specs, mid_spec, out_specs = _build_level_specs(cfg)
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([self._make_layer(s) for s in block]) for block in in_specs])
        self.middle_block = nn.ModuleList([self._make_layer(s) for s in mid_spec])
        self.output_blocks = nn.ModuleList(
            [nn.ModuleList([self._make_layer(s) for s in block]) for block in out_specs])
        self.out = nn.Sequential(
            GroupNorm(32, cfg.model_channels), nn.SiLU(),
            nn.Conv2d(cfg.model_channels, cfg.out_channels, 3, padding=1))

    def _make_layer(self, spec) -> nn.Module:
        cfg = self.config
        kind = spec[0]
        if kind == "conv_first":
            return nn.Conv2d(cfg.in_channels, spec[1], 3, padding=1)
        if kind == "res":
            return VideoResBlock(spec[1], cfg.model_channels * 4, out_channels=spec[2],
                                 video_kernel_size=cfg.video_kernel_size)
        if kind == "spatial":
            d = cfg.num_head_channels
            return SpatialVideoTransformer(
                spec[1], spec[1] // d, d, depth=cfg.transformer_depth,
                context_dim=cfg.context_dim, use_linear=cfg.use_linear_in_transformer,
                ff_in=cfg.extra_ff_mix_layer)
        if kind == "down":
            return Downsample(spec[1])
        if kind == "up":
            return Upsample(spec[1])
        raise ValueError(kind)

    @property
    def dtype(self) -> torch.dtype:
        return self.out[2].weight.dtype

    def _run_layers(self, layers, h, emb, context, t):
        for layer in layers:
            if isinstance(layer, VideoResBlock):
                h = layer(h, emb, t)
            elif isinstance(layer, SpatialVideoTransformer):
                h = layer(h, context, t)
            else:  # first conv, down, up
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        """x: (B, T, h, w, C_in); timesteps: (B,) float (the denoiser's
        c_noise); context: (B, L, context_dim), one per clip; y: (B,
        adm_in_channels). Returns (B, T, h, w, C_out) in the UNet's dtype."""
        b, t, hh, ww, cin = x.shape
        with trace.span("unet", rows=b * t, frames=t):
            cfg = self.config
            dtype = self.dtype
            h = x.to(dtype).permute(0, 1, 4, 2, 3).reshape(b * t, cin, hh, ww)
            context = context.to(dtype)
            emb = self.time_embed(sched.timestep_embedding(timesteps, cfg.model_channels).to(dtype))
            emb = emb + self.label_emb(y.to(dtype))
            hs = []
            for layers in self.input_blocks:
                h = self._run_layers(layers, h, emb, context, t)
                hs.append(h)
            h = self._run_layers(self.middle_block, h, emb, context, t)
            for layers in self.output_blocks:
                h = torch.cat([h, hs.pop()], dim=1)
                h = self._run_layers(layers, h, emb, context, t)
            h = self.out[2](self.out[0](h, silu=True))   # out[1]'s SiLU in the norm
            return h.view(b, t, *h.shape[1:]).permute(0, 1, 3, 4, 2)
