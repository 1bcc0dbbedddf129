"""The 3D (factorized spatial/temporal) UNet denoiser.

Reference lvdm/modules/networks/openaimodel3d.py:281-603; JAX twin
dynamicrafter_tpu/models/unet3d.py. The public forward keeps the JAX
layout, x (B, T, h, w, C) -> (B, T, h, w, C_out); inside, activations are
(B*T, C, h, w). As in the JAX package, the text context is not repeated per
frame (its K/V broadcast over frames) and the timestep/fs embeddings are
shared by the frames of a clip.

Block indices follow the reference construction loops, so the state_dict
keys are the released checkpoint's `model.diffusion_model.*` keys.

`use_checkpoint` (set by every shipped config) turns on per-layer gradient
checkpointing while gradients are being recorded: each ResBlock,
SpatialTransformer, TemporalTransformer and `init_attn` is its own
`torch.utils.checkpoint` segment, as the JAX package's
`remat_layers=True` ("blocks", the policy its training CLI picks above
32x32 latents). The segments keep the flash-attention op's outputs (o and
lse) across the boundary (`flash_residual_policy`, the JAX package's
`_flash_residual_policy`), so the backward pass feeds K4a/K4b from them and
K3 runs once per spatial self-attention per step. Without gradients (the
sampler) nothing is checkpointed.

Each call is a span `unet` (`utils/trace.py`); each ResBlock,
SpatialTransformer and TemporalTransformer (`init_attn` too) opens its
span `resblock`, `spatial` or `temporal` in its own forward, so the
recomputation of a checkpointed layer in the backward pass opens it again.

The sp axis: under `parallel.sharding.use_frames(split)` x holds this
rank's T/sp frames of each clip and the output is this rank's frames (the
JAX UNet's T on 'sp', models/unet3d.py:284,339). Every layer runs with the
local frame count; the temporal ones get `split` as an argument and make
the collectives (`models/blocks.py`). Where sp does not divide T the caller
makes no split and every rank runs the whole clip.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dynamicrafter_tpu_torch import schedule as sched
from dynamicrafter_tpu_torch.models.blocks import (
    Downsample,
    ResBlock,
    SpatialTransformer,
    TemporalTransformer,
    Upsample,
)
from dynamicrafter_tpu_torch.ops.norms import GroupNorm
from dynamicrafter_tpu_torch.parallel.sharding import active_frames
from dynamicrafter_tpu_torch.utils import trace


def flash_residual_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy: save the flash op's (o, lse), recompute
    everything else (projections, norms, convs, K2)."""
    if op is torch.ops.dct.flash_attn.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(layer: nn.Module, *args):
    """Run `layer(*args)` as one checkpoint segment under
    `flash_residual_policy`."""
    return checkpoint(layer, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   flash_residual_policy))


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    dropout: float = 0.0
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    conv_resample: bool = True
    context_dim: Optional[int] = 1024
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    num_heads: int = -1
    num_head_channels: int = 64
    transformer_depth: int = 1
    use_linear: bool = True
    use_checkpoint: bool = False
    temporal_conv: bool = True
    tempspatial_aware: bool = False
    temporal_attention: bool = True
    use_relative_position: bool = False
    use_causal_attention: bool = False
    temporal_length: Optional[int] = 16
    addition_attention: bool = True
    temporal_selfatt_only: bool = True
    image_cross_attention: bool = True
    image_cross_attention_scale_learnable: bool = False
    default_fs: int = 3
    fs_condition: bool = False
    text_context_len: int = 77

    def heads_for(self, ch: int) -> Tuple[int, int]:
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels

    @classmethod
    def from_dict(cls, d: dict) -> "UNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in known})


def _build_level_specs(cfg: UNetConfig):
    """Static topology (input_specs, middle_spec, output_specs), the same
    construction as the reference (openaimodel3d.py:383-540)."""
    input_specs = [[("conv_first", cfg.model_channels)]]
    input_chans = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [("res", ch, mult * cfg.model_channels)]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                layers.append(("spatial", ch))
                if cfg.temporal_attention:
                    layers.append(("temporal", ch))
            input_specs.append(layers)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_specs.append([("down", ch)])
            input_chans.append(ch)
            ds *= 2

    middle_spec = [("res", ch, ch), ("spatial", ch)]
    if cfg.temporal_attention:
        middle_spec.append(("temporal", ch))
    middle_spec.append(("res", ch, ch))

    output_specs = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            layers = [("res", ch + ich, mult * cfg.model_channels)]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                layers.append(("spatial", ch))
                if cfg.temporal_attention:
                    layers.append(("temporal", ch))
            if level and i == cfg.num_res_blocks:
                layers.append(("up", ch))
                ds //= 2
            output_specs.append(layers)
    return input_specs, middle_spec, output_specs


def _time_mlp(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(cin, cout), nn.SiLU(), nn.Linear(cout, cout))


class UNetModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        if cfg.resblock_updown:
            # the JAX package's UNet builds plain Down/Upsample layers whatever
            # this flag says (only its ResBlock knows up/down); refuse it
            # here so a checkpoint that needs it fails at construction
            raise NotImplementedError("resblock_updown is not built by the UNet")
        ted = cfg.model_channels * 4
        self.time_embed = _time_mlp(cfg.model_channels, ted)
        if cfg.fs_condition:
            self.fps_embedding = _time_mlp(cfg.model_channels, ted)
        in_specs, mid_spec, out_specs = _build_level_specs(cfg)
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([self._make_layer(s) for s in block]) for block in in_specs])
        if cfg.addition_attention:
            # built without use_linear in the reference: Conv1d projections
            self.init_attn = nn.ModuleList([TemporalTransformer(
                cfg.model_channels, 8, cfg.num_head_channels,
                depth=cfg.transformer_depth, use_linear=False,
                relative_position=cfg.use_relative_position,
                temporal_length=cfg.temporal_length)])
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
            return ResBlock(spec[1], cfg.model_channels * 4, out_channels=spec[2],
                            use_temporal_conv=cfg.temporal_conv,
                            use_scale_shift_norm=cfg.use_scale_shift_norm,
                            tempspatial_aware=cfg.tempspatial_aware)
        heads, dim_head = cfg.heads_for(spec[1])
        if kind == "spatial":
            return SpatialTransformer(
                spec[1], heads, dim_head, depth=cfg.transformer_depth,
                context_dim=cfg.context_dim,
                image_cross_attention=cfg.image_cross_attention,
                image_cross_attention_scale_learnable=cfg.image_cross_attention_scale_learnable,
                use_linear=cfg.use_linear)
        if kind == "temporal":
            return TemporalTransformer(
                spec[1], heads, dim_head, depth=cfg.transformer_depth,
                use_linear=cfg.use_linear, causal_attention=cfg.use_causal_attention,
                relative_position=cfg.use_relative_position,
                temporal_length=cfg.temporal_length)
        if kind == "down":
            return Downsample(spec[1], use_conv=cfg.conv_resample)
        if kind == "up":
            return Upsample(spec[1], use_conv=cfg.conv_resample)
        raise ValueError(kind)

    @property
    def dtype(self) -> torch.dtype:
        return self.out[2].weight.dtype

    def _call(self, layer: nn.Module, *args):
        if self.config.use_checkpoint and torch.is_grad_enabled():
            return checkpointed(layer, *args)
        return layer(*args)

    def _run_layers(self, layers, h, emb, context, t, frames=None):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = self._call(layer, h, emb, t, frames)
            elif isinstance(layer, SpatialTransformer):
                h = self._call(layer, h, context, t)
            elif isinstance(layer, TemporalTransformer):
                h = self._call(layer, h, t, frames)
            else:  # first conv, down, up
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context_text: Optional[torch.Tensor] = None,
                context_img: Optional[torch.Tensor] = None,
                fs: Optional[torch.Tensor] = None,
                cache: Optional[torch.Tensor] = None, return_cache: bool = False):
        """x: (B, T, h, w, C_in); timesteps, fs: (B,); context_text
        (B, Lt, Cc); context_img (B, T, Li, Cc). Returns (B, T, h, w, C_out).

        The DeepCache seam (Ma et al., CVPR'24; the JAX UNet's `cache` /
        `return_cache`): `return_cache=True` returns (output, feature), the
        deep feature entering the top-level output blocks, (B, T, h, w, C)
        in the UNet's dtype. Passing that feature as `cache` runs a shallow
        forward: the first 1 + num_res_blocks input blocks (for their skip
        connections; `init_attn` after the first), then the last
        num_res_blocks + 1 output blocks from the cached feature, skipping
        every deeper level and the middle block. shallow(x, t,
        cache=full_cache(x, t)) equals the full forward; reusing a cache
        over adjacent sampler steps is the approximation.

        Under an active frame split x (and `cache`) hold this rank's frames
        and context_img the whole clip's (this rank's frames are taken)."""
        with trace.span("unet", rows=x.shape[0], shallow=cache is not None):
            cfg = self.config
            dtype = self.dtype
            b, t, hh, ww, cin = x.shape
            frames = active_frames()
            if frames is not None:
                if t != frames.local:
                    raise ValueError(f"x holds {t} frames; this rank's of the split clip are "
                                     f"{frames.local}")
                if context_img is not None:
                    context_img = frames.slice(context_img)
            n_top_in = 1 + cfg.num_res_blocks
            n_top_out = cfg.num_res_blocks + 1
            if (cache is not None or return_cache) and len(cfg.channel_mult) < 2:
                raise ValueError("DeepCache needs >=2 UNet levels")
            h = x.to(dtype).permute(0, 1, 4, 2, 3).reshape(b * t, cin, hh, ww)
            if context_text is not None:
                context_text = context_text.to(dtype)
            if context_img is not None:
                context_img = context_img.to(dtype)
            context = (context_text, context_img)

            emb = self.time_embed(
                sched.timestep_embedding(timesteps, cfg.model_channels).to(dtype))
            if cfg.fs_condition:
                if fs is None:
                    fs = torch.full((b,), cfg.default_fs, dtype=torch.long, device=x.device)
                emb = emb + self.fps_embedding(
                    sched.timestep_embedding(fs, cfg.model_channels).to(dtype))

            def frames_last(a: torch.Tensor) -> torch.Tensor:
                """(B*T, C, h, w) -> (B, T, h, w, C)."""
                return a.view(b, t, *a.shape[1:]).permute(0, 1, 3, 4, 2)

            hs = []
            in_blocks = self.input_blocks if cache is None else self.input_blocks[:n_top_in]
            for i, layers in enumerate(in_blocks):
                h = self._run_layers(layers, h, emb, context, t, frames)
                if i == 0 and cfg.addition_attention:
                    h = self._call(self.init_attn[0], h, t, frames)
                hs.append(h)
            if cache is None:
                h = self._run_layers(self.middle_block, h, emb, context, t, frames)
                out_blocks = self.output_blocks
            else:
                h = cache.to(dtype).permute(0, 1, 4, 2, 3).flatten(0, 1)
                out_blocks = self.output_blocks[-n_top_out:]
            seam = len(out_blocks) - n_top_out
            cache_out = None
            for i, layers in enumerate(out_blocks):
                if i == seam and return_cache:
                    cache_out = frames_last(h)
                h = torch.cat([h, hs.pop()], dim=1)
                h = self._run_layers(layers, h, emb, context, t, frames)
            h = frames_last(self.out[2](self.out[0](h, silu=True)))   # out[1]'s SiLU in the norm
            return (h, cache_out) if return_cache else h
