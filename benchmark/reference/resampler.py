"""Perceiver Resampler of the reference, float32 (a frozen copy of the
port's `models/resampler.py`): CLIP patch tokens -> per-frame image context.

Reference lvdm/modules/encoders/resampler.py:26-145; JAX twin
dynamicrafter_tpu/models/resampler.py. With video_length=16 and
num_queries=16 the learned latents are 256 queries (16 per frame); each
PerceiverAttention layer attends over [patch tokens ; latents] with the
symmetric 1/sqrt(sqrt(d)) scaling and an fp32 softmax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from benchmark.reference.layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4
    video_length: Optional[int] = 16

    @classmethod
    def from_dict(cls, d: dict) -> "ResamplerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """x: (B, N1, D) image features; latents: (B, N2, D)."""
        x = self.norm1(x).to(latents.dtype)
        lat = self.norm2(latents)
        b, l, _ = lat.shape
        q = self.to_q(lat)
        k, v = self.to_kv(torch.cat([x, lat], dim=-2)).chunk(2, dim=-1)
        split = lambda t: t.unflatten(-1, (self.heads, self.dim_head)).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        scale = float(np.float32(1.0) / np.sqrt(np.sqrt(np.float32(self.dim_head))))
        w = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
        w = torch.softmax(w, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, l, -1)
        return self.to_out(out)


class Resampler(nn.Module):
    def __init__(self, config: ResamplerConfig = ResamplerConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        nq = cfg.num_queries * (cfg.video_length or 1)
        self.latents = nn.Parameter(torch.empty(1, nq, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim)
        self.norm_out = LayerNorm(cfg.output_dim)
        inner_ff = cfg.dim * cfg.ff_mult
        self.layers = nn.ModuleList([
            nn.ModuleList([
                PerceiverAttention(cfg.dim, cfg.dim_head, cfg.heads),
                nn.Sequential(LayerNorm(cfg.dim), nn.Linear(cfg.dim, inner_ff, bias=False),
                              nn.GELU(), nn.Linear(inner_ff, cfg.dim, bias=False)),
            ]) for _ in range(cfg.depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, embedding_dim) CLIP tokens -> (B, T*Q, output_dim)."""
        dtype = self.proj_in.weight.dtype
        x = self.proj_in(x.to(dtype))
        lat = self.latents.to(dtype).expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            lat = attn(x, lat) + lat
            lat = ff(lat) + lat
        return self.norm_out(self.proj_out(lat))


class ImageProjModel(nn.Module):
    """The linear alternative to the Resampler (reference resampler.py:9-23):
    a pooled image embedding (B, clip_embeddings_dim) -> (B,
    clip_extra_context_tokens, cross_attention_dim). No shipped config uses
    it; the pipeline is built around the Resampler."""

    def __init__(self, cross_attention_dim: int = 1024, clip_embeddings_dim: int = 1024,
                 clip_extra_context_tokens: int = 4):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.proj = nn.Linear(clip_embeddings_dim,
                              clip_extra_context_tokens * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim, keep_fp32=True)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds.to(self.proj.weight.dtype))
        return self.norm(x.reshape(x.shape[0], -1, self.cross_attention_dim))
