"""OpenCLIP ViT-H/14 text and vision towers of the reference, float32 (a
frozen copy of the port's `models/clip.py`).

Reference lvdm/modules/encoders/condition.py:174-372; JAX twin
dynamicrafter_tpu/models/clip.py. Module names follow open_clip, so the
state_dict keys are the checkpoint's (`model.transformer.resblocks.N.attn.
in_proj_weight`, `model.visual.conv1.weight`, ...). The towers' attention is
short (77 and 257 tokens) and always takes the plain path.

The text tower stops one block early (layer="penultimate") and returns the
fp32 output of ln_final; the vision tower returns all 257 tokens before
ln_post/proj.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import dot_product_attention
from benchmark.reference.layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    penultimate: bool = True


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    width: int = 1280
    heads: int = 16
    layers: int = 32
    patch_size: int = 14
    image_size: int = 224
    act: str = "gelu"   # "quick_gelu" for the OpenAI CLIP ViT-L weights


class _MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj), computed
    with the port's plain attention."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        quant = getattr(self, "quantize", lambda a: a)
        q, k, v = F.linear(quant(x), quant(self.in_proj_weight),
                           self.in_proj_bias).chunk(3, dim=-1)
        split = lambda t: t.unflatten(-1, (self.heads, -1))
        out = dot_product_attention(split(q), split(k), split(v), mask=mask,
                                    backend="plain")
        return self.out_proj(out.flatten(-2))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str = "gelu"):
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.ln_1 = LayerNorm(width)
        self.attn = _MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, width * 4),
                                  "c_proj": nn.Linear(width * 4, width)})

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        h = self.mlp["c_fc"](self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp["c_proj"](h)


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, act: str = "gelu"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, act) for _ in range(layers)])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        n_blocks = cfg.layers - (1 if cfg.penultimate else 0)
        self.transformer = _Transformer(cfg.width, cfg.heads, n_blocks)
        self.ln_final = LayerNorm(cfg.width, keep_fp32=True)


class CLIPTextEncoder(nn.Module):
    """tokens (B, 77) int -> (B, 77, width) fp32 penultimate features."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.model = _TextModel(config)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        m = self.model
        dtype = m.transformer.resblocks[0].attn.out_proj.weight.dtype
        x = (m.token_embedding(tokens) + m.positional_embedding).to(dtype)
        n = self.config.context_length
        causal = torch.ones(n, n, dtype=torch.bool, device=tokens.device).tril()
        return m.ln_final(m.transformer(x, causal))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, cfg.width))
        self.ln_pre = LayerNorm(cfg.width)
        self.transformer = _Transformer(cfg.width, cfg.heads, cfg.layers, cfg.act)


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.visual = _VisionTransformer(cfg)


class CLIPVisionEncoder(nn.Module):
    """CLIP-normalized pixels (B, S, S, 3) -> all tokens (B, 1 + grid^2, width)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.model = _VisionModel(config)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vis = self.model.visual
        dtype = vis.conv1.weight.dtype
        x = vis.conv1(pixels.to(dtype).permute(0, 3, 1, 2))      # (B, W, g, g)
        x = x.flatten(2).transpose(1, 2)
        cls = vis.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + vis.positional_embedding.to(dtype)
        return vis.transformer(vis.ln_pre(x))


# CLIP image normalization constants (condition.py:319-320)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _cubic_kernel(s: np.ndarray, a: float = -0.75) -> np.ndarray:
    s = np.abs(s)
    return np.where(
        s <= 1, ((a + 2) * s - (a + 3)) * s * s + 1,
        np.where(s < 2, a * (((s - 5) * s + 8) * s - 4), 0.0),
    )


def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Bicubic align_corners=True interpolation as an (out, in) matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    scale = (in_size - 1) / (out_size - 1)
    coords = np.arange(out_size, dtype=np.float64) * scale
    base = np.floor(coords).astype(np.int64)
    frac = coords - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for off in (-1, 0, 1, 2):
        idx = np.clip(base + off, 0, in_size - 1)
        wgt = _cubic_kernel(off - frac)
        np.add.at(mat, (np.arange(out_size), idx), wgt)
    return mat.astype(np.float32)


def _gaussian_blur_matrix(size: int, sigma: float, ksize: int) -> np.ndarray:
    """Separable gaussian blur with reflect padding as a (size, size) matrix."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    mat = np.zeros((size, size), dtype=np.float64)
    half = ksize // 2
    for k, off in enumerate(range(-half, half + 1)):
        j = np.arange(size) + off
        j = np.where(j < 0, -j, j)
        j = np.where(j >= size, 2 * size - 2 - j, j)
        np.add.at(mat, (np.arange(size), j), g[k])
    return mat.astype(np.float32)


def _antialias_sigma_ks(factor: float):
    """kornia antialias parameters for one axis."""
    sigma = max((factor - 1.0) / 2.0, 0.001)
    ks = int(max(2.0 * 2 * sigma, 3))
    if ks % 2 == 0:
        ks += 1
    return sigma, ks


def clip_preprocess(images: torch.Tensor, out_size: int = 224,
                    antialias: bool = True) -> torch.Tensor:
    """[-1, 1] (B, H, W, 3) -> CLIP-normalized (B, out, out, 3) fp32.

    kornia resize (bicubic, align_corners=True, antialias) + CLIP
    renormalization (condition.py:322-330), with the blur folded into the
    per-axis resize matrices: two matmuls."""
    b, h, w, c = images.shape
    mh, mw = _resize_matrix(h, out_size), _resize_matrix(w, out_size)
    if antialias and max(h, w) > out_size:
        mh = mh @ _gaussian_blur_matrix(h, *_antialias_sigma_ks(h / out_size))
        mw = mw @ _gaussian_blur_matrix(w, *_antialias_sigma_ks(w / out_size))
    dev = images.device
    x = images.float()
    x = torch.einsum("oh,bhwc->bowc", torch.from_numpy(mh).to(dev), x)
    x = torch.einsum("ow,bhwc->bhoc", torch.from_numpy(mw).to(dev), x)
    x = (x + 1.0) / 2.0
    return (x - torch.from_numpy(CLIP_MEAN).to(dev)) / torch.from_numpy(CLIP_STD).to(dev)
