"""Alternate conditioning encoders.

The reference registers several encoder classes beyond the OpenCLIP pair of
DynamiCrafter's released configs (those two are in `models/clip.py`). This
module holds the rest (reference lvdm/modules/encoders/condition.py; JAX
twin dynamicrafter_tpu/models/encoders.py), each with the state_dict keys of
the module the reference wraps, so its checkpoint loads by name:

  * `HFCLIPTextEncoder`  FrozenCLIPEmbedder (condition.py:209-252): the HF
    CLIP ViT-L/14 text tower (quick_gelu), `layer` = last | pooled | hidden
    (with `layer_idx`); keys of `transformers.CLIPTextModel`.
  * `T5Encoder`          FrozenT5Embedder (condition.py:175-206): the
    t5-v1_1 encoder stack: RMSNorm, one relative-position bias shared by all
    layers, gated-GELU feed-forward, no attention mask (the reference passes
    `input_ids` only); keys of `transformers.T5EncoderModel`.
  * `ClassEmbedder`      condition.py:42-66, with the "extra class" dropout.
  * `CLIPVisionPooled`   the pooled image embedders (ClipImageEmbedder
    condition.py:255-291, FrozenOpenCLIPImageEmbedder condition.py:352-420):
    the whole ViT with ln_post and the projection of the class token, plus
    the per-sample zeroing; open_clip keys under `model.visual.`.
  * `CLIPT5Encoder`      FrozenCLIPT5Encoder (condition.py:375-389).
  * `identity_encode`    IdentityEncoder (condition.py:33-35).

The contexts are short (<= 257 tokens): attention is the plain version
everywhere. A module computes in the dtype its weights are stored in, norms
in fp32. The HF CLIP path tokenizes with the package's BPE tokenizer padded
with the end-of-text id (HF's CLIPTokenizer pads so, open_clip's with 0, and
pad positions show in the unmasked `last` and `hidden` outputs): the
pipeline asks for that. `T5Encoder` takes token ids; its sentencepiece
vocabulary is an external file.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamicrafter_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionEncoder
from dynamicrafter_tpu_torch.ops.attention import dot_product_attention
from dynamicrafter_tpu_torch.ops.norms import LayerNorm


# ---------------------------------------------------------------------------
# FrozenCLIPEmbedder: the HF CLIP text tower
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HFCLIPTextConfig:
    """openai/clip-vit-large-patch14 text defaults (condition.py:216)."""
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    context_length: int = 77
    eos_token_id: int = 49407
    layer: str = "last"               # last | pooled | hidden
    layer_idx: Optional[int] = None   # for layer="hidden"; may be negative


class _HFCLIPLayer(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.ModuleDict(
            {n: nn.Linear(width, width) for n in ("q_proj", "k_proj", "v_proj", "out_proj")})
        self.layer_norm1 = LayerNorm(width)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(width, width * 4),
                                  "fc2": nn.Linear(width * 4, width)})
        self.layer_norm2 = LayerNorm(width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm1(x)
        split = lambda t: t.unflatten(-1, (self.heads, -1))
        a = self.self_attn
        out = dot_product_attention(split(a["q_proj"](h)), split(a["k_proj"](h)),
                                    split(a["v_proj"](h)), mask=mask, backend="plain")
        x = x + a["out_proj"](out.flatten(-2))
        h = self.mlp["fc1"](self.layer_norm2(x))
        return x + self.mlp["fc2"](h * torch.sigmoid(1.702 * h))    # quick_gelu


class _HFCLIPEmbeddings(nn.Module):
    def __init__(self, cfg: HFCLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.context_length, cfg.width)


class _HFCLIPStack(nn.Module):
    def __init__(self, cfg: HFCLIPTextConfig, n_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList([_HFCLIPLayer(cfg.width, cfg.heads)
                                     for _ in range(n_blocks)])


class _HFCLIPTextModel(nn.Module):
    def __init__(self, cfg: HFCLIPTextConfig, n_blocks: int):
        super().__init__()
        self.embeddings = _HFCLIPEmbeddings(cfg)
        self.encoder = _HFCLIPStack(cfg, n_blocks)
        if cfg.layer != "hidden":
            self.final_layer_norm = LayerNorm(cfg.width)


class HFCLIPTextEncoder(nn.Module):
    """`transformers.CLIPTextModel.forward`. tokens (B, L) int ->

    layer="last":   (B, L, width) after final_layer_norm;
    layer="pooled": (B, 1, width), the last hidden state at the first EOS
                    position (HF's pooler; position 0 when there is none),
                    `outputs.pooler_output[:, None, :]` of condition.py:246;
    layer="hidden": (B, L, width) hidden_states[layer_idx], BEFORE the final
                    norm (HF semantics): only the blocks up to there are built.
    """

    def __init__(self, config: HFCLIPTextConfig = HFCLIPTextConfig()):
        super().__init__()
        cfg = config
        if cfg.layer not in ("last", "pooled", "hidden"):
            raise ValueError(f"unknown layer {cfg.layer!r}")
        if cfg.layer == "hidden":
            if cfg.layer_idx is None or abs(cfg.layer_idx) > cfg.layers:
                raise ValueError(f"layer='hidden' needs |layer_idx| <= {cfg.layers}")
            # hidden_states has layers + 1 entries (the embeddings first)
            n_blocks = cfg.layer_idx % (cfg.layers + 1)
        else:
            n_blocks = cfg.layers
        self.config = cfg
        self.text_model = _HFCLIPTextModel(cfg, n_blocks)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, m = self.config, self.text_model
        emb = m.embeddings
        dtype = emb.token_embedding.weight.dtype
        x = (emb.token_embedding(tokens) + emb.position_embedding.weight).to(dtype)
        n = cfg.context_length
        causal = torch.ones(n, n, dtype=torch.bool, device=tokens.device).tril()
        for layer in m.encoder.layers:
            x = layer(x, causal)
        if cfg.layer == "hidden":
            return x
        x = m.final_layer_norm(x)
        if cfg.layer == "pooled":
            pos = (tokens == cfg.eos_token_id).int().argmax(dim=-1)
            return x[torch.arange(x.shape[0], device=x.device), pos][:, None]
        return x


# ---------------------------------------------------------------------------
# FrozenT5Embedder: the t5-v1_1 encoder stack
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class T5Config:
    """google/t5-v1_1-large defaults (condition.py:178)."""
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6


def t5_rel_buckets(qlen: int, klen: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5's bidirectional relative-position buckets as a (qlen, klen) int64
    table (HF T5Attention._relative_position_bucket, bidirectional=True):
    half the buckets per sign, exact up to half of those, then log-spaced up
    to `max_distance`."""
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(n, 1) / max_exact)
                         / np.log(max_distance / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(n < max_exact, n, large)


class T5RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight in fp32 (no mean subtraction, no
    bias), cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class _T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads = cfg.num_heads
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:   # computed by layer 0, shared by all
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.num_heads)

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        split = lambda t: t.unflatten(-1, (self.heads, -1)).transpose(1, 2)   # (B, H, L, d)
        q, k, v = split(self.q(h)), split(self.k(h)), split(self.v(h))
        # T5 attention is unscaled (1 / sqrt(d) is folded into the init)
        scores = q @ k.transpose(-1, -2) + bias
        probs = torch.softmax(scores.float(), dim=-1).to(h.dtype)
        return self.o((probs @ v).transpose(1, 2).flatten(-2))


class _T5AttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = _T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return x + self.SelfAttention(self.layer_norm(x), bias)


class _T5FeedForwardLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        lin = lambda i, o: nn.Linear(i, o, bias=False)
        self.DenseReluDense = nn.ModuleDict({"wi_0": lin(cfg.d_model, cfg.d_ff),
                                             "wi_1": lin(cfg.d_model, cfg.d_ff),
                                             "wo": lin(cfg.d_ff, cfg.d_model)})
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, ff = self.layer_norm(x), self.DenseReluDense
        # gated GELU: gelu_new(wi_0 h) * wi_1 h (t5-v1_1's feed_forward_proj)
        return x + ff["wo"](F.gelu(ff["wi_0"](h), approximate="tanh") * ff["wi_1"](h))


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5AttentionLayer(cfg, has_relative_bias),
                                    _T5FeedForwardLayer(cfg)])


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5RMSNorm(cfg.d_model, cfg.eps)


class T5Encoder(nn.Module):
    """`T5EncoderModel.forward(input_ids)` -> last_hidden_state (B, L,
    d_model). No attention mask, as in the reference: pads take part."""

    def __init__(self, config: T5Config = T5Config()):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _T5Stack(config)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.shared(tokens)
        n = tokens.shape[-1]
        buckets = torch.from_numpy(
            t5_rel_buckets(n, n, cfg.rel_buckets, cfg.rel_max_distance)).to(tokens.device)
        rel = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        bias = rel(buckets).permute(2, 0, 1)[None].to(x.dtype)     # (1, H, L, L)
        for block in self.encoder.block:
            x = block.layer[1](block.layer[0](x, bias))
        return self.encoder.final_layer_norm(x)


# ---------------------------------------------------------------------------
# ClassEmbedder (condition.py:42-66)
# ---------------------------------------------------------------------------

def _keep_mask(shape, keep_prob: float, generator: Optional[torch.Generator],
               device) -> torch.Tensor:
    if generator is None:
        raise ValueError("a dropout rate > 0 needs a generator (or disable the dropout)")
    return torch.rand(shape, generator=generator, device=generator.device).to(device) < keep_prob


class ClassEmbedder(nn.Module):
    def __init__(self, embed_dim: int, n_classes: int = 1000, ucg_rate: float = 0.1):
        super().__init__()
        self.n_classes = n_classes
        self.ucg_rate = ucg_rate
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, class_ids: torch.Tensor, generator: Optional[torch.Generator] = None,
                disable_dropout: bool = False) -> torch.Tensor:
        """(B,) int class ids -> (B, 1, embed_dim) for cross-attention. With
        ucg_rate > 0 each id becomes the extra unconditional class
        (n_classes - 1) with probability ucg_rate (condition.py:55-58),
        drawn from `generator`."""
        c = class_ids[:, None].long()
        if self.ucg_rate > 0.0 and not disable_dropout:
            keep = _keep_mask(c.shape, 1.0 - self.ucg_rate, generator, c.device)
            c = torch.where(keep, c, torch.full_like(c, self.n_classes - 1))
        return self.embedding(c)

    def unconditional_ids(self, bs: int) -> torch.Tensor:
        """condition.py:61-65 (the dict around it is the caller's)."""
        return torch.full((bs,), self.n_classes - 1, dtype=torch.long,
                          device=self.embedding.weight.device)


# ---------------------------------------------------------------------------
# Pooled CLIP image embedders
# ---------------------------------------------------------------------------

class CLIPVisionPooled(CLIPVisionEncoder):
    """The whole ViT image encode: ln_post(class token) @ proj -> (B,
    output_dim). Serves both pooled reference embedders, the OpenAI clip ViT
    (`ClipImageEmbedder`, config act "quick_gelu") and open_clip's ViT-H
    (`FrozenOpenCLIPImageEmbedder`, "gelu"); the tower is `CLIPVisionEncoder`'s.
    Callers run `clip_preprocess` first."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig(), output_dim: int = 1024):
        super().__init__(config)
        vis = self.model.visual
        vis.ln_post = LayerNorm(config.width, keep_fp32=True)
        vis.proj = nn.Parameter(torch.empty(config.width, output_dim))

    def forward(self, pixels: torch.Tensor, generator: Optional[torch.Generator] = None,
                ucg_rate: float = 0.0) -> torch.Tensor:
        vis = self.model.visual
        tokens = super().forward(pixels)
        out = (vis.ln_post(tokens[:, 0]) @ vis.proj.float()).to(tokens.dtype)
        if ucg_rate > 0.0:
            # one draw per sample: all or nothing (condition.py:270-272, 287-289)
            keep = _keep_mask((out.shape[0], 1), 1.0 - ucg_rate, generator, out.device)
            out = out * keep.to(out.dtype)
        return out


# ---------------------------------------------------------------------------
# FrozenCLIPT5Encoder (condition.py:375-389) and IdentityEncoder
# ---------------------------------------------------------------------------

class CLIPT5Encoder(nn.Module):
    """Both text encoders at once: (clip_z, t5_z), the reference's list."""

    def __init__(self, clip_config: HFCLIPTextConfig = HFCLIPTextConfig(),
                 t5_config: T5Config = T5Config()):
        super().__init__()
        self.clip_encoder = HFCLIPTextEncoder(clip_config)
        self.t5_encoder = T5Encoder(t5_config)

    def forward(self, clip_tokens: torch.Tensor,
                t5_tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.clip_encoder(clip_tokens), self.t5_encoder(t5_tokens)


def identity_encode(x: torch.Tensor) -> torch.Tensor:
    """IdentityEncoder.encode (condition.py:33-35)."""
    return x
