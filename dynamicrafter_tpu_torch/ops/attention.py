"""Attention entry points and the routing to the kernels.

Shapes follow the (batch..., length, heads, head_dim) convention of the JAX
package (`dynamicrafter_tpu/ops/attention.py`):

  * `plain_attention` — the reference semantics: logits in the input dtype,
    fp32 softmax, K/V with fewer leading batch dims broadcast over q's
    (text context shared by all frames).
  * `dot_product_attention` — routes unmasked self-attention over at
    most 32 tokens (q, k, v of one shape, at least 4 dims) to
    `small_t_attention` (`ops/small_attention.py`: K5, differentiable);
    unmasked attention with Lq >= 2048, Lk >= 512 and head dim 64 to
    `flash_attention` (`ops/flash_attention.py`: K1, or under a gradient
    K3 forward and K4a/K4b backward); everything else to
    `plain_attention`.
  * `attention_axis1` — self-attention over axis 1 of (B, T, G, H, D);
    unmasked with T <= 32 goes to `small_t_attention_tmajor`
    (`ops/small_attention.py`: K2, differentiable).

The flash thresholds are the JAX package's, measured on a TPU; they are
kept until they are measured again on the card. The JAX rule for K5 also
wants at least 256 rows of leading batch; on an H100 K5 is faster than
`plain_attention` from 64 rows to 4096 (`chip_smoke.py` phase 10), so the
port has no row threshold and one shape takes one path at every batch
size. The kernel wrappers pick their
plain version for CPU tensors and launch the kernel (or raise) for CUDA
tensors. `use_backend("plain")` makes every call inside the `with` take the
plain path instead; only tests and `chip_smoke.py` use it, to hold the
kernels against their plain versions. The setting is process-wide, not
per-thread: a checkpointed layer is recomputed during the backward pass on
autograd's device thread, and must take the same path there as in its
forward.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from dynamicrafter_tpu_torch.ops.flash_attention import HEAD_DIM, flash_attention
from dynamicrafter_tpu_torch.ops.small_attention import (
    MAX_T,
    small_t_attention,
    small_t_attention_tmajor,
)

_backend = "auto"


@contextlib.contextmanager
def use_backend(name: str):
    """"auto" (kernels where the routing rule says so) or "plain"."""
    global _backend
    if name not in ("auto", "plain"):
        raise ValueError(f"unknown attention backend {name!r}")
    saved, _backend = _backend, name
    try:
        yield
    finally:
        _backend = saved


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Lq, H, D); k, v: (..., Lk, H, D), possibly with fewer leading
    dims than q (broadcast). mask: broadcastable to (..., H, Lq, Lk); False
    masks a position out."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    while k.dim() < q.dim():
        k, v = k.unsqueeze(-4), v.unsqueeze(-4)
    qh, kh, vh = (x.transpose(-3, -2) for x in (q, k, v))   # (..., H, L, D)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask, -torch.finfo(sim.dtype).max)
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    out = torch.matmul(attn, vh)
    return out.transpose(-3, -2).to(q.dtype)


def _use_flash(q, k, mask, backend: str) -> bool:
    return (backend == "auto" and mask is None and q.shape[-1] == HEAD_DIM
            and k.shape[-3] >= 512 and q.shape[-3] >= 2048)


def _use_small_t(q, k, v, mask, backend: str) -> bool:
    """The JAX package's `_use_small_t` without its TPU tests: self-attention
    (q, k, v of one shape, tested before any K/V broadcast) over T <= 32
    tokens, at least 4 dims, head rows of whole 16-byte vectors (what the
    kernel loads). The JAX rule also wants 128 % T == 0 and at least 256
    rows of leading batch; the first is the TPU tile's need, the second a
    TPU measurement that does not hold on the card (module docstring), and
    both are dropped here: K5 takes any T in 1..32 and any row count."""
    return (backend == "auto" and mask is None and q.dim() >= 4
            and q.shape == k.shape == v.shape and q.shape[-3] <= MAX_T
            and (q.shape[-1] * q.element_size()) % 16 == 0)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          backend: Optional[str] = None) -> torch.Tensor:
    backend = backend or _backend
    if _use_small_t(q, k, v, mask, backend):
        return small_t_attention(q, k, v, scale=scale)
    if _use_flash(q, k, mask, backend):
        while k.dim() < q.dim():
            k, v = k.unsqueeze(-4), v.unsqueeze(-4)
        k = k.expand(*q.shape[:-3], *k.shape[-3:])
        v = v.expand(*q.shape[:-3], *v.shape[-3:])
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, mask=mask, scale=scale)


def attention_axis1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Self-attention over the axis-1 tokens of (B, T, G, H, D), the UNet's
    time-major temporal layout, with no transpose on the kernel path."""
    backend = backend or _backend
    if (backend == "auto" and mask is None and q.dim() == 5
            and q.shape == k.shape == v.shape and q.shape[1] <= MAX_T):
        return small_t_attention_tmajor(q, k, v, scale=scale)
    mv = lambda x: x.movedim(1, -3)
    out = plain_attention(mv(q), mv(k), mv(v), mask=mask, scale=scale)
    return out.movedim(-3, 1)
