"""K2: temporal self-attention over a short T axis, time-major layout.

`small_t_fwd_tmajor` is the kernel wrapper on (B, T, G, H*D), the layout
the UNet's temporal transformers already hold (tokens over T at axis 1,
G = h*w positions): on a CUDA tensor it launches the hand-written kernel in
`csrc/small_attention.cu` (which replaces the Pallas kernel
`dynamicrafter_tpu/ops/small_attention.py::_kernel_tmajor`) or raises; on a
CPU tensor it runs `small_t_fwd_tmajor_plain`. `small_t_fwd_tmajor.launches`
counts kernel launches.

`small_t_attention_tmajor` is the entry point on (B, T, G, H, D), as in the
JAX package. When no input needs a gradient it calls the kernel wrapper
directly. Under a gradient it goes through `SmallTAttention`, whose forward
is the same kernel and whose backward is autograd of
`small_t_fwd_tmajor_plain` on the saved q, k and v: the JAX package's
`_vjp_bwd_tmajor`, which has no Pallas backward either.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dynamicrafter_tpu_torch.ops import kernels

MAX_T = 32


def small_t_fwd_tmajor_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             heads: int, scale: float) -> torch.Tensor:
    """Per (b, g, head): softmax over T of fp32 logits q k^T * scale, times v
    (the JAX package's `_xla_ref_tmajor` math)."""
    b, t, g, hd = q.shape
    d = hd // heads
    # (B, G, H, T, D)
    mv = lambda x: x.reshape(b, t, g, heads, d).permute(0, 2, 3, 1, 4)
    qh, kh, vh = mv(q), mv(k), mv(v)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    att = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(att, vh)                       # (B, G, H, T, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, g, hd).to(q.dtype)


def small_t_fwd_tmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, scale: float) -> torch.Tensor:
    """q, k, v: (B, T, G, H*D), T <= 32 -> (B, T, G, H*D)."""
    if q.device.type == "cpu":
        return small_t_fwd_tmajor_plain(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_t_fwd_tmajor: unsupported device {q.device}")
    kernels.check_operands("small_t_fwd_tmajor", q, k, v)
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError("small_t_fwd_tmajor: q, k, v must share one "
                         "(B, T, G, H*D) shape")
    b, t, g, hd = q.shape
    if t > MAX_T:
        raise ValueError(f"small_t_fwd_tmajor: T={t} > {MAX_T}")
    d = hd // heads
    if d * heads != hd or (d * q.element_size()) % 16:
        raise ValueError(f"small_t_fwd_tmajor: head dim {d} must fill whole "
                         "16-byte vectors")
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        code = lib.dct_small_t_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], b, t, g, heads, d, float(scale),
            kernels.stream_handle(q.device))
    kernels.check(code, "small_t_fwd_tmajor launch")
    small_t_fwd_tmajor.launches += 1
    return out


small_t_fwd_tmajor.launches = 0


class SmallTAttention(torch.autograd.Function):
    """K2 forward; backward through the plain version's autograd."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return small_t_fwd_tmajor(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = small_t_fwd_tmajor_plain(q, k, v, ctx.heads, ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None


def small_t_attention_tmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over axis 1 of (B, T, G, H, D); returns the same shape."""
    if q.dim() != 5 or not (q.shape == k.shape == v.shape):
        raise ValueError("small_t_attention_tmajor: (B, T, G, H, D) "
                         "self-attention only")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, t, g, heads, d = q.shape
    flat = lambda x: x.reshape(b, t, g, heads * d).contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = SmallTAttention.apply(flat(q), flat(k), flat(v), heads, scale)
    else:
        out = small_t_fwd_tmajor(flat(q), flat(k), flat(v), heads, scale)
    return out.view(b, t, g, heads, d)
