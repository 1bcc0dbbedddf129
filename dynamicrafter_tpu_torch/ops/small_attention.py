"""K2 and K5: self-attention over a short token axis (T <= 32).

K2, time-major. `small_t_fwd_tmajor` is the kernel wrapper on
(B, T, G, H*D), the layout the UNet's temporal transformers already hold
(tokens over T at axis 1, G = h*w positions): on a CUDA tensor it launches
the hand-written kernel in `csrc/small_attention.cu` (which replaces the
Pallas kernel `dynamicrafter_tpu/ops/small_attention.py::_kernel_tmajor`)
or raises; on a CPU tensor it runs `small_t_fwd_tmajor_plain`. The C entry
point picks the kernel: bf16 with head dim 64 (every temporal attention of
the shipped configs) runs `small_t_tc_kernel`, both products on the tensor
cores; fp32, and bf16 with another head dim, run `small_t_kernel`.
`small_t_attention_tmajor` is its entry point on (B, T, G, H, D).

K5, position-major. `small_t_fwd` is the kernel wrapper on (G, T, H*D):
each of G rows attends over its own T tokens (spatial self-attention over
a tiny frame, many frames). On a CUDA tensor it launches a kernel of the
same source (which replaces the Pallas kernel
`dynamicrafter_tpu/ops/small_attention.py::_kernel`) or raises; on a CPU
tensor it runs `small_t_fwd_plain`. bf16 with head dim 64 (the 256x256
model's middle block) runs `small_t_posmajor_tc_kernel`, K2's tensor-core
warp loop on this layout; fp32, and bf16 with another head dim, run the
SIMT `small_t_posmajor_kernel`, whose grid takes at most 65535 heads.
At the 256x256 model's shape (256, 16, 20*64) bf16 the tensor-core kernel
takes 0.014 ms of device time, the SIMT kernel 0.071 (chip_smoke.py phase
10, NVIDIA H100 80GB HBM3, 700 W). `small_t_attention` is its entry point
on (..., T, H, D).

Which route rounds p: the plain versions and the kernels round the
probabilities to the input dtype before the product with v, as the Pallas
kernels and their XLA references do, but for one: K2's SIMT kernel keeps p
in fp32 (for fp32 inputs that is their dtype; for bf16 with a head dim
other than 64 it is one rounding fewer).

Each wrapper counts its kernel launches in `.launches` (K2 also by its
m16 tiles of T in `.launches_by_tiles`) and opens the span
K2 or K5 around the launch (`utils/trace.py`). When no input needs
a gradient an entry point calls its kernel wrapper directly. Under a
gradient it goes through `SmallTAttention`, whose forward is the same
kernel and whose backward is autograd of the plain version on the saved q,
k and v: the JAX package's `_vjp_bwd` / `_vjp_bwd_tmajor`, which have no
Pallas backward either.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dynamicrafter_tpu_torch.ops import kernels
from dynamicrafter_tpu_torch.utils import trace

MAX_T = 32


def _head_dim(name: str, t: int, hd: int, heads: int, itemsize: int) -> int:
    if t > MAX_T:
        raise ValueError(f"{name}: T={t} > {MAX_T}")
    d = hd // heads
    if d * heads != hd or d == 0 or (d * itemsize) % 16:
        raise ValueError(f"{name}: head dim {d} must fill whole 16-byte vectors")
    return d


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
    d = _head_dim("small_t_fwd_tmajor", t, hd, heads, q.element_size())
    if b > 65535 or heads > 65535:
        raise ValueError(f"small_t_fwd_tmajor: B={b}, heads={heads} outside the launch grid")
    out = torch.empty_like(q)
    lib = kernels.library()
    with trace.span("K2", b=b, t=t, g=g, heads=heads), \
            torch.cuda.device(q.device):
        code = lib.dct_small_t_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], b, t, g, heads, d, float(scale),
            kernels.stream_handle(q.device))
    kernels.check(code, "small_t_fwd_tmajor launch")
    small_t_fwd_tmajor.launches += 1
    tiles = small_t_fwd_tmajor.launches_by_tiles
    tiles[(t + 15) // 16] = tiles.get((t + 15) // 16, 0) + 1
    return out


small_t_fwd_tmajor.launches = 0
small_t_fwd_tmajor.launches_by_tiles = {}   # by m16 tiles of T: 1 for T <= 16, 2 to 32


def small_t_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, scale: float) -> torch.Tensor:
    """Per (g, head): softmax over T of fp32 logits q k^T * scale, rounded to
    v's dtype, times v (the JAX package's `_xla_ref` math) on (G, T, H*D)."""
    g, t, hd = q.shape
    mv = lambda x: x.reshape(g, t, heads, hd // heads).transpose(1, 2)   # (G, H, T, D)
    qh, kh, vh = mv(q), mv(k), mv(v)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    att = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(att, vh).transpose(1, 2).reshape(g, t, hd).to(q.dtype)


def small_t_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                heads: int, scale: float) -> torch.Tensor:
    """K5. q, k, v: (G, T, H*D), T <= 32 -> (G, T, H*D)."""
    if q.device.type == "cpu":
        return small_t_fwd_plain(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"small_t_fwd: unsupported device {q.device}")
    kernels.check_operands("small_t_fwd", q, k, v)
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        raise ValueError("small_t_fwd: q, k, v must share one (G, T, H*D) shape")
    g, t, hd = q.shape
    d = _head_dim("small_t_fwd", t, hd, heads, q.element_size())
    # the tensor-core route's persistent grid counts G*heads groups in an
    # int; the SIMT kernel's grid has the head as its y
    tc = q.dtype == torch.bfloat16 and d == 64
    if g < 1 or g * heads > 2**31 - 1 or (not tc and heads > 65535):
        raise ValueError(f"small_t_fwd: G={g}, heads={heads} outside the launch grid")
    out = torch.empty_like(q)
    lib = kernels.library()
    with trace.span("K5", g=g, t=t, heads=heads), \
            torch.cuda.device(q.device):
        code = lib.dct_small_t_fwd_posmajor(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], g, t, heads, d, float(scale),
            kernels.stream_handle(q.device))
    kernels.check(code, "small_t_fwd launch")
    small_t_fwd.launches += 1
    return out


small_t_fwd.launches = 0


class SmallTAttention(torch.autograd.Function):
    """K2 (`tmajor`) or K5 forward; backward through the plain version's
    autograd."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float, tmajor: bool):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale, ctx.tmajor = heads, scale, tmajor
        return (small_t_fwd_tmajor if tmajor else small_t_fwd)(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        plain = small_t_fwd_tmajor_plain if ctx.tmajor else small_t_fwd_plain
        with torch.enable_grad():
            out = plain(q, k, v, ctx.heads, ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None, None


def _attend(q, k, v, heads: int, scale: float, tmajor: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return SmallTAttention.apply(q, k, v, heads, scale, tmajor)
    return (small_t_fwd_tmajor if tmajor else small_t_fwd)(q, k, v, heads, scale)


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
    return _attend(flat(q), flat(k), flat(v), heads, scale, True).view(b, t, g, heads, d)


def small_t_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over the T axis of (..., T, H, D), any leading dims;
    returns the same shape."""
    if q.dim() < 3 or not (q.shape == k.shape == v.shape):
        raise ValueError("small_t_attention: (..., T, H, D) self-attention only")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    t, heads, d = q.shape[-3:]
    # the kernel needs contiguous (G, T, H*D) rows; a view of a projection's
    # output usually is, but that is not relied on
    flat = lambda x: x.reshape(-1, t, heads * d).contiguous()
    return _attend(flat(q), flat(k), flat(v), heads, scale, False).view(q.shape)
