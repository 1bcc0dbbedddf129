"""K1, K3, K4a, K4b and K6: flash attention for spatial self-attention.

The kernel wrappers work on the transpose-free (N, L, H*D) layout. On a
CUDA tensor each launches its hand-written kernel or raises; on a CPU
tensor it runs the same function in plain PyTorch. Each counts its kernel
launches in `.launches` and opens a span named for its kernel around the
launch (`utils/trace.py`; attrs: the launch shape).

  * `flash_fwd` (K1, `csrc/flash_attention.cu`): the forward, replacing
    `dynamicrafter_tpu/ops/flash_attention.py::_fwd_kernel_nlhd`. bf16
    inputs run both products on the tensor cores (`mma.sync`, p rounded to
    bf16 before the PV product as in the Pallas kernel; the scale must be
    positive); fp32 inputs run them as fp32 FMAs.
  * `flash_fwd_lse` (K3, same source and the same two routes): the forward
    that also returns the logsumexp lse (N, H, Lq) fp32, replacing
    `_fwd_kernel` with save_lse=True.
  * `flash_bwd_dq` (K4a) and `flash_bwd_dkv` (K4b),
    `csrc/flash_attention_bwd.cu`: the FlashAttention-2 backward from o
    and lse, replacing `_bwd_dq_kernel` and `_bwd_dkv_kernel`; `flash_bwd`
    runs both. bf16 inputs run every product on the tensor cores and read
    di = rowsum(dO * o) from one pre-pass (`flash_bwd_di`, launched by
    `flash_bwd` once for both, or by either wrapper called alone); fp32
    inputs run the FMA kernels, which compute di themselves.
  * `flash_fwd_packed` (K6, `csrc/flash_packed.cu`): K1's function with one
    block per group of heads, served from whole staged rows; replaces
    `_fwd_kernel_packed`, behind `flash_attention(packed=True)`. bf16
    inputs run both products on the tensor cores (the main loop of
    `csrc/flash_tc.cuh`), fp32 inputs as fp32 FMAs; any finite scale, as
    the Pallas kernel takes.

`flash_attention` is the entry point on the (..., L, H, D) convention of
`ops.attention`, as in the JAX package. When no input needs a gradient it
runs K1. Under a gradient it calls the custom op `dct::flash_attn`, whose
forward is K3 and whose backward is K4a and K4b on the saved (q, k, v, o,
lse), as the JAX package's `_nlhd_vjp_fwd` / `_nlhd_vjp_bwd` do. Being an
operator, it can be named in a selective-checkpoint policy (see
`models/unet3d.py`), which keeps its outputs across a checkpoint boundary
so the forward is not run again in the backward pass.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from dynamicrafter_tpu_torch.ops import kernels
from dynamicrafter_tpu_torch.utils import trace

HEAD_DIM = 64  # the only head width the kernels take (all shipped configs)


def _heads(x: Tensor, heads: int) -> Tensor:
    """(N, L, H*D) -> (N, H, L, D) view."""
    n, l, hd = x.shape
    return x.reshape(n, l, heads, hd // heads).transpose(1, 2)


def _unheads(x: Tensor) -> Tensor:
    """(N, H, L, D) -> (N, L, H*D)."""
    n, h, l, d = x.shape
    return x.transpose(1, 2).reshape(n, l, h * d)


def _logits(q: Tensor, k: Tensor, heads: int, scale: float) -> Tensor:
    """q k^T * scale per head, (N, H, Lq, Lk), in the input dtype."""
    return torch.matmul(_heads(q, heads), _heads(k, heads).transpose(-1, -2)) * scale


def _attend(sim: Tensor, v: Tensor, heads: int, dtype: torch.dtype) -> Tensor:
    """softmax(sim) v per head, from fp32 logits (N, H, Lq, Lk)."""
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return _unheads(torch.matmul(attn, _heads(v, heads))).to(dtype)


def flash_fwd_plain(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> Tensor:
    """softmax(q k^T * scale) v per head on (N, L, H*D): input-dtype logits,
    fp32 softmax, the JAX package's `xla_attention` math."""
    return _attend(_logits(q, k, heads, scale).float(), v, heads, q.dtype)


def flash_fwd_lse_plain(q: Tensor, k: Tensor, v: Tensor, heads: int,
                        scale: float) -> Tuple[Tensor, Tensor]:
    """`flash_fwd_plain` and the logsumexp of each row's fp32 logits,
    (N, H, Lq) fp32."""
    sim = _logits(q, k, heads, scale).float()
    return _attend(sim, v, heads, q.dtype), torch.logsumexp(sim, dim=-1)


def flash_bwd_di_plain(o: Tensor, do: Tensor, heads: int) -> Tensor:
    """rowsum(dO * o) per head in fp32, (N, H, Lq): `flash_bwd_plain`'s di."""
    return (_heads(do, heads).float() * _heads(o, heads).float()).sum(-1)


def flash_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                    do: Tensor, heads: int, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """The FlashAttention-2 backward written out (the Pallas kernels'
    formulas, not autograd of the forward): p = exp(s - lse) from fp32
    logits, dp = dO v^T and di = rowsum(dO * o) in fp32, ds = p (dp - di)
    scale rounded to the input dtype, dq = ds k, dk = ds^T q, dv = p^T dO."""
    qh, kh, vh, doh = (_heads(x, heads).float() for x in (q, k, v, do))
    p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale - lse[..., None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    di = flash_bwd_di_plain(o, do, heads)[..., None]
    ds = (p * (dp - di) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    return _unheads(dq).to(q.dtype), _unheads(dk).to(k.dtype), _unheads(dv).to(v.dtype)


def check_qkv(name: str, q: Tensor, k: Tensor, v: Tensor, heads: int) -> None:
    """What every flash-forward kernel requires of its CUDA operands: q
    (N, Lq, H*64), k and v (N, Lk, H*64), one dtype and device, contiguous,
    16-byte aligned, N and H within the launch grid."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    kernels.check_operands(name, q, k, v)
    n, lq, hd = q.shape
    if hd != heads * HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd // heads} != {HEAD_DIM}")
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != hd:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError(f"{name}: empty key sequence")
    if n > 65535 or heads > 65535:   # grid.z and grid.y
        raise ValueError(f"{name}: N={n}, heads={heads} outside the launch grid")


def _check_bwd(name: str, q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
               do: Tensor, heads: int) -> None:
    check_qkv(name, q, k, v, heads)
    kernels.check_operands(name, q, o, do)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{name}: o and dO must have q's shape {tuple(q.shape)}")
    if (lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.shape != (q.shape[0], heads, q.shape[1])):
        raise ValueError(f"{name}: lse must be contiguous fp32 (N, H, Lq) on {q.device}")


def flash_fwd(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> Tensor:
    """K1. q: (N, Lq, H*D), k/v: (N, Lk, H*D) -> (N, Lq, H*D)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, heads, scale)
    check_qkv("flash_fwd", q, k, v, heads)
    n, lq, _ = q.shape
    out = torch.empty_like(q)
    with trace.span("K1", n=n, lq=lq, lk=k.shape[1], heads=heads), \
            torch.cuda.device(q.device):
        code = kernels.library().dct_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], n, lq, k.shape[1], heads,
            float(scale), kernels.stream_handle(q.device))
    kernels.check(code, "flash_fwd launch")
    flash_fwd.launches += 1
    return out


def flash_fwd_packed(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> Tensor:
    """K6. `flash_fwd`'s function and shapes through the packed-rows kernel."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, heads, scale)
    check_qkv("flash_fwd_packed", q, k, v, heads)
    n, lq, _ = q.shape
    out = torch.empty_like(q)
    with trace.span("K6", n=n, lq=lq, lk=k.shape[1], heads=heads), \
            torch.cuda.device(q.device):
        code = kernels.library().dct_flash_fwd_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], n, lq, k.shape[1], heads,
            float(scale), kernels.stream_handle(q.device))
    kernels.check(code, "flash_fwd_packed launch")
    flash_fwd_packed.launches += 1
    return out


def flash_fwd_lse(q: Tensor, k: Tensor, v: Tensor, heads: int,
                  scale: float) -> Tuple[Tensor, Tensor]:
    """K3. As `flash_fwd`, and lse (N, H, Lq) fp32."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, heads, scale)
    check_qkv("flash_fwd_lse", q, k, v, heads)
    n, lq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((n, heads, lq), device=q.device, dtype=torch.float32)
    with trace.span("K3", n=n, lq=lq, lk=k.shape[1], heads=heads), \
            torch.cuda.device(q.device):
        code = kernels.library().dct_flash_fwd_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], n, lq, k.shape[1], heads,
            float(scale), kernels.stream_handle(q.device))
    kernels.check(code, "flash_fwd_lse launch")
    flash_fwd_lse.launches += 1
    return out, lse


def _bwd_di(name: str, q: Tensor, o: Tensor, lse: Tensor, do: Tensor, heads: int,
            di: Optional[Tensor]) -> Optional[Tensor]:
    """What the bf16 K4a/K4b read as di: the given one (checked), else the
    pre-pass's. The fp32 kernels compute di themselves and take none."""
    if q.dtype != torch.bfloat16:
        return None
    if di is None:
        return flash_bwd_di(o, do, heads)
    if (di.device != q.device or di.dtype != torch.float32 or not di.is_contiguous()
            or di.shape != lse.shape):
        raise ValueError(f"{name}: di must be contiguous fp32 (N, H, Lq) on {q.device}")
    return di


def flash_bwd_di(o: Tensor, do: Tensor, heads: int) -> Tensor:
    """di = rowsum(dO * o) per head, (N, H, Lq) fp32: the bf16 backward's
    pre-pass (`csrc/flash_attention_bwd.cu`), once per backward."""
    if o.device.type == "cpu":
        return flash_bwd_di_plain(o, do, heads)
    if o.device.type != "cuda":
        raise ValueError(f"flash_bwd_di: unsupported device {o.device}")
    kernels.check_operands("flash_bwd_di", o, do)
    n, lq, hd = o.shape
    if do.shape != o.shape or hd != heads * HEAD_DIM:
        raise ValueError(f"flash_bwd_di: bad shapes o{tuple(o.shape)} dO{tuple(do.shape)} "
                         f"for {heads} heads of {HEAD_DIM}")
    di = torch.empty((n, heads, lq), device=o.device, dtype=torch.float32)
    with trace.span("di", n=n, lq=lq, heads=heads), \
            torch.cuda.device(o.device):
        code = kernels.library().dct_flash_bwd_di(
            o.data_ptr(), do.data_ptr(), di.data_ptr(), kernels.DTYPE_CODES[o.dtype], n, lq,
            heads, kernels.stream_handle(o.device))
    kernels.check(code, "flash_bwd_di launch")
    flash_bwd_di.launches += 1
    return di


def flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
                 heads: int, scale: float, di: Optional[Tensor] = None) -> Tensor:
    """K4a: dq (N, Lq, H*D) in q's dtype. `di` (bf16 only): the pre-pass's
    output when the caller already has it."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, heads, scale)[0]
    _check_bwd("flash_bwd_dq", q, k, v, o, lse, do, heads)
    di = _bwd_di("flash_bwd_dq", q, o, lse, do, heads, di)
    n, lq, _ = q.shape
    dq = torch.empty_like(q)
    with trace.span("K4a", n=n, lq=lq, lk=k.shape[1], heads=heads), \
            torch.cuda.device(q.device):
        code = kernels.library().dct_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if di is None else di.data_ptr(), do.data_ptr(), dq.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], n, lq, k.shape[1], heads, float(scale),
            kernels.stream_handle(q.device))
    kernels.check(code, "flash_bwd_dq launch")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
                  heads: int, scale: float,
                  di: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K4b: dk, dv (N, Lk, H*D) in k's dtype; `di` as for `flash_bwd_dq`."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, heads, scale)[1:]
    _check_bwd("flash_bwd_dkv", q, k, v, o, lse, do, heads)
    di = _bwd_di("flash_bwd_dkv", q, o, lse, do, heads, di)
    n, lq, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with trace.span("K4b", n=n, lq=lq, lk=k.shape[1], heads=heads), \
            torch.cuda.device(q.device):
        code = kernels.library().dct_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if di is None else di.data_ptr(), do.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), kernels.DTYPE_CODES[q.dtype], n, lq, k.shape[1], heads,
            float(scale), kernels.stream_handle(q.device))
    kernels.check(code, "flash_bwd_dkv launch")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = flash_fwd_lse.launches = flash_fwd_packed.launches = 0
flash_bwd_dq.launches = flash_bwd_dkv.launches = flash_bwd_di.launches = 0


def flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor, do: Tensor,
              heads: int, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv): K4a and K4b (for bf16 after one di pre-pass that both
    read), or `flash_bwd_plain` for CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, heads, scale)
    _check_bwd("flash_bwd", q, k, v, o, lse, do, heads)
    di = _bwd_di("flash_bwd", q, o, lse, do, heads, None)
    return (flash_bwd_dq(q, k, v, o, lse, do, heads, scale, di),
            *flash_bwd_dkv(q, k, v, o, lse, do, heads, scale, di))


@torch.library.custom_op("dct::flash_attn", mutates_args=())
def flash_attn_op(q: Tensor, k: Tensor, v: Tensor, heads: int,
                  scale: float) -> Tuple[Tensor, Tensor]:
    """Differentiable flash attention on (N, L, H*D): (o, lse) from K3."""
    return flash_fwd_lse(q, k, v, heads, scale)


@flash_attn_op.register_fake
def _(q, k, v, heads, scale):
    return torch.empty_like(q), q.new_empty((q.shape[0], heads, q.shape[1]),
                                            dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, heads, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.heads, ctx.scale = heads, scale
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.heads, ctx.scale)
    return dq, dk, dv, None, None


flash_attn_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: Optional[float] = None,
                    packed: bool = False) -> Tensor:
    """Attention over (..., L, H, D) inputs with identical batch dims.
    `packed` takes the forward through K6 instead of K1; under a gradient
    both take the same op (K3 forward, K4a/K4b backward), as the JAX
    package's packed path shares the default path's vjp."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    *batch, lq, heads, d = q.shape
    lk = k.shape[-3]
    n = math.prod(batch)
    qf = q.reshape(n, lq, heads * d).contiguous()
    kf = k.reshape(n, lk, heads * d).contiguous()
    vf = v.reshape(n, lk, heads * d).contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = flash_attn_op(qf, kf, vf, heads, float(scale))[0]
    else:
        out = (flash_fwd_packed if packed else flash_fwd)(qf, kf, vf, heads, scale)
    return out.view(*batch, lq, heads, d)
