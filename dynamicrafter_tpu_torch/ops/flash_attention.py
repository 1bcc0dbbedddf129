"""K1: flash-attention forward for spatial self-attention.

`flash_fwd` is the kernel wrapper on the transpose-free (N, L, H*D) layout:
on a CUDA tensor it launches the hand-written kernel in
`csrc/flash_attention.cu` (which replaces the Pallas kernel
`dynamicrafter_tpu/ops/flash_attention.py::_fwd_kernel_nlhd`) or raises;
on a CPU tensor it runs `flash_fwd_plain`, the same function in plain
PyTorch. `flash_fwd.launches` counts kernel launches.

`flash_attention` is the entry point on the (..., L, H, D) convention of
`ops.attention`, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from dynamicrafter_tpu_torch.ops import kernels

HEAD_DIM = 64  # the only head width the kernel takes (all shipped configs)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head on (N, L, H*D): input-dtype logits,
    fp32 softmax, the JAX package's `xla_attention` math."""
    n, lq, hd = q.shape
    d = hd // heads
    qh = q.reshape(n, lq, heads, d).transpose(1, 2)
    kh = k.reshape(n, k.shape[1], heads, d).transpose(1, 2)
    vh = v.reshape(n, v.shape[1], heads, d).transpose(1, 2)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    out = torch.matmul(attn, vh)
    return out.transpose(1, 2).reshape(n, lq, hd).to(q.dtype)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              scale: float) -> torch.Tensor:
    """q: (N, Lq, H*D), k/v: (N, Lk, H*D) -> (N, Lq, H*D)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    kernels.check_operands("flash_fwd", q, k, v)
    n, lq, hd = q.shape
    if hd != heads * HEAD_DIM:
        raise ValueError(f"flash_fwd: head dim {hd // heads} != {HEAD_DIM}")
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != hd:
        raise ValueError(f"flash_fwd: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("flash_fwd: empty key sequence")
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        code = lib.dct_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], n, lq, k.shape[1], heads,
            float(scale), kernels.stream_handle(q.device))
    kernels.check(code, "flash_fwd launch")
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (..., L, H, D) inputs with identical batch dims."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    *batch, lq, heads, d = q.shape
    lk = k.shape[-3]
    n = math.prod(batch)
    out = flash_fwd(q.reshape(n, lq, heads * d).contiguous(),
                    k.reshape(n, lk, heads * d).contiguous(),
                    v.reshape(n, lk, heads * d).contiguous(), heads, scale)
    return out.view(*batch, lq, heads, d)
