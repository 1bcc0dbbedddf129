"""K9: flash-attention forward with two heads per block.

`flash_attention_pairs` computes K1's function, softmax(q k^T * scale) v per
head on (N, L, H*64), through `csrc/flash_pairs.cu`, which assigns a pair
of heads to each block and moves 128-column rows: bf16 inputs run both
products on the tensor cores (the main loop of `csrc/flash_tc.cuh`), fp32
inputs as fp32 FMAs. Any finite scale, negative included. It replaces
`experiments/flash_pairs/flash_pairs.py::_fwd_kernel_pairs` of the JAX
repository (entry `flash_attention_pairs` there, without the Pallas tile
sizes `block_q`, `block_k`). Head dim 64 only; any H >= 1, odd H included
(the last pair then has one head and the kernel touches no column at or
beyond H*64). On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs the plain version, `flash_fwd_plain`. Forward only.
"""
from __future__ import annotations

import torch
from torch import Tensor

from dynamicrafter_tpu_torch.ops import kernels
from dynamicrafter_tpu_torch.ops.flash_attention import check_qkv, flash_fwd_plain
from dynamicrafter_tpu_torch.utils import trace


def flash_attention_pairs(q: Tensor, k: Tensor, v: Tensor, heads: int,
                          scale: float) -> Tensor:
    """K9. q: (N, Lq, H*64), k/v: (N, Lk, H*64) -> (N, Lq, H*64)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, heads, scale)
    check_qkv("flash_attention_pairs", q, k, v, heads)
    n, lq, _ = q.shape
    out = torch.empty_like(q)
    with trace.span("K9", n=n, lq=lq, lk=k.shape[1], heads=heads), \
            torch.cuda.device(q.device):
        code = kernels.library().dct_flash_fwd_pairs(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kernels.DTYPE_CODES[q.dtype], n, lq, k.shape[1], heads,
            float(scale), kernels.stream_handle(q.device))
    kernels.check(code, "flash_attention_pairs launch")
    flash_attention_pairs.launches += 1
    return out


flash_attention_pairs.launches = 0
