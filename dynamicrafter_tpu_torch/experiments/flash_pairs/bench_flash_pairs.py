"""K9 (two heads per block) against K1 at the model's hot self-attention
shapes: the counterpart of the JAX repository's
`experiments/flash_pairs/bench_flash_pairs.py`, without its sweep over
Pallas tile sizes.

    python -m dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_pairs

times both kernels at the three cases of `bench_flash_variants.CASES` (bf16,
N = 32) with CUDA events and prints milliseconds, TFLOP/s and K1's time over
the row's. It needs a CUDA device and raises without one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants import (
    bench_cases, cuda_device, get_parser)
from dynamicrafter_tpu_torch.experiments.flash_pairs.flash_pairs import flash_attention_pairs
from dynamicrafter_tpu_torch.ops.flash_attention import flash_fwd


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = get_parser(f"{__package__}.bench_flash_pairs").parse_args(argv)
    device = cuda_device(args.device)
    print("device:", torch.cuda.get_device_name(device), flush=True)
    return bench_cases({"K1 flash_fwd": flash_fwd, "K9 pairs": flash_attention_pairs}, device)


if __name__ == "__main__":
    main()
