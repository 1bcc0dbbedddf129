"""Data-parallel batch inference: each process samples a slice of the prompts.

The port's counterpart of the JAX package's `scripts/distributed_inference.py`
(reference scripts/evaluation/ddp_wrapper.py:8-47 with the prompt slicing of
inference.py:350-356): pure data parallelism, no collective and no
`torch.distributed` group. Launch one process per card, e.g. by hand:

  python -m dynamicrafter_tpu_torch.distributed_inference \\
      --num_processes 2 --process_id 0 ... (the inference flags)

or with `torchrun --nproc_per_node N -m
dynamicrafter_tpu_torch.distributed_inference ...`, whose WORLD_SIZE and RANK
are read when --num_processes is not given. A process on CUDA takes card
cuda:<LOCAL_RANK> (cuda:0 without torchrun). --coordinator is accepted for
the JAX command line and has no effect. The arguments are parsed once and
the namespace goes to `inference.main` as it is. To share each clip's UNet
calls across the ranks instead, torchrun `inference` itself with --dp.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from dynamicrafter_tpu_torch import inference


def get_parser() -> argparse.ArgumentParser:
    p = inference.get_parser()
    p.prog = "python -m dynamicrafter_tpu_torch.distributed_inference"
    p.add_argument("--coordinator", type=str, default=None,
                   help="accepted for the JAX command line; no effect (no collective)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="default: $WORLD_SIZE, else 1")
    p.add_argument("--process_id", type=int, default=None,
                   help="default: $RANK, else 0")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_parser().parse_args(argv)
    if args.num_processes is None:
        args.num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if args.process_id is None:
        args.process_id = int(os.environ.get("RANK", "0"))
    if args.device == "cuda":
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    if (args.dp, args.sp) not in ((1, -1), (1, 1)):
        raise SystemExit("distributed_inference shards the prompts; --dp / --sp split one "
                         "clip's UNet calls: torchrun `dynamicrafter_tpu_torch.inference`")
    return inference.main(args, prompt_shard=(args.process_id, args.num_processes),
                          distributed=False)


if __name__ == "__main__":
    main()
