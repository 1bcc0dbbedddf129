"""The attention kernels' share of their roofline over the traced tail: the
sum of each launch's least time (the larger of its operations over the
bf16 peak and its bytes over the HBM bandwidth) over the sum of those
kernels' device time in the profiler's timeline. The launches come from
the cell's geometry (`benchmark.flops.attention`) over the tail's calls,
and are held to the program's launch counters over the same calls: where
they disagree the share is not given."""
from __future__ import annotations

import sys

from benchmark import harness
from benchmark.flops import peaks

FAMILY = {"K1": "K1 flash_fwd", "K2": "K2 small_t_kernel", "K3": "K1 flash_fwd",
          "K5": "K5 small_t_fwd", "K4a": "K4a flash_bwd_dq", "K4b": "K4b flash_bwd_dkv",
          "di": "K4 di pre-pass"}


def share(data, expected: dict, least_s: float):
    """`expected`: {kernel: launches over the tail}; `least_s`: their least
    seconds together."""
    tl = data.get("timeline")
    if tl is None or not tl.device or not expected:
        return None
    counted = data.get("launches", {})
    for k, n in expected.items():
        if counted.get(k) != n:
            print(f"roofline: {k} launched {counted.get(k)} times, the geometry says {n}: "
                  "no share", file=sys.stderr)
            return None
    fams = {FAMILY[k] for k in expected}
    dev = sum(e - s for name, s, e in tl.device if harness.family(name) in fams)
    return 100.0 * least_s / dev if dev > 0 else None


def least(flops: float, nbytes: float) -> float:
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
