"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by its name (see
`benchmark/harness.py`). Set-up (imports, the kernel library, the
modules, the weights drawn from the seed, a warm-up of the cell's shapes)
is timed as `setup_s`; then the window runs for `--seconds`; then the
program is freed and the reference in `benchmark/reference/` recomputes
what the window produced, which decides `correct`. With `--trace 1` the
window is the same and the line carries the per-layer metrics instead of
the end-to-end ones: the times from the window's CUDA events and clocks,
the device's share, rooflines and breakdown from a short tail run after
it under `torch.profiler` (device activity alone).

The last line of stdout is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and `checks`,
each compared number beside its limit); earlier lines give the set-up's
parts and the card's clocks. Exits non-zero with no result when CUDA is
absent or has fewer cards than the cell asks for, and when JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402

# every build and kernel cache of the run at a fixed path inside the checkout
_CACHES = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, rel in _CACHES.items():
        os.environ[var] = str(harness.ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    cell = harness.load_cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {cell.name} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    traffic = harness.traffic_module(cell.entry["traffic"])
    result, checks = traffic.run(cell, seed=args.seed, seconds=args.seconds,
                                 trace=bool(args.trace), device=torch.device("cuda", 0),
                                 clock=harness.SetupClock(T_START))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
