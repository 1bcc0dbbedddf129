"""The generation traffic of `benchmark/traffic/generate.py` under a second
name. A cell is one pair of configuration and traffic, so a second cell of a
configuration whose first cell runs `generate` names this module instead. The
generator is the same; what the cell changes (`i2v1024.ddim50`: DDIM-50 with
eta 1, `run.sh 1024`'s preset) is in its parameters,
`benchmark/workloads/<cell>.json`."""
from benchmark.traffic.generate import program_factory, run  # noqa: F401
