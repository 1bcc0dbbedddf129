"""The attention kernels of the generation cell's traced tail (every
launch the geometry routes to one of ours: K1, K2, K5) against their
roofline (see `benchmark/metrics/roofline.py`)."""
from benchmark.flops import attention
from benchmark.metrics import roofline


def read(data):
    ours = [c for c in data.get("attention") or [] if c["kernel"] != "plain"]
    if not ours:
        return None
    least = sum(roofline.least(c["flops"], c["bytes"]) for c in ours)
    return roofline.share(data, attention.count(ours), least)
