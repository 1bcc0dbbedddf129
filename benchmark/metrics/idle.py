"""Idle share of a traced window (the union of device intervals against
the window's wall time)."""
from benchmark import harness


def pct(data):
    tl = data.get("timeline")
    if tl is None or not tl.device:
        return None
    span = tl.window[1] - tl.window[0]
    busy = sum(e - s for s, e in harness.busy_intervals(tl))
    return 100.0 * (1.0 - busy / span) if span > 0 else None
