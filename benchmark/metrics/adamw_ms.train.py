"""Mean milliseconds of `AccumulatingAdamW.update` per micro-step (the
running mean of the gradients, and every second micro-step the clip and
AdamW), from CUDA events the harness puts around it."""


def read(data):
    ms = data.get("adamw_ms") or []
    return sum(ms) / len(ms) if ms else None
