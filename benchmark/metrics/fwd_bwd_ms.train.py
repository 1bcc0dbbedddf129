"""Mean milliseconds of `Trainer.loss_and_grads` (batch input, forward and
backward under autocast) per micro-step, from CUDA events the harness puts
around it."""


def read(data):
    ms = data.get("fwd_bwd_ms") or []
    return sum(ms) / len(ms) if ms else None
