"""Mean milliseconds of one UNet call of the sampler loop, from CUDA
events that forward hooks on the pipeline's UNet record around each call
of the window."""


def read(data):
    ms = data.get("unet_ms") or []
    return sum(ms) / len(ms) if ms else None
