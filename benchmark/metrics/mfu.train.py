"""The micro-step's share of the card's bf16 peak: the model operations of
the micro-steps of the window (`benchmark.flops.model.train_step_flops`:
three times the trained UNet's and Resampler's forward, the frozen parts'
forward; recomputation not counted) over the window's seconds."""
from benchmark.flops import model, peaks


def read(data):
    if not data.get("steps"):
        return None
    h, w = data["hw"]
    per = model.train_step_flops(model.parts(data["config"], data["frames"], h, w),
                                 data["frames"])
    return 100.0 * per * data["steps"] / data["window_s"] / peaks.BF16_FLOPS
