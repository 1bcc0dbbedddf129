"""The whole clip's share of the card's bf16 peak: the model operations of
the clips completed in the window (`benchmark.flops.model`: both CLIP
towers on both prompts and images, the Resampler, every frame's VAE encode
and decode, every UNet pass, DeepCache's shallow ones at their own count)
over the window's seconds."""
from benchmark.flops import model, peaks


def read(data):
    if not data.get("clips"):
        return None
    h, w = data["hw"]
    per_clip = model.clip_flops(model.parts(data["config"], data["frames"], h, w),
                                data["frames"], data["passes_per_clip"],
                                data.get("shallow_passes_per_clip", 0))
    return 100.0 * per_clip * data["clips"] / data["window_s"] / peaks.BF16_FLOPS
