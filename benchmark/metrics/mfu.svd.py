"""The whole Stable Video Diffusion clip's share of the card's bf16 peak:
the model operations of the clips completed in the window
(`benchmark.flops.svd.clip_flops`: the image embedder and the conditioning
encoder on the image, every UNet call on the 2 x 25 rows of batched CFG,
the decode of the 25 frames) over the window's seconds."""
from benchmark.flops import peaks, svd


def read(data):
    if not data.get("clips") or data.get("steps") is None:
        return None
    h, w = data["hw"]
    per_clip = svd.clip_flops(data["config"], data["frames"], h, w, data["steps"])
    return 100.0 * per_clip * data["clips"] / data["window_s"] / peaks.BF16_FLOPS
