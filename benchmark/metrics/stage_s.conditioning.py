"""Mean seconds of the conditioning stage of a clip (CLIP text, CLIP vision
and Resampler, VAE encode), from `pipeline.sample(timings=)`."""


def read(data):
    vals = [s["conditioning"] for s in data.get("stages", []) if "conditioning" in s]
    return sum(vals) / len(vals) if vals else None
