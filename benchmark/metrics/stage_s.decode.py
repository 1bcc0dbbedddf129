"""Mean seconds of the decode stage of a clip, from `pipeline.sample(timings=)`."""


def read(data):
    vals = [s["decode"] for s in data.get("stages", []) if "decode" in s]
    return sum(vals) / len(vals) if vals else None
