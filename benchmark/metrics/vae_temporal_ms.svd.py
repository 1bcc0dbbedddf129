"""Device milliseconds a clip of the traced tail launched inside the
program's `vae_temporal` spans (the decoder's time ResBlocks, their blends
and its time conv), charged by `benchmark/metrics/spans.py`."""
LAYER = frozenset({"vae_temporal"})


def read(data):
    ch = data.get("charged")
    if ch is None:
        return None
    clips = sum(1 for s in ch.spans if s.name == "request")
    ms = 1e3 * sum(ch.seconds(a) for a, o in zip(ch.activities, ch.owner)
                   if ch.within(o, LAYER) is not None)
    return ms / clips if clips and ms else None
