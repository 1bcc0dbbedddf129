"""Device milliseconds a UNet call of the traced tail launched inside the
program's `temporal` spans (each time ResBlock with its blend, each frame
embedding + VideoTransformerBlock + blend), charged by
`benchmark/metrics/spans.py`."""


def read(data):
    rep = data.get("span_report") or {}
    return rep.get("unet_ms.temporal") or None
