"""The attention kernels of the fine-tuning cell's traced tail against
their roofline (see `benchmark/metrics/roofline.py`): per micro-step K3
(the forward that keeps the log-sum-exp) and the flash backward (K4a, K4b
and the di pre-pass together) of every spatial self-attention routed to
flash, and K2 twice per temporal attention (forward, and again when the
checkpointed layer is recomputed)."""
from benchmark.flops import attention
from benchmark.metrics import roofline


def read(data):
    n = data.get("trace_steps")
    if not n:
        return None
    h, w = data["hw"]
    params = data["config"]["model"]["params"]
    f = 2 ** (len(params["first_stage_config"]["params"]["ddconfig"]["ch_mult"]) - 1)
    unet = params["unet_config"]["params"]
    calls = attention.launches(unet, n=1, t=data["frames"], h=h // f, w=w // f)
    flash = [c for c in calls if c["kernel"] == "K1"]
    temporal = [c for c in calls if c["kernel"] == "K2"]
    if not flash and not temporal:
        return None
    least = sum(roofline.least(k["flops"], k["bytes"])
                for c in flash for k in (attention.forward_lse(c), attention.backward(c)))
    least += 2 * sum(roofline.least(c["flops"], c["bytes"]) for c in temporal)
    expected = {"K3": n * len(flash), "K4a": n * len(flash), "K4b": n * len(flash),
                "di": n * len(flash), "K2": 2 * n * len(temporal)}
    return roofline.share(data, expected, n * least)
