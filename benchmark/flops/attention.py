"""The attention launches of one UNet call, from the configuration and the
call's shapes, with each launch's operations and bytes.

Routing follows the program's documented rule (its `ops/attention.py`):
unmasked self-attention with Lq >= 2048, Lk >= 512 and head dim 64 is K1
(flash forward; K3 under a gradient, then K4a, K4b and the di pre-pass in
the backward); self-attention over <= 32 tokens is K5 when the tokens are
a frame's positions and K2 when they are a clip's frames (time-major
temporal attention); everything else is plain PyTorch. Operations count
both products (2 per multiply-add); bytes count each input read once and
each output written once, in bf16.
"""
from __future__ import annotations

from typing import Dict, List

HEAD_DIM = 64
BYTES = 2          # bf16


def _levels(unet: dict):
    """(ds, channels) of every spatial and temporal transformer, in call
    order, with `init_attn` first (as ("init", 320))."""
    mult = list(unet.get("channel_mult", (1, 2, 4, 4)))
    mc = unet.get("model_channels", 320)
    nres = unet.get("num_res_blocks", 2)
    att = set(unet.get("attention_resolutions", (4, 2, 1)))
    out, ds = [], 1
    for level, m in enumerate(mult):
        for _ in range(nres):
            if ds in att:
                out.append((ds, m * mc))
        if level != len(mult) - 1:
            ds *= 2
    mid = (ds, mult[-1] * mc)
    outs = []
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(nres + 1):
            if ds in att:
                outs.append((ds, m * mc))
            if level and i == nres:
                ds //= 2
    return out, mid, outs


def launches(unet: dict, n: int, t: int, h: int, w: int, shallow: bool = False) -> List[Dict]:
    """Every attention of one UNet call on n clips of t frames at h x w
    latents: {"kernel", "flops", "bytes"} (kernel "plain" for the plain
    path). Spatial transformers: self-attention, text and image
    cross-attention; temporal transformers: two self-attentions over T.
    `shallow`: DeepCache's shallow call, which runs the top level's input
    and output blocks alone (`init_attn` among them)."""
    d = unet.get("num_head_channels", 64)
    heads = lambda ch: ch // d
    out: List[Dict] = []

    def spatial(ds: int, ch: int) -> None:
        lq = (h // ds) * (w // ds)
        frames = n * t
        hh = heads(ch)
        io = BYTES * frames * hh * d * 4 * lq
        kernel = ("K1" if lq >= 2048 and d == HEAD_DIM else
                  "K5" if lq <= 32 else "plain")
        out.append({"kernel": kernel, "flops": 4 * frames * hh * lq * lq * d, "bytes": io})
        lt = unet.get("text_context_len", 77)
        out.append({"kernel": "plain", "flops": 4 * frames * hh * lq * lt * d,
                    "bytes": BYTES * hh * d * (2 * frames * lq + 2 * n * lt)})
        if unet.get("image_cross_attention", True):
            li = 16
            out.append({"kernel": "plain", "flops": 4 * frames * hh * lq * li * d,
                        "bytes": BYTES * frames * hh * d * (2 * lq + 2 * li)})

    def temporal(ds: int, ch: int, hh: int) -> None:
        g = (h // ds) * (w // ds)
        for _ in range(2):       # attn1 and attn2, both self-attention over T
            out.append({"kernel": "K2" if t <= 32 else "plain",
                        "flops": 4 * n * g * hh * t * t * d,
                        "bytes": BYTES * 4 * n * t * g * hh * d})

    ins, mid, outs = _levels(unet)
    if unet.get("addition_attention", True):
        temporal(1, unet.get("model_channels", 320), 8)
    blocks = ([b for b in ins + outs if b[0] == 1] if shallow else ins + [mid] + outs)
    for ds, ch in blocks:
        spatial(ds, ch)
        if unet.get("temporal_attention", True):
            temporal(ds, ch, heads(ch))
    return out


def count(calls: List[Dict]) -> Dict[str, int]:
    c: Dict[str, int] = {}
    for k in calls:
        c[k["kernel"]] = c.get(k["kernel"], 0) + 1
    return c


def backward(call: Dict) -> Dict:
    """The flash backward of one K1-routed attention (K4a, K4b and the di
    pre-pass together): the five products of the backward (the logits
    again, dP, dV, dQ, dK: 10 per multiply-add of one product over 4 in
    the forward) and q, k, v, o, dO and the log-sum-exp read, dq, dk, dv
    written."""
    io = call["bytes"] // 4            # one of q, k, v, o
    lse = io // (BYTES * HEAD_DIM) * 4
    return {"kernel": "K4", "flops": call["flops"] * 10 // 4, "bytes": 8 * io + lse}


def forward_lse(call: Dict) -> Dict:
    """K3: the K1 forward that also writes the rows' log-sum-exp (fp32)."""
    io = call["bytes"] // 4
    return {"kernel": "K3", "flops": call["flops"],
            "bytes": call["bytes"] + io // (BYTES * HEAD_DIM) * 4}
