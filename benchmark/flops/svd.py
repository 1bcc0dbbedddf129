"""Model operations and attention launches of a Stable Video Diffusion clip,
from the configuration and the shapes.

`clip_flops`: the reference modules (`benchmark/reference/svd.py`) run on
the `meta` device under `FlopCounterMode`, which counts the matrix products
and convolutions (2 per multiply-add) and nothing else: the image
embedder and the conditioning encoder on the one image (the unconditional
pass zeroes their outputs and runs neither), `steps` UNet calls on the 2B
rows of batched CFG, and the decode of the clip's frames.

`attention_launches`: every attention of one UNet call, routed by the
program's documented rule (`benchmark/flops/attention.py`): in each
SpatialVideoTransformer the spatial self-attention (K1 at L >= 2048 with
head dim 64, else plain) and cross-attention to the one image token
(plain), the temporal self-attention over T (K2, T <= 32) and
cross-attention over T to the image token (plain).
"""
from __future__ import annotations

import functools
import json
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.flops.attention import BYTES, HEAD_DIM, _levels
from benchmark.reference import svd as ref_svd

VALUES = {"fps_id": 6, "motion_bucket_id": 127, "cond_aug": 0.02}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=4)
def _parts(config_json: str, frames: int, height: int, width: int) -> Dict[str, int]:
    config = json.loads(config_json)
    with torch.device("meta"):
        ref = ref_svd.SVDReference(config).requires_grad_(False)
        net = ref_svd.model_node(config)["network_config"]["params"]
        dec = ref_svd.model_node(config)["first_stage_config"]["params"]["decoder_config"]
        ddc = dec["params"]
        f = 2 ** (len(ddc["ch_mult"]) - 1)
        h, w, z = height // f, width // f, ddc["z_channels"]
        img = torch.zeros(1, height, width, 3)
        return {
            "conditioning": _count(lambda: ref.conditioning(img, img, VALUES)),
            "unet": _count(lambda: ref.unet(
                torch.zeros(2, frames, h, w, net["in_channels"]), torch.zeros(2),
                torch.zeros(2, 1, net["context_dim"]), torch.zeros(2, net["adm_in_channels"]))),
            "decode": _count(lambda: ref.decode(torch.zeros(1, frames, h, w, z))),
        }


def parts(config: dict, frames: int, height: int, width: int) -> Dict[str, int]:
    """Operations of the conditioning of one image, one UNet call on one
    clip's 2 x `frames` rows, and the decode of one clip."""
    return _parts(json.dumps(config, sort_keys=True), frames, height, width)


def clip_flops(config: dict, frames: int, height: int, width: int, steps: int) -> int:
    p = parts(config, frames, height, width)
    return p["conditioning"] + steps * p["unet"] + p["decode"]


def attention_launches(unet: dict, clips: int, t: int, h: int, w: int) -> List[Dict]:
    """Every attention of one UNet call on `clips` clips of t frames (2 x
    clips x t rows with batched CFG) at h x w latents: {"kernel", "flops",
    "bytes"}."""
    d = unet.get("num_head_channels", 64)
    rows = 2 * clips
    out: List[Dict] = []
    ins, mid, outs = _levels(unet)
    for ds, ch in ins + [mid] + outs:
        hh, lq = ch // d, (h // ds) * (w // ds)
        frames = rows * t
        out.append({"kernel": "K1" if lq >= 2048 and d == HEAD_DIM else "plain",
                    "flops": 4 * frames * hh * lq * lq * d,
                    "bytes": BYTES * frames * hh * d * 4 * lq})
        out.append({"kernel": "plain", "flops": 4 * frames * hh * lq * d,
                    "bytes": BYTES * hh * d * (2 * frames * lq + 2 * rows)})
        out.append({"kernel": "K2" if t <= 32 else "plain",
                    "flops": 4 * rows * lq * hh * t * t * d,
                    "bytes": BYTES * 4 * rows * t * lq * hh * d})
        out.append({"kernel": "plain", "flops": 4 * rows * lq * hh * t * d,
                    "bytes": BYTES * hh * d * (2 * rows * t * lq + 2 * rows)})
    return out
