"""Model operations of a clip or a training step, counted from the
configuration and the shapes: the reference modules run on the `meta`
device under `torch.utils.flop_counter.FlopCounterMode`, which counts the
matrix products and convolutions (2 per multiply-add) and nothing else.
The count is the model's and not the program's: the same whatever
implements it (an untiled decode, no recomputation).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import ReferenceModel


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def parts(config: dict, frames: int, height: int, width: int) -> Dict[str, int]:
    """Forward operations of each module at one clip's shapes: `text` (one
    prompt), `image` (the vision tower and Resampler on one image),
    `resampler` (the Resampler alone),
    `encode` and `decode` (one frame each), `unet` (one clip of `frames`),
    `unet_shallow` (DeepCache's shallow call on one clip)."""
    with torch.device("meta"):
        ref = ReferenceModel(config).requires_grad_(False)
        f = 2 ** (len(ref.first_stage_model.config.ch_mult) - 1)
        h, w = height // f, width // f
        zc = ref.first_stage_model.config.embed_dim
        unet = ref.unet
        cin = unet.config.in_channels
        ctx = unet.config.context_dim
        q = ref.image_proj_model.config.num_queries
        unet_args = lambda: (torch.zeros(1, frames, h, w, cin), torch.zeros(1, dtype=torch.long))
        unet_kw = lambda: dict(context_text=torch.zeros(1, 77, ctx),
                               context_img=torch.zeros(1, frames, q, ctx),
                               fs=torch.zeros(1, dtype=torch.long))
        feature = unet(*unet_args(), **unet_kw(), return_cache=True)[1]
        return {
            "text": _count(lambda: ref.embed_text(torch.zeros(1, 77, dtype=torch.long))),
            "image": _count(lambda: ref.embed_image(torch.zeros(1, height, width, 3))),
            "resampler": _count(lambda: ref.image_proj_model(torch.zeros(
                1, (ref.embedder.config.image_size // ref.embedder.config.patch_size) ** 2 + 1,
                ref.embedder.config.width))),
            "encode": _count(lambda: ref.encode(torch.zeros(1, height, width, 3),
                                                torch.zeros(1, h, w, zc))),
            "decode": _count(lambda: ref.first_stage_model.decode(torch.zeros(1, h, w, zc))),
            "unet": _count(lambda: unet(*unet_args(), **unet_kw())),
            "unet_shallow": _count(lambda: unet(*unet_args(), **unet_kw(), cache=feature)),
        }


def clip_flops(p: Dict[str, int], frames: int, unet_passes: int,
               shallow_passes: int = 0) -> int:
    """One generated clip with CFG: two prompts (the prompt and the empty
    one), two images (the image and the zero image), every frame encoded
    and decoded, `unet_passes` whole UNet passes over the clip and
    `shallow_passes` DeepCache shallow ones."""
    return (2 * p["text"] + 2 * p["image"] + frames * (p["encode"] + p["decode"])
            + unet_passes * p["unet"] + shallow_passes * p["unet_shallow"])


def train_step_flops(p: Dict[str, int], frames: int) -> int:
    """One fine-tuning micro-step: three times the forward of the trained
    UNet and Resampler (forward and backward; recomputation not counted),
    and the forward of the frozen parts: two prompts (the prompt and the
    empty one), the vision tower on one image, every frame encoded."""
    vision = p["image"] - p["resampler"]
    return (3 * (p["unet"] + p["resampler"]) + 2 * p["text"] + vision
            + frames * p["encode"])
