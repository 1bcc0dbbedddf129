"""Weights: strict loading of reference-format state dicts, and the smoke init.

The port's `state_dict` keys are the released checkpoint keys, so a flat
`{reference_key: array}` dict loads with no converter: either the output of
`dynamicrafter_tpu.utils.export.export_state_dict` (JAX params carried
across as numpy) or a released checkpoint after `normalize_state_dict`
(the JAX package's `utils/weights.py::normalize_state_dict`, kept here as
the port's own copy).

Some key families in a checkpoint belong to modules the port never runs.
They are dropped by name through `DONOR_ONLY` (the same families
`dynamicrafter_tpu/utils/export.py` documents as never held by the Flax
tree); any other missing or unexpected key is an error.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# DDPM schedule buffers of the reference LatentDiffusion (ddpm3d.py:123-186);
# the port rebuilds them from the config (schedule.py)
SCHEDULE_BUFFERS = frozenset({
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "lvlb_weights",
    "scale_arr", "logvar",
})

DONOR_ONLY = (
    # text tower: pooled-output head, unused by the penultimate features
    re.compile(r"^cond_stage_model\.model\.(text_projection|logit_scale|attn_mask)$"),
    # vision tower: pooling head after the transformer, and the image
    # normalization constants the preprocess holds as literals
    re.compile(r"^embedder\.model\.visual\.(ln_post\..*|proj)$"),
    re.compile(r"^embedder\.(mean|std)$"),
    # VAE GAN-training head
    re.compile(r"^first_stage_model\.loss\..*"),
)
_TEXT_BLOCK = re.compile(r"^cond_stage_model\.model\.transformer\.resblocks\.(\d+)\.")


_DEEPSPEED_PREFIX = "_forward_module."


def normalize_state_dict(sd: Mapping) -> Dict[str, object]:
    """Undo the three source formats of a raw checkpoint dict (reference
    scripts/evaluation/inference.py:36-59, funcs.py:103-124):
      1. plain      {"state_dict": {keys}};
      2. 256 model  the same, with framestride_embed renamed fps_embedding;
      3. deepspeed  {"module": {"_forward_module.<key>": tensor}}.
    Values are passed through untouched."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    elif "module" in sd and isinstance(sd["module"], Mapping):
        sd = {k.removeprefix(_DEEPSPEED_PREFIX): v for k, v in sd["module"].items()}
    return {k.replace("framestride_embed", "fps_embedding"): v for k, v in sd.items()}


def donor_only(key: str, n_text_blocks: Optional[int] = None) -> bool:
    """True for checkpoint keys the port drops by name. `n_text_blocks` is
    the number of text resblocks the port built: the one block after them
    (the last block, unused by layer="penultimate") is dropped too."""
    if key in SCHEDULE_BUFFERS or any(p.match(key) for p in DONOR_ONLY):
        return True
    m = _TEXT_BLOCK.match(key)
    return bool(m and n_text_blocks is not None and int(m.group(1)) == n_text_blocks)


def _text_blocks(own_keys) -> Optional[int]:
    idx = [int(m.group(1)) for k in own_keys if (m := _TEXT_BLOCK.match(k))]
    return max(idx) + 1 if idx else None


def load_reference_state_dict(target, sd: Mapping[str, np.ndarray],
                              prefix: str = "") -> None:
    """Strict-load `sd` into `target` (a pipeline or an nn.Module).

    For a pipeline the keys are full checkpoint keys. For a module whose
    keys sit under a checkpoint prefix (e.g. "cond_stage_model."), pass that
    prefix; `sd` then holds the keys without it. Values are numpy arrays or
    tensors; they are copied into the module's parameters (device and dtype
    of the parameter). Raises KeyError on any missing or unexpected key
    that is not dropped by name, and ValueError on a shape mismatch.
    """
    module: nn.Module = getattr(target, "net", target)
    own = module.state_dict()
    n_text = _text_blocks(prefix + k for k in own)
    incoming = {k: v for k, v in sd.items() if not donor_only(prefix + k, n_text)}
    missing = sorted(set(own) - set(incoming))
    unexpected = sorted(set(incoming) - set(own))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:10]} "
                       f"({len(missing)}), unexpected {unexpected[:10]} "
                       f"({len(unexpected)})")
    with torch.no_grad():
        for k, dst in own.items():
            src = torch.as_tensor(np.asarray(incoming[k]))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{k}: checkpoint shape {tuple(src.shape)} != "
                                 f"module shape {tuple(dst.shape)}")
            dst.copy_(src.to(dtype=dst.dtype))


def init_normal_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Fill every parameter and floating buffer from N(0, std^2), drawn from
    one generator on the module's device: the smoke-run weights. No layer is
    zero-initialised, so a wrong kernel cannot hide behind a zero output."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.normal_(0.0, std, generator=generator)
    return module
