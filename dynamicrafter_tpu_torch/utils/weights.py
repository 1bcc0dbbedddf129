"""Weights: strict loading of reference-format state dicts, and the smoke init.

The port's `state_dict` keys are the released checkpoint keys, so a flat
`{reference_key: array}` dict loads with no converter: either the output of
`dynamicrafter_tpu.utils.export.export_state_dict` (JAX params carried
across as numpy) or a released checkpoint after `normalize_state_dict`
(the JAX package's `utils/weights.py::normalize_state_dict`, kept here as
the port's own copy).

`flax_encoder_state_dict` carries the Flax param tree of an alternate
encoder (`models/encoders.py`), as nested dicts of numpy arrays, to that
module's state_dict.

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


def _dense(out: Dict[str, np.ndarray], key: str, node: Mapping) -> None:
    """A Flax Dense {kernel (in, out)[, bias]} as a torch Linear at `key`."""
    out[key + ".weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        out[key + ".bias"] = np.asarray(node["bias"])


def _norm(out: Dict[str, np.ndarray], key: str, node: Mapping) -> None:
    out[key + ".weight"] = np.asarray(node["scale"])
    if "bias" in node:
        out[key + ".bias"] = np.asarray(node["bias"])


def _hf_clip_text(params: Mapping) -> Dict[str, np.ndarray]:
    out = {"text_model.embeddings.token_embedding.weight": np.asarray(params["token_embedding"]),
           "text_model.embeddings.position_embedding.weight":
               np.asarray(params["positional_embedding"])}
    for name, node in params.items():
        if name.startswith("resblocks_"):
            base = f"text_model.encoder.layers.{name.split('_')[1]}."
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _dense(out, base + "self_attn." + proj, node[proj])
            _dense(out, base + "mlp.fc1", node["c_fc"])
            _dense(out, base + "mlp.fc2", node["c_proj"])
            _norm(out, base + "layer_norm1", node["ln_1"])
            _norm(out, base + "layer_norm2", node["ln_2"])
    if "ln_final" in params:
        _norm(out, "text_model.final_layer_norm", params["ln_final"])
    return out


def _t5(params: Mapping) -> Dict[str, np.ndarray]:
    out = {"shared.weight": np.asarray(params["token_embedding"]),
           "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
               np.asarray(params["rel_bias"])}
    _norm(out, "encoder.final_layer_norm", params["ln_final"])
    for name, node in params.items():
        if name.startswith("blocks_"):
            base = f"encoder.block.{name.split('_')[1]}.layer."
            for proj in ("q", "k", "v", "o"):
                _dense(out, base + "0.SelfAttention." + proj, node[proj])
            for proj in ("wi_0", "wi_1", "wo"):
                _dense(out, base + "1.DenseReluDense." + proj, node[proj])
            _norm(out, base + "0.layer_norm", node["ln_attn"])
            _norm(out, base + "1.layer_norm", node["ln_ff"])
    return out


def _clip_vision_pooled(params: Mapping) -> Dict[str, np.ndarray]:
    vis, pre = params["visual"], "model.visual."
    patch = np.asarray(vis["patch_embed"]["kernel"])          # (p*p*3, W)
    p = int(round((patch.shape[0] // 3) ** 0.5))
    out = {pre + "conv1.weight": patch.reshape(p, p, 3, -1).transpose(3, 2, 0, 1),
           pre + "class_embedding": np.asarray(vis["class_embedding"]),
           pre + "positional_embedding": np.asarray(vis["positional_embedding"]),
           pre + "proj": np.asarray(params["proj"])}
    _norm(out, pre + "ln_pre", vis["ln_pre"])
    _norm(out, pre + "ln_post", params["ln_post"])
    for name, node in vis.items():
        if name.startswith("resblocks_"):
            base = f"{pre}transformer.resblocks.{name.split('_')[1]}."
            qkv = [node[n] for n in ("q_proj", "k_proj", "v_proj")]
            out[base + "attn.in_proj_weight"] = np.concatenate(
                [np.asarray(n["kernel"]).T for n in qkv])
            out[base + "attn.in_proj_bias"] = np.concatenate([np.asarray(n["bias"]) for n in qkv])
            _dense(out, base + "attn.out_proj", node["out_proj"])
            _dense(out, base + "mlp.c_fc", node["c_fc"])
            _dense(out, base + "mlp.c_proj", node["c_proj"])
            _norm(out, base + "ln_1", node["ln_1"])
            _norm(out, base + "ln_2", node["ln_2"])
    return out


def flax_encoder_state_dict(kind: str, params: Mapping) -> Dict[str, np.ndarray]:
    """The Flax param tree of an alternate encoder of the JAX package
    (`dynamicrafter_tpu/models/encoders.py`), as nested dicts of arrays, under
    the state_dict keys of its counterpart in `models/encoders.py`; load the
    result with `load_reference_state_dict`. kind: "clip_text_hf"
    (HFCLIPTextEncoder), "t5" (T5Encoder), "clip_t5" (CLIPT5Encoder),
    "class_embed" (ClassEmbedder) or "clip_vision_pooled" (CLIPVisionPooled).
    Dense kernels (in, out) become Linear weights (out, in); q, k, v of a
    vision block are packed into in_proj; the patch-embedding matrix becomes
    the (W, 3, p, p) conv weight."""
    if kind == "clip_text_hf":
        return _hf_clip_text(params)
    if kind == "t5":
        return _t5(params)
    if kind == "clip_t5":
        return {**{"clip_encoder." + k: v for k, v in _hf_clip_text(params["clip_encoder"]).items()},
                **{"t5_encoder." + k: v for k, v in _t5(params["t5_encoder"]).items()}}
    if kind == "class_embed":
        return {"embedding.weight": np.asarray(params["embedding"]["embedding"])}
    if kind == "clip_vision_pooled":
        return _clip_vision_pooled(params)
    raise ValueError(f"unknown encoder kind {kind!r}")


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
