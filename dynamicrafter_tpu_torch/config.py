"""Config system over the reference YAML schema, without PyYAML.

The reference composes models from `{target: pkg.Cls, params: {...}}` nodes.
As in the JAX package (`dynamicrafter_tpu/config.py`), `target:` names map
onto component roles and the YAML schema is read verbatim. Two schemas:
DynamiCrafter's `LatentVisualDiffusion` (`ModelConfig`) and Stability's
`sgm` `DiffusionEngine` of Stable Video Diffusion (`SVDConfig`).

PyYAML is not installed everywhere the port runs, so `load_yaml` parses the
subset of YAML that `configs/*.yaml` use: nested block mappings, block lists
of scalars (`- 4`, at the key's indent or deeper) or of mappings (`- key:
value`, the item's further keys two columns in, as sgm's `emb_models`),
flow lists of scalars (`[1, 2]`, `[]`), `#` comments, and plain or quoted
scalars resolved as YAML 1.1 does (int, float, bool, null, str). Anything
else raises.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

_TARGET_ROLES = {
    "UNetModel": "unet",
    "AutoencoderKL": "vae",
    "IdentityFirstStage": "vae_identity",
    "FrozenOpenCLIPEmbedder": "clip_text",
    "FrozenOpenCLIPImageEmbedderV2": "clip_vision",
    "FrozenCLIPEmbedder": "clip_text_hf",
    "FrozenT5Embedder": "t5_text",
    "FrozenCLIPT5Encoder": "clip_t5_text",
    "ClipImageEmbedder": "clip_vision_pooled",
    "FrozenOpenCLIPImageEmbedder": "clip_vision_pooled",
    "ClassEmbedder": "class_embed",
    "IdentityEncoder": "identity",
    "Resampler": "resampler",
    "ImageProjModel": "image_proj",
    "LatentVisualDiffusion": "model",
    "LatentDiffusion": "model",
    "DDPM": "model",
    # sgm (Stable Video Diffusion)
    "DiffusionEngine": "svd_model",
    "VideoUNet": "video_unet",
    "AutoencodingEngine": "video_vae",
    "VideoDecoder": "video_decoder",
    "Encoder": "vae_encoder",
    "AutoencoderKLModeOnly": "vae_mode",
    "GeneralConditioner": "conditioner",
    "FrozenOpenCLIPImagePredictionEmbedder": "clip_image_prediction",
    "ConcatTimestepEmbedderND": "timestep_vector",
    "VideoPredictionEmbedderWithEncoder": "video_encoder_concat",
    "Denoiser": "denoiser",
    "VScalingWithEDMcNoise": "v_scaling_edm",
    "EulerEDMSampler": "euler_edm",
    "EDMDiscretization": "edm_discretization",
    "LinearPredictionGuider": "linear_guider",
}

# YAML 1.1 implicit scalar resolution, as PyYAML's resolver does it
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")
_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_NULL = {"~", "null", "Null", "NULL", ""}


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    if text[:1] in ("{", "&", "*", "!", "|", ">"):
        raise ValueError(f"YAML feature outside the supported subset: {text!r}")
    if text in _NULL:
        return None
    if text in ("yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE",
                "false", "False", "FALSE", "on", "On", "ON", "off", "Off",
                "OFF"):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("tabs in YAML indentation are not supported")
        out.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return out


def _is_item(s: str) -> bool:
    return s == "-" or s.startswith("- ")


def _parse_list(lines, i: int, indent: int):
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        item = lines[i][1][1:].strip()
        if not item:
            raise ValueError("YAML list item with a nested block is not supported")
        if not item.startswith(("'", '"', "[")) and re.match(r"^[^'\"\[]+:(\s|$)", item):
            # a mapping: its first key on the item's line, the rest below it
            # two columns in
            lines[i] = (indent + 2, item)
            value, i = _parse_map(lines, i, indent + 2)
            out.append(value)
            continue
        out.append(_scalar(item))
        i += 1
    return out, i


def _parse_map(lines, i: int, indent: int):
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        text = lines[i][1]
        m = re.match(r"^([^:]+?):(?:\s+(.*))?$", text)
        if m is None:
            raise ValueError(f"cannot parse YAML line: {text!r}")
        key, rest = _scalar(m.group(1)), (m.group(2) or "").strip()
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _parse_block(lines, i, lines[i][0])
        elif i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            out[key], i = _parse_list(lines, i, indent)
        else:
            out[key] = None
    return out, i


def _parse_block(lines, i: int, indent: int):
    if _is_item(lines[i][1]):
        return _parse_list(lines, i, indent)
    return _parse_map(lines, i, indent)


def parse_yaml(text: str) -> Any:
    lines = _lines(text)
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected YAML indentation at {lines[i][1]!r}")
    return value


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_yaml(f.read())


def target_role(target: str) -> Optional[str]:
    return _TARGET_ROLES.get(target.rsplit(".", 1)[-1])


class ModelConfig:
    """Parsed model section of a reference-style YAML config (the same
    fields and defaults as `dynamicrafter_tpu.config.ModelConfig`)."""

    def __init__(self, model_node: Dict[str, Any]):
        if "model" in model_node:
            model_node = model_node["model"]
        if target_role(model_node.get("target", "LatentVisualDiffusion")) != "model":
            raise ValueError(f"not a model node: {model_node.get('target')!r}")
        p = dict(model_node.get("params", {}))
        self.params = p
        self.pretrained_checkpoint = model_node.get("pretrained_checkpoint")

        self.timesteps = p.get("timesteps", 1000)
        self.beta_schedule = p.get("beta_schedule", "linear")
        self.linear_start = p.get("linear_start", 1e-4)
        self.linear_end = p.get("linear_end", 2e-2)
        self.cosine_s = p.get("cosine_s", 8e-3)
        self.parameterization = p.get("parameterization", "eps")
        self.rescale_betas_zero_snr = p.get("rescale_betas_zero_snr", False)
        self.use_dynamic_rescale = p.get("use_dynamic_rescale", False)
        self.base_scale = p.get("base_scale", 0.7)
        self.turning_step = p.get("turning_step", 400)
        self.scale_factor = p.get("scale_factor", 0.18215)
        self.uncond_type = p.get("uncond_type", "empty_seq")
        self.uncond_prob = p.get("uncond_prob", 0.05)
        self.interp_mode = p.get("interp_mode", False)
        self.fps_condition_type = p.get("fps_condition_type", "fs")
        self.perframe_ae = p.get("perframe_ae", False)
        self.rand_cond_frame = p.get("rand_cond_frame", False)
        self.conditioning_key = p.get("conditioning_key", "hybrid")
        self.loss_type = p.get("loss_type", "l2")

        self.unet = dict(p["unet_config"]["params"])
        self.vae = dict(p["first_stage_config"]["params"])

        def _role(node, default_target):
            target = node.get("target", default_target)
            role = target_role(target)
            if role is None:
                raise ValueError(
                    f"unrecognized conditioning target {target!r}; known "
                    f"targets: {sorted(_TARGET_ROLES)}")
            return target, role

        cond_node = p.get("cond_stage_config") or {}
        self.cond_stage_target, self.cond_stage_role = _role(
            cond_node, "lvdm.modules.encoders.condition.FrozenOpenCLIPEmbedder")
        self.cond_stage_params = dict(cond_node.get("params", {}) or {})
        img_node = p.get("img_cond_stage_config") or {}
        self.img_cond_stage_target, self.img_cond_stage_role = _role(
            img_node,
            "lvdm.modules.encoders.condition.FrozenOpenCLIPImageEmbedderV2")
        self.resampler = (dict(p["image_proj_stage_config"]["params"])
                          if "image_proj_stage_config" in p else None)
        self.clip_text = dict(p.get("clip_text_config", {}).get("params", {}) or {})
        self.clip_vision = dict(p.get("clip_vision_config", {}).get("params", {}) or {})

    @classmethod
    def from_yaml(cls, path: str) -> "ModelConfig":
        return cls(load_yaml(path))


class SVDConfig:
    """The `model:` node of an sgm `DiffusionEngine` YAML (Stable Video
    Diffusion, `configs/inference_svd_xt.yaml`): the VideoUNet's params, the
    first stage's encoder and `VideoDecoder` params, the conditioner's
    embedders in order as (role, input_key, params), the denoiser's scaling,
    and the sampler's EDM discretization and guider."""

    def __init__(self, model_node: Dict[str, Any]):
        if "model" in model_node:
            model_node = model_node["model"]
        if target_role(model_node.get("target", "")) != "svd_model":
            raise ValueError(f"not an sgm DiffusionEngine node: {model_node.get('target')!r}")
        p = dict(model_node.get("params", {}))
        self.params = p
        self.scale_factor = p.get("scale_factor", 0.18215)

        def node(n: Dict[str, Any], role: str, what: str) -> Dict[str, Any]:
            got = target_role(n.get("target", ""))
            if got != role:
                raise ValueError(f"{what}: target {n.get('target')!r} is not the port's {role}")
            return dict(n.get("params", {}) or {})

        self.unet = node(p["network_config"], "video_unet", "network_config")
        den = p.get("denoiser_config", {}).get("params", {})
        node(den.get("scaling_config", {}), "v_scaling_edm", "denoiser scaling")
        first = node(p["first_stage_config"], "video_vae", "first_stage_config")
        self.encoder = node(first["encoder_config"], "vae_encoder", "encoder_config")
        self.decoder = node(first["decoder_config"], "video_decoder", "decoder_config")
        cond = node(p["conditioner_config"], "conditioner", "conditioner_config")
        self.embedders: List[Tuple[str, str, Dict[str, Any]]] = []
        for e in cond["emb_models"]:
            role = target_role(e.get("target", ""))
            if role not in ("clip_image_prediction", "timestep_vector", "video_encoder_concat"):
                raise ValueError(f"conditioner embedder {e.get('target')!r} is not built")
            self.embedders.append((role, e["input_key"], dict(e.get("params", {}) or {})))
        sampler = node(p.get("sampler_config", {"target": "EulerEDMSampler"}), "euler_edm",
                       "sampler_config")
        disc = node(sampler.get("discretization_config", {"target": "EDMDiscretization"}),
                    "edm_discretization", "discretization_config")
        guider = node(sampler.get("guider_config", {"target": "LinearPredictionGuider"}),
                      "linear_guider", "guider_config")
        self.sigma_min = disc.get("sigma_min", 0.002)
        self.sigma_max = disc.get("sigma_max", 80.0)
        self.rho = disc.get("rho", 7.0)
        self.min_cfg = guider.get("min_scale", 1.0)
        self.max_cfg = guider.get("max_scale", 2.5)
        self.num_frames = guider.get("num_frames", 14)
        self.num_steps = sampler.get("num_steps", 25)
        if sampler.get("s_churn", 0.0):
            raise ValueError("EulerEDMSampler with s_churn > 0 is not built")

    @classmethod
    def from_yaml(cls, path: str) -> "SVDConfig":
        return cls(load_yaml(path))


def is_svd(raw: Dict[str, Any]) -> bool:
    """Whether a parsed YAML is an sgm DiffusionEngine (SVD) configuration."""
    node = raw.get("model", raw) if isinstance(raw, dict) else {}
    return target_role((node or {}).get("target", "")) == "svd_model"


def deep_update(base: Dict[str, Any], extra: Dict[str, Any]) -> Dict[str, Any]:
    """Merge `extra` into `base` recursively (later configs win)."""
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def _node(d: Optional[Dict[str, Any]], *keys: str) -> Dict[str, Any]:
    for k in keys:
        d = (d or {}).get(k)
    return d or {}


class TrainingConfig:
    """The three roots of a reference training YAML (`model:`, `data:`,
    `lightning:`), read with the defaults `scripts/train.py` of the JAX
    package applies. `paths` are merged left to right (the reference's
    `--base a.yaml b.yaml`)."""

    def __init__(self, raw: Dict[str, Any]):
        self.raw = raw
        self.model = ModelConfig(raw)
        model_node = raw.get("model", {})
        self.base_learning_rate = model_node.get("base_learning_rate", 1e-5)
        self.scale_lr = model_node.get("scale_lr", False)
        trainer = _node(raw, "lightning", "trainer")
        self.accumulate_grad_batches = trainer.get("accumulate_grad_batches", 1)
        self.max_steps = trainer.get("max_steps", 100000)
        self.gradient_clip_val = trainer.get("gradient_clip_val", 0.5)
        self.checkpoint = _node(raw, "lightning", "callbacks", "model_checkpoint", "params")
        self.batch_logger = _node(raw, "lightning", "callbacks", "batch_logger", "params")
        data = _node(raw, "data", "params")
        self.batch_size = data.get("batch_size", 1)
        self.num_workers = data.get("num_workers", 4)
        self.train_data = _node(data, "train", "params")
        self.validation_data = _node(data, "validation", "params")

    @classmethod
    def from_yaml(cls, paths: Sequence[str]) -> "TrainingConfig":
        raw: Dict[str, Any] = {}
        for path in ([paths] if isinstance(paths, str) else paths):
            deep_update(raw, load_yaml(path))
        return cls(raw)
