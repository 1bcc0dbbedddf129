"""Export a fine-tuned model as a reference-format checkpoint.

    python -m dynamicrafter_tpu_torch.export_checkpoint \
        --config configs/training_512_v1.0.yaml \
        --params <logdir>/<name>/checkpoints/step_<n>.pt \
        --base model.ckpt [--ema] --out exported/model.ckpt

The counterpart of the JAX package's `scripts/export_checkpoint.py`. A
training checkpoint (`Trainer.state_dict()`, written by `train.py`) holds
the trainable tensors alone (the UNet and, when trained, the Resampler)
under reference checkpoint keys, beside the optimizer and EMA state. This
merges the online weights, or with --ema the EMA weights, over the
state_dict of a donor checkpoint (the released .ckpt the fine-tune started
from: it supplies the frozen VAE and CLIP towers, the schedule buffers and
the keys the port never builds) and writes `{"state_dict": ...}` in fp32
with `torch.save`: what `inference.py --ckpt_path`, `app.py` and the
reference's own code load. A learned `logvar` table is not a model weight
and is skipped, as `training.checkpoints.load_trained_weights` skips it.
A tensor whose key or shape the donor does not hold is an error. Without
--base the file holds the trainable tensors alone, checked against the
model `--config` builds; a strict load then needs a donor.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

# reference key prefix -> name of the trainable component, for the summary line
_COMPONENTS = {"model.diffusion_model.": "unet", "image_proj_model.": "resampler"}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.export_checkpoint",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="model YAML (reference schema)")
    p.add_argument("--params", required=True,
                   help="a training checkpoint step_<n>.pt written by train.py")
    p.add_argument("--base", default=None,
                   help="donor checkpoint (.ckpt) to merge over: required for a "
                        "checkpoint that loads strictly (frozen towers + schedule buffers)")
    p.add_argument("--out", required=True, help="output .ckpt path")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA weights instead of the online ones "
                        "(the reference's ema_scope evaluation weights)")
    return p


def _model_shapes(config_path: str) -> Dict[str, torch.Size]:
    """Reference key -> shape of every tensor of the model `config_path`
    builds (on the meta device: no memory, no weights)."""
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import LatentVisualDiffusion

    with torch.device("meta"):
        net = LatentVisualDiffusion(ModelConfig.from_yaml(config_path))
    return {k: v.shape for k, v in net.state_dict().items()}


def export(weights: Dict[str, torch.Tensor], reference: Dict[str, torch.Size],
           base_sd: Optional[Dict[str, torch.Tensor]] = None,
           against: str = "donor") -> Dict[str, torch.Tensor]:
    """`weights` merged over `base_sd` (or alone), fp32: every key but
    `logvar` must name a tensor of `reference`'s shape."""
    weights = {k: v for k, v in weights.items() if k != "logvar"}
    unknown = sorted(k for k in weights if k not in reference)
    if unknown:
        raise KeyError(f"checkpoint keys not in the {against}: {unknown[:10]} "
                       f"({len(unknown)})")
    for k, v in weights.items():
        if tuple(v.shape) != tuple(reference[k]):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != {against} shape "
                             f"{tuple(reference[k])}")
    out = dict(base_sd or {})
    out.update(weights)
    return {k: (v.detach().float() if v.is_floating_point() else v).contiguous()
            for k, v in out.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """Write the exported checkpoint; returns its state_dict."""
    args = get_parser().parse_args(argv)
    from dynamicrafter_tpu_torch.utils.weights import normalize_state_dict

    # mapped: of the training checkpoint only the exported weights are read,
    # not the optimizer state beside them
    state = torch.load(args.params, map_location="cpu", weights_only=True, mmap=True)
    if args.ema:
        if state.get("ema") is None:
            raise SystemExit("--ema: checkpoint has no EMA shadow params")
        weights = state["ema"]
    else:
        weights = state["weights"]

    if args.base:
        base_sd = normalize_state_dict(
            torch.load(args.base, map_location="cpu", weights_only=True))
        sd = export(weights, {k: v.shape for k, v in base_sd.items()}, base_sd)
    else:
        sd = export(weights, _model_shapes(args.config), against="model of --config")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"state_dict": sd}, args.out)
    comps = ", ".join(sorted({name for k in weights if k != "logvar"
                              for prefix, name in _COMPONENTS.items()
                              if k.startswith(prefix)}))
    print(f"exported {'EMA ' if args.ema else ''}[{comps}] ({len(sd)} keys"
          f"{', merged over ' + args.base if args.base else ''}) -> {args.out}")
    if not args.base:
        print("no --base: the file holds the trainable tensors alone; a strict load "
              "(inference --ckpt_path) needs them merged over a donor checkpoint")
    return sd


if __name__ == "__main__":
    main()
