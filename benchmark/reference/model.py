"""The reference DynamiCrafter, float32: every module under the released
checkpoint's top-level names, built from a configuration file of
`benchmark/configs/`, and the stages the correctness check recomputes.

Nothing here imports the program. Weights come from `benchmark.weights`,
drawn from the seed exactly as the program's are.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from benchmark.reference.clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    CLIPVisionConfig,
    CLIPVisionEncoder,
    clip_preprocess,
)
from benchmark.reference.resampler import Resampler, ResamplerConfig
from benchmark.reference.unet3d import UNetConfig, UNetModel
from benchmark.reference.vae import AutoencoderKL, DiagonalGaussian, VAEConfig, decode_tiled


def model_params(config: dict) -> dict:
    """The `model.params` node of a configuration file."""
    return config["model"]["params"]


class _Diffusion(nn.Module):
    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


class ReferenceModel(nn.Module):
    """model.diffusion_model, first_stage_model, cond_stage_model, embedder,
    image_proj_model: the checkpoint's module tree."""

    def __init__(self, config: dict):
        super().__init__()
        p = model_params(config)
        layer = (p.get("cond_stage_config") or {}).get("params", {}).get("layer", "penultimate")
        self.model = _Diffusion(UNetModel(UNetConfig.from_dict(p["unet_config"]["params"])))
        self.first_stage_model = AutoencoderKL(VAEConfig.from_dict(
            p["first_stage_config"]["params"]))
        text = dict((p.get("clip_text_config") or {}).get("params") or {})
        text.setdefault("penultimate", layer == "penultimate")
        self.cond_stage_model = CLIPTextEncoder(CLIPTextConfig(**text))
        self.embedder = CLIPVisionEncoder(CLIPVisionConfig(
            **((p.get("clip_vision_config") or {}).get("params") or {})))
        self.image_proj_model = Resampler(ResamplerConfig.from_dict(
            p["image_proj_stage_config"]["params"]))
        self.scale_factor = float(p.get("scale_factor", 0.18215))

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    # the conditioning stage
    def embed_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.cond_stage_model(tokens)

    def embed_image(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [-1, 1] -> per-frame context (B, T, Q, C)."""
        px = clip_preprocess(images, self.embedder.config.image_size)
        ctx = self.image_proj_model(self.embedder(px))
        t = self.image_proj_model.config.video_length or 1
        return ctx.reshape(ctx.shape[0], t, -1, ctx.shape[-1])

    def encode(self, frames: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """frames (N, H, W, 3), noise (N, h, w, z) -> scaled posterior samples."""
        moments = self.first_stage_model.encode_moments(frames)
        return DiagonalGaussian(moments).sample(noise) * self.scale_factor

    def decode(self, z: torch.Tensor, tile: int) -> torch.Tensor:
        """z (N, h, w, c) -> frames (N, H, W, 3): one frame at a time, or in
        `tile` x `tile` latent tiles blended over 8 rows where a side is
        longer than `tile`."""
        vae = self.first_stage_model
        scale = 2 ** (len(vae.config.ch_mult) - 1)
        z = z / self.scale_factor
        if max(z.shape[1:3]) > tile:
            return torch.cat([decode_tiled(vae.decode, z[i:i + 1], tile=tile, overlap=8,
                                           scale=scale) for i in range(z.shape[0])])
        return torch.cat([vae.decode(z[i:i + 1]) for i in range(z.shape[0])])


def build(config: dict, device, sd: Dict[str, torch.Tensor]) -> ReferenceModel:
    """The reference on `device` in float32 with the weights `sd`."""
    with torch.device("meta"):
        ref = ReferenceModel(config)
    ref = ref.to_empty(device=device).float()
    ref.load_state_dict(sd, strict=True)
    return ref.eval().requires_grad_(False)


def param_shapes(config: dict) -> Sequence:
    """(name, shape) of every weight, in the order `benchmark.weights` draws them."""
    with torch.device("meta"):
        ref = ReferenceModel(config)
    return [(k, tuple(v.shape)) for k, v in ref.state_dict().items()]
