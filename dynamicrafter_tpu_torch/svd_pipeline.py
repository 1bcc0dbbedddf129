"""StableVideoDiffusionPipeline: one still image to a clip with Stable Video
Diffusion (SVD-XT: 25 frames at 576x1024), beside `DynamiCrafterPipeline`.

The sampling path of Stability AI's generative-models
(scripts/sampling/simple_video_sample.py over sgm's `DiffusionEngine`) and
the defaults of diffusers' `StableVideoDiffusionPipeline`:

  * conditioning: the conditioner's embedders in the configuration's order.
    `FrozenOpenCLIPImagePredictionEmbedder`: the OpenCLIP ViT-H/14 tower's
    projected pooled embedding of the image, one token (`crossattn`);
    `VideoPredictionEmbedderWithEncoder`: the KL encoder's mode of the image
    plus cond_aug times Gaussian noise, unscaled (`concat`, repeated over
    the frames); each `ConcatTimestepEmbedderND`: the sinusoidal embedding
    of fps_id, motion_bucket_id or cond_aug, concatenated into `vector`.
    The unconditional pass zeroes crossattn and concat.
  * sampling: `sampling/edm.py`'s Euler steps, each one UNet call on the 2B
    rows of batched CFG ([unconditional, conditional], as sgm and
    diffusers batch them), the v-scaling denoiser around it and a guidance
    scale per frame.
  * decode: the `VideoDecoder` over each clip's frames in one call
    (diffusers' default decode_chunk_size), latents over the scale factor.

As `DynamiCrafterPipeline.sample`: one `request` span, the stages
`conditioning`, `sampler` and `decode` timed and traced by `trace.stage`,
`PipelineOutput`, `init_random(seed)` and `from_checkpoint`. Every random
draw comes from one torch.Generator seeded with `seed`: the conditioning
latent's noise, then x_T; `cond_noise` and `x_T` replace them. The
module names are sgm's (`model.diffusion_model`, `first_stage_model`,
`conditioner.embedders.N`); the released safetensors are not yet mapped
onto them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from dynamicrafter_tpu_torch.config import SVDConfig
from dynamicrafter_tpu_torch.models.clip import CLIPVisionConfig, clip_preprocess
from dynamicrafter_tpu_torch.models.encoders import CLIPVisionPooled
from dynamicrafter_tpu_torch.models.vae import KLModeEncoder, VAEConfig, VideoAutoencoder
from dynamicrafter_tpu_torch.models.video_unet import VideoUNet, VideoUNetConfig
from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
from dynamicrafter_tpu_torch.pipeline import PipelineOutput, _Diffusion
from dynamicrafter_tpu_torch.sampling.edm import (
    edm_sigmas,
    euler_edm_sample,
    frame_scales,
    v_scaling,
)
from dynamicrafter_tpu_torch.schedule import timestep_embedding
from dynamicrafter_tpu_torch.utils import trace
from dynamicrafter_tpu_torch.utils.weights import init_normal_


class ImagePredictionEmbedder(nn.Module):
    """FrozenOpenCLIPImagePredictionEmbedder (n_cond_frames 1, n_copies 1):
    images (B, H, W, 3) in [-1, 1] -> (B, 1, output_dim)."""

    def __init__(self, params: dict):
        super().__init__()
        vision = dict(params.get("clip_vision_config") or {})
        out_dim = vision.pop("output_dim", 1024)
        self.open_clip = CLIPVisionPooled(CLIPVisionConfig(**vision), output_dim=out_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        size = self.open_clip.config.image_size
        return self.open_clip(clip_preprocess(images, size))[:, None]


class TimestepVector(nn.Module):
    """ConcatTimestepEmbedderND: (B,) values -> (B, outdim) [cos | sin]."""

    def __init__(self, params: dict):
        super().__init__()
        self.outdim = params.get("outdim", 256)

    def forward(self, values: torch.Tensor) -> torch.Tensor:
        return timestep_embedding(values, self.outdim)


class EncoderConcat(nn.Module):
    """VideoPredictionEmbedderWithEncoder (is_ae, n_cond_frames 1): the KL
    encoder's mode of (B, H, W, 3) -> (B, h, w, z), unscaled."""

    def __init__(self, params: dict):
        super().__init__()
        self.encoder = KLModeEncoder(VAEConfig.from_dict(params["encoder_config"]["params"]))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)


_EMBEDDERS = {"clip_image_prediction": ImagePredictionEmbedder,
              "timestep_vector": TimestepVector, "video_encoder_concat": EncoderConcat}


class Conditioner(nn.Module):
    """sgm's GeneralConditioner: `embedders` in the configuration's order."""

    def __init__(self, config: SVDConfig):
        super().__init__()
        self.keys = [key for _, key, _ in config.embedders]
        self.embedders = nn.ModuleList(
            [_EMBEDDERS[role](params) for role, _, params in config.embedders])


class SVDEngine(nn.Module):
    """Module container with sgm DiffusionEngine's top-level names."""

    def __init__(self, config: SVDConfig):
        super().__init__()
        self.model = _Diffusion(VideoUNet(VideoUNetConfig.from_dict(config.unet)))
        dec = config.decoder
        self.first_stage_model = VideoAutoencoder(VAEConfig.from_dict(dec),
                                                  dec.get("video_kernel_size", (3, 1, 1)))
        self.conditioner = Conditioner(config)


class SVDConditioning(NamedTuple):
    context: torch.Tensor    # (2B, 1, C): [unconditional (zeros), conditional]
    concat: torch.Tensor     # (2B, h, w, z): [zeros, the image's latent]
    vector: torch.Tensor     # (2B, V): the same for both passes


class StableVideoDiffusionPipeline:
    def __init__(self, config: SVDConfig, device, dtype: torch.dtype = torch.float32):
        """Builds the modules on `device` with uninitialised weights: call
        `init_random` or `load_state_dict` (or use `from_checkpoint`)."""
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        with torch.device("meta"):
            net = SVDEngine(config)
        net = net.to_empty(device=self.device)
        if dtype != torch.float32:
            keep_norms_fp32(net.to(dtype))
        self.net = net.eval().requires_grad_(False)
        self.unet = net.model.diffusion_model
        self.vae = net.first_stage_model
        self.conditioner = net.conditioner

    def init_random(self, seed: int = 0, std: float = 0.02) -> None:
        """Smoke weights: every tensor from N(0, std^2), drawn on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init_normal_(self.net, gen, std)

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        self.net.load_state_dict(sd, strict=True)

    @classmethod
    def from_checkpoint(cls, config_path: str, ckpt_path: str, device,
                        dtype: torch.dtype = torch.float32) -> "StableVideoDiffusionPipeline":
        """A pipeline with the weights of a state dict under this module
        tree's names (`torch.save(pipe.net.state_dict())`)."""
        pipe = cls(SVDConfig.from_yaml(config_path), device, dtype)
        pipe.load_state_dict(torch.load(ckpt_path, map_location="cpu", weights_only=True))
        return pipe

    @torch.no_grad()
    def build_conditioning(self, images: torch.Tensor, cond_noise: torch.Tensor,
                           values: Dict[str, float]) -> SVDConditioning:
        """images (B, H, W, 3) in [-1, 1]; cond_noise like images; values:
        fps_id, motion_bucket_id and cond_aug (the noise's scale)."""
        b = images.shape[0]
        crossattn = concat = None
        vector = []
        for key, emb in zip(self.conditioner.keys, self.conditioner.embedders):
            if isinstance(emb, ImagePredictionEmbedder):
                with trace.span("clip_vision", rows=b):
                    crossattn = emb(images)
            elif isinstance(emb, EncoderConcat):
                with trace.span("vae_encode", frames=b):
                    concat = emb(images + values["cond_aug"] * cond_noise).float()
            else:
                v = torch.full((b,), float(values[key]), dtype=torch.float32, device=self.device)
                vector.append(emb(v))
        vec = torch.cat(vector, dim=-1)
        return SVDConditioning(context=torch.cat([torch.zeros_like(crossattn), crossattn]),
                               concat=torch.cat([torch.zeros_like(concat), concat]),
                               vector=torch.cat([vec, vec]))

    @torch.no_grad()
    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, T, h, w, c) -> frames (B, T, H, W, 3) fp32, each clip's
        frames in one decoder call."""
        return self.vae.decode(z / self.config.scale_factor).float()

    @torch.no_grad()
    def sample(self, images: np.ndarray, *, frames: Optional[int] = None,
               steps: Optional[int] = None, min_cfg: Optional[float] = None,
               max_cfg: Optional[float] = None, fps_id: int = 6, motion_bucket_id: int = 127,
               cond_aug: float = 0.02, seed: int = 23, x_T: Optional[np.ndarray] = None,
               cond_noise: Optional[np.ndarray] = None, timings: Optional[dict] = None,
               peaks: Optional[dict] = None) -> PipelineOutput:
        """Image-to-video synthesis. images: (B, H, W, 3) in [-1, 1].
        `frames`, `steps`, `min_cfg` and `max_cfg` default to the
        configuration's guider and sampler. x_T (B, T, h, w, z) is the
        sampler's N(0, 1) draw before its scaling; cond_noise (B, H, W, 3).
        `timings` and `peaks` as in `DynamiCrafterPipeline.sample` (stages
        `conditioning`, `sampler`, `decode`). Returns PipelineOutput with
        videos (B, 1, T, H, W, 3) and latents (B, 1, T, h, w, z)."""
        cfg = self.config
        frames = frames or cfg.num_frames
        steps = steps or cfg.num_steps
        min_cfg = cfg.min_cfg if min_cfg is None else min_cfg
        max_cfg = cfg.max_cfg if max_cfg is None else max_cfg
        with trace.span("request", sampler="euler_edm", steps=steps, batch=len(images)):
            dev = self.device
            stage = lambda name: trace.stage(name, timings, dev, peaks)
            gen = torch.Generator(device=dev).manual_seed(seed)
            on_dev = lambda a: None if a is None else torch.tensor(
                np.asarray(a, dtype=np.float32), device=dev)
            imgs = on_dev(images)
            b, hh, ww, _ = imgs.shape
            f = 2 ** (len(self.vae.config.ch_mult) - 1)
            lat_shape = (b, frames, hh // f, ww // f, self.vae.config.z_channels)

            with stage("conditioning"):
                noise = on_dev(cond_noise)
                if noise is None:
                    noise = torch.randn(imgs.shape, generator=gen, device=dev)
                cond = self.build_conditioning(imgs, noise, {
                    "fps_id": fps_id, "motion_bucket_id": motion_bucket_id,
                    "cond_aug": cond_aug})
            concat = cond.concat[:, None].expand(-1, frames, -1, -1, -1)

            def model(x: torch.Tensor, sigma: float):
                c_skip, c_out, c_in, c_noise = v_scaling(sigma)
                xin = torch.cat([(x * c_in).repeat(2, 1, 1, 1, 1), concat], dim=-1)
                ts = torch.full((2 * b,), c_noise, dtype=torch.float32, device=dev)
                out = self.unet(xin, ts, cond.context, cond.vector).float()
                d = out * c_out + x.repeat(2, 1, 1, 1, 1) * c_skip
                return d[:b], d[b:]

            with stage("sampler"):
                xt = on_dev(x_T)
                if xt is None:
                    xt = torch.randn(lat_shape, generator=gen, device=dev)
                z = euler_edm_sample(model, xt, edm_sigmas(steps, cfg.sigma_min, cfg.sigma_max,
                                                           cfg.rho),
                                     frame_scales(frames, min_cfg, max_cfg))
            with stage("decode"):
                videos = self.decode_latents(z).cpu().numpy()
            return PipelineOutput(videos=videos[:, None], latents=z[:, None].cpu().numpy())
