"""DynamiCrafterPipeline: the end-to-end image-to-video orchestrator.

Call path of the reference (scripts/evaluation/inference.py:216-313) and of
the JAX twin dynamicrafter_tpu/pipeline.py: embed the conditioning image
into Resampler tokens, embed the prompt, VAE-encode the conditioning frames,
assemble the hybrid conditioning with the CFG unconditional passes, run the
DDIM loop, decode the latents frame by frame.

All modules live in one `LatentVisualDiffusion` container whose state_dict
keys are the released checkpoint's. Every entry point takes an explicit
device; every random draw comes from an explicit torch.Generator.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from dynamicrafter_tpu_torch import schedule as sched_lib
from dynamicrafter_tpu_torch.config import ModelConfig
from dynamicrafter_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    CLIPVisionConfig,
    CLIPVisionEncoder,
    clip_preprocess,
)
from dynamicrafter_tpu_torch.models.resampler import Resampler, ResamplerConfig
from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
from dynamicrafter_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian, VAEConfig
from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
from dynamicrafter_tpu_torch.sampling.ddim import (
    CFGConditioning,
    SamplerSettings,
    ddim_sample,
    make_cfg_denoiser,
)
from dynamicrafter_tpu_torch.utils.tokenizer import HashTokenizer, default_tokenizer
from dynamicrafter_tpu_torch.utils.weights import init_normal_, load_reference_state_dict


@dataclasses.dataclass
class PipelineOutput:
    videos: np.ndarray   # (B, 1, T, H, W, 3) float32 in [-1, 1]


def _text_config(config: ModelConfig) -> CLIPTextConfig:
    kwargs = dict(config.clip_text)
    kwargs.setdefault("penultimate",
                      config.cond_stage_params.get("layer", "penultimate") == "penultimate")
    return CLIPTextConfig(**kwargs)


class _Diffusion(nn.Module):
    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


class LatentVisualDiffusion(nn.Module):
    """Module container with the reference checkpoint's top-level names."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.cond_stage_role != "clip_text" or config.img_cond_stage_role != "clip_vision":
            raise NotImplementedError(
                "only the OpenCLIP text/vision conditioning of the shipped "
                f"configs is ported (got {config.cond_stage_target!r}, "
                f"{config.img_cond_stage_target!r})")
        if config.resampler is None:
            raise NotImplementedError("ImageProjModel conditioning is not ported yet")
        self.model = _Diffusion(UNetModel(UNetConfig.from_dict(config.unet)))
        self.first_stage_model = AutoencoderKL(VAEConfig.from_dict(config.vae))
        self.cond_stage_model = CLIPTextEncoder(_text_config(config))
        self.embedder = CLIPVisionEncoder(CLIPVisionConfig(**config.clip_vision))
        self.image_proj_model = Resampler(ResamplerConfig.from_dict(config.resampler))


class DynamiCrafterPipeline:
    def __init__(self, config: ModelConfig, device, dtype: torch.dtype = torch.float32,
                 tokenizer=None):
        """Builds the modules on `device` with uninitialised weights: call
        `init_random` or `load_state_dict` (or use `from_checkpoint`)."""
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        self.dtype = dtype
        with torch.device("meta"):
            net = LatentVisualDiffusion(config)
        net = net.to_empty(device=self.device)
        if dtype != torch.float32:
            keep_norms_fp32(net.to(dtype))
        self.net = net.eval().requires_grad_(False)
        self.unet = net.model.diffusion_model
        self.vae = net.first_stage_model
        self.text_encoder = net.cond_stage_model
        self.vision_encoder = net.embedder
        self.resampler = net.image_proj_model
        self.unet_config = self.unet.config
        self.vae_config = self.vae.config
        self.tokenizer = tokenizer if tokenizer is not None else default_tokenizer()
        self.schedule = sched_lib.build_schedule(
            timesteps=config.timesteps, beta_schedule=config.beta_schedule,
            linear_start=config.linear_start, linear_end=config.linear_end,
            cosine_s=config.cosine_s, parameterization=config.parameterization,
            rescale_betas_zero_snr=config.rescale_betas_zero_snr,
            use_dynamic_rescale=config.use_dynamic_rescale,
            base_scale=config.base_scale, turning_step=config.turning_step)

    @classmethod
    def for_training(cls, config: ModelConfig, device,
                     frozen_dtype: torch.dtype = torch.bfloat16, tokenizer=None,
                     train_resampler: bool = True) -> "DynamiCrafterPipeline":
        """The training construction (JAX `scripts/train.py` with
        `cast_storage=False`): the UNet, and the Resampler when
        `train_resampler`, stay fp32 and require gradients (they are the
        optimizer's master weights; compute dtype comes from autocast);
        the frozen VAE and CLIP towers are stored in `frozen_dtype` with fp32
        norms and require none. Weights are uninitialised, as in __init__."""
        pipe = cls(config, device, torch.float32, tokenizer)
        frozen = [pipe.vae, pipe.text_encoder, pipe.vision_encoder]
        if not train_resampler:
            frozen.append(pipe.resampler)
        if frozen_dtype != torch.float32:
            for m in frozen:
                keep_norms_fp32(m.to(frozen_dtype))
        pipe.unet.requires_grad_(True)
        if train_resampler:
            pipe.resampler.requires_grad_(True)
        return pipe

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    def init_random(self, seed: int = 0, std: float = 0.02) -> None:
        """Smoke weights: every tensor from N(0, std^2), drawn on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init_normal_(self.net, gen, std)

    def load_state_dict(self, sd) -> None:
        load_reference_state_dict(self, sd)

    def load_checkpoint(self, ckpt_path: str) -> None:
        """Load a released checkpoint (plain, 256-model or deepspeed format)."""
        from dynamicrafter_tpu.utils.weights import normalize_state_dict

        self.load_state_dict(normalize_state_dict(
            torch.load(ckpt_path, map_location="cpu", weights_only=True)))

    @classmethod
    def from_checkpoint(cls, config_path: str, ckpt_path: str, device,
                        dtype: torch.dtype = torch.float32, tokenizer=None,
                        allow_hash_tokenizer: bool = False) -> "DynamiCrafterPipeline":
        """A pipeline with the weights of a released checkpoint."""
        pipe = cls(ModelConfig.from_yaml(config_path), device, dtype, tokenizer)
        if isinstance(pipe.tokenizer, HashTokenizer) and not allow_hash_tokenizer:
            raise FileNotFoundError(
                "a real checkpoint needs the CLIP BPE vocab (the tokenizer fell "
                "back to HashTokenizer): pass tokenizer= or --vocab_path")
        pipe.load_checkpoint(ckpt_path)
        return pipe

    # ------------------------------------------------------------------
    # stages
    # ------------------------------------------------------------------

    @torch.no_grad()
    def embed_text(self, prompts: Sequence[str]) -> torch.Tensor:
        tokens = torch.tensor(np.asarray(self.tokenizer(list(prompts))),
                              dtype=torch.long, device=self.device)
        return self.text_encoder(tokens)

    @torch.no_grad()
    def embed_image_ctx(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) in [-1, 1] -> (B, T, Q, ctx_dim)."""
        px = clip_preprocess(images, self.vision_encoder.config.image_size)
        ctx = self.resampler(self.vision_encoder(px))
        t = self.resampler.config.video_length or 1
        return ctx.reshape(ctx.shape[0], t, -1, ctx.shape[-1])

    @property
    def _latent_factor(self) -> int:
        return 2 ** (len(self.vae_config.ch_mult) - 1)

    @torch.no_grad()
    def encode_video(self, video: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """video: (B, T, H, W, 3) in [-1, 1]; noise: (B*T, h, w, z) fp32 ->
        latents (B, T, h, w, z) fp32 (posterior sample times scale_factor),
        one frame at a time when the config sets perframe_ae."""
        b, t, h, w, _ = video.shape
        flat = video.reshape(b * t, h, w, 3)
        step = 1 if self.config.perframe_ae else b * t
        zs = []
        for i in range(0, b * t, step):
            moments = self.vae.encode_moments(flat[i:i + step]).float()
            zs.append(DiagonalGaussian(moments).sample(noise[i:i + step].float()))
        z = torch.cat(zs) * self.config.scale_factor
        return z.reshape(b, t, *z.shape[1:])

    @torch.no_grad()
    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, T, h, w, c) -> frames (B, T, H, W, 3) fp32, one frame at a
        time when the config sets perframe_ae."""
        b, t = z.shape[:2]
        flat = z.reshape(b * t, *z.shape[2:]) / self.config.scale_factor
        step = 1 if self.config.perframe_ae else b * t
        out = torch.cat([self.vae.decode(flat[i:i + step]).float()
                         for i in range(0, b * t, step)])
        return out.reshape(b, t, *out.shape[1:])

    @torch.no_grad()
    def build_conditioning(self, prompts: Sequence[str], videos: torch.Tensor,
                           encode_noise: torch.Tensor, *, cfg_scale: float = 7.5,
                           fs: Optional[Sequence[int]] = None) -> CFGConditioning:
        """Two-pass CFG conditioning [uncond, cond] (one pass when
        cfg_scale == 1), with the first frame's latent repeated over T as
        the hybrid concat (inference.py:238-276)."""
        b = videos.shape[0]
        img = videos[:, 0]
        img_ctx = self.embed_image_ctx(img)
        text_ctx = self.embed_text(prompts)
        z = self.encode_video(videos, encode_noise)
        cc = z[:, :1].expand(z.shape)
        passes_text, passes_img = [text_ctx], [img_ctx]
        if cfg_scale != 1.0:
            if self.config.uncond_type == "empty_seq":
                uc_text = self.embed_text([""] * b)
            else:
                uc_text = torch.zeros_like(text_ctx)
            uc_img = self.embed_image_ctx(torch.zeros_like(img))
            passes_text, passes_img = [uc_text, text_ctx], [uc_img, img_ctx]
        p = len(passes_text)
        fs_t = None
        if self.unet_config.fs_condition:
            fs_t = torch.as_tensor(list(fs) if fs is not None
                                   else [self.unet_config.default_fs] * b,
                                   dtype=torch.long, device=self.device)
        return CFGConditioning(
            context_text=torch.stack(passes_text),
            context_img=torch.stack(passes_img),
            concat=cc.unsqueeze(0).expand(p, *cc.shape),
            fs=fs_t)

    @torch.no_grad()
    def sample(self, prompts: Sequence[str], videos: np.ndarray, *, steps: int = 50,
               cfg_scale: float = 7.5, eta: float = 1.0,
               timestep_spacing: str = "uniform", guidance_rescale: float = 0.0,
               fs: Optional[Sequence[int]] = None, seed: int = 123,
               x_T: Optional[np.ndarray] = None,
               encode_noise: Optional[np.ndarray] = None, decode: bool = True,
               timings: Optional[dict] = None):
        """Image-guided synthesis, one sample per prompt. videos:
        (B, T, H, W, 3) in [-1, 1].

        Random draws come from one torch.Generator seeded with `seed`, in
        this order: the VAE encode noise, x_T, the DDIM step noise.
        `encode_noise` (B*T, h, w, z) and `x_T` (B, T, h, w, z) replace their
        draws, so a test can feed the JAX pipeline's numbers. `timings`, when
        given, receives the seconds of each stage (synchronised on the
        device).

        Returns PipelineOutput, or the latents (B, 1, T, h, w, z) as numpy
        when decode=False (the JAX pipeline's layout, n_samples = 1)."""
        dev = self.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        clock = {} if timings is None else timings
        gen = torch.Generator(device=dev).manual_seed(seed)
        vids = torch.tensor(np.asarray(videos, dtype=np.float32), device=dev)
        b, t, hh, ww, _ = vids.shape
        f = self._latent_factor
        lat_shape = (b, t, hh // f, ww // f, self.vae_config.z_channels)

        t0 = time.perf_counter()
        if encode_noise is None:
            enc = torch.randn((b * t, *lat_shape[2:]), generator=gen, device=dev)
        else:
            enc = torch.tensor(np.asarray(encode_noise, dtype=np.float32), device=dev)
        cond = self.build_conditioning(prompts, vids, enc, cfg_scale=cfg_scale, fs=fs)
        sync()
        clock["conditioning"] = time.perf_counter() - t0

        settings = SamplerSettings(
            steps=steps, discretize=timestep_spacing, eta=eta, cfg_scale=cfg_scale,
            guidance_rescale=guidance_rescale,
            parameterization=self.config.parameterization)
        table = sched_lib.build_ddim_table(self.schedule, num_steps=steps,
                                           discretize=timestep_spacing, eta=eta)
        t0 = time.perf_counter()
        if x_T is None:
            xt = torch.randn(lat_shape, generator=gen, device=dev)
        else:
            xt = torch.tensor(np.asarray(x_T, dtype=np.float32), device=dev)
        z = ddim_sample(make_cfg_denoiser(self.unet, cond, settings), xt, self.schedule,
                        table, settings, generator=gen)
        sync()
        clock["ddim"] = time.perf_counter() - t0
        if not decode:
            return z[:, None].cpu().numpy()
        t0 = time.perf_counter()
        frames = self.decode_latents(z)
        sync()
        clock["decode"] = time.perf_counter() - t0
        return PipelineOutput(videos=frames[:, None].cpu().numpy())
