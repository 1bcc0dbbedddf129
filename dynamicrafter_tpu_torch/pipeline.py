"""DynamiCrafterPipeline: the end-to-end image-to-video orchestrator.

Call path of the reference (scripts/evaluation/inference.py:216-313) and of
the JAX twin dynamicrafter_tpu/pipeline.py: embed the conditioning image
into Resampler tokens, embed the prompt, VAE-encode the conditioning frames,
assemble the hybrid conditioning with the CFG unconditional passes, run the
DDIM loop, decode the latents (all frames at once, frame by frame, or in
spatial tiles above `tiled_vae_threshold`).

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
from dynamicrafter_tpu_torch.models.encoders import HFCLIPTextConfig, HFCLIPTextEncoder
from dynamicrafter_tpu_torch.models.resampler import Resampler, ResamplerConfig
from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
from dynamicrafter_tpu_torch.models.vae import (
    AutoencoderKL,
    DiagonalGaussian,
    VAEConfig,
    decode_tiled,
)
from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
from dynamicrafter_tpu_torch.sampling.ddim import (
    CFGConditioning,
    SamplerSettings,
    ddim_sample,
    make_cfg_denoiser,
)
from dynamicrafter_tpu_torch.sampling.dpm import dpm_sample
from dynamicrafter_tpu_torch.sampling.unipc import unipc_sample
from dynamicrafter_tpu_torch.utils.tokenizer import HashTokenizer, default_tokenizer
from dynamicrafter_tpu_torch.utils.weights import (
    init_normal_,
    load_reference_state_dict,
    normalize_state_dict,
)


@dataclasses.dataclass
class PipelineOutput:
    videos: np.ndarray   # (B, n_samples, T, H, W, 3) float32 in [-1, 1]
    # decoded DDIM intermediates (n_logs + 1, B, T, H, W, 3), with log_every_t
    denoise_rows: Optional[np.ndarray] = None


def _text_config(config: ModelConfig) -> CLIPTextConfig:
    kwargs = dict(config.clip_text)
    kwargs.setdefault("penultimate",
                      config.cond_stage_params.get("layer", "penultimate") == "penultimate")
    return CLIPTextConfig(**kwargs)


def _hf_text_config(config: ModelConfig) -> HFCLIPTextConfig:
    """FrozenCLIPEmbedder's knobs: `layer` and `layer_idx` from the
    cond_stage_config, the widths from clip_text_config."""
    kwargs = dict(config.clip_text)
    kwargs.pop("penultimate", None)   # an open_clip knob
    kwargs.setdefault("layer", config.cond_stage_params.get("layer", "last"))
    kwargs.setdefault("layer_idx", config.cond_stage_params.get("layer_idx"))
    return HFCLIPTextConfig(**kwargs)


class _FrozenCLIPEmbedder(nn.Module):
    """FrozenCLIPEmbedder's checkpoint layout: the HF text model under
    `transformer.` (condition.py:209-252)."""

    def __init__(self, config: HFCLIPTextConfig):
        super().__init__()
        self.config = config
        self.transformer = HFCLIPTextEncoder(config)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)


class _Diffusion(nn.Module):
    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


class LatentVisualDiffusion(nn.Module):
    """Module container with the reference checkpoint's top-level names."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.cond_stage_role == "clip_text":
            text_encoder = CLIPTextEncoder(_text_config(config))
        elif config.cond_stage_role == "clip_text_hf":
            text_encoder = _FrozenCLIPEmbedder(_hf_text_config(config))
        else:
            raise ValueError(
                f"text conditioning target {config.cond_stage_target!r} (role "
                f"{config.cond_stage_role!r}) is implemented in models/encoders.py but "
                "has no UNet context contract in the DynamiCrafter i2v pipeline (same "
                "in the reference).")
        if config.img_cond_stage_role != "clip_vision":
            raise ValueError(
                f"image conditioning target {config.img_cond_stage_target!r} is "
                "implemented (models/encoders.py::CLIPVisionPooled) but the 3D UNet's "
                "per-frame context split needs the all-tokens "
                "FrozenOpenCLIPImageEmbedderV2 + Resampler pair: a pooled embedder "
                "cannot produce the (T, 16, C) image context (the reference has the "
                "same shape contract, openaimodel3d.py:556).")
        if config.resampler is None:
            raise ValueError(
                "the pipeline needs an image_proj_stage_config (the Resampler): the "
                "UNet's per-frame image context comes from it")
        self.model = _Diffusion(UNetModel(UNetConfig.from_dict(config.unet)))
        self.first_stage_model = AutoencoderKL(VAEConfig.from_dict(config.vae))
        self.cond_stage_model = text_encoder
        self.embedder = CLIPVisionEncoder(CLIPVisionConfig(**config.clip_vision))
        self.image_proj_model = Resampler(ResamplerConfig.from_dict(config.resampler))


class DynamiCrafterPipeline:
    def __init__(self, config: ModelConfig, device, dtype: torch.dtype = torch.float32,
                 tokenizer=None, tiled_vae_threshold: int = 64,
                 vocab_path: Optional[str] = None):
        """Builds the modules on `device` with uninitialised weights: call
        `init_random` or `load_state_dict` (or use `from_checkpoint`).
        Latents wider or taller than `tiled_vae_threshold` are decoded in
        tiles of that size. Without `tokenizer` the default one is built from
        `vocab_path`, padding as the text encoder's own tokenizer pads: HF's
        CLIPTokenizer with the end-of-text id (pad positions show in the
        unmasked outputs of the FrozenCLIPEmbedder role), open_clip's with 0."""
        self.config = config
        self.tiled_vae_threshold = tiled_vae_threshold
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
        if tokenizer is None:
            pad = (self.text_encoder.config.eos_token_id
                   if config.cond_stage_role == "clip_text_hf" else 0)
            tokenizer = default_tokenizer(vocab_path, pad_id=pad)
        self.tokenizer = tokenizer
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
                     train_resampler: bool = True,
                     vocab_path: Optional[str] = None) -> "DynamiCrafterPipeline":
        """The training construction (JAX `scripts/train.py` with
        `cast_storage=False`): the UNet, and the Resampler when
        `train_resampler`, stay fp32 and require gradients (they are the
        optimizer's master weights; compute dtype comes from autocast);
        the frozen VAE and CLIP towers are stored in `frozen_dtype` with fp32
        norms and require none. Weights are uninitialised, as in __init__."""
        pipe = cls(config, device, torch.float32, tokenizer, vocab_path=vocab_path)
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
        self.load_state_dict(normalize_state_dict(
            torch.load(ckpt_path, map_location="cpu", weights_only=True)))

    @classmethod
    def from_checkpoint(cls, config_path: str, ckpt_path: str, device,
                        dtype: torch.dtype = torch.float32, tokenizer=None,
                        allow_hash_tokenizer: bool = False,
                        vocab_path: Optional[str] = None) -> "DynamiCrafterPipeline":
        """A pipeline with the weights of a released checkpoint."""
        pipe = cls(ModelConfig.from_yaml(config_path), device, dtype, tokenizer,
                   vocab_path=vocab_path)
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
    def decode_latents(self, z: torch.Tensor, perframe: Optional[bool] = None,
                       tiled: Optional[bool] = None) -> torch.Tensor:
        """z: (B, T, h, w, c) -> frames (B, T, H, W, 3) fp32. In tiles when
        `tiled` (default: a latent side above `tiled_vae_threshold`), else
        one frame at a time when `perframe` (default: the config's
        perframe_ae), else all frames in one call: the JAX pipeline's order
        of precedence."""
        b, t, h, w, _ = z.shape
        if perframe is None:
            perframe = self.config.perframe_ae
        if tiled is None:
            tiled = max(h, w) > self.tiled_vae_threshold
        flat = z.reshape(b * t, *z.shape[2:]) / self.config.scale_factor
        if tiled:
            out = decode_tiled(self.vae.decode, flat, tile=self.tiled_vae_threshold,
                               overlap=8, scale=self._latent_factor)
        else:
            step = 1 if perframe else b * t
            out = torch.cat([self.vae.decode(flat[i:i + step]).float()
                             for i in range(0, b * t, step)])
        return out.reshape(b, t, *out.shape[1:])

    @torch.no_grad()
    def build_conditioning(self, prompts: Sequence[str], videos: torch.Tensor,
                           encode_noise: torch.Tensor, *, cfg_scale: float = 7.5,
                           multiple_cond_cfg: bool = False,
                           cfg_img: Optional[float] = None,
                           loop_or_interp: bool = False,
                           fs: Optional[Sequence[int]] = None,
                           negative_prompt: str = "") -> CFGConditioning:
        """The CFG conditioning (reference inference.py:238-276): passes
        [uncond, cond], or [uncond, uncond_img (no text, real image), cond]
        with `multiple_cond_cfg`, or the one conditional pass when cfg_scale
        == 1. The hybrid concat is the first frame's latent repeated over T,
        or with `loop_or_interp` the first and last frames' latents with
        zeros between. `negative_prompt` is the unconditional text."""
        b = videos.shape[0]
        img = videos[:, 0]
        img_ctx = self.embed_image_ctx(img)
        text_ctx = self.embed_text(prompts)
        z = self.encode_video(videos, encode_noise)
        if loop_or_interp:
            cc = torch.zeros_like(z)
            cc[:, 0], cc[:, -1] = z[:, 0], z[:, -1]
        else:
            cc = z[:, :1].expand(z.shape)
        passes_text, passes_img = [text_ctx], [img_ctx]
        if cfg_scale != 1.0:
            if self.config.uncond_type == "empty_seq":
                uc_text = self.embed_text([negative_prompt] * b)
            else:
                uc_text = torch.zeros_like(text_ctx)
            uc_img = self.embed_image_ctx(torch.zeros_like(img))
            if multiple_cond_cfg and (cfg_img or cfg_scale) != 1.0:
                passes_text = [uc_text, uc_text, text_ctx]
                passes_img = [uc_img, img_ctx, img_ctx]
            else:
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
               cfg_scale: float = 7.5, cfg_img: Optional[float] = None,
               multiple_cond_cfg: bool = False, eta: float = 1.0,
               timestep_spacing: str = "uniform", guidance_rescale: float = 0.0,
               fs: Optional[Sequence[int]] = None, loop_or_interp: bool = False,
               n_samples: int = 1, seed: int = 123,
               x_T: Optional[np.ndarray] = None,
               encode_noise: Optional[np.ndarray] = None, decode: bool = True,
               negative_prompt: str = "", sequential_cfg: bool = False,
               mask: Optional[np.ndarray] = None,
               x0_latents: Optional[np.ndarray] = None,
               log_every_t: Optional[int] = None, deepcache: int = 1,
               sampler: str = "ddim", solver_order: int = 2, use_corrector: bool = True,
               timings: Optional[dict] = None, peaks: Optional[dict] = None):
        """Image-guided synthesis, `n_samples` per prompt. videos:
        (B, T, H, W, 3) in [-1, 1].

        Random draws come from one torch.Generator seeded with `seed`, in
        this order: the VAE encode noise; then for each sample its x_T, its
        mask-blend noise and DDIM step noise step by step. `encode_noise`
        (B*T, h, w, z) and `x_T` replace their draws, so a test can feed the
        JAX pipeline's numbers; `x_T` is (B, T, h, w, z), shared by the
        samples as in the JAX pipeline, or (B, n_samples, T, h, w, z).
        `sequential_cfg` changes memory and speed, not the draws. mask,
        x0_latents: (B, T, h, w, z), 1 = hold the latent to x0.
        `timings`, when given, receives the seconds of each stage
        (synchronised on the device), and `peaks` the peak bytes allocated
        on a CUDA device during each stage.

        Returns PipelineOutput with videos (B, n_samples, T, H, W, 3) and,
        with `log_every_t`, the decoded intermediates; or with decode=False
        the latents (B, n_samples, T, h, w, z) as numpy, and with
        `log_every_t` also the x_inter stack (n_logs + 1, B, T, h, w, z)
        (the JAX pipeline's layouts). `log_every_t` needs n_samples == 1.

        sampler: "ddim" (the reference surface), "dpm" (DPM-Solver++(2M),
        `sampling/dpm.py`) or "unipc" (`sampling/unipc.py`), the latter two
        deterministic solvers of the same ODE: `eta` is forced to 0 for them,
        and `log_every_t` and `deepcache` (N > 1: a full UNet call every N
        steps, shallow calls from its cached deep feature in between) are
        ddim-only. solver_order (1..3) and use_corrector select the unipc
        scheme and are ignored otherwise. The stage of the sampler loop is
        named "ddim" in `timings` whatever the sampler."""
        if log_every_t is not None and n_samples != 1:
            raise ValueError("log_every_t intermediates need n_samples=1")
        if sampler not in ("ddim", "dpm", "unipc"):
            raise ValueError(f"unknown sampler {sampler!r}; expected 'ddim', 'dpm' or 'unipc'")
        if sampler != "ddim" and log_every_t is not None:
            raise ValueError("log_every_t intermediates are a DDIM-surface feature "
                             "(reference ddim.py:199-201); use sampler='ddim'")
        if sampler != "ddim":
            eta = 0.0
        dev = self.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        clock = {} if timings is None else timings

        def stage_start() -> float:
            if peaks is not None and dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            return time.perf_counter()

        def stage_end(name: str, t0: float) -> None:
            sync()
            clock[name] = time.perf_counter() - t0
            if peaks is not None and dev.type == "cuda":
                peaks[name] = torch.cuda.max_memory_allocated(dev)

        gen = torch.Generator(device=dev).manual_seed(seed)
        on_dev = lambda a: None if a is None else torch.tensor(
            np.asarray(a, dtype=np.float32), device=dev)
        vids = on_dev(videos)
        b, t, hh, ww, _ = vids.shape
        f = self._latent_factor
        lat_shape = (b, t, hh // f, ww // f, self.vae_config.z_channels)

        t0 = stage_start()
        enc = on_dev(encode_noise)
        if enc is None:
            enc = torch.randn((b * t, *lat_shape[2:]), generator=gen, device=dev)
        cond = self.build_conditioning(
            prompts, vids, enc, cfg_scale=cfg_scale, multiple_cond_cfg=multiple_cond_cfg,
            cfg_img=cfg_img, loop_or_interp=loop_or_interp, fs=fs,
            negative_prompt=negative_prompt)
        stage_end("conditioning", t0)

        settings = SamplerSettings(
            steps=steps, discretize=timestep_spacing, eta=eta, cfg_scale=cfg_scale,
            cfg_img=cfg_img, guidance_rescale=guidance_rescale,
            parameterization=self.config.parameterization, sequential_cfg=sequential_cfg,
            deepcache=deepcache, sampler=sampler, solver_order=solver_order,
            use_corrector=use_corrector)
        table = sched_lib.build_ddim_table(self.schedule, num_steps=steps,
                                           discretize=timestep_spacing, eta=eta)
        model_fn = make_cfg_denoiser(self.unet, cond, settings)
        t0 = stage_start()
        x_T = on_dev(x_T)
        if x_T is not None and x_T.dim() == 5:
            x_T = x_T[:, None].expand(b, n_samples, *x_T.shape[1:])
        variants, inter = [], None
        for k in range(n_samples):
            xt = (torch.randn(lat_shape, generator=gen, device=dev) if x_T is None
                  else x_T[:, k])
            blend = dict(generator=gen, mask=on_dev(mask), x0=on_dev(x0_latents))
            if sampler == "dpm":
                z = dpm_sample(model_fn, xt, self.schedule, table, settings, **blend)
            elif sampler == "unipc":
                z = unipc_sample(model_fn, xt, self.schedule, table, settings, **blend)
            else:
                z = ddim_sample(model_fn, xt, self.schedule, table, settings, **blend,
                                log_every_t=log_every_t)
            if log_every_t is not None:
                z, inter = z[0], z[1]["x_inter"]
            variants.append(z)
        z_all = torch.stack(variants, dim=1)
        stage_end("ddim", t0)
        if not decode:
            if log_every_t is not None:
                return z_all.cpu().numpy(), inter.cpu().numpy()
            return z_all.cpu().numpy()
        t0 = stage_start()
        frames = np.stack([self.decode_latents(z).cpu().numpy() for z in variants], axis=1)
        rows = None
        if log_every_t is not None:
            rows = np.stack([self.decode_latents(x).cpu().numpy() for x in inter])
        stage_end("decode", t0)
        return PipelineOutput(videos=frames, denoise_rows=rows)
