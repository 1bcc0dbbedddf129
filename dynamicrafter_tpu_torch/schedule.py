"""Diffusion schedule math.

Tables are built host-side in float64 numpy and kept as float32 numpy
arrays, exactly as `dynamicrafter_tpu/schedule.py` builds them; the sampler
reads per-step scalars from them. `timestep_embedding` and
`rescale_noise_cfg` work on torch tensors on any device.

Reference file:line for each piece is in the JAX module's docstring.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from dynamicrafter_tpu_torch.parallel.sharding import active_frames, sp_all_reduce


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start: float = 1e-4, linear_end: float = 2e-2,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule table, float64, shape (n_timestep,)."""
    if schedule == "linear":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = timesteps / (1 + cosine_s) * np.pi / 2
        alphas = np.cos(alphas) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, a_min=0, a_max=0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas to zero terminal SNR (arXiv:2305.08891, Algorithm 1)."""
    alphas = 1.0 - betas
    alphas_bar_sqrt = np.sqrt(np.cumprod(alphas, axis=0))
    a0 = alphas_bar_sqrt[0].copy()
    aT = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * a0 / (a0 - aT)
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = alphas_bar[1:] / alphas_bar[:-1]
    alphas = np.concatenate([alphas_bar[0:1], alphas])
    return 1 - alphas


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """DDIM timestep subset, int64, ascending."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        steps = np.asarray(list(range(0, num_ddpm_timesteps, c))) + 1
    elif ddim_discr_method == "uniform_trailing":
        c = num_ddpm_timesteps / num_ddim_timesteps
        steps = np.flip(np.round(np.arange(num_ddpm_timesteps, 0, -c))).astype(np.int64) - 1
    elif ddim_discr_method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                             num_ddim_timesteps) ** 2).astype(int) + 1
    else:
        raise NotImplementedError(
            f'There is no ddim discretization method called "{ddim_discr_method}"')
    return steps


def make_ddim_sampling_parameters(alphacums: np.ndarray,
                                  ddim_timesteps: np.ndarray, eta: float):
    """Per-DDIM-step (sigma, alpha, alpha_prev) tables (arXiv:2010.02502)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def make_dynamic_scale_arr(num_timesteps: int, base_scale: float = 0.7,
                           turning_step: int = 400) -> np.ndarray:
    """Dynamic-rescale array: linear 1.0->base over turning_step, then flat."""
    return np.concatenate((np.linspace(1.0, base_scale, turning_step),
                           np.full(num_timesteps, base_scale)))


# Cody-Waite split of 2*pi (see dynamicrafter_tpu/schedule.py): C1 is exact
# in 8 significand bits, so n*C1 and args - n*C1 are exact in fp32 for the
# n that timesteps below ~1300 produce; the C2/C3 terms recover ~1e-7 of
# absolute accuracy in the reduced argument. A plain fp32 cos(t*f) loses
# ~1e-3 at t ~ 1000.
_TWOPI_C1 = 6.28125
_TWOPI_C2 = float(np.float32(2 * np.pi - _TWOPI_C1))
_TWOPI_C3 = float(np.float32(2 * np.pi - _TWOPI_C1 - _TWOPI_C2))
_INV_TWOPI = float(np.float32(1.0 / (2 * np.pi)))


def _reduce_mod_2pi(args: torch.Tensor) -> torch.Tensor:
    """Reduce fp32 args (|args| < ~1e4) into [-pi, pi]."""
    n = torch.round(args * _INV_TWOPI)
    r = args - n * _TWOPI_C1
    r = r - n * _TWOPI_C2
    return r - n * _TWOPI_C3


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] layout, (N, dim) fp32."""
    half = dim // 2
    freqs = torch.from_numpy(np.exp(
        -math.log(max_period) * np.arange(half, dtype=np.float64) / half
    ).astype(np.float32)).to(timesteps.device)
    args = timesteps[:, None].to(torch.float32) * freqs[None]
    r = _reduce_mod_2pi(args)
    emb = torch.cat([torch.cos(r), torch.sin(r)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _clip_stds(*xs: torch.Tensor):
    """The std of each sample of each x over all its other axes, (B, 1,
    ...). Under an active frame split the x hold this rank's frames: the
    sums of x and x^2 go over the sp group (one all-reduce for all of them)
    and each std is the whole clip's."""
    dims = tuple(range(1, xs[0].dim()))
    split = active_frames()
    if split is None:
        return [x.std(dim=dims, keepdim=True, correction=0) for x in xs]
    sums = sp_all_reduce(torch.stack([s for x in xs for s in (x.sum(dims), x.square().sum(dims))]),
                         split)
    n = xs[0][0].numel() * split.sp
    stds = []
    for total, squares in sums.view(len(xs), 2, -1).unbind():
        mean = total / n
        var = (squares / n - mean.square()).clamp_min(0.0)
        stds.append(var.sqrt().reshape(-1, *(1,) * len(dims)))
    return stds


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float = 0.0) -> torch.Tensor:
    """Rescale CFG output std to the text-conditional std (arXiv:2305.08891).
    The std spans the whole clip, also where its frames are split over the
    sp ranks."""
    std_text, std_cfg = _clip_stds(noise_pred_text, noise_cfg)
    rescaled = noise_cfg * (std_text / torch.clamp(std_cfg, min=1e-12))
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def extract_into_tensor(a: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather the fp32 table `a` at the per-sample timesteps t (B,), shaped
    (B, 1, ..., 1) to broadcast against an ndim-dimensional batch."""
    out = torch.as_tensor(a, device=t.device)[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM schedule tables, float32 numpy, length num_timesteps."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    scale_arr: Optional[np.ndarray] = None

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    # forward process at per-sample timesteps t (B,), as in training
    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        nd = x_start.dim()
        return (extract_into_tensor(self.sqrt_alphas_cumprod, t, nd) * x_start
                + extract_into_tensor(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def get_v(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        nd = x.dim()
        return (extract_into_tensor(self.sqrt_alphas_cumprod, t, nd) * noise
                - extract_into_tensor(self.sqrt_one_minus_alphas_cumprod, t, nd) * x)

    # v-parameterization at one DDPM timestep t shared by the whole batch
    def predict_start_from_z_and_v(self, x_t: torch.Tensor, t: int,
                                   v: torch.Tensor) -> torch.Tensor:
        return (float(self.sqrt_alphas_cumprod[t]) * x_t
                - float(self.sqrt_one_minus_alphas_cumprod[t]) * v)

    def predict_eps_from_z_and_v(self, x_t: torch.Tensor, t: int,
                                 v: torch.Tensor) -> torch.Tensor:
        return (float(self.sqrt_alphas_cumprod[t]) * v
                + float(self.sqrt_one_minus_alphas_cumprod[t]) * x_t)


def build_schedule(*, timesteps: int = 1000, beta_schedule: str = "linear",
                   linear_start: float = 1e-4, linear_end: float = 2e-2,
                   cosine_s: float = 8e-3,
                   given_betas: Optional[np.ndarray] = None,
                   rescale_betas_zero_snr: bool = False,
                   parameterization: str = "eps", v_posterior: float = 0.0,
                   use_dynamic_rescale: bool = False, base_scale: float = 0.7,
                   turning_step: int = 400) -> DiffusionSchedule:
    """Build all schedule tables in float64, return float32 arrays."""
    if given_betas is not None:
        betas = np.asarray(given_betas, dtype=np.float64)
    else:
        betas = make_beta_schedule(beta_schedule, timesteps,
                                   linear_start=linear_start,
                                   linear_end=linear_end, cosine_s=cosine_s)
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (
        1.0 - alphas_cumprod) + v_posterior * betas

    if parameterization == "eps":
        with np.errstate(divide="ignore"):
            lvlb_weights = betas ** 2 / (
                2 * posterior_variance * alphas * (1 - alphas_cumprod))
    elif parameterization == "x0":
        lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
    elif parameterization == "v":
        lvlb_weights = np.ones_like(betas)
    else:
        raise NotImplementedError(f"parameterization {parameterization}")
    lvlb_weights = np.asarray(lvlb_weights).copy()
    lvlb_weights[0] = lvlb_weights[1]

    # zero-terminal SNR makes alphas_cumprod[-1] == 0; the reference zeroes
    # the reciprocal tables for v-parameterization
    if parameterization != "v":
        sqrt_recip = np.sqrt(1.0 / alphas_cumprod)
        sqrt_recipm1 = np.sqrt(1.0 / alphas_cumprod - 1)
    else:
        sqrt_recip = np.zeros_like(alphas_cumprod)
        sqrt_recipm1 = np.zeros_like(alphas_cumprod)

    f32 = lambda x: np.asarray(x, dtype=np.float32)
    scale_arr = None
    if use_dynamic_rescale:
        scale_arr = f32(make_dynamic_scale_arr(timesteps, base_scale, turning_step))
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(sqrt_recip),
        sqrt_recipm1_alphas_cumprod=f32(sqrt_recipm1),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                 / (1.0 - alphas_cumprod)),
        lvlb_weights=f32(lvlb_weights),
        scale_arr=scale_arr,
    )


@dataclasses.dataclass(frozen=True)
class DDIMTable:
    """Per-DDIM-step tables, all shape (S,), index 0 = lowest timestep."""

    timesteps: np.ndarray          # int32, the DDPM t fed to the UNet
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    scale_arr: Optional[np.ndarray] = None
    scale_arr_prev: Optional[np.ndarray] = None

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def build_ddim_table(schedule: DiffusionSchedule, *, num_steps: int,
                     discretize: str = "uniform", eta: float = 0.0) -> DDIMTable:
    """Build the DDIM sampling table from a DDPM schedule."""
    alphacums = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
    ddim_timesteps = make_ddim_timesteps(discretize, num_steps, schedule.num_timesteps)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        alphacums, ddim_timesteps, eta)
    scale_arr = scale_arr_prev = None
    if schedule.scale_arr is not None:
        sa = np.asarray(schedule.scale_arr)[ddim_timesteps]
        scale_arr = sa.astype(np.float32)
        scale_arr_prev = np.concatenate([sa[0:1], sa[:-1]]).astype(np.float32)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DDIMTable(
        timesteps=np.asarray(ddim_timesteps, dtype=np.int32),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
        sigmas=f32(sigmas),
        scale_arr=scale_arr,
        scale_arr_prev=scale_arr_prev,
    )
