"""The reference sampler arithmetic, from the published formulas, with every
table in float64: the DDPM schedule (linear betas, zero-terminal-SNR
rescale, arXiv:2305.08891 Algorithm 1), the DDIM step of DynamiCrafter's
`lvdm/models/samplers/ddim.py` (v-parameterization, classifier-free
guidance, guidance rescale, the dynamic rescale of the predicted x0) and
its `uniform_trailing` timesteps.

`ddim_step` maps one step's input and the two CFG passes' raw UNet outputs
to the next step's input, so the check can follow the program's own
trajectory step by step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    alphas_cumprod: np.ndarray        # float64 (num_timesteps,)
    scale_arr: np.ndarray             # float64 (num_timesteps,), ones without rescale


def schedule(params: dict) -> Schedule:
    """From a configuration's `model.params`."""
    n = int(params.get("timesteps", 1000))
    if params.get("beta_schedule", "linear") != "linear":
        raise NotImplementedError("the reference knows the linear beta schedule")
    betas = np.linspace(params.get("linear_start", 1e-4) ** 0.5,
                        params.get("linear_end", 2e-2) ** 0.5, n, dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    if params.get("rescale_betas_zero_snr", False):
        s = np.sqrt(abar)
        s = (s - s[-1]) * s[0] / (s[0] - s[-1])
        abar = s ** 2
    scale = np.ones(n)
    if params.get("use_dynamic_rescale", False):
        base, turn = params.get("base_scale", 0.7), params.get("turning_step", 400)
        scale = np.concatenate([np.linspace(1.0, base, turn), np.full(n, base)])[:n]
    return Schedule(abar, scale)


def timesteps(spacing: str, steps: int, n: int = 1000) -> np.ndarray:
    """DDIM timesteps, ascending."""
    if spacing == "uniform":
        return np.arange(0, n, n // steps) + 1
    if spacing == "uniform_trailing":
        return np.flip(np.round(np.arange(n, 0, -n / steps))).astype(np.int64) - 1
    raise NotImplementedError(spacing)


@dataclasses.dataclass(frozen=True)
class DDIMStep:
    t: int
    a_t: float
    a_prev: float
    sigma: float
    x0_rescale: float


def ddim_steps(sched: Schedule, spacing: str, steps: int, eta: float):
    """The steps in sampling order (highest timestep first)."""
    ts = timesteps(spacing, steps, len(sched.alphas_cumprod))
    a = sched.alphas_cumprod[ts]
    a_prev = np.concatenate([[sched.alphas_cumprod[0]], a[:-1]])
    sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    sa = sched.scale_arr[ts]
    sa_prev = np.concatenate([sa[:1], sa[:-1]])
    return [DDIMStep(int(ts[i]), float(a[i]), float(a_prev[i]), float(sigma[i]),
                     float(sa_prev[i] / sa[i]))
            for i in range(len(ts) - 1, -1, -1)]


def cfg(out_uc: torch.Tensor, out_c: torch.Tensor, scale: float,
        rescale: float) -> torch.Tensor:
    """Classifier-free guidance, then the std rescale toward the conditional
    pass (per sample, over all other axes)."""
    e = out_uc + scale * (out_c - out_uc)
    if rescale > 0:
        dims = tuple(range(1, e.dim()))
        std_c = out_c.std(dim=dims, keepdim=True, correction=0)
        std_e = e.std(dim=dims, keepdim=True, correction=0)
        e = rescale * (e * std_c / std_e) + (1 - rescale) * e
    return e


def ddim_step(x: torch.Tensor, v: torch.Tensor, step: DDIMStep,
              noise: torch.Tensor) -> torch.Tensor:
    """One DDIM step from x with the guided v-prediction `v`, in the dtype of x."""
    sa, s1a = step.a_t ** 0.5, (1 - step.a_t) ** 0.5
    eps = sa * v + s1a * x
    x0 = (sa * x - s1a * v) * step.x0_rescale
    dir_xt = max(0.0, 1 - step.a_prev - step.sigma ** 2) ** 0.5 * eps
    return step.a_prev ** 0.5 * x0 + dir_xt + step.sigma * noise
