"""Ancestral (DDPM) sampling with logged intermediates: the reference's
debugging / ImageLogger surface (lvdm/models/ddpm3d.py:881-973). JAX twin
dynamicrafter_tpu/sampling/ancestral.py, whose loop is one lax.scan writing
into a fixed buffer; here it is a Python loop writing the same buffer.

The reference's ancestral path takes eps and x0 parameterizations only; "v"
is added through predict_start_from_z_and_v, as in the JAX package, since
every shipped config is v-parameterized.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dynamicrafter_tpu_torch.parallel.sharding import active_frames, randn_frames
from dynamicrafter_tpu_torch.schedule import DiffusionSchedule


def log_slots(save: np.ndarray) -> Tuple[int, np.ndarray]:
    """(n, slots) for an intermediates buffer of n rows: step i writes row
    slots[i]; a step with save[i] false gets slot n (out of range: dropped)."""
    save = np.asarray(save, dtype=bool)
    n = int(save.sum())
    return n, np.where(save, np.cumsum(save) - 1, n).astype(np.int32)


@torch.no_grad()
def p_sample_loop(model_fn: Callable, x_T: torch.Tensor, schedule: DiffusionSchedule, *,
                  parameterization: str = "eps", clip_denoised: bool = False,
                  temperature: float = 1.0, timesteps: Optional[int] = None,
                  start_T: Optional[int] = None, log_every_t: int = 100,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  mask: Optional[torch.Tensor] = None,
                  x0: Optional[torch.Tensor] = None,
                  mask_noise: Optional[torch.Tensor] = None,
                  return_intermediates: bool = False):
    """The full ancestral loop (ddpm3d.py:928-973) from x_T (fp32), t = T-1
    down to 0. model_fn(x, t) -> model output (the reference's ancestral path
    applies no CFG). `noise` and `mask_noise` (T, *x.shape) replace the
    draws from `generator`; within a step the update draws before the blend.
    Under an active frame split draws and given noise are the whole clip's,
    sliced to this rank's frames (as in `ddim_sample`).

    Returns the final latent, or (latent, intermediates) with intermediates
    (n_logs + 1, *x.shape) starting with x_T, saved whenever i %
    log_every_t == 0 or i == T - 1 (reference line 941)."""
    T = schedule.num_timesteps if timesteps is None else timesteps
    if start_T is not None:
        T = min(T, start_T)
    x = x_T.float()
    if mask is not None:
        if x0 is None:
            raise ValueError("mask blending needs x0")
        mask, x0 = mask.to(x), x0.to(x)
    i_vals = np.arange(T - 1, -1, -1)
    n_logs, slots = log_slots((i_vals % log_every_t == 0) | (i_vals == T - 1))
    buf = x.new_zeros((n_logs, *x.shape))
    split = active_frames()

    def draw(given, k):
        if given is None:
            return randn_frames(x, generator)
        return given[k].to(x) if split is None else split.slice(given[k].to(x))
    for k, i in enumerate(i_vals):
        t = int(i)
        out = model_fn(x, t)
        if parameterization == "eps":
            x_recon = (float(schedule.sqrt_recip_alphas_cumprod[t]) * x
                       - float(schedule.sqrt_recipm1_alphas_cumprod[t]) * out)
        elif parameterization == "x0":
            x_recon = out
        elif parameterization == "v":
            x_recon = schedule.predict_start_from_z_and_v(x, t, out)
        else:
            raise NotImplementedError(parameterization)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        # q_posterior (ddpm3d.py:253-262); no noise at t == 0 (ddpm3d.py:920)
        mean = (float(schedule.posterior_mean_coef1[t]) * x_recon
                + float(schedule.posterior_mean_coef2[t]) * x)
        n = draw(noise, k)
        if t > 0:
            std = np.exp(np.float32(0.5) * schedule.posterior_log_variance_clipped[t])
            x = mean + float(std) * n * temperature
        else:
            x = mean
        if mask is not None:
            # blend after the update (reference loop order, ddpm3d.py:961-963)
            ts = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
            x = schedule.q_sample(x0, ts, draw(mask_noise, k)) * mask + (1.0 - mask) * x
        if slots[k] < n_logs:
            buf[slots[k]] = x
    if return_intermediates:
        return x, torch.cat([x_T.float()[None], buf])
    return x
