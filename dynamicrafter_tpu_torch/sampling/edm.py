"""Stable Video Diffusion's sampler: Euler steps on the EDM noise levels,
with the v-scaling denoiser and a guidance scale per frame.

sgm's `EDMDiscretization` (Karras et al. 2022: sigma_max^(1/rho) to
sigma_min^(1/rho) linearly in n steps, to the rho-th power, then 0),
`VScalingWithEDMcNoise` (c_skip = 1 / (s^2 + 1), c_out = -s / sqrt(s^2 + 1),
c_in = 1 / sqrt(s^2 + 1), c_noise = ln(s) / 4), `LinearPredictionGuider`
(frame f's scale linspace(min, max, T)[f], D = D_u + scale (D_c - D_u)),
and `EulerEDMSampler` with s_churn 0: x_T = N(0, 1) sqrt(1 + s_0^2); each
step x <- x + (s_next - s) (x - D) / s, the last (to s = 0) landing on D.
The noise levels are computed in float64; the sampler state and every
step's arithmetic are float32, as sgm's.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from dynamicrafter_tpu_torch.utils import trace


def edm_sigmas(steps: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
               rho: float = 7.0) -> np.ndarray:
    """(steps + 1,) float64: the EDM noise levels, then 0."""
    ramp = np.linspace(0.0, 1.0, steps)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    return np.append((hi + ramp * (lo - hi)) ** rho, 0.0)


def v_scaling(sigma: float):
    """(c_skip, c_out, c_in, c_noise) of VScalingWithEDMcNoise at sigma."""
    return (1.0 / (sigma ** 2 + 1.0), -sigma / math.sqrt(sigma ** 2 + 1.0),
            1.0 / math.sqrt(sigma ** 2 + 1.0), 0.25 * math.log(sigma))


def frame_scales(frames: int, min_scale: float, max_scale: float) -> np.ndarray:
    """LinearPredictionGuider's scale of each frame, (frames,)."""
    return np.linspace(min_scale, max_scale, frames)


def euler_edm_sample(model: Callable[[torch.Tensor, float], tuple], x_T: torch.Tensor,
                     sigmas: np.ndarray, scales: np.ndarray) -> torch.Tensor:
    """x_T: (B, T, h, w, z) drawn from N(0, 1); `model(x, sigma)` returns the
    (unconditional, conditional) denoised D of x at sigma, each (B, T, h, w,
    z) float32. Returns the sample (B, T, h, w, z) float32."""
    x = x_T.float() * math.sqrt(1.0 + float(sigmas[0]) ** 2)
    scale = torch.as_tensor(scales, dtype=torch.float32, device=x.device).view(1, -1, 1, 1, 1)
    for i in range(len(sigmas) - 1):
        s, s_next = float(sigmas[i]), float(sigmas[i + 1])
        with trace.span("sampler_step", index=i, sigma=s):
            d_u, d_c = model(x, s)
            denoised = d_u + scale * (d_c - d_u)
            x = x + (s_next - s) * ((x - denoised) / s)
    return x
