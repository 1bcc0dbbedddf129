"""DDIM sampling with batched classifier-free guidance.

Reference lvdm/models/samplers/ddim.py:134-279 (and ddim_multiplecond.py
for the 3-pass mode); JAX twin dynamicrafter_tpu/sampling/ddim.py, whose
whole loop is one lax.scan. Here the loop is plain Python over the DDIM
steps: PyTorch runs eagerly and each step is one batched UNet call, so the
host loop costs nothing next to the step.

The 2 (or 3) CFG passes run as one UNet call on a batch of P*B. Per-step
scalars come from the float32 tables and are combined in float32, as in
the JAX package. The combined model output is taken in fp32 whatever the
UNet's dtype. Step noise (eta > 0) is either pre-drawn, `noise` of shape
(S, *x.shape) in scan order, or drawn from an explicit torch.Generator.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dynamicrafter_tpu_torch.schedule import (
    DDIMTable,
    DiffusionSchedule,
    rescale_noise_cfg,
)


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    steps: int = 50
    discretize: str = "uniform"
    eta: float = 0.0
    cfg_scale: float = 7.5
    cfg_img: Optional[float] = None       # multi-cond second axis; None = off
    guidance_rescale: float = 0.0
    parameterization: str = "v"


class CFGConditioning(NamedTuple):
    """Stacked conditioning for 1..3 CFG passes, pass order
    [uncond, (uncond_img,) cond] along a leading pass axis P."""

    context_text: torch.Tensor             # (P, B, Lt, C)
    context_img: Optional[torch.Tensor]    # (P, B, T, Li, C)
    concat: Optional[torch.Tensor]         # (P, B, T, h, w, Cc)
    fs: Optional[torch.Tensor]             # (B,) shared by the passes

    @property
    def num_passes(self) -> int:
        return self.context_text.shape[0]


def make_cfg_denoiser(unet: Callable, cond: CFGConditioning,
                      settings: SamplerSettings) -> Callable:
    """model_fn(x, t) -> CFG-combined fp32 model output, with one UNet call:
      standard:  e = e_uc + s * (e_c - e_uc)                     (ddim.py:226)
      multicond: e = e_uc + s_img * (e_uc_img - e_uc) + s * (e_c - e_uc_img)
    then the optional guidance rescale against the conditional pass."""
    p = cond.num_passes

    def model_fn(x: torch.Tensor, t: int) -> torch.Tensor:
        b = x.shape[0]
        xs = x.unsqueeze(0).expand(p, *x.shape)
        if cond.concat is not None:
            xs = torch.cat([xs, cond.concat.to(x.dtype)], dim=-1)
        flat = lambda a: a.reshape(p * b, *a.shape[2:])
        out = unet(
            flat(xs),
            torch.full((p * b,), int(t), dtype=torch.long, device=x.device),
            context_text=flat(cond.context_text),
            context_img=None if cond.context_img is None else flat(cond.context_img),
            fs=None if cond.fs is None else cond.fs.repeat(p),
        ).float()
        out = out.reshape(p, b, *out.shape[1:])
        if p == 1:
            return out[0]
        if p == 2:
            e_uc, e_c = out[0], out[1]
            e = e_uc + settings.cfg_scale * (e_c - e_uc)
        else:
            e_uc, e_uc_img, e_c = out[0], out[1], out[2]
            s_img = settings.cfg_img if settings.cfg_img is not None else settings.cfg_scale
            e = e_uc + s_img * (e_uc_img - e_uc) + settings.cfg_scale * (e_c - e_uc_img)
        if settings.guidance_rescale > 0.0:
            e = rescale_noise_cfg(e, e_c, settings.guidance_rescale)
        return e

    return model_fn


@torch.no_grad()
def ddim_sample(model_fn: Callable, x_T: torch.Tensor, schedule: DiffusionSchedule,
                table: DDIMTable, settings: SamplerSettings, *,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Run the DDIM loop from x_T (fp32) over the table's steps, highest
    timestep first; returns the final latent."""
    s = table.num_steps
    x = x_T.float()
    one = np.float32(1.0)
    for i, idx in enumerate(range(s - 1, -1, -1)):
        t = int(table.timesteps[idx])
        a_t, a_prev = table.alphas[idx], table.alphas_prev[idx]
        sigma = table.sigmas[idx]
        out = model_fn(x, t)
        if settings.parameterization == "v":
            e_t = schedule.predict_eps_from_z_and_v(x, t, out)
            pred_x0 = schedule.predict_start_from_z_and_v(x, t, out)
        else:
            e_t = out
            pred_x0 = (x - float(table.sqrt_one_minus_alphas[idx]) * e_t) / float(np.sqrt(a_t))
        if table.scale_arr is not None:
            pred_x0 = pred_x0 * float(table.scale_arr_prev[idx] / table.scale_arr[idx])
        dir_xt = float(np.sqrt(one - a_prev - sigma * sigma)) * e_t
        x = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
        if settings.eta > 0.0:
            if noise is not None:
                n = noise[i].to(device=x.device, dtype=x.dtype)
            else:
                n = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
            x = x + float(sigma) * n
    return x
