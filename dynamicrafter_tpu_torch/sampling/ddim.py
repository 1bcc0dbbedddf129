"""DDIM sampling with batched or sequential classifier-free guidance.

Reference lvdm/models/samplers/ddim.py:134-279 (and ddim_multiplecond.py
for the 3-pass mode); JAX twin dynamicrafter_tpu/sampling/ddim.py, whose
whole loop is one lax.scan. Here the loop is plain Python over the DDIM
steps: PyTorch runs eagerly and each step is one batched UNet call, so the
host loop costs nothing next to the step.

The 2 (or 3) CFG passes run as one UNet call on a batch of P*B, or, with
`SamplerSettings.sequential_cfg`, as P calls on a batch of B (the peak
activation memory of one pass: 576x1024 on one device). Per-step scalars
come from the float32 tables and are combined in float32, as in the JAX
package. The combined model output is taken in fp32 whatever the UNet's
dtype.

DeepCache (`SamplerSettings.deepcache` = N > 1, an opt-in approximation
with no reference counterpart): the loop runs the full UNet on the first of
every N steps, keeps the deep feature it returns, and runs the UNet's
shallow forward from that feature on the other N - 1. `SamplerSettings` also
names the sampler ("ddim", or "dpm" / "unipc" of `sampling/dpm.py` and
`sampling/unipc.py`, which share `make_cfg_denoiser`, `make_mask_blend` and
`reject_ode_unsupported` with this module).

Random numbers: step noise (eta > 0) is either pre-drawn, `noise` of shape
(S, *x.shape) in scan order, or drawn from an explicit torch.Generator; so
is the noise of the mask blend (`mask_noise`). Within a step the blend
draws before the update. The CFG mode draws nothing, so batched and
sequential CFG see the same numbers.
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
    clean_cond: bool = False              # mask blending uses clean x0
    sequential_cfg: bool = False          # one UNet call per CFG pass
    deepcache: int = 1                    # N > 1: run the UNet's deep levels
                                          # every N steps and reuse the cached
                                          # deep feature in between (DeepCache,
                                          # Ma et al. CVPR'24; ddim only, an
                                          # opt-in approximation)
    sampler: str = "ddim"                 # "ddim", "dpm" = DPM-Solver++(2M)
                                          # (sampling/dpm.py) or "unipc"
                                          # (sampling/unipc.py)
    solver_order: int = 2                 # unipc only: 1..3
    use_corrector: bool = True            # unipc only: apply the corrector


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
    """model_fn(x, t, cache=None, return_cache=False) -> CFG-combined fp32
    model output:
      standard:  e = e_uc + s * (e_c - e_uc)                     (ddim.py:226)
      multicond: e = e_uc + s_img * (e_uc_img - e_uc) + s * (e_c - e_uc_img)
    then the optional guidance rescale against the conditional pass. The
    passes run as one UNet call, or one call each under
    `settings.sequential_cfg`.

    `return_cache=True` returns (output, cache), the UNet's DeepCache
    feature of this call; `cache=` runs the UNet's shallow forward from such
    a feature. Under sequential CFG the cache is one feature per pass,
    stacked. The two keywords reach `unet` only when in use, so a plain
    unet(x, t, context_text=, context_img=, fs=) callable works. `t` is
    one timestep for the whole batch, or a (B,) tensor of per-sample
    timesteps (score distillation draws one per sample)."""
    p = cond.num_passes

    def timesteps(t, b: int, device) -> torch.Tensor:
        if torch.is_tensor(t) and t.dim() == 1:
            return t.to(device=device, dtype=torch.long)
        return torch.full((b,), int(t), dtype=torch.long, device=device)

    def model_fn(x: torch.Tensor, t: int, cache: Optional[torch.Tensor] = None,
                 return_cache: bool = False):
        b = x.shape[0]
        dc_kw = {"return_cache": True} if return_cache else {}
        cache_out = None
        if settings.sequential_cfg and p > 1:
            ts = timesteps(t, b, x.device)
            outs, caches = [], []
            for i in range(p):
                o = unet(
                    x if cond.concat is None
                    else torch.cat([x, cond.concat[i].to(x.dtype)], dim=-1),
                    ts, context_text=cond.context_text[i],
                    context_img=None if cond.context_img is None else cond.context_img[i],
                    fs=cond.fs, **dc_kw, **({} if cache is None else {"cache": cache[i]}))
                if return_cache:
                    o, c = o
                    caches.append(c)
                outs.append(o.float())
            out = torch.stack(outs)
            if return_cache:
                cache_out = torch.stack(caches)
        else:
            xs = x.unsqueeze(0).expand(p, *x.shape)
            if cond.concat is not None:
                xs = torch.cat([xs, cond.concat.to(x.dtype)], dim=-1)
            flat = lambda a: a.reshape(p * b, *a.shape[2:])
            out = unet(
                flat(xs),
                timesteps(t, b, x.device).repeat(p),
                context_text=flat(cond.context_text),
                context_img=None if cond.context_img is None else flat(cond.context_img),
                fs=None if cond.fs is None else cond.fs.repeat(p),
                **dc_kw, **({} if cache is None else {"cache": cache}))
            if return_cache:
                out, cache_out = out
            out = out.float().reshape(p, b, *out.shape[1:])
        ret = lambda e: (e, cache_out) if return_cache else e
        if p == 1:
            return ret(out[0])
        if p == 2:
            e_uc, e_c = out[0], out[1]
            e = e_uc + settings.cfg_scale * (e_c - e_uc)
        else:
            e_uc, e_uc_img, e_c = out[0], out[1], out[2]
            s_img = settings.cfg_img if settings.cfg_img is not None else settings.cfg_scale
            e = e_uc + s_img * (e_uc_img - e_uc) + settings.cfg_scale * (e_c - e_uc_img)
        if settings.guidance_rescale > 0.0:
            e = rescale_noise_cfg(e, e_c, settings.guidance_rescale)
        return ret(e)

    return model_fn


def make_mask_blend(schedule: DiffusionSchedule, settings: SamplerSettings,
                    mask: Optional[torch.Tensor], x0: Optional[torch.Tensor]) -> Callable:
    """Inpaint-style latent blending (reference ddim.py:173-180): before each
    model call, replace the region where mask == 1 with x0, noised to the
    step's timestep unless `settings.clean_cond`. blend(x, t, mask_noise,
    generator) -> x; `mask_noise` None draws from the generator."""

    def blend(x: torch.Tensor, t: int, mask_noise: Optional[torch.Tensor],
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if mask is None:
            return x
        if x0 is None:
            raise ValueError("mask blending needs x0")
        if settings.clean_cond:
            img_orig = x0
        else:
            if mask_noise is None:
                mask_noise = torch.randn(x.shape, generator=generator, device=x.device,
                                         dtype=x.dtype)
            ts = torch.full((x.shape[0],), int(t), dtype=torch.long, device=x.device)
            img_orig = schedule.q_sample(x0, ts, mask_noise.to(device=x.device, dtype=x.dtype))
        return img_orig * mask + (1.0 - mask) * x

    return blend


def reject_ode_unsupported(settings: SamplerSettings, table: DDIMTable,
                           sampler: str) -> None:
    """What the deterministic ODE solvers (dpm, unipc) refuse: DeepCache
    (ddim only), and eps-parameterization on a zero-terminal-SNR schedule,
    where x0 = (x - sigma * eps) / sqrt(alpha_bar) divides by zero at the
    t = 999 endpoint."""
    if settings.deepcache > 1:
        raise ValueError("deepcache is only certified with the DDIM "
                         f"sampler; run {sampler} without it")
    if settings.parameterization != "v" and float(np.min(table.alphas)) < 1e-8:
        raise ValueError(
            "eps-parameterization with a zero-terminal-SNR schedule is "
            "unsupported: x0 = (x - sigma*eps)/sqrt(alpha_bar) divides by "
            "zero at the t=999 endpoint; use v-parameterization")


@torch.no_grad()
def ddim_sample(model_fn: Callable, x_T: torch.Tensor, schedule: DiffusionSchedule,
                table: DDIMTable, settings: SamplerSettings, *,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None,
                mask_noise: Optional[torch.Tensor] = None,
                log_every_t: Optional[int] = None):
    """Run the DDIM loop from x_T (fp32) over the table's steps, highest
    timestep first; returns the final latent.

    mask, x0: (B, T, h, w, c); where mask == 1 the latent is held to x0
    (noised per step from `mask_noise` (S, *x.shape) or the generator).

    log_every_t: also return the reference sampler's intermediates
    (ddim.py:157, 199-201), {"x_inter", "pred_x0"}, each (n_logs + 1,
    *x.shape) starting with x_T, saved whenever the descending step index
    satisfies index % log_every_t == 0 or index == steps - 1.

    `settings.deepcache` = N > 1 (DeepCache): the steps run in groups of N;
    the first step of a group is a full UNet call that also returns its deep
    feature, the other N - 1 are shallow calls from that feature. N must
    divide the number of steps; no intermediates are logged."""
    s = table.num_steps
    n_dc = settings.deepcache
    if n_dc > 1 and log_every_t is not None:
        raise ValueError("log_every_t intermediates require the exact "
                         "sampler (deepcache=1)")
    if n_dc > 1 and s % n_dc != 0:
        raise ValueError(f"deepcache interval {n_dc} must divide steps={s}")
    x = x_T.float()
    one = np.float32(1.0)
    blend = make_mask_blend(schedule, settings,
                            None if mask is None else mask.to(x),
                            None if x0 is None else x0.to(x))
    x_inter, pred_inter = [x], [x]
    cache = None
    for i, idx in enumerate(range(s - 1, -1, -1)):
        t = int(table.timesteps[idx])
        a_t, a_prev = table.alphas[idx], table.alphas_prev[idx]
        sigma = table.sigmas[idx]
        x = blend(x, t, None if mask_noise is None else mask_noise[i], generator)
        if n_dc == 1:
            out = model_fn(x, t)
        elif i % n_dc == 0:
            out, cache = model_fn(x, t, return_cache=True)
        else:
            out = model_fn(x, t, cache=cache)
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
        if log_every_t is not None and (idx % log_every_t == 0 or idx == s - 1):
            x_inter.append(x)
            pred_inter.append(pred_x0)
    if log_every_t is not None:
        return x, {"x_inter": torch.stack(x_inter), "pred_x0": torch.stack(pred_inter)}
    return x


def ddim_decode(model_fn: Callable, x_latent: torch.Tensor, schedule: DiffusionSchedule,
                table: DDIMTable, settings: SamplerSettings, t_start: int, *,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """img2img: denoise from DDIM step t_start down to 0 (reference
    ddim.py:281-301): the same loop over the first t_start entries of the
    table."""
    cut = lambda a: None if a is None else a[:t_start]
    truncated = DDIMTable(
        timesteps=table.timesteps[:t_start], alphas=table.alphas[:t_start],
        alphas_prev=table.alphas_prev[:t_start],
        sqrt_one_minus_alphas=table.sqrt_one_minus_alphas[:t_start],
        sigmas=table.sigmas[:t_start], scale_arr=cut(table.scale_arr),
        scale_arr_prev=cut(table.scale_arr_prev))
    return ddim_sample(model_fn, x_latent, schedule, truncated, settings, noise=noise,
                       generator=generator)


def stochastic_encode(table: DDIMTable, x0: torch.Tensor, t_index: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """img2img entry: noise x0 to the DDIM step t_index (B,) (reference
    ddim.py:303-317)."""
    shape = (-1,) + (1,) * (x0.dim() - 1)
    idx = t_index.cpu().numpy()
    ga = torch.as_tensor(np.sqrt(table.alphas)[idx], device=x0.device).reshape(shape)
    g1 = torch.as_tensor(table.sqrt_one_minus_alphas[idx], device=x0.device).reshape(shape)
    return ga * x0 + g1 * noise
