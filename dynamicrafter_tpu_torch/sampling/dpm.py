"""DPM-Solver++(2M) sampling (Lu et al., 2022, arXiv:2211.01095): a
deterministic second-order multistep solver of the probability-flow ODE
that DDIM with eta = 0 solves to first order.

JAX twin dynamicrafter_tpu/sampling/dpm.py, whose loop is one lax.scan; here
it is a Python loop over the steps, as in `sampling/ddim.py`. The JAX
module's chunked-dispatch seam (`coeffs`, `carry_in`, `return_carry`) is
not carried over: it splits one long device program, and there is none
here.

Design, as in the JAX module:
  * every per-step coefficient (the log-SNR lambda(t), the step gap h_i,
    exp(-h_i), the 2M coefficient h_i / (2 h_{i-1})) is computed on the host
    in float64 from the DDIMTable. Zero-terminal SNR makes lambda(999) =
    -inf; it is clipped once, there, so no inf or nan reaches the device;
  * data-prediction (x0) form, which stays finite for v-parameterization at
    a zero-terminal-SNR endpoint; eps-parameterization there divides by
    sqrt(alpha_bar) = 0 and is refused (`reject_ode_unsupported`);
  * the first step is first-order (no history) and so is the last
    ("lower-order final");
  * the model is evaluated once per step at the table's integer timesteps;
  * dynamic rescale: the model predicts scale(t) * x0, so the loop divides
    the prediction by scale_t to get the underlying x0, which the multistep
    history extrapolates, and the exact scale-aware one-step map is folded
    into the per-step constants
        A_i = alpha_next * (scale_next - e^{-h} scale_t)       # order 1
        B_i = alpha_next * (1 - e^{-h}) * scale_next * c_i     # order 2
    with c_i = h_i / (2 h_{i-1}). A_i equals DDIM's one-step map; without
    dynamic rescale this is standard DPM++(2M).

Update rule (descending step index i = 0 .. S-1):
    p_i     = x0_pred(x_i, t_i) / scale_{t_i}       # one CFG-combined UNet call
    x_{i+1} = (sigma_{t_{i+1}} / sigma_{t_i}) x_i + A_i p_i + B_i (p_i - p_{i-1})
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from dynamicrafter_tpu_torch.schedule import DDIMTable, DiffusionSchedule
from dynamicrafter_tpu_torch.sampling.ddim import (
    SamplerSettings,
    make_mask_blend,
    reject_ode_unsupported,
)
from dynamicrafter_tpu_torch.utils import trace


def _lambda_from_alpha_bar(a_bar: np.ndarray) -> np.ndarray:
    """Half the log-SNR, lambda = log(alpha / sigma) with alpha =
    sqrt(a_bar), in float64. Clipped so that the zero-terminal-SNR endpoint
    (a_bar == 0 at t = 999) gives a large finite negative lambda (about -23)
    and not -inf."""
    a = np.clip(np.asarray(a_bar, dtype=np.float64), 1e-20, 1.0 - 1e-12)
    return 0.5 * (np.log(a) - np.log1p(-a))


def ode_step_tables(table: DDIMTable) -> Dict[str, np.ndarray]:
    """What dpm and unipc share, float64 in scan order (index 0 = highest
    timestep): idx, a_t, h, sig_ratio, alp_next, scale_t, scale_next, lam_t."""
    s = table.num_steps
    idx = np.arange(s - 1, -1, -1)
    a_t = np.asarray(table.alphas, dtype=np.float64)[idx]
    a_next = np.asarray(table.alphas_prev, dtype=np.float64)[idx]
    lam_t = _lambda_from_alpha_bar(a_t)
    if table.scale_arr is not None:
        scale_t = np.asarray(table.scale_arr, dtype=np.float64)[idx]
        scale_next = np.asarray(table.scale_arr_prev, dtype=np.float64)[idx]
    else:
        scale_t = scale_next = np.ones(s)
    return dict(idx=idx, a_t=a_t, lam_t=lam_t,
                h=_lambda_from_alpha_bar(a_next) - lam_t,   # > 0: denoising moves up-SNR
                sig_ratio=np.sqrt(1.0 - a_next) / np.sqrt(1.0 - a_t),
                alp_next=np.sqrt(a_next), scale_t=scale_t, scale_next=scale_next)


def dpm_solver_pp_2m_coeffs(table: DDIMTable) -> Dict[str, np.ndarray]:
    """Per-step constants, computed in float64 and returned as float32 (S,)
    arrays in scan order (index 0 = highest timestep)."""
    s = table.num_steps
    st = ode_step_tables(table)
    h = st["h"]
    # 2M coefficient h_i / (2 h_{i-1}); order 1 at the first and last step
    coef = np.zeros(s)
    if s > 1:
        coef[1:] = h[1:] / (2.0 * h[:-1])
        coef[-1] = 0.0
    e_mh = np.exp(-h)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return {
        "t": np.asarray(table.timesteps)[st["idx"]],
        "a_t": f32(st["a_t"]),
        "inv_scale": f32(1.0 / st["scale_t"]),
        "sig_ratio": f32(st["sig_ratio"]),
        "order1": f32(st["alp_next"] * (st["scale_next"] - e_mh * st["scale_t"])),
        "order2": f32(st["alp_next"] * (1.0 - e_mh) * st["scale_next"] * coef),
    }


def predict_x0(schedule: DiffusionSchedule, settings: SamplerSettings, x: torch.Tensor,
               t: int, a_t: np.float32, out: torch.Tensor) -> torch.Tensor:
    """The model's x0 prediction from its output at timestep t."""
    if settings.parameterization == "v":
        return schedule.predict_start_from_z_and_v(x, t, out)
    return (x - float(np.sqrt(np.float32(1.0) - a_t)) * out) / float(np.sqrt(a_t))


@torch.no_grad()
def dpm_sample(model_fn: Callable, x_T: torch.Tensor, schedule: DiffusionSchedule,
               table: DDIMTable, settings: SamplerSettings, *,
               generator: Optional[torch.Generator] = None,
               mask: Optional[torch.Tensor] = None,
               x0: Optional[torch.Tensor] = None,
               mask_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the DPM-Solver++(2M) loop from x_T (fp32); returns the final
    latent. model_fn(x, t) returns the CFG-combined model output, as for
    `ddim_sample`. Build the table with eta = 0 (`settings.eta` is ignored).
    mask, x0, mask_noise: the mask blend of `ddim_sample`, before each model
    call."""
    reject_ode_unsupported(settings, table, "dpm++2m")
    c = dpm_solver_pp_2m_coeffs(table)
    x = x_T.float()
    blend = make_mask_blend(schedule, settings,
                            None if mask is None else mask.to(x),
                            None if x0 is None else x0.to(x))
    p_prev = torch.zeros_like(x)
    for i in range(table.num_steps):
        with trace.span("sampler_step", step=i):
            t = int(c["t"][i])
            x = blend(x, t, None if mask_noise is None else mask_noise[i], generator)
            m0 = predict_x0(schedule, settings, x, t, c["a_t"][i], model_fn(x, t))
            p = m0 * float(c["inv_scale"][i])     # the underlying (unscaled) x0
            x = (float(c["sig_ratio"][i]) * x + float(c["order1"][i]) * p
                 + float(c["order2"][i]) * (p - p_prev))
            p_prev = p
    return x
