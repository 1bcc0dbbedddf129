r"""UniPC-style predictor-corrector multistep sampling (Zhao et al., 2023,
arXiv:2302.04867), orders 1 to 3, one model call per step: the corrector
reuses the model evaluation the next step makes anyway.

JAX twin dynamicrafter_tpu/sampling/unipc.py, whose loop is one lax.scan;
here it is a Python loop over the steps, as in `sampling/ddim.py`.

Derivation (the exact-interpolant variant). With alpha_t = sqrt(abar),
sigma_t = sqrt(1 - abar), lambda = log(alpha / sigma), the data-prediction
form of the exact ODE solution from lambda_i to lambda_{i+1} = lambda_i + h
is

    x_{i+1} = (sigma_{i+1}/sigma_i) x_i
              + alpha_{i+1} e^{-h} \int_0^h e^tau x0hat(lambda_i + tau) dtau.

Predictor: replace x0hat by the Lagrange interpolant through the q most
recent model values p_{i-j} at node offsets delta_j = lambda_{i-j} -
lambda_i (delta_0 = 0) and integrate exactly:

    x_{i+1} = (sigma_{i+1}/sigma_i) x_i + alpha_{i+1} sum_j W_j p_{i-j},
    W_j = \int_0^h e^{tau-h} L_j(tau) dtau,

with E_n = \int_0^h e^{tau-h} tau^n dtau from the recurrence E_0 = 1 -
e^{-h}, E_n = h^n - n E_{n-1}, on the host in float64.

Corrector: at the next step the model is evaluated at the predicted x_{i+1},
giving p_{i+1}; the step is redone with the node set extended by (h,
p_{i+1}), and only the difference from the predictor is applied:

    x_{i+1} += alpha_{i+1} [ Wc_new p_{i+1} + sum_j (Wc_j - W_j) p_{i-j} ].

In the loop the corrector acts on the x the model was evaluated at, that
is, AFTER the mask blend of the step (as the JAX loop does): with a mask the
correction also moves the held region, which the next blend resets.

As in `sampling/dpm.py`: coefficients on the host in float64 with lambda(999)
clipped there; the order ramps up over the first steps and down to 1 at the
last; dynamic rescale interpolates the underlying x0 (prediction divided by
scale_t), scale_next multiplies the integral weights and the current node
carries the exact one-step correction; eps-parameterization with
zero-terminal SNR is refused. Order 1 without the corrector is the DDIM
eta = 0 map.
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
from dynamicrafter_tpu_torch.sampling.dpm import ode_step_tables, predict_x0
from dynamicrafter_tpu_torch.utils import trace


def _exp_integrals(h: float, n_max: int) -> list:
    """E_n = int_0^h e^(tau-h) tau^n dtau for n = 0..n_max (float64): E_0 =
    1 - e^{-h} via expm1, E_n = h^n - n E_{n-1}."""
    e = [-np.expm1(-h)]
    for n in range(1, n_max + 1):
        e.append(h ** n - n * e[n - 1])
    return e


def _lagrange_exp_weights(deltas: np.ndarray, h: float) -> np.ndarray:
    """W_j = int_0^h e^(tau-h) L_j(tau) dtau for the Lagrange basis L_j on
    the node offsets `deltas` (float64). sum_j W_j == E_0."""
    q = len(deltas)
    ee = _exp_integrals(h, q - 1)
    w = np.zeros(q)
    for j in range(q):
        coeffs = np.array([1.0])      # ascending powers of tau
        denom = 1.0
        for m in range(q):
            if m == j:
                continue
            coeffs = np.convolve(coeffs, np.array([-deltas[m], 1.0]))
            denom *= deltas[j] - deltas[m]
        w[j] = sum(c * ee[n] for n, c in enumerate(coeffs)) / denom
    return w


def unipc_coeffs(table: DDIMTable, order: int, use_corrector: bool) -> Dict[str, np.ndarray]:
    """Per-step constants, computed in float64 and returned as float32 in
    scan order: pred_w (S, order) on nodes [p_i, p_{i-1}, ...]; corr_w
    (S, order + 1) on nodes [p_i (new), p_{i-1}, ...], correcting the
    previous step's output (row 0 is zeros); t, a_t, inv_scale, sig_ratio."""
    if not 1 <= order <= 3:
        raise ValueError(f"unipc supports solver orders 1..3, got {order}")
    s = table.num_steps
    st = ode_step_tables(table)
    lam_t, h, alp_next = st["lam_t"], st["h"], st["alp_next"]
    scale_t, scale_next = st["scale_t"], st["scale_next"]
    e_mh = np.exp(-h)

    pred_w = np.zeros((s, order))
    corr_w = np.zeros((s, order + 1))
    # predictor order at step k: up with the history, down to 1 at the end
    q = [min(order, k + 1, s - k) for k in range(s)]
    lag_w = []
    for k in range(s):
        deltas = lam_t[k - np.arange(q[k])] - lam_t[k]   # <= 0, delta_0 = 0
        w = _lagrange_exp_weights(deltas, h[k])
        lag_w.append(w)
        pred_w[k, :q[k]] = scale_next[k] * w
        # the coefficient of a constant p must be scale_next - e^{-h} scale_t
        pred_w[k, 0] += e_mh[k] * (scale_next[k] - scale_t[k])
        pred_w[k] *= alp_next[k]
        if use_corrector and k > 0:
            # correct the step k-1 -> k: the predictor's nodes and h_{k-1}
            deltas_p = lam_t[k - 1 - np.arange(q[k - 1])] - lam_t[k - 1]
            wc = _lagrange_exp_weights(np.concatenate([[h[k - 1]], deltas_p]), h[k - 1])
            diff = wc - np.concatenate([[0.0], lag_w[k - 1]])
            corr_w[k, :q[k - 1] + 1] = alp_next[k - 1] * scale_next[k - 1] * diff
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return {
        "t": np.asarray(table.timesteps)[st["idx"]],
        "a_t": f32(st["a_t"]),
        "inv_scale": f32(1.0 / scale_t),
        "sig_ratio": f32(st["sig_ratio"]),
        "pred_w": f32(pred_w),
        "corr_w": f32(corr_w),
    }


@torch.no_grad()
def unipc_sample(model_fn: Callable, x_T: torch.Tensor, schedule: DiffusionSchedule,
                 table: DDIMTable, settings: SamplerSettings, *,
                 generator: Optional[torch.Generator] = None,
                 mask: Optional[torch.Tensor] = None,
                 x0: Optional[torch.Tensor] = None,
                 mask_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the predictor-corrector loop from x_T (fp32); returns the final
    latent. model_fn(x, t) returns the CFG-combined model output, as for
    `ddim_sample`. Build the table with eta = 0 (`settings.eta` is ignored).
    `settings.solver_order` (1..3) and `settings.use_corrector` select the
    scheme. mask, x0, mask_noise: the mask blend of `ddim_sample`, before
    each model call."""
    reject_ode_unsupported(settings, table, "unipc")
    order = settings.solver_order
    c = unipc_coeffs(table, order, settings.use_corrector)
    x = x_T.float()
    blend = make_mask_blend(schedule, settings,
                            None if mask is None else mask.to(x),
                            None if x0 is None else x0.to(x))
    hist = [torch.zeros_like(x) for _ in range(order)]   # most recent first
    for i in range(table.num_steps):
        with trace.span("sampler_step", step=i):
            t = int(c["t"][i])
            x = blend(x, t, None if mask_noise is None else mask_noise[i], generator)
            m0 = predict_x0(schedule, settings, x, t, c["a_t"][i], model_fn(x, t))
            nodes = [m0 * float(c["inv_scale"][i]), *hist]    # [p_k, p_{k-1}, ...]
            # corrector for the previous step (its row is zeros at k = 0)
            for j in range(order + 1):
                x = x + float(c["corr_w"][i, j]) * nodes[j]
            # predictor to the next node
            xn = float(c["sig_ratio"][i]) * x
            for j in range(order):
                xn = xn + float(c["pred_w"][i, j]) * nodes[j]
            x, hist = xn, nodes[:order]
    return x
