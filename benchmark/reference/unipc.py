"""The reference UniPC predictor-corrector step (Zhao et al., 2023,
arXiv:2302.04867) in the data-prediction form with the exact interpolant:
the x0 predictions p of the most recent steps are interpolated by the
Lagrange polynomial in lambda = log(alpha / sigma), and the exact solution
of the ODE from lambda_i to lambda_i + h,

    x_{i+1} = (sigma_{i+1} / sigma_i) x_i
              + alpha_{i+1} e^{-h} int_0^h e^tau p(lambda_i + tau) dtau,

is integrated with that interpolant, here by 24-point Gauss-Legendre
quadrature in float64. The predictor uses q = min(order, i + 1, S - i)
nodes; at the next step the model's value at the predicted point joins the
nodes and the difference of the two integrals corrects x_{i+1} (the
corrector). Under the dynamic rescale the model predicts scale_t * x0:
p is the prediction over scale_t, the integral is weighted by scale_next,
and the current node carries alpha_{i+1} e^{-h} (scale_next - scale_t),
which makes order 1 the DDIM step of eta 0. lambda at the zero-terminal-SNR
endpoint is taken at alpha_bar = 1e-20, as the program's solver takes it.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import diffusion

_NODES, _WEIGHTS = np.polynomial.legendre.leggauss(24)


def _lam(a_bar: np.ndarray) -> np.ndarray:
    a = np.clip(a_bar, 1e-20, 1.0 - 1e-12)
    return 0.5 * (np.log(a) - np.log1p(-a))


def _weights(deltas, h: float) -> np.ndarray:
    """int_0^h e^(tau - h) L_j(tau) dtau for the Lagrange basis on `deltas`."""
    tau = 0.5 * h * (_NODES + 1.0)
    w = 0.5 * h * _WEIGHTS * np.exp(tau - h)
    out = []
    for j, dj in enumerate(deltas):
        basis = np.ones_like(tau)
        for m, dm in enumerate(deltas):
            if m != j:
                basis *= (tau - dm) / (dj - dm)
        out.append(float((w * basis).sum()))
    return np.array(out)


def tables(params: dict, spacing: str, steps: int):
    """Per step, in sampling order: t, a_t, a_next, lam, h, scale_t, scale_next."""
    sched = diffusion.schedule(params)
    ts = diffusion.timesteps(spacing, steps, len(sched.alphas_cumprod))[::-1]
    a_t = sched.alphas_cumprod[ts]
    a_next = np.concatenate([a_t[1:], [sched.alphas_cumprod[0]]])
    s_t = sched.scale_arr[ts]
    s_next = np.concatenate([s_t[1:], [s_t[-1]]])
    lam = _lam(a_t)
    return dict(t=ts, a_t=a_t, a_next=a_next, lam=lam, h=_lam(a_next) - lam,
                s_t=s_t, s_next=s_next)


def worst_step(p: dict, params: dict, xs, outs, latents, device, control: bool) -> float:
    """The largest relative gap between the program's input of step i + 1
    (its final latent after the last step) and the reference step from the
    program's own inputs and outputs of steps <= i; with `control`, the
    reference's step in bfloat16 against it in float64."""
    tb = tables(params, p["spacing"], p["steps"])
    order, n = p.get("solver_order", 2), p["steps"]
    seq = p["sequential_cfg"]
    per = 2 if seq else 1
    dt = torch.bfloat16 if control else torch.float64
    q = [min(order, i + 1, n - i) for i in range(n)]
    final = torch.as_tensor(latents, device=device)[None]
    worst = 0.0

    def x0(i, dtype):
        x = xs[i * per][None].to(dtype)
        if seq:
            o_uc, o_c = outs[i * 2][0:1], outs[i * 2 + 1][0:1]
        else:
            o_uc, o_c = outs[i][0:1], outs[i][1:2]
        v = diffusion.cfg(o_uc.to(dtype), o_c.to(dtype), p["cfg_scale"], p["guidance_rescale"])
        a = float(tb["a_t"][i])
        return (a ** 0.5 * x - (1 - a) ** 0.5 * v) / float(tb["s_t"][i])

    def step(i, dtype, ps):
        """x_{i+1} from the program's x_i (before its correction) and p_0..p_i."""
        x = xs[i * per][None].to(dtype)
        if i > 0 and p.get("use_corrector", True):
            k = i - 1
            prev = [tb["lam"][k - m] - tb["lam"][k] for m in range(q[k])]
            wp = _weights(prev, tb["h"][k])
            wc = _weights([tb["h"][k]] + prev, tb["h"][k])
            corr = wc[0] * ps[i] + sum((wc[1 + m] - wp[m]) * ps[k - m] for m in range(q[k]))
            x = x + float(tb["a_next"][k] ** 0.5 * tb["s_next"][k]) * corr
        deltas = [tb["lam"][i - m] - tb["lam"][i] for m in range(q[i])]
        w = _weights(deltas, tb["h"][i])
        e_mh = float(np.exp(-tb["h"][i]))
        integral = sum(float(w[m]) * ps[i - m] for m in range(q[i]))
        sig_ratio = float(np.sqrt(1 - tb["a_next"][i]) / np.sqrt(1 - tb["a_t"][i]))
        alp = float(tb["a_next"][i] ** 0.5)
        return (sig_ratio * x + alp * float(tb["s_next"][i]) * integral
                + alp * e_mh * float(tb["s_next"][i] - tb["s_t"][i]) * ps[i])

    ps = [x0(i, dt) for i in range(n)]
    ps64 = [x0(i, torch.float64) for i in range(n)] if control else None
    for i in range(n):
        got = step(i, dt, ps)
        if control:
            want = step(i, torch.float64, ps64)
        else:
            want, got = got, (xs[(i + 1) * per][None] if i + 1 < n else final)
        worst = max(worst, harness.rel_l2(got, want))
    return worst
