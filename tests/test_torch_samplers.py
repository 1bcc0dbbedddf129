"""The dpm, unipc and ancestral samplers of the PyTorch package against the JAX
package, at TINY_MODEL_CONFIG size, fp32 on the CPU (DeepCache, the pipeline
and the CLI with these samplers: test_torch_deepcache.py).

Both packages get the same weights (one random Flax param tree exported to
reference keys, the fixture of test_torch_slice.py) and the same random
numbers (drawn with numpy and handed to both).

Tolerances: the samplers' host-side coefficients are computed in float64
and stored as float32 by both packages: equal to 1e-12 (that is, the same
float32 numbers). Sampler loops on the tiny UNet: relative L2 <= 1e-4 (a
few hundred fp32 layers per step, several steps); the achieved values are
noted at each test; on an analytic denoiser (the loop's arithmetic alone)
atol = rtol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu import schedule as jsched  # noqa: E402
from dynamicrafter_tpu.sampling import ancestral as jancestral  # noqa: E402
from dynamicrafter_tpu.sampling import ddim as jddim  # noqa: E402
from dynamicrafter_tpu.sampling import dpm as jdpm  # noqa: E402
from dynamicrafter_tpu.sampling import unipc as junipc  # noqa: E402
from dynamicrafter_tpu_torch import schedule as tsched  # noqa: E402
from dynamicrafter_tpu_torch.sampling import ancestral as tancestral  # noqa: E402
from dynamicrafter_tpu_torch.sampling import ddim as tddim  # noqa: E402
from dynamicrafter_tpu_torch.sampling import dpm as tdpm  # noqa: E402
from dynamicrafter_tpu_torch.sampling import unipc as tunipc  # noqa: E402
from test_torch_modules import randn, rel_l2, t  # noqa: E402
from test_torch_slice import HW, LAT, T, _cond_arrays, pipes  # noqa: E402,F401

SHAPE = (1, T, LAT, LAT, 4)
# the sampler-visible settings of the 512 config and of the 256 config
SCHEDULES = {
    "512": dict(build=dict(linear_start=0.00085, linear_end=0.012, parameterization="v",
                           rescale_betas_zero_snr=True, use_dynamic_rescale=True,
                           base_scale=0.7), discretize="uniform_trailing"),
    "256": dict(build=dict(linear_start=0.00085, linear_end=0.012, parameterization="eps"),
                discretize="uniform"),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The tensors here are tiny: more intra-op threads only contend with the
    other test workers' (a 0.5 s test took minutes among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(which, steps):
    spec = SCHEDULES[which]
    kw = dict(num_steps=steps, discretize=spec["discretize"], eta=0.0)
    return (jsched.build_ddim_table(jsched.build_schedule(**spec["build"]), **kw),
            tsched.build_ddim_table(tsched.build_schedule(**spec["build"]), **kw))


def _same_f32(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    if name != "t":
        assert got.dtype == np.float32 and ref.dtype == np.float32, name
    np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                               atol=1e-12, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# host-side coefficients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 2, 10, 30])
@pytest.mark.parametrize("which", ["512", "256"])
def test_dpm_coeffs_equal_jax(which, steps):
    jtab, ttab = _tables(which, steps)
    ref, got = jdpm.dpm_solver_pp_2m_coeffs(jtab), tdpm.dpm_solver_pp_2m_coeffs(ttab)
    assert set(got) == set(ref)
    for name in ref:
        _same_f32(got[name], ref[name], name)
    assert np.isfinite(got["order1"]).all() and np.isfinite(got["order2"]).all()


@pytest.mark.parametrize("corrector", [True, False])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("which", ["512", "256"])
def test_unipc_coeffs_equal_jax(which, order, corrector):
    for steps in (2, 10):
        jtab, ttab = _tables(which, steps)
        ref = junipc.unipc_coeffs(jtab, order, corrector)
        got = tunipc.unipc_coeffs(ttab, order, corrector)
        assert set(got) == set(ref)
        for name in ref:
            _same_f32(got[name], ref[name], name)
        assert (got["corr_w"] != 0).any() == (corrector and steps > 1)


def test_unipc_refuses_other_orders():
    _, ttab = _tables("512", 4)
    for order in (0, 4):
        with pytest.raises(ValueError, match="orders 1..3"):
            tunipc.unipc_coeffs(ttab, order, True)


def test_log_slots_equal_jax():
    save = np.array([True, False, False, True, True, False])
    n, slots = tancestral.log_slots(save)
    jn, jslots = jancestral.log_slots(save)
    assert n == jn == 3
    np.testing.assert_array_equal(slots, np.asarray(jslots))


# ---------------------------------------------------------------------------
# the sampler loops on the tiny UNet
# ---------------------------------------------------------------------------

def _j_unet_apply(jp):
    def unet_apply(p, x, ts, context_text, context_img, fs, **kw):
        return jp.unet.apply({"params": p}, x, ts, context_text=context_text,
                             context_img=context_img, fs=fs, **kw)
    return unet_apply


def _conds(arrs):
    jcond = jddim.CFGConditioning(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tcond = tddim.CFGConditioning(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    return jcond, tcond._replace(fs=tcond.fs.long())


def _j_analytic(x, ts):
    return jnp.tanh(x) * 0.5 + 1e-3 * ts[0]


def _t_analytic(x, t):
    return torch.tanh(x) * 0.5 + 1e-3 * t


def _run_both(pipes, sampler, steps, *, seed, unet=True, mask=False, sequential_cfg=False,
              **settings):
    """One sampler loop in both packages with the 512 config's schedule: on
    the tiny UNet with 2-pass CFG and guidance rescale, or (`unet=False`) on
    an analytic denoiser, which holds the loop's arithmetic alone; with
    `mask`, a mask, x0 and pre-drawn mask noise. Returns (port latent, JAX
    latent)."""
    jp, tp = pipes
    rng = np.random.default_rng(seed)
    arrs = _cond_arrays(rng)
    x_T = randn(rng, *SHAPE)
    kw = dict(steps=steps, discretize="uniform_trailing", eta=0.0, cfg_scale=7.5,
              guidance_rescale=0.7, parameterization="v", sampler=sampler,
              sequential_cfg=sequential_cfg, **settings)
    jset, tset = jddim.SamplerSettings(**kw), tddim.SamplerSettings(**kw)
    tab_kw = dict(num_steps=steps, discretize="uniform_trailing", eta=0.0)
    jtab = jsched.build_ddim_table(jp.schedule, **tab_kw)
    ttab = tsched.build_ddim_table(tp.schedule, **tab_kw)
    extra = {}
    if mask:
        extra = dict(mask=(rng.random(SHAPE) < 0.4).astype(np.float32), x0=randn(rng, *SHAPE),
                     mask_noise=randn(rng, steps, *SHAPE))
    jfn = {"ddim": jddim.ddim_sample, "dpm": jdpm.dpm_sample, "unipc": junipc.unipc_sample}
    tfn = {"ddim": tddim.ddim_sample, "dpm": tdpm.dpm_sample, "unipc": tunipc.unipc_sample}
    jcond, tcond = _conds(arrs)

    @jax.jit
    def run(params, x_T, cond, extra):
        fn = (jddim.make_cfg_denoiser(_j_unet_apply(jp), params, cond, jset) if unet
              else _j_analytic)
        return jfn[sampler](fn, x_T, jp.schedule, jtab, jset, **extra)

    ref = np.asarray(run(jp.params["unet"], x_T, jcond,
                         {k: jnp.asarray(v) for k, v in extra.items()}))
    model_fn = tddim.make_cfg_denoiser(tp.unet, tcond, tset) if unet else _t_analytic
    out = tfn[sampler](model_fn, t(x_T), tp.schedule, ttab, tset,
                       **{k: t(v) for k, v in extra.items()}).numpy()
    return out, ref


@pytest.mark.parametrize("sampler", ["dpm", "unipc"])
def test_ode_samplers_on_the_tiny_unet_match_jax(pipes, sampler):
    """5 steps of DPM-Solver++(2M) and of unipc (order 2 with the corrector)
    on the tiny UNet, with a mask, x0 and pre-drawn mask noise. This also
    pins the mask behaviour of the JAX loops: the latent is blended with the
    noised x0 before each model call and, in unipc, the corrector for the
    previous step is applied AFTER that blend (so it also moves the held
    region until the next blend). Achieved rel L2 5.1e-6 and 6.0e-6."""
    out, ref = _run_both(pipes, sampler, 5, seed=32, mask=True)
    assert np.isfinite(out).all() and rel_l2(out, ref) <= 1e-4


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("sampler,settings", [
    ("dpm", {}), ("unipc", dict(solver_order=1)), ("unipc", dict(solver_order=2)),
    ("unipc", dict(solver_order=3)), ("unipc", dict(solver_order=3, use_corrector=False))],
    ids=["dpm", "unipc1", "unipc2", "unipc3", "unipc3-nocorr"])
def test_ode_sampler_arithmetic_matches_jax(pipes, sampler, settings, mask):
    """The loops' arithmetic alone, 8 steps on an analytic denoiser: every
    order, with and without the corrector and the mask. fp32 sums of a
    handful of terms per step: atol = rtol = 1e-5."""
    out, ref = _run_both(pipes, sampler, 8, seed=31, unet=False, mask=mask, **settings)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_unipc_corrector_acts_after_the_blend(pipes):
    """On an analytic denoiser, by hand: two steps of unipc order 1 with the
    corrector and a mask. Step 2 blends, evaluates the model at the blended
    x, then adds corr_w[1, 0] * p_1 + corr_w[1, 1] * p_0 to the blended x
    before predicting."""
    _, tp = pipes
    rng = np.random.default_rng(33)
    x_T, x0 = t(randn(rng, *SHAPE)), t(randn(rng, *SHAPE))
    mask = t((rng.random(SHAPE) < 0.5).astype(np.float32))
    mnoise = t(randn(rng, 2, *SHAPE))
    ttab = tsched.build_ddim_table(tp.schedule, num_steps=2, discretize="uniform_trailing",
                                   eta=0.0)
    st = tddim.SamplerSettings(steps=2, sampler="unipc", solver_order=1)
    model = lambda x, ts: torch.tanh(x) * 0.5
    got = tunipc.unipc_sample(model, x_T, tp.schedule, ttab, st, mask=mask, x0=x0,
                              mask_noise=mnoise)
    c = tunipc.unipc_coeffs(ttab, 1, True)
    blend = tddim.make_mask_blend(tp.schedule, st, mask, x0)
    x, ps = x_T, []
    for i in range(2):
        ti = int(c["t"][i])
        x = blend(x, ti, mnoise[i], None)
        p = tp.schedule.predict_start_from_z_and_v(x, ti, model(x, ti)) * float(c["inv_scale"][i])
        if i == 1:
            x = x + float(c["corr_w"][1, 0]) * p + float(c["corr_w"][1, 1]) * ps[0]
        x = float(c["sig_ratio"][i]) * x + float(c["pred_w"][i, 0]) * p
        ps.append(p)
    assert float(c["corr_w"][1, 0]) != 0.0
    np.testing.assert_allclose(got.numpy(), x.numpy(), atol=1e-6, rtol=1e-6)


def test_unipc_order1_without_corrector_is_ddim_eta0(pipes):
    _, tp = pipes
    rng = np.random.default_rng(34)
    arrs = _cond_arrays(rng)
    x_T = t(randn(rng, *SHAPE))
    kw = dict(steps=5, discretize="uniform_trailing", eta=0.0, guidance_rescale=0.7)
    ttab = tsched.build_ddim_table(tp.schedule, num_steps=5, discretize="uniform_trailing",
                                   eta=0.0)
    _, tcond = _conds(arrs)
    s_ddim = tddim.SamplerSettings(**kw)
    s_uni = tddim.SamplerSettings(**kw, sampler="unipc", solver_order=1, use_corrector=False)
    fn = tddim.make_cfg_denoiser(tp.unet, tcond, s_ddim)
    a = tddim.ddim_sample(fn, x_T, tp.schedule, ttab, s_ddim)
    b = tunipc.unipc_sample(fn, x_T, tp.schedule, ttab, s_uni)
    assert rel_l2(b.numpy(), a.numpy()) <= 1e-5


@pytest.mark.parametrize("parameterization,unet", [("v", True), ("eps", False), ("x0", False)])
def test_p_sample_loop_matches_jax(pipes, parameterization, unet):
    """The last 7 ancestral steps (t = 6 .. 0) with pre-drawn noise, a mask
    with pre-drawn mask noise, and intermediates every 3 steps: "v" on the
    tiny UNet, "eps" and "x0" on an analytic denoiser. Achieved rel L2 1.1e-7
    (latent and intermediates)."""
    jp, tp = pipes
    rng = np.random.default_rng(35)
    steps = 7
    arrs = _cond_arrays(rng, p=1)
    x_T, x0 = randn(rng, *SHAPE), randn(rng, *SHAPE)
    mask = (rng.random(SHAPE) < 0.4).astype(np.float32)
    noise, mnoise = randn(rng, steps, *SHAPE), randn(rng, steps, *SHAPE)
    build = dict(SCHEDULES["512" if parameterization == "v" else "256"]["build"])
    jschedule, tschedule = jsched.build_schedule(**build), tsched.build_schedule(**build)
    jset, tset = jddim.SamplerSettings(cfg_scale=1.0), tddim.SamplerSettings(cfg_scale=1.0)
    jcond, tcond = _conds(arrs)
    kw = dict(parameterization=parameterization, timesteps=steps, log_every_t=3,
              return_intermediates=True)

    @jax.jit
    def run(params, x_T, cond, arrays):
        fn = (jddim.make_cfg_denoiser(_j_unet_apply(jp), params, cond, jset) if unet
              else _j_analytic)
        return jancestral.p_sample_loop(fn, x_T, jschedule, **arrays, **kw)

    ref, ref_inter = run(jp.params["unet"], x_T, jcond,
                         {k: jnp.asarray(v) for k, v in dict(
                             noise=noise, mask=mask, x0=x0, mask_noise=mnoise).items()})
    out, inter = tancestral.p_sample_loop(
        tddim.make_cfg_denoiser(tp.unet, tcond, tset) if unet else _t_analytic, t(x_T),
        tschedule, noise=t(noise),
        mask=t(mask), x0=t(x0), mask_noise=t(mnoise), **kw)
    assert inter.shape == ref_inter.shape == (1 + 3, *SHAPE)     # x_T, t = 6, 3, 0
    assert rel_l2(out.numpy(), np.asarray(ref)) <= 1e-4
    assert rel_l2(inter.numpy(), np.asarray(ref_inter)) <= 1e-4
    np.testing.assert_array_equal(inter[0].numpy(), x_T)


def test_p_sample_loop_draws_from_the_generator(pipes):
    """Without pre-drawn arrays the update draws before the blend, from the
    one generator; without intermediates only the latent comes back."""
    _, tp = pipes
    rng = np.random.default_rng(36)
    x_T, x0 = t(randn(rng, *SHAPE)), t(randn(rng, *SHAPE))
    mask = t((rng.random(SHAPE) < 0.5).astype(np.float32))
    model = lambda x, ts: torch.tanh(x) * 0.5
    run = lambda **kw: tancestral.p_sample_loop(model, x_T, tp.schedule, parameterization="v",
                                                timesteps=3, mask=mask, x0=x0, **kw)
    a = run(generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    draws = [torch.randn(SHAPE, generator=g) for _ in range(6)]
    b = run(noise=torch.stack(draws[0::2]), mask_noise=torch.stack(draws[1::2]))
    assert isinstance(a, torch.Tensor)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="needs x0"):
        tancestral.p_sample_loop(model, x_T, tp.schedule, timesteps=2, mask=mask)


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------

def test_sampler_raises(pipes):
    _, tp = pipes
    model = lambda x, ts, **kw: x
    x_T = torch.zeros(SHAPE)
    _, ttab = _tables("512", 6)
    # DeepCache: the interval divides the steps; no logged intermediates
    with pytest.raises(ValueError, match="must divide steps=6"):
        tddim.ddim_sample(model, x_T, tp.schedule, ttab, tddim.SamplerSettings(deepcache=4))
    with pytest.raises(ValueError, match="require the exact sampler"):
        tddim.ddim_sample(model, x_T, tp.schedule, ttab, tddim.SamplerSettings(deepcache=3),
                          log_every_t=2)
    # the ODE solvers: no DeepCache; no eps-parameterization at zero terminal SNR
    for fn in (tdpm.dpm_sample, tunipc.unipc_sample):
        with pytest.raises(ValueError, match="only certified with the DDIM"):
            fn(model, x_T, tp.schedule, ttab, tddim.SamplerSettings(deepcache=2))
        with pytest.raises(ValueError, match="zero-terminal-SNR"):
            fn(model, x_T, tp.schedule, ttab, tddim.SamplerSettings(parameterization="eps"))
    # eps without zero terminal SNR (the 256 config) is fine
    _, ttab256 = _tables("256", 4)
    sched256 = tsched.build_schedule(**SCHEDULES["256"]["build"])
    out = tdpm.dpm_sample(lambda x, ts: torch.tanh(x), x_T + 1.0, sched256, ttab256,
                          tddim.SamplerSettings(parameterization="eps"))
    assert bool(torch.isfinite(out).all())


def test_pipeline_sample_raises(pipes):
    _, tp = pipes
    videos = np.zeros((1, T, HW, HW, 3), np.float32)
    with pytest.raises(ValueError, match="unknown sampler 'euler'"):
        tp.sample(["x"], videos, steps=2, sampler="euler")
    for sampler in ("dpm", "unipc"):
        with pytest.raises(ValueError, match="DDIM-surface feature"):
            tp.sample(["x"], videos, steps=2, sampler=sampler, log_every_t=1)
        with pytest.raises(ValueError, match="only certified with the DDIM"):
            tp.sample(["x"], videos, steps=2, sampler=sampler, deepcache=2)
    with pytest.raises(ValueError, match="require the exact sampler"):
        tp.sample(["x"], videos, steps=2, deepcache=2, log_every_t=1)
    with pytest.raises(ValueError, match="must divide steps=5"):
        tp.sample(["x"], videos, steps=5, deepcache=2)
