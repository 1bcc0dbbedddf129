"""The sp axis of `dynamicrafter_tpu_torch` (a clip's frames split over the
ranks of an sp group) on two and four spawned `gloo` processes on the CPU,
fp32, against the one-process port and the JAX package.

The JAX package has no collective of its own here: XLA inserts them where
its layouts change (tests/test_sp_collectives.py pins the plan). The port
writes them out, so each is held to a reference computed whole: (a) each
sp collective and its backward; (b) the per-clip GroupNorm, the temporal
conv block and the TemporalTransformer in all three layouts; (c) the UNet
at (dp, sp) = (1, 2), (1, 4), (2, 2), against the one-process UNet and the
JAX UNet on the same numpy inputs (atol 2e-4, as
tests/test_sp_executed_inference.py); (d) an odd frame count (every rank
runs the whole clip) and a level whose HW sp does not divide (that stage
runs replicated); (e) the samplers (DDIM with eta 1, guidance rescale 0.7,
2- and 3-pass CFG, generator draws with a mask blend, dpm, DeepCache); (f)
the collectives of one UNet call against the formula of
tests/test_sp_collectives.py; (g) `train.main --sp 2`, and `--dp 2 --sp 2`
on four ranks, against the one-process trainer; (h) the rank layout of `create_mesh` against JAX's
`devices.reshape(dp, sp)`.

The spawned ranks import this file, so it imports no JAX at the top; the
JAX references are computed in the test process. One spawn of two ranks
and one of four run every UNet-level case (module-scoped fixtures), and
each case then compares what they saved.
"""
import copy
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402  (a plain dict)
from dynamicrafter_tpu_torch import schedule as tsched  # noqa: E402
from dynamicrafter_tpu_torch.models.blocks import TemporalConvBlock, TemporalTransformer  # noqa: E402
from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel, _build_level_specs  # noqa: E402
from dynamicrafter_tpu_torch.ops.norms import ClipGroupNorm  # noqa: E402
from dynamicrafter_tpu_torch.parallel import sharding  # noqa: E402
from dynamicrafter_tpu_torch.sampling import ddim as tddim  # noqa: E402
from dynamicrafter_tpu_torch.sampling.dpm import dpm_sample  # noqa: E402
from dynamicrafter_tpu_torch.utils.weights import init_normal_  # noqa: E402
from test_torch_parallel import few_torch_threads, run_ranks  # noqa: E402,F401

UNET = TINY_MODEL_CONFIG["model"]["params"]["unet_config"]["params"]
T, LAT, B = 4, 8, 2
STEPS = 2
SCHEDULE = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
                linear_end=0.012, parameterization="v", rescale_betas_zero_snr=True,
                use_dynamic_rescale=True, base_scale=0.7, turning_step=400)
# sampler cases: settings, passes, pre-drawn noise (else the generator), extras
SAMPLERS = {
    "ddim_2pass": (dict(eta=1.0, guidance_rescale=0.7), 2, True, {}),
    "ddim_3pass": (dict(eta=1.0, guidance_rescale=0.7, cfg_img=1.5), 3, True, {}),
    "ddim_generator_mask": (dict(eta=1.0, guidance_rescale=0.7), 2, False, {"mask": True}),
    "dpm": (dict(eta=0.0, sampler="dpm"), 2, False, {}),
    "deepcache": (dict(eta=1.0, deepcache=2), 2, True, {}),
}
MODULES = ["group_norm", "temporal_conv", "temporal_conv_spatial_aware",
           "temporal_transformer", "temporal_transformer_relative_position",
           "temporal_transformer_causal", "temporal_transformer_hw_not_divisible"]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def flat(tensors) -> np.ndarray:
    return torch.cat([t.reshape(-1) for t in tensors]).numpy()


def plan(cfg: UNetConfig, shallow: bool = False):
    """(TemporalTransformers with init_attn, temporal convs) of one UNet
    call: the formula of tests/test_sp_collectives.py::_expected; with
    `shallow`, of DeepCache's shallow call (the top input and output
    blocks)."""
    in_s, mid_s, out_s = _build_level_specs(cfg)
    blocks = in_s + [mid_s] + out_s
    if shallow:
        blocks = in_s[:1 + cfg.num_res_blocks] + out_s[-(cfg.num_res_blocks + 1):]
    n_temporal = sum(1 for b in blocks for s in b if s[0] == "temporal")
    n_temporal += int(cfg.addition_attention)
    n_res = sum(1 for b in blocks for s in b if s[0] == "res")
    return n_temporal, 4 * n_res if cfg.temporal_conv else 0


def _unet(state_path):
    unet = UNetModel(UNetConfig.from_dict(UNET))
    sd = torch.load(state_path)
    unet.load_state_dict({k[len("model.diffusion_model."):]: v for k, v in sd.items()},
                         strict=True)
    return unet.eval()


def _module(name: str):
    """The module of case `name` with seeded N(0, 0.1) weights (norm scales
    around 1), and its input (B, C, T, 4, 4) or, at HW 15, (B, C, T, 3, 5)."""
    torch.manual_seed(7)
    if name == "group_norm":
        m = ClipGroupNorm(32, 64)
    elif name.startswith("temporal_conv"):
        m = TemporalConvBlock(64, spatial_aware=name.endswith("aware"))
    else:
        m = TemporalTransformer(64, 4, 16, temporal_length=T,
                                relative_position=name.endswith("position"),
                                causal_attention=name.endswith("causal"))
    init_normal_(m, torch.Generator().manual_seed(8), 0.1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.GroupNorm) or type(mod).__name__.endswith("Norm"):
                mod.weight.add_(1.0)
    hw = (3, 5) if name.endswith("not_divisible") else (4, 4)
    x = torch.randn(B, 64, T, *hw, generator=torch.Generator().manual_seed(9))
    g = torch.randn(B, 64, T, *hw, generator=torch.Generator().manual_seed(10))
    return m, x, g


def _run_module(name, m, x, frames):
    """The module on (B, C, T', h, w) -> (B, C, T', h, w), T' = x's frames."""
    if name == "group_norm":
        return m(x) if frames is None else m(x, frames)
    b, c, t, h, w = x.shape
    rows = x.transpose(1, 2).reshape(b * t, c, h, w)
    y = m(rows, t) if frames is None else m(rows, t, frames)
    return y.view(b, t, c, h, w).transpose(1, 2)


def _module_results(name, frames=None):
    """Output, input gradient and parameter gradients of module case `name`
    (this rank's frames, the sp ranks' parameter gradients summed)."""
    m, x, g = _module(name)
    if frames is not None:
        x, g = frames.slice(x, 2), frames.slice(g, 2)
    x = x.clone().requires_grad_(True)
    y = _run_module(name, m, x, frames)
    (y * g).sum().backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in m.parameters()]
    if frames is not None:
        sharding.sp_sum_(grads, frames.mesh)
    return {"y": y.detach(), "gx": x.grad, "grads": flat(grads)}


def _collective_errors(mesh):
    """(a): each sp collective on this rank's frames of seeded whole
    tensors, forward and backward, against what the whole tensors give:
    the largest absolute difference a collective and direction."""
    split = sharding.FrameSplit(mesh, 2 * mesh.sp)
    r, sp = mesh.sp_rank, mesh.sp
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, split.t, 4 * sp, 3, generator=gen)          # (B, T, HW, C)
    g = torch.randn(2, split.t, 4 * sp, 3, generator=gen)
    lo, tl, m = split.lo, split.local, 4
    err = {}
    # frames_to_tokens: this rank gets every frame of its HW piece; the
    # backward brings each rank's frames the gradient of every piece
    xl = split.slice(x).clone().requires_grad_(True)
    tok = sharding.frames_to_tokens(xl, split)
    err["frames_to_tokens"] = float((tok - x[:, :, r * m:(r + 1) * m]).abs().max())
    (tok * g[:, :, r * m:(r + 1) * m]).sum().backward()
    err["frames_to_tokens_backward"] = float((xl.grad - split.slice(g)).abs().max())
    yl = x[:, :, r * m:(r + 1) * m].clone().requires_grad_(True)
    fr = sharding.tokens_to_frames(yl, split)
    err["tokens_to_frames"] = float((fr - split.slice(x)).abs().max())
    (fr * split.slice(g)).sum().backward()
    err["tokens_to_frames_backward"] = float((yl.grad - g[:, :, r * m:(r + 1) * m]).abs().max())
    # halo along dim 2 of (B, C, T, H, W)
    v = torch.randn(2, 3, split.t, 2, 2, generator=gen)
    wa = torch.randn(sp, 2, 3, 1, 2, 2, generator=gen)     # weights of each rank's prev
    wb = torch.randn(sp, 2, 3, 1, 2, 2, generator=gen)     # and next frame in the loss
    vl = split.slice(v, 2).clone().requires_grad_(True)
    prev, nxt = sharding.halo(vl, split, dim=2)
    want_prev = v[:, :, lo - 1:lo] if r > 0 else torch.zeros_like(prev)
    want_next = v[:, :, lo + tl:lo + tl + 1] if r < sp - 1 else torch.zeros_like(nxt)
    err["halo"] = max(float((prev - want_prev).abs().max()), float((nxt - want_next).abs().max()))
    (prev * wa[r] + nxt * wb[r]).sum().backward()
    want = torch.zeros_like(vl)
    if r > 0:
        want[:, :, :1] += wb[r - 1]
    if r < sp - 1:
        want[:, :, -1:] += wa[r + 1]
    err["halo_backward"] = float((vl.grad - want).abs().max())
    # sp_all_reduce: rank k adds c[k]; every rank's loss reads the sum
    c = torch.randn(sp, 4, 3, generator=gen)
    wc = torch.randn(sp, 4, 3, generator=gen)
    a = c[r].clone().requires_grad_(True)
    total = sharding.sp_all_reduce(a, split)
    err["sp_all_reduce"] = float((total - c.sum(0)).abs().max())
    (total * wc[r]).sum().backward()
    err["sp_all_reduce_backward"] = float((a.grad - wc.sum(0)).abs().max())
    # sp_gather_frames: the whole clip; the backward sums every rank's gradient
    xl = split.slice(x).clone().requires_grad_(True)
    full = sharding.sp_gather_frames(xl, split)
    err["sp_gather_frames"] = float((full - x).abs().max())
    wg = torch.randn(sp, *x.shape, generator=gen)
    (full * wg[r]).sum().backward()
    err["sp_gather_frames_backward"] = float((xl.grad - split.slice(wg.sum(0))).abs().max())
    return err



# -- the spawned ranks --------------------------------------------------------

def _unet_call(unet, mesh, arrays, x_key, ci_key, grad=False):
    """One UNet call on the inputs `x_key` / `ci_key` under `mesh` (rows
    over dp through `pipeline.split_rows`, frames over sp): this rank's
    frames of the output, the collectives of the call, and with `grad` the
    gradients of sum(out * g) (parameter gradients summed over sp)."""
    from dynamicrafter_tpu_torch.pipeline import split_rows

    a = {k: torch.from_numpy(arrays[k]) for k in ("ts", "ct", "fs", "g", x_key, ci_key)}
    x = a[x_key]
    split = sharding.split_frames(x.shape[1], mesh)
    mine = (lambda v: v) if split is None else split.slice
    fn = unet if mesh.dp == 1 else split_rows(unet, mesh)
    xl = mine(x).clone().requires_grad_(grad)
    sharding.collectives.clear()
    with sharding.use_mesh(mesh), sharding.use_frames(split), torch.set_grad_enabled(grad):
        y = fn(xl, a["ts"].long(), context_text=a["ct"], context_img=a[ci_key],
               fs=a["fs"].long())
    out = {"y": y.detach(), "calls": dict(sharding.collectives)}
    if grad:
        (y * mine(a["g"])).sum().backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in unet.parameters()]
        if split is not None:
            sharding.sp_sum_(grads, mesh)
        out.update(gx=xl.grad, grads=flat(grads))
        unet.zero_grad(set_to_none=True)
    return out


def _sample(unet, arrays, name, split=None):
    """Sampler case `name` from x_T on the tiny UNet; with `split` on this
    rank's frames (the draws and pre-drawn noise whole, sliced)."""
    kw, passes, predrawn, extra = SAMPLERS[name]
    settings = tddim.SamplerSettings(steps=STEPS, discretize="uniform_trailing", cfg_scale=7.5,
                                     parameterization="v", **kw)
    schedule = tsched.build_schedule(**SCHEDULE)
    table = tsched.build_ddim_table(schedule, num_steps=STEPS, discretize="uniform_trailing",
                                    eta=settings.eta)
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    mine = (lambda v, dim=1: v) if split is None else split.slice
    cond = tddim.CFGConditioning(context_text=a["s_ct"][:passes],
                                 context_img=a["s_ci"][:passes],
                                 concat=mine(a["s_cc"][:passes], 2), fs=a["s_fs"].long())
    fn = tddim.make_cfg_denoiser(unet, cond, settings)
    gen = None if predrawn else torch.Generator().manual_seed(5)
    with torch.no_grad(), sharding.use_frames(split):
        if settings.sampler == "dpm":
            return dpm_sample(fn, mine(a["s_x_T"]), schedule, table, settings, generator=gen)
        blend = dict(mask=mine(a["s_mask"]), x0=mine(a["s_x0"])) if extra.get("mask") else {}
        return tddim.ddim_sample(fn, mine(a["s_x_T"]), schedule, table, settings,
                                 noise=a["s_noise"] if predrawn else None, generator=gen,
                                 **blend)


def _rank_sp2(rank, world, d):
    mesh = sharding.create_mesh(1, 2)
    arrays = dict(np.load(os.path.join(d, "inputs.npz")))
    unet = _unet(os.path.join(d, "unet.pt"))
    out = {"collectives": _collective_errors(mesh)}
    split = sharding.FrameSplit(mesh, T)
    for name in MODULES:
        out[name] = _module_results(name, split)
    out["unet"] = _unet_call(unet, mesh, arrays, "x", "ci", grad=True)
    out["unet_odd_frames"] = _unet_call(unet, mesh, arrays, "x_odd", "ci_odd")
    out["unet_hw_not_divisible"] = _unet_call(unet, mesh, arrays, "x_hw", "ci")
    for name in SAMPLERS:
        sharding.collectives.clear()
        y = _sample(unet, arrays, name, split)
        out[f"sampler_{name}"] = {"y": y, "calls": dict(sharding.collectives)}
    torch.save(out, os.path.join(d, f"sp2_rank{rank}.pt"))


def _rank_world4(rank, world, d):
    """sp = 4, then a (2, 2) mesh in the same group: both meshes' groups,
    made in one order on every rank."""
    arrays = dict(np.load(os.path.join(d, "inputs.npz")))
    unet = _unet(os.path.join(d, "unet.pt"))
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = sharding.create_mesh(*shape)
        ranks = lambda g: torch.distributed.get_process_group_ranks(g)
        out[shape] = {"groups": (ranks(mesh.group), ranks(mesh.sp_group)),
                      "unet": _unet_call(unet, mesh, arrays, "x", "ci")}
        if shape == (1, 4):
            out[shape]["collectives"] = _collective_errors(mesh)
            out[shape]["unet_hw_not_divisible"] = _unet_call(unet, mesh, arrays, "x_hw", "ci")
    torch.save(out, os.path.join(d, f"world4_rank{rank}.pt"))


# -- the one-process and JAX references ---------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Random JAX UNet params (numpy-filled, nothing zero) exported to the
    port's keys, and every numpy input of the UNet and sampler cases."""
    import jax.numpy as jnp

    from dynamicrafter_tpu.models.unet3d import UNetConfig as JConfig
    from dynamicrafter_tpu.models.unet3d import UNetModel as JUNet
    from dynamicrafter_tpu.utils.export import export_state_dict
    from test_torch_modules import random_params

    d = tmp_path_factory.mktemp("sp")
    jcfg = JConfig.from_dict(UNET)
    junet = JUNet(jcfg, dtype=jnp.float32)
    zeros = lambda *s, dt=np.float32: np.zeros(s, dt)
    params = random_params(junet, zeros(1, T, LAT, LAT, 8), zeros(1, dt=np.int32),
                           context_text=zeros(1, 77, 48), context_img=zeros(1, T, 4, 48),
                           fs=zeros(1, dt=np.int32), seed=1)
    sd = export_state_dict({"unet": params}, unet_config=jcfg)
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()},
               d / "unet.pt")
    rng = np.random.default_rng(0)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    arrays = dict(
        x=r(B, T, LAT, LAT, 8), ts=np.array([999, 17], np.int32), ct=r(B, 77, 48),
        ci=r(B, T, 4, 48), fs=np.array([3, 24], np.int32), g=r(B, T, LAT, LAT, 4),
        x_odd=r(B, 3, LAT, LAT, 8), ci_odd=r(B, 3, 4, 48), x_hw=r(B, T, 6, 10, 8),
        s_ct=r(3, 1, 77, 48), s_ci=r(3, 1, T, 4, 48), s_cc=r(3, 1, T, LAT, LAT, 4, scale=0.5),
        s_fs=np.array([24], np.int32), s_x_T=r(1, T, LAT, LAT, 4),
        s_noise=r(STEPS, 1, T, LAT, LAT, 4), s_x0=r(1, T, LAT, LAT, 4),
        s_mask=np.broadcast_to((np.arange(T) == 0).astype(np.float32)[None, :, None, None, None],
                               (1, T, LAT, LAT, 4)).copy())
    np.savez(d / "inputs.npz", **arrays)
    return d, junet, params, arrays


@pytest.fixture(scope="module")
def one(setup):
    """The one-process port on every case."""
    d, _, _, arrays = setup
    unet = _unet(d / "unet.pt")
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    out = {name: _module_results(name) for name in MODULES}
    x = a["x"].clone().requires_grad_(True)
    y = unet(x, a["ts"].long(), context_text=a["ct"], context_img=a["ci"], fs=a["fs"].long())
    (y * a["g"]).sum().backward()
    out["unet"] = {"y": y.detach(), "gx": x.grad, "grads": flat(
        [p.grad if p.grad is not None else torch.zeros_like(p) for p in unet.parameters()])}
    unet.zero_grad(set_to_none=True)
    with torch.no_grad():
        for name, x_key, ci_key in (("unet_odd_frames", "x_odd", "ci_odd"),
                                    ("unet_hw_not_divisible", "x_hw", "ci")):
            out[name] = {"y": unet(a[x_key], a["ts"].long(), context_text=a["ct"],
                                   context_img=a[ci_key], fs=a["fs"].long())}
    for name in SAMPLERS:
        out[f"sampler_{name}"] = {"y": _sample(unet, arrays, name)}
    return out


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The JAX UNet on the UNet inputs and the JAX DDIM sampler on the 2- and
    3-pass cases (pre-drawn noise), single device."""
    import jax
    import jax.numpy as jnp

    from dynamicrafter_tpu import schedule as jsched
    from dynamicrafter_tpu.sampling import ddim as jddim

    _, junet, params, a = setup
    apply = lambda p, x, ts, context_text, context_img, fs: junet.apply(
        {"params": p}, x, ts, context_text=context_text, context_img=context_img, fs=fs)
    out = {"unet": np.asarray(jax.jit(apply)(params, a["x"], a["ts"], a["ct"], a["ci"],
                                              a["fs"]))}
    schedule = jsched.build_schedule(**SCHEDULE)
    for name in ("ddim_2pass", "ddim_3pass"):
        kw, passes, _, _ = SAMPLERS[name]
        settings = jddim.SamplerSettings(steps=STEPS, discretize="uniform_trailing",
                                         cfg_scale=7.5, parameterization="v", **kw)
        table = jsched.build_ddim_table(schedule, num_steps=STEPS,
                                        discretize="uniform_trailing", eta=kw["eta"])
        cond = jddim.CFGConditioning(
            context_text=jnp.asarray(a["s_ct"][:passes]),
            context_img=jnp.asarray(a["s_ci"][:passes]),
            concat=jnp.asarray(a["s_cc"][:passes]), fs=jnp.asarray(a["s_fs"]))

        def run(p, x_T, cond, noise, settings=settings, table=table):
            fn = jddim.make_cfg_denoiser(apply, p, cond, settings)
            return jddim.ddim_sample(fn, x_T, schedule, table, settings, noise=noise)

        out[name] = np.asarray(jax.jit(run)(params, a["s_x_T"], cond, a["s_noise"]))
    return out


@pytest.fixture(scope="module")
def sp2(setup):
    d = setup[0]
    run_ranks(_rank_sp2, 2, d, str(d))
    return [torch.load(d / f"sp2_rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def world4(setup):
    d = setup[0]
    run_ranks(_rank_world4, 4, d, str(d))
    return [torch.load(d / f"world4_rank{r}.pt", weights_only=False) for r in range(4)]


# -- (a) collectives ----------------------------------------------------------

@pytest.mark.parametrize("sp", [2, 4])
def test_sp_collectives_match_whole_tensors(sp, sp2, world4):
    """Each collective and its backward on every rank against the whole
    tensors: the all-to-alls and gathers move numbers (exact), the sums may
    round in another order."""
    errs = [r["collectives"] for r in sp2] if sp == 2 else [r[(1, 4)]["collectives"]
                                                           for r in world4]
    for rank, err in enumerate(errs):
        assert len(err) == 10, err
        for name, e in err.items():
            assert e <= (1e-5 if "reduce" in name or name.endswith("backward") else 0.0), (
                rank, name, e)


# -- (b) modules --------------------------------------------------------------

@pytest.mark.parametrize("name", MODULES)
def test_module_at_sp2_matches_one_process(name, sp2, one):
    """Output, input gradient and parameter gradients of each module that
    mixes frames, at sp 2 against the one-process module (relative 1e-5)."""
    got = [r[name] for r in sp2]
    want = one[name]
    assert rel_l2(torch.cat([g["y"] for g in got], 2), want["y"]) <= 1e-5
    assert rel_l2(torch.cat([g["gx"] for g in got], 2), want["gx"]) <= 1e-5
    for g in got:
        assert rel_l2(g["grads"], want["grads"]) <= 1e-5


# -- (c), (d), (f) the UNet -----------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_unet_forward_matches_one_process_and_jax(shape, sp2, world4, one, jax_refs):
    ranks = [r["unet"] for r in sp2] if shape == (1, 2) else [r[shape]["unet"] for r in world4]
    y = torch.cat([ranks[s]["y"] for s in range(shape[1])], dim=1)
    for r, got in enumerate(ranks):      # every dp rank holds every row
        assert torch.equal(got["y"], ranks[r % shape[1]]["y"]), r
    assert rel_l2(y, one["unet"]["y"]) <= 1e-5
    np.testing.assert_allclose(y.numpy(), jax_refs["unet"], atol=2e-4, rtol=0)


def test_unet_backward_at_sp2_matches_one_process(sp2, one):
    """The training path: the input gradient and the parameter gradients
    (each rank's summed over sp) of sum(out * g)."""
    got = [r["unet"] for r in sp2]
    assert rel_l2(torch.cat([g["gx"] for g in got], 1), one["unet"]["gx"]) <= 1e-5
    for g in got:
        assert rel_l2(g["grads"], one["unet"]["grads"]) <= 1e-5


def test_unet_odd_frames_run_whole_on_every_rank(sp2, one):
    """T = 3 on sp 2: no split, no collective, the one-process output."""
    for r in sp2:
        assert r["unet_odd_frames"]["calls"] == {}
        assert torch.equal(r["unet_odd_frames"]["y"], one["unet_odd_frames"]["y"])


@pytest.mark.parametrize("sp", [2, 4])
def test_unet_level_whose_hw_sp_does_not_divide(sp, sp2, world4, one):
    """6 x 10 latents: HW 60 at the first level splits, 15 at the second
    does not, so its 4 TemporalTransformers gather the clip and run whole."""
    ranks = ([r["unet_hw_not_divisible"] for r in sp2] if sp == 2
             else [r[(1, 4)]["unet_hw_not_divisible"] for r in world4])
    y = torch.cat([r["y"] for r in ranks], dim=1)
    assert rel_l2(y, one["unet_hw_not_divisible"]["y"]) <= 1e-5
    n_temporal, n_tconv = plan(UNetConfig.from_dict(UNET))
    whole = 4
    assert ranks[0]["calls"] == {"sp_all_gather": whole,
                                 "sp_all_to_all": 2 * (n_temporal - whole),
                                 "sp_halo": n_tconv,
                                 "sp_all_reduce": n_temporal - whole + n_tconv}


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_collective_plan_per_unet_call(shape, sp2, world4):
    """JAX's plan (tests/test_sp_collectives.py): 2 all-to-alls a
    TemporalTransformer (init_attn included), one halo exchange a temporal
    conv (JAX's two permutes), one all-reduce of statistics each, no gather;
    at dp 2 the rows' one all-gather."""
    n_temporal, n_tconv = plan(UNetConfig.from_dict(UNET))
    assert (n_temporal, n_tconv) == (8, 32)
    want = {"sp_all_to_all": 2 * n_temporal, "sp_halo": n_tconv,
            "sp_all_reduce": n_temporal + n_tconv}
    if shape[0] > 1:
        want["all_gather"] = 1
    ranks = [r["unet"] for r in sp2] if shape == (1, 2) else [r[shape]["unet"] for r in world4]
    for r in ranks:
        assert r["calls"] == want


def test_collective_plan_of_the_1024_config():
    """The formula on the shipped 576x1024 UNet gives JAX's budget
    (tests/test_sp_collectives.py::test_flagship_1024_topology_collective_budget)."""
    from dynamicrafter_tpu_torch.config import ModelConfig

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = ModelConfig.from_yaml(os.path.join(repo, "configs", "inference_1024_v1.0.yaml"))
    assert plan(UNetConfig.from_dict(cfg.unet)) == (17, 88)


# -- (e) samplers ---------------------------------------------------------------

def _sampler_calls(name):
    """The sp collectives of a sampler run: a step's UNet call (full, or
    DeepCache's shallow one) and, with guidance rescale, one all-reduce for
    its two stds."""
    kw = SAMPLERS[name][0]
    cfg = UNetConfig.from_dict(UNET)
    calls = {"sp_all_to_all": 0, "sp_halo": 0, "sp_all_reduce": 0}
    for i in range(STEPS):
        n_temporal, n_tconv = plan(cfg, shallow=kw.get("deepcache", 1) > 1 and i % 2 == 1)
        calls["sp_all_to_all"] += 2 * n_temporal
        calls["sp_halo"] += n_tconv
        calls["sp_all_reduce"] += n_temporal + n_tconv + int(kw.get("guidance_rescale", 0) > 0)
    return calls


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_sampler_at_sp2_matches_one_process(name, sp2, one, jax_refs):
    """Each rank's frames of the sampled latent against the one-process
    sampler on the same draws (relative 1e-5), the DDIM 2- and 3-pass runs
    also against JAX's single-device sampler at the port's bound against
    JAX (relative 1e-4, as tests/test_torch_slice.py: after CFG 7.5 the
    one-process port itself is up to ~5e-4 from JAX here, so JAX's atol
    2e-4 between its own sharded and single-device runs does not apply);
    and the run's collectives."""
    y = torch.cat([r[f"sampler_{name}"]["y"] for r in sp2], dim=1)
    assert rel_l2(y, one[f"sampler_{name}"]["y"]) <= 1e-5
    if name in jax_refs:
        assert rel_l2(y, jax_refs[name]) <= 1e-4
    for r in sp2:
        assert r[f"sampler_{name}"]["calls"] == _sampler_calls(name)


# -- (h) the rank layout --------------------------------------------------------

@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2), (1, 4), (4, 2), (2, 4)])
def test_create_mesh_rank_layout(dp, sp):
    """Rank r at (r // sp, r % sp): JAX's np.asarray(devices).reshape(dp, sp)
    (dynamicrafter_tpu/parallel/sharding.py:43)."""
    grid = np.arange(dp * sp).reshape(dp, sp)
    for r in range(dp * sp):
        mesh = sharding.create_mesh(dp, sp, world_size=dp * sp, rank=r)
        assert (mesh.dp, mesh.sp) == (dp, sp)
        assert grid[mesh.dp_rank, mesh.sp_rank] == r


def test_mesh_groups_across_spawned_ranks(world4):
    """The dp group holds the ranks of one sp position, the sp group the
    ranks of one dp position."""
    for r, out in enumerate(world4):
        assert out[(1, 4)]["groups"] == ([r], [0, 1, 2, 3])
        d, s = divmod(r, 2)
        assert out[(2, 2)]["groups"] == ([s, 2 + s], [2 * d, 2 * d + 1])


# -- (g) train.main --sp 2 --------------------------------------------------------

def test_sp_loss_parts_sum_to_the_clip_loss():
    """`combine_diffusion_losses(share=1/sp)` on each rank's part of the
    per-clip means: the parts sum to the clip's loss and to its gradient,
    the learned logvar's term (which does not scale with the means)
    included."""
    from dynamicrafter_tpu_torch.training.trainer import TrainConfig, combine_diffusion_losses

    cfg = TrainConfig(learn_logvar=True, original_elbo_weight=0.3)
    schedule = tsched.build_schedule(**SCHEDULE)
    t = torch.tensor([3, 700])
    parts = torch.rand(4, 2, generator=torch.Generator().manual_seed(0))
    logvar = torch.randn(1000, generator=torch.Generator().manual_seed(1)).requires_grad_(True)
    whole, _ = combine_diffusion_losses(parts.sum(0), t, cfg, schedule, logvar)
    (g_whole,) = torch.autograd.grad(whole, logvar)
    split = sum(combine_diffusion_losses(p, t, cfg, schedule, logvar, 1 / 4)[0] for p in parts)
    (g_split,) = torch.autograd.grad(split, logvar)
    torch.testing.assert_close(split, whole, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_split, g_whole, rtol=1e-6, atol=1e-9)


def _train_flags(cfg, logdir):
    return ["--config", cfg, "--logdir", logdir, "--name", "run", "--synthetic_data",
            "--max_steps", "2", "--log_every", "1", "--val_every", "2", "--device", "cpu"]


def _train_state(result):
    """The metrics, parameters and AdamW moments after a run, full tensors
    in the trainable tensors' order (the ZeRO shards gathered)."""
    tr = result["trainer"]
    opt = tr.opt
    if opt.mesh is None:
        moments = [opt.optimizer.state[p]["exp_avg"] for p in tr.params.values()]
    else:
        moments = opt.shards.gather(opt.exp_avg)
    return {"metrics": result["metrics"], "params": flat(p.detach() for p in tr.params.values()),
            "exp_avg": flat(moments), "mesh": None if tr.mesh is None else tr.mesh.shape}


def _train_sp_rank(rank, world, cfg, logdir, out_dir):
    from dynamicrafter_tpu_torch import train

    sharding.collectives.clear()
    result = train.main([*_train_flags(cfg, logdir), "--sp", str(world)])
    out = _train_state(result)
    out["calls"] = dict(sharding.collectives)
    out["steps"] = result["checkpoints"].all_steps()
    torch.save(out, os.path.join(out_dir, f"train_sp_rank{rank}.pt"))


def test_train_main_sp2_matches_one_process(tmp_path):
    """Two micro-steps (one AdamW update at accumulation 2, EMA on,
    validation at step 2) of `train.main --sp 2` against `train.main` in
    one process: both ranks train on the one process's batch and draws (dp
    1), the losses, gradient norms and validation losses, the parameters and
    the first moment (the gradient's mean, which the shipped lr 1e-5 would
    hide in the parameters) agree to relative 1e-5; rank 0 alone writes the
    checkpoint."""
    from dynamicrafter_tpu_torch import train

    cfg = copy.deepcopy(TINY_MODEL_CONFIG)
    cfg["model"]["params"].update(use_ema=True, rand_cond_frame=True)
    cfg["data"] = {"params": {"batch_size": 2, "num_workers": 1, "train": {
        "params": {"video_length": T, "resolution": [2 * LAT, 2 * LAT]}}}}
    cfg["lightning"] = {"trainer": {"accumulate_grad_batches": 2, "max_steps": 100}}
    path = tmp_path / "tiny_train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run_ranks(_train_sp_rank, 2, tmp_path, str(path), str(tmp_path / "sp"), str(tmp_path))
    ranks = [torch.load(tmp_path / f"train_sp_rank{r}.pt", weights_only=False)
             for r in range(2)]
    one = _train_state(train.main(_train_flags(str(path), str(tmp_path / "one"))))
    for r in ranks:
        assert r["mesh"] == {"dp": 1, "sp": 2} and r["steps"] == [2]
        assert r["calls"]["sp_all_to_all"] > 0 and r["calls"]["sp_halo"] > 0
        for got, want in zip(r["metrics"], one["metrics"]):
            assert got.keys() == want.keys()
            for k in want:
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
        assert rel_l2(r["params"], one["params"]) <= 1e-5
        assert rel_l2(r["exp_avg"], one["exp_avg"]) <= 1e-5
    assert not os.path.exists(tmp_path / "sp" / "run" / "checkpoints" / "step_000000002.pt.tmp")


def _record_steps(seen):
    """Trainer.train_step and eval_step wrapped to record each call's batch
    and draws (drawn where the step would draw them) into `seen[kind]` and
    the validation metrics into `seen["val_metrics"]`."""
    from dynamicrafter_tpu_torch.training.trainer import Trainer

    def recording(kind, fn):
        def run(self, batch, draws=None):
            draws = self.draw(batch) if draws is None else draws
            seen[kind].append((batch, draws))
            out = fn(self, batch, draws)
            if kind == "val":
                seen["val_metrics"].append({k: float(v) for k, v in out.items()})
            return out
        return run

    Trainer.train_step = recording("train", Trainer.train_step)
    Trainer.eval_step = recording("val", Trainer.eval_step)


def _train_dp2_sp2_rank(rank, world, cfg, logdir, out_dir):
    """train.main --dp 2 --sp 2 on this rank, recording the batches and draws
    of its micro-steps and validation, and the checkpoints it wrote."""
    from dynamicrafter_tpu_torch import train
    from dynamicrafter_tpu_torch.training import checkpoints

    seen = {"train": [], "val": [], "val_metrics": [], "ckpt_writes": []}
    _record_steps(seen)
    write = checkpoints.CheckpointManager._write

    def recording_write(self, path, s, *a):
        seen["ckpt_writes"].append(s)
        return write(self, path, s, *a)

    checkpoints.CheckpointManager._write = recording_write
    sharding.collectives.clear()
    result = train.main([*_train_flags(cfg, logdir), "--dp", "2", "--sp", "2"])
    out = _train_state(result)
    out.update(seen, calls=dict(sharding.collectives),
               steps=result["checkpoints"].all_steps())
    torch.save(out, os.path.join(out_dir, f"train_dp2_sp2_rank{rank}.pt"))


def _joined(a, b):
    """Two dp ranks' batches, or draws, as one micro-batch: tensors and
    lists concatenated along the batch, the one conditioning frame kept."""
    if isinstance(a, dict):
        return {k: _joined(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        assert torch.equal(a.cond_idx, b.cond_idx)
        return type(a)(*[v if k == "cond_idx" else _joined(v, w)
                         for k, v, w in zip(a._fields, a, b)])
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b])
    return None if a is None else list(a) + list(b)


def test_train_main_dp2_sp2_matches_one_process(tmp_path):
    """Four ranks at (dp, sp) = (2, 2): each sp group (ranks {0, 1} and {2,
    3}) takes its own shard of the data and its own draws, both of its
    ranks the same; the gradients are summed over sp and reduce-scattered
    over dp (ZeRO over the dp groups {0, 2} and {1, 3}). Two micro-steps (one
    AdamW update at accumulation 2, EMA on, validation at step 2) against
    `train.main` in one process on the two sp groups' batches and draws
    concatenated: losses, gradient norms and validation losses (the EMA's
    through `ema_scope`'s all-gather), the parameters and the first moment
    agree to relative 1e-5 on every rank; rank 0 alone writes the
    checkpoint. rand_cond_frame is off: a micro-batch has one conditioning
    frame (ddpm3d.py), so two sp groups' batches form one only if they
    share it."""
    from dynamicrafter_tpu_torch import train
    from dynamicrafter_tpu_torch.training.trainer import Trainer

    cfg = copy.deepcopy(TINY_MODEL_CONFIG)
    cfg["model"]["params"].update(use_ema=True, rand_cond_frame=False)
    cfg["data"] = {"params": {"batch_size": 1, "num_workers": 1, "train": {
        "params": {"video_length": T, "resolution": [2 * LAT, 2 * LAT]}}}}
    cfg["lightning"] = {"trainer": {"accumulate_grad_batches": 2, "max_steps": 100}}
    path = tmp_path / "tiny_train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    run_ranks(_train_dp2_sp2_rank, 4, tmp_path, str(path), str(tmp_path / "mesh"),
              str(tmp_path), timeout=300)
    ranks = [torch.load(tmp_path / f"train_dp2_sp2_rank{r}.pt", weights_only=False)
             for r in range(4)]
    for kind in ("train", "val"):
        assert len(ranks[0][kind]) == (2 if kind == "train" else 1)
        for (ba, da), (bb, db) in zip(ranks[0][kind], ranks[2][kind]):
            assert not torch.equal(ba["video"], bb["video"])       # the dp shards differ
            assert not torch.equal(da.noise, db.noise)             # draws from the dp rank
        for lead, other in ((0, 1), (2, 3)):                       # an sp group agrees
            for (ba, da), (bb, db) in zip(ranks[lead][kind], ranks[other][kind]):
                assert torch.equal(ba["video"], bb["video"])
                assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(da, db))
    joined = {kind: [(_joined(ba, bb), _joined(da, db)) for (ba, da), (bb, db)
                     in zip(ranks[0][kind], ranks[2][kind])] for kind in ("train", "val")}

    val_metrics = []

    def substituting(kind, fn):
        calls = iter(joined[kind])

        def run(self, batch, draws=None):
            out = fn(self, *next(calls))
            if kind == "val":
                val_metrics.append({k: float(v) for k, v in out.items()})
            return out
        return run

    step, ev = Trainer.train_step, Trainer.eval_step
    Trainer.train_step, Trainer.eval_step = substituting("train", step), substituting("val", ev)
    try:
        one = _train_state(train.main(_train_flags(str(path), str(tmp_path / "one"))))
    finally:
        Trainer.train_step, Trainer.eval_step = step, ev
    assert len(val_metrics) == 1 and "val/loss_ema" in val_metrics[0]
    for r in ranks:
        assert r["mesh"] == {"dp": 2, "sp": 2} and r["steps"] == [2]
        assert r["calls"]["sp_all_to_all"] > 0 and r["calls"]["reduce_scatter"] > 0
        assert len(r["metrics"]) == len(one["metrics"]) == 2 and len(r["val_metrics"]) == 1
        for got, want in zip(r["metrics"] + r["val_metrics"], one["metrics"] + val_metrics):
            assert got.keys() == want.keys()
            for k in want:
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
        assert rel_l2(r["params"], one["params"]) <= 1e-5
        assert rel_l2(r["exp_avg"], one["exp_avg"]) <= 1e-5
    assert [r["ckpt_writes"] for r in ranks] == [[2], [], [], []]
