"""The inference modes of the PyTorch package beyond the 320x512 preset,
against the JAX package, at TINY_MODEL_CONFIG size, fp32 on the CPU: K5
(position-major small-sequence attention) and its route, tiled VAE decode,
the conditioning variants (interp/loop, multi-cond CFG, negative prompt),
sequential CFG, mask blending, logged intermediates, `ddim_decode`,
`stochastic_encode`, `n_samples`, the interp pipeline end to end, a batch
large enough to take the K5 route, and the CLI's flags.

Both packages get the same weights (one random Flax param tree exported to
reference keys) and the same random numbers (drawn once with numpy or with
the JAX pipeline's own key and handed to the port). The port's attention
runs its plain versions here (CPU tensors).

Tolerances: kernels' plain versions atol 1e-5 (fp32, same arithmetic in
another summation order); gradients rtol 1e-4; sampler logic on an analytic
denoiser 1e-5; whole-model comparisons relative L2 <= 1e-4 (a few hundred
fp32 layers deep).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from dynamicrafter_tpu import schedule as jsched  # noqa: E402
from dynamicrafter_tpu.models import clip as jclip  # noqa: E402
from dynamicrafter_tpu.models import resampler as jres  # noqa: E402
from dynamicrafter_tpu.models import unet3d as junet  # noqa: E402
from dynamicrafter_tpu.models import vae as jvae  # noqa: E402
from dynamicrafter_tpu.ops.small_attention import small_t_attention as j_small_t  # noqa: E402
from dynamicrafter_tpu.sampling import ddim as jddim  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu.utils import export as E  # noqa: E402
from dynamicrafter_tpu.utils import video as jvideo  # noqa: E402
from dynamicrafter_tpu_torch import inference  # noqa: E402
from dynamicrafter_tpu_torch import schedule as tsched  # noqa: E402
from dynamicrafter_tpu_torch.models import clip as tclip  # noqa: E402
from dynamicrafter_tpu_torch.models import resampler as tres  # noqa: E402
from dynamicrafter_tpu_torch.models import unet3d as tunet  # noqa: E402
from dynamicrafter_tpu_torch.models import vae as tvae  # noqa: E402
from dynamicrafter_tpu_torch.ops import attention as tattn  # noqa: E402
from dynamicrafter_tpu_torch.ops import small_attention as tsmall  # noqa: E402
from dynamicrafter_tpu_torch.sampling import ddim as tddim  # noqa: E402
from dynamicrafter_tpu_torch.utils import video as tvideo  # noqa: E402
from test_torch_modules import load, randn, random_params, rel_l2, t  # noqa: E402
from test_torch_slice import EXAMPLE_PNG, HW, LAT, T, pipes  # noqa: E402,F401

PROMPTS = ["a red fox running through snow"]


# ---------------------------------------------------------------------------
# K5 and its route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(300, 16, 4, 64), (130, 8, 2, 64), (37, 4, 1, 64),
                                   (2, 150, 16, 2, 32), (3, 7, 32, 1, 16)])
def test_k5_plain_matches_jax_small_t_kernel(shape):
    """(G, T, H, D) and extra leading dims; G not a multiple of 8."""
    rng = np.random.default_rng(0)
    q, k, v = (randn(rng, *shape) for _ in range(3))
    ref = np.asarray(j_small_t(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               interpret=True))
    before = tsmall.small_t_fwd.launches
    out = tsmall.small_t_attention(t(q), t(k), t(v)).numpy()
    assert tsmall.small_t_fwd.launches == before     # CPU: plain path, no launch
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_k5_takes_any_t_up_to_32():
    """T = 5 does not divide 128 (the TPU kernel refuses it); the port's
    entry takes it, here against plain attention."""
    rng = np.random.default_rng(1)
    q, k, v = (t(randn(rng, 40, 5, 2, 16)) for _ in range(3))
    out = tsmall.small_t_attention(q, k, v)
    np.testing.assert_allclose(out.numpy(), tattn.plain_attention(q, k, v).numpy(),
                               atol=1e-5, rtol=0)


def test_k5_grads_match_jax_custom_vjp():
    rng = np.random.default_rng(2)
    q, k, v, g = (randn(rng, 36, 16, 2, 32) for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: j_small_t(a, b, c, interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    refs = vjp(jnp.asarray(g))
    xs = [t(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tsmall.small_t_attention(*xs), xs, t(g))
    for a, ref in zip(got, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_k5_route_taken_by_a_256_style_batch(pipes, monkeypatch):
    """64 clips of 4 frames: every 4 x 4 spatial self-attention has 256 rows
    of 16 tokens and takes the K5 entry (its plain version here); the UNet
    output still matches the JAX package, which on the CPU takes its XLA
    path for the same function."""
    jp, tp = pipes
    rng = np.random.default_rng(3)
    b = 64
    x = randn(rng, b, T, LAT, LAT, 8)
    ts = np.full((b,), 500, np.int32)
    ct, ci = randn(rng, b, 77, 48), randn(rng, b, T, 4, 48)
    fs = np.full((b,), 3, np.int32)
    ref = np.asarray(jax.jit(lambda p, *a: jp.unet.apply(
        {"params": p}, a[0], a[1], context_text=a[2], context_img=a[3], fs=a[4]))(
            jp.params["unet"], x, ts, ct, ci, fs))
    calls = []
    real = tattn.small_t_attention
    monkeypatch.setattr(tattn, "small_t_attention",
                        lambda q, k, v, scale=None: calls.append(tuple(q.shape))
                        or real(q, k, v, scale=scale))
    with torch.no_grad():
        out = tp.unet(*(t(a) for a in (x, ts.astype(np.int64), ct, ci, fs.astype(np.int64))))
    # level-1 blocks (input, two output) and the middle block, all at 4 x 4
    assert calls == [(b, T, 16, 4, 16)] * 4
    assert rel_l2(out.numpy(), ref) <= 1e-4


# ---------------------------------------------------------------------------
# UNet options no shipped config sets, ImageProjModel, quick-GELU CLIP
# ---------------------------------------------------------------------------

UNET_OPTIONS = [
    dict(use_relative_position=True),
    dict(use_causal_attention=True),
    dict(use_relative_position=True, use_causal_attention=True),
    dict(use_scale_shift_norm=True),
    dict(tempspatial_aware=True),
    dict(use_linear=False),
    dict(conv_resample=False),
]


@pytest.mark.parametrize("options", UNET_OPTIONS, ids=lambda o: "+".join(o))
def test_tiny_unet_options_match_jax(options):
    """Relative position and the causal temporal mask (plain attention in the
    tokens-at--2 layout), scale-shift norm, (3, 3, 1)/(3, 1, 3) temporal
    convs, Conv2d/Conv1d 1x1 projections, pooled/bare resampling."""
    cfg = {**TINY_MODEL_CONFIG["model"]["params"]["unet_config"]["params"], **options}
    jcfg = junet.UNetConfig.from_dict(cfg)
    jm = junet.UNetModel(jcfg)
    rng = np.random.default_rng(16)
    x = randn(rng, 2, T, LAT, LAT, 8)
    ts, fs = np.array([999, 17], np.int32), np.array([3, 24], np.int32)
    ct, ci = randn(rng, 2, 77, 48), randn(rng, 2, T, 4, 48)
    prm = random_params(jm, x, ts, context_text=ct, context_img=ci, fs=fs, seed=16)
    ref = np.asarray(jax.jit(lambda p: jm.apply(
        {"params": p}, x, ts, context_text=ct, context_img=ci, fs=fs))(prm))
    tm = load(tunet.UNetModel(tunet.UNetConfig.from_dict(cfg)), E.export_unet(prm, jcfg))
    with torch.no_grad():
        out = tm(t(x), t(ts).long(), context_text=t(ct), context_img=t(ci), fs=t(fs).long())
    assert out.shape == ref.shape
    assert rel_l2(out.numpy(), ref) <= 1e-4


def test_unet_refuses_resblock_updown():
    cfg = {**TINY_MODEL_CONFIG["model"]["params"]["unet_config"]["params"],
           "resblock_updown": True}
    with pytest.raises(NotImplementedError, match="resblock_updown"):
        tunet.UNetModel(tunet.UNetConfig.from_dict(cfg))


def test_image_proj_model_matches_jax():
    jm = jres.ImageProjModel(cross_attention_dim=48, clip_embeddings_dim=40,
                             clip_extra_context_tokens=4)
    x = randn(np.random.default_rng(17), 3, 40)
    prm = random_params(jm, x, seed=17)
    ref = np.asarray(jm.apply({"params": prm}, x))
    tm = load(tres.ImageProjModel(48, 40, 4), E.export_resampler(prm))
    with torch.no_grad():
        out = tm(t(x)).numpy()
    assert out.shape == ref.shape == (3, 4, 48)
    assert rel_l2(out, ref) <= 1e-5


def test_clip_vision_quick_gelu_matches_jax():
    """The OpenAI CLIP activation x * sigmoid(1.702 x)."""
    cfg = {**TINY_MODEL_CONFIG["model"]["params"]["clip_vision_config"]["params"],
           "act": "quick_gelu"}
    jm = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(**cfg))
    px = randn(np.random.default_rng(18), 2, 32, 32, 3)
    prm = random_params(jm, px, seed=18)
    ref = np.asarray(jm.apply({"params": prm}, px))
    tm = load(tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(**cfg)),
              E.export_clip_vision(prm), prefix="embedder.")
    with torch.no_grad():
        out = tm(t(px)).numpy()
    assert rel_l2(out, ref) <= 1e-5
    gelu = load(tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(**{**cfg, "act": "gelu"})),
                E.export_clip_vision(prm), prefix="embedder.")
    with torch.no_grad():
        assert rel_l2(gelu(t(px)).numpy(), ref) > 1e-4


# ---------------------------------------------------------------------------
# tiled VAE decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,tile", [((20, 28), 12), ((8, 30), 12), ((12, 12), 12)])
def test_decode_tiled_matches_jax(hw, tile):
    """Tile starts, overlap 8 and the blend ramps, on a tiny VAE: both axes
    tiled, one axis shorter than a tile, and the untiled early return."""
    cfg = TINY_MODEL_CONFIG["model"]["params"]["first_stage_config"]["params"]
    jm = jvae.AutoencoderKL(jvae.VAEConfig.from_dict(cfg))
    prm = random_params(jm, np.zeros((1, 16, 16, 3), np.float32), seed=4)
    tm = load(tvae.AutoencoderKL(tvae.VAEConfig.from_dict(cfg)), E.export_vae(prm))
    z = randn(np.random.default_rng(4), 2, *hw, 4)
    decode = jax.jit(lambda zt: jm.apply({"params": prm}, zt, method=jm.decode))
    ref = np.asarray(jvae.decode_tiled(decode, jnp.asarray(z), tile=tile, overlap=8, scale=2))
    with torch.no_grad():
        out = tvae.decode_tiled(tm.decode, t(z), tile=tile, overlap=8, scale=2).numpy()
    assert out.shape == ref.shape == (2, hw[0] * 2, hw[1] * 2, 3)
    assert np.abs(out - ref).max() <= 1e-4


def test_decode_latents_precedence(pipes):
    """Tiled above the threshold whatever perframe says; else per frame or
    all at once, which agree."""
    _, tp = pipes
    z = t(randn(np.random.default_rng(5), 1, 2, 12, 12, 4))
    whole = tp.decode_latents(z, perframe=False)
    np.testing.assert_allclose(tp.decode_latents(z, perframe=True).numpy(), whole.numpy(),
                               atol=1e-5)
    tp.tiled_vae_threshold = 10
    try:
        tiled = tp.decode_latents(z, perframe=True)
        ref = tvae.decode_tiled(tp.vae.decode, z[0] / tp.config.scale_factor, tile=10,
                                overlap=8, scale=2)
    finally:
        tp.tiled_vae_threshold = 64
    np.testing.assert_allclose(tiled[0].numpy(), ref.numpy(), atol=1e-6)
    assert np.abs(tiled.numpy() - whole.numpy()).max() > 1e-4   # per-tile statistics


# ---------------------------------------------------------------------------
# conditioning
# ---------------------------------------------------------------------------

def _videos(rng, b=1):
    first, last = (randn(rng, b, 1, HW, HW, 3, scale=0.5).clip(-1, 1) for _ in range(2))
    return np.concatenate([np.repeat(first, T // 2, 1), np.repeat(last, T - T // 2, 1)], 1)


@pytest.mark.parametrize("kw", [
    dict(loop_or_interp=True),
    dict(multiple_cond_cfg=True, cfg_img=2.0),
    dict(negative_prompt="blurry, low resolution"),
    dict(cfg_scale=1.0),
], ids=["interp", "multicond", "negative", "no_cfg"])
def test_build_conditioning_matches_jax(pipes, kw):
    jp, tp = pipes
    videos = _videos(np.random.default_rng(6))
    key = jax.random.PRNGKey(7)
    enc_noise = np.asarray(jax.random.normal(key, (T, LAT, LAT, 4)))
    ref = jp.build_conditioning(PROMPTS, jnp.asarray(videos), key, fs=[5], **kw)
    got = tp.build_conditioning(PROMPTS, t(videos), t(enc_noise), fs=[5], **kw)
    assert got.num_passes == ref.num_passes == {"multicond": 3, "no_cfg": 1}.get(
        "multicond" if "multiple_cond_cfg" in kw else "no_cfg" if "cfg_scale" in kw else "", 2)
    for name in ("context_text", "context_img", "concat", "fs"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=name)
    if kw.get("loop_or_interp"):
        assert np.all(got.concat.numpy()[:, :, 1:-1] == 0)
        assert np.abs(got.concat.numpy()[:, :, 0] - got.concat.numpy()[:, :, -1]).max() > 0


# ---------------------------------------------------------------------------
# sampler logic on an analytic denoiser (no UNet: the arithmetic of the loop)
# ---------------------------------------------------------------------------

STEPS = 6


def _tables(pipes, eta, steps=STEPS):
    jp, tp = pipes
    kw = dict(num_steps=steps, discretize="uniform_trailing", eta=eta)
    return (jsched.build_ddim_table(jp.schedule, **kw),
            tsched.build_ddim_table(tp.schedule, **kw))


def _j_model(x, ts):
    return jnp.tanh(x) * 0.5 + 1e-3 * ts[0]


def _t_model(x, ts):
    return torch.tanh(x) * 0.5 + 1e-3 * ts


@pytest.mark.parametrize("clean_cond", [False, True])
def test_mask_blend_and_logged_intermediates_match_jax(pipes, clean_cond):
    """eta 1 with pre-drawn step noise and mask noise; log_every_t = 2."""
    jp, tp = pipes
    rng = np.random.default_rng(8)
    shape = (2, T, LAT, LAT, 4)
    x_T, x0 = randn(rng, *shape), randn(rng, *shape)
    mask = (rng.random(shape) < 0.4).astype(np.float32)
    noise, mnoise = randn(rng, STEPS, *shape), randn(rng, STEPS, *shape)
    kw = dict(steps=STEPS, discretize="uniform_trailing", eta=1.0, parameterization="v",
              clean_cond=clean_cond)
    jtab, ttab = _tables(pipes, 1.0)
    ref, ref_log = jddim.ddim_sample(
        _j_model, jnp.asarray(x_T), jp.schedule, jtab, jddim.SamplerSettings(**kw),
        noise=jnp.asarray(noise), mask=jnp.asarray(mask), x0=jnp.asarray(x0),
        mask_noise=jnp.asarray(mnoise), log_every_t=2)
    out, log = tddim.ddim_sample(
        _t_model, t(x_T), tp.schedule, ttab, tddim.SamplerSettings(**kw), noise=t(noise),
        mask=t(mask), x0=t(x0), mask_noise=t(mnoise), log_every_t=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    for name in ("x_inter", "pred_x0"):
        assert log[name].shape == ref_log[name].shape == (1 + 4, *shape), name
        np.testing.assert_allclose(log[name].numpy(), np.asarray(ref_log[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_mask_blend_draws_from_the_generator(pipes):
    """Without pre-drawn arrays the blend and the step draw, in that order,
    from the one generator: the same seed gives the same sample, and the
    pre-drawn seam reproduces it."""
    _, tp = pipes
    rng = np.random.default_rng(9)
    shape = (1, T, LAT, LAT, 4)
    x_T, x0 = t(randn(rng, *shape)), t(randn(rng, *shape))
    mask = t((rng.random(shape) < 0.5).astype(np.float32))
    _, ttab = _tables(pipes, 1.0, steps=2)
    st = tddim.SamplerSettings(steps=2, discretize="uniform_trailing", eta=1.0)
    run = lambda **kw: tddim.ddim_sample(_t_model, x_T, tp.schedule, ttab, st, mask=mask,
                                         x0=x0, **kw)
    a = run(generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    draws = [torch.randn(shape, generator=g) for _ in range(4)]   # blend, step, blend, step
    b = run(noise=torch.stack(draws[1::2]), mask_noise=torch.stack(draws[0::2]))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_ddim_decode_and_stochastic_encode_match_jax(pipes):
    jp, tp = pipes
    rng = np.random.default_rng(10)
    shape = (2, T, LAT, LAT, 4)
    x0, noise = randn(rng, *shape), randn(rng, *shape)
    jtab, ttab = _tables(pipes, 0.0)
    idx = np.array([3, 1])
    j_enc = jddim.stochastic_encode(jp.schedule, jtab, jnp.asarray(x0), jnp.asarray(idx),
                                    jnp.asarray(noise))
    t_enc = tddim.stochastic_encode(ttab, t(x0), t(idx), t(noise))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), atol=1e-6, rtol=1e-6)
    kw = dict(steps=STEPS, discretize="uniform_trailing", eta=0.0, parameterization="v")
    ref = jddim.ddim_decode(_j_model, j_enc, jp.schedule, jtab, jddim.SamplerSettings(**kw), 4)
    out = tddim.ddim_decode(_t_model, t_enc, tp.schedule, ttab,
                            tddim.SamplerSettings(**kw), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the pipeline: sequential CFG, n_samples, interp end to end
# ---------------------------------------------------------------------------

def _enc_noise(seed):
    """The VAE encode noise the JAX pipeline draws for `seed`."""
    return np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(seed))[1],
                                        (T, LAT, LAT, 4)))


def test_sequential_cfg_combines_the_same_passes():
    """The denoiser alone, on a UNet stand-in whose rows do not interact:
    one call on P*B rows and P calls on B rows give the same CFG
    combination (3 passes with cfg_img, guidance rescale), to 1e-5."""
    rng = np.random.default_rng(15)
    p, b = 3, 2
    cond = tddim.CFGConditioning(
        context_text=t(randn(rng, p, b, 7, 4)), context_img=t(randn(rng, p, b, T, 3, 4)),
        concat=t(randn(rng, p, b, T, LAT, LAT, 4)), fs=t(np.array([3, 24])))
    batches = []

    def unet(x, ts, context_text, context_img, fs):
        batches.append(x.shape[0])
        shift = context_text.mean((1, 2)) + context_img.mean((1, 2, 3)) + 1e-3 * (ts + fs)
        return torch.tanh(x[..., :4] + x[..., 4:]) + shift.reshape(-1, 1, 1, 1, 1)

    x = t(randn(rng, b, T, LAT, LAT, 4))
    kw = dict(steps=2, cfg_scale=7.5, cfg_img=2.0, guidance_rescale=0.7)
    outs = [tddim.make_cfg_denoiser(unet, cond, tddim.SamplerSettings(sequential_cfg=seq, **kw))(
        x, 500) for seq in (False, True)]
    assert batches == [p * b, b, b, b]
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-5, rtol=0)


def test_sequential_cfg_changes_no_sample(pipes):
    """Batched and sequential CFG (3 passes, eta 1, one generator) through
    the pipeline: the same draws, so the same latents up to the UNet's fp32
    summation order at another batch size (whole-model tolerance); and equal
    to the JAX pipeline's sequential run at eta 0."""
    jp, tp = pipes
    rng = np.random.default_rng(11)
    videos = _videos(rng)
    kw = dict(steps=2, cfg_scale=7.5, multiple_cond_cfg=True, cfg_img=2.0,
              timestep_spacing="uniform_trailing", guidance_rescale=0.7, fs=[3], seed=3,
              decode=False)
    batched = tp.sample(PROMPTS, videos, eta=1.0, **kw)
    seq = tp.sample(PROMPTS, videos, eta=1.0, sequential_cfg=True, **kw)
    assert rel_l2(seq, batched) <= 1e-4
    x_T = randn(rng, 1, T, LAT, LAT, 4)
    ref = np.asarray(jp.sample(PROMPTS, videos, eta=0.0, sequential_cfg=True, x_T=x_T, **kw))
    out = tp.sample(PROMPTS, videos, eta=0.0, sequential_cfg=True, x_T=x_T,
                    encode_noise=_enc_noise(3), **kw)
    assert rel_l2(out, ref) <= 1e-4


def test_sample_n_samples_layout_and_values(pipes):
    jp, tp = pipes
    rng = np.random.default_rng(12)
    videos = _videos(rng, b=2)
    prompts = ["a fox", "waves at dusk"]
    enc = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(4))[1],
                                       (2 * T, LAT, LAT, 4)))
    kw = dict(steps=2, cfg_scale=7.5, eta=0.0, timestep_spacing="uniform_trailing",
              fs=[3, 3], seed=4, decode=False)
    x_T = randn(rng, 2, T, LAT, LAT, 4)
    ref = np.asarray(jp.sample(prompts, videos, n_samples=2, x_T=x_T, **kw))
    out = tp.sample(prompts, videos, n_samples=2, x_T=x_T, encode_noise=enc, **kw)
    assert out.shape == ref.shape == (2, 2, T, LAT, LAT, 4)
    assert rel_l2(out, ref) <= 1e-4
    # one x_T per sample: sample k is the single-sample run from x_T[:, k]
    x_T2 = randn(rng, 2, 2, T, LAT, LAT, 4)
    per = tp.sample(prompts, videos, n_samples=2, x_T=x_T2, encode_noise=enc, **kw)
    for k in range(2):
        one = tp.sample(prompts, videos, x_T=x_T2[:, k], encode_noise=enc, **kw)
        np.testing.assert_allclose(per[:, k], one[:, 0], atol=1e-6)
    frames = tp.sample(prompts, videos, n_samples=2, x_T=x_T2, encode_noise=enc,
                       **{**kw, "decode": True}).videos
    assert frames.shape == (2, 2, T, HW, HW, 3)
    # drawn x_T: the samples differ
    drawn = tp.sample(prompts, videos, n_samples=2, encode_noise=enc, **kw)
    assert np.abs(drawn[:, 0] - drawn[:, 1]).max() > 1e-3


def test_interp_pipeline_end_to_end(pipes):
    """Two conditioning frames, loop_or_interp, eta-0 DDIM, logged
    intermediates, decode: latents, x_inter and frames against JAX."""
    jp, tp = pipes
    rng = np.random.default_rng(13)
    videos = _videos(rng)
    x_T = randn(rng, 1, T, LAT, LAT, 4)
    kw = dict(steps=3, cfg_scale=7.5, eta=0.0, timestep_spacing="uniform_trailing",
              guidance_rescale=0.7, fs=[3], seed=5, x_T=x_T, loop_or_interp=True,
              log_every_t=2)
    j_lat, j_inter = jp.sample(PROMPTS, videos, decode=False, **kw)
    t_lat, t_inter = tp.sample(PROMPTS, videos, decode=False, encode_noise=_enc_noise(5), **kw)
    assert t_lat.shape == j_lat.shape == (1, 1, T, LAT, LAT, 4)
    assert rel_l2(t_lat, j_lat) <= 1e-4
    assert t_inter.shape == j_inter.shape == (3, 1, T, LAT, LAT, 4)
    assert rel_l2(t_inter, j_inter) <= 1e-4
    j_out = jp.sample(PROMPTS, videos, **kw)
    t_out = tp.sample(PROMPTS, videos, encode_noise=_enc_noise(5), **kw)
    assert np.abs(t_out.videos - j_out.videos).max() <= 1e-3
    assert t_out.denoise_rows.shape == j_out.denoise_rows.shape == (3, 1, T, HW, HW, 3)
    assert np.abs(t_out.denoise_rows[-1] - j_out.denoise_rows[-1]).max() <= 1e-3


# ---------------------------------------------------------------------------
# video IO
# ---------------------------------------------------------------------------

def test_load_prompt_dir_interp_pairs(tmp_path):
    for name in ("a0.png", "a1.png", "b0.png", "b1.png"):
        shutil.copy(EXAMPLE_PNG, tmp_path / name)
    (tmp_path / "prompts.txt").write_text("first\nsecond\n")
    names, vids, prompts = tvideo.load_prompt_dir(str(tmp_path), (32, 48), 6, interp=True)
    j_names, j_vids, j_prompts = jvideo.load_prompt_dir(str(tmp_path), (32, 48), 6, interp=True)
    assert names == j_names == ["a0.png", "b0.png"] and prompts == j_prompts
    assert vids.shape == j_vids.shape == (2, 6, 32, 48, 3)
    assert np.abs(vids - j_vids).max() <= 2 * 2.0 / 255 + 1e-6    # resize rounding
    os.remove(tmp_path / "b1.png")
    with pytest.raises(FileNotFoundError, match="need 4 PNG"):
        tvideo.load_prompt_dir(str(tmp_path), (32, 48), 6, interp=True)


def test_grids_match_jax():
    rng = np.random.default_rng(14)
    rows = randn(rng, 3, 4, 5, 6, 3)
    np.testing.assert_array_equal(tvideo.make_denoise_grid(rows), jvideo.make_denoise_grid(rows))
    grid = tvideo.video_grid(randn(rng, 5, 4, 6, 8, 3))
    assert grid.shape == (4, 2 * 6, 3 * 8, 3)
    assert np.all(grid[:, 6:, 16:] == -1)      # the padded sixth cell


def test_save_results_names_samples(tmp_path):
    vids = np.zeros((2, 2, T, 8, 8, 3), np.float32)
    paths = tvideo.save_results(vids, ["x.png", "y.png"], str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [
        "x_sample0.npy", "x_sample1.npy", "y_sample0.npy", "y_sample1.npy"]
    assert np.load(paths[0]).shape == (T, 8, 8, 3)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    prompts = root / "prompts"
    prompts.mkdir()
    for name in ("a0.png", "a1.png"):
        shutil.copy(EXAMPLE_PNG, prompts / name)
    (prompts / "prompts.txt").write_text("a fox in the snow\n")
    return root, cfg, prompts


def _cli(cli_dirs, out, *flags, width=HW):
    root, cfg, prompts = cli_dirs
    return inference.main([
        "--config", str(cfg), "--prompt_dir", str(prompts), "--savedir", str(root / out),
        "--random_init", "--height", str(HW), "--width", str(width),
        "--unconditional_guidance_scale", "7.5", "--text_input", "--video_length", str(T),
        "--ddim_steps", "2", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,frames,files", [
    (("--interp",), T, ["a0.npy"]),
    (("--loop",), T - 1, ["a0.npy"]),
    (("--n_samples", "2"), T, ["a0_sample0.npy", "a0_sample1.npy"]),
    (("--negative_prompt", "--negative_prompt_text", "blurry"), T, ["a0.npy"]),
    (("--multiple_cond_cfg", "--cfg_img", "2.0", "--sequential_cfg"), T, ["a0.npy"]),
    (("--use_fixed_scheduler", "--savefps", "8", "--perframe_ae"), T, ["a0.npy"]),
], ids=["interp", "loop", "n_samples", "negative", "multicond_sequential", "compat"])
def test_cli_flags(cli_dirs, flags, frames, files):
    result = _cli(cli_dirs, "out_" + flags[0].strip("-"), *flags)
    assert [os.path.basename(p) for p in result["paths"]] == files
    for p in result["paths"]:
        arr = np.load(p)
        assert arr.shape == (frames, HW, HW, 3) and arr.dtype == np.uint8
    assert result["videos"][0].shape == (1, len(files), frames, HW, HW, 3)
    assert np.isfinite(result["videos"][0]).all()


def test_cli_negative_prompt_reaches_the_text_tower(cli_dirs, monkeypatch):
    """--negative_prompt embeds its text as the unconditional pass (with
    N(0, 0.02) weights the sample itself barely moves, so the texts are
    watched instead); --sequential_cfg leaves the sample as it is."""
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline

    texts = []
    real = DynamiCrafterPipeline.embed_text
    monkeypatch.setattr(DynamiCrafterPipeline, "embed_text",
                        lambda self, prompts: texts.append(list(prompts)) or real(self, prompts))
    base = _cli(cli_dirs, "cmp0")["videos"][0]
    assert texts == [["a fox in the snow"], [""]]
    del texts[:]
    _cli(cli_dirs, "cmp1", "--negative_prompt")
    _cli(cli_dirs, "cmp1", "--negative_prompt", "--negative_prompt_text", "blurry")
    assert [x[0] for x in texts[1::2]] == [
        "worst quality, blurry, distorted, low resolution", "blurry"]
    same = _cli(cli_dirs, "cmp2", "--sequential_cfg")["videos"][0]
    np.testing.assert_allclose(same, base, atol=1e-4)


def test_cli_sequential_cfg_is_the_default_at_width_1024(cli_dirs, monkeypatch):
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline

    seen = {}

    def fake_sample(self, prompts, videos, **kw):
        seen.update(kw)
        raise StopIteration

    monkeypatch.setattr(DynamiCrafterPipeline, "sample", fake_sample)
    with pytest.raises(StopIteration):
        _cli(cli_dirs, "wide", width=1024)
    assert seen["sequential_cfg"] is True
    with pytest.raises(StopIteration):
        _cli(cli_dirs, "narrow")
    assert seen["sequential_cfg"] is False
