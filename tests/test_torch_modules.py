"""Module parity: each ported module of the PyTorch package against its JAX
twin, at TINY_MODEL_CONFIG widths, fp32 on the CPU.

Weights come from one random Flax param tree (numpy, from a seed) and cross
over through `dynamicrafter_tpu.utils.export` (Flax tree -> reference
checkpoint keys) and `load_reference_state_dict`, so the tests also hold
the port's state_dict keys and ranks to the reference format. Tolerance:
relative L2 <= 1e-5 (fp32 on both sides; the difference is summation
order).

The helpers at the top are shared with test_torch_slice.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu.models import blocks as jb  # noqa: E402
from dynamicrafter_tpu.models import clip as jclip  # noqa: E402
from dynamicrafter_tpu.models import resampler as jres  # noqa: E402
from dynamicrafter_tpu.models import vae as jvae  # noqa: E402
from dynamicrafter_tpu.ops.norms import GroupNorm as JGroupNorm  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu.utils import export as E  # noqa: E402
from dynamicrafter_tpu_torch.models import blocks as tb  # noqa: E402
from dynamicrafter_tpu_torch.models import clip as tclip  # noqa: E402
from dynamicrafter_tpu_torch.models import resampler as tres  # noqa: E402
from dynamicrafter_tpu_torch.models import vae as tvae  # noqa: E402
from dynamicrafter_tpu_torch.ops.norms import GroupNorm  # noqa: E402
from dynamicrafter_tpu_torch.utils.weights import (  # noqa: E402
    DONOR_ONLY, SCHEDULE_BUFFERS, donor_only, load_reference_state_dict,
)

P = TINY_MODEL_CONFIG["model"]["params"]
TOL = 1e-5


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def random_params(module, *args, seed=0, method=None, **kwargs):
    """A Flax param tree for `module` filled from numpy (no jitted init):
    norm scales ~ 1 + N(0, 0.1), kernels ~ N(0, 1/fan_in), all else
    N(0, 0.02). Nothing is zero, so every branch shows in the output."""
    init = module.init if method is None else (
        lambda *a, **k: module.init(*a, method=method, **k))
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args, **kwargs))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['kernel']") and len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def to_frames(x):
    """JAX (B, T, H, W, C) -> port (B*T, C, H, W)."""
    b, tt, h, w, c = x.shape
    return t(x.transpose(0, 1, 4, 2, 3).reshape(b * tt, c, h, w))


def from_frames(y, b):
    bt, c, h, w = y.shape
    return y.detach().numpy().reshape(b, bt // b, c, h, w).transpose(0, 1, 3, 4, 2)


def load(module, sd, prefix=""):
    load_reference_state_dict(module, sd, prefix=prefix)
    return module.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_batch_axes", [1, 2])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_group_norm(num_batch_axes, eps):
    rng = np.random.default_rng(0)
    x = randn(rng, 2, 3, 5, 6, 64) + 3.0
    jm = JGroupNorm(32, epsilon=eps, num_batch_axes=num_batch_axes)
    prm = random_params(jm, x)
    ref = np.asarray(jm.apply({"params": prm}, x))
    gn = load(GroupNorm(32, 64, eps), {"weight": prm["scale"], "bias": prm["bias"]})
    if num_batch_axes == 2:   # per frame: (B*T, C, H, W)
        out = from_frames(gn(to_frames(x)), 2)
    else:                     # per clip: (B, C, T, H, W)
        out = gn(t(x.transpose(0, 4, 1, 2, 3))).numpy().transpose(0, 2, 3, 4, 1)
    assert rel_l2(out, ref) <= TOL


# ---------------------------------------------------------------------------
# UNet blocks
# ---------------------------------------------------------------------------

def _export(fn, tree, **kw):
    out = {}
    fn(tree, out, "", **kw)
    return out


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resblock_with_temporal_conv(cin, cout):
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 4, 6, 6, cin)
    emb = randn(rng, 2, 128)
    jm = jb.ResBlock(cin, 128, out_channels=cout, use_temporal_conv=True)
    prm = random_params(jm, x, emb)
    ref = np.asarray(jm.apply({"params": prm}, x, emb))
    tm = load(tb.ResBlock(cin, 128, out_channels=cout, use_temporal_conv=True),
              _export(E._export_resblock, prm))
    with torch.no_grad():
        out = from_frames(tm(to_frames(x), t(emb), 4), 2)
    assert rel_l2(out, ref) <= TOL


def test_spatial_transformer_dual_cross_attention():
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 3, 4, 5, 32)
    ctx_text = randn(rng, 2, 7, 48)
    ctx_img = randn(rng, 2, 3, 4, 48)
    kw = dict(context_dim=48, image_cross_attention=True,
              image_cross_attention_scale_learnable=True)
    jm = jb.SpatialTransformer(32, 2, 16, **kw)
    prm = random_params(jm, x, (ctx_text, ctx_img))
    ref = np.asarray(jm.apply({"params": prm}, x, (ctx_text, ctx_img)))
    tm = load(tb.SpatialTransformer(32, 2, 16, **kw),
              _export(E._export_transformer, prm, proj_rank=2))
    with torch.no_grad():
        out = from_frames(tm(to_frames(x), (t(ctx_text), t(ctx_img)), 3), 2)
    assert rel_l2(out, ref) <= TOL


@pytest.mark.parametrize("use_linear", [True, False])
def test_temporal_transformer(use_linear):
    """use_linear=False is init_attn's form: Conv1d projections."""
    rng = np.random.default_rng(3)
    x = randn(rng, 2, 4, 3, 5, 32)
    jm = jb.TemporalTransformer(32, 2, 16)
    prm = random_params(jm, x)
    ref = np.asarray(jm.apply({"params": prm}, x))
    tm = load(tb.TemporalTransformer(32, 2, 16, use_linear=use_linear),
              _export(E._export_transformer, prm, proj_rank=2 if use_linear else 3))
    with torch.no_grad():
        out = from_frames(tm(to_frames(x), 4), 2)
    assert rel_l2(out, ref) <= TOL


@pytest.mark.parametrize("kind", ["down", "up"])
def test_resample(kind):
    rng = np.random.default_rng(4)
    x = randn(rng, 1, 2, 6, 8, 32)
    jm = jb.Downsample(32) if kind == "down" else jb.Upsample(32)
    prm = random_params(jm, x)
    ref = np.asarray(jm.apply({"params": prm}, x))
    name = "op" if kind == "down" else "conv"
    sd = {f"{name}.weight": E._conv5d_to_2d(prm[name]["kernel"]),
          f"{name}.bias": prm[name]["bias"]}
    tm = load(tb.Downsample(32) if kind == "down" else tb.Upsample(32), sd)
    with torch.no_grad():
        out = from_frames(tm(to_frames(x)), 1)
    assert rel_l2(out, ref) <= TOL


# ---------------------------------------------------------------------------
# VAE, CLIP towers, Resampler
# ---------------------------------------------------------------------------

VAE_CFG = P["first_stage_config"]["params"]


@pytest.mark.parametrize("attn", [False, True])
def test_vae_encode_decode(attn):
    cfg_j = jvae.VAEConfig.from_dict(VAE_CFG)
    cfg_t = tvae.VAEConfig.from_dict(VAE_CFG)
    if attn:   # exercise AttnBlock at every level as well as the mid block
        cfg_j = jvae.VAEConfig(**{**cfg_j.__dict__, "attn_resolutions": (16, 8)})
        cfg_t = tvae.VAEConfig(**{**cfg_t.__dict__, "attn_resolutions": (16, 8)})
    rng = np.random.default_rng(5)
    x = randn(rng, 2, 16, 16, 3, scale=0.5)
    z = randn(rng, 2, 8, 8, 4)
    jm = jvae.AutoencoderKL(cfg_j)
    prm = random_params(jm, x)
    mom_ref = np.asarray(jm.apply({"params": prm}, x, method=jm.encode_moments))
    dec_ref = np.asarray(jm.apply({"params": prm}, z, method=jm.decode))
    tm = load(tvae.AutoencoderKL(cfg_t), E.export_vae(prm))
    with torch.no_grad():
        mom = tm.encode_moments(t(x)).numpy()
        dec = tm.decode(t(z)).numpy()
    assert rel_l2(mom, mom_ref) <= TOL
    assert rel_l2(dec, dec_ref) <= TOL
    noise = randn(rng, *mom.shape[:-1], 4)
    samp_ref = np.asarray(jvae.DiagonalGaussian(jnp.asarray(mom_ref)).sample(noise))
    samp = tvae.DiagonalGaussian(t(mom)).sample(t(noise)).numpy()
    assert rel_l2(samp, samp_ref) <= TOL


def test_clip_text_tower():
    cfg = P["clip_text_config"]["params"]
    jm = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**cfg))
    tokens = np.random.default_rng(6).integers(0, cfg["vocab_size"], (2, 77)).astype(np.int32)
    prm = random_params(jm, tokens)
    ref = np.asarray(jm.apply({"params": prm}, tokens))
    tm = load(tclip.CLIPTextEncoder(tclip.CLIPTextConfig(**cfg)),
              E.export_clip_text(prm), prefix="cond_stage_model.")
    with torch.no_grad():
        out = tm(t(tokens).long()).numpy()
    assert out.dtype == np.float32
    assert rel_l2(out, ref) <= TOL


@pytest.mark.parametrize("hw", [(40, 64), (20, 24)])
def test_clip_preprocess(hw):
    """Bicubic resize matrices, antialias blur and CLIP normalization; both
    a downscale that triggers the blur and an upscale that does not."""
    imgs = randn(np.random.default_rng(7), 2, *hw, 3)
    ref = np.asarray(jclip.clip_preprocess(jnp.asarray(imgs), 32))
    out = tclip.clip_preprocess(t(imgs), 32).numpy()
    assert rel_l2(out, ref) <= TOL


def test_clip_vision_tower():
    cfg = P["clip_vision_config"]["params"]
    jm = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(**cfg))
    px = randn(np.random.default_rng(8), 2, 32, 32, 3)
    prm = random_params(jm, px)
    ref = np.asarray(jm.apply({"params": prm}, px))
    tm = load(tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(**cfg)),
              E.export_clip_vision(prm), prefix="embedder.")
    with torch.no_grad():
        out = tm(t(px)).numpy()
    assert out.shape == (2, 17, cfg["width"])
    assert rel_l2(out, ref) <= TOL


def test_resampler():
    cfg = P["image_proj_stage_config"]["params"]
    jm = jres.Resampler(jres.ResamplerConfig.from_dict(cfg))
    x = randn(np.random.default_rng(9), 2, 17, cfg["embedding_dim"])
    prm = random_params(jm, x)
    ref = np.asarray(jm.apply({"params": prm}, x))
    tm = load(tres.Resampler(tres.ResamplerConfig.from_dict(cfg)), E.export_resampler(prm))
    with torch.no_grad():
        out = tm(t(x)).numpy()
    assert out.shape == (2, 16, cfg["output_dim"])
    assert rel_l2(out, ref) <= TOL


# ---------------------------------------------------------------------------
# strict loading
# ---------------------------------------------------------------------------

def _resampler_sd():
    cfg = P["image_proj_stage_config"]["params"]
    jm = jres.Resampler(jres.ResamplerConfig.from_dict(cfg))
    prm = random_params(jm, np.zeros((1, 17, cfg["embedding_dim"]), np.float32))
    return tres.Resampler(tres.ResamplerConfig.from_dict(cfg)), E.export_resampler(prm)


def test_strict_load_rejects_unexpected_key():
    module, sd = _resampler_sd()
    sd["layers.0.0.to_q.bias"] = np.zeros(32, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(module, sd, prefix="image_proj_model.")


def test_strict_load_rejects_missing_key():
    module, sd = _resampler_sd()
    del sd["latents"]
    with pytest.raises(KeyError, match="missing"):
        load_reference_state_dict(module, sd, prefix="image_proj_model.")


def test_strict_load_rejects_shape_mismatch():
    module, sd = _resampler_sd()
    sd["latents"] = sd["latents"][:, :-1]
    with pytest.raises(ValueError, match="latents"):
        load_reference_state_dict(module, sd, prefix="image_proj_model.")


def test_donor_only_keys_are_dropped_by_name():
    """The explicit list: schedule buffers, text pooling head and its last
    block, vision pooling head and normalization constants, VAE loss.*."""
    dropped = ["betas", "alphas_cumprod", "scale_arr", "posterior_variance",
               "cond_stage_model.model.text_projection",
               "cond_stage_model.model.logit_scale",
               "cond_stage_model.model.attn_mask",
               "embedder.model.visual.ln_post.weight",
               "embedder.model.visual.ln_post.bias",
               "embedder.model.visual.proj", "embedder.mean", "embedder.std",
               "first_stage_model.loss.logvar",
               "first_stage_model.loss.discriminator.main.0.weight"]
    for k in dropped:
        assert donor_only(k), k
    assert donor_only("cond_stage_model.model.transformer.resblocks.23.ln_1.weight", 23)
    kept = ["cond_stage_model.model.transformer.resblocks.22.ln_1.weight",
            "embedder.model.visual.ln_pre.weight",
            "model.diffusion_model.out.2.weight",
            "first_stage_model.decoder.conv_out.weight",
            "image_proj_model.latents"]
    for k in kept:
        assert not donor_only(k, 23), k
    assert "betas" in SCHEDULE_BUFFERS and len(DONOR_ONLY) == 4


def test_text_tower_last_block_dropped_on_load():
    """A penultimate text tower loads a checkpoint that still holds the last
    block (released checkpoints do); any other extra block is an error."""
    cfg = P["clip_text_config"]["params"]
    jm = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**cfg))
    prm = random_params(jm, np.zeros((1, 77), np.int32))
    sd = E.export_clip_text(prm)
    last = {k.replace("resblocks.0.", "resblocks.1."): v for k, v in sd.items()
            if ".resblocks.0." in k}
    tm = tclip.CLIPTextEncoder(tclip.CLIPTextConfig(**cfg))
    load_reference_state_dict(tm, {**sd, **last}, prefix="cond_stage_model.")
    extra = {k.replace("resblocks.0.", "resblocks.2."): v for k, v in sd.items()
             if ".resblocks.0." in k}
    with pytest.raises(KeyError, match="unexpected"):
        load_reference_state_dict(tm, {**sd, **last, **extra}, prefix="cond_stage_model.")
