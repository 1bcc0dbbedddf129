"""The port's sampler-quality scripts (`dynamicrafter_tpu_torch.dpm_certify`
here, `dynamicrafter_tpu_torch.deepcache_certify` in
test_torch_certify_deepcache.py) against their JAX twins
(`scripts/dpm_certify.py`, `scripts/deepcache_certify.py`), row by row, at
TINY_MODEL_CONFIG size on 8x8 latents, fp32 on the CPU. Each JAX candidate
compiles its own sampling loop (7-8 s here), so the two scripts' tests sit
in two files of about a minute each.

Both packages get the same weights (one random Flax param tree for the UNet
and the VAE, handed to the JAX scripts as their `real=` params and to the
port through `export_state_dict` as its `weights=`) and the same draws
(x_T and the conditioning drawn with `jax.random.PRNGKey(11)` exactly as the
JAX scripts draw them, handed to the port as numpy through `draws=`). The
smallest settings that reach every branch: a dpm reference of 6 steps with
candidates dpm, ddim and unipc at 2-3 steps and dpm at the reference's own
count, DeepCache N = 2 at a step count it does not divide, both CFG modes.

Tolerances: PSNRs within 0.05 dB, the relative L2 within 1e-3 of the JAX
value plus 1e-5 (both scripts round it to 5 decimals), SSIM within 1e-3
(rounded to 4 decimals); the sampled latents themselves agree to ~1e-5
(test_torch_samplers.py), far inside these.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dynamicrafter_tpu.models.unet3d import UNetConfig as JUNetConfig  # noqa: E402
from dynamicrafter_tpu.models.unet3d import UNetModel as JUNetModel  # noqa: E402
from dynamicrafter_tpu.models.vae import AutoencoderKL as JAutoencoderKL  # noqa: E402
from dynamicrafter_tpu.models.vae import VAEConfig as JVAEConfig  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu.utils.export import export_state_dict  # noqa: E402
from dynamicrafter_tpu_torch import dpm_certify  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from test_torch_modules import random_params  # noqa: E402
from test_torch_samplers import few_torch_threads  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
import dpm_certify as j_dpm_certify  # noqa: E402

H = W = 8
T = 4


@pytest.fixture(scope="module")
def weights():
    """(JAX `real=` params, the port's reference-keyed state dict)."""
    jmc = JModelConfig(TINY_MODEL_CONFIG)
    ucfg, vcfg = JUNetConfig.from_dict(jmc.unet), JVAEConfig.from_dict(jmc.vae)
    up = random_params(JUNetModel(ucfg), np.zeros((1, T, H, W, ucfg.in_channels), np.float32),
                       np.zeros((1,), np.int32), context_text=np.zeros((1, 77, 48), np.float32),
                       context_img=np.zeros((1, T, 4, 48), np.float32),
                       fs=np.zeros((1,), np.int32), seed=1)
    vp = random_params(JAutoencoderKL(vcfg), np.zeros((1, 16, 16, 3), np.float32), seed=2)
    sd = export_state_dict({"unet": up, "vae": vp}, unet_config=ucfg)
    return (up, vp["decoder"]), sd


def jax_draws(passes):
    """x_T and the conditioning as both JAX scripts draw them (fp32)."""
    jmc = JModelConfig(TINY_MODEL_CONFIG)
    ucfg, zc = JUNetConfig.from_dict(jmc.unet), JVAEConfig.from_dict(jmc.vae).z_channels
    t_len, ctx, n_img = ucfg.temporal_length, ucfg.context_dim, jmc.resampler["num_queries"]
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    draws = {"x_T": jax.random.normal(keys[0], (1, t_len, H, W, zc), jnp.float32),
             "context_text": jax.random.normal(keys[1], (passes, 1, 77, ctx), jnp.float32) * 0.1,
             "context_img": jax.random.normal(
                 keys[2], (passes, 1, t_len, n_img, ctx), jnp.float32) * 0.1,
             "concat": jax.random.normal(keys[3], (passes, 1, t_len, H, W, zc), jnp.float32)}
    return {k: np.asarray(v) for k, v in draws.items()}


def _same_rows(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r), (g, r)
        for key, want in r.items():
            have = g[key]
            if key == "seconds":
                continue
            if want is None or isinstance(want, (int, str)) or not np.isfinite(want):
                assert have == want, (key, g, r)
            elif key == "rel_l2_vs_ref":
                assert abs(have - want) <= 1e-3 * abs(want) + 1e-5, (key, g, r)
            elif key == "pixel_ssim":
                assert abs(have - want) <= 1e-3, (key, g, r)
            else:
                assert abs(have - want) <= 0.05, (key, g, r)


@pytest.mark.parametrize("passes,candidates", [
    (2, [("dpm", 6), ("dpm", 3), ("ddim", 2)]),
    (3, [("dpm", 6), ("unipc", 3)])])
def test_dpm_certify_rows_match_jax(weights, passes, candidates):
    """dpm@6 reproduces the reference in both (rel L2 0, PSNR null); every
    other row matches the JAX row."""
    real, sd = weights
    ref = j_dpm_certify.run_config(JModelConfig(TINY_MODEL_CONFIG), H, W, candidates, 6,
                                   passes, jnp.float32, real=real)
    got = dpm_certify.run_config(ModelConfig(TINY_MODEL_CONFIG), H, W, candidates, 6, passes,
                                 torch.float32, weights=sd, draws=jax_draws(passes),
                                 device="cpu")
    _same_rows(got, ref)
    assert got[0]["rel_l2_vs_ref"] == 0.0 and got[0]["latent_psnr_db"] is None
    assert all(r["rel_l2_vs_ref"] > 0 and np.isfinite(r["pixel_psnr_db"]) for r in got[1:])


def test_dpm_certify_cli_on_the_cpu(tmp_path, capsys):
    """`python -m dynamicrafter_tpu_torch.dpm_certify` with a tiny YAML: one
    JSON line a candidate, dpm at the reference's count reproducing it."""
    import json

    import yaml

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    rows = dpm_certify.main(["--config", str(cfg), "--resolutions", "256", "--latent_hw", "8,8",
                             "--ref_steps", "4", "--candidates", "dpm:4,ddim:2",
                             "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [(r["sampler"], r["steps"]) for r in lines] == [("dpm", 4), ("ddim", 2)]
    assert rows[0]["rel_l2_vs_ref"] == 0.0 and rows[1]["rel_l2_vs_ref"] > 0
    assert all(r["resolution"] == "256" and r["weights"] == "random" for r in rows)


def test_certify_refuses_a_checkpoint_for_two_resolutions(tmp_path):
    with pytest.raises(SystemExit, match="one resolution"):
        dpm_certify.main(["--resolutions", "256,512", "--ckpt_path", str(tmp_path / "m.ckpt"),
                          "--device", "cpu"])
