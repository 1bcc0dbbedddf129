"""`dynamicrafter_tpu_torch.deepcache_certify` against its JAX twin
`scripts/deepcache_certify.py`, row by row, at TINY_MODEL_CONFIG size on 8x8
latents, fp32 on the CPU: the weights, draws and tolerances of
test_torch_certify.py (its docstring), whose fixtures this file shares.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu_torch import deepcache_certify  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from test_torch_certify import H, W, _same_rows, jax_draws, weights  # noqa: E402,F401
from test_torch_samplers import few_torch_threads  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))
import deepcache_certify as j_deepcache_certify  # noqa: E402


@pytest.mark.parametrize("passes", [2, 3])
def test_deepcache_certify_rows_match_jax(weights, passes):
    """N = 2 does not divide 3 steps: both run it at 2 against a 2-step exact
    baseline."""
    real, sd = weights
    ref = j_deepcache_certify.run_config(JModelConfig(TINY_MODEL_CONFIG), H, W, 3, [2], passes,
                                         jnp.float32, real=real)
    got = deepcache_certify.run_config(ModelConfig(TINY_MODEL_CONFIG), H, W, 3, [2], passes,
                                       torch.float32, weights=sd, draws=jax_draws(passes),
                                       device="cpu")
    _same_rows(got, ref)
    assert got[0]["steps"] == 2 and np.isfinite(got[0]["latent_psnr_db"])


def test_deepcache_certify_cli_on_the_cpu(tmp_path):
    """`python -m dynamicrafter_tpu_torch.deepcache_certify` with a tiny YAML,
    random weights, N = 1 (which reproduces its baseline: infinite PSNR,
    SSIM 1) and N = 2, and the markdown table appended."""
    import yaml

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    out = tmp_path / "table.md"
    rows = deepcache_certify.main(["--config", str(cfg), "--resolutions", "512", "--latent_hw",
                                   "8,8", "--steps", "2", "--intervals", "1,2", "--cfg_passes",
                                   "2", "--device", "cpu",
                                   "--out", str(out)])
    assert [r["interval_N"] for r in rows] == [1, 2]
    assert rows[0]["latent_psnr_db"] == float("inf") and rows[0]["pixel_ssim"] == 1.0
    assert np.isfinite(rows[1]["latent_psnr_db"]) and rows[1]["weights"] == "random"
    assert out.read_text().count("| 512 | 2-pass |") == 2


