"""Config loading and schedule math of the PyTorch package against the JAX
package: the PyYAML-free loader against yaml.safe_load, schedule and DDIM
tables bit for bit, and the timestep embedding to 1e-6."""
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from dynamicrafter_tpu import config as jconfig  # noqa: E402
from dynamicrafter_tpu import schedule as jsched  # noqa: E402
from dynamicrafter_tpu_torch import config as tconfig  # noqa: E402
from dynamicrafter_tpu_torch import schedule as tsched  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_all_six_configs_are_covered():
    assert len(CONFIGS) == 6


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_subset_loader_equals_pyyaml(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert tconfig.load_yaml(path) == ref


@pytest.mark.parametrize("path", [p for p in CONFIGS if "inference" in p],
                         ids=os.path.basename)
def test_model_config_fields_match(path):
    ours = vars(tconfig.ModelConfig.from_yaml(path))
    ref = vars(jconfig.ModelConfig.from_yaml(path))
    assert ours == ref


@pytest.mark.parametrize("text,expected", [
    ("a: 1\nb: 1.0e-05\nc: 1e-5\nd: [1, 2]\ne: []\nf: ~\ng: yes\nh: '7'\n",
     {"a": 1, "b": 1e-05, "c": "1e-5", "d": [1, 2], "e": [], "f": None, "g": True,
      "h": "7"}),
    ("m:\n  k:\n  - 4\n  - x  # note\n  n: false\n", {"m": {"k": [4, "x"], "n": False}}),
])
def test_yaml_scalar_resolution(text, expected):
    assert tconfig.parse_yaml(text) == yaml.safe_load(text) == expected


def test_yaml_outside_subset_raises():
    with pytest.raises(ValueError):
        tconfig.parse_yaml("a:\n- b: 1\n")


def _tables(obj):
    return {k: v for k, v in vars(obj).items() if v is not None}


SCHEDULES = [
    dict(linear_start=0.00085, linear_end=0.012, parameterization="v",
         rescale_betas_zero_snr=True, use_dynamic_rescale=True, base_scale=0.7),
    dict(linear_start=0.00085, linear_end=0.012, parameterization="eps"),
    dict(beta_schedule="cosine", parameterization="x0"),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_tables_bit_exact(kw):
    ours, ref = _tables(tsched.build_schedule(**kw)), _tables(jsched.build_schedule(**kw))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
        assert ours[k].dtype == np.float32, k


@pytest.mark.parametrize("discretize", ["uniform", "uniform_trailing"])
@pytest.mark.parametrize("steps,eta", [(50, 1.0), (4, 0.0), (25, 0.5)])
def test_ddim_tables_bit_exact(discretize, steps, eta):
    kw = SCHEDULES[0]
    ours = tsched.build_ddim_table(tsched.build_schedule(**kw), num_steps=steps,
                                   discretize=discretize, eta=eta)
    ref = jsched.build_ddim_table(jsched.build_schedule(**kw), num_steps=steps,
                                  discretize=discretize, eta=eta)
    o, r = _tables(ours), _tables(ref)
    assert set(o) == set(r)
    for k in r:
        np.testing.assert_array_equal(o[k], np.asarray(r[k]), err_msg=k)


@pytest.mark.parametrize("dim", [320, 32, 7])
def test_timestep_embedding(dim):
    ts = np.concatenate([np.arange(1000), [3, 10, 24]]).astype(np.int32)
    ref = np.asarray(jsched.timestep_embedding(jnp.asarray(ts), dim))
    ours = tsched.timestep_embedding(torch.from_numpy(ts.astype(np.int64)), dim).numpy()
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-6


def test_rescale_noise_cfg():
    rng = np.random.default_rng(0)
    cfg, text = (rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jsched.rescale_noise_cfg(jnp.asarray(cfg), jnp.asarray(text), 0.7))
    ours = tsched.rescale_noise_cfg(torch.from_numpy(cfg), torch.from_numpy(text), 0.7)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
