"""Config loading and schedule math of the PyTorch package against the JAX
package: the PyYAML-free loader against yaml.safe_load, the training roots
as the JAX training CLI reads them, schedule and DDIM tables bit for bit,
the batched-t forward process, and the timestep embedding to 1e-6."""
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
# DynamiCrafter's (LatentVisualDiffusion); the sgm ones (Stable Video
# Diffusion) have tests/test_torch_svd.py
DC_CONFIGS = [p for p in CONFIGS if not tconfig.is_svd(tconfig.load_yaml(p))]


def test_all_six_configs_are_covered():
    assert len(DC_CONFIGS) == 6


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_subset_loader_equals_pyyaml(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert tconfig.load_yaml(path) == ref


@pytest.mark.parametrize("path", [p for p in DC_CONFIGS if "inference" in p],
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
    ("a:\n- b: 1\n  c:\n    d: [2]\n\n- e: x\n- 3\n",
     {"a": [{"b": 1, "c": {"d": [2]}}, {"e": "x"}, 3]}),
])
def test_yaml_scalar_resolution(text, expected):
    assert tconfig.parse_yaml(text) == yaml.safe_load(text) == expected


def test_yaml_outside_subset_raises():
    with pytest.raises(ValueError):
        tconfig.parse_yaml("a: {b: 1}\n")


@pytest.mark.parametrize("name", ["training_512_v1.0.yaml", "training_512_interp.yaml",
                                  "training_1024_v1.0.yaml"])
def test_training_config_reads_data_and_lightning(name):
    """The `data:` and `lightning:` roots, with the defaults
    scripts/train.py of the JAX package applies."""
    path = os.path.join(REPO, "configs", name)
    with open(path) as f:
        raw = yaml.safe_load(f)
    tc = tconfig.TrainingConfig.from_yaml([path])
    assert tc.raw == raw
    assert vars(tc.model) == vars(jconfig.ModelConfig(raw))
    trainer = raw["lightning"]["trainer"]
    data = raw["data"]["params"]
    assert (tc.accumulate_grad_batches, tc.max_steps, tc.gradient_clip_val) == (
        trainer["accumulate_grad_batches"], trainer["max_steps"], trainer["gradient_clip_val"])
    assert (tc.batch_size, tc.num_workers) == (data["batch_size"], data["num_workers"])
    assert tc.train_data == data["train"]["params"] and tc.validation_data == {}
    assert tc.checkpoint == raw["lightning"]["callbacks"]["model_checkpoint"]["params"]
    assert (tc.base_learning_rate, tc.scale_lr) == (raw["model"]["base_learning_rate"],
                                                    raw["model"]["scale_lr"])


def test_training_configs_merge_left_to_right(tmp_path):
    extra = tmp_path / "extra.yaml"
    extra.write_text("lightning:\n  trainer:\n    max_steps: 7\n")
    tc = tconfig.TrainingConfig.from_yaml(
        [os.path.join(REPO, "configs", "training_512_v1.0.yaml"), str(extra)])
    assert tc.max_steps == 7 and tc.accumulate_grad_batches == 2


def test_q_sample_and_get_v_match_jax():
    """Per-sample timesteps, as the train step uses them."""
    kw = SCHEDULES[0]
    ours, ref = tsched.build_schedule(**kw), jsched.build_schedule(**kw)
    rng = np.random.default_rng(1)
    x, noise = (rng.standard_normal((3, 4, 5, 6, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 417, 999])
    tt = torch.from_numpy(t)
    np.testing.assert_allclose(
        ours.q_sample(torch.from_numpy(x), tt, torch.from_numpy(noise)).numpy(),
        np.asarray(ref.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ours.get_v(torch.from_numpy(x), torch.from_numpy(noise), tt).numpy(),
        np.asarray(ref.get_v(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))),
        rtol=1e-6, atol=1e-6)
    scale = tsched.extract_into_tensor(ours.scale_arr, tt, 5)
    assert scale.shape == (3, 1, 1, 1, 1)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(
        jsched.extract_into_tensor(ref.scale_arr, jnp.asarray(t), 5)))


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
