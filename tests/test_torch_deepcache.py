"""DeepCache in the PyTorch package (the UNet's cache seam and the grouped DDIM
loop), and `pipeline.sample` and the CLI with the dpm and unipc samplers and
DeepCache, against the JAX package at TINY_MODEL_CONFIG size, fp32 on the
CPU. Weights and random numbers as in test_torch_samplers.py.

Tolerances: whole-model comparisons relative L2 <= 1e-4 (latents through the
pipeline 1e-3, as test_torch_slice.py); the achieved values are noted at
each test. The seam: a shallow forward from the same call's own cache
repeats the same operations on the same numbers and is exactly equal.
"""
import copy
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import yaml  # noqa: E402

from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu_torch import inference  # noqa: E402
from dynamicrafter_tpu_torch import schedule as tsched  # noqa: E402
from dynamicrafter_tpu_torch.sampling import ddim as tddim  # noqa: E402
from test_torch_modules import randn, rel_l2, t  # noqa: E402
from test_torch_samplers import SHAPE, _run_both, few_torch_threads  # noqa: E402,F401
from test_torch_slice import EXAMPLE_PNG, HW, LAT, T, pipes  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# DeepCache: the UNet seam and the grouped DDIM loop
# ---------------------------------------------------------------------------

def test_unet_cache_seam(pipes):
    """`return_cache` gives the JAX UNet's deep feature and leaves the output
    as it was; a shallow forward from that cache equals the full forward
    exactly; at other inputs it runs only the top level (its result differs
    from the full one)."""
    jp, tp = pipes
    rng = np.random.default_rng(37)
    x = randn(rng, 2, T, LAT, LAT, 8)
    ts = np.array([999, 17], np.int32)
    ct, ci = randn(rng, 2, 77, 48), randn(rng, 2, T, 4, 48)
    fs = np.array([3, 24], np.int32)
    ref, ref_cache = jax.jit(lambda p, *a: jp.unet.apply(
        {"params": p}, a[0], a[1], context_text=a[2], context_img=a[3], fs=a[4],
        return_cache=True))(jp.params["unet"], x, ts, ct, ci, fs)
    args = [t(a) for a in (x, ts.astype(np.int64), ct, ci, fs.astype(np.int64))]
    with torch.no_grad():
        full = tp.unet(*args)
        out, cache = tp.unet(*args, return_cache=True)
        shallow = tp.unet(*args, cache=cache)
        other = tp.unet(t(x) + 0.1, *args[1:], cache=cache)
        full_other = tp.unet(t(x) + 0.1, *args[1:])
    assert cache.shape == ref_cache.shape
    assert rel_l2(cache.numpy(), np.asarray(ref_cache)) <= 1e-4
    assert rel_l2(out.numpy(), np.asarray(ref)) <= 1e-4
    assert torch.equal(out, full)
    assert torch.equal(shallow, full)
    assert not torch.equal(other, full_other)
    assert rel_l2(other.numpy(), full_other.numpy()) <= 0.5    # an approximation of it


def test_unet_cache_seam_skips_the_deep_levels(pipes, monkeypatch):
    """A shallow call runs 1 + num_res_blocks input blocks, no middle block
    and num_res_blocks + 1 output blocks."""
    _, tp = pipes
    seen = []
    real = tp.unet._run_layers
    monkeypatch.setattr(tp.unet, "_run_layers",
                        lambda layers, *a: seen.append(layers) or real(layers, *a))
    rng = np.random.default_rng(38)
    args = [t(randn(rng, 1, T, LAT, LAT, 8)), torch.tensor([500]), t(randn(rng, 1, 77, 48)),
            t(randn(rng, 1, T, 4, 48)), torch.tensor([3])]
    with torch.no_grad():
        _, cache = tp.unet(*args, return_cache=True)
        n_full = len(seen)
        seen.clear()
        tp.unet(*args, cache=cache)
    n_res = tp.unet.config.num_res_blocks
    assert n_full == len(tp.unet.input_blocks) + 1 + len(tp.unet.output_blocks)
    assert len(seen) == (1 + n_res) + (n_res + 1)
    assert all(layers is not tp.unet.middle_block for layers in seen)


def test_unet_cache_needs_two_levels():
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel

    cfg = dict(TINY_MODEL_CONFIG["model"]["params"]["unet_config"]["params"])
    unet = UNetModel(UNetConfig.from_dict({**cfg, "channel_mult": [1]}))
    x = torch.zeros(1, T, LAT, LAT, 8)
    kw = dict(context_text=torch.zeros(1, 77, 48), context_img=torch.zeros(1, T, 4, 48))
    with pytest.raises(ValueError, match=">=2 UNet levels"):
        unet(x, torch.tensor([1]), return_cache=True, **kw)
    with pytest.raises(ValueError, match=">=2 UNet levels"):
        unet(x, torch.tensor([1]), cache=torch.zeros(1, T, LAT, LAT, 32), **kw)


@pytest.mark.parametrize("sequential_cfg", [False, True])
def test_deepcache_ddim_matches_jax(pipes, sequential_cfg):
    """6 DDIM steps in groups of 3 (2 full calls, 4 shallow), batched CFG
    and sequential CFG (one cache per pass, stacked). Achieved rel L2 4.0e-6
    and 3.8e-6."""
    out, ref = _run_both(pipes, "ddim", 6, seed=39, deepcache=3,
                         sequential_cfg=sequential_cfg)
    assert np.isfinite(out).all() and rel_l2(out, ref) <= 1e-4


def test_deepcache_calls_full_then_shallow(pipes):
    """Groups of N: a full call with return_cache, then N - 1 calls from
    that cache; deepcache = 1 passes neither keyword."""
    _, tp = pipes
    calls = []

    def model(x, ts, cache=None, return_cache=False):
        calls.append(("full" if return_cache else "shallow" if cache is not None else "plain",
                      cache))
        out = torch.tanh(x) * 0.5
        return (out, len(calls)) if return_cache else out

    ttab = tsched.build_ddim_table(tp.schedule, num_steps=6, discretize="uniform_trailing",
                                   eta=0.0)
    x_T = t(randn(np.random.default_rng(40), *SHAPE))
    tddim.ddim_sample(model, x_T, tp.schedule, ttab, tddim.SamplerSettings(steps=6, deepcache=3))
    assert calls == [("full", None), ("shallow", 1), ("shallow", 1),
                     ("full", None), ("shallow", 4), ("shallow", 4)]
    calls.clear()
    tddim.ddim_sample(lambda x, ts: model(x, ts), x_T, tp.schedule, ttab,
                      tddim.SamplerSettings(steps=6))
    assert [c[0] for c in calls] == ["plain"] * 6


# ---------------------------------------------------------------------------
# the pipeline and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(sampler="dpm"), dict(sampler="unipc", solver_order=3),
                                dict(deepcache=2)], ids=["dpm", "unipc3", "deepcache2"])
def test_pipeline_sample_with_each_sampler_matches_jax(pipes, kw):
    """pipeline.sample end to end (conditioning, 4 sampler steps with 2-pass
    CFG and guidance rescale, latents out). eta = 1 is passed on purpose: it
    is forced to 0 for dpm and unipc; DeepCache keeps it, so its test feeds
    eta 0 (the step noise would come from different generators). Achieved
    rel L2 5.8e-6, 8.7e-6, 5.8e-6."""
    jp, tp = pipes
    rng = np.random.default_rng(41)
    seed = 123
    videos = np.repeat(randn(rng, 1, 1, HW, HW, 3, scale=0.5).clip(-1, 1), T, axis=1)
    x_T = randn(rng, 1, T, LAT, LAT, 4)
    enc_noise = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(seed))[1], (T, LAT, LAT, 4)))
    common = dict(steps=4, cfg_scale=7.5, eta=0.0 if "deepcache" in kw else 1.0,
                  timestep_spacing="uniform_trailing", guidance_rescale=0.7, fs=[3],
                  seed=seed, x_T=x_T, decode=False, **kw)
    prompts = ["a red fox running through snow"]
    j_lat = np.asarray(jp.sample(prompts, videos, **common))
    t_lat = tp.sample(prompts, videos, encode_noise=enc_noise, **common)
    assert t_lat.shape == j_lat.shape == (1, 1, T, LAT, LAT, 4)
    assert rel_l2(t_lat, j_lat) <= 1e-3


def _tiny_cli_dir(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(copy.deepcopy(TINY_MODEL_CONFIG)))
    prompts = tmp_path / "prompts"
    prompts.mkdir(exist_ok=True)
    shutil.copy(EXAMPLE_PNG, prompts / "example.png")
    (prompts / "prompts.txt").write_text("a fox in the snow\n")
    return ["--config", str(cfg), "--prompt_dir", str(prompts), "--random_init", "--height",
            str(HW), "--width", str(HW), "--frame_stride", "24", "--timestep_spacing",
            "uniform_trailing", "--guidance_rescale", "0.7", "--unconditional_guidance_scale",
            "7.5", "--text_input", "--video_length", str(T), "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--sampler", "dpm", "--ddim_steps", "3"],
    ["--sampler", "unipc", "--solver_order", "3", "--ddim_steps", "4"],
    ["--deepcache", "2", "--ddim_steps", "4"],
], ids=["dpm", "unipc", "deepcache"])
def test_inference_cli_flags_in_a_fresh_interpreter(tmp_path, flags):
    """`python -m dynamicrafter_tpu_torch.inference` with each new flag."""
    out_dir = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "dynamicrafter_tpu_torch.inference", *_tiny_cli_dir(tmp_path),
         "--savedir", str(out_dir), *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    frames = np.load(out_dir / "example.npy")
    assert frames.shape == (T, HW, HW, 3) and frames.dtype == np.uint8
    assert len(np.unique(frames)) > 1


def test_inference_cli_passes_the_flags_on(tmp_path, monkeypatch):
    """--sampler, --solver_order and --deepcache reach `sample`."""
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline

    seen = {}
    real = DynamiCrafterPipeline.sample

    def spy(self, *a, **kw):
        seen.update(kw)
        return real(self, *a, **kw)

    monkeypatch.setattr(DynamiCrafterPipeline, "sample", spy)
    inference.main([*_tiny_cli_dir(tmp_path), "--savedir", str(tmp_path / "o"), "--sampler",
                    "unipc", "--solver_order", "1", "--ddim_steps", "2"])
    assert (seen["sampler"], seen["solver_order"], seen["deepcache"]) == ("unipc", 1, 1)
    inference.main([*_tiny_cli_dir(tmp_path), "--savedir", str(tmp_path / "o2"),
                    "--deepcache", "2", "--ddim_steps", "2"])
    assert (seen["sampler"], seen["deepcache"]) == ("ddim", 2)


def test_inference_cli_refuses_a_deepcache_that_does_not_divide(tmp_path):
    with pytest.raises(SystemExit, match="--deepcache 4 must divide --ddim_steps 6"):
        inference.main(["--config", "none.yaml", "--prompt_dir", str(tmp_path),
                        "--deepcache", "4", "--ddim_steps", "6"])
    with pytest.raises(SystemExit):      # argparse: not a choice
        inference.main(["--config", "none.yaml", "--prompt_dir", str(tmp_path),
                        "--sampler", "euler"])
