"""The port's SDS guidance path against the JAX package's, at
TINY_MODEL_CONFIG size, fp32 on the CPU.

Both pipelines hold the same weights (the fixture of test_torch_slice.py)
and get the same random numbers: the test draws what
`dynamicrafter_tpu/sds.py` draws from its `jax.random` key (the VAE encode
noise, then per optimisation step the timestep indices and the diffusion
noise) and hands them to the port through `encode_noise=` and `draws=`;
both start from the same `init_latents`. Tolerances: latents atol 1e-4
after 4 Adam steps of lr 0.05 (fp32 UNets that agree to ~1e-5; Adam
normalises the gradient, so an update differs by about lr times that), loss
curve rel 1e-3.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from dynamicrafter_tpu import sds as jsds  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu_torch import generate_guidance  # noqa: E402
from dynamicrafter_tpu_torch import sds as tsds  # noqa: E402
from dynamicrafter_tpu_torch.utils import video as tvideo  # noqa: E402
from test_torch_modules import randn  # noqa: E402
from test_torch_slice import EXAMPLE_PNG, HW, LAT, T, pipes  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Tiny tensors: more intra-op threads only contend with the other test
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SETTINGS = dict(num_steps=4, log_every=2, lr=0.05, cfg_scale=2.0, ddim_grid_steps=4,
                timestep_spacing="uniform_trailing", guidance_rescale=0.7)


def jax_draws(seed, steps, b, n_grid):
    """What dynamicrafter_tpu/sds.py draws: `__call__` splits its key in
    three (carry, encode, init); each scan step splits the carry, then the
    sub-key into the timestep and the noise key."""
    rng, enc_rng, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    enc_noise = jax.random.normal(enc_rng, (b * T, LAT, LAT, 4))
    idx, noise = [], []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        r_t, r_n = jax.random.split(sub)
        idx.append(jax.random.randint(r_t, (b,), 0, n_grid))
        noise.append(jax.random.normal(r_n, (b, T, LAT, LAT, 4), jnp.float32))
    draws = tsds.SDSDraws(torch.tensor(np.array(jnp.stack(idx)), dtype=torch.long),
                          torch.tensor(np.array(jnp.stack(noise))))
    return np.asarray(enc_noise), draws


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    videos = np.repeat(randn(rng, b, 1, HW, HW, 3, scale=0.5).clip(-1, 1), T, axis=1)
    return videos, randn(rng, b, T, LAT, LAT, 4), ["a cat", "a red fox in the snow"][:b]


@pytest.mark.parametrize("weight_type,optimizer,b", [
    ("t", "Adam", 1), ("ada", "Adam", 1), ("uniform", "Adam", 1), ("t", "AdamW", 1),
    ("t", "Adam", 2)])
def test_sds_matches_jax(pipes, weight_type, optimizer, b):  # noqa: F811
    """Four optimisation steps, 2-pass CFG with guidance rescale, v-param;
    with b = 2 the two samples draw different timesteps."""
    jp, tp = pipes
    kw = dict(SETTINGS, weight_type=weight_type, optimizer_type=optimizer,
              negative_prompt="blurry")
    videos, init, prompts = _inputs(b, 20)
    seed, fs = 7, [3, 24][:b]
    jpipe = jsds.SDSGuidancePipeline(jp, jsds.SDSSettings(**kw))
    tpipe = tsds.SDSGuidancePipeline(tp, tsds.SDSSettings(**kw))
    np.testing.assert_array_equal(tpipe.t_grid.numpy(), np.asarray(jpipe._t_grid))
    ref = jpipe(prompts, videos, seed=seed, fs=fs, init_latents=init, decode=False)
    enc_noise, draws = jax_draws(seed, 4, b, len(tpipe.t_grid))
    out = tpipe(prompts, videos, seed=seed, fs=fs, init_latents=init, decode=False,
                encode_noise=enc_noise, draws=draws)
    assert out["latents"].shape == ref["latents"].shape == (b, T, LAT, LAT, 4)
    assert np.abs(ref["latents"] - init).max() > 0.05          # four steps of lr 0.05
    np.testing.assert_allclose(out["latents"], ref["latents"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["loss_curve"], ref["loss_curve"], rtol=1e-3)
    if b == 2:
        assert len(set(tpipe.t_grid[draws.t_index].flatten().tolist())) > 1


@pytest.mark.parametrize("spacing,grid,lo,hi", [
    ("uniform", 50, 0.02, 0.98), ("uniform_trailing", 50, 0.02, 0.98),
    ("uniform_trailing", 4, 0.02, 0.98), ("uniform", 10, 0.3, 0.3)])
def test_timestep_grid_matches_jax(pipes, spacing, grid, lo, hi):  # noqa: F811
    jp, tp = pipes
    kw = dict(timestep_spacing=spacing, ddim_grid_steps=grid, min_step_ratio=lo,
              max_step_ratio=hi)
    ref = np.asarray(jsds.SDSGuidancePipeline(jp, jsds.SDSSettings(**kw))._t_grid)
    ours = tsds.SDSGuidancePipeline(tp, tsds.SDSSettings(**kw)).t_grid.numpy()
    np.testing.assert_array_equal(ours, ref)
    assert len(ours) >= 1


def test_chunks_are_whole(pipes):  # noqa: F811
    """The JAX loop makes max(1, num_steps // log_every) chunks of log_every."""
    _, tp = pipes
    steps = lambda n, every: tsds.SDSGuidancePipeline(
        tp, tsds.SDSSettings(num_steps=n, log_every=every)).total_steps
    assert (steps(4, 2), steps(5, 2), steps(2, 50), steps(1000, 50)) == (4, 4, 50, 1000)


def test_own_draws_follow_the_seed(pipes):  # noqa: F811
    _, tp = pipes
    videos, _, prompts = _inputs(1, 21)
    pipe = tsds.SDSGuidancePipeline(tp, tsds.SDSSettings(**dict(SETTINGS, num_steps=2)))
    a, b, c = (pipe(prompts, videos, seed=s, fs=[3], decode=False)["latents"]
               for s in (3, 3, 4))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0.1
    assert np.isfinite(a).all() and a.shape == (1, T, LAT, LAT, 4)


@pytest.mark.parametrize("field,value", [("optimizer_type", "sgd"), ("weight_type", "w")])
def test_unknown_settings_raise(pipes, field, value):  # noqa: F811
    _, tp = pipes
    videos, _, prompts = _inputs(1, 22)
    pipe = tsds.SDSGuidancePipeline(tp, tsds.SDSSettings(**dict(SETTINGS, **{field: value})))
    with pytest.raises(ValueError):
        pipe(prompts, videos, seed=1, fs=[3])


def test_debug_tree(pipes, tmp_path):  # noqa: F811
    """The reference's debug tree: per-interval frames and clips, the
    process clip, the loss curve and its analysis plot; stage timings."""
    _, tp = pipes
    videos, _, prompts = _inputs(1, 23)
    clock = {}
    out = tsds.SDSGuidancePipeline(tp, tsds.SDSSettings(**SETTINGS))(
        prompts, videos, seed=1, fs=[3], debug_dir=str(tmp_path / "d"), timings=clock)
    assert out["debug_dir"] == str(tmp_path / "d")
    assert out["videos"].shape == (1, T, HW, HW, 3) and np.isfinite(out["videos"]).all()
    dbg = set(os.listdir(tmp_path / "d" / "debug"))
    try:                      # clips are mp4 where OpenCV imports, else .npy
        import cv2  # noqa: F401
        ext = ".mp4"
    except ImportError:
        ext = ".npy"
    for step in ("step_000000", "step_000002"):
        assert {step + "_video" + ext, step + "_frame_00.png", step + "_frame.png"} <= dbg
    frame = tvideo.decode_png(str(tmp_path / "d" / "debug" / "step_000002_frame.png"))
    assert frame.shape == (HW, HW, 3)
    assert os.path.exists(tmp_path / "d" / "process" / ("optimization_process" + ext))
    lines = (tmp_path / "d" / "loss_curve.csv").read_text().splitlines()
    assert lines[0] == "step,loss" and len(lines) == 5
    assert float(lines[-1].split(",")[1]) == pytest.approx(float(out["loss_curve"][-1]))
    pytest.importorskip("matplotlib")
    assert os.path.exists(tmp_path / "d" / "loss_analysis.png")
    assert set(clock) == {"conditioning", "loop", "steps", "decode"} and len(clock["steps"]) == 4


def _cli(tmp_path, *flags):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    return generate_guidance.main([
        "--config", str(cfg), "--random_init", "--height", str(HW), "--width", str(HW),
        "--num_frames", str(T), "--num_optimization_steps", "2", "--learning_rate", "0.05",
        "--guidance_scale", "2.0", "--debug_save_interval", "2", "--device", "cpu", *flags])


def test_guidance_cli_single_sample_mode(tmp_path, capsys):
    """--prompt + --condition_image with the reference's flag spellings."""
    img = tmp_path / "cond.png"
    shutil.copy(EXAMPLE_PNG, img)
    out_dir = tmp_path / "out"
    result = _cli(tmp_path, "--prompt", "a spinning top", "--condition_image", str(img),
                  "--output_dir", str(out_dir), "--optimizer_type", "Adam", "--save_results",
                  "--min_step_ratio_end", "0.5", "--loss_type", "csd")
    frames = np.load(out_dir / "cond.npy")
    assert frames.shape == (T, HW, HW, 3) and frames.dtype == np.uint8
    assert np.load(out_dir / "cond_loss.npy").shape == (2,)
    assert str(out_dir / "cond.npy") in result["paths"]
    assert (out_dir / "debug" / "cond" / "loss_curve.csv").exists()
    assert "min_step_ratio_end" in capsys.readouterr().out   # the dead flag's warning
    assert result["outputs"][0]["latents"].shape == (1, T, LAT, LAT, 4)


def test_guidance_cli_prompt_dir_mode(tmp_path):
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    for name in ("a.png", "b.png"):
        shutil.copy(EXAMPLE_PNG, prompts / name)
    (prompts / "prompts.txt").write_text("a fox in the snow\nwaves at dusk\n")
    out_dir = tmp_path / "out"
    result = _cli(tmp_path, "--prompt_dir", str(prompts), "--savedir", str(out_dir),
                  "--weight_type", "uniform", "--negative_prompt", "blurry")
    assert len(result["outputs"]) == 2
    for stem in ("a", "b"):
        assert np.load(out_dir / f"{stem}.npy").shape == (T, HW, HW, 3)
        assert np.isfinite(np.load(out_dir / f"{stem}_loss.npy")).all()
    assert not (out_dir / "debug").exists()


def test_guidance_cli_needs_inputs(tmp_path):
    with pytest.raises(SystemExit, match="prompt_dir"):
        _cli(tmp_path, "--prompt", "no image given")


def test_guidance_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_guidance.main(["--config", str(cfg), "--prompt", "x",
                                "--condition_image", EXAMPLE_PNG])
