"""The port's serving layer (`app.py`) and `SampleLogger` at
TINY_MODEL_CONFIG size on the CPU, with the pieces that have a JAX
counterpart held against it: the resolution table, the example rows, the
image fit (`_resize_center_crop_f`, OpenCV's INTER_LINEAR there, numpy here:
atol 1e-5 on floats in [-1, 1]) and the denoise grid's layout.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import yaml  # noqa: E402

import dynamicrafter_tpu.app as japp  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu.utils.video import make_denoise_grid as j_denoise_grid  # noqa: E402
from dynamicrafter_tpu_torch import app as tapp  # noqa: E402
from dynamicrafter_tpu_torch import train  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.training.logging import SampleLogger  # noqa: E402
from dynamicrafter_tpu_torch.utils import video as tvideo  # noqa: E402
from test_torch_train import _tiny_train_yaml  # noqa: E402

T, HW = 4, 16


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip_ext():
    try:
        import cv2  # noqa: F401
        return ".mp4"
    except ImportError:
        return ".npy"


def test_resolution_table_matches_jax():
    assert tapp.RESOLUTIONS == japp.RESOLUTIONS


@pytest.mark.parametrize("resolution", ["256_256", "320_512", "576_1024"])
def test_example_rows_match_jax(resolution):
    ours, ref = tapp._example_rows(resolution), japp._example_rows(resolution)
    assert [[os.path.basename(r[0]), *r[1:]] for r in ours] == \
        [[os.path.basename(r[0]), *r[1:]] for r in ref]
    assert all(os.path.exists(r[0]) for r in ours)


@pytest.mark.parametrize("shape,size", [((24, 30, 3), (16, 16)), ((20, 20, 3), (32, 48)),
                                        ((64, 40, 3), (16, 24)), ((16, 16, 3), (16, 16))])
def test_resize_center_crop_matches_jax(shape, size):
    pytest.importorskip("cv2")
    img = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    ours, ref = tapp._resize_center_crop_f(img, size), japp._resize_center_crop_f(img, size)
    assert ours.shape == ref.shape == (*size, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def test_denoise_grid_matches_jax():
    rows = np.random.default_rng(1).uniform(-1, 1, (3, T, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvideo.make_denoise_grid(rows), j_denoise_grid(rows))


@pytest.fixture(scope="module")
def tiny_spec(tmp_path_factory):
    cfg = tmp_path_factory.mktemp("app") / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    return dict(height=HW, width=HW, fs=3, fs_min=1, fs_max=6, config=str(cfg),
                timestep_spacing="uniform_trailing", guidance_rescale=0.0)


@pytest.mark.parametrize("mode", ["i2v", "interp", "loop"])
def test_backend_modes(tiny_spec, tmp_path, monkeypatch, mode):
    """The backend on the tiny model: one clip per call; loop mode drops
    the last frame; a uint8 image of another size is fitted first."""
    monkeypatch.setitem(tapp.RESOLUTIONS, "tiny", tiny_spec)
    backend = tapp.Image2Video(str(tmp_path / "results"), resolution="tiny",
                               random_init=True, mode=mode, device="cpu")
    assert backend.pipe.dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (24, 30, 3)).astype(np.uint8)
    img2 = rng.uniform(0, 255, (20, 20, 3)).astype(np.uint8)
    clock = {}
    path = backend.get_image(img, "a drifting cloud", steps=2, cfg_scale=2.0, eta=0.0, seed=3,
                             image2=None if mode == "i2v" else img2, timings=clock)
    assert os.path.exists(path) and path.endswith(_clip_ext())
    assert os.path.dirname(path) == str(tmp_path / "results")
    assert "a_drifting_cloud" in os.path.basename(path)
    assert set(clock) == {"conditioning", "ddim", "decode"}
    if path.endswith(".npy"):
        frames = np.load(path)
    else:
        import cv2
        cap, frames = cv2.VideoCapture(path), []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        frames = np.stack(frames)
    assert frames.shape == (T - 1 if mode == "loop" else T, HW, HW, 3)


def test_backend_snaps_deepcache_and_rejects_bad_arguments(tiny_spec, tmp_path, monkeypatch):
    monkeypatch.setitem(tapp.RESOLUTIONS, "tiny", tiny_spec)
    backend = tapp.Image2Video(str(tmp_path), resolution="tiny", random_init=True,
                               device="cpu")
    seen = {}
    sample = backend.pipe.sample
    monkeypatch.setattr(backend.pipe, "sample",
                        lambda *a, **kw: seen.update(kw) or sample(*a, **kw))
    img = np.zeros((HW, HW, 3), np.float32)
    backend.get_image(img, "", steps=4, cfg_scale=1.0, deepcache=3)
    assert seen["deepcache"] == 2 and seen["fs"] == [3]      # largest divisor of 4 up to 3
    backend.get_image(img, "", steps=2, cfg_scale=1.0, deepcache=2, sampler="dpm", fs=0)
    assert seen["deepcache"] == 1 and seen["fs"] == [0]      # DDIM-only; fs=0 is kept
    with pytest.raises(ValueError, match="unknown resolution"):
        tapp.Image2Video(str(tmp_path), resolution="8_8", random_init=True, device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        tapp.Image2Video(str(tmp_path), resolution="tiny", random_init=True, mode="video",
                         device="cpu")


def test_launch_app_builds_three_tabs():
    """launch_app wires the i2v, interpolation and looping tabs with
    examples and a random-seed button each; a stub records the UI."""
    record = {"tabs": [], "clicks": 0, "examples": 0}

    class _Ctx:
        def __init__(self, label=None):
            self.label = label

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def click(self, fn=None, inputs=None, outputs=None, queue=None, **kw):
            record["clicks"] += 1

        def launch(self, **kw):
            record["launched"] = kw

    class _Comp(_Ctx):
        def __init__(self, *a, **kw):
            super().__init__(kw.get("label"))

    def _tab(label=None):
        record["tabs"].append(label)
        return _Ctx(label)

    def _examples(**kw):
        record["examples"] += 1
        record["example_rows"] = kw.get("examples")

    gr = types.SimpleNamespace(
        Blocks=lambda **kw: _Ctx(), Tab=_tab, Row=_Ctx, Column=_Ctx, Markdown=_Comp,
        Image=_Comp, Textbox=_Comp, Text=_Comp, Slider=lambda *a, **kw: _Comp(**kw),
        Button=_Comp, Video=_Comp, Radio=lambda *a, **kw: _Comp(**kw),
        Examples=lambda **kw: _examples(**kw))

    demo = tapp.launch_app(resolution="320_512", random_init=True, gr_module=gr, launch=False)
    assert demo is not None
    assert record["tabs"] == ["Image2Video_320x512", "Interpolation_320x512",
                              "Looping_320x512"]
    assert record["clicks"] == 6                  # three generate and three seed buttons
    assert record["examples"] == 1 and record["example_rows"]
    tapp.launch_app(resolution="256_256", random_init=True, gr_module=gr, share=True)
    assert record["launched"] == {"share": True}


def test_launch_app_without_gradio_points_at_the_backend():
    try:
        import gradio  # noqa: F401
        pytest.skip("gradio is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="backend"):
        tapp.main(["--res", "256_256", "--random_init", "--device", "cpu"])


@pytest.fixture(scope="module")
def tiny_pipe():
    pipe = DynamiCrafterPipeline(ModelConfig(TINY_MODEL_CONFIG), "cpu")
    pipe.init_random(seed=0)
    return pipe


def _batch():
    return {"video": np.random.default_rng(0).uniform(-1, 1, (2, T, HW, HW, 3)).astype(
                np.float32),
            "captions": ["a test clip", "another"], "fs": np.asarray([3, 3])}


def test_sample_logger_writes_clips(tiny_pipe, tmp_path):
    sl = SampleLogger(tiny_pipe, str(tmp_path), every_n_steps=5,
                      sample_kwargs=dict(ddim_steps=2, unconditional_guidance_scale=2.0),
                      max_samples=1)
    assert sl.kwargs["steps"] == 2 and sl.kwargs["cfg_scale"] == 2.0   # reference names
    sl.maybe_log(4, _batch())          # not a multiple of 5: nothing
    assert not os.listdir(tmp_path / "samples")
    sl.maybe_log(5, _batch())
    ext = _clip_ext()
    assert set(os.listdir(tmp_path / "samples")) == {
        "step0000005_0" + ext, "step0000005_0_input" + ext, "step0000005_0_reconst" + ext}
    if sl._tb is not None:
        assert any("tfevents" in f for f in os.listdir(tmp_path / "tb_samples"))


def test_sample_logger_denoise_rows(tiny_pipe, tmp_path):
    """One grid PNG per sample: a row per logged DDIM intermediate (the x_T
    row included), T frames per row."""
    sl = SampleLogger(tiny_pipe, str(tmp_path), every_n_steps=1,
                      sample_kwargs=dict(steps=4, plot_denoise_rows=True,
                                         denoise_log_every_t=2),
                      max_samples=1, log_inputs=False, to_tensorboard=False)
    assert sl.plot_denoise_rows and sl.denoise_log_every_t == 2
    assert "plot_denoise_rows" not in sl.kwargs
    sl.maybe_log(1, _batch())
    pngs = [f for f in os.listdir(tmp_path / "samples") if f.endswith("_denoise_row.png")]
    assert len(pngs) == 1
    # steps 4, log_every_t 2: the x_T row and indices 3 (first), 2, 0
    grid = tvideo.decode_png(str(tmp_path / "samples" / pngs[0]))
    assert grid.shape == (4 * HW, T * HW, 3)


def test_png_writer_round_trips(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (13, 17, 3)).astype(np.uint8)
    tvideo.save_image(img, str(tmp_path / "a" / "x.png"))
    np.testing.assert_array_equal(tvideo.decode_png(str(tmp_path / "a" / "x.png")), img)
    PIL = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(np.asarray(PIL.open(tmp_path / "a" / "x.png")), img)
    tvideo.save_image(np.zeros((4, 4, 3), np.float32), str(tmp_path / "grey.png"))
    assert (tvideo.decode_png(str(tmp_path / "grey.png")) == 128).all()


def test_train_cli_sample_every(tmp_path):
    """--sample_every writes sampled clips beside the metrics."""
    cfg = _tiny_train_yaml(tmp_path)
    result = train.main(["--config", cfg, "--logdir", str(tmp_path / "logs"), "--name", "run",
                         "--synthetic_data", "--log_every", "1", "--device", "cpu",
                         "--max_steps", "2", "--sample_every", "2"])
    samples = os.listdir(os.path.join(result["workdir"], "samples"))
    assert "step0000002_0" + _clip_ext() in samples
