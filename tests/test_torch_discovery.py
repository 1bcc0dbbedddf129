"""The port's `utils/discovery.py` and `python -m dynamicrafter_tpu_torch.parity_check`
against the JAX package's `dynamicrafter_tpu/utils/discovery.py` and
`scripts/parity_check.py`.

Discovery: the same fabricated trees and environment as `tests/test_discovery.py`,
every candidate list, hit and "blocked on:" line equal to the JAX function's
apart from the package's own vocab path (the port looks beside its own
tokenizer). parity_check at TINY_MODEL_CONFIG size on the CPU: exit 2 with one
blocked line when nothing is found; a checkpoint written from the tiny random
pipeline, found through the environment, scored against its own frames is
infinitely close; the `--x_t_npy` transpose; the PSNR function itself.
"""
import gzip
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu.utils import discovery as jdisc  # noqa: E402
from dynamicrafter_tpu.utils import tokenizer as jtok  # noqa: E402
from dynamicrafter_tpu_torch import parity_check  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.utils import discovery as tdisc  # noqa: E402
from dynamicrafter_tpu_torch.utils import tokenizer as ttok  # noqa: E402
from dynamicrafter_tpu_torch.utils.video import save_image  # noqa: E402
from test_torch_samplers import few_torch_threads  # noqa: E402,F401
from test_torch_slice import EXAMPLE_PNG, HW, LAT, REPO, T  # noqa: E402

ENV = ("DYNAMICRAFTER_CKPT", "DYNAMICRAFTER_CKPT_256", "DYNAMICRAFTER_CKPT_512",
       "DYNAMICRAFTER_CKPT_1024", "DYNAMICRAFTER_CKPT_512_INTERP", "DYNAMICRAFTER_VOCAB",
       "HF_HOME", "HUGGINGFACE_HUB_CACHE")
RESOLUTIONS = ("256", "512", "1024", "512_interp")


def _as_port(text):
    """The JAX package's own vocab path, read as the port's."""
    return text.replace(jtok._DEFAULT_VOCAB_CANDIDATES[0], ttok._DEFAULT_VOCAB_CANDIDATES[0])


@pytest.fixture
def clean_env(tmp_path, monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _touch(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"x")
    return str(path)


def _env_override(root, mp):
    mp.setenv("DYNAMICRAFTER_CKPT_512", _touch(root / "a" / "model.ckpt"))
    mp.setenv("DYNAMICRAFTER_CKPT", _touch(root / "b" / "other.ckpt"))


def _hf_hub_cache(root, mp):
    _touch(root / "hub" / "models--Doubiiu--DynamiCrafter_512" / "snapshots" / "abc123"
           / "model.ckpt")
    mp.setenv("HUGGINGFACE_HUB_CACHE", str(root / "hub"))


def _hf_home(root, mp):
    _touch(root / "hf" / "hub" / "models--Doubiiu--DynamiCrafter_512_Interp" / "snapshots"
           / "f00" / "model.ckpt")
    mp.setenv("HF_HOME", str(root / "hf"))


def _run_script_layout(root, mp):
    _touch(root / "checkpoints" / "dynamicrafter_256_v1" / "model.ckpt")


def _vocab(root, mp):
    vocab = root / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(vocab, "wt") as f:
        f.write("a b\n")
    mp.setenv("DYNAMICRAFTER_VOCAB", str(vocab))


def _nothing(root, mp):
    mp.setenv("DYNAMICRAFTER_CKPT_512", "/nonexistent/model.ckpt")


@pytest.mark.parametrize("layout", [_env_override, _hf_hub_cache, _hf_home, _run_script_layout,
                                    _vocab, _nothing],
                         ids=["env_override", "hf_hub_cache", "hf_home", "run_script_layout",
                              "vocab", "nothing"])
def test_discover_matches_jax(clean_env, monkeypatch, layout):
    layout(clean_env, monkeypatch)
    for res in RESOLUTIONS:
        assert tdisc.checkpoint_candidates(res) == jdisc.checkpoint_candidates(res)
        assert tdisc.find_checkpoint(res) == jdisc.find_checkpoint(res)
        found, line = tdisc.discover(res)
        jfound, jline = jdisc.discover(res)
        assert found == {k: v and _as_port(v) for k, v in jfound.items()}
        assert line == _as_port(jline)
        assert "\n" not in line and (line == "" or line.startswith("blocked on: "))
    assert tdisc.vocab_candidates() == [_as_port(c) for c in jdisc.vocab_candidates()]
    assert tdisc.find_vocab() == jdisc.find_vocab()
    assert ttok._DEFAULT_VOCAB_CANDIDATES[0].startswith(
        os.path.join(REPO, "dynamicrafter_tpu_torch", ""))


def test_env_override_order_and_hits(clean_env, monkeypatch):
    """The resolution's override outranks the generic one; the HF cache and the
    run-script layout are found where tests/test_discovery.py finds them."""
    _env_override(clean_env, monkeypatch)
    assert tdisc.find_checkpoint("512") == str(clean_env / "a" / "model.ckpt")
    assert tdisc.find_checkpoint("1024") == str(clean_env / "b" / "other.ckpt")
    _run_script_layout(clean_env, monkeypatch)
    assert tdisc.find_checkpoint("256") == str(clean_env / "b" / "other.ckpt")
    monkeypatch.delenv("DYNAMICRAFTER_CKPT")
    assert tdisc.find_checkpoint("256") == os.path.join(
        ".", "checkpoints", "dynamicrafter_256_v1", "model.ckpt")
    _vocab(clean_env, monkeypatch)
    assert tdisc.vocab_candidates()[0] == tdisc.find_vocab() == str(
        clean_env / "bpe_simple_vocab_16e6.txt.gz")


def _tiny_config(root):
    path = root / "tiny.yaml"
    path.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    return str(path)


def _flags(cfg, out, *extra):
    return ["--config", cfg, "--image", EXAMPLE_PNG, "--prompt", "a fox in the snow",
            "--height", str(HW), "--width", str(HW), "--video_length", str(T),
            "--ddim_steps", "2", "--ddim_eta", "1.0", "--frame_stride", "24",
            "--timestep_spacing", "uniform_trailing", "--guidance_rescale", "0.7",
            "--out", str(out), "--device", "cpu", *extra]


def test_parity_check_blocked_exits_2(clean_env, monkeypatch):
    """Nothing mounted: one "blocked on:" line and exit 2, before any model is
    built (so --device cuda does not matter)."""
    found, line = tdisc.discover("256")
    env = {k: v for k, v in os.environ.items() if k not in ENV}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "dynamicrafter_tpu_torch.parity_check",
         *_flags(_tiny_config(clean_env), clean_env / "o.npy")[:-2], "--device", "cuda"],
        cwd=clean_env, env=env, capture_output=True, text=True, timeout=300)
    if None in found.values():
        # the child's ~ is the fixture's HOME, so its list differs from `line`
        assert proc.returncode == 2, proc.stderr
        (got,) = proc.stdout.splitlines()
        assert got.startswith("blocked on: ") and line.startswith("blocked on: ")
        assert os.path.join(str(clean_env), "home", "checkpoints", "dynamicrafter_256_v1",
                            "model.ckpt") in got
    else:  # released weights and vocab are mounted on this machine
        assert "blocked on:" not in proc.stdout


def test_parity_check_scores_its_own_frames_inf(clean_env, monkeypatch, capsys):
    """A checkpoint from the tiny random pipeline and a BPE vocab, both found
    through the environment: the second run, scored against the first run's
    frames (the .npy it wrote, and the same frames as a PNG directory), reports
    PSNR inf; a third run from other noise does not."""
    cfg = _tiny_config(clean_env)
    pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(cfg), "cpu")
    pipe.init_random(seed=7)
    ckpt = clean_env / "tiny.ckpt"
    torch.save({"state_dict": pipe.net.state_dict()}, ckpt)
    vocab = clean_env / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(vocab, "wt") as f:
        f.write("#version: 0.2\nt h\nth e</w>\ns n\no w</w>")
    monkeypatch.setenv("DYNAMICRAFTER_CKPT_256", str(ckpt))
    monkeypatch.setenv("DYNAMICRAFTER_VOCAB", str(vocab))
    first = parity_check.main(_flags(cfg, clean_env / "first.npy"))
    assert first["psnr"] is None
    assert first["frames"].shape == (T, HW, HW, 3) and first["frames"].dtype == np.uint8
    np.testing.assert_array_equal(np.load(clean_env / "first.npy"), first["frames"])
    pngs = clean_env / "ref_png"
    pngs.mkdir()
    for i, frame in enumerate(first["frames"]):
        save_image(frame.astype(np.float32) / 255.0 * 2.0 - 1.0, str(pngs / f"{i:03d}.png"))
    for ref in (clean_env / "first.npy", pngs):
        again = parity_check.main(_flags(cfg, clean_env / "again.npy", "--reference_dir",
                                         str(ref)))
        assert again["psnr"] == float("inf") and again["frames_compared"] == T
        assert "PSNR vs reference over 4 frames: inf dB (PASS 40 dB target)" in \
            capsys.readouterr().out
    x_t = np.random.default_rng(3).standard_normal((1, 4, T, LAT, LAT)).astype(np.float32)
    np.save(clean_env / "xT.npy", x_t)
    other = parity_check.main(_flags(cfg, clean_env / "other.npy", "--x_t_npy",
                                     str(clean_env / "xT.npy"), "--reference_dir",
                                     str(clean_env / "first.npy")))
    assert np.isfinite(other["psnr"])


def test_x_t_npy_is_transposed_from_the_torch_layout(clean_env):
    """The hash-tokenizer seam: `check` on a pipeline loaded with
    allow_hash_tokenizer; --x_t_npy (B, C, T, h, w) gives the frames of
    `pipe.sample(x_T=<(B, T, h, w, C)>)` bit for bit."""
    cfg = _tiny_config(clean_env)
    donor = DynamiCrafterPipeline(ModelConfig.from_yaml(cfg), "cpu")
    donor.init_random(seed=11)
    torch.save({"state_dict": donor.net.state_dict()}, clean_env / "tiny.ckpt")
    pipe = DynamiCrafterPipeline.from_checkpoint(cfg, str(clean_env / "tiny.ckpt"), "cpu",
                                                 allow_hash_tokenizer=True)
    x_t = np.random.default_rng(5).standard_normal((1, 4, T, LAT, LAT)).astype(np.float32)
    np.save(clean_env / "xT.npy", x_t)
    args = parity_check.get_parser().parse_args(
        _flags(cfg, clean_env / "o.npy", "--x_t_npy", str(clean_env / "xT.npy")))
    got = parity_check.check(args, pipe)["frames"]
    from dynamicrafter_tpu_torch.utils.video import load_image, to_uint8

    video = np.stack([load_image(EXAMPLE_PNG, (HW, HW))] * T)[None]
    ref = pipe.sample(["a fox in the snow"], video, steps=2, eta=1.0, cfg_scale=7.5,
                      timestep_spacing="uniform_trailing", guidance_rescale=0.7, fs=[24],
                      x_T=x_t.transpose(0, 2, 3, 4, 1))
    np.testing.assert_array_equal(got, to_uint8(ref.videos[0, 0]))
    plain = parity_check.check(parity_check.get_parser().parse_args(
        _flags(cfg, clean_env / "p.npy")), pipe)["frames"]
    assert not np.array_equal(got, plain)


def test_psnr_matches_the_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_check", os.path.join(REPO, "scripts", "parity_check.py"))
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.01, a.shape), -1, 1).astype(np.float32)
    assert parity_check.psnr(a, b) == jscript.psnr(a, b)
    assert parity_check.psnr(a, b, 1.0) == jscript.psnr(a, b, 1.0)
    assert parity_check.psnr(a, a) == jscript.psnr(a, a) == float("inf")
