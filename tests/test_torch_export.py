"""`python -m dynamicrafter_tpu_torch.export_checkpoint` on the CPU at
TINY_MODEL_CONFIG size: train -> export -> inference, and the exported key
set against the JAX package's `export_state_dict` over the same donor.

A donor checkpoint is written from the tiny random pipeline's reference-keyed
state dict; `train.main` fine-tunes from it for 2 micro-steps (EMA on); the
export merges the step's online or EMA weights over the donor. The
inference CLI then loads the result with `--ckpt_path` (a strict load, which
needs a CLIP BPE vocabulary: a tiny merge table is written here) and must
give the latents of the in-process route (donor, then
`load_trained_weights`) exactly: the same fp32 operations on the same
numbers in one process.
"""
import gzip
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynamicrafter_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dynamicrafter_tpu.models.unet3d import UNetConfig as JUNetConfig  # noqa: E402
from dynamicrafter_tpu.utils import weights as jweights  # noqa: E402
from dynamicrafter_tpu.utils.export import export_state_dict  # noqa: E402
from dynamicrafter_tpu_torch import export_checkpoint, inference, train  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.training.checkpoints import (  # noqa: E402
    CheckpointManager, load_trained_weights,
)
from dynamicrafter_tpu_torch.utils.video import load_prompt_dir  # noqa: E402
from test_torch_samplers import few_torch_threads  # noqa: E402,F401
from test_torch_slice import EXAMPLE_PNG, HW, T  # noqa: E402
from test_torch_train import _tiny_train_yaml  # noqa: E402

SAMPLE = dict(steps=2, cfg_scale=7.5, eta=1.0, timestep_spacing="uniform_trailing",
              guidance_rescale=0.7, fs=24, seed=5)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tiny training config, the donor checkpoint, a 2-micro-step
    fine-tune from it (its step_<n>.pt), a prompt dir and a BPE vocab."""
    root = tmp_path_factory.mktemp("export")
    cfg = _tiny_train_yaml(root)
    donor = DynamiCrafterPipeline(ModelConfig.from_yaml(cfg), "cpu")
    donor.init_random(seed=7)
    donor_path = root / "donor.ckpt"
    torch.save({"state_dict": donor.net.state_dict()}, donor_path)
    result = train.main(["--config", cfg, "--logdir", str(root / "logs"), "--name", "run",
                         "--synthetic_data", "--max_steps", "2", "--log_every", "1",
                         "--device", "cpu", "--pretrained", str(donor_path)])
    ckpts = result["checkpoints"]
    prompts = root / "prompts"
    prompts.mkdir()
    shutil.copy(EXAMPLE_PNG, prompts / "example.png")
    (prompts / "prompts.txt").write_text("a fox in the snow\n")
    vocab = root / "bpe_simple_vocab_16e6.txt.gz"
    with gzip.open(vocab, "wt") as f:
        f.write("#version: 0.2\nt h\nth e</w>\ns n\no w</w>")
    return dict(root=root, cfg=cfg, donor=str(donor_path), step=ckpts.path(ckpts.latest_step()),
                prompts=str(prompts), vocab=str(vocab))


def _export(run, out, *flags, base=True):
    return export_checkpoint.main(["--config", run["cfg"], "--params", run["step"],
                                   *(["--base", run["donor"]] if base else []),
                                   "--out", str(out), *flags])


@pytest.mark.parametrize("ema", [False, True], ids=["online", "ema"])
def test_train_export_inference_round_trip(run, ema, tmp_path):
    """The exported checkpoint through `inference --ckpt_path` gives the
    latents (and frames) of the donor + `load_trained_weights` route."""
    out = tmp_path / "model.ckpt"
    sd = _export(run, out, *(["--ema"] if ema else []))
    state = CheckpointManager(str(run["root"] / "logs" / "run" / "checkpoints")).restore()
    trained = state["ema"] if ema else state["weights"]
    donor = torch.load(run["donor"], weights_only=True)["state_dict"]
    assert set(sd) == set(donor)
    assert all(sd[k].dtype == torch.float32 for k in sd)
    for k, v in trained.items():
        if k != "logvar":
            assert torch.equal(sd[k], v.float()), k
    assert any(not torch.equal(sd[k], donor[k]) for k in trained if k != "logvar")

    cli = inference.main([
        "--config", run["cfg"], "--ckpt_path", str(out), "--vocab_path", run["vocab"],
        "--prompt_dir", run["prompts"], "--savedir", str(tmp_path / "o"), "--height", str(HW),
        "--width", str(HW), "--video_length", str(T), "--frame_stride", str(SAMPLE["fs"]),
        "--ddim_steps", str(SAMPLE["steps"]), "--ddim_eta", str(SAMPLE["eta"]),
        "--unconditional_guidance_scale", str(SAMPLE["cfg_scale"]),
        "--timestep_spacing", SAMPLE["timestep_spacing"],
        "--guidance_rescale", str(SAMPLE["guidance_rescale"]), "--seed", str(SAMPLE["seed"]),
        "--text_input", "--device", "cpu"])

    pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(run["cfg"]), "cpu",
                                 vocab_path=run["vocab"])
    pipe.load_checkpoint(run["donor"])
    load_trained_weights(pipe, {"weights": trained})
    _, videos, prompts = load_prompt_dir(run["prompts"], video_size=(HW, HW), video_frames=T)
    ref = pipe.sample(prompts, videos, steps=SAMPLE["steps"], cfg_scale=SAMPLE["cfg_scale"],
                      eta=SAMPLE["eta"], timestep_spacing=SAMPLE["timestep_spacing"],
                      guidance_rescale=SAMPLE["guidance_rescale"], fs=[SAMPLE["fs"]],
                      seed=SAMPLE["seed"])
    assert np.isfinite(ref.latents).all()
    np.testing.assert_array_equal(cli["latents"][0], ref.latents)
    np.testing.assert_array_equal(cli["videos"][0], ref.videos)


@pytest.mark.parametrize("ema", [False, True], ids=["online", "ema"])
def test_exported_keys_match_jax_export_state_dict(run, ema, tmp_path):
    """The same trained tensors carried into Flax trees by the JAX converters
    and exported over the same donor by `export_state_dict`: the same keys,
    shapes and values."""
    sd = _export(run, tmp_path / "model.ckpt", *(["--ema"] if ema else []))
    state = torch.load(run["step"], weights_only=True)
    trained = {k: v.float().numpy() for k, v in (state["ema"] if ema else state["weights"]).items()
               if k != "logvar"}
    split = jweights.split_reference_checkpoint(trained)
    tree = {"unet": jweights.convert_unet(split["unet"])}
    if split["resampler"]:
        tree["resampler"] = jweights.convert_resampler(split["resampler"])
    donor = {k: v.float().numpy()
             for k, v in torch.load(run["donor"], weights_only=True)["state_dict"].items()}
    ref = export_state_dict(tree, unet_config=JUNetConfig.from_dict(
        JModelConfig.from_yaml(run["cfg"]).unet), base_sd=donor)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_without_base_writes_the_trainables(run, tmp_path, capsys):
    """No donor: the trainable tensors alone (no logvar), checked against the
    model the config builds, and a note that a strict load needs a donor."""
    out = tmp_path / "trainables.ckpt"
    sd = _export(run, out, base=False)
    weights = torch.load(run["step"], weights_only=True)["weights"]
    assert set(sd) == set(weights) - {"logvar"}
    assert set(torch.load(out, weights_only=True)["state_dict"]) == set(sd)
    assert "needs them merged over a donor" in capsys.readouterr().out
    pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(run["cfg"]), "cpu")
    with pytest.raises(KeyError, match="missing"):
        pipe.load_checkpoint(str(out))


def test_ema_without_ema_is_an_error(run, tmp_path):
    state = torch.load(run["step"], weights_only=True)
    state["ema"] = None
    path = tmp_path / "step_no_ema.pt"
    torch.save(state, path)
    with pytest.raises(SystemExit, match="no EMA shadow"):
        export_checkpoint.main(["--config", run["cfg"], "--params", str(path),
                                "--base", run["donor"], "--out", str(tmp_path / "m.ckpt"),
                                "--ema"])


@pytest.mark.parametrize("base", [True, False], ids=["donor", "config"])
def test_a_tensor_the_donor_does_not_hold_is_an_error(run, tmp_path, base):
    """An unknown key is a KeyError and a wrong shape a ValueError, against
    the donor or, without one, against the model of --config."""
    state = torch.load(run["step"], weights_only=True)
    key = next(k for k in state["weights"] if k.startswith("model.diffusion_model."))
    flags = ["--base", run["donor"]] if base else []
    for weights, error, match in (
            ({**state["weights"], "model.diffusion_model.extra.weight": torch.zeros(3)},
             KeyError, "not in the"),
            ({**state["weights"], key: torch.zeros(3)}, ValueError, "shape")):
        path = tmp_path / "bad.pt"
        torch.save({**state, "weights": weights}, path)
        with pytest.raises(error, match=match):
            export_checkpoint.main(["--config", run["cfg"], "--params", str(path), *flags,
                                    "--out", str(tmp_path / "m.ckpt")])


def test_export_reads_without_torch(run, tmp_path):
    """The exported file keeps `torch.save`'s CRC32 of each record (training
    checkpoints are written without it): the JAX package's torch-free reader,
    which checks each record's CRC, reads the tensors `torch.load` reads."""
    from dynamicrafter_tpu.utils.torch_reader import load_torch_checkpoint

    out = tmp_path / "model.ckpt"
    sd = _export(run, out)
    got = load_torch_checkpoint(str(out))["state_dict"]
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
