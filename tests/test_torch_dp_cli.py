"""`train.main` and `inference.main` as ranks of the dp axis: two spawned
`gloo` processes on the CPU at TINY_MODEL_CONFIG size, each calling the
entry point as a torchrun process would (RANK / WORLD_SIZE set, the group
joined), against the one-process runs; and the --dp / --sp guards.

Training: each rank reads its own shard of the synthetic clips, the
metrics are the ranks' means (equal on both), rank 0 alone writes
metrics.csv, the TensorBoard file and the checkpoints, and a SIGUSR1 that
reaches rank 1 alone still checkpoints on both (the flag is all-reduced),
with validation and sampling (the EMA gather) on every rank; with a --logdir
of each rank's own, the ranks still agree on saving and resuming (rank 0's
directory decides, and a resume that rank 1 cannot see raises). Inference: the
frames of --dp 2 equal the one-process frames at a relative 1e-5 for
batched CFG (the two passes split across the ranks), DeepCache (the
feature splits with the rows) and three-pass CFG (3 rows do not divide by
2: every rank runs every row); rank 1 writes no file.
"""
import copy
import os
import shutil
import signal

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402  (a plain dict)
from dynamicrafter_tpu_torch import inference, train  # noqa: E402
from dynamicrafter_tpu_torch.parallel import sharding  # noqa: E402
from test_torch_parallel import few_torch_threads, run_ranks  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, HW = 4, 16
STEPS = 2
# flags, and the all-gathers of a run: one a UNet call, two where it returns
# the DeepCache feature, none where the 3 rows do not divide by 2
VARIANTS = {"cfg": ([], 2), "deepcache": (["--deepcache", "2"], 2 + 1),
            "three_pass": (["--multiple_cond_cfg", "--cfg_img", "3.0"], 0)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    cfg = copy.deepcopy(TINY_MODEL_CONFIG)
    cfg["model"]["params"].update(use_ema=True, rand_cond_frame=True)
    infer_cfg = root / "tiny.yaml"
    infer_cfg.write_text(yaml.safe_dump(cfg))
    cfg["data"] = {"params": {"batch_size": 2, "num_workers": 1, "train": {
        "params": {"video_length": T, "resolution": [HW, HW]}}}}
    cfg["lightning"] = {"trainer": {"accumulate_grad_batches": 2, "max_steps": 100},
                        "callbacks": {"batch_logger": {"params": {"log_images_kwargs": {
                            "ddim_steps": 2, "unconditional_guidance_scale": 7.5}}}}}
    train_cfg = root / "tiny_train.yaml"
    train_cfg.write_text(yaml.safe_dump(cfg))
    prompts = root / "prompts"
    prompts.mkdir()
    shutil.copy(os.path.join(REPO, "prompts", "512", "example.png"), prompts / "img00.png")
    (prompts / "prompts.txt").write_text("a fox in the snow\n")
    return root, str(train_cfg), str(infer_cfg), str(prompts)


def _train_flags(cfg, logdir):
    return ["--config", cfg, "--logdir", logdir, "--name", "run", "--synthetic_data",
            "--max_steps", str(STEPS), "--log_every", "1", "--val_every", "2",
            "--sample_every", "2", "--device", "cpu"]


def _train_rank(rank, world, cfg, logdir, out_dir):
    """train.main on this rank, recording the clips it trained on, its
    checkpoint and metric writes; rank 1 signals itself after micro-step 1."""
    from dynamicrafter_tpu_torch.training import checkpoints, logging as tlog
    from dynamicrafter_tpu_torch.training.trainer import Trainer

    seen = {"captions": [], "ckpt_writes": [], "metric_rows": 0}
    to_device, write, log, step = (train._to_device, checkpoints.CheckpointManager._write,
                                   tlog.MetricLogger.log, Trainer.train_step)

    def recording_to_device(batch, device):
        seen["captions"].append(list(batch["captions"]))
        return to_device(batch, device)

    def recording_write(self, path, s, *a):
        seen["ckpt_writes"].append(s)
        return write(self, path, s, *a)

    def recording_log(self, *a):
        seen["metric_rows"] += 1
        return log(self, *a)

    def step_then_signal(self, *a, **k):
        out = step(self, *a, **k)
        if rank == 1 and self.step == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    train._to_device = recording_to_device
    checkpoints.CheckpointManager._write = recording_write
    tlog.MetricLogger.log = recording_log
    Trainer.train_step = step_then_signal
    result = train.main([*_train_flags(cfg, logdir), "--dp", str(world)])
    seen.update(metrics=result["metrics"], step=result["trainer"].step,
                steps=result["checkpoints"].all_steps(),
                shard=result["trainer"].opt.shards.numel,
                n=sum(p.numel() for p in result["trainer"].params.values()))
    torch.save(seen, os.path.join(out_dir, f"train_rank{rank}.pt"))


def test_train_main_on_two_ranks(setup):
    root, cfg, _, _ = setup
    logdir = str(root / "logs_dp2")
    run_ranks(_train_rank, 2, root, cfg, logdir, str(root))
    ranks = [torch.load(root / f"train_rank{r}.pt", weights_only=False) for r in range(2)]
    # STEPS training batches and one validation batch a rank, from its shards
    assert [len(r["captions"]) for r in ranks] == [STEPS + 1] * 2
    caps = [{c for batch in r["captions"] for c in batch} for r in ranks]
    assert not caps[0] & caps[1]
    for a, b in zip(ranks[0]["metrics"], ranks[1]["metrics"]):
        assert a == b                                    # the dp means, on both ranks
    assert all(np.isfinite(v) for m in ranks[0]["metrics"] for v in m.values())
    # SIGUSR1 at rank 1 alone: both ranks checkpoint step 1; rank 0 writes
    assert ranks[0]["ckpt_writes"] == [1, 2] and ranks[1]["ckpt_writes"] == []
    assert ranks[0]["steps"] == ranks[1]["steps"] == [1, 2]
    assert ranks[0]["metric_rows"] == STEPS + 1 and ranks[1]["metric_rows"] == 0
    workdir = os.path.join(logdir, "run")
    with open(os.path.join(workdir, "metrics.csv")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 1 + STEPS + 1 and "val/loss_ema" in rows[0]
    assert sorted(os.listdir(os.path.join(workdir, "samples")))
    state = torch.load(os.path.join(workdir, "checkpoints", "step_000000002.pt"),
                       weights_only=True)
    # full tensors in the one-process format: the shards were gathered
    n = ranks[0]["n"]
    assert ranks[0]["shard"] < n
    for what in ("weights", "ema", "acc_grads"):
        if state[what] is not None:
            assert sum(v.numel() for v in state[what].values()) == n, what


def _own_logdir_rank(rank, world, cfg, logdir, out_dir):
    """train.main with a --logdir of each rank's own, as on nodes that share
    no filesystem: rank 0 signals itself at the last micro-step, so rank 0
    checkpoints it where rank 1 cannot see it; then a resume from those
    directories."""
    from dynamicrafter_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def step_then_signal(self, *a, **k):
        out = step(self, *a, **k)
        if rank == 0 and self.step == STEPS:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    flags = [*_train_flags(cfg, os.path.join(logdir, f"rank{rank}")), "--dp", str(world),
             "--val_every", "0", "--sample_every", "0"]
    Trainer.train_step = step_then_signal
    result = train.main(flags)
    Trainer.train_step = step
    out = {"steps": result["checkpoints"].all_steps(), "step": result["trainer"].step}
    try:
        train.main([*flags, "--auto_resume"])
    except RuntimeError as e:
        out["resume_error"] = str(e)
    torch.save(out, os.path.join(out_dir, f"own_logdir_rank{rank}.pt"))


def test_train_main_with_a_logdir_of_each_rank(setup):
    """Whether to save at the end, and what to resume, is rank 0's decision
    on every rank: the run whose last checkpoint only rank 0 sees ends on
    both ranks (rank 1 does not save again alone and hang in the
    all-gathers), and the resume raises on both, naming rank 1."""
    root, cfg, _, _ = setup
    run_ranks(_own_logdir_rank, 2, root, cfg, str(root / "own_logdirs"), str(root))
    ranks = [torch.load(root / f"own_logdir_rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["steps"] == [STEPS] and ranks[1]["steps"] == []
    assert [r["step"] for r in ranks] == [STEPS, STEPS]
    for r in ranks:
        assert "ranks [1] do not see" in r.get("resume_error", ""), r


def test_train_and_inference_refuse_sp_and_lone_dp(setup):
    """--sp and --dp above 1 split one run over processes: without torchrun
    both entry points refuse them (--sp raised naming ROADMAP item K before
    the sp axis was ported)."""
    root, cfg, infer_cfg, prompts = setup
    with pytest.raises(SystemExit, match="torchrun"):
        train.main([*_train_flags(cfg, str(root / "x")), "--sp", "2"])
    with pytest.raises(SystemExit, match="torchrun"):
        inference.main(["--config", infer_cfg, "--prompt_dir", prompts, "--sp", "2",
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="torchrun"):
        train.main([*_train_flags(cfg, str(root / "x")), "--dp", "2"])
    with pytest.raises(SystemExit, match="torchrun"):
        inference.main(["--config", infer_cfg, "--prompt_dir", prompts, "--dp", "2",
                        "--device", "cpu"])


def _infer_flags(cfg, prompts, savedir):
    return ["--config", cfg, "--prompt_dir", prompts, "--savedir", savedir, "--random_init",
            "--height", str(HW), "--width", str(HW), "--video_length", str(T),
            "--ddim_steps", "2", "--ddim_eta", "1.0", "--text_input",
            "--unconditional_guidance_scale", "7.5", "--guidance_rescale", "0.7",
            "--frame_stride", "3", "--device", "cpu"]


def _infer_rank(rank, world, cfg, prompts, out_dir):
    """Without --dp two ranks make sp = 2 (the JAX default): each clip's
    frames split over the ranks; then each variant at --dp 2, into a
    directory of the rank's own."""
    sharding.collectives.clear()
    r = inference.main(_infer_flags(cfg, prompts, os.path.join(out_dir, f"no_dp_rank{rank}")))
    out = {"no_dp": (r["videos"][0], r["paths"], dict(sharding.collectives))}
    for name, (extra, _) in VARIANTS.items():
        savedir = os.path.join(out_dir, f"{name}_rank{rank}")
        sharding.collectives.clear()
        r = inference.main([*_infer_flags(cfg, prompts, savedir), *extra, "--dp", str(world)])
        out[name] = (r["videos"][0], r["paths"], sharding.collectives["all_gather"])
    torch.save(out, os.path.join(out_dir, f"infer_rank{rank}.pt"))


def test_inference_dp2_equals_one_process(setup):
    root, _, cfg, prompts = setup
    run_ranks(_infer_rank, 2, root, cfg, prompts, str(root))
    ranks = [torch.load(root / f"infer_rank{r}.pt", weights_only=False) for r in range(2)]
    one = inference.main(_infer_flags(cfg, prompts, str(root / "no_dp_one")))
    want = one["videos"][0]
    for r, (videos, paths, calls) in enumerate(got["no_dp"] for got in ranks):
        # sp = 2: both ranks hold the whole clip (latents and frames gathered)
        err = np.linalg.norm(videos - want) / np.linalg.norm(want)
        assert err <= 1e-5, ("no_dp", r, err)
        assert len(paths) == (1 if r == 0 else 0), ("no_dp", r, paths)
        assert calls["sp_all_gather"] == 2 and calls["sp_all_to_all"] > 0, calls
    for name, (extra, gathers) in VARIANTS.items():
        one = inference.main([*_infer_flags(cfg, prompts, str(root / f"{name}_one")), *extra])
        want = one["videos"][0]
        for r, got in enumerate(ranks):
            videos, paths, n = got[name]
            assert n == gathers, (name, r, n)
            err = np.linalg.norm(videos - want) / np.linalg.norm(want)
            assert err <= 1e-5, (name, r, err)
            assert len(paths) == (1 if r == 0 else 0), (name, r, paths)
        assert not os.path.exists(root / f"{name}_rank1")
