"""`python -m dynamicrafter_tpu_torch.distributed_inference` and
`inference.main(prompt_shard=)` against the JAX package's prompt slicing
(`scripts/inference.py:145-150`).

Shards are pure data parallelism over the prompt list: at --bs 1 every
prompt's sample is seeded with --seed, so a prompt's frames do not depend on
the process that ran it and the shards' files, taken together, are the
one-process run's bit for bit (TINY_MODEL_CONFIG, CPU, random weights).
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu_torch import distributed_inference, inference  # noqa: E402
from test_torch_samplers import few_torch_threads  # noqa: E402,F401
from test_torch_slice import EXAMPLE_PNG, HW, REPO, T  # noqa: E402

N_PROMPTS = 3


def jax_prompt_slice(items, shard_id, num_shards):
    """scripts/inference.py:145-150, as the JAX CLI slices."""
    if num_shards > 1:
        per = -(-len(items) // num_shards)
        lo = shard_id * per
        hi = min(len(items), lo + per)
        items = items[lo:hi]
    return items


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
def test_shard_bounds_match_jax(num_shards):
    for n in range(1, 8):
        items = list(range(n))
        shards = []
        for shard_id in range(num_shards):
            lo, hi = inference.shard_bounds(n, shard_id, num_shards)
            assert items[lo:hi] == jax_prompt_slice(items, shard_id, num_shards)
            shards += items[lo:hi]
        assert shards == items


def test_prompt_shard_out_of_range_raises():
    with pytest.raises(ValueError, match="prompt_shard"):
        inference.main(["--config", "x.yaml", "--prompt_dir", "p"], prompt_shard=(2, 2))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    prompts = root / "prompts"
    prompts.mkdir()
    for i in range(N_PROMPTS):
        shutil.copy(EXAMPLE_PNG, prompts / f"img{i:02d}.png")
    (prompts / "prompts.txt").write_text(
        "".join(f"a clip of scene {i}, slow camera motion\n" for i in range(N_PROMPTS)))
    return root, str(cfg), str(prompts)


def _flags(cfg, prompts, savedir):
    return ["--config", cfg, "--prompt_dir", prompts, "--savedir", str(savedir),
            "--random_init", "--height", str(HW), "--width", str(HW), "--frame_stride", "24",
            "--timestep_spacing", "uniform_trailing", "--guidance_rescale", "0.7",
            "--unconditional_guidance_scale", "7.5", "--text_input", "--video_length", str(T),
            "--ddim_steps", "2", "--ddim_eta", "1.0", "--bs", "1", "--device", "cpu"]


def _files(savedir):
    return {f: np.load(os.path.join(savedir, f)) for f in sorted(os.listdir(savedir))}


def test_two_shards_union_equals_one_process(setup):
    """Two CPU processes by --num_processes/--process_id and one by torchrun's
    RANK/WORLD_SIZE, all started together: disjoint files whose union equals
    the one-process run bit for bit."""
    root, cfg, prompts = setup
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "dynamicrafter_tpu_torch.distributed_inference"]
    procs = [subprocess.Popen([*cmd, *_flags(cfg, prompts, root / f"shard{i}"),
                               "--num_processes", "2", "--process_id", str(i),
                               "--coordinator", "localhost:1234"],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    procs.append(subprocess.Popen([*cmd, *_flags(cfg, prompts, root / "rank1")],
                                  env=dict(env, RANK="1", WORLD_SIZE="2", LOCAL_RANK="0"),
                                  cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    whole = inference.main(_flags(cfg, prompts, root / "whole"))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    one = _files(root / "whole")
    shards = [_files(root / f"shard{i}") for i in range(2)]
    assert list(one) == [f"img{i:02d}.npy" for i in range(N_PROMPTS)]
    assert list(shards[0]) == ["img00.npy", "img01.npy"] and list(shards[1]) == ["img02.npy"]
    for shard in shards:
        for name, frames in shard.items():
            np.testing.assert_array_equal(frames, one[name])
    rank1 = _files(root / "rank1")
    assert list(rank1) == ["img02.npy"]
    np.testing.assert_array_equal(rank1["img02.npy"], one["img02.npy"])
    assert len(whole["paths"]) == N_PROMPTS


def test_parser_takes_the_inference_flags_and_the_shard(setup, monkeypatch):
    """The namespace goes to inference.main as parsed, with the shard from
    RANK / WORLD_SIZE when the flags are absent and cuda:<LOCAL_RANK>, and
    never as a rank of a process group (the prompt shards need no
    collective)."""
    root, cfg, prompts = setup
    seen = {}
    monkeypatch.setattr(inference, "main", lambda args, prompt_shard, distributed: seen.update(
        args=args, shard=prompt_shard, distributed=distributed))
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    distributed_inference.main(["--config", cfg, "--prompt_dir", prompts, "--bs", "2"])
    assert seen["shard"] == (3, 4) and seen["distributed"] is False
    assert seen["args"].device == "cuda:1" and seen["args"].bs == 2
    distributed_inference.main(["--config", cfg, "--prompt_dir", prompts, "--num_processes",
                                "2", "--process_id", "0", "--device", "cpu"])
    assert seen["shard"] == (0, 2) and seen["args"].device == "cpu"
