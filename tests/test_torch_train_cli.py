"""The training CLI's loader, profiler, TensorBoard and checkpointing switches,
and `python -m dynamicrafter_tpu_torch.train_probe`, on the CPU at
TINY_MODEL_CONFIG size.

`--loader processes` (the JAX CLI's `--loader grain`) must give the thread
loader's batches bit for bit, in order, from spawned worker processes, with
the same sharding and the same refusal of a shard smaller than a batch.
`--checkpoint none` changes memory and time only: in fp32 the loss and the
gradients equal `config`'s to rel 1e-6 (the same operations; checkpointing
recomputes the forward in the backward).
"""
import csv
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynamicrafter_tpu_torch import train, train_probe  # noqa: E402
from dynamicrafter_tpu_torch.data.webvid import (  # noqa: E402
    DataLoader, IterableVideoDataset, ProcessDataLoader, SyntheticVideoDataset,
)
from dynamicrafter_tpu_torch.training import trainer as ttrainer  # noqa: E402
from dynamicrafter_tpu_torch.training.logging import MetricLogger  # noqa: E402
from dynamicrafter_tpu_torch.utils.tokenizer import HashTokenizer  # noqa: E402
from test_torch_samplers import few_torch_threads  # noqa: E402,F401
from test_torch_train import _tiny_train_yaml  # noqa: E402

N_BATCHES = 7  # past the end of an epoch: 12 clips in 2 shards of 3 batches


def _loader(cls, shard_id, num_shards, **kw):
    return cls(SyntheticVideoDataset(video_length=4, resolution=(16, 16), size=12),
               batch_size=2, tokenizer=HashTokenizer(), seed=5, num_workers=2,
               shard_id=shard_id, num_shards=num_shards, **kw)


def _take(loader, n):
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            return out


@pytest.mark.parametrize("num_shards", [1, 2])
def test_process_loader_gives_the_thread_loaders_batches(num_shards):
    """Bit for bit and in order, past an epoch's end, from two worker
    processes; the shards' epochs are disjoint."""
    epochs = []
    for shard_id in range(num_shards):
        threads = _take(_loader(DataLoader, shard_id, num_shards), N_BATCHES)
        loader = _loader(ProcessDataLoader, shard_id, num_shards)
        procs, pids = [], ()
        for batch in loader:
            procs.append(batch)
            pids = loader.worker_pids
            if len(procs) == N_BATCHES:
                break
        assert len(pids) == 2 and os.getpid() not in pids and len(set(pids)) == 2
        for a, b in zip(threads, procs):
            assert set(a) == set(b) == {"video", "fs", "captions", "tokens"}
            for key in ("video", "fs", "tokens"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            assert a["captions"] == b["captions"]
        per_epoch = 6 // num_shards  # 12 clips, batches of 2
        epochs.append({c for b in procs[:per_epoch] for c in b["captions"]})
    assert sum(map(len, epochs)) == len(set().union(*epochs)) == 12


def test_process_loader_refuses_what_the_thread_loader_refuses():
    with pytest.raises(ValueError, match="fewer than batch_size"):
        ProcessDataLoader(SyntheticVideoDataset(size=3), batch_size=2, shard_id=1, num_shards=2)
    with pytest.raises(TypeError, match="IterableVideoDataset"):
        next(iter(ProcessDataLoader(IterableVideoDataset(num_records=8), batch_size=2)))


def test_metric_logger_tensorboard_leaves_the_csv_as_it_was(tmp_path):
    """The CSV with TensorBoard on equals the CSV without it (wall time
    aside); the event file holds the scalars."""
    rows = [(1, {"loss": 0.5, "grad_norm": 2.0}), (2, {"loss": 0.25, "grad_norm": 1.5}),
            (2, {"val/loss": 0.75})]
    for tb in (False, True):
        logger = MetricLogger(str(tmp_path / str(tb)), use_tensorboard=tb)
        for step, m in rows:
            logger.log(step, m)
        logger.close()
    read = lambda d: [{k: v for k, v in r.items() if k != "wall_s" and "rss" not in k}
                      for r in csv.DictReader(open(tmp_path / d / "metrics.csv"))]
    assert read("False") == read("True")
    assert not glob.glob(str(tmp_path / "False" / "events.out.tfevents.*"))
    (events,) = glob.glob(str(tmp_path / "True" / "events.out.tfevents.*"))
    scalars = {}
    for event in _events(events):
        for v in event.summary.value:
            scalars.setdefault(v.tag, []).append((event.step, v.simple_value))
    assert {k: scalars[k] for k in ("loss", "grad_norm", "val/loss")} == {
        "loss": [(1, 0.5), (2, 0.25)], "grad_norm": [(1, 2.0), (2, 1.5)], "val/loss": [(2, 0.75)]}


def _events(path):
    """The Event records of a TensorBoard event file (TFRecord framing: length,
    its CRC, the record, its CRC)."""
    import struct

    from tensorboardX.proto.event_pb2 import Event

    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (n,) = struct.unpack("<Q", data[pos:pos + 8])
        event = Event()
        event.ParseFromString(data[pos + 12:pos + 12 + n])
        yield event
        pos += 12 + n + 4


def test_train_cli_processes_loader_profile_and_tensorboard(tmp_path):
    """11 micro-steps with --loader processes and --profile_steps 1: the
    trace of micro-step 10 under <workdir>/profile, workers in other
    processes, TensorBoard scalars beside metrics.csv, and the first two
    micro-steps' metrics equal to a --loader threads run's."""
    cfg = _tiny_train_yaml(tmp_path)
    common = ["--config", cfg, "--logdir", str(tmp_path / "logs"), "--synthetic_data",
              "--log_every", "1", "--device", "cpu"]
    res = train.main([*common, "--name", "proc", "--max_steps", "11", "--loader", "processes",
                      "--profile_steps", "1"])
    workdir = tmp_path / "logs" / "proc"
    assert res["trace"] == str(workdir / "profile" / "trace.json")
    with open(res["trace"]) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    assert len(res["worker_pids"]) == 2 and os.getpid() not in res["worker_pids"]
    assert len(res["metrics"]) == 11
    assert glob.glob(str(workdir / "events.out.tfevents.*"))
    with open(workdir / "metrics.csv") as f:
        assert [int(r["step"]) for r in csv.DictReader(f)] == list(range(1, 12))
    threads = train.main([*common, "--name", "thr", "--max_steps", "2", "--loader", "grain"])
    assert threads["metrics"] == res["metrics"][:2]
    assert threads["trace"] is None


def test_checkpoint_none_gives_configs_loss_and_gradients(tmp_path, monkeypatch):
    """One fp32 micro-step each way through the CLI: the UNet checkpoints only
    under `config`, and the loss and every gradient agree to rel 1e-6."""
    grads = []
    real = ttrainer.AccumulatingAdamW.update

    def spy(self, g):
        grads.append(torch.cat([x.flatten() for x in g]))
        return real(self, g)

    monkeypatch.setattr(ttrainer.AccumulatingAdamW, "update", spy)
    cfg = _tiny_train_yaml(tmp_path)
    runs = {policy: train.main(["--config", cfg, "--logdir", str(tmp_path / "logs"),
                                "--name", policy, "--synthetic_data", "--max_steps", "1",
                                "--device", "cpu", "--checkpoint", policy])
            for policy in ("config", "none")}
    assert runs["config"]["trainer"].pipe.unet.config.use_checkpoint
    assert not runs["none"]["trainer"].pipe.unet.config.use_checkpoint
    loss = [runs[p]["metrics"][0]["loss"] for p in ("config", "none")]
    assert abs(loss[0] - loss[1]) <= 1e-6 * abs(loss[0])
    assert ((grads[0] - grads[1]).norm() / grads[0].norm()).item() <= 1e-6
    assert grads[0].abs().sum() > 0


def test_train_probe_prints_both_policies(tmp_path, capsys):
    cfg = _tiny_train_yaml(tmp_path)
    result = train_probe.main(["--config", cfg, "--res", "256", "--batch", "1", "--iters", "1",
                               "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["res"] == 256 and last["batch"] == 1
    assert set(last["ms_per_step"]) == set(last["peak_gib"]) == {"config", "none"}
    assert all(v > 0 for v in last["ms_per_step"].values())
    assert last["peak_gib"] == {"config": None, "none": None}  # no device peak on the CPU
    assert result["device"] == "cpu"
    with pytest.raises(SystemExit, match="unknown policy"):
        train_probe.main(["--config", cfg, "--policies", "dots", "--device", "cpu"])


def test_webvid_dataset_pickles_for_worker_processes(tmp_path):
    """A spawned worker gets the dataset by pickle: the thread-local RNG is
    left behind and made anew, the rest (metadata, settings) comes along."""
    import pickle

    from dynamicrafter_tpu_torch.data.webvid import WebVidDataset

    meta = tmp_path / "meta.csv"
    meta.write_text("page_dir,videoid,name\np0,v0,a fox\np1,v1,waves at dusk\n")
    ds = WebVidDataset(str(meta), str(tmp_path), video_length=4, resolution=(16, 16), seed=3)
    first = ds.rng.random()
    copy = pickle.loads(pickle.dumps(ds))
    assert copy.metadata == ds.metadata and copy.resolution == (16, 16) and copy.seed == 3
    assert copy.rng.random() == first   # a fresh RNG from the same seed, on this thread


class _RangeIterable(IterableVideoDataset):
    def __iter__(self):
        for i in self.sample_ids:
            yield {"video": np.full((4, 16, 16, 3), i / 16, np.float32), "caption": f"c{i}",
                   "frame_stride": np.int32(1)}


@pytest.mark.parametrize("kind", ["threads", "processes", "iterable"])
def test_skip_batches_starts_the_stream_later(kind):
    """`skip_batches=k` gives the stream without its first k batches, past
    an epoch's end and on a shard, for both loaders (what a resumed training
    run reads); an iterable dataset, which could only replay its stream,
    raises."""
    if kind == "iterable":
        with pytest.raises(ValueError, match="map-style"):
            DataLoader(_RangeIterable(num_records=12), batch_size=2,
                       tokenizer=HashTokenizer(), skip_batches=3)
        return
    cls = DataLoader if kind == "threads" else ProcessDataLoader
    make = lambda **kw: _loader(cls, 1, 2, **kw)
    whole = _take(make(), N_BATCHES)
    tail = _take(make(skip_batches=3), N_BATCHES - 3)
    assert [b["captions"] for b in tail] == [b["captions"] for b in whole[3:]]
    for a, b in zip(whole[3:], tail):
        for key in ("video", "fs", "tokens"):
            np.testing.assert_array_equal(a[key], b[key])
