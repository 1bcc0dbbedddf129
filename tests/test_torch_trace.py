"""The port's tracer (`dynamicrafter_tpu_torch/utils/trace.py`), its spans
in the pipeline, the samplers, the UNet, the VAE, SDS and the trainer, and
its Chrome export, on the CPU at the tiny configuration. The charging of a
trace's device time to the spans is the benchmark's
(`benchmark/tests/test_bench_spans.py`)."""
import copy
import gc
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu_torch import profile_unet  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.models.blocks import (  # noqa: E402
    ResBlock, SpatialTransformer, TemporalTransformer,
)
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.training import trainer as ttrainer  # noqa: E402
from dynamicrafter_tpu_torch.utils import trace  # noqa: E402
from test_torch_samplers import few_torch_threads  # noqa: E402,F401

T, HW = 4, 16


def _pipe(config=TINY_MODEL_CONFIG, training=False):
    cfg = ModelConfig(copy.deepcopy(config))
    pipe = (DynamiCrafterPipeline.for_training(cfg, "cpu", frozen_dtype=torch.float32)
            if training else DynamiCrafterPipeline(cfg, "cpu"))
    pipe.init_random(3)
    return pipe


def _layer_counts(unet):
    kinds = {"resblock": ResBlock, "spatial": SpatialTransformer,
             "temporal": TemporalTransformer}
    return {k: sum(isinstance(m, c) for m in unet.modules()) for k, c in kinds.items()}


def _video(b=1, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (b, T, HW, HW, 3)).astype(np.float32)


def test_off_records_nothing_and_returns_the_shared_noop():
    assert trace.span("unet", rows=2) is trace.NOOP
    with trace.span("unet") as s:
        assert s is None
    with trace.recording() as rec:
        with trace.span("a", k=1) as s:
            assert isinstance(s, trace.Span)
    assert trace.span("b") is trace.NOOP
    with trace.span("b"):
        pass
    assert [s.name for s in rec.spans] == ["a"] and rec.spans[0].attrs == {"k": 1}
    assert rec.residual_ns is not None and rec.residual_ns < 10**6
    with trace.recording():
        with pytest.raises(RuntimeError):
            trace.recording()


def test_ddim_sample_spans_one_request():
    """DDIM-3 with batched CFG: one request, three sampler steps, three UNet
    calls, each holding the configuration's ResBlocks, SpatialTransformers
    and TemporalTransformers (init_attn among them), all of one request;
    `timings` keeps its keys and equals the stage spans."""
    pipe = _pipe()
    timings = {}
    with trace.recording() as rec:
        pipe.sample(["a cat"], _video(), steps=3, cfg_scale=7.5, seed=1, timings=timings,
                    timestep_spacing="uniform_trailing")
    names = [s.name for s in rec.spans if s.name != "gc"]
    by = lambda n: [s for s in rec.spans if s.name == n]
    assert len(by("request")) == 1 and len(by("sampler_step")) == 3 and len(by("unet")) == 3
    req = by("request")[0]
    assert req.parent is None and req.attrs == {"sampler": "ddim", "steps": 3, "batch": 1}
    assert all(s.rid == req.id for s in rec.spans)
    want = _layer_counts(pipe.unet)
    assert want["temporal"] == want["spatial"] + 1           # init_attn
    for u in by("unet"):
        assert u.attrs == {"rows": 2, "shallow": False}
        assert u.parent in {s.id for s in by("sampler_step")}
        inside = [s for s in rec.spans if u.start <= s.start and s.end <= u.end]
        for kind, n in want.items():
            assert sum(s.name == kind for s in inside) == n
    assert [s.attrs["step"] for s in by("sampler_step")] == [0, 1, 2]
    (cond,) = by("conditioning")
    for n in ("clip_text", "clip_vision", "resampler", "vae_encode"):
        assert by(n) and all(cond.start <= s.start and s.end <= cond.end for s in by(n))
    assert len(by("vae_decode")) == (T if pipe.config.perframe_ae else 1)
    assert set(timings) == {"conditioning", "ddim", "decode"}
    for span_name, key in (("conditioning", "conditioning"), ("sampler", "ddim"),
                           ("decode", "decode")):
        (s,) = by(span_name)
        assert s.parent == req.id and timings[key] == (s.end - s.start) / 1e9
    assert names.index("conditioning") < names.index("sampler") < names.index("decode")


def test_timings_without_recording_keep_their_keys():
    pipe = _pipe()
    timings, peaks = {}, {}
    pipe.sample(["a cat"], _video(), steps=2, cfg_scale=1.0, seed=1, timings=timings,
                peaks=peaks)
    assert set(timings) == {"conditioning", "ddim", "decode"}
    assert all(v > 0 for v in timings.values()) and peaks == {}


def test_checkpointed_train_step_spans():
    """One checkpointed micro-step: the five trainer spans, once each, of one
    request; every layer span again inside `backward` (the recomputation),
    its parent chain reaching `backward`."""
    config = copy.deepcopy(TINY_MODEL_CONFIG)
    config["model"]["params"]["unet_config"]["params"]["use_checkpoint"] = True
    pipe = _pipe(config, training=True)
    trainer = ttrainer.Trainer(pipe, ttrainer.TrainConfig(accumulate_grad_batches=1))
    batch = {"video": torch.from_numpy(_video(2)),
             "tokens": torch.from_numpy(np.asarray(pipe.tokenizer(["a cat", "a dog"]),
                                                   dtype=np.int64)),
             "fs": torch.tensor([3, 5])}
    with trace.recording() as rec:
        trainer.train_step(batch)
    by = lambda n: [s for s in rec.spans if s.name == n]
    phases = {n: by(n) for n in ("train_step", "batch_input", "forward", "backward", "update")}
    assert all(len(v) == 1 for v in phases.values()), {k: len(v) for k, v in phases.items()}
    root = phases["train_step"][0]
    assert root.parent is None and all(s.rid == root.id for s in rec.spans)
    for n in ("batch_input", "forward", "backward", "update"):
        assert phases[n][0].parent == root.id
    order = [phases[n][0].start for n in ("batch_input", "forward", "backward", "update")]
    assert order == sorted(order)
    bwd = phases["backward"][0]
    want = _layer_counts(pipe.unet)
    ids = {s.id: s for s in rec.spans}

    def under(s, anc):
        while s.parent is not None:
            if s.parent == anc.id:
                return True
            s = ids[s.parent]
        return False

    for kind, n in want.items():
        spans = by(kind)
        assert len(spans) == 2 * n
        again = [s for s in spans if bwd.start <= s.start and s.end <= bwd.end]
        assert len(again) == n and all(under(s, bwd) for s in again)
        assert all(under(s, phases["forward"][0]) for s in spans if s not in again)


def test_a_span_on_a_waiting_callers_worker_thread_joins_its_request():
    """A thread with no span open (autograd's device thread recomputing a
    layer) takes the innermost span open on the root's thread as parent."""
    seen = []

    def worker():
        with trace.span("resblock") as s:
            seen.append(s)

    with trace.recording():
        with trace.span("train_step") as root, trace.span("backward") as bwd:
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    (s,) = seen
    assert s.parent == bwd.id and s.rid == root.id and s.tid != root.tid
    assert bwd.start <= s.start and s.end <= bwd.end


def test_gc_collection_is_a_span():
    with trace.recording() as rec:
        with trace.span("request") as req:
            gc.collect()
    (g,) = [s for s in rec.spans if s.name == "gc" and s.attrs["generation"] == 2]
    assert g.parent == req.id and req.start <= g.start <= g.end <= req.end
    n = len(gc.callbacks)
    gc.collect()
    assert len(gc.callbacks) == n


def test_spans_are_on_the_profiler_clock():
    """A `record_function` range opened inside a span lies within the span
    on the profiler's timeline (CPU activity)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, trace.recording() as rec:
        with trace.span("outer") as outer:
            time.sleep(0.002)
            with record_function("inner"):
                time.sleep(0.004)
            time.sleep(0.002)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    lo, hi = rec.trace_ns(outer.start), rec.trace_ns(outer.end)
    assert lo < ev.start_ns() and ev.start_ns() + ev.duration_ns() < hi


def test_stop_trace_writes_the_spans(tmp_path):
    session = profile_unet.start_trace(torch.device("cpu"))
    with trace.span("request", sampler="ddim"):
        with trace.span("unet", rows=2):
            torch.ones(8) @ torch.ones(8)
    path = profile_unet.stop_trace(session, torch.device("cpu"), str(tmp_path))
    doc = json.load(open(path))
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert [e["name"] for e in spans] == ["request", "unet"]
    req, unet = spans
    assert unet["args"]["parent"] == req["args"]["id"] == unet["args"]["request"]
    assert req["args"]["sampler"] == "ddim" and unet["args"]["rows"] == 2
    assert req["ts"] <= unet["ts"] and unet["ts"] + unet["dur"] <= req["ts"] + req["dur"]
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops and min(e["ts"] for e in ops) >= req["ts"]
    assert trace.span("x") is trace.NOOP


@pytest.mark.parametrize("sampler", ["dpm", "unipc"])
def test_other_samplers_span_their_steps(sampler):
    """DPM-Solver++ and UniPC at 4 steps (batched CFG): a `sampler_step` a
    step, numbered from 0, each UNet call inside the sampler stage and of
    the request; `timings` keeps the sampler loop's key "ddim"."""
    pipe = _pipe()
    timings = {}
    with trace.recording() as rec:
        pipe.sample(["a cat"], _video(), steps=4, cfg_scale=7.5, seed=1, timings=timings,
                    sampler=sampler, timestep_spacing="uniform_trailing")
    by = lambda n: [s for s in rec.spans if s.name == n]
    (req,) = by("request")
    (loop,) = by("sampler")
    assert req.attrs["sampler"] == sampler and all(s.rid == req.id for s in rec.spans)
    steps = by("sampler_step")
    assert [s.attrs["step"] for s in steps] == list(range(len(steps))) and len(steps) >= 4
    assert all(s.parent == loop.id for s in steps)
    unet = by("unet")
    assert len(unet) >= len(steps)
    assert all(loop.start <= u.start and u.end <= loop.end for u in unet)
    assert set(timings) == {"conditioning", "ddim", "decode"}
    assert timings["ddim"] == (loop.end - loop.start) / 1e9


def test_tiled_decode_spans_one_a_tile():
    from dynamicrafter_tpu_torch.models.vae import decode_tiled

    pipe = _pipe()
    zc = pipe.vae_config.z_channels
    z = torch.randn(1, 6, 6, zc)
    with trace.recording() as rec:
        decode_tiled(pipe.vae.decode, z, tile=4, overlap=2, scale=pipe._latent_factor)
    tiles = [s for s in rec.spans if s.name == "vae_decode"]
    assert len(tiles) == 4 and all(s.attrs["shape"] == (1, 4, 4, zc) for s in tiles)


def test_sds_stages_are_spans():
    """SDS's stage clock is the tracer's: `timings` equals its
    `conditioning`, `loop` and `decode` spans, one UNet call a step and CFG
    pass inside the loop."""
    from dynamicrafter_tpu_torch import sds

    pipe = _pipe()
    timings = {}
    guide = sds.SDSGuidancePipeline(pipe, sds.SDSSettings(
        num_steps=2, log_every=2, lr=0.05, cfg_scale=2.0, ddim_grid_steps=4,
        timestep_spacing="uniform_trailing"))
    with trace.recording() as rec:
        guide(["a cat"], _video(), seed=1, fs=[3], timings=timings)
    by = lambda n: [s for s in rec.spans if s.name == n]
    assert set(timings) == {"conditioning", "loop", "steps", "decode"}
    for name in ("conditioning", "loop", "decode"):
        (s,) = by(name)
        assert timings[name] == (s.end - s.start) / 1e9
    (loop,) = by("loop")
    unet = by("unet")
    assert unet and all(loop.start <= u.start and u.end <= loop.end for u in unet)
    assert len(timings["steps"]) == 2
