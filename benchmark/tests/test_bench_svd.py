"""The Stable Video Diffusion cell end to end at the tiny size on the CPU:
the result line's keys, `correct` on the sound program, and `correct`
false with the UNet's blend convention swapped, the frame-position
embedding dropped, the guidance ramp reversed, and under the control."""
import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny_svd
from benchmark.traffic import generate_svd

SEED = 2**33 + 29
# float32 on both sides at the tiny size: limits from the sound program's
# own readings (about 1e-6 and below), far under the faults'
LIMITS = {"conditioning": 1e-4, "unet": 1e-4, "sampler_step": 1e-4, "decode": 1e-4}


@pytest.fixture(scope="module")
def cell():
    return tiny_svd.cell(steps=3, max_clips=1, check_clips=1, check_calls=3, limits=LIMITS)


def _run(cell, trace=False, fault=None, control=False):
    return generate_svd.run(cell, seed=SEED, seconds=0.5, trace=trace,
                            device=torch.device("cpu"),
                            clock=harness.SetupClock(time.perf_counter()),
                            program=tiny_svd.program(cell.config), control=control, fault=fault)


def _line(result, checks) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        harness.emit(result, checks)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_and_sound_program(cell, trace):
    line = _line(*_run(cell, trace=trace))
    assert set(line) - {"breakdown"} == {"correct", "attempted", "failed", "metrics", "device",
                                         "checks"}
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(LIMITS)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if trace:
        assert "mfu.svd" in line["metrics"] and "stage_s.decode" in line["metrics"]
    else:
        assert {"clip_s", "peak_gib", "setup_s"} <= set(line["metrics"])


def _swap_blends(pipe):
    from dynamicrafter_tpu_torch.models.video_unet import AlphaBlender
    for m in pipe.unet.modules():
        if isinstance(m, AlphaBlender):
            m.forward = lambda xs, xt, f=m.forward: f(xt, xs)


def _drop_frame_embedding(pipe):
    from dynamicrafter_tpu_torch.models.video_unet import SpatialVideoTransformer
    for m in pipe.unet.modules():
        if isinstance(m, SpatialVideoTransformer):
            m.time_pos_embed.register_forward_hook(lambda mod, args, out: out * 0)


@pytest.mark.parametrize("fault", ["blend_swapped", "frame_embedding_dropped",
                                   "guidance_reversed"])
def test_faults_fail_correct(cell, fault, monkeypatch):
    plant = {"blend_swapped": _swap_blends, "frame_embedding_dropped": _drop_frame_embedding,
             "guidance_reversed": None}[fault]
    if fault == "guidance_reversed":
        import dynamicrafter_tpu_torch.svd_pipeline as sp
        ramp = sp.frame_scales
        monkeypatch.setattr(sp, "frame_scales", lambda f, lo, hi: ramp(f, hi, lo))
    result, checks = _run(cell, fault=plant)
    assert result["correct"] is False, checks


def test_control_fails_the_limits(cell):
    result, checks = _run(cell, control=True)
    assert result["correct"] is True, checks
    assert any(v > LIMITS[k] for k, v in result["control"].items()), result["control"]
