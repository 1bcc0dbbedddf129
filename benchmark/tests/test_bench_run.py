"""The cells end to end at the tiny size on the CPU: the result line's
keys, `correct` on the sound program, and `correct` false under each
fault the cell can have (`benchmark/faults.py`; the exchange between
chips is not among them: every cell runs on one card) and under the
control; a cell's sampler, batch and DeepCache read from its file; and
the traced tail's timeline on a profiler's events made by hand."""
import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import tiny
from benchmark.traffic import finetune, generate

SEED = 2**33 + 17


def _gen(cell, trace=False, fault=None, control=False):
    return generate.run(cell, seed=SEED, seconds=0.5, trace=trace, device=torch.device("cpu"),
                        clock=harness.SetupClock(time.perf_counter()),
                        program=tiny.program(cell.config), control=control, fault=fault)


def _train(cell, trace=False, fault=None, control=False):
    return finetune.run(cell, seed=SEED, seconds=0.5, trace=trace, device=torch.device("cpu"),
                        clock=harness.SetupClock(time.perf_counter()),
                        program=tiny.train_program(cell.config), control=control, fault=fault)


@pytest.fixture(scope="module")
def gen_cell():
    return tiny.cell("i2v512.ddim50", steps=3, max_clips=2, check_clips=2, check_calls=3)


@pytest.fixture(scope="module")
def unipc_cell():
    return tiny.cell("i2v1024.unipc20", steps=4, max_clips=1, check_clips=1, check_calls=2)


@pytest.fixture(scope="module")
def train_cell():
    # float32 on the CPU (bf16 autocast there leaves the tiny model's
    # near-zero leaves to rounding alone), and limits from its own readings
    # (sound 0.018, 0.018, 0.034, 0.027; the control 0.82, 0.26, 0.40,
    # 0.097; the 5 %-off prediction 0.073, 0.046, 0.082, 0.062)
    return tiny.cell("ft1024.bs1", bf16=False, limits={
        "grad": 0.05, "change": 0.05, "grad_late": 0.06, "change_late": 0.05})


def _line(result, checks) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        harness.emit(result, checks)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("kind,trace", [("gen", False), ("gen", True), ("unipc", False),
                                        ("train", False), ("train", True)])
def test_result_line_has_the_contract_keys(kind, trace, gen_cell, unipc_cell, train_cell):
    cell = {"gen": gen_cell, "unipc": unipc_cell, "train": train_cell}[kind]
    run = _train if kind == "train" else _gen
    line = _line(*run(cell, trace=trace))
    keys = {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert set(line) - {"breakdown"} == keys
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(cell.params["limits"])
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        # no traced tail without a CUDA device: its readers are silent here,
        # those of the window (mfu, the stages) are not
        assert set(line["metrics"]) <= names
        assert any(k.startswith("mfu.") for k in line["metrics"])
        assert "breakdown" not in line
    else:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}


@pytest.mark.parametrize("name", sorted(faults.GENERATION))
def test_a_generation_fault_is_not_correct(gen_cell, name, monkeypatch):
    import dynamicrafter_tpu_torch.pipeline as pl
    monkeypatch.setattr(pl, "ddim_sample", pl.ddim_sample)
    monkeypatch.setattr(pl, "unipc_sample", pl.unipc_sample)
    result, checks = _gen(gen_cell, fault=faults.GENERATION[name])
    assert result["correct"] is False, checks


@pytest.mark.parametrize("name", sorted(faults.TRAINING))
def test_a_training_fault_is_not_correct(train_cell, name):
    result, checks = _train(train_cell, fault=faults.TRAINING[name])
    assert result["correct"] is False, checks


def test_a_fault_after_the_warm_up_fails_the_late_pair_alone(train_cell):
    result, checks = _train(train_cell, fault=faults.TRAINING["answer_altered_late"])
    assert result["correct"] is False
    late = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert late and late <= {"grad_late", "change_late"}, checks


@pytest.mark.parametrize("over", [{"bs": 2, "check_clips": 4},
                                  {"deepcache": 2, "steps": 4, "check_calls": 4}],
                         ids=["bs2", "deepcache2"])
def test_batch_and_deepcache_from_the_cell_file(over):
    cell = tiny.cell("i2v512.ddim50", **{"steps": 3, "max_clips": 2, "check_clips": 2,
                                          "check_calls": 3, **over})
    result, checks = _gen(cell)
    assert result["correct"] is True, checks
    assert result["metrics"]["clip_s"]["value"] > 0
    result, checks = _gen(cell, fault=faults.GENERATION["answer_altered"])
    assert result["correct"] is False, checks


def test_a_sampler_the_reference_does_not_follow_is_refused():
    cell = tiny.cell("i2v512.ddim50", sampler="dpm", steps=3)
    with pytest.raises(ValueError, match="reference follows"):
        _gen(cell)


@pytest.mark.parametrize("kind", ["gen", "train"])
def test_the_control_fails_the_limits(kind, gen_cell, train_cell):
    cell = gen_cell if kind == "gen" else train_cell
    result, _ = (_gen if kind == "gen" else _train)(cell, control=True)
    control, limits = result["control"], cell.params["limits"]
    assert any(control[k] > limits[k] for k in limits), control


class _Event:
    def __init__(self, name, start_s, dur_s, cuda=True):
        from torch.autograd import DeviceType
        self._n, self._s, self._d = name, int(start_s * 1e9), int(dur_s * 1e9)
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


def test_the_traced_tail_timeline_from_its_markers():
    from types import SimpleNamespace
    events = [_Event("fill marker", 1000.0, 1e-6), _Event("cudaLaunchKernel", 1000.2, 1e-3, False),
              _Event("gemm", 1000.1, 0.3), _Event("flash_fwd_tc_kernel", 1000.5, 0.2),
              _Event("fill marker", 1001.0, 1e-6)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    # the host launched the first marker at 5.0 s on its own clock
    tl = harness.read_timeline(prof, 5.0, [("unet_call", 5.05, 5.45), ("clip", 5.0, 5.95)])
    assert tl.window == (pytest.approx(1000.0), pytest.approx(1001.0))
    assert [d[0] for d in tl.device] == ["gemm", "flash_fwd_tc_kernel"]
    assert tl.spans[0] == ("unet_call", pytest.approx(1000.05), pytest.approx(1000.45))
    gaps = harness.idle_gaps(tl, generate._gap_labeller(tl))
    # idle 1000.0-1000.1 (inside the clip, before its first UNet call),
    # 1000.4-1000.5 (the host still inside the call) and 1000.7-1001.0
    # (after the UNet call: the decode)
    assert gaps == {"conditioning": pytest.approx(0.1), "unet_call": pytest.approx(0.1),
                    "decode": pytest.approx(0.3)}
    assert harness.device_families(tl)["K1 flash_fwd"] == pytest.approx(0.2)


def test_bf16_products_round_the_trained_weights_and_give_them_back():
    from benchmark.reference import training
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.LayerNorm(4), torch.nn.Conv1d(4, 2, 1))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1e-5)                     # a step below bf16's spacing
    masters = [p.detach().clone() for p in net.parameters()]
    x = torch.randn(3, 4)
    with training.bf16_products([net]):
        lin, norm = net[0], net[1]
        assert torch.equal(lin.weight, lin.weight.bfloat16().float())
        assert not torch.equal(lin.weight, masters[0])
        assert torch.equal(norm.weight, masters[2])        # norms keep float32
        y = net[2](net[1](net[0](x)).unsqueeze(-1)).sum()
        grads = torch.autograd.grad(y, list(net.parameters()))
    assert all(torch.equal(p, m) for p, m in zip(net.parameters(), masters))
    assert all(g.shape == p.shape for g, p in zip(grads, net.parameters()))
