"""What every cell shares: finding a cell's files by name, the set-up
clock, the card's clocks beside the window, reading the profiler's
timeline, the per-layer metric readers, the checks of `correct`, and the
result line.

A cell `<name>` is the entry of that name in `BENCHMARK.json`; its
parameters and limits are `benchmark/workloads/<name>.json`, its
configuration the file its entry in `configs` names, its traffic the
module `benchmark/traffic/<traffic>.py`, and each per-layer metric
`benchmark/metrics/<metric>.py`. Nothing here names a cell.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamicrafter_tpu")

# first match wins (copied from the program's profile_unet.FAMILIES): copies
# before elementwise (a copy is an elementwise kernel by name), layout
# transposes before convolutions
FAMILIES = (
    ("K4a flash_bwd_dq", ("flash_bwd_dq",)),
    ("K4b flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("K4 di pre-pass", ("flash_bwd_di",)),
    ("K6 flash_fwd_packed", ("flash_fwd_packed_tc_kernel", "flash_fwd_packed_kernel")),
    ("K9 flash_attention_pairs", ("flash_fwd_pairs_tc_kernel", "flash_fwd_pairs_kernel")),
    ("K10 run_variant", ("flash_variants_tc_kernel", "flash_variants_kernel")),
    ("K1 flash_fwd", ("flash_fwd_tc_kernel", "flash_fwd_fma_kernel")),
    ("K5 small_t_fwd", ("small_t_posmajor_tc_kernel", "small_t_posmajor_kernel")),
    ("K2 small_t_kernel", ("small_t_tc_kernel", "small_t_kernel")),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("conv", "fprop", "xmma", "cudnn", "implicit_gemm")),
    ("GroupNorm + LayerNorm", ("RowwiseMoments", "GroupNorm", "group_norm", "layer_norm",
                               "LayerNorm")),
    ("softmax", ("softmax", "Softmax")),
    ("dtype and layout copies", ("copy", "Copy", "CatArray", "Memcpy", "memcpy")),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "cublas")),
    ("reductions", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "vectorized")),
)


def family(kernel_name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in kernel_name for k in keys):
            return fam
    return "other"


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the workloads entry of BENCHMARK.json
    params: dict          # benchmark/workloads/<name>.json
    config: dict          # the configuration file's contents
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    params = json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text())
    config = json.loads((root / conf["file"]).read_text())
    listed = lambda m: name in m.get("workloads", [name])
    return Cell(name, entry, params, config,
                [m for m in spec["end_to_end"] if listed(m)],
                [m for m in spec["per_layer"] if listed(m)])


def traffic_module(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class SetupClock:
    """Seconds of each part of the set-up, from a start taken before the
    heavy imports."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0
        self.parts: Dict[str, float] = {}

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.t0


def card_clocks() -> str:
    """The card's name, SM clock, power draw and limit, temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi printed nothing"


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# --- the traced tail ---------------------------------------------------------

class Spans:
    """The harness's host spans, (name, start, end) on `time.perf_counter`."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))


@dataclasses.dataclass
class Timeline:
    """Device activities and the harness's host spans of a traced window, in
    seconds on the device trace's clock."""
    device: List[Tuple[str, float, float]]        # (name, start, end)
    spans: List[Tuple[str, float, float]]         # (name, start, end), host
    window: Tuple[float, float]


class TracedTail:
    """`torch.profiler` over device activity alone (no host operator
    tracing, whose cost lands on a host-paced step), around work run after
    the measured window. The window's ends are marker kernels launched on
    an idle device: the first and the last device activities of the trace.
    A marker starts as the host launches it, so its start minus the host's
    clock at the launch maps the host spans onto the trace's clock."""

    def __init__(self, device):
        import torch
        self.torch, self.device = torch, device
        self.spans = Spans()
        self.timeline: Optional[Timeline] = None

    def __enter__(self):
        torch = self.torch
        self.marker = torch.zeros(1, dtype=torch.float64, device=self.device)
        torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        self.marker.fill_(1.0)
        return self

    def __exit__(self, *exc):
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.marker.fill_(2.0)
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        if exc[0] is None:
            self.timeline = read_timeline(self.prof, self.t0, self.spans.items)
        del self.prof
        return False


def read_timeline(prof, t_host0: float, spans) -> Timeline:
    """The device activities of `prof` between its first and last (the
    markers), and `spans` moved onto the trace's clock by the first
    marker's start less `t_host0`."""
    from torch.autograd import DeviceType
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns() * 1e-9
            dev.append((e.name(), start, start + e.duration_ns() * 1e-9))
    dev.sort(key=lambda d: d[1])
    if len(dev) < 2:
        return Timeline([], [], (0.0, 0.0))
    lo, hi = dev[0][1], dev[-1][1]
    shift = lo - t_host0
    inner = [(n, max(s, lo), min(e, hi)) for n, s, e in dev[1:-1] if e > lo and s < hi]
    return Timeline(inner, [(n, s + shift, e + shift) for n, s, e in spans], (lo, hi))


class GcPauses:
    """Seconds the interpreter spent in cyclic garbage collection while
    open, by generation (printed beside the window: a host stall that
    lands inside a timed step)."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.counts = [0, 0, 0]
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info.get("generation", 2)
            self.seconds[g] += time.perf_counter() - self._t
            self.counts[g] += 1

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False

    def line(self) -> str:
        return "gc pauses in the window: " + ", ".join(
            f"gen{g} {c} x {s:.4f} s" for g, (c, s) in enumerate(zip(self.counts, self.seconds)))


def busy_intervals(tl: Timeline) -> List[Tuple[float, float]]:
    """The union of the device activities' intervals."""
    out: List[List[float]] = []
    for _, s, e in sorted(tl.device, key=lambda d: d[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(tl: Timeline, label: Callable[[float], str]) -> Dict[str, float]:
    """Idle seconds of the window, summed by what the host was doing at the
    start of each gap (`label(t)`)."""
    lo, hi = tl.window
    gaps: Dict[str, float] = {}
    t = lo
    for s, e in busy_intervals(tl) + [(hi, hi)]:
        if s > t:
            name = label(t)
            gaps[name] = gaps.get(name, 0.0) + (s - t)
        t = max(t, e)
    return gaps


def device_families(tl: Timeline) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e in tl.device:
        fam = family(name)
        out[fam] = out.get(fam, 0.0) + (e - s)
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


# --- correctness -------------------------------------------------------------

def rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    den = float(want.norm())
    return float((got - want).norm()) / max(den, 1e-300)


def rms_gap(got, want) -> float:
    """The root mean square of got - want, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm()) / max(want.numel(), 1) ** 0.5


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """Each number against its limit; a number missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


# --- the result --------------------------------------------------------------

def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines of stderr,
    then the result as the last line of stdout, `checks` its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
