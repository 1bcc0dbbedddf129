"""A traced tail's device time and idle charged to the program's spans
(`dynamicrafter_tpu_torch/utils/trace.py`): the arithmetic of the span
metrics, kept with the benchmark.

An activity (kernel, copy, set) is charged to the innermost span open at
its host launch: the CUDA runtime or driver call of its correlation id,
which a CUDA-only `torch.profiler` trace keeps. An idle gap of the window is
charged to the innermost span open at its start. Threads are not told
apart: while a checkpointed layer is recomputed on autograd's thread the
caller's thread waits inside `backward`, so the latest span opened is the
one at work (a CUDA-only trace gives its host events torch's thread index,
not the OS id the spans carry).

The inputs are plain: spans as `Span` tuples on the trace's clock
(`from_recording` makes them from a recording), activities as
`launched_activities` reads them. Nothing here imports the program, which
may have no tracer: with no spans, `report` is empty.
"""
from __future__ import annotations

import collections
import heapq
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from benchmark import harness

LAYERS = frozenset({"resblock", "spatial", "temporal"})
PHASES = frozenset({"batch_input", "forward", "backward", "update"})


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    start: int            # ns on the trace's clock
    end: int


def from_recording(rec) -> List[Span]:
    """The closed spans of a `trace.Recording`, moved onto the profiler's
    clock by its offset."""
    return [Span(s.name, s.id, s.parent, s.start + rec.offset_ns, s.end + rec.offset_ns)
            for s in rec.spans if s.end is not None]


def launched_activities(prof) -> List[tuple]:
    """The device activities of a finished CUDA trace in order of start:
    (name, start, end, launch) in ns on the trace's clock, `launch` the
    start of the host's launch call (the runtime or driver API event of the
    same correlation id), None where the trace holds none."""
    from torch.autograd import DeviceType
    launch, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id()))
        elif e.correlation_id() and e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()    # cudaLaunchKernel, cuLaunchKernel, ...
    return sorted(((n, s, t, launch.get(c)) for n, s, t, c in dev), key=lambda a: a[1])


def innermost(spans: Sequence[tuple], times: Sequence[float]) -> List[Optional[int]]:
    """For each of `times`, the index in `spans` ((start, end, id)) of the
    innermost span open then (start <= t < end; the latest opened, by start
    and then id), or None."""
    by_start = sorted(range(len(spans)), key=lambda i: (spans[i][0], spans[i][2]))
    out: List[Optional[int]] = [None] * len(times)
    heap: list = []
    j = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(by_start) and spans[by_start[j]][0] <= t:
            i = by_start[j]
            heapq.heappush(heap, (-spans[i][0], -spans[i][2], i))
            j += 1
        while heap and spans[heap[0][2]][1] <= t:
            heapq.heappop(heap)
        out[q] = heap[0][2] if heap else None
    return out


def idle_gaps(activities: Sequence[tuple], window: Tuple[float, float]) -> List[tuple]:
    """The (start, end) intervals of `window` in which no activity ran
    (`harness.busy_intervals`' complement)."""
    lo, hi = window
    tl = harness.Timeline([(a[0], max(a[1], lo), min(a[2], hi)) for a in activities
                           if a[2] > lo and a[1] < hi], [], window)
    gaps, t = [], lo
    for s, e in harness.busy_intervals(tl) + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    return gaps


class Charged:
    """`activities` inside `window` and the window's idle gaps, each with
    the id of the span charged (None: no span open)."""

    def __init__(self, spans: Sequence[Span], activities: Sequence[tuple],
                 window: Tuple[int, int]):
        self.spans = list(spans)
        self.by_id = {s.id: s for s in self.spans}
        self.window = window
        clock = [(s.start, s.end, s.id) for s in self.spans]
        self.activities = [a for a in activities if a[2] > window[0] and a[1] < window[1]]
        at = innermost(clock, [float("-inf") if a[3] is None else a[3] for a in self.activities])
        self.owner = [None if i is None else self.spans[i].id for i in at]
        self.gaps = idle_gaps(self.activities, window)
        self.gap_owner = [None if i is None else self.spans[i].id
                          for i in innermost(clock, [s for s, _ in self.gaps])]

    def within(self, sid: Optional[int], names: frozenset) -> Optional[Span]:
        """The nearest span named in `names` among span `sid` and its ancestors."""
        while sid is not None:
            s = self.by_id.get(sid)
            if s is None or s.name in names:
                return s
            sid = s.parent
        return None

    def seconds(self, a: tuple) -> float:
        return (min(a[2], self.window[1]) - max(a[1], self.window[0])) * 1e-9


def report(ch: Charged) -> Dict[str, float]:
    """The span numbers of a charged tail. `charged_pct`: the share of
    device time launched inside some span. For UNet calls (`unet` spans),
    per call: device idle inside them over their length, the busy time
    inside them, the activities they launched, and the device time of those
    by layer kind (`other`: in a call but in no layer span). For micro-steps
    (`train_step` spans), per step: device time and idle by phase, the part
    of the backward launched in layer spans (the recomputation of the
    checkpointed layers), and the activities. Keys whose spans are absent
    are left out."""
    out: Dict[str, float] = {}
    unet_f, step_f = frozenset({"unet"}), frozenset({"train_step"})
    total = sum(map(ch.seconds, ch.activities))
    if total:
        out["charged_pct"] = 100.0 * sum(
            ch.seconds(a) for a, o in zip(ch.activities, ch.owner) if o is not None) / total
    unet = [s for s in ch.spans if s.name == "unet"]
    if unet:
        n = len(unet)
        calls = [(s.start, s.end) for s in unet]
        length = sum(e - s for s, e in calls) * 1e-9
        idle = sum(_overlap(g, calls) for g in ch.gaps) * 1e-9
        out["unet_idle_pct"] = 100.0 * idle / length
        out["unet_busy_ms"] = 1e3 * (length - idle) / n
        by_layer: Dict[str, float] = collections.Counter()
        kernels = 0
        for a, o in zip(ch.activities, ch.owner):
            if ch.within(o, unet_f) is not None:
                layer = ch.within(o, LAYERS)
                by_layer["other" if layer is None else layer.name] += ch.seconds(a)
                kernels += 1
        for k in ("resblock", "spatial", "temporal", "other"):
            out[f"unet_ms.{k}"] = 1e3 * by_layer[k] / n
        out["unet_kernels"] = kernels / n
    steps = [s for s in ch.spans if s.name == "train_step"]
    if steps:
        n = len(steps)
        busy: Dict[str, float] = collections.Counter()
        idle: Dict[str, float] = collections.Counter()
        recompute, kernels = 0.0, 0
        for a, o in zip(ch.activities, ch.owner):
            if ch.within(o, step_f) is None:
                continue
            kernels += 1
            phase = ch.within(o, PHASES)
            if phase is not None:
                busy[phase.name] += ch.seconds(a)
                if phase.name == "backward" and ch.within(o, LAYERS) is not None:
                    recompute += ch.seconds(a)
        for (s, e), o in zip(ch.gaps, ch.gap_owner):
            phase = ch.within(o, PHASES)
            if phase is not None and ch.within(o, step_f) is not None:
                idle[phase.name] += (e - s) * 1e-9
        for k in ("batch_input", "forward", "backward", "update"):
            out[f"train_ms.{k}"] = 1e3 * busy[k] / n
            out[f"train_idle_ms.{k}"] = 1e3 * idle[k] / n
        out["train_ms.recompute"] = 1e3 * recompute / n
        out["train_kernels.step"] = kernels / n
    return out


def _overlap(gap: tuple, intervals: Sequence[tuple]) -> float:
    return sum(max(0, min(gap[1], e) - max(gap[0], s)) for s, e in intervals)
