"""Spans of the port's work, on the clock of the `torch.profiler` timeline.

    from dynamicrafter_tpu_torch.utils import trace

    with trace.recording() as rec:
        pipe.sample(...)
    rec.spans        # every span opened while recording, in order of opening

`span(name, **attrs)` marks one piece of work where it happens (a request,
a stage, a sampler step, a UNet call and its layers, a kernel launch, a
trainer phase). With no recording open, the default, it returns one shared
no-op context after a single test of a module flag: it reads no clock and
never touches the device. A recording adds no device synchronisation
either: a span reads the host's clock at each end and appends itself to the
recording's list, which stays in memory until someone writes it out
(`profile_unet.stop_trace` puts it into its Chrome trace).

A span holds its name, id, parent id, request id (the id of its root span,
so the spans of one `pipeline.sample` or one `train_step` share it), the
OS thread id (the one the profiler reports), start and end, and its attrs.
Its parent is the innermost span open on its thread; on a thread with no
span open (autograd's device thread, recomputing a checkpointed layer in
the backward pass) it is the innermost span open on the thread that opened
the current root, which is waiting for that work.

The clock: spans read `time.perf_counter_ns()` (the monotonic clock). The
profiler's timeline (`_KinetoEvent.start_ns()`, and `ts` in its Chrome
trace after `baseTimeNanoseconds`) is on the Unix clock, to which kineto
maps its own clock and CUPTI's. The two system clocks run at one rate, so
one offset converts between them: `Recording.offset_ns`, read when the
recording opens; `Recording.residual_ns` is how far the same reading moved
by the time it closed (nonzero only where the system clock was stepped).

While a recording is open each cyclic garbage collection is a span `gc`
(attr `generation`), from `gc.callbacks`.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from typing import Dict, List, Optional

_on = False                           # the one test `span` makes
_rec: Optional["Recording"] = None
_local = threading.local()
_ids = itertools.count(1)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def span(name: str, **attrs):
    """A context for the span `name` while recording, else `NOOP`."""
    if not _on:
        return NOOP
    return Span(name, attrs)


def _thread() -> tuple:
    """This thread's (span stack, OS thread id), the id read once: reading
    it is a system call."""
    try:
        return _local.state
    except AttributeError:
        _local.state = ([], threading.get_native_id())
        return _local.state


class Span:
    """One span; a context manager that records itself in the open
    recording. Entered with none open it only reads the clock (a stage's
    timer, see `stage`)."""
    __slots__ = ("name", "attrs", "id", "parent", "rid", "tid", "start", "end")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name, self.attrs = name, attrs or {}
        self.id = self.parent = self.rid = self.tid = self.end = None

    def __enter__(self) -> "Span":
        rec = _rec
        if rec is not None:
            stack, tid = _thread()
            if stack:
                parent = stack[-1]
            elif rec.lead:                 # another thread's root is open
                parent = rec.lead[-1]
            else:
                parent = None
                rec.lead = stack
            self.id = next(_ids)
            self.parent = None if parent is None else parent.id
            self.rid = self.id if parent is None else parent.rid
            self.tid = tid
            stack.append(self)
            rec.spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self.id is not None:
            stack = _thread()[0]
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
        return False


def _unix_offset_ns() -> int:
    """Unix time less monotonic time, from the closest of a few paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


class Recording:
    """The spans of one recording (`recording()` opens it; `close` or the
    end of its `with` block closes it)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.lead: Optional[list] = None   # the span stack of the open root's thread
        self.offset_ns = _unix_offset_ns()
        self.residual_ns: Optional[int] = None
        self._gc_open: Dict[int, Span] = {}

    def _gc(self, phase: str, info: dict) -> None:
        tid = _thread()[1]
        if phase == "start":
            self._gc_open[tid] = Span("gc", {"generation": info.get("generation")}).__enter__()
        elif tid in self._gc_open:
            self._gc_open.pop(tid).__exit__(None, None, None)

    def close(self) -> None:
        global _on, _rec
        if _rec is self:
            _on, _rec = False, None
            gc.callbacks.remove(self._gc)
            self.residual_ns = abs(_unix_offset_ns() - self.offset_ns)

    def __enter__(self) -> "Recording":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def trace_ns(self, t: int) -> int:
        """A span's time on the profiler's clock (Unix ns)."""
        return t + self.offset_ns

    def chrome_events(self, base_ns: int = 0) -> List[dict]:
        """The closed spans as Chrome trace events ("X", microseconds after
        `base_ns` on the profiler's clock), one track per thread."""
        out = []
        for s in self.spans:
            if s.end is None:
                continue
            out.append({"ph": "X", "cat": "span", "name": s.name, "pid": "spans", "tid": s.tid,
                        "ts": (self.trace_ns(s.start) - base_ns) / 1e3,
                        "dur": (s.end - s.start) / 1e3,
                        "args": {"id": s.id, "parent": s.parent, "request": s.rid,
                                 **{k: v if isinstance(v, (int, float, bool, str)) else str(v)
                                    for k, v in s.attrs.items()}}})
        return out


def recording() -> Recording:
    """Open a recording: spans record into it until it is closed."""
    global _on, _rec
    if _rec is not None:
        raise RuntimeError("a trace recording is already open")
    rec = Recording()
    _rec = rec
    gc.callbacks.append(rec._gc)
    _on = True
    return rec


@contextlib.contextmanager
def stage(name: str, clock: Optional[dict], device, peaks: Optional[dict] = None,
          key: Optional[str] = None):
    """A request's stage as a span that is also its timer: the device is
    synchronised at its end (on CUDA), and `clock[key or name]` gets its
    seconds, `peaks[key or name]` the peak bytes allocated on the device
    during it (the counter reset at its start)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if peaks is not None and cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with Span(name) as s:
        yield s
        if cuda:
            torch.cuda.synchronize(device)
    key = key or name
    if clock is not None:
        clock[key] = (s.end - s.start) / 1e9
    if peaks is not None and cuda:
        peaks[key] = torch.cuda.max_memory_allocated(device)
