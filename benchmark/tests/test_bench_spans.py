"""`benchmark/metrics/spans.py` on hand-made spans and timelines: charging
to the innermost span, across threads, and gaps at span and window edges."""
import pytest

from benchmark.metrics import spans


def _spans(rows):
    """`Span`s from (name, start, end, parent name); ids count from 1."""
    made, out = {}, []
    for i, (name, s, e, parent) in enumerate(rows):
        sp = spans.Span(name, i + 1, None if parent is None else made[parent].id, s, e)
        made.setdefault(name, sp)
        out.append(sp)
    return out


@pytest.mark.parametrize("t, want", [(5, None), (10, 0), (15, 1), (20, 0), (25, 2),
                                     (29, 2), (30, 0), (40, None)])
def test_innermost_open_span(t, want):
    """Spans (start, end, id): a root [10, 40), a child [15, 20) (end
    excluded), a second child [25, 30) opened on another thread."""
    assert spans.innermost([(10, 40, 1), (15, 20, 2), (25, 30, 3)], [t]) == [want]


def test_idle_gaps_at_window_edges():
    acts = [("k", 12, 20, None), ("k", 18, 25, None), ("k", 30, 45, None)]
    assert spans.idle_gaps(acts, (10, 40)) == [(10, 12), (25, 30)]
    assert spans.idle_gaps([], (0, 5)) == [(0, 5)]
    assert spans.idle_gaps([("k", 0, 3, None), ("k", 4, 9, None)], (1, 6)) == [(3, 4)]


def test_report_charges_launches_and_gaps():
    """Two UNet calls; kernels charged by launch (a kernel launched in a
    resblock runs after the span closed), gaps by the span open at their
    start; a kernel without a launch event stays uncharged."""
    sp = _spans([("request", 0, 200, None), ("unet", 10, 60, "request"),
                 ("resblock", 12, 30, "unet"), ("spatial", 30, 50, "unet"),
                 ("unet", 100, 150, "request")])
    acts = [("a", 20, 40, 14), ("b", 40, 55, 35), ("c", 60, 70, 55),
            ("d", 110, 140, 105), ("e", 160, 170, None)]
    ch = spans.Charged(sp, acts, (0, 200))
    assert ch.owner == [3, 4, 2, 5, None]
    r = spans.report(ch)
    assert r["unet_ms.resblock"] == pytest.approx(1e3 * 20e-9 / 2)
    assert r["unet_ms.spatial"] == pytest.approx(1e3 * 15e-9 / 2)
    assert r["unet_ms.other"] == pytest.approx(1e3 * 40e-9 / 2)
    assert r["unet_ms.temporal"] == 0 and r["unet_kernels"] == 2.0
    # idle inside the calls: [10, 20), [55, 60), [100, 110), [140, 150) of 100 ns
    assert r["unet_idle_pct"] == pytest.approx(35.0)
    assert r["unet_busy_ms"] == pytest.approx(1e3 * 65e-9 / 2)
    assert r["charged_pct"] == pytest.approx(100 * 75 / 85)
    # gaps from 0, 55, 70, 140, 170: the request, the first call (its
    # spatial span closed at 50), the request, the second call, the request
    assert ch.gap_owner == [1, 2, 1, 5, 1]


def test_report_trainer_phases_and_recompute():
    """A micro-step whose backward recomputes a layer on another thread: the
    layer's span (parent `backward`) owns the recompute's kernel."""
    sp = _spans([("train_step", 0, 100, None), ("batch_input", 0, 10, "train_step"),
                 ("forward", 10, 40, "train_step"), ("resblock", 12, 30, "forward"),
                 ("backward", 40, 90, "train_step"), ("resblock", 50, 60, "backward"),
                 ("update", 90, 100, "train_step")])
    acts = [("enc", 2, 12, 1), ("fwd", 14, 40, 13), ("bwd", 42, 52, 41),
            ("recompute", 52, 62, 55), ("adam", 92, 99, 91)]
    r = spans.report(spans.Charged(sp, acts, (0, 100)))
    assert r["train_ms.batch_input"] == pytest.approx(1e3 * 10e-9)
    assert r["train_ms.forward"] == pytest.approx(1e3 * 26e-9)
    assert r["train_ms.backward"] == pytest.approx(1e3 * 20e-9)
    assert r["train_ms.recompute"] == pytest.approx(1e3 * 10e-9)
    assert r["train_ms.update"] == pytest.approx(1e3 * 7e-9)
    assert r["train_kernels.step"] == 5
    # gaps [0, 2) batch_input, [12, 14) forward, [40, 42) backward,
    # [62, 92) backward, [99, 100) update
    assert r["train_idle_ms.batch_input"] == pytest.approx(1e3 * 2e-9)
    assert r["train_idle_ms.forward"] == pytest.approx(1e3 * 2e-9)
    assert r["train_idle_ms.backward"] == pytest.approx(1e3 * 32e-9)
    assert r["train_idle_ms.update"] == pytest.approx(1e3 * 1e-9)


def test_activities_clipped_to_the_window():
    """An activity that crosses the window's edge counts its part inside."""
    sp = _spans([("unet", 0, 100, None)])
    ch = spans.Charged(sp, [("a", -10, 10, 1), ("b", 90, 120, 80), ("c", 130, 140, 85)],
                       (0, 100))
    assert [a[0] for a in ch.activities] == ["a", "b"]
    assert sum(map(ch.seconds, ch.activities)) == pytest.approx(20e-9)
    assert spans.report(ch)["unet_idle_pct"] == pytest.approx(80.0)


def test_no_spans_report_nothing():
    """A program without the tracer: no spans, so no span numbers."""
    assert spans.report(spans.Charged([], [("a", 0, 5, 1)], (0, 10))) == {"charged_pct": 0.0}
    assert spans.report(spans.Charged([], [], (0, 10))) == {}


def test_from_recording_moves_spans_onto_the_trace_clock():
    trace = pytest.importorskip("dynamicrafter_tpu_torch.utils.trace")
    with trace.recording() as rec:
        with trace.span("request"):
            with trace.span("unet"):
                pass
    got = [s for s in spans.from_recording(rec) if s.name != "gc"]
    assert [s.name for s in got] == ["request", "unet"]
    req, unet = got
    assert unet.parent == req.id
    assert req.start == rec.spans[0].start + rec.offset_ns
    assert req.start <= unet.start <= unet.end <= req.end
