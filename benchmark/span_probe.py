"""Measurements of the program's spans (`dynamicrafter_tpu_torch/utils/trace.py`)
on the card, with the arithmetic of `benchmark/metrics/spans.py`. Not part
of a cell's run: nothing in `BENCHMARK.json` names it.

    python3 -m benchmark.span_probe tail <cell> <seed> <seconds> [--out f.json]
    python3 -m benchmark.span_probe cost gen|train <seed> <pairs> [--out f.json]
    python3 -m benchmark.span_probe clock
    python3 -m benchmark.span_probe host

`tail`: one run of the cell as `benchmark.run --trace 1` makes it, with the
spans recorded in the traced tail (opened after its first marker, closed
before its last) and the tail's launch events kept; prints the span numbers
(`spans.report`), the share of each hand-written kernel's launches inside its
wrapper's span, the device time by layer or phase and kernel family, and, for
the fine-tune, busy plus idle charged to the phases against the harness's
`loss_and_grads` spans.
`cost`: one clip of `i2v512.ddim50` or four micro-steps of `ft1024.bs1`,
recording off and on in turns in one process, under a CUDA-only profiler
between marker kernels and without one: seconds and `idle_pct` each side.
`clock`: 500 spans each around one small kernel launch under a CUDA-only
profiler: where each launch event falls in its span.
`host`: a span's host time with no recording open and with one, and the
clock reads it is made of (runs without a card).

The last line of stdout is one JSON object; `--out` writes it to a file too.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import threading  # noqa: E402
import timeit  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.metrics import spans  # noqa: E402

# each hand-written kernel's device name (a substring) and its wrapper's span
WRAPPERS = {"flash_fwd_tc_kernel<false>": "K1", "flash_fwd_tc_kernel<true>": "K3",
            "small_t_tc_kernel": "K2", "flash_bwd_dq": "K4a", "flash_bwd_dkv": "K4b",
            "flash_bwd_di": "di", "small_t_posmajor": "K5"}


def host_ns(n: int = 100000) -> dict:
    """Nanoseconds a call: a span off and on, and the reads it is made of."""
    from dynamicrafter_tpu_torch.utils import trace

    def one():
        with trace.span("x", a=1):
            pass

    out = {name: timeit.timeit(f, number=n) / n * 1e9
           for name, f in (("perf_counter_ns", time.perf_counter_ns), ("time_ns", time.time_ns),
                           ("get_native_id", threading.get_native_id),
                           ("get_ident", threading.get_ident), ("span_off", one))}
    with trace.recording():
        out["span_on"] = timeit.timeit(one, number=n) / n * 1e9
    return out


class RecordedTail(harness.TracedTail):
    """The harness's traced tail with the program's spans recorded inside
    it and its activities kept with their launch events."""
    last = None

    def __enter__(self):
        from dynamicrafter_tpu_torch.utils import trace
        super().__enter__()
        self.rec = trace.recording()
        return self

    def __exit__(self, *exc):
        self.rec.close()
        prof = self.prof
        out = super().__exit__(*exc)
        self.activities = spans.launched_activities(prof)
        RecordedTail.last = self
        return out


def tail(cell_name: str, seed: int, seconds: float) -> dict:
    import torch
    harness.TracedTail = RecordedTail
    cell = harness.load_cell(cell_name)
    traffic = harness.traffic_module(cell.entry["traffic"])
    result, _ = traffic.run(cell, seed=seed, seconds=seconds, trace=True,
                            device=torch.device("cuda", 0), clock=harness.SetupClock(T_START))
    t = RecordedTail.last
    acts = t.activities
    window = (acts[0][1], acts[-1][1])           # the markers' starts, as the harness reads them
    ch = spans.Charged(spans.from_recording(t.rec), acts[1:-1], window)
    rep = spans.report(ch)
    names = collections.Counter(s.name for s in ch.spans)
    out = {"cell": cell_name, "seed": seed, "window_s": (window[1] - window[0]) / 1e9,
           "metrics": result["metrics"], "correct": result["correct"],
           "device": result["device"], "report": rep, "spans": dict(names),
           "residual_ns": t.rec.residual_ns}
    inside = collections.Counter()
    by = collections.Counter()
    steps, calls = names["train_step"], max(names["unet"], 1)
    for a, o in zip(ch.activities, ch.owner):
        for key, span_name in WRAPPERS.items():
            if key in a[0]:
                owner = ch.by_id.get(o)
                inside[f"{span_name}:{'in' if owner and owner.name == span_name else 'out'}"] += 1
                break
        layer = ch.within(o, spans.LAYERS)
        if steps:
            phase = ch.within(o, spans.PHASES)
            where = ("none" if phase is None else phase.name) + ("/" + layer.name if layer else "")
            by[(where, harness.family(a[0]))] += ch.seconds(a) * 1e3 / steps
        elif ch.within(o, frozenset({"unet"})) is not None:
            by[("other" if layer is None else layer.name, harness.family(a[0]))] += (
                ch.seconds(a) * 1e3 / calls)
    out["kernel_in_wrapper"] = dict(inside)
    out["ms_by_layer_and_family"] = {f"{k}|{f}": round(v, 3) for (k, f), v in by.most_common(60)}
    layers = [rep[k] for k in rep if k.startswith("unet_ms.")]
    if layers:
        out["unet_ms_over_busy"] = sum(layers) / rep["unet_busy_ms"]
    if steps:
        charged = sum(rep[f"train_ms.{k}"] + rep[f"train_idle_ms.{k}"]
                      for k in ("batch_input", "forward", "backward"))
        lg = [e - s for name, s, e in t.timeline.spans if name == "loss_and_grads"]
        out["phases_ms"] = charged
        out["loss_and_grads_ms"] = 1e3 * sum(lg) / max(len(lg), 1)
        out["phases_over_loss_and_grads"] = charged / out["loss_and_grads_ms"]
    return out


def _workload(kind: str, seed: int, device):
    """`work(i)`: the i-th clip of `i2v512.ddim50` or four micro-steps of
    `ft1024.bs1`, on the cell's weights drawn from `seed`."""
    from benchmark import weights
    from benchmark.reference import model as ref_model
    if kind == "gen":
        from benchmark.traffic import generate as g
        cell = harness.load_cell("i2v512.ddim50")
        p = cell.params
        pipe = g.program_factory(cell, device)()
        pipe.config.perframe_ae = True
        pipe.net.load_state_dict(weights.draw(ref_model.param_shapes(cell.config), seed, device))
        hw = tuple(cell.config["resolution"])
        lat = g._latent(cell.config, hw)

        def work(i):
            req = g.make_request(seed, i, p, hw, lat)
            pipe.sample(req.prompts, g._video(req, p["frames"]),
                        **g._sample_kwargs(p, req, p["steps"]))
        return work
    from benchmark.traffic import finetune as f
    from dynamicrafter_tpu_torch.training.trainer import Draws, TrainConfig, Trainer
    cell = harness.load_cell("ft1024.bs1")
    p = cell.params
    pipe = f.program_factory(cell, device)()
    pipe.net.load_state_dict(weights.draw(ref_model.param_shapes(cell.config), seed, device))
    trainer = Trainer(pipe, f._train_config(cell.config, p, TrainConfig), train_resampler=True,
                      seed=seed)

    def work(i):
        for j in range(4):
            batch, d = f.make_batch(seed, 4 * i + j, p, cell.config, device)
            trainer.train_step(batch, Draws(**d))
    return work


def cost(kind: str, seed: int, pairs: int) -> dict:
    import torch
    from dynamicrafter_tpu_torch.utils import trace
    dev = torch.device("cuda", 0)
    work = _workload(kind, seed, dev)

    def side(i, record, profiled):
        marker = torch.zeros(1, dtype=torch.float64, device=dev)
        torch.cuda.synchronize(dev)
        if profiled:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            torch.cuda.synchronize(dev)
            marker.fill_(1.0)
        rec = trace.recording() if record else None
        t0 = time.perf_counter()
        work(i)
        torch.cuda.synchronize(dev)
        row = {"record": record, "profiled": profiled, "s": time.perf_counter() - t0}
        if rec is not None:
            rec.close()
            row["spans"] = len(rec.spans)
        if profiled:
            marker.fill_(2.0)
            torch.cuda.synchronize(dev)
            prof.stop()
            acts = spans.launched_activities(prof)
            window = (acts[0][1], acts[-1][1])
            gaps = spans.idle_gaps(acts[1:-1], window)
            row["idle_pct"] = 100.0 * sum(e - s for s, e in gaps) / (window[1] - window[0])
        return row

    work(1000)
    work(1001)
    rows = []
    for profiled in (True, False):
        for i in range(pairs):
            for record in ((False, True) if i % 2 == 0 else (True, False)):
                rows.append(side(10 * i + int(record) + 100 * int(profiled), record, profiled))
                print("ROW " + json.dumps(rows[-1]), flush=True)
    summary = {}
    for profiled in (True, False):
        for record in (False, True):
            sel = [r for r in rows if r["profiled"] == profiled and r["record"] == record]
            key = f"{'profiled' if profiled else 'plain'}_{'on' if record else 'off'}"
            summary[key] = {"s_median": statistics.median(r["s"] for r in sel)}
            if profiled:
                summary[key]["idle_pct_median"] = statistics.median(r["idle_pct"] for r in sel)
    return {"kind": kind, "seed": seed, "host_ns": host_ns(), "card": harness.card_clocks(),
            "rows": rows, "summary": summary}


def clock(n: int = 500) -> dict:
    import torch
    from dynamicrafter_tpu_torch.utils import trace
    dev = torch.device("cuda", 0)
    x = torch.zeros(1024, device=dev)
    x.add_(1.0)
    torch.cuda.synchronize(dev)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    with trace.recording() as rec:
        for _ in range(n):
            with trace.span("probe"):
                x.add_(1.0)
    torch.cuda.synchronize(dev)
    prof.stop()
    probes = [s for s in spans.from_recording(rec) if s.name == "probe"]
    acts = [a for a in spans.launched_activities(prof) if a[3] is not None][:n]
    head = sorted(a[3] - s.start for a, s in zip(acts, probes))
    tail_ = sorted(s.end - a[3] for a, s in zip(acts, probes))

    def q(v):
        return [v[0], statistics.median(v), v[-1]]
    return {"launch_after_span_start_ns": q(head), "span_end_after_launch_ns": q(tail_),
            "inside": sum(h >= 0 and t > 0 for h, t in zip(head, tail_)), "of": len(acts),
            "residual_ns": rec.residual_ns}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.span_probe")
    sub = p.add_subparsers(dest="what", required=True)
    t = sub.add_parser("tail")
    t.add_argument("cell")
    t.add_argument("seed", type=int)
    t.add_argument("seconds", type=float)
    c = sub.add_parser("cost")
    c.add_argument("kind", choices=("gen", "train"))
    c.add_argument("seed", type=int)
    c.add_argument("pairs", type=int)
    sub.add_parser("clock")
    sub.add_parser("host")
    for s in (t, c):
        s.add_argument("--out")
    args = p.parse_args(argv)
    for var, rel in {"TRITON_CACHE_DIR": "build/triton",
                     "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}.items():
        os.environ[var] = str(harness.ROOT / rel)
    if args.what == "tail":
        out = tail(args.cell, args.seed, args.seconds)
    elif args.what == "cost":
        out = cost(args.kind, args.seed, args.pairs)
    elif args.what == "clock":
        out = clock()
    else:
        out = host_ns()
    line = json.dumps(out)
    if getattr(args, "out", None):
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
