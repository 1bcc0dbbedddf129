"""Stable Video Diffusion traffic: one client in a closed loop, one clip a
request, through `StableVideoDiffusionPipeline.sample`.

A request is one image made from the run's seed and the request's index
(the generation traffic's coarse blocks plus fine noise), its sampler
draw x_T and the noise of its conditioning latent (cond_aug times it is
added to the image before the encode). The weights are `weights.draw`'s
from the seed, every blend's mix factor then set by `set_blends`, on the
program's side and the reference's alike. Requests run back to back; the
first `max_clips` are made before the window opens. The window and
`clip_s` are the generation traffic's (`benchmark/traffic/generate.py`):
a request starts only where the window's mean so far says it will end
inside, and `clip_s` is the window's seconds over its clips.

Parameters (the cell's file): steps, frames, min_cfg and max_cfg (the
guidance of the first and the last frame), fps_id, motion_bucket_id,
cond_aug, max_clips (requests recorded for the check), check_clips,
check_calls, trace_clips, limits.

With `--trace 1` the window is the same; then `trace_clips` more requests
run under `torch.profiler` (device activity alone) with the program's
spans recorded (`utils/trace.py`), which the device metrics, the
breakdown and the span metrics read (`benchmark/metrics/spans.py`).

The check follows the program's trajectory, as the generation traffic's:
every UNet call's scaled input latent (the first z channels of the
conditional rows: x times c_in) and its output go to pinned host memory,
and the first call's whole arguments stay on the device. Once the window
has closed and the program is freed, the float32 reference
(`benchmark/reference/svd.py`) recomputes, for a sample of the finished
clips: the conditioning (image token, conditioning latent, vector; the
unconditional pass's zeros) against what the program fed its UNet; the
UNet on the program's inputs at a sample of steps (the first and the last
among them); every Euler step from the program's input and outputs to its
next input (and x_T's scaling before the first); and the decode of the
program's final latent against its frames, as the frames' RMS gap in pixel
units. The program's modules are imported in set-up: a program without
them fails there.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.flops import svd as svd_flops
from benchmark.metrics import spans as span_metrics
from benchmark.reference import svd as ref_svd
from benchmark.reference.layers import fp8_
from benchmark.traffic.generate import _gap_labeller


@dataclasses.dataclass
class Request:
    seed: int
    image: np.ndarray          # (1, H, W, 3) float32 in [-1, 1]
    x_T: np.ndarray            # (1, T, h, w, z) float32, N(0, 1)
    cond_noise: np.ndarray     # (1, H, W, 3) float32


def make_request(seed: int, index: int, p: dict, hw, lat) -> Request:
    """Request `index` of a run (a negative index is the warm-up's)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, index + 2**20]))
    h, w = hw
    coarse = rng.uniform(-1, 1, size=(h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
    image = np.clip(np.kron(coarse, np.ones((16, 16, 1), np.float32))[:h, :w]
                    + rng.normal(0, 0.1, size=(h, w, 3)).astype(np.float32), -1, 1)
    x_T = rng.standard_normal((1, p["frames"], *lat)).astype(np.float32)
    noise = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    return Request(int(rng.integers(0, 2**62)), image[None], x_T, noise)


def set_blends(sd: Dict[str, torch.Tensor], seed: int) -> None:
    """Every blend's mix factor, drawn from the seed away from 0: a sign and a
    magnitude from U(1, 3), so each blend weighs one branch 0.73 to 0.95 and
    the other the rest. At N(0, 0.02), as `weights.draw` gives, every blend
    is half and half, and a swapped blend or a lost temporal branch moves
    the output by less than the check's rounding."""
    names = [k for k in sd if k.endswith("mix_factor")]
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, 11]))
    values = rng.choice([-1.0, 1.0], size=len(names)) * rng.uniform(1.0, 3.0, size=len(names))
    for k, v in zip(names, values):
        sd[k] = torch.full_like(sd[k], float(v))


def _values(p: dict) -> Dict[str, float]:
    return {k: p[k] for k in ("fps_id", "motion_bucket_id", "cond_aug")}


def _sample_kwargs(p: dict, req: Request, steps: int) -> dict:
    return dict(frames=p["frames"], steps=steps, min_cfg=p["min_cfg"], max_cfg=p["max_cfg"],
                seed=req.seed, x_T=req.x_T, cond_noise=req.cond_noise, **_values(p))


def _latent(config: dict, hw):
    ddc = ref_svd.model_node(config)["first_stage_config"]["params"]["decoder_config"]["params"]
    f = 2 ** (len(ddc["ch_mult"]) - 1)
    return (hw[0] // f, hw[1] // f, ddc["z_channels"])


class Recorder:
    """Forward hooks on the UNet (called as unet(x, timesteps, context, y)).
    CUDA events time every call (`events`); with `spans` set, each call's
    host span goes there too. While a clip's buffers are set, every call's
    scaled latent (the first `z` channels of the conditional rows) and
    output go to pinned host buffers, and the first call also keeps its
    arguments on the device."""

    def __init__(self, unet, z: int, calls: int, clips: int, lat_shape, out_shape,
                 pin: bool, events: bool):
        self.z = z
        self.free = [{"x": torch.empty((calls, *lat_shape), dtype=torch.float32, pin_memory=pin),
                      "out": torch.empty((calls, *out_shape), dtype=unet.dtype, pin_memory=pin)}
                     for _ in range(clips)]
        self.clip: Optional[dict] = None
        self.events = [] if events else None
        self.spans: Optional[list] = None
        self.calls = 0
        self.handles = [unet.register_forward_pre_hook(self._pre),
                        unet.register_forward_hook(self._post)]

    def new_clip(self) -> Optional[dict]:
        self.clip = dict(self.free.pop(0), args=None, n=0) if self.free else None
        return self.clip

    def _pre(self, module, args):
        self._t = time.perf_counter()
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append([ev, None])

    def _post(self, module, args, output):
        self.calls += 1
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[-1][1] = ev
        if self.spans is not None:
            self.spans.append(("unet_call", self._t, time.perf_counter()))
        clip = self.clip
        if clip is None:
            return
        i = clip["n"]
        if i < len(clip["x"]):
            x = args[0]
            rows = x.shape[0] // 2
            clip["x"][i].copy_(x[rows:, ..., :self.z], non_blocking=True)
            clip["out"][i].copy_(output, non_blocking=True)
            if i == 0:
                clip["args"] = [a.detach().clone() for a in args]
        clip["n"] = i + 1

    def unet_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events or [] if b is not None]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class _RecordedTail(harness.TracedTail):
    """The harness's traced tail with the program's spans recorded inside it
    and its activities kept with their launch events."""

    def __enter__(self):
        from dynamicrafter_tpu_torch.utils import trace
        super().__enter__()
        self.rec = trace.recording()
        return self

    def __exit__(self, *exc):
        self.rec.close()
        prof = self.prof
        out = super().__exit__(*exc)
        self.activities = span_metrics.launched_activities(prof)
        return out


def program_factory(cell, device):
    """A factory that builds the port's pipeline once and hands the same
    one to every later run of this process (`benchmark/calibrate.py`)."""
    from dynamicrafter_tpu_torch.config import SVDConfig
    from dynamicrafter_tpu_torch.svd_pipeline import StableVideoDiffusionPipeline
    built = []

    def make():
        if not built:
            built.append(StableVideoDiffusionPipeline(SVDConfig(cell.config), device,
                                                      torch.bfloat16))
        return built[0]
    return make


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock,
        program=None, control: bool = False, fault=None) -> tuple:
    """One run of the cell. `program` replaces the port's pipeline (tests:
    the port at a tiny size); `fault(pipe)` plants a fault. With `control`
    the result also carries the control's readings of the same clips."""
    p, config = cell.params, cell.config
    hw = tuple(config["resolution"])
    lat = _latent(config, hw)
    if program is None:
        from dynamicrafter_tpu_torch.config import SVDConfig
        from dynamicrafter_tpu_torch.ops import flash_attention, kernels, small_attention
        from dynamicrafter_tpu_torch.svd_pipeline import StableVideoDiffusionPipeline
        clock.mark("imports")
        kernels.library()
        clock.mark("kernel library")
        built = kernels.build_seconds
        counters = {"K1": flash_attention.flash_fwd, "K2": small_attention.small_t_fwd_tmajor}
        make = lambda: StableVideoDiffusionPipeline(SVDConfig(config), device, torch.bfloat16)
    else:
        make, counters, built = program, {}, None
        clock.mark("imports")
    pipe = make()
    if fault is not None:
        fault(pipe)
    clock.mark("modules")
    shapes = ref_svd.param_shapes(config)
    sd = weights.draw(shapes, seed, device)
    set_blends(sd, seed)
    pipe.load_state_dict(sd)
    del sd
    clock.mark("weights")

    t, calls = p["frames"], p["steps"]
    warm = make_request(seed, -1, p, hw, lat)
    pipe.sample(warm.image, **_sample_kwargs(p, warm, 2))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    clock.mark("warm-up")
    rec = Recorder(pipe.unet, lat[2], calls, p["max_clips"], (1, t, *lat), (2, t, *lat),
                   cuda, cuda)
    reqs = [make_request(seed, i, p, hw, lat) for i in range(p["max_clips"])]
    clock.mark("check buffers and requests")

    print(f"setup {clock.total():.4f} s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in clock.parts.items())
        + ("" if built is None else f"; of the kernel library, nvcc build {built} s"))
    if cuda:
        print(f"clocks before the window: {harness.card_clocks()}")
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def request(i: int) -> Request:
        return reqs[i] if i < len(reqs) else make_request(seed, i, p, hw, lat)

    req_s, stages, finished, attempted, done = [], [], [], 0, 0
    rec.calls = 0
    gc_pauses = harness.GcPauses()
    t0 = time.perf_counter()
    with gc_pauses:
        while True:
            elapsed = time.perf_counter() - t0
            if attempted and (elapsed + elapsed / attempted > seconds if done
                              else elapsed > seconds):
                break
            req = request(attempted)
            attempted += 1
            recorded = rec.new_clip()
            timings: Dict[str, float] = {}
            c0 = time.perf_counter()
            try:
                out = pipe.sample(req.image, **_sample_kwargs(p, req, p["steps"]),
                                  timings=timings)
            except RuntimeError as e:
                print(f"request {attempted - 1} raised: {e}", file=sys.stderr)
                continue
            req_s.append(time.perf_counter() - c0)
            if not np.isfinite(out.videos).all():
                print(f"request {attempted - 1} has non-finite frames", file=sys.stderr)
                continue
            done += 1
            stages.append(timings)
            if recorded is not None:
                finished.append((recorded, req, out.videos[0, 0], out.latents[0, 0]))
    window_s = time.perf_counter() - t0
    rec.clip = None
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        print(f"clocks after the window: {harness.card_clocks()}")
    print(f"window {window_s:.4f} s: {done} clips of {attempted}, request seconds "
          + " ".join(f"{s:.4f}" for s in req_s) + f"; UNet calls {rec.calls}")
    print(gc_pauses.line())

    result = {"correct": False, "attempted": attempted, "failed": attempted - done}
    device_info = harness.device_info(torch, 1) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    device_info["memory_peak_bytes"] = int(peak)
    if trace:
        data = {"stages": stages, "unet_ms": rec.unet_ms(), "clips": done,
                "window_s": window_s, "config": config, "frames": t, "hw": hw,
                "steps": p["steps"]}
        if cuda:
            n_tail = p.get("trace_clips", 1)
            tail_reqs = [make_request(seed, attempted + i, p, hw, lat) for i in range(n_tail)]
            before = {k: f.launches for k, f in counters.items()}
            tiles = dict(getattr(counters.get("K2"), "launches_by_tiles", {}))
            rec.events = None
            with _RecordedTail(device) as tail:
                rec.spans = tail.spans.items
                for req in tail_reqs:
                    with tail.spans("clip"):
                        pipe.sample(req.image, **_sample_kwargs(p, req, p["steps"]))
            rec.spans = None
            tl = tail.timeline
            acts = tail.activities
            unet = ref_svd.model_node(config)["network_config"]["params"]
            data.update(
                timeline=tl, launches={k: f.launches - before[k] for k, f in counters.items()},
                attention=n_tail * p["steps"] * svd_flops.attention_launches(unet, 1, t, *lat[:2]),
                charged=span_metrics.Charged(span_metrics.from_recording(tail.rec), acts[1:-1],
                                             (acts[0][1], acts[-1][1])))
            data["span_report"] = span_metrics.report(data["charged"])
            k2 = getattr(counters.get("K2"), "launches_by_tiles", {})
            print("K2 launches by m16 tiles in the tail: "
                  f"{ {n: k2.get(n, 0) - tiles.get(n, 0) for n in k2} }")
            device_info["busy_s"] = sum(e - s for s, e in harness.busy_intervals(tl))
            device_info["window_s"] = tl.window[1] - tl.window[0]
            result["breakdown"] = {
                "device_ops": harness.top(harness.device_families(tl)),
                "idle_gaps": harness.top(harness.idle_gaps(tl, _gap_labeller(tl)))}
            print(f"traced tail: {n_tail} request(s), {tl.window[1] - tl.window[0]:.4f} s, "
                  f"device busy {device_info['busy_s']:.4f} s; launches {data['launches']}; "
                  f"spans {data['span_report']}")
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        ms = data["unet_ms"]
        if ms:
            print(f"UNet calls {len(ms)}: mean {statistics.mean(ms):.4f} ms, p95 "
                  f"{float(np.percentile(ms, 95)):.4f} ms")
    else:
        metrics = {}
        if done:
            metrics["clip_s"] = {"value": window_s / done, "unit": "s"}
        metrics["peak_gib"] = {"value": peak / 2**30, "unit": "GiB"}
        metrics["setup_s"] = {"value": clock.total(), "unit": "s"}
    result["metrics"] = metrics
    result["device"] = device_info

    rec.remove()
    del pipe, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check(cell, seed, device, shapes, finished, lat) if finished else {}
    print(f"checked in {time.perf_counter() - t_check:.2f} s, "
          f"{min(len(finished), p['check_clips'])} clip(s)")
    ok, checks = harness.judge(numbers, p["limits"])
    result["correct"] = bool(ok and done > 0 and result["failed"] == 0)
    if control and finished:
        result["control"] = check(cell, seed, device, shapes, finished, lat, control=True)
    return result, checks


# --- the check ----------------------------------------------------------------

def check(cell, seed: int, device, shapes, finished, lat,
          control: bool = False) -> Dict[str, float]:
    """The compared numbers, each the largest over the sampled clips: the
    program against the float32 reference, or with `control` the
    reference in the step below (fp8 modules, bf16 sampler arithmetic)
    against it."""
    p, config = cell.params, cell.config
    sd = weights.draw(shapes, seed, device)
    set_blends(sd, seed)
    ref = ref_svd.build(config, device, sd)
    low = fp8_(ref_svd.build(config, device, sd)) if control else None
    del sd
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, 7]))
    pick = sorted(rng.choice(len(finished), size=min(len(finished), p["check_clips"]),
                             replace=False).tolist())
    sig = ref.sigmas(p["steps"])
    scales = ref_svd.frame_scales(p["frames"], p["min_cfg"], p["max_cfg"])
    numbers: Dict[str, float] = {}
    worst = lambda k, v: numbers.__setitem__(k, max(numbers.get(k, 0.0), v))
    z = lat[2]
    n = p["steps"]
    with torch.no_grad():
        for ci in pick:
            rec_clip, req, frames, latents = finished[ci]
            x0, ts0, ctx, vec = rec_clip["args"]
            # conditioning: the reference's against what the program fed the UNet
            img = torch.as_tensor(req.image, device=device)
            noise = torch.as_tensor(req.cond_noise, device=device)
            want = ref.conditioning(img, noise, _values(p))
            if control:
                got = low.conditioning(img, noise, _values(p))
            else:
                got = (ctx[1:], x0[1:, 0, ..., z:], vec[1:])
                # the unconditional pass: zero image token and latent, the same vector
                uc = (ctx[:1].flatten(), x0[:1, ..., z:].flatten(), vec[:1].flatten())
                worst("conditioning", harness.rel_l2(
                    torch.cat(uc), torch.cat([0 * uc[0], 0 * uc[1], want[2].flatten()])))
                # every frame's latent is the first's
                worst("conditioning", harness.rel_l2(x0[1:, :, ..., z:],
                                                     want[1][:, None].expand_as(x0[1:, ..., z:])))
            worst("conditioning", max(harness.rel_l2(g, w) for g, w in zip(got, want)))
            # the UNet on the program's inputs
            xs = rec_clip["x"].to(device)                         # (calls, 1, T, h, w, z)
            outs = rec_clip["out"].to(device).float()              # (calls, 2, T, h, w, z)
            idx = sorted({0, n - 1, *rng.choice(n, size=max(0, p["check_calls"] - 2),
                                                replace=False).tolist()})
            for s in idx:
                c_noise = ref_svd.v_scaling(float(sig[s]))[3]
                xin = torch.cat([torch.cat([xs[s], xs[s]]), x0[..., z:].float()], dim=-1)
                ts = torch.full((2,), c_noise, device=device)
                args = (xin, ts, ctx.float(), vec.float())
                want_o = ref.unet(*args)
                got_o = low.unet(*args) if control else outs[s]
                worst("unet", harness.rel_l2(got_o, want_o))
            # every Euler step from the program's state to its next input
            worst("sampler_step", _steps(sig, scales, xs, outs, req, latents, device, control))
        # the decodes last, with the UNets and the conditioners freed: a float32
        # whole-clip decode of 25 frames at 576x1024 holds ~60 GiB at its peak
        for m in (ref, low):
            if m is not None:
                del m.model, m.conditioner
        gc.collect()              # the control's patched modules hold cycles
        if device.type == "cuda":
            torch.cuda.empty_cache()
        for ci in pick:
            _, _, frames, latents = finished[ci]
            zl = torch.as_tensor(latents, device=device)[None]
            want_f = ref.decode(zl)[0]
            got_f = low.decode(zl)[0] if control else torch.as_tensor(frames, device=device)
            worst("decode", harness.rms_gap(got_f, want_f))
            print(f"check: clip {ci} decode, frames' RMS {harness.rms_gap(want_f, 0 * want_f):.6g}, "
                  f"relative gap {harness.rel_l2(got_f, want_f):.6g}", file=sys.stderr)
    del ref, low
    return numbers


def _steps(sig, scales, xs, outs, req, latents, device, control: bool) -> float:
    """The largest gap over the clip's Euler steps: the state before each
    step is the recorded scaled latent over c_in; the step is the guider and
    Euler in float64 (bfloat16 for the control) from the recorded outputs."""
    n = len(sig) - 1
    state = lambda s: xs[s].double() / ref_svd.v_scaling(float(sig[s]))[2]
    x_T = torch.as_tensor(req.x_T, device=device).double()
    worst = harness.rel_l2(state(0), x_T * math.sqrt(1.0 + float(sig[0]) ** 2))
    final = torch.as_tensor(latents, device=device)[None]
    dt = torch.bfloat16 if control else torch.float64
    for s in range(n):
        c_skip, c_out, _, _ = ref_svd.v_scaling(float(sig[s]))
        x = state(s)
        d = outs[s].double() * c_out + x * c_skip
        step = lambda t_: ref_svd.euler_step(x.to(t_), d[0:1].to(t_), d[1:2].to(t_),
                                             sig[s], sig[s + 1], scales)
        got = step(dt)
        if control:
            want = step(torch.float64)
        else:
            want, got = got, (state(s + 1) if s + 1 < n else final)
        worst = max(worst, harness.rel_l2(got, want))
    return worst
