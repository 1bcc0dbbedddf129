"""Generation traffic: one client in a closed loop, one request at a time.

A request is `bs` clips: for each an image and a prompt, its initial
latent x_T and the VAE's encode noise, all made from the run's seed and the
request's index; the sampler's step noise is the stream of a CUDA
generator seeded with the request's own seed (the program draws it in
`pipeline.sample`, the reference draws it again). Requests run back to
back through `DynamiCrafterPipeline.sample`, the CLI's entry, from the
request to frames on the host. The first `max_clips` requests are made
before the window opens (a later one is made inside it). The window ends
at the last request boundary inside `--seconds`: a request starts only
where the window's mean so far says it will end inside. `clip_s` is the
window's seconds over the clips it completed.

Parameters (the cell's file): steps, sampler ("ddim" or "unipc", the two
the reference follows), solver_order and use_corrector (unipc), eta,
cfg_scale, spacing, guidance_rescale, fs, sequential_cfg, deepcache (N:
a whole UNet call every N steps, shallow calls from its cached feature
between; ddim), bs (clips a request), frames, tile, words (the least and
most words of a prompt), max_clips (requests recorded for the check),
check_clips (clips checked), check_calls, trace_clips (requests in the
traced tail), limits. The program and the reference read each from the
same file.

With `--trace 1` the window is the same; then `trace_clips` more
requests run under `torch.profiler` (device activity alone), which the
device metrics and the breakdown read. The times of the per-layer metrics
come from the window, without the profiler.

The check follows the program's own trajectory step by step: every UNet
call's input latent and output are copied to pinned host memory as the
window runs. Once the window has closed and the program is freed, the
float32 reference recomputes, for a sample of the finished clips drawn
from the seed: the conditioning (both prompts, both images, the first
frame's latent) against what the program fed its UNet; the UNet on the
program's inputs at a sample of steps (the first and the last among them;
a shallow call from the reference's own cache of its group's whole call on
the program's input); every sampler step from the program's input and
outputs to its next input; and the decode of the program's final latent
against its frames. Each is a relative L2 gap, but the decode's, which is
the frames' RMS gap in pixel units ([-1, 1]): with random weights the
frames' scale swings from seed to seed and the absolute gap does not.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.flops import attention as attn_flops
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference import model as ref_model
from benchmark.reference import unipc as ref_unipc
from benchmark.reference.layers import fp8_

SOT, EOT, CONTEXT = 49406, 49407, 77
WORDS = ("a", "the", "red", "small", "cat", "dog", "river", "city", "night", "sky",
         "walking", "running", "slowly", "camera", "pans", "over", "bright", "old",
         "forest", "boat", "waves", "snow", "falling", "light", "street", "people",
         "flowers", "wind", "mountain", "cloud", "smoke", "fire", "rain", "car")
SAMPLERS = ("ddim", "unipc")       # the samplers the reference follows


class Tokenizer:
    """The benchmark's own tokenizer: each word to a stable id below the
    end-of-text id, between start and end of text, zero-padded to 77."""

    def __call__(self, prompts: List[str]) -> np.ndarray:
        out = np.zeros((len(prompts), CONTEXT), dtype=np.int64)
        for r, p in enumerate(prompts):
            ids = [SOT] + [1 + zlib.crc32(w.encode()) % (SOT - 1) for w in p.split()]
            ids = ids[:CONTEXT - 1] + [EOT]
            out[r, :len(ids)] = ids
        return out


def validate(p: dict) -> None:
    """Refuse a cell the reference cannot follow, before anything runs."""
    if p["sampler"] not in SAMPLERS:
        raise ValueError(f"sampler {p['sampler']!r}: the reference follows {SAMPLERS} alone")
    n = p.get("deepcache", 1)
    if n > 1 and (p["sampler"] != "ddim" or p["steps"] % n):
        raise ValueError(f"deepcache {n} needs the ddim sampler and steps divisible by it")


@dataclasses.dataclass
class Request:
    seed: int
    prompts: List[str]
    images: np.ndarray         # (B, H, W, 3) float32 in [-1, 1]
    x_T: np.ndarray            # (B, T, h, w, z) float32
    encode_noise: np.ndarray   # (B * T, h, w, z) float32


def make_request(seed: int, index: int, p: dict, hw, lat) -> Request:
    """Request `index` of a run (a negative index is the warm-up's)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, index + 2**20]))
    lo, hi = p["words"]
    h, w = hw
    prompts, images = [], []
    for _ in range(p.get("bs", 1)):
        prompts.append(" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi + 1)))))
        coarse = rng.uniform(-1, 1, size=(h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
        images.append(np.clip(np.kron(coarse, np.ones((16, 16, 1), np.float32))[:h, :w]
                              + rng.normal(0, 0.1, size=(h, w, 3)).astype(np.float32), -1, 1))
    b, t = len(prompts), p["frames"]
    x_T = rng.standard_normal((b, t, *lat)).astype(np.float32)
    enc = rng.standard_normal((b * t, *lat)).astype(np.float32)
    return Request(int(rng.integers(0, 2**62)), prompts, np.stack(images), x_T, enc)


class Recorder:
    """Forward hooks on the UNet. CUDA events time every call (`events`);
    with `spans` set, each call's host span goes there too. While a clip's
    buffers are set, every call's input latent (the first `z` channels of
    the request's rows) and its output go to pinned host buffers, and the
    first `passes` calls also keep their whole arguments on the device."""

    def __init__(self, unet, z: int, passes: int, calls: int, clips: int, x_shape,
                 out_shape, pin: bool, events: bool):
        self.z, self.passes, self.rows = z, passes, x_shape[0]
        self.free = [{"x": torch.empty((calls, *x_shape), dtype=torch.float32, pin_memory=pin),
                      "out": torch.empty((calls, *out_shape), dtype=unet.dtype,
                                         pin_memory=pin)} for _ in range(clips)]
        self.clip: Optional[dict] = None
        self.events = [] if events else None
        self.spans: Optional[list] = None
        self.calls = 0
        self.handles = [unet.register_forward_pre_hook(self._pre, with_kwargs=True),
                        unet.register_forward_hook(self._post, with_kwargs=True)]

    def new_clip(self) -> Optional[dict]:
        """The buffers of the next request, None once every buffer is used."""
        self.clip = dict(self.free.pop(0), args=[], n=0) if self.free else None
        return self.clip

    def _pre(self, module, args, kwargs):
        self._t = time.perf_counter()
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append([ev, None])

    def _post(self, module, args, kwargs, output):
        self.calls += 1
        if self.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[-1][1] = ev
        if self.spans is not None:
            self.spans.append(("unet_call", self._t, time.perf_counter()))
        if isinstance(output, tuple):          # (output, DeepCache feature)
            output = output[0]
        clip = self.clip
        if clip is None:
            return
        i = clip["n"]
        if i < len(clip["x"]):
            x = args[0]
            clip["x"][i].copy_(x[:self.rows, ..., :self.z], non_blocking=True)
            clip["out"][i].copy_(output, non_blocking=True)
            if i < self.passes:
                clip["args"].append({k: v.detach().clone() for k, v in
                                     dict(kwargs, x=x).items() if torch.is_tensor(v)
                                     and k in ("x", "context_text", "context_img", "fs")})
        clip["n"] = i + 1

    def unet_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events or [] if b is not None]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def _latent(config: dict, hw):
    vae = ref_model.model_params(config)["first_stage_config"]["params"]
    f = 2 ** (len(vae["ddconfig"]["ch_mult"]) - 1)
    return (hw[0] // f, hw[1] // f, vae["embed_dim"])


def _sample_kwargs(p: dict, req: Request, steps: int) -> dict:
    return dict(steps=steps, cfg_scale=p["cfg_scale"], eta=p["eta"],
                timestep_spacing=p["spacing"], guidance_rescale=p["guidance_rescale"],
                fs=[p["fs"]] * len(req.prompts), seed=req.seed, x_T=req.x_T,
                encode_noise=req.encode_noise, sequential_cfg=p["sequential_cfg"],
                sampler=p["sampler"], solver_order=p.get("solver_order", 2),
                use_corrector=p.get("use_corrector", True),
                deepcache=p.get("deepcache", 1) if steps % p.get("deepcache", 1) == 0 else 1)


def _video(req: Request, frames: int) -> np.ndarray:
    b, h, w, c = req.images.shape
    return np.broadcast_to(req.images[:, None], (b, frames, h, w, c))


def _calls(p: dict):
    """(whole, shallow) UNet calls of one request."""
    per = 2 if p["sequential_cfg"] else 1
    n = p.get("deepcache", 1)
    return per * p["steps"] // n, per * (p["steps"] - p["steps"] // n)


def _attention(p: dict, config: dict, lat, requests: int) -> List[dict]:
    """Every attention launch of `requests` requests, from the geometry."""
    unet = ref_model.model_params(config)["unet_config"]["params"]
    b = p.get("bs", 1)
    rows = b if p["sequential_cfg"] else 2 * b
    whole, shallow = _calls(p)
    one = lambda sh: attn_flops.launches(unet, rows, p["frames"], lat[0], lat[1], shallow=sh)
    return requests * (whole * one(False) + shallow * one(True))


def program_factory(cell, device):
    """A factory that builds the port's pipeline once and hands the same
    one to every later run of this process (`benchmark/calibrate.py`)."""
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    built = []

    def make():
        if not built:
            built.append(DynamiCrafterPipeline(ModelConfig(cell.config["model"]), device,
                                               torch.bfloat16, tokenizer=Tokenizer()))
        return built[0]
    return make


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock,
        program=None, control: bool = False, fault=None) -> tuple:
    """One run of a generation cell. `program` replaces the port's modules
    (tests: the port at a tiny size); `fault(pipe)` plants a fault. With
    `control` the result also carries the control's readings of the same
    clips (`benchmark/calibrate.py`)."""
    p, config = cell.params, cell.config
    validate(p)
    hw = tuple(config["resolution"])
    lat = _latent(config, hw)
    if program is None:
        from dynamicrafter_tpu_torch.config import ModelConfig
        from dynamicrafter_tpu_torch.ops import flash_attention, kernels, small_attention
        from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
        clock.mark("imports")
        kernels.library()
        clock.mark("kernel library")
        built = kernels.build_seconds
        counters = {"K1": flash_attention.flash_fwd,
                    "K2": small_attention.small_t_fwd_tmajor,
                    "K5": small_attention.small_t_fwd}
        make = lambda: DynamiCrafterPipeline(ModelConfig(config["model"]), device,
                                             torch.bfloat16, tokenizer=Tokenizer())
    else:
        make, counters, built = program, {}, None
        clock.mark("imports")
    pipe = make()
    pipe.config.perframe_ae = True
    if fault is not None:
        fault(pipe)
    clock.mark("modules")
    shapes = ref_model.param_shapes(config)
    sd = weights.draw(shapes, seed, device)
    pipe.net.load_state_dict(sd, strict=True)
    del sd
    clock.mark("weights")

    t, b = p["frames"], p.get("bs", 1)
    passes = 2 if p["sequential_cfg"] else 1          # UNet calls a step
    rows = b if p["sequential_cfg"] else 2 * b        # rows of a UNet call
    calls = p["steps"] * passes
    warm = make_request(seed, -1, p, hw, lat)
    # two steps, or one DeepCache group of whole and shallow calls
    pipe.sample(warm.prompts, _video(warm, t),
                **_sample_kwargs(p, warm, max(2, p.get("deepcache", 1))))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    clock.mark("warm-up")
    rec = Recorder(pipe.unet, lat[2], passes, calls, p["max_clips"], (b, t, *lat),
                   (rows, t, *lat), cuda, cuda)
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
                out = pipe.sample(req.prompts, _video(req, t),
                                  **_sample_kwargs(p, req, p["steps"]), timings=timings)
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
                finished.append((recorded, req, out.videos[:, 0], out.latents[:, 0]))
    window_s = time.perf_counter() - t0
    rec.clip = None
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        print(f"clocks after the window: {harness.card_clocks()}")
    window_calls = rec.calls
    print(f"window {window_s:.4f} s: {done} requests of {attempted} ({done * b} clips), "
          "request seconds " + " ".join(f"{s:.4f}" for s in req_s)
          + f"; UNet calls {window_calls}")
    print(gc_pauses.line())

    result = {"correct": False, "attempted": attempted, "failed": attempted - done}
    device_info = harness.device_info(torch, 1) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    device_info["memory_peak_bytes"] = int(peak)
    if trace:
        whole, shallow = _calls(p)
        data = {"stages": stages, "unet_ms": rec.unet_ms(), "clips": done * b,
                "window_s": window_s, "config": config, "frames": t, "hw": hw,
                "passes_per_clip": whole * rows // b, "shallow_passes_per_clip": shallow * rows // b}
        if cuda:
            n_tail = p.get("trace_clips", 1)
            tail_reqs = [make_request(seed, attempted + i, p, hw, lat) for i in range(n_tail)]
            before = {k: f.launches for k, f in counters.items()}
            rec.events = None
            with harness.TracedTail(device) as tail:
                rec.spans = tail.spans.items
                for req in tail_reqs:
                    with tail.spans("clip"):
                        pipe.sample(req.prompts, _video(req, t),
                                    **_sample_kwargs(p, req, p["steps"]))
            rec.spans = None
            tl = tail.timeline
            data.update(timeline=tl, attention=_attention(p, config, lat, n_tail),
                        launches={k: f.launches - before[k] for k, f in counters.items()})
            device_info["busy_s"] = sum(e - s for s, e in harness.busy_intervals(tl))
            device_info["window_s"] = tl.window[1] - tl.window[0]
            result["breakdown"] = {
                "device_ops": harness.top(harness.device_families(tl)),
                "idle_gaps": harness.top(harness.idle_gaps(tl, _gap_labeller(tl)))}
            print(f"traced tail: {n_tail} request(s), {tl.window[1] - tl.window[0]:.4f} s, "
                  f"device busy {device_info['busy_s']:.4f} s; launches {data['launches']}")
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
            metrics["clip_s"] = {"value": window_s / (done * b), "unit": "s"}
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
          f"{min(len(finished) * b, p['check_clips'])} clip(s)")
    ok, checks = harness.judge(numbers, cell.params["limits"])
    result["correct"] = bool(ok and done > 0 and result["failed"] == 0)
    if control and finished:
        result["control"] = check(cell, seed, device, shapes, finished, lat, control=True)
    return result, checks


def _gap_labeller(tl):
    clips = sorted((s, e) for n, s, e in tl.spans if n == "clip")
    unets = sorted((s, e) for n, s, e in tl.spans if n == "unet_call")

    def label(t: float) -> str:
        if any(s <= t < e for s, e in unets):
            return "unet_call"
        for s, e in clips:
            if s <= t < e:
                inside = [u for u in unets if s <= u[0] < e]
                if not inside or t < inside[0][0]:
                    return "conditioning"
                if t >= inside[-1][1]:
                    return "decode"
                return "sampler_between_calls"
        return "between_clips"
    return label


# --- the check ----------------------------------------------------------------

def _passes(rec_clip: dict, sequential: bool, b: int, r: int):
    """The program's UNet arguments of clip row r in each CFG pass (uncond,
    cond): x (1, T, h, w, 2z), context_text, context_img, fs."""
    row = lambda d, i: {k: v[i:i + 1] for k, v in d.items()}
    if sequential:
        return row(rec_clip["args"][0], r), row(rec_clip["args"][1], r)
    a = rec_clip["args"][0]
    return row(a, r), row(a, b + r)


def _row_outputs(outs, sequential: bool, b: int, r: int):
    """Row r's outputs in a one-clip layout: (calls, 2, ...) batched (uncond,
    cond) or (calls, 1, ...) sequential."""
    if sequential:
        return outs[:, r:r + 1]
    return torch.stack([outs[:, r], outs[:, b + r]], dim=1)


def check(cell, seed: int, device, shapes, finished, lat,
          control: bool = False) -> Dict[str, float]:
    """The compared numbers, each the largest over the sampled clips: the
    program against the float32 reference, or with `control` the
    reference in the step below (fp8 modules, bf16 sampler arithmetic)
    against it."""
    p, config = cell.params, cell.config
    params = ref_model.model_params(config)
    sd = weights.draw(shapes, seed, device)
    ref = ref_model.build(config, device, sd)
    low = fp8_(ref_model.build(config, device, sd)) if control else None
    del sd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = p.get("bs", 1)
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, 7]))
    pick = sorted(rng.choice(len(finished) * b, size=min(len(finished) * b, p["check_clips"]),
                             replace=False).tolist())
    sched = ref_diffusion.schedule(params)
    steps = ref_diffusion.ddim_steps(sched, p["spacing"], p["steps"],
                                     p["eta"] if p["sampler"] == "ddim" else 0.0)
    numbers: Dict[str, float] = {}
    worst = lambda k, v: numbers.__setitem__(k, max(numbers.get(k, 0.0), v))
    tok = Tokenizer()
    seq = p["sequential_cfg"]
    per = 2 if seq else 1
    n_dc = p.get("deepcache", 1)
    tile = p.get("tile", 64)
    z = lat[2]
    with torch.no_grad():
        for pick_i in pick:
            ci, r = divmod(pick_i, b)
            rec_clip, req, frames, latents = finished[ci]
            uc, c = _passes(rec_clip, seq, b, r)
            # conditioning: the reference's against what the program fed the UNet
            tokens = torch.as_tensor(tok([req.prompts[r], ""]), device=device)
            img = torch.as_tensor(req.images[r], device=device)[None]
            imgs = torch.cat([img, torch.zeros_like(img)])
            enc_noise = torch.as_tensor(req.encode_noise[r * p["frames"]][None], device=device)
            want = {"text": ref.embed_text(tokens), "image": ref.embed_image(imgs),
                    "latent": ref.encode(img, enc_noise)}
            if control:
                got = {"text": low.embed_text(tokens), "image": low.embed_image(imgs),
                       "latent": low.encode(img, enc_noise)}
            else:
                got = {"text": torch.cat([c["context_text"], uc["context_text"]]),
                       "image": torch.cat([c["context_img"], uc["context_img"]]),
                       "latent": c["x"][:, 0, ..., z:]}
            worst("conditioning", max(harness.rel_l2(got[k], want[k]) for k in want))
            # the UNet on the program's inputs
            xs = rec_clip["x"][:, r].to(device)
            outs = _row_outputs(rec_clip["out"], seq, b, r).to(device).float()
            n = len(steps)
            idx = sorted({0, n - 1, *rng.choice(n, size=max(0, p["check_calls"] - 2),
                                                replace=False).tolist()})
            for s in idx:
                for k, args in enumerate((uc, c)):
                    def run_ref(m, step):
                        x = torch.cat([xs[step * per][None], args["x"][..., z:]], dim=-1)
                        ts = torch.full((1,), steps[step].t, dtype=torch.long, device=device)
                        return x, ts, dict(context_text=args["context_text"],
                                           context_img=args["context_img"], fs=args["fs"])

                    def ref_out(m):
                        x, ts, kw = run_ref(m, s)
                        if s % n_dc == 0:
                            return m.unet(x, ts, **kw).float()
                        # a shallow call: from the cache of its group's whole call
                        xg, tg, kwg = run_ref(m, s - s % n_dc)
                        cache = m.unet(xg, tg, **kwg, return_cache=True)[1]
                        return m.unet(x, ts, **kw, cache=cache).float()
                    want_o = ref_out(ref)
                    got_o = ref_out(low) if control else outs[s * per + (k if seq else 0)][
                        0 if seq else k]
                    worst("unet", harness.rel_l2(got_o, want_o.reshape(got_o.shape)))
            # every sampler step from the program's state to its next input
            worst("sampler_step", _steps(p, params, steps, xs, outs, req, latents[r], device,
                                         control, r))
            # the decode of the program's latent
            zl = torch.as_tensor(latents[r], device=device)
            want_f = ref.decode(zl, tile)
            got_f = (low.decode(zl, tile) if control
                     else torch.as_tensor(frames[r], device=device))
            # the gap in pixel units: the absolute gap is steady from seed to
            # seed, the frames' own scale (and so a relative gap) is not
            worst("decode", harness.rms_gap(got_f, want_f))
            print(f"check: clip {ci}.{r} decode, frames' RMS "
                  f"{harness.rms_gap(want_f, 0 * want_f):.6g}, "
                  f"relative gap {harness.rel_l2(got_f, want_f):.6g}", file=sys.stderr)
    del ref, low
    return numbers


def _steps(p, params, steps, xs, outs, req, latents, device, control: bool, r: int) -> float:
    """The largest gap over clip row r's sampler steps (see `check`)."""
    seq = p["sequential_cfg"]
    per = 2 if seq else 1
    n = len(steps)
    if p["sampler"] == "unipc":
        return ref_unipc.worst_step(p, params, xs, outs, latents, device, control)
    gen = torch.Generator(device=device).manual_seed(req.seed)
    shape = (len(req.prompts), *xs.shape[1:])
    final = torch.as_tensor(latents, device=device)[None]
    worst = 0.0
    dt = torch.bfloat16 if control else torch.float64
    for s in range(n):
        noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)[r:r + 1]
        if seq:
            o_uc, o_c = outs[s * 2][0:1], outs[s * 2 + 1][0:1]
        else:
            o_uc, o_c = outs[s][0:1], outs[s][1:2]
        x = xs[s * per][None]
        v = ref_diffusion.cfg(o_uc.to(dt), o_c.to(dt), p["cfg_scale"], p["guidance_rescale"])
        got = ref_diffusion.ddim_step(x.to(dt), v, steps[s], noise.to(dt))
        if control:
            want = ref_diffusion.ddim_step(x.double(), ref_diffusion.cfg(
                o_uc.double(), o_c.double(), p["cfg_scale"], p["guidance_rescale"]),
                steps[s], noise.double())
        else:
            want, got = got, (xs[(s + 1) * per][None] if s + 1 < n else final)
        worst = max(worst, harness.rel_l2(got, want))
    return worst
