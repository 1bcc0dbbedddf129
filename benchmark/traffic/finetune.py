"""Fine-tuning traffic: the trainer's micro-steps back to back, on batches
made on the device from the seed.

Micro-step i takes a batch (a clip of `frames` frames at the
configuration's resolution, smooth random values in [-1, 1]; a prompt of
random words; an fs) and its draws (timestep, diffusion and VAE noise, the
CFG-dropout uniform, the conditioning frame), all from a CUDA generator
seeded from (seed, i): every micro-step's rows differ. Set-up builds one
`Trainer` (the recipe of the configuration's `training` node: bf16
autocast, per-layer checkpointing, accumulation, no EMA) and drives it
through micro-steps 0-2 with the window's own call and batches: they warm
every shape (an AdamW update among them) and give what the check compares
first. The window then runs micro-steps 3, 4, ... and ends at the last
micro-step boundary inside `--seconds`, in `torch.cuda.synchronize()`.
With `--trace 1` the window is the same; then `trace_steps` more
micro-steps run under `torch.profiler` (device activity alone) for the
device metrics and the breakdown; the per-layer times come from the
window. After the window (and the tail) the same trainer finishes its
accumulation window untimed and takes two more micro-steps through the
same call, an accumulation and an update: the late pair the check
compares second.

The check: the float32 reference (`benchmark/reference/training.py`;
under a bf16 recipe its products read the trained weights rounded to
bfloat16, as autocast reads the program's master weights) follows
micro-steps 0-2 from the same weights, batches and draws, and the late
pair from the program's own state before it (its weights and AdamW
moments, copied to the host; the reference cannot work out the window's
steps again in less time than the window). Compared, each as the worst
leaf: the norm of each trained tensor's first gradient, as the optimizer
holds it after one micro-step (`grad`; `grad_late` for the pair's first),
and the norm of each tensor's change over the three micro-steps (one
AdamW update; `change`) and over the pair (`change_late`). The loss of
each micro-step (relative gap) is printed and read as `loss` over the
micro-steps before the first update; the cell's file gives it no limit:
with random weights the UNet's prediction is small beside the v target,
so the loss barely moves with it, and neither the control nor a fault
separates from sound runs there. A leaf's gap is measured against the
larger of its own reference norm and the median leaf's. Leaves whose
reference gradient (at micro-step 0, or at the pair's first) is under a
thousandth of the median leaf's (a bias before a norm: round-off alone
moves them under Adam) are left out of that stage's numbers.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import harness, weights
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference import model as ref_model
from benchmark.reference import training as ref_training
from benchmark.reference.layers import fp8_
from benchmark.traffic.generate import WORDS, Tokenizer

CHECK_STEPS = 3


def _model_node(config: dict) -> dict:
    node = dict(config["model"])
    node["params"] = {**node["params"], **config["training"]["model_params"]}
    return node


def make_batch(seed: int, i: int, p: dict, config: dict, device):
    """(batch, draws) of micro-step i: tensors on `device`."""
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed % 2**63, i, 11]).generate_state(1)[0]))
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, i, 12]))
    t = p["frames"]
    h, w = config["resolution"]
    coarse = torch.rand((t, 3, h // 16, w // 16), generator=gen, device=device) * 2 - 1
    video = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    video = video.permute(0, 2, 3, 1)[None].contiguous()
    lo, hi = p["words"]
    prompt = " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi + 1))))
    tokens = torch.as_tensor(Tokenizer()([prompt]), device=device)
    fs = torch.as_tensor([int(rng.integers(p["fs"][0], p["fs"][1] + 1))], device=device)
    vae = ref_model.model_params(config)["first_stage_config"]["params"]
    f = 2 ** (len(vae["ddconfig"]["ch_mult"]) - 1)
    lat = (h // f, w // f, vae["embed_dim"])
    n_t = ref_model.model_params(config).get("timesteps", 1000)
    kw = dict(generator=gen, device=device)
    draws = {"t": torch.randint(0, n_t, (1,), **kw),
             "noise": torch.randn((1, t, *lat), **kw),
             "enc_noise": torch.randn((t, *lat), **kw),
             "uniform": torch.rand((1,), **kw),
             "cond_idx": torch.randint(0, t, (1,), **kw)}
    return {"video": video, "tokens": tokens, "fs": fs}, draws


def _train_config(config: dict, p: dict, TrainConfig):
    tr = config["training"]
    mp = {**ref_model.model_params(config), **tr["model_params"]}
    return TrainConfig(
        learning_rate=tr["base_learning_rate"], grad_clip=tr["gradient_clip_val"],
        accumulate_grad_batches=tr["accumulate_grad_batches"],
        use_ema=mp.get("use_ema", False), uncond_prob=mp.get("uncond_prob", 0.05),
        rand_cond_frame=mp.get("rand_cond_frame", True), loss_type="l2",
        parameterization=mp.get("parameterization", "v"), bf16=p.get("bf16", True))


class _Timer:
    """CUDA events around a bound method of an object, per call, while
    `on`; with `spans` set, each call's host span goes there too."""

    def __init__(self, obj, name: str):
        self.events: List[list] = []
        self.on, self.spans = True, None
        inner = getattr(obj, name)

        def timed(*a, **k):
            if not self.on:
                return inner(*a, **k)
            t0 = time.perf_counter()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **k)
            end.record()
            self.events.append([start, end])
            if self.spans is not None:
                self.spans.append((name, t0, time.perf_counter()))
            return out
        setattr(obj, name, timed)

    def ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events]


def program_factory(cell, device):
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    return lambda: DynamiCrafterPipeline.for_training(
        ModelConfig(_model_node(cell.config)), device, frozen_dtype=torch.bfloat16,
        tokenizer=Tokenizer(), train_resampler=True)


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock,
        program=None, control: bool = False, fault=None) -> tuple:
    """One run of a fine-tuning cell. `program` builds the pipeline (tests:
    the port at a tiny size); `fault(trainer)` plants a fault (tests)."""
    from dynamicrafter_tpu_torch.training.trainer import Draws, TrainConfig, Trainer
    p, config = cell.params, cell.config
    cuda = device.type == "cuda"
    counters, built = {}, None
    if program is None:
        from dynamicrafter_tpu_torch.ops import flash_attention as fa
        from dynamicrafter_tpu_torch.ops import kernels, small_attention
        clock.mark("imports")
        kernels.library()
        built = kernels.build_seconds
        clock.mark("kernel library")
        counters = {"K3": fa.flash_fwd_lse, "K4a": fa.flash_bwd_dq, "K4b": fa.flash_bwd_dkv,
                    "di": fa.flash_bwd_di, "K2": small_attention.small_t_fwd_tmajor,
                    "K1": fa.flash_fwd}
        program = program_factory(cell, device)
    else:
        clock.mark("imports")
    pipe = program()
    clock.mark("modules")
    shapes = ref_model.param_shapes(config)
    sd = weights.draw(shapes, seed, device)
    pipe.net.load_state_dict(sd, strict=True)
    del sd
    trainer = Trainer(pipe, _train_config(config, p, TrainConfig), train_resampler=True, seed=seed)
    if fault is not None:
        fault(trainer)
    clock.mark("weights")

    # micro-steps 0-2: the warm-up, read for the check
    def step(i):
        batch, d = make_batch(seed, i, p, config, device)
        return trainer.train_step(batch, Draws(**d))

    names = list(trainer.params)
    acc_norms = lambda: _acc_norms(trainer, names)
    before = [t.detach().clone() for t in trainer.params.values()]
    losses, first_grad = [], None
    t_steps = []
    for i in range(CHECK_STEPS):
        s0 = time.perf_counter()
        losses.append(float(step(i)["loss"]))
        t_steps.append(time.perf_counter() - s0)
        if i == 0:
            first_grad = acc_norms()
    change = ref_training.leaf_norms(
        [a.detach() - b for a, b in zip(trainer.params.values(), before)]).cpu()
    del before
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    clock.mark("warm-up")
    print(f"setup {clock.total():.4f} s: " + ", ".join(
        f"{k} {v:.4f}" for k, v in clock.parts.items())
        + ("" if built is None else f"; of the kernel library, nvcc build {built} s")
        + "; warm-up micro-steps " + " ".join(f"{s:.4f}" for s in t_steps))

    timers = [_Timer(trainer, "loss_and_grads"), _Timer(trainer.opt, "update")] if cuda else []
    if cuda:
        print(f"clocks before the window: {harness.card_clocks()}")
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    est = statistics.median(t_steps[1:])
    n, step_s = 0, []
    gc_pauses = harness.GcPauses()
    t0 = time.perf_counter()
    with gc_pauses:
        while n == 0 or time.perf_counter() - t0 + est <= seconds:
            s0 = time.perf_counter()
            step(CHECK_STEPS + n)
            step_s.append(time.perf_counter() - s0)
            n += 1
        if cuda:
            torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        print(f"clocks after the window: {harness.card_clocks()}")
    print(f"window {window_s:.4f} s: {n} micro-steps, {window_s / n:.4f} s each; host seconds "
          "a micro-step " + " ".join(f"{x:.4f}" for x in step_s))
    print(gc_pauses.line())
    for tm in timers:
        tm.on = False
    nxt = CHECK_STEPS + n

    # a micro-step that raises ends the run: no result line
    result = {"correct": False, "attempted": n, "failed": 0}
    dev_info = harness.device_info(torch, 1) if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    dev_info["memory_peak_bytes"] = int(peak)
    if trace:
        data = {"fwd_bwd_ms": timers[0].ms() if timers else [],
                "adamw_ms": timers[1].ms() if timers else [],
                "steps": n, "window_s": window_s,
                "config": config, "frames": p["frames"], "hw": tuple(config["resolution"])}
        if cuda:
            n_tail = p.get("trace_steps", 4)
            start = {k: f.launches for k, f in counters.items()}
            with harness.TracedTail(device) as tail:
                for tm in timers:
                    tm.on, tm.spans = True, tail.spans.items
                for i in range(n_tail):
                    step(nxt + i)
            for tm in timers:
                tm.on = False
            nxt += n_tail
            tl = tail.timeline
            data.update(timeline=tl, trace_steps=n_tail,
                        launches={k: f.launches - start[k] for k, f in counters.items()})
            dev_info["busy_s"] = sum(e - s for s, e in harness.busy_intervals(tl))
            dev_info["window_s"] = tl.window[1] - tl.window[0]
            result["breakdown"] = {
                "device_ops": harness.top(harness.device_families(tl)),
                "idle_gaps": harness.top(harness.idle_gaps(tl, _gap_labeller(tl)))}
            print(f"traced tail: {n_tail} micro-steps, {tl.window[1] - tl.window[0]:.4f} s, "
                  f"device busy {dev_info['busy_s']:.4f} s; launches {data['launches']}")
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"train_step_s": {"value": window_s / n, "unit": "s"},
                   "peak_gib": {"value": peak / 2**30, "unit": "GiB"},
                   "setup_s": {"value": clock.total(), "unit": "s"}}
    result["metrics"] = metrics
    result["device"] = dev_info

    # the late pair: an accumulation and an update after the window, from
    # the state the window left (its accumulation window finished first)
    while trainer.opt.mini_step != 0:
        step(nxt)
        nxt += 1
    state = trainer.state_dict()
    opt_state = state["optimizer"]["state"]
    host = lambda x: x.detach().to("cpu", copy=True)
    late = {"index": nxt, "weights": [host(state["weights"][k]) for k in names],
            "adam_steps": int(opt_state[0]["step"]) if opt_state else 0,
            "m": [host(opt_state[i]["exp_avg"]) for i in range(len(names))] if opt_state else None,
            "v": [host(opt_state[i]["exp_avg_sq"]) for i in range(len(names))] if opt_state
            else None}
    del state, opt_state
    late_losses = [float(step(nxt)["loss"])]
    late_grad = acc_norms()
    late_losses.append(float(step(nxt + 1)["loss"]))
    late_change = ref_training.leaf_norms(
        [a.detach() - b.to(a.device) for a, b in zip(trainer.params.values(),
                                                      late["weights"])]).cpu()

    del trainer, pipe, timers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    program_side = {"loss": losses, "grad": first_grad, "change": change,
                    "late_loss": late_losses, "grad_late": late_grad,
                    "change_late": late_change}
    numbers = check(cell, seed, device, shapes, program_side, names, late)
    print(f"checked in {time.perf_counter() - t_check:.2f} s; program losses "
          + " ".join(f"{x:.6f}" for x in losses) + f"; late pair at micro-step {nxt}, after "
          f"{late['adam_steps']} AdamW updates, losses "
          + " ".join(f"{x:.6f}" for x in late_losses))
    ok, checks = harness.judge(numbers, p["limits"])
    result["correct"] = bool(ok and n > 0)
    if control:
        result["control"] = check(cell, seed, device, shapes, None, names, late, control=True)
    return result, checks


def _acc_norms(trainer, names) -> torch.Tensor:
    """Leaf norms of the gradient the optimizer holds (zeros where it holds
    none), read through the trainer's state."""
    acc = trainer.state_dict()["acc_grads"]
    if acc is None:
        return torch.zeros(len(names), dtype=torch.float64)
    return ref_training.leaf_norms([acc[k] for k in names]).cpu()


def _gap_labeller(tl):
    spans = sorted((s, e, n) for n, s, e in tl.spans if n in ("loss_and_grads", "update"))

    def label(t: float) -> str:
        for s, e, n in spans:
            if s <= t < e:
                return n
        return "between_calls"
    return label


def reference_steps(cell, seed: int, device, shapes, late: dict, control: bool = False):
    """The reference's readings: losses, first-gradient leaf norms and change
    leaf norms over micro-steps 0-2 (`loss`, `grad`, `change`), then the
    same over the late pair from the program's state `late` (`late_loss`,
    `grad_late`, `change_late`)."""
    p, config = cell.params, cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = weights.draw(shapes, seed, device)
    ref = ref_model.build(config, device, sd)
    del sd
    if control:
        fp8_(ref)
    params = ref_training.trainable(ref)
    for t in params.values():
        t.requires_grad_(True)
    tr = config["training"]
    opt = ref_training.AdamW(params, tr["base_learning_rate"], tr["accumulate_grad_batches"],
                             tr["gradient_clip_val"])
    sched = ref_diffusion.schedule(ref_model.model_params(config))
    uncond = {**ref_model.model_params(config), **tr["model_params"]}.get("uncond_prob", 0.05)
    null = torch.as_tensor(Tokenizer()([""]), device=device)

    def micro_steps(first: int, count: int):
        """(losses, the first micro-step's gradient leaf norms, the change)."""
        before = [t.detach().clone() for t in params.values()]
        losses, grad = [], None
        for i in range(first, first + count):
            batch, d = make_batch(seed, i, p, config, device)
            with ref_training.bf16_products((ref.unet, ref.image_proj_model), p.get("bf16", True)):
                loss = ref_training.micro_step_loss(ref, batch, d, sched, uncond, null)
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: (g if g is not None else torch.zeros_like(t))
                     for (n, t), g in zip(params.items(), grads)}
            losses.append(float(loss.detach()))
            if grad is None:
                grad = ref_training.leaf_norms(list(grads.values())).cpu()
            opt.update(grads)
            del grads, loss
        change = ref_training.leaf_norms(
            [a.detach() - b for a, b in zip(params.values(), before)]).cpu()
        return losses, grad, change

    out = dict(zip(("loss", "grad", "change"), micro_steps(0, CHECK_STEPS)))
    with torch.no_grad():
        for t, w in zip(params.values(), late["weights"]):
            t.copy_(w)
        opt.load(late["m"], late["v"], late["adam_steps"])
    out.update(zip(("late_loss", "grad_late", "change_late"), micro_steps(late["index"], 2)))
    del ref, opt, params
    gc.collect()
    return out


def _worst_leaf(got: torch.Tensor, want: torch.Tensor, keep) -> tuple:
    """The largest gap of a kept leaf's norm, over the larger of the
    reference's norm of that leaf and of the median kept leaf, and its
    index."""
    floor = torch.maximum(want, want[keep].median())
    gap = torch.where(keep, (got - want).abs() / floor, torch.zeros_like(want))
    i = int(gap.argmax())
    return float(gap[i]), i


def check(cell, seed: int, device, shapes, program_side, names, late, control: bool = False):
    """The compared numbers: the program's (or with `control`, the fp8
    reference's) readings against the float32 reference's."""
    want = reference_steps(cell, seed, device, shapes, late)
    if control:
        program_side = reference_steps(cell, seed, device, shapes, late, control=True)
    numbers = {}
    for grad, change in (("grad", "change"), ("grad_late", "change_late")):
        # leaves the reference's gradient leaves all but unmoved (round-off
        # alone moves them under Adam) count in neither number of the stage
        moved = want[grad] >= 1e-3 * want[grad].median()
        skipped = [n for n, k in zip(names, moved.tolist()) if not k]
        if skipped:
            print(f"check: {len(skipped)} leaves with a reference gradient under a thousandth "
                  f"of the median leaf's left out of {grad} and {change}: {skipped[:6]}",
                  file=sys.stderr)
        for k in (grad, change):
            numbers[k], i = _worst_leaf(program_side[k], want[k], moved)
            print(f"check: {k}'s worst leaf {names[i]}: norm {float(program_side[k][i]):.6g}, "
                  f"the reference's {float(want[k][i]):.6g}, the median kept leaf's "
                  f"{float(want[k][moved].median()):.6g}", file=sys.stderr)
    gaps = [abs(a - b) / abs(b) for a, b in zip(program_side["loss"] + program_side["late_loss"],
                                                want["loss"] + want["late_loss"])]
    before_update = cell.config["training"]["accumulate_grad_batches"]
    print("check: reference losses " + " ".join(f"{x:.6f}" for x in want["loss"] + want[
        "late_loss"]) + "; relative gaps " + " ".join(f"{g:.3g}" for g in gaps)
        + f" (the first {before_update} read as loss)", file=sys.stderr)
    numbers["loss"] = max(gaps[:before_update])
    return numbers
