"""Training-core probe: ms per step and peak memory of the UNet's forward and
backward under each gradient-checkpointing policy.

The port's counterpart of the JAX package's `scripts/train_probe.py`: the
full-width UNet of the resolution's inference config, bf16 weights drawn from
N(0, 0.02), forward + backward + gradient norm of the mean-square loss
against a random target, on random bf16 inputs as the JAX probe draws them
(x (B, T, h, w, 2·z) and target N(0, 1), text context (B, 77, C) and image
context (B, T, Q, C) N(0, 0.01), t = 500, fs = 24). No optimizer, no frozen
towers: this is the part the policy controls. Timed by CUDA events over
`--iters` steps after one warm-up; the peak is `torch.cuda.max_memory_allocated`
over those steps.

Policies (the counterpart of the JAX CLI's --remat_policy):
  config  per-layer checkpointing wherever the config sets use_checkpoint,
          the flash outputs kept (the trainer's default)
  none    no checkpointing
The JAX probe's dots / dots_flash are XLA checkpoint policies with no
PyTorch counterpart. A policy that runs out of device memory prints
"FAILED (...)" and the probe goes on. The last line is the JAX probe's JSON
line with `peak_gib` beside `ms_per_step`. Run e.g.:

  python -m dynamicrafter_tpu_torch.train_probe --res 512 --batch 2 --policies config,none

`--config` replaces the resolution's config (the tests run a tiny one on the
CPU, where the time is the host clock's and no peak is read).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Sequence, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = {  # config and latent (h, w)
    256: ("configs/inference_256_v1.0.yaml", 32, 32),
    512: ("configs/inference_512_v1.0.yaml", 40, 64),
    1024: ("configs/inference_1024_v1.0.yaml", 72, 128),
}
POLICIES = ("config", "none")


def probe(unet_config, n_img_tokens: int, batch: int, hw: Tuple[int, int],
          device: torch.device, iters: int) -> Tuple[float, Optional[int]]:
    """(ms per step, peak bytes allocated or None off CUDA) of forward +
    backward + grad norm of the UNet `unet_config` describes."""
    from dynamicrafter_tpu_torch.models.unet3d import UNetModel
    from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
    from dynamicrafter_tpu_torch.utils.weights import init_normal_

    dtype = torch.bfloat16
    with torch.device("meta"):
        unet = UNetModel(unet_config)
    # eval(): dropout off, as the JAX probe's deterministic=True
    unet = keep_norms_fp32(unet.to_empty(device=device).to(dtype)).eval()
    init_normal_(unet, torch.Generator(device=device).manual_seed(42), 0.02)
    params = [p for p in unet.parameters() if p.requires_grad]
    gen = torch.Generator(device=device).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device).to(dtype)
    b, t, (h, w) = batch, unet_config.temporal_length, hw
    x = rand(b, t, h, w, unet_config.in_channels)
    target = rand(b, t, h, w, unet_config.out_channels)
    ts = torch.full((b,), 500, dtype=torch.long, device=device)
    ctx_text = rand(b, 77, unet_config.context_dim) * 0.1
    ctx_img = rand(b, t, n_img_tokens, unet_config.context_dim) * 0.1
    fs = torch.full((b,), 24, dtype=torch.long, device=device)

    def step() -> torch.Tensor:
        pred = unet(x, ts, context_text=ctx_text, context_img=ctx_img, fs=fs)
        loss = (pred.float() - target.float()).square().mean()
        grads = torch.autograd.grad(loss, params)
        return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()

    cuda = device.type == "cuda"
    step()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            step()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    return 1e3 * (time.perf_counter() - t0) / iters, None


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.train_probe")
    ap.add_argument("--res", type=int, default=512, choices=sorted(RES))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--policies", default="config,none",
                    help="comma-separated, of: " + ", ".join(POLICIES))
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--config", default=None,
                    help="a model config in place of the resolution's inference config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available")
    policies = args.policies.split(",")
    for policy in policies:
        if policy not in POLICIES:
            raise SystemExit(f"unknown policy {policy!r}: want one of {POLICIES}")
    yaml_path, h, w = RES[args.res]
    mc = ModelConfig.from_yaml(args.config or os.path.join(REPO, yaml_path))
    base = UNetConfig.from_dict(mc.unet)
    n_img_tokens = (mc.resampler or {}).get("num_queries", 16)
    on = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ms, peak_gib = {}, {}
    for policy in policies:
        cfg = dataclasses.replace(base, use_checkpoint=base.use_checkpoint and policy == "config")
        peak = None
        try:
            ms[policy], peak = probe(cfg, n_img_tokens, args.batch, (h, w), device, args.iters)
        except torch.cuda.OutOfMemoryError as e:
            print(f"{policy}: FAILED ({type(e).__name__}: {str(e)[:200]})")
            ms[policy] = None
        if device.type == "cuda":  # the failed policy's tensors are free only now
            torch.cuda.empty_cache()
        peak_gib[policy] = None if peak is None else peak / 2**30
        if ms[policy] is not None:
            print(f"{policy}: {ms[policy]:.2f} ms/step, peak "
                  + ("not measured" if peak is None else f"{peak_gib[policy]:.3f} GiB")
                  + f" (res {args.res}, b={args.batch}, on {on})")
    result = {"res": args.res, "batch": args.batch,
              "ms_per_step": {k: (None if v is None else round(v, 1)) for k, v in ms.items()},
              "peak_gib": {k: (None if v is None else round(v, 3)) for k, v in peak_gib.items()}}
    print(json.dumps(result))
    return dict(result, ms_per_step=ms, peak_gib=peak_gib, device=on)


if __name__ == "__main__":
    main()
