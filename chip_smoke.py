#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one line:

  1. the device (torch and nvidia-smi name and power limit); build the CUDA
     kernels from `dynamicrafter_tpu_torch/csrc/` with nvcc; each kernel's
     registers and spill bytes as `ptxas -v` reports them (the bf16 K1/K3,
     K2, K4a, K4b, K6, K9, K10 and K7/K8 kernels and the GroupNorm
     statistics kernels must not spill);
  2. K1 (spatial flash attention) against its plain version at the 320x512
     shape (32, 2560, 5*64) bf16, ragged L = 300 and Lq 130 / Lk 77 cases,
     and fp32 checks; bf16 runs on the tensor cores, fp32 on FMAs. Phases 2,
     6 and 11 print each time with its TFLOP/s and its factor over the
     library call;
  3. K2 (temporal attention) against its plain version at the shapes the
     320x512 (B = 2), 256x256 --bs 8 (B = 16) and 576x1024 (B = 1, G up to
     9216) paths give it (bf16, on the tensor cores) and one fp32 shape; then,
     from a generator of the phase's own, the bf16 route at T = 1, 5, 16, 17
     and 32 and at head dim 32 (the SIMT route), at scales 0.125 and -0.125,
     with NaN sentinels past the output and three runs bit-identical; and
     K2 at SVD-XT's T 25 shapes (2, 25, G, H) for G 9216, 2304, 576 (the
     two-tile kernel, one launch counted as two tiles);
  4. one full-width UNet forward of configs/inference_512_v1.0.yaml on a
     batched-CFG input (2, 16, 40, 64, 8), bf16, N(0, 0.02) weights,
     through the kernels and through the plain versions, compared; counts
     the kernel launches of one UNet call;
  5. the slice end to end through `dynamicrafter_tpu_torch.inference.main`
     (the `python -m dynamicrafter_tpu_torch.inference` entry point):
     DDIM-50, eta 1, CFG 7.5 batched, guidance rescale 0.7, fs 24,
     per-frame decode, random N(0, 0.02) weights; checks the written frames
     and that both kernels ran on that path (phase 3b before it holds the
     norm kernels against fp32, SVD-XT's clips among them: the UNet's time
     ResBlock over 2 x 25 frames with its per-clip emb add, the decoder's
     whole 25-frame 576x1024 clip);
 5b. one SVD-XT clip (configs/inference_svd_xt.yaml: 25 frames at 576x1024,
     batched CFG over 2 x 25 rows, whole-clip decode) at STEPS_SVD Euler
     steps through `StableVideoDiffusionPipeline.sample`: finite frames,
     stages, peak, and the launches of K1 and K2 (all two-tile) against
     SVD_PER_CALL a UNet call, GroupNorm and LayerNorm (none on the island),
     which the kernels line carries under `svd_1024`;
  6. K3 (flash forward with logsumexp) against its plain version at
     (32, 2560, 5*64) bf16, ragged L = 300 and Lq 77 / Lk 130 cases, and
     fp32;
  7. K4a and K4b (flash backward dq, dk/dv; bf16 on the tensor cores after a
     di pre-pass, fp32 on FMAs) against `flash_bwd_plain` at the same shapes
     (Lq 77 / Lk 130 for the ragged one), with their TFLOP/s and their factor
     over the library's backward, and the pre-pass against its plain
     version; a level-0 attention forward + backward at (32, 2560, 5*64) and
     (32, 300, 5*64) bf16 timed three ways (`flash_attention`, bf16
     `plain_attention` under autograd, the library); the gradients of the
     differentiable `flash_attention` and `small_t_attention_tmajor` against
     autograd of their plain versions;
  8. one full-width training forward and backward of
     configs/training_512_v1.0.yaml (batch 2 x 16 frames at 320x512, bf16
     autocast, fp32 trainable weights), through the kernels and through the
     plain versions on the same weights and draws: loss and flattened
     gradient compared, kernel launches per micro-step counted; the median,
     min and max of TIMED_STEPS more micro-steps on the kernel route, and one
     profiled, its device time by kernel family;
  9. the training slice end to end through `dynamicrafter_tpu_torch.train.main`
     (the `python -m dynamicrafter_tpu_torch.train` entry point): 4
     micro-steps at accumulation 2 from N(0, 0.02) weights on synthetic
     clips, with --val_every 2 and --sample_every 2 (SampleLogger's sampler
     at STEPS_SAMPLE DDIM steps, set through the config's own
     log_images_kwargs); checks finite losses and validation losses, the
     sampled clips (finite, written), moved trainable and unmoved frozen
     weights, the checkpoint, and the kernel launches of the micro-steps and,
     counted apart, of the validations' and samplers' UNet calls;
 10. K5 (position-major small-sequence attention) against its plain version
     at the 256x256 middle-block shape (256, 16, 20*64) bf16 and fp32 and
     at ragged shapes (G not a multiple of the row tile, T = 8 and 32, other
     head counts), with its share of the bound and its factor over the
     library call, timed as CUDA-graph replays (the bf16 kernel takes less
     time than the host takes for a wrapper call; the back-to-back wrapper
     calls' time is printed beside it) beside K2's kernel on the same memory
     viewed as (G, T, 1, H*64) (the same output bit for bit); then, from a generator of the phase's own, the bf16 route (tensor
     cores) at T = 1, 5, 16, 17 and 32 and G = 1, 3, 257 and 4096 and at head
     dim 32 (the SIMT route), at scales 0.125 and -0.125, with NaN sentinels
     past the output, three runs bit-identical and the kernel that
     `torch.profiler` records (in a fresh process); K5 against plain
     attention at several G;
 11. K1 at the 576x1024 shapes (L = 9216 x 5 heads, L = 2304 x 10 heads)
     at N = 16, every row against its plain version (taken two rows of N at
     a time: the plain logits are N*H*L^2), and a ragged L = 2301;
 12. one full-width UNet forward of configs/inference_256_v1.0.yaml on the
     batched-CFG input of 8 clips (16, 16, 32, 32, 8), bf16, kernels against
     plain, with the launches of one UNet call; then `profile_unet` on that
     config in a process of its own, K5's and K2's device time by family;
 13. the 256x256 slice end to end through `inference.main`: 8 prompts in one
     batch (--bs 8), DDIM-50, eta 1, CFG 7.5 batched, fs 3;
 14. the 576x1024 slice end to end through `inference.main`: one prompt,
     sequential CFG (the CLI's default at this width), per-frame encode,
     tiled decode, DDIM-50; before it, the full-width UNet of that config
     cut to 2 frames, kernels against plain;
 15. interpolation and looping through `inference.main --interp` / `--loop`
     on the 320x512 model at a reduced step count;
 16. the other samplers through `inference.main` on the 320x512 model at
     full width: `--sampler dpm` at 30 steps, `--sampler unipc --solver_order
     2` at 20, and DDIM-50 with `--deepcache 5` (10 full UNet calls, 40
     shallow ones); frames, stage times and K1/K2 launch counts checked;
 17. the UNet's DeepCache seam at full width (a shallow forward from the
     same call's cache against the full forward, and both timed), and two
     DPM-Solver++ steps under batched CFG, kernels against plain;
 18. K6 (`flash_fwd_packed`), K9 (`flash_attention_pairs`) and K10
     (`run_variant`, modes exp, exp2, nosoftmax) against their plain
     versions in bf16 and fp32: at (32, 2560, 5*64) whole, at (32, 9216,
     5*64) and (32, 2304, 10*64) as one N = 32 launch held against the plain
     version two rows of N at a time, and at ragged shapes; the four
     attention variants and K1 against each other; K9's odd-H guard region;
     the bf16 K6, K9 and K10 modes (tensor cores) at the card tests' shapes
     at scales 0.3 and -0.125, with NaN sentinels past the output and three
     runs bit-identical (inputs from a generator of the phase's own); bf16
     K10 exp2 equal to K1 bit for bit at every shape (at -0.125: K1 on -q);
 19. the bench entry points as K9's and K10's path
     (`experiments/flash_pairs/bench_flash_variants.main`,
     `bench_flash_pairs.main`, the three hot shapes at N = 32) and
     `flash_attention(packed=True)` at the same shapes as K6's, with their
     times beside K1's, the plain version's (at L = 2560) and the library
     call's; K6, K9 and K1 timed in turn in one loop, K1 and K10's three
     modes in another, with their TFLOP/s, share of the bound and factor
     over the library call, and the softmax's share of the tensor-core
     loop, 1 - nosoftmax / exp2;
 20. K7 (`fused_gn_silu_conv`) and K8 (`fused_gn_silu_conv_tiled`) against
     their plain versions in fp32 and bf16, with and without emb, at small
     and ragged shapes and at Co != C; K7 against K8 on the same fp32 input;
     then, from a generator of the phase's own, the bf16 route (`gn_stats`,
     then the wgmma + TMA conv) at C = 32 and 96 (a channel chunk past C),
     Co = 96 and 8, images of 5 x 7, 8 x 14, 10 x 16 and 72 x 128, with and
     without emb: against plain, NaN sentinels past the output, three runs
     bit-identical; and `gn_stats` against `gn_stats_plain` in both modes;
 21. K7's and K8's path, `experiments/fused_conv/bench_fused_conv.main`:
     K7, K8 and the library route (group_norm, silu, conv2d on a
     channels-last tensor) timed in turn at the ResBlock shapes of the
     320x512 UNet (N = 32 frames) and level 0 of the 576x1024 UNet (N = 16),
     bf16 with emb, with `gn_stats` alone in both modes, `torch.var_mean`,
     `F.conv2d` alone and K7's plain version beside them; then each kernel
     against its plain version at those shapes, its TFLOP/s, share of the
     bound and factor over the library route;
 22. one full-width ResBlock of the 320x512 UNet (level 0, 320 -> 320, its
     N(0, 0.02) weights): `in_layers(x)` and `out_layers(h + emb_out)`
     through the module and through K7 and K8 fed the module's parameters;
 23. SDS guidance end to end through `generate_guidance.main` on the 320x512
     model (bf16, batched CFG with rescale 0.7, 20 optimisation steps, debug
     dumps every 10): frames, loss curve, moved latents, K1/K2 launches,
     seconds per step and stage peaks; then two steps with fixed draws,
     kernels against plain;
 24. the app backend `Image2Video` at 320x512 with random weights:
     `get_image` at 10 steps in mode i2v and in mode loop (15 frames out);
 25. K4a, K4b and the pre-pass at the 576x1024 shapes (N = 16, L = 9216 x 5
     heads and L = 2304 x 10), one launch each against the plain version two
     rows of N at a time, timed beside the bound and the library's backward;
     one full-width training micro-step of configs/training_1024_v1.0.yaml
     (batch 1 x 16 frames at 576x1024, latents 72x128, bf16 autocast,
     synthetic frames): finite loss and gradient, peak memory, launches per
     micro-step, one profiled by kernel family; then that UNet cut to 2
     frames, forward and backward through the kernels and through the plain
     versions, gradients compared;
 26. the sampler-quality scripts at 256x256, 320x512 and 576x1024 (random
     N(0, 0.02) weights, bf16, 2-pass CFG), cut in depth (CERTIFY_*):
     `dpm_certify.main` against dpm@5, whose candidate at that count must
     reproduce it (relative L2 0), and ddim@5; `deepcache_certify.main` at
     N = 1 (equal to the exact sampler: infinite PSNR, SSIM 1) and 5 over 5
     steps at 256x256 and 320x512, N = 1 alone at 576x1024; launches exact;
     each row with its seconds beside the card's name and power limit.
 27. discovery and `parity_check` at 320x512: the CLI from an empty HOME and
     working directory must print one "blocked on:" line and exit 2 (unless
     `discover` finds weights there); then `parity_check.check` on the
     random-weight bf16 pipeline at DDIM-5: `--x_t_npy` (1, 4, 16, 40, 64)
     gives the frames of `pipe.sample(x_T=<transposed>)` bit for bit, and the
     frames scored against themselves (as `.npy` and as PNGs) give PSNR inf;
 28. `distributed_inference.main` at 320x512 over 3 prompts, DDIM-5, --bs 1:
     two shards in turn, then the one-process `inference.main` with
     --profile_dir: disjoint shards whose frames equal the one-process run's,
     and the first batch's trace naming K1's and K2's kernels;
 29. `train.main` on configs/training_512_interp.yaml (interp_mode, batch 2 x
     16 at 320x512) for 12 micro-steps with --loader processes (spawned
     workers; /dev/shm's size printed) and --profile_steps 2: finite losses,
     launches 12 x phase 8's, the trace naming K3, K4a, K4b and K2's kernels,
     the median s/micro-step beside phase 9's;
 30. `train_probe` at 320x512, policies config and none, batch 2 and 4 (in
     one process of its own): ms/step and peak per row, launches exact for the
     rows that ran; an out-of-memory row is a result, but config at batch 2
     must run.
 31. the dp axis at world size 1 over nccl (a FileStore in a temporary
     directory; RANK=0 WORLD_SIZE=1 LOCAL_RANK=0): (a) the training_512_v1.0
     step through `AccumulatingAdamW(mesh=)` (ZeRO-2) against the plain
     optimizer, 4 micro-steps at accumulation 2 (two updates) with EMA from the same
     weights, batches and draws: relative L2 of the parameters, EMA and both
     moments (at most 1e-5), grad_norm, ms per micro-step, peak memory and
     the collective calls of each micro-step; then the ZeRO state's way
     out, each held to the plain optimizer's state at 1e-5: the EMA
     all-gathered into the modules (`ema_scope`), the state gathered onto
     rank 0's host (`state_dict`), written by `CheckpointManager(mesh=)`
     and read back (weights, EMA, both moments, step counters), its EMA
     through `export_checkpoint --ema`; (b) `train.main --dp 1`,
     3 micro-steps on synthetic clips (the Trainer takes the plain optimizer
     at dp 1: ZeRO has nothing to shard), its checkpoint read back by
     `export_checkpoint`; (c) `inference.main --dp 1` at DDIM-5 against the
     same clip with no process group, frames equal bit for bit; then the
     process group is destroyed.
 32. the sp axis (each clip's frames split over the ranks) with two processes
     that this script spawns (itself, with --sp-rank), sharing the one card
     over gloo (nccl cannot put two ranks on one device; gloo carries the
     CUDA tensors through host memory itself), joined by a FileStore: (a)
     `inference.main --sp 2` on the 320x512 model at DDIM-5 (eta 1, CFG 7.5,
     rescale 0.7), its frames against the one-process `inference.main` on
     the same seed (relative L2 at most 2e-2), stage seconds and peaks per
     rank, and the layout copies around the all-to-alls of one UNet call
     (rank 0's shapes, the exchange left out) timed against their bound;
     (b) `train.main --sp 2`, two micro-steps of the 320x512 recipe, its
     losses, and its parameters and first moments after the update read
     from the two checkpoints, against the one-process `train.main`
     (relative: losses 1e-4, parameters 1e-5, first moment 1e-2); (c) the
     collectives of every UNet call equal to JAX's plan (2 all-to-alls a
     TemporalTransformer, one halo exchange a temporal conv, one all-reduce
     of statistics each, no gather), and K1's and K2's launches per rank.
 33. `inference.main` at 576x1024 (--bs 1, sequential CFG) with `--sampler
     dpm` (30 steps), `--sampler unipc --solver_order 2` (20) and DDIM-50
     with `--deepcache 5`: frames, stage seconds and peaks, launches against
     a full pass's and a DeepCache shallow pass's counts;
 34. the same three samplers at 256x256, 8 prompts in one batch (--bs 8,
     batched CFG over 16 clips, 'uniform' spacing: dpm@30 takes 31 steps);
 35. SDS through `generate_guidance.main` at 256_256 and 576_1024 (bf16,
     STEPS_SDS_WIDE steps: finite latents that moved, seconds per step,
     stage peaks) and the app's `Image2Video.get_image` at both sizes in
     mode i2v (10 steps);
 36. the 576x1024 fine-tune through `train.main` on
     configs/training_1024_v1.0.yaml: 4 micro-steps at accumulation 2 (two
     AdamW updates; finite losses, moved and unmoved weights, peak, launches,
     the checkpoint); `export_checkpoint` of it, `train.main --pretrained`
     of the export (the loaded weights equal it) and `inference.main
     --ckpt_path` of it at DDIM-5 (strict load); 2 micro-steps, then
     `--auto_resume` to 4: weights, moments and losses equal the
     uninterrupted run's bit for bit, the counters continue. Each checkpoint
     directory is deleted once checked.

Then a JSON line with, for each kernel, its launches on its main path (K1 and
K2 phase 5, K3, K4a, K4b and the di pre-pass phase 9, K5 phase 13, K6, K9 and
K10 phase 19, K7, K8 and `gn_stats` phase 21; `launches_by_path` has every
path), error against the plain version (K6, K9, K10: the worst over phase
18's bf16 shapes; K7, K8: at the first shape of phase 21; `gn_stats`: phase
20 at that shape; `launches_by_path` adds the paths of phases 26-36, the sp
ones summed over the two ranks), and
times: the kernel, the plain
version, the bound (the larger of bytes over 3.35 TB/s and operations over
the peak rate of the input type, from the shapes) and one library call
(`F.scaled_dot_product_attention` or its backward, `torch.linalg.vecdot`
for the pre-pass, for K7 and K8 the group_norm, silu, conv2d route, for
`gn_stats` `torch.var_mean`;
timed here and used nowhere in the
package); the nvidia-smi line, and last `{"ok": true, "device": {...}}`.
Any failure raises, so the script exits nonzero; without a CUDA device it
exits 1 before printing any result. Float32 matmuls and convolutions run
without TF32 (both flags set False) in every comparison.
"""
from __future__ import annotations

import collections
import csv
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

CONFIG = "configs/inference_512_v1.0.yaml"
TRAIN_CONFIG = "configs/training_512_v1.0.yaml"
TRAIN_CONFIG_1024 = "configs/training_1024_v1.0.yaml"
TRAIN_CONFIG_INTERP = "configs/training_512_interp.yaml"
CONFIG_256 = "configs/inference_256_v1.0.yaml"
CONFIG_1024 = "configs/inference_1024_v1.0.yaml"
PROMPTS = "prompts/512"
STEPS = 50
STEPS_1024 = 50
STEPS_INTERP = 4
STEPS_DPM = 30
STEPS_UNIPC = 20
DEEPCACHE = 5
TRAIN_STEPS = 4
TIMED_STEPS = 10
TRAIN_STEPS_DP = 3
SAMPLE_EVERY = 2
STEPS_SAMPLE = 5
STEPS_SDS = 20
STEPS_APP = 10
STEPS_SDS_WIDE = 5
# the certify scripts' resolutions and depth, cut from the scripts' own
# defaults (dpm@120 against dpm:30, ddim:50, ddim:30; N = 2..5 over 50 steps):
# dpm_certify at dpm@5 against dpm:5 and ddim:5; deepcache_certify by group of
# resolutions, (steps, intervals N): N = 1 alone at 576x1024, where a row's
# SSIM on the host takes longer than its two samplers
CERTIFY_RESOLUTIONS = "256,512,1024"
CERTIFY_REF_STEPS, CERTIFY_CANDIDATES = 5, "dpm:5,ddim:5"
CERTIFY_INTERVALS = (("256,512", 5, (1, 5)), ("1024", 5, (1,)))
STEPS_PARITY = 5
TRAIN_STEPS_INTERP = 12
PROBE_BATCHES = (2, 4)
PROBE_ITERS = 4
SP = 2
STEPS_SP = 5
TRAIN_STEPS_SP = 2
# published peaks of one H100 SXM at 700 W: HBM bytes/s, FLOP/s by input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 123
REPO = os.path.dirname(os.path.abspath(__file__))
SVD_CONFIG = "configs/inference_svd_xt.yaml"
STEPS_SVD = 2
# K2's shapes on SVD-XT's path: (B, T, G, heads), 25 frames under batched CFG
SVD_K2_SHAPES = ((2, 25, 9216, 5), (2, 25, 2304, 10), (2, 25, 576, 20))
# SVD-XT's UNet call: K1 in the ten spatial transformers at L 9216 and 2304,
# K2 in the sixteen temporal self-attentions at T 25 (two m16 tiles)
SVD_PER_CALL = (10, 16)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Device milliseconds per call of the kernels `fn` launches, as replays
    of a CUDA graph of one call: the host's time per wrapper call is left
    out. Relaxed capture, since a wrapper sets kernel attributes."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return cuda_ms(graph.replay, iters=iters)


def fresh_process_kernel_names(cases) -> dict:
    """The `small_t` kernels `torch.profiler` records for one bf16
    `small_t_fwd` call at each (G, T, H, D) of `cases`, profiled in a fresh
    process: in this one, after the training phases, a profile of a single
    short launch recorded no kernel at all (a fresh process records it, as
    the card tests do)."""
    code = (
        "import json, sys, torch\n"
        "from dynamicrafter_tpu_torch import profile_unet\n"
        "from dynamicrafter_tpu_torch.ops.small_attention import small_t_fwd\n"
        "out = {}\n"
        "for g, t, h, d in json.loads(sys.argv[1]):\n"
        "    q = torch.randn(g, t, h * d, device='cuda').to(torch.bfloat16)\n"
        "    small_t_fwd(q, q, q, h, 0.125)\n"
        "    _, names, _, _ = profile_unet.profile_families(\n"
        "        lambda: small_t_fwd(q, q, q, h, 0.125), 1)\n"
        "    out[str((g, t, h, d))] = sorted(n for n in names if 'small_t' in n)\n"
        "print(json.dumps(out))\n")
    done = subprocess.run([sys.executable, "-c", code, json.dumps(cases)], capture_output=True,
                          text=True, timeout=600, check=True, cwd=REPO)
    return json.loads(done.stdout.strip().splitlines()[-1])


def errors(out, ref):
    d = (out.float() - ref.float())
    return d.abs().max().item(), (d.norm() / ref.float().norm()).item()


def bound(n_bytes: float, flops: float, dtype) -> dict:
    """The least milliseconds the card could take: every input read and every
    output written once at the memory rate, or the operations at the peak
    rate of the input type, whichever is larger."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES
    by_ops = 1e3 * flops / PEAK_FLOPS[str(dtype)[6:]]
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def attention_bound(n, lq, lk, h, d, dtype, products: int = 2, extra_tensors: int = 0,
                    lse: bool = False) -> dict:
    """Attention over (n, l, h*d) operands: q and o-sized tensors of lq rows,
    k and v of lk rows, `extra_tensors` more of lq rows (do, dq, ...), an
    fp32 lse, and `products` matrix products of 2*n*h*lq*lk*d operations."""
    size = 4 if str(dtype).endswith("float32") else 2
    n_bytes = size * n * h * d * ((2 + extra_tensors) * lq + 2 * lk) + (4 * n * h * lq if lse else 0)
    return bound(n_bytes, products * 2.0 * n * h * lq * lk * d, dtype)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def read_clip(path: str):
    """A clip as `save_clip` wrote it, `.npy` or (where OpenCV imports) `.mp4`,
    as (T, H, W, 3) uint8."""
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path)
    import cv2

    cap, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    check(bool(frames), f"{path}: no frame decodes")
    return np.stack(frames)


def svd_k2(dev) -> dict:
    """Phase 3's K2 at SVD-XT's shapes (T 25: the two-tile tensor-core
    kernel) in bf16 against the plain version, from a generator of its own;
    one launch a call, counted as two tiles."""
    import torch
    from dynamicrafter_tpu_torch.ops.small_attention import (
        small_t_fwd_tmajor, small_t_fwd_tmajor_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    rows = {}
    for b, t, g, h in SVD_K2_SHAPES:
        q, k, v = (torch.randn(b, t, g, h * 64, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        before = small_t_fwd_tmajor.launches_by_tiles.get(2, 0)
        out = small_t_fwd_tmajor(q, k, v, h, 0.125)
        two = small_t_fwd_tmajor.launches_by_tiles.get(2, 0) - before
        ref = small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: small_t_fwd_tmajor(q, k, v, h, 0.125), iters=50)
        plain_ms = cuda_ms(lambda: small_t_fwd_tmajor_plain(q, k, v, h, 0.125), iters=10)
        b2 = attention_bound(b * g, t, t, h, 64, torch.bfloat16)
        rows[str((b, t, g, h))] = dict(max_abs_err=max_abs, rel_l2=rel, ms=ms, plain_ms=plain_ms,
                                       **b2)
        log(f"[3] K2 small_t_fwd_tmajor SVD-XT ({b}, {t}, {g}, {h}*64) bf16: max_abs "
            f"{max_abs:.3e} rel_l2 {rel:.3e} (tol 1e-2) | two-tile launches {two} | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, {b2['bound_ms'] / ms:.1%} of the "
            f"{b2['bound_ms']:.4f} ms bound ({b2['bound_by']})")
        check(rel <= 1e-2, f"K2 rel L2 {rel} > 1e-2 at SVD-XT's {(b, t, g, h)}")
        check(two == 1, f"K2 at T {t} took {two} two-tile launches, not 1")
        del q, k, v, out, ref
    return rows


def svd_norms(dev) -> dict:
    """Phase 3b's GroupNorm at SVD-XT's clips (eps 1e-5, SiLU) against fp32,
    x made as the model makes it: the UNet's time ResBlock on 2 x 25 frames
    (its first norm on the clip view of a channels-last ResBlock output, its
    second on the Conv3d's output with the per-clip emb add) and the
    decoder's time stack on the whole 25-frame 576x1024 clip (128 channels,
    3.8 GB in bf16: the streamed channels-last plan), bf16 alone there."""
    import torch
    from dynamicrafter_tpu_torch.models.blocks import _to_clip
    from dynamicrafter_tpu_torch.ops.norms import group_norm_act, group_norm_act_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)

    def clip_view(n, c, h, w, dtype):
        x = torch.empty(n, c, h, w, device=dev, dtype=dtype,
                        memory_format=torch.channels_last).normal_(generator=gen)
        return _to_clip(x.mul_(1.5).add_(0.3), 25)

    def conv3d_out(n, c, h, w, dtype):
        conv = torch.nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0)).to(dev, dtype)
        with torch.no_grad():
            return conv(clip_view(n, c, h, w, dtype))

    cases = [("unet clip b2 320 T25 72x128 cl view", lambda dt: clip_view(50, 320, 72, 128, dt),
              False, (torch.bfloat16, torch.float32)),
             ("unet clip b2 320 T25 72x128 conv3d +emb",
              lambda dt: conv3d_out(50, 320, 72, 128, dt), True, (torch.bfloat16, torch.float32)),
             ("unet clip b2 1280 T25 9x16 conv3d +emb",
              lambda dt: conv3d_out(50, 1280, 9, 16, dt), True, (torch.bfloat16, torch.float32)),
             ("vae clip b1 128 T25 576x1024 cl view",
              lambda dt: clip_view(25, 128, 576, 1024, dt), False, (torch.bfloat16,))]
    rows = {}
    for label, make, emb, dtypes in cases:
        for dtype in dtypes:
            tol = 4e-3 if dtype == torch.bfloat16 else 1e-5
            x = make(dtype)
            c = x.shape[1]
            w, b = 1.0 + 0.2 * rnd(c), 0.2 * rnd(c)
            add = (0.5 * rnd(x.shape[0], c, 1, 1, 1)).to(dtype) if emb else None
            out = group_norm_act(x, w, b, 32, 1e-5, add, True)
            v = x if add is None else x + add
            max_abs, rel = errors(out, group_norm_act_plain(v.float(), w, b, 32, 1e-5, None,
                                                            True))
            del v
            same = torch.equal(out, group_norm_act(x, w, b, 32, 1e-5, add, True))
            ms = cuda_ms(lambda: group_norm_act(x, w, b, 32, 1e-5, add, True), iters=5)
            bd = bound(2 * x.numel() * x.element_size(), 0, dtype)
            rows[f"{label} {str(dtype)[6:]}"] = dict(max_abs_err=max_abs, rel_l2=rel, ms=ms, **bd)
            log(f"[3b] group_norm_act SVD-XT {label} {str(dtype)[6:]} {tuple(x.shape)} stride "
                f"{x.stride()}: max_abs {max_abs:.3e} rel_l2 {rel:.3e} against fp32 (tol {tol:g}) "
                f"| two runs bit-identical {same} | kernel {ms:.4f} ms, bound "
                f"{bd['bound_ms']:.4f} ({100 * bd['bound_ms'] / ms:.1f} %)")
            check(rel <= tol, f"group_norm_act rel L2 {rel} > {tol} at SVD-XT's {label} {dtype}")
            check(same, f"group_norm_act runs differ at SVD-XT's {label} {dtype}")
            del x, out, add
            torch.cuda.empty_cache()
    return rows


def svd_clip(dev) -> dict:
    """One SVD-XT clip at its published size (25 frames at 576x1024, batched
    CFG over 2 x 25 rows, the whole-clip decode), STEPS_SVD Euler steps,
    random N(0, 0.02) weights, bf16, through
    `StableVideoDiffusionPipeline.sample`: finite frames, the stages, the
    peak, and the launches of K1, K2 (by m16 tiles), GroupNorm and LayerNorm,
    counted from zero (no norm on the fp32 island)."""
    import numpy as np
    import torch
    from dynamicrafter_tpu_torch.config import SVDConfig
    from dynamicrafter_tpu_torch.ops import norms
    from dynamicrafter_tpu_torch.ops.flash_attention import flash_fwd
    from dynamicrafter_tpu_torch.ops.small_attention import small_t_fwd_tmajor
    from dynamicrafter_tpu_torch.svd_pipeline import StableVideoDiffusionPipeline

    t0 = time.perf_counter()
    pipe = StableVideoDiffusionPipeline(SVDConfig.from_yaml(SVD_CONFIG), dev, torch.bfloat16)
    pipe.init_random(SEED)
    built = time.perf_counter() - t0
    image = np.random.default_rng(SEED).uniform(-1, 1, (1, 576, 1024, 3)).astype(np.float32)
    flash_fwd.launches = small_t_fwd_tmajor.launches = 0
    small_t_fwd_tmajor.launches_by_tiles.clear()
    norms.group_norm_act.launches = norms.layer_norm.launches = norms.island_calls = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    t1 = time.perf_counter()
    out = pipe.sample(image, steps=STEPS_SVD, seed=SEED, timings=timings)
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev)
    n = dict(flash_fwd=flash_fwd.launches, small_t_fwd_tmajor=small_t_fwd_tmajor.launches,
             small_t_fwd_tmajor_by_tiles=dict(small_t_fwd_tmajor.launches_by_tiles),
             group_norm_act=norms.group_norm_act.launches, layer_norm=norms.layer_norm.launches,
             island=norms.island_calls)
    videos = out.videos
    log(f"[5b] SVD-XT 25x576x1024 Euler-{STEPS_SVD} batched CFG, whole-clip decode: videos "
        f"{videos.shape} finite {bool(np.isfinite(videos).all())} std {videos.std():.3e} | "
        + " ".join(f"{k} {v:.2f}s" for k, v in timings.items())
        + f" | sample {wall:.1f}s, modules and weights {built:.1f}s | peak allocated "
        f"{peak / 2**30:.2f} GiB | launches K1 {n['flash_fwd']} K2 {n['small_t_fwd_tmajor']} "
        f"(by m16 tiles {n['small_t_fwd_tmajor_by_tiles']}) group_norm_act "
        f"{n['group_norm_act']} layer_norm {n['layer_norm']} | CUDA norm calls on the fp32 "
        f"island {n['island']}")
    check(videos.shape == (1, 1, 25, 576, 1024, 3), f"SVD-XT videos {videos.shape}")
    check(bool(np.isfinite(videos).all()) and videos.std() > 0, "SVD-XT frames")
    want = tuple(STEPS_SVD * c for c in SVD_PER_CALL)
    check((n["flash_fwd"], n["small_t_fwd_tmajor"]) == want
          and n["small_t_fwd_tmajor_by_tiles"] == {2: want[1]},
          f"SVD-XT launches K1, K2 {n} != {want}, all K2 two-tile")
    check(min(n["group_norm_act"], n["layer_norm"]) > 0 and n["island"] == 0,
          f"SVD-XT norm launches {n}")
    del pipe, out, videos
    gc.collect()
    torch.cuda.empty_cache()
    return n


def counts(*wrappers) -> tuple:
    return tuple(w.launches for w in wrappers)


def reset(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


@functools.lru_cache(maxsize=None)
def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def infer_kernels() -> tuple:
    """The wrappers of the kernels an inference path launches: K1, K2, K5."""
    from dynamicrafter_tpu_torch.ops.flash_attention import flash_fwd
    from dynamicrafter_tpu_torch.ops.small_attention import small_t_fwd, small_t_fwd_tmajor

    return flash_fwd, small_t_fwd_tmajor, small_t_fwd


def train_kernels() -> tuple:
    """The wrappers a training micro-step launches: K3, K4a, K4b, K2, K1, and
    the di pre-pass."""
    from dynamicrafter_tpu_torch.ops.flash_attention import (
        flash_bwd_di, flash_bwd_dkv, flash_bwd_dq, flash_fwd, flash_fwd_lse)
    from dynamicrafter_tpu_torch.ops.small_attention import small_t_fwd_tmajor

    return flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, small_t_fwd_tmajor, flash_fwd, flash_bwd_di


def unet_calls(spacing: str, steps: int) -> int:
    """The sampler steps (UNet calls a CFG pass) of a run at `steps` and
    `spacing`: the length of the port's DDIM table, which "uniform" makes
    one longer where 1000 // steps leaves a remainder (dpm@30 at 256x256
    takes 31), as the JAX package's and the reference's tables do."""
    from dynamicrafter_tpu_torch.schedule import make_ddim_timesteps

    return len(make_ddim_timesteps(spacing, steps, 1000))


def prompt_dir(root: str, n_prompts: int, images_per_prompt: int = 1) -> str:
    """A prompt dir of copies of the example image and as many prompt lines."""
    os.makedirs(root)
    for i in range(n_prompts * images_per_prompt):
        shutil.copy(os.path.join(PROMPTS, "example.png"), os.path.join(root, f"img{i:02d}.png"))
    with open(os.path.join(root, "prompts.txt"), "w") as f:
        f.write("".join(f"a clip of scene {i}, slow camera motion\n" for i in range(n_prompts)))
    return root


def run_cli(tag: str, flags: list, expect_shape: tuple, steps: int, sampler: str = "DDIM",
            weights: str = None):
    """Drive `inference.main` with the counts at 0, on random weights or on
    the checkpoint `weights`; returns (launches K1, K2, K5, stage seconds,
    peak bytes) after checking the written frames. Flags that `flags`
    repeats override the common ones below."""
    import numpy as np
    import torch

    from dynamicrafter_tpu_torch import inference

    wrappers = infer_kernels()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset(*wrappers)
    t1 = time.perf_counter()
    source = ["--random_init"] if weights is None else ["--ckpt_path", weights]
    result = inference.main([*source, "--bf16", "--text_input",
                             "--unconditional_guidance_scale", "7.5", "--video_length",
                             "16", "--ddim_steps", str(steps), "--ddim_eta", "1.0",
                             "--seed", str(SEED), "--device", "cuda", *flags])
    wall = time.perf_counter() - t1
    n = counts(*wrappers)
    videos, stages = result["videos"][0], result["timings"][0]
    stage_peaks = result["peaks"][0]
    peak = max(result["build_peak"], *stage_peaks.values())
    frames = np.stack([np.load(p) for p in result["paths"]])
    levels = int(np.count_nonzero(np.bincount(frames.reshape(-1), minlength=256)))
    log(f"[{tag}] frames {videos.shape} finite {bool(np.isfinite(videos).all())}, files "
        f"{frames.shape} {frames.dtype} levels {levels} | {sampler}-{steps} | "
        + " ".join(f"{k} {v:.2f}s (peak {stage_peaks[k] / 2**30:.2f} GiB)"
                   for k, v in stages.items())
        + f" | {1e3 * stages['ddim'] / steps:.1f} ms/step | main() wall {wall:.1f}s | peak "
        f"allocated {peak / 2**30:.2f} GiB (building the pipeline "
        f"{result['build_peak'] / 2**30:.2f}; {held / 2**30:.2f} held before by this "
        f"process) | launches K1 {n[0]} K2 {n[1]} K5 {n[2]} "
        f"| {smi_line()}")
    check(videos.shape == expect_shape, f"{tag}: frames {videos.shape} != {expect_shape}")
    check(bool(np.isfinite(videos).all()), f"{tag}: decoded frames are not finite")
    check(frames.dtype == np.uint8 and frames.shape == (
        expect_shape[0] * expect_shape[1], *expect_shape[2:]), f"{tag}: frame files")
    check(levels > 1, f"{tag}: decoded frames are constant")
    return n, stages, peak


def sampler_runs(tag: str, tmp: str, flags: list, expect_shape: tuple, spacing: str,
                 full: tuple, shallow: tuple, passes: int) -> dict:
    """dpm@30, unipc@20 (order 2) and DDIM-50 with DeepCache-5 through
    `inference.main` with `flags`. Each run's launches (K1, K2, K5) must be
    `passes` UNet calls a sampler step of `full`'s counts, and under DeepCache
    `shallow`'s at the cached steps. Returns {run: (launches, stage seconds,
    peak)}."""
    runs = {}
    for name, extra, steps, label in (
            ("dpm30", ["--sampler", "dpm"], STEPS_DPM, "DPM++(2M)"),
            ("unipc20", ["--sampler", "unipc", "--solver_order", "2"], STEPS_UNIPC, "UniPC"),
            (f"deepcache{DEEPCACHE}", ["--deepcache", str(DEEPCACHE)], STEPS,
             f"DDIM with DeepCache-{DEEPCACHE}")):
        runs[name] = run_cli(f"{tag} {name}", [*flags, *extra, "--savedir",
                                               os.path.join(tmp, name)],
                             expect_shape, steps, sampler=label)
        calls = unet_calls(spacing, steps)
        n_full = calls // DEEPCACHE if name.startswith("deepcache") else calls
        want = tuple(passes * (n_full * f + (calls - n_full) * c) for f, c in zip(full, shallow))
        check(runs[name][0] == want, f"{tag} {name}: launches {runs[name][0]} != {want} "
              f"({calls} steps x {passes} passes, {n_full} full)")
    return runs


def certify_runs(per_call: dict, shallow: dict) -> dict:
    """Phase 26: `dpm_certify.main` and `deepcache_certify.main` (random
    N(0, 0.02) weights, bf16, 2-pass CFG) at CERTIFY_RESOLUTIONS. Their
    invariants: the candidate at the reference's step count reproduces the
    reference (relative L2 0), N = 1 equals the exact sampler (infinite
    PSNR, SSIM 1), every other row finite. Launches (K1, K2, K5) exact:
    `per_call[res]` a UNet call (`shallow[res]` a DeepCache shallow one);
    dpm_certify runs 1024's passes one call each, as the inference CLI does,
    deepcache_certify batches them. Returns the launches of each script."""
    import numpy as np
    import torch

    from dynamicrafter_tpu_torch import deepcache_certify, dpm_certify

    wrappers, smi = infer_kernels(), smi_line()
    resolutions = CERTIFY_RESOLUTIONS.split(",")
    dpm_flags = ["--ref_steps", str(CERTIFY_REF_STEPS), "--candidates", CERTIFY_CANDIDATES]
    reset(*wrappers)
    dpm_rows = dpm_certify.main(["--resolutions", CERTIFY_RESOLUTIONS, "--cfg_passes", "2",
                                 *dpm_flags])
    n_dpm = counts(*wrappers)
    torch.cuda.empty_cache()
    reset(*wrappers)
    dc_rows, dc_flags = [], {}
    for group, steps, intervals in CERTIFY_INTERVALS:
        dc_flags[group] = ["--steps", str(steps),
                           "--intervals", ",".join(str(n) for n in intervals)]
        dc_rows += deepcache_certify.main(["--resolutions", group, "--cfg_passes", "2",
                                           *dc_flags[group]])
        torch.cuda.empty_cache()
    n_dc = counts(*wrappers)
    add = lambda a, n, c: tuple(x + n * y for x, y in zip(a, c))
    want_dpm = want_dc = (0, 0, 0)
    dpm_calls = CERTIFY_REF_STEPS + sum(int(c.split(":")[1])
                                        for c in CERTIFY_CANDIDATES.split(","))
    for res in resolutions:
        want_dpm = add(want_dpm, (2 if res == "1024" else 1) * dpm_calls, per_call[res])
        exact = set()
        steps, intervals = next((st, ns) for group, st, ns in CERTIFY_INTERVALS
                                if res in group.split(","))
        for n in intervals:
            n_steps = steps if steps % n == 0 else (steps // n) * n
            if n_steps not in exact:
                exact.add(n_steps)
                want_dc = add(want_dc, n_steps, per_call[res])
            want_dc = add(add(want_dc, n_steps // n, per_call[res]),
                          n_steps - n_steps // n, shallow[res])
    for row in dpm_rows:
        log(f"[26] dpm_certify {row['resolution']} {row['cfg_passes']}-pass, ref "
            f"dpm@{CERTIFY_REF_STEPS}, {row['weights']} weights: {row['sampler']}@{row['steps']} "
            f"rel_l2 {row['rel_l2_vs_ref']} latent PSNR {row['latent_psnr_db']} dB pixel PSNR "
            f"{row['pixel_psnr_db']} dB | {row['seconds']} s on {smi}")
    for row in dc_rows:
        log(f"[26] deepcache_certify {row['resolution']} {row['cfg_passes']}-pass, "
            f"{row['weights']} weights: N={row['interval_N']} at {row['steps']} steps latent PSNR "
            f"{row['latent_psnr_db']} dB pixel PSNR {row['pixel_psnr_db']} dB SSIM "
            f"{row['pixel_ssim']} | {row['seconds']} s on {smi}")
    log(f"[26] {CERTIFY_RESOLUTIONS}: dpm_certify {' '.join(dpm_flags)}, deepcache_certify "
        + "; ".join(f"{group}: {' '.join(f)}" for group, f in dc_flags.items())
        + f" | launches K1 K2 K5 {n_dpm} (expected {want_dpm}), {n_dc} "
        f"(expected {want_dc}) | peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    reproduce = [r for r in dpm_rows if (r["sampler"], r["steps"]) == ("dpm", CERTIFY_REF_STEPS)]
    check(len(reproduce) == len(resolutions)
          and all(r["rel_l2_vs_ref"] == 0.0 and r["latent_psnr_db"] is None for r in reproduce),
          f"dpm@{CERTIFY_REF_STEPS} does not reproduce the reference: {reproduce}")
    check(all(np.isfinite(r["rel_l2_vs_ref"]) and r["rel_l2_vs_ref"] > 0
              and np.isfinite(r["latent_psnr_db"]) and np.isfinite(r["pixel_psnr_db"])
              for r in dpm_rows if r not in reproduce), f"dpm_certify rows {dpm_rows}")
    exact_rows = [r for r in dc_rows if r["interval_N"] == 1]
    check(len(exact_rows) == len(resolutions)
          and all(r["latent_psnr_db"] == float("inf") and r["pixel_psnr_db"] == float("inf")
                  and r["pixel_ssim"] == 1.0 for r in exact_rows),
          f"DeepCache N = 1 differs from the exact sampler: {exact_rows}")
    check(all(np.isfinite(r["latent_psnr_db"]) and np.isfinite(r["pixel_psnr_db"])
              and np.isfinite(r["pixel_ssim"]) for r in dc_rows if r["interval_N"] != 1),
          f"deepcache_certify rows {dc_rows}")
    check(n_dpm == want_dpm, f"dpm_certify launches {n_dpm} != {want_dpm}")
    check(n_dc == want_dc, f"deepcache_certify launches {n_dc} != {want_dc}")
    tag = "_".join(resolutions)
    return {f"dpm_certify_{tag}": n_dpm, f"deepcache_certify_{tag}": n_dc}


def sds_run(tmp: str, resolution: str, config: str, steps: int, per_call: tuple) -> tuple:
    """`generate_guidance.main` at `resolution` (bf16, batched CFG, the
    CLI's spacing and rescale for that width) for `steps` optimisation
    steps: finite frames and loss curve, latents that moved, launches of
    `per_call` a step; returns (launches, seconds per step, stage peaks)."""
    import numpy as np
    import torch

    from dynamicrafter_tpu_torch import generate_guidance

    h, w = generate_guidance.RESOLUTIONS[resolution]
    wrappers = infer_kernels()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset(*wrappers)
    t1 = time.perf_counter()
    result = generate_guidance.main([
        "--config", config, "--prompt_dir",
        prompt_dir(os.path.join(tmp, f"p_sds{w}"), 1),
        "--savedir", os.path.join(tmp, f"sds{w}"), "--resolution", resolution, "--random_init",
        "--bf16", "--num_steps", str(steps), "--debug_save_interval", str(steps),
        "--seed", str(SEED), "--device", "cuda"])
    wall = time.perf_counter() - t1
    n = counts(*wrappers)
    out, clock, peak = result["outputs"][0], result["timings"][0], result["peaks"][0]
    settings = result["pipeline"].settings
    # the init the pipeline drew: encode noise first, then the latents
    g = torch.Generator(device="cuda").manual_seed(SEED)
    torch.randn((16, h // 8, w // 8, 4), generator=g, device="cuda")
    init = torch.randn((1, 16, h // 8, w // 8, 4), generator=g, device="cuda").cpu().numpy()
    moved = float(np.abs(out["latents"] - init).mean())
    secs = clock["steps"]
    log(f"[35] SDS generate_guidance --resolution {resolution} bf16, {steps} steps, lr "
        f"{settings.lr}, rescale {settings.guidance_rescale}, spacing {settings.timestep_spacing}: "
        f"frames {out['videos'].shape} finite {bool(np.isfinite(out['videos']).all())} | loss "
        + " ".join(f"{v:.4f}" for v in out["loss_curve"])
        + f" | latents moved by mean abs {moved:.4f} | s/step first {secs[0]:.3f}, mean after "
        f"{np.mean(secs[1:]):.4f} | conditioning {clock['conditioning']:.2f}s loop "
        f"{clock['loop']:.2f}s decode {clock['decode']:.2f}s | peaks " + " ".join(
            f"{k} {v / 2**30:.2f}" for k, v in peak.items())
        + f" GiB, building {result['build_peak'] / 2**30:.2f} ({held / 2**30:.2f} held before) "
        f"| main() wall {wall:.1f}s | "
        f"launches K1 {n[0]} K2 {n[1]} K5 {n[2]} | {smi_line()}")
    check(out["videos"].shape == (1, 16, h, w, 3) and bool(np.isfinite(out["videos"]).all())
          and bool(np.isfinite(out["latents"]).all()), f"SDS {resolution} frames or latents")
    check(out["loss_curve"].shape == (steps,) and bool(np.isfinite(out["loss_curve"]).all()),
          f"SDS {resolution} loss curve")
    check(0.1 * settings.lr < moved < settings.lr * (steps + 1),
          f"SDS {resolution} latents moved by {moved}")
    check(n == tuple(steps * c for c in per_call), f"SDS {resolution} launches {n}")
    return n, secs, peak


def app_run(tmp: str, resolution: str, steps: int, per_pass: tuple) -> tuple:
    """`Image2Video(resolution).get_image` in mode i2v: a finite clip of 16
    frames at the resolution, launches of `per_pass` a CFG pass a step
    (sequential passes at width 1024, as the backend runs them); returns
    (launches, stage seconds, peak bytes)."""
    import numpy as np
    import torch

    from dynamicrafter_tpu_torch.app import RESOLUTIONS, Image2Video
    from dynamicrafter_tpu_torch.utils.video import decode_png

    spec = RESOLUTIONS[resolution]
    wrappers = infer_kernels()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    backend = Image2Video(os.path.join(tmp, f"app{resolution}"), resolution=resolution,
                          random_init=True, mode="i2v")
    build_s = time.perf_counter() - t1
    sampled = []   # what the pipeline handed the backend, before the uint8 clamp
    sample = backend.pipe.sample
    backend.pipe.sample = lambda *a, **k: sampled.append(sample(*a, **k)) or sampled[-1]
    reset(*wrappers)
    clock = {}
    path = backend.get_image(decode_png(os.path.join(PROMPTS, "example.png")),
                             "a fox running through snow", steps=steps, seed=SEED, timings=clock)
    n = counts(*wrappers)
    peak = torch.cuda.max_memory_allocated()
    frames = read_clip(path)
    finite = bool(np.isfinite(sampled[0].videos).all())
    passes = 2 if spec["width"] >= 1024 else 1
    want = tuple(passes * unet_calls(spec["timestep_spacing"], steps) * c for c in per_pass)
    log(f"[35] Image2Video {resolution} mode i2v, {steps} steps, {passes} UNet call(s) a step: "
        f"{os.path.basename(path)} ({os.path.getsize(path)} bytes) {frames.shape} {frames.dtype} "
        f"levels {len(np.unique(frames))} finite {finite} | built in {build_s:.2f}s | "
        + " ".join(f"{k} {v:.2f}s" for k, v in clock.items())
        + f" | peak allocated {peak / 2**30:.2f} GiB ({held / 2**30:.2f} held before) | "
        f"launches K1 {n[0]} K2 {n[1]} K5 {n[2]} "
        f"(expected {want}) | {smi_line()}")
    check(finite and frames.shape == (16, spec["height"], spec["width"], 3)
          and frames.dtype == np.uint8 and len(np.unique(frames)) > 1,
          f"app {resolution}: frames {frames.shape}")
    check(n == want, f"app {resolution} launches {n} != {want}")
    # the wrapped `sample` and the pipeline refer to each other: collect now
    del backend, sampled, sample
    gc.collect()
    return n, clock, peak


def finetune_1024(root: str, per_step: tuple, per_pass: tuple) -> dict:
    """Phase 36: the 576x1024 fine-tune's life cycle through `train.main` on
    configs/training_1024_v1.0.yaml (--synthetic_data --bf16), each
    checkpoint directory deleted once checked. (a) TRAIN_STEPS micro-steps
    at accumulation 2 (two AdamW updates): finite losses, trainable weights
    moved and frozen ones not (against the same seed's fresh pipeline),
    launches `per_step` (K3, K4a, K4b, K2, K1, di) a micro-step, the
    checkpoint; (c) `export_checkpoint` of it over that fresh pipeline as the
    donor (the trained tensors read back bit for bit), `train.main
    --pretrained` of the export for one micro-step (no update at
    accumulation 2: the weights are the loaded ones, equal to the export),
    and `inference.main --ckpt_path` of the export on the inference config
    at DDIM-5 (strict load, a tiny BPE vocab; launches `per_pass` a CFG
    pass); (b) 2 micro-steps, then --auto_resume to TRAIN_STEPS in the same
    --logdir: the losses, weights and both AdamW moments equal (a)'s bit for
    bit and the counters continue. Returns the launches by path."""
    import gzip

    import numpy as np
    import torch

    from dynamicrafter_tpu_torch import export_checkpoint, train
    from dynamicrafter_tpu_torch.config import TrainingConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.training import checkpoints
    from dynamicrafter_tpu_torch.training.trainer import Trainer

    dev = torch.device("cuda", 0)
    wrappers = train_kernels()
    gib = lambda b: f"{b / 2**30:.2f}"
    common = ["--config", TRAIN_CONFIG_1024, "--synthetic_data", "--bf16", "--device", "cuda",
              "--seed", str(SEED), "--log_every", "1", "--logdir", root]

    def run(name, *flags):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        reset(*wrappers)
        t1 = time.perf_counter()
        r = train.main([*common, "--name", name, *flags])
        torch.cuda.synchronize()
        r.update(wall=time.perf_counter() - t1, launches=counts(*wrappers), held=held,
                 peak=torch.cuda.max_memory_allocated(dev))
        return r

    def moments(trainer):
        state = trainer.opt.optimizer.state
        return [(state[p]["exp_avg"], state[p]["exp_avg_sq"]) for p in trainer.params.values()]

    # (a) the uninterrupted run
    a = run("whole", "--max_steps", str(TRAIN_STEPS))
    trainer = a["trainer"]
    hist, secs = a["metrics"], a["step_seconds"]
    first = next(iter(trainer.params.values()))
    updates = int(trainer.opt.optimizer.state[first]["step"])
    weights_a = {k: p.detach().cpu() for k, p in trainer.params.items()}
    moments_a = [(m.cpu(), v.cpu()) for m, v in moments(trainer)]
    mngr = a["checkpoints"]
    ckpt_a = mngr.path(mngr.latest_step())
    ckpt_gib = os.path.getsize(ckpt_a) / 2**30
    fresh = DynamiCrafterPipeline.for_training(TrainingConfig.from_yaml(TRAIN_CONFIG_1024).model,
                                               dev, frozen_dtype=torch.bfloat16)
    fresh.init_random(seed=SEED)
    fresh_sd, trained_sd = fresh.net.state_dict(), trainer.pipe.net.state_dict()
    moved = [k for k in trainer.params
             if k in fresh_sd and not torch.equal(fresh_sd[k], trained_sd[k])]
    frozen_same = all(torch.equal(v, trained_sd[k]) for k, v in fresh_sd.items()
                      if k not in trainer.params)
    n_trainable = sum(k in fresh_sd for k in trainer.params)
    finite = all(np.isfinite(v) for m in hist for v in m.values())
    log(f"[36a] train.main {TRAIN_CONFIG_1024} --synthetic_data --bf16, {TRAIN_STEPS} micro-steps "
        f"(batch 1 x 16 at 576x1024, accumulation 2, {updates} AdamW updates): loss "
        + " ".join(f"{m['loss']:.5f}" for m in hist) + " | grad_norm "
        + " ".join(f"{m['grad_norm']:.4e}" for m in hist) + " | s/micro-step "
        + " ".join(f"{s:.3f}" for s in secs) + f" (median {np.median(secs):.3f}) | main() wall "
        f"{a['wall']:.1f}s | peak allocated {gib(a['peak'])} GiB ({gib(a['held'])} held before) "
        f"| trainable tensors moved "
        f"{len(moved)}/{n_trainable}, frozen unchanged {frozen_same} | checkpoint step "
        f"{mngr.latest_step()} {ckpt_gib:.2f} GiB | launches K3 K4a K4b K2 K1 di {a['launches']} "
        f"(expected {TRAIN_STEPS} x {per_step}) | {smi_line()}")
    check(len(hist) == TRAIN_STEPS and finite and all(m["grad_norm"] > 0 for m in hist),
          "1024 fine-tune losses / grad norms")
    check(updates == TRAIN_STEPS // 2, f"1024 fine-tune made {updates} AdamW updates")
    check(len(moved) >= n_trainable // 2 and frozen_same,
          f"1024 fine-tune: {len(moved)}/{n_trainable} trainable moved, frozen same {frozen_same}")
    check(mngr.latest_step() == TRAIN_STEPS, "1024 fine-tune checkpoint")
    check(a["launches"] == tuple(TRAIN_STEPS * c for c in per_step),
          f"1024 fine-tune launches {a['launches']}")
    out = {"train_1024": a["launches"]}
    del trainer, trained_sd, a
    gc.collect()

    # (c) export over the fresh pipeline as the donor, --pretrained, --ckpt_path
    donor, exported = os.path.join(root, "donor.ckpt"), os.path.join(root, "model.ckpt")
    t1 = time.perf_counter()
    # the donor stands in for a released checkpoint; only torch.load reads it
    checkpoints.write({"state_dict": fresh_sd}, donor)
    donor_s = time.perf_counter() - t1
    del fresh, fresh_sd
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    sd = export_checkpoint.main(["--config", TRAIN_CONFIG_1024, "--params", ckpt_a, "--base",
                                 donor, "--out", exported])
    export_s = time.perf_counter() - t1
    read_back = all(torch.equal(sd[k], v) for k, v in weights_a.items())
    os.remove(donor)
    shutil.rmtree(os.path.join(root, "whole"))
    pre = run("pretrained", "--max_steps", "1", "--pretrained", exported)
    own = pre["trainer"].pipe.net.state_dict()
    loaded = all(torch.equal(v.float().cpu(), sd[k]) for k, v in own.items())
    pre_state = (pre["trainer"].step, pre["trainer"].opt.mini_step,
                 len(pre["trainer"].opt.optimizer.state))
    out["train_1024_pretrained"] = pre["launches"]
    del pre, own, sd
    gc.collect()
    shutil.rmtree(os.path.join(root, "pretrained"))
    vocab = os.path.join(root, "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(vocab, "wt") as f:
        f.write("#version: 0.2\nt h\nth e</w>\ns n\no w</w>")
    n_ckpt, _, ckpt_peak = run_cli("36c inference.main --ckpt_path <exported> 576x1024", [
        "--config", CONFIG_1024, "--prompt_dir",
        prompt_dir(os.path.join(root, "p1024"), 1),
        "--savedir", os.path.join(root, "o1024"), "--height", "576", "--width", "1024",
        "--frame_stride", "10", "--timestep_spacing", "uniform_trailing", "--guidance_rescale",
        "0.7", "--perframe_ae", "--bs", "1", "--vocab_path", vocab],
        (1, 1, 16, 576, 1024, 3), STEPS_PARITY, weights=exported)
    os.remove(exported)
    want_ckpt = tuple(STEPS_PARITY * 2 * c for c in per_pass)
    log(f"[36c] donor (the fresh pipeline's state dict) written in {donor_s:.1f}s; "
        f"export_checkpoint --base donor in {export_s:.1f}s, its trained tensors equal the run's "
        f"{read_back} | train.main --pretrained <exported> --max_steps 1: loaded weights equal the "
        f"export {loaded}, (step, mini_step, AdamW states) {pre_state} (no update at accumulation "
        f"2), launches {out['train_1024_pretrained']} | inference --ckpt_path at DDIM-"
        f"{STEPS_PARITY}: strict load, launches {n_ckpt} (expected {want_ckpt}), peak "
        f"{gib(ckpt_peak)} GiB | {smi_line()}")
    check(read_back, "the export's trained tensors differ from the run's")
    check(loaded and pre_state == (1, 1, 0), f"--pretrained: loaded {loaded}, state {pre_state}")
    check(out["train_1024_pretrained"] == per_step, "--pretrained launches")
    check(n_ckpt == want_ckpt, f"--ckpt_path launches {n_ckpt} != {want_ckpt}")
    out["inference_1024_ckpt"] = n_ckpt

    # (b) stop after 2 micro-steps, resume to TRAIN_STEPS
    b1 = run("cut", "--max_steps", "2")
    hist_b = b1["metrics"]
    del b1
    restored = {}
    load = Trainer.load_state_dict

    def recording(self, state, weights_only=False):
        load(self, state, weights_only)
        torch.cuda.synchronize()
        restored.update(held=torch.cuda.memory_allocated(dev),
                        peak=torch.cuda.max_memory_allocated(dev))

    Trainer.load_state_dict = recording
    try:
        b2 = run("cut", "--max_steps", str(TRAIN_STEPS), "--auto_resume")
    finally:
        Trainer.load_state_dict = load
    trainer = b2["trainer"]
    hist_b += b2["metrics"]
    same_w = all(torch.equal(p.detach().cpu(), weights_a[k]) for k, p in trainer.params.items())
    same_m = all(torch.equal(m.cpu(), ma) and torch.equal(v.cpu(), va)
                 for (m, v), (ma, va) in zip(moments(trainer), moments_a))
    counters = (trainer.step, trainer.opt.mini_step,
                int(trainer.opt.optimizer.state[next(iter(trainer.params.values()))]["step"]),
                b2["checkpoints"].all_steps())
    log(f"[36b] train.main --max_steps 2, then --auto_resume --max_steps {TRAIN_STEPS} in the same "
        f"--logdir: losses " + " ".join(f"{m['loss']:.5f}" for m in hist_b)
        + f" equal (a)'s {[m['loss'] for m in hist_b] == [m['loss'] for m in hist]} | weights "
        f"equal (a)'s {same_w}, both AdamW moments {same_m} | (step, mini_step, AdamW step, "
        f"checkpoints) {counters} | after the restore {gib(restored['held'])} GiB held, peak "
        f"{gib(restored['peak'])} GiB (building and restoring); the run's peak {gib(b2['peak'])} "
        f"GiB | resumed run wall {b2['wall']:.1f}s | launches {b2['launches']} | {smi_line()}")
    check(same_w and same_m and [m["loss"] for m in hist_b] == [m["loss"] for m in hist],
          "the resumed run does not end where the uninterrupted one does")
    check(counters == (TRAIN_STEPS, 0, TRAIN_STEPS // 2, [2, TRAIN_STEPS]),
          f"resumed counters {counters}")
    check(b2["launches"] == tuple((TRAIN_STEPS - 2) * c for c in per_step),
          f"resumed launches {b2['launches']}")
    out["train_1024_resumed"] = b2["launches"]
    del trainer, b2, weights_a, moments_a
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(root, "cut"))
    return out


def sp_infer_flags(tmp: str, name: str) -> list:
    """Phase 32's `inference.main` flags: the 320x512 slice at DDIM-5."""
    return ["--config", CONFIG, "--prompt_dir", os.path.join(tmp, "prompts"), "--random_init",
            "--bf16", "--height", "320", "--width", "512", "--frame_stride", "24",
            "--timestep_spacing", "uniform_trailing", "--guidance_rescale", "0.7",
            "--perframe_ae", "--unconditional_guidance_scale", "7.5", "--text_input",
            "--video_length", "16", "--ddim_steps", str(STEPS_SP), "--ddim_eta", "1.0",
            "--seed", str(SEED), "--device", "cuda", "--savedir", os.path.join(tmp, name)]


def sp_train_flags(tmp: str, name: str) -> list:
    """Phase 32's `train.main` flags: the 320x512 recipe, TRAIN_STEPS_SP
    micro-steps (one update at its accumulation of 2)."""
    return ["--config", TRAIN_CONFIG, "--synthetic_data", "--bf16",
            "--max_steps", str(TRAIN_STEPS_SP), "--device", "cuda", "--seed", str(SEED),
            "--logdir", tmp, "--name", name, "--log_every", "1"]


def sp_rank_main(rank: int, tmp: str) -> int:
    """One rank of phase 32 (a process the phase spawns with RANK,
    WORLD_SIZE=SP and LOCAL_RANK=0): joins a gloo group on cuda:0 through a
    FileStore in `tmp`, runs `inference.main --sp SP` and then `train.main
    --sp SP`, and writes what it saw to `tmp/sp_rank<rank>.json` (rank 0
    also the frames and the checkpoint)."""
    import numpy as np
    import torch

    from dynamicrafter_tpu_torch import inference, train
    from dynamicrafter_tpu_torch.models.unet3d import UNetModel
    from dynamicrafter_tpu_torch.ops.flash_attention import flash_bwd_di, flash_fwd
    from dynamicrafter_tpu_torch.ops.small_attention import small_t_fwd_tmajor
    from dynamicrafter_tpu_torch.parallel import sharding

    os.chdir(REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = sharding.init_distributed("cuda", os.path.join(tmp, "store"), backend="gloo")
    out = {"rank": rank, "device": str(dev), "backend": torch.distributed.get_backend(),
           "world": torch.distributed.get_world_size()}
    # the collectives of each UNet call, counted around its forward, and the
    # tensors each all-to-all's layout copies take in the first call
    per_call, forward = [], UNetModel.forward
    layouts, layout_fns = [], {"t_to_hw": sharding._t_to_hw, "hw_to_t": sharding._hw_to_t}

    def counted(self, *a, **k):
        before = collections.Counter(sharding.collectives)
        y = forward(self, *a, **k)
        per_call.append(dict(collections.Counter(sharding.collectives) - before))
        return y

    def recorded(name):
        def layout(x, sp, exchange):
            if not per_call:
                layouts.append((name, list(x.shape), list(x.stride()), str(x.dtype)[6:]))
            return layout_fns[name](x, sp, exchange)
        return layout

    try:
        # (a) inference.main --sp SP
        UNetModel.forward = counted
        sharding._t_to_hw, sharding._hw_to_t = recorded("t_to_hw"), recorded("hw_to_t")
        infer_w = (flash_fwd, small_t_fwd_tmajor)
        reset(*infer_w)
        sharding.collectives.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        r = inference.main([*sp_infer_flags(tmp, f"sp_rank{rank}"), "--sp", str(SP)])
        torch.cuda.synchronize()
        UNetModel.forward = forward
        sharding._t_to_hw, sharding._hw_to_t = layout_fns["t_to_hw"], layout_fns["hw_to_t"]
        out["infer"] = dict(launches=counts(*infer_w), calls=dict(sharding.collectives),
                            per_call=per_call, layouts=layouts, timings=r["timings"][0],
                            peak=torch.cuda.max_memory_allocated(dev), paths=r["paths"])
        np.save(os.path.join(tmp, f"sp_frames{rank}.npy"), r["videos"][0])
        del r
        gc.collect()
        torch.cuda.empty_cache()
        # (b) train.main --sp SP: the ranks share each clip's frames
        train_w = train_kernels()[:5]
        reset(*train_w, flash_bwd_di)
        sharding.collectives.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        r = train.main([*sp_train_flags(tmp, "sp_train"), "--sp", str(SP)])
        torch.cuda.synchronize()
        out["train"] = dict(metrics=r["metrics"], secs=r["step_seconds"],
                            launches=counts(*train_w) + (flash_bwd_di.launches,),
                            calls=dict(sharding.collectives), mesh=r["trainer"].mesh.shape,
                            peak=torch.cuda.max_memory_allocated(dev),
                            steps=r["checkpoints"].all_steps())
        del r
    finally:
        UNetModel.forward = forward
        sharding._t_to_hw, sharding._hw_to_t = layout_fns["t_to_hw"], layout_fns["hw_to_t"]
        sharding.destroy_distributed()
    with open(os.path.join(tmp, f"sp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dynamicrafter_tpu_torch import (
        distributed_inference, export_checkpoint, generate_guidance, inference, parity_check,
        profile_unet)
    from dynamicrafter_tpu_torch.parallel import sharding
    from dynamicrafter_tpu_torch.app import Image2Video
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.experiments.fused_conv import bench_fused_conv
    from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv import (
        fused_gn_silu_conv, fused_gn_silu_conv_plain, gn_stats, gn_stats_plain, pick_tile_tc)
    from dynamicrafter_tpu_torch.experiments.fused_conv.fused_conv_tiled import (
        fused_gn_silu_conv_tiled, fused_gn_silu_conv_tiled_plain)
    from dynamicrafter_tpu_torch.models.blocks import ResBlock, SpatialTransformer
    from dynamicrafter_tpu_torch.sds import SDSDraws, SDSGuidancePipeline, SDSSettings
    from dynamicrafter_tpu_torch.utils.video import decode_png, load_image, save_image, to_uint8
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.ops import attention, kernels
    from dynamicrafter_tpu_torch import train
    from dynamicrafter_tpu_torch.config import TrainingConfig
    from dynamicrafter_tpu_torch.experiments.flash_pairs import (
        bench_flash_pairs, bench_flash_variants)
    from dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants import (
        run_variant, run_variant_plain)
    from dynamicrafter_tpu_torch.experiments.flash_pairs.flash_pairs import (
        flash_attention_pairs)
    from dynamicrafter_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd, flash_bwd_di, flash_bwd_di_plain, flash_bwd_dkv, flash_bwd_dq,
        flash_bwd_plain, flash_fwd, flash_fwd_lse, flash_fwd_lse_plain, flash_fwd_packed,
        flash_fwd_plain)
    from dynamicrafter_tpu_torch.models.blocks import _to_clip
    from dynamicrafter_tpu_torch.ops import norms
    from dynamicrafter_tpu_torch.ops.norms import (
        group_norm_act, group_norm_act_plain, keep_norms_fp32, layer_norm, layer_norm_plain)
    from dynamicrafter_tpu_torch.ops.small_attention import (
        small_t_attention, small_t_attention_tmajor, small_t_fwd, small_t_fwd_plain,
        small_t_fwd_tmajor, small_t_fwd_tmajor_plain)
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.sampling.ddim import (
        CFGConditioning, SamplerSettings, make_cfg_denoiser)
    from dynamicrafter_tpu_torch.sampling.dpm import dpm_sample
    from dynamicrafter_tpu_torch.schedule import build_ddim_table, build_schedule
    from dynamicrafter_tpu_torch.training.checkpoints import CheckpointManager
    from dynamicrafter_tpu_torch.training.trainer import AccumulatingAdamW, TrainConfig, Trainer
    from dynamicrafter_tpu_torch.utils.weights import init_normal_
    phase_s = {}

    os.chdir(REPO)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()

    # -- phase 1: device and build --------------------------------------
    t_start = t0 = time.perf_counter()
    # build from the checkout's sources: a library cached by an earlier run
    # would leave no ptxas report to check
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    kernels.library()
    ptxas = kernels.ptxas_report(kernels.build_log)
    log(f"[1] device {kind!r} | nvidia-smi {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | allow_tf32 matmul=False cudnn=False | "
        f"kernels built in {time.perf_counter() - t0:.2f}s (nvcc "
        f"{kernels.build_seconds:.2f}s) | ptxas (registers, spill stores): "
        + "; ".join(f"{name} {r['regs']} regs {r['spill']} B" for name, r in ptxas.items()))
    for what, key, count in (("K1/K3", "flash_fwd_tc_kernel", 2),
                             ("K2", "small_t_tc_kernel", 2),
                             ("K5", "small_t_posmajor_tc_kernel", 2),
                             ("K4a", "flash_bwd_dq_tc_kernel", 1),
                             ("K4b", "flash_bwd_dkv_tc_kernel", 1),
                             ("K6", "flash_fwd_packed_tc_kernel", 1),
                             ("K9", "flash_fwd_pairs_tc_kernel", 1),
                             ("K10", "flash_variants_tc_kernel", 3),
                             ("K7/K8", "fused_conv_tc_kernel", 2),
                             ("gn_stats", "gn_stats_kernel", 2),
                             ("gn_stats finish", "gn_stats_finish_kernel", 2)):
        tc = {name: r for name, r in ptxas.items() if key in name}
        check(len(tc) == count and all(r["spill"] == 0 for r in tc.values()),
              f"the {what} kernel spills or is missing: {tc}")
    phase_s["1"] = time.perf_counter() - t0

    report = {}

    def heads_first(x, h):
        """(..., L, h*64) -> the (..., h, L, 64) view the library call takes."""
        return x.unflatten(-1, (h, 64)).transpose(-3, -2)

    def sdpa_ms(q, k, v, h, iters=10):
        """One `F.scaled_dot_product_attention` forward on the same data."""
        qh, kh, vh = (heads_first(x, h) for x in (q, k, v))
        return cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=iters)

    def rate(ms, n, lq, lk, h, lib_ms):
        """A flash forward's time with its TFLOP/s (two products of
        2*n*h*lq*lk*64 operations) and its factor over the library call."""
        return (f"{ms:.3f} ms ({4.0 * n * h * lq * lk * 64 / ms / 1e9:.1f} TFLOP/s, "
                f"{ms / lib_ms:.2f}x the library's {lib_ms:.3f} ms)")

    def draw_qkv(n, lq, lk, h, dtype, scales=(1.0, 1.0, 1.0)):
        q = (torch.randn(n, lq, h * 64, device=dev, generator=gen) * scales[0]).to(dtype)
        k, v = ((torch.randn(n, lk, h * 64, device=dev, generator=gen) * sc).to(dtype)
                for sc in scales[1:])
        return q, k, v

    # -- phase 2: K1 ------------------------------------------------------
    t0 = time.perf_counter()
    h1 = 5
    for n, lq, lk, dtype, tol in [
            (32, 2560, 2560, torch.bfloat16, 1e-2), (4, 300, 300, torch.bfloat16, 1e-2),
            (3, 130, 77, torch.bfloat16, 1e-2), (4, 2560, 2560, torch.float32, 1e-5),
            (4, 300, 300, torch.float32, 1e-5)]:
        q, k, v = draw_qkv(n, lq, lk, h1, dtype)
        out = flash_fwd(q, k, v, h1, 0.125)
        ref = flash_fwd_plain(q.float(), k.float(), v.float(), h1, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: flash_fwd(q, k, v, h1, 0.125))
        plain_ms = cuda_ms(lambda: flash_fwd_plain(q, k, v, h1, 0.125))
        lib_ms = sdpa_ms(q, k, v, h1)
        log(f"[2] K1 flash_fwd ({n}, Lq {lq}, Lk {lk}, {h1}*64) {str(dtype)[6:]}: max_abs "
            f"{max_abs:.3e} rel_l2 {rel:.3e} (tol {tol:g}) | kernel "
            f"{rate(ms, n, lq, lk, h1, lib_ms)}, plain {plain_ms:.3f} ms")
        check(rel <= tol, f"K1 rel L2 {rel} > {tol} at {(n, lq, lk, dtype)}")
        if (n, lq, dtype) == (32, 2560, torch.bfloat16):
            report["flash_fwd"] = dict(
                max_abs_err=max_abs, rel_l2=rel, ms=ms, plain_ms=plain_ms,
                **attention_bound(n, lq, lk, h1, 64, dtype), library_ms=lib_ms)
        del q, k, v, out, ref

    phase_s["2"] = time.perf_counter() - t0

    # -- phase 3: K2 ------------------------------------------------------
    t0 = time.perf_counter()
    bf16, fp32 = torch.bfloat16, torch.float32
    k2_cases = [
        # 320x512, batched CFG (B = 2): the init attention (8 heads), levels 0-3
        (2, 2560, 5, bf16, 1e-2), (2, 2560, 8, bf16, 1e-2), (2, 640, 10, bf16, 1e-2),
        (2, 160, 20, bf16, 1e-2), (2, 40, 20, bf16, 1e-2), (2, 2560, 5, fp32, 1e-5),
        # 256x256, 8 clips under batched CFG (B = 16)
        (16, 1024, 5, bf16, 1e-2), (16, 1024, 8, bf16, 1e-2), (16, 256, 10, bf16, 1e-2),
        (16, 64, 20, bf16, 1e-2), (16, 16, 20, bf16, 1e-2),
        # 576x1024, one pass of sequential CFG (B = 1)
        (1, 9216, 5, bf16, 1e-2), (1, 9216, 8, bf16, 1e-2), (1, 2304, 10, bf16, 1e-2),
        (1, 576, 20, bf16, 1e-2), (1, 144, 20, bf16, 1e-2)]
    for b, g, h, dtype, tol in k2_cases:
        q, k, v = (torch.randn(b, 16, g, h * 64, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        out = small_t_fwd_tmajor(q, k, v, h, 0.125)
        ref = small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: small_t_fwd_tmajor(q, k, v, h, 0.125), iters=50)
        plain_ms = cuda_ms(lambda: small_t_fwd_tmajor_plain(q, k, v, h, 0.125), iters=50)
        log(f"[3] K2 small_t_fwd_tmajor ({b}, 16, {g}, {h}*64) {str(dtype)[6:]}: max_abs "
            f"{max_abs:.3e} rel_l2 {rel:.3e} (tol {tol:g}) | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        check(rel <= tol, f"K2 rel L2 {rel} > {tol} at {(b, g, h, dtype)}")
        if (b, g, h, dtype) == (2, 2560, 5, bf16):
            # the library call on the (B, G, h, T, 64) view of the same data
            lib_ms = sdpa_ms(*(x.transpose(1, 2) for x in (q, k, v)), h, iters=50)
            b2 = attention_bound(b * g, 16, 16, h, 64, dtype)
            report["small_t_fwd_tmajor"] = dict(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, **b2, library_ms=lib_ms,
                bound_share=b2["bound_ms"] / ms)
            log(f"[3] K2 at (2, 16, 2560, 5*64) bf16: {b2['bound_ms'] / ms:.1%} of the "
                f"{b2['bound_ms']:.4f} ms bound ({b2['bound_by']}), library {lib_ms:.4f} ms")
        del q, k, v, out, ref
    # the bf16 route at T = 1, 5, 16, 17 and 32 (one m16 tile of rows, then
    # two) and at head dim 32 (the SIMT route), at any scale, with NaN
    # sentinels past the output and three runs bit-identical. The inputs come
    # from a generator of this phase's own, so later phases draw what they
    # drew before these checks existed.
    local_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for b, t, g, h, d in [(2, 1, 37, 3, 64), (2, 5, 37, 3, 64), (1, 16, 160, 5, 64),
                          (1, 17, 160, 5, 64), (2, 32, 37, 3, 64), (2, 16, 37, 3, 32)]:
        q, k, v = (torch.randn(b, t, g, h * d, device=dev, generator=local_gen).to(bf16)
                   for _ in range(3))
        rels = {sc: errors(small_t_fwd_tmajor(q, k, v, h, sc),
                           small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, sc))[1]
                for sc in (0.125, -0.125)}
        check(max(rels.values()) <= 1e-2,
              f"K2 bf16 rel L2 {rels} > 1e-2 at {(b, t, g, h, d)}")
        buf = torch.full((q.numel() + 4096,), float("nan"), device=dev, dtype=bf16)
        kernels.check(kernels.library().dct_small_t_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), kernels.DTYPE_CODES[bf16],
            b, t, g, h, d, 0.125, kernels.stream_handle(dev)), "dct_small_t_fwd")
        first, second = (small_t_fwd_tmajor(q, k, v, h, 0.125) for _ in range(2))
        torch.cuda.synchronize()
        intact = bool(buf[q.numel():].isnan().all())
        same = torch.equal(buf[:q.numel()].view_as(q), first) and torch.equal(first, second)
        log(f"[3] K2 ({b}, {t}, {g}, {h}*{d}) bf16 {'tensor cores' if d == 64 else 'SIMT'}: "
            f"rel_l2 {rels[0.125]:.3e} at scale 0.125, {rels[-0.125]:.3e} at -0.125 (tol 1e-2), "
            f"NaN sentinels intact {intact}, three runs bit-identical {same}")
        check(intact, f"K2 wrote past its output at {(b, t, g, h, d)}")
        check(same, f"K2 bf16 runs differ at {(b, t, g, h, d)}")
        del q, k, v, buf, first, second
    report["small_t_fwd_tmajor"]["svd_xt"] = svd_k2(dev)

    phase_s["3"] = time.perf_counter() - t0

    # -- phase 3b: the norm kernels against fp32 at the main path's shapes ----
    t0 = time.perf_counter()
    cl = lambda x: x.contiguous(memory_format=torch.channels_last)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    # (label, x maker, per-frame emb add): the UNet's per-frame norms
    # channels-last as its convs leave them (and one per channel), the VAE's
    # 512x512 tile, and the clips' views the temporal blocks take
    gn_cases = [
        ("frame 16x320 72x128 cl +emb", lambda: cl(rnd(16, 320, 72, 128)), True),
        ("frame 32x320 40x64 cl +emb", lambda: cl(rnd(32, 320, 40, 64)), True),
        ("frame 32x1280 5x8 cl +emb", lambda: cl(rnd(32, 1280, 5, 8)), True),
        ("frame 16x640 72x128 +emb", lambda: rnd(16, 640, 72, 128), True),
        ("vae 2x128 512x512 cl", lambda: cl(rnd(2, 128, 512, 512)), False),
        ("clip b1 320 T16 72x128 cl", lambda: _to_clip(cl(rnd(16, 320, 72, 128)), 16), False),
        ("clip b2 320 T16 40x64 cl (transpose)",
         lambda: cl(rnd(32, 320, 40, 64)).view(2, 16, 320, 2560).transpose(1, 2), False),
        ("clip b1 320 T16 72x128 (transpose)",
         lambda: rnd(1, 16, 320, 9216).transpose(1, 2), False)]
    gn_by_shape, ln_by_shape = {}, {}
    for label, make, per_frame in gn_cases:
        for dtype, tol in ((torch.bfloat16, 4e-3), (torch.float32, 1e-5)):
            x = (1.5 * make() + 0.3).to(dtype)
            c = x.shape[1]
            w, b = 1.0 + 0.2 * rnd(c), 0.2 * rnd(c)
            add = (0.5 * rnd(x.shape[0], c, 1, 1)).to(dtype) if per_frame else None
            out = group_norm_act(x, w, b, 32, 1e-6, add, True)
            # fp32 all through from the same input (the caller's add rounded
            # in x's dtype): the kernel rounds once, half a bf16 ulp
            v = x if add is None else x + add
            max_abs, rel = errors(out, group_norm_act_plain(v.float(), w, b, 32, 1e-6, None, True))
            same = torch.equal(out, group_norm_act(x, w, b, 32, 1e-6, add, True))
            layout = out.shape == x.shape and out.is_contiguous(memory_format=norms._layout(x))
            row = dict(max_abs_err=max_abs, rel_l2=rel)
            if dtype == torch.bfloat16:
                row.update(
                    ms=graph_ms(lambda: group_norm_act(x, w, b, 32, 1e-6, add, True)),
                    plain_ms=graph_ms(lambda: group_norm_act_plain(x, w, b, 32, 1e-6, add, True)),
                    library_ms=graph_ms(lambda: F.silu(F.group_norm(
                        x if add is None else x + add, 32, w.to(dtype), b.to(dtype), 1e-6))),
                    **bound(2 * x.numel() * x.element_size(), 0, dtype))
                gn_by_shape[label] = row
            log(f"[3b] group_norm_act {label} {str(dtype)[6:]} {tuple(x.shape)} stride "
                f"{x.stride()}: max_abs {max_abs:.3e} rel_l2 {rel:.3e} against fp32 (tol {tol:g}) "
                f"| two runs bit-identical {same} | x's layout kept {layout}"
                + (f" | kernel {row['ms']:.4f} ms, island {row['plain_ms']:.4f}, library bf16 "
                   f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                   f"({100 * row['bound_ms'] / row['ms']:.1f} %)" if "ms" in row else ""))
            check(rel <= tol, f"group_norm_act rel L2 {rel} > {tol} at {label} {dtype}")
            check(same and layout, f"group_norm_act {label} {dtype}: runs equal {same}, "
                                   f"layout kept {layout}")
            del x, out, v, add
    # the transformers' norm1..3 at each level, CLIP's towers (the text
    # tower's last norm keeps fp32)
    for rows, c, keep in ((16 * 72 * 128, 320, False), (16 * 36 * 64, 640, False),
                          (16 * 18 * 32, 1280, False), (32 * 40 * 64, 320, False),
                          (16 * 257, 1280, False), (2 * 77, 1024, True)):
        for dtype, tol in ((torch.bfloat16, 4e-3), (torch.float32, 1e-5)):
            x = (2.0 * rnd(rows, c) + 0.5).to(dtype)
            w, b = 1.0 + 0.2 * rnd(c), 0.2 * rnd(c)
            out = layer_norm(x, w, b, 1e-5, keep)
            max_abs, rel = errors(out, layer_norm_plain(x.float(), w, b, 1e-5, True))
            same = torch.equal(out, layer_norm(x, w, b, 1e-5, keep))
            label = f"({rows}, {c})" + (" keep_fp32" if keep else "")
            row = dict(max_abs_err=max_abs, rel_l2=rel)
            if dtype == torch.bfloat16:
                row.update(ms=graph_ms(lambda: layer_norm(x, w, b, 1e-5, keep)),
                           plain_ms=graph_ms(lambda: layer_norm_plain(x, w, b, 1e-5, keep)),
                           library_ms=graph_ms(lambda: F.layer_norm(
                               x, (c,), w.to(dtype), b.to(dtype), 1e-5)),
                           **bound(x.numel() * (x.element_size() + out.element_size()), 0,
                                   dtype))
                ln_by_shape[label] = row
            log(f"[3b] layer_norm {label} {str(dtype)[6:]}: max_abs {max_abs:.3e} rel_l2 "
                f"{rel:.3e} against fp32 (tol {tol:g}) | two runs bit-identical {same}"
                + (f" | kernel {row['ms']:.4f} ms, island {row['plain_ms']:.4f}, library bf16 "
                   f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
                   f"({100 * row['bound_ms'] / row['ms']:.1f} %)" if "ms" in row else ""))
            check(rel <= (tol if dtype == torch.float32 or not keep else 1e-5),
                  f"layer_norm rel L2 {rel} at {label} {dtype}")
            check(same, f"layer_norm runs differ at {label} {dtype}")
            del x, out
    first_gn, first_ln = gn_cases[0][0], f"({16 * 72 * 128}, 320)"
    torch.cuda.empty_cache()
    gn_by_shape.update(svd_norms(dev))
    report["group_norm_act"] = dict(gn_by_shape[first_gn], by_shape=gn_by_shape)
    report["layer_norm"] = dict(ln_by_shape[first_ln], by_shape=ln_by_shape)
    phase_s["3b"] = time.perf_counter() - t0

    # -- phase 4: full-width UNet forward, kernels vs plain ---------------
    t0 = time.perf_counter()
    cfg = ModelConfig.from_yaml(CONFIG)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(cfg.unet))
    unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
    init_normal_(unet.requires_grad_(False), gen, 0.02)
    x = torch.randn(2, 16, 40, 64, 8, device=dev, generator=gen)
    ts = torch.full((2,), 999, dtype=torch.long, device=dev)
    ctx_t = torch.randn(2, 77, 1024, device=dev, generator=gen)
    ctx_i = torch.randn(2, 16, 16, 1024, device=dev, generator=gen)
    fs = torch.full((2,), 24, dtype=torch.long, device=dev)
    run = lambda: unet(x, ts, context_text=ctx_t, context_img=ctx_i, fs=fs)
    with torch.no_grad():
        flash_fwd.launches = small_t_fwd_tmajor.launches = 0
        out = run()
        torch.cuda.synchronize()
        per_call = (flash_fwd.launches, small_t_fwd_tmajor.launches)
        with attention.use_backend("plain"):
            ref = run()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(run, iters=5, warmup=1)
        with attention.use_backend("plain"):
            plain_ms = cuda_ms(run, iters=5, warmup=1)
    n_params = sum(p.numel() for p in unet.parameters())
    log(f"[4] UNet forward (2, 16, 40, 64, 8) bf16, {n_params / 1e9:.3f} B params: "
        f"out {tuple(out.shape)} finite {bool(torch.isfinite(out).all())} std "
        f"{out.float().std().item():.3e} | kernels vs plain max_abs {max_abs:.3e} rel_l2 "
        f"{rel:.3e} (tol 2e-2) | launches per call K1 {per_call[0]} (the 5 level-0 "
        f"spatial transformers), K2 {per_call[1]} (17 temporal transformers x attn1 + "
        f"attn2, both self-attention over T) | {ms:.1f} ms with kernels, "
        f"{plain_ms:.1f} ms plain")
    check(bool(torch.isfinite(out).all()) and out.shape == (2, 16, 40, 64, 4), "UNet output")
    check(rel <= 2e-2, f"UNet kernels vs plain rel L2 {rel} > 2e-2")
    check(per_call == (5, 34), f"launches per UNet call {per_call} != (5, 34)")
    del unet, x, out, ref
    torch.cuda.empty_cache()
    phase_s["4"] = time.perf_counter() - t0

    # -- phase 5: the slice end to end -------------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as savedir:
        flash_fwd.launches = small_t_fwd_tmajor.launches = 0
        group_norm_act.launches = layer_norm.launches = norms.island_calls = 0
        t0 = time.perf_counter()
        result = inference.main([
            "--config", CONFIG, "--prompt_dir", PROMPTS, "--savedir", savedir,
            "--random_init", "--bf16", "--height", "320", "--width", "512",
            "--frame_stride", "24", "--timestep_spacing", "uniform_trailing",
            "--guidance_rescale", "0.7", "--perframe_ae",
            "--unconditional_guidance_scale", "7.5", "--text_input",
            "--video_length", "16", "--ddim_steps", str(STEPS), "--ddim_eta", "1.0",
            "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = (flash_fwd.launches, small_t_fwd_tmajor.launches)
        norm_launches = (group_norm_act.launches, layer_norm.launches, norms.island_calls)
        frames = np.load(result["paths"][0])
        videos = result["videos"][0]
    # `sample` restarts the peak count at each stage
    peak = max(result["build_peak"], *result["peaks"][0].values())
    stages = result["timings"][0]
    log(f"[5] slice 320x512 DDIM-{STEPS}: frames {frames.shape} {frames.dtype} "
        f"levels {len(np.unique(frames))} finite {bool(np.isfinite(videos).all())} | "
        + " ".join(f"{k} {v:.2f}s" for k, v in stages.items())
        + f" | {1e3 * stages['ddim'] / STEPS:.1f} ms/step | main() wall {wall:.1f}s | "
        f"peak allocated {peak / 2**30:.2f} GiB | launches K1 {launches[0]} K2 {launches[1]} "
        f"group_norm_act {norm_launches[0]} layer_norm {norm_launches[1]} | CUDA norm calls "
        f"on the fp32 island {norm_launches[2]}")
    check(frames.shape == (16, 320, 512, 3) and frames.dtype == np.uint8, "frame file")
    check(bool(np.isfinite(videos).all()), "decoded frames are not finite")
    check(len(np.unique(frames)) > 1, "decoded frames are constant")
    check(launches == (per_call[0] * STEPS, per_call[1] * STEPS),
          f"launches on the slice {launches} != {per_call} x {STEPS} steps")
    check(min(norm_launches[:2]) > 0 and norm_launches[2] == 0,
          f"norm launches on the slice (GN, LN, island) {norm_launches}")
    del result, frames, videos
    phase_s["5"] = time.perf_counter() - t0

    # -- phase 5b: SVD-XT at 576x1024 through its pipeline --------------------
    t0 = time.perf_counter()
    n_svd = svd_clip(dev)
    report["small_t_fwd_tmajor"]["svd_1024_launches_by_tiles"] = n_svd[
        "small_t_fwd_tmajor_by_tiles"]
    phase_s["5b"] = time.perf_counter() - t0

    # -- phase 6: K3 ------------------------------------------------------
    t0 = time.perf_counter()
    for n, lq, lk, dtype, tol in [
            (32, 2560, 2560, torch.bfloat16, 1e-2), (4, 300, 300, torch.bfloat16, 1e-2),
            (3, 77, 130, torch.bfloat16, 1e-2), (4, 2560, 2560, torch.float32, 1e-5),
            (4, 300, 300, torch.float32, 1e-5)]:
        q, k, v = draw_qkv(n, lq, lk, h1, dtype)
        out, lse = flash_fwd_lse(q, k, v, h1, 0.125)
        ref, ref_lse = flash_fwd_lse_plain(q.float(), k.float(), v.float(), h1, 0.125)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        same = torch.equal(out, flash_fwd(q, k, v, h1, 0.125))
        ms = cuda_ms(lambda: flash_fwd_lse(q, k, v, h1, 0.125))
        plain_ms = cuda_ms(lambda: flash_fwd_lse_plain(q, k, v, h1, 0.125))
        lib_ms = sdpa_ms(q, k, v, h1)
        log(f"[6] K3 flash_fwd_lse ({n}, Lq {lq}, Lk {lk}, {h1}*64) {str(dtype)[6:]}: o max_abs "
            f"{max_abs:.3e} rel_l2 {rel:.3e} (tol {tol:g}), lse max_abs {lse_err:.3e} "
            f"(tol 1e-3), o equal to K1's {same} | kernel {rate(ms, n, lq, lk, h1, lib_ms)}, "
            f"plain {plain_ms:.3f} ms")
        check(rel <= tol and lse_err <= 1e-3 and same,
              f"K3 at {(n, lq, lk, dtype)}: o {rel}, lse {lse_err}, equal to K1 {same}")
        if (n, lq, dtype) == (32, 2560, torch.bfloat16):
            report["flash_fwd_lse"] = dict(
                max_abs_err=max_abs, rel_l2=rel, lse_max_abs_err=lse_err, ms=ms,
                plain_ms=plain_ms, **attention_bound(n, lq, lk, h1, 64, dtype, lse=True),
                library_ms=lib_ms)
        del q, k, v, out, lse, ref, ref_lse
    phase_s["6"] = time.perf_counter() - t0

    # -- phase 7: K4a and K4b; the differentiable entries -------------------
    t0 = time.perf_counter()
    for n, lq, lk, dtype, tol in [
            (32, 2560, 2560, bf16, 2e-2), (4, 300, 300, bf16, 2e-2), (3, 77, 130, bf16, 2e-2),
            (4, 2560, 2560, fp32, 1e-4), (4, 300, 300, fp32, 1e-4), (3, 77, 130, fp32, 1e-4)]:
        q, k, v = draw_qkv(n, lq, lk, h1, dtype)
        do = torch.randn(n, lq, h1 * 64, device=dev, generator=gen).to(dtype)
        o, lse = flash_fwd_lse_plain(q.float(), k.float(), v.float(), h1, 0.125)
        refs = flash_bwd_plain(q.float(), k.float(), v.float(), o, lse, do.float(), h1, 0.125)
        o = o.to(dtype)
        grads = flash_bwd(q, k, v, o, lse, do, h1, 0.125)
        torch.cuda.synchronize()
        errs = [errors(g, r) for g, r in zip(grads, refs)]
        # bf16: both kernels read one pre-pass's di, as `flash_bwd` runs them
        di = flash_bwd_di(o, do, h1) if dtype == bf16 else None
        ms_dq = cuda_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, h1, 0.125, di))
        ms_dkv = cuda_ms(lambda: flash_bwd_dkv(q, k, v, o, lse, do, h1, 0.125, di))
        plain_ms = cuda_ms(lambda: flash_bwd_plain(q, k, v, o, lse, do, h1, 0.125))
        flops = 2.0 * n * h1 * lq * lk * 64   # one product
        timing = (f"K4a {ms_dq:.3f} ms ({3 * flops / ms_dq / 1e9:.1f} TFLOP/s) + K4b "
                  f"{ms_dkv:.3f} ms ({4 * flops / ms_dkv / 1e9:.1f} TFLOP/s)")
        if dtype == bf16:
            # the library's backward computes dq, dk and dv in one call, as
            # the plain version does: both kernels are held against that time
            leaves = [heads_first(x, h1).detach().requires_grad_() for x in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*leaves)
            lib_do = heads_first(do, h1)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, lib_do,
                                                         retain_graph=True))
            del leaves, lib_out, lib_do
            di_ms = cuda_ms(lambda: flash_bwd_di(o, do, h1))
            di_err = errors(di, flash_bwd_di_plain(o, do, h1))
            timing += (f", di pre-pass {di_ms:.4f} ms (max_abs {di_err[0]:.3e}); together "
                       f"{(ms_dq + ms_dkv + di_ms) / lib_ms:.2f}x the library's backward "
                       f"{lib_ms:.3f} ms")
            check(di_err[1] <= 1e-6, f"di pre-pass rel L2 {di_err[1]} at {(n, lq, lk)}")
        log(f"[7] K4 flash_bwd ({n}, Lq {lq}, Lk {lk}, {h1}*64) {str(dtype)[6:]}: "
            + ", ".join(f"{name} max_abs {a:.3e} rel_l2 {r:.3e}"
                        for name, (a, r) in zip(("dq", "dk", "dv"), errs))
            + f" (tol {tol:g}) | {timing}, plain (dq, dk, dv together) {plain_ms:.3f} ms")
        check(all(r <= tol for _, r in errs), f"K4 at {(n, lq, lk, dtype)}: {errs}")
        if (n, lq, dtype) == (32, 2560, bf16):
            # K4a reads q, k, v, lse, di, do and writes dq (three products);
            # K4b reads the same and writes dk, dv (four products); Lq = Lk.
            # The pre-pass reads o and do and writes di, fp32 (N, H, Lq).
            k4 = lambda ms, products: dict(
                tflops=products * flops / ms / 1e9, over_library=ms / lib_ms,
                library_ms=lib_ms, library_covers="dq+dk+dv")
            report["flash_bwd_dq"] = dict(
                max_abs_err=errs[0][0], rel_l2=errs[0][1], ms=ms_dq, plain_ms=plain_ms,
                **attention_bound(n, lq, lk, h1, 64, dtype, products=3, extra_tensors=2,
                                  lse=True), **k4(ms_dq, 3))
            report["flash_bwd_dkv"] = dict(
                max_abs_err=max(errs[1][0], errs[2][0]), rel_l2_dk=errs[1][1],
                rel_l2_dv=errs[2][1], ms=ms_dkv, plain_ms=plain_ms,
                **attention_bound(n, lq, lk, h1, 64, dtype, products=4, extra_tensors=3,
                                  lse=True), **k4(ms_dkv, 4))
            di_lib = lambda: torch.linalg.vecdot(o.unflatten(-1, (h1, 64)),
                                                 do.unflatten(-1, (h1, 64)))
            report["flash_bwd_di"] = dict(
                max_abs_err=di_err[0], ms=di_ms,
                plain_ms=cuda_ms(lambda: flash_bwd_di_plain(o, do, h1)),
                # fp32 FMAs off the tensor cores: the float32 rate
                **bound(2 * 2 * n * lq * h1 * 64 + 4 * n * h1 * lq, 2.0 * n * lq * h1 * 64, fp32),
                library_ms=cuda_ms(di_lib))
        del q, k, v, do, o, lse, refs, grads, di

    # a level-0 attention forward + backward three ways: flash (K3, the
    # pre-pass, K4a, K4b), bf16 plain attention under autograd, and the library
    for l in (2560, 300):
        xs = [torch.randn(32, l, h1, 64, device=dev, generator=gen).to(bf16).requires_grad_()
              for _ in range(3)]
        g_out = torch.randn(32, l, h1, 64, device=dev, generator=gen).to(bf16)
        sdpa_bhld = lambda q, k, v: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2)
        fwd_bwd = {name: cuda_ms(lambda: torch.autograd.grad(fn(*xs), xs, g_out))
                   for name, fn in (("flash_attention", flash_attention),
                                    ("plain_attention", attention.plain_attention),
                                    ("library", sdpa_bhld))}
        log(f"[7] level-0 attention forward + backward (32, {l}, {h1}, 64) bf16: "
            + ", ".join(f"{name} {ms:.3f} ms" for name, ms in fwd_bwd.items()))
        report["flash_bwd_dq"].setdefault("fwd_bwd_ms", {})[f"(32, {l}, {h1}*64)"] = fwd_bwd
        del xs, g_out

    def grad_check(fn, plain_fn, shape, what):
        xs = [torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
              for _ in range(3)]
        g_out = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        got = torch.autograd.grad(fn(*xs), xs, g_out)
        ref = torch.autograd.grad(plain_fn(*xs), xs, g_out)
        rels = [errors(a, b)[1] for a, b in zip(got, ref)]
        log(f"[7] {what} {shape} bf16 gradients vs autograd of the plain version: rel_l2 "
            f"dq {rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e} (tol 2e-2)")
        check(max(rels) <= 2e-2, f"{what} gradients {rels}")

    grad_check(flash_attention, attention.plain_attention, (32, 2560, h1, 64),
               "flash_attention (K3 + K4a/K4b)")
    flat = lambda x: x.flatten(-2)
    grad_check(small_t_attention_tmajor,
               lambda q, k, v: small_t_fwd_tmajor_plain(flat(q), flat(k), flat(v), h1,
                                                        0.125).unflatten(-1, (h1, 64)),
               (2, 16, 2560, h1, 64), "small_t_attention_tmajor (K2)")
    torch.cuda.empty_cache()
    phase_s["7"] = time.perf_counter() - t0

    # -- phase 8: one full-width training micro-step, kernels vs plain ------
    t0 = time.perf_counter()
    train_wrappers = train_kernels()[:5]
    tc = TrainingConfig.from_yaml(TRAIN_CONFIG)
    mc = tc.model
    pipe = DynamiCrafterPipeline.for_training(mc, dev, frozen_dtype=torch.bfloat16)
    pipe.init_random(seed=SEED)
    trainer = Trainer(pipe, TrainConfig(
        accumulate_grad_batches=tc.accumulate_grad_batches, use_ema=False,
        uncond_prob=mc.uncond_prob, rand_cond_frame=mc.rand_cond_frame,
        parameterization=mc.parameterization, bf16=True), seed=SEED)
    bsz, t_len = tc.batch_size, mc.unet["temporal_length"]
    hh, ww = tc.train_data["resolution"]
    batch = {"video": torch.rand(bsz, t_len, hh, ww, 3, device=dev, generator=gen) * 2 - 1,
             "tokens": torch.as_tensor(pipe.tokenizer(["a fox running", "waves at dusk"]),
                                       dtype=torch.long, device=dev),
             "fs": torch.full((bsz,), 8.0, device=dev)}
    draws = trainer.draw(batch)
    reset(*train_wrappers, flash_bwd_di)
    t1 = time.perf_counter()
    loss, _, grads = trainer.loss_and_grads(batch, draws)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    per_step = counts(*train_wrappers)
    di_per_step = flash_bwd_di.launches
    g_kern = torch.cat([g.flatten() for g in grads])
    del grads

    # the micro-step's spread on the kernel route, and where its device time goes
    micro_step = lambda: trainer.loss_and_grads(batch, draws)
    secs_after = []
    for _ in range(TIMED_STEPS):
        t1 = time.perf_counter()
        micro_step()
        torch.cuda.synchronize()
        secs_after.append(time.perf_counter() - t1)
    fam, _, window_ms, _ = profile_unet.profile_families(micro_step, 1)
    device_ms = sum(fam.values())
    log(f"[8] micro-step on the kernel route, {TIMED_STEPS} after the first: median "
        f"{np.median(secs_after):.3f} s, min {min(secs_after):.3f}, max {max(secs_after):.3f} | "
        f"one profiled: {device_ms:.1f} ms of device time in a {window_ms:.1f} ms window "
        f"({100 * device_ms / window_ms:.1f} % busy): "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in fam.most_common()))
    report["flash_bwd_dq"]["train_512_ms_by_family"] = dict(fam)
    with attention.use_backend("plain"):
        t1 = time.perf_counter()
        loss_plain, _, grads = trainer.loss_and_grads(batch, draws)
        torch.cuda.synchronize()
        plain_step_s = time.perf_counter() - t1
    g_plain = torch.cat([g.flatten() for g in grads])
    del grads
    g_abs, g_rel = errors(g_kern, g_plain)
    # the slice of the gradient K4a/K4b feed directly: to_q, to_k, to_v of
    # the level-0 spatial self-attentions (L = 2560)
    level0 = [f"model.diffusion_model.{name}.transformer_blocks.0.attn1.to_"
              for name, m in pipe.unet.named_modules() if isinstance(m, SpatialTransformer)
              and m.proj_in.in_features == pipe.unet_config.model_channels]
    offsets = np.cumsum([0] + [p.numel() for p in trainer.params.values()])
    sel = torch.cat([torch.arange(offsets[i], offsets[i + 1], device=dev)
                     for i, k in enumerate(trainer.params) if k.startswith(tuple(level0))])
    qkv_abs, qkv_rel = errors(g_kern[sel], g_plain[sel])
    n_train = g_kern.numel()
    log(f"[8] training micro-step {TRAIN_CONFIG} (batch {bsz} x {t_len} at {hh}x{ww}, "
        f"{n_train / 1e9:.3f} B trainable): loss kernels {loss.item():.6f} plain "
        f"{loss_plain.item():.6f} | flattened gradient rel_l2 {g_rel:.3e} max_abs "
        f"{g_abs:.3e} (tol 5e-2), norm {g_kern.norm().item():.4e}; of the {len(level0)} "
        f"level-0 spatial attn1 to_q/to_k/to_v weights rel_l2 {qkv_rel:.3e} max_abs "
        f"{qkv_abs:.3e}, norm {g_kern[sel].norm().item():.4e} | launches per "
        f"micro-step K3 {per_step[0]} K4a {per_step[1]} K4b {per_step[2]} K2 {per_step[3]} "
        f"K1 {per_step[4]} (di pre-pass {di_per_step}) | fwd+bwd {step_s:.2f} s with kernels "
        f"(first call), "
        f"{plain_step_s:.2f} s plain")
    check(bool(torch.isfinite(g_kern).all()) and g_kern.norm().item() > 0, "training gradient")
    check(g_rel <= 5e-2, f"training gradient kernels vs plain rel L2 {g_rel} > 5e-2")
    check(abs(loss.item() - loss_plain.item()) <= 1e-2 * abs(loss_plain.item()),
          f"training loss kernels {loss.item()} vs plain {loss_plain.item()}")
    check(per_step == (5, 5, 5, 68, 0), f"launches per micro-step {per_step} != (5, 5, 5, 68, 0)")
    check(di_per_step == 5, f"di pre-pass launches per micro-step {di_per_step} != 5")
    del pipe, trainer, batch, draws, g_kern, g_plain, sel, loss, loss_plain
    torch.cuda.empty_cache()
    phase_s["8"] = time.perf_counter() - t0

    # -- phase 9: the training slice end to end -----------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(dir=REPO) as logdir:
        # SampleLogger's sampler cut from the config's 50 DDIM steps through
        # the config's own key (F3's mapping of ddim_steps to steps)
        override = os.path.join(logdir, "sample_steps.yaml")
        with open(override, "w") as f:
            f.write("lightning:\n  callbacks:\n    batch_logger:\n      params:\n"
                    f"        log_images_kwargs:\n          ddim_steps: {STEPS_SAMPLE}\n")
        sampled, sample, eval_step = [], DynamiCrafterPipeline.sample, Trainer.eval_step
        # K3, K4a, K4b, K2, K1 of the samplers' and validations' calls,
        # counted apart from the micro-steps'
        no_grad = [0] * len(train_wrappers)

        def outside_micro_steps(fn):
            def counted(*a, **k):
                before = counts(*train_wrappers)
                out = fn(*a, **k)
                no_grad[:] = [n + c - b for n, b, c in
                              zip(no_grad, before, counts(*train_wrappers))]
                return out
            return counted

        def recording(self, *a, **k):
            out = sample(self, *a, **k)
            sampled.append((out.videos.shape, bool(np.isfinite(out.videos).all())))
            return out

        reset(*train_wrappers, flash_bwd_di)
        DynamiCrafterPipeline.sample = outside_micro_steps(recording)
        Trainer.eval_step = outside_micro_steps(eval_step)
        try:
            result = train.main([
                "--config", TRAIN_CONFIG, override, "--synthetic_data", "--bf16",
                "--max_steps", str(TRAIN_STEPS), "--device", "cuda", "--seed", str(SEED),
                "--logdir", logdir, "--name", "smoke", "--log_every", "1",
                "--sample_every", str(SAMPLE_EVERY), "--val_every", str(SAMPLE_EVERY)])
        finally:
            DynamiCrafterPipeline.sample, Trainer.eval_step = sample, eval_step
        torch.cuda.synchronize()
        no_grad_launches = tuple(no_grad)
        train_launches = tuple(n - g for n, g in zip(counts(*train_wrappers), no_grad_launches))
        train_di = flash_bwd_di.launches
        train_peak = torch.cuda.max_memory_allocated(dev)
        trainer = result["trainer"]
        hist, secs = result["metrics"], result["step_seconds"]
        sample_files = sorted(os.listdir(os.path.join(result["workdir"], "samples")))
        with open(os.path.join(result["workdir"], "metrics.csv")) as f:
            val_rows = [(int(r["step"]), float(r["val/loss"])) for r in csv.DictReader(f)
                        if r.get("val/loss")]
        saved_step = result["checkpoints"].latest_step()
        state = result["checkpoints"].restore()
        ckpt_bytes = os.path.getsize(result["checkpoints"].path(saved_step))
        reloaded = all(torch.equal(state["weights"][k], p.detach().cpu())
                       for k, p in trainer.params.items())
        del state
    fresh = DynamiCrafterPipeline.for_training(mc, dev, frozen_dtype=torch.bfloat16)
    fresh.init_random(seed=SEED)
    fresh_sd, trained_sd = fresh.net.state_dict(), trainer.pipe.net.state_dict()
    trainable = set(trainer.params)
    updates = int(trainer.opt.optimizer.state[next(iter(trainer.params.values()))]["step"])
    moved = [k for k in trainable if k in fresh_sd
             and not torch.equal(fresh_sd[k], trained_sd[k])]
    frozen_same = all(torch.equal(v, trained_sd[k]) for k, v in fresh_sd.items()
                      if k not in trainable)
    n_trainable = sum(k in fresh_sd for k in trainable)
    delta = sum((trained_sd[k].double() - fresh_sd[k].double()).square().sum().item()
                for k in trainable if k in fresh_sd) ** 0.5
    del fresh, fresh_sd, trained_sd
    finite = all(np.isfinite(v) for m in hist for v in m.values())
    # K3, K4a, K4b, K2, K1: the micro-steps', and apart from them K2 and K1
    # of the validations' forwards and the samplers' UNet calls (no gradient)
    sample_steps = list(range(SAMPLE_EVERY, TRAIN_STEPS + 1, SAMPLE_EVERY))
    no_grad_calls = len(sample_steps) * (1 + STEPS_SAMPLE)
    expect_9 = tuple(TRAIN_STEPS * c for c in per_step)
    expect_no_grad = (0, 0, 0, no_grad_calls * per_call[1], no_grad_calls * per_call[0])
    log(f"[9] train.main {TRAIN_CONFIG} --synthetic_data --bf16, {TRAIN_STEPS} micro-steps "
        f"(accumulation {tc.accumulate_grad_batches}, {updates} optimizer updates): loss " + " ".join(f"{m['loss']:.5f}" for m in hist)
        + " | grad_norm " + " ".join(f"{m['grad_norm']:.4e}" for m in hist)
        + " | s/micro-step " + " ".join(f"{s:.3f}" for s in secs)
        + f" (mean after the first {np.mean(secs[1:]):.3f}) | peak allocated "
        f"{train_peak / 2**30:.2f} GiB | trainable weights moved by L2 {delta:.4e} "
        f"({len(moved)}/{n_trainable} tensors; AdamW steps below half an fp32 ulp vanish), "
        f"frozen unchanged {frozen_same} | checkpoint step {saved_step} "
        f"{ckpt_bytes / 2**30:.2f} GiB reloads equal {reloaded} | launches of the micro-steps "
        f"K3 {train_launches[0]} K4a {train_launches[1]} K4b {train_launches[2]} K2 "
        f"{train_launches[3]} K1 {train_launches[4]} di pre-pass {train_di} (expected "
        f"{TRAIN_STEPS} x {per_step}, {TRAIN_STEPS * di_per_step}); of the validations' "
        f"forwards and the samplers' UNet calls {no_grad_launches} (expected {expect_no_grad}: "
        f"{no_grad_calls} calls at {per_call} each) | --val_every {SAMPLE_EVERY}: val/loss "
        + " ".join(f"step {k} {v:.5f}" for k, v in val_rows)
        + f" | --sample_every {SAMPLE_EVERY} (ddim_steps {STEPS_SAMPLE} from the config): "
        f"samples {sampled} (shape, finite), {len(sample_files)} files "
        f"{sample_files[:2]}... | {smi}")
    check(len(hist) == TRAIN_STEPS and finite, "training losses / grad norms not finite")
    check([k for k, _ in val_rows] == sample_steps and all(np.isfinite(v) for _, v in val_rows),
          f"validation rows {val_rows}")
    check(len(sampled) == len(sample_steps)
          and all(shape == (2, 1, 16, 320, 512, 3) and ok for shape, ok in sampled)
          and {f"step{k:07d}_{i}" for k in sample_steps for i in range(2)}
          <= {os.path.splitext(f)[0] for f in sample_files},
          f"SampleLogger clips {sampled}, files {sample_files}")
    check(all(m["grad_norm"] > 0 for m in hist), "zero grad_norm")
    check(delta > 0 and len(moved) >= n_trainable // 2, "trainable weights did not move")
    check(frozen_same, "a frozen weight changed")
    check(saved_step == TRAIN_STEPS and reloaded, "checkpoint missing or does not reload")
    check(train_launches == expect_9 and train_di == TRAIN_STEPS * di_per_step,
          f"micro-step launches {train_launches}, di {train_di} != {expect_9}")
    check(no_grad_launches == expect_no_grad,
          f"validation and sample launches {no_grad_launches} != {expect_no_grad}")
    phase_s["9"] = time.perf_counter() - t0
    median_9 = float(np.median(secs))
    del result, trainer, hist, secs
    torch.cuda.empty_cache()

    # -- phase 10: K5 -------------------------------------------------------
    t0 = time.perf_counter()
    for g, tk, h, d, dtype, tol in [
            (256, 16, 20, 64, torch.bfloat16, 1e-2), (256, 16, 20, 64, torch.float32, 1e-4),
            (37, 8, 3, 64, torch.bfloat16, 1e-2), (37, 8, 3, 64, torch.float32, 1e-4),
            (19, 32, 7, 64, torch.bfloat16, 1e-2), (19, 32, 7, 32, torch.float32, 1e-4)]:
        q, k, v = (torch.randn(g, tk, h * d, device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        scale = d ** -0.5
        out = small_t_fwd(q, k, v, h, scale)
        ref = small_t_fwd_plain(q.float(), k.float(), v.float(), h, scale)
        torch.cuda.synchronize()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(lambda: small_t_fwd(q, k, v, h, scale), iters=50)
        plain_ms = cuda_ms(lambda: small_t_fwd_plain(q, k, v, h, scale), iters=50)
        log(f"[10] K5 small_t_fwd ({g}, {tk}, {h}*{d}) {str(dtype)[6:]}: max_abs {max_abs:.3e} "
            f"rel_l2 {rel:.3e} (tol {tol:g}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(rel <= tol, f"K5 rel L2 {rel} > {tol} at {(g, tk, h, d, dtype)}")
        if (g, tk, dtype) == (256, 16, torch.bfloat16):
            lib_ms = sdpa_ms(q, k, v, h, iters=50)
            b5 = attention_bound(g, tk, tk, h, d, dtype)
            # K2's kernel on the same memory viewed as (G, T, 1, H*D): the
            # warp loop K5's kernel shares, under K2's address map
            as_k2 = lambda: small_t_fwd_tmajor(
                *(x.view(g, tk, 1, h * d) for x in (q, k, v)), h, scale)
            k2_ms = cuda_ms(as_k2, iters=50)
            same = torch.equal(as_k2().view_as(out), out)
            # the tensor-core kernel takes less time than the host takes for a
            # wrapper call: its time is that of CUDA-graph replays, and the
            # back-to-back wrapper calls' time is kept beside it
            dev_ms = graph_ms(lambda: small_t_fwd(q, k, v, h, scale))
            k2_dev_ms = graph_ms(as_k2)
            report["small_t_fwd"] = dict(
                max_abs_err=max_abs, ms=dev_ms, plain_ms=plain_ms, **b5, library_ms=lib_ms,
                bound_share=b5["bound_ms"] / dev_ms, wrapper_ms=ms)
            log(f"[10] K5 at (256, 16, 20*64) bf16 (tensor cores), as CUDA-graph replays: "
                f"{dev_ms:.4f} ms, {b5['bound_ms'] / dev_ms:.1%} of the {b5['bound_ms']:.4f} ms "
                f"bound ({b5['bound_by']}; the 42 MB fit the 50 MB L2), {lib_ms / dev_ms:.2f}x "
                f"faster than the library's {lib_ms:.4f} ms; back-to-back wrapper calls "
                f"{ms:.4f} ms | K2's kernel on the same memory as (256, 16, 1, 20*64): replays "
                f"{k2_dev_ms:.4f} ms, wrapper calls {k2_ms:.4f} ms, output bit-identical {same}")
            check(same, "K5's tensor-core kernel differs from K2's on the same memory")
        del q, k, v, out, ref
    # the bf16 route at T = 1, 5, 16, 17 and 32 (one m16 tile of rows, then
    # two), G = 1, 3, 257 and 4096, and at head dim 32 (the SIMT route), at
    # scales 0.125 and -0.125: against plain, NaN sentinels past the output,
    # three runs bit-identical, and the kernel `torch.profiler` records as
    # the witness of the route. The inputs come from a generator of this
    # phase's own, so later phases draw what they drew before these checks.
    local_gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    k5_cases = [(1, 1, 3, 64), (3, 5, 3, 64), (257, 16, 5, 64), (4096, 17, 2, 64),
                (257, 32, 3, 64), (3, 16, 3, 32), (257, 16, 5, 32)]
    k5_names = fresh_process_kernel_names(k5_cases)
    for g, tk, h, d in k5_cases:
        q, k, v = (torch.randn(g, tk, h * d, device=dev, generator=local_gen).to(bf16)
                   for _ in range(3))
        rels = {sc: errors(small_t_fwd(q, k, v, h, sc),
                           small_t_fwd_plain(q.float(), k.float(), v.float(), h, sc))[1]
                for sc in (0.125, -0.125)}
        check(max(rels.values()) <= 1e-2, f"K5 bf16 rel L2 {rels} > 1e-2 at {(g, tk, h, d)}")
        buf = torch.full((q.numel() + 4096,), float("nan"), device=dev, dtype=bf16)
        kernels.check(kernels.library().dct_small_t_fwd_posmajor(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), kernels.DTYPE_CODES[bf16],
            g, tk, h, d, 0.125, kernels.stream_handle(dev)), "dct_small_t_fwd_posmajor")
        first, second = (small_t_fwd(q, k, v, h, 0.125) for _ in range(2))
        names = k5_names[str((g, tk, h, d))]
        torch.cuda.synchronize()
        intact = bool(buf[q.numel():].isnan().all())
        same = torch.equal(buf[:q.numel()].view_as(q), first) and torch.equal(first, second)
        want = (f"small_t_posmajor_tc_kernel<{1 if tk <= 16 else 2}>" if d == 64
                else "small_t_posmajor_kernel<__nv_bfloat16>")
        log(f"[10] K5 ({g}, {tk}, {h}*{d}) bf16 {'tensor cores' if d == 64 else 'SIMT'}: "
            f"rel_l2 {rels[0.125]:.3e} at scale 0.125, {rels[-0.125]:.3e} at -0.125 (tol 1e-2), "
            f"NaN sentinels intact {intact}, three runs bit-identical {same}, kernel {names}")
        check(intact, f"K5 wrote past its output at {(g, tk, h, d)}")
        check(same, f"K5 bf16 runs differ at {(g, tk, h, d)}")
        check(len(names) == 1 and want in names[0], f"K5 at {(g, tk, h, d)} ran {names}")
        del q, k, v, buf, first, second
    # why the route has no row threshold (the JAX rule wants 256 rows): K5
    # against plain attention on (rows, 16, 20, 64) bf16, from --bs 2 up
    for g in (32, 64, 256, 1024, 4096):
        q, k, v = (torch.randn(g, 16, 20, 64, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        ms = cuda_ms(lambda: small_t_attention(q, k, v), iters=50)
        plain_ms = cuda_ms(lambda: attention.plain_attention(q, k, v), iters=50)
        rel = errors(small_t_attention(q, k, v), attention.plain_attention(q, k, v))[1]
        log(f"[10] route ({g}, 16, 20, 64) bf16: small_t_attention (K5) {ms:.4f} ms, "
            f"plain_attention {plain_ms:.4f} ms, rel_l2 between them {rel:.3e}")
        check(rel <= 2e-2, f"K5 vs plain_attention rel L2 {rel} at G={g}")
        del q, k, v
    phase_s["10"] = time.perf_counter() - t0

    # -- phase 11: K1 at the 576x1024 shapes ----------------------------------
    t0 = time.perf_counter()
    for l, h in [(9216, 5), (2304, 10), (2301, 10)]:
        q, k, v = draw_qkv(16, l, l, h, torch.bfloat16)
        # one N = 16 launch, as the path makes it, held against the plain
        # version two rows of N at a time (its logits are N*H*L^2)
        full = flash_fwd(q, k, v, h, 0.125)
        torch.cuda.synchronize()
        max_abs = rel = 0.0
        for i in range(0, 16, 2):
            ref = flash_fwd_plain(q[i:i + 2].float(), k[i:i + 2].float(), v[i:i + 2].float(),
                                  h, 0.125)
            a, r = errors(full[i:i + 2], ref)
            max_abs, rel = max(max_abs, a), max(rel, r)
            del ref
        ms = cuda_ms(lambda: flash_fwd(q, k, v, h, 0.125), iters=5, warmup=1)
        lib_ms = sdpa_ms(q, k, v, h, iters=5)
        b = attention_bound(16, l, l, h, 64, torch.bfloat16)
        log(f"[11] K1 flash_fwd (16, {l}, {h}*64) bf16: one N=16 launch vs plain in eight "
            f"N=2 slices, worst slice max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 1e-2) | "
            f"kernel {rate(ms, 16, l, l, h, lib_ms)}, bound {b['bound_ms']:.3f} ms by "
            f"{b['bound_by']}")
        report["flash_fwd"].setdefault("by_shape", {})[f"(16, {l}, {h}*64)"] = dict(
            ms=ms, library_ms=lib_ms, rel_l2=rel, **b)
        check(rel <= 1e-2, f"K1 rel L2 {rel} > 1e-2 at N=16, L={l}")
        del q, k, v, full
    torch.cuda.empty_cache()
    phase_s["11"] = time.perf_counter() - t0

    # -- phase 12: full-width 256x256 UNet forward, kernels vs plain ----------
    t0 = time.perf_counter()
    infer_wrappers = infer_kernels()
    cfg = ModelConfig.from_yaml(CONFIG_256)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(cfg.unet))
    unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
    init_normal_(unet.requires_grad_(False), gen, 0.02)
    x = torch.randn(16, 16, 32, 32, 8, device=dev, generator=gen)
    ts = torch.full((16,), 999, dtype=torch.long, device=dev)
    ctx_t = torch.randn(16, 77, 1024, device=dev, generator=gen)
    ctx_i = torch.randn(16, 16, 16, 1024, device=dev, generator=gen)
    fs = torch.full((16,), 3, dtype=torch.long, device=dev)
    run = lambda: unet(x, ts, context_text=ctx_t, context_img=ctx_i, fs=fs)
    with torch.no_grad():
        reset(*infer_wrappers)
        out = run()
        torch.cuda.synchronize()
        per_call_256 = counts(*infer_wrappers)
        with attention.use_backend("plain"):
            ref = run()
        max_abs, rel = errors(out, ref)
        ms = cuda_ms(run, iters=3, warmup=1)
        with attention.use_backend("plain"):
            plain_ms = cuda_ms(run, iters=3, warmup=1)
    log(f"[12] UNet forward {CONFIG_256} (16, 16, 32, 32, 8) bf16: out {tuple(out.shape)} "
        f"finite {bool(torch.isfinite(out).all())} | kernels vs plain max_abs {max_abs:.3e} "
        f"rel_l2 {rel:.3e} (tol 2e-2) | launches per call K1 {per_call_256[0]} (L = 1024 < "
        f"2048), K2 {per_call_256[1]} (17 temporal transformers x attn1 + attn2), K5 "
        f"{per_call_256[2]} (the middle block's 4 x 4 frame: attn1, and attn2's image "
        f"cross-attention, whose 16 image tokens per frame give k and v the shape of q) | "
        f"{ms:.1f} ms with kernels, {plain_ms:.1f} ms plain")
    # profile_unet's kernel families of one such call, in a process of its
    # own (see fresh_process_kernel_names)
    prof = subprocess.run([sys.executable, "-m", "dynamicrafter_tpu_torch.profile_unet",
                           "--config", CONFIG_256, "--batch", "16", "--height", "256",
                           "--width", "256"], capture_output=True, text=True, timeout=600,
                          check=True, cwd=REPO).stdout
    fam_256 = {m.group(1).strip(): float(m.group(2))
               for m in re.finditer(r"^  (\S.*?)\s+([\d.]+) ms\s+[\d.]+ %$", prof, re.M)}
    log(f"[12] profile_unet, one call of that UNet: "
        + re.search(r"[\d.]+ ms per call unprofiled.*? device time [\d.]+ ms per call",
                    prof).group(0)
        + f"; K5 family {fam_256.get('K5 small_t_fwd', 0.0):.2f} ms, K2 family "
        f"{fam_256.get('K2 small_t_kernel', 0.0):.2f} ms")
    check(fam_256.get("K5 small_t_fwd", 0.0) > 0, "the profile of a 256 UNet call has no K5 kernel")
    check(bool(torch.isfinite(out).all()) and out.shape == (16, 16, 32, 32, 4), "256 UNet output")
    check(rel <= 2e-2, f"256 UNet kernels vs plain rel L2 {rel} > 2e-2")
    check(per_call_256 == (0, 34, 2), f"launches per 256 UNet call {per_call_256} != (0, 34, 2)")
    del unet, x, out, ref
    torch.cuda.empty_cache()
    phase_s["12"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        # -- phase 13: the 256x256 slice end to end, 8 prompts in one batch ---
        t0 = time.perf_counter()
        launches_256, _, peak_256 = run_cli("13 slice 256x256 --bs 8", [
            "--config", CONFIG_256, "--prompt_dir",
            prompt_dir(os.path.join(tmp, "p256"), 8),
            "--savedir", os.path.join(tmp, "o256"), "--height", "256", "--width", "256",
            "--frame_stride", "3", "--timestep_spacing", "uniform", "--bs", "8"],
            (8, 1, 16, 256, 256, 3), STEPS)
        check(launches_256 == tuple(STEPS * c for c in per_call_256),
              f"launches on the 256 slice {launches_256} != {STEPS} x {per_call_256}")
        phase_s["13"] = time.perf_counter() - t0

        # -- phase 14: the 576x1024 slice end to end ----------------------------
        t0 = time.perf_counter()
        # first the full-width UNet, kernels against plain, cut to 2 frames
        # (the plain logits of 16 frames at L = 9216 are 13.6 GB in bf16)
        cfg = ModelConfig.from_yaml(CONFIG_1024)
        with torch.device("meta"):
            unet = UNetModel(UNetConfig.from_dict(cfg.unet))
        unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
        init_normal_(unet.requires_grad_(False), gen, 0.02)
        x = torch.randn(1, 2, 72, 128, 8, device=dev, generator=gen)
        one = lambda v: torch.full((1,), v, dtype=torch.long, device=dev)
        ctx_t = torch.randn(1, 77, 1024, device=dev, generator=gen)
        ctx_i = torch.randn(1, 2, 16, 1024, device=dev, generator=gen)
        run = lambda: unet(x, one(999), context_text=ctx_t, context_img=ctx_i, fs=one(10))
        with torch.no_grad():
            reset(*infer_wrappers)
            out = run()
            per_pass_1024 = counts(*infer_wrappers)
            with attention.use_backend("plain"):
                ref = run()
        max_abs, rel = errors(out, ref)
        log(f"[14] UNet forward {CONFIG_1024} cut to 2 frames (1, 2, 72, 128, 8) bf16: "
            f"kernels vs plain max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 2e-2) | launches "
            f"per pass K1 {per_pass_1024[0]} (5 level-0 spatial transformers at L = 9216, 5 "
            f"level-1 at L = 2304), K2 {per_pass_1024[1]}, K5 {per_pass_1024[2]}")
        check(bool(torch.isfinite(out).all()) and rel <= 2e-2,
              f"1024 UNet kernels vs plain rel L2 {rel} > 2e-2")
        check(per_pass_1024 == (10, 34, 0), f"launches per 1024 pass {per_pass_1024}")
        # a DeepCache shallow call (`UNetModel.forward` with `cache=`) runs the
        # 2 input and 3 output blocks of level 0, each with one spatial
        # transformer (K1: L = 9216 here, but L = 1024 at 256x256, below
        # flash's 2048) and one temporal transformer (K2: attn1 and attn2), and
        # init_attn (K2 twice); no middle block, so no K5 at 256x256
        shallow_1024, shallow_256 = (5, 12, 0), (0, 12, 0)
        del unet, x, out, ref
        launches_1024, stages_1024, peak_1024_infer = run_cli(
            "14 slice 576x1024 sequential CFG, tiled decode", [
            "--config", CONFIG_1024, "--prompt_dir",
            prompt_dir(os.path.join(tmp, "p1024"), 1),
            "--savedir", os.path.join(tmp, "o1024"), "--height", "576", "--width", "1024",
            "--frame_stride", "10", "--timestep_spacing", "uniform_trailing",
            "--guidance_rescale", "0.7", "--perframe_ae", "--bs", "1"],
            (1, 1, 16, 576, 1024, 3), STEPS_1024)
        # per pass of 16 frames: K1 at the 5 level-0 (L = 9216, 5 heads) and the
        # 5 level-1 (L = 2304, 10 heads) spatial transformers, K2 as everywhere
        check(launches_1024 == tuple(STEPS_1024 * 2 * c for c in per_pass_1024),
              f"launches on the 1024 slice {launches_1024} != {STEPS_1024} steps x 2 passes "
              f"x {per_pass_1024}")
        fit_s = {}
        for size in ((576, 1024), (256, 256)):
            t1 = time.perf_counter()
            load_image(os.path.join(PROMPTS, "example.png"), size)
            fit_s[size] = time.perf_counter() - t1
        log("[14] load_image of the 320x512 example on the host (a prompt image each run): "
            + ", ".join(f"to {h}x{w} {sec:.4f}s" for (h, w), sec in fit_s.items()))
        phase_s["14"] = time.perf_counter() - t0

        # -- phase 15: interpolation and looping on the 320x512 model -----------
        t0 = time.perf_counter()
        flags_512 = ["--config", CONFIG, "--height", "320", "--width", "512", "--frame_stride",
                     "5", "--timestep_spacing", "uniform_trailing", "--guidance_rescale", "0.7",
                     "--perframe_ae"]
        n_interp, _, _ = run_cli("15 --interp 320x512, two images", [
            *flags_512, "--interp", "--prompt_dir",
            prompt_dir(os.path.join(tmp, "pinterp"), 1, images_per_prompt=2),
            "--savedir", os.path.join(tmp, "ointerp")], (1, 1, 16, 320, 512, 3), STEPS_INTERP)
        n_loop, _, _ = run_cli("15 --loop 320x512, last frame dropped", [
            *flags_512, "--loop", "--prompt_dir", PROMPTS,
            "--savedir", os.path.join(tmp, "oloop")], (1, 1, 15, 320, 512, 3), STEPS_INTERP)
        check(n_interp == n_loop == (STEPS_INTERP * per_call[0], STEPS_INTERP * per_call[1], 0),
              f"launches in interp {n_interp} / loop {n_loop}")
        phase_s["15"] = time.perf_counter() - t0

        # -- phase 16: dpm, unipc and DeepCache on the 320x512 model -------------
        t0 = time.perf_counter()
        # a shallow call runs the level-0 blocks only: all 5 level-0 spatial
        # transformers (K1), and of the 17 temporal transformers `init_attn`
        # and the 5 of level 0 (K2 twice each: attn1 and attn2)
        shallow_512 = (5, 12, 0)
        runs_512 = sampler_runs("16 320x512", tmp, [
            *flags_512, "--frame_stride", "24", "--prompt_dir", PROMPTS],
            (1, 1, 16, 320, 512, 3), "uniform_trailing", (*per_call, 0), shallow_512, passes=1)
        log(f"[16] launches as counted (a full call K1 K2 {per_call}, a DeepCache shallow one "
            f"{shallow_512[:2]}) | sampler loop per clip: "
            + " ".join(f"{k} {st['ddim']:.2f}s" for k, (_, st, _) in runs_512.items()))
        phase_s["16"] = time.perf_counter() - t0

    # -- phase 17: the DeepCache seam and a dpm step at the full-width UNet ----
    t0 = time.perf_counter()
    cfg = ModelConfig.from_yaml(CONFIG)
    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(cfg.unet))
    unet = keep_norms_fp32(unet.to_empty(device=dev).to(torch.bfloat16)).eval()
    init_normal_(unet.requires_grad_(False), gen, 0.02)
    x = torch.randn(2, 16, 40, 64, 8, device=dev, generator=gen)
    ts = torch.full((2,), 999, dtype=torch.long, device=dev)
    ctx_t = torch.randn(2, 77, 1024, device=dev, generator=gen)
    ctx_i = torch.randn(2, 16, 16, 1024, device=dev, generator=gen)
    fs = torch.full((2,), 24, dtype=torch.long, device=dev)
    kw = dict(context_text=ctx_t, context_img=ctx_i, fs=fs)
    with torch.no_grad():
        full, cache = unet(x, ts, return_cache=True, **kw)
        reset(*infer_wrappers)
        from_cache = unet(x, ts, cache=cache, **kw)
        torch.cuda.synchronize()
        n_shallow = counts(*infer_wrappers)
        max_abs, rel = errors(from_cache, full)
        full_ms = cuda_ms(lambda: unet(x, ts, **kw), iters=5, warmup=1)
        shallow_ms = cuda_ms(lambda: unet(x, ts, cache=cache, **kw), iters=5, warmup=1)
    log(f"[17] DeepCache seam, UNet {CONFIG} (2, 16, 40, 64, 8) bf16: cache "
        f"{tuple(cache.shape)} {str(cache.dtype)[6:]} | shallow(x, t, cache=full_cache(x, t)) "
        f"vs the full forward max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 1e-3), exactly "
        f"equal {bool(torch.equal(from_cache, full))} | launches of a shallow call K1 "
        f"{n_shallow[0]} K2 {n_shallow[1]} K5 {n_shallow[2]} | full call {full_ms:.1f} ms, "
        f"shallow call {shallow_ms:.1f} ms")
    check(cache.shape == (2, 16, 40, 64, 640), f"cache shape {tuple(cache.shape)}")
    check(rel <= 1e-3, f"shallow-from-own-cache vs full rel L2 {rel} > 1e-3")
    check(n_shallow == shallow_512, f"launches of a shallow call {n_shallow} != {shallow_512}")
    # two steps of DPM-Solver++(2M) (the second uses the history) under batched
    # CFG with guidance rescale, as the 512 preset samples
    schedule = build_schedule(
        timesteps=cfg.timesteps, beta_schedule=cfg.beta_schedule,
        linear_start=cfg.linear_start, linear_end=cfg.linear_end, cosine_s=cfg.cosine_s,
        parameterization=cfg.parameterization,
        rescale_betas_zero_snr=cfg.rescale_betas_zero_snr,
        use_dynamic_rescale=cfg.use_dynamic_rescale, base_scale=cfg.base_scale,
        turning_step=cfg.turning_step)
    settings = SamplerSettings(steps=2, discretize="uniform_trailing", eta=0.0, cfg_scale=7.5,
                               guidance_rescale=0.7, parameterization=cfg.parameterization,
                               sampler="dpm")
    table = build_ddim_table(schedule, num_steps=2, discretize="uniform_trailing", eta=0.0)
    cond = CFGConditioning(
        context_text=ctx_t[:, None], context_img=ctx_i[:, None],
        concat=torch.randn(2, 1, 16, 40, 64, 4, device=dev, generator=gen), fs=fs[:1])
    x_T = torch.randn(1, 16, 40, 64, 4, device=dev, generator=gen)
    model_fn = make_cfg_denoiser(unet, cond, settings)
    z = dpm_sample(model_fn, x_T, schedule, table, settings)
    with attention.use_backend("plain"):
        z_plain = dpm_sample(model_fn, x_T, schedule, table, settings)
    max_abs, rel = errors(z, z_plain)
    log(f"[17] two DPM-Solver++(2M) steps, batched CFG 7.5 with rescale 0.7, latent "
        f"{tuple(z.shape)}: kernels vs plain max_abs {max_abs:.3e} rel_l2 {rel:.3e} (tol 2e-2) "
        f"finite {bool(torch.isfinite(z).all())}")
    check(bool(torch.isfinite(z).all()) and rel <= 2e-2, f"dpm kernels vs plain rel L2 {rel}")
    # phase 22 takes one level-0 ResBlock (320 -> 320) of this UNet
    resblock = next(m for m in unet.modules() if isinstance(m, ResBlock)
                    and m.in_layers[2].in_channels == m.in_layers[2].out_channels
                    == unet.config.model_channels)
    del unet, x, full, cache, from_cache, cond, x_T, z, z_plain, model_fn
    torch.cuda.empty_cache()
    phase_s["17"] = time.perf_counter() - t0

    # -- phase 18: K6, K9, K10 against their plain versions --------------------
    t0 = time.perf_counter()
    variants = {
        "K6 flash_fwd_packed": flash_fwd_packed,
        "K9 flash_attention_pairs": flash_attention_pairs,
        "K10 run_variant exp": lambda *a: run_variant(*a, "exp"),
        "K10 run_variant exp2": lambda *a: run_variant(*a, "exp2"),
    }
    nosoftmax = lambda *a: run_variant(*a, "nosoftmax")
    variant_tol = {bf16: 5e-3, fp32: 1e-5}
    worst = {}   # (kernel, dtype) -> (max_abs, rel) over every shape

    def hold(name, out, ref, dtype, what):
        a, r = errors(out, ref)
        w = worst.get((name, dtype), (0.0, 0.0))
        worst[(name, dtype)] = (max(w[0], a), max(w[1], r))
        check(r <= variant_tol[dtype],
              f"{name} rel L2 {r} > {variant_tol[dtype]} at {what} {str(dtype)[6:]}")
        return r

    # q and k scaled as the benches scale them: logits on both sides of +-1
    bench_scales = (0.6, 0.6, 1.0)

    # whole at the 320x512 shape; ragged L, Lq != Lk, H = 1, 5 and 20, two groups
    for n, lq, lk, h in [(32, 2560, 2560, 5), (4, 300, 300, 5), (3, 130, 77, 1),
                         (2, 200, 333, 20), (2, 97, 150, 7)]:
        for dtype in (bf16, fp32):
            q, k, v = draw_qkv(n, lq, lk, h, dtype, bench_scales)
            ref = flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
            rels = {name: hold(name, fn(q, k, v, h, 0.125), ref, dtype, (n, lq, lk, h))
                    for name, fn in variants.items()}
            ref = run_variant_plain(q.float(), k.float(), v.float(), h, 0.125, "nosoftmax")
            rels["K10 run_variant nosoftmax"] = hold(
                "K10 run_variant nosoftmax", nosoftmax(q, k, v, h, 0.125), ref, dtype,
                (n, lq, lk, h))
            log(f"[18] ({n}, Lq {lq}, Lk {lk}, {h}*64) {str(dtype)[6:]} rel_l2 vs plain: "
                + ", ".join(f"{name} {r:.3e}" for name, r in rels.items())
                + f" (tol {variant_tol[dtype]:g})")
            if dtype == bf16:
                check(torch.equal(run_variant(q, k, v, h, 0.125, "exp2"),
                                  flash_fwd(q, k, v, h, 0.125)),
                      f"bf16 K10 exp2 differs from K1 at {(n, lq, lk, h)}")
            if (n, lq, dtype) == (32, 2560, bf16):
                outs = {"K1 flash_fwd": flash_fwd(q, k, v, h, 0.125),
                        **{name: fn(q, k, v, h, 0.125) for name, fn in variants.items()}}
                names = list(outs)
                pair_rel = max(errors(outs[a], outs[b])[1]
                               for i, a in enumerate(names) for b in names[i + 1:])
                log(f"[18] K1, K6, K9, K10 exp, K10 exp2 on the same bf16 inputs: largest "
                    f"pairwise rel_l2 {pair_rel:.3e} (tol 5e-3)")
                check(pair_rel <= 5e-3, f"variants disagree pairwise: rel L2 {pair_rel}")
                del outs
            del q, k, v, ref
    # the 576x1024 shapes: one N = 32 launch, held against the plain version
    # two rows of N at a time (its logits at N = 32, L = 9216 are 54 GB in fp32)
    for l, h in [(9216, 5), (2304, 10)]:
        for dtype in (bf16, fp32):
            q, k, v = draw_qkv(32, l, l, h, dtype, bench_scales)
            outs = {name: fn(q, k, v, h, 0.125) for name, fn in variants.items()}
            out_ns = nosoftmax(q, k, v, h, 0.125)
            torch.cuda.synchronize()
            rels = dict.fromkeys([*outs, "K10 run_variant nosoftmax"], 0.0)
            for i in range(0, 32, 2):
                sl = slice(i, i + 2)
                args = (q[sl].float(), k[sl].float(), v[sl].float(), h, 0.125)
                ref = flash_fwd_plain(*args)
                for name, out in outs.items():
                    rels[name] = max(rels[name], hold(name, out[sl], ref, dtype, (32, l, h)))
                ref = run_variant_plain(*args, "nosoftmax")
                rels["K10 run_variant nosoftmax"] = max(
                    rels["K10 run_variant nosoftmax"],
                    hold("K10 run_variant nosoftmax", out_ns[sl], ref, dtype, (32, l, h)))
                del ref
            log(f"[18] (32, {l}, {h}*64) {str(dtype)[6:]}: one N=32 launch vs plain in sixteen "
                f"N=2 slices, worst slice rel_l2: "
                + ", ".join(f"{name} {r:.3e}" for name, r in rels.items())
                + f" (tol {variant_tol[dtype]:g})")
            if dtype == bf16:
                check(torch.equal(outs["K10 run_variant exp2"], flash_fwd(q, k, v, h, 0.125)),
                      f"bf16 K10 exp2 differs from K1 at (32, {l}, {h})")
            del q, k, v, outs, out_ns
    # K9 at odd H: a guard region right behind the output keeps its fill
    for h in (1, 5):
        q, k, v = draw_qkv(2, 100, 77, h, bf16, bench_scales)
        buf = torch.full((q.numel() + 4096,), 7.0, device=dev, dtype=bf16)
        out = buf[:q.numel()].view_as(q)
        kernels.check(kernels.library().dct_flash_fwd_pairs(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kernels.DTYPE_CODES[bf16],
            2, 100, 77, h, 0.125, kernels.stream_handle(dev)), "dct_flash_fwd_pairs")
        torch.cuda.synchronize()
        intact = bool((buf[q.numel():] == 7.0).all())
        rel = errors(out, flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125))[1]
        log(f"[18] K9 at H = {h} into the head of a larger buffer: guard region intact "
            f"{intact}, rel_l2 {rel:.3e}")
        check(intact and rel <= 5e-3, f"K9 wrote past H*64 columns at H = {h}")
        del q, k, v, buf, out
    # bf16 K6, K9 and the K10 modes (tensor cores) at the card tests' shapes:
    # any scale, no write past the output, three runs bit-identical, K10 exp2
    # equal to K1 (at -0.125: K1 on -q, as K10 moves the sign into Q). The
    # inputs come from a generator of this phase's own, so later phases draw
    # what they drew before these checks existed.
    local_gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    tc_entries = {"K6": (flash_fwd_packed, "dct_flash_fwd_packed"),
                  "K9": (flash_attention_pairs, "dct_flash_fwd_pairs"),
                  **{f"K10 {m}": ((lambda *a, m=m: run_variant(*a, m)), m)
                     for m in ("exp", "exp2", "nosoftmax")}}

    def entry_call(entry, q, k, v, out, n, lq, lk, h):
        """The library entry of a tc_entries row, writing into `out`."""
        lib = kernels.library()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                kernels.DTYPE_CODES[bf16])
        if entry in bench_flash_variants.MODES:
            code = lib.dct_flash_variant(*args, bench_flash_variants.MODES[entry], n, lq, lk, h,
                                         0.125, kernels.stream_handle(dev))
        else:
            code = getattr(lib, entry)(*args, n, lq, lk, h, 0.125, kernels.stream_handle(dev))
        kernels.check(code, entry)

    for n, lq, lk, h in [(2, 300, 300, 5), (2, 2560, 2560, 5), (2, 130, 77, 1), (1, 200, 333, 20),
                         (2, 64, 32, 2), (1, 97, 150, 7), (1, 2304, 2304, 10)]:
        q, k, v = (torch.randn(n, ln, h * 64, device=dev, generator=local_gen).to(bf16)
                   for ln in (lq, lk, lk))
        refs = {sc: flash_fwd_plain(q.float(), k.float(), v.float(), h, sc) for sc in (0.3, -0.125)}
        refs_ns = {sc: run_variant_plain(q.float(), k.float(), v.float(), h, sc, "nosoftmax")
                   for sc in (0.3, -0.125)}
        parts = []
        for name, (fn, entry) in tc_entries.items():
            rels = {sc: errors(fn(q, k, v, h, sc), ref)[1]
                    for sc, ref in (refs_ns if entry == "nosoftmax" else refs).items()}
            check(max(rels.values()) <= 5e-3,
                  f"{name} bf16 rel L2 {rels} > 5e-3 at scales 0.3, -0.125, {(n, lq, lk, h)}")
            if entry == "exp2":
                check(torch.equal(fn(q, k, v, h, 0.3), flash_fwd(q, k, v, h, 0.3))
                      and torch.equal(fn(q, k, v, h, -0.125), flash_fwd(-q, k, v, h, 0.125)),
                      f"bf16 K10 exp2 differs from K1 at scale 0.3 or -0.125, {(n, lq, lk, h)}")
            buf = torch.full((q.numel() + 4096,), float("nan"), device=dev, dtype=bf16)
            entry_call(entry, q, k, v, buf, n, lq, lk, h)
            first, second = fn(q, k, v, h, 0.125), fn(q, k, v, h, 0.125)
            torch.cuda.synchronize()
            intact = bool(buf[q.numel():].isnan().all())
            same = torch.equal(buf[:q.numel()].view_as(q), first) and torch.equal(first, second)
            check(intact, f"{name} wrote past its output at {(n, lq, lk, h)}")
            check(same, f"{name} bf16 runs differ at {(n, lq, lk, h)}")
            parts.append(f"{name} rel_l2 {rels[0.3]:.3e} at scale 0.3, {rels[-0.125]:.3e} at "
                         f"-0.125, NaN sentinels intact, three runs bit-identical")
        log(f"[18] ({n}, Lq {lq}, Lk {lk}, {h}*64) bf16 tensor cores: " + "; ".join(parts)
            + " (tol 5e-3); K10 exp2 equal to K1 bit for bit at 0.3 and -0.125")
        del q, k, v, refs, refs_ns, buf, first, second
    torch.cuda.empty_cache()
    phase_s["18"] = time.perf_counter() - t0

    # -- phase 19: the bench entry points (K9, K10) and packed=True (K6) --------
    t0 = time.perf_counter()
    variant_wrappers = (flash_fwd_packed, flash_attention_pairs, run_variant)
    reset(*variant_wrappers)
    rows = bench_flash_variants.main([]) + bench_flash_pairs.main([])
    bench_ms = {(r["L"], r["heads"], r["row"]): r["ms"] for r in rows}
    by_shape = {name: {} for name in ("flash_fwd_packed", "flash_attention_pairs",
                                      "run_variant")}
    for label, n, l, h in bench_flash_variants.CASES:
        q, k, v = bench_flash_variants.case_inputs(n, l, h, dev)
        q4, k4, v4 = (a.view(n, l, h, 64) for a in (q, k, v))
        # K6 (through its entry point), K9 and K1 timed in turn in one loop,
        # so that clock drift between separate loops cannot tell them apart;
        # then K1 and K10's three modes in a loop of their own, so that the
        # first loop stays as earlier runs timed it (in one loop of six, K1
        # itself read slower at L = 2560, and K6 and K9 with it)
        def in_turn(turns):
            """5 rounds of 10 calls of each, in turn: every name's times."""
            alt = {name: [] for name in turns}
            for _ in range(5):
                for name, fn in turns.items():
                    alt[name].append(cuda_ms(fn, iters=10, warmup=1))
            return alt

        alt = in_turn({"K6": lambda: flash_attention(q4, k4, v4, packed=True),
                       "K9": lambda: flash_attention_pairs(q, k, v, h, 0.125),
                       "K1": lambda: flash_fwd(q, k, v, h, 0.125)})
        alt10 = in_turn({"K1": lambda: flash_fwd(q, k, v, h, 0.125),
                         **{f"K10 {m}": (lambda m=m: run_variant(q, k, v, h, 0.125, m))
                            for m in ("exp", "exp2", "nosoftmax")}})
        alt_ms = {name: sorted(t)[2] for name, t in alt.items()}
        alt10_ms = {name: sorted(t)[2] for name, t in alt10.items()}
        lib_ms = sdpa_ms(q, k, v, h, iters=10)
        b = attention_bound(n, l, l, h, 64, bf16)
        shape = f"({n}, {l}, {h}*64)"
        common = dict(k1_ms=bench_ms[(l, h, "K1 flash_fwd")], library_ms=lib_ms, **b)
        by_shape["flash_fwd_packed"][shape] = dict(ms=alt_ms["K6"], **common)
        by_shape["flash_attention_pairs"][shape] = dict(ms=alt_ms["K9"], **common)
        by_shape["run_variant"][shape] = dict(
            ms=alt10_ms["K10 exp"],
            ms_by_mode={m: alt10_ms[f"K10 {m}"] for m in ("exp", "exp2", "nosoftmax")},
            k1_in_turn_ms=alt10_ms["K1"],
            bench_ms_by_mode={m: bench_ms[(l, h, f"K10 {m}")]
                              for m in ("exp", "exp2", "nosoftmax")},
            softmax_share=1 - alt10_ms["K10 nosoftmax"] / alt10_ms["K10 exp2"], **common)
        if l == 2560:
            plain_ms = cuda_ms(lambda: flash_fwd_plain(q, k, v, h, 0.125))
            plain_ns_ms = cuda_ms(lambda: run_variant_plain(q, k, v, h, 0.125, "nosoftmax"))
        modes = by_shape["run_variant"][shape]["bench_ms_by_mode"]
        log(f"[19] {label.strip()} bf16 bench entry points: K1 {common['k1_ms']:.3f} ms | "
            f"K9 pairs {bench_ms[(l, h, 'K9 pairs')]:.3f} | K10 exp {modes['exp']:.3f} exp2 "
            f"{modes['exp2']:.3f} nosoftmax {modes['nosoftmax']:.3f} | library {lib_ms:.3f} | "
            f"bound {b['bound_ms']:.3f} ms by {b['bound_by']}")
        for what, times, ms_of in (("K6, K9, K1", alt, alt_ms), ("K1, K10", alt10, alt10_ms)):
            log(f"[19] {label.strip()} bf16 {what} in turn (5 rounds of 10 calls, median; "
                "min-max): " + ", ".join(f"{name} {ms_of[name]:.3f} ({min(t):.3f}-{max(t):.3f})"
                                         for name, t in times.items()) + " ms")
            log(f"[19] {label.strip()} bf16 rates: " + ", ".join(
                    f"{name} " + rate(ms_of[name], n, l, l, h, lib_ms) for name in ms_of)
                + " | share of the bound: " + ", ".join(
                    f"{name} {b['bound_ms'] / ms_of[name]:.1%}" for name in ms_of)
                + " | / K1: " + ", ".join(f"{name} {ms_of[name] / ms_of['K1']:.3f}"
                                          for name in ms_of if name != "K1"))
        log(f"[19] {label.strip()} bf16 softmax share of the tensor-core loop, 1 - nosoftmax / "
            f"exp2: {by_shape['run_variant'][shape]['softmax_share']:.1%}")
        del q, k, v, q4, k4, v4
    variant_launches = counts(*variant_wrappers)
    first = "(32, 2560, 5*64)"
    for name, label in (("flash_fwd_packed", "K6 flash_fwd_packed"),
                        ("flash_attention_pairs", "K9 flash_attention_pairs"),
                        ("run_variant", "K10 run_variant exp")):
        at = by_shape[name][first]
        report[name] = dict(max_abs_err=worst[(label, bf16)][0], ms=at["ms"], plain_ms=plain_ms,
                            bound_ms=at["bound_ms"], bound_by=at["bound_by"],
                            library_ms=at["library_ms"], by_shape=by_shape[name])
    report["run_variant"].update(
        ms_by_mode=by_shape["run_variant"][first]["ms_by_mode"],
        softmax_share=by_shape["run_variant"][first]["softmax_share"],
        plain_ms_nosoftmax=plain_ns_ms,
        max_abs_err_by_mode={m: worst[(f"K10 run_variant {m}", bf16)][0]
                             for m in ("exp", "exp2", "nosoftmax")})
    log(f"[19] launches: K6 {variant_launches[0]} (flash_attention(packed=True) at the three "
        f"shapes), K9 {variant_launches[1]} (bench_flash_pairs.main and the turns), K10 "
        f"{variant_launches[2]} (bench_flash_variants.main and the turns, three modes) | plain "
        f"at {first}: attention {plain_ms:.3f} ms, nosoftmax {plain_ns_ms:.3f} ms")
    torch.cuda.empty_cache()
    phase_s["19"] = time.perf_counter() - t0


    # -- phase 20: K7 and K8 against their plain versions -----------------------
    t0 = time.perf_counter()
    conv_tol = {fp32: 1e-5, bf16: 1e-2}   # bf16: one rounding of each output, 2^-9 relative

    def conv_check(tag, shape, tile_h, dtype, emb):
        n, h, w, c, co = shape
        ops = list(bench_fused_conv.case_inputs(n, h, w, c, co, dev, dtype))
        if not emb:
            ops[5] = None
        out7 = fused_gn_silu_conv(*ops)
        out8 = fused_gn_silu_conv_tiled(*ops, tile_h=tile_h)
        torch.cuda.synchronize()
        e7 = errors(out7, fused_gn_silu_conv_plain(*ops))
        e8 = errors(out8, fused_gn_silu_conv_tiled_plain(*ops, tile_h=tile_h))
        between = errors(out7, out8)[1]
        log(f"[{tag}] ({n}, {h}, {w}, {c} -> {co}) {str(dtype)[6:]} emb {emb}: K7 max_abs "
            f"{e7[0]:.3e} rel_l2 {e7[1]:.3e}, K8 (tile_h {tile_h}) max_abs {e8[0]:.3e} rel_l2 "
            f"{e8[1]:.3e} (tol {conv_tol[dtype]:g}) | K7 vs K8 rel_l2 {between:.3e}")
        check(e7[1] <= conv_tol[dtype], f"K7 rel L2 {e7[1]} at {shape} {dtype} emb {emb}")
        check(e8[1] <= conv_tol[dtype], f"K8 rel L2 {e8[1]} at {shape} {dtype} emb {emb}")
        if dtype == fp32:
            check(between <= 1e-5, f"K7 vs K8 in fp32 rel L2 {between} at {shape}")
        return e7, e8

    for shape, tile_h in [((2, 8, 12, 64, 64), 8), ((1, 5, 7, 32, 32), 5),
                          ((2, 8, 14, 64, 64), 4), ((2, 20, 32, 320, 640), 4)]:
        for dtype in (fp32, bf16):
            for emb in (False, True):
                conv_check("20", shape, tile_h, dtype, emb)

    # the bf16 route (gn_stats, then the wgmma conv) at the edges of its
    # tiling, from a generator of its own so that later phases draw what
    # they drew before: a 64-channel chunk past C (C = 32, 96), ragged
    # output-channel tiles (Co = 96, 8), images of 5 x 7, 8 x 14, 10 x 16
    # and 72 x 128 (tiles that straddle samples in K7); NaN sentinels past
    # the output (through the C entries), three runs bit-identical
    g20 = torch.Generator(device=dev).manual_seed(SEED + 20)

    def draw20(n, h, w, c, co, emb):
        d = lambda *shape: torch.randn(shape, device=dev, generator=g20)
        return [d(n, h, w, c).to(bf16), (d(3, 3, c, co) * (9 * c) ** -0.5).to(bf16),
                (d(co) * 0.1).to(bf16), d(c) * 0.2 + 1, d(c) * 0.2,
                d(n, c).to(bf16) if emb else None]

    def conv_into(which, ops, tile_h, buf):
        """The bf16 route of K7 or K8 as its wrapper runs it, writing into the
        head of `buf`."""
        x, k, b, gs, gb, e = ops
        n, h, w, c = x.shape
        co, lib = k.shape[-1], kernels.library()
        e_ptr = None if e is None else e.data_ptr()
        sc, sh = gn_stats(x, gs, gb, e, two_pass=which == "K8")
        if which == "K7":
            th, tw = pick_tile_tc(n, h, w)
            rc = lib.dct_fused_gn_silu_conv(
                x.data_ptr(), k.data_ptr(), b.data_ptr(), gs.data_ptr(), gb.data_ptr(), e_ptr,
                buf.data_ptr(), kernels.DTYPE_CODES[bf16], n, h, w, c, co, 32, 1e-5, th, tw,
                sc.data_ptr(), sh.data_ptr(), kernels.stream_handle(dev))
        else:
            th, tw = pick_tile_tc(n, h, w, tile_h)
            rc = lib.dct_fused_gn_silu_conv_tiled(
                x.data_ptr(), sc.data_ptr(), sh.data_ptr(), k.data_ptr(), b.data_ptr(),
                buf.data_ptr(), kernels.DTYPE_CODES[bf16], n, h, w, c, co, th, tw, e_ptr,
                kernels.stream_handle(dev))
        kernels.check(rc, f"{which} into a sentinel buffer")

    for shape, tile_h in [((2, 8, 14, 32, 64), 4), ((2, 8, 14, 96, 96), 2),
                          ((2, 8, 12, 64, 96), 4), ((3, 5, 7, 32, 8), 5),
                          ((4, 10, 16, 64, 64), 5), ((2, 72, 128, 64, 64), 8)]:
        n, h, w, c, co = shape
        numel = n * h * w * co
        for emb in (False, True):
            ops = draw20(*shape, emb)
            for which, fn, plain, kw in (
                    ("K7", fused_gn_silu_conv, fused_gn_silu_conv_plain, {}),
                    ("K8", fused_gn_silu_conv_tiled, fused_gn_silu_conv_tiled_plain,
                     {"tile_h": tile_h})):
                outs = [fn(*ops, **kw) for _ in range(3)]
                buf = torch.full((numel + 4096,), float("nan"), device=dev, dtype=bf16)
                conv_into(which, ops, tile_h, buf)
                torch.cuda.synchronize()
                e = errors(outs[0], plain(*ops, **kw))
                same = all(torch.equal(outs[0], o) for o in outs[1:])
                sentinels = bool(buf[numel:].isnan().all())
                head = torch.equal(buf[:numel].view_as(outs[0]), outs[0])
                tile = pick_tile_tc(n, h, w, kw.get("tile_h"))
                log(f"[20] bf16 route {which} {shape} emb {emb} tile {tile}: max_abs {e[0]:.3e} rel_l2 {e[1]:.3e} (tol 1e-2) | 3 runs "
                    f"bit-identical {same} | sentinels past the output intact {sentinels}, "
                    f"head equal to the wrapper's {head}")
                check(e[1] <= 1e-2 and same and sentinels and head,
                      f"bf16 {which} at {shape} emb {emb}: {e} {same} {sentinels} {head}")
            del ops, outs, buf

    # gn_stats against gn_stats_plain in both modes, relative L2 <= 1e-5
    # (fp32 sums in another order)
    stats_err = {}
    for n, h, w, c in [(32, 40, 64, 320), (3, 5, 7, 32), (2, 10, 16, 1280)]:
        x, _, _, gs, gb, e = draw20(n, h, w, c, 8, True)
        for two_pass in (False, True):
            sc, sh = gn_stats(x, gs, gb, e, two_pass=two_pass)
            sc0, sh0 = gn_stats_plain(x, gs, gb, e, two_pass=two_pass)
            torch.cuda.synchronize()
            es, eb = errors(sc, sc0), errors(sh, sh0)
            stats_err[((n, h, w, c), two_pass)] = (max(es[0], eb[0]), max(es[1], eb[1]))
            log(f"[20] gn_stats ({n}, {h}, {w}, {c}) emb, {'two-pass' if two_pass else 'moments'}"
                f": scale max_abs {es[0]:.3e} rel_l2 {es[1]:.3e}, bias max_abs {eb[0]:.3e} "
                f"rel_l2 {eb[1]:.3e} (tol 1e-5)")
            check(max(es[1], eb[1]) <= 1e-5, f"gn_stats at {(n, h, w, c)}: {es} {eb}")
        del x, e
    phase_s["20"] = time.perf_counter() - t0

    # -- phase 21: K7 and K8 at full width: their bench entry point --------------
    t0 = time.perf_counter()
    conv_wrappers = (fused_gn_silu_conv, fused_gn_silu_conv_tiled, gn_stats)
    reset(*conv_wrappers)
    rows = bench_fused_conv.main([])
    conv_launches = counts(*conv_wrappers)
    conv_rows = {(r["h"], r["c"], r["co"], r["row"]): r for r in rows}
    conv_by_shape = {"fused_gn_silu_conv": {}, "fused_gn_silu_conv_tiled": {}, "gn_stats": {}}
    first_conv = None
    for label, n, h, w, c, co in bench_fused_conv.CASES:
        e7, e8 = conv_check("21", (n, h, w, c, co), bench_fused_conv.TILE_H[h], bf16, True)
        # x, the kernel, bias and emb read once, the output written once (the
        # norm's 2 C fp32 parameters beside them); 9 products of C x Co per pixel
        b = bound(2 * (n * h * w * (c + co) + 9 * c * co + co + n * c) + 8 * c,
                  2.0 * n * h * w * c * co * 9, bf16)
        # gn_stats: x and emb read once, the (N, C) fp32 scale and bias written
        bs = bound(2 * n * h * w * c + 2 * n * c + 8 * n * c + 8 * c, 0.0, bf16)
        shape = f"({n}, {h}, {w}, {c} -> {co})"
        first_conv = first_conv or shape
        at = lambda row: conv_rows[(h, c, co, row)]["ms"]
        common = dict(plain_ms=at("plain"), library_ms=at("library"),
                      conv2d_ms=at("conv2d"), **b)
        stats_dev = lambda row: conv_rows[(h, c, co, row)]["device_ms"]
        for name, row, err, stats, extra in (
                ("fused_gn_silu_conv", "K7 fused", e7, "gn_stats", {}),
                ("fused_gn_silu_conv_tiled", "K8 tiled", e8, "gn_stats two-pass",
                 dict(tile_h=bench_fused_conv.TILE_H[h]))):
            conv_by_shape[name][shape] = dict(
                ms=at(row), max_abs_err=err[0], rel_l2=err[1], stats_ms=stats_dev(stats),
                tflops=2.0 * n * h * w * c * co * 9 / at(row) / 1e9,
                bound_share=b["bound_ms"] / at(row), over_library=at(row) / at("library"),
                **extra, **common)
        sx = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(n, h, w, c, device=dev, generator=sx).to(bf16)
        gs1, gb1 = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        emb1 = torch.randn(n, c, device=dev, generator=sx).to(bf16)
        stats_plain_ms = cuda_ms(lambda: gn_stats_plain(x, gs1, gb1, emb1))
        del x, emb1
        conv_by_shape["gn_stats"][shape] = dict(
            ms=at("gn_stats"), ms_two_pass=at("gn_stats two-pass"),
            device_ms=stats_dev("gn_stats"), device_ms_two_pass=stats_dev("gn_stats two-pass"),
            plain_ms=stats_plain_ms, library_ms=at("var_mean"),
            bound_share=bs["bound_ms"] / stats_dev("gn_stats"), **bs)
        k7, k8 = (conv_by_shape[k][shape] for k in ("fused_gn_silu_conv",
                                                      "fused_gn_silu_conv_tiled"))
        log(f"[21] {label.strip()} bf16 (in turn, median of {bench_fused_conv.ROUNDS}): K7 "
            f"{k7['ms']:.3f} ms ({k7['tflops']:.1f} TFLOP/s, {k7['bound_share']:.1%} of the "
            f"bound, {k7['over_library']:.2f}x the library; gn_stats {k7['stats_ms']:.4f}) | K8 "
            f"{k8['ms']:.3f} ({k8['tflops']:.1f} TFLOP/s, {k8['bound_share']:.1%}, "
            f"{k8['over_library']:.2f}x; gn_stats two-pass {k8['stats_ms']:.4f}; statistics: "
            "device time) | K7 / K8 "
            f"{k7['ms'] / k8['ms']:.3f} | library (group_norm, silu, conv2d) {at('library'):.3f}"
            f", conv2d alone {at('conv2d'):.3f} | plain {at('plain'):.3f} | gn_stats back to "
            f"back {at('gn_stats'):.4f} / two-pass {at('gn_stats two-pass'):.4f}, plain "
            f"{stats_plain_ms:.3f}, var_mean {at('var_mean'):.4f}, bound {bs['bound_ms']:.4f} "
            f"(bytes) | bound {b['bound_ms']:.3f} ms by {b['bound_by']}")
    for name in ("fused_gn_silu_conv", "fused_gn_silu_conv_tiled"):
        at = conv_by_shape[name][first_conv]
        report[name] = dict(max_abs_err=at["max_abs_err"], ms=at["ms"], plain_ms=at["plain_ms"],
                            bound_ms=at["bound_ms"], bound_by=at["bound_by"],
                            library_ms=at["library_ms"], bound_share=at["bound_share"],
                            tflops=at["tflops"], stats_ms=at["stats_ms"],
                            by_shape=conv_by_shape[name])
    at = conv_by_shape["gn_stats"][first_conv]
    report["gn_stats"] = dict(
        max_abs_err=max(stats_err[((32, 40, 64, 320), tp)][0] for tp in (False, True)),
        ms=at["ms"], ms_two_pass=at["ms_two_pass"], device_ms=at["device_ms"],
        device_ms_two_pass=at["device_ms_two_pass"], plain_ms=at["plain_ms"],
        bound_ms=at["bound_ms"], bound_by=at["bound_by"], library_ms=at["library_ms"],
        library_call="torch.var_mean over the groups of x", by_shape=conv_by_shape["gn_stats"])
    log(f"[21] launches by bench_fused_conv.main: K7 {conv_launches[0]}, K8 {conv_launches[1]} "
        f"(five shapes x {bench_fused_conv.ROUNDS} rounds x 11 calls each), gn_stats "
        f"{conv_launches[2]} (K7's and K8's, and its own rows)")
    torch.cuda.empty_cache()
    phase_s["21"] = time.perf_counter() - t0

    # -- phase 22: the kernels compute the model's function ----------------------
    t0 = time.perf_counter()
    n_frames, ch = 32, resblock.in_layers[2].in_channels
    x = torch.randn(n_frames, ch, 40, 64, device=dev, generator=gen).to(bf16).contiguous(
        memory_format=torch.channels_last)
    emb = torch.randn(2, 4 * ch, device=dev, generator=gen).to(bf16)
    nhwc = lambda a: a.permute(0, 2, 3, 1).contiguous()
    hwio = lambda conv: conv.weight.permute(2, 3, 1, 0).contiguous()
    with torch.no_grad():
        gn1, conv1 = resblock.in_layers[0], resblock.in_layers[2]
        gn2, conv2 = resblock.out_layers[0], resblock.out_layers[3]
        h_mod = resblock.in_layers(x)
        emb_out = resblock.emb_layers(emb).to(h_mod.dtype)[:, None].expand(-1, 16, -1)
        emb_out = emb_out.reshape(n_frames, ch).contiguous()
        out_mod = resblock.out_layers(h_mod + emb_out[:, :, None, None])
        rels = {}
        for name, fn in (("K7", fused_gn_silu_conv),
                         ("K8", lambda *a: fused_gn_silu_conv_tiled(*a, tile_h=8))):
            h_k = fn(nhwc(x), hwio(conv1), conv1.bias, gn1.weight, gn1.bias, None)
            out_k = fn(nhwc(h_mod), hwio(conv2), conv2.bias, gn2.weight, gn2.bias, emb_out)
            rels[name] = (errors(h_k, nhwc(h_mod))[1], errors(out_k, nhwc(out_mod))[1])
    log(f"[22] one level-0 ResBlock of {CONFIG} ({ch} -> {ch}, N(0, 0.02) weights) on "
        f"({n_frames}, {ch}, 40, 64) bf16: in_layers(x) and out_layers(h + emb_out) through "
        f"the module vs the kernels fed its parameters, rel_l2 "
        + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in rels.items()) + " (tol 2e-2)")
    check(all(max(r) <= 2e-2 for r in rels.values()), f"ResBlock through K7/K8: {rels}")
    del resblock, x, emb, h_mod, out_mod, emb_out, h_k, out_k
    torch.cuda.empty_cache()
    phase_s["22"] = time.perf_counter() - t0

    # -- phase 23: SDS guidance end to end ----------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset(*infer_wrappers)
        t1 = time.perf_counter()
        result = generate_guidance.main([
            "--config", CONFIG, "--prompt_dir", PROMPTS, "--savedir", tmp, "--resolution",
            "320_512", "--random_init", "--bf16", "--num_steps", str(STEPS_SDS),
            "--debug_save_interval", "10", "--save_results", "--seed", str(SEED),
            "--device", "cuda"])
        wall = time.perf_counter() - t1
        n_sds = counts(*infer_wrappers)
        out = result["outputs"][0]
        frames_file = np.load(os.path.join(tmp, "example.npy"))
        debug_files = sorted(os.listdir(os.path.join(tmp, "debug", "example", "debug")))
    clock, peak = result["timings"][0], result["peaks"][0]
    secs = clock["steps"]
    # the init the pipeline drew: encode noise first, then the latents
    g = torch.Generator(device=dev).manual_seed(SEED)
    torch.randn((16, 40, 64, 4), generator=g, device=dev)
    init = torch.randn((1, 16, 40, 64, 4), generator=g, device=dev).cpu().numpy()
    moved = float(np.abs(out["latents"] - init).mean())
    log(f"[23] SDS {CONFIG} bf16, {STEPS_SDS} steps, lr 0.01, AdamW, weight t: frames "
        f"{out['videos'].shape} finite {bool(np.isfinite(out['videos']).all())}, file "
        f"{frames_file.shape} {frames_file.dtype} | loss " + " ".join(
            f"{v:.4f}" for v in out["loss_curve"][::5]) + f" (every 5th of "
        f"{len(out['loss_curve'])}) | latents moved by mean abs {moved:.4f} | s/step first "
        f"{secs[0]:.3f}, mean after {np.mean(secs[1:]):.4f} | conditioning "
        f"{clock['conditioning']:.2f}s loop {clock['loop']:.2f}s (with 2 debug decodes) decode "
        f"{clock['decode']:.2f}s | peaks " + " ".join(
            f"{k} {v / 2**30:.2f}" for k, v in peak.items())
        + f" GiB, building {result['build_peak'] / 2**30:.2f} | main() wall {wall:.1f}s | "
        f"launches K1 {n_sds[0]} K2 {n_sds[1]} K5 {n_sds[2]} | debug tree {len(debug_files)} "
        f"files")
    check(out["videos"].shape == (1, 16, 320, 512, 3) and bool(np.isfinite(out["videos"]).all()),
          "SDS frames")
    check(frames_file.shape == (16, 320, 512, 3) and frames_file.dtype == np.uint8
          and len(np.unique(frames_file)) > 1, "SDS frame file")
    check(out["loss_curve"].shape == (STEPS_SDS,) and bool(np.isfinite(out["loss_curve"]).all()),
          "SDS loss curve")
    check(0.01 < moved < 0.01 * STEPS_SDS + 0.01, f"SDS latents moved by {moved}")
    check(n_sds == (per_call[0] * STEPS_SDS, per_call[1] * STEPS_SDS, 0),
          f"launches under SDS {n_sds}")
    check({"step_000000_frame.png", "step_000010_frame_00.png"} <= set(debug_files),
          f"SDS debug tree {debug_files}")
    # two steps with fixed draws, kernels against plain
    sds2 = SDSGuidancePipeline(result["pipeline"].pipe, SDSSettings(
        num_steps=2, log_every=2, guidance_rescale=0.7, timestep_spacing="uniform_trailing",
        optimizer_type="AdamW"))
    fixed = SDSDraws(torch.randint(0, len(sds2.t_grid), (2, 1), generator=g, device=dev),
                     torch.randn((2, 1, 16, 40, 64, 4), generator=g, device=dev))
    enc_noise = torch.randn((16, 40, 64, 4), generator=g, device=dev).cpu().numpy()
    video = np.repeat(decode_png(os.path.join(PROMPTS, "example.png"))[None, None]
                      .astype(np.float32) / 127.5 - 1.0, 16, axis=1)
    run2 = lambda: sds2(["a clip"], video, fs=[24], init_latents=init, decode=False,
                        encode_noise=enc_noise, draws=fixed)["latents"]
    lat_k = run2()
    with attention.use_backend("plain"):
        lat_p = run2()
    rel = float(np.linalg.norm(lat_k - lat_p) / np.linalg.norm(lat_p))
    rel_update = float(np.linalg.norm(lat_k - lat_p) / np.linalg.norm(lat_p - init))
    log(f"[23] two SDS steps with fixed draws, kernels vs plain: latents rel_l2 {rel:.3e} "
        f"(tol 2e-2), as a share of the update {rel_update:.3e}")
    check(rel <= 2e-2, f"SDS kernels vs plain rel L2 {rel}")
    del result, out, sds2, fixed
    torch.cuda.empty_cache()
    phase_s["23"] = time.perf_counter() - t0

    # -- phase 24: the app backend --------------------------------------------------
    t0 = time.perf_counter()
    image = decode_png(os.path.join(PROMPTS, "example.png"))
    n_app = {}
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        for mode, n_out in (("i2v", 16), ("loop", 15)):
            backend = Image2Video(os.path.join(tmp, mode), resolution="320_512",
                                  random_init=True, mode=mode)
            sampled = []   # what the pipeline handed the backend, before the uint8 clamp
            sample = backend.pipe.sample
            backend.pipe.sample = lambda *a, **k: sampled.append(sample(*a, **k)) or sampled[-1]
            reset(*infer_wrappers)
            clock = {}
            path = backend.get_image(image, "a fox running through snow", steps=STEPS_APP,
                                     seed=SEED, image2=image if mode == "loop" else None,
                                     timings=clock)
            n_app[mode] = counts(*infer_wrappers)
            frames = read_clip(path)
            finite = bool(np.isfinite(sampled[0].videos).all())
            log(f"[24] Image2Video 320_512 mode {mode}, {STEPS_APP} steps: {os.path.basename(path)} "
                f"({os.path.getsize(path)} bytes) {frames.shape} {frames.dtype} levels "
                f"{len(np.unique(frames))} finite {finite} | "
                + " ".join(f"{k} {v:.2f}s" for k, v in clock.items())
                + f" | launches K1 {n_app[mode][0]} K2 {n_app[mode][1]}")
            check(finite and frames.shape == (n_out, 320, 512, 3) and frames.dtype == np.uint8
                  and len(np.unique(frames)) > 1, f"app {mode}: frames {frames.shape}")
            check(n_app[mode] == (per_call[0] * STEPS_APP, per_call[1] * STEPS_APP, 0),
                  f"launches in app mode {mode}: {n_app[mode]}")
            # the wrapped `sample` and the pipeline refer to each other
            del backend, sampled, sample
            gc.collect()
            torch.cuda.empty_cache()
    phase_s["24"] = time.perf_counter() - t0

    # -- phase 25: one full-width 576x1024 training micro-step ------------------
    t0 = time.perf_counter()
    # K4 at the shapes this micro-step gives it (levels 0 and 1): one N = 16
    # backward, as the path makes it, held against the plain version two rows
    # of N at a time (its p is N*H*Lq*Lk fp32)
    for l, h in [(9216, 5), (2304, 10)]:
        q, k, v = draw_qkv(16, l, l, h, bf16)
        do = torch.randn(16, l, h * 64, device=dev, generator=gen).to(bf16)
        o, lse = flash_fwd_lse(q, k, v, h, 0.125)
        grads = flash_bwd(q, k, v, o, lse, do, h, 0.125)
        torch.cuda.synchronize()
        rels = [0.0, 0.0, 0.0]
        for i in range(0, 16, 2):
            sl = slice(i, i + 2)
            refs = flash_bwd_plain(q[sl].float(), k[sl].float(), v[sl].float(), o[sl].float(),
                                   lse[sl], do[sl].float(), h, 0.125)
            rels = [max(r, errors(g[sl], ref)[1]) for r, g, ref in zip(rels, grads, refs)]
            del refs
        di = flash_bwd_di(o, do, h)
        ms_dq = cuda_ms(lambda: flash_bwd_dq(q, k, v, o, lse, do, h, 0.125, di), iters=5)
        ms_dkv = cuda_ms(lambda: flash_bwd_dkv(q, k, v, o, lse, do, h, 0.125, di), iters=5)
        ms_di = cuda_ms(lambda: flash_bwd_di(o, do, h), iters=5)
        leaves = [heads_first(x, h).detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, heads_first(do, h),
                                                     retain_graph=True), iters=5)
        flops = 2.0 * 16 * h * l * l * 64
        b_dq = attention_bound(16, l, l, h, 64, bf16, products=3, extra_tensors=2, lse=True)
        b_dkv = attention_bound(16, l, l, h, 64, bf16, products=4, extra_tensors=3, lse=True)
        log(f"[25] K4 flash_bwd (16, {l}, {h}*64) bf16: one N=16 backward vs plain in eight N=2 "
            f"slices, worst rel_l2 dq {rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e} (tol 2e-2) | "
            f"K4a {ms_dq:.3f} ms ({3 * flops / ms_dq / 1e9:.1f} TFLOP/s, bound "
            f"{b_dq['bound_ms']:.3f}) + K4b {ms_dkv:.3f} ms ({4 * flops / ms_dkv / 1e9:.1f} TFLOP/s, "
            f"bound {b_dkv['bound_ms']:.3f}) + di {ms_di:.3f} ms = "
            f"{(ms_dq + ms_dkv + ms_di) / lib_ms:.2f}x the library's backward {lib_ms:.3f} ms")
        check(max(rels) <= 2e-2, f"K4 at (16, {l}, {h}): {rels}")
        for name, ms, b in (("flash_bwd_dq", ms_dq, b_dq), ("flash_bwd_dkv", ms_dkv, b_dkv)):
            report[name].setdefault("by_shape", {})[f"(16, {l}, {h}*64)"] = dict(
                ms=ms, library_ms=lib_ms, **b)
        del q, k, v, do, o, lse, grads, di, leaves, lib_out
    torch.cuda.empty_cache()
    tc = TrainingConfig.from_yaml(TRAIN_CONFIG_1024)
    mc = tc.model
    pipe = DynamiCrafterPipeline.for_training(mc, dev, frozen_dtype=torch.bfloat16)
    pipe.init_random(seed=SEED)
    trainer = Trainer(pipe, TrainConfig(
        accumulate_grad_batches=tc.accumulate_grad_batches, use_ema=False,
        uncond_prob=mc.uncond_prob, rand_cond_frame=mc.rand_cond_frame,
        parameterization=mc.parameterization, bf16=True), seed=SEED)
    bsz, t_len = tc.batch_size, mc.unet["temporal_length"]
    hh, ww = tc.train_data["resolution"]
    batch = {"video": torch.rand(bsz, t_len, hh, ww, 3, device=dev, generator=gen) * 2 - 1,
             "tokens": torch.as_tensor(pipe.tokenizer(["a fox running"] * bsz),
                                       dtype=torch.long, device=dev),
             "fs": torch.full((bsz,), 10.0, device=dev)}
    draws = trainer.draw(batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_1024 = torch.cuda.memory_allocated(dev)   # weights, batch, and any leftovers
    reset(*train_wrappers, flash_bwd_di)
    secs_1024 = []
    for i in range(2):
        t1 = time.perf_counter()
        loss, _, grads = trainer.loss_and_grads(batch, draws)
        torch.cuda.synchronize()
        secs_1024.append(time.perf_counter() - t1)
        if i == 0:
            per_step_1024 = (*counts(*train_wrappers), flash_bwd_di.launches)
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            g_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads])).item()
        del grads
    peak_1024 = torch.cuda.max_memory_allocated(dev)
    fam, _, window_ms, _ = profile_unet.profile_families(
        lambda: trainer.loss_and_grads(batch, draws), 1)
    device_ms = sum(fam.values())
    log(f"[25] training micro-step {TRAIN_CONFIG_1024} (batch {bsz} x {t_len} at {hh}x{ww}, "
        f"latents 72x128, bf16 autocast, synthetic frames): loss {loss.item():.6f}, gradient "
        f"finite {finite} norm {g_norm:.4e} | launches per micro-step K3 {per_step_1024[0]} "
        f"K4a {per_step_1024[1]} K4b {per_step_1024[2]} K2 {per_step_1024[3]} K1 "
        f"{per_step_1024[4]} di pre-pass {per_step_1024[5]} (flash at the 5 level-0 spatial "
        f"self-attentions, L = 9216, and the 5 of level 1, L = 2304: K3 once, its (o, lse) "
        f"kept across the checkpoint; K2 at 34 temporal attentions, again in the recompute) "
        f"| s/micro-step {secs_1024[0]:.2f} (first), {secs_1024[1]:.2f} | peak allocated "
        f"{peak_1024 / 2**30:.2f} GiB ({held_1024 / 2**30:.2f} held before the step) | one profiled: {device_ms:.1f} ms of device time in a "
        f"{window_ms:.1f} ms window ({100 * device_ms / window_ms:.1f} % busy): "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in fam.most_common()))
    check(finite and g_norm > 0 and bool(torch.isfinite(loss)), "1024 training loss or gradient")
    check(per_step_1024 == (10, 10, 10, 68, 0, 10),
          f"launches per 1024 micro-step {per_step_1024} != (10, 10, 10, 68, 0, 10)")
    del batch, draws, loss
    # kernels against plain on the same UNet cut to 2 frames: the plain
    # logits of 16 frames at L = 9216 are 27 GB in fp32, per attention
    torch.cuda.empty_cache()
    unet = pipe.unet
    params = [p for p in unet.parameters() if p.requires_grad]
    x = torch.randn(1, 2, 72, 128, 8, device=dev, generator=gen)
    target = torch.randn(1, 2, 72, 128, 4, device=dev, generator=gen)
    ts = torch.full((1,), 500, dtype=torch.long, device=dev)
    ctx_t = torch.randn(1, 77, 1024, device=dev, generator=gen)
    ctx_i = torch.randn(1, 2, 16, 1024, device=dev, generator=gen)
    fs = torch.full((1,), 10, dtype=torch.long, device=dev)

    def cut_grads():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            pred = unet(x, ts, context_text=ctx_t, context_img=ctx_i, fs=fs)
        loss = (pred.float() - target).square().mean()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), torch.cat([(g if g is not None else torch.zeros_like(p)).flatten()
                                         for g, p in zip(grads, params)])

    reset(*train_wrappers, flash_bwd_di)
    loss_k, g_kern = cut_grads()
    per_cut = (*counts(*train_wrappers), flash_bwd_di.launches)
    with attention.use_backend("plain"):
        loss_p, g_plain = cut_grads()
    g_abs, g_rel = errors(g_kern, g_plain)
    log(f"[25] the 1024 UNet cut to 2 frames (1, 2, 72, 128, 8), forward + backward under bf16 "
        f"autocast, kernels vs plain: loss {loss_k.item():.6f} / {loss_p.item():.6f}, flattened "
        f"gradient rel_l2 {g_rel:.3e} max_abs {g_abs:.3e} (tol 5e-2) | launches K3 {per_cut[0]} "
        f"K4a {per_cut[1]} K4b {per_cut[2]} K2 {per_cut[3]} K1 {per_cut[4]} di {per_cut[5]}")
    check(g_rel <= 5e-2 and abs(loss_k.item() - loss_p.item()) <= 1e-2 * abs(loss_p.item()),
          f"1024 cut kernels vs plain: gradient rel L2 {g_rel}, loss {loss_k} vs {loss_p}")
    check(per_cut == per_step_1024, f"launches in the 2-frame cut {per_cut} != {per_step_1024}")
    del pipe, trainer, unet, params, g_kern, g_plain
    torch.cuda.empty_cache()
    phase_s["25"] = time.perf_counter() - t0

    # -- phase 26: the sampler-quality scripts at 256x256, 320x512, 576x1024 ----
    t0 = time.perf_counter()
    n_certify = certify_runs(
        {"256": per_call_256, "512": (*per_call, 0), "1024": per_pass_1024},
        {"256": shallow_256, "512": shallow_512, "1024": shallow_1024})
    phase_s["26"] = time.perf_counter() - t0

    # -- phase 27: discovery and parity_check at 320x512 ----------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        # the CLI from an empty HOME and working directory, no overrides
        empty = os.path.join(tmp, "empty")
        os.makedirs(empty)
        env = {k: v for k, v in os.environ.items() if not k.startswith("DYNAMICRAFTER_")
               and k not in ("HF_HOME", "HUGGINGFACE_HUB_CACHE")}
        env.update(HOME=empty, PYTHONPATH=REPO)
        found = json.loads(subprocess.run(
            [sys.executable, "-c", "import json; from dynamicrafter_tpu_torch.utils.discovery "
             "import discover; print(json.dumps(discover('512')[0]))"], cwd=empty, env=env,
            capture_output=True, text=True, timeout=300, check=True).stdout.splitlines()[-1])
        image = os.path.join(REPO, PROMPTS, "example.png")
        pc_flags = ["--config", os.path.join(REPO, CONFIG), "--image", image, "--prompt",
                    "a fox running through the snow", "--height", "320", "--width", "512",
                    "--video_length", "16", "--ddim_steps", str(STEPS_PARITY), "--ddim_eta",
                    "1.0", "--cfg_scale", "7.5", "--frame_stride", "24", "--timestep_spacing",
                    "uniform_trailing", "--guidance_rescale", "0.7", "--device", "cuda"]
        if None in found.values():
            blocked = subprocess.run(
                [sys.executable, "-m", "dynamicrafter_tpu_torch.parity_check", *pc_flags],
                cwd=empty, env=env, capture_output=True, text=True, timeout=300)
            lines = blocked.stdout.splitlines()
            log(f"[27] parity_check with nothing mounted: exit {blocked.returncode}, "
                f"{len(lines)} line: {lines[0][:160] if lines else ''}...")
            check(blocked.returncode == 2 and len(lines) == 1
                  and lines[0].startswith("blocked on: "),
                  f"parity_check without weights: exit {blocked.returncode}, stdout "
                  f"{blocked.stdout[-2000:]!r}, stderr {blocked.stderr[-2000:]!r}")
        else:
            log(f"[27] discover('512') found {found}: the blocked line is not exercised")
        # in process, through the seam, on random weights
        pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(CONFIG), dev, torch.bfloat16)
        pipe.init_random(seed=SEED)
        x_t = np.random.default_rng(SEED + 27).standard_normal((1, 4, 16, 40, 64))
        np.save(os.path.join(tmp, "xT.npy"), x_t.astype(np.float32))
        parse = parity_check.get_parser().parse_args
        reset(*infer_wrappers)
        first = parity_check.check(parse([*pc_flags, "--x_t_npy", os.path.join(tmp, "xT.npy"),
                                          "--out", os.path.join(tmp, "first.npy")]), pipe)
        n_parity = counts(*infer_wrappers)
        video = np.stack([load_image(image, (320, 512))] * 16)[None]
        direct = pipe.sample(["a fox running through the snow"], video, steps=STEPS_PARITY,
                             eta=1.0, cfg_scale=7.5, timestep_spacing="uniform_trailing",
                             guidance_rescale=0.7, fs=[24],
                             x_T=x_t.astype(np.float32).transpose(0, 2, 3, 4, 1))
        same = np.array_equal(first["frames"], to_uint8(direct.videos[0, 0]))
        png_dir = os.path.join(tmp, "png")
        for i, frame in enumerate(first["frames"]):
            save_image(frame, os.path.join(png_dir, f"{i:03d}.png"))
        scores = {}
        for fmt, ref in (("npy", os.path.join(tmp, "first.npy")), ("png", png_dir)):
            again = parity_check.check(parse([*pc_flags, "--x_t_npy", os.path.join(tmp, "xT.npy"),
                                              "--reference_dir", ref, "--out",
                                              os.path.join(tmp, "again.npy")]), pipe)
            scores[fmt] = (again["psnr"], again["frames_compared"])
        del pipe, direct
    torch.cuda.empty_cache()
    expect = (STEPS_PARITY * per_call[0], STEPS_PARITY * per_call[1], 0)
    log(f"[27] parity_check.check on the 320x512 model (random N(0, 0.02) bf16 weights), DDIM-"
        f"{STEPS_PARITY} eta 1, CFG 7.5: --x_t_npy (1, 4, 16, 40, 64) frames equal to "
        f"pipe.sample(x_T=<transposed>) bit for bit {same} | PSNR against its own frames: .npy "
        f"{scores['npy'][0]} dB, PNG directory {scores['png'][0]} dB over {scores['png'][1]} "
        f"frames | launches K1 {n_parity[0]} K2 {n_parity[1]} (expected {expect[:2]})")
    check(same, "parity_check --x_t_npy frames differ from pipe.sample(x_T=)")
    check(scores == {"npy": (float("inf"), 16), "png": (float("inf"), 16)},
          f"parity_check against its own frames: {scores}")
    check(n_parity == expect, f"parity_check launches {n_parity} != {expect}")
    phase_s["27"] = time.perf_counter() - t0

    # -- phase 28: distributed inference at 320x512 ---------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        dist_flags = ["--config", CONFIG, "--prompt_dir", prompt_dir(os.path.join(tmp, "p3"), 3),
                      "--random_init", "--bf16", "--height", "320", "--width", "512",
                      "--frame_stride", "24", "--timestep_spacing", "uniform_trailing",
                      "--guidance_rescale", "0.7", "--perframe_ae",
                      "--unconditional_guidance_scale", "7.5", "--text_input", "--video_length",
                      "16", "--ddim_steps", str(STEPS_PARITY), "--ddim_eta", "1.0", "--bs", "1",
                      "--seed", str(SEED), "--device", "cuda"]
        n_shards, shard_files = [], []
        for i in range(2):
            reset(*infer_wrappers)
            res = distributed_inference.main([*dist_flags, "--savedir",
                                              os.path.join(tmp, f"shard{i}"),
                                              "--num_processes", "2", "--process_id", str(i)])
            n_shards.append(counts(*infer_wrappers))
            shard_files.append({os.path.basename(p): np.load(p) for p in res["paths"]})
        reset(*infer_wrappers)
        res = inference.main([*dist_flags, "--savedir", os.path.join(tmp, "whole"),
                              "--profile_dir", os.path.join(tmp, "prof")])
        n_whole = counts(*infer_wrappers)
        whole = {os.path.basename(p): np.load(p) for p in res["paths"]}
        with open(os.path.join(tmp, "prof", "trace.json")) as f:
            trace = f.read()
        trace_mb = len(trace) / 1e6
        traced = {k: k in trace for k in ("flash_fwd_tc_kernel", "small_t_tc_kernel")}
        del trace, res
    names = [sorted(s) for s in shard_files]
    diff = max(int(np.abs(f.astype(np.int16) - whole[n].astype(np.int16)).max())
               for s in shard_files for n, f in s.items())
    per_prompt = (STEPS_PARITY * per_call[0], STEPS_PARITY * per_call[1], 0)
    log(f"[28] distributed_inference 320x512, 3 prompts, DDIM-{STEPS_PARITY}, --bs 1: shard 0 "
        f"{names[0]}, shard 1 {names[1]} | largest frame difference against the one-process "
        f"run {diff} (uint8) | one-process --profile_dir trace {trace_mb:.1f} MB names "
        + " ".join(f"{k} {v}" for k, v in traced.items())
        + f" | launches shards {n_shards[0][:2]} {n_shards[1][:2]}, one process {n_whole[:2]}")
    check(not set(names[0]) & set(names[1]) and sorted(names[0] + names[1]) == sorted(whole)
          and len(whole) == 3, f"shards {names} against the one-process run {sorted(whole)}")
    check(diff == 0, f"shards differ from the one-process run by {diff}")
    check(all(traced.values()), f"the first batch's trace lacks a kernel: {traced}")
    check(n_shards == [tuple(2 * c for c in per_prompt), per_prompt]
          and n_whole == tuple(3 * c for c in per_prompt),
          f"launches shards {n_shards}, one process {n_whole}, per prompt {per_prompt}")
    phase_s["28"] = time.perf_counter() - t0

    # -- phase 29: interp training through train.main: processes, profile ------
    t0 = time.perf_counter()
    shm = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(dir=REPO) as logdir:
        reset(*train_wrappers, flash_bwd_di)
        result = train.main([
            "--base", TRAIN_CONFIG_INTERP, "--train", "--synthetic_data", "--bf16",
            "--max_steps", str(TRAIN_STEPS_INTERP), "--loader", "processes", "--profile_steps",
            "2", "--log_every", "1", "--device", "cuda", "--seed", str(SEED), "--logdir",
            logdir, "--name", "training_512_interp"])
        torch.cuda.synchronize()
        interp_launches = counts(*train_wrappers)
        interp_di = flash_bwd_di.launches
        interp_peak = torch.cuda.max_memory_allocated(dev)
        with open(result["trace"]) as f:
            trace = f.read()
        trace_mb = len(trace) / 1e6
        traced = {k: k in trace for k in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                                          "flash_bwd_dkv_tc_kernel", "small_t_tc_kernel")}
        del trace
        hist, secs, pids = result["metrics"], result["step_seconds"], result["worker_pids"]
        interp_on = result["trainer"].cfg.interp_mode and not result["trainer"].cfg.rand_cond_frame
        del result
    torch.cuda.empty_cache()
    finite = all(np.isfinite(v) for m in hist for v in m.values())
    unprofiled = secs[1:10]
    log(f"[29] train.main {TRAIN_CONFIG_INTERP} --synthetic_data --bf16 --loader processes "
        f"--profile_steps 2, {TRAIN_STEPS_INTERP} micro-steps: interp_mode and not "
        f"rand_cond_frame {interp_on} | loss " + " ".join(f"{m['loss']:.5f}" for m in hist)
        + " | grad_norm " + " ".join(f"{m['grad_norm']:.4e}" for m in hist)
        + " | s/micro-step " + " ".join(f"{s:.3f}" for s in secs)
        + f" (median of micro-steps 2-10 {np.median(unprofiled):.3f}, phase 9's "
        f"training_512_v1.0 median {median_9:.3f}) on {smi} | peak allocated "
        f"{interp_peak / 2**30:.2f} GiB | {len(pids)} loader workers, PIDs {list(pids)} (this "
        f"process {os.getpid()}); /dev/shm: {shm} | trace of micro-steps 10-11 {trace_mb:.1f} MB "
        "names " + " ".join(f"{k} {v}" for k, v in traced.items())
        + f" | launches K3 {interp_launches[0]} K4a {interp_launches[1]} K4b "
        f"{interp_launches[2]} K2 {interp_launches[3]} K1 {interp_launches[4]} di pre-pass "
        f"{interp_di}")
    check(interp_on, "the interp config did not set interp_mode / rand_cond_frame")
    check(len(hist) == TRAIN_STEPS_INTERP and finite
          and all(m["grad_norm"] > 0 for m in hist), "interp losses / grad norms not finite")
    check(all(traced.values()), f"the training trace lacks a kernel: {traced}")
    check(len(pids) == TrainingConfig.from_yaml(TRAIN_CONFIG_INTERP).num_workers
          and os.getpid() not in pids and len(set(pids)) == len(pids),
          f"loader workers {pids}")
    check(interp_launches == tuple(TRAIN_STEPS_INTERP * c for c in per_step)
          and interp_di == TRAIN_STEPS_INTERP * di_per_step,
          f"launches {interp_launches}, di {interp_di} != {TRAIN_STEPS_INTERP} x {per_step}, "
          f"{di_per_step}")
    phase_s["29"] = time.perf_counter() - t0

    # -- phase 30: train_probe at 320x512, both checkpointing policies --------
    t0 = time.perf_counter()
    probe_code = (
        "import json, sys\n"
        "from dynamicrafter_tpu_torch import train_probe\n"
        "from dynamicrafter_tpu_torch.ops.flash_attention import (\n"
        "    flash_bwd_di, flash_bwd_dkv, flash_bwd_dq, flash_fwd, flash_fwd_lse)\n"
        "from dynamicrafter_tpu_torch.ops.small_attention import small_t_fwd_tmajor\n"
        "ws = (flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, small_t_fwd_tmajor, flash_fwd,\n"
        "      flash_bwd_di)\n"
        "batches, iters = sys.argv[1:]\n"
        "for batch in batches.split(','):\n"
        "    for policy in ('config', 'none'):\n"
        "        for w in ws:\n"
        "            w.launches = 0\n"
        "        r = train_probe.main(['--res', '512', '--batch', batch, '--policies', policy,\n"
        "                              '--iters', iters])\n"
        "        print('ROW ' + json.dumps(dict(batch=int(batch), policy=policy,\n"
        "            ms=r['ms_per_step'][policy], peak_gib=r['peak_gib'][policy],\n"
        "            launches=[w.launches for w in ws])), flush=True)\n")
    probe_rows, n_probe = {}, [0] * 6
    # a step's launches (K3, K4a, K4b, K2, K1, di): K2 again in the recompute
    probe_per_step = {"config": (*per_step, di_per_step),
                      "none": (*per_step[:3], per_step[3] // 2, per_step[4], di_per_step)}
    # one process for both batches (train_probe reports an out-of-memory
    # policy as FAILED and goes on), apart from this one's allocations
    done = subprocess.run([sys.executable, "-c", probe_code,
                           ",".join(str(b) for b in PROBE_BATCHES), str(PROBE_ITERS)],
                          capture_output=True, text=True, timeout=900, cwd=REPO)
    for line in done.stdout.splitlines():
        if line.startswith("ROW "):
            row = json.loads(line[4:])
            probe_rows[(row["batch"], row["policy"])] = row
        elif "FAILED" in line:
            log(f"[30] {line}")
    if done.returncode != 0:
        log(f"[30] train_probe exited {done.returncode}: {done.stderr[-1500:]}")
    # batch 2 must run to its end; batch 4 may run out of memory, a result
    check(done.returncode == 0 or {(2, "config"), (2, "none")} <= set(probe_rows),
          f"train_probe at batch 2: {done.stderr[-3000:]}")
    for (b, policy), row in probe_rows.items():
        ok = row["ms"] is not None
        want = [(1 + PROBE_ITERS) * c for c in probe_per_step[policy]]
        log(f"[30] train_probe --res 512 --batch {b} --policies {policy}: "
            + (f"{row['ms']:.2f} ms/step, peak {row['peak_gib']:.3f} GiB" if ok else "FAILED (OOM)")
            + f" on {smi} | launches K3 K4a K4b K2 K1 di {row['launches']}"
            + (f" (expected {want})" if ok else ""))
        if ok:
            check(row["launches"] == want, f"probe launches {row['launches']} != {want}")
            n_probe = [a + c for a, c in zip(n_probe, row["launches"])]
    check(probe_rows.get((2, "config"), {}).get("ms") is not None,
          "train_probe failed at batch 2 with the config policy")
    phase_s["30"] = time.perf_counter() - t0

    # -- phase 31: the dp axis at world size 1 (nccl): trainer, train.main, inference.main --
    t0 = time.perf_counter()
    dist_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    os.environ.update(dist_env)
    held_31 = torch.cuda.memory_allocated(dev)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        sharding.init_distributed(dev, os.path.join(tmp, "store"))
        try:
            backend = torch.distributed.get_backend()
            # (a) AccumulatingAdamW(mesh=) against the plain optimizer: the same
            # weights, batches and draws, accumulation 2, EMA on, one update
            tc = TrainingConfig.from_yaml(TRAIN_CONFIG)
            mc = tc.model
            pipe = DynamiCrafterPipeline.for_training(mc, dev, frozen_dtype=torch.bfloat16)
            pipe.init_random(seed=SEED)
            zcfg = TrainConfig(
                learning_rate=tc.base_learning_rate, grad_clip=tc.gradient_clip_val,
                accumulate_grad_batches=tc.accumulate_grad_batches, use_ema=True,
                uncond_prob=mc.uncond_prob, rand_cond_frame=mc.rand_cond_frame,
                parameterization=mc.parameterization, bf16=True)
            bsz, t_len = tc.batch_size, mc.unet["temporal_length"]
            hh, ww = tc.train_data["resolution"]
            zgen = torch.Generator(device=dev).manual_seed(31)
            tokens = torch.as_tensor(pipe.tokenizer(["a fox running", "waves at dusk"]),
                                     dtype=torch.long, device=dev)
            zbatches = [{"video": torch.rand(bsz, t_len, hh, ww, 3, device=dev,
                                             generator=zgen) * 2 - 1,
                         "tokens": tokens, "fs": torch.full((bsz,), 8.0, device=dev)}
                        for _ in range(TRAIN_STEPS)]

            def rel_l2(got, want):
                """Relative L2 over lists of tensors, on the device of `want`
                (a tensor of `got` elsewhere is moved there one at a time)."""
                num = torch.stack([torch.linalg.vector_norm(g.to(w.device) - w)
                                   for g, w in zip(got, want)])
                den = torch.stack([torch.linalg.vector_norm(w) for w in want])
                return float(num.square().sum().sqrt() / den.square().sum().sqrt())

            start, zdraws, runs = None, None, {}
            for path in ("plain", "mesh"):
                mesh = sharding.create_mesh(1) if path == "mesh" else None
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                trainer = Trainer(pipe, zcfg, seed=SEED, mesh=mesh)
                if mesh is not None:
                    # the Trainer takes the plain optimizer at dp 1: the ZeRO-2
                    # one on its one-rank dp group is what this phase holds to it
                    trainer.opt = AccumulatingAdamW(trainer.params, zcfg, mesh=mesh)
                if start is None:
                    start = {k: p.detach().cpu() for k, p in trainer.params.items()}
                    zdraws = [trainer.draw(b, torch.Generator(device=dev).manual_seed(100 + i))
                              for i, b in enumerate(zbatches)]
                reset(*train_wrappers, flash_bwd_di)
                secs, metrics, calls = [], [], []
                for b, d in zip(zbatches, zdraws):
                    sharding.collectives.clear()
                    t1 = time.perf_counter()
                    m = trainer.train_step(b, d)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t1)
                    metrics.append({k: float(v) for k, v in m.items()})
                    calls.append(dict(sharding.collectives))
                run = dict(secs=secs, metrics=metrics, calls=calls,
                           peak=torch.cuda.max_memory_allocated(dev) - base,
                           launches=counts(*train_wrappers) + (flash_bwd_di.launches,))
                opt = trainer.opt
                if path == "plain":
                    # the plain state stays on the card (the EMA and moments
                    # by reference) while the mesh path runs
                    state = [opt.optimizer.state[p] for p in trainer.params.values()]
                    run["state"] = {
                        "params": [p.detach().clone() for p in trainer.params.values()],
                        "ema": list(opt.ema.values()),
                        "exp_avg": [st["exp_avg"] for st in state],
                        "exp_avg_sq": [st["exp_avg_sq"] for st in state],
                        "counters": (opt.step, opt.mini_step, opt._acc is None)}
                    del state
                else:
                    ref = runs["plain"].pop("state")
                    rel = {"params": rel_l2([p.detach() for p in trainer.params.values()],
                                            ref["params"])}
                    for what in ("ema", "exp_avg", "exp_avg_sq"):
                        rel[what] = rel_l2(opt.shards.gather(getattr(opt, what)), ref[what])
                    run.update(rel=rel, buckets=len(opt.shards.buckets), adam_steps=opt.adam_steps)
                    # the ZeRO state's way out: the EMA all-gathered into the
                    # modules (ema_scope), the state gathered onto rank 0's
                    # host (state_dict), written by CheckpointManager(mesh=)
                    # and read back, the EMA through export_checkpoint --ema
                    with trainer.ema_scope():
                        rel["ema_scope"] = rel_l2(
                            [p.detach() for p in trainer.params.values()], ref["ema"])
                    sharding.collectives.clear()
                    t1 = time.perf_counter()
                    zpath = CheckpointManager(os.path.join(tmp, "zero"), mesh=mesh).save(
                        trainer.step, trainer.state_dict())
                    save_s, save_calls = time.perf_counter() - t1, dict(sharding.collectives)
                    saved = torch.load(zpath, map_location="cpu", mmap=True, weights_only=True)
                    zstate = saved["optimizer"]["state"]
                    held = [zstate[i] for i in range(len(trainer.params))]
                    rel["ckpt_weights"] = rel_l2(list(saved["weights"].values()), ref["params"])
                    rel["ckpt_ema"] = rel_l2(list(saved["ema"].values()), ref["ema"])
                    for what in ("exp_avg", "exp_avg_sq"):
                        rel["ckpt_" + what] = rel_l2([st[what] for st in held], ref[what])
                    counters = (saved["step"], saved["mini_step"], saved["acc_grads"] is None)
                    keys_equal = list(saved["weights"]) == list(trainer.params)
                    del saved, zstate, held
                    t1 = time.perf_counter()
                    exported = export_checkpoint.main([
                        "--config", TRAIN_CONFIG, "--params", zpath, "--ema",
                        "--out", os.path.join(tmp, "zero", "exported_ema.ckpt")])
                    rel["exported_ema"] = rel_l2([exported[k] for k in trainer.params],
                                                 ref["ema"])
                    run.update(counters=counters, want_counters=ref["counters"],
                               keys_equal=keys_equal, save_s=save_s, save_calls=save_calls,
                               export_s=time.perf_counter() - t1,
                               ckpt_gib=os.path.getsize(zpath) / 2**30)
                    del exported
                    shutil.rmtree(os.path.join(tmp, "zero"))
                    del ref
                runs[path] = run
                with torch.no_grad():
                    for k, p in trainer.params.items():
                        p.copy_(start[k])
                del trainer, opt
            del pipe, start, zbatches, zdraws, m, b, d
            gc.collect()
            torch.cuda.empty_cache()
            plain_run, mesh_run = runs["plain"], runs["mesh"]
            norms = [(a["grad_norm"], b["grad_norm"]) for a, b in zip(plain_run["metrics"],
                                                                         mesh_run["metrics"])]
            log(f"[31a] AccumulatingAdamW(mesh=) at world size 1, backend {backend}, "
                f"{TRAIN_CONFIG} (batch {bsz} x {t_len} at {hh}x{ww}, bf16 autocast, accumulation "
                f"{zcfg.accumulate_grad_batches}, EMA on), {TRAIN_STEPS} micro-steps from the "
                f"same weights, batches and draws as the plain optimizer: relative L2 against "
                f"plain "
                + " ".join(f"{k} {v:.3e}" for k, v in mesh_run["rel"].items())
                + " | grad_norm plain / mesh " + " ".join(f"{a:.6e}/{b:.6e}" for a, b in norms)
                + " | loss plain / mesh " + " ".join(
                    f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b in zip(plain_run["metrics"],
                                                                       mesh_run["metrics"]))
                + f" | the ZeRO state written by CheckpointManager(mesh=) in {mesh_run['save_s']:.1f}s "
                f"({mesh_run['ckpt_gib']:.2f} GiB, collectives {mesh_run['save_calls']}), step, "
                f"mini_step, accumulator empty {mesh_run['counters']} (plain "
                f"{mesh_run['want_counters']}), export_checkpoint --ema read it back in "
                f"{mesh_run['export_s']:.1f}s"
                + f" | ms per micro-step plain {[round(1e3 * s, 1) for s in plain_run['secs']]} "
                f"(median {1e3 * np.median(plain_run['secs']):.1f}), mesh "
                f"{[round(1e3 * s, 1) for s in mesh_run['secs']]} (median "
                f"{1e3 * np.median(mesh_run['secs']):.1f}) on {smi} | peak allocated above what "
                f"was held before the optimizer was built: plain {plain_run['peak'] / 2**30:.2f} "
                f"GiB, mesh {mesh_run['peak'] / 2**30:.2f} GiB (held at the phase's start "
                f"{held_31 / 2**30:.2f} GiB, after (a) "
                f"{torch.cuda.memory_allocated(dev) / 2**30:.2f}) | {mesh_run['buckets']} buckets; "
                f"collective calls per micro-step {mesh_run['calls']} | launches K3 K4a K4b K2 K1 "
                f"di plain {plain_run['launches']} mesh {mesh_run['launches']}")
            for what, v in mesh_run["rel"].items():
                check(v <= 1e-5, f"mesh-path {what} differs from plain by {v} (relative L2)")
            check(all(abs(a - b) <= 1e-5 * abs(a) for a, b in norms), f"grad_norm {norms}")
            check(mesh_run["keys_equal"] and mesh_run["counters"] == mesh_run["want_counters"],
                  f"ZeRO checkpoint keys equal {mesh_run['keys_equal']}, counters "
                  f"{mesh_run['counters']} against plain {mesh_run['want_counters']}")
            # an all-gather a bucket for each moment, the EMA and a pending
            # accumulator; the save's barrier
            gathered = 3 + (not mesh_run["counters"][2])
            check(mesh_run["save_calls"] == {"all_gather": gathered * mesh_run["buckets"],
                                             "barrier": 1},
                  f"the ZeRO checkpoint's collectives {mesh_run['save_calls']}")
            check(mesh_run["adam_steps"] == TRAIN_STEPS // zcfg.accumulate_grad_batches,
                  f"{mesh_run['adam_steps']} AdamW steps")
            check(all(c.get("reduce_scatter") == mesh_run["buckets"] for c in mesh_run["calls"])
                  and [c.get("all_gather", 0) for c in mesh_run["calls"]]
                  == [0, mesh_run["buckets"]] * (TRAIN_STEPS // 2),
                  f"collective calls per micro-step {mesh_run['calls']}")
            check(mesh_run["launches"] == plain_run["launches"]
                  == tuple(TRAIN_STEPS * c for c in (*per_step, di_per_step)),
                  f"launches plain {plain_run['launches']} mesh {mesh_run['launches']}")

            # (b) train.main --dp 1 under a torchrun environment (the plain
            # optimizer: the Trainer takes ZeRO only at dp > 1); the checkpoint
            # through export_checkpoint
            reset(*train_wrappers, flash_bwd_di)
            sharding.collectives.clear()
            dp1_base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            result = train.main([
                "--config", TRAIN_CONFIG, "--synthetic_data", "--bf16", "--max_steps",
                str(TRAIN_STEPS_DP),
                "--device", "cuda", "--seed", str(SEED), "--logdir", tmp, "--name", "dp1",
                "--log_every", "1", "--dp", "1"])
            torch.cuda.synchronize()
            dp1_launches = counts(*train_wrappers) + (flash_bwd_di.launches,)
            dp1_calls = dict(sharding.collectives)
            dp1_peak = torch.cuda.max_memory_allocated(dev)
            hist, secs = result["metrics"], result["step_seconds"]
            mngr, trainer = result["checkpoints"], result["trainer"]
            dp1_mesh = trainer.mesh.shape
            ckpt_path = mngr.path(mngr.latest_step())
            ckpt_gib = os.path.getsize(ckpt_path) / 2**30
            t1 = time.perf_counter()
            exported = export_checkpoint.main(["--config", TRAIN_CONFIG, "--params", ckpt_path,
                                               "--out", os.path.join(tmp, "exported.ckpt")])
            export_s = time.perf_counter() - t1
            same = all(torch.equal(exported[k], p.detach().cpu())
                       for k, p in trainer.params.items())
            steps_saved = mngr.all_steps()
            del result, trainer, mngr, exported
            torch.cuda.empty_cache()
            log(f"[31b] train.main {TRAIN_CONFIG} --synthetic_data --bf16 --dp 1 under RANK=0 "
                f"WORLD_SIZE=1 LOCAL_RANK=0: mesh {dp1_mesh}, the plain optimizer (ZeRO only at "
                f"dp > 1), {TRAIN_STEPS_DP} micro-steps: loss "
                + " ".join(f"{m['loss']:.5f}" for m in hist) + " | grad_norm "
                + " ".join(f"{m['grad_norm']:.4e}" for m in hist) + " | s/micro-step "
                + " ".join(f"{s:.3f}" for s in secs) + f" on {smi} | peak allocated "
                f"{dp1_peak / 2**30:.2f} GiB, {dp1_base / 2**30:.2f} of it held before the run "
                f"(phase 9's, without a mesh: {train_peak / 2**30:.2f}) "
                f"| checkpoints {steps_saved}, {ckpt_gib:.2f} GiB; "
                f"export_checkpoint read it back in {export_s:.1f}s, exported weights equal to the "
                f"trainer's {same} | collectives {dp1_calls} | launches K3 K4a K4b K2 K1 di "
                f"{dp1_launches}")
            check(len(hist) == TRAIN_STEPS_DP
                  and all(np.isfinite(v) for m in hist for v in m.values())
                  and all(m["grad_norm"] > 0 for m in hist), "train.main --dp 1 metrics")
            check(steps_saved == [TRAIN_STEPS_DP] and same,
                  f"checkpoints {steps_saved}, export equal {same}")
            check(dp1_mesh == {"dp": 1, "sp": 1}, f"mesh {dp1_mesh}")
            check(dp1_launches == tuple(TRAIN_STEPS_DP * c for c in (*per_step, di_per_step)),
                  f"train.main --dp 1 launches {dp1_launches}")

            # (c) inference.main --dp 1 against the same clip with no process group
            dp_flags = ["--config", CONFIG,
                        "--prompt_dir", prompt_dir(os.path.join(tmp, "p1"), 1), "--random_init",
                        "--bf16", "--height", "320", "--width", "512",
                        "--frame_stride", "24", "--timestep_spacing", "uniform_trailing",
                        "--guidance_rescale", "0.7", "--perframe_ae",
                        "--unconditional_guidance_scale", "7.5", "--text_input", "--video_length",
                        "16", "--ddim_steps", str(STEPS_PARITY), "--ddim_eta", "1.0",
                        "--seed", str(SEED), "--device", "cuda"]
            reset(*infer_wrappers)
            sharding.collectives.clear()
            with_dp = inference.main([*dp_flags, "--savedir", os.path.join(tmp, "dp1"),
                                      "--dp", "1"])
            n_infer_dp = counts(*infer_wrappers)
            infer_calls = dict(sharding.collectives)
            for k in dist_env:
                os.environ.pop(k)       # the run with no process group
            without = inference.main([*dp_flags, "--savedir", os.path.join(tmp, "none")])
            frames_equal = (np.array_equal(with_dp["videos"][0], without["videos"][0])
                            and np.array_equal(np.load(with_dp["paths"][0]),
                                               np.load(without["paths"][0])))
            del with_dp, without
        finally:
            # before the FileStore's directory goes: a live nccl group polls it
            sharding.destroy_distributed()
            for k in dist_env:
                os.environ.pop(k, None)
    torch.cuda.empty_cache()
    log(f"[31c] inference.main --dp 1 (nccl, world size 1) 320x512 DDIM-{STEPS_PARITY}: frames "
        f"equal bit for bit to the run with no process group {frames_equal} | collectives "
        f"{infer_calls} | launches K1 {n_infer_dp[0]} K2 {n_infer_dp[1]} | process group "
        f"destroyed {not torch.distributed.is_initialized()}")
    check(frames_equal, "inference --dp 1 frames differ from the run without a process group")
    check(infer_calls == {"all_gather": STEPS_PARITY},
          f"inference --dp 1 collectives {infer_calls}")
    check(n_infer_dp[:2] == (STEPS_PARITY * per_call[0], STEPS_PARITY * per_call[1]),
          f"inference --dp 1 launches {n_infer_dp}")
    check(not torch.distributed.is_initialized(), "the process group outlived phase 31")
    phase_s["31"] = time.perf_counter() - t0

    # -- phase 32: the sp axis, two processes sharing the card over gloo --------
    t0 = time.perf_counter()
    from dynamicrafter_tpu_torch.models.unet3d import _build_level_specs

    # the JAX plan of one UNet call (tests/test_sp_collectives.py::_expected)
    ucfg = UNetConfig.from_dict(ModelConfig.from_yaml(CONFIG).unet)
    in_s, mid_s, out_s = _build_level_specs(ucfg)
    n_temporal = sum(1 for b in in_s + [mid_s] + out_s for sp_ in b if sp_[0] == "temporal")
    n_temporal += int(ucfg.addition_attention)
    n_tconv = 4 * sum(1 for b in in_s + [mid_s] + out_s for sp_ in b if sp_[0] == "res")
    plan = {"sp_all_to_all": 2 * n_temporal, "sp_halo": n_tconv,
            "sp_all_reduce": n_temporal + n_tconv}
    gc.collect()
    torch.cuda.empty_cache()
    held_32 = torch.cuda.memory_allocated(dev)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        prompt_dir(os.path.join(tmp, "prompts"), 1)
        # the one-process run first, then the ranks, then the one-process trainer:
        # the card holds two ranks' trainers at once but never a third
        reset(*infer_wrappers)
        torch.cuda.reset_peak_memory_stats(dev)
        one = inference.main(sp_infer_flags(tmp, "one"))
        torch.cuda.synchronize()
        one_frames, one_clock = one["videos"][0], one["timings"][0]
        n_one, one_peak = counts(flash_fwd, small_t_fwd_tmajor), torch.cuda.max_memory_allocated(dev)
        del one
        gc.collect()
        torch.cuda.empty_cache()

        procs = []
        t1 = time.perf_counter()
        for r in range(SP):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(SP), LOCAL_RANK="0",
                       PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
            logf = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--sp-rank", str(r), tmp],
                env=env, cwd=REPO, stdout=logf, stderr=subprocess.STDOUT), logf))
        try:
            for proc, _ in procs:
                proc.wait(timeout=max(1.0, t1 + 900 - time.perf_counter()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc, logf in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                logf.close()
        ranks_s = time.perf_counter() - t1
        codes = [proc.returncode for proc, _ in procs]
        if codes != [0] * SP:
            for r in range(SP):
                with open(os.path.join(tmp, f"rank{r}.log")) as f:
                    print(f"--- phase 32 rank {r} (exit {codes[r]}), last lines:\n"
                          + "".join(f.readlines()[-40:]), file=sys.stderr)
        check(codes == [0] * SP, f"phase 32 ranks exited {codes}")
        ranks = []
        for r in range(SP):
            with open(os.path.join(tmp, f"sp_rank{r}.json")) as f:
                ranks.append(json.load(f))
        sp_frames = [np.load(os.path.join(tmp, f"sp_frames{r}.npy")) for r in range(SP)]
        frames_rel = max(float(np.linalg.norm(f - one_frames) / np.linalg.norm(one_frames))
                         for f in sp_frames)
        # the layout copies into and out of the wire layout around each
        # all-to-all of one UNet call, at rank 0's shapes and strides, with
        # the exchange left out (one process alone on the card)
        layouts = ranks[0]["infer"]["layouts"]
        lay_in = [(getattr(sharding, "_" + name),
                   torch.empty_strided(shape, stride, device=dev,
                                       dtype=getattr(torch, dt)).normal_())
                  for name, shape, stride, dt in layouts]
        layout_ms = cuda_ms(lambda: [fn(x, SP, lambda inp: inp) for fn, x in lay_in])
        layout_bytes = 4 * sum(x.numel() * x.element_size() for _, x in lay_in)
        layout_bound = bound(layout_bytes, 0, lay_in[0][1].dtype)["bound_ms"]
        del lay_in

        # the one-process trainer on the same batches and draws (dp 1)
        train_w = train_kernels()[:5]
        reset(*train_w, flash_bwd_di)
        torch.cuda.reset_peak_memory_stats(dev)
        one_train = train.main(sp_train_flags(tmp, "one_train"))
        torch.cuda.synchronize()
        one_hist, one_secs = one_train["metrics"], one_train["step_seconds"]
        one_train_peak = torch.cuda.max_memory_allocated(dev)
        one_train_launches = counts(*train_w) + (flash_bwd_di.launches,)
        del one_train
        gc.collect()
        torch.cuda.empty_cache()
        # parameters and first moments after the update, from the two checkpoints
        ckpt = lambda name: torch.load(
            os.path.join(tmp, name, "checkpoints", f"step_{TRAIN_STEPS_SP:09d}.pt"),
            map_location="cpu", mmap=True, weights_only=True)
        got, want = ckpt("sp_train"), ckpt("one_train")

        def ckpt_rel(a, b):
            num = den = 0.0
            for x, y in zip(a, b):
                x, y = x.to(dev, torch.float64), y.to(dev, torch.float64)
                num += float(torch.linalg.vector_norm(x - y)) ** 2
                den += float(torch.linalg.vector_norm(y)) ** 2
            return (num / den) ** 0.5

        params_rel = ckpt_rel([got["weights"][k] for k in want["weights"]],
                              list(want["weights"].values()))
        moments = lambda c: [c["optimizer"]["state"][i]["exp_avg"]
                             for i in sorted(c["optimizer"]["state"])]
        exp_avg_rel = ckpt_rel(moments(got), moments(want))
        del got, want
    torch.cuda.empty_cache()
    inf, trn = [r["infer"] for r in ranks], [r["train"] for r in ranks]
    gib = lambda b: f"{b / 2**30:.2f}"
    log(f"[32a] inference.main --sp {SP} {CONFIG} 320x512 DDIM-{STEPS_SP} (eta 1, CFG 7.5, "
        f"rescale 0.7), {SP} processes on one card: backend {ranks[0]['backend']}, world "
        f"{ranks[0]['world']}, devices {[r['device'] for r in ranks]} (both ranks share the card: "
        f"nccl cannot put two ranks on one device; gloo carries the CUDA tensors through host "
        f"memory itself, so no collective is staged by the port: staged none) | frames' relative "
        f"L2 against the one-process run {frames_rel:.3e} (bound 2e-2) | stage seconds sp "
        + "; ".join(f"rank {r}: " + " ".join(f"{k} {v:.2f}" for k, v in i["timings"].items())
                    for r, i in enumerate(inf))
        + " | one process " + " ".join(f"{k} {v:.2f}" for k, v in one_clock.items())
        + f" on {smi} | the layout copies around the {len(layouts)} all-to-alls of one UNet call "
        f"(rank 0's shapes, the exchange left out, CUDA events) {layout_ms:.3f} ms, bound "
        f"{layout_bound:.3f} ms ({layout_bytes / 1e9:.2f} GB at 3.35 TB/s), against "
        f"{1e3 * one_clock['ddim'] / STEPS_SP:.1f} ms a one-process UNet step"
        f" | peak allocated per rank {[gib(i['peak']) for i in inf]} GiB, one process "
        f"{gib(one_peak)} GiB | files written by rank {[r for r, i in enumerate(inf) if i['paths']]}"
        f" | launches K1 K2 per rank {[tuple(i['launches']) for i in inf]}, one process {n_one}")
    check(frames_rel <= 2e-2, f"sp frames differ from the one-process run: rel L2 {frames_rel}")
    check(len(layouts) == plan["sp_all_to_all"], f"{len(layouts)} all-to-all layouts recorded")
    check(all(np.isfinite(f).all() and f.shape == one_frames.shape for f in sp_frames),
          "sp frames")
    check([bool(i["paths"]) for i in inf] == [True] + [False] * (SP - 1), "sp writers")
    check(all(tuple(i["launches"]) == n_one == (STEPS_SP * per_call[0], STEPS_SP * per_call[1])
              for i in inf), f"sp inference launches {[i['launches'] for i in inf]}, {n_one}")
    step_losses = lambda h: [m["loss"] for m in h]
    loss_rel = max(abs(a - b) / abs(b) for t in trn for a, b in
                   zip(step_losses(t["metrics"]), step_losses(one_hist)))
    log(f"[32b] train.main --sp {SP} {TRAIN_CONFIG} (batch 2 x 16 at 320x512, bf16 autocast, "
        f"accumulation 2), {TRAIN_STEPS_SP} micro-steps, mesh {trn[0]['mesh']}: loss per rank "
        + "; ".join(" ".join(f"{m['loss']:.6f}" for m in t["metrics"]) for t in trn)
        + " | one process " + " ".join(f"{m['loss']:.6f}" for m in one_hist)
        + f" (largest relative difference {loss_rel:.3e}, bound 1e-4) | grad_norm sp "
        + " ".join(f"{m['grad_norm']:.6e}" for m in trn[0]["metrics"]) + ", one process "
        + " ".join(f"{m['grad_norm']:.6e}" for m in one_hist)
        + f" | after the update, relative L2 against one process: parameters {params_rel:.3e} "
        f"(bound 1e-5; a trainer that took no step is ~5e-4 away at lr 1e-5), first moment "
        f"{exp_avg_rel:.3e} (bound 1e-2) | s/micro-step per rank "
        + "; ".join(" ".join(f"{x:.3f}" for x in t["secs"]) for t in trn)
        + " | one process " + " ".join(f"{x:.3f}" for x in one_secs)
        + f" on {smi} | peak allocated per rank {[gib(t['peak']) for t in trn]} GiB, one process "
        f"{gib(one_train_peak)} GiB (held by this process {gib(held_32)}) | collectives per rank "
        f"{trn[0]['calls']} | launches K3 K4a K4b K2 K1 di per rank "
        f"{[tuple(t['launches']) for t in trn]}, one process {one_train_launches} | checkpoint "
        f"steps {[t['steps'] for t in trn]} | ranks' wall {ranks_s:.1f}s")
    check(all(all(np.isfinite(v) for m in t["metrics"] for v in m.values()) for t in trn),
          "sp train metrics")
    check(all(t["metrics"] == trn[0]["metrics"] for t in trn), "sp ranks report other metrics")
    check(all(t["mesh"] == {"dp": 1, "sp": SP} for t in trn), f"train mesh {trn[0]['mesh']}")
    check(loss_rel <= 1e-4 and params_rel <= 1e-5 and exp_avg_rel <= 1e-2,
          f"sp training differs: loss {loss_rel}, params {params_rel}, first moment {exp_avg_rel}")
    check(all(tuple(t["launches"]) == one_train_launches
              == tuple(TRAIN_STEPS_SP * c for c in (*per_step, di_per_step)) for t in trn),
          f"sp train launches {[t['launches'] for t in trn]}, one process {one_train_launches}")
    # (c) the collectives of each UNet call and of the whole run
    want_run = {"all_gather": STEPS_SP, "sp_all_gather": 2,
                **{k: STEPS_SP * v for k, v in plan.items()}}
    want_run["sp_all_reduce"] += STEPS_SP          # guidance rescale's stds, once a step
    log(f"[32c] collectives per UNet call (JAX plan of {n_temporal} TemporalTransformers with "
        f"init_attn and {n_tconv} temporal convs: {plan}, no gather): "
        + "; ".join(f"rank {r}: {len(i['per_call'])} calls, "
                    f"{sorted({json.dumps(c, sort_keys=True) for c in i['per_call']})}"
                    for r, i in enumerate(inf))
        + f" | whole run per rank {inf[0]['calls']} (the dp rows' all-gather a call at dp 1, "
        f"rescale's all-reduce a step, latents and frames gathered once each) | K1 {inf[0]['launches'][0]}"
        f" and K2 {inf[0]['launches'][1]} launches a rank on this path, {n_one[0] // STEPS_SP} "
        f"and {n_one[1] // STEPS_SP} a call | phase {time.perf_counter() - t0:.1f}s")
    check(all(len(i["per_call"]) == STEPS_SP and all(c == plan for c in i["per_call"])
              for i in inf), f"sp collectives per UNet call {[i['per_call'] for i in inf]}")
    check(all(i["calls"] == want_run for i in inf),
          f"sp run collectives {[i['calls'] for i in inf]} != {want_run}")
    n_sp_infer = [sum(i["launches"][k] for i in inf) for k in range(2)]
    n_sp_train = [sum(t["launches"][k] for t in trn) for k in range(6)]
    phase_s["32"] = time.perf_counter() - t0

    # -- phase 33: dpm, unipc and DeepCache at 576x1024, sequential CFG --------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        runs_1024 = sampler_runs("33 576x1024 --bs 1 sequential CFG", tmp, [
            "--config", CONFIG_1024, "--prompt_dir",
            prompt_dir(os.path.join(tmp, "p"), 1),
            "--height", "576", "--width", "1024", "--frame_stride", "10", "--timestep_spacing",
            "uniform_trailing", "--guidance_rescale", "0.7", "--perframe_ae", "--bs", "1"],
            (1, 1, 16, 576, 1024, 3), "uniform_trailing", per_pass_1024, shallow_1024, passes=2)
    log("[33] samplers at 576x1024, two UNet calls a step (full pass K1 K2 K5 "
        f"{per_pass_1024}, DeepCache shallow pass {shallow_1024}): "
        + "; ".join(f"{k} loop {st['ddim']:.2f}s, launches {n}, peak {pk / 2**30:.2f} GiB"
                    for k, (n, st, pk) in runs_1024.items())
        + f" | DDIM-{STEPS_1024} without DeepCache (phase 14) loop {stages_1024['ddim']:.2f}s, "
        f"peak {peak_1024_infer / 2**30:.2f} GiB | phase {time.perf_counter() - t0:.1f}s | {smi}")
    phase_s["33"] = time.perf_counter() - t0

    # -- phase 34: dpm, unipc and DeepCache at 256x256, 8 clips a batch --------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        runs_256 = sampler_runs("34 256x256 --bs 8 batched CFG", tmp, [
            "--config", CONFIG_256, "--prompt_dir",
            prompt_dir(os.path.join(tmp, "p"), 8),
            "--height", "256", "--width", "256", "--frame_stride", "3", "--timestep_spacing",
            "uniform", "--bs", "8"], (8, 1, 16, 256, 256, 3), "uniform", per_call_256,
            shallow_256, passes=1)
    log("[34] samplers at 256x256 --bs 8, one UNet call of 16 clips a step (full K1 K2 K5 "
        f"{per_call_256}, DeepCache shallow {shallow_256}; dpm@{STEPS_DPM} takes "
        f"{unet_calls('uniform', STEPS_DPM)} calls at 'uniform' spacing): "
        + "; ".join(f"{k} loop {st['ddim']:.2f}s, launches {n}, peak {pk / 2**30:.2f} GiB"
                    for k, (n, st, pk) in runs_256.items())
        + f" | DDIM-{STEPS} (phase 13) peak {peak_256 / 2**30:.2f} GiB | phase "
        f"{time.perf_counter() - t0:.1f}s | {smi}")
    phase_s["34"] = time.perf_counter() - t0

    # -- phase 35: SDS and the app at 256x256 and 576x1024 ---------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        n_sds_wide = {res: sds_run(tmp, res, cfg_path, STEPS_SDS_WIDE, per)[0]
                      for res, cfg_path, per in (("256_256", CONFIG_256, per_call_256),
                                                 ("576_1024", CONFIG_1024, per_pass_1024))}
        n_app_wide = {res: app_run(tmp, res, STEPS_APP, per)[0]
                      for res, per in (("256_256", per_call_256), ("576_1024", per_pass_1024))}
    phase_s["35"] = time.perf_counter() - t0

    # -- phase 36: the 576x1024 fine-tune's life cycle through train.main -------
    t0 = time.perf_counter()
    disk = shutil.disk_usage(REPO)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        n_finetune = finetune_1024(tmp, per_step_1024, per_pass_1024)
    log(f"[36] phase {time.perf_counter() - t0:.1f}s; {disk.free / 2**30:.0f} GiB free on the "
        f"checkout's disk before it")
    phase_s["36"] = time.perf_counter() - t0

    log("[wall] " + " ".join(f"phase {k} {v:.1f}s" for k, v in phase_s.items())
        + f" | total {time.perf_counter() - t_start:.1f}s")

    # the paths of phases 26 and 33-36: (K1, K2, K5) and (K3, K4a, K4b, K2, K1, di)
    infer_paths = {**n_certify,
                   **{f"inference_1024_{k}": n for k, (n, _, _) in runs_1024.items()},
                   **{f"inference_256_bs8_{k}": n for k, (n, _, _) in runs_256.items()},
                   "sds_256": n_sds_wide["256_256"], "sds_1024": n_sds_wide["576_1024"],
                   "app_256": n_app_wide["256_256"], "app_1024": n_app_wide["576_1024"],
                   "inference_1024_ckpt": n_finetune["inference_1024_ckpt"]}
    train_paths = {k: n_finetune[k] for k in ("train_1024", "train_1024_resumed",
                                              "train_1024_pretrained")}
    src = "dynamicrafter_tpu_torch/csrc/"
    tpu = "dynamicrafter_tpu/ops/"
    exp = "experiments/flash_pairs/"
    # name: (source, TPU kernel, launches on the kernel's main path, on every path)
    sources = {
        "flash_fwd": (src + "flash_attention.cu", tpu + "flash_attention.py:161", launches[0],
                      {"inference_512": launches[0], "train_512": train_launches[4],
                       "train_512_val_samples": no_grad_launches[4],
                       "inference_256_bs8": launches_256[0],
                       "inference_1024": launches_1024[0],
                       **{f"inference_512_{k}": n[0] for k, (n, _, _) in runs_512.items()},
                       "sds_512": n_sds[0],
                       "app_512": n_app["i2v"][0] + n_app["loop"][0],
                       "parity_check_512": n_parity[0],
                       "distributed_512": n_shards[0][0] + n_shards[1][0] + n_whole[0],
                       "inference_512_dp1": n_infer_dp[0], "inference_sp2": n_sp_infer[0],
                       "svd_1024": n_svd["flash_fwd"],
                       **{k: v[0] for k, v in infer_paths.items()}}),
        "small_t_fwd_tmajor": (src + "small_attention.cu", tpu + "small_attention.py:134",
                               launches[1],
                               {"inference_512": launches[1], "train_512": train_launches[3],
                                "train_512_val_samples": no_grad_launches[3],
                                "inference_256_bs8": launches_256[1],
                                "inference_1024": launches_1024[1],
                                "train_1024_per_micro_step": per_step_1024[3],
                                **{f"inference_512_{k}": n[1]
                                   for k, (n, _, _) in runs_512.items()},
                                "sds_512": n_sds[1],
                                "app_512": n_app["i2v"][1] + n_app["loop"][1],
                                "parity_check_512": n_parity[1],
                                "distributed_512": n_shards[0][1] + n_shards[1][1] + n_whole[1],
                                "train_512_interp": interp_launches[3],
                                "train_probe_512": n_probe[3],
                                "train_512_zero_dp1": mesh_run["launches"][3],
                                "train_512_dp1": dp1_launches[3],
                                "inference_512_dp1": n_infer_dp[1],
                                "inference_sp2": n_sp_infer[1], "train_sp2": n_sp_train[3],
                                "svd_1024": n_svd["small_t_fwd_tmajor"],
                                **{k: v[1] for k, v in infer_paths.items()},
                                **{k: v[3] for k, v in train_paths.items()}}),
        "flash_fwd_lse": (src + "flash_attention.cu", tpu + "flash_attention.py:32",
                          train_launches[0], {"train_512": train_launches[0],
                                              "train_1024_per_micro_step": per_step_1024[0],
                                              "train_512_interp": interp_launches[0],
                                              "train_probe_512": n_probe[0],
                                              "train_512_zero_dp1": mesh_run["launches"][0],
                                              "train_512_dp1": dp1_launches[0],
                                              "train_sp2": n_sp_train[0],
                                              **{k: v[0] for k, v in train_paths.items()}}),
        "flash_bwd_dq": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:304",
                         train_launches[1], {"train_512": train_launches[1],
                                             "train_1024_per_micro_step": per_step_1024[1],
                                             "train_512_interp": interp_launches[1],
                                             "train_probe_512": n_probe[1],
                                             "train_512_zero_dp1": mesh_run["launches"][1],
                                             "train_512_dp1": dp1_launches[1],
                                             "train_sp2": n_sp_train[1],
                                             **{k: v[1] for k, v in train_paths.items()}}),
        "flash_bwd_dkv": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:339",
                          train_launches[2], {"train_512": train_launches[2],
                                              "train_1024_per_micro_step": per_step_1024[2],
                                              "train_512_interp": interp_launches[2],
                                              "train_probe_512": n_probe[2],
                                              "train_512_zero_dp1": mesh_run["launches"][2],
                                              "train_512_dp1": dp1_launches[2],
                                              "train_sp2": n_sp_train[2],
                                              **{k: v[2] for k, v in train_paths.items()}}),
        "flash_bwd_di": (src + "flash_attention_bwd.cu", tpu + "flash_attention.py:329",
                         train_di, {"train_512": train_di,
                                    "train_1024_per_micro_step": per_step_1024[5],
                                    "train_512_interp": interp_di,
                                    "train_probe_512": n_probe[5],
                                    "train_512_zero_dp1": mesh_run["launches"][5],
                                    "train_512_dp1": dp1_launches[5],
                                    "train_sp2": n_sp_train[5],
                                    **{k: v[5] for k, v in train_paths.items()}}),
        "small_t_fwd": (src + "small_attention.cu", tpu + "small_attention.py:32",
                        launches_256[2], {"inference_256_bs8": launches_256[2],
                                          "inference_1024": launches_1024[2],
                                          **{k: v[2] for k, v in infer_paths.items()
                                             if "256" in k}}),
        "flash_fwd_packed": (src + "flash_packed.cu", tpu + "flash_attention.py:479",
                             variant_launches[0],
                             {"flash_attention_packed": variant_launches[0]}),
        "flash_attention_pairs": (src + "flash_pairs.cu", exp + "flash_pairs.py:44",
                                  variant_launches[1],
                                  {"bench_flash_pairs": variant_launches[1]}),
        "run_variant": (src + "flash_variants.cu", exp + "bench_flash_variants.py:25",
                        variant_launches[2], {"bench_flash_variants": variant_launches[2]}),
        "fused_gn_silu_conv": (src + "fused_conv.cu", "experiments/fused_conv/fused_conv.py:36",
                               conv_launches[0], {"bench_fused_conv": conv_launches[0]}),
        "fused_gn_silu_conv_tiled": (src + "fused_conv.cu",
                                     "experiments/fused_conv/fused_conv_tiled.py:28",
                                     conv_launches[1], {"bench_fused_conv": conv_launches[1]}),
        "gn_stats": (src + "fused_conv.cu", "experiments/fused_conv/fused_conv.py:54",
                     conv_launches[2], {"bench_fused_conv": conv_launches[2]}),
        "group_norm_act": (src + "norms.cu", "none (the JAX package's norms are XLA fusions)",
                           norm_launches[0], {"inference_512": norm_launches[0],
                                              "svd_1024": n_svd["group_norm_act"]}),
        "layer_norm": (src + "norms.cu", "none (the JAX package's norms are XLA fusions)",
                       norm_launches[1], {"inference_512": norm_launches[1],
                                          "svd_1024": n_svd["layer_norm"]})}
    for name, (_, _, n, _) in sources.items():
        check(n > 0, f"{name} was launched no time on its main path")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=rep, launches=n,
             launches_by_path=by_path, **report[name])
        for name, (source, rep, n, by_path) in sources.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sp-rank"]:
        sys.exit(sp_rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
