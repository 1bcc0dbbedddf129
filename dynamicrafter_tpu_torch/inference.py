"""CLI inference: image + text -> video, over a prompt directory.

The flag surface of the JAX package's `scripts/inference.py` (reference
scripts/evaluation/inference.py:383-413) on one device, with its --sampler
{ddim,dpm,unipc}, --solver_order and --deepcache, plus --random_init, --bf16, --device and --save_format; the three
presets of `scripts/run.sh` are in `run.sh` beside this file. Run e.g.:

  python -m dynamicrafter_tpu_torch.inference \
      --config configs/inference_512_v1.0.yaml --prompt_dir prompts/512 \
      --random_init --bf16 --height 320 --width 512 --frame_stride 24 \
      --timestep_spacing uniform_trailing --guidance_rescale 0.7 \
      --perframe_ae --unconditional_guidance_scale 7.5 --text_input \
      --video_length 16 --ddim_steps 50 --ddim_eta 1.0

Each prompt writes `<savedir>/<image stem>.npy`, uint8 (T, H, W, 3)
(`<stem>_sample<k>.npy` with --n_samples > 1), and with `--save_format mp4`
also an mp4 at --savefps (needs OpenCV). With --interp the prompt dir holds
two images per prompt (first and last frame); --loop conditions on the one
image at both ends and drops the last generated frame. CFG passes run one
UNet call each under --sequential_cfg, which is the default at --width >=
1024 (the JAX CLI's rule).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.inference")
    p.add_argument("--savedir", type=str, default="results")
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--prompt_dir", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frame_stride", type=int, default=3)
    p.add_argument("--unconditional_guidance_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--negative_prompt", action="store_true")
    p.add_argument("--negative_prompt_text", type=str,
                   default="worst quality, blurry, distorted, low resolution",
                   help="unconditional text used when --negative_prompt is set")
    p.add_argument("--text_input", action="store_true")
    p.add_argument("--multiple_cond_cfg", action="store_true")
    p.add_argument("--cfg_img", type=float, default=None)
    p.add_argument("--timestep_spacing", type=str, default="uniform")
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "dpm", "unipc"],
                   help="dpm = DPM-Solver++(2M), unipc = UniPC-style predictor-"
                        "corrector: deterministic multistep solvers (ignore "
                        "--ddim_eta)")
    p.add_argument("--solver_order", type=int, default=2, choices=[1, 2, 3],
                   help="unipc only: predictor order")
    p.add_argument("--deepcache", type=int, default=1,
                   help="N>1: reuse the UNet's deep-level features for N-1 of "
                        "every N DDIM steps (DeepCache; must divide --ddim_steps)")
    p.add_argument("--guidance_rescale", type=float, default=0.0)
    p.add_argument("--perframe_ae", action="store_true")
    p.add_argument("--use_fixed_scheduler", action="store_true",
                   help="accepted for reference-CLI compatibility: the schedule "
                        "tables are always fp64 with a guarded rescale")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--interp", action="store_true")
    p.add_argument("--savefps", type=int, default=10)
    p.add_argument("--sequential_cfg", action="store_true",
                   help="one UNet call per CFG pass (lower peak memory); "
                        "always on at --width >= 1024")
    p.add_argument("--random_init", action="store_true",
                   help="random N(0, 0.02) weights from --seed (smoke runs)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 weights and compute")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--save_format", choices=["npy", "mp4"], default="npy",
                   help="npy always; mp4 in addition (needs OpenCV)")
    p.add_argument("--vocab_path", type=str, default=None,
                   help="path to bpe_simple_vocab_16e6.txt.gz")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run inference over a prompt dir. Returns {"paths": [...], "timings":
    [per-batch stage seconds], "peaks": [per-batch peak bytes allocated in
    each stage, on a CUDA device], "build_peak": peak bytes while the
    pipeline was built and filled, "videos": [per-batch (B, n_samples, T, H,
    W, 3) float frames]} for callers that drive it in-process."""
    args = get_parser().parse_args(argv)
    if args.deepcache > 1 and args.ddim_steps % args.deepcache != 0:
        raise SystemExit(f"--deepcache {args.deepcache} must divide "
                         f"--ddim_steps {args.ddim_steps}")
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.utils.video import load_prompt_dir, save_results

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.ckpt_path and not args.random_init:
        pipe = DynamiCrafterPipeline.from_checkpoint(
            args.config, args.ckpt_path, device, dtype, vocab_path=args.vocab_path)
    else:
        pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(args.config), device,
                                     dtype, vocab_path=args.vocab_path)
        pipe.init_random(seed=args.seed)
        print("WARNING: random-init weights (no checkpoint): smoke run only")
    if args.perframe_ae:
        pipe.config.perframe_ae = True
    # `sample` restarts the peak count at each stage
    build_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    names, videos, prompts = load_prompt_dir(
        args.prompt_dir, video_size=(args.height, args.width),
        video_frames=args.video_length, interp=args.interp)
    if not args.text_input:
        prompts = [""] * len(prompts)

    start = time.perf_counter()
    paths, timings, peaks, outputs = [], [], [], []
    for i0 in range(0, len(prompts), args.bs):
        sl = slice(i0, min(i0 + args.bs, len(prompts)))
        clock, peak = {}, {}
        out = pipe.sample(
            prompts[sl], videos[sl], steps=args.ddim_steps,
            cfg_scale=args.unconditional_guidance_scale, eta=args.ddim_eta,
            cfg_img=args.cfg_img, multiple_cond_cfg=args.multiple_cond_cfg,
            timestep_spacing=args.timestep_spacing,
            guidance_rescale=args.guidance_rescale,
            fs=[args.frame_stride] * (sl.stop - sl.start),
            loop_or_interp=args.loop or args.interp, n_samples=args.n_samples,
            seed=args.seed,
            negative_prompt=args.negative_prompt_text if args.negative_prompt else "",
            sequential_cfg=args.sequential_cfg or args.width >= 1024,
            sampler=args.sampler, solver_order=args.solver_order, deepcache=args.deepcache,
            timings=clock, peaks=peak)
        vids = out.videos
        if args.loop:
            vids = vids[:, :, :-1]   # the last frame repeats the first
        paths += save_results(vids, names[sl], args.savedir,
                              save_format=args.save_format, fps=args.savefps)
        timings.append(clock)
        peaks.append(peak)
        outputs.append(vids)
        print(f"[{sl.stop}/{len(prompts)}] " + " ".join(
            f"{k} {v:.2f}s" + (f" (peak {peak[k] / 2**30:.2f} GiB)" if k in peak else "")
            for k, v in clock.items()))
    print(f"done in {time.perf_counter() - start:.1f}s -> {args.savedir}")
    return {"paths": paths, "timings": timings, "peaks": peaks, "build_peak": build_peak,
            "videos": outputs}


if __name__ == "__main__":
    main()
