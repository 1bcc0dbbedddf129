"""SDS-guidance generation CLI.

    python -m dynamicrafter_tpu_torch.generate_guidance --config \
        configs/inference_512_v1.0.yaml --prompt_dir prompts/512 \
        --resolution 320_512 --random_init --bf16 --num_steps 20

The flag surface of the JAX package's `scripts/generate_guidance.py` (the
fork's generate_dynamicrafter_pipeline.py:81-155): optimise latents by score
distillation instead of DDIM sampling. Two input modes: the reference's
single sample, --prompt + --condition_image, or a --prompt_dir of PNG images
and a prompt file. Frame stride by resolution when --frame_stride is not
given (256 -> 3, 512 -> 24, 1024 -> 10).

Flags kept for compatibility:
  * --min/max_step_ratio_end are parsed and never consumed by the reference
    (it has no annealing); accepted here with a warning when they differ
    from the _start values, which ARE used.
  * --eta / --output_type are accepted and change nothing: SDS has no
    stochastic DDIM step, and the outputs are always frame files plus the
    loss curve as .npy.
--device is the torch device the pipeline runs on: `cuda` unless asked
otherwise. Each prompt writes `<savedir>/<image stem>.npy` (uint8 (T, H, W,
3); `.mp4` too where OpenCV imports) and `<stem>_loss.npy`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

AUTO_FS = {256: 3, 512: 24, 1024: 10}
RESOLUTIONS = {"256_256": (256, 256), "320_512": (320, 512), "576_1024": (576, 1024)}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.generate_guidance")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--ckpt_path", type=str, default=None)
    src = p.add_argument_group("inputs (one of)")
    src.add_argument("--prompt_dir", type=str, default=None,
                     help="dir of PNG images and a .txt of prompts, one per line")
    src.add_argument("--prompt", type=str, default=None,
                     help="single text prompt (reference mode)")
    src.add_argument("--condition_image", type=str, default=None,
                     help="condition image (PNG) for --prompt")
    p.add_argument("--savedir", "--output_dir", "--results_dir", dest="savedir", type=str,
                   default="results_guidance")
    p.add_argument("--resolution", type=str, default=None, choices=sorted(RESOLUTIONS),
                   help="sets --height/--width")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--video_length", "--num_frames", dest="video_length", type=int,
                   default=16)
    p.add_argument("--num_steps", "--num_optimization_steps", dest="num_steps", type=int,
                   default=1000)
    p.add_argument("--lr", "--learning_rate", dest="lr", type=float, default=0.01)
    p.add_argument("--cfg_scale", "--guidance_scale", dest="cfg_scale", type=float,
                   default=7.5)
    p.add_argument("--loss_type", type=str, default="sds", choices=["sds", "csd", "rfds"],
                   help="alias for a default weight_type: sds->t, csd->ada, rfds->uniform")
    p.add_argument("--weight_type", type=str, default="auto",
                   choices=["auto", "t", "ada", "uniform"])
    p.add_argument("--optimizer_type", type=str, default="AdamW", choices=["AdamW", "Adam"],
                   help="reference betas: AdamW (0.9, 0.99), Adam (0.9, 0.999)")
    p.add_argument("--negative_prompt", type=str, default=None,
                   help="unconditional text for the CFG branch")
    p.add_argument("--min_step_ratio_start", type=float, default=0.02)
    p.add_argument("--min_step_ratio_end", type=float, default=None,
                   help="parsed and unused in the reference; accepted only")
    p.add_argument("--max_step_ratio_start", type=float, default=0.98)
    p.add_argument("--max_step_ratio_end", type=float, default=None,
                   help="parsed and unused in the reference; accepted only")
    p.add_argument("--frame_stride", type=int, default=None)
    p.add_argument("--eta", type=float, default=1.0,
                   help="accepted for compatibility; the SDS loop has no stochastic "
                        "DDIM step to apply it to")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--savefps", type=int, default=10)
    p.add_argument("--random_init", action="store_true",
                   help="random N(0, 0.02) weights from --seed (smoke runs)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--debug_dir", type=str, default=None,
                   help="write per-interval debug dumps (step clips and frames, the "
                        "optimisation-process clip, loss analysis) here")
    p.add_argument("--save_results", action="store_true",
                   help="reference enhanced saving: the debug dumps go under "
                        "<savedir>/debug if --debug_dir is unset")
    p.add_argument("--save_debug_images", action="store_true")
    p.add_argument("--save_debug_videos", action="store_true")
    p.add_argument("--save_process_video", action="store_true")
    p.add_argument("--debug_save_interval", type=int, default=None,
                   help="debug dump every N optimisation steps (SDSSettings.log_every: "
                        "the run makes whole intervals)")
    p.add_argument("--output_type", type=str, default="tensor", choices=["tensor", "numpy"],
                   help="accepted for compatibility; outputs are frame files + .npy")
    p.add_argument("--device", type=str, default="cuda", help="torch device: cuda or cpu")
    p.add_argument("--vocab_path", type=str, default=None,
                   help="path to bpe_simple_vocab_16e6.txt.gz")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run SDS over the inputs. Returns {"paths", "outputs" (per prompt: the
    pipeline's dict of latents, loss_curve, videos), "timings", "peaks" (per
    prompt, by stage), "build_peak", "pipeline" (the SDSGuidancePipeline)} for
    callers that drive it in-process."""
    args = get_parser().parse_args(argv)

    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.sds import SDSGuidancePipeline, SDSSettings
    from dynamicrafter_tpu_torch.utils.video import load_image, load_prompt_dir, save_results

    if args.resolution:
        args.height, args.width = RESOLUTIONS[args.resolution]
    if not args.prompt_dir and not (args.prompt and args.condition_image):
        raise SystemExit("need --prompt_dir, or --prompt + --condition_image")
    for nm in ("min", "max"):
        end = getattr(args, f"{nm}_step_ratio_end")
        start = getattr(args, f"{nm}_step_ratio_start")
        if end is not None and end != start:
            print(f"WARNING: --{nm}_step_ratio_end={end} accepted but unused "
                  f"(dead flag in the reference too); using _start={start}")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} but CUDA is not available")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.ckpt_path and not args.random_init:
        pipe = DynamiCrafterPipeline.from_checkpoint(args.config, args.ckpt_path, device,
                                                     dtype, vocab_path=args.vocab_path)
    else:
        pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(args.config), device, dtype,
                                     vocab_path=args.vocab_path)
        pipe.init_random(seed=args.seed)
        print("WARNING: random-init weights (no checkpoint): smoke run only")
    build_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    fs = AUTO_FS.get(args.width, 24) if args.frame_stride is None else args.frame_stride
    if args.weight_type == "auto":
        # loss_type only remaps to a weight type, in the reference too
        weight_type = {"sds": "t", "csd": "ada", "rfds": "uniform"}[args.loss_type]
    else:
        weight_type = args.weight_type
    hi_res = args.width in (512, 1024)
    settings = SDSSettings(
        num_steps=args.num_steps, lr=args.lr, cfg_scale=args.cfg_scale,
        guidance_rescale=0.7 if hi_res else 0.0, weight_type=weight_type,
        min_step_ratio=args.min_step_ratio_start, max_step_ratio=args.max_step_ratio_start,
        timestep_spacing="uniform_trailing" if hi_res else "uniform",
        optimizer_type=args.optimizer_type, negative_prompt=args.negative_prompt or "")
    if args.debug_save_interval:
        settings = dataclasses.replace(settings, log_every=args.debug_save_interval)
    sds = SDSGuidancePipeline(pipe, settings)

    debug_dir = args.debug_dir
    if debug_dir is None and (args.save_results or args.save_debug_images
                              or args.save_debug_videos or args.save_process_video):
        debug_dir = os.path.join(args.savedir, "debug")

    if args.prompt_dir:
        names, videos, prompts = load_prompt_dir(
            args.prompt_dir, video_size=(args.height, args.width),
            video_frames=args.video_length)
    else:
        img = load_image(args.condition_image, (args.height, args.width))
        videos = np.repeat(img[None, None], args.video_length, axis=1)
        names = [os.path.basename(args.condition_image)]
        prompts = [args.prompt]

    try:
        import cv2  # noqa: F401
        save_format = "mp4"
    except ImportError:
        save_format = "npy"
    os.makedirs(args.savedir, exist_ok=True)
    paths, outputs, timings, peaks = [], [], [], []
    for i, (name, prompt) in enumerate(zip(names, prompts)):
        stem = os.path.splitext(name)[0]
        clock, peak = {}, {}
        out = sds([prompt], videos[i:i + 1], seed=args.seed, fs=[fs],
                  debug_dir=os.path.join(debug_dir, stem) if debug_dir else None,
                  timings=clock, peaks=peak)
        if not np.all(np.isfinite(out["videos"])):
            raise FloatingPointError(f"{name}: non-finite values in the generated video")
        paths += save_results(out["videos"][:, None], [name], args.savedir,
                              save_format=save_format, fps=args.savefps)
        loss_path = os.path.join(args.savedir, stem + "_loss.npy")
        np.save(loss_path, out["loss_curve"])
        paths.append(loss_path)
        outputs.append(out)
        timings.append(clock)
        peaks.append(peak)
        print(f"[{i + 1}/{len(prompts)}] {name}: final loss {out['loss_curve'][-1]:.5f}")
    return {"paths": paths, "outputs": outputs, "timings": timings, "peaks": peaks,
            "build_peak": build_peak, "pipeline": sds}


if __name__ == "__main__":
    main()
