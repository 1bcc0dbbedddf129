"""CLI inference: image + text -> video, over a prompt directory.

The flag surface of `scripts/run.sh 512` (reference
scripts/evaluation/inference.py:383-413), plus --random_init, --bf16,
--device and --save_format. Run e.g.:

  python -m dynamicrafter_tpu_torch.inference \
      --config configs/inference_512_v1.0.yaml --prompt_dir prompts/512 \
      --random_init --bf16 --height 320 --width 512 --frame_stride 24 \
      --timestep_spacing uniform_trailing --guidance_rescale 0.7 \
      --perframe_ae --unconditional_guidance_scale 7.5 --text_input \
      --video_length 16 --ddim_steps 50 --ddim_eta 1.0

Each prompt writes `<savedir>/<image stem>.npy`, uint8 (T, H, W, 3), and
with `--save_format mp4` also an mp4 (needs OpenCV).
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
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=1.0)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frame_stride", type=int, default=3)
    p.add_argument("--unconditional_guidance_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--text_input", action="store_true")
    p.add_argument("--timestep_spacing", type=str, default="uniform")
    p.add_argument("--guidance_rescale", type=float, default=0.0)
    p.add_argument("--perframe_ae", action="store_true")
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
    [per-batch stage seconds], "videos": [per-batch (B, 1, T, H, W, 3)
    float frames]} for callers that drive it in-process."""
    args = get_parser().parse_args(argv)
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.utils.tokenizer import default_tokenizer
    from dynamicrafter_tpu_torch.utils.video import load_prompt_dir, save_results

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    tokenizer = default_tokenizer(args.vocab_path)
    if args.ckpt_path and not args.random_init:
        pipe = DynamiCrafterPipeline.from_checkpoint(
            args.config, args.ckpt_path, device, dtype, tokenizer=tokenizer)
    else:
        pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(args.config), device,
                                     dtype, tokenizer=tokenizer)
        pipe.init_random(seed=args.seed)
        print("WARNING: random-init weights (no checkpoint): smoke run only")
    if args.perframe_ae:
        pipe.config.perframe_ae = True

    names, videos, prompts = load_prompt_dir(
        args.prompt_dir, video_size=(args.height, args.width),
        video_frames=args.video_length)
    if not args.text_input:
        prompts = [""] * len(prompts)

    start = time.perf_counter()
    paths, timings, outputs = [], [], []
    for i0 in range(0, len(prompts), args.bs):
        sl = slice(i0, min(i0 + args.bs, len(prompts)))
        clock = {}
        out = pipe.sample(
            prompts[sl], videos[sl], steps=args.ddim_steps,
            cfg_scale=args.unconditional_guidance_scale, eta=args.ddim_eta,
            timestep_spacing=args.timestep_spacing,
            guidance_rescale=args.guidance_rescale,
            fs=[args.frame_stride] * (sl.stop - sl.start), seed=args.seed,
            timings=clock)
        paths += save_results(out.videos, names[sl], args.savedir,
                              save_format=args.save_format)
        timings.append(clock)
        outputs.append(out.videos)
        print(f"[{sl.stop}/{len(prompts)}] " + " ".join(
            f"{k} {v:.2f}s" for k, v in clock.items()))
    print(f"done in {time.perf_counter() - start:.1f}s -> {args.savedir}")
    return {"paths": paths, "timings": timings, "videos": outputs}


if __name__ == "__main__":
    main()
