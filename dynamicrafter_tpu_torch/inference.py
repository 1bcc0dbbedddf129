"""CLI inference: image + text -> video, over a prompt directory.

The flag surface of the JAX package's `scripts/inference.py` (reference
scripts/evaluation/inference.py:383-413), with its --sampler
{ddim,dpm,unipc}, --solver_order, --deepcache and --dp / --sp, plus
--random_init, --bf16, --device and --save_format; the three presets of
`scripts/run.sh` are in `run.sh` beside this file. Run e.g.:

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
1024 (the JAX CLI's rule). `--profile_dir` writes a `torch.profiler` Chrome
trace of the first batch there. `main(prompt_shard=(i, n))` runs the i-th of
n slices of the prompt list (`distributed_inference` passes it).

A Stable Video Diffusion configuration (an sgm `DiffusionEngine`, e.g.
`configs/inference_svd_xt.yaml`) runs `svd_pipeline.StableVideoDiffusionPipeline`
on every image of --prompt_dir (a prompt file is not needed; text is not
read): --video_length frames, --ddim_steps Euler EDM steps, guidance from
--min_cfg to --max_cfg over the frames, --fps (passed as fps_id = fps - 1),
--motion_bucket_id and --cond_aug, as diffusers' pipeline takes them:

  python -m dynamicrafter_tpu_torch.inference --config configs/inference_svd_xt.yaml \
      --prompt_dir prompts/1024 --random_init --bf16 --height 576 --width 1024 \
      --video_length 25 --ddim_steps 25

Under torchrun (WORLD_SIZE set) the ranks share each clip instead, on a
(dp, sp) mesh of one card a process. `--dp D` splits every UNet call's rows
over D ranks (batched CFG's passes: at --bs 1 one dp rank runs the
unconditional pass, the other the conditional one) and all-gathers the
outputs each step (`pipeline.split_rows`). `--sp S` splits each clip's
frames over S ranks: each runs the UNet on its T/S frames, with the
collectives of the temporal layers between them, and decodes them; the
frames are gathered at the end. --sp defaults to the ranks --dp leaves, as
in the JAX CLI, so a bare torchrun splits the frames over every rank.
Rank 0 writes the files. E.g.

  torchrun --nproc_per_node 4 -m dynamicrafter_tpu_torch.inference --dp 2 --sp 2 \
      --config configs/inference_512_v1.0.yaml ... (the flags above)
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence, Tuple, Union

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
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the first batch here")
    p.add_argument("--dp", type=int, default=1,
                   help="under torchrun: ranks that split each UNet call's rows")
    p.add_argument("--sp", type=int, default=-1,
                   help="under torchrun: ranks that split each clip's frames (-1: those "
                        "--dp leaves)")
    svd = p.add_argument_group("Stable Video Diffusion configurations")
    svd.add_argument("--fps", type=int, default=7, help="the clip's frame rate (fps_id = fps - 1)")
    svd.add_argument("--motion_bucket_id", type=int, default=127)
    svd.add_argument("--cond_aug", type=float, default=0.02,
                     help="scale of the noise added to the conditioning image")
    svd.add_argument("--min_cfg", type=float, default=None,
                     help="guidance of the first frame (default: the config's guider)")
    svd.add_argument("--max_cfg", type=float, default=None,
                     help="guidance of the last frame (default: the config's guider)")
    return p


def svd_main(args: argparse.Namespace) -> dict:
    """`main` for a Stable Video Diffusion configuration: every image of
    --prompt_dir to a clip, one a batch."""
    from dynamicrafter_tpu_torch.config import SVDConfig
    from dynamicrafter_tpu_torch.svd_pipeline import StableVideoDiffusionPipeline
    from dynamicrafter_tpu_torch.utils.video import IMG_EXTS, load_image, save_results

    if "WORLD_SIZE" in os.environ or (args.dp, args.sp) not in ((1, -1), (1, 1)):
        raise SystemExit("Stable Video Diffusion runs in one process (no --dp / --sp)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.ckpt_path and not args.random_init:
        pipe = StableVideoDiffusionPipeline.from_checkpoint(args.config, args.ckpt_path,
                                                            device, dtype)
    else:
        pipe = StableVideoDiffusionPipeline(SVDConfig.from_yaml(args.config), device, dtype)
        pipe.init_random(seed=args.seed)
        print("WARNING: random-init weights (no checkpoint): smoke run only")
    names = sorted(f for f in os.listdir(args.prompt_dir) if f.endswith(IMG_EXTS))
    if not names:
        raise FileNotFoundError(f"no image found in {args.prompt_dir}")
    start = time.perf_counter()
    paths, timings, peaks, outputs, latents = [], [], [], [], []
    for i, name in enumerate(names):
        image = load_image(os.path.join(args.prompt_dir, name), (args.height, args.width))
        clock, peak = {}, {}
        out = pipe.sample(image[None], frames=args.video_length, steps=args.ddim_steps,
                          min_cfg=args.min_cfg, max_cfg=args.max_cfg, fps_id=args.fps - 1,
                          motion_bucket_id=args.motion_bucket_id, cond_aug=args.cond_aug,
                          seed=args.seed, timings=clock, peaks=peak)
        paths += save_results(out.videos, [name], args.savedir, save_format=args.save_format,
                              fps=args.savefps)
        timings.append(clock)
        peaks.append(peak)
        outputs.append(out.videos)
        latents.append(out.latents)
        print(f"[{i + 1}/{len(names)}] " + " ".join(
            f"{k} {v:.2f}s" + (f" (peak {peak[k] / 2**30:.2f} GiB)" if k in peak else "")
            for k, v in clock.items()))
    print(f"done in {time.perf_counter() - start:.1f}s -> {args.savedir}")
    return {"paths": paths, "timings": timings, "peaks": peaks, "videos": outputs,
            "latents": latents}


def shard_bounds(n: int, shard_id: int, num_shards: int) -> Tuple[int, int]:
    """[lo, hi) of the prompts of shard `shard_id` of `num_shards`: ceil(n /
    num_shards) a shard, the last ones shorter or empty (reference
    inference.py:350-356)."""
    per = -(-n // num_shards)
    lo = min(n, shard_id * per)
    return lo, min(n, lo + per)


def main(argv: Union[None, Sequence[str], argparse.Namespace] = None,
         prompt_shard: Tuple[int, int] = (0, 1), distributed: Optional[bool] = None) -> dict:
    """Run inference over a prompt dir, or over slice `prompt_shard` =
    (shard_id, num_shards) of it; `argv` may be a parsed namespace.
    `distributed` (default: whether WORLD_SIZE is set) joins the process
    group and splits the UNet's rows over --dp ranks and each clip's
    frames over --sp ranks. Returns
    {"paths": [...], "timings": [per-batch stage seconds], "peaks":
    [per-batch peak bytes allocated in each stage, on a CUDA device],
    "build_peak": peak bytes while the pipeline was built and filled,
    "videos": [per-batch (B, n_samples, T, H, W, 3) float frames],
    "latents": [per-batch (B, n_samples, T, h, w, z) sampled latents]} for
    callers that drive it in-process."""
    args = argv if isinstance(argv, argparse.Namespace) else get_parser().parse_args(argv)
    shard_id, num_shards = prompt_shard
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"prompt_shard {prompt_shard}: want 0 <= shard_id < num_shards")
    if args.deepcache > 1 and args.ddim_steps % args.deepcache != 0:
        raise SystemExit(f"--deepcache {args.deepcache} must divide "
                         f"--ddim_steps {args.ddim_steps}")
    from dynamicrafter_tpu_torch.config import is_svd, load_yaml
    if os.path.isfile(args.config) and is_svd(load_yaml(args.config)):
        return svd_main(args)
    from dynamicrafter_tpu_torch import profile_unet
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.parallel import sharding
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.utils.video import load_prompt_dir, save_results

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available")
    if distributed is None:
        distributed = "WORLD_SIZE" in os.environ
    mesh, joined = None, torch.distributed.is_initialized()
    if distributed:
        device = sharding.init_distributed(device)
        mesh = sharding.create_mesh(args.dp, args.sp)
    elif (args.dp, args.sp) not in ((1, -1), (1, 1)):
        raise SystemExit(f"--dp {args.dp} --sp {args.sp} needs one process a rank: run under "
                         "torchrun")
    writer = mesh is None or mesh.rank == 0
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
    lo, hi = shard_bounds(len(prompts), shard_id, num_shards)
    names, videos, prompts = names[lo:hi], videos[lo:hi], prompts[lo:hi]
    if not args.text_input:
        prompts = [""] * len(prompts)

    start = time.perf_counter()
    paths, timings, peaks, outputs, latents = [], [], [], [], []
    for i0 in range(0, len(prompts), args.bs):
        sl = slice(i0, min(i0 + args.bs, len(prompts)))
        clock, peak = {}, {}
        prof = (profile_unet.start_trace(device) if args.profile_dir and i0 == 0 and writer
                else None)
        with sharding.use_mesh(mesh):
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
        if writer:
            paths += save_results(vids, names[sl], args.savedir,
                                  save_format=args.save_format, fps=args.savefps)
        if prof is not None:
            print(f"profiler trace -> {profile_unet.stop_trace(prof, device, args.profile_dir)}")
        timings.append(clock)
        peaks.append(peak)
        outputs.append(vids)
        latents.append(out.latents)
        print(f"[{sl.stop}/{len(prompts)}] " + " ".join(
            f"{k} {v:.2f}s" + (f" (peak {peak[k] / 2**30:.2f} GiB)" if k in peak else "")
            for k, v in clock.items()))
    print(f"done in {time.perf_counter() - start:.1f}s -> {args.savedir}")
    if mesh is not None and not joined:
        sharding.destroy_distributed()
    return {"paths": paths, "timings": timings, "peaks": peaks, "build_peak": build_peak,
            "videos": outputs, "latents": latents}


if __name__ == "__main__":
    main()
