"""Fixed-seed PSNR parity harness against reference outputs.

The port's counterpart of the JAX package's `scripts/parity_check.py`: load a
released checkpoint, sample with the reference's initial noise (`--x_t_npy`,
torch layout (B, C, T, h, w), transposed here to the port's (B, T, h, w, C)),
write the frames and report their PSNR against the reference's frames (data
range 2, PASS above 40 dB). Run e.g.:

  python -m dynamicrafter_tpu_torch.parity_check \\
      --config configs/inference_256_v1.0.yaml --image prompts/256/img.png \\
      --prompt "..." --x_t_npy xT.npy --reference_dir ref_frames/ \\
      --height 256 --width 256

Without --ckpt_path / --vocab_path the checkpoint and the CLIP BPE vocab are
sought at the standard places (`utils/discovery.py`); when either is
missing the script prints one "blocked on:" line and exits 2. The frames are
scored as written (uint8), as the reference's are. Reference frames: a
directory of PNGs (decoded with the port's numpy decoder), a `.npy` of uint8
(T, H, W, 3) (what `inference` writes), or an mp4 (needs OpenCV). `check`
runs the sampling and scoring on a pipeline the caller built.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def _to_unit(frames: np.ndarray) -> np.ndarray:
    return frames.astype(np.float32) / 255.0 * 2.0 - 1.0


def load_reference_frames(path: str) -> np.ndarray:
    """A directory of PNGs, a uint8 `.npy` or an mp4 -> (T, H, W, 3) in [-1, 1]."""
    if os.path.isdir(path):
        from dynamicrafter_tpu_torch.utils.video import decode_png

        files = sorted(f for f in os.listdir(path) if f.endswith(".png"))
        if not files:
            raise FileNotFoundError(f"no .png frames in {path}")
        return _to_unit(np.stack([decode_png(os.path.join(path, f)) for f in files]))
    if path.endswith(".npy"):
        frames = np.load(path)
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"{path}: want uint8 (T, H, W, 3), got {frames.dtype} "
                             f"{frames.shape}")
        return _to_unit(frames)
    import cv2

    cap, frames = cv2.VideoCapture(path), []
    ok, frame = cap.read()
    while ok:
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        ok, frame = cap.read()
    cap.release()
    if not frames:
        raise ValueError(f"{path}: no frame decodes")
    return _to_unit(np.stack(frames))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.parity_check")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt_path", default=None,
                   help="released model.ckpt; omitted -> sought at the standard places "
                        "(utils/discovery.py)")
    p.add_argument("--image", required=True)
    p.add_argument("--prompt", default="")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--frame_stride", type=int, default=3)
    p.add_argument("--timestep_spacing", default="uniform")
    p.add_argument("--guidance_rescale", type=float, default=0.0)
    p.add_argument("--x_t_npy", default=None,
                   help="initial latent noise, torch layout (B, C, T, h, w)")
    p.add_argument("--reference_dir", default=None,
                   help="the reference's frames: PNG directory, uint8 .npy or mp4")
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--out", default="parity_sample.npy",
                   help="the sampled frames: uint8 .npy, or .mp4 (needs OpenCV)")
    p.add_argument("--device", default="cuda")
    return p


def check(args: argparse.Namespace, pipe) -> dict:
    """Sample one clip with `pipe` as `args` say, write it to `args.out` and
    score it against `args.reference_dir` when given. Returns {"frames":
    uint8 (T, H, W, 3) as written, "psnr": dB or None, "frames_compared"}."""
    from dynamicrafter_tpu_torch.utils.video import load_image, save_video, to_uint8

    img = load_image(args.image, (args.height, args.width))
    video = np.stack([img] * args.video_length)[None]
    x_T = None
    if args.x_t_npy:
        x_T = np.transpose(np.load(args.x_t_npy), (0, 2, 3, 4, 1))
    out = pipe.sample([args.prompt], video, steps=args.ddim_steps, eta=args.ddim_eta,
                      cfg_scale=args.cfg_scale, timestep_spacing=args.timestep_spacing,
                      guidance_rescale=args.guidance_rescale, fs=[args.frame_stride], x_T=x_T)
    frames = to_uint8(out.videos[0, 0])
    if args.out.endswith(".mp4"):
        save_video(frames, args.out, fps=8)
    else:
        np.save(args.out, frames)
    print(f"wrote {args.out}")
    score, t = None, 0
    if args.reference_dir:
        ref = load_reference_frames(args.reference_dir)
        t = min(len(ref), len(frames))
        score = psnr(_to_unit(frames[:t]), np.clip(ref[:t], -1, 1))
        print(f"PSNR vs reference over {t} frames: {score:.2f} dB "
              f"({'PASS' if score > 40 else 'BELOW'} 40 dB target)")
    return {"frames": frames, "psnr": score, "frames_compared": t}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = get_parser().parse_args(argv)
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.utils.discovery import discover

    res = "256" if args.width <= 256 else ("512" if args.width <= 512 else "1024")
    found, blocked = discover(res)
    args.ckpt_path = args.ckpt_path or found["checkpoint"]
    args.vocab_path = args.vocab_path or found["vocab"]
    if args.ckpt_path is None or args.vocab_path is None:
        print(blocked)
        raise SystemExit(2)
    pipe = DynamiCrafterPipeline.from_checkpoint(args.config, args.ckpt_path, args.device,
                                                 vocab_path=args.vocab_path)
    return check(args, pipe)


if __name__ == "__main__":
    main()
