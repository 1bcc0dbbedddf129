"""Serving layer: the Image2Video backend and the gradio UI.

Counterpart of `dynamicrafter_tpu/app.py` and the top-level `gradio_app.py`
(reference scripts/gradio/i2v_test.py:13-102 for the backend,
scripts/gradio/i2v_test_application.py:13-126 for interpolation and looping,
where loop mode drops the last frame (:104-105), and gradio_app.py:38-181
for the per-resolution UI defaults).

    python -m dynamicrafter_tpu_torch.app --res 320_512 --ckpt_path model.ckpt
    python -m dynamicrafter_tpu_torch.app --res 256_256 --random_init

The backend needs no gradio and is what a program calls; `launch_app`
builds the UI where gradio imports. It runs on `device` (cuda unless asked
otherwise). Clips are written as mp4 where OpenCV imports, else as uint8
`.npy`.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dynamicrafter_tpu_torch.utils.video import save_clip

RESOLUTIONS = {
    "256_256": dict(height=256, width=256, fs=3, fs_min=1, fs_max=6,
                    config="configs/inference_256_v1.0.yaml",
                    timestep_spacing="uniform", guidance_rescale=0.0),
    "320_512": dict(height=320, width=512, fs=24, fs_min=15, fs_max=30,
                    config="configs/inference_512_v1.0.yaml",
                    timestep_spacing="uniform_trailing", guidance_rescale=0.7),
    "576_1024": dict(height=576, width=1024, fs=10, fs_min=5, fs_max=20,
                     config="configs/inference_1024_v1.0.yaml",
                     timestep_spacing="uniform_trailing", guidance_rescale=0.7),
}
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Image2Video:
    """The generation backend behind the UI and for programmatic callers."""

    def __init__(self, result_dir: str = "./gradio_results", resolution: str = "320_512",
                 ckpt_path: Optional[str] = None, random_init: bool = False,
                 mode: str = "i2v", device: str = "cuda", seed: int = 0):
        from dynamicrafter_tpu_torch.config import ModelConfig
        from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline

        if resolution not in RESOLUTIONS:
            raise ValueError(f"unknown resolution {resolution!r}; one of {sorted(RESOLUTIONS)}")
        if mode not in ("i2v", "interp", "loop"):
            raise ValueError(f"unknown mode {mode!r}; expected i2v, interp or loop")
        self.spec = RESOLUTIONS[resolution]
        self.mode = mode
        self.result_dir = result_dir
        os.makedirs(result_dir, exist_ok=True)

        cfg_path = os.path.join(REPO_ROOT, self.spec["config"])
        if ckpt_path is None and not random_init:
            # the reference backend downloads the released weights
            # (scripts/gradio/i2v_test.py:20-29; the interp and loop tabs use
            # the 512_interp checkpoint); without the hub, random weights
            # bring the demo up all the same
            from dynamicrafter_tpu_torch.utils.video import download_checkpoint
            res = resolution.split("_")[-1]
            if mode in ("interp", "loop"):
                res = f"{res}_interp"
            try:
                ckpt_path = download_checkpoint(res)
            except Exception as e:   # no network, no hub package, no such checkpoint
                print(f"WARNING: checkpoint download failed ({e}); "
                      "running with random-init weights (smoke mode)")
                random_init = True
        if ckpt_path and not random_init:
            self.pipe = DynamiCrafterPipeline.from_checkpoint(cfg_path, ckpt_path, device,
                                                              torch.bfloat16)
        else:
            self.pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(cfg_path), device,
                                              torch.bfloat16)
            self.pipe.init_random(seed=seed)

    def get_image(self, image: np.ndarray, prompt: str, steps: int = 50,
                  cfg_scale: float = 7.5, eta: float = 1.0, fs: Optional[int] = None,
                  seed: int = 123, image2: Optional[np.ndarray] = None, deepcache: int = 1,
                  sampler: str = "ddim", timings: Optional[dict] = None) -> str:
        """image: (H, W, 3) uint8, or float in [-1, 1]; returns the path of
        the clip. `timings` receives the pipeline's stage seconds."""
        spec = self.spec
        fs = spec["fs"] if fs is None else fs   # `or` would swallow fs=0
        t = self.pipe.unet_config.temporal_length or 16
        if sampler != "ddim":
            deepcache = 1   # DeepCache is a DDIM-path option
        if deepcache > 1 and steps % deepcache != 0:
            # the UI's leniency: the largest divisor of steps up to the asked
            # interval (the pipeline itself is strict)
            deepcache = max(d for d in range(1, deepcache + 1) if steps % d == 0)

        def prep(img):
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0 * 2 - 1
            return _resize_center_crop_f(img, (spec["height"], spec["width"]))

        img = prep(image)
        if self.mode in ("interp", "loop") and image2 is not None:
            half = t // 2
            video = np.stack([img] * half + [prep(image2)] * (t - half))[None]
        else:
            video = np.stack([img] * t)[None]

        out = self.pipe.sample(
            [prompt], video, steps=steps, cfg_scale=cfg_scale, eta=eta,
            timestep_spacing=spec["timestep_spacing"],
            guidance_rescale=spec["guidance_rescale"], fs=[fs], seed=seed,
            loop_or_interp=self.mode in ("interp", "loop"), deepcache=deepcache,
            sampler=sampler, sequential_cfg=spec["width"] >= 1024, timings=timings)
        frames = out.videos[0, 0]
        if self.mode == "loop":
            frames = frames[:-1]   # i2v_test_application.py:104-105
        name = f"{prompt[:40].replace(' ', '_') or 'sample'}_{int(time.time())}"
        return save_clip(frames, os.path.join(self.result_dir, name), fps=8)


def _resize_center_crop_f(img: np.ndarray, size) -> np.ndarray:
    """Float (H, W, 3) image: scaled to cover `size` = (height, width), then
    centre-cropped. Linear interpolation on pixel centres, as
    cv2.INTER_LINEAR; a downscale reads only the two nearest source pixels
    (no area filter), as there."""
    th, tw = size
    h, w, _ = img.shape
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        img = _resize_linear(img, nh, nw)
    top, left = (nh - th) // 2, (nw - tw) // 2
    return img[top:top + th, left:left + tw]


def _linear_taps(n_in: int, n_out: int):
    """Source indices and weights of linear interpolation on pixel centres
    with clamped edges."""
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x)
    frac = (x - x0).astype(np.float32)
    i0 = np.clip(x0, 0, n_in - 1).astype(np.int64)
    i1 = np.clip(x0 + 1, 0, n_in - 1).astype(np.int64)
    return i0, i1, frac


def _resize_linear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    j0, j1, fx = _linear_taps(img.shape[1], nw)
    img = img[:, j0] * (1 - fx)[None, :, None] + img[:, j1] * fx[None, :, None]
    i0, i1, fy = _linear_taps(img.shape[0], nh)
    return img[i0] * (1 - fy)[:, None, None] + img[i1] * fy[:, None, None]


def _example_rows(resolution: str):
    """Example rows [image, prompt, steps, cfg, eta, fs, seed] from the
    repository's prompt assets, prompts/<res>/ (the reference's
    gradio_app.py:8-34 ships a table per resolution)."""
    d = os.path.join(REPO_ROOT, "prompts", resolution.split("_")[-1])
    spec = RESOLUTIONS[resolution]
    rows = []
    if os.path.isdir(d):
        for fn in sorted(os.listdir(d)):
            if fn.lower().endswith((".png", ".jpg", ".jpeg")):
                txt = os.path.join(d, os.path.splitext(fn)[0] + ".txt")
                shared = os.path.join(d, "prompts.txt")
                prompt = ""
                if os.path.exists(txt):
                    with open(txt) as f:
                        prompt = f.read().strip()
                elif os.path.exists(shared):
                    with open(shared) as f:
                        prompt = (f.read().strip().splitlines() or [""])[0]
                rows.append([os.path.join(d, fn), prompt, 50, 7.5, 1.0, spec["fs"], 123])
    return rows


def launch_app(resolution: str = "320_512", ckpt_path: Optional[str] = None,
               random_init: bool = False, gr_module=None, launch: bool = True,
               device: str = "cuda", **launch_kwargs):
    """Build and launch the gradio demo: the per-resolution image-to-video
    tab with examples and a random-seed button (reference
    gradio_app.py:38-181), and the interpolation and looping backends
    (scripts/gradio/i2v_test_application.py) as two more tabs. A backend is
    built at its tab's first request. `gr_module` and `launch` let a test
    build the UI without gradio."""
    if gr_module is None:
        try:
            import gradio as gr_module
        except ImportError as e:
            raise ImportError("gradio is not installed here; the Image2Video backend "
                              "remains usable from a program") from e
    gr = gr_module

    spec = RESOLUTIONS[resolution]
    backends = {}

    def get_backend(mode):
        if mode not in backends:
            backends[mode] = Image2Video(resolution=resolution, ckpt_path=ckpt_path,
                                         random_init=random_init, mode=mode, device=device)
        return backends[mode]

    max_seed = 2 ** 31
    motion_label = "Motion magnitude" if resolution == "256_256" else "FPS"

    def build_controls():
        import random

        prompt = gr.Textbox(label="Prompts")
        with gr.Row():
            eta = gr.Slider(0.0, 1.0, value=1.0, step=0.1, label="ETA")
            cfg = gr.Slider(1.0, 15.0, value=7.5, step=0.5, label="CFG Scale")
        with gr.Row():
            steps = gr.Slider(1, 60, value=50, step=1, label="Sampling steps")
            fs = gr.Slider(spec["fs_min"], spec["fs_max"], value=spec["fs"], step=1,
                           label=motion_label)
        with gr.Row():
            seed = gr.Slider(0, max_seed, value=123, step=1, label="Random Seed")
            rnd = gr.Button("\U0001f3b2")
        deepcache = gr.Slider(1, 10, value=1, step=1,
                              label="DeepCache interval (1 = off; N>1 reuses deep UNet "
                                    "features for faster, slightly approximate sampling)")
        sampler = gr.Radio(["ddim", "dpm", "unipc"], value="ddim",
                           label="Sampler (dpm = DPM-Solver++(2M), DDIM-50 quality at ~30 "
                                 "steps; unipc = predictor-corrector for <=20 steps; both "
                                 "deterministic: ETA ignored, DeepCache off)")
        rnd.click(fn=lambda: random.randint(0, max_seed), outputs=seed, queue=False)
        return prompt, steps, cfg, eta, fs, seed, deepcache, sampler

    h, w = spec["height"], spec["width"]
    with gr.Blocks() as demo:
        gr.Markdown("## DynamiCrafter: animating open-domain images with video "
                    "diffusion priors")

        with gr.Tab(label=f"Image2Video_{h}x{w}"):
            with gr.Row():
                with gr.Column():
                    image = gr.Image(label="Input Image")
                    prompt, steps, cfg, eta, fs, seed, deepcache, sampler = build_controls()
                    go = gr.Button("Generate")
                with gr.Column():
                    video = gr.Video(label="Generated Video", autoplay=True)
            examples = _example_rows(resolution)
            if examples:
                gr.Examples(examples=examples,
                            inputs=[image, prompt, steps, cfg, eta, fs, seed],
                            outputs=[video], fn=lambda *a: _run(get_backend("i2v"), *a),
                            cache_examples=False)
            go.click(lambda *a: _run(get_backend("i2v"), *a),
                     inputs=[image, prompt, steps, cfg, eta, fs, seed, deepcache, sampler],
                     outputs=[video])

        with gr.Tab(label=f"Interpolation_{h}x{w}"):
            with gr.Row():
                with gr.Column():
                    image_a = gr.Image(label="First Frame")
                    image_b = gr.Image(label="Last Frame")
                    (prompt2, steps2, cfg2, eta2, fs2, seed2, deepcache2,
                     sampler2) = build_controls()
                    go2 = gr.Button("Generate")
                with gr.Column():
                    video2 = gr.Video(label="Generated Video", autoplay=True)
            go2.click(lambda im, im2, *a: _run(get_backend("interp"), im, *a, image2=im2),
                      inputs=[image_a, image_b, prompt2, steps2, cfg2, eta2, fs2, seed2,
                              deepcache2, sampler2],
                      outputs=[video2])

        with gr.Tab(label=f"Looping_{h}x{w}"):
            with gr.Row():
                with gr.Column():
                    image3 = gr.Image(label="Input Image")
                    (prompt3, steps3, cfg3, eta3, fs3, seed3, deepcache3,
                     sampler3) = build_controls()
                    go3 = gr.Button("Generate")
                with gr.Column():
                    video3 = gr.Video(label="Generated Video", autoplay=True)
            # loop mode: the first frame is also the last (dropped on output)
            go3.click(lambda im, *a: _run(get_backend("loop"), im, *a, image2=im),
                      inputs=[image3, prompt3, steps3, cfg3, eta3, fs3, seed3, deepcache3,
                              sampler3],
                      outputs=[video3])

    if not launch:
        return demo
    return demo.launch(**launch_kwargs)


def _run(backend, image, prompt, steps, cfg, eta, fs, seed, deepcache=1, sampler="ddim",
         image2=None):
    return backend.get_image(image, prompt, int(steps), float(cfg), float(eta), int(fs),
                             int(seed), image2=image2, deepcache=int(deepcache),
                             sampler=str(sampler))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.app")
    p.add_argument("--res", type=str, default="320_512", choices=sorted(RESOLUTIONS))
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv: Optional[Sequence[str]] = None):
    args = get_parser().parse_args(argv)
    return launch_app(resolution=args.res, ckpt_path=args.ckpt_path,
                      random_init=args.random_init, device=args.device, share=args.share)


if __name__ == "__main__":
    main()
