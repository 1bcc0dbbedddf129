"""Score-distillation-sampling (SDS) guidance pipeline.

Counterpart of `dynamicrafter_tpu/sds.py` (the fork's
DynamiCrafterGuidancePipeline, guidance_pipeline.py:34, _sds_loss 347-424,
_optimization_loop 759-808): instead of a DDIM loop, Adam optimises the
video latent against the score-distillation gradient

    grad = w(t) * (z - x0_hat),   x0_hat = (z_t - sqrt(1 - a_t) eps) / sqrt(a_t)

with timesteps drawn from the middle (2 % .. 98 %) of the 50-step DDIM grid,
two-pass CFG plus guidance rescale 0.7 for the 512 and 1024 models, and the
weight types t / ada / uniform (guidance_pipeline.py:392-414).

The gradient IS the update: each step is one UNet forward under
`torch.no_grad()`, and the gradient is handed to `torch.optim` through
`latents.grad`; no surrogate loss graph is built and no backward kernel
runs. Every random draw comes from one `torch.Generator` seeded with `seed`,
in this order: the VAE encode noise, the initial latents, then per step the
timestep indices and the diffusion noise. `encode_noise`, `init_latents` and
`draws` replace those draws, so a test can feed another implementation's
numbers.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dynamicrafter_tpu_torch import schedule as sched_lib
from dynamicrafter_tpu_torch.sampling.ddim import SamplerSettings, make_cfg_denoiser
from dynamicrafter_tpu_torch.utils.video import save_clip, save_image, to_uint8


@dataclasses.dataclass(frozen=True)
class SDSSettings:
    num_steps: int = 1000
    lr: float = 0.01
    cfg_scale: float = 7.5
    guidance_rescale: float = 0.0       # 0.7 for 512/1024
    weight_type: str = "t"              # t | ada | uniform
    min_step_ratio: float = 0.02
    max_step_ratio: float = 0.98
    ddim_grid_steps: int = 50
    timestep_spacing: str = "uniform"
    log_every: int = 50
    # reference guidance_pipeline.py:769-774: AdamW betas (0.9, 0.99),
    # Adam betas (0.9, 0.999), both eps 1e-8 (AdamW weight decay 1e-2)
    optimizer_type: str = "Adam"        # Adam | AdamW
    negative_prompt: str = ""           # unconditional text


class SDSDraws(NamedTuple):
    """The random numbers of the optimisation steps, drawn ahead."""
    t_index: torch.Tensor   # (steps, B) int64 indices into the timestep grid
    noise: torch.Tensor     # (steps, B, T, h, w, c) diffusion noise


class SDSGuidancePipeline:
    """Optimises video latents by score distillation with a loaded
    DynamiCrafterPipeline's UNet and conditioning stack."""

    def __init__(self, pipe, settings: SDSSettings = SDSSettings()):
        self.pipe = pipe
        self.settings = settings
        s = settings
        grid = sched_lib.make_ddim_timesteps(s.timestep_spacing, s.ddim_grid_steps,
                                             pipe.schedule.num_timesteps)
        lo = int(len(grid) * s.min_step_ratio)
        hi = max(int(len(grid) * s.max_step_ratio), lo + 1)
        self.t_grid = torch.as_tensor(np.asarray(grid[lo:hi]), dtype=torch.long,
                                      device=pipe.device)

    @property
    def total_steps(self) -> int:
        """Whole chunks of `log_every` steps, at least one (the JAX loop)."""
        s = self.settings
        return max(1, s.num_steps // s.log_every) * s.log_every

    def sds_grad(self, model_fn, latents: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor):
        """(gradient, logging loss) at per-sample timesteps t (B,)."""
        s, schedule = self.settings, self.pipe.schedule
        b, nd = latents.shape[0], latents.dim()
        z_t = schedule.q_sample(latents, t, noise)
        model_output = model_fn(z_t, t)
        extract = lambda table: sched_lib.extract_into_tensor(table, t, nd)
        if self.pipe.config.parameterization == "v":
            eps = (extract(schedule.sqrt_alphas_cumprod) * model_output
                   + extract(schedule.sqrt_one_minus_alphas_cumprod) * z_t)
        else:
            eps = model_output
        a_t = extract(schedule.alphas_cumprod)
        x0_hat = (z_t - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        diff = latents - x0_hat
        if s.weight_type == "t":
            grad = (1.0 - a_t) * diff
        elif s.weight_type == "ada":
            wf = diff.abs().mean(dim=tuple(range(1, nd)), keepdim=True).clamp(min=1e-4)
            grad = diff / wf
        elif s.weight_type == "uniform":
            grad = diff
        else:
            raise ValueError(s.weight_type)
        grad = torch.nan_to_num(grad)
        # the surrogate's value, for logging (guidance_pipeline.py:416-420)
        loss = 0.5 * grad.square().mean() / b
        return grad, loss

    def _optimizer(self, latents: torch.Tensor) -> torch.optim.Optimizer:
        s = self.settings
        if s.optimizer_type == "AdamW":
            return torch.optim.AdamW([latents], lr=s.lr, betas=(0.9, 0.99), eps=1e-8,
                                     weight_decay=1e-2)
        if s.optimizer_type == "Adam":
            return torch.optim.Adam([latents], lr=s.lr, betas=(0.9, 0.999), eps=1e-8)
        raise ValueError(f"unknown optimizer_type {s.optimizer_type!r}")

    @torch.no_grad()
    def __call__(self, prompts: Sequence[str], videos: np.ndarray, *, seed: int = 123,
                 fs: Optional[Sequence[int]] = None,
                 init_latents: Optional[np.ndarray] = None, decode: bool = True,
                 debug_dir: Optional[str] = None, encode_noise: Optional[np.ndarray] = None,
                 draws: Optional[SDSDraws] = None, timings: Optional[dict] = None,
                 peaks: Optional[dict] = None) -> Dict[str, np.ndarray]:
        """videos: (B, T, H, W, 3) in [-1, 1]. Returns latents (B, T, h, w,
        c), loss_curve (steps,), with `decode` videos (B, T, H, W, 3), with
        `debug_dir` the debug tree's root. `timings` receives the seconds of
        conditioning and decode and the list `steps` of seconds per
        optimisation step (synchronised on the device); `peaks` the peak
        bytes allocated on a CUDA device in conditioning, the loop and
        decode."""
        pipe, s = self.pipe, self.settings
        dev = pipe.device
        on_cuda = dev.type == "cuda"
        sync = (lambda: torch.cuda.synchronize(dev)) if on_cuda else (lambda: None)
        clock = {} if timings is None else timings

        def stage_start() -> float:
            if peaks is not None and on_cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            return time.perf_counter()

        def stage_end(name: str, t0: float) -> None:
            sync()
            clock[name] = time.perf_counter() - t0
            if peaks is not None and on_cuda:
                peaks[name] = torch.cuda.max_memory_allocated(dev)

        on_dev = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev)
        vids = on_dev(videos)
        b, t = vids.shape[:2]
        f = 2 ** (len(pipe.vae_config.ch_mult) - 1)
        lat_shape = (b, t, vids.shape[2] // f, vids.shape[3] // f, pipe.vae_config.z_channels)
        gen = torch.Generator(device=dev).manual_seed(seed)

        t0 = stage_start()
        enc = (on_dev(encode_noise) if encode_noise is not None
               else torch.randn((b * t, *lat_shape[2:]), generator=gen, device=dev))
        cond = pipe.build_conditioning(prompts, vids, enc, cfg_scale=s.cfg_scale, fs=fs,
                                       negative_prompt=s.negative_prompt)
        stage_end("conditioning", t0)

        latents = (on_dev(init_latents) if init_latents is not None
                   else torch.randn(lat_shape, generator=gen, device=dev))
        opt = self._optimizer(latents)
        model_fn = make_cfg_denoiser(pipe.unet, cond, SamplerSettings(
            cfg_scale=s.cfg_scale, guidance_rescale=s.guidance_rescale,
            parameterization=pipe.config.parameterization))

        dbg = _DebugWriter(debug_dir) if debug_dir else None
        losses, step_seconds = [], []
        t0 = stage_start()
        for step in range(self.total_steps):
            t1 = time.perf_counter()
            if draws is not None:
                idx, noise = draws.t_index[step].to(dev), draws.noise[step].to(dev)
            else:
                idx = torch.randint(0, self.t_grid.shape[0], (b,), generator=gen, device=dev)
                noise = torch.randn(lat_shape, generator=gen, device=dev)
            grad, loss = self.sds_grad(model_fn, latents, self.t_grid[idx], noise)
            latents.grad = grad
            opt.step()
            losses.append(loss)
            sync()
            step_seconds.append(time.perf_counter() - t1)
            if dbg is not None and (step + 1) % s.log_every == 0:
                dbg.step(step + 1 - s.log_every, pipe.decode_latents(latents).cpu().numpy())
        stage_end("loop", t0)
        clock["steps"] = step_seconds
        loss_curve = torch.stack(losses).cpu().numpy()

        out = {"latents": latents.cpu().numpy(), "loss_curve": loss_curve}
        if decode:
            t0 = stage_start()
            out["videos"] = pipe.decode_latents(latents).cpu().numpy()
            stage_end("decode", t0)
        if dbg is not None:
            dbg.finish(loss_curve)
            out["debug_dir"] = debug_dir
        return out


class _DebugWriter:
    """Per-interval dumps in the reference's debug tree
    (guidance_pipeline.py:527-751): debug/step_XXXXXX_{frame_00.png,
    frame.png, video} per interval, process/optimization_process of the
    middle frames across intervals, loss_curve.csv, and loss_analysis.png
    (whole curve in log scale / last 50 / change rate) where matplotlib
    imports. Clips are mp4 where OpenCV imports, else uint8 `.npy`."""

    def __init__(self, root: str):
        self.root = root
        self.debug = os.path.join(root, "debug")
        self.process = os.path.join(root, "process")
        os.makedirs(self.debug, exist_ok=True)
        os.makedirs(self.process, exist_ok=True)
        self._mid_frames = []

    def step(self, step_idx: int, frames: np.ndarray) -> None:
        vid = np.asarray(frames)[0]          # (T, H, W, 3) in [-1, 1]
        u8 = to_uint8(vid)
        base = os.path.join(self.debug, f"step_{step_idx:06d}")
        save_image(u8[0], base + "_frame_00.png")
        save_image(u8[len(u8) // 2], base + "_frame.png")
        save_clip(u8, base + "_video")
        self._mid_frames.append(vid[len(vid) // 2])

    def finish(self, loss_curve: np.ndarray) -> None:
        if len(self._mid_frames) >= 2:
            save_clip(np.stack(self._mid_frames),
                      os.path.join(self.process, "optimization_process"), fps=4)
        with open(os.path.join(self.root, "loss_curve.csv"), "w") as f:
            f.write("step,loss\n")
            for i, v in enumerate(loss_curve):
                f.write(f"{i},{float(v)}\n")
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        axes[0].plot(loss_curve)
        axes[0].set_yscale("log")
        axes[0].set_title("Complete SDS Loss Curve")
        tail = loss_curve[-50:]
        axes[1].plot(range(len(loss_curve) - len(tail), len(loss_curve)), tail)
        axes[1].set_title("Last 50 Steps")
        if len(loss_curve) > 1:
            axes[2].plot(np.diff(loss_curve))
        axes[2].set_title("Loss Change Rate")
        for ax in axes:
            ax.grid(True)
            ax.set_xlabel("Step")
        fig.tight_layout()
        fig.savefig(os.path.join(self.root, "loss_analysis.png"), dpi=100)
        plt.close(fig)
