"""Training logs: a file and console logger, `metrics.csv`, and periodic
sample clips (JAX twin dynamicrafter_tpu/training/logging.py; reference
main/utils_train.py:99-173, the CUDACallback's memory report,
main/callbacks.py:104-133, and the ImageLogger callback,
main/callbacks.py:15-101)."""
from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from dynamicrafter_tpu_torch.utils.video import make_denoise_grid, save_clip, save_image

mainlogger = logging.getLogger("dynamicrafter_tpu_torch.train")


def setup_logger(logdir: str) -> logging.Logger:
    """INFO to `<logdir>/train.log` and to the console (replacing the
    handlers of an earlier call)."""
    os.makedirs(logdir, exist_ok=True)
    for h in list(mainlogger.handlers):
        mainlogger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (logging.FileHandler(os.path.join(logdir, "train.log")), logging.StreamHandler()):
        h.setFormatter(fmt)
        mainlogger.addHandler(h)
    mainlogger.setLevel(logging.INFO)
    mainlogger.propagate = False
    return mainlogger


def device_memory_stats() -> Dict[str, float]:
    """Live and peak allocated device memory (GB) from torch.cuda; on a
    machine without CUDA, the host's peak RSS as `peak_host_rss_gb`."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return {"mem_in_use_gb": torch.cuda.memory_allocated() / 1e9,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    import resource
    return {"peak_host_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}


class MetricLogger:
    """Appends one row per `log` call to `<logdir>/metrics.csv`; a metric
    that appears later widens the header and the file is rewritten."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.csv")
        self._fields = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                self._fields = list(csv.DictReader(f).fieldnames or [])
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in metrics.items()}, **device_memory_stats()}
        new = [k for k in row if k not in self._fields]
        if new and self._fields:
            with open(self.path) as f:
                rows = list(csv.DictReader(f))
            self._fields += new
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields, restval="")
                w.writeheader()
                w.writerows(rows)
        elif new:
            self._fields = new
            with open(self.path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writeheader()
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fields, restval="").writerow(row)


class SampleLogger:
    """The ImageLogger's work: every `every_n_steps` run the whole sampler on
    the first `max_samples` clips of the batch and write them under
    `<logdir>/samples` (mp4 where OpenCV imports, else uint8 `.npy`): the
    samples, with `log_inputs` the inputs and their VAE reconstructions
    (the reference's "image_condition" and "reconst" keys), with
    `plot_denoise_rows` one PNG per sample of the decoded DDIM intermediates
    every `denoise_log_every_t` steps, a row each. Both denoise options may
    also come inside `sample_kwargs`, as the reference passes them through
    log_images_kwargs (ddpm3d.py:1131). A TensorBoard video summary goes to
    `<logdir>/tb_samples` where `tensorboardX` imports. `autocast` is the
    compute dtype for a pipeline whose weights are stored in fp32 (training
    under bf16 autocast)."""

    def __init__(self, pipe, logdir: str, every_n_steps: int = 500,
                 sample_kwargs: Optional[dict] = None, max_samples: int = 2, fps: int = 8,
                 to_tensorboard: bool = True, log_inputs: bool = True,
                 plot_denoise_rows: bool = False, denoise_log_every_t: int = 10,
                 autocast: Optional[torch.dtype] = None):
        self.pipe = pipe
        self.dir = os.path.join(logdir, "samples")
        os.makedirs(self.dir, exist_ok=True)
        self.every = every_n_steps
        self.kwargs = dict(steps=50, cfg_scale=7.5, timestep_spacing="uniform_trailing",
                           guidance_rescale=0.7)
        # the reference's log_images names for the sampler's settings, as the
        # shipped training configs spell them
        alias = {"ddim_steps": "steps", "unconditional_guidance_scale": "cfg_scale",
                 "ddim_eta": "eta"}
        self.kwargs.update({alias.get(k, k): v for k, v in (sample_kwargs or {}).items()})
        self.max_samples = max_samples
        self.fps = fps
        self.log_inputs = log_inputs
        self.autocast = autocast
        self.plot_denoise_rows = bool(self.kwargs.pop("plot_denoise_rows", plot_denoise_rows))
        self.denoise_log_every_t = int(
            self.kwargs.pop("denoise_log_every_t", denoise_log_every_t))
        self._tb = None
        if to_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(logdir, "tb_samples"))
            except ImportError:
                self._tb = None

    @torch.no_grad()
    def maybe_log(self, step: int, batch: Dict) -> None:
        if step % self.every != 0:
            return
        as_np = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        videos = as_np(batch["video"])[: self.max_samples].astype(np.float32)
        prompts = list(batch.get("captions", [""] * len(videos)))[: self.max_samples]
        kwargs = dict(self.kwargs)
        if self.plot_denoise_rows:
            kwargs["log_every_t"] = self.denoise_log_every_t
        dev = self.pipe.device
        name = lambda i, tag="": os.path.join(self.dir, f"step{step:07d}_{i}{tag}")
        with torch.autocast(dev.type, dtype=self.autocast, enabled=self.autocast is not None):
            out = self.pipe.sample(prompts, videos,
                                   fs=[int(x) for x in as_np(batch["fs"])[: self.max_samples]],
                                   **kwargs)
            for i in range(out.videos.shape[0]):
                save_clip(out.videos[i, 0], name(i), fps=self.fps)
            if out.denoise_rows is not None:
                # (n_logs + 1, B, T, H, W, 3) -> one grid per sample
                for i in range(out.denoise_rows.shape[1]):
                    save_image(make_denoise_grid(out.denoise_rows[:, i]),
                               name(i, "_denoise_row.png"))
            if self.log_inputs:
                vids = torch.as_tensor(videos, device=dev)
                b, t, h, w, _ = vids.shape
                f = 2 ** (len(self.pipe.vae_config.ch_mult) - 1)
                noise = torch.randn((b * t, h // f, w // f, self.pipe.vae_config.z_channels),
                                    generator=torch.Generator(device=dev).manual_seed(0),
                                    device=dev)
                reconst = self.pipe.decode_latents(
                    self.pipe.encode_video(vids, noise)).cpu().numpy()
                for i in range(len(videos)):
                    save_clip(videos[i], name(i, "_input"), fps=self.fps)
                    save_clip(reconst[i], name(i, "_reconst"), fps=self.fps)
        if self._tb is not None:
            # (N, T, C, H, W) uint8 (reference main/callbacks.py:31-55)
            vids = np.clip((out.videos[:, 0] + 1.0) / 2.0, 0, 1)
            vids = (vids * 255).astype(np.uint8).transpose(0, 1, 4, 2, 3)
            self._tb.add_video("samples", vids, global_step=step, fps=self.fps)
            self._tb.flush()
        mainlogger.info(f"[SampleLogger] wrote {out.videos.shape[0]} samples at step {step}")
