"""The training step: batch preparation, the diffusion loss, and the
optimizer around them.

JAX twin dynamicrafter_tpu/training/trainer.py (reference
lvdm/models/ddpm3d.py:740-827, 1052-1128):

  * `make_batch_input`: VAE posterior sample, 5/5/5 % CFG dropout (text,
    image, both), CLIP text with the null prompt, a random conditioning
    frame, CLIP vision tower and Resampler, and the hybrid (conditioning
    frame repeated) or interp (first and last frame) concat;
  * `Trainer.loss`: dynamic rescale of x0, offset noise, q_sample, the v,
    eps or x0 target, l1/l2, the per-timestep logvar (learned or constant)
    and the ELBO term (`combine_diffusion_losses`);
  * `Trainer.train_step`: AdamW with optax's defaults after a global-norm
    clip, on the mean of `accumulate_grad_batches` micro-step gradients
    (optax.MultiSteps), EMA after every micro-step, the step counting
    micro-steps.

The trainable modules keep fp32 master weights; with `bf16` the forward runs
under `torch.autocast(bfloat16)`, which is what the JAX trainer does with
`--bf16` and `cast_storage=False`. Training is deterministic (no dropout),
as in JAX. Every random number of a step comes from one `torch.Generator`
seeded from (seed, step), the counterpart of JAX's `fold_in(rng, step)`;
`Draws` is the seam through which a test hands in JAX's numbers instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dynamicrafter_tpu_torch.models.clip import clip_preprocess
from dynamicrafter_tpu_torch.schedule import extract_into_tensor
from dynamicrafter_tpu_torch.training.ema import ema_init, ema_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    grad_clip: float = 0.5
    accumulate_grad_batches: int = 1
    ema_decay: float = 0.9999
    use_ema: bool = True
    uncond_prob: float = 0.05        # 5/5/5 % text/image/both dropout
    rand_cond_frame: bool = True
    interp_mode: bool = False
    loss_type: str = "l2"
    parameterization: str = "v"
    noise_strength: float = 0.0      # offset noise (ddpm3d.py:740-747)
    l_simple_weight: float = 1.0     # ddpm3d.py:63,777
    original_elbo_weight: float = 0.0  # weight on loss_vlb (ddpm3d.py:61,782)
    learn_logvar: bool = False       # per-timestep trainable logvar table
    logvar_init: float = 0.0         # ddpm3d.py:69,119
    bf16: bool = False               # autocast the forward to bfloat16


def combine_diffusion_losses(loss_simple: torch.Tensor, t: torch.Tensor,
                             cfg: TrainConfig, schedule,
                             logvar: Optional[torch.Tensor] = None):
    """The loss after the model call (ddpm3d.py:763-783): per-timestep
    logvar weighting (the learned table, else the constant
    cfg.logvar_init), l_simple_weight, and original_elbo_weight * loss_vlb.
    loss_simple: (B,) per-sample mean l1/l2 losses."""
    if logvar is not None:
        logvar_t = logvar[t].to(loss_simple.dtype)
    else:
        logvar_t = torch.tensor(cfg.logvar_init, dtype=loss_simple.dtype,
                                device=loss_simple.device)
    loss_gamma = loss_simple / torch.exp(logvar_t) + logvar_t
    loss = cfg.l_simple_weight * loss_gamma.mean()
    lvlb = torch.as_tensor(schedule.lvlb_weights, device=t.device)[t]
    loss_vlb = (lvlb * loss_simple).mean()
    loss = loss + cfg.original_elbo_weight * loss_vlb
    metrics = {"loss": loss, "loss_simple": loss_simple.mean(), "loss_vlb": loss_vlb}
    if cfg.learn_logvar:
        metrics["loss_gamma"] = loss_gamma.mean()
        metrics["logvar"] = logvar.mean()
    return loss, metrics


class Draws(NamedTuple):
    """The random numbers of one micro-step."""
    t: torch.Tensor                  # (B,) int64 DDPM timesteps
    noise: torch.Tensor              # (B, T, h, w, c) diffusion noise
    enc_noise: torch.Tensor          # (B*T, h, w, c) VAE posterior noise
    uniform: torch.Tensor            # (B,) CFG-dropout uniforms in [0, 1)
    cond_idx: torch.Tensor           # (1,) int64 conditioning frame
    offset: Optional[torch.Tensor] = None   # (B, T, 1, 1, c) offset noise


def make_batch_input(pipe, cfg: TrainConfig):
    """The conditioning assembly (get_batch_input, ddpm3d.py:1058-1128).

    Returns fn(batch, draws) -> (z, text_ctx, img_ctx, cc). batch: video
    (B, T, H, W, 3) in [-1, 1], tokens (B, 77) int64. The frozen towers run
    without gradients; the Resampler records them when it is trainable."""
    null_tokens = torch.as_tensor(np.asarray(pipe.tokenizer([""])), dtype=torch.long,
                                  device=pipe.device)
    p = cfg.uncond_prob

    def batch_input(batch, draws: Draws):
        video = batch["video"]
        b, t = video.shape[:2]
        with torch.no_grad():
            z = pipe.encode_video(video, draws.enc_noise)
            u = draws.uniform
            prompt_mask = (u < 2 * p)[:, None, None]
            input_mask = 1.0 - ((u >= p) & (u < 3 * p)).to(video.dtype)[:, None, None, None]
            text_emb = pipe.text_encoder(batch["tokens"])
            null_emb = pipe.text_encoder(null_tokens)
            text_ctx = torch.where(prompt_mask, null_emb, text_emb)
            img = video.index_select(1, draws.cond_idx)[:, 0] * input_mask
            px = clip_preprocess(img, pipe.vision_encoder.config.image_size)
            tokens = pipe.vision_encoder(px)
        img_ctx = pipe.resampler(tokens)
        img_ctx = img_ctx.reshape(b, t, -1, img_ctx.shape[-1])
        if cfg.interp_mode:
            cc = torch.zeros_like(z)
            cc[:, 0], cc[:, -1] = z[:, 0], z[:, -1]
        else:
            cc = z.index_select(1, draws.cond_idx).expand(z.shape)
        return z, text_ctx, img_ctx, cc

    return batch_input


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: scale by max_norm / norm when
    norm >= max_norm."""
    norm = global_norm(grads)
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


class AccumulatingAdamW:
    """What the JAX trainer's `optax.MultiSteps(chain(clip_by_global_norm,
    adamw), k)` and `ema_update` do to a dict of fp32 tensors: `update`
    takes one micro-step's gradients, keeps their running mean, and every
    k-th call clips the mean by its global norm and applies AdamW (optax's
    defaults: betas 0.9/0.999, eps 1e-8, weight decay `cfg.weight_decay`);
    the EMA follows after every call, and `step` counts calls."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig):
        self.params, self.cfg = params, cfg
        self.optimizer = torch.optim.AdamW(
            list(params.values()), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.ema = ema_init(params) if cfg.use_ema else None
        self.step = 0          # micro-steps taken
        self.mini_step = 0     # position inside the accumulation window
        self._acc: Optional[List[torch.Tensor]] = None

    def update(self, grads: List[torch.Tensor]) -> None:
        """Take one micro-step's gradients (in `params` order; consumed)."""
        k = self.cfg.accumulate_grad_batches
        if k > 1:
            # Welford running mean, as optax.MultiSteps keeps it; in place
            # in `grads`, so no full-size temporaries
            if self._acc is None:
                self._acc = grads
            else:
                torch._foreach_sub_(grads, self._acc)
                torch._foreach_div_(grads, self.mini_step + 1)
                torch._foreach_add_(self._acc, grads)
            grads = self._acc
        if self.mini_step == k - 1:
            clip_by_global_norm_(grads, self.cfg.grad_clip)
            for p, g in zip(self.params.values(), grads):
                p.grad = g
            self.optimizer.step()
            for p in self.params.values():
                p.grad = None
            self._acc = None
        self.mini_step = (self.mini_step + 1) % k
        if self.ema is not None:
            ema_update(self.ema, self.params, self.step, self.cfg.ema_decay)
        self.step += 1

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "optimizer": self.optimizer.state_dict(),
            "ema": self.ema,
            "mini_step": self.mini_step,
            "acc_grads": (dict(zip(self.params, self._acc))
                          if self._acc is not None else None),
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict, weights_only: bool = False) -> None:
        if self.ema is not None and state.get("ema") is not None:
            for k, s in self.ema.items():
                s.copy_(state["ema"][k])
        if weights_only:
            return
        self.step = int(state["step"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.mini_step = int(state["mini_step"])
        acc = state["acc_grads"]
        self._acc = ([acc[k].to(p.device) for k, p in self.params.items()]
                     if acc is not None else None)


class Trainer:
    """The train step for one pipeline built with
    `DynamiCrafterPipeline.for_training`.

    `params` maps reference checkpoint keys (`model.diffusion_model.*`,
    `image_proj_model.*`, and `logvar` when learned) to the trainable
    tensors; checkpoints and EMA use the same keys."""

    def __init__(self, pipe, cfg: TrainConfig, train_resampler: bool = True, seed: int = 0):
        self.pipe, self.cfg, self.seed = pipe, cfg, seed
        modules = {"model.diffusion_model.": pipe.unet}
        if train_resampler:
            modules["image_proj_model."] = pipe.resampler
        self.params: Dict[str, torch.Tensor] = {
            prefix + name: p for prefix, m in modules.items()
            for name, p in m.named_parameters()}
        self.logvar = None
        if cfg.learn_logvar:
            self.logvar = torch.full((pipe.schedule.num_timesteps,), cfg.logvar_init,
                                     device=pipe.device, requires_grad=True)
            self.params["logvar"] = self.logvar
        self.opt = AccumulatingAdamW(self.params, cfg)
        self.batch_input = make_batch_input(pipe, cfg)

    @property
    def step(self) -> int:
        return self.opt.step

    # ------------------------------------------------------------------
    # one micro-step
    # ------------------------------------------------------------------

    def draw(self, batch, generator: Optional[torch.Generator] = None) -> Draws:
        """This micro-step's random numbers, from a generator seeded from
        (seed, step) unless one is given."""
        pipe, cfg = self.pipe, self.cfg
        video = batch["video"]
        dev = video.device
        if generator is None:
            seed = int(np.random.SeedSequence([self.seed, self.step]).generate_state(1)[0])
            generator = torch.Generator(device=dev).manual_seed(seed)
        b, t, hh, ww = video.shape[:4]
        f = pipe._latent_factor
        lat = (b, t, hh // f, ww // f, pipe.vae_config.z_channels)
        kw = dict(generator=generator, device=dev)
        t_len = pipe.unet_config.temporal_length if cfg.rand_cond_frame else 1
        return Draws(
            t=torch.randint(0, pipe.schedule.num_timesteps, (b,), **kw),
            noise=torch.randn(lat, **kw),
            enc_noise=torch.randn((b * t, *lat[2:]), **kw),
            uniform=torch.rand((b,), **kw),
            cond_idx=torch.randint(0, t_len, (1,), **kw),
            offset=(torch.randn((b, t, 1, 1, lat[-1]), **kw)
                    if cfg.noise_strength > 0 else None))

    def _autocast(self):
        if not self.cfg.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.pipe.device.type, dtype=torch.bfloat16)

    def loss(self, batch, draws: Draws):
        """(loss, metrics) of one micro-step (ddpm3d.py:740-784)."""
        cfg, sched, unet = self.cfg, self.pipe.schedule, self.pipe.unet
        with self._autocast():
            z, text_ctx, img_ctx, cc = self.batch_input(batch, draws)
            t = draws.t
            if sched.scale_arr is not None:
                # dynamic rescale of x0 (ddpm3d.py:711-715)
                z = z * extract_into_tensor(sched.scale_arr, t, z.dim())
            noise = draws.noise
            if cfg.noise_strength > 0:
                noise = noise + cfg.noise_strength * draws.offset
            x_noisy = sched.q_sample(z, t, noise)
            if cfg.parameterization == "v":
                target = sched.get_v(z, noise, t)
            elif cfg.parameterization == "eps":
                target = noise
            else:
                target = z
            pred = unet(torch.cat([x_noisy, cc], dim=-1), t, context_text=text_ctx,
                        context_img=img_ctx, fs=batch.get("fs"))
        err = pred.float() - target
        loss_simple = (err.abs() if cfg.loss_type == "l1" else err.square()).mean(dim=(1, 2, 3, 4))
        return combine_diffusion_losses(loss_simple, t, cfg, sched, self.logvar)

    def loss_and_grads(self, batch, draws: Draws):
        """Forward and backward of one micro-step: (loss, metrics, grads),
        loss and metrics detached (a live graph would keep the weights'
        AccumulateGrad nodes), grads in `params` order (zeros where a
        tensor got none)."""
        for p in self.params.values():
            p.grad = None
        loss, metrics = self.loss(batch, draws)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params.values()]
        for p in self.params.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(self, batch, draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """One micro-step; metrics are 0-d device tensors, `grad_norm` the
        norm of this micro-step's raw gradients."""
        if draws is None:
            draws = self.draw(batch)
        _, metrics, grads = self.loss_and_grads(batch, draws)
        metrics["grad_norm"] = global_norm(grads)
        self.opt.update(grads)
        return metrics

    @contextlib.contextmanager
    def ema_scope(self):
        """The EMA weights swapped into the modules (reference ema_scope,
        ddpm3d.py:188-201); the trained weights come back on exit."""
        ema = self.opt.ema
        if ema is None:
            yield
            return
        with torch.no_grad():
            saved = {k: p.detach().clone() for k, p in self.params.items()}
            for k, p in self.params.items():
                p.copy_(ema[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in self.params.items():
                    p.copy_(saved[k])

    @torch.no_grad()
    def eval_step(self, batch, draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """Validation losses with and without the EMA weights
        (ddpm3d.py:398-405)."""
        if draws is None:
            draws = self.draw(batch)
        _, m = self.loss(batch, draws)
        out = {"val/loss": m["loss"], "val/loss_simple": m["loss_simple"],
               "val/loss_vlb": m["loss_vlb"]}
        if self.opt.ema is not None:
            with self.ema_scope():
                out["val/loss_ema"] = self.loss(batch, draws)[1]["loss"]
        return out

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """The step, the trainable weights, and the optimizer, EMA and
        accumulator state (`AccumulatingAdamW.state_dict`)."""
        return {"weights": {k: p.detach() for k, p in self.params.items()},
                **self.opt.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict, weights_only: bool = False) -> None:
        """Restore a `state_dict`; `weights_only` takes the weights and EMA
        and keeps a fresh optimizer and step counter."""
        if set(state["weights"]) != set(self.params):
            raise KeyError("checkpoint weights do not match the trainable tensors: "
                           f"{sorted(set(state['weights']) ^ set(self.params))[:10]}")
        for k, p in self.params.items():
            p.copy_(state["weights"][k])
        self.opt.load_state_dict(state, weights_only)
