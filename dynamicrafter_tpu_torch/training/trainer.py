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
from dynamicrafter_tpu_torch.parallel import sharding
from dynamicrafter_tpu_torch.parallel.sharding import (
    BUCKET_NUMEL,
    FlatShards,
    FrameSplit,
    Mesh,
    dp_mean,
)
from dynamicrafter_tpu_torch.schedule import extract_into_tensor
from dynamicrafter_tpu_torch.training.ema import ema_init, ema_update
from dynamicrafter_tpu_torch.utils import trace


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
                             logvar: Optional[torch.Tensor] = None, share: float = 1.0):
    """The loss after the model call (ddpm3d.py:763-783): per-timestep
    logvar weighting (the learned table, else the constant
    cfg.logvar_init), l_simple_weight, and original_elbo_weight * loss_vlb.
    loss_simple: (B,) per-sample mean l1/l2 losses. With `share` < 1,
    loss_simple is one sp rank's part of each clip's mean (its frames' sum
    over the clip's count) and the returned loss is that rank's part of the
    loss: the parts of the sp ranks sum to the clip's loss (the logvar
    term, which does not scale with loss_simple, is shared out)."""
    if logvar is not None:
        logvar_t = logvar[t].to(loss_simple.dtype)
    else:
        logvar_t = torch.tensor(cfg.logvar_init, dtype=loss_simple.dtype,
                                device=loss_simple.device)
    loss_gamma = loss_simple / torch.exp(logvar_t) + share * logvar_t
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

    Returns fn(batch, draws, frames=None) -> (z, text_ctx, img_ctx, cc).
    batch: video (B, T, H, W, 3) in [-1, 1], tokens (B, 77) int64. The
    frozen towers run without gradients; the Resampler records them when it
    is trainable. With `frames` (a clip split over the sp ranks) z and cc
    are this rank's frames: the VAE encodes them alone, and the frames the
    concat takes (the conditioning frame, or the first and last) are encoded
    on every rank; text_ctx and img_ctx stay whole."""
    null_tokens = torch.as_tensor(np.asarray(pipe.tokenizer([""])), dtype=torch.long,
                                  device=pipe.device)
    p = cfg.uncond_prob

    def encode(video, noise, idx=None):
        """The latents of frames `idx` (a tensor; default: all) of video."""
        if idx is None:
            return pipe.encode_video(video, noise)
        b, t = video.shape[:2]
        noise = noise.view(b, t, *noise.shape[1:]).index_select(1, idx).flatten(0, 1)
        return pipe.encode_video(video.index_select(1, idx), noise)

    def batch_input(batch, draws: Draws, frames: Optional[FrameSplit] = None):
        video = batch["video"]
        b, t = video.shape[:2]
        with torch.no_grad():
            if frames is None:
                z = encode(video, draws.enc_noise)
            else:
                mine = torch.arange(frames.lo, frames.lo + frames.local, device=video.device)
                z = encode(video, draws.enc_noise, mine)
                ends = torch.tensor([0, t - 1], device=video.device)
                z_cond = encode(video, draws.enc_noise,
                                ends if cfg.interp_mode else draws.cond_idx)
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
        if frames is not None:
            if cfg.interp_mode:
                cc = torch.zeros((b, t, *z.shape[2:]), dtype=z.dtype, device=z.device)
                cc[:, 0], cc[:, -1] = z_cond[:, 0], z_cond[:, 1]
                cc = frames.slice(cc)
            else:
                cc = z_cond.expand(z.shape)
        elif cfg.interp_mode:
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
    the EMA follows after every call, and `step` counts calls.

    With a `mesh`, ZeRO-2 over its dp axis, in the order of the JAX step
    (trainer.py:286-303; the reference's DDPSharded strategy): `update`
    reduce-scatters the local gradients (each the mean over this rank's
    batch) into this rank's shard of their dp mean and keeps the running
    mean in a shard-sized accumulator; at the window's end it clips by the
    global norm, runs AdamW on the shard and all-gathers the shard into the
    tensors in place. The AdamW is `torch.optim.AdamW` itself, over views of
    this rank's elements of the tensors (`pieces`), its moments views of the
    shard-sized `exp_avg` and `exp_avg_sq`; the EMA shadow `ema` is this
    rank's shard too. The arithmetic is the plain path's kernel for kernel,
    so at dp 1 the two agree bit for bit. `update` returns the global norm
    of the micro-step's dp-mean gradient. `state_dict` gathers full tensors
    onto rank 0's host in the plain path's format (no padding; None on the
    other ranks), so a checkpoint resumes at any dp; `load_state_dict` takes
    this rank's shard. Every rank makes every call. The layout is `shards`
    (`parallel.sharding.FlatShards`)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: TrainConfig,
                 mesh: Optional[Mesh] = None, bucket_numel: int = BUCKET_NUMEL):
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.step = 0          # micro-steps taken
        self.mini_step = 0     # position inside the accumulation window
        self._acc: Optional[List[torch.Tensor]] = None
        if mesh is None:
            self.optimizer = torch.optim.AdamW(
                list(params.values()), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=cfg.weight_decay)
            self.ema = ema_init(params) if cfg.use_ema else None
            return
        tensors = [p.detach() for p in params.values()]
        self.shards = FlatShards(tensors, mesh, bucket_numel)
        self.pieces = self.shards.views(tensors)
        self.optimizer = torch.optim.AdamW(
            self.pieces, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay)
        self.exp_avg, self.exp_avg_sq = self.shards.zeros(), self.shards.zeros()
        self._set_moments(0)
        self.ema = self.shards.shard_of(tensors) if cfg.use_ema else None

    def _set_moments(self, steps: int) -> None:
        """The optimizer's state: each piece's moments as views of the flat
        shards (the padding stays outside every view) after `steps` steps."""
        for piece, m, v in zip(self.pieces, self.shards.pieces(self.exp_avg),
                               self.shards.pieces(self.exp_avg_sq)):
            self.optimizer.state[piece] = {"step": torch.tensor(float(steps)),
                                           "exp_avg": m, "exp_avg_sq": v}

    @property
    def adam_steps(self) -> int:
        return int(self.optimizer.state[self.pieces[0]]["step"]) if self.pieces else 0

    def update(self, grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
        """Take one micro-step's gradients (in `params` order; consumed).
        With a mesh, returns the global norm of their dp mean."""
        with trace.span("update", mini_step=self.mini_step):
            return self._update(grads)

    def _update(self, grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
        if self.mesh is not None:
            return self._update_sharded(grads)
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
                # consumed: freed before AdamW's moments and temporaries are
                # allocated (a full-size set of buffers less at the peak)
                grads.clear()
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

    @torch.no_grad()
    def _update_sharded(self, grads: List[torch.Tensor]) -> torch.Tensor:
        # the plain path's foreach kernels on one-element lists: a scalar
        # division or a multiplication may round otherwise in another kernel
        k = self.cfg.accumulate_grad_batches
        g = self.shards.reduce_scatter(grads)
        norm = self.shards.norm(g)
        if k > 1:
            if self._acc is None:
                self._acc = g
            else:
                torch._foreach_sub_([g], [self._acc])
                torch._foreach_div_([g], self.mini_step + 1)
                torch._foreach_add_([self._acc], [g])
            g = self._acc
        if self.mini_step == k - 1:
            total = norm if k == 1 else self.shards.norm(g)
            torch._foreach_mul_([g], torch.where(total < self.cfg.grad_clip, 1.0,
                                                 self.cfg.grad_clip / total))
            for piece, grad in zip(self.pieces, self.shards.pieces(g)):
                piece.grad = grad
            self.optimizer.step()
            for piece in self.pieces:
                piece.grad = None
            self.shards.gather_into(list(self.params.values()))
            self._acc = None
        self.mini_step = (self.mini_step + 1) % k
        if self.ema is not None:
            d = min(self.cfg.ema_decay, (1.0 + self.step) / (10.0 + self.step))
            torch._foreach_lerp_(self.shards.pieces(self.ema),
                                 self.shards.views(list(self.params.values())), 1.0 - d)
        self.step += 1
        return norm

    def state_dict(self) -> dict:
        if self.mesh is not None:
            return self._state_dict_sharded()
        return {
            "step": self.step,
            "optimizer": self.optimizer.state_dict(),
            "ema": self.ema,
            "mini_step": self.mini_step,
            "acc_grads": (dict(zip(self.params, self._acc))
                          if self._acc is not None else None),
        }

    def _state_dict_sharded(self) -> Optional[dict]:
        """`state_dict` gathered from the shards onto rank 0's CPU, in the
        plain path's format (either path's `load_state_dict` reads it). Every
        rank makes the all-gathers; the others copy nothing to the host and
        get None."""
        gather = lambda shard: self.shards.gather(shard, "cpu", root=0)
        m = v = ema = acc = None
        steps = self.adam_steps
        if steps:
            m, v = gather(self.exp_avg), gather(self.exp_avg_sq)
        if self.ema is not None:
            ema = gather(self.ema)
        if self._acc is not None:
            acc = gather(self._acc)
        if self.mesh.rank != 0:
            return None
        moments = {} if m is None else {
            i: {"step": torch.tensor(float(steps)), "exp_avg": m[i], "exp_avg_sq": v[i]}
            for i in range(len(m))}
        group = dict(self.optimizer.state_dict()["param_groups"][0],
                     params=list(range(len(self.params))))
        return {
            "step": self.step,
            "optimizer": {"state": moments, "param_groups": [group]},
            "ema": dict(zip(self.params, ema)) if ema is not None else None,
            "mini_step": self.mini_step,
            "acc_grads": dict(zip(self.params, acc)) if acc is not None else None,
        }

    @torch.no_grad()
    def _load_sharded(self, state: dict, weights_only: bool) -> None:
        in_order = lambda d: [d[k] for k in self.params]
        if self.ema is not None and state.get("ema") is not None:
            self.ema = self.shards.shard_of(in_order(state["ema"]))
        if weights_only:
            return
        self.step = int(state["step"])
        self.mini_step = int(state["mini_step"])
        opt = state["optimizer"]
        self.optimizer.param_groups[0].update(
            {k: v for k, v in opt["param_groups"][0].items() if k != "params"})
        per_param = [opt["state"].get(i) for i in range(len(self.params))]
        if per_param[0] is None:
            self.exp_avg.zero_()
            self.exp_avg_sq.zero_()
            self._set_moments(0)
        else:
            for name, shard in (("exp_avg", self.exp_avg), ("exp_avg_sq", self.exp_avg_sq)):
                shard.copy_(self.shards.shard_of([s[name] for s in per_param]))
            self._set_moments(int(per_param[0]["step"]))
        acc = state["acc_grads"]
        self._acc = self.shards.shard_of(in_order(acc)) if acc is not None else None

    @torch.no_grad()
    def load_state_dict(self, state: dict, weights_only: bool = False) -> None:
        if self.mesh is not None:
            return self._load_sharded(state, weights_only)
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
    tensors; checkpoints and EMA use the same keys.

    With a `mesh` each dp rank takes its own batch and draws (seeded from
    (seed, dp rank, step) where dp > 1), the optimizer is ZeRO-2 over dp
    where dp > 1 (`AccumulatingAdamW`; the plain one at dp 1) and the
    metrics are dp means; every rank must make every call. With sp > 1 the
    ranks of an sp group share the batch and draws and split each clip's
    frames (`loss`), and their gradients are summed over the group before
    the dp reduce-scatter (ZeRO stays over dp, as JAX's `zero_spec` shards
    over the data axis alone)."""

    def __init__(self, pipe, cfg: TrainConfig, train_resampler: bool = True, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        self.pipe, self.cfg, self.seed, self.mesh = pipe, cfg, seed, mesh
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
        # ZeRO over dp; at dp 1 there is nothing to shard, and the plain
        # optimizer spares the shard-sized buffers (bit for bit the same
        # arithmetic, AccumulatingAdamW's docstring)
        self.opt = AccumulatingAdamW(self.params, cfg,
                                     mesh=mesh if mesh is not None and mesh.dp > 1 else None)
        self.batch_input = make_batch_input(pipe, cfg)

    @property
    def step(self) -> int:
        return self.opt.step

    # ------------------------------------------------------------------
    # one micro-step
    # ------------------------------------------------------------------

    def draw(self, batch, generator: Optional[torch.Generator] = None) -> Draws:
        """This micro-step's random numbers, from a generator seeded from
        (seed, step), with a mesh of dp > 1 (seed, dp rank, step), unless one
        is given; whole clips' draws on every sp rank."""
        pipe, cfg = self.pipe, self.cfg
        video = batch["video"]
        dev = video.device
        if generator is None:
            # at dp 1 the one batch is the one-process run's, and so are its draws
            entropy = ([self.seed, self.step] if self.mesh is None or self.mesh.dp == 1
                       else [self.seed, self.mesh.dp_rank, self.step])
            seed = int(np.random.SeedSequence(entropy).generate_state(1)[0])
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

    def frames(self, batch) -> Optional[FrameSplit]:
        """The split of the batch's clips over the mesh's sp ranks, or None
        (no mesh, sp = 1, or sp does not divide the frames: every rank of
        the group then runs whole clips)."""
        if self.mesh is None:
            return None
        return sharding.split_frames(batch["video"].shape[1], self.mesh)

    def _autocast(self):
        if not self.cfg.bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.pipe.device.type, dtype=torch.bfloat16)

    def loss(self, batch, draws: Draws):
        """(loss, metrics) of one micro-step (ddpm3d.py:740-784). Under sp
        this rank's frames of each clip: the loss is this rank's part (the
        parts of the sp group sum to the clip's loss; each rank's backward
        reaches the others' frames through the collectives), the metrics
        are the whole clips' (the per-clip sums all-reduced over the group
        and divided by the clips' element counts)."""
        cfg, sched, unet = self.cfg, self.pipe.schedule, self.pipe.unet
        frames = self.frames(batch)
        mine = (lambda a: a) if frames is None else frames.slice
        with contextlib.ExitStack() as forward:
            with self._autocast(), sharding.use_frames(frames):
                with trace.span("batch_input"):
                    z, text_ctx, img_ctx, cc = self.batch_input(batch, draws, frames)
                forward.enter_context(trace.span("forward"))    # to the loss's end
                t = draws.t
                if sched.scale_arr is not None:
                    # dynamic rescale of x0 (ddpm3d.py:711-715)
                    z = z * extract_into_tensor(sched.scale_arr, t, z.dim())
                noise = mine(draws.noise)
                if cfg.noise_strength > 0:
                    noise = noise + cfg.noise_strength * mine(draws.offset)
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
            err = err.abs() if cfg.loss_type == "l1" else err.square()
            if frames is None:
                return combine_diffusion_losses(err.mean(dim=(1, 2, 3, 4)), t, cfg, sched,
                                                self.logvar)
            part = err.sum(dim=(1, 2, 3, 4)) / (err[0].numel() * frames.sp)
            whole = sharding.sp_all_reduce(part.detach(), frames)
            loss, _ = combine_diffusion_losses(part, t, cfg, sched, self.logvar,
                                               1.0 / frames.sp)
            _, metrics = combine_diffusion_losses(whole, t, cfg, sched, self.logvar)
            return loss, metrics

    def loss_and_grads(self, batch, draws: Draws):
        """Forward and backward of one micro-step: (loss, metrics, grads),
        loss and metrics detached (a live graph would keep the weights'
        AccumulateGrad nodes), grads in `params` order (zeros where a
        tensor got none)."""
        for p in self.params.values():
            p.grad = None
        loss, metrics = self.loss(batch, draws)
        with trace.span("backward"):
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params.values()]
        for p in self.params.values():
            p.grad = None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(self, batch, draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """One micro-step; metrics are 0-d device tensors, `grad_norm` the
        norm of this micro-step's raw gradients (with a mesh: the losses'
        dp means and the norm of the dp-mean gradient, as the JAX step
        reports them over its global batch)."""
        with trace.span("train_step", step=self.step):
            if draws is None:
                draws = self.draw(batch)
            _, metrics, grads = self.loss_and_grads(batch, draws)
            if self.mesh is not None:
                if self.frames(batch) is not None:
                    sharding.sp_sum_(grads, self.mesh)
                metrics = dp_mean(metrics, self.mesh)
            if self.opt.mesh is not None:
                metrics["grad_norm"] = self.opt.update(grads)
                return metrics
            metrics["grad_norm"] = global_norm(grads)
            self.opt.update(grads)
            return metrics

    @contextlib.contextmanager
    def ema_scope(self):
        """The EMA weights swapped into the modules (reference ema_scope,
        ddpm3d.py:188-201); the trained weights come back on exit. With a
        mesh every rank all-gathers the EMA shards into its modules."""
        ema = self.opt.ema
        if ema is None:
            yield
            return
        with torch.no_grad():
            saved = {k: p.detach().clone() for k, p in self.params.items()}
            if self.opt.mesh is not None:
                self.opt.shards.gather_into(list(self.params.values()), ema)
            else:
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
        (ddpm3d.py:398-405); with a mesh their dp means."""
        if draws is None:
            draws = self.draw(batch)
        _, m = self.loss(batch, draws)
        out = {"val/loss": m["loss"], "val/loss_simple": m["loss_simple"],
               "val/loss_vlb": m["loss_vlb"]}
        if self.opt.ema is not None:
            with self.ema_scope():
                out["val/loss_ema"] = self.loss(batch, draws)[1]["loss"]
        return out if self.mesh is None else dp_mean(out, self.mesh)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def state_dict(self) -> Optional[dict]:
        """The step, the trainable weights, and the optimizer, EMA and
        accumulator state (`AccumulatingAdamW.state_dict`). With a mesh every
        rank calls it and rank 0 alone gets the state; the others get None."""
        opt = self.opt.state_dict()
        if opt is None:
            return None
        return {"weights": {k: p.detach() for k, p in self.params.items()}, **opt}

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
