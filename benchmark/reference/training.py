"""The reference fine-tuning step, float32 (TF32 off): DynamiCrafter's
`get_batch_input` and `p_losses` (lvdm/models/ddpm3d.py) and AdamW after a
global-norm clip on the mean of the accumulated micro-step gradients, all
from the published recipe (`configs/training_*.yaml`), written here.

A micro-step takes the benchmark's batch (video, tokens, fs) and draws
(timestep, diffusion noise, VAE posterior noise, the CFG-dropout uniform,
the conditioning frame): the VAE encodes every frame; with u < 2p the text
is the empty prompt's, with p <= u < 3p the conditioning image is zeroed
(p = uncond_prob); the Resampler embeds the CLIP tokens of the
conditioning frame (trained); the concat repeats that frame's latent; x0
is scaled by the dynamic-rescale factor of t; the loss is the mean square
error of the UNet's v prediction.

Under a bf16 recipe (`bf16_products`) the trained Linear and convolution
weights and biases are read rounded to bfloat16, as the recipe's autocast
reads its float32 master weights; the masters keep float32 and take the
update. After an AdamW step of lr 1e-5, below bfloat16's spacing at the
weights' scale (1.2e-4 at 0.02), the rounded weights and the masters are
different functions, so a reference on the masters would compare another
model.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch import nn

from benchmark.reference.clip import clip_preprocess
from benchmark.reference.diffusion import Schedule


def micro_step_loss(ref, batch: dict, draws: dict, sched: Schedule, uncond_prob: float,
                    null_tokens: torch.Tensor) -> torch.Tensor:
    video = batch["video"]                      # (1, T, H, W, 3)
    b, t = video.shape[:2]
    dev = video.device
    p = uncond_prob
    with torch.no_grad():
        flat = video.reshape(b * t, *video.shape[2:])
        z = torch.cat([ref.encode(flat[i:i + 1], draws["enc_noise"][i:i + 1])
                       for i in range(b * t)])
        z = z.reshape(b, t, *z.shape[1:])
        u = draws["uniform"]
        drop_text = (u < 2 * p)[:, None, None]
        keep_img = 1.0 - ((u >= p) & (u < 3 * p)).float()[:, None, None, None]
        text = torch.where(drop_text, ref.embed_text(null_tokens),
                           ref.embed_text(batch["tokens"]))
        img = video[:, int(draws["cond_idx"])] * keep_img
        tokens = ref.embedder(clip_preprocess(img, ref.embedder.config.image_size))
    img_ctx = ref.image_proj_model(tokens)
    img_ctx = img_ctx.reshape(b, t, -1, img_ctx.shape[-1])
    cc = z[:, int(draws["cond_idx"])][:, None].expand(z.shape)
    ts = draws["t"]
    shape = (b,) + (1,) * (z.dim() - 1)
    col = lambda a: torch.as_tensor(a, device=dev)[ts].float().reshape(shape)
    abar = col(sched.alphas_cumprod)
    z = z * col(sched.scale_arr)
    noise = draws["noise"]
    x_noisy = abar.sqrt() * z + (1 - abar).sqrt() * noise
    target = abar.sqrt() * noise - (1 - abar).sqrt() * z
    pred = ref.unet(torch.cat([x_noisy, cc], dim=-1), ts, context_text=text,
                    context_img=img_ctx, fs=batch["fs"])
    return (pred - target).square().mean()


class AdamW:
    """Mean of `k` micro-step gradients, clipped to a global norm, then
    AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, k: int, clip: float,
                 weight_decay: float = 0.0):
        self.params, self.lr, self.k, self.clip, self.wd = params, lr, k, clip, weight_decay
        self.acc: Dict[str, torch.Tensor] = {}
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.micro = self.steps = 0

    @torch.no_grad()
    def load(self, m, v, steps: int) -> None:
        """Continue from moments `m`, `v` (lists in `params` order; None
        before the first step) after `steps` steps, with nothing
        accumulated."""
        self.acc, self.micro, self.steps = {}, 0, steps
        if m is not None:
            for n, a, b in zip(self.params, m, v):
                self.m[n].copy_(a)
                self.v[n].copy_(b)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        for n, g in grads.items():
            self.acc[n] = self.acc[n] + g if n in self.acc else g.clone()
        self.micro += 1
        if self.micro % self.k:
            return
        mean = {n: a / self.k for n, a in self.acc.items()}
        self.acc = {}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in mean.values()]))
        factor = 1.0 if norm < self.clip else self.clip / norm
        self.steps += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n, p in self.params.items():
            g = mean[n] * factor
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[n] / (1 - b1 ** self.steps)
            v_hat = self.v[n] / (1 - b2 ** self.steps)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + eps))


@contextlib.contextmanager
def bf16_products(modules, on: bool = True):
    """While open, every Linear and convolution of `modules` holds its
    weight and bias rounded to bfloat16 (in float32); the masters come back
    on exit. Gradients taken inside are the masters' (autocast's cast
    passes them through)."""
    saved = []
    if on:
        with torch.no_grad():
            for m in modules:
                for mod in m.modules():
                    if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                        for t in (mod.weight, mod.bias):
                            if t is not None:
                                saved.append((t, t.detach().clone()))
                                t.copy_(t.to(torch.bfloat16).float())
    try:
        yield
    finally:
        with torch.no_grad():
            for t, master in saved:
                t.copy_(master)


def trainable(ref) -> Dict[str, torch.Tensor]:
    """The trained tensors under their checkpoint keys (UNet and Resampler)."""
    out = {}
    for prefix, m in (("model.diffusion_model.", ref.unet),
                      ("image_proj_model.", ref.image_proj_model)):
        for name, p in m.named_parameters():
            out[prefix + name] = p
    return out


def leaf_norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.detach().double().norm() for t in tensors])
