"""Faults planted in the timed path, to see `correct` come out false: each
takes the program's object (the pipeline of a generation cell, the trainer
of a fine-tuning cell) and breaks it in place. The tests run them at a
tiny size on the CPU; `benchmark/calibrate.py --fault` reads them on the
card at a cell's size."""
from __future__ import annotations

import torch


# --- generation: the pipeline ---------------------------------------------

def gen_step_unchanged(pipe):
    """Every sampler step returns its input: the model is called, x stays."""
    import dynamicrafter_tpu_torch.pipeline as pl

    def frozen(model_fn, x_T, schedule, table, settings, **kw):
        x = x_T.float()
        for idx in range(table.num_steps - 1, -1, -1):
            model_fn(x, int(table.timesteps[idx]))
        return x
    pl.ddim_sample = pl.unipc_sample = frozen


def gen_answer_altered(pipe):
    """Every UNet output 5 % off where it is produced (a DeepCache feature
    returned beside it is left as it is)."""
    pipe.unet.register_forward_hook(lambda module, args, out: (
        (out[0] * 1.05, *out[1:]) if isinstance(out, tuple) else out * 1.05))


def gen_frames_altered(pipe):
    """The decoded frames 0.05 off."""
    decode = pipe.vae.decode
    pipe.vae.decode = lambda z: decode(z) + 0.05


# --- fine-tuning: the trainer -----------------------------------------------

def train_step_unchanged(trainer):
    """The optimizer takes the gradients and changes nothing."""
    trainer.opt.update = lambda grads: None


def train_half_batch(trainer):
    """Half of the clip's frames left out of the gradient: the UNet's
    prediction for the second half is detached, the loss still their mean."""
    def hook(module, args, out):
        half = out.shape[1] // 2
        return torch.cat([out[:, :half], out[:, half:].detach()], dim=1)
    trainer.pipe.unet.register_forward_hook(hook)


def train_answer_altered(trainer):
    """Every UNet prediction 5 % off where it is produced."""
    trainer.pipe.unet.register_forward_hook(lambda module, args, out: out * 1.05)


def train_answer_altered_late(trainer, after: int = 3):
    """The UNet's prediction 5 % off from its (after + 1)-th call on: a path
    that changes once the warm-up's micro-steps are over."""
    calls = [0]

    def hook(module, args, out):
        calls[0] += 1
        return out * 1.05 if calls[0] > after else out
    trainer.pipe.unet.register_forward_hook(hook)


# a generation cell takes no mean over a batch, so has no half-batch fault
GENERATION = {"step_unchanged": gen_step_unchanged, "answer_altered": gen_answer_altered,
              "frames_altered": gen_frames_altered}
TRAINING = {"step_unchanged": train_step_unchanged, "half_batch": train_half_batch,
            "answer_altered": train_answer_altered,
            "answer_altered_late": train_answer_altered_late}
