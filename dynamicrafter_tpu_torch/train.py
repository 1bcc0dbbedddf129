"""Training CLI: fine-tune DynamiCrafter on one device.

The flag surface of the JAX package's `scripts/train.py` for one device
(reference main/trainer.py). It reads a reference-style training YAML
(`model:`, `data:`, `lightning:`): base_learning_rate and scale_lr,
accumulate_grad_batches, max_steps and gradient_clip_val, the checkpoint
interval and monitor. Run e.g.:

  python -m dynamicrafter_tpu_torch.train \\
      --config configs/training_512_v1.0.yaml --name run0 --logdir ./logs \\
      --synthetic_data --bf16 --device cuda

Writes `<logdir>/<name>/train.log`, `metrics.csv` and `checkpoints/`, and
with --sample_every sampled clips under `samples/`.
Without a pretrained checkpoint every weight is drawn from N(0, 0.02)
(`--seed`). SIGUSR1 writes a checkpoint at the end of the current
micro-step (reference trainer.py:129-143).
"""
from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Optional, Sequence

import numpy as np
import torch


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.train")
    p.add_argument("--config", "--base", "-b", dest="config", nargs="+", required=True,
                   help="YAML config(s), merged left to right")
    p.add_argument("--name", type=str, default="run")
    p.add_argument("--logdir", type=str, default="./logs")
    p.add_argument("--pretrained", type=str, default=None,
                   help="released .ckpt to fine-tune from")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume step, weights, optimizer and EMA from the latest checkpoint")
    p.add_argument("--auto_resume_weight_only", action="store_true",
                   help="resume weights and EMA only: fresh optimizer and step")
    p.add_argument("--max_steps", type=int, default=None, help="micro-steps to run")
    p.add_argument("--bs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=20230211)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 frozen towers and bf16 autocast; trainable weights stay fp32")
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--sample_every", type=int, default=0,
                   help="sample clips from the training batch every N micro-steps "
                        "(0: never); the sampler's settings come from the config's "
                        "lightning.callbacks.batch_logger.params.log_images_kwargs")
    p.add_argument("--val_every", type=int, default=0,
                   help="validation loss (with and without EMA) every N micro-steps")
    p.add_argument("--vocab_path", type=str, default=None,
                   help="path to bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _build_dataset(split: dict, args, temporal_length: int, log):
    from dynamicrafter_tpu_torch.data.webvid import SyntheticVideoDataset, WebVidDataset

    if args.synthetic_data or not split:
        log.info("using SyntheticVideoDataset")
        return SyntheticVideoDataset(video_length=split.get("video_length", temporal_length),
                                     resolution=tuple(split.get("resolution", (64, 64))))
    return WebVidDataset(
        meta_path=split["meta_path"], data_dir=split["data_dir"],
        video_length=split.get("video_length", 16),
        frame_stride=split.get("frame_stride", 4),
        resolution=tuple(split.get("resolution", (320, 512))),
        random_fs=split.get("random_fs", False), fixed_fps=split.get("fixed_fps"),
        fps_max=split.get("fps_max"))


def _to_device(batch: dict, device: torch.device) -> dict:
    return {"video": torch.as_tensor(batch["video"], device=device),
            "tokens": torch.as_tensor(np.asarray(batch["tokens"]), dtype=torch.long,
                                      device=device),
            "fs": torch.as_tensor(batch["fs"], device=device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns {"trainer", "workdir", "metrics" (one dict of floats
    per micro-step), "step_seconds" (host wall time of each micro-step,
    synchronised on the device)} for callers that drive it in-process."""
    args = get_parser().parse_args(argv)
    from dynamicrafter_tpu_torch.data.webvid import DataLoader
    from dynamicrafter_tpu_torch.config import TrainingConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    from dynamicrafter_tpu_torch.training.checkpoints import CheckpointManager
    from dynamicrafter_tpu_torch.training.logging import (
        MetricLogger, SampleLogger, device_memory_stats, setup_logger)
    from dynamicrafter_tpu_torch.training.trainer import TrainConfig, Trainer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available")
    tc = TrainingConfig.from_yaml(args.config)
    mc = tc.model
    workdir = os.path.join(args.logdir, args.name)
    log = setup_logger(workdir)

    bs = args.bs or tc.batch_size
    lr = (args.lr or tc.base_learning_rate) * (bs if tc.scale_lr else 1)
    max_steps = args.max_steps or tc.max_steps
    cfg = TrainConfig(
        learning_rate=lr, grad_clip=tc.gradient_clip_val,
        accumulate_grad_batches=tc.accumulate_grad_batches,
        use_ema=mc.params.get("use_ema", False), uncond_prob=mc.uncond_prob,
        rand_cond_frame=mc.rand_cond_frame, interp_mode=mc.interp_mode,
        loss_type=mc.loss_type, parameterization=mc.parameterization,
        noise_strength=mc.params.get("noise_strength", 0.0),
        l_simple_weight=mc.params.get("l_simple_weight", 1.0),
        original_elbo_weight=mc.params.get("original_elbo_weight", 0.0),
        learn_logvar=mc.params.get("learn_logvar", False),
        logvar_init=mc.params.get("logvar_init", 0.0), bf16=args.bf16)
    log.info(f"device={device} lr={lr} bs={bs} accum={cfg.accumulate_grad_batches} "
             f"max_steps={max_steps} bf16={args.bf16}")

    train_resampler = bool(mc.params.get("image_proj_model_trainable", True))
    pipe = DynamiCrafterPipeline.for_training(
        mc, device, frozen_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        train_resampler=train_resampler, vocab_path=args.vocab_path)
    tokenizer = pipe.tokenizer
    pretrained = args.pretrained
    if pretrained is None and mc.pretrained_checkpoint:
        if os.path.exists(mc.pretrained_checkpoint):
            pretrained = mc.pretrained_checkpoint
        else:
            log.info(f"pretrained_checkpoint {mc.pretrained_checkpoint!r} not found")
    if pretrained:
        pipe.load_checkpoint(pretrained)
        log.info(f"loaded pretrained checkpoint {pretrained}")
    else:
        pipe.init_random(seed=args.seed)
        log.info("WARNING: random-init weights N(0, 0.02) (no pretrained checkpoint)")

    trainer = Trainer(pipe, cfg, train_resampler=train_resampler, seed=args.seed)
    ckpt = tc.checkpoint
    ckpt_every = ckpt.get("every_n_train_steps", 9000)
    monitor = mc.params.get("monitor")
    mngr = CheckpointManager(os.path.join(workdir, "checkpoints"), max_to_keep=3,
                             monitor=monitor, top_k=ckpt.get("save_top_k", 3),
                             mode=ckpt.get("mode", "min"))
    if args.auto_resume or args.auto_resume_weight_only:
        state = mngr.restore()
        if state is not None:
            trainer.load_state_dict(state, weights_only=not args.auto_resume)
            log.info(f"resumed from step {state['step']}"
                     + (" (weights only)" if not args.auto_resume else ""))

    # the batch key feeding the UNet's fps embedding (ddpm3d.py:1118-1121)
    fs_key = "fps" if mc.fps_condition_type == "fps" else "frame_stride"
    t_len = pipe.unet_config.temporal_length or 16
    loader = DataLoader(_build_dataset(tc.train_data, args, t_len, log), batch_size=bs,
                        tokenizer=tokenizer, seed=args.seed, num_workers=tc.num_workers,
                        fs_key=fs_key)
    val_iter = None
    if args.val_every:
        val_data = _build_dataset(tc.validation_data or tc.train_data, args, t_len, log)
        val_iter = iter(DataLoader(val_data, batch_size=bs, tokenizer=tokenizer,
                                   shuffle=False, seed=args.seed + 1,
                                   num_workers=tc.num_workers, fs_key=fs_key))

    metrics_log = MetricLogger(workdir)
    sample_logger = None
    if args.sample_every > 0:
        sample_logger = SampleLogger(
            pipe, workdir, every_n_steps=args.sample_every,
            sample_kwargs=tc.batch_logger.get("log_images_kwargs"),
            autocast=torch.bfloat16 if args.bf16 else None)
    want_ckpt = {"now": False}
    signal.signal(signal.SIGUSR1, lambda *_: want_ckpt.update(now=True))
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    history, step_seconds, last_val = [], [], {}
    for batch in loader:
        if trainer.step >= max_steps:
            break
        t0 = time.perf_counter()
        m = trainer.train_step(_to_device(batch, device))
        vals = {k: float(v) for k, v in m.items()}
        sync()
        step_seconds.append(time.perf_counter() - t0)
        history.append(vals)
        step = trainer.step
        if val_iter is not None and step % args.val_every == 0:
            last_val = {k: float(v) for k, v in
                        trainer.eval_step(_to_device(next(val_iter), device)).items()}
            metrics_log.log(step, last_val)
            log.info(f"step {step} val: " + " ".join(f"{k}={v:.4g}" for k, v in last_val.items()))
        if step % args.log_every == 0:
            vals = dict(vals, s_per_step=step_seconds[-1], **device_memory_stats())
            metrics_log.log(step, vals)
            log.info(f"step {step}: " + " ".join(f"{k}={v:.4g}" for k, v in vals.items()))
        if sample_logger is not None:
            sample_logger.maybe_log(step, batch)
        if step % ckpt_every == 0 or want_ckpt["now"]:
            mngr.save(step, trainer.state_dict(), metrics=last_val)
            want_ckpt["now"] = False
            log.info(f"checkpoint at step {step}")
    if mngr.latest_step() != trainer.step:
        mngr.save(trainer.step, trainer.state_dict(), metrics=last_val)
    log.info(f"done at step {trainer.step}")
    return {"trainer": trainer, "workdir": workdir, "metrics": history,
            "step_seconds": step_seconds, "checkpoints": mngr}


if __name__ == "__main__":
    main()
