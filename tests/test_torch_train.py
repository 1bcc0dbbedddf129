"""The training slice of the PyTorch package against the JAX package, at
TINY_MODEL_CONFIG size, fp32 on the CPU.

Both packages get the same weights (one random Flax param tree exported to
reference keys) and the same random numbers: the JAX side draws them with
the key splits of `dynamicrafter_tpu/training/trainer.py` (:149-176 and
:223-239) and the port receives them through `Draws`. The JAX loss is
built from the module-level functions (no remat, the frozen towers outside
the jitted function), so it compiles in seconds. Tolerances: batch input
and loss to 1e-5 relative, gradients relative L2 <= 1e-4 per tensor (fp32,
summation order), the optimizer to 1e-6 against optax.
"""
import copy
import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import yaml  # noqa: E402

from dynamicrafter_tpu import schedule as jsched  # noqa: E402
from dynamicrafter_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dynamicrafter_tpu.models.clip import clip_preprocess as j_clip_preprocess  # noqa: E402
from dynamicrafter_tpu.pipeline import DynamiCrafterPipeline as JPipeline  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu.training import trainer as jtrainer  # noqa: E402
from dynamicrafter_tpu.training.ema import ema_update as j_ema_update  # noqa: E402
from dynamicrafter_tpu.utils.export import export_state_dict  # noqa: E402
from dynamicrafter_tpu_torch import schedule as tsched  # noqa: E402
from dynamicrafter_tpu_torch import train  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.models import unet3d  # noqa: E402
from dynamicrafter_tpu_torch.models.blocks import SpatialTransformer  # noqa: E402
from dynamicrafter_tpu_torch.ops import attention  # noqa: E402
from dynamicrafter_tpu_torch.ops import flash_attention as tflash  # noqa: E402
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.training import trainer as ttrainer  # noqa: E402
from dynamicrafter_tpu_torch.training.checkpoints import (  # noqa: E402
    CheckpointManager, load_trained_weights,
)
from test_torch_modules import random_params, rel_l2  # noqa: E402

B, T, HW, LAT = 2, 4, 16, 8     # clips, frames, frame size, latent size


@pytest.fixture(scope="module")
def pipes():
    return build_pipes()


def build_pipes():
    """The JAX pipeline with random params, and the port's training
    construction (fp32 throughout) loaded from them."""
    jp = JPipeline(JModelConfig(TINY_MODEL_CONFIG))
    u = jp.unet_config
    params = {
        "unet": random_params(
            jp.unet, np.zeros((1, T, LAT, LAT, u.in_channels), np.float32),
            np.zeros((1,), np.int32), context_text=np.zeros((1, 77, 48), np.float32),
            context_img=np.zeros((1, T, 4, 48), np.float32),
            fs=np.zeros((1,), np.int32), seed=11),
        "vae": random_params(jp.vae, np.zeros((1, HW, HW, 3), np.float32), seed=12),
        "clip_text": random_params(jp.text_encoder, np.zeros((1, 77), np.int32), seed=13),
        "clip_vision": random_params(jp.vision_encoder,
                                     np.zeros((1, 32, 32, 3), np.float32), seed=14),
        "resampler": random_params(jp.resampler, np.zeros((1, 17, 40), np.float32), seed=15),
    }
    jp.params = params
    tp = DynamiCrafterPipeline.for_training(ModelConfig(TINY_MODEL_CONFIG), "cpu",
                                            frozen_dtype=torch.float32)
    tp.load_state_dict(export_state_dict(params, unet_config=u))
    return jp, tp


def _batch(jp, seed=0):
    rng = np.random.default_rng(seed)
    return {"video": rng.uniform(-1, 1, (B, T, HW, HW, 3)).astype(np.float32),
            "tokens": np.asarray(jp.tokenizer(["a cat", "a dog"])),
            "fs": np.array([3, 5], np.int32)}


def _torch_batch(batch):
    return {"video": torch.from_numpy(batch["video"]),
            "tokens": torch.from_numpy(batch["tokens"].astype(np.int64)),
            "fs": torch.from_numpy(batch["fs"].astype(np.int64))}


def _jax_draws(seed, jp, cfg):
    """The JAX train step's random numbers for key PRNGKey(seed) (or for
    `seed` itself when it is a key), drawn by repeating its key splits;
    returns (JAX batch key, port Draws)."""
    key = jax.random.PRNGKey(seed) if isinstance(seed, int) else seed
    r_batch, r_t, r_noise = jax.random.split(key, 3)
    r_drop, r_frame, r_enc = jax.random.split(r_batch, 3)
    lat = (B, T, LAT, LAT, 4)
    enc = jax.random.normal(r_enc, (B * T, *lat[2:]))
    uniform = jax.random.uniform(r_drop, (B,))
    cond_idx = (jax.random.randint(r_frame, (), 0, jp.unet_config.temporal_length)
                if cfg.rand_cond_frame else jnp.asarray(0))
    t = jax.random.randint(r_t, (B,), 0, jp.schedule.num_timesteps)
    noise = jax.random.normal(r_noise, lat)
    offset = jax.random.normal(jax.random.fold_in(r_noise, 1), (B, T, 1, 1, 4))
    tt = lambda x: torch.from_numpy(np.array(x))
    return r_batch, ttrainer.Draws(
        t=tt(t).long(), noise=tt(noise), enc_noise=tt(enc), uniform=tt(uniform),
        cond_idx=tt(cond_idx).long().reshape(1), offset=tt(offset))


def _split(params):
    frozen = {k: params[k] for k in ("vae", "clip_text", "clip_vision")}
    return frozen, {k: params[k] for k in ("unet", "resampler")}


@pytest.mark.parametrize("interp", [False, True])
def test_batch_input_matches_jax(pipes, interp):
    """VAE posterior sample, CFG dropout (seed 2 drops the image of clip 0
    and the text of clip 1 at uncond_prob 0.3), the random conditioning
    frame, CLIP towers and Resampler, and the hybrid or interp concat."""
    jp, tp = pipes
    kw = dict(uncond_prob=0.3, rand_cond_frame=True, interp_mode=interp)
    jcfg, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    batch = _batch(jp)
    r_batch, draws = _jax_draws(2, jp, jcfg)
    u = draws.uniform.numpy()
    assert u[0] >= 0.6 and 0.3 <= u[0] < 0.9 and u[1] < 0.3, u   # the branches above
    ref = jax.jit(jtrainer.make_batch_input(jp, jcfg))(*_split(jp.params), batch, r_batch)
    with torch.no_grad():
        got = ttrainer.make_batch_input(tp, tcfg)(_torch_batch(batch), draws)
    for name, a, r in zip(("z", "text_ctx", "img_ctx", "cc"), got, ref):
        assert a.shape == r.shape, name
        assert rel_l2(a.numpy(), r) <= 1e-5, (name, rel_l2(a.numpy(), r))


def test_loss_and_gradients_match_jax(pipes):
    """Loss and the gradient of every UNet and Resampler tensor against
    jax.value_and_grad of the same loss: v target, zero-terminal SNR,
    dynamic rescale, offset noise, the hybrid concat."""
    jp, tp = pipes
    kw = dict(uncond_prob=0.3, rand_cond_frame=True, noise_strength=0.1)
    jcfg, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    batch = _batch(jp, seed=1)
    r_batch, draws = _jax_draws(16, jp, jcfg)
    frozen, trainable = _split(jp.params)
    z, text_ctx, _, cc = jax.jit(jtrainer.make_batch_input(jp, jcfg))(
        frozen, trainable, batch, r_batch)
    # the vision tokens, as make_batch_input computes them
    u = jnp.asarray(draws.uniform.numpy())
    input_mask = 1.0 - ((u >= 0.3) & (u < 0.9)).astype(jnp.float32)[:, None, None, None]
    img = jnp.take(jnp.asarray(batch["video"]), int(draws.cond_idx), axis=1) * input_mask
    tokens = jp.vision_encoder.apply({"params": frozen["clip_vision"]},
                                     j_clip_preprocess(img, 32))
    sched = jp.schedule

    def loss_fn(tr, t, noise, offset):
        img_ctx = jp.resampler.apply({"params": tr["resampler"]}, tokens)
        img_ctx = img_ctx.reshape(B, T, -1, img_ctx.shape[-1])
        zs = z * jsched.extract_into_tensor(sched.scale_arr, t, z.ndim)
        noise = noise + jcfg.noise_strength * offset
        x_noisy = sched.q_sample(zs, t, noise)
        target = sched.get_v(zs, noise, t)
        pred = jp.unet.apply({"params": tr["unet"]}, jnp.concatenate([x_noisy, cc], -1), t,
                             context_text=text_ctx, context_img=img_ctx,
                             fs=jnp.asarray(batch["fs"]))
        loss_simple = jnp.square(pred - target).mean(axis=(1, 2, 3, 4))
        return jtrainer.combine_diffusion_losses(loss_simple, t, jcfg, sched)

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, *(jnp.asarray(x.numpy()) for x in (draws.t, draws.noise, draws.offset)))
    ref = export_state_dict(j_grads, unet_config=jp.unet_config)

    trainer = ttrainer.Trainer(tp, tcfg)
    loss, _, grads = trainer.loss_and_grads(_torch_batch(batch), draws)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert set(trainer.params) <= set(ref)
    # a tensor whose gradient is zero in exact arithmetic (a conv bias ahead
    # of a GroupNorm of one channel per group) holds only rounding noise on
    # both sides: below 1e-6 of the total norm, it is held to an absolute
    # bound of 1e-7 of the total norm (fp32 rounding) instead
    total = np.sqrt(sum(float(np.sum(np.square(ref[k]))) for k in trainer.params))
    checked = 0
    for (name, _), g in zip(trainer.params.items(), grads):
        r = np.asarray(ref[name], np.float64)
        diff = np.linalg.norm(g.numpy() - r)
        if np.linalg.norm(r) < 1e-6 * total:
            assert diff <= 1e-7 * total, name
            continue
        checked += 1
        assert diff <= 1e-4 * np.linalg.norm(r), (name, diff / np.linalg.norm(r))
    assert checked >= 0.9 * len(grads)


@pytest.mark.parametrize("learn,elbo,lsw,lv_init,loss_type", [
    (True, 0.37, 0.9, 0.0, "l2"), (False, 0.41, 1.0, 0.3, "l2"), (True, 0.2, 1.0, 0.1, "l1")])
def test_loss_knobs_match_jax(learn, elbo, lsw, lv_init, loss_type):
    """`combine_diffusion_losses` and l1/l2 at nonzero ELBO weight, with a
    learned logvar table (and its gradient) or a constant one, around a
    stand-in model pred = 0.1 * x_noisy."""
    kw = dict(parameterization="v", learn_logvar=learn, original_elbo_weight=elbo,
              l_simple_weight=lsw, logvar_init=lv_init, loss_type=loss_type)
    jcfg, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    skw = dict(timesteps=24, linear_start=0.00085, linear_end=0.012, parameterization="v")
    js, ts = jsched.build_schedule(**skw), tsched.build_schedule(**skw)
    rng = np.random.default_rng(3)
    z, noise = (rng.standard_normal((3, 4, 5, 6, 4)).astype(np.float32) for _ in range(2))
    t = np.array([1, 7, 23])
    table = (0.2 * rng.standard_normal(24)).astype(np.float32)

    def j_loss(lv):
        x_noisy = js.q_sample(jnp.asarray(z), jnp.asarray(t), jnp.asarray(noise))
        err = 0.1 * x_noisy - js.get_v(jnp.asarray(z), jnp.asarray(noise), jnp.asarray(t))
        simple = (jnp.abs(err) if loss_type == "l1" else jnp.square(err)).mean(axis=(1, 2, 3, 4))
        return jtrainer.combine_diffusion_losses(simple, jnp.asarray(t), jcfg, js,
                                                 lv if learn else None)

    (ref, ref_m), ref_g = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(table))
    lv = torch.from_numpy(table).requires_grad_()
    tt = torch.from_numpy(t)
    x_noisy = ts.q_sample(torch.from_numpy(z), tt, torch.from_numpy(noise))
    err = 0.1 * x_noisy - ts.get_v(torch.from_numpy(z), torch.from_numpy(noise), tt)
    simple = (err.abs() if loss_type == "l1" else err.square()).mean(dim=(1, 2, 3, 4))
    loss, m = ttrainer.combine_diffusion_losses(simple, tt, tcfg, ts, lv if learn else None)
    assert set(m) == set(ref_m)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(ref_m[k]), rtol=2e-6, err_msg=k)
    if learn:
        loss.backward()
        np.testing.assert_allclose(lv.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_matches_optax(weight_decay):
    """Clip by global norm 0.5, AdamW and accumulation over k = 2
    (optax.MultiSteps), and the EMA after every micro-step, for 4
    micro-steps; the gradients of steps 0-1 exceed the clip, those of
    steps 2-3 do not."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    params0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    scales = [1.0, 2.0, 0.01, 0.02]
    grads = [{k: (sc * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    lr, decay = 1e-2, 0.9
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(0.5),
                                      optax.adamw(lr, weight_decay=weight_decay)), 2)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    jstate, jema = tx.init(jp), dict(jp)
    tparams = {k: torch.tensor(v) for k, v in params0.items()}
    opt = ttrainer.AccumulatingAdamW(tparams, ttrainer.TrainConfig(
        learning_rate=lr, weight_decay=weight_decay, grad_clip=0.5,
        accumulate_grad_batches=2, use_ema=True, ema_decay=decay))
    for step, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        jema = j_ema_update(jema, jp, jnp.asarray(step, jnp.int32), decay)
        opt.update([torch.tensor(g[k]) for k in tparams])
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"params {k} step {step}")
            np.testing.assert_allclose(opt.ema[k].numpy(), np.asarray(jema[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"ema {k} step {step}")
        moved = not np.array_equal(tparams["a"].numpy(), params0["a"])
        assert moved == (step >= 1)    # the first update comes at micro-step 2
    assert opt.step == 4 and opt.mini_step == 0


def test_flash_residuals_saved_across_checkpoint():
    """On a checkpointed SpatialTransformer at L = 2048, the flash forward
    runs once per forward and backward pass: the policy keeps (o, lse)
    across the boundary. A checkpoint without the policy runs it twice.
    Gradients are those of the layer without checkpointing."""
    calls = []
    real = tflash.flash_fwd_lse

    def counting(*a):
        calls.append(1)
        return real(*a)

    torch.manual_seed(0)
    layer = SpatialTransformer(64, 1, 64, context_dim=16)
    x = torch.randn(2, 64, 32, 64, requires_grad=True)
    ctx = (torch.randn(1, 5, 16), None)
    runs = {"policy": lambda: unet3d.checkpointed(layer, x, ctx, 2),
            "no policy": lambda: torch.utils.checkpoint.checkpoint(
                layer, x, ctx, 2, use_reentrant=False),
            "none": lambda: layer(x, ctx, 2)}
    seen, grads = {}, {}
    tflash.flash_fwd_lse = counting
    try:
        for name, run in runs.items():
            calls.clear()
            grads[name] = torch.autograd.grad(run().square().mean(),
                                              [x, *layer.parameters()])
            seen[name] = len(calls)
    finally:
        tflash.flash_fwd_lse = real
    assert seen == {"policy": 1, "no policy": 2, "none": 1}
    for a, b in zip(grads["policy"], grads["none"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_backend_reaches_recomputation_on_another_thread():
    """`use_backend("plain")` holds for a checkpointed layer recomputed on
    another thread, as autograd's CUDA device thread recomputes it on the
    card: the recomputation takes the same (plain) path as the forward, so
    the saved tensors match and no flash op runs."""
    import threading

    calls = []
    real = tflash.flash_fwd_lse
    torch.manual_seed(0)
    layer = SpatialTransformer(64, 1, 64, context_dim=16)
    x = torch.randn(2, 64, 32, 64, requires_grad=True)
    ctx = (torch.randn(1, 5, 16), None)
    done = []

    def backward():
        loss.backward()     # raises CheckpointError if the paths differ
        done.append(True)

    tflash.flash_fwd_lse = lambda *a: calls.append(1) or real(*a)
    try:
        with attention.use_backend("plain"):
            loss = unet3d.checkpointed(layer, x, ctx, 2).square().mean()
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
    finally:
        tflash.flash_fwd_lse = real
    assert done == [True] and calls == [] and x.grad is not None


def test_unet_checkpoints_each_layer_only_under_grad(pipes, monkeypatch):
    """use_checkpoint: one segment per ResBlock, SpatialTransformer,
    TemporalTransformer and init_attn while gradients are recorded, none
    without; the gradients do not change."""
    _, tp = pipes
    unet = tp.unet
    calls = []
    real = unet3d.checkpointed
    monkeypatch.setattr(unet3d, "checkpointed", lambda layer, *a: calls.append(
        type(layer).__name__) or real(layer, *a))
    rng = np.random.default_rng(7)
    args = (torch.from_numpy(rng.standard_normal((1, T, LAT, LAT, 8)).astype(np.float32)),
            torch.tensor([500]))
    kw = dict(context_text=torch.randn(1, 77, 48), context_img=torch.randn(1, T, 4, 48),
              fs=torch.tensor([3]))
    out = {}
    for on in (True, False):
        monkeypatch.setattr(unet, "config", unet.config.__class__(
            **{**vars(unet.config), "use_checkpoint": on}))
        unet.zero_grad(set_to_none=True)
        unet(*args, **kw).square().mean().backward()
        out[on] = [p.grad.clone() for p in unet.parameters()]
    n_layers = sum(isinstance(m, (unet3d.ResBlock, unet3d.SpatialTransformer,
                                  unet3d.TemporalTransformer)) for m in unet.modules())
    assert len(calls) == n_layers and "TemporalTransformer" in calls
    calls.clear()
    monkeypatch.setattr(unet, "config", unet.config.__class__(
        **{**vars(unet.config), "use_checkpoint": True}))
    with torch.no_grad():
        unet(*args, **kw)
    assert calls == []
    unet.zero_grad(set_to_none=True)
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_checkpoint_manager_retention(tmp_path):
    m = CheckpointManager(str(tmp_path / "a"), max_to_keep=2)
    for s in (1, 2, 3):
        m.save(s, {"step": s})
    assert m.all_steps() == [2, 3] and m.restore()["step"] == 3
    assert m.restore(2)["step"] == 2
    best = CheckpointManager(str(tmp_path / "b"), monitor="val/loss", top_k=2, mode="min")
    for s, v in ((1, 0.5), (2, 0.2), (3, 0.9), (4, 0.3)):
        best.save(s, {"step": s}, metrics={"val/loss": v})
    assert best.all_steps() == [2, 4]
    assert CheckpointManager(str(tmp_path / "c")).restore() is None


def test_checkpoint_written_without_crc32(tmp_path):
    """A checkpoint's records carry no CRC32 and `restore` reads them back
    exactly; the process's own `torch.save` settings are left as they were."""
    import zipfile

    from torch.utils.serialization import config

    before = config.save.compute_crc32, config.save.use_pinned_memory_for_d2h
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    state = {"step": 3, "weights": {"w": w}}
    m = CheckpointManager(str(tmp_path))
    path = m.save(3, state)
    assert (config.save.compute_crc32, config.save.use_pinned_memory_for_d2h) == before
    with zipfile.ZipFile(path) as z:
        data = [i for i in z.infolist() if i.filename.split("/")[-2] == "data"]
    assert data and all(i.CRC == 0 for i in data)
    back = m.restore()
    assert back["step"] == 3 and torch.equal(back["weights"]["w"], w)
    torch.save(state, tmp_path / "default.pt")
    with zipfile.ZipFile(tmp_path / "default.pt") as z:
        assert any(i.CRC != 0 for i in z.infolist() if i.filename.split("/")[-2] == "data")


def _tiny_train_yaml(tmp_path):
    cfg = copy.deepcopy(TINY_MODEL_CONFIG)
    p = cfg["model"]["params"]
    p["unet_config"]["params"]["use_checkpoint"] = True
    p.update(rand_cond_frame=True, use_ema=True)
    cfg["data"] = {"params": {"batch_size": 2, "num_workers": 2, "train": {
        "params": {"video_length": T, "resolution": [HW, HW]}}}}
    cfg["lightning"] = {"trainer": {"accumulate_grad_batches": 2, "max_steps": 100,
                                    "gradient_clip_val": 0.5},
                        "callbacks": {"model_checkpoint": {"params": {
                            "every_n_train_steps": 100}}}}
    path = tmp_path / "tiny_train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_sigusr1_writes_a_checkpoint(tmp_path, monkeypatch):
    """SIGUSR1 during a run checkpoints at the end of that micro-step
    (reference trainer.py:129-143)."""
    import signal

    real = ttrainer.Trainer.train_step

    def step_then_signal(self, *a, **k):
        out = real(self, *a, **k)
        if self.step == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    monkeypatch.setattr(ttrainer.Trainer, "train_step", step_then_signal)
    previous = signal.getsignal(signal.SIGUSR1)
    try:
        result = train.main(["--config", _tiny_train_yaml(tmp_path), "--logdir",
                             str(tmp_path / "logs"), "--synthetic_data", "--max_steps", "3",
                             "--device", "cpu"])
    finally:
        signal.signal(signal.SIGUSR1, previous)
    assert result["checkpoints"].all_steps() == [1, 3]


def test_train_cli_end_to_end(tmp_path):
    """`python -m dynamicrafter_tpu_torch.train` at tiny size on the CPU
    with synthetic clips: 2 micro-steps write metrics.csv and a checkpoint,
    --auto_resume continues from it, --auto_resume_weight_only restarts
    the step, and the inference pipeline loads the trained weights."""
    cfg = _tiny_train_yaml(tmp_path)
    common = ["--config", cfg, "--logdir", str(tmp_path / "logs"), "--name", "run",
              "--synthetic_data", "--log_every", "1", "--val_every", "2", "--device", "cpu"]
    first = train.main([*common, "--max_steps", "2"])
    workdir = first["workdir"]
    with open(os.path.join(workdir, "metrics.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0].startswith("step,") and "grad_norm" in rows[0] and "val/loss_ema" in rows[0]
    assert len(rows) == 1 + 3          # two training rows and one validation row
    assert first["checkpoints"].all_steps() == [2]
    assert all(np.isfinite(v) for m in first["metrics"] for v in m.values())
    assert first["metrics"][0]["grad_norm"] > 0
    trained = {k: p.detach().clone() for k, p in first["trainer"].params.items()}

    resumed = train.main([*common, "--max_steps", "4", "--auto_resume"])
    assert len(resumed["metrics"]) == 2 and resumed["trainer"].step == 4
    assert resumed["checkpoints"].all_steps() == [2, 4]
    restarted = train.main([*common, "--max_steps", "1", "--auto_resume_weight_only"])
    assert restarted["trainer"].step == 1 and len(restarted["metrics"]) == 1

    state = CheckpointManager(os.path.join(workdir, "checkpoints")).restore(2)
    pipe = DynamiCrafterPipeline(ModelConfig.from_yaml(cfg), "cpu")
    pipe.init_random(seed=0)
    load_trained_weights(pipe, state)
    own = pipe.net.state_dict()
    for k, v in trained.items():
        torch.testing.assert_close(own[k], v, rtol=0, atol=0)
    ema = state["ema"]
    assert set(ema) == set(trained) and any(not torch.equal(ema[k], v)
                                            for k, v in trained.items())


def test_auto_resume_continues_the_uninterrupted_run(tmp_path):
    """Two micro-steps, then --auto_resume to four, end where four
    micro-steps without a stop end: the same losses, validation losses,
    weights, EMA and AdamW moments, bit for bit. The resumed run takes the
    batches the first one had not reached (`DataLoader(skip_batches=)`); the
    draws follow the step. JAX's `scripts/train.py` restarts its loader at
    the first batch on a resume, so it is no oracle for this."""
    cfg = _tiny_train_yaml(tmp_path)
    common = ["--config", cfg, "--logdir", str(tmp_path / "logs"), "--synthetic_data",
              "--log_every", "1", "--val_every", "2", "--device", "cpu"]
    whole = train.main([*common, "--name", "whole", "--max_steps", "4"])
    first = train.main([*common, "--name", "cut", "--max_steps", "2"])
    rest = train.main([*common, "--name", "cut", "--max_steps", "4", "--auto_resume"])
    assert rest["trainer"].step == 4 and rest["checkpoints"].all_steps() == [2, 4]
    assert first["metrics"] + rest["metrics"] == whole["metrics"]
    def val(result):
        with open(os.path.join(result["workdir"], "metrics.csv")) as f:
            return [{k: v for k, v in row.items() if k.startswith("val/")}
                    for row in csv.DictReader(f) if row["step"] == "4" and row["val/loss"]]

    assert len(val(whole)) == 1 and val(rest) == val(whole)
    a, b = (r["checkpoints"].restore(4) for r in (whole, rest))
    for key in ("weights", "ema"):
        for k, v in a[key].items():
            torch.testing.assert_close(b[key][k], v, rtol=0, atol=0)
    for i, s in a["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(b["optimizer"]["state"][i][name], s[name], rtol=0, atol=0)
