"""DeepCache quality: PSNR / SSIM of DDIM with `deepcache=N` against the
exact sampler (`deepcache=1`), on one GPU.

    python -m dynamicrafter_tpu_torch.deepcache_certify --resolutions 512 \
        --intervals 2,3,4,5 --cfg_passes 2,3

The counterpart of the JAX package's `scripts/deepcache_certify.py`.
DeepCache (Ma et al., CVPR'24) reuses the UNet's deep feature over N - 1 of
every N DDIM steps; it is an opt-in approximation with no reference
counterpart, so its quality is measured here: for each interval N, DDIM
with identical noise and conditioning under `deepcache=N` and under
`deepcache=1`, scored by final-latent PSNR and by decoded-pixel PSNR and
SSIM through one decoder (the VAE's, frame by frame). N must divide the
step count, so an N that does not divide --steps runs at the largest
multiple of N below it against an exact baseline of as many steps (N = 3
and 4 at 48 when --steps is 50). N = 1 reproduces its baseline (infinite
PSNR, SSIM 1).

The shipped configs (`configs/inference_<res>_v1.0.yaml`) in bf16 with
their norms in fp32 (fp32 with `--device cpu`). Weights: N(0, 0.02), with
no zero-initialised layer (the port's smoke init), unless --ckpt_path
names a released checkpoint, which loads through the port's strict loader.
Random weights say nothing of quality on trained ones: a row is tagged
with the weights it ran on. x_T and the conditioning are drawn from seed
11 in the JAX script's shapes and scales (torch's generator, not JAX's). DDIM
eta 0, `uniform_trailing`, CFG 7.5 (image CFG 1.5 with 3 passes),
guidance rescale 0.7, as the JAX script. `run_config` takes `draws=` (x_T
and the conditioning) and `weights=` (a reference-keyed state dict) so
that a test can feed both packages the same arrays. Writes one JSON line a
row and, with --out, appends a markdown table. `--config` and
`--latent_hw` replace the shipped config and the latent size (a tiny model
on the CPU with `--device cpu`).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

# latent (h, w) of each shipped resolution
SHAPES = {"256": (32, 32), "512": (40, 64), "1024": (72, 128)}
# the draws' seed (the JAX scripts' PRNGKey(11)); the random weights take SEED + 1
SEED = 11
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    rng = float(b.max() - b.min())
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(rng ** 2 / mse)


def _ssim(a: np.ndarray, b: np.ndarray, win: int = 8) -> float:
    """Mean SSIM over frames with a uniform win x win window (standard
    K1/K2, data range from the exact output). Inputs (..., H, W, C)."""
    a = a.astype(np.float64).reshape((-1,) + a.shape[-3:])
    b = b.astype(np.float64).reshape((-1,) + b.shape[-3:])
    L = float(b.max() - b.min())
    c1, c2 = (0.01 * L) ** 2, (0.03 * L) ** 2

    def box(x):  # (N, H, W, C) -> windowed means via cumsum integral image
        for axis in (1, 2):
            c = np.cumsum(x, axis=axis)
            lead = np.take(c, range(win - 1, x.shape[axis]), axis=axis)
            lag = np.concatenate(
                [np.zeros_like(np.take(c, [0], axis=axis)),
                 np.take(c, range(0, x.shape[axis] - win), axis=axis)],
                axis=axis)
            x = (lead - lag) / win
        return x

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a ** 2
    var_b = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2) /
         ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(s.mean())


def build_models(mc, dtype: torch.dtype, device, weights: Optional[Mapping] = None):
    """The UNet and the VAE decoder of `mc` on `device` in `dtype` (norms in
    fp32). Weights from `weights`, a reference-keyed state dict (its
    `model.diffusion_model.` and `first_stage_model.decoder.` keys, strictly),
    else N(0, 0.02) from SEED + 1."""
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.models.vae import Decoder, VAEConfig
    from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32
    from dynamicrafter_tpu_torch.utils.weights import init_normal_, load_reference_state_dict

    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(mc.unet))
        decoder = Decoder(VAEConfig.from_dict(mc.vae))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    models = []
    for module, prefix in ((unet, "model.diffusion_model."),
                           (decoder, "first_stage_model.decoder.")):
        module = keep_norms_fp32(module.to_empty(device=device).to(dtype))
        module.eval().requires_grad_(False)
        if weights is None:
            init_normal_(module, gen, 0.02)
        else:
            load_reference_state_dict(module, {k[len(prefix):]: v for k, v in weights.items()
                                               if k.startswith(prefix)}, prefix=prefix)
        models.append(module)
    return tuple(models)


def conditioning(mc, h: int, w: int, passes: int, dtype: torch.dtype, device,
                 draws: Optional[Mapping[str, np.ndarray]] = None):
    """x_T (1, T, h, w, z) fp32 and the CFG conditioning of `passes` passes,
    in the JAX script's shapes and scales: from `draws` (numpy arrays under
    those names, as the JAX script draws them) or drawn from SEED."""
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig
    from dynamicrafter_tpu_torch.models.vae import VAEConfig
    from dynamicrafter_tpu_torch.sampling.ddim import CFGConditioning

    ucfg, zc = UNetConfig.from_dict(mc.unet), VAEConfig.from_dict(mc.vae).z_channels
    t_len, ctx = ucfg.temporal_length, ucfg.context_dim
    n_img = (mc.resampler or {}).get("num_queries", 16)
    shapes = {"x_T": ((1, t_len, h, w, zc), 1.0),
              "context_text": ((passes, 1, 77, ctx), 0.1),
              "context_img": ((passes, 1, t_len, n_img, ctx), 0.1),
              "concat": ((passes, 1, t_len, h, w, zc), 1.0)}
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(SEED)
        arrs = {k: (torch.randn(shape, generator=gen, device=device) * sc).to(dtype)
                for k, (shape, sc) in shapes.items()}
    else:
        arrs = {k: torch.as_tensor(np.array(draws[k]), device=device).to(dtype)
                for k in shapes}
        for k, (shape, _) in shapes.items():
            if tuple(arrs[k].shape) != shape:
                raise ValueError(f"draws[{k!r}]: shape {tuple(arrs[k].shape)} != {shape}")
    cond = CFGConditioning(context_text=arrs["context_text"], context_img=arrs["context_img"],
                           concat=arrs["concat"],
                           fs=torch.full((1,), 24, dtype=torch.long, device=device))
    return arrs["x_T"].float(), cond


def sampler_setup(mc, passes: int):
    """The schedule of `mc` and `settings(sampler, steps, **kw)` -> (table,
    SamplerSettings): every candidate's settings come from this one function,
    so that the CFG and schedule settings of the compared runs cannot drift
    apart."""
    from dynamicrafter_tpu_torch import schedule as sched_lib
    from dynamicrafter_tpu_torch.sampling.ddim import SamplerSettings

    schedule = sched_lib.build_schedule(
        timesteps=mc.timesteps, linear_start=mc.linear_start, linear_end=mc.linear_end,
        parameterization=mc.parameterization,
        rescale_betas_zero_snr=mc.rescale_betas_zero_snr,
        use_dynamic_rescale=mc.use_dynamic_rescale, base_scale=mc.base_scale)

    def settings(sampler: str, n_steps: int, **kw):
        table = sched_lib.build_ddim_table(schedule, num_steps=n_steps,
                                           discretize="uniform_trailing", eta=0.0)
        return table, SamplerSettings(
            steps=n_steps, discretize="uniform_trailing", eta=0.0, cfg_scale=7.5,
            cfg_img=1.5 if passes == 3 else None, guidance_rescale=0.7,
            parameterization=mc.parameterization, sampler=sampler, **kw)

    return schedule, settings


def decode_frames(decoder, z: torch.Tensor) -> np.ndarray:
    """Latents (1, T, h, w, z) -> frames (T, H, W, 3) fp32, one frame a
    decoder call (no scale factor, no post-quant conv: as the JAX script)."""
    with torch.no_grad():
        frames = [decoder(zf.to(decoder.conv_in.weight.dtype).permute(0, 3, 1, 2))
                  .permute(0, 2, 3, 1).float() for zf in z[0].split(1)]
    return torch.cat(frames).cpu().numpy()


def run_config(mc, h: int, w: int, steps: int, n_list: Sequence[int], passes: int,
               dtype: torch.dtype, weights: Optional[Mapping] = None,
               draws: Optional[Mapping[str, np.ndarray]] = None, device="cuda",
               models=None) -> list:
    """One row per N in `n_list` (the exact baseline is not a row), each N
    against the exact sampler at its step count. `models`, a (unet, decoder)
    pair from `build_models`, is reused across calls when given."""
    from dynamicrafter_tpu_torch.sampling.ddim import ddim_sample, make_cfg_denoiser

    device = torch.device(device)
    unet, decoder = models or build_models(mc, dtype, device, weights)
    x_T, cond = conditioning(mc, h, w, passes, dtype, device, draws)
    schedule, settings = sampler_setup(mc, passes)

    def sample(n_steps: int, dc: int):
        table, st = settings("ddim", n_steps, deepcache=dc)
        z = ddim_sample(make_cfg_denoiser(unet, cond, st), x_T, schedule, table, st)
        return z.float().cpu().numpy(), decode_frames(decoder, z)

    exact: Dict[int, tuple] = {}   # step count -> (latent, pixels)
    rows = []
    for n in n_list:
        n_steps = steps if steps % n == 0 else (steps // n) * n
        if n_steps not in exact:
            t0 = time.perf_counter()
            exact[n_steps] = sample(n_steps, 1)
            print(f"# exact baseline steps={n_steps} done in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        z, px = sample(n_steps, n)
        z_ref, px_ref = exact[n_steps]
        rows.append({
            "interval_N": n,
            "steps": n_steps,
            "cfg_passes": passes,
            "latent_psnr_db": round(_psnr(z, z_ref), 2),
            "pixel_psnr_db": round(_psnr(px, px_ref), 2),
            "pixel_ssim": round(_ssim(px, px_ref), 4),
            "seconds": round(time.perf_counter() - t0, 1),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def working_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_weights(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """A released checkpoint's state dict (any of the three formats)."""
    from dynamicrafter_tpu_torch.utils.weights import normalize_state_dict

    return normalize_state_dict(torch.load(ckpt_path, map_location="cpu", weights_only=True))


def add_common_args(p: argparse.ArgumentParser, cfg_passes: str) -> None:
    p.add_argument("--resolutions", default="256,512")
    p.add_argument("--cfg_passes", "--passes", default=cfg_passes,
                   help="comma list of CFG modes: 2 (text) and/or 3 (text + image)")
    p.add_argument("--ckpt_path", default=None,
                   help="released checkpoint of the model at --resolutions (one "
                        "resolution); random N(0, 0.02) weights without it")
    p.add_argument("--config", default=None,
                   help="model YAML in place of configs/inference_<res>_v1.0.yaml")
    p.add_argument("--latent_hw", default=None,
                   help="'h,w' latent size in place of the resolution's")
    p.add_argument("--device", default="cuda", help="bf16 on cuda, fp32 on cpu")
    p.add_argument("--out", default=None, help="append a markdown table to this file")


def setups(args):
    """(resolution, ModelConfig, (h, w), weights or None) for each of
    --resolutions; refuses a missing CUDA device."""
    from dynamicrafter_tpu_torch.config import ModelConfig

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available")
    resolutions = args.resolutions.split(",")
    if args.ckpt_path and len(resolutions) > 1:
        raise SystemExit("--ckpt_path is the checkpoint of one resolution")
    weights = load_weights(args.ckpt_path) if args.ckpt_path else None
    for res in resolutions:
        mc = ModelConfig.from_yaml(args.config or os.path.join(
            REPO, "configs", f"inference_{res}_v1.0.yaml"))
        hw = (tuple(int(x) for x in args.latent_hw.split(",")) if args.latent_hw
              else SHAPES[res])
        if weights is None:
            print(f"# resolution {res}: random N(0, 0.02) weights (no --ckpt_path)", flush=True)
        yield res, mc, hw, weights


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.deepcache_certify",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--intervals", default="2,3,4,5", help="comma list of N")
    p.add_argument("--steps", type=int, default=50)
    add_common_args(p, "2,3")
    args = p.parse_args(argv)
    n_list = [int(n) for n in args.intervals.split(",")]
    device = torch.device(args.device)
    dtype = working_dtype(device)
    all_rows = []
    for res, mc, (h, w), weights in setups(args):
        models = build_models(mc, dtype, device, weights)
        for passes in [int(x) for x in args.cfg_passes.split(",")]:
            print(f"# resolution {res}, {passes}-pass CFG", flush=True)
            rows = run_config(mc, h, w, args.steps, n_list, passes, dtype, device=device,
                              models=models)
            for r in rows:
                r["resolution"] = res
                r["weights"] = "released" if weights is not None else "random"
            all_rows.extend(rows)
        del models
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n## DeepCache quality vs exact sampler "
                    f"({'/'.join(sorted({r['weights'] for r in all_rows}))} {dtype} "
                    f"weights, {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})\n\n")
            f.write("| res | CFG | N | steps | latent PSNR dB | pixel PSNR dB | pixel SSIM |\n"
                    "|---|---|---|---|---|---|---|\n")
            for r in all_rows:
                f.write(f"| {r['resolution']} | {r['cfg_passes']}-pass | {r['interval_N']} | "
                        f"{r['steps']} | {r['latent_psnr_db']} | {r['pixel_psnr_db']} | "
                        f"{r['pixel_ssim']} |\n")
        print(f"appended table to {args.out}")
    return all_rows


if __name__ == "__main__":
    main()
