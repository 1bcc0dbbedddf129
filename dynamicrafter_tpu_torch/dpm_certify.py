"""DPM-Solver++(2M) quality against a fine-step reference trajectory, on one
GPU: is dpm@30 DDIM-50-class?

    python -m dynamicrafter_tpu_torch.dpm_certify --resolutions 512 \
        --candidates dpm:30,ddim:50,ddim:30 --ref_steps 120

The counterpart of the JAX package's `scripts/dpm_certify.py`: identical
noise and conditioning for every candidate, a reference trajectory of dpm
at --ref_steps (its O(1/S^2) error sits far below every candidate's), and
for each candidate the latent's relative L2 distance and PSNR against it,
and the decoded pixels' PSNR through one decoder (the VAE's, frame by
frame). The claim holds when err(dpm@30) <= err(ddim@50); ddim@30 shows
what 30 steps cost the first-order solver. A candidate at --ref_steps
reproduces the reference (relative L2 0, PSNR null): the run is
deterministic. Candidates are `sampler:steps` with sampler ddim, dpm or
unipc.

Weights, draws, sampler settings (eta 0, `uniform_trailing`, CFG 7.5,
rescale 0.7), `--config`, `--latent_hw` and `--device` as in
`deepcache_certify` (its docstring). 576x1024 (`--resolutions 1024`)
runs its CFG passes one UNet call each, as the inference CLI does at that
width. Writes one JSON line a candidate and, with --out, appends a
markdown table.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from dynamicrafter_tpu_torch.deepcache_certify import (
    _psnr, add_common_args, build_models, conditioning, decode_frames, sampler_setup, setups,
    working_dtype,
)


def _finite_psnr(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    """PSNR rounded to 0.01 dB; None for an exact match (JSON has no inf)."""
    v = _psnr(a, b)
    return round(v, 2) if np.isfinite(v) else None


def run_config(mc, h: int, w: int, candidates, ref_steps: int, passes: int,
               dtype: torch.dtype, weights: Optional[Mapping] = None,
               draws: Optional[Mapping[str, np.ndarray]] = None,
               sequential_cfg: bool = False, device="cuda", models=None) -> list:
    """Sample each (sampler, steps) candidate from identical noise and
    conditioning and score it against dpm@`ref_steps`. One row per
    candidate. `models` as in `deepcache_certify.run_config`."""
    from dynamicrafter_tpu_torch.sampling.ddim import ddim_sample, make_cfg_denoiser
    from dynamicrafter_tpu_torch.sampling.dpm import dpm_sample
    from dynamicrafter_tpu_torch.sampling.unipc import unipc_sample

    device = torch.device(device)
    unet, decoder = models or build_models(mc, dtype, device, weights)
    x_T, cond = conditioning(mc, h, w, passes, dtype, device, draws)
    schedule, settings = sampler_setup(mc, passes)
    loops = {"ddim": ddim_sample, "dpm": dpm_sample, "unipc": unipc_sample}

    def sample(sampler: str, n_steps: int):
        table, st = settings(sampler, n_steps, sequential_cfg=sequential_cfg)
        z = loops[sampler](make_cfg_denoiser(unet, cond, st), x_T, schedule, table, st)
        return z.float().cpu().numpy(), decode_frames(decoder, z)

    t0 = time.perf_counter()
    z_ref, px_ref = sample("dpm", ref_steps)
    print(f"# reference dpm@{ref_steps} done in {time.perf_counter() - t0:.1f}s", flush=True)
    ref_norm = float(np.linalg.norm(z_ref))
    rows = []
    for sampler, n_steps in candidates:
        t0 = time.perf_counter()
        z, px = sample(sampler, n_steps)
        rows.append({
            "sampler": sampler,
            "steps": n_steps,
            "cfg_passes": passes,
            "rel_l2_vs_ref": round(float(np.linalg.norm(z - z_ref)) / ref_norm, 5),
            "latent_psnr_db": _finite_psnr(z, z_ref),
            "pixel_psnr_db": _finite_psnr(px, px_ref),
            "seconds": round(time.perf_counter() - t0, 1),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(prog="python -m dynamicrafter_tpu_torch.dpm_certify",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--candidates", default="dpm:30,ddim:50,ddim:30",
                   help="comma list of sampler:steps")
    p.add_argument("--ref_steps", type=int, default=120)
    add_common_args(p, "2")
    args = p.parse_args(argv)
    candidates = [(s.split(":")[0], int(s.split(":")[1])) for s in args.candidates.split(",")]
    device = torch.device(args.device)
    dtype = working_dtype(device)
    all_rows = []
    for res, mc, (h, w), weights in setups(args):
        models = build_models(mc, dtype, device, weights)
        for passes in [int(x) for x in args.cfg_passes.split(",")]:
            print(f"# resolution {res}, {passes}-pass CFG", flush=True)
            rows = run_config(mc, h, w, candidates, args.ref_steps, passes, dtype,
                              sequential_cfg=res == "1024", device=device, models=models)
            for r in rows:
                r["resolution"] = res
                r["weights"] = "released" if weights is not None else "random"
            all_rows.extend(rows)
        del models
    if args.out:
        with open(args.out, "a") as f:
            f.write(f"\n## DPM-Solver++ quality vs fine-step trajectory (ref dpm@{args.ref_steps}; "
                    f"{'/'.join(sorted({r['weights'] for r in all_rows}))} {dtype} weights, "
                    f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})\n\n")
            f.write("| res | CFG | sampler | steps | rel L2 vs ref | latent PSNR dB | "
                    "pixel PSNR dB |\n|---|---|---|---|---|---|---|\n")
            for r in all_rows:
                f.write(f"| {r['resolution']} | {r['cfg_passes']}-pass | {r['sampler']} | "
                        f"{r['steps']} | {r['rel_l2_vs_ref']} | {r['latent_psnr_db']} | "
                        f"{r['pixel_psnr_db']} |\n")
        print(f"appended table to {args.out}")
    return all_rows


if __name__ == "__main__":
    main()
