"""The weights of a run, drawn from its seed on the device.

Every weight is N(0, 0.02^2), zero-initialised layers included (a UNet
whose output layer is zero returns exactly 0 and would hide a wrong
kernel), in bfloat16, the type the program serves in. One generator on the
device draws each top-level module's weights in one call, in the order of
`benchmark.reference.model.param_shapes`. The program and the reference
get views of the same draws, so they hold equal weights: the program casts
its copies to its own storage types (bfloat16; float32 norms and master
weights), the reference to float32.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

STD = 0.02


def draw(shapes: Sequence[Tuple[str, tuple]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: bf16 tensor} for `shapes`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups: Dict[str, list] = {}
    for name, shape in shapes:
        groups.setdefault(name.split(".")[0], []).append((name, shape))
    out = {}
    for items in groups.values():
        sizes = [torch.Size(s).numel() for _, s in items]
        flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.bfloat16)
        flat.mul_(STD)
        for (name, shape), part in zip(items, flat.split(sizes)):
            out[name] = part.view(shape)
    return out
