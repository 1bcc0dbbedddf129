"""EMA of the trainable weights with warmup decay (JAX twin
dynamicrafter_tpu/training/ema.py; reference LitEma, lvdm/ema.py:5-76):
s -= (1 - d) * (s - p) with d = min(decay, (1 + n) / (10 + n)).
"""
from __future__ import annotations

from typing import Dict

import torch


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in params.items()}


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               num_updates: int, decay: float = 0.9999) -> None:
    """Update `shadow` in place towards `params` after `num_updates` steps."""
    d = min(decay, (1.0 + num_updates) / (10.0 + num_updates))
    keys = list(shadow)
    torch._foreach_lerp_([shadow[k] for k in keys], [params[k].detach() for k in keys],
                         1.0 - d)
