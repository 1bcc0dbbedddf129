"""Training checkpoints with `torch.save` (JAX twin
dynamicrafter_tpu/training/checkpoints.py, which uses Orbax).

A checkpoint is one file, `<dir>/step_<step>.pt`, holding a
`Trainer.state_dict()`: the step, the trainable weights under reference
checkpoint keys, the optimizer state, the EMA weights and the gradient
accumulator. Retention follows the JAX manager: the newest `max_to_keep`,
or, with a monitored metric, the best `top_k` (the reference's monitored
ModelCheckpoint, main/utils_train.py:68-73). The metrics of every kept
checkpoint live in `<dir>/index.json`.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 monitor: Optional[str] = None, top_k: int = 3, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep, self.monitor, self.top_k, self.mode = max_to_keep, monitor, top_k, mode
        self._index_path = os.path.join(self.directory, "index.json")

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def all_steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _index(self) -> Dict[str, dict]:
        if not os.path.exists(self._index_path):
            return {}
        with open(self._index_path) as f:
            return json.load(f)

    def save(self, step: int, state: dict, metrics: Optional[dict] = None) -> str:
        """Write `state` for `step` (atomically), then apply retention."""
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        index = self._index()
        index[str(step)] = {k: float(v) for k, v in (metrics or {}).items()}
        self._retain(index)
        with open(self._index_path, "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)
        return path

    def _retain(self, index: Dict[str, dict]) -> None:
        steps = self.all_steps()
        if self.monitor is not None:
            worst = math.inf if self.mode == "min" else -math.inf
            score = lambda s: index.get(str(s), {}).get(self.monitor, worst)
            keep = sorted(steps, key=score, reverse=self.mode == "max")[:self.top_k]
        elif self.max_to_keep is not None:
            keep = steps[-self.max_to_keep:]
        else:
            return
        for s in steps:
            if s not in keep:
                os.remove(self.path(s))
                index.pop(str(s), None)

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The state saved at `step` (default: the latest) on the CPU, or
        None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)


def load_trained_weights(pipe, state: dict) -> None:
    """Copy the trained weights of a checkpoint `state` into a pipeline;
    every key must name a tensor of the pipeline's modules (a learned
    `logvar` table has none and is skipped)."""
    weights = state["weights"]
    own = pipe.net.state_dict()
    unknown = sorted(k for k in weights if k not in own and k != "logvar")
    if unknown:
        raise KeyError(f"checkpoint keys not in the pipeline: {unknown[:10]}")
    with torch.no_grad():
        for k, v in weights.items():
            if k in own:
                own[k].copy_(v.to(dtype=own[k].dtype))
