"""Training checkpoints with `torch.save` (JAX twin
dynamicrafter_tpu/training/checkpoints.py, which uses Orbax).

A checkpoint is one file, `<dir>/step_<step>.pt`, holding a
`Trainer.state_dict()`: the step, the trainable weights under reference
checkpoint keys, the optimizer state, the EMA weights and the gradient
accumulator. Retention follows the JAX manager: the newest `max_to_keep`,
or, with a monitored metric, the best `top_k` (the reference's monitored
ModelCheckpoint, main/utils_train.py:68-73). The metrics of every kept
checkpoint live in `<dir>/index.json`. With a data-parallel mesh every rank
calls `save` (rank 0 with the gathered state, the others with None): rank 0
writes, and every rank leaves `save` after a barrier, so that none reads the
directory early. What is in the directory is rank 0's word: `latest_step`
gives rank 0's on every rank, so that every rank decides alike whether to
save or resume, and `restore` raises on every rank if one of them does not
see the file that rank 0 names (a --logdir the ranks do not share).

A checkpoint is written without a CRC32 of each record and through pinned
host buffers (`write`): only `torch.load` reads it (`restore`,
`export_checkpoint`), which does not check the CRC, and computing it and the
pageable copies off the device cost seconds a checkpoint of tens of GB.
`restore` maps the file rather than reading it. An exported checkpoint keeps
`torch.save`'s CRCs: the JAX package's torch-free reader checks them.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Optional

import torch

from dynamicrafter_tpu_torch.parallel.sharding import Mesh, barrier, gather_objects

_NAME = re.compile(r"^step_(\d+)\.pt$")


def write(state, path: str) -> None:
    """`torch.save` as checkpoints are written here: no CRC32 of each
    record, device tensors copied through pinned host buffers."""
    from torch.utils.serialization import config

    with config.patch({"save.compute_crc32": False, "save.use_pinned_memory_for_d2h": True}):
        torch.save(state, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 monitor: Optional[str] = None, top_k: int = 3, mode: str = "min",
                 mesh: Optional[Mesh] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.mesh = mesh
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
        """The newest saved step, or None; with a mesh, rank 0's on every
        rank (a collective: every rank calls it)."""
        steps = self.all_steps()
        step = steps[-1] if steps else None
        return step if self.mesh is None else gather_objects(step, self.mesh)[0]

    def _index(self) -> Dict[str, dict]:
        if not os.path.exists(self._index_path):
            return {}
        with open(self._index_path) as f:
            return json.load(f)

    def save(self, step: int, state: Optional[dict], metrics: Optional[dict] = None) -> str:
        """Write `state` for `step` (atomically), then apply retention; with
        a mesh, on rank 0, and every rank returns after a barrier."""
        path = self.path(step)
        if self.mesh is not None:
            if self.mesh.rank == 0:
                self._write(path, step, state, metrics)
            barrier(self.mesh)
            return path
        self._write(path, step, state, metrics)
        return path

    def _write(self, path: str, step: int, state: dict, metrics: Optional[dict]) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        write(state, tmp)
        os.replace(tmp, path)
        index = self._index()
        index[str(step)] = {k: float(v) for k, v in (metrics or {}).items()}
        self._retain(index)
        with open(self._index_path, "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)

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
        None. With a mesh every rank calls it and loads rank 0's step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self.path(step)
        if self.mesh is not None:
            seen = gather_objects(os.path.exists(path), self.mesh)
            if not all(seen):
                raise RuntimeError(
                    f"ranks {[r for r, s in enumerate(seen) if not s]} do not see {path}, which "
                    "rank 0 wrote: to resume, every rank needs the same checkpoint directory "
                    "(a --logdir on a filesystem that all ranks share)")
        # mapped, not read: the caller copies the records it uses
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


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
