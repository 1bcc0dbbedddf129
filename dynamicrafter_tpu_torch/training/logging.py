"""Training logs: a file and console logger, and `metrics.csv` (JAX twin
dynamicrafter_tpu/training/logging.py; reference main/utils_train.py:99-173
and the CUDACallback's memory report, main/callbacks.py:104-133)."""
from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict

import torch

mainlogger = logging.getLogger("dynamicrafter_tpu_torch.train")


def setup_logger(logdir: str) -> logging.Logger:
    """INFO to `<logdir>/train.log` and to the console (replacing the
    handlers of an earlier call)."""
    os.makedirs(logdir, exist_ok=True)
    for h in list(mainlogger.handlers):
        mainlogger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for h in (logging.FileHandler(os.path.join(logdir, "train.log")), logging.StreamHandler()):
        h.setFormatter(fmt)
        mainlogger.addHandler(h)
    mainlogger.setLevel(logging.INFO)
    mainlogger.propagate = False
    return mainlogger


def device_memory_stats() -> Dict[str, float]:
    """Live and peak allocated device memory (GB) from torch.cuda; on a
    machine without CUDA, the host's peak RSS as `peak_host_rss_gb`."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return {"mem_in_use_gb": torch.cuda.memory_allocated() / 1e9,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    import resource
    return {"peak_host_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}


class MetricLogger:
    """Appends one row per `log` call to `<logdir>/metrics.csv`; a metric
    that appears later widens the header and the file is rewritten."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.csv")
        self._fields = []
        if os.path.exists(self.path):
            with open(self.path) as f:
                self._fields = list(csv.DictReader(f).fieldnames or [])
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "wall_s": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in metrics.items()}, **device_memory_stats()}
        new = [k for k in row if k not in self._fields]
        if new and self._fields:
            with open(self.path) as f:
                rows = list(csv.DictReader(f))
            self._fields += new
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields, restval="")
                w.writeheader()
                w.writerows(rows)
        elif new:
            self._fields = new
            with open(self.path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writeheader()
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fields, restval="").writerow(row)
