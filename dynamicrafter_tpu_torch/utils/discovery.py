"""Discovery of released weights and the CLIP vocab at the standard places.

The port's own copy of the JAX package's `dynamicrafter_tpu/utils/discovery.py`
(standard library only): the same search order, environment overrides and
single "blocked on:" line. `parity_check` calls `discover` and, when
something is missing, prints that one line naming every absent artifact and
every path searched.

Searched per resolution (reference checkpoint table, README.md:292):
  * $DYNAMICRAFTER_CKPT_<RES> / $DYNAMICRAFTER_CKPT, $DYNAMICRAFTER_VOCAB
  * ./checkpoints/dynamicrafter_<res>[_interp]_v1/model.ckpt (the run-script
    layout) under the working directory, ~ and the common mount roots
    (`_MOUNT_ROOTS`, the JAX module's list)
  * the HF hub offline cache ($HF_HOME/hub, $HUGGINGFACE_HUB_CACHE or
    ~/.cache/huggingface/hub): models--Doubiiu--DynamiCrafter[_512|_1024|
    _512_Interp]/snapshots/*/model.ckpt
The vocab is also sought beside the port's tokenizer (`utils/assets/`), in
~/.cache/dynamicrafter_tpu/ and inside an installed open_clip.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

_HF_REPOS = {
    "256": "DynamiCrafter",
    "512": "DynamiCrafter_512",
    "1024": "DynamiCrafter_1024",
    "512_interp": "DynamiCrafter_512_Interp",
}

_MOUNT_ROOTS = tuple(dict.fromkeys(
    (".", os.path.expanduser("~"), "/root", "/data", "/mnt", "/models")))


def _hf_cache_dirs() -> List[str]:
    dirs = []
    if os.environ.get("HF_HOME"):
        dirs.append(os.path.join(os.environ["HF_HOME"], "hub"))
    if os.environ.get("HUGGINGFACE_HUB_CACHE"):
        dirs.append(os.environ["HUGGINGFACE_HUB_CACHE"])
    dirs.append(os.path.expanduser("~/.cache/huggingface/hub"))
    return dirs


def checkpoint_candidates(resolution: str) -> List[str]:
    """Every path (or glob) searched for a released model.ckpt, in order."""
    res = resolution.lower()
    cands = [os.environ[var] for var in (f"DYNAMICRAFTER_CKPT_{res.upper()}",
                                         "DYNAMICRAFTER_CKPT") if os.environ.get(var)]
    cands += [os.path.join(root, "checkpoints", f"dynamicrafter_{res}_v1", "model.ckpt")
              for root in _MOUNT_ROOTS]
    repo = _HF_REPOS.get(res)
    if repo:
        cands += [os.path.join(hub, f"models--Doubiiu--{repo}", "snapshots", "*", "model.ckpt")
                  for hub in _hf_cache_dirs()]
    return cands


def vocab_candidates() -> List[str]:
    """Every path searched for bpe_simple_vocab_16e6.txt.gz, in order."""
    from dynamicrafter_tpu_torch.utils.tokenizer import _DEFAULT_VOCAB_CANDIDATES

    cands = [os.environ["DYNAMICRAFTER_VOCAB"]] if os.environ.get("DYNAMICRAFTER_VOCAB") else []
    cands += list(_DEFAULT_VOCAB_CANDIDATES)
    cands += [os.path.join(root, "bpe_simple_vocab_16e6.txt.gz") for root in _MOUNT_ROOTS]
    try:  # open_clip ships the vocab inside its package
        import open_clip  # type: ignore

        cands.append(os.path.join(os.path.dirname(open_clip.__file__),
                                  "bpe_simple_vocab_16e6.txt.gz"))
    except ImportError:
        pass
    return cands


def _first_existing(candidates: List[str]) -> Optional[str]:
    for cand in candidates:
        if "*" in cand:
            hits = sorted(glob.glob(cand))
            if hits:
                return hits[0]
        elif os.path.exists(cand):
            return cand
    return None


def find_checkpoint(resolution: str) -> Optional[str]:
    return _first_existing(checkpoint_candidates(resolution))


def find_vocab() -> Optional[str]:
    return _first_existing(vocab_candidates())


def discover(resolution: str) -> Tuple[Dict[str, Optional[str]], str]:
    """({"checkpoint": path or None, "vocab": path or None}, blocked_line):
    the line is "" when both were found, else one line naming what is
    missing and every path searched for it."""
    found = {"checkpoint": find_checkpoint(resolution), "vocab": find_vocab()}
    missing = []
    if found["checkpoint"] is None:
        missing.append("checkpoint (searched: "
                       + ", ".join(checkpoint_candidates(resolution)) + ")")
    if found["vocab"] is None:
        missing.append("vocab bpe_simple_vocab_16e6.txt.gz (searched: "
                       + ", ".join(vocab_candidates()) + ")")
    return found, ("blocked on: " + "; ".join(missing) if missing else "")
