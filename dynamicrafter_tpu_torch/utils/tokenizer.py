"""Tokenizers for the CLIP text tower.

With a CLIP BPE vocab (`bpe_simple_vocab_16e6.txt.gz`, shipped with
open_clip) the tokenizer is the JAX package's numpy-only
`dynamicrafter_tpu.utils.tokenizer.CLIPTokenizer`, imported only then.
Without one, `HashTokenizer` stands in for random-weight runs; it gives
the same ids as the JAX package's, so both packages see the same tokens.
"""
from __future__ import annotations

import hashlib
import html
import re
from typing import Optional, Sequence

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class HashTokenizer:
    """Deterministic stand-in: each whitespace word maps to a stable id.
    Not CLIP-compatible; only for smoke tests and random-weight runs."""

    def __init__(self, context_length: int = CONTEXT_LENGTH,
                 vocab_size: int = VOCAB_SIZE, pad_id: int = 0):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1
        self.pad_id = pad_id

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
                   % (self.vocab_size - 2) for w in _clean_text(text).split()]
            toks = [self.sot] + ids[: self.context_length - 2] + [self.eot]
            out[i, : len(toks)] = toks
        return out


def default_tokenizer(vocab_path: Optional[str] = None):
    """The CLIP BPE tokenizer when `vocab_path` is given, else HashTokenizer."""
    if vocab_path is None:
        return HashTokenizer()
    from dynamicrafter_tpu.utils.tokenizer import CLIPTokenizer

    return CLIPTokenizer(vocab_path)
