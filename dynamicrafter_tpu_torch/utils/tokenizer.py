"""Tokenizers for the CLIP text tower.

`CLIPTokenizer` is the byte-pair-encoding tokenizer of open_clip's
SimpleTokenizer (numpy, gzip and re only; the same code as the JAX
package's `dynamicrafter_tpu/utils/tokenizer.py`, kept as the port's own
copy). It needs the merge table `bpe_simple_vocab_16e6.txt.gz` shipped
with open_clip. Without one, `HashTokenizer` stands in for random-weight
runs; it gives the same ids as the JAX package's, so both packages see
the same tokens.
"""
from __future__ import annotations

import gzip
import hashlib
import html
import os
import re
from typing import List, Optional, Sequence

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
# where a downloaded merge table is looked for (`utils/discovery.py`)
_DEFAULT_VOCAB_CANDIDATES = (
    os.path.join(os.path.dirname(__file__), "assets", "bpe_simple_vocab_16e6.txt.gz"),
    os.path.expanduser("~/.cache/dynamicrafter_tpu/bpe_simple_vocab_16e6.txt.gz"),
)


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (standard GPT-2/CLIP BPE)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class CLIPTokenizer:
    """Byte-pair-encoding tokenizer compatible with open_clip's SimpleTokenizer."""

    def __init__(self, vocab_path: str, context_length: int = CONTEXT_LENGTH,
                 pad_id: int = 0):
        # open_clip pads with 0
        self.pad_id = pad_id
        if not os.path.exists(vocab_path):
            raise FileNotFoundError(
                f"CLIP BPE vocab not found at {vocab_path!r}: pass the path of "
                "bpe_simple_vocab_16e6.txt.gz (shipped with open_clip), or use "
                "HashTokenizer for random-weight runs")
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if vocab_path.endswith(".gz") else open
        with opener(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read()
        merges = merges.split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # \p{L}/\p{N} approximated with stdlib re unicode classes
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[^\W\d_]+|\d|[^\s\w]+",
            re.IGNORECASE | re.UNICODE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(self.pat, _clean_text(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """-> (B, 77) int32, pad_id-padded, [sot] tokens [eot]."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_id,
                      dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text)[: self.context_length - 2] + [self.eot]
            out[i, : len(toks)] = toks
        return out


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


def default_tokenizer(vocab_path: Optional[str] = None, pad_id: int = 0):
    """The CLIP BPE tokenizer when `vocab_path` is given, else HashTokenizer;
    rows are padded with `pad_id`."""
    if vocab_path is None:
        return HashTokenizer(pad_id=pad_id)
    return CLIPTokenizer(vocab_path, pad_id=pad_id)
