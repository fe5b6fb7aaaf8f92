"""Vocab: words -> stable 64-bit lexical-attribute keys (host side).

A copy of ``spacy_ray_tpu/pipeline/vocab.py``: each token maps to its
NORM/PREFIX/SUFFIX/SHAPE strings, each string is murmur-hashed to a uint64
key, and the keys ship to the device as [T, n_attrs, 2] uint32 (lo, hi)
words, re-hashed there per embedding table. The strings of a batch's new
words are hashed in one call to the native MurmurHash3 (``native/``, the
keys of ``ops/hashing.py:hash_string_u64``). Computed features are cached
per word in one contiguous array.
"""

from __future__ import annotations

import threading
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np

from ..native import hash_strings_u64
from ..ops.hashing import split_u64

# Canonical order of lexical attributes (models/tok2vec.py ATTRS).
ATTRS = ("NORM", "PREFIX", "SUFFIX", "SHAPE")


@lru_cache(maxsize=2 ** 17)
def shape_of(word: str) -> str:
    """Word shape: 'Xxxx', 'dd', 'xx-xx' — capped run length like spaCy."""
    out = []
    last = ""
    run = 0
    for ch in word:
        if ch.isalpha():
            sym = "X" if ch.isupper() else "x"
        elif ch.isdigit():
            sym = "d"
        else:
            sym = ch
        if sym == last:
            run += 1
            if run < 4:
                out.append(sym)
        else:
            out.append(sym)
            last = sym
            run = 1
    return "".join(out)


def attr_strings(word: str) -> List[str]:
    """The attribute strings of a word, in ATTRS order."""
    return [
        "norm=" + word.lower(),
        "pre=" + word[:1],
        "suf=" + word[-3:],
        "shape=" + shape_of(word),
    ]


class Vocab:
    """Featurizer with a bounded per-word cache:
    ``featurize(words) -> uint32 [len(words), n_attrs, 2]``."""

    CACHE_MAX = 2 ** 20  # rows

    def __init__(self):
        self._index: Dict[str, int] = {}
        self._rows = np.zeros((1024, len(ATTRS), 2), dtype=np.uint32)
        self._n_rows = 0
        # rows are written before their index is published, so lock-free
        # readers of the all-cached path only ever see complete rows
        self._append_lock = threading.Lock()

    @staticmethod
    def _compute_feats(words: List[str]) -> np.ndarray:
        strings = [s for w in words for s in attr_strings(w)]
        return split_u64(hash_strings_u64(strings).reshape(len(words), len(ATTRS)))

    def _append_rows(self, feats: np.ndarray) -> int:
        k = feats.shape[0]
        while self._n_rows + k > self._rows.shape[0]:
            self._rows = np.concatenate([self._rows, np.zeros_like(self._rows)])
        start = self._n_rows
        self._rows[start:start + k] = feats
        self._n_rows = start + k
        return start

    def featurize(self, words: Sequence[str]) -> np.ndarray:
        n = len(words)
        if not n:
            return np.zeros((0, len(ATTRS), 2), dtype=np.uint32)
        index = self._index
        missing = [w for w in words if w not in index]
        overflow: Dict[str, np.ndarray] = {}
        if missing:
            with self._append_lock:
                uniq = [w for w in dict.fromkeys(missing) if w not in index]
                if uniq:
                    feats = self._compute_feats(uniq)
                    room = max(self.CACHE_MAX - self._n_rows, 0)
                    if room:
                        start = self._append_rows(feats[:room])
                        for k, w in enumerate(uniq[:room]):
                            index[w] = start + k
                    for k in range(room, len(uniq)):  # cache full (rare)
                        overflow[uniq[k]] = feats[k]
        idx = np.fromiter((index.get(w, 0) for w in words), dtype=np.intp, count=n)
        result = self._rows[idx]
        for i, w in enumerate(words):
            if w in overflow:
                result[i] = overflow[w]
        return result
