"""Static word vectors: a copy of ``spacy_ray_tpu/pipeline/vectors.py``.

The asset is an ``.npz`` with ``words`` (a unicode array) and ``vectors``
([N, D] float32), the file ``[initialize] vectors`` names and a model
directory carries as ``vectors.npz`` (written by the ``init-vectors``
command). Words are deduplicated keeping the first occurrence; a word
missing from the table falls back to its lower case, and a word missing in
both is row -1 (a zero vector).

The active table is installed in a context (:func:`use_vectors`) so that
architecture factories reach it while a config is resolved, where no vocab
handle exists; ``StaticVectors`` (``models/layers.py``) copies it into a
frozen buffer of the model.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Union

import numpy as np


class Vectors:
    def __init__(self, words: Sequence[str], table: np.ndarray):
        if len(words) != table.shape[0]:
            raise ValueError(f"{len(words)} words vs {table.shape[0]} vector rows")
        table = np.asarray(table, dtype=np.float32)
        # keep the first occurrence of a word, so that saving and loading
        # give the same table
        seen: Dict[str, int] = {}
        keep: list = []
        for i, w in enumerate(words):
            if w not in seen:
                seen[w] = len(keep)
                keep.append(i)
        if len(keep) != len(words):
            table = table[np.asarray(keep)]
        self.table = table
        self.key_to_row: Dict[str, int] = seen

    @property
    def width(self) -> int:
        return int(self.table.shape[1])

    def __len__(self) -> int:
        return self.table.shape[0]

    def row_of(self, word: str) -> int:
        """The word's row, else its lower case's, else -1 (a zero vector)."""
        r = self.key_to_row.get(word)
        if r is None:
            r = self.key_to_row.get(word.lower(), -1)
        return r

    def rows_of(self, words: Sequence[str]) -> np.ndarray:
        return np.array([self.row_of(w) for w in words], dtype=np.int32)

    @classmethod
    def from_disk(cls, path: Union[str, Path]) -> "Vectors":
        with np.load(str(path), allow_pickle=False) as data:
            words = [str(w) for w in data["words"]]
            table = data["vectors"]
        return cls(words, table)

    def to_disk(self, path: Union[str, Path]) -> None:
        words = np.array(list(self.key_to_row), dtype=np.str_)
        order = np.argsort([self.key_to_row[w] for w in words])
        np.savez(str(path), words=words[order], vectors=self.table)


_ACTIVE: "contextvars.ContextVar[Optional[Vectors]]" = contextvars.ContextVar(
    "spacy_ray_tpu_torch_vectors", default=None
)


def current_vectors() -> Optional[Vectors]:
    return _ACTIVE.get()


@contextmanager
def use_vectors(vectors: Optional[Vectors]) -> Iterator[None]:
    token = _ACTIVE.set(vectors)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
