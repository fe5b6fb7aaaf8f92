"""Knowledge base for entity linking: a copy of ``spacy_ray_tpu/pipeline/kb.py``.

The ``entity_linker``'s candidate store, on the host: entity ids with
frequencies and one dense vector each, and aliases (surface forms) mapping
to candidate entities with prior probabilities. Lookup is a dictionary hit
at collation and decode time; only the mention scoring runs on the device
(``components/nel.py``).

Serialized as one ``.npz``: ``vectors`` [n_entities, D] float32 and ``meta``,
the UTF-8 bytes of a JSON payload with the string tables (no pickle). A file
written by either package loads in the other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


@dataclass
class Candidate:
    """One candidate entity for a mention: id, prior P(entity|alias), vector."""

    entity: str
    prior: float
    vector: np.ndarray
    freq: float = 0.0


class KnowledgeBase:
    def __init__(self, entity_vector_length: int):
        self.entity_vector_length = int(entity_vector_length)
        self._ids: List[str] = []
        self._row: Dict[str, int] = {}
        self._freqs: List[float] = []
        self._vectors: List[np.ndarray] = []
        # alias -> parallel lists (entity row, prior), sorted by prior desc
        self._aliases: Dict[str, List[Tuple[int, float]]] = {}

    # ------------------------------------------------------------- build
    def add_entity(self, entity: str, freq: float, vector) -> None:
        vec = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vec.shape[0] != self.entity_vector_length:
            raise ValueError(
                f"entity {entity!r}: vector length {vec.shape[0]} != "
                f"kb entity_vector_length {self.entity_vector_length}"
            )
        if entity in self._row:
            raise ValueError(f"entity {entity!r} already in KB")
        self._row[entity] = len(self._ids)
        self._ids.append(entity)
        self._freqs.append(float(freq))
        self._vectors.append(vec)

    def add_alias(
        self, alias: str, entities: Sequence[str], probabilities: Sequence[float]
    ) -> None:
        if len(entities) != len(probabilities):
            raise ValueError("entities and probabilities must align")
        total = float(sum(probabilities))
        if total > 1.0 + 1e-6:
            raise ValueError(
                f"alias {alias!r}: prior probabilities sum to {total} > 1"
            )
        rows = []
        for ent, p in zip(entities, probabilities):
            if ent not in self._row:
                raise ValueError(f"alias {alias!r}: unknown entity {ent!r}")
            rows.append((self._row[ent], float(p)))
        rows.sort(key=lambda rp: -rp[1])
        self._aliases[alias] = rows

    # ------------------------------------------------------------ lookup
    def __len__(self) -> int:
        return len(self._ids)

    @property
    def entities(self) -> List[str]:
        return list(self._ids)

    @property
    def aliases(self) -> List[str]:
        return list(self._aliases)

    def vector_of(self, entity: str) -> np.ndarray:
        return self._vectors[self._row[entity]]

    def candidates(self, mention: str) -> List[Candidate]:
        """Candidates for a mention surface form, highest prior first
        (falls back to the lowercased alias, mirroring vector lookup)."""
        rows = self._aliases.get(mention)
        if rows is None:
            rows = self._aliases.get(mention.lower())
        if not rows:
            return []
        return [
            Candidate(
                entity=self._ids[r],
                prior=p,
                vector=self._vectors[r],
                freq=self._freqs[r],
            )
            for r, p in rows
        ]

    # ------------------------------------------------------------- disk
    @staticmethod
    def _norm(path: Union[str, Path]) -> str:
        """np.savez appends '.npz' to suffix-less names but np.load does
        not — normalize so to_disk/from_disk agree on the same file."""
        p = str(path)
        return p if p.endswith(".npz") else p + ".npz"

    def to_disk(self, path: Union[str, Path]) -> None:
        meta = {
            "entity_vector_length": self.entity_vector_length,
            "ids": self._ids,
            "freqs": self._freqs,
            "aliases": {
                a: [[r, p] for r, p in rows] for a, rows in self._aliases.items()
            },
        }
        vectors = (
            np.stack(self._vectors)
            if self._vectors
            else np.zeros((0, self.entity_vector_length), np.float32)
        )
        np.savez(
            self._norm(path),
            vectors=vectors,
            meta=np.frombuffer(
                json.dumps(meta).encode("utf8"), dtype=np.uint8
            ),
        )

    @classmethod
    def from_disk(cls, path: Union[str, Path]) -> "KnowledgeBase":
        with np.load(cls._norm(path), allow_pickle=False) as data:
            meta = json.loads(bytes(data["meta"]).decode("utf8"))
            vectors = np.asarray(data["vectors"], dtype=np.float32)
        kb = cls(meta["entity_vector_length"])
        for ent, freq, vec in zip(meta["ids"], meta["freqs"], vectors):
            kb.add_entity(ent, freq, vec)
        for alias, rows in meta["aliases"].items():
            kb._aliases[alias] = [(int(r), float(p)) for r, p in rows]
        return kb
