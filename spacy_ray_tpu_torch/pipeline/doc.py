"""Doc / Span / Example: host-side annotation containers (copies of
``spacy_ray_tpu/pipeline/doc.py``). The device never sees them: collation
lowers them to padded tensors."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Span:
    """A labeled token slice [start, end) of a doc."""

    start: int
    end: int
    label: str
    kb_id: str = ""


@dataclass
class Doc:
    """A tokenized text with optional gold/predicted annotations."""

    words: List[str]
    spaces: Optional[List[bool]] = None
    tags: Optional[List[str]] = None
    pos: Optional[List[str]] = None
    heads: Optional[List[int]] = None
    deps: Optional[List[str]] = None
    lemmas: Optional[List[str]] = None
    morphs: Optional[List[str]] = None
    sent_starts: Optional[List[int]] = None
    ents: List[Span] = field(default_factory=list)
    spans: Dict[str, List[Span]] = field(default_factory=dict)
    cats: Dict[str, float] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.words)

    @property
    def text(self) -> str:
        if self.spaces is None:
            return " ".join(self.words)
        return "".join(w + (" " if sp else "") for w, sp in zip(self.words, self.spaces))

    def copy_shell(self) -> "Doc":
        """A prediction shell: same tokens, no annotations."""
        return Doc(words=list(self.words), spaces=list(self.spaces) if self.spaces else None)


@dataclass
class Example:
    """Paired (predicted, reference) docs."""

    predicted: Doc
    reference: Doc

    @classmethod
    def from_gold(cls, gold: Doc) -> "Example":
        return cls(predicted=gold.copy_shell(), reference=gold)

    def __len__(self) -> int:
        return len(self.reference)


def doc_to_json(doc: Doc) -> dict:
    """The JSON schema the JAX package's ``parse`` CLI and server write."""
    out: dict = {"tokens": doc.words}
    if doc.spaces is not None:
        out["spaces"] = doc.spaces
    for attr in ("tags", "pos", "heads", "deps", "lemmas", "morphs", "sent_starts"):
        val = getattr(doc, attr)
        if val is not None:
            out[attr] = val
    if doc.ents:
        out["ents"] = [
            [s.start, s.end, s.label] + ([s.kb_id] if s.kb_id else []) for s in doc.ents
        ]
    if doc.spans:
        out["spans"] = {
            g: [[s.start, s.end, s.label] for s in spans] for g, spans in doc.spans.items()
        }
    if doc.cats:
        out["cats"] = doc.cats
    return out
