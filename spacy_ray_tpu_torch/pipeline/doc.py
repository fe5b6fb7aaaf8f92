"""Doc / Span / Example: host-side annotation containers (copies of
``spacy_ray_tpu/pipeline/doc.py``). The device never sees them: collation
lowers them to padded tensors; entity spans go to BILUO tags and back."""

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

    def __iter__(self):
        yield from (self.start, self.end, self.label)


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
    # tri-state entity-annotation marker (spaCy's has_annotation("ENT_IOB")):
    # True = annotated (no ents means "no entities here": predictions count
    # as false positives), False = unannotated (the scorer skips the doc),
    # None = annotated iff ents is non-empty
    ents_annotated: Optional[bool] = None

    @property
    def has_ents_annotation(self) -> bool:
        if self.ents_annotated is not None:
            return self.ents_annotated
        return bool(self.ents)

    def __len__(self) -> int:
        return len(self.words)

    @property
    def text(self) -> str:
        if self.spaces is None:
            return " ".join(self.words)
        return "".join(w + (" " if sp else "") for w, sp in zip(self.words, self.spaces))

    def ents_biluo(self) -> List[str]:
        """The entity spans as per-token BILUO tags (O outside)."""
        tags = ["O"] * len(self.words)
        for span in self.ents:
            if span.end <= span.start:
                continue
            if span.end - span.start == 1:
                tags[span.start] = f"U-{span.label}"
            else:
                tags[span.start] = f"B-{span.label}"
                for i in range(span.start + 1, span.end - 1):
                    tags[i] = f"I-{span.label}"
                tags[span.end - 1] = f"L-{span.label}"
        return tags

    @staticmethod
    def spans_from_biluo(tags: List[str]) -> List[Span]:
        """Spans of a BILUO tag sequence; malformed runs are dropped."""
        spans: List[Span] = []
        start, label = None, None
        for i, tag in enumerate(tags):
            if tag == "O" or tag == "-":
                start, label = None, None
                continue
            prefix, _, lab = tag.partition("-")
            if prefix == "U":
                spans.append(Span(i, i + 1, lab))
                start, label = None, None
            elif prefix == "B":
                start, label = i, lab
            elif prefix == "I":
                if start is None or lab != label:
                    start, label = None, None
            elif prefix == "L":
                if start is not None and lab == label:
                    spans.append(Span(start, i + 1, lab))
                start, label = None, None
        return spans

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
