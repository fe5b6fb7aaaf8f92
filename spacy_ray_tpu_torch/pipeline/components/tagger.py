"""Tagger component: per-token softmax classification (POS tags)."""

from __future__ import annotations

from typing import Any, Dict, List

from ...registry import registry
from ..doc import Doc
from .base import Component


class TaggerComponent(Component):
    def add_labels_from(self, examples) -> None:
        labels = set(self.labels)
        for eg in examples:
            if eg.reference.tags:
                labels.update(t for t in eg.reference.tags if t)
        self.labels = list(labels)

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        pred = outputs.X.argmax(dim=-1).cpu().numpy()
        for i, doc in enumerate(docs):
            doc.tags = [self.labels[t] for t in pred[i, :lengths[i]]]


@registry.factories("tagger")
def make_tagger(name: str, model: Dict[str, Any]) -> TaggerComponent:
    return TaggerComponent(name, model)
