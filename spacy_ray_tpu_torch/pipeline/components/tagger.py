"""Tagger component: per-token softmax classification (POS tags), scored
by token accuracy (``tag_acc``). Counterpart of
``spacy_ray_tpu/pipeline/components/tagger.py``."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ...models.core import Context, call
from ...ops import ops as O
from ...registry import registry
from ..doc import Doc, Example
from .base import Component


class TaggerComponent(Component):

    default_score_weights = {"tag_acc": 1.0}

    def add_labels_from(self, examples) -> None:
        labels = set(self.labels)
        for eg in examples:
            if eg.reference.tags:
                labels.update(t for t in eg.reference.tags if t)
        self.labels = list(labels)

    def make_targets(self, examples: List[Example], B: int, T: int) -> Dict[str, np.ndarray]:
        label_ids = {label: i for i, label in enumerate(self.labels)}
        tags = np.zeros((B, T), dtype=np.int32)
        mask = np.zeros((B, T), dtype=bool)
        # per-Example target cache (examples recur every epoch); keyed by the
        # label tuple, so any label change invalidates it
        cache_key = tuple(self.labels)
        for i, eg in enumerate(examples):
            ref = eg.reference
            if not ref.tags:
                continue
            cached = getattr(eg, "_tag_target_cache", None)
            if cached is None or cached[0] != cache_key:
                ids = np.zeros(len(ref.tags), dtype=np.int32)
                valid = np.zeros(len(ref.tags), dtype=bool)
                for j, tag in enumerate(ref.tags):
                    idx = label_ids.get(tag)
                    if idx is not None:
                        ids[j] = idx
                        valid[j] = True
                eg._tag_target_cache = cached = (cache_key, ids, valid)
            _, ids, valid = cached
            n = min(len(ids), T)
            tags[i, :n] = ids[:n]
            mask[i, :n] = valid[:n]
        return {"tags": tags, "tag_mask": mask}

    def loss(self, inputs: Any, targets: Dict[str, Any], ctx: Context):
        logits = call(self.model, inputs, ctx).X
        loss = O.masked_softmax_cross_entropy(logits, targets["tags"], targets["tag_mask"])
        acc = O.masked_accuracy(logits.detach(), targets["tags"], targets["tag_mask"])
        return loss, {"tag_acc_batch": acc}

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        pred = outputs.X.argmax(dim=-1).cpu().numpy()
        for i, doc in enumerate(docs):
            doc.tags = [self.labels[t] for t in pred[i, :lengths[i]]]

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        from ..scoring import score_token_acc

        return score_token_acc(examples, "tag_acc", lambda d: d.tags)


@registry.factories("tagger")
def make_tagger(name: str, model: Dict[str, Any]) -> TaggerComponent:
    return TaggerComponent(name, model)
