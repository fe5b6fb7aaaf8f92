"""Text classifiers: ``textcat`` (exclusive classes, softmax) and
``textcat_multilabel`` (independent sigmoids). Counterpart of
``spacy_ray_tpu/pipeline/components/textcat.py``, scored with spaCy's
``Scorer.score_cats`` keys."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ...models.core import Context, call
from ...ops import ops as O
from ...registry import registry
from ..doc import Doc, Example
from .base import Component


class TextCatComponent(Component):

    default_score_weights = {"cats_score": 1.0}

    def __init__(self, name: str, model_cfg: Dict[str, Any], exclusive: bool,
                 threshold: float = 0.5):
        super().__init__(name, model_cfg)
        self.exclusive = exclusive
        self.threshold = threshold

    def add_labels_from(self, examples) -> None:
        labels = set(self.labels)
        for eg in examples:
            labels.update(eg.reference.cats.keys())
        self.labels = list(labels)

    def make_targets(self, examples: List[Example], B: int, T: int) -> Dict[str, np.ndarray]:
        label_ids = {label: i for i, label in enumerate(self.labels)}
        cats = np.zeros((B, len(self.labels)), dtype=np.float32)
        mask = np.zeros((B,), dtype=bool)
        for i, eg in enumerate(examples):
            if eg.reference.cats:
                mask[i] = True
                for label, value in eg.reference.cats.items():
                    if label in label_ids:
                        cats[i, label_ids[label]] = float(value)
        return {"cats": cats, "cats_mask": mask}

    def loss(self, inputs: Any, targets: Dict[str, Any], ctx: Context):
        logits = call(self.model, inputs, ctx)  # [B, C]
        cats = targets["cats"]
        if self.exclusive:
            mask = targets["cats_mask"].float()
            per = -(cats * torch.log_softmax(logits.float(), dim=-1)).sum(dim=-1)
            loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        else:
            loss = O.masked_sigmoid_bce(logits, cats, targets["cats_mask"])
        return loss, {}

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        logits = outputs.float().cpu().numpy()
        if self.exclusive:
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs = probs / probs.sum(-1, keepdims=True)
        else:
            probs = 1.0 / (1.0 + np.exp(-logits))
        for i, doc in enumerate(docs):
            doc.cats = {label: float(probs[i, j]) for j, label in enumerate(self.labels)}

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        """Micro P/R/F over per-label decisions (gold positive at 0.5, the
        prediction at ``threshold``), macro F, ``cats_f_per_type``, macro
        ROC AUC over the labels where it is defined, and for exclusive
        classes the accuracy of the argmax (the first maximum wins), which
        is then ``cats_score``. Docs without gold cats are skipped; every key
        is None when no doc has any."""
        from ..scoring import PRF, rank_auc

        micro = PRF()
        per_label: Dict[str, PRF] = {l: PRF() for l in self.labels}
        gold_by_label: Dict[str, List[int]] = {l: [] for l in self.labels}
        score_by_label: Dict[str, List[float]] = {l: [] for l in self.labels}
        correct = total = 0
        any_annotation = False
        for eg in examples:
            gold = eg.reference.cats
            pred = eg.predicted.cats
            if not gold:
                continue
            any_annotation = True
            if self.exclusive:
                total += 1
                g = max(gold, key=gold.get)
                p = max(pred, key=pred.get) if pred else None
                correct += int(g == p)
            for label in self.labels:
                gv = gold.get(label, 0.0) >= 0.5
                pv = pred.get(label, 0.0) >= self.threshold
                gold_by_label[label].append(int(gv))
                score_by_label[label].append(float(pred.get(label, 0.0)))
                prf = per_label[label]
                if pv and gv:
                    micro.tp += 1
                    prf.tp += 1
                elif pv:
                    micro.fp += 1
                    prf.fp += 1
                elif gv:
                    micro.fn += 1
                    prf.fn += 1
        if not any_annotation:
            return {k: None for k in ("cats_micro_p", "cats_micro_r", "cats_micro_f",
                                      "cats_macro_f", "cats_macro_auc", "cats_f_per_type",
                                      "cats_score")}
        aucs = [a for a in (rank_auc(gold_by_label[l], score_by_label[l]) for l in self.labels)
                if a is not None]
        out = {
            "cats_micro_p": micro.precision,
            "cats_micro_r": micro.recall,
            "cats_micro_f": micro.fscore,
            "cats_macro_f": (float(np.mean([per_label[l].fscore for l in self.labels]))
                             if self.labels else 0.0),
            "cats_macro_auc": float(np.mean(aucs)) if aucs else None,
            "cats_f_per_type": {l: per_label[l].to_dict() for l in sorted(per_label)},
            "cats_score": micro.fscore,
        }
        if self.exclusive and total:
            out["cats_acc"] = correct / total
            out["cats_score"] = out["cats_acc"]
        return out


@registry.factories("textcat")
def make_textcat(name: str, model: Dict[str, Any], threshold: float = 0.5) -> TextCatComponent:
    return TextCatComponent(name, model, exclusive=True, threshold=threshold)


@registry.factories("textcat_multilabel")
def make_textcat_multilabel(name: str, model: Dict[str, Any],
                            threshold: float = 0.5) -> TextCatComponent:
    return TextCatComponent(name, model, exclusive=False, threshold=threshold)
