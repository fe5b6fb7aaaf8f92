"""Per-token classifiers beside the tagger (counterpart of
``spacy_ray_tpu/pipeline/components/token_classifiers.py``): each is the
tagger's head and loss over other gold attributes.

* ``morphologizer``: the label is ``POS|FEATS`` (``POS`` alone without
  features); sets ``doc.pos`` and ``doc.morphs``; scored by ``pos_acc``,
  ``morph_acc`` and ``morph_per_feat``.
* ``senter``: labels fixed as ``["I", "S"]``; sets ``doc.sent_starts``
  (token 0 always starts one); scored by ``sents_p/r/f`` over whole
  sentences.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ...registry import registry
from ..doc import Doc, Example
from .tagger import TaggerComponent


class MorphologizerComponent(TaggerComponent):

    default_score_weights = {"pos_acc": 0.5, "morph_acc": 0.5}

    @staticmethod
    def _gold_label(doc: Doc, i: int) -> str:
        pos = doc.pos[i] if doc.pos else ""
        morph = doc.morphs[i] if doc.morphs else ""
        if not pos and not morph:
            return ""
        return f"{pos}|{morph}" if morph else pos

    def add_labels_from(self, examples) -> None:
        labels = set(self.labels)
        for eg in examples:
            ref = eg.reference
            if ref.pos or ref.morphs:
                labels.update(l for l in (self._gold_label(ref, i) for i in range(len(ref))) if l)
        self.labels = list(labels)

    def make_targets(self, examples: List[Example], B: int, T: int) -> Dict[str, np.ndarray]:
        label_ids = {label: i for i, label in enumerate(self.labels)}
        tags = np.zeros((B, T), dtype=np.int32)
        mask = np.zeros((B, T), dtype=bool)
        # per-Example cache of the label ids, keyed by the label tuple
        cache_key = tuple(self.labels)
        for i, eg in enumerate(examples):
            ref = eg.reference
            if not (ref.pos or ref.morphs):
                continue
            cached = getattr(eg, "_morph_target_cache", None)
            if cached is None or cached[0] != cache_key:
                found = [label_ids.get(self._gold_label(ref, j)) for j in range(len(ref))]
                ids = np.array([0 if f is None else f for f in found], dtype=np.int32)
                valid = np.array([f is not None for f in found], dtype=bool)
                eg._morph_target_cache = cached = (cache_key, ids, valid)
            _, ids, valid = cached
            n = min(len(ids), T)
            tags[i, :n] = ids[:n]
            mask[i, :n] = valid[:n]
        return {"tags": tags, "tag_mask": mask}

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        pred = outputs.X.argmax(dim=-1).cpu().numpy()
        for i, doc in enumerate(docs):
            pos, morphs = [], []
            for t in pred[i, :lengths[i]]:
                p, _, m = (self.labels[t] if self.labels else "").partition("|")
                pos.append(p)
                morphs.append(m)
            doc.pos = pos
            doc.morphs = morphs

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        from ..scoring import score_morph_per_feat, score_token_acc

        out: Dict[str, Any] = {}
        out.update(score_token_acc(examples, "pos_acc", lambda d: d.pos))
        out.update(score_token_acc(examples, "morph_acc", lambda d: d.morphs))
        out.update(score_morph_per_feat(examples))
        return out


class SenterComponent(TaggerComponent):
    """Binary sentence-start classifier."""

    default_score_weights = {"sents_f": 1.0, "sents_p": 0.0, "sents_r": 0.0}

    def add_labels_from(self, examples) -> None:
        self.labels = ["I", "S"]

    def finish_labels(self) -> None:
        self.labels = ["I", "S"]

    def make_targets(self, examples: List[Example], B: int, T: int) -> Dict[str, np.ndarray]:
        tags = np.zeros((B, T), dtype=np.int32)
        mask = np.zeros((B, T), dtype=bool)
        for i, eg in enumerate(examples):
            starts = eg.reference.sent_starts
            if not starts:
                continue
            s = np.asarray(starts[:T])
            tags[i, :len(s)] = s == 1
            mask[i, :len(s)] = s != 0  # 0: unannotated
        return {"tags": tags, "tag_mask": mask}

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        pred = outputs.X.argmax(dim=-1).cpu().numpy()
        for i, doc in enumerate(docs):
            starts = [1 if t == 1 else -1 for t in pred[i, :lengths[i]]]
            if starts:
                starts[0] = 1  # the first token always starts a sentence
            doc.sent_starts = starts

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        from ..scoring import score_sents

        return score_sents(examples)


@registry.factories("morphologizer")
def make_morphologizer(name: str, model: Dict[str, Any]) -> MorphologizerComponent:
    return MorphologizerComponent(name, model)


@registry.factories("senter")
def make_senter(name: str, model: Dict[str, Any]) -> SenterComponent:
    return SenterComponent(name, model)
