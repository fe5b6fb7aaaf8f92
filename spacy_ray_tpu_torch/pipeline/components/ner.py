"""Named entity recognizer over the BILUO transition system: counterpart of
``spacy_ray_tpu/pipeline/components/ner.py``.

The BILUO action at a token depends only on its position and the open
entity, so training is one window-feature classification over [B, T] (the
gold actions are the BILUO tags), and decoding computes every token's logits
in one pass and walks only the constraint automaton (``decode`` "viterbi",
exact, or "greedy"; ``models/parser.py``). Entities set by an earlier
component are kept. Scored by ``ents_p``/``ents_r``/``ents_f`` and per type.

Action encoding: O = 0, B-i = 1+4i, I-i = 2+4i, L-i = 3+4i, U-i = 4+4i.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models.core import Context
from ...models.parser import BiluoPlan, decode_biluo, decode_biluo_viterbi, ner_window_features
from ...ops import ops as O
from ...registry import registry
from ...types import Padded
from ..doc import Doc, Example
from .base import Component


def n_ner_actions(n_labels: int) -> int:
    return 1 + 4 * n_labels


def biluo_action_id(tag: str, label_ids: Dict[str, int]) -> int:
    if tag == "O" or tag == "-":
        return 0
    prefix, _, label = tag.partition("-")
    i = label_ids.get(label)
    if i is None:  # a label outside the sampled set counts as O
        return 0
    return {"B": 1, "I": 2, "L": 3, "U": 4}[prefix] + 4 * i


def action_to_biluo(action: int, labels: List[str]) -> str:
    if action == 0:
        return "O"
    prefix = ["B", "I", "L", "U"][(action - 1) % 4]
    return f"{prefix}-{labels[(action - 1) // 4]}"


class NERComponent(Component):

    default_score_weights = {"ents_f": 1.0, "ents_p": 0.0, "ents_r": 0.0}
    sets_ents = True

    def __init__(self, name, model_cfg, decode: str = "viterbi"):
        super().__init__(name, model_cfg)
        if decode not in ("viterbi", "greedy"):
            raise ValueError(f"ner decode must be viterbi|greedy, got {decode!r}")
        self.decode = decode
        self._plans: Dict[Tuple[int, str], BiluoPlan] = {}

    def add_labels_from(self, examples) -> None:
        labels = set(self.labels)
        for eg in examples:
            for span in eg.reference.ents:
                labels.add(span.label)
        self.labels = list(labels)

    def build_model(self):
        cfg = dict(self.model_cfg)
        cfg["nO"] = n_ner_actions(len(self.labels))
        model = registry.resolve(cfg)
        self.model = model
        self.listens = bool(model.meta.get("has_listener"))
        self._plans = {}
        return model

    def make_targets(self, examples: List[Example], B: int, Tlen: int) -> Dict[str, np.ndarray]:
        label_ids = {label: i for i, label in enumerate(self.labels)}
        actions = np.zeros((B, Tlen), dtype=np.int32)
        mask = np.zeros((B, Tlen), dtype=bool)
        lengths = np.zeros(B, dtype=np.int64)
        for i, eg in enumerate(examples):
            ref = eg.reference
            n = min(len(ref), Tlen)
            lengths[i] = n
            tags = ref.ents_biluo()
            for t in range(n):
                actions[i, t] = biluo_action_id(tags[t], label_ids)
                mask[i, t] = True
        feats = ner_window_features(Tlen, torch.from_numpy(lengths)).numpy()
        return {"actions": actions, "feats": feats, "ner_mask": mask}

    def loss(self, inputs: Any, targets: Dict[str, Any], ctx: Context):
        logits = self.model((inputs, targets["feats"]))
        loss = O.masked_softmax_cross_entropy(logits, targets["actions"], targets["ner_mask"])
        acc = O.masked_accuracy(logits.detach(), targets["actions"], targets["ner_mask"])
        return loss, {"ner_action_acc": acc}

    def trunk_output(self, inputs: Any) -> Padded:
        return inputs if isinstance(inputs, Padded) else self.model.tok2vec(inputs)

    #: both decodes are replayed as CUDA graphs when served
    graph_capturable = True

    def decode_signature(self) -> Tuple[Any, ...]:
        return ("decode", self.decode, len(self.labels))

    def plan(self, device: torch.device) -> BiluoPlan:
        key = (len(self.labels), str(device))
        if key not in self._plans:
            self._plans[key] = BiluoPlan(len(self.labels), device)
        return self._plans[key]

    def device_decode(self, X: torch.Tensor, lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        """BILUO action ids [B, T] of trunk output X [B, T, D] with true
        lengths [B]. No host synchronisation."""
        feats = ner_window_features(X.shape[1], lengths)
        logits = self.model.upper.step_logits(X, feats)
        fn = decode_biluo_viterbi if self.decode == "viterbi" else decode_biluo
        return {"actions": fn(logits, lengths, len(self.labels), self.plan(X.device))}

    def forward(self, inputs: Any, overlay: Optional[Dict[str, Any]] = None,
                ctx: Optional[Context] = None) -> Dict[str, torch.Tensor]:
        t2v = self.trunk_output(inputs)
        return self.device_decode(t2v.X, t2v.mask.sum(1))

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        actions = outputs["actions"].cpu().numpy()
        for i, doc in enumerate(docs):
            tags = [action_to_biluo(int(a), self.labels) for a in actions[i, :lengths[i]]]
            model_ents = Doc.spans_from_biluo(tags)
            if doc.ents:
                # entities set by an earlier component stay; the model adds
                # only the ones that do not overlap them
                claimed = {j for e in doc.ents for j in range(e.start, e.end)}
                model_ents = [m for m in model_ents
                              if not (set(range(m.start, m.end)) & claimed)]
                doc.ents = sorted(doc.ents + model_ents, key=lambda s: s.start)
            else:
                doc.ents = model_ents

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        from ..scoring import score_spans

        return score_spans(examples, "ents", lambda d: d.ents,
                           has_annotation=lambda d: d.has_ents_annotation)


@registry.factories("ner")
def make_ner(name: str, model: Dict[str, Any], decode: str = "viterbi") -> NERComponent:
    return NERComponent(name, model, decode=decode)
