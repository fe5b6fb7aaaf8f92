"""Dependency parser component (arc-eager, teacher-forced training):
counterpart of ``spacy_ray_tpu/pipeline/components/parser.py``.

Collation lowers each gold tree, projectivized (``pipeline/nonproj.py``), to
the oracle's (actions, state features, valid masks) grid on the host, once
per Example; the loss is one masked classification over the doc x step grid.
Decoding runs the arc-eager machine on the device (``models/parser.py``),
greedy or with a beam, and ``set_annotations`` undoes the lifting. Scored by
``dep_uas``/``dep_las``.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models.core import Context, call
from ...models.parser import NEG, ArcEagerPlan, decode_parser, decode_parser_beam
from ...registry import registry
from ...types import Padded
from .. import nonproj
from .. import transition as TS
from ..doc import Doc, Example
from .base import Component


class ParserComponent(Component):

    default_score_weights = {"dep_uas": 0.5, "dep_las": 0.5}

    def __init__(self, name, model_cfg, beam_width: int = 1):
        super().__init__(name, model_cfg)
        self.beam_width = int(beam_width)
        # collation's oracle accounting, printed by the train command
        self.oracle_stats = {"docs": 0, "projectivized": 0, "skipped": 0}
        self._stats_lock = threading.Lock()
        self._warned_skip = False
        self._plans: Dict[Tuple[int, int, int, str], ArcEagerPlan] = {}

    def add_labels_from(self, examples) -> None:
        labels = set(self.labels)
        for eg in examples:
            ref = eg.reference
            if ref.deps:
                labels.update(d for d in ref.deps if d)
                if ref.heads:
                    # the decorated labels of pseudo-projective lifting are
                    # real arc labels: the action space is sized with them
                    res = nonproj.projectivize(ref.heads, ref.deps)
                    if res is not None and res[2] > 0:
                        labels.update(l for l in res[1] if nonproj.is_decorated(l))
        self.labels = list(labels)

    def build_model(self):
        cfg = dict(self.model_cfg)
        cfg["nO"] = TS.n_actions(len(self.labels))
        model = registry.resolve(cfg)
        self.model = model
        self.listens = bool(model.meta.get("has_listener"))
        self._plans = {}
        return model

    # ------------------------------------------------------------------
    def make_targets(self, examples: List[Example], B: int, Tlen: int) -> Dict[str, np.ndarray]:
        label_ids = {label: i for i, label in enumerate(self.labels)}
        n_act = TS.n_actions(len(self.labels))
        S = 2 * Tlen + 2
        actions = np.zeros((B, S), dtype=np.int32)
        feats = np.full((B, S, TS.N_FEATURES), -1, dtype=np.int32)
        valid = np.zeros((B, S, n_act), dtype=bool)
        step_mask = np.zeros((B, S), dtype=bool)
        batch_stats = {"docs": 0, "projectivized": 0, "skipped": 0}
        labels_sig = tuple(self.labels)
        for i, eg in enumerate(examples):
            ref = eg.reference
            if not ref.heads or not ref.deps or len(ref) > Tlen:
                continue
            # the oracle is memoised per Example (the corpus yields the same
            # objects every epoch), keyed by the labels and the gold tree
            memo_key = (labels_sig, hash((tuple(ref.heads), tuple(ref.deps))))
            cached = getattr(eg, "_oracle_cache", None)
            if cached is not None and cached[0] == memo_key:
                out, lifted = cached[1]
            else:
                res = nonproj.projectivize(ref.heads, ref.deps)
                if res is None:  # malformed tree (cycle, bad head index)
                    out, lifted = None, 0
                else:
                    proj_heads, deco_deps, lifted = res
                    # a decorated label outside the sampled labels falls back
                    # to its undecorated base label
                    ids = [label_ids.get(d, label_ids.get(nonproj.decompose_label(d)[0], 0))
                           for d in deco_deps]
                    out = TS.gold_oracle(proj_heads, ids, len(self.labels))
                eg._oracle_cache = (memo_key, (out, lifted))
            batch_stats["docs"] += 1
            if lifted:
                batch_stats["projectivized"] += 1
            if out is None:  # unreachable for the oracle even after lifting
                batch_stats["skipped"] += 1
                if not self._warned_skip:
                    print(f"[{self.name}] warning: dropped a doc whose gold tree is "
                          "unusable even after pseudo-projective lifting", file=sys.stderr)
                    self._warned_skip = True
                continue
            acts, f, v = out
            s = min(len(acts), S)
            actions[i, :s] = acts[:s]
            feats[i, :s] = f[:s]
            valid[i, :s] = v[:s]
            step_mask[i, :s] = True
        with self._stats_lock:
            for key, count in batch_stats.items():
                self.oracle_stats[key] += count
        return {"actions": actions, "feats": feats, "valid": valid, "step_mask": step_mask}

    # ------------------------------------------------------------------
    def loss(self, inputs: Any, targets: Dict[str, Any], ctx: Context):
        logits = call(self.model, (inputs, targets["feats"]), ctx)
        masked = torch.where(targets["valid"], logits, NEG)
        logp = torch.log_softmax(masked.float(), dim=-1)
        actions = targets["actions"].long()
        ce = -logp.gather(-1, actions[..., None])[..., 0]
        mask_f = targets["step_mask"].float()
        denom = torch.clamp(mask_f.sum(), min=1.0)
        loss = (ce * mask_f).sum() / denom
        pred = masked.detach().argmax(-1)
        acc = ((pred == actions).float() * mask_f).sum() / denom
        return loss, {"parse_action_acc": acc}

    # ------------------------------------------------------------------
    def trunk_output(self, inputs: Any) -> Padded:
        if isinstance(inputs, Padded):
            if not self.listens:
                raise TypeError(f"{self.name} got the trunk's output but has its own tok2vec")
            return inputs
        return self.model.tok2vec(inputs)

    @property
    def graph_capturable(self) -> bool:
        """Greedy decodes are replayed as CUDA graphs when served; the beam
        runs eagerly."""
        return self.beam_width <= 1

    def decode_signature(self) -> Tuple[Any, ...]:
        return ("beam_width", self.beam_width, len(self.labels))

    def plan(self, N: int, T: int, device: torch.device, group: int = 1) -> ArcEagerPlan:
        """The decode's constants for N rows of T tokens, built once."""
        key = (N, T, group, str(device))
        if key not in self._plans:
            self._plans[key] = ArcEagerPlan(N, T, len(self.labels), device, group=group)
        return self._plans[key]

    def device_decode(self, X: torch.Tensor, lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device decode of trunk output X [B, T, D] with true lengths [B]:
        {"heads": [B, T], "labels": [B, T]}. No host synchronisation."""
        B, T = X.shape[:2]
        upper = self.model.upper
        if self.beam_width > 1:
            K = self.beam_width
            heads, labels = decode_parser_beam(upper, X, lengths, len(self.labels), K,
                                               self.plan(B * K, T, X.device, group=K))
        else:
            heads, labels = decode_parser(upper, X, lengths, len(self.labels),
                                          self.plan(B, T, X.device))
        return {"heads": heads, "labels": labels}

    def forward(self, inputs: Any, overlay: Optional[Dict[str, Any]] = None,
                ctx: Optional[Context] = None) -> Dict[str, torch.Tensor]:
        t2v = self.trunk_output(inputs)
        return self.device_decode(t2v.X, t2v.mask.sum(1))

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        heads = outputs["heads"].cpu().numpy()
        labels = outputs["labels"].cpu().numpy()
        for i, doc in enumerate(docs):
            n = lengths[i]
            doc.heads = [int(h) for h in heads[i, :n]]
            doc.deps = [self.labels[l] if self.labels else "dep" for l in labels[i, :n]]
            # undo the lifting before the ROOT rewrite erases the decorations
            if any(nonproj.is_decorated(d) for d in doc.deps):
                doc.heads, doc.deps = nonproj.deprojectivize(doc.heads, doc.deps)
            for j in range(n):
                if doc.heads[j] == j:
                    doc.deps[j] = "ROOT"

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        from ..scoring import score_deps

        return score_deps(examples)


@registry.factories("parser")
def make_parser(name: str, model: Dict[str, Any], beam_width: int = 1) -> ParserComponent:
    return ParserComponent(name, model, beam_width=beam_width)
