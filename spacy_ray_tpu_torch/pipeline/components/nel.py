"""``entity_linker``: link entity mentions to a knowledge base (counterpart
of ``spacy_ray_tpu/pipeline/components/nel.py``).

* Device: the model projects the trunk's vectors into the KB's
  entity-vector space ([B, T, D]); the loss pools each training mention as
  the mean over its tokens (a cumulative sum along T, gathered at its start
  and end) and scores its K padded candidates with one einsum, statically
  shaped [B, M, K, D], the mention axis M bucketed to a power of two.
* Host: candidate lookup in the KB (``pipeline/kb.py``) at collation and
  decode, the decode itself (argmax over a mention's candidates, NIL under
  ``threshold``) and the scores.

Training takes gold mentions whose gold entity is among the top-K
candidates by prior; with ``use_gold_ents = false``, the mentions an
annotating NER or entity ruler predicted onto ``eg.predicted``, supervised
by the gold entity at the same boundaries. Prediction links the
``doc.ents`` an earlier component set. The KB travels in a model directory
as the binary sidecar ``{name}.kb.npz``; the settings in
``components.json``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...models.core import Context, call
from ...registry import registry
from ...types import Padded
from ..doc import Doc, Example
from ..kb import KnowledgeBase
from .base import Component

NEG = -1e30


def _mention_text(doc: Doc, start: int, end: int) -> str:
    """The KB alias a mention is looked up by: its words, space-joined."""
    return " ".join(doc.words[start:end])


def _bucket_mentions(n: int) -> int:
    m = 2
    while m < n:
        m *= 2
    return m


def pool_mentions(X: torch.Tensor, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """The mean of X[b, s:e] for each mention: X [B, T, D], start and end
    [B, M] -> [B, M, D], through a cumulative sum along T gathered at both
    ends (an empty span counts as length 1)."""
    B, _, D = X.shape
    csz = torch.cat([X.new_zeros(B, 1, D), torch.cumsum(X, dim=1)], dim=1)  # [B, T+1, D]

    def take(idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(csz, 1, idx.long()[..., None].expand(-1, -1, D))

    total = take(end) - take(start)
    length = torch.clamp(end - start, min=1)[..., None].to(X.dtype)
    return total / length


class EntityLinkerComponent(Component):

    default_score_weights = {"nel_micro_f": 1.0, "nel_micro_p": 0.0, "nel_micro_r": 0.0}

    def __init__(self, name: str, model_cfg: Dict[str, Any], *, n_candidates: int = 8,
                 threshold: float = 0.0, use_prior: bool = True, use_gold_ents: bool = True,
                 kb_path: Optional[str] = None):
        super().__init__(name, model_cfg)
        self.n_candidates = int(n_candidates)
        self.threshold = float(threshold)
        self.use_prior = bool(use_prior)
        #: train on gold mentions, and let ``evaluate`` seed the prediction
        #: shells with gold boundaries; false: train on the mentions an
        #: annotating component predicted
        self.use_gold_ents = bool(use_gold_ents)
        #: read as given (not relative to the config), as the JAX package reads it
        self.kb_path = kb_path
        self.kb: Optional[KnowledgeBase] = None

    def set_kb(self, kb: KnowledgeBase) -> None:
        self.kb = kb

    def add_labels_from(self, examples) -> None:
        # no labels: initialize's label hook is where the KB loads
        if self.kb is None and self.kb_path:
            self.kb = KnowledgeBase.from_disk(self.kb_path)

    def build_model(self):
        if self.kb is None and self.kb_path:
            self.kb = KnowledgeBase.from_disk(self.kb_path)
        if self.kb is None:
            raise ValueError(
                f"entity_linker {self.name!r} has no knowledge base: set "
                "kb_path in [components." + self.name + "] or call set_kb() "
                "before initialize"
            )
        self.model_cfg = dict(self.model_cfg)
        self.model_cfg["nO"] = self.kb.entity_vector_length
        return super().build_model()

    # ----------------------------------------------------------- collate
    def _training_mentions(self, eg: Example) -> List[tuple]:
        """(start, end, gold kb_id) of each mention to train on: the gold
        entities, or with ``use_gold_ents = false`` the predicted ones, each
        with the kb_id of the gold entity at its boundaries ("" if none)."""
        if self.use_gold_ents:
            return [(s.start, s.end, s.kb_id) for s in eg.reference.ents]
        gold = {(s.start, s.end): s.kb_id for s in eg.reference.ents if s.kb_id}
        return [(s.start, s.end, gold.get((s.start, s.end), "")) for s in eg.predicted.ents]

    def make_targets(self, examples: List[Example], B: int, T: int) -> Dict[str, np.ndarray]:
        """Per doc the mentions with a kb_id inside T whose gold entity is
        among the alias's top-K candidates (the rest are skipped), padded to
        M, the next power of two >= the most mentions of a doc (>= 2)."""
        assert self.kb is not None
        K = self.n_candidates
        D = self.kb.entity_vector_length
        per_doc: List[List[tuple]] = []
        m_max = 1
        for eg in examples[:B]:
            rows = []
            for start, end, kb_id in self._training_mentions(eg):
                if not kb_id or end > T or end <= start:
                    continue
                cands = self.kb.candidates(_mention_text(eg.reference, start, end))[:K]
                gold = next((i for i, c in enumerate(cands) if c.entity == kb_id), None)
                if gold is None:
                    continue
                rows.append((start, end, gold, cands))
            per_doc.append(rows)
            m_max = max(m_max, len(rows))
        M = _bucket_mentions(m_max)
        m_start = np.zeros((B, M), np.int32)
        m_end = np.ones((B, M), np.int32)
        m_mask = np.zeros((B, M), bool)
        gold_idx = np.zeros((B, M), np.int32)
        cand_vecs = np.zeros((B, M, K, D), np.float32)
        cand_mask = np.zeros((B, M, K), bool)
        for i, rows in enumerate(per_doc):
            for j, (s, e, gold, cands) in enumerate(rows[:M]):
                m_start[i, j] = s
                m_end[i, j] = e
                m_mask[i, j] = True
                gold_idx[i, j] = gold
                for k, c in enumerate(cands):
                    cand_vecs[i, j, k] = c.vector
                    cand_mask[i, j, k] = True
        return {"nel_start": m_start, "nel_end": m_end, "nel_mask": m_mask,
                "nel_gold": gold_idx, "nel_cand_vecs": cand_vecs, "nel_cand_mask": cand_mask}

    # ------------------------------------------------------------ device
    def loss(self, inputs: Any, targets: Dict[str, Any], ctx: Context):
        """The mean NLL of the gold candidate over the real mentions, and
        ``nel_acc``, the share of them whose best candidate is the gold."""
        proj: Padded = call(self.model, inputs, ctx)
        X = proj.X.float()
        enc = pool_mentions(X, targets["nel_start"], targets["nel_end"])
        scores = torch.einsum("bmd,bmkd->bmk", enc, targets["nel_cand_vecs"].float())
        scores = torch.where(targets["nel_cand_mask"], scores, torch.full_like(scores, NEG))
        logp = torch.log_softmax(scores, dim=-1)
        gold = targets["nel_gold"].long()
        nll = -torch.gather(logp, -1, gold[..., None])[..., 0]
        mask = targets["nel_mask"].float()
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        acc = ((logp.detach().argmax(dim=-1) == gold).float() * mask).sum() / denom
        return loss, {"nel_acc": acc}

    # ------------------------------------------------------------- host
    def set_annotations(self, docs: List[Doc], outputs: Any, lengths: List[int]) -> None:
        """Each ``doc.ents`` span takes the mean of its projected rows; each
        candidate scores its dot product with it, plus log(prior + 1e-8)
        with ``use_prior``; the best is kept if its softmax probability is
        at least ``threshold``, else the span is NIL (``kb_id = ""``). The
        JAX loop's arithmetic, candidate by candidate."""
        assert self.kb is not None
        X = outputs.X.float().cpu().numpy()  # [B, T, D]
        for i, doc in enumerate(docs):
            L = lengths[i]
            for span in doc.ents:
                span.kb_id = ""
                if span.end > L or span.end <= span.start:
                    continue
                cands = self.kb.candidates(
                    _mention_text(doc, span.start, span.end))[:self.n_candidates]
                if not cands:
                    continue
                enc = X[i, span.start:span.end].mean(axis=0)
                scores = np.array([float(enc @ c.vector) for c in cands])
                if self.use_prior:
                    scores = scores + np.log(np.array([c.prior for c in cands]) + 1e-8)
                probs = np.exp(scores - scores.max())
                probs = probs / probs.sum()
                best = int(np.argmax(probs))
                if probs[best] >= self.threshold:
                    span.kb_id = cands[best].entity

    # ------------------------------------------------------- serialization
    def table_data(self) -> Dict[str, Any]:
        return {"n_candidates": self.n_candidates, "threshold": self.threshold,
                "use_prior": self.use_prior, "use_gold_ents": self.use_gold_ents}

    def load_table_data(self, data: Dict[str, Any]) -> None:
        self.n_candidates = int(data.get("n_candidates", self.n_candidates))
        self.threshold = float(data.get("threshold", self.threshold))
        self.use_prior = bool(data.get("use_prior", self.use_prior))
        self.use_gold_ents = bool(data.get("use_gold_ents", self.use_gold_ents))

    def save_binary(self, path, name: str) -> None:
        assert self.kb is not None
        self.kb.to_disk(Path(path) / f"{name}.kb.npz")

    def load_binary(self, path, name: str) -> None:
        kb_file = Path(path) / f"{name}.kb.npz"
        if kb_file.exists():
            self.kb = KnowledgeBase.from_disk(kb_file)

    def score(self, examples: List[Example]) -> Dict[str, float]:
        """Micro P/R/F over non-NIL links: a link is right when a predicted
        span with the gold span's boundaries carries its kb_id."""
        tp = fp = fn = 0
        for eg in examples:
            gold = {(s.start, s.end): s.kb_id for s in eg.reference.ents if s.kb_id}
            pred = {(s.start, s.end): s.kb_id for s in eg.predicted.ents if s.kb_id}
            for key, kb_id in pred.items():
                if gold.get(key) == kb_id:
                    tp += 1
                else:
                    fp += 1
            for key, kb_id in gold.items():
                if pred.get(key) != kb_id:
                    fn += 1
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f = 2 * p * r / (p + r) if p + r else 0.0
        return {"nel_micro_p": p, "nel_micro_r": r, "nel_micro_f": f, "nel_score": f}


@registry.factories("entity_linker")
def make_entity_linker(name: str, model: Dict[str, Any], n_candidates: int = 8,
                       threshold: float = 0.0, use_prior: bool = True,
                       use_gold_ents: bool = True,
                       kb_path: Optional[str] = None) -> EntityLinkerComponent:
    return EntityLinkerComponent(name, model, n_candidates=n_candidates, threshold=threshold,
                                 use_prior=use_prior, use_gold_ents=use_gold_ents,
                                 kb_path=kb_path)
