"""Scores of predicted against gold annotations, with spaCy's Scorer
conventions (the part of ``spacy_ray_tpu/pipeline/scoring.py`` the
trainable components need):

* zero division gives 0.0 inside a PRF, but no gold annotation at all gives
  ``None`` for the key, so the weighted score leaves it out;
* span scoring skips docs without gold annotation; per-type PRF sits beside
  the micro scores;
* dependency scoring leaves out tokens labelled ``p``/``punct`` and compares
  labels lowercased;
* a sentence is right only when both its start and its end are;
* ``morph_per_feat`` scores each UD feature apart; a text classifier's
  macro AUC is the rank statistic with ties counted half, undefined (None)
  for a label with one gold class.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .doc import Doc, Example, Span


class PRF:
    """tp/fp/fn accumulator with spaCy PRFScore's zero-division → 0.0."""

    __slots__ = ("tp", "fp", "fn")

    def __init__(self) -> None:
        self.tp = 0
        self.fp = 0
        self.fn = 0

    @property
    def precision(self) -> float:
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def recall(self) -> float:
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def fscore(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    def score_sets(self, pred: set, gold: set) -> None:
        self.tp += len(pred & gold)
        self.fp += len(pred - gold)
        self.fn += len(gold - pred)

    def to_dict(self) -> Dict[str, float]:
        return {"p": self.precision, "r": self.recall, "f": self.fscore}


def score_spans(
    examples: Sequence[Example],
    prefix: str,
    getter: Callable[[Doc], Iterable[Span]],
    has_annotation: Callable[[Doc], bool],
    labeled: bool = True,
) -> Dict[str, object]:
    """Micro + per-type PRF over (start, end[, label]) exact matches.

    Keys: ``{prefix}_p/r/f`` (None when NO gold doc has the annotation)
    and ``{prefix}_per_type`` ({label: {p, r, f}}). Docs where
    ``has_annotation(gold)`` is False are skipped entirely (their
    predictions are neither correct nor false positives) — spaCy
    ``Scorer.score_spans`` semantics."""
    micro = PRF()
    per_type: Dict[str, PRF] = {}
    any_annotation = False
    for eg in examples:
        if not has_annotation(eg.reference):
            continue
        any_annotation = True
        gold = {
            (s.start, s.end, s.label if labeled else "")
            for s in getter(eg.reference)
        }
        pred = {
            (s.start, s.end, s.label if labeled else "")
            for s in getter(eg.predicted)
        }
        micro.score_sets(pred, gold)
        labels = {t[2] for t in gold | pred}
        for label in labels:
            bucket = per_type.setdefault(label, PRF())
            bucket.score_sets(
                {t for t in pred if t[2] == label},
                {t for t in gold if t[2] == label},
            )
    if not any_annotation:
        out: Dict[str, object] = {
            f"{prefix}_p": None,
            f"{prefix}_r": None,
            f"{prefix}_f": None,
        }
        if labeled:
            out[f"{prefix}_per_type"] = None
        return out
    out = {
        f"{prefix}_p": micro.precision,
        f"{prefix}_r": micro.recall,
        f"{prefix}_f": micro.fscore,
    }
    if labeled:
        out[f"{prefix}_per_type"] = {
            label: prf.to_dict() for label, prf in sorted(per_type.items())
        }
        # flat aliases so [training.score_weights] and the console logger
        # can address per-type scores without nested lookups
        for label, prf in per_type.items():
            out[f"{prefix}_f_{label}"] = prf.fscore
    return out


def score_token_acc(
    examples: Sequence[Example],
    key: str,
    getter: Callable[[Doc], Optional[List[str]]],
) -> Dict[str, Optional[float]]:
    """Token-level accuracy; positions with missing (falsy) gold are
    excluded from the denominator; ``None`` when no gold annotation exists
    anywhere (spaCy ``Scorer.score_token_attr``)."""
    correct = 0
    total = 0
    for eg in examples:
        gold = getter(eg.reference) or []
        pred = getter(eg.predicted) or []
        for i, g in enumerate(gold):
            if not g:
                continue
            total += 1
            if i < len(pred) and pred[i] == g:
                correct += 1
    if total == 0:
        return {key: None}
    return {key: correct / total}


DEP_IGNORE_LABELS = ("p", "punct")


def score_deps(
    examples: Sequence[Example],
    ignore_labels: Tuple[str, ...] = DEP_IGNORE_LABELS,
) -> Dict[str, Optional[float]]:
    """UAS/LAS with spaCy's ``score_deps`` conventions: each side drops
    tokens whose OWN dep label lowercases into ``ignore_labels`` (gold set
    by gold label, pred set by predicted label — a gold-punct token
    mis-predicted as ``nsubj`` IS a false positive); labels compare
    lowercased; the unlabeled (UAS) sets are the labeled sets minus the
    label field; ``None`` when no doc has gold heads."""
    unlabeled = PRF()
    labeled = PRF()
    per_dep: Dict[str, PRF] = {}
    any_annotation = False
    for eg in examples:
        gold_heads = eg.reference.heads
        if not gold_heads:
            continue
        any_annotation = True
        gold_deps = eg.reference.deps or [""] * len(gold_heads)
        pred_heads = eg.predicted.heads or []
        pred_deps = eg.predicted.deps or [""] * len(pred_heads)
        gold_l = set()
        for i, (h, d) in enumerate(zip(gold_heads, gold_deps)):
            d = (d or "").lower()
            if d in ignore_labels:
                continue
            gold_l.add((i, h, d))
        pred_l = set()
        for i, h in enumerate(pred_heads):
            if i >= len(gold_heads):
                break
            d = (pred_deps[i] if i < len(pred_deps) else "") or ""
            d = d.lower()
            if d in ignore_labels:
                continue
            pred_l.add((i, h, d))
        labeled.score_sets(pred_l, gold_l)
        unlabeled.score_sets(
            {t[:2] for t in pred_l}, {t[:2] for t in gold_l}
        )
        for dep in {t[2] for t in gold_l | pred_l}:
            bucket = per_dep.setdefault(dep, PRF())
            bucket.score_sets(
                {t for t in pred_l if t[2] == dep},
                {t for t in gold_l if t[2] == dep},
            )
    if not any_annotation:
        return {"dep_uas": None, "dep_las": None, "dep_las_per_type": None}
    return {
        "dep_uas": unlabeled.fscore,
        "dep_las": labeled.fscore,
        "dep_las_per_type": {
            dep: prf.to_dict() for dep, prf in sorted(per_dep.items())
        },
    }


def sentence_spans(sent_starts: Optional[List[int]], n: int) -> List[Span]:
    """Sentence (start, end) spans from per-token 1/-1/0 markers. Token 0
    always opens a sentence (spaCy's Doc.sents convention)."""
    if not sent_starts or n == 0:
        return []
    starts = [0] + [i for i in range(1, min(n, len(sent_starts))) if sent_starts[i] == 1]
    starts = sorted(set(starts))
    ends = starts[1:] + [n]
    return [Span(s, e, "") for s, e in zip(starts, ends)]


def score_sents(examples: Sequence[Example]) -> Dict[str, Optional[float]]:
    """``sents_p/r/f`` over whole sentence spans — both boundaries must be
    right (spaCy scores sentences via ``score_spans(examples, "sents")``,
    NOT per boundary token)."""
    return {
        k.replace("sents_spans", "sents"): v
        for k, v in score_spans(
            examples,
            "sents_spans",
            lambda d: sentence_spans(d.sent_starts, len(d)),
            has_annotation=lambda d: bool(d.sent_starts)
            and any(v != 0 for v in d.sent_starts),
            labeled=False,
        ).items()
    }


def parse_feats(morph: str) -> Dict[str, str]:
    """'Number=Sing|Person=3' -> {'Number': 'Sing', 'Person': '3'}."""
    out: Dict[str, str] = {}
    if not morph:
        return out
    for part in morph.split("|"):
        k, _, v = part.partition("=")
        if k:
            out[k] = v
    return out


def score_morph_per_feat(examples: Sequence[Example]) -> Dict[str, object]:
    """spaCy's ``morph_per_feat``: a PRF per UD feature over the tokens with
    gold morphs; None when no token has any."""
    per_feat: Dict[str, PRF] = {}
    any_annotation = False
    for eg in examples:
        gold_morphs = eg.reference.morphs or []
        pred_morphs = eg.predicted.morphs or []
        for i, gm in enumerate(gold_morphs):
            if not gm:
                continue
            any_annotation = True
            gold_feats = parse_feats(gm)
            pred_feats = parse_feats(pred_morphs[i] if i < len(pred_morphs) else "")
            for feat in set(gold_feats) | set(pred_feats):
                prf = per_feat.setdefault(feat, PRF())
                gset = {(i, feat, gold_feats[feat])} if feat in gold_feats else set()
                pset = {(i, feat, pred_feats[feat])} if feat in pred_feats else set()
                prf.score_sets(pset, gset)
    if not any_annotation:
        return {"morph_per_feat": None}
    return {"morph_per_feat": {feat: prf.to_dict() for feat, prf in sorted(per_feat.items())}}


def rank_auc(gold: List[int], scores: List[float]) -> Optional[float]:
    """ROC AUC as the rank statistic (Mann-Whitney U): the chance that a
    random positive outscores a random negative, ties counted half; None
    when only one class is present."""
    pos = [s for g, s in zip(gold, scores) if g]
    neg = [s for g, s in zip(gold, scores) if not g]
    if not pos or not neg:
        return None
    wins = 0.0
    for ps in pos:
        for ns in neg:
            if ps > ns:
                wins += 1.0
            elif ps == ns:
                wins += 0.5
    return wins / (len(pos) * len(neg))
