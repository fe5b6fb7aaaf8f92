"""Scores of predicted against gold annotations (the part of
``spacy_ray_tpu/pipeline/scoring.py`` the tagger needs)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .doc import Doc, Example


def score_token_acc(
    examples: Sequence[Example],
    key: str,
    getter: Callable[[Doc], Optional[List[str]]],
) -> Dict[str, Optional[float]]:
    """Token-level accuracy; positions with missing (falsy) gold are left out
    of the denominator; ``None`` when no gold annotation exists anywhere
    (spaCy ``Scorer.score_token_attr``)."""
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
