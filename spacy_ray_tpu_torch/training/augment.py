"""Data augmenters for the ``[corpora.train.augmenter]`` slot of
``spacy.Corpus.v1`` (counterpart of ``spacy_ray_tpu/training/augment.py``).

An augmenter is ``Example -> Iterator[Example]``, applied to the training
stream every epoch after the corpus's cache (``Corpus._augment``). Both are
spaCy's names and semantics: with probability ``level`` the variant replaces
the original, so an epoch keeps its size.

* ``spacy.lower_case.v1(level)``: a fully lower-cased copy.
* ``spacy.orth_variants.v1(level, lower, orth_variants)``: a copy with
  tokens swapped for spelling variants. ``orth_variants = {"single":
  [{"tags": [...], "variants": [...]}, ...], "paired": [{"tags": [...],
  "variants": [["``", "''"], ['"', '"']]}, ...]}``: a "single" group
  replaces a member token by another member; a "paired" group picks one
  target pair per doc and maps each matched token to the same position in
  it, a form that sits at both positions (the straight quote) alternating
  open and close by occurrence. Tag restrictions apply when given; with
  probability ``lower`` the copy is also lower-cased.

A copy is a fresh :class:`Example` over a deep copy of the gold doc with
only its words changed, so it keeps every gold annotation and none of the
original Example's caches (features, vector rows, targets, oracle). The
draws of ``random.Random(seed)`` come in the JAX package's order, so both
packages augment a stream alike, epoch after epoch.
"""

from __future__ import annotations

import copy
import random
from typing import Any, Callable, Dict, Iterator, List, Optional

from ..pipeline.doc import Doc, Example
from ..registry import registry


def _copy_with_words(doc: Doc, words: List[str]) -> Doc:
    new = copy.deepcopy(doc)
    new.words = list(words)
    return new


@registry.augmenters("spacy.lower_case.v1")
def create_lower_casing_augmenter(level: float = 0.3, seed: int = 0) -> Callable:
    rng = random.Random(seed)

    def augment(eg: Example) -> Iterator[Example]:
        if rng.random() < level:
            ref = eg.reference
            yield Example.from_gold(_copy_with_words(ref, [w.lower() for w in ref.words]))
        else:
            yield eg

    return augment


@registry.augmenters("spacy.orth_variants.v1")
def create_orth_variants_augmenter(
    level: float = 0.3,
    lower: float = 0.0,
    orth_variants: Optional[Dict[str, Any]] = None,
    seed: int = 0,
) -> Callable:
    singles = (orth_variants or {}).get("single", [])
    paired = (orth_variants or {}).get("paired", [])
    table: Dict[str, Any] = {}  # word -> (its variant group, tag restriction)
    for entry in singles:
        variants = entry.get("variants", [])
        tags = set(entry.get("tags", []))
        for v in variants:
            table[v] = (variants, tags)
    # word -> (positions it can take in a pair, the entry's pairs, tags)
    pair_table: Dict[str, Any] = {}
    for entry in paired:
        groups = entry.get("variants", [])
        tags = set(entry.get("tags", []))
        for group in groups:
            for pos, form in enumerate(group):
                if form in pair_table:
                    pair_table[form][0].add(pos)
                else:
                    pair_table[form] = ({pos}, groups, tags)
    rng = random.Random(seed)

    def augment(eg: Example) -> Iterator[Example]:
        if rng.random() >= level:
            yield eg
            return
        ref = eg.reference
        new_words = list(ref.words)
        changed = False
        chosen_pairs: Dict[int, List[str]] = {}  # id(pairs) -> this doc's target pair
        seen_count: Dict[str, int] = {}  # occurrences of a form at both positions
        for i, w in enumerate(new_words):
            hit = table.get(w)
            if hit is not None:
                variants, tags = hit
                if not tags or (ref.tags and ref.tags[i] in tags):
                    alt = [v for v in variants if v != w]
                    if alt:
                        new_words[i] = rng.choice(alt)
                        changed = True
                    continue
            phit = pair_table.get(w)
            if phit is not None:
                positions, groups, tags = phit
                if tags and (not ref.tags or ref.tags[i] not in tags):
                    continue
                if len(positions) == 1:
                    pos = next(iter(positions))
                else:  # 1st occurrence opens, 2nd closes, ...
                    n_seen = seen_count.get(w, 0)
                    seen_count[w] = n_seen + 1
                    pos = n_seen % 2
                # setdefault draws every time, as JAX's does: the same draws
                target = chosen_pairs.setdefault(id(groups), rng.choice(groups))
                if pos < len(target) and target[pos] != w:
                    new_words[i] = target[pos]
                    changed = True
        do_lower = rng.random() < lower
        if not changed and not do_lower:
            yield eg
            return
        doc = _copy_with_words(ref, new_words)
        if do_lower:
            doc.words = [w.lower() for w in doc.words]
        yield Example.from_gold(doc)

    return augment
