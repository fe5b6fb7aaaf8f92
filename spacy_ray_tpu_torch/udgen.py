"""Seeded pseudo-UD corpus (a copy of ``spacy_ray_tpu/udgen.py``; the same
seed gives the same corpus in both packages).

* A zipfian vocabulary of about 2.4k word types, surface forms built from
  stable per-type syllables.
* Systematic morphology: plural nouns take ``-s`` and tag NNS; past verbs
  ``-ed`` and VBD (3sg ``-s`` and VBZ otherwise); the lemma is the stem.
* Grammar: a root verb with subject and object noun phrases (det, 0-2
  adjectives, noun), optional PP (case + nmod) and advmod, and a
  sentence-final punct.
* About 7% of sentences put the subject's PP after the object: a crossing
  arc, the case pseudo-projective lifting exists for.
* Rare labels: a ``vocative`` dep (~0.7% of sentences) and a
  ``WORK_OF_ART`` entity (~3% of mentions).
* Documents of 1-6 sentences (up to ~120 tokens) with ``sent_starts``, and
  entities over PROPN mentions, each mention type with a fixed label.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Tuple

from .pipeline.doc import Doc, Example, Span, doc_to_json

_CONS = ["b", "d", "f", "g", "k", "l", "m", "n", "p", "r", "s", "t", "v", "z"]
_VOW = ["a", "e", "i", "o", "u"]


def _make_stem(type_id: int, n_syll: int) -> str:
    """Stable surface stem for a word-type id."""
    rng = random.Random(0xC0FFEE ^ type_id)
    return "".join(
        rng.choice(_CONS) + rng.choice(_VOW) for _ in range(n_syll)
    )


class _Lexicon:
    """Per-POS zipfian lexicons, fixed given the generator seed."""

    def __init__(self, rng: random.Random):
        def types(n: int, n_syll: int, prefix: int) -> List[str]:
            return [_make_stem(prefix * 100000 + i, n_syll) for i in range(n)]

        self.nouns = types(800, 2, 1)
        self.verbs = types(600, 2, 2)
        self.adjs = types(400, 2, 3)
        self.advs = types(200, 3, 4)
        self.dets = ["the", "a", "this", "that", "every"]
        self.adps = ["in", "on", "under", "near", "with", "from"]
        # proper nouns: two-word mentions; each mention type has a FIXED
        # entity label so the mapping is learnable
        self.propn: List[Tuple[List[str], str]] = []
        ent_labels = ["PERSON", "ORG", "GPE"]
        for i in range(120):
            first = _make_stem(500000 + i, 2).capitalize()
            second = _make_stem(600000 + i, 2).capitalize()
            # a rare WORK_OF_ART tail: one head-rank type (so the label
            # actually OCCURS, ~2-3% of mentions) plus a thin random tail
            if i == 7 or rng.random() < 0.02:
                label = "WORK_OF_ART"
            else:
                label = rng.choice(ent_labels)
            self.propn.append(([first, second], label))
        self._cums: Dict[int, List[float]] = {}

    def zipf(self, rng: random.Random, items: List[str]) -> str:
        """Pick with p ∝ 1/(rank+1) — exact zipf(s=1) via the harmonic
        cumulative distribution (cached per lexicon size)."""
        import bisect

        n = len(items)
        cum = self._cums.get(n)
        if cum is None:
            total = 0.0
            cum = []
            for r in range(n):
                total += 1.0 / (r + 1)
                cum.append(total)
            self._cums[n] = cum
        x = rng.random() * cum[-1]
        return items[bisect.bisect_left(cum, x)]


class _Sent:
    def __init__(self) -> None:
        self.words: List[str] = []
        self.tags: List[str] = []
        self.pos: List[str] = []
        self.heads: List[int] = []
        self.deps: List[str] = []
        self.lemmas: List[str] = []
        self.morphs: List[str] = []
        self.ents: List[Tuple[int, int, str]] = []

    def emit(
        self, word: str, tag: str, pos: str, dep: str, lemma: str, morph: str,
        head: int = -1,
    ) -> int:
        i = len(self.words)
        self.words.append(word)
        self.tags.append(tag)
        self.pos.append(pos)
        self.heads.append(head)
        self.deps.append(dep)
        self.lemmas.append(lemma)
        self.morphs.append(morph)
        return i


def _noun(rng: random.Random, lex: _Lexicon, s: _Sent, head_slot: int, dep: str) -> int:
    """det + adjs + noun (or a PROPN entity mention); returns the head index."""
    if rng.random() < 0.18:
        mention, label = lex.zipf(rng, lex.propn)
        start = len(s.words)
        idxs = [
            s.emit(w, "NNP", "PROPN", "compound" if k < len(mention) - 1 else dep,
                   w, "Number=Sing")
            for k, w in enumerate(mention)
        ]
        for k in idxs[:-1]:
            s.heads[k] = idxs[-1]
        s.heads[idxs[-1]] = head_slot
        s.ents.append((start, len(s.words), label))
        return idxs[-1]
    det = rng.choice(lex.dets)
    di = s.emit(det, "DT", "DET", "det", det, "")
    adj_idx = []
    for _ in range(rng.choice([0, 0, 0, 1, 1, 2])):
        a = lex.zipf(rng, lex.adjs)
        adj_idx.append(s.emit(a, "JJ", "ADJ", "amod", a, "Degree=Pos"))
    plural = rng.random() < 0.35
    stem = lex.zipf(rng, lex.nouns)
    ni = s.emit(
        stem + ("s" if plural else ""),
        "NNS" if plural else "NN",
        "NOUN",
        dep,
        stem,
        "Number=Plur" if plural else "Number=Sing",
        head=head_slot,
    )
    s.heads[di] = ni
    for k in adj_idx:
        s.heads[k] = ni
    return ni


def _pp(rng: random.Random, lex: _Lexicon, s: _Sent, attach_to: int) -> Tuple[int, int]:
    """case + nmod noun phrase attached to ``attach_to``; returns the token
    span (start, end) of the PP for extraposition bookkeeping."""
    start = len(s.words)
    adp = rng.choice(lex.adps)
    ci = s.emit(adp, "IN", "ADP", "case", adp, "")
    ni = _noun(rng, lex, s, attach_to, "nmod")
    s.heads[ci] = ni
    return start, len(s.words)


def _sentence(rng: random.Random, lex: _Lexicon, s: _Sent) -> None:
    """Append one sentence's tokens to ``s`` (indices are sentence-local
    until the caller rebases)."""
    base = len(s.words)
    # optional rare vocative opener
    if rng.random() < 0.007:
        mention, _label = lex.propn[rng.randrange(len(lex.propn))]
        # head=-2: patched to the clause root once it exists (UD vocative)
        vi = s.emit(mention[0], "NNP", "PROPN", "vocative", mention[0], "", head=-2)
        s.emit(",", ",", "PUNCT", "punct", ",", "", head=vi)
    extrapose = rng.random() < 0.07
    subj = _noun(rng, lex, s, -2, "nsubj")  # head patched to root below
    if not extrapose and rng.random() < 0.25:
        _pp(rng, lex, s, subj)
    third_sg = s.morphs[subj] == "Number=Sing"
    past = rng.random() < 0.5
    stem = lex.zipf(rng, lex.verbs)
    if past:
        form, tag, morph = stem + "ed", "VBD", "Tense=Past"
    elif third_sg:
        form, tag, morph = stem + "s", "VBZ", "Number=Sing|Person=3|Tense=Pres"
    else:
        form, tag, morph = stem, "VBP", "Tense=Pres"
    root = s.emit(form, tag, "VERB", "ROOT", stem, morph)
    s.heads[root] = root
    for i in range(base, root):
        if s.heads[i] == -2:
            s.heads[i] = root
    if rng.random() < 0.3:
        a = lex.zipf(rng, lex.advs)
        s.heads[s.emit(a, "RB", "ADV", "advmod", a, "")] = root
    _noun(rng, lex, s, root, "obj")
    if extrapose:
        # PP attached to the SUBJECT noun but positioned after the object:
        # root and obj sit inside the subject subtree's span without being
        # its descendants — non-projective
        _pp(rng, lex, s, subj)
    elif rng.random() < 0.2:
        _pp(rng, lex, s, root)
    s.heads[s.emit(".", ".", "PUNCT", "punct", ".", "")] = root


def synth_ud_doc(rng: random.Random, lex: _Lexicon, max_sents: int = 6) -> Doc:
    s = _Sent()
    sent_bounds: List[int] = []
    for _ in range(rng.randint(1, max_sents)):
        sent_bounds.append(len(s.words))
        _sentence(rng, lex, s)
    n = len(s.words)
    sent_starts = [-1] * n
    for b in sent_bounds:
        sent_starts[b] = 1
    doc = Doc(
        words=s.words,
        tags=s.tags,
        pos=s.pos,
        heads=s.heads,
        deps=s.deps,
        lemmas=s.lemmas,
        morphs=s.morphs,
        sent_starts=sent_starts,
        ents=[Span(a, b, label) for a, b, label in s.ents],
        ents_annotated=True,
    )
    return doc


def synth_ud_corpus(n_docs: int, seed: int = 0, max_sents: int = 6) -> List[Example]:
    """Deterministic pseudo-UD corpus (see module docstring)."""
    rng = random.Random(seed)
    lex = _Lexicon(random.Random(1234))  # lexicon fixed across seeds
    return [
        Example.from_gold(synth_ud_doc(rng, lex, max_sents=max_sents))
        for _ in range(n_docs)
    ]


def write_ud_jsonl(path, n_docs: int, seed: int = 0, max_sents: int = 6) -> None:
    """``n_docs`` docs of :func:`synth_ud_corpus` as a .jsonl corpus."""
    with open(path, "w", encoding="utf8") as f:
        for eg in synth_ud_corpus(n_docs, seed=seed, max_sents=max_sents):
            f.write(json.dumps(doc_to_json(eg.reference)) + "\n")
