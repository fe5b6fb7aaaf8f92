"""Synthetic corpora (copies of the generators of ``spacy_ray_tpu/util.py``;
the pseudo-UD corpus with trees is ``udgen.py``): tagged docs whose tags
follow from the words, NER docs of entity phrases between filler words,
topical docs for text classification, and NER docs whose entities are
spancat gold in ``doc.spans["sc"]``. With the same seed both packages write
the same corpus, byte for byte."""

from __future__ import annotations

import json
import random
from typing import List

from .pipeline.doc import Doc, Example, Span, doc_to_json

_POS_VOCAB = {
    "DET": ["the", "a", "an", "this", "that"],
    "NOUN": ["cat", "dog", "tree", "market", "chip", "tensor", "mesh", "house"],
    "VERB": ["runs", "jumps", "compiles", "shards", "eats", "sees", "builds"],
    "ADJ": ["green", "fast", "large", "tiny", "sharded", "parallel"],
    "ADV": ["quickly", "slowly", "very", "almost"],
    "PROPN": ["Alice", "Bob", "Jax", "Pallas", "Austin", "Tokyo"],
    "ADP": ["in", "on", "under", "over", "with"],
    "PRON": ["he", "she", "it", "they", "we"],
}

_ENT_LABELS = {
    "PERSON": ["Alice Smith", "Bob Jones", "Carol White"],
    "ORG": ["Acme Corp", "Globex Inc", "Initech LLC"],
    "GPE": ["Austin", "Tokyo", "Berlin", "Paris"],
}

_TOPICAL = {
    "SPORTS": ["game", "team", "score", "win", "league", "ball"],
    "TECH": ["chip", "tensor", "compile", "code", "mesh", "kernel"],
    "FOOD": ["eat", "ham", "eggs", "bake", "sauce", "dish"],
}


def synth_tagged_doc(rng: random.Random, min_len: int = 4, max_len: int = 24) -> Doc:
    """A doc of ``min_len``..``max_len`` words whose tags follow from the words."""
    n = rng.randint(min_len, max_len)
    words: List[str] = []
    tags: List[str] = []
    pos_names = list(_POS_VOCAB)
    for _ in range(n):
        pos = rng.choice(pos_names)
        words.append(rng.choice(_POS_VOCAB[pos]))
        tags.append(pos)
    return Doc(words=words, tags=tags, pos=list(tags))


def synth_ner_doc(rng: random.Random, min_len: int = 5, max_len: int = 24) -> Doc:
    """2-6 chunks, each an entity phrase (0.4) or 1-4 filler words."""
    words: List[str] = []
    ents: List[Span] = []
    for _ in range(rng.randint(2, 6)):
        if rng.random() < 0.4:
            label = rng.choice(list(_ENT_LABELS))
            ent_words = rng.choice(_ENT_LABELS[label]).split()
            start = len(words)
            words.extend(ent_words)
            ents.append(Span(start, len(words), label))
        else:
            for _ in range(rng.randint(1, 4)):
                pos = rng.choice(list(_POS_VOCAB))
                words.append(rng.choice(_POS_VOCAB[pos]))
    doc = Doc(words=words)
    doc.ents = ents
    return doc


def synth_textcat_doc(rng: random.Random) -> Doc:
    """5-15 words of one topic, the topic's cat 1.0 and the others 0.0."""
    label = rng.choice(["SPORTS", "TECH", "FOOD"])
    words = [rng.choice(_TOPICAL[label]) for _ in range(rng.randint(5, 15))]
    rng.shuffle(words)
    doc = Doc(words=words)
    doc.cats = {k: (1.0 if k == label else 0.0) for k in _TOPICAL}
    return doc


def synth_spancat_doc(rng: random.Random) -> Doc:
    """An NER doc whose entity spans are spancat gold in ``doc.spans["sc"]``."""
    doc = synth_ner_doc(rng)
    doc.spans["sc"] = list(doc.ents)
    doc.ents = []
    return doc


_MAKERS = {
    "tagger": synth_tagged_doc,
    "ner": synth_ner_doc,
    "textcat": synth_textcat_doc,
    "spancat": synth_spancat_doc,
}


def synth_corpus(n_docs: int, kind: str = "tagger", seed: int = 0) -> List[Example]:
    """``n_docs`` gold Examples of ``kind`` from ``random.Random(seed)``."""
    rng = random.Random(seed)
    maker = _MAKERS[kind]
    return [Example.from_gold(maker(rng)) for _ in range(n_docs)]


def write_synth_jsonl(path, n_docs: int, kind: str = "tagger", seed: int = 0,
                      min_len: int = 4, max_len: int = 24) -> None:
    """``n_docs`` docs of ``kind`` from ``random.Random(seed)`` as a .jsonl
    corpus; ``min_len`` and ``max_len`` bound a tagged doc's length."""
    rng = random.Random(seed)
    with open(path, "w", encoding="utf8") as f:
        for _ in range(n_docs):
            doc = (synth_tagged_doc(rng, min_len, max_len) if kind == "tagger"
                   else _MAKERS[kind](rng))
            f.write(json.dumps(doc_to_json(doc)) + "\n")
