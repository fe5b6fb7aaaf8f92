"""Synthetic tagged corpora (a copy of the tagger rule of
``spacy_ray_tpu/util.py``): each word is drawn from one part of speech's
vocabulary, and its tag is that part of speech, so the tags are learnable
from the words alone. With the same seed and lengths both packages write the
same corpus."""

from __future__ import annotations

import json
import random
from typing import List

from .pipeline.doc import Doc, doc_to_json

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


def write_synth_jsonl(path, n_docs: int, seed: int = 0, min_len: int = 4,
                      max_len: int = 24) -> None:
    """``n_docs`` tagged docs from ``random.Random(seed)`` as a .jsonl corpus."""
    rng = random.Random(seed)
    with open(path, "w", encoding="utf8") as f:
        for _ in range(n_docs):
            f.write(json.dumps(doc_to_json(synth_tagged_doc(rng, min_len, max_len))) + "\n")
