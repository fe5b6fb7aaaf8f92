"""Corpus readers: the ``@readers`` blocks of ``[corpora]``, callables that
yield :class:`Example` streams (counterpart of
``spacy_ray_tpu/training/corpus.py``).

``.jsonl`` files hold one doc per line: ``{"tokens": [...], "tags": [...],
"heads": [...], "deps": [...], "ents": [[start, end, label], ...], "spans":
{"group": [[s, e, label], ...]}, "cats": {...}}``. A line carries no
entity-annotation marker: a doc's ``ents_annotated`` stays None, so it
counts as annotated for the NER's scores exactly when it has entities (the
JAX reader's rule). A directory is read file by file in sorted order. The
binary corpora (``.spacy``, ``.msgdoc``) and ``.conllu`` are not ported yet
and raise.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Union

from ..pipeline.doc import Doc, Example, Span, doc_to_json
from ..registry import registry

CorpusReader = Callable[[], Iterator[Example]]
_NOT_PORTED = (".spacy", ".msgdoc", ".conllu")


def _doc_from_json(obj: dict) -> Doc:
    words = obj.get("tokens") or obj.get("words")
    if words is None:
        if obj.get("text") is not None:
            raise ValueError(
                "Corpus line has raw 'text' but no 'tokens': supervised corpora "
                "need tokenized, annotated lines"
            )
        raise ValueError(f"Corpus line missing 'tokens': keys={list(obj)}")
    doc = Doc(
        words=list(words),
        spaces=obj.get("spaces"),
        tags=obj.get("tags"),
        pos=obj.get("pos"),
        heads=obj.get("heads"),
        deps=obj.get("deps"),
        lemmas=obj.get("lemmas"),
        morphs=obj.get("morphs"),
        sent_starts=obj.get("sent_starts"),
        cats=dict(obj.get("cats") or {}),
    )
    for ent in obj.get("ents") or []:
        s, e, label = ent[0], ent[1], ent[2]
        kb_id = str(ent[3]) if len(ent) > 3 else ""
        doc.ents.append(Span(int(s), int(e), str(label), kb_id=kb_id))
    for group, spans in (obj.get("spans") or {}).items():
        doc.spans[group] = [Span(int(s), int(e), str(label)) for s, e, label in spans]
    return doc


#: the JSON schema of a corpus line is the parse output's
_doc_to_json = doc_to_json


def read_jsonl_docs(path: Union[str, Path]) -> Iterator[Doc]:
    with open(path, "r", encoding="utf8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield _doc_from_json(json.loads(line))


def _iter_path(path: Path) -> Iterator[Doc]:
    if path.is_dir():
        for sub in sorted(path.iterdir()):
            if sub.suffix == ".jsonl" or sub.suffix in _NOT_PORTED:
                yield from _iter_path(sub)
        return
    if path.suffix == ".jsonl":
        yield from read_jsonl_docs(path)
    elif path.suffix in _NOT_PORTED:
        raise NotImplementedError(
            f"{path}: {path.suffix} corpora are not ported yet; convert to .jsonl "
            "with the JAX package (python -m spacy_ray_tpu convert)"
        )
    else:
        raise ValueError(f"Unsupported corpus format: {path}")


class Corpus:
    """Config-constructed corpus: a callable yielding Example iterators.

    ``max_length`` splits longer docs on sentence starts (or in hard chunks);
    ``limit`` keeps the first N examples (after shuffling); ``shuffle``
    orders each epoch by ``random.Random(seed + epoch)``; ``cache`` (default)
    reads the files once and yields the same Example objects every epoch.
    """

    def __init__(self, path: Union[str, Path], *, max_length: int = 0, limit: int = 0,
                 shuffle: bool = False, seed: int = 0, cache: bool = True):
        self.path = Path(path)
        self.max_length = max_length
        self.limit = limit
        self.shuffle = shuffle
        self.seed = seed
        self.cache = cache
        self._examples: Optional[List[Example]] = None
        self._epoch = 0

    def _split(self, doc: Doc) -> Iterator[Doc]:
        if self.max_length <= 0 or len(doc) <= self.max_length:
            yield doc
            return
        bounds: List[int] = [0]
        if doc.sent_starts:
            for i, s in enumerate(doc.sent_starts):
                if s == 1 and i > 0:
                    bounds.append(i)
        else:
            bounds.extend(range(self.max_length, len(doc), self.max_length))
        bounds.append(len(doc))
        for a, b in zip(bounds, bounds[1:]):
            if b <= a:
                continue
            piece = Doc(
                words=doc.words[a:b],
                spaces=doc.spaces[a:b] if doc.spaces else None,
                tags=doc.tags[a:b] if doc.tags else None,
                pos=doc.pos[a:b] if doc.pos else None,
                # a head outside the slice becomes a root (head == self)
                heads=[h - a if a <= h < b else i for i, h in enumerate(doc.heads[a:b])]
                if doc.heads else None,
                deps=doc.deps[a:b] if doc.deps else None,
                lemmas=doc.lemmas[a:b] if doc.lemmas else None,
                morphs=doc.morphs[a:b] if doc.morphs else None,
                sent_starts=doc.sent_starts[a:b] if doc.sent_starts else None,
                cats=dict(doc.cats),
            )
            for span in doc.ents:
                if span.start >= a and span.end <= b:
                    piece.ents.append(Span(span.start - a, span.end - a, span.label))
            for g, spans in doc.spans.items():
                kept = [Span(s.start - a, s.end - a, s.label)
                        for s in spans if s.start >= a and s.end <= b]
                if kept:
                    piece.spans[g] = kept
            yield piece

    def _read_examples(self) -> Iterator[Example]:
        for doc in _iter_path(self.path):
            for piece in self._split(doc):
                if len(piece) == 0:
                    continue
                yield Example.from_gold(piece)

    def __call__(self) -> Iterator[Example]:
        # limit applies after shuffling: each shuffled epoch takes a fresh subset
        if not self.cache and not self.shuffle:
            n = 0
            for eg in self._read_examples():
                yield eg
                n += 1
                if self.limit and n >= self.limit:
                    return
            return
        if self.cache:
            if self._examples is None:
                self._examples = list(self._read_examples())
            examples: List[Example] = self._examples
        else:
            examples = list(self._read_examples())
        if self.shuffle:
            order = list(range(len(examples)))
            random.Random(self.seed + self._epoch).shuffle(order)
            self._epoch += 1
            examples = [examples[i] for i in order]
        if self.limit:
            examples = examples[: self.limit]
        yield from examples


@registry.readers("spacy.Corpus.v1")
def create_corpus(
    path: Optional[str] = None,
    max_length: int = 0,
    gold_preproc: bool = False,
    limit: int = 0,
    augmenter: Optional[Callable] = None,
    shuffle: bool = False,
    seed: int = 0,
    cache: bool = True,
) -> Corpus:
    if path is None:
        raise ValueError("Corpus path is required (set [paths.train]/[paths.dev])")
    if augmenter is not None:
        raise NotImplementedError("corpus augmenters are not ported yet")
    return Corpus(path, max_length=max_length, limit=limit, shuffle=shuffle, seed=seed,
                  cache=cache)


@registry.readers("spacy.JsonlCorpus.v1")
def create_jsonl_corpus(
    path: Optional[str] = None,
    min_length: int = 0,
    max_length: int = 0,
    limit: int = 0,
    shuffle: bool = False,
    seed: int = 0,
    cache: bool = True,
) -> Corpus:
    if path is None:
        raise ValueError("JsonlCorpus path is required")
    return Corpus(path, max_length=max_length, limit=limit, shuffle=shuffle, seed=seed,
                  cache=cache)
