"""Corpus readers: the ``@readers`` blocks of ``[corpora]``, callables that
yield :class:`Example` streams (counterpart of
``spacy_ray_tpu/training/corpus.py``).

Formats, by suffix (a directory is read file by file in sorted order):

* ``.spacy``: spaCy's DocBin, what ``spacy convert`` writes
  (``training/spacy_docbin.py``); a gzip file under this suffix is read as
  ``.msgdoc``, as the JAX package does;
* ``.msgdoc``: the JAX package's DocBin, gzip'd JSON lines of the ``.jsonl``
  schema (:class:`DocBin`);
* ``.jsonl``: one doc per line: ``{"tokens": [...], "tags": [...], "heads":
  [...], "deps": [...], "ents": [[start, end, label], ...], "spans":
  {"group": [[s, e, label], ...]}, "cats": {...}}``;
* ``.conllu``: Universal Dependencies (FORM, UPOS, XPOS, FEATS, HEAD,
  DEPREL; multiword and empty nodes skipped).

A ``.spacy`` doc carries its entity-annotation marker (``ents_annotated``:
any ENT_IOB set); a JSON line carries none, so such a doc counts as
annotated for the NER's scores exactly when it has entities (the JAX
reader's rule).

A raw-text line (``{"text": ...}``, no tokens) is read only inside
:func:`use_raw_text_tokenizer`, with the pipeline's tokenizer; ``pretrain``
runs in it. Elsewhere such a line raises. ``spacy.Corpus.v1`` takes an
``augmenter`` (``training/augment.py``), applied per epoch after the cache.
"""

from __future__ import annotations

import gzip
import json
import random
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Union

from ..pipeline.doc import Doc, Example, Span, doc_to_json
from ..registry import registry
from . import augment  # noqa: F401  (registers the augmenters)
from .spacy_docbin import read_docbin

CorpusReader = Callable[[], Iterator[Example]]
SUFFIXES = (".jsonl", ".conllu", ".msgdoc", ".spacy")


_raw_text_tokenizer: Optional[Callable[[str], Doc]] = None


@contextmanager
def use_raw_text_tokenizer(tokenizer: Callable[[str], Doc]) -> Iterator[None]:
    """Read raw-text corpus lines with ``tokenizer`` (the pipeline's) inside
    this context; outside it a raw-text line in a supervised corpus stays an
    error, as training on annotation-free docs would train on nothing."""
    global _raw_text_tokenizer
    prev = _raw_text_tokenizer
    _raw_text_tokenizer = tokenizer
    try:
        yield
    finally:
        _raw_text_tokenizer = prev


def _doc_from_json(obj: dict) -> Doc:
    words = obj.get("tokens") or obj.get("words")
    if words is None:
        text = obj.get("text")
        if text is not None and _raw_text_tokenizer is not None:
            return _raw_text_tokenizer(text)
        if text is not None:
            raise ValueError(
                "Corpus line has raw 'text' but no 'tokens': raw-text lines "
                "are only readable under a pretraining run (use the "
                "`pretrain` command); supervised corpora need tokenized, "
                "annotated lines"
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


def read_conllu_docs(path: Union[str, Path]) -> Iterator[Doc]:
    """Docs of a CoNLL-U file: a root's head is itself, a missing XPOS
    falls back to the UPOS, a missing DEPREL to ``dep``."""
    rows: List[List[str]] = []

    def flush() -> Optional[Doc]:
        if not rows:
            return None
        heads = []
        for i, cols in enumerate(rows):
            head = int(cols[6]) if cols[6] != "_" else 0
            heads.append(head - 1 if head > 0 else i)
        doc = Doc(words=[c[1] for c in rows], pos=[c[3] for c in rows],
                  tags=[c[4] if c[4] != "_" else c[3] for c in rows],
                  heads=heads, deps=[c[7] if c[7] != "_" else "dep" for c in rows],
                  morphs=[c[5] if c[5] != "_" else "" for c in rows])
        rows.clear()
        return doc

    with open(path, "r", encoding="utf8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                doc = flush()
                if doc:
                    yield doc
                continue
            if line.startswith("#"):
                continue
            cols = line.split("\t")
            if "-" in cols[0] or "." in cols[0]:
                continue  # multiword tokens and empty nodes
            rows.append(cols)
    doc = flush()
    if doc:
        yield doc


class DocBin:
    """The JAX package's ``.msgdoc`` collection: gzip'd JSON lines."""

    def __init__(self, docs: Optional[Iterable[Doc]] = None):
        self.docs: List[Doc] = list(docs) if docs else []

    def add(self, doc: Doc) -> None:
        self.docs.append(doc)

    def to_disk(self, path: Union[str, Path]) -> None:
        with gzip.open(path, "wt", encoding="utf8") as f:
            for doc in self.docs:
                f.write(json.dumps(doc_to_json(doc)) + "\n")

    @classmethod
    def from_disk(cls, path: Union[str, Path]) -> "DocBin":
        with gzip.open(path, "rt", encoding="utf8") as f:
            return cls(_doc_from_json(json.loads(line)) for line in f if line.strip())


def _iter_path(path: Path) -> Iterator[Doc]:
    if path.is_dir():
        for sub in sorted(path.iterdir()):
            if sub.suffix in SUFFIXES:
                yield from _iter_path(sub)
        return
    suffix = path.suffix
    if suffix == ".jsonl":
        yield from read_jsonl_docs(path)
    elif suffix == ".conllu":
        yield from read_conllu_docs(path)
    elif suffix == ".msgdoc":
        yield from DocBin.from_disk(path).docs
    elif suffix == ".spacy":
        with open(path, "rb") as f:
            gzipped = f.read(2) == b"\x1f\x8b"
        yield from DocBin.from_disk(path).docs if gzipped else read_docbin(path)
    else:
        raise ValueError(f"Unsupported corpus format: {path}")


class Corpus:
    """Config-constructed corpus: a callable yielding Example iterators.

    ``max_length`` splits longer docs on sentence starts (or in hard chunks);
    ``limit`` keeps the first N examples (after shuffling); ``shuffle``
    orders each epoch by ``random.Random(seed + epoch)``; ``cache`` (default)
    reads the files once and yields the same Example objects every epoch.
    ``augmenter`` maps each of an epoch's Examples to the ones it yields:
    the original object (which keeps its caches) or fresh copies.
    """

    def __init__(self, path: Union[str, Path], *, max_length: int = 0, limit: int = 0,
                 shuffle: bool = False, seed: int = 0, cache: bool = True,
                 augmenter: Optional[Callable[[Example], Iterator[Example]]] = None):
        self.path = Path(path)
        self.max_length = max_length
        self.limit = limit
        self.shuffle = shuffle
        self.seed = seed
        self.cache = cache
        self.augmenter = augmenter
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
                yield from self._augment(eg)
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
        for eg in examples:
            yield from self._augment(eg)

    def _augment(self, eg: Example) -> Iterator[Example]:
        if self.augmenter is None:
            yield eg
        else:
            yield from self.augmenter(eg)


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
    return Corpus(path, max_length=max_length, limit=limit, shuffle=shuffle, seed=seed,
                  cache=cache, augmenter=augmenter)


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
