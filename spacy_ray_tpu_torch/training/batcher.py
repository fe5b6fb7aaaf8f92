"""Batchers, size schedules and shape buckets (a copy of
``spacy_ray_tpu/training/batcher.py`` for one device).

``spacy.batch_by_words.v1``, ``spacy.batch_by_sequence.v1`` and
``spacy.batch_by_padded.v1`` group a stream of examples into batches, with ``compounding.v1`` / ``constant.v1``
size schedules. Padded batches then take a small set of (B, T) bucket
shapes, shared by collation, training and the serving warmup sweep.
:func:`shard_stream` deals a stream out to the workers of a trainer fleet.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

from ..pipeline.doc import Example
from ..registry import registry


@registry.schedules("compounding.v1")
def compounding(start: float, stop: float, compound: float) -> Iterable[float]:
    def gen():
        curr = float(start)
        while True:
            yield curr
            curr = min(curr * compound, stop) if compound >= 1.0 else max(curr * compound, stop)

    return gen()


@registry.schedules("constant.v1")
def constant(rate: float) -> Iterable[float]:
    return itertools.repeat(float(rate))


def _as_schedule(size) -> Iterator[float]:
    if isinstance(size, (int, float)):
        return itertools.repeat(float(size))
    return iter(size)


class _Batcher:
    def __init__(self, fn: Callable[[Iterable[Example]], Iterator[List[Example]]]):
        self._fn = fn

    def __call__(self, examples: Iterable[Example]) -> Iterator[List[Example]]:
        return self._fn(examples)


@registry.batchers("spacy.batch_by_words.v1")
def batch_by_words(
    size,
    tolerance: float = 0.2,
    discard_oversize: bool = False,
    get_length: Optional[Callable] = None,
) -> _Batcher:
    """Batches of about ``size`` words (``size`` may be a schedule). A doc
    longer than the target on its own is a batch of one unless discarded."""

    def fn(examples: Iterable[Example]) -> Iterator[List[Example]]:
        sched = _as_schedule(size)
        target = next(sched)
        batch: List[Example] = []
        count = 0
        for eg in examples:
            n = len(eg) if get_length is None else get_length(eg)
            if n > target * (1.0 + tolerance):
                if discard_oversize:
                    continue
                if batch:
                    yield batch
                    target = next(sched)
                    batch, count = [], 0
                yield [eg]
                target = next(sched)
                continue
            if count + n > target * (1.0 + tolerance) and batch:
                yield batch
                target = next(sched)
                batch, count = [], 0
            batch.append(eg)
            count += n
        if batch:
            yield batch

    return _Batcher(fn)


@registry.batchers("spacy.batch_by_sequence.v1")
def batch_by_sequence(size, get_length: Optional[Callable] = None) -> _Batcher:
    def fn(examples: Iterable[Example]) -> Iterator[List[Example]]:
        sched = _as_schedule(size)
        target = int(next(sched))
        batch: List[Example] = []
        for eg in examples:
            batch.append(eg)
            if len(batch) >= target:
                yield batch
                batch = []
                target = int(next(sched))
        if batch:
            yield batch

    return _Batcher(fn)


@registry.batchers("spacy.batch_by_padded.v1")
def batch_by_padded(size, buffer: int = 256, discard_oversize: bool = False,
                    get_length: Optional[Callable] = None) -> _Batcher:
    """Batches whose padded size (docs x longest doc) stays within ``size``
    (a schedule may drive it, one value a batch), the docs sorted by length
    within each buffer of ``buffer`` examples to cut padding. A doc longer
    than the target is a batch of one unless discarded."""

    def fn(examples: Iterable[Example]) -> Iterator[List[Example]]:
        sched = _as_schedule(size)
        it = iter(examples)
        while True:
            buf = list(itertools.islice(it, buffer))
            if not buf:
                return
            buf.sort(key=len)
            target = next(sched)
            batch: List[Example] = []
            max_len = 0
            for eg in buf:
                n = len(eg)
                new_max = max(max_len, n)
                if batch and new_max * (len(batch) + 1) > target:
                    yield batch
                    target = next(sched)
                    batch, max_len = [], 0
                    new_max = n
                if n > target:
                    if not discard_oversize:
                        yield [eg]
                        target = next(sched)
                    continue
                batch.append(eg)
                max_len = new_max
            if batch:
                yield batch

    return _Batcher(fn)


DEFAULT_LENGTH_BUCKETS = (16, 32, 64, 128, 256, 512)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS) -> int:
    """Round a sequence length up to a bucket. Lengths beyond the largest
    bucket round up to the next multiple of it (never truncate)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def bucket_batch_size(n: int) -> int:
    """Round a batch size up to a small set of sizes."""
    for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def shard_stream(examples: Iterable[Example], rank: int, world: int) -> Iterator[Example]:
    """Deterministic round-robin shard of the example stream by rank: the
    examples at positions ``rank, rank + world, ...`` (a fleet worker's
    share of the corpus)."""
    for i, eg in enumerate(examples):
        if i % world == rank:
            yield eg
