"""Shape bucketing (a copy of the bucket rules in
``spacy_ray_tpu/training/batcher.py``): padded batches take a small set of
(B, T) shapes, shared by collation and the serving warmup sweep."""

from __future__ import annotations

from typing import Sequence

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
