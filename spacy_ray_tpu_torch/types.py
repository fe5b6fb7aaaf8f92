"""Tensor containers crossing the host/device boundary."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Padded:
    """A padded batch of token vectors: X [B, T, D], mask [B, T] bool."""

    X: torch.Tensor
    mask: torch.Tensor

    @property
    def width(self) -> int:
        return self.X.shape[-1]


@dataclass
class TokenBatch:
    """Featurized token batch on the device.

    attr_keys: [B, T, n_attrs, 2] int64 — the (lo, hi) uint32 halves of the
      64-bit lexical-attribute hash keys (NORM/PREFIX/SUFFIX/SHAPE), held in
      int64 because torch has no general uint32 arithmetic.
    mask: [B, T] bool — True on real tokens.
    vector_rows: [B, T] int64 — each token's row of the static vectors
      table, -1 on padding and words without a vector; None when the
      pipeline has no vectors.
    """

    attr_keys: torch.Tensor
    mask: torch.Tensor
    vector_rows: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.attr_keys.shape[0]

    @property
    def seq_len(self) -> int:
        return self.attr_keys.shape[1]
