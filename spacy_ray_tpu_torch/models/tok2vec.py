"""MultiHashEmbed: the hash-embedding featurizer of the transformer trunk
(counterpart of ``spacy_ray_tpu/models/tok2vec.py``)."""

from __future__ import annotations

from typing import List, Optional

from ..ops.hashing import hash_string_u64
from .core import Chain, Model
from .layers import ConcatPadded, HashEmbed, LayerNorm, Maxout

# Canonical order of lexical attributes in TokenBatch.attr_keys
# (pipeline/vocab.py featurizes in this order).
ATTRS = ("NORM", "PREFIX", "SUFFIX", "SHAPE")


def attr_index(attr: str) -> int:
    try:
        return ATTRS.index(attr.upper())
    except ValueError:
        raise ValueError(f"Unknown attr {attr!r}; supported: {ATTRS}")


def MultiHashEmbed(
    width: int, attrs: Optional[List[str]] = None, rows: Optional[List[int]] = None
) -> Model:
    """Per attribute a HashEmbed(width, rows[i]); concatenated, mixed by a
    Maxout back to ``width`` and layer-normed. The table seeds are the JAX
    package's, so the same keys land on the same rows."""
    attrs = list(ATTRS) if attrs is None else attrs
    rows = [5000] + [2500] * (len(attrs) - 1) if rows is None else rows
    if len(rows) != len(attrs):
        raise ValueError(f"len(rows) != len(attrs): {rows} vs {attrs}")
    embeds = [
        HashEmbed(
            width, int(r),
            seed=hash_string_u64(f"hashembed-{a}-{i}") & 0x7FFFFFFF,
            attr_index=attr_index(a),
            name=f"embed_{a.lower()}",
        )
        for i, (a, r) in enumerate(zip(attrs, rows))
    ]
    mix = Chain(
        ConcatPadded(*embeds, name="embeds"),
        Maxout(width * len(attrs), width, nP=3, name="mix"),
        LayerNorm(width),
        name="multi_hash_embed",
    )
    mix.dims["nO"] = width
    return mix
