"""Token-to-vector architectures: the hash-embedding featurizer and the CNN
window encoder (counterpart of ``spacy_ray_tpu/models/tok2vec.py``).

Registered under the JAX package's ``spacy.*`` names, with its parameter
paths: ``MultiHashEmbed`` is ``0_embeds/{i}_embed_<attr>/E``, ``1_mix/{W,b}``
and ``2_norm/{g,b}``, with ``0_embeds/{n}_static_vectors/{frozen_table,W}``
after the ``n`` tables when it includes static vectors; the encoder is
``depth`` residual blocks ``{i}_res_{i}/inner/{1_maxout,2_norm}`` (the
parameter-free ``0_seq2col`` keeps index 0); ``HashEmbedCNN`` chains them
as ``0_multi_hash_embed`` and ``1_maxout_window_encoder`` (``2_`` when its
``dropout`` puts a Dropout between them). The trunk a ``tok2vec`` component
holds is a :class:`Tok2VecModel`: it takes ``(TokenBatch, overlay, ctx)``
like the transformer trunk.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..ops.hashing import hash_string_u64
from ..registry import registry
from ..types import TokenBatch
from .core import Chain, Context, Model, Residual
from .layers import (
    ConcatPadded, Dropout, HashEmbed, LayerNorm, Maxout, Seq2Col, StaticVectors,
)

# Canonical order of lexical attributes in TokenBatch.attr_keys
# (pipeline/vocab.py featurizes in this order).
ATTRS = ("NORM", "PREFIX", "SUFFIX", "SHAPE")


def attr_index(attr: str) -> int:
    try:
        return ATTRS.index(attr.upper())
    except ValueError:
        raise ValueError(f"Unknown attr {attr!r}; supported: {ATTRS}")


class Tok2VecModel(Chain):
    """A chain that a ``tok2vec`` component runs as its trunk: the
    transformer trunk's call signature. Serving overlays cover transformer
    layers only, so one is refused here."""

    def forward(self, batch: TokenBatch, overlay: Optional[Any] = None,
                ctx: Optional[Context] = None):
        if overlay:
            raise ValueError(f"{self.name}: a precision overlay needs a transformer trunk")
        return super().forward(batch, ctx)


@registry.architectures("spacy.MultiHashEmbed.v2")
def MultiHashEmbed(
    width: int,
    attrs: Optional[List[str]] = None,
    rows: Optional[List[int]] = None,
    include_static_vectors: bool = False,
) -> Model:
    """Per attribute a HashEmbed(width, rows[i]), and with
    ``include_static_vectors`` the active vectors' StaticVectors(width);
    concatenated, mixed by a Maxout back to ``width`` and layer-normed. The
    table seeds are the JAX package's, so the same keys land on the same
    rows."""
    attrs = list(ATTRS) if attrs is None else attrs
    rows = [5000] + [2500] * (len(attrs) - 1) if rows is None else rows
    if len(rows) != len(attrs):
        raise ValueError(f"len(rows) != len(attrs): {rows} vs {attrs}")
    embeds: List[Model] = [
        HashEmbed(
            width, int(r),
            seed=hash_string_u64(f"hashembed-{a}-{i}") & 0x7FFFFFFF,
            attr_index=attr_index(a),
            name=f"embed_{a.lower()}",
        )
        for i, (a, r) in enumerate(zip(attrs, rows))
    ]
    if include_static_vectors:
        embeds.append(StaticVectors(width))
    mix = Chain(
        ConcatPadded(*embeds, name="embeds"),
        Maxout(width * len(embeds), width, nP=3, name="mix"),
        LayerNorm(width),
        name="multi_hash_embed",
    )
    mix.dims["nO"] = width
    return mix


@registry.architectures("spacy.MultiHashEmbed.v1")
def MultiHashEmbedV1(
    width: int,
    rows: int = 7000,
    also_embed_subwords: bool = True,
    also_use_static_vectors: bool = False,
) -> Model:
    """The v1 signature: NORM at ``rows``, and PREFIX, SUFFIX and SHAPE at
    half of it when subwords are embedded."""
    if also_embed_subwords:
        attrs = ["NORM", "PREFIX", "SUFFIX", "SHAPE"]
        row_list = [rows, rows // 2, rows // 2, rows // 2]
    else:
        attrs, row_list = ["NORM"], [rows]
    return MultiHashEmbed(width, attrs=attrs, rows=row_list,
                          include_static_vectors=also_use_static_vectors)


@registry.architectures("spacy.MaxoutWindowEncoder.v1")
@registry.architectures("spacy.MaxoutWindowEncoder.v2")
def MaxoutWindowEncoder(width: int, window_size: int = 1, maxout_pieces: int = 3,
                        depth: int = 4) -> Model:
    """``depth`` x residual[seq2col(window) -> maxout -> layer norm]."""

    def block(i: int) -> Model:
        return Residual(
            Chain(
                Seq2Col(window_size, width),
                Maxout(width * (2 * window_size + 1), width, nP=maxout_pieces),
                LayerNorm(width),
                name=f"cnn_{i}",
            ),
            name=f"res_{i}",
        )

    enc = Chain(*[block(i) for i in range(depth)], name="maxout_window_encoder")
    enc.dims.update({"nI": width, "nO": width})
    return enc


@registry.architectures("spacy.TorchBiLSTMEncoder.v1")
def TorchBiLSTMEncoder(width: int, depth: int = 2, dropout: float = 0.0) -> Model:
    raise NotImplementedError(
        "the BiLSTM encoder is not provided (as in the JAX package); use "
        "spacy.MaxoutWindowEncoder.v2 or the transformer trunk"
    )


@registry.architectures("spacy.Tok2Vec.v1")
@registry.architectures("spacy.Tok2Vec.v2")
def Tok2Vec(embed: Model, encode: Model) -> Model:
    t2v = Tok2VecModel(embed, encode, name="tok2vec")
    t2v.dims["nO"] = encode.dims.get("nO", embed.dims.get("nO", 0))
    return t2v


@registry.architectures("spacy.HashEmbedCNN.v1")
@registry.architectures("spacy.HashEmbedCNN.v2")
def HashEmbedCNN(
    width: int,
    depth: int,
    embed_size: int,
    window_size: int = 1,
    maxout_pieces: int = 3,
    subword_features: bool = True,
    pretrained_vectors: Optional[str] = None,
    dropout: Optional[float] = None,
) -> Model:
    """The standard CNN tok2vec: MultiHashEmbed (NORM at ``embed_size``
    rows, the subword attributes at half; the active static vectors when
    ``pretrained_vectors`` is set), a Dropout when ``dropout`` is set, then
    the maxout window encoder."""
    attrs = list(ATTRS) if subword_features else ["NORM"]
    rows = [embed_size] + [embed_size // 2] * (len(attrs) - 1)
    layers: List[Model] = [MultiHashEmbed(width=width, attrs=attrs, rows=rows,
                                          include_static_vectors=bool(pretrained_vectors))]
    if dropout:
        layers.append(Dropout(dropout))
    layers.append(MaxoutWindowEncoder(width=width, window_size=window_size,
                                      maxout_pieces=maxout_pieces, depth=depth))
    t2v = Tok2VecModel(*layers, name="hash_embed_cnn")
    t2v.dims["nO"] = width
    return t2v
