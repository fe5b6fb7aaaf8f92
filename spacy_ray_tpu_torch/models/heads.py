"""Per-component head architectures and the listener that feeds a head the
shared trunk's output (counterparts of ``spacy_ray_tpu/models/heads.py``):
the tagger, the text classifiers (pooled ``TextCatReduce``, hashed
bag-of-words ``TextCatBOW``, their sum ``TextCatEnsemble``, ``TextCatCNN``)
and the entity linker's projection.

Parameter paths are the JAX package's: the tagger's ``1_output/{W,b}``, the
entity linker's ``1_project/{W,b}`` beside its trunk's ``0_...``; a
reduce head's ``W``, ``b`` beside its inline trunk's ``tok2vec/...`` (a
listener has none); the BOW table ``W`` [length, nO] and ``b``; the
ensemble's ``neural/...`` and ``linear/...``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..ops import ops as O
from ..registry import registry
from ..types import Padded, TokenBatch
from .core import Chain, Context, Model, call, empty_param, glorot_uniform_, zeros_param
from .layers import Linear


class Tok2VecListener(Model):
    """Stands in for the shared trunk: the pipeline passes the trunk's
    Padded output straight through it."""

    def __init__(self, width: int, upstream: str = "*"):
        super().__init__("tok2vec_listener", dims={"nO": width},
                         meta={"listener": True, "upstream": upstream})

    def forward(self, x: Padded) -> Padded:
        if not isinstance(x, Padded):
            raise TypeError(
                "Tok2VecListener expected the upstream trunk output (Padded); "
                "did the pipeline forget to run the shared trunk?"
            )
        return x


@registry.architectures("spacy.Tok2VecListener.v1")
def make_tok2vec_listener(width: int, upstream: str = "*") -> Tok2VecListener:
    return Tok2VecListener(width, upstream)


def has_listener(model: Model) -> bool:
    return any(m.meta.get("listener") for m in model.walk())


@registry.architectures("spacy.Tagger.v1")
@registry.architectures("spacy.Tagger.v2")
def make_tagger(tok2vec: Model, nO: Optional[int] = None, normalize: bool = False) -> Model:
    """Softmax tagger head: tok2vec -> linear(nO). Parameters sit at
    ``1_output/{W,b}``, as in the JAX package."""
    width = tok2vec.dims.get("nO")
    nO = 1 if nO is None else nO  # resized at initialize() from the labels
    head = Chain(tok2vec, Linear(width, nO, name="output"), name="tagger_model")
    head.dims.update({"nO": nO, "width": width})
    head.meta["has_listener"] = has_listener(tok2vec)
    return head


@registry.architectures("spacy.EntityLinker.v1")
@registry.architectures("spacy.EntityLinker.v2")
def make_entity_linker(tok2vec: Model, nO: Optional[int] = None) -> Model:
    """The entity linker's encoder: the trunk, then a linear projection into
    the KB's entity-vector space. ``nO`` is the KB's
    ``entity_vector_length``, set by the component at ``build_model``
    (1 until then). Mention pooling, candidate scoring and the decode are
    the component's (``pipeline/components/nel.py``)."""
    width = tok2vec.dims.get("nO")
    nO = 1 if nO is None else nO
    head = Chain(tok2vec, Linear(width, nO, name="project"), name="entity_linker_model")
    head.dims.update({"nO": nO, "width": width})
    head.meta["has_listener"] = has_listener(tok2vec)
    return head


class TextCatReduce(Model):
    """Doc classifier: the trunk's output pooled over each doc's real tokens
    (first, last, max and mean, those enabled, concatenated in that order)
    and a linear layer to nO logits. The component applies the sigmoid or
    the softmax."""

    takes_ctx = True

    def __init__(self, tok2vec: Model, nO: int, exclusive_classes: bool,
                 pools: tuple):
        width = tok2vec.dims.get("nO")
        super().__init__("textcat_model", dims={"nO": nO, "width": width},
                         meta={"has_listener": has_listener(tok2vec),
                               "exclusive_classes": exclusive_classes})
        self.pools = pools
        self.tok2vec = tok2vec
        self.W = empty_param(width * len(pools), nO)
        self.b = zeros_param(nO)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.W, generator)

    def forward(self, x: Any, ctx: Optional[Context] = None) -> torch.Tensor:
        h: Padded = call(self.tok2vec, x, ctx or Context())
        feats = []
        for pool in self.pools:
            if pool == "first":
                feats.append(h.X[:, 0, :])
            elif pool == "last":
                last = torch.clamp(h.mask.long().sum(dim=1) - 1, min=0)
                feats.append(h.X[torch.arange(h.X.shape[0], device=h.X.device), last])
            elif pool == "max":
                feats.append(O.max_pool(h.X, h.mask))
            else:
                feats.append(O.mean_pool(h.X, h.mask))
        return torch.cat(feats, dim=-1) @ self.W + self.b


@registry.architectures("spacy.TextCatReduce.v1")
def make_textcat_reduce(
    tok2vec: Model,
    nO: Optional[int] = None,
    exclusive_classes: bool = False,
    use_reduce_first: bool = False,
    use_reduce_last: bool = False,
    use_reduce_max: bool = True,
    use_reduce_mean: bool = True,
) -> TextCatReduce:
    pools = tuple(p for p, on in (("first", use_reduce_first), ("last", use_reduce_last),
                                  ("max", use_reduce_max), ("mean", use_reduce_mean)) if on)
    if not pools:
        raise ValueError("TextCatReduce: enable at least one reduction")
    return TextCatReduce(tok2vec, 1 if nO is None else nO, exclusive_classes, pools)


#: the multiplier that rolls the next token's hash into an n-gram's, in
#: 16-bit halves: a 32-bit value times either half stays inside int64
_NGRAM_MUL_LO, _NGRAM_MUL_HI = 2654435761 & 0xFFFF, 2654435761 >> 16
_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor) -> torch.Tensor:
    """``x * 2654435761`` modulo 2**32 for int64 ``x`` in [0, 2**32),
    with no intermediate past 2**49."""
    return (x * _NGRAM_MUL_LO + (((x * _NGRAM_MUL_HI) & 0xFFFF) << 16)) & _U32


def bow_ngram_rows(attr_keys: torch.Tensor, mask: torch.Tensor, ngram_size: int,
                   length: int):
    """Per n (1..ngram_size), the table rows [B, T] of the n-grams starting
    at each position and their mask: the JAX package's uint32 hashing of the
    NORM key halves (``lo ^ (hi >> 1)``, then ``prev * 2654435761 + next_lo``
    for each further token, wrapping at 2**32), in int64 reduced to 32 bits
    after every multiply and add; the last n - 1 positions hold no n-gram."""
    lo = attr_keys[:, :, 0, 0]
    hi = attr_keys[:, :, 0, 1]
    prev = lo ^ (hi >> 1)
    gram_mask = mask
    out = []
    for k in range(max(int(ngram_size), 1)):
        if k > 0:
            prev = (_mul_u32(prev) + torch.roll(lo, -k, dims=1)) & _U32
            gram_mask = gram_mask & torch.roll(mask, -k, dims=1)
            gram_mask[:, -k:] = False
        out.append((prev % length, gram_mask))
    return out


class TextCatBOW(Model):
    """Hashed n-gram bag of words: each n-gram of the doc hashes to a row of
    a [length, nO] table; the doc's logits are the mean of its rows plus
    ``b``. Reads the TokenBatch itself, no trunk. The table starts at zero.
    ``nO`` may be unset at construction (spaCy's config shape): the
    ensemble then sets it with :meth:`set_nO` before any weights exist."""

    def __init__(self, nO: Optional[int], ngram_size: int, length: int,
                 exclusive_classes: bool):
        super().__init__("textcat_bow", dims={"nO": nO},
                         meta={"has_listener": False, "exclusive_classes": exclusive_classes})
        self.ngram_size = int(ngram_size)
        self.length = int(length)
        self.set_nO(nO)

    def set_nO(self, nO: Optional[int]) -> None:
        self.dims["nO"] = nO
        self.W = zeros_param(self.length, nO or 1)
        self.b = zeros_param(nO or 1)

    def forward(self, tokens: TokenBatch) -> torch.Tensor:
        B = tokens.attr_keys.shape[0]
        scores = torch.zeros((B, self.W.shape[-1]), dtype=self.W.dtype, device=self.W.device)
        count = torch.zeros((B, 1), dtype=self.W.dtype, device=self.W.device)
        for idx, gram_mask in bow_ngram_rows(tokens.attr_keys, tokens.mask,
                                             self.ngram_size, self.length):
            m = gram_mask.to(self.W.dtype)[..., None]
            scores = scores + (self.W[idx] * m).sum(dim=1)
            count = count + m.sum(dim=1)
        return scores / torch.clamp(count, min=1.0) + self.b


@registry.architectures("spacy.TextCatBOW.v2")
@registry.architectures("spacy.TextCatBOW.v3")
def make_textcat_bow(
    exclusive_classes: bool = False,
    ngram_size: int = 1,
    no_output_layer: bool = False,
    nO: Optional[int] = None,
    length: int = 262144,
) -> TextCatBOW:
    return TextCatBOW(nO, ngram_size, length, exclusive_classes)


class TextCatEnsemble(Model):
    """spaCy's default textcat: a reduce head over an inline trunk summed with
    a linear (BOW) model, each under its own child context."""

    takes_ctx = True

    def __init__(self, neural: TextCatReduce, linear: Model):
        super().__init__("textcat_ensemble", dims={"nO": neural.dims["nO"]},
                         meta={"has_listener": False,
                               "exclusive_classes": neural.meta["exclusive_classes"]})
        self.neural = neural
        self.linear = linear

    def forward(self, x: Any, ctx: Optional[Context] = None) -> torch.Tensor:
        ctx = ctx or Context()
        return call(self.neural, x, ctx.child(0)) + call(self.linear, x, ctx.child(1))


@registry.architectures("spacy.TextCatEnsemble.v2")
def make_textcat_ensemble(tok2vec: Model, linear_model: Model,
                          nO: Optional[int] = None) -> TextCatEnsemble:
    if has_listener(tok2vec):
        raise ValueError(
            "spacy.TextCatEnsemble.v2 needs an INLINE tok2vec here: its "
            "linear_model reads raw token features, which a listener-fed "
            "head never receives. Put a full tok2vec block under "
            "[components.textcat.model.tok2vec] instead of a listener."
        )
    neural = make_textcat_reduce(tok2vec, nO=nO)
    nO = neural.dims["nO"] if nO is None else nO
    lm_nO = linear_model.dims.get("nO")
    if lm_nO is None:
        linear_model.set_nO(nO)
    elif lm_nO != nO:
        raise ValueError(
            f"TextCatEnsemble: linear_model nO={lm_nO} != {nO} labels — "
            "omit nO in the [linear_model] block to inherit the label count"
        )
    return TextCatEnsemble(neural, linear_model)


@registry.architectures("spacy.TextCatCNN.v2")
def make_textcat_cnn(tok2vec: Model, exclusive_classes: bool = False,
                     nO: Optional[int] = None) -> TextCatReduce:
    """The trunk, mean pooling and a linear layer (TextCatReduce's mean)."""
    return make_textcat_reduce(tok2vec, nO=nO, exclusive_classes=exclusive_classes,
                               use_reduce_max=False, use_reduce_mean=True)
