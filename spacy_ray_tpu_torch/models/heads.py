"""Tagger head and the listener that feeds it the shared trunk's output
(counterparts of ``spacy_ray_tpu/models/heads.py``)."""

from __future__ import annotations

from typing import Optional

from ..registry import registry
from ..types import Padded
from .core import Chain, Model
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


@registry.architectures("spacy.Tagger.v2")
def make_tagger(tok2vec: Model, nO: Optional[int] = None, normalize: bool = False) -> Model:
    """Softmax tagger head: tok2vec -> linear(nO). Parameters sit at
    ``1_output/{W,b}``, as in the JAX package."""
    width = tok2vec.dims.get("nO")
    nO = 1 if nO is None else nO  # resized at initialize() from the labels
    head = Chain(tok2vec, Linear(width, nO, name="output"), name="tagger_model")
    head.dims.update({"nO": nO, "width": width})
    head.meta["has_listener"] = any(m.meta.get("listener") for m in tok2vec.walk())
    return head
