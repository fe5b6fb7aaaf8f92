"""The shared trunk components: ``tok2vec`` (the CNN trunk, e.g.
``spacy.HashEmbedCNN.v2``) and ``transformer``. Counterpart of
``spacy_ray_tpu/pipeline/components/tok2vec.py``.

Both factories make the same :class:`Tok2VecComponent`: a trunk with no
loss of its own, run once per batch, whose output every listening head
reads through its ``Tok2VecListener``. The heads' losses are summed into one
differentiable total, so the trunk's gradient is the sum of theirs (spaCy's
listener backprop relay, without the relay). The trunk model takes
``(TokenBatch, overlay, ctx)``; a serving precision overlay exists for
transformer trunks only, and a CNN trunk is served in f32
(``serving/overlay.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ...models.core import Context
from ...registry import registry
from ...types import TokenBatch
from .base import Component


class Tok2VecComponent(Component):
    trainable = False  # no loss of its own; trained through its listeners

    def forward(self, inputs: TokenBatch, overlay: Optional[Dict[str, Any]] = None,
                ctx: Optional[Context] = None):
        assert self.model is not None, "build_model() first"
        return self.model(inputs, overlay=overlay, ctx=ctx)


@registry.factories("tok2vec")
def make_tok2vec(name: str, model: Dict[str, Any]) -> Tok2VecComponent:
    return Tok2VecComponent(name, model)


@registry.factories("transformer")
def make_transformer(name: str, model: Dict[str, Any],
                     max_batch_items: int = 4096) -> Tok2VecComponent:
    return Tok2VecComponent(name, model)
