"""The shared transformer trunk component: heads listen to its output."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ...models.core import Context
from ...registry import registry
from ...types import TokenBatch
from .base import Component


class Tok2VecComponent(Component):
    def forward(self, inputs: TokenBatch, overlay: Optional[Dict[str, Any]] = None,
                ctx: Optional[Context] = None):
        assert self.model is not None, "build_model() first"
        return self.model(inputs, overlay=overlay, ctx=ctx)


@registry.factories("transformer")
def make_transformer(name: str, model: Dict[str, Any], max_batch_items: int = 4096):
    return Tok2VecComponent(name, model)
