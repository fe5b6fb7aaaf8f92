"""Pipeline component protocol (counterpart of
``spacy_ray_tpu/pipeline/components/base.py``): labels, the model resolved
from the component's config block, targets collated on the host, a loss and
a forward on the device, annotation decoding and scoring on the host."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ...models.core import Context, Model
from ...registry import registry
from ..doc import Doc, Example


class Component:
    #: does this component's model contain a Tok2VecListener?
    listens: bool = False
    #: does this component produce a trainable loss?
    trainable: bool = True
    #: does this component write ``doc.ents`` (the NER, the entity ruler)?
    #: ``evaluate`` and the training loop's ``use_gold_ents`` checks read it
    sets_ents: bool = False
    #: default [training] score weights contributed by this component when
    #: the config declares none (spaCy's per-factory metadata)
    default_score_weights: Dict[str, float] = {}
    #: is this head's decode captured as a CUDA graph per (B, T) bucket when
    #: a prediction is pinned to one (``pipeline/decode_graph.py``)? Such a
    #: head defines ``trunk_output``, ``device_decode`` and ``decode_signature``
    graph_capturable: bool = False

    def __init__(self, name: str, model_cfg: Dict[str, Any]):
        self.name = name
        self.model_cfg = dict(model_cfg)
        self.model: Optional[Model] = None
        self.labels: List[str] = []

    def add_labels_from(self, examples: Iterable[Example]) -> None:
        """Collect the label set from gold data."""

    def finish_labels(self) -> None:
        self.labels = sorted(set(self.labels))

    def build_model(self) -> Model:
        """Resolve the model config block, with nO set to the label count,
        in it and in each direct sub-block that declares ``nO = null`` (as
        a TextCatEnsemble's ``linear_model`` may: spaCy infers it)."""
        cfg = dict(self.model_cfg)
        if self.labels:
            cfg["nO"] = len(self.labels)
            for key, sub in list(cfg.items()):
                if (isinstance(sub, dict) and "@architectures" in sub
                        and "nO" in sub and sub["nO"] is None):
                    cfg[key] = {**sub, "nO": len(self.labels)}
        model = registry.resolve(cfg)
        if not isinstance(model, Model):
            raise TypeError(f"[components.{self.name}.model] did not resolve to a Model")
        self.model = model
        self.listens = bool(model.meta.get("has_listener"))
        return model

    def make_targets(self, examples: List[Example], B: int, T: int) -> Dict[str, np.ndarray]:
        """Lower gold annotations to padded host arrays for the loss."""
        return {}

    def loss(self, inputs: Any, targets: Dict[str, Any], ctx: Context):
        """(scalar loss, metrics dict) on the device."""
        raise NotImplementedError

    def forward(self, inputs: Any, overlay: Optional[Dict[str, Any]] = None,
                ctx: Optional[Context] = None) -> Any:
        assert self.model is not None, "build_model() first"
        return self.model(inputs)

    def trunk_output(self, inputs: Any) -> Any:
        """The trunk output (``Padded``) a graph-captured decode reads."""
        raise NotImplementedError(f"{self.name} has no graph-captured decode")

    def decode_signature(self) -> Tuple[Any, ...]:
        """What, beside (B, T), tells one captured decode from another."""
        return ()

    def device_decode(self, X: Any, lengths: Any) -> Dict[str, Any]:
        """The decode of trunk output X [B, T, D] with true lengths [B], with
        no host synchronisation (what a CUDA graph captures)."""
        raise NotImplementedError(f"{self.name} has no graph-captured decode")

    def set_annotations(self, docs: List[Doc], outputs: Any, lengths: List[int]) -> None:
        """Decode device outputs into doc annotations."""

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        return {}
