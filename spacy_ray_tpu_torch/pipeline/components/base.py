"""Pipeline component protocol (counterpart of
``spacy_ray_tpu/pipeline/components/base.py``, inference side): labels,
the model resolved from the component's config block, a forward on the
device and annotation decoding on the host."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from ...models.core import Model
from ...registry import registry
from ..doc import Doc, Example


class Component:
    #: does this component's model contain a Tok2VecListener?
    listens: bool = False

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
        """Resolve the model config block, with nO set to the label count."""
        cfg = dict(self.model_cfg)
        if self.labels:
            cfg["nO"] = len(self.labels)
        model = registry.resolve(cfg)
        if not isinstance(model, Model):
            raise TypeError(f"[components.{self.name}.model] did not resolve to a Model")
        self.model = model
        self.listens = bool(model.meta.get("has_listener"))
        return model

    def forward(self, inputs: Any, overlay: Optional[Dict[str, Any]] = None) -> Any:
        assert self.model is not None, "build_model() first"
        return self.model(inputs)

    def set_annotations(self, docs: List[Doc], outputs: Any, lengths: List[int]) -> None:
        """Decode device outputs into doc annotations."""
