"""Attribute ruler: token attributes set by patterns, on the host. A copy of
``spacy_ray_tpu/pipeline/components/attribute_ruler.py``.

A rule is ``{"patterns": [[{"LOWER": "who"}], ...], "attrs": {"TAG": "WP",
"LEMMA": "who"}, "index": 0}``: every match of any of its token patterns
(``pipeline/matcher.py``) sets ``attrs`` on the matched token at ``index``
(negative indices count from the match's end; an index outside the match
raises). Every rule is matched against the doc as it came in, then every
match is applied (spaCy's order), so TAG- or POS-keyed patterns see the
tagger's annotations, not this pass's. Rules serialize in
``components.json``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from ...registry import registry
from ..doc import Doc, Example
from ..matcher import match_pattern, validate_token_patterns
from .base import Component

_ATTR_FIELDS = {
    "TAG": "tags",
    "POS": "pos",
    "LEMMA": "lemmas",
    "MORPH": "morphs",
}


class AttributeRulerComponent(Component):
    trainable = False
    listens = False

    def __init__(self, name: str, model_cfg: Optional[Dict[str, Any]] = None,
                 patterns: Optional[List[Dict[str, Any]]] = None):
        super().__init__(name, model_cfg or {})
        self.patterns: List[Dict[str, Any]] = []
        if patterns:
            self.add_patterns(patterns)

    @staticmethod
    def _validate(patterns: Iterable[Dict[str, Any]]) -> None:
        for rule in patterns:
            for attr in rule.get("attrs", {}):
                if attr.upper() not in _ATTR_FIELDS:
                    raise ValueError(
                        f"Unsupported attribute {attr!r}; "
                        f"supported: {sorted(_ATTR_FIELDS)}"
                    )
            validate_token_patterns(rule.get("patterns", []))

    def add_patterns(self, patterns: Iterable[Dict[str, Any]]) -> None:
        patterns = list(patterns)
        self._validate(patterns)
        self.patterns.extend(patterns)

    def build_model(self):
        self.model = None
        return None

    def finish_labels(self) -> None:
        self.labels = []

    @staticmethod
    def _ensure_field(doc: Doc, field: str) -> List[str]:
        values = getattr(doc, field)
        if values is None:
            values = [""] * len(doc)
            setattr(doc, field, values)
        return values

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        for doc in docs:
            pending: List[tuple] = []
            for rule in self.patterns:
                field_values = [(_ATTR_FIELDS[attr.upper()], value)
                                for attr, value in rule.get("attrs", {}).items()]
                index = int(rule.get("index", 0))
                for pattern in rule.get("patterns", []):
                    for start in range(len(doc.words)):
                        end = match_pattern(doc, pattern, start)
                        if end is None or end <= start:
                            continue
                        span_len = end - start
                        ti = index if index >= 0 else span_len + index
                        if not (0 <= ti < span_len):
                            raise ValueError(
                                f"attribute_ruler rule index {index} is out "
                                f"of range for a {span_len}-token match at "
                                f"tokens {start}:{end}"
                            )
                        pending.append((start + ti, field_values))
            for tok, field_values in pending:
                for field, value in field_values:
                    self._ensure_field(doc, field)[tok] = value

    def score(self, examples: List[Example]) -> Dict[str, float]:
        return {}

    def table_data(self) -> Dict[str, Any]:
        return {"patterns": self.patterns}

    def load_table_data(self, data: Dict[str, Any]) -> None:
        patterns = list(data.get("patterns", []))
        self._validate(patterns)
        self.patterns = patterns


@registry.factories("attribute_ruler")
def make_attribute_ruler(name: str, model: Optional[Dict[str, Any]] = None,
                         patterns: Optional[List[Dict[str, Any]]] = None
                         ) -> AttributeRulerComponent:
    return AttributeRulerComponent(name, model, patterns=patterns)
