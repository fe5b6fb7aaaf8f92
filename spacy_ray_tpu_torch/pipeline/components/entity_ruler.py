"""Entity ruler: entities from patterns, on the host. A copy of
``spacy_ray_tpu/pipeline/components/entity_ruler.py``.

* phrase patterns, ``{"label": "ORG", "pattern": "Acme Corp"}``: the phrase
  is tokenized once, when the patterns are added or loaded, by the port's
  own tokenizer, and matched case-sensitively on the tokens;
* token patterns, ``{"label": "GPE", "pattern": [{"LOWER": "new"},
  {"LOWER": "york"}]}``: the matcher's language (``pipeline/matcher.py``).

Matches are taken longest first, then leftmost, and a match overlapping one
already taken is dropped. With ``overwrite_ents`` the rule entities replace
the entities already on the doc where they overlap; without it they only
fill tokens no entity claims. Patterns serialize in ``components.json``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from ...registry import registry
from ..doc import Doc, Example, Span
from ..matcher import match_pattern, validate_token_patterns
from ..tokenizer import Tokenizer
from .base import Component

_PATTERN_TOKENIZER = Tokenizer()  # stateless; shared by the phrase patterns


class EntityRulerComponent(Component):
    sets_ents = True
    trainable = False
    listens = False

    def __init__(self, name: str, model_cfg: Optional[Dict[str, Any]] = None,
                 patterns: Optional[List[Dict[str, Any]]] = None,
                 overwrite_ents: bool = False):
        super().__init__(name, model_cfg or {})
        self.patterns: List[Dict[str, Any]] = []
        self._compiled: List[Tuple[str, List[Dict[str, Any]]]] = []
        self.overwrite_ents = overwrite_ents
        if patterns:
            self.add_patterns(patterns)

    def add_patterns(self, patterns: Iterable[Dict[str, Any]]) -> None:
        patterns = list(patterns)
        validate_token_patterns(p["pattern"] for p in patterns)
        self.patterns.extend(patterns)
        self.finish_labels()

    def build_model(self):
        self.model = None
        return None

    def finish_labels(self) -> None:
        """The labels of the patterns; the phrase patterns tokenized (the
        patterns keep the user's form for saving)."""
        self.labels = sorted({p["label"] for p in self.patterns})
        self._compiled = []
        for pat in self.patterns:
            pattern = pat["pattern"]
            if isinstance(pattern, str):
                pattern = [{"TEXT": w} for w in _PATTERN_TOKENIZER(pattern).words]
            self._compiled.append((pat["label"], pattern))

    def _find_matches(self, doc: Doc) -> List[Span]:
        words = doc.words
        matches: List[Tuple[int, int, str]] = []
        for label, pattern in self._compiled:
            for start in range(len(words)):
                end = match_pattern(doc, pattern, start)
                if end is not None and end > start:
                    matches.append((start, end, label))
        # longest first, then leftmost; drop overlaps
        matches.sort(key=lambda m: (-(m[1] - m[0]), m[0]))
        taken = [False] * len(words)
        out: List[Span] = []
        for start, end, label in matches:
            if any(taken[start:end]):
                continue
            for i in range(start, end):
                taken[i] = True
            out.append(Span(start, end, label))
        out.sort(key=lambda s: s.start)
        return out

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        for doc in docs:
            matches = self._find_matches(doc)
            if self.overwrite_ents:
                primary, secondary = matches, doc.ents  # the rules win
            else:
                primary, secondary = doc.ents, matches  # the model's entities win
            claimed = {i for e in primary for i in range(e.start, e.end)}
            merged = list(primary) + [m for m in secondary
                                      if not (set(range(m.start, m.end)) & claimed)]
            doc.ents = sorted(merged, key=lambda s: s.start)

    def score(self, examples: List[Example]) -> Dict[str, float]:
        return {}

    def table_data(self) -> Dict[str, Any]:
        return {"patterns": self.patterns, "overwrite_ents": self.overwrite_ents}

    def load_table_data(self, data: Dict[str, Any]) -> None:
        patterns = list(data.get("patterns", []))
        validate_token_patterns(p["pattern"] for p in patterns)
        self.patterns = patterns
        self.overwrite_ents = bool(data.get("overwrite_ents", False))
        self.finish_labels()


@registry.factories("entity_ruler")
def make_entity_ruler(name: str, model: Optional[Dict[str, Any]] = None,
                      patterns: Optional[List[Dict[str, Any]]] = None,
                      overwrite_ents: bool = False) -> EntityRulerComponent:
    return EntityRulerComponent(name, model, patterns=patterns,
                                overwrite_ents=overwrite_ents)
