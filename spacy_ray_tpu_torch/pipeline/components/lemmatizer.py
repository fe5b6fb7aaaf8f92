"""Lemmatizer on the host, in ``lookup`` and ``rule`` modes: a copy of
``spacy_ray_tpu/pipeline/components/lemmatizer.py``.

* ``lookup`` (the default): at initialize, (word, pos) -> lemma and word ->
  lemma tables from the gold corpus by majority count; a prediction is a
  lookup with suffix-strip fallbacks.
* ``rule``: spaCy's rule lemmatizer: the POS's exception table, then its
  suffix rewrite rules, a rewrite counting only when it lands on a lemma of
  the POS's index. The built-in tables are the JAX package's English ones
  (exceptions and morphy-style rules); a ``tables_path`` JSON replaces them
  key by key, and the index grows from the gold lemmas at initialize.

The tables serialize in ``components.json``. Scored by ``lemma_acc``.
"""

from __future__ import annotations

import json
import warnings
from collections import Counter, defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ...registry import registry
from ..doc import Doc, Example
from ..scoring import score_token_acc
from .base import Component

_SUFFIX_RULES = [
    ("ies", "y"),
    ("sses", "ss"),
    ("ing", ""),
    ("ed", ""),
    ("s", ""),
]

# The built-in English rule tables (the shape of spaCy's English lemmatizer
# tables in spacy-lookups-data)
_EN_RULES: Dict[str, List[List[str]]] = {
    "NOUN": [
        ["ses", "s"], ["ves", "f"], ["xes", "x"], ["zes", "z"],
        ["ches", "ch"], ["shes", "sh"], ["men", "man"], ["ies", "y"],
        ["s", ""],
    ],
    "VERB": [
        ["ies", "y"], ["ees", "ee"], ["es", "e"], ["es", ""],
        ["ied", "y"], ["ed", "e"], ["ed", ""], ["ing", "e"], ["ing", ""],
        ["s", ""],
    ],
    "ADJ": [["er", ""], ["est", ""], ["er", "e"], ["est", "e"], ["ier", "y"], ["iest", "y"]],
    "ADV": [],
}

_EN_EXCEPTIONS: Dict[str, Dict[str, str]] = {
    "VERB": {
        "am": "be", "are": "be", "is": "be", "was": "be", "were": "be",
        "been": "be", "being": "be", "has": "have", "had": "have",
        "having": "have", "does": "do", "did": "do", "done": "do",
        "goes": "go", "went": "go", "gone": "go", "said": "say",
        "made": "make", "took": "take", "taken": "take", "came": "come",
        "saw": "see", "seen": "see", "got": "get", "gotten": "get",
        "knew": "know", "known": "know", "thought": "think",
        "gave": "give", "given": "give", "found": "find", "told": "tell",
        "became": "become", "left": "leave", "felt": "feel", "put": "put",
        "brought": "bring", "began": "begin", "begun": "begin",
        "kept": "keep", "held": "hold", "wrote": "write", "written": "write",
        "stood": "stand", "heard": "hear", "let": "let", "meant": "mean",
        "set": "set", "met": "meet", "ran": "run", "paid": "pay",
        "sat": "sit", "spoke": "speak", "spoken": "speak", "lay": "lie",
        "led": "lead", "read": "read", "grew": "grow", "grown": "grow",
        "lost": "lose", "fell": "fall", "fallen": "fall", "sent": "send",
        "built": "build", "understood": "understand", "drew": "draw",
        "drawn": "draw", "broke": "break", "broken": "break",
        "spent": "spend", "cut": "cut", "rose": "rise", "risen": "rise",
        "drove": "drive", "driven": "drive", "bought": "buy",
        "wore": "wear", "worn": "wear", "chose": "choose", "chosen": "choose",
    },
    "NOUN": {
        "men": "man", "women": "woman", "children": "child", "people": "person",
        "teeth": "tooth", "feet": "foot", "mice": "mouse", "geese": "goose",
        "oxen": "ox", "lives": "life", "wives": "wife", "knives": "knife",
        "leaves": "leaf", "halves": "half", "selves": "self",
        "criteria": "criterion", "phenomena": "phenomenon", "data": "datum",
        "analyses": "analysis", "theses": "thesis", "crises": "crisis",
        "indices": "index", "matrices": "matrix",
    },
    "ADJ": {
        "better": "good", "best": "good", "worse": "bad", "worst": "bad",
        "further": "far", "furthest": "far", "farther": "far", "farthest": "far",
    },
    "ADV": {"better": "well", "best": "well", "worse": "badly", "worst": "badly"},
}


class LemmatizerComponent(Component):

    default_score_weights = {"lemma_acc": 1.0}
    trainable = False
    listens = False

    def __init__(self, name: str, model_cfg: Optional[Dict[str, Any]] = None,
                 mode: str = "lookup", tables_path: Optional[str] = None):
        super().__init__(name, model_cfg or {})
        if mode not in ("lookup", "rule"):
            raise ValueError(f"lemmatizer mode must be lookup/rule, got {mode!r}")
        self.mode = mode
        self.table: Dict[Tuple[str, str], str] = {}
        self.word_table: Dict[str, str] = {}
        # rule mode: per-POS rewrite rules, exceptions, valid-lemma index
        self.rules: Dict[str, List[List[str]]] = {
            p: [list(r) for r in rs] for p, rs in _EN_RULES.items()
        }
        self.exceptions: Dict[str, Dict[str, str]] = {
            p: dict(t) for p, t in _EN_EXCEPTIONS.items()
        }
        self.index: Dict[str, set] = {p: set() for p in self.rules}
        if tables_path:
            self._load_tables_file(tables_path)

    def _load_tables_file(self, path: str) -> None:
        """User tables (JSON ``{"rules": {POS: [[suffix, replacement],
        ...]}, "exceptions": {POS: {form: lemma}}, "index": {POS: [lemma,
        ...]}}``) replace the built-in ones, each key present. A missing
        file warns and keeps the built-in tables: a saved model's tables
        load from ``components.json`` afterwards."""
        if not Path(path).exists():
            warnings.warn(
                f"lemmatizer tables_path {path!r} not found; using built-in "
                "tables (serialized model tables, if any, load afterwards)"
            )
            return
        data = json.loads(Path(path).read_text(encoding="utf8"))
        if "rules" in data:
            self.rules = {p: [list(r) for r in rs] for p, rs in data["rules"].items()}
        if "exceptions" in data:
            self.exceptions = {p: dict(t) for p, t in data["exceptions"].items()}
        if "index" in data:
            self.index = {p: set(v) for p, v in data["index"].items()}
        for p in self.rules:
            self.index.setdefault(p, set())

    def build_model(self):
        self.model = None
        return None

    def add_labels_from(self, examples) -> None:
        counts: Dict[Tuple[str, str], Counter] = defaultdict(Counter)
        word_counts: Dict[str, Counter] = defaultdict(Counter)
        for eg in examples:
            ref = eg.reference
            if not ref.lemmas:
                continue
            for i, lemma in enumerate(ref.lemmas):
                if not lemma:
                    continue
                pos = ref.pos[i] if ref.pos else ""
                if self.mode == "rule":
                    if pos in self.index:
                        # the gold lemmas extend the index
                        self.index[pos].add(lemma.lower())
                    continue
                word = ref.words[i].lower()
                counts[(word, pos)][lemma] += 1
                word_counts[word][lemma] += 1
        if self.mode == "lookup":
            self.table = {k: c.most_common(1)[0][0] for k, c in counts.items()}
            self.word_table = {w: c.most_common(1)[0][0] for w, c in word_counts.items()}

    def finish_labels(self) -> None:
        pass

    def lemmatize_rule(self, word: str, pos: str) -> str:
        """Exceptions first; a form already in the index is a lemma; else
        the first suffix rewrite the index holds, else the first rewrite at
        all, else the form itself (lower-cased)."""
        low = word.lower()
        exc = self.exceptions.get(pos, {})
        if low in exc:
            return exc[low]
        rules = self.rules.get(pos)
        if rules is None:  # a POS with no rule table (PUNCT, PROPN, ...)
            return low
        index = self.index.get(pos, set())
        if low in index:
            return low
        first_rewrite: Optional[str] = None
        for suffix, repl in rules:
            if low.endswith(suffix) and len(low) > len(suffix):
                form = low[: -len(suffix)] + repl
                if form in index:
                    return form
                if first_rewrite is None:
                    first_rewrite = form
        return first_rewrite if first_rewrite is not None else low

    def lemmatize(self, word: str, pos: str = "") -> str:
        if self.mode == "rule":
            return self.lemmatize_rule(word, pos)
        low = word.lower()
        hit = self.table.get((low, pos)) or self.word_table.get(low)
        if hit:
            return hit
        for suffix, repl in _SUFFIX_RULES:
            if low.endswith(suffix) and len(low) > len(suffix) + 2:
                return low[: -len(suffix)] + repl
        return low

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        for doc in docs:
            pos_list = doc.pos or [""] * len(doc)
            doc.lemmas = [self.lemmatize(w, pos_list[i] if i < len(pos_list) else "")
                          for i, w in enumerate(doc.words)]

    def score(self, examples: List[Example]) -> Dict[str, float]:
        # spaCy's lemma_acc: exact (case-sensitive) match, missing gold left
        # out, None when no doc has gold lemmas
        return score_token_acc(examples, "lemma_acc", lambda d: d.lemmas)

    def table_data(self) -> Dict[str, Any]:
        data: Dict[str, Any] = {
            "mode": self.mode,
            "table": [[w, p, l] for (w, p), l in self.table.items()],
            "word_table": self.word_table,
        }
        if self.mode == "rule":  # lookup models never read these
            data["rules"] = self.rules
            data["exceptions"] = self.exceptions
            data["index"] = {p: sorted(v) for p, v in self.index.items()}
        return data

    def load_table_data(self, data: Dict[str, Any]) -> None:
        self.mode = data.get("mode", "lookup")
        self.table = {(w, p): l for w, p, l in data.get("table", [])}
        self.word_table = dict(data.get("word_table", {}))
        if "rules" in data:
            self.rules = {p: [list(r) for r in rs] for p, rs in data["rules"].items()}
        if "exceptions" in data:
            self.exceptions = {p: dict(t) for p, t in data["exceptions"].items()}
        if "index" in data:
            self.index = {p: set(v) for p, v in data["index"].items()}


@registry.factories("lemmatizer")
def make_lemmatizer(name: str, model: Optional[Dict[str, Any]] = None, mode: str = "lookup",
                    tables_path: Optional[str] = None) -> LemmatizerComponent:
    return LemmatizerComponent(name, model, mode=mode, tables_path=tables_path)
