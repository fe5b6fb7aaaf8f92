"""Token-pattern matcher shared by the entity ruler and the attribute ruler:
a copy of ``spacy_ray_tpu/pipeline/matcher.py`` (host side, spaCy's Matcher
pattern language).

* token keys: ``TEXT``, ``LOWER``, ``TAG``, ``POS``, ``LEMMA``, ``SHAPE``,
  ``LENGTH``, ``IS_DIGIT``, ``IS_ALPHA``, ``IS_TITLE``, ``IS_UPPER``,
  ``IS_LOWER``, ``IS_PUNCT``. TAG/POS/LEMMA read the doc's annotations, so
  rules using them run after the components that set them.
* values: a literal, or a predicate dict with any of ``REGEX``
  (``re.search``), ``IN``, ``NOT_IN``, ``==``, ``!=``, ``>=``, ``<=``,
  ``>``, ``<``, e.g. ``{"LOWER": {"IN": ["inc", "corp"]}}``.
* ``OP``: ``1`` (default), ``?``, ``*``, ``+``, ``!`` (negate, one token),
  ``{n}``, ``{n,m}``, ``{n,}``, ``{,m}``.

Matching is greedy with backtracking; :func:`match_pattern` returns the end
of the longest match. :func:`validate_token_patterns` checks patterns
eagerly, so a bad rule fails when it is added or loaded, not at the first
token.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from .vocab import shape_of

_PRED_OPS = ("REGEX", "IN", "NOT_IN", "==", "!=", ">=", "<=", ">", "<")
_BOOL_KEYS = {
    "IS_DIGIT": str.isdigit,
    "IS_ALPHA": str.isalpha,
    "IS_TITLE": str.istitle,
    "IS_UPPER": str.isupper,
    "IS_LOWER": str.islower,
    "IS_PUNCT": lambda w: bool(w) and all(not c.isalnum() for c in w),
}
_DOC_KEYS = ("TEXT", "LOWER", "TAG", "POS", "LEMMA", "SHAPE", "LENGTH")
SUPPORTED_TOKEN_KEYS = _DOC_KEYS + tuple(_BOOL_KEYS) + ("OP",)

_OP_RE = re.compile(r"^(!|\?|\*|\+|1|\{\d+\}|\{\d+,\d*\}|\{,\d+\})$")


def _op_bounds(op: str) -> Tuple[int, Optional[int], bool]:
    """(min repeats, max repeats or None for unbounded, negate)."""
    if op == "1":
        return 1, 1, False
    if op == "!":
        return 1, 1, True
    if op == "?":
        return 0, 1, False
    if op == "*":
        return 0, None, False
    if op == "+":
        return 1, None, False
    m = _OP_RE.match(op)
    if m and op.startswith("{"):
        body = op[1:-1]
        if "," not in body:
            n = int(body)
            return n, n, False
        lo_s, hi_s = body.split(",", 1)
        lo = int(lo_s) if lo_s else 0
        hi = int(hi_s) if hi_s else None
        return lo, hi, False
    raise ValueError(f"Unsupported OP {op!r}")


def validate_token_patterns(patterns) -> None:
    """Check token-pattern lists (phrase strings pass): their keys, OP
    syntax and predicate dicts (REGEX must compile, IN/NOT_IN must be
    sequences, comparisons must suit the key's type)."""
    for pattern in patterns:
        if isinstance(pattern, str):
            continue
        for tok in pattern:
            for key, want in tok.items():
                if key == "OP":
                    op = str(want)
                    if not _OP_RE.match(op):
                        raise ValueError(
                            f"Unsupported OP {want!r}; supported: "
                            "1 ? * + ! {n} {n,m} {n,} {,m}"
                        )
                    _op_bounds(op)  # range syntax must parse
                    continue
                if key not in SUPPORTED_TOKEN_KEYS:
                    raise ValueError(
                        f"Unsupported token-pattern key {key!r}; "
                        f"supported: {sorted(SUPPORTED_TOKEN_KEYS)}"
                    )
                if isinstance(want, dict):
                    for pop, arg in want.items():
                        if pop not in _PRED_OPS:
                            raise ValueError(
                                f"Unsupported predicate {pop!r} for {key}; "
                                f"supported: {_PRED_OPS}"
                            )
                        if pop == "REGEX":
                            re.compile(arg)  # must compile now, not mid-match
                        elif pop in ("IN", "NOT_IN"):
                            if not isinstance(arg, (list, tuple, set)):
                                raise ValueError(
                                    f"{key}.{pop} wants a list, got "
                                    f"{type(arg).__name__}"
                                )
                        elif pop in (">=", "<=", ">", "<", "==", "!="):
                            # the comparison runs against the key's value
                            # type at match time: a mismatch there would be
                            # a TypeError in the middle of a prediction
                            if key == "LENGTH" and not isinstance(arg, (int, float)):
                                raise ValueError(
                                    f"LENGTH.{pop} wants a number, got "
                                    f"{type(arg).__name__}"
                                )
                            if (key != "LENGTH" and pop in (">=", "<=", ">", "<")
                                    and not isinstance(arg, str)):
                                raise ValueError(
                                    f"{key}.{pop} wants a string, got "
                                    f"{type(arg).__name__}"
                                )


def _attr_value(doc, i: int, key: str):
    w = doc.words[i]
    if key == "TEXT":
        return w
    if key == "LOWER":
        return w.lower()
    if key == "SHAPE":
        return shape_of(w)
    if key == "LENGTH":
        return len(w)
    if key == "TAG":
        return (doc.tags[i] if doc.tags else "") or ""
    if key == "POS":
        return (doc.pos[i] if doc.pos else "") or ""
    if key == "LEMMA":
        return (doc.lemmas[i] if doc.lemmas else "") or ""
    fn = _BOOL_KEYS.get(key)
    if fn is not None:
        return fn(w)
    raise ValueError(f"Unsupported token-pattern key {key!r}")


def _value_matches(actual, want) -> bool:
    if isinstance(want, dict):
        for op, arg in want.items():
            if op == "REGEX":
                ok = re.search(arg, str(actual)) is not None
            elif op == "IN":
                ok = actual in arg
            elif op == "NOT_IN":
                ok = actual not in arg
            elif op == "==":
                ok = actual == arg
            elif op == "!=":
                ok = actual != arg
            elif op == ">=":
                ok = actual >= arg
            elif op == "<=":
                ok = actual <= arg
            elif op == ">":
                ok = actual > arg
            elif op == "<":
                ok = actual < arg
            else:
                raise ValueError(f"Unsupported predicate {op!r}")
            if not ok:
                return False
        return True
    if isinstance(want, bool):
        return bool(actual) == want
    return actual == want


def token_matches(doc, i: int, constraint: Dict[str, Any]) -> bool:
    """Does token i of doc satisfy every (non-OP) key of the constraint?"""
    for key, want in constraint.items():
        if key == "OP":
            continue
        if not _value_matches(_attr_value(doc, i, key), want):
            return False
    return True


def match_pattern(doc, pattern: List[Dict[str, Any]], start: int) -> Optional[int]:
    """Match ``pattern`` at ``start``: the end (exclusive) of the longest
    match, or None. Greedy with backtracking."""
    n = len(doc.words)

    def rec(pi: int, wi: int) -> Optional[int]:
        if pi == len(pattern):
            return wi
        tok = pattern[pi]
        lo, hi, neg = _op_bounds(str(tok.get("OP", "1")))

        def ok(i: int) -> bool:
            if i >= n:
                return False
            m = token_matches(doc, i, tok)
            return (not m) if neg else m

        limit = (n - wi) if hi is None else min(hi, n - wi)
        cnt = 0
        while cnt < limit and ok(wi + cnt):
            cnt += 1
        for take in range(cnt, lo - 1, -1):
            got = rec(pi + 1, wi + take)
            if got is not None:
                return got
        return None

    return rec(0, start)
