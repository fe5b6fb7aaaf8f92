"""Rule-based word tokenizer (host side), a copy of
``spacy_ray_tpu/pipeline/tokenizer.py``.

Per whitespace chunk, repeatedly: exact-match special cases (tokenizer
exceptions), then ``token_match`` (URLs, emails, numbers kept whole), then
strip one PREFIX, then one SUFFIX, and finally split the rest on INFIXES.
Token texts concatenate exactly to the chunk text, so ``spaces`` always
reconstructs the original text.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from .doc import Doc

_QUOTES = "\"'``''‘’“”«»„"
_OPENERS = r"\(\[\{<"
_CLOSERS = r"\)\]\}>"
_CURRENCY = "$£€¥₹₩"

DEFAULT_PREFIXES: Sequence[str] = (
    rf"[{_OPENERS}]",
    rf"[{re.escape(_QUOTES)}]",
    rf"[{re.escape(_CURRENCY)}]",
    r"[§#@&*]",
    r"\.\.\.|…",
    r"[-–—]",
)

_CLITICS = (
    r"(?:['’]s|['’]S|n['’]t|N['’]T"
    r"|['’]ll|['’]re|['’]ve|['’]m|['’]d"
    r"|['’]LL|['’]RE|['’]VE|['’]M|['’]D)"
)

DEFAULT_SUFFIXES: Sequence[str] = (
    rf"[{_CLOSERS}]",
    rf"[{re.escape(_QUOTES)}]",
    rf"[{re.escape(_CURRENCY)}]",         # 50€
    r"\.\.\.|…",
    r"[.,!?:;%°]",
    r"[-–—]",
    _CLITICS,
)

DEFAULT_INFIXES: Sequence[str] = (
    r"\.\.\.|…",
    r"--+|[–—]",
    r"[\(\)\[\]\{\}<>]",                  # mid-chunk brackets: foo(bar)
    r"(?<=[a-zA-Z])[-](?=[a-zA-Z])",      # well-known -> well - known
    r"(?<=\w)[,;:!?](?=\w)",              # missing space after punctuation
    r"(?<=[a-z0-9])\.(?=[A-Z])",          # sentence glue: end.Next
    r"(?<=[a-zA-Z])[/](?=[a-zA-Z])",      # either/or
    # symbol glue: price=5, x^2, a|b — deliberately NOT & or + or *, which
    # live inside real tokens (AT&T, R&D, 1e+5, C*-algebra)
    r"(?<=\w)[=~^|](?=\w)",
)

# kept whole regardless of punctuation inside (spaCy's token_match/url_match).
# URLs must not end in terminal punctuation, so "see https://x.io/a," still
# sheds the comma via the suffix rule before the URL matches on recursion.
DEFAULT_TOKEN_MATCH = (
    r"^(?:https?://|www\.)\S*[^\s.,!?;:'\"\)\]\}]$"  # URLs
    r"|^[\w.+-]+@[\w-]+(?:\.[\w-]+)+$"     # emails
    r"|^\d+(?:[.,]\d+)*$"                  # numbers incl. 1,000.5
    r"|^(?:[A-Za-z]\.){2,}$"               # U.S., e.g., i.e.
)


def _english_exceptions() -> Dict[str, List[str]]:
    """Contractions + abbreviations; pieces must concatenate to the key."""
    exc: Dict[str, List[str]] = {}
    # irregular contractions (spelling changes across the split point)
    for base, pieces in {
        "can't": ["ca", "n't"], "won't": ["wo", "n't"], "shan't": ["sha", "n't"],
        "cannot": ["can", "not"], "gonna": ["gon", "na"], "gotta": ["got", "ta"],
        "lemme": ["lem", "me"], "wanna": ["wan", "na"], "'cause": ["'cause"],
    }.items():
        exc[base] = pieces
        exc[base.capitalize()] = [pieces[0].capitalize()] + pieces[1:]
    # abbreviations that end in '.' (must not lose the period to suffixing)
    for abbr in (
        "etc.", "vs.", "v.s.", "Mr.", "Mrs.", "Ms.", "Dr.", "Prof.", "St.",
        "Ave.", "Inc.", "Ltd.", "Co.", "Corp.", "No.", "approx.", "est.",
        "a.m.", "p.m.", "Jan.", "Feb.", "Mar.", "Apr.", "Jun.", "Jul.",
        "Aug.", "Sep.", "Sept.", "Oct.", "Nov.", "Dec.",
    ):
        exc[abbr] = [abbr]
    return exc


class Tokenizer:
    def __init__(
        self,
        exceptions: Optional[Dict[str, List[str]]] = None,
        prefixes: Optional[Sequence[str]] = None,
        suffixes: Optional[Sequence[str]] = None,
        infixes: Optional[Sequence[str]] = None,
        token_match: Optional[str] = None,
    ):
        self.exceptions = dict(
            exceptions if exceptions is not None else _english_exceptions()
        )
        for key, pieces in self.exceptions.items():
            if "".join(pieces) != key:
                raise ValueError(
                    f"tokenizer exception {key!r} pieces {pieces} do not "
                    "concatenate to the key (would break text alignment)"
                )
        self._prefix_re = re.compile(
            "|".join(prefixes if prefixes is not None else DEFAULT_PREFIXES)
        )
        suf = suffixes if suffixes is not None else DEFAULT_SUFFIXES
        self._suffix_re = re.compile("(?:" + "|".join(suf) + ")$")
        self._infix_re = re.compile(
            "|".join(infixes if infixes is not None else DEFAULT_INFIXES)
        )
        self._token_match_re = re.compile(
            token_match if token_match is not None else DEFAULT_TOKEN_MATCH
        )

    # ------------------------------------------------------------------
    def __call__(self, text: str) -> Doc:
        words: List[str] = []
        spaces: List[bool] = []
        for m in re.finditer(r"\S+", text):
            chunk = m.group(0)
            end = m.end()
            pieces = self._tokenize_chunk(chunk)
            for i, piece in enumerate(pieces):
                words.append(piece)
                spaces.append(
                    (end < len(text)) if i == len(pieces) - 1 else False
                )
        return Doc(words=words, spaces=spaces)

    # ------------------------------------------------------------------
    def _tokenize_chunk(self, chunk: str, depth: int = 0) -> List[str]:
        if not chunk:
            return []
        if depth > 2 * len(chunk) + 8:  # defensive: rules must consume chars
            return [chunk]
        if chunk in self.exceptions:
            return list(self.exceptions[chunk])
        if self._token_match_re.match(chunk):
            return [chunk]
        m = self._prefix_re.match(chunk)
        if m and 0 < m.end() < len(chunk):
            return [m.group(0)] + self._tokenize_chunk(chunk[m.end():], depth + 1)
        if m and m.end() == len(chunk):
            return [chunk]  # the whole chunk is one prefix-class token
        m = self._suffix_re.search(chunk)
        if m and 0 < m.start() < len(chunk):
            return self._tokenize_chunk(chunk[: m.start()], depth + 1) + [m.group(0)]
        if m and m.start() == 0:
            return [chunk]
        pieces: List[tuple] = []  # (text, is_infix_token)
        pos = 0
        for im in self._infix_re.finditer(chunk):
            if im.start() == 0 or im.end() == im.start():
                continue
            if im.start() > pos:
                pieces.append((chunk[pos : im.start()], False))
            pieces.append((im.group(0), True))
            pos = im.end()
        if pos == 0:
            return [chunk]
        if pos < len(chunk):
            pieces.append((chunk[pos:], False))
        # re-tokenize the non-infix pieces fully: "it's,fine" must split the
        # clitic in "it's" exactly as it would with a space after it
        out: List[str] = []
        for piece, is_infix in pieces:
            if is_infix:
                out.append(piece)
            else:
                out.extend(self._tokenize_chunk(piece, depth + 1))
        return out
