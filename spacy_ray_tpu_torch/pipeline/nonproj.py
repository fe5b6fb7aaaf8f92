"""Pseudo-projective dependency transformation (Nivre & Nilsson 2005; a
copy of ``spacy_ray_tpu/pipeline/nonproj.py``).

The arc-eager machine (``pipeline/transition.py``) builds only projective
trees. Gold trees are projectivized before the oracle runs and predicted
trees deprojectivized after decoding, in the "head" encoding:

* ``projectivize``: lift the smallest non-projective arc to the grandparent
  until the tree is projective; each lifted dependent's label becomes
  ``childlabel||headlabel``, the label of its original head.
* ``deprojectivize``: for each decorated token, search the current head's
  subtree for the nearest token labelled ``headlabel`` and reattach there.

``heads[i] == i`` marks a root token.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

DELIMITER = "||"


def decompose_label(label: str) -> Tuple[str, str]:
    """'advmod||conj' -> ('advmod', 'conj'); undecorated -> (label, '')."""
    if DELIMITER in label:
        a, b = label.split(DELIMITER, 1)
        return a, b
    return label, ""


def is_decorated(label: str) -> bool:
    return DELIMITER in label


def _valid_heads(heads: Sequence[int]) -> bool:
    n = len(heads)
    return all(0 <= h < n for h in heads)


def _is_nonproj_arc(d: int, heads: Sequence[int]) -> bool:
    h = heads[d]
    if h == d:
        return False
    lo, hi = (h, d) if h < d else (d, h)
    for k in range(lo + 1, hi):
        hk = heads[k]
        # a root inside the span counts as non-projective too: its virtual
        # ROOT arc (from position -1) necessarily crosses (h, d)
        if hk == k or hk < lo or hk > hi:
            return True
    return False


def _smallest_nonproj_arc(heads: Sequence[int]) -> Optional[int]:
    best, best_size = None, None
    for d, h in enumerate(heads):
        if h == d:
            continue
        if _is_nonproj_arc(d, heads):
            size = abs(h - d)
            if best is None or size < best_size:
                best, best_size = d, size
    return best


def is_projective(heads: Sequence[int]) -> bool:
    """Strict projectivity: crossing arcs AND roots covered by another arc's
    span count as non-projective (both are unreachable for the arc-eager
    machine, whose virtual ROOT sits left of the sentence). Malformed input
    (out-of-range heads) is 'not projective' rather than an exception."""
    if not _valid_heads(heads):
        return False
    return _smallest_nonproj_arc(heads) is None


def projectivize(
    heads: Sequence[int], labels: Sequence[str]
) -> Optional[Tuple[List[int], List[str], int]]:
    """Lift non-projective arcs until the tree is projective.

    Returns (proj_heads, decorated_labels, n_lifted), or None if lifting
    failed to converge (malformed input: cycles, out-of-range heads).
    n_lifted == 0 means the tree was already projective (labels returned
    unchanged).
    """
    n = len(heads)
    if not _valid_heads(heads):
        return None
    proj = list(heads)
    lifted = set()
    max_iter = n * n + 10
    for _ in range(max_iter):
        d = _smallest_nonproj_arc(proj)
        if d is None:
            break
        h = proj[d]
        if not (0 <= h < n):
            return None
        gp = proj[h]
        # lift to the grandparent; when the head is itself a root, the
        # dependent becomes a root (its virtual-ROOT arc can't cross)
        proj[d] = d if gp == h else gp
        lifted.add(d)
    else:
        return None  # didn't converge within the bound
    deco = list(labels)
    for d in lifted:
        head_label = labels[heads[d]]
        # an empty head label can't guide reattachment — leave the lifted
        # arc undecorated (still trainable, just not recoverable) rather
        # than emit a dangling "label||"
        if head_label:
            deco[d] = f"{labels[d]}{DELIMITER}{head_label}"
    return proj, deco, len(lifted)


def _subtree(root: int, heads: Sequence[int]) -> List[int]:
    """All strict descendants of ``root`` (child edges from heads[])."""
    n = len(heads)
    children: List[List[int]] = [[] for _ in range(n)]
    for d, h in enumerate(heads):
        if h != d and 0 <= h < n:
            children[h].append(d)
    out: List[int] = []
    stack = list(children[root])
    while stack:
        k = stack.pop()
        out.append(k)
        stack.extend(children[k])
    return out


def deprojectivize(
    heads: Sequence[int], labels: Sequence[str]
) -> Tuple[List[int], List[str]]:
    """Undo the pseudo-projective transform on a PREDICTED tree.

    For each token whose label is decorated ``child||headlabel``: search the
    current head's subtree (the lift moved the token to an ancestor of its
    true head, so the true head is below) for the nearest token labeled
    ``headlabel`` and reattach. The decoration is stripped regardless; an
    unmatched search leaves the head where the parser put it.
    """
    n = len(heads)
    new_heads = list(heads)
    new_labels = list(labels)
    for d in range(n):
        if not is_decorated(labels[d]):
            continue
        base, head_label = decompose_label(labels[d])
        new_labels[d] = base  # strip the decoration unconditionally
        if not head_label:
            continue
        h = new_heads[d]
        # never reattach a token into its own subtree (would create a cycle)
        own = set(_subtree(d, new_heads))
        if h == d:  # lifted all the way to root: search the whole sentence
            candidates = [k for k in range(n) if k != d and k not in own]
        else:
            candidates = [
                k for k in _subtree(h, new_heads) if k != d and k not in own
            ]
        best = None
        for k in candidates:
            if decompose_label(labels[k])[0] == head_label:
                if best is None or abs(k - d) < abs(best - d):
                    best = k
        if best is not None:
            new_heads[d] = best
    return new_heads, new_labels
