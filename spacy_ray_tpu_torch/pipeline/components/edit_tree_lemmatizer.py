"""``trainable_lemmatizer``: lemmas by edit trees (counterpart of
``spacy_ray_tpu/pipeline/components/edit_tree_lemmatizer.py``).

On the host at initialize, each (form, lemma) pair induces an edit tree: a
recursive longest-common-substring split with substitution leaves. The
trees seen at least ``min_tree_freq`` times are the labels, the identity
tree first. On the device, the tagger's head and loss classify each token
over the trees. On the host at decode, each token tries its ``top_k`` best
trees in order and takes the first that applies to its form (a tree is
partial), else keeps the form. Scored by ``lemma_acc``.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ...registry import registry
from ..doc import Doc, Example
from .tagger import TaggerComponent

# An edit tree is nested tuples:
#   ("s", orig, subst)                      a substitution leaf
#   ("m", pfx_len, sfx_len, left, right)    a match node: the middle (the
#       longest common substring) is kept; left rewrites the first pfx_len
#       characters, right the last sfx_len (None: the identity)
Tree = Union[Tuple, None]


def _lcs(a: str, b: str) -> Tuple[int, int, int]:
    """(start in a, start in b, length) of the longest common substring."""
    best = (0, 0, 0)
    if not a or not b:
        return best
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        for j in range(1, len(b) + 1):
            if a[i - 1] == b[j - 1]:
                cur[j] = prev[j - 1] + 1
                if cur[j] > best[2]:
                    best = (i - cur[j], j - cur[j], cur[j])
        prev = cur
    return best


def build_tree(form: str, lemma: str) -> Tree:
    """The edit tree that rewrites ``form`` into ``lemma``."""
    if form == lemma:
        return None
    sa, sb, n = _lcs(form, lemma)
    if n == 0:
        return ("s", form, lemma)
    left = build_tree(form[:sa], lemma[:sb])
    right = build_tree(form[sa + n:], lemma[sb + n:])
    return ("m", sa, len(form) - sa - n, left, right)


def apply_tree(tree: Tree, form: str) -> Optional[str]:
    """The tree applied to ``form``; None where it does not match."""
    if tree is None:
        return form
    if tree[0] == "s":
        return tree[2] if form == tree[1] else None
    _, pfx, sfx, left, right = tree
    if pfx + sfx > len(form):
        return None
    mid = form[pfx:len(form) - sfx] if sfx else form[pfx:]
    lp = apply_tree(left, form[:pfx])
    if lp is None:
        return None
    rp = apply_tree(right, form[len(form) - sfx:] if sfx else "")
    if rp is None:
        return None
    return lp + mid + rp


def tree_key(tree: Tree) -> str:
    return json.dumps(tree, separators=(",", ":"), ensure_ascii=False)


def tree_from_key(key: str) -> Tree:
    def tup(x):
        return tuple(tup(v) for v in x) if isinstance(x, list) else x

    return tup(json.loads(key))


class EditTreeLemmatizerComponent(TaggerComponent):

    default_score_weights = {"lemma_acc": 1.0}

    def __init__(self, name: str, model_cfg: Dict[str, Any], *, min_tree_freq: int = 3,
                 top_k: int = 3, overwrite: bool = True):
        super().__init__(name, model_cfg)
        self.min_tree_freq = int(min_tree_freq)
        self.top_k = int(top_k)
        self.overwrite = bool(overwrite)

    def add_labels_from(self, examples) -> None:
        counts: Counter = Counter()
        for eg in examples:
            ref = eg.reference
            for i, lemma in enumerate(ref.lemmas or []):
                if lemma:
                    counts[tree_key(build_tree(ref.words[i], lemma))] += 1
        kept = {k for k, c in counts.items() if c >= self.min_tree_freq}
        kept.discard(tree_key(None))
        self.labels = list(set(self.labels) | kept)

    def finish_labels(self) -> None:
        """The identity tree first (the decode's fallback), the rest sorted."""
        ident = tree_key(None)
        self.labels = [ident] + sorted(l for l in self.labels if l != ident)

    @property
    def trees(self) -> List[Tree]:
        """The labels' trees, rebuilt whenever the label list is replaced
        (``from_disk`` assigns it)."""
        if getattr(self, "_trees_for", None) is not self.labels:
            self._trees = [tree_from_key(k) for k in self.labels]
            self._trees_for = self.labels
        return self._trees

    def make_targets(self, examples: List[Example], B: int, T: int) -> Dict[str, np.ndarray]:
        label_ids = {label: i for i, label in enumerate(self.labels)}
        tags = np.zeros((B, T), dtype=np.int32)
        mask = np.zeros((B, T), dtype=bool)
        # per-Example cache, keyed by the label tuple: tree induction is a
        # dynamic program per token, and examples recur every epoch
        cache_key = tuple(self.labels)
        for i, eg in enumerate(examples):
            ref = eg.reference
            if not ref.lemmas:
                continue
            cached = getattr(eg, "_etl_target_cache", None)
            if cached is None or cached[0] != cache_key:
                ids = np.zeros(len(ref.lemmas), dtype=np.int32)
                valid = np.zeros(len(ref.lemmas), dtype=bool)
                for j, lemma in enumerate(ref.lemmas):
                    if not lemma:
                        continue
                    tid = label_ids.get(tree_key(build_tree(ref.words[j], lemma)))
                    if tid is not None:
                        ids[j] = tid
                        valid[j] = True
                eg._etl_target_cache = cached = (cache_key, ids, valid)
            _, ids, valid = cached
            n = min(len(ids), T)
            tags[i, :n] = ids[:n]
            mask[i, :n] = valid[:n]
        return {"tags": tags, "tag_mask": mask}

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        logits = outputs.X.float().cpu().numpy()  # [B, T, L]
        k = min(self.top_k, logits.shape[-1])
        # the top k per token, best first
        part = np.argpartition(-logits, k - 1, axis=-1)[..., :k]
        order = np.take_along_axis(logits, part, axis=-1).argsort(axis=-1)[..., ::-1]
        topk = np.take_along_axis(part, order, axis=-1)  # [B, T, k]
        for i, doc in enumerate(docs):
            if doc.lemmas and not self.overwrite:
                continue
            lemmas = []
            for j in range(lengths[i]):
                form = doc.words[j]
                out = None
                for tid in topk[i, j]:
                    out = apply_tree(self.trees[tid], form)
                    if out:  # an empty string is no match
                        break
                    out = None
                lemmas.append(out if out else form)
            doc.lemmas = lemmas + list(doc.words[lengths[i]:])

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        from ..scoring import score_token_acc

        return score_token_acc(examples, "lemma_acc", lambda d: d.lemmas)


@registry.factories("trainable_lemmatizer")
def make_trainable_lemmatizer(name: str, model: Dict[str, Any], min_tree_freq: int = 3,
                              top_k: int = 3,
                              overwrite: bool = True) -> EditTreeLemmatizerComponent:
    return EditTreeLemmatizerComponent(name, model, min_tree_freq=min_tree_freq, top_k=top_k,
                                       overwrite=overwrite)
