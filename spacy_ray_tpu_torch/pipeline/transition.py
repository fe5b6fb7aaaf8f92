"""Arc-eager transition system: the host-side oracle and state features (a
copy of ``spacy_ray_tpu/pipeline/transition.py``).

Training is teacher-forced: the gold action sequence and the state-feature
token indices of every step follow from the gold tree, so they are computed
here on the host as dense int arrays, and the device only gathers trunk
vectors at those indices and classifies the actions. Decoding runs the same
machine on the device (``models/parser.py``).

Action encoding: 0 = SHIFT, 1 = REDUCE, 2+2i = LEFT-ARC(label_i),
3+2i = RIGHT-ARC(label_i).

State features (12 token slots, -1 = absent, a zero vector after the
gather): s0, s1, s2 (top three of the stack), b0, b1, b2 (front three of
the buffer), s0.l, s0.r (leftmost and rightmost child of s0), s1.l, s1.r,
s0.l2, s0.r2 (second-leftmost and second-rightmost child of s0).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

N_FEATURES = 12

SHIFT = 0
REDUCE = 1


def n_actions(n_labels: int) -> int:
    return 2 + 2 * n_labels


def left_arc(label_id: int) -> int:
    return 2 + 2 * label_id


def right_arc(label_id: int) -> int:
    return 3 + 2 * label_id


def action_label(action: int) -> int:
    """label id of an arc action (undefined for SHIFT/REDUCE)."""
    return (action - 2) // 2


def is_left_arc(action: int) -> bool:
    return action >= 2 and (action - 2) % 2 == 0


def is_right_arc(action: int) -> bool:
    return action >= 2 and (action - 2) % 2 == 1


class ParseState:
    """Mutable arc-eager state over one sentence (host side, numpy ints).

    ROOT is the virtual index -1 sitting at the bottom of the stack; tokens
    whose gold head is themselves (our Doc convention for root, see
    training/corpus.py conllu reader) are attached to ROOT.
    """

    def __init__(self, n: int):
        self.n = n
        self.stack: List[int] = []  # ROOT implicit below stack[0]
        self.buffer = 0  # index of b0; buffer is [buffer, n)
        self.heads = np.full(n, -2, dtype=np.int64)  # -2 = unattached, -1 = ROOT
        self.labels = np.zeros(n, dtype=np.int64)
        self.lchild = np.full((n, 2), -1, dtype=np.int64)  # two leftmost children
        self.rchild = np.full((n, 2), -1, dtype=np.int64)  # two rightmost children

    # ------------------------------------------------------------------
    def is_terminal(self) -> bool:
        return self.buffer >= self.n and len(self.stack) == 0

    def _add_arc(self, head: int, dep: int, label: int) -> None:
        self.heads[dep] = head
        self.labels[dep] = label
        if head >= 0:
            if dep < head:
                l0, l1 = self.lchild[head]
                if l0 == -1 or dep < l0:
                    self.lchild[head] = (dep, l0)
                elif l1 == -1 or dep < l1:
                    self.lchild[head, 1] = dep
            else:
                r0, r1 = self.rchild[head]
                if r0 == -1 or dep > r0:
                    self.rchild[head] = (dep, r0)
                elif r1 == -1 or dep > r1:
                    self.rchild[head, 1] = dep

    def valid_mask(self, n_labels: int) -> np.ndarray:
        """Boolean [n_actions] mask of structurally valid actions."""
        mask = np.zeros(n_actions(n_labels), dtype=bool)
        has_b0 = self.buffer < self.n
        has_s0 = len(self.stack) > 0
        s0_has_head = has_s0 and self.heads[self.stack[-1]] != -2
        if has_b0:
            mask[SHIFT] = True
        if has_s0 and s0_has_head:
            mask[REDUCE] = True
        if has_s0 and has_b0 and not s0_has_head:
            for i in range(n_labels):
                mask[left_arc(i)] = True
        if has_b0:
            if has_s0:
                for i in range(n_labels):
                    mask[right_arc(i)] = True
        # Dead-end escape: if buffer exhausted but stack non-empty, allow
        # REDUCE of headless tokens by attaching to ROOT implicitly at end.
        if not mask.any() and has_s0:
            mask[REDUCE] = True
        return mask

    def apply(self, action: int) -> None:
        if action == SHIFT:
            self.stack.append(self.buffer)
            self.buffer += 1
        elif action == REDUCE:
            s0 = self.stack.pop()
            if self.heads[s0] == -2:  # dead-end escape: default to ROOT
                self._add_arc(-1, s0, 0)
        elif is_left_arc(action):
            s0 = self.stack.pop()
            self._add_arc(self.buffer, s0, action_label(action))
        elif is_right_arc(action):
            b0 = self.buffer
            head = self.stack[-1] if self.stack else -1
            self._add_arc(head, b0, action_label(action))
            self.stack.append(b0)
            self.buffer += 1
        else:
            raise ValueError(f"unknown action {action}")

    def features(self) -> np.ndarray:
        """[N_FEATURES] token indices (-1 = absent)."""
        f = np.full(N_FEATURES, -1, dtype=np.int64)
        st = self.stack
        if len(st) >= 1:
            f[0] = st[-1]
        if len(st) >= 2:
            f[1] = st[-2]
        if len(st) >= 3:
            f[2] = st[-3]
        for k in range(3):
            if self.buffer + k < self.n:
                f[3 + k] = self.buffer + k
        if len(st) >= 1:
            s0 = st[-1]
            f[6] = self.lchild[s0, 0]
            f[7] = self.rchild[s0, 0]
            f[10] = self.lchild[s0, 1]
            f[11] = self.rchild[s0, 1]
        if len(st) >= 2:
            s1 = st[-2]
            f[8] = self.lchild[s1, 0]
            f[9] = self.rchild[s1, 0]
        return f


def is_projective(heads: Sequence[int]) -> bool:
    """Single source of truth lives in pipeline/nonproj.py (strict variant:
    crossing arcs and covered roots are both non-projective — both are
    unreachable for this machine). Re-exported here for the oracle's guard."""
    from .nonproj import is_projective as _isp

    return _isp(heads)


def gold_oracle(
    heads: Sequence[int], label_ids: Sequence[int], n_labels: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Static arc-eager oracle: teacher-forced training data for one doc.

    Returns (actions [S], features [S, N_FEATURES], valid [S, n_actions])
    or None if the tree is unusable (the standard arc-eager restriction:
    non-projective arcs are unreachable; such docs are skipped for parser
    training, matching the projective-only capability of greedy arc-eager).

    ``heads[i] == i`` marks the root token (attached to virtual ROOT via the
    final REDUCE escape).
    """
    n = len(heads)
    gold_heads = [(-1 if heads[i] == i else heads[i]) for i in range(n)]
    if not is_projective(heads):
        return None
    state = ParseState(n)
    actions: List[int] = []
    feats: List[np.ndarray] = []
    valids: List[np.ndarray] = []
    max_steps = 4 * n + 4
    while not state.is_terminal() and len(actions) < max_steps:
        feats.append(state.features())
        valids.append(state.valid_mask(n_labels))
        action = _oracle_action(state, gold_heads, label_ids, n_labels)
        if action is None or not valids[-1][action]:
            return None  # oracle stuck (shouldn't happen on projective trees)
        actions.append(action)
        state.apply(action)
    if not state.is_terminal():
        return None
    # verify replay reproduced the gold tree (sanity: oracle correctness)
    ok = all(
        state.heads[d] == gold_heads[d]
        for d in range(n)
    )
    if not ok:
        return None
    return (
        np.asarray(actions, dtype=np.int64),
        np.stack(feats).astype(np.int64),
        np.stack(valids),
    )


def _oracle_action(
    state: ParseState, gold_heads: List[int], label_ids: Sequence[int], n_labels: int
) -> Optional[int]:
    """Static arc-eager oracle (Nivre-style priority):

    1. LEFT-ARC  if gold head of s0 is b0 (and s0 headless)
    2. RIGHT-ARC if gold head of b0 is s0
    3. REDUCE    if s0 is attached, has no remaining gold dependents in the
                 buffer, and popping it is needed: b0's gold head (or a gold
                 dependent of b0) lies strictly below s0 in the stack / ROOT
    4. SHIFT     otherwise
    """
    st = state.stack
    b0 = state.buffer if state.buffer < state.n else None
    s0 = st[-1] if st else None
    if b0 is None:
        return REDUCE if s0 is not None else None
    if s0 is not None:
        if gold_heads[s0] == b0 and state.heads[s0] == -2:
            return left_arc(label_ids[s0])
        if gold_heads[b0] == s0:
            return right_arc(label_ids[b0])
        if state.heads[s0] != -2:
            s0_done = all(
                gold_heads[k] != s0 for k in range(state.buffer, state.n)
            )
            below = set(st[:-1])
            below.add(-1)  # virtual ROOT
            need_pop = gold_heads[b0] in below or any(
                i >= 0 and gold_heads[i] == b0 for i in below
            )
            if s0_done and need_pop:
                return REDUCE
    return SHIFT
