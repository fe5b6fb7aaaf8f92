"""TransitionBasedParser: trunk vectors gathered at state features, a maxout
hidden layer and a linear action layer, and the decodes of the parser
(arc-eager) and the NER (BILUO). Counterpart of
``spacy_ray_tpu/models/parser.py``.

Training is teacher-forced: the host computes every step's state features
(``pipeline/transition.py``), so the loss is one gather and two matmuls over
the doc x step grid (:meth:`ParserUpper.step_logits`), as in the JAX package.

Decoding has a fixed number of steps (``2T + 2`` for the parser, ``T`` for
the BILUO automata) and no host synchronisation inside the loop, so one
decode can be captured as a CUDA graph per (B, T) bucket
(``pipeline/decode_graph.py``) and replayed; elsewhere the same step
functions run eagerly. In JAX the loop is a ``lax.scan`` that XLA fuses; run
eagerly in PyTorch each op of a step is a kernel launch, so the steps are
written with few ops:

* the parser's whole state is one int64 tensor ``[N, L]`` per row (stack,
  buffer position, heads, labels, the two leftmost and rightmost children,
  sentinel slots that make absent tokens read -1, a dump slot for writes an
  action does not make). A step reads it with two gathers and writes it with
  one scatter; what an action writes where is a lookup table indexed by
  (validity code, action). The hidden layer's input projection is
  precomputed per token and feature slot once per decode (``X @ W_f``, the
  "precomputable affine" of spaCy's parser), so a step sums 12 gathered rows
  instead of multiplying a ``[N, 12 * D]`` gather by ``hidden_W``;
* the BILUO automata read their masks and transitions from lookup tables
  indexed by the automaton state; the Viterbi scores every action from its
  fixed predecessor state in one gather and reduces the two kinds of next
  state with one ``max`` each.

The results are the JAX decodes' integers (the tests hold them equal on the
same inputs); ties break toward the lower index as in ``argmax`` and
``lax.top_k`` (the beam sorts stably).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import ops as O
from ..pipeline import transition as TS
from ..registry import registry
from ..types import Padded
from .core import Context, Model, call, empty_param, glorot_uniform_, zeros_param

PARSER_N_FEATURES = TS.N_FEATURES
NER_N_FEATURES = 5  # token window [t-2, t-1, t, t+1, t+2]
NEG = -1e9          # logit of an invalid action (the JAX decodes' constant)
NEG_VITERBI = -1e30


def ner_window_features(Tlen: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T, 5] window indices [t-2 .. t+2], -1 outside [0, length)."""
    lengths = torch.as_tensor(lengths)
    grid = (torch.arange(Tlen, device=lengths.device)[None, :, None]
            + torch.arange(-2, 3, device=lengths.device)[None, None, :])
    ok = (grid >= 0) & (grid < lengths[:, None, None])
    return torch.where(ok, grid, torch.full_like(grid, -1)).to(torch.int32)


def _gather(X: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """X [B, T, D], feats [B, ..., F] -> [B, ..., F, D], -1 slots zeroed (the
    JAX package's clip-and-mask gather, which it runs off the TPU)."""
    B, Tlen = X.shape[:2]
    safe = feats.clamp(0, Tlen - 1).long()
    rows = torch.arange(B, device=X.device).view(B, *([1] * (feats.dim() - 1)))
    out = X[rows, safe]
    return out * (feats >= 0).unsqueeze(-1).to(X.dtype)


class ParserUpper(Model):
    """The state-to-action MLP: ``hidden_W [F*D, H*P]``, ``hidden_b [H, P]``,
    ``out_W [H, nA]``, ``out_b [nA]`` (the JAX ``ParserModelFns`` params)."""

    def __init__(self, n_feats: int, width: int, hidden: int, pieces: int,
                 n_actions: int):
        super().__init__("upper", dims={"n_feats": n_feats, "width": width,
                                        "hidden": hidden, "pieces": pieces,
                                        "nO": n_actions})
        self.hidden_W = empty_param(n_feats * width, hidden * pieces)
        self.hidden_b = zeros_param(hidden, pieces)
        self.out_W = empty_param(hidden, n_actions)
        self.out_b = zeros_param(n_actions)

    @property
    def n_feats(self) -> int:
        return self.dims["n_feats"]

    @property
    def n_actions(self) -> int:
        return self.dims["nO"]

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.hidden_W, generator)
        glorot_uniform_(self.out_W, generator)

    def logits(self, state_vecs: torch.Tensor) -> torch.Tensor:
        """state_vecs [..., F*D] -> [..., n_actions]."""
        h = O.maxout(state_vecs, self.hidden_W, self.hidden_b)
        return h @ self.out_W + self.out_b

    def step_logits(self, X: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        """X [B, T, D], feats [B, S, F] -> [B, S, nA] (the training grid)."""
        vecs = _gather(X, feats)
        return self.logits(vecs.reshape(*vecs.shape[:-2], -1))

    def token_projection(self, X: torch.Tensor) -> torch.Tensor:
        """``P [(B * (T+1) * F), H*P]``: row ``(b * (T+1) + t + 1) * F + f``
        holds ``X[b, t] @ W_f`` and row ``(b * (T+1)) * F + f`` (an absent
        token) zeros; ``hidden_b`` is folded into slot f = 0, so the sum of a
        state's F rows is its hidden pre-activation."""
        F_, D = self.n_feats, X.shape[-1]
        HP = self.hidden_W.shape[1]
        W = self.hidden_W.view(F_, D, HP).permute(1, 0, 2).reshape(D, F_ * HP)
        Xp = F.pad(X, (0, 0, 1, 0))                               # [B, T+1, D]
        P = (Xp.reshape(-1, D) @ W).view(-1, F_, HP)              # [B*(T+1), F, HP]
        P[:, 0] += self.hidden_b.reshape(-1)
        return P.view(-1, HP)

    def state_logits(self, P: torch.Tensor, pidx: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [N, nA] of N states from their projection rows pidx [N, F];
        ``bias`` [N, nA] in place of ``out_b``."""
        N = pidx.shape[0]
        hid = P.index_select(0, pidx.reshape(-1)).view(N, self.n_feats, -1).sum(1)
        h = hid.view(N, *self.hidden_b.shape).amax(-1)
        return torch.addmm(self.out_b if bias is None else bias, h, self.out_W)


class TransitionModel(Model):
    """tok2vec (a listener, or a trunk of its own) + :class:`ParserUpper`;
    parameters at ``tok2vec/...`` and ``upper/...``. The trunk of its own
    runs under the loss's context (dropout, the aux sink), as in JAX."""

    takes_ctx = True

    def __init__(self, tok2vec: Model, upper: ParserUpper, state_type: str):
        super().__init__(
            f"transition_model_{state_type}",
            dims={"nO": upper.n_actions, "width": upper.dims["width"],
                  "hidden": upper.dims["hidden"], "n_feats": upper.n_feats},
            meta={"has_listener": any(m.meta.get("listener") for m in tok2vec.walk()),
                  "state_type": state_type},
        )
        self.tok2vec = tok2vec
        self.upper = upper

    def forward(self, x, ctx: Optional[Context] = None) -> torch.Tensor:
        """x = (trunk input or output, feats [B, S, F]) -> [B, S, nA]."""
        inputs, feats = x
        t2v: Padded = call(self.tok2vec, inputs, ctx or Context())
        return self.upper.step_logits(t2v.X, feats)


@registry.architectures("spacy.TransitionBasedParser.v1")
@registry.architectures("spacy.TransitionBasedParser.v2")
def TransitionBasedParser(
    tok2vec: Model,
    state_type: str = "parser",
    extra_state_tokens: bool = False,
    hidden_width: int = 64,
    maxout_pieces: int = 2,
    use_upper: bool = True,
    nO: Optional[int] = None,
) -> TransitionModel:
    """nO = the number of actions (set at initialize from the labels)."""
    width = tok2vec.dims.get("nO")
    n_feats = PARSER_N_FEATURES if state_type == "parser" else NER_N_FEATURES
    upper = ParserUpper(n_feats, width, hidden_width, maxout_pieces, nO if nO else 3)
    return TransitionModel(tok2vec, upper, state_type)


# ----------------------------------------------------------------------
# The arc-eager machine on the device
# ----------------------------------------------------------------------

# kinds of a step's effect (the write tables' rows)
_SHIFT, _REDUCE_HEADLESS, _LEFT, _RIGHT, _NOOP, _REDUCE_HEADED = range(6)


class ArcEagerPlan:
    """The constants of one decode shape: N rows (B, or B*K for the beam) of
    T tokens, ``n_labels`` arc labels, on ``device``. Built outside a CUDA
    graph capture and reused by every decode of that shape.

    A row of the state S [N, L] (int64) holds, by column::

        0 sp, 1 buf, 2 zero (always 0)
        3..5       -1 sentinels under the stack
        STK0 + i   stack[i], i in 0..T
        TOK0 + i   i if i < length else -1, i in 0..T+2 (static per decode)
        R + 1 + t  per region R in HEADS, LABELS, LC0, LC1, RC0, RC1, HCODE,
                   BFLAG: the value for token t; R itself is the value for
                   token -1 (heads -2, labels 0, children -1, HCODE and
                   BFLAG 0), never written. HCODE is 4 for a headless token
                   and 5 once it has a head; BFLAG is 2 (static)
        DUMP       the target of writes an action does not make

    A state's validity code, 4 [s0 exists] + 2 [b0 exists] + [s0 has a
    head], is then HCODE[s0] + BFLAG[b0]: one add.
    """

    def __init__(self, N: int, T: int, n_labels: int, device: torch.device,
                 group: int = 1):
        self.N, self.T, self.n_labels = N, T, n_labels
        self.n_actions = TS.n_actions(n_labels)
        nA = self.n_actions
        SP, BUF, Z = 0, 1, 2
        STK0 = 6
        TOK0 = STK0 + T + 1
        HEADS = TOK0 + T + 3
        LABELS, LC0, LC1, RC0, RC1, HCODE, BFLAG = (HEADS + (T + 1) * k for k in range(1, 8))
        DUMP = BFLAG + T + 1
        self.L = DUMP + 1
        self.TOK0, self.HEADS, self.LABELS = TOK0, HEADS, LABELS
        i64 = dict(dtype=torch.long, device=device)

        S0 = torch.full((self.L,), -1, dtype=torch.long)
        S0[[SP, BUF, Z]] = 0
        S0[HEADS:HEADS + T + 1] = -2
        S0[LABELS:LABELS + T + 1] = 0
        S0[HCODE:HCODE + T + 1] = 4
        S0[BFLAG:BFLAG + T + 1] = 2
        S0[[HCODE, BFLAG, DUMP]] = 0
        self.S0 = S0.to(device).expand(N, self.L).contiguous()
        self.tok_range = torch.arange(T + 3, **i64)
        self.self_idx = torch.arange(T, **i64).expand(N, T)

        # read 1: g1 = [sp, buf, 0, s0, s1, s2, b0, b1, b2]
        self.src1 = torch.tensor([Z, Z, Z, SP, SP, SP, BUF, BUF, BUF], **i64)
        self.off1 = torch.tensor([SP, BUF, Z, STK0 - 1, STK0 - 2, STK0 - 3,
                                  TOK0, TOK0 + 1, TOK0 + 2], **i64)
        # read 2: g2 = [s0l, s0r, s1l, s1r, s0l2, s0r2, HCODE[s0], lc0[b0], BFLAG[b0]]
        self.src2 = torch.tensor([3, 3, 4, 4, 3, 3, 3, 6, 6], **i64)
        self.off2 = torch.tensor([LC0 + 1, RC0 + 1, LC0 + 1, RC0 + 1, LC1 + 1,
                                  RC1 + 1, HCODE + 1, LC0 + 1, BFLAG + 1], **i64)
        # V = cat(g1, g2): 0 sp, 1 buf, 2 zero, 3 s0, 4 s1, 5 s2, 6 b0, 7 b1,
        # 8 b2, 9 s0l, 10 s0r, 11 s1l, 12 s1r, 13 s0l2, 14 s0r2, 15 HCODE[s0],
        # 16 lc0(b0), 17 BFLAG[b0]; the features are V[:, 3:15] in the JAX order
        cV = dict(sp=0, buf=1, zero=2, s0=3, b0=6, s0r=10, hcode=15, lc0b0=16, bflag=17)
        self.code_cols = (cV["hcode"], cV["bflag"])
        valid = torch.zeros(8, nA, dtype=torch.bool)
        for code in range(8):
            has_s0, has_b0, hh = bool(code & 4), bool(code & 2), bool(code & 1)
            valid[code, TS.SHIFT] = has_b0
            valid[code, TS.REDUCE] = has_s0 and (hh or not has_b0)
            valid[code, 2::2] = has_s0 and has_b0 and not hh
            valid[code, 3::2] = has_s0 and has_b0
        self.valid = valid.to(device)
        # the greedy decode adds NEG to the logits of invalid actions, in the
        # output layer's bias (the argmax is that of where(valid, logits, NEG))
        self.penalty = torch.where(valid, 0.0, NEG).to(device)

        # what a step writes: 8 (position, value) pairs, each V[:, src] + add;
        # a table row [8 position sources, 8 value sources, 8 position adds,
        # 8 value adds] per code * nA + action
        def writes(kind: int, label: int):
            dump = (cV["zero"], DUMP, cV["zero"], 0)
            sp_d = {_SHIFT: 1, _RIGHT: 1, _NOOP: 0, _REDUCE_HEADED: -1}.get(kind, -1)
            buf_d = 1 if kind in (_SHIFT, _RIGHT) else 0
            w = [(cV["zero"], SP, cV["sp"], sp_d), (cV["zero"], BUF, cV["buf"], buf_d)]
            if kind == _LEFT:       # head(s0) = b0; b0's new leftmost child is s0
                w += [(cV["s0"], HEADS + 1, cV["b0"], 0),
                      (cV["s0"], LABELS + 1, cV["zero"], label),
                      (cV["b0"], LC0 + 1, cV["s0"], 0),
                      (cV["b0"], LC1 + 1, cV["lc0b0"], 0), dump,
                      (cV["s0"], HCODE + 1, cV["zero"], 5)]
            elif kind == _RIGHT:    # head(b0) = s0; s0's new rightmost child is b0
                w += [(cV["b0"], HEADS + 1, cV["s0"], 0),
                      (cV["b0"], LABELS + 1, cV["zero"], label),
                      (cV["s0"], RC0 + 1, cV["b0"], 0),
                      (cV["s0"], RC1 + 1, cV["s0r"], 0),
                      (cV["sp"], STK0, cV["b0"], 0),
                      (cV["b0"], HCODE + 1, cV["zero"], 5)]
            elif kind == _SHIFT:
                w += [dump] * 4 + [(cV["sp"], STK0, cV["b0"], 0), dump]
            elif kind == _REDUCE_HEADLESS:  # the ROOT escape
                w += ([(cV["s0"], HEADS + 1, cV["zero"], -1)] + [dump] * 4
                      + [(cV["s0"], HCODE + 1, cV["zero"], 5)])
            else:
                w += [dump] * 6
            return ([x[0] for x in w] + [x[2] for x in w]
                    + [x[1] for x in w] + [x[3] for x in w])

        table = torch.zeros(8 * nA, 32, dtype=torch.long)
        for code in range(8):
            for a in range(nA):
                if not valid[code, a]:
                    kind = _NOOP    # also every action of a finished row
                elif a == TS.SHIFT:
                    kind = _SHIFT
                elif a == TS.REDUCE:
                    kind = _REDUCE_HEADED if code & 1 else _REDUCE_HEADLESS
                else:
                    kind = _LEFT if TS.is_left_arc(a) else _RIGHT
                table[code * nA + a] = torch.tensor(
                    writes(kind, TS.action_label(a) if a >= 2 else 0))
        self.writes = table.to(device)

        # row n's projection rows: (g(n) * (T+1) + feat + 1) * F + f, where
        # g(n) = n // group is the sentence of row n (the beam's K rows share one)
        Fn = PARSER_N_FEATURES
        g = torch.arange(N) // group
        self.pbase = (g[:, None] * (T + 1) * Fn + Fn + torch.arange(Fn)[None, :]).to(device)

    def init_state(self, lengths: torch.Tensor) -> torch.Tensor:
        S = self.S0.clone()
        tok = self.tok_range.expand(self.N, -1)
        S[:, self.TOK0:self.TOK0 + self.T + 3] = torch.where(
            tok < lengths[:, None], tok, torch.full_like(tok, -1))
        return S

    def read(self, S: torch.Tensor) -> torch.Tensor:
        """V [N, 18]: the state's scalars and features (see the layout)."""
        g1 = S.gather(1, S.index_select(1, self.src1) + self.off1)
        g2 = S.gather(1, g1.index_select(1, self.src2) + self.off2)
        return torch.cat((g1, g2), 1)

    def code(self, V: torch.Tensor) -> torch.Tensor:
        return torch.add(V[:, self.code_cols[0]], V[:, self.code_cols[1]])

    def apply(self, S: torch.Tensor, V: torch.Tensor, code: torch.Tensor,
              action: torch.Tensor) -> None:
        """Apply ``action`` [N] in place (a no-op on finished rows and for
        actions invalid in the row's state)."""
        w = self.writes.index_select(0, torch.add(action, code, alpha=self.n_actions))
        G = V.gather(1, w[:, :16]).add_(w[:, 16:])
        S.scatter_(1, G[:, :8], G[:, 8:])

    def result(self, S: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(heads [N, T] with ROOT as the self index, labels [N, T])."""
        T = self.T
        heads = S[:, self.HEADS + 1:self.HEADS + 1 + T]
        heads = torch.where(heads < 0, self.self_idx, heads)
        return heads, S[:, self.LABELS + 1:self.LABELS + 1 + T].clone()


def decode_parser(upper: ParserUpper, X: torch.Tensor, lengths: torch.Tensor,
                  n_labels: int, plan: Optional[ArcEagerPlan] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy arc-eager decode: X [B, T, D] trunk output, lengths [B].
    Returns (heads [B, T] with ROOT as the self index, labels [B, T]); a
    fixed ``2T + 2`` steps of 22 device operations each, no host
    synchronisation."""
    B, Tlen, _ = X.shape
    plan = plan or ArcEagerPlan(B, Tlen, n_labels, X.device)
    P = upper.token_projection(X)
    bias = plan.penalty + upper.out_b       # [8, nA]: the bias of each code
    S = plan.init_state(lengths)
    for _ in range(2 * Tlen + 2):
        V = plan.read(S)
        code = plan.code(V)
        logits = upper.state_logits(P, torch.add(plan.pbase, V[:, 3:15],
                                                 alpha=PARSER_N_FEATURES),
                                    bias.index_select(0, code))
        plan.apply(S, V, code, logits.argmax(1))
    return plan.result(S)


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` order: descending, the lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_parser_beam(upper: ParserUpper, X: torch.Tensor, lengths: torch.Tensor,
                       n_labels: int, beam_width: int,
                       plan: Optional[ArcEagerPlan] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search arc-eager decode, scored by summed action log-probs (the
    JAX package's ``decode_parser_beam``): states [B*K], the top K of each
    sentence's K * nA candidates kept every step. A finished beam offers one
    candidate (action 0) carrying its score."""
    K = int(beam_width)
    if K <= 1:
        return decode_parser(upper, X, lengths, n_labels, plan)
    B, Tlen, _ = X.shape
    plan = plan or ArcEagerPlan(B * K, Tlen, n_labels, X.device, group=K)
    nA = plan.n_actions
    P = upper.token_projection(X)
    S = plan.init_state(lengths.repeat_interleave(K))
    base = (torch.arange(B, device=X.device) * K)[:, None]
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=X.device)
    scores[:, 0] = 0.0
    noop = torch.full((B, K, nA), NEG, dtype=torch.float32, device=X.device)
    for _ in range(2 * Tlen + 2):
        V = plan.read(S)
        pidx = torch.add(plan.pbase, V[:, 3:15], alpha=PARSER_N_FEATURES)
        logits = upper.state_logits(P, pidx).float()
        code = plan.code(V)
        valid = plan.valid.index_select(0, code)
        logp = torch.log_softmax(torch.where(valid, logits, NEG), dim=-1)
        logp = torch.where(valid, logp, NEG).view(B, K, nA)
        done = (code == 0).view(B, K, 1)
        noop[:, :, 0] = scores
        cand = torch.where(done, noop, scores[:, :, None] + logp)
        scores, top = _top_k_stable(cand.view(B, K * nA), K)
        src = (base + top // nA).view(-1)
        S = S.index_select(0, src)
        plan.apply(S, V.index_select(0, src), code.index_select(0, src),
                   (top % nA).view(-1))
    heads, labels = plan.result(S)
    best = (torch.arange(B, device=X.device) * K + scores.argmax(1))
    return heads.index_select(0, best), labels.index_select(0, best)


# ----------------------------------------------------------------------
# BILUO decodes (NER): O = 0, B-i = 1+4i, I-i = 2+4i, L-i = 3+4i, U-i = 4+4i
# ----------------------------------------------------------------------


class BiluoPlan:
    """Lookup tables of the BILUO automaton with ``n_labels`` labels. The
    automaton state s is -1 (outside) or the open label; tables index s + 1."""

    def __init__(self, n_labels: int, device: torch.device):
        L = n_labels
        self.n_labels, self.n_actions = L, 1 + 4 * L
        nA = self.n_actions
        # greedy: allowed actions by (state + 1) + (L + 1) * [last token]
        allow = torch.zeros(2 * (L + 1), nA, dtype=torch.bool)
        for last in (0, 1):
            r = (L + 1) * last
            allow[r, 0] = True                      # O
            allow[r, 4::4] = True                   # U-*
            if not last:
                allow[r, 1::4] = True               # B-* (needs an L later)
            for k in range(L):
                allow[r + 1 + k, 3 + 4 * k] = True  # L-k
                if not last:
                    allow[r + 1 + k, 2 + 4 * k] = True  # I-k
        self.allow = allow.to(device)
        # greedy: next (state + 1) by (state + 1) * nA + action
        nxt = torch.zeros((L + 1) * nA, dtype=torch.long)
        for s in range(L + 1):
            for a in range(1, nA):
                kind, lab = (a - 1) % 4, (a - 1) // 4
                nxt[s * nA + a] = lab + 1 if kind == 0 else (s if kind == 1 else 0)
        self.next = nxt.to(device)
        # Viterbi: actions ordered [O, U-*, L-*, (B-i, I-i)...]; the first
        # 1 + 2L lead to "outside", pair i to "inside i". prev[a] is the
        # state (+1) an action leaves from.
        lab = list(range(L))
        order = [0] + [4 + 4 * i for i in lab] + [3 + 4 * i for i in lab]
        for i in lab:
            order += [1 + 4 * i, 2 + 4 * i]
        self.order = torch.tensor(order, dtype=torch.long, device=device)
        prev = [0] + [0] * L + [1 + i for i in lab]
        for i in lab:
            prev += [0, 1 + i]
        self.prev = torch.tensor(prev, dtype=torch.long, device=device)
        self.is_bi = torch.zeros(nA, dtype=torch.bool, device=device)
        self.is_bi[1 + 2 * L:] = True
        # the state (+1) an action is taken from, walking back: I-i and L-i
        # come from inside i, every other action from outside
        back = torch.zeros(nA, dtype=torch.long)
        for a in range(1, nA):
            if (a - 1) % 4 in (1, 2):
                back[a] = (a - 1) // 4 + 1
        self.back = back.to(device)
        self.bi_first = torch.tensor([1 + 4 * i for i in lab], dtype=torch.long,
                                     device=device)


def decode_biluo(logits: torch.Tensor, lengths: torch.Tensor, n_labels: int,
                 plan: Optional[BiluoPlan] = None) -> torch.Tensor:
    """Constrained greedy BILUO decode over precomputed logits [B, T, nA].
    Returns action ids [B, T]."""
    B, Tlen, nA = logits.shape
    if n_labels == 0:
        return torch.zeros((B, Tlen), dtype=torch.long, device=logits.device)
    plan = plan or BiluoPlan(n_labels, logits.device)
    t = torch.arange(Tlen, device=logits.device)
    last_off = ((t[:, None] + 1) >= lengths[None, :]).long() * (n_labels + 1)  # [T, B]
    state = torch.zeros(B, dtype=torch.long, device=logits.device)
    acts = []
    for i in range(Tlen):
        allowed = plan.allow.index_select(0, state + last_off[i])
        act = torch.where(allowed, logits[:, i], NEG).argmax(1)
        acts.append(act)
        state = plan.next.index_select(0, torch.add(act, state, alpha=nA))
    return torch.stack(acts, 1)


def decode_biluo_viterbi(logits: torch.Tensor, lengths: torch.Tensor, n_labels: int,
                         plan: Optional[BiluoPlan] = None) -> torch.Tensor:
    """Exact max-sum decode over the BILUO automaton (states: outside, and
    inside label i). Returns action ids [B, T], as ``decode_biluo``."""
    B, Tlen, nA = logits.shape
    if n_labels == 0:
        return torch.zeros((B, Tlen), dtype=torch.long, device=logits.device)
    L = n_labels
    plan = plan or BiluoPlan(n_labels, logits.device)
    sc = logits.float().index_select(2, plan.order)                   # [B, T, nA]
    t = torch.arange(Tlen, device=logits.device)
    last = (t[None, :] + 1) >= lengths[:, None]                        # [B, T]
    active = t[None, :] < lengths[:, None]                             # [B, T]
    # B-* and I-* are not allowed at a doc's last token (an entity closes)
    sc = torch.where(last[:, :, None] & plan.is_bi, NEG_VITERBI, sc)
    dp = torch.full((B, L + 1), NEG_VITERBI, dtype=torch.float32, device=logits.device)
    dp[:, 0] = 0.0
    out_arg, in_arg = [], []
    # a padded position's scores are never read back: the walk back starts
    # outside at T - 1 and takes O through the padding, so the forward pass
    # runs over it unmasked (5 device operations a step)
    for i in range(Tlen):
        cand = dp.index_select(1, plan.prev) + sc[:, i]
        out_max, o_arg = cand[:, :1 + 2 * L].max(1)
        in_max, i_arg = cand[:, 1 + 2 * L:].view(B, L, 2).max(2)
        out_arg.append(o_arg)
        in_arg.append(i_arg)
        dp = torch.cat((out_max[:, None], in_max), 1)
    # the action taken into each state at each position, [B, T, 1 + L];
    # padded positions take O (the walk back starts outside and stays there)
    best = torch.cat((plan.order.index_select(0, torch.stack(out_arg, 1).view(-1))
                      .view(B, Tlen, 1),
                      torch.stack(in_arg, 1) + plan.bi_first), 2)
    best = torch.where(active[:, :, None], best, 0)
    state = torch.zeros(B, 1, dtype=torch.long, device=logits.device)
    acts = []
    for i in range(Tlen - 1, -1, -1):
        act = best[:, i].gather(1, state)
        acts.append(act)
        state = plan.back.index_select(0, act.view(-1)).view(B, 1)
    return torch.cat(acts[::-1], 1)
