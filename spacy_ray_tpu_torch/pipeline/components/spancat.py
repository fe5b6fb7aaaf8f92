"""Span categorizer: an n-gram span suggester and a multilabel span scorer
(counterpart of ``spacy_ray_tpu/pipeline/components/spancat.py``).

Given the padded length T, the candidate spans are static: for each
suggested size s (outer) every start 0..T-s (inner). Their
representations are shifted-slice stacks pooled by mean and max, one
matmul scores every candidate, and validity is a mask, so no ragged span
list reaches the device. Spans may overlap; each label is a sigmoid.
Scores: ``spans_{key}_p/r/f`` and per type (exact span and label).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models.core import Context, Model, call, empty_param, glorot_uniform_, zeros_param
from ...models.heads import has_listener
from ...ops import ops as O
from ...registry import registry
from ..doc import Doc, Example, Span
from .base import Component


@registry.misc("spacy.ngram_suggester.v1")
def ngram_suggester(sizes: List[int]):
    return {"sizes": [int(s) for s in sizes]}


@registry.misc("spacy.ngram_range_suggester.v1")
def ngram_range_suggester(min_size: int = 1, max_size: int = 3):
    """spaCy's range form: every n-gram size in [min_size, max_size]."""
    if min_size < 1:
        raise ValueError(f"min_size must be >= 1, got {min_size}")
    if max_size < min_size:
        raise ValueError(f"max_size {max_size} < min_size {min_size}")
    return {"sizes": list(range(int(min_size), int(max_size) + 1))}


def span_grid(Tlen: int, sizes: List[int]) -> List[Tuple[int, int]]:
    """The candidate list [(start, size)] for a padded length."""
    return [(start, s) for s in sizes for start in range(Tlen - s + 1)]


def span_reprs(X: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """X [B, T, D] -> [B, n_spans, 2D]: [mean; max] over each n-gram span of
    the grid, from shifted slices. The max is ``amax``: a size-1 span's and
    padding's ties split the gradient evenly, as ``jnp.max`` does."""
    T = X.shape[1]
    reprs = []
    for s in sizes:
        n = T - s + 1
        if n <= 0:
            continue
        stack = torch.stack([X[:, k:k + n, :] for k in range(s)], dim=2)  # [B, n, s, D]
        reprs.append(torch.cat([stack.mean(dim=2), stack.amax(dim=2)], dim=-1))
    return torch.cat(reprs, dim=1)


class SpanCategorizer(Model):
    """The trunk, the span representations, a GELU hidden layer and a
    linear layer to one logit per label: ``hidden_W``, ``hidden_b``,
    ``out_W``, ``out_b`` beside an inline trunk's ``tok2vec/...``."""

    takes_ctx = True

    def __init__(self, tok2vec: Model, sizes: List[int], hidden_size: int, nO: int):
        width = tok2vec.dims.get("nO")
        super().__init__("spancat_model", dims={"nO": nO, "width": width},
                         meta={"has_listener": has_listener(tok2vec), "sizes": sizes})
        self.tok2vec = tok2vec
        self.hidden_W = empty_param(2 * width, hidden_size)
        self.hidden_b = zeros_param(hidden_size)
        self.out_W = empty_param(hidden_size, nO)
        self.out_b = zeros_param(nO)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.hidden_W, generator)
        glorot_uniform_(self.out_W, generator)

    def forward(self, x: Any, ctx: Optional[Context] = None) -> torch.Tensor:
        t2v = call(self.tok2vec, x, ctx or Context())
        reprs = span_reprs(t2v.X, self.meta["sizes"])
        h = O.gelu(reprs @ self.hidden_W + self.hidden_b)
        return h @ self.out_W + self.out_b  # [B, n_spans, n_labels]


@registry.architectures("spacy.SpanCategorizer.v1")
def make_span_categorizer(
    tok2vec: Model,
    reducer: Optional[Dict] = None,
    scorer: Optional[Dict] = None,
    suggester: Optional[Dict] = None,
    hidden_size: int = 128,
    nO: Optional[int] = None,
) -> SpanCategorizer:
    sizes = (suggester or {}).get("sizes", [1, 2, 3])
    return SpanCategorizer(tok2vec, sizes, hidden_size, nO if nO else 1)


class SpanCatComponent(Component):
    def __init__(self, name: str, model_cfg: Dict[str, Any], spans_key: str = "sc",
                 threshold: float = 0.5, max_positive: Optional[int] = None):
        super().__init__(name, model_cfg)
        self.spans_key = spans_key
        self.threshold = threshold
        self.max_positive = max_positive
        # per instance: the score keys carry the configured spans_key
        self.default_score_weights = {
            f"spans_{spans_key}_f": 1.0,
            f"spans_{spans_key}_p": 0.0,
            f"spans_{spans_key}_r": 0.0,
        }
        #: per padded length: (starts, sizes) of the grid as arrays, and
        #: {(start, size): grid index}
        self._grids: Dict[Tuple[int, Tuple[int, ...]], Any] = {}

    def add_labels_from(self, examples) -> None:
        labels = set(self.labels)
        for eg in examples:
            for span in eg.reference.spans.get(self.spans_key, []):
                labels.add(span.label)
        self.labels = list(labels)

    @property
    def sizes(self) -> List[int]:
        assert self.model is not None
        return self.model.meta["sizes"]

    def grid(self, Tlen: int, sizes: List[int]):
        key = (Tlen, tuple(sizes))
        if key not in self._grids:
            grid = span_grid(Tlen, sizes)
            self._grids[key] = (np.array([g[0] for g in grid], dtype=np.int64),
                                np.array([g[1] for g in grid], dtype=np.int64),
                                {sp: i for i, sp in enumerate(grid)})
        return self._grids[key]

    def make_targets(self, examples: List[Example], B: int, Tlen: int) -> Dict[str, np.ndarray]:
        """Every in-length grid span of every doc is a candidate (a doc
        without the spans key gives negatives only); a gold span on the grid
        sets its label. Each Example keeps its (span, label) indices, keyed
        by the labels, the length and the sizes."""
        label_ids = {label: i for i, label in enumerate(self.labels)}
        sizes = self.sizes if self.model else [1, 2, 3]
        starts, span_sizes, grid_index = self.grid(Tlen, sizes)
        target = np.zeros((B, len(starts), max(len(self.labels), 1)), dtype=np.float32)
        mask = np.zeros((B, len(starts)), dtype=bool)
        cache_key = (tuple(self.labels), Tlen, tuple(sizes))
        for i, eg in enumerate(examples):
            ref = eg.reference
            mask[i] = starts + span_sizes <= min(len(ref), Tlen)
            cached = getattr(eg, "_span_target_cache", None)
            if cached is None or cached[0] != cache_key:
                hits = [(grid_index.get((s.start, s.end - s.start)), label_ids.get(s.label))
                        for s in ref.spans.get(self.spans_key, [])]
                hits = [(j, li) for j, li in hits if j is not None and li is not None]
                eg._span_target_cache = cached = (
                    cache_key, np.array([h[0] for h in hits], dtype=np.int64),
                    np.array([h[1] for h in hits], dtype=np.int64))
            target[i, cached[1], cached[2]] = 1.0
        return {"span_target": target, "span_mask": mask}

    def loss(self, inputs: Any, targets: Dict[str, Any], ctx: Context):
        logits = call(self.model, inputs, ctx)  # [B, n_spans, n_labels]
        return O.masked_sigmoid_bce(logits, targets["span_target"], targets["span_mask"]), {}

    def forward(self, inputs: Any, overlay=None, ctx=None) -> Dict[str, torch.Tensor]:
        return {"probs": torch.sigmoid(self.model(inputs).float())}

    def set_annotations(self, docs: List[Doc], outputs, lengths: List[int]) -> None:
        """Per doc, the grid spans inside its length in grid order; per span
        its labels at or over the threshold by (probability, label)
        descending (equal probabilities: the label that sorts last first),
        at most ``max_positive`` of them. ``doc.spans[key]`` is set even
        when empty."""
        probs = outputs["probs"].cpu().numpy()  # [B, n_spans, n_labels]
        starts, span_sizes, _ = self.grid(self._grid_T(probs.shape[1]), self.sizes)
        for i, doc in enumerate(docs):
            valid = starts + span_sizes <= lengths[i]
            over = (probs[i] >= self.threshold) & valid[:, None]
            found: List[Span] = []
            js, lis = np.nonzero(over)
            for j in np.unique(js):
                ranked = sorted(((float(probs[i, j, li]), self.labels[li])
                                 for li in lis[js == j]), reverse=True)
                if self.max_positive:
                    ranked = ranked[: self.max_positive]
                start, size = int(starts[j]), int(span_sizes[j])
                found.extend(Span(start, start + size, label) for _, label in ranked)
            doc.spans[self.spans_key] = found

    def _grid_T(self, n_spans: int) -> int:
        """Invert len(span_grid(T, sizes)) = k * T - sum(sizes) + k for T."""
        sizes = self.sizes
        k = len(sizes)
        return (n_spans + sum(sizes) - k) // k

    def score(self, examples: List[Example]) -> Dict[str, Any]:
        from ..scoring import score_spans

        key = self.spans_key
        # docs without the spans key are skipped (their predictions are not
        # false positives); a present but empty key counts
        return score_spans(examples, f"spans_{key}", lambda d: d.spans.get(key, []),
                           has_annotation=lambda d: key in d.spans)


@registry.factories("spancat")
def make_spancat(name: str, model: Dict[str, Any], spans_key: str = "sc",
                 threshold: float = 0.5, max_positive: Optional[int] = None,
                 suggester: Optional[Dict] = None) -> SpanCatComponent:
    if suggester is not None:
        # the suggester's sizes go into the model block
        model = dict(model)
        model.setdefault("suggester", suggester)
    return SpanCatComponent(name, model, spans_key=spans_key, threshold=threshold,
                            max_positive=max_positive)
