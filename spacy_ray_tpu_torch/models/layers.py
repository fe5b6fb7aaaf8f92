"""Primitive layers over :class:`~spacy_ray_tpu_torch.types.Padded` batches
(counterparts of ``spacy_ray_tpu/models/layers.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import ops as O
from ..ops.hashing import hash_embed_ids
from ..ops.pallas_kernels import hash_embed_lookup
from ..pipeline.vectors import current_vectors
from ..types import Padded, TokenBatch
from .core import (
    Context, Model, empty_param, glorot_uniform_, normal_, ones_param, zeros_param,
)


class Linear(Model):
    def __init__(self, nI: int, nO: int, name: str = "linear"):
        super().__init__(name, dims={"nI": nI, "nO": nO})
        self.W = empty_param(nI, nO)
        self.b = zeros_param(nO)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.W, generator)

    def forward(self, x: Padded) -> Padded:
        return Padded(X=x.X @ self.W + self.b, mask=x.mask)


class Maxout(Model):
    def __init__(self, nI: int, nO: int, nP: int = 3, name: str = "maxout"):
        super().__init__(name, dims={"nI": nI, "nO": nO, "nP": nP})
        self.W = empty_param(nI, nO * nP)
        self.b = zeros_param(nO, nP)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.W, generator)

    def forward(self, x: Padded) -> Padded:
        return Padded(X=O.maxout(x.X, self.W, self.b), mask=x.mask)


class LayerNorm(Model):
    def __init__(self, nO: int, name: str = "norm"):
        super().__init__(name, dims={"nI": nO, "nO": nO})
        self.g = ones_param(nO)
        self.b = zeros_param(nO)

    def forward(self, x: Padded) -> Padded:
        return Padded(X=O.layer_norm(x.X, self.g, self.b), mask=x.mask)


class Dropout(Model):
    """A dropout site: its rate is ``rate`` unless ``[training] dropout``
    overrides it (:meth:`Context.dropout_rate`); it drops only in training
    and only with a seed, the mask drawn from a generator seeded with it."""

    takes_ctx = True

    def __init__(self, rate: float, name: str = "dropout"):
        super().__init__(name)
        self.rate = rate

    def forward(self, x: Padded, ctx: Optional[Context] = None) -> Padded:
        ctx = ctx or Context()
        rate = ctx.dropout_rate(self.rate)
        if not ctx.train or ctx.seed is None or rate <= 0:
            return x
        gen = torch.Generator(device=x.X.device).manual_seed(ctx.seed)
        return Padded(X=O.dropout(x.X, rate, gen), mask=x.mask)


class Seq2Col(Model):
    """Each position's window of ``window`` neighbours a side, concatenated
    (the CNN encoder's input to its maxout)."""

    def __init__(self, window: int, nI: int, name: str = "seq2col"):
        super().__init__(name, dims={"nI": nI, "nO": nI * (2 * window + 1)})
        self.window = window

    def forward(self, x: Padded) -> Padded:
        return Padded(X=O.seq2col(x.X, self.window, x.mask), mask=x.mask)


class HashEmbed(Model):
    """Feature-hashing embedding table: each 64-bit attribute key hashes to
    4 rows of a [rows, width] table (murmur3 x86_128), which are summed."""

    def __init__(self, width: int, rows: int, seed: int, attr_index: int,
                 name: str = "hash_embed"):
        super().__init__(name, dims={"nO": width, "rows": rows})
        self.seed = seed
        self.attr_index = attr_index
        self.E = empty_param(rows, width)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        normal_(self.E, self.dims["nO"] ** -0.5, generator)

    def forward(self, batch: TokenBatch) -> Padded:
        keys = batch.attr_keys[..., self.attr_index, :]  # [B, T, 2]
        ids = hash_embed_ids(keys, self.seed, self.dims["rows"])  # [B, T, 4]
        X = hash_embed_lookup(self.E, ids)
        return Padded(X=X * batch.mask[..., None].to(X.dtype), mask=batch.mask)


class StaticVectors(Model):
    """Frozen pretrained vectors, projected to ``width`` by a trainable
    ``W`` (glorot). The table is the active vectors' (``pipeline/vectors.py``),
    copied into the persistent buffer ``frozen_table``: it is saved and
    loaded under the JAX package's path like a parameter, but it is not one,
    so no gradient reaches it and the optimizer never sees it. A row of -1
    (padding, or a word with no vector) gives a zero vector. The gather and
    the projection are an index and a matmul, as in JAX (no kernel)."""

    def __init__(self, width: int, name: str = "static_vectors"):
        vectors = current_vectors()
        if vectors is None:
            raise ValueError(
                "include_static_vectors=true but no vectors are loaded — set "
                "[initialize] vectors = \"path.npz\""
            )
        super().__init__(name, dims={"nO": width, "nV": len(vectors)})
        self.register_buffer("frozen_table", torch.tensor(vectors.table))
        self.W = empty_param(vectors.width, width)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.W, generator)

    def forward(self, batch: TokenBatch) -> Padded:
        rows = batch.vector_rows
        if rows is None:
            raise ValueError(
                "TokenBatch has no vector_rows — the pipeline that collated "
                "this batch has no vectors loaded"
            )
        table = self.frozen_table
        vecs = table[rows.clamp(0, table.shape[0] - 1)]  # [B, T, Dv]
        vecs = vecs * (rows >= 0)[..., None].to(vecs.dtype)
        return Padded(X=vecs @ self.W, mask=batch.mask)


class ConcatPadded(Model):
    """Apply layers to the same input and concatenate their features."""

    def __init__(self, *layers: Model, name: str = "concat"):
        super().__init__(name, dims={"nO": sum(l.dims.get("nO", 0) for l in layers)})
        for i, layer in enumerate(layers):
            self.add_module(f"{i}_{layer.name}", layer)

    def forward(self, x) -> Padded:
        outs = [layer(x) for layer in self.children()]
        return Padded(X=torch.cat([o.X for o in outs], dim=-1), mask=outs[-1].mask)
