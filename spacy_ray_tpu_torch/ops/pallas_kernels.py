"""HashEmbed gather-sum: ``out[n] = sum_j table[ids[n, j]]`` over the four
hashed rows of each key, and its table gradient.

Counterpart of ``spacy_ray_tpu/ops/pallas_kernels.py``. :func:`hash_embed_lookup`
is differentiable through :class:`HashEmbedLookup`, an autograd function like
the JAX kernel's ``custom_vjp``. On a CUDA tensor the forward launches
``csrc/hash_embed.cu`` (:func:`hash_embed_gather_sum`) and the backward
``csrc/hash_embed_grad.cu`` (:func:`hash_embed_table_grad`); on a CPU tensor
they run the plain versions (:func:`hash_embed_gather_sum_plain`, which adds
the four rows in the kernel's order, and :func:`hash_embed_table_grad_plain`,
which sums each row's cotangents in the kernel's order). There is no other
path.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_SOURCE = "hash_embed.cu"
_SIGNATURES = {
    "srt_hash_embed_gather_sum": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ),
}
_GRAD_SOURCE = "hash_embed_grad.cu"
_GRAD_SIGNATURES = {
    "srt_hash_embed_table_grad": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ),
}


def hash_embed_gather_sum_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[rows, D], [N, 4] -> [N, D]; the four rows summed left to right."""
    ids = ids.long()
    return ((table[ids[:, 0]] + table[ids[:, 1]]) + table[ids[:, 2]]) + table[ids[:, 3]]


def hash_embed_gather_sum(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: table [rows, D] f32, ids [N, 4] int32 -> [N, D] f32,
    on PyTorch's current stream, without synchronising."""
    _cuda.require(table.is_cuda and ids.device == table.device,
                  "hash_embed_gather_sum: table and ids must be on one CUDA device")
    _cuda.require(table.dtype == torch.float32 and table.dim() == 2,
                  f"hash_embed_gather_sum: table must be 2-D float32, got "
                  f"{table.dtype} {tuple(table.shape)}")
    _cuda.require(ids.dtype == torch.int32 and ids.dim() == 2 and ids.shape[1] == 4,
                  f"hash_embed_gather_sum: ids must be int32 [N, 4], got "
                  f"{ids.dtype} {tuple(ids.shape)}")
    _cuda.require(table.is_contiguous() and ids.is_contiguous(),
                  "hash_embed_gather_sum: table and ids must be contiguous")
    n, d = ids.shape[0], table.shape[1]
    # the kernel moves rows and id quadruples as 16-byte vectors
    _cuda.require(d % 4 == 0 and table.data_ptr() % 16 == 0 and ids.data_ptr() % 16 == 0,
                  f"hash_embed_gather_sum: needs a width divisible by 4 and 16-byte "
                  f"aligned table and ids, got width {d}")
    out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    lib = _cuda.library(_SOURCE, _SIGNATURES)
    rc = lib.srt_hash_embed_gather_sum(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d,
        table.device.index or 0, _cuda.stream_of(table),
    )
    _cuda.check(lib, rc, "hash_embed_gather_sum")
    _cuda.LAUNCHES["hash_embed_gather_sum"] += 1
    return out


def hash_embed_table_grad_plain(ct: torch.Tensor, ids: torch.Tensor, rows: int) -> torch.Tensor:
    """[N, D], [N, 4] -> [rows, D]: each row the sum of the cotangents of
    the (token, j) pairs that name it, added in ascending (token, j) order
    from zero (``index_add_`` on the CPU walks its index in order)."""
    flat = ids.reshape(-1).long()
    return torch.zeros((rows, ct.shape[1]), dtype=ct.dtype, device=ct.device).index_add_(
        0, flat, ct.repeat_interleave(4, dim=0))


def hash_embed_table_grad(ct: torch.Tensor, ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The CUDA kernel: ct [N, D] f32, ids [N, 4] int32 -> [rows, D] f32, every
    row written, on PyTorch's current stream, without synchronising. The
    (row, token*4 + j) pairs are put in row order by a stable sort first, so
    each row's sum runs in ascending (token, j) order, as the plain
    version's does."""
    _cuda.require(ct.is_cuda and ids.device == ct.device,
                  "hash_embed_table_grad: ct and ids must be on one CUDA device")
    _cuda.require(ct.dtype == torch.float32 and ct.dim() == 2 and ct.is_contiguous(),
                  f"hash_embed_table_grad: ct must be contiguous 2-D float32, got "
                  f"{ct.dtype} {tuple(ct.shape)}")
    _cuda.require(ids.dtype == torch.int32 and ids.shape == (ct.shape[0], 4),
                  f"hash_embed_table_grad: ids must be int32 [N, 4] with N = "
                  f"{ct.shape[0]}, got {ids.dtype} {tuple(ids.shape)}")
    n, d = ct.shape
    _cuda.require(4 * n < 2 ** 31, "hash_embed_table_grad: more than 2**31 id pairs")
    _cuda.require(d % 4 == 0 and ct.data_ptr() % 16 == 0,
                  f"hash_embed_table_grad: needs a width divisible by 4 and a "
                  f"16-byte aligned ct, got width {d}")
    row_of_pair, order = torch.sort(ids.reshape(-1), stable=True)
    offsets = torch.searchsorted(
        row_of_pair, torch.arange(rows + 1, dtype=torch.int32, device=ct.device)
    ).to(torch.int32)
    order = order.to(torch.int32)
    out = torch.empty((rows, d), dtype=torch.float32, device=ct.device)
    lib = _cuda.library(_GRAD_SOURCE, _GRAD_SIGNATURES)
    rc = lib.srt_hash_embed_table_grad(
        ct.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(), rows, d,
        ct.device.index or 0, _cuda.stream_of(ct),
    )
    _cuda.check(lib, rc, "hash_embed_table_grad")
    _cuda.LAUNCHES["hash_embed_table_grad"] += 1
    return out


class HashEmbedLookup(torch.autograd.Function):
    """Gather-sum with the table gradient as its backward (the JAX kernel's
    ``custom_vjp``). Inputs: table [rows, D] f32, ids [N, 4] int32."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        if table.is_cuda:
            return hash_embed_gather_sum(table, ids)
        if table.device.type == "cpu":
            return hash_embed_gather_sum_plain(table, ids)
        raise ValueError(f"hash_embed_lookup: unsupported device {table.device}")

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (ids,) = ctx.saved_tensors
        ct = ct.contiguous()
        if ct.is_cuda:
            return hash_embed_table_grad(ct, ids, ctx.rows), None
        return hash_embed_table_grad_plain(ct, ids, ctx.rows), None


def hash_embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather-sum 4 rows per key: table [rows, D], ids [..., 4] -> [..., D];
    differentiable in ``table``."""
    lead = ids.shape[:-1]
    flat = ids.reshape(-1, 4).to(torch.int32).contiguous()
    return HashEmbedLookup.apply(table, flat).reshape(*lead, table.shape[1])
