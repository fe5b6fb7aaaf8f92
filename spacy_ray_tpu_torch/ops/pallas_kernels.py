"""HashEmbed gather-sum: ``out[n] = sum_j table[ids[n, j]]`` over the four
hashed rows of each key.

Counterpart of ``spacy_ray_tpu/ops/pallas_kernels.py``. On a CUDA tensor
:func:`hash_embed_lookup` launches the hand-written kernel
``csrc/hash_embed.cu`` (:func:`hash_embed_gather_sum`); on a CPU tensor it
runs the plain version (:func:`hash_embed_gather_sum_plain`), which adds the
four rows in the kernel's order. There is no other path.
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


def hash_embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather-sum 4 rows per key: table [rows, D], ids [..., 4] -> [..., D]."""
    lead = ids.shape[:-1]
    flat = ids.reshape(-1, 4).to(torch.int32).contiguous()
    if table.is_cuda:
        out = hash_embed_gather_sum(table, flat)
    elif table.device.type == "cpu":
        out = hash_embed_gather_sum_plain(table, flat)
    else:
        raise ValueError(f"hash_embed_lookup: unsupported device {table.device}")
    return out.reshape(*lead, table.shape[1])
