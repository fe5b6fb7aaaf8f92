"""Hashing for hash-embedding tables.

Two halves, both copies of ``spacy_ray_tpu/ops/hashing.py``:

* the host side (pure Python / numpy): ``hash_string_u64`` gives each
  attribute string its stable 64-bit key, ``split_u64`` splits keys into
  (lo, hi) uint32 words, and ``murmur3_x86_128_u64_np`` is the numpy oracle;
* the device side: :func:`hash_embed_ids` maps each 64-bit key to four row
  indices with MurmurHash3 x86_128, bit-equal to the JAX function. torch has
  no general uint32 arithmetic, so the words ride in int64 and every
  multiply, add and shift is masked back to 32 bits. Each 32-bit multiply is
  split into 16-bit halves so no int64 intermediate ever overflows.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0x239B961B
_C2 = 0xAB0E9789
_C3 = 0x38B34AE5
_C4 = 0xA1E38B93
_M32 = 0xFFFFFFFF


# ------------------------------------------------------------ device side


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32): both partial products stay
    below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur3_x86_128_u64(key_lo: torch.Tensor, key_hi: torch.Tensor, seed: int):
    """MurmurHash3 x86_128 of 8-byte keys given as two 32-bit words held in
    int64 tensors. Returns four int64 tensors of 32-bit hashes."""
    h1 = torch.full_like(key_lo, seed & _M32)
    h2, h3, h4 = h1, h1, h1

    k1 = _mul32(_rotl32(_mul32(key_lo, _C1), 15), _C2)
    h1 = h1 ^ k1
    k2 = _mul32(_rotl32(_mul32(key_hi, _C2), 16), _C3)
    h2 = h2 ^ k2

    h1, h2, h3, h4 = h1 ^ 8, h2 ^ 8, h3 ^ 8, h4 ^ 8  # length = 8 bytes
    h1 = (h1 + h2 + h3 + h4) & _M32
    h2 = (h2 + h1) & _M32
    h3 = (h3 + h1) & _M32
    h4 = (h4 + h1) & _M32
    h1, h2, h3, h4 = _fmix32(h1), _fmix32(h2), _fmix32(h3), _fmix32(h4)
    h1 = (h1 + h2 + h3 + h4) & _M32
    h2 = (h2 + h1) & _M32
    h3 = (h3 + h1) & _M32
    h4 = (h4 + h1) & _M32
    return h1, h2, h3, h4


def hash_embed_ids(keys: torch.Tensor, seed: int, n_rows: int) -> torch.Tensor:
    """Map 64-bit keys to 4 row indices each, for the HashEmbed gather-sum.

    keys: [..., 2] integer tensor of (lo, hi) uint32 words. Returns int32
    [..., 4] row indices in [0, n_rows)."""
    keys = keys.to(torch.int64)
    h = murmur3_x86_128_u64(keys[..., 0], keys[..., 1], seed)
    return (torch.stack(h, dim=-1) % n_rows).to(torch.int32)


# -------------------------------------------------------------- host side


def murmur3_x86_128_u64_np(key_lo: np.ndarray, key_hi: np.ndarray, seed: int):
    """numpy oracle of :func:`murmur3_x86_128_u64` (uint32 arithmetic)."""
    with np.errstate(over="ignore"):
        key_lo = key_lo.astype(np.uint32)
        key_hi = key_hi.astype(np.uint32)
        u = np.uint32

        def rotl(x, r):
            return ((x << u(r)) | (x >> u(32 - r))).astype(np.uint32)

        def fmix(h):
            h = h ^ (h >> u(16))
            h = (h * u(0x85EBCA6B)).astype(np.uint32)
            h = h ^ (h >> u(13))
            h = (h * u(0xC2B2AE35)).astype(np.uint32)
            return h ^ (h >> u(16))

        h1 = np.full(key_lo.shape, u(seed & _M32), dtype=np.uint32)
        h2, h3, h4 = h1.copy(), h1.copy(), h1.copy()
        k1 = (rotl((key_lo * u(_C1)).astype(np.uint32), 15) * u(_C2)).astype(np.uint32)
        h1 = h1 ^ k1
        k2 = (rotl((key_hi * u(_C2)).astype(np.uint32), 16) * u(_C3)).astype(np.uint32)
        h2 = h2 ^ k2
        h1, h2, h3, h4 = h1 ^ u(8), h2 ^ u(8), h3 ^ u(8), h4 ^ u(8)
        h1 = (h1 + h2 + h3 + h4).astype(np.uint32)
        h2 = (h2 + h1).astype(np.uint32)
        h3 = (h3 + h1).astype(np.uint32)
        h4 = (h4 + h1).astype(np.uint32)
        h1, h2, h3, h4 = fmix(h1), fmix(h2), fmix(h3), fmix(h4)
        h1 = (h1 + h2 + h3 + h4).astype(np.uint32)
        h2 = (h2 + h1).astype(np.uint32)
        h3 = (h3 + h1).astype(np.uint32)
        h4 = (h4 + h1).astype(np.uint32)
        return h1, h2, h3, h4


def hash_string_u64(s: str, seed: int = 0) -> int:
    """Stable 64-bit hash of a string: MurmurHash3 x86_128 over its utf-8
    bytes, truncated to 64 bits. Identical in every process."""
    return _murmur3_x86_128_bytes(s.encode("utf8"), seed) & 0xFFFFFFFFFFFFFFFF


def _murmur3_x86_128_bytes(data: bytes, seed: int) -> int:
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & _M32

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & _M32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & _M32
        h ^= h >> 16
        return h

    c1, c2, c3, c4 = _C1, _C2, _C3, _C4
    h1 = h2 = h3 = h4 = seed & _M32
    length = len(data)
    nblocks = length // 16
    for i in range(nblocks):
        block = data[i * 16: (i + 1) * 16]
        k1 = int.from_bytes(block[0:4], "little")
        k2 = int.from_bytes(block[4:8], "little")
        k3 = int.from_bytes(block[8:12], "little")
        k4 = int.from_bytes(block[12:16], "little")
        k1 = (rotl((k1 * c1) & _M32, 15) * c2) & _M32
        h1 ^= k1
        h1 = (((rotl(h1, 19) + h2) & _M32) * 5 + 0x561CCD1B) & _M32
        k2 = (rotl((k2 * c2) & _M32, 16) * c3) & _M32
        h2 ^= k2
        h2 = (((rotl(h2, 17) + h3) & _M32) * 5 + 0x0BCAA747) & _M32
        k3 = (rotl((k3 * c3) & _M32, 17) * c4) & _M32
        h3 ^= k3
        h3 = (((rotl(h3, 15) + h4) & _M32) * 5 + 0x96CD1C35) & _M32
        k4 = (rotl((k4 * c4) & _M32, 18) * c1) & _M32
        h4 ^= k4
        h4 = (((rotl(h4, 13) + h1) & _M32) * 5 + 0x32AC3B17) & _M32

    tail = data[nblocks * 16:]
    t = len(tail)
    k1 = k2 = k3 = k4 = 0
    if t >= 13:
        k4 = int.from_bytes(tail[12:t].ljust(4, b"\0"), "little")
    if t >= 9:
        k3 = int.from_bytes(tail[8:min(t, 12)].ljust(4, b"\0"), "little")
    if t >= 5:
        k2 = int.from_bytes(tail[4:min(t, 8)].ljust(4, b"\0"), "little")
    if t >= 1:
        k1 = int.from_bytes(tail[0:min(t, 4)].ljust(4, b"\0"), "little")
    if k4:
        h4 ^= (rotl((k4 * c4) & _M32, 18) * c1) & _M32
    if k3:
        h3 ^= (rotl((k3 * c3) & _M32, 17) * c4) & _M32
    if k2:
        h2 ^= (rotl((k2 * c2) & _M32, 16) * c3) & _M32
    if k1:
        h1 ^= (rotl((k1 * c1) & _M32, 15) * c2) & _M32

    h1 ^= length
    h2 ^= length
    h3 ^= length
    h4 ^= length
    h1 = (h1 + h2 + h3 + h4) & _M32
    h2 = (h2 + h1) & _M32
    h3 = (h3 + h1) & _M32
    h4 = (h4 + h1) & _M32
    h1, h2, h3, h4 = fmix(h1), fmix(h2), fmix(h3), fmix(h4)
    h1 = (h1 + h2 + h3 + h4) & _M32
    h2 = (h2 + h1) & _M32
    return (h2 << 32) | h1


def split_u64(keys: np.ndarray) -> np.ndarray:
    """uint64 array -> [..., 2] uint32 (lo, hi) for device-side hashing."""
    keys = keys.astype(np.uint64)
    lo = (keys & np.uint64(_M32)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)
