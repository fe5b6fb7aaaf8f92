"""Pickle-free wire codec for the trainer fleet's arrays
(``spacy_ray_tpu/training/fleet/wire.py``, its f32 wire).

Gradient pushes and parameter pulls move ``{leaf-path: ndarray}`` dicts
between processes. An open port never unpickles what a client sent: a
frame is a JSON header (lengths, dtypes, shapes) followed by the arrays'
raw little-endian bytes,

    b"SRTF1" | u64 header length (big-endian) | header json | raw bytes

decoded with ``np.frombuffer`` against the declared dtypes. Every malformed
frame raises :class:`WireError`. For the same meta and arrays the frames are
the JAX package's byte for byte, and each package decodes the other's.

Only the uncompressed wire is here: a gradient frame's ``codec`` is
``"f32"`` (the arrays as they are). A frame naming ``bf16`` or ``int8``
raises, since this package does not decode them; a frame naming a codec
neither package knows passes its arrays through, as in the JAX package.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np

MAGIC = b"SRTF1"

#: codecs this package decodes: what ``/healthz`` advertises to pushers
WIRE_CODECS = ("f32",)

#: codecs of the JAX package that this one cannot decode
UNDECODED_CODECS = ("bf16", "int8", "delta")


class WireError(ValueError):
    """Malformed fleet wire payload (truncated, wrong magic, bad header,
    byte-count mismatch)."""


def frame_epoch(meta: Dict[str, Any]) -> int:
    """The membership epoch stamped on a frame's meta; a frame without one
    is epoch 0. A stamp that is not an int >= 0 raises :class:`WireError`."""
    e = meta.get("epoch", 0)
    if isinstance(e, bool) or not isinstance(e, int) or e < 0:
        raise WireError(f"bad fleet payload: epoch {e!r} is not an int >= 0")
    return int(e)


def encode_arrays(meta: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> bytes:
    entries = []
    blobs = []
    for key in sorted(arrays):
        arr = np.ascontiguousarray(arrays[key])
        if arr.dtype.byteorder == ">":  # a big-endian host array
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        entries.append([key, arr.dtype.str, list(arr.shape)])
        blobs.append(arr.tobytes())
    header = json.dumps({"meta": meta, "arrays": entries}).encode("utf8")
    return MAGIC + len(header).to_bytes(8, "big") + header + b"".join(blobs)


def decode_arrays(body: bytes) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    if len(body) < len(MAGIC) + 8 or body[: len(MAGIC)] != MAGIC:
        raise WireError("bad fleet payload: missing magic")
    hlen = int.from_bytes(body[len(MAGIC): len(MAGIC) + 8], "big")
    start = len(MAGIC) + 8
    if len(body) < start + hlen:
        raise WireError("bad fleet payload: truncated header")
    try:
        header = json.loads(body[start: start + hlen].decode("utf8"))
        entries = header["arrays"]
        meta = header.get("meta") or {}
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise WireError(f"bad fleet payload header: {e}") from e
    arrays: Dict[str, np.ndarray] = {}
    offset = start + hlen
    for entry in entries:
        try:
            key, dtype_s, shape = entry
            dtype = np.dtype(str(dtype_s))
            shape = tuple(int(d) for d in shape)
        except (ValueError, TypeError) as e:
            raise WireError(f"bad fleet payload entry {entry!r}: {e}") from e
        count = int(np.prod(shape, dtype=np.int64))  # () -> 1, (0, d) -> 0
        nbytes = dtype.itemsize * count
        if len(body) < offset + nbytes:
            raise WireError(f"bad fleet payload: truncated data for {key!r}")
        arrays[str(key)] = np.frombuffer(
            body, dtype=dtype, count=count, offset=offset).reshape(shape).copy()
        offset += nbytes
    if offset != len(body):
        raise WireError(f"bad fleet payload: {len(body) - offset} trailing bytes")
    return meta, arrays


def encode_grads(meta: Dict[str, Any], grads: Dict[str, np.ndarray]) -> bytes:
    """A gradient push frame: ``meta`` with ``codec`` ``"f32"``, the arrays
    as they are."""
    m = dict(meta)
    m["codec"] = "f32"
    return encode_arrays(m, {k: np.ascontiguousarray(np.asarray(v)) for k, v in grads.items()})


def decode_grads(body: bytes) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Decode a gradient push frame. A frame without a ``codec`` is an f32
    frame; a compressed one raises :class:`WireError`."""
    meta, arrays = decode_arrays(body)
    codec = str(meta.get("codec") or "f32")
    if codec in UNDECODED_CODECS:
        raise WireError(f"bad fleet payload: codec {codec!r} is not decoded here "
                        f"(this build decodes {', '.join(WIRE_CODECS)})")
    return meta, arrays
