"""Pickle-free wire codec for the trainer fleet's arrays
(``spacy_ray_tpu/training/fleet/wire.py``).

Gradient pushes and parameter pulls move ``{leaf-path: ndarray}`` dicts
between processes. An open port never unpickles what a client sent: a
frame is a JSON header (lengths, dtypes, shapes) followed by the arrays'
raw little-endian bytes,

    b"SRTF1" | u64 header length (big-endian) | header json | raw bytes

decoded with ``np.frombuffer`` against the declared dtypes. Every malformed
frame raises :class:`WireError`. For the same meta and arrays the frames are
the JAX package's byte for byte, and each package decodes the other's.

Compression rides on top of that frame: the ``codec`` field of the meta
names how the arrays were shrunk,

``f32``
    the arrays as they are (the uncompressed wire, and the fallback).
``bf16``
    f32 leaves carried as their top 16 bits (round to nearest even) in
    ``<u2`` arrays: half the bytes.
``int8``
    each leaf ``k`` as int8 plus an f32 ``k#scale`` companion (per channel
    of the last axis at rank >= 2, per tensor below: :func:`~...ops.
    int8_matmul.quantize_int8_np`), a quarter of the bytes. A leaf of rank
    0 or of fewer than :data:`INT8_MIN_LEAF` elements rides as f32.
``delta``
    a parameter pull as the owner's stacked per-version compressed pieces
    (``v{n}/{key}`` keys, the table in ``meta["pieces"]``) on top of the
    puller's known version (``peer.OwnerState``'s wire chain).

The sender negotiates (:func:`negotiate_push_codec`: f32 unless the peer's
``/healthz`` advertised the codec); a receiver passes a codec it does not
know through as declared, so a mixed fleet falls back to f32 frames, and
the owner's structural check counts a mismatch as a discard.

Integrity: a frame carries no checksum of its own (the bytes stay the JAX
package's), so the port sends each frame's CRC-32 beside it in the
:data:`CRC_HEADER` HTTP header, and a port receiver refuses a frame whose
bytes do not match it (:func:`check_frame_crc`): a flipped byte inside the
arrays would otherwise decode into a wrong number. A frame without the
header (a JAX peer's) is taken as it is.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from ...ops.int8_matmul import dequantize_int8_np, quantize_int8_np

MAGIC = b"SRTF1"

#: codecs this package decodes: what ``/healthz`` advertises to pushers
WIRE_CODECS = ("f32", "bf16", "int8", "delta")

#: the key suffix of a quantized leaf's scales
SCALE_SUFFIX = "#scale"

#: an int8 leaf of fewer elements rides as f32 (its scale would cost more
#: than the quantization saves)
INT8_MIN_LEAF = 8


class WireError(ValueError):
    """Malformed fleet wire payload (truncated, wrong magic, bad header,
    byte-count mismatch, CRC-32 mismatch)."""


#: the HTTP header with a frame's CRC-32 (8 lower-case hex digits)
CRC_HEADER = "X-SRT-CRC32"


def frame_crc(body: bytes) -> str:
    return f"{zlib.crc32(body) & 0xFFFFFFFF:08x}"


def check_frame_crc(body: bytes, headers: Mapping[str, Any]) -> None:
    """Raise :class:`WireError` when ``headers`` carry a CRC-32 that ``body``
    does not match (no header: nothing to check)."""
    want = headers.get(CRC_HEADER)
    if want is not None and str(want).lower() != frame_crc(body):
        raise WireError(f"frame CRC-32 mismatch ({frame_crc(body)} != {want}): "
                        "corrupted in flight")


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


# -- leaf codecs -------------------------------------------------------


def _to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """f32 -> bf16 as uint16: the top 16 bits, rounded to nearest even (the
    carry added in uint64, so it cannot wrap)."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    one = np.uint64(1)
    rounded = bits + np.uint64(0x7FFF) + ((bits >> np.uint64(16)) & one)
    return (rounded >> np.uint64(16)).astype(np.uint16).reshape(a.shape)


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(np.asarray(bits, dtype=np.uint16))
    return (b.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _compress_leaf(codec: str, key: str,
                   arr: np.ndarray) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """``(wire entries, what the receiver reconstructs)`` of one leaf; the
    error-feedback residual and the owner's wire chain are defined by the
    second."""
    a32 = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
    if codec == "bf16":
        bits = _to_bf16_bits(a32)
        return {key: bits}, _from_bf16_bits(bits)
    if codec == "int8":
        if a32.ndim == 0 or a32.size < INT8_MIN_LEAF or key.endswith(SCALE_SUFFIX):
            return {key: a32}, a32
        q, scale = quantize_int8_np(a32)
        return {key: q, key + SCALE_SUFFIX: scale}, dequantize_int8_np(q, scale)
    return {key: a32}, a32  # f32, and any other name


def compress_arrays(arrays: Dict[str, np.ndarray], codec: str) -> Dict[str, np.ndarray]:
    """A whole dict compressed without error feedback; ``f32`` passes it
    through."""
    if codec == "f32":
        return {k: np.ascontiguousarray(np.asarray(v)) for k, v in arrays.items()}
    out: Dict[str, np.ndarray] = {}
    for key in sorted(arrays):
        out.update(_compress_leaf(codec, key, arrays[key])[0])
    return out


def decompress_arrays(arrays: Dict[str, np.ndarray], codec: str) -> Dict[str, np.ndarray]:
    """Invert :func:`compress_arrays`. An int8 leaf without its ``#scale``
    raises :class:`WireError`; a codec other than bf16 and int8 passes the
    arrays through as declared."""
    if codec == "bf16":
        return {k: _from_bf16_bits(v) if v.dtype == np.uint16 else v
                for k, v in arrays.items()}
    if codec == "int8":
        out: Dict[str, np.ndarray] = {}
        for k, v in arrays.items():
            if k.endswith(SCALE_SUFFIX):
                continue
            sk = k + SCALE_SUFFIX
            if sk in arrays:
                out[k] = dequantize_int8_np(v, arrays[sk])
            elif v.dtype == np.int8:
                raise WireError(f"bad fleet payload: int8 leaf {k!r} missing {sk!r}")
            else:
                out[k] = v  # a small leaf, sent as f32
        return out
    return dict(arrays)


# -- gradient frames ---------------------------------------------------


def encode_grads(meta: Dict[str, Any], grads: Dict[str, np.ndarray],
                 codec: str = "f32") -> bytes:
    """A gradient push frame: ``meta`` with ``codec`` set, the arrays
    compressed by it without error feedback (:class:`GradCompressor` is the
    push path's)."""
    m = dict(meta)
    m["codec"] = str(codec)
    return encode_arrays(m, compress_arrays(grads, str(codec)))


def decode_grads(body: bytes) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Decode a gradient push frame to f32 leaves. A frame without a
    ``codec`` is an f32 frame; one with a codec this package does not know
    decodes to its arrays as declared."""
    meta, arrays = decode_arrays(body)
    codec = str(meta.get("codec") or "f32")
    if codec in ("f32", "bf16", "int8"):
        return meta, decompress_arrays(arrays, codec)
    return meta, arrays


# -- delta frames: version-delta parameter pulls -----------------------


def encode_delta_frame(meta: Dict[str, Any],
                       pieces: Iterable[Tuple[int, str, Dict[str, np.ndarray]]]) -> bytes:
    """A pull as stacked per-version deltas: ``pieces`` are ``(version,
    codec, compressed arrays)`` oldest first, the owner's stored pieces as
    they are (compressing them again would fork its chain); keys go out as
    ``v{version}/{key}``, the table as ``meta["pieces"]``."""
    table: List[List[Any]] = []
    arrays: Dict[str, np.ndarray] = {}
    for version, piece_codec, piece in pieces:
        table.append([int(version), str(piece_codec)])
        for key, arr in piece.items():
            arrays[f"v{int(version)}/{key}"] = arr
    m = dict(meta)
    m["codec"] = "delta"
    m["pieces"] = table
    return encode_arrays(m, arrays)


def decode_delta_frame(meta: Dict[str, Any],
                       arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The sum of a delta frame's decompressed pieces, ``{key: f32 delta}``
    to add onto the puller's known version. A malformed piece table raises
    :class:`WireError`."""
    try:
        table = [(int(v), str(c)) for v, c in meta["pieces"]]
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"bad delta frame piece table: {e}") from e
    total: Dict[str, np.ndarray] = {}
    for version, piece_codec in table:
        prefix = f"v{version}/"
        piece = {k[len(prefix):]: a for k, a in arrays.items() if k.startswith(prefix)}
        for key, delta in decompress_arrays(piece, piece_codec).items():
            d32 = np.asarray(delta, dtype=np.float32)
            total[key] = d32 if key not in total else total[key] + d32
    return total


# -- error-feedback push compression -----------------------------------


class GradCompressor:
    """Per-(peer, leaf) error feedback for gradient pushes: the compression
    error of a round is added to the next round's gradient for the same peer
    (``g' = g + r; r = g' - deq(Q(g'))``), so over T rounds the pushes sum to
    the raw gradients minus one bounded residual. A residual whose shape no
    longer matches (a re-shard raced a push) is dropped; :meth:`reset` drops
    them all. ``error_feedback=False`` is the ablation: a signal below half
    a quantization step then never reaches the owner. Not thread-safe (the
    worker's training thread alone pushes)."""

    def __init__(self, codec: str, *, error_feedback: bool = True) -> None:
        self.codec = str(codec)
        self.error_feedback = bool(error_feedback)
        self._residual: Dict[Tuple[Any, str], np.ndarray] = {}

    def reset(self) -> None:
        """Drop every residual: at a re-shard the slices they belong to are
        gone."""
        self._residual.clear()

    def compress(self, peer: Any, grads: Dict[str, np.ndarray],
                 codec: Optional[str] = None) -> Tuple[Dict[str, np.ndarray], str]:
        """``(wire arrays, codec used)`` of one push to ``peer``; ``codec``
        overrides the default (the peer's negotiated one)."""
        c = str(codec) if codec is not None else self.codec
        feedback = self.error_feedback and c != "f32"
        out: Dict[str, np.ndarray] = {}
        for key in sorted(grads):
            g32 = np.asarray(grads[key], dtype=np.float32)
            if feedback:
                residual = self._residual.get((peer, key))
                if residual is not None and residual.shape == g32.shape:
                    g32 = g32 + residual
            entries, deq = _compress_leaf(c, key, g32)
            out.update(entries)
            if feedback:
                self._residual[(peer, key)] = (g32 - deq).astype(np.float32)
        return out, c

    def encode(self, peer: Any, meta: Dict[str, Any], grads: Dict[str, np.ndarray],
               codec: Optional[str] = None) -> bytes:
        """Compress (with error feedback) and frame one push."""
        arrays, used = self.compress(peer, grads, codec)
        m = dict(meta)
        m["codec"] = used
        return encode_arrays(m, arrays)


# -- negotiation -------------------------------------------------------


def resolve_grad_compression(requested: str, backend: str) -> Tuple[str, str]:
    """``(codec, reason)`` of ``--grad-compression`` on ``backend`` (the
    worker's device type): ``auto`` is int8 on ``cpu``, where the JAX
    package's error-feedback convergence suite runs, and bf16 elsewhere."""
    req = str(requested or "auto").lower()
    if req in ("f32", "bf16", "int8"):
        return req, "explicit"
    if req != "auto":
        raise ValueError(f"unknown --grad-compression {requested!r} "
                         "(choose auto|f32|bf16|int8)")
    if str(backend).lower() == "cpu":
        return "int8", "error-feedback convergence suite committed on cpu"
    return ("bf16", f"no committed int8+error-feedback convergence record on "
                    f"{backend} — conservative tier")


def negotiate_push_codec(resolved: str, peer_codecs: Any) -> str:
    """The codec to push with, given what the peer's ``/healthz`` advertised:
    ``resolved`` when it is there, f32 for a peer that advertises none (or
    garbage) or not this one."""
    if not peer_codecs:
        return "f32"
    try:
        advertised = {str(c) for c in peer_codecs}
    except TypeError:
        return "f32"
    return str(resolved) if str(resolved) in advertised else "f32"
