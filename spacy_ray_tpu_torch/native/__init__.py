"""The host featurizer's batch string hash, a small C++ library
(``murmur.cpp``) built with ``g++`` at first use and loaded with ``ctypes``.

The library goes to ``spacy_ray_tpu_torch/_build/`` (listed in
``.gitignore``), named by a digest of the source and flags, so an edited
source rebuilds. A build writes a temporary file and publishes it with an
atomic rename, so processes that build at once (test workers) never load a
half-written library. A failed build raises with the compiler's output;
there is no silent pure-Python substitute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "murmur.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"murmur-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``murmur.cpp`` unless its library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host featurizer's murmur library "
                           "(spacy_ray_tpu_torch/native/murmur.cpp) is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.murmur3_u64.restype = ctypes.c_uint64
            lib.murmur3_u64.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
            lib.murmur3_u64_batch.restype = None
            lib.murmur3_u64_batch.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint64),
            ]
            _LIB = lib
        return _LIB


def hash_strings_u64(strings: Sequence[str], seed: int = 0) -> np.ndarray:
    """uint64 [len(strings)]: the 64-bit murmur key of each string's utf-8
    bytes, bit-equal to ``ops/hashing.py:hash_string_u64``."""
    lib = load()
    encoded = [s.encode("utf8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    out = np.zeros(len(encoded), dtype=np.uint64)
    lib.murmur3_u64_batch(
        b"".join(encoded), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(encoded), seed & 0xFFFFFFFF, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out
