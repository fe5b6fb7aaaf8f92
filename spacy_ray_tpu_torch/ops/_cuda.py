"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
Libraries are built at first use into ``_build/`` (listed in
``.gitignore``), named by a digest of the source, header and flags, so an
edited source rebuilds and an unchanged one is reused. :func:`build`
starts one ``nvcc`` per source, all at once.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0. A wrapper
adds one to its entry in :data:`LAUNCHES` right after it launches its
kernel (:func:`count_launch`, under a lock: the dispatch threads of several
serving engines launch at once), and nowhere else, so a run can show which
kernels its path went through. The attention and int8 wrappers also add
their kernel's analytic FLOPs to an open :func:`kernel_flop_tally` (the
trainer telemetry's FLOP count), and every library load and decode-graph
capture counts as one of :func:`compile_count`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = (
    "hash_embed.cu", "flash_attention.cu", "int8_matmul.cu",
    "hash_embed_grad.cu", "flash_attention_bwd.cu", "fused_update.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # each kernel's registers, shared memory and spills, into BUILD_LOGS
    "-Xptxas", "-v",
)
#: flags of one source on top of NVCC_FLAGS. The optimizer update must not
#: contract a*b + c into an FMA: it follows the reference's expression
#: order to the last bit.
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "fused_update.cu": ("--fmad=false",),
}

#: kernel name -> launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {
    "hash_embed_gather_sum": 0,
    "flash_attention_fwd": 0,
    "int8_weight_matmul": 0,
    "hash_embed_table_grad": 0,
    "flash_attention_bwd": 0,
    "fused_update": 0,
}

#: source -> the compiler's output of its last build in this process
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
#: kernel-library loads (each built first when its library is missing) and
#: CUDA-graph captures of this process: what the port builds at run time,
#: where the JAX package compiles programs (telemetry's ``compile_count``)
_COMPILES = 0
#: the analytic FLOPs of the kernels launched inside :func:`kernel_flop_tally`
#: (a FLOP counter sees no work behind a ctypes call); None outside it
_FLOP_TALLY: Optional[List[float]] = None


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` (a read-modify-write of the dict is not
    atomic across threads)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def count_compile() -> None:
    """One kernel-library load or CUDA-graph capture."""
    global _COMPILES
    with _COUNT_LOCK:
        _COMPILES += 1


def compile_count() -> int:
    with _COUNT_LOCK:
        return _COMPILES


def tally_flops(n: float) -> None:
    """Add a launched kernel's analytic FLOPs to the open tally, if any (the
    backward pass may launch on another thread than the one that opened it)."""
    with _COUNT_LOCK:
        if _FLOP_TALLY is not None:
            _FLOP_TALLY[0] += float(n)


@contextmanager
def kernel_flop_tally() -> Iterator[List[float]]:
    """``[flops]`` of the hand kernels launched inside the block."""
    global _FLOP_TALLY
    tally = [0.0]
    with _COUNT_LOCK:
        _FLOP_TALLY = tally
    try:
        yield tally
    finally:
        with _COUNT_LOCK:
            _FLOP_TALLY = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def flags_of(source: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def _library_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    h.update(" ".join(flags_of(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns the wall seconds of the
    build (0.0 for a library already built). Raises with the compiler's
    output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = _library_path(src)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *flags_of(src), "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds = {src: 0.0 for src in sources}
    failures = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        BUILD_LOGS[src] = log
        if proc.returncode != 0:
            failures.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(source: str, signatures: Dict[str, Iterable]) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed, with each
    named C function's argument types set (every function returns int)."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_library_path(source)))
            lib.srt_error_string.restype = ctypes.c_char_p
            lib.srt_error_string.argtypes = [ctypes.c_int]
            for fn, argtypes in signatures.items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = list(argtypes)
            _LIBS[source] = lib
            count_compile()
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.srt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
