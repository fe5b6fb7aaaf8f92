"""Int8 weight-only matmul for the serving precision overlay.

Counterpart of ``spacy_ray_tpu/ops/int8_matmul.py``: the trunk's dense
matmul weights are quantized once, per output channel and symmetric
(:func:`quantize_int8`, bit-equal to the JAX function), and the forward
computes ``(x @ f32(q8)) * scale`` with f32 accumulation. Activations stay
unquantized.

On CUDA tensors :func:`int8_matmul` launches the hand-written kernel
``csrc/int8_matmul.cu`` (:func:`int8_weight_matmul`) on the bf16 tensor
cores; on CPU tensors it runs :func:`int8_matmul_plain`. The activations
reach the kernel in their own type: bf16 (the serving path's) or f32.

:func:`quantize_int8_np` and :func:`dequantize_int8_np` are the same recipe
on host numpy arrays, for the trainer fleet's int8 wire (the gradients it
pushes are host copies already): bit-equal to the JAX package's functions of
those names.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import _cuda

_SOURCE = "int8_matmul.cu"
_SIGNATURES = {
    "srt_int8_weight_matmul": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ),
}
_TILE_M, _TILE_N, _TILE_K = 128, 128, 32  # the kernel's output tile and K step
_X_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class Int8Weight:
    """A quantized weight leaf: ``q8`` int8 [K, N] and ``scale`` f32 [N]."""

    q8: torch.Tensor
    scale: torch.Tensor


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (last axis) symmetric int8 quantization:
    ``scale = max(absmax / 127, 1e-12)``, ``q8 = clip(round(w / scale))``
    with round-half-to-even, as ``jnp.round`` does."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    scale = torch.clamp_min(absmax / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def quantize_int8_np(arr) -> Tuple[np.ndarray, np.ndarray]:
    """``(q8 int8, scale f32)`` of a host array: rank >= 2 takes one scale
    per channel of the last axis (shape ``(N,)``), rank <= 1 one scale for
    the tensor (shape ``()``); an empty array takes zero absmax. ``scale =
    max(absmax / 127, 1e-12)`` and ``q8 = clip(rint(a / scale), -127,
    127)``, all in float32, so each element is within ``scale / 2`` of its
    reconstruction."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
    if a.ndim >= 2:
        absmax = (np.max(np.abs(a), axis=tuple(range(a.ndim - 1))) if a.size
                  else np.zeros(a.shape[-1], np.float32))
    else:
        absmax = np.max(np.abs(a)) if a.size else np.float32(0.0)
    scale = np.maximum(np.asarray(absmax, np.float32) / np.float32(127.0),
                       np.float32(1e-12)).astype(np.float32)
    q = np.clip(np.rint(a / scale), -127.0, 127.0).astype(np.int8)
    return q, scale


def dequantize_int8_np(q8, scale) -> np.ndarray:
    """``f32(q8) * scale``: the scale broadcasts over the last axis (rank >= 2)
    or over the tensor (rank <= 1)."""
    return q8.astype(np.float32) * np.asarray(scale, np.float32)


def int8_matmul_plain(x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[M, K] f32 or bf16, [K, N] int8, [N] f32 -> [M, N] f32, in f32."""
    return (x2.to(torch.float32) @ q8.to(torch.float32)) * scale


def split_k(M: int, N: int, K: int, n_sm: int) -> Tuple[int, int]:
    """How the kernel cuts K: ``(splits, k_chunk)``. Where the output has
    fewer tiles than the card has SMs, K is split until every SM has a CTA,
    keeping at least 4 K steps per split;
    ``k_chunk`` is a multiple of the K step and ``splits * k_chunk >= K``
    with no empty split."""
    tiles = -(-M // _TILE_M) * -(-N // _TILE_N)
    steps = max(1, -(-K // _TILE_K))
    splits = max(1, min(-(-n_sm // tiles), steps // 4))
    chunk_steps = -(-steps // splits)
    return -(-steps // chunk_steps), chunk_steps * _TILE_K


def int8_weight_matmul(x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x2 [M, K] bf16 or f32, q8 [K, N] int8, scale [N] f32,
    all contiguous, -> [M, N] f32 on PyTorch's current stream. bf16 x takes
    one bf16 product per K step; f32 x is split into two bf16 parts (hi and
    the rest), two products into the same f32 accumulators."""
    _cuda.require(x2.is_cuda and q8.device == x2.device and scale.device == x2.device,
                  "int8_weight_matmul: x, q8 and scale must be on one CUDA device")
    _cuda.require(x2.dtype in _X_DTYPE_CODE and q8.dtype == torch.int8
                  and scale.dtype == torch.float32,
                  f"int8_weight_matmul: need bf16 or f32 x, int8 q8, f32 scale; got "
                  f"{x2.dtype}, {q8.dtype}, {scale.dtype}")
    _cuda.require(x2.dim() == 2 and q8.dim() == 2 and x2.shape[1] == q8.shape[0]
                  and scale.shape == (q8.shape[1],),
                  f"int8_weight_matmul: shapes x {tuple(x2.shape)}, q8 "
                  f"{tuple(q8.shape)}, scale {tuple(scale.shape)} do not line up")
    _cuda.require(x2.is_contiguous() and q8.is_contiguous() and scale.is_contiguous(),
                  "int8_weight_matmul: x, q8 and scale must be contiguous")
    M, K = x2.shape
    N = q8.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x2.device)
    n_sm = torch.cuda.get_device_properties(x2.device).multi_processor_count
    splits, k_chunk = split_k(M, N, K, n_sm)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x2.device)
            if splits > 1 else None)
    lib = _cuda.library(_SOURCE, _SIGNATURES)
    rc = lib.srt_int8_weight_matmul(
        x2.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, N, K, splits, k_chunk,
        _X_DTYPE_CODE[x2.dtype], x2.device.index or 0, _cuda.stream_of(x2),
    )
    _cuda.check(lib, rc, "int8_weight_matmul")
    _cuda.count_launch("int8_weight_matmul")
    _cuda.tally_flops(2.0 * M * K * N)
    return out


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 matmul: x [..., K] (bf16 or f32 as it comes; another
    float type is cast to f32) times q8 [K, N] int8 with per-channel scale
    [N]; returns f32 [..., N]."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in _X_DTYPE_CODE:
        x2 = x2.to(torch.float32)
    x2 = x2.contiguous()
    if x2.is_cuda:
        out = int8_weight_matmul(x2, q8, scale)
    elif x2.device.type == "cpu":
        out = int8_matmul_plain(x2, q8, scale)
    else:
        raise ValueError(f"int8_matmul: unsupported device {x2.device}")
    return out.reshape(*lead, q8.shape[1])
