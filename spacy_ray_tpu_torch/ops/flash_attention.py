"""Exact masked attention for the transformer trunk.

Counterpart of ``spacy_ray_tpu/ops/flash_attention.py`` (forward only: the
serving slice has no backward). q/k/v are in the trunk's [B, T, H, Dh]
layout, the key-padding mask becomes the same finite additive bias
(``NEG = -1e30``), and the scale is ``1/sqrt(Dh)`` of the real head dim.

On CUDA tensors :func:`flash_attention` launches the hand-written kernel
``csrc/flash_attention.cu`` (:func:`flash_attention_fwd`); on CPU tensors it
runs :func:`flash_attention_plain`. Both return the output in the input
dtype and the f32 per-query log-sum-exp, in [B, T, H, Dh] and [B, T, H].
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _cuda

NEG = -1e30
# head dims the kernel is instantiated for: trf.cfg's 64 and the tests' 16
SUPPORTED_HEAD_DIMS = (16, 64)

_SOURCE = "flash_attention.cu"
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "srt_flash_attention_fwd": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _LL, _LL, ctypes.c_float, _I, _I, _P,
    ),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool key-padding mask -> [B, T] additive f32 bias."""
    return torch.where(
        mask,
        torch.zeros((), dtype=torch.float32, device=mask.device),
        torch.full((), NEG, dtype=torch.float32, device=mask.device),
    ).contiguous()


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, f32 throughout."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0].permute(0, 2, 1)  # [B, H, T] -> [B, T, H]
    return o.to(q.dtype), lse.contiguous()


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel. q/k/v [B, T, H, Dh] f32 or bf16 with any batch and
    time strides (heads and head dim contiguous, as the split of the fused
    qkv projection leaves them), bias [B, T] f32 contiguous. Launches on
    PyTorch's current stream without synchronising."""
    _cuda.require(q.is_cuda and all(x.device == q.device for x in (k, v, bias)),
                  "flash_attention_fwd: q, k, v and bias must be on one CUDA device")
    _cuda.require(q.dtype in _DTYPE_CODE and k.dtype == q.dtype and v.dtype == q.dtype,
                  f"flash_attention_fwd: q/k/v must share float32 or bfloat16, got "
                  f"{q.dtype}/{k.dtype}/{v.dtype}")
    _cuda.require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape,
                  f"flash_attention_fwd: q/k/v must be [B, T, H, Dh] of one shape, got "
                  f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    B, T, H, Dh = q.shape
    _cuda.require(Dh in SUPPORTED_HEAD_DIMS,
                  f"flash_attention_fwd: head dim {Dh} not in {SUPPORTED_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _cuda.require(x.stride(3) == 1 and x.stride(2) == Dh,
                      f"flash_attention_fwd: {name} needs contiguous heads and head "
                      f"dim, got strides {x.stride()}")
    _cuda.require(bias.dtype == torch.float32 and bias.shape == (B, T)
                  and bias.is_contiguous(),
                  "flash_attention_fwd: bias must be contiguous float32 [B, T]")
    o = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    lib = _cuda.library(_SOURCE, _SIGNATURES)
    rc = lib.srt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, T, H, Dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), _DTYPE_CODE[q.dtype], q.device.index or 0, _cuda.stream_of(q),
    )
    _cuda.check(lib, rc, "flash_attention_fwd")
    _cuda.LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked attention. q/k/v [B, T, H, Dh], mask [B, T] bool (key
    padding). Returns (o [B, T, H, Dh] in q.dtype, lse [B, T, H] f32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    bias = mask_to_bias(mask)
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, bias, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """The trunk's attention entry point: the output of :func:`flash_attention`."""
    return flash_attention(q, k, v, mask)[0]
