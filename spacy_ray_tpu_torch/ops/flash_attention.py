"""Exact masked attention for the transformer trunk, with its backward.

Counterpart of ``spacy_ray_tpu/ops/flash_attention.py``. q/k/v are in the
trunk's [B, T, H, Dh] layout, the key-padding mask becomes the same finite
additive bias (``NEG = -1e30``), and the scale is ``1/sqrt(Dh)`` of the real
head dim.

:func:`flash_attention` runs :class:`FlashAttention`, an autograd function
returning (o, lse) whose backward takes a cotangent for both, as the JAX
package's ``_make_flash_lse`` does (ring attention's block merge needs the
lse cotangent). On CUDA tensors the forward launches ``csrc/flash_attention.cu``
(:func:`flash_attention_fwd`) and the backward ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`); on CPU tensors they run
:func:`flash_attention_plain` and :func:`flash_attention_bwd_plain`. Outputs
and gradients are in the input dtype, the log-sum-exp is f32, in
[B, T, H, Dh] and [B, T, H].

The mask reaches the kernels as a :class:`KeyPadding`: the bias, and each
row's key extent (one past its last real key). Keys at or past the extent
have the NEG bias, so in a row with a real key their p is exactly 0 and the
kernels leave their tiles out; a row with no real key has extent T. The
trunk builds it once per forward (:func:`key_padding`) and hands it to every
layer's :func:`masked_attention`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

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
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _LL, _LL, ctypes.c_float, _I, _I, _P,
    ),
}
_BWD_SIGNATURES = {
    "srt_flash_attention_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
        _LL, _LL, _LL, _LL, _LL, _LL, ctypes.c_float, _I, _I, _P,
    ),
}
_BWD_SOURCE = "flash_attention_bwd.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class KeyPadding(NamedTuple):
    """A [B, T] key-padding mask as the attention functions take it."""

    bias: torch.Tensor    # [B, T] f32: 0 on real keys, NEG on padding
    extent: torch.Tensor  # [B] int32: one past the last real key; T if none


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool key-padding mask -> [B, T] additive f32 bias."""
    return torch.where(
        mask,
        torch.zeros((), dtype=torch.float32, device=mask.device),
        torch.full((), NEG, dtype=torch.float32, device=mask.device),
    ).contiguous()


def key_extent(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool mask -> [B] int32: one past each row's last real key, or
    T for a row with none (such a row attends to every key uniformly)."""
    B, T = mask.shape
    if T == 0:
        return torch.zeros(B, dtype=torch.int32, device=mask.device)
    pos = torch.arange(1, T + 1, dtype=torch.int32, device=mask.device)
    last = (mask.to(torch.int32) * pos).amax(dim=1)
    return torch.where(last > 0, last, torch.full_like(last, T)).contiguous()


def key_padding(mask: torch.Tensor) -> KeyPadding:
    return KeyPadding(mask_to_bias(mask), key_extent(mask))


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32, where the TPU kernel feeds
    a product in the input type (the identity for f32)."""
    return x.to(dtype).float()


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: f32 scores, p rounded to the
    input dtype for the product with v and normalised by the f32 row sum of
    the unrounded p, as the TPU kernel computes them."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", _rounded(p, q.dtype), v.float())
    o = o / l.permute(0, 2, 1, 3)  # l [B, H, T, 1] -> [B, T, H, 1]
    lse = (m + torch.log(l))[..., 0].permute(0, 2, 1)  # [B, H, T] -> [B, T, H]
    return o.to(q.dtype), lse.contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, dlse, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch: p recomputed from
    lse, delta = rowsum(do * o), ds = p * (dp - delta + dlse) * scale in f32;
    p (for dv) and ds (for dq, dk) rounded to the input dtype first, as the
    TPU kernel rounds them. ``dlse`` may be None (a zero lse cotangent).
    Returns dq, dk, dv in the input dtypes."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = s + bias[:, None, None, :]
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    delta = (dof * o.float()).sum(dim=-1).permute(0, 2, 1)[..., None]  # [B, H, T, 1]
    c = torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta
    if dlse is not None:
        c = c + dlse.permute(0, 2, 1)[..., None]
    ds = _rounded(p * c * scale, q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, q.dtype), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_flops(B: int, T: int, H: int, Dh: int, *, backward: bool) -> float:
    """The multiply-adds of the attention's products, counted over every key
    as the plain versions compute them: the forward's two (scores, then p
    with v), the backward's five (scores again, do with v, dq, dk, dv)."""
    return (10.0 if backward else 4.0) * B * H * T * T * Dh


def _check_extent(extent, B: int, device, what: str) -> None:
    _cuda.require(extent is None or (extent.dtype == torch.int32 and extent.shape == (B,)
                                     and extent.is_contiguous() and extent.device == device),
                  f"{what}: extent must be contiguous int32 [B] on the inputs' device")


def _rows_16b(x: torch.Tensor) -> torch.Tensor:
    """``x`` if every (batch, time) row of its bf16 elements starts on 16
    bytes, as the kernel's cp.async copies need, else a contiguous copy."""
    if x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, scale: float,
    extent: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel. q/k/v [B, T, H, Dh] f32 or bf16 with any batch and
    time strides (heads and head dim contiguous, as the split of the fused
    qkv projection leaves them), bias [B, T] f32 contiguous, extent [B]
    int32 (:func:`key_extent`) or None. Launches on PyTorch's current stream
    without synchronising."""
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
    _check_extent(extent, B, q.device, "flash_attention_fwd")
    if q.dtype == torch.bfloat16:
        q, k, v = _rows_16b(q), _rows_16b(k), _rows_16b(v)
    o = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    lib = _cuda.library(_SOURCE, _SIGNATURES)
    rc = lib.srt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if extent is None else extent.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, T, H, Dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), _DTYPE_CODE[q.dtype], q.device.index or 0, _cuda.stream_of(q),
    )
    _cuda.check(lib, rc, "flash_attention_fwd")
    _cuda.count_launch("flash_attention_fwd")
    _cuda.tally_flops(attention_flops(B, T, H, Dh, backward=False))
    return o, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, dlse, scale: float,
    extent: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA backward kernel (two launches: a query-major pass for delta
    and dq, then a key-major pass for dk and dv; deterministic, no atomics).
    q/k/v, bias and extent as :func:`flash_attention_fwd` takes them; o and
    do [B, T, H, Dh] contiguous in the input dtype; lse and dlse [B, T, H]
    f32 contiguous, dlse None for a zero lse cotangent. Returns contiguous
    dq, dk, dv in the input dtype, on PyTorch's current stream without
    synchronising."""
    _cuda.require(q.is_cuda and all(x.device == q.device for x in (k, v, bias, o, lse, do)),
                  "flash_attention_bwd: every input must be on one CUDA device")
    _cuda.require(q.dtype in _DTYPE_CODE and all(x.dtype == q.dtype for x in (k, v, o, do)),
                  f"flash_attention_bwd: q/k/v/o/do must share float32 or bfloat16, got "
                  f"{[x.dtype for x in (q, k, v, o, do)]}")
    _cuda.require(q.dim() == 4 and all(x.shape == q.shape for x in (k, v, o, do)),
                  "flash_attention_bwd: q/k/v/o/do must be [B, T, H, Dh] of one shape")
    B, T, H, Dh = q.shape
    _cuda.require(Dh in SUPPORTED_HEAD_DIMS,
                  f"flash_attention_bwd: head dim {Dh} not in {SUPPORTED_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _cuda.require(x.stride(3) == 1 and x.stride(2) == Dh,
                      f"flash_attention_bwd: {name} needs contiguous heads and head "
                      f"dim, got strides {x.stride()}")
    _cuda.require(o.is_contiguous() and do.is_contiguous(),
                  "flash_attention_bwd: o and do must be contiguous")
    for name, x in (("lse", lse), ("dlse", dlse)):
        _cuda.require(x is None or (x.dtype == torch.float32 and x.shape == (B, T, H)
                                    and x.is_contiguous() and x.device == q.device),
                      f"flash_attention_bwd: {name} must be contiguous float32 [B, T, H]")
    _cuda.require(bias.dtype == torch.float32 and bias.shape == (B, T)
                  and bias.is_contiguous(),
                  "flash_attention_bwd: bias must be contiguous float32 [B, T]")
    _check_extent(extent, B, q.device, "flash_attention_bwd")
    if q.dtype == torch.bfloat16:
        q, k, v, o, do = (_rows_16b(x) for x in (q, k, v, o, do))
    dq = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    delta = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    lib = _cuda.library(_BWD_SOURCE, _BWD_SIGNATURES)
    rc = lib.srt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if extent is None else extent.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), None if dlse is None else dlse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B, T, H, Dh,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), _DTYPE_CODE[q.dtype], q.device.index or 0, _cuda.stream_of(q),
    )
    _cuda.check(lib, rc, "flash_attention_bwd")
    _cuda.count_launch("flash_attention_bwd")
    _cuda.tally_flops(attention_flops(B, T, H, Dh, backward=True))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(o, lse) = attention(q, k, v, bias) with a backward that takes a
    cotangent for both outputs (either may be absent). The bias and the key
    extent are the mask's constants and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, extent=None):
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, bias, scale, extent)
        elif q.device.type == "cpu":  # over every key: past the extent p is exactly 0
            o, lse = flash_attention_plain(q, k, v, bias, scale)
        else:
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, bias, o, lse, extent)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse, extent = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        do = do.contiguous()
        if dlse is not None:
            dlse = dlse.float().contiguous()
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, ctx.scale, extent)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, bias, o, lse, do, dlse, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked attention. q/k/v [B, T, H, Dh], mask [B, T] bool (key
    padding). Returns (o [B, T, H, Dh] in q.dtype, lse [B, T, H] f32), both
    differentiable."""
    keys = key_padding(mask)
    return FlashAttention.apply(q, k, v, keys.bias, 1.0 / math.sqrt(q.shape[-1]), keys.extent)


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, keys: KeyPadding
) -> torch.Tensor:
    """The trunk's attention over a key padding built once per forward: the
    output of :class:`FlashAttention` (its backward then receives no lse
    cotangent)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, keys.bias, scale, keys.extent)[0]


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """:func:`masked_attention` from a [B, T] bool mask."""
    return masked_attention(q, k, v, key_padding(mask))
