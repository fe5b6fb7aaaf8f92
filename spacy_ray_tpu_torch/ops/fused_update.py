"""Fused Adam/RAdam update: the whole optimizer chain in one pass per step.

Counterpart of ``spacy_ray_tpu/ops/fused_update.py``. One step is

* the step scalars of ``FusedTransformation.update``: the count increment,
  the bias corrections ``bc1 = 1 - b1**count``, ``bc2 = 1 - b2**count``,
  ``step_size = -lr(schedule count before its increment)`` and, for RAdam,
  ``ro`` and ``rect``; computed on the host in float32 in the reference's
  operation order (:func:`step_scalars`), so they are the reference's values
  bit for bit;
* the gradient's global norm ``sqrt(sum over leaves of sum g**2)`` in f32,
  on the device (:func:`global_norm`: PyTorch's ``_foreach_norm`` and a norm
  of the per-leaf norms, which rounds differently from optax's one sum, by a
  few float32 ulp);
* the per-element chain of ``_leaf_math`` (clip select, classic L2, moments,
  bias correction, RAdam rectification, decoupled decay, learning rate,
  ``p + u``), in place.

On CUDA tensors the per-element chain is one launch of ``csrc/fused_update.cu``
over every leaf (:meth:`FusedUpdate.kernel_step`); on CPU tensors it is
:func:`leaf_math_plain`, a line-for-line copy of ``_leaf_math`` in the same
expression order, per leaf. The two agree bit for bit (the kernel is built
without FMA contraction). Against the JAX package run op by op they agree to
1 ulp; a jitted XLA CPU program contracts ``(1 - b1) * g + b1 * m`` into an
FMA and so differs from both by more ulp where the two terms cancel.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _cuda

_SOURCE = "fused_update.cu"
_F = ctypes.c_float
_SIGNATURES = {
    "srt_fused_update": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        _F, _F, _F, _F, _F, _F, _F, _F, _F, ctypes.c_int, _F, _F, _F, _F, _F,
        ctypes.c_int, ctypes.c_void_p,
    ),
}
#: elements per CTA of the fused kernel
CHUNK = 65536
_INT32_MAX = 2 ** 31 - 1


class FusedHyper(NamedTuple):
    """Static hyperparameters of one fused update (Python floats, as the
    JAX package's)."""

    kind: str  # "adam" | "radam"
    b1: float
    b2: float
    eps: float
    grad_clip: float  # 0 = no clipping link
    l2_grad: float  # classic L2 added to grads BEFORE adam (0 = absent)
    l2_decay: float  # decoupled weight decay AFTER adam (0 = absent)
    radam_threshold: float = 5.0


class StepScalars(NamedTuple):
    """The per-step scalars of ``_update_kernel`` (float32 values held in
    Python floats; ro and rect are 0 for Adam)."""

    bc1: float
    bc2: float
    step_size: float
    ro: float
    rect: float


def safe_int32_increment(count: int) -> int:
    """optax's ``safe_int32_increment``: +1, saturating at int32's max."""
    return count + 1 if count < _INT32_MAX else count


def step_scalars(hyper: FusedHyper, count: int, sched_count: int,
                 lr_fn: Callable[[int], np.float32]) -> StepScalars:
    """Scalars of the step that takes the moment count from ``count`` to
    ``count + 1``; the learning rate is read at the schedule count BEFORE
    its increment (optax ``scale_by_schedule``). Every operation is a
    float32 one, in the order the reference traces: ``b ** count`` is
    float32 ``powf`` with the integer count, ``2 * count`` an integer."""
    f = np.float32
    count_inc = safe_int32_increment(int(count))
    cf = f(count_inc)
    with np.errstate(over="ignore", under="ignore", invalid="ignore", divide="ignore"):
        bc1 = f(1.0) - f(hyper.b1) ** cf
        bc2 = f(1.0) - f(hyper.b2) ** cf
        step_size = f(-1.0) * f(lr_fn(int(sched_count)))
        ro = rect = f(0.0)
        if hyper.kind == "radam":
            ro_inf = 2.0 / (1 - hyper.b2) - 1
            b2t = f(hyper.b2) ** cf
            ro = f(ro_inf) - f(2 * count_inc) * b2t / (f(1.0) - b2t)
            rect = np.sqrt((ro - f(4.0)) * (ro - f(2.0)) * f(ro_inf)
                           / (f((ro_inf - 4) * (ro_inf - 2)) * ro))
    return StepScalars(float(bc1), float(bc2), float(step_size), float(ro), float(rect))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum over leaves of sum g**2)`` as a 0-dim f32 tensor on the
    grads' device: the per-leaf 2-norms (``torch._foreach_norm``), then the
    2-norm of those."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm(grads)
    return torch.linalg.vector_norm(torch.stack(norms))


def leaf_math_plain(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    gnorm: Optional[torch.Tensor], bc1: float, bc2: float, step_size: float,
    ro: float, rect: float, hyper: FusedHyper,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf's whole chain, ``_leaf_math`` line for line: clip -> (classic
    L2) -> moments -> bias correction -> (RAdam rectification) -> (decoupled
    decay) -> lr -> apply. Returns new (p, m, v)."""
    if hyper.grad_clip > 0:
        g = torch.where(gnorm < hyper.grad_clip, g, (g / gnorm) * hyper.grad_clip)
    if hyper.l2_grad:
        g = g + hyper.l2_grad * p
    m2 = (1 - hyper.b1) * g + hyper.b1 * m
    v2 = (1 - hyper.b2) * (g * g) + hyper.b2 * v
    # divide by tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    mu_hat = m2 / torch.tensor(bc1, dtype=m2.dtype, device=m2.device)
    nu_hat = v2 / torch.tensor(bc2, dtype=v2.dtype, device=v2.device)
    if hyper.kind == "radam":
        # rect is NaN for ro < 4: that branch is never evaluated then
        if ro >= hyper.radam_threshold:
            u = rect * mu_hat / (torch.sqrt(nu_hat) + hyper.eps)
        else:
            u = mu_hat
    else:
        u = mu_hat / (torch.sqrt(nu_hat) + hyper.eps)
    if hyper.l2_decay:
        u = u + hyper.l2_decay * p
    u = step_size * u
    return p + u, m2, v2


class FusedUpdate:
    """The per-element chain over a list of leaves, in place. Holds the K5
    kernel's device table of leaf addresses, built once per parameter set
    (the same tensors step after step) and rebuilt when any address
    changes."""

    def __init__(self, hyper: FusedHyper):
        if hyper.kind not in ("adam", "radam"):
            raise ValueError(f"unknown fused optimizer kind {hyper.kind!r}")
        self.hyper = hyper
        self._table: Optional[Tuple[tuple, torch.Tensor, torch.Tensor]] = None

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             mu: List[torch.Tensor], nu: List[torch.Tensor],
             gnorm: Optional[torch.Tensor], sc: StepScalars) -> None:
        """Update every (p, m, v) in place from its g. CUDA leaves take the
        kernel, CPU leaves the plain version; the leaves share one device."""
        if not params:
            return
        if params[0].is_cuda:
            self.kernel_step(params, grads, mu, nu, gnorm, sc)
            return
        if params[0].device.type != "cpu":
            raise ValueError(f"fused update: unsupported device {params[0].device}")
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                p2, m2, v2 = leaf_math_plain(p, g, m, v, gnorm, *sc, hyper=self.hyper)
                p.copy_(p2)
                m.copy_(m2)
                v.copy_(v2)

    def _leaf_table(self, params, grads, mu, nu) -> Tuple[torch.Tensor, torch.Tensor]:
        key = tuple((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
                    for p, g, m, v in zip(params, grads, mu, nu))
        if self._table is None or self._table[0] != key:
            chunks = [(i, s) for i, (*_, n) in enumerate(key) for s in range(0, n, CHUNK)]
            dev = params[0].device
            leaves = torch.tensor(key, dtype=torch.int64).to(dev)
            table = torch.tensor(chunks, dtype=torch.int64).reshape(-1, 2).to(dev)
            self._table = (key, leaves, table)
        return self._table[1], self._table[2]

    def kernel_step(self, params, grads, mu, nu, gnorm, sc: StepScalars) -> None:
        """The CUDA kernel: one launch over every leaf, on PyTorch's current
        stream, without synchronising. Every tensor f32, contiguous, on one
        card; gnorm a 0-dim f32 tensor there (read when clipping)."""
        h = self.hyper
        dev = params[0].device
        for group in (params, grads, mu, nu):
            for t in group:
                _cuda.require(t.is_cuda and t.device == dev and t.dtype == torch.float32
                              and t.is_contiguous(),
                              "fused_update: p, g, m, v must be contiguous float32 "
                              "tensors on one CUDA device")
        _cuda.require(all(p.shape == g.shape == m.shape == v.shape
                          for p, g, m, v in zip(params, grads, mu, nu)),
                      "fused_update: p, g, m, v of a leaf must share a shape")
        if h.grad_clip > 0:
            _cuda.require(gnorm is not None and gnorm.is_cuda and gnorm.device == dev
                          and gnorm.dtype == torch.float32 and gnorm.numel() == 1,
                          "fused_update: clipping needs the global norm as one f32 on the card")
        leaves, chunks = self._leaf_table(params, grads, mu, nu)
        lib = _cuda.library(_SOURCE, _SIGNATURES)
        rc = lib.srt_fused_update(
            leaves.data_ptr(), chunks.data_ptr(), chunks.shape[0], CHUNK,
            gnorm.data_ptr() if h.grad_clip > 0 else None,
            1 - h.b1, h.b1, 1 - h.b2, h.b2, h.eps, h.grad_clip, h.l2_grad, h.l2_decay,
            h.radam_threshold, int(h.kind == "radam"),
            sc.bc1, sc.bc2, sc.step_size, sc.ro, sc.rect,
            dev.index or 0, _cuda.stream_of(params[0]),
        )
        _cuda.check(lib, rc, "fused_update")
        _cuda.LAUNCHES["fused_update"] += 1
