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
over every leaf (:meth:`FusedUpdate.kernel_step`), over the chunks of
:func:`chunk_plan`; on CPU tensors it is :func:`leaf_math_plain`, a
line-for-line copy of ``_leaf_math`` in the same expression order, per leaf.
The two agree bit for bit (the kernel is built without FMA contraction).
Against the JAX package run op by op they agree to 1 ulp; a jitted XLA CPU
program contracts ``(1 - b1) * g + b1 * m`` into an FMA and so differs from
both by more ulp where the two terms cancel.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _cuda

_SOURCE = "fused_update.cu"
_F = ctypes.c_float
_SIGNATURES = {
    "srt_fused_update": (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        _F, _F, _F, _F, _F, _F, _F, _F, ctypes.c_int, _F, _F, _F, _F,
        ctypes.c_int, ctypes.c_void_p,
    ),
}
#: elements per chunk (one CTA of 256 threads each) of the fused kernel, a
#: multiple of VEC: 4096 gives each thread one pass of four float4s per
#: tensor (PERF.md)
CHUNK = 4096
#: floats in one 16-byte vector
VEC = 4
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


class Chunk(NamedTuple):
    """Elements ``[start, stop)`` of leaf ``leaf``, as float4s (``vec``) or
    one float at a time."""

    leaf: int
    start: int
    stop: int
    vec: bool


def chunk_plan(leaves: Sequence[Tuple[int, int, int, int, int]],
               chunk: int = CHUNK) -> List[Chunk]:
    """The K5 kernel's work list. ``leaves`` gives each leaf's element count
    and the byte addresses of its p, g, m and v: ``(numel, p, g, m, v)``.
    Every element of every leaf lies in exactly one chunk of at most
    ``chunk`` elements, in leaf order. Where the four addresses agree modulo
    16 bytes, a leaf is its scalar head up to the first 16-byte boundary,
    vector chunks (16-byte aligned in all four tensors, a multiple of
    :data:`VEC` long) and its scalar tail; where they disagree, it is scalar
    chunks only."""
    if chunk <= 0 or chunk % VEC or chunk >= 2 ** 31:
        raise ValueError(f"fused_update: chunk must be a positive multiple of {VEC} "
                         f"below 2**31, got {chunk}")
    plan = []
    for i, (n, *addrs) in enumerate(leaves):
        if any(a % 4 for a in addrs):
            raise ValueError(f"fused_update: leaf {i} is not 4-byte aligned")
        if len({a % 16 for a in addrs}) == 1:
            head = min(n, -addrs[0] % 16 // 4)
            body = (n - head) // VEC * VEC
        else:
            head, body = n, 0
        for lo, hi, vec in ((0, head, False), (head, head + body, True), (head + body, n, False)):
            plan += [Chunk(i, s, min(s + chunk, hi), vec) for s in range(lo, hi, chunk)]
    return plan


def chunk_rows(leaves: Sequence[Tuple[int, int, int, int, int]],
               chunk: int = CHUNK) -> List[List[int]]:
    """The kernel's table, one row per chunk of :func:`chunk_plan`: the byte
    addresses of the chunk's first element in p, g, m and v, its length, and
    1 for a vector chunk or 0."""
    return [[a + 4 * c.start for a in leaves[c.leaf][1:]] + [c.stop - c.start, int(c.vec)]
            for c in chunk_plan(leaves, chunk)]


class FusedUpdate:
    """The per-element chain over a list of leaves, in place. Holds the K5
    kernel's device table of chunks (:func:`chunk_plan`), built and checked
    once per parameter set: the same tensors step after step. Each step
    compares only the tensors' identities and addresses with the table's;
    any change rebuilds and rechecks it."""

    def __init__(self, hyper: FusedHyper):
        if hyper.kind not in ("adam", "radam"):
            raise ValueError(f"unknown fused optimizer kind {hyper.kind!r}")
        self.hyper = hyper
        self._tensors: List[torch.Tensor] = []
        self._ptrs: List[int] = []
        self._table: Optional[torch.Tensor] = None

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

    def _chunk_table(self, params, grads, mu, nu) -> torch.Tensor:
        tensors = [*params, *grads, *mu, *nu]
        ptrs = [t.data_ptr() for t in tensors]
        if (self._table is not None and ptrs == self._ptrs
                and all(map(operator.is_, tensors, self._tensors))):
            return self._table
        dev = params[0].device
        _cuda.require(len(params) == len(grads) == len(mu) == len(nu),
                      "fused_update: p, g, m, v must be lists of one length")
        for t in tensors:
            _cuda.require(t.is_cuda and t.device == dev and t.dtype == torch.float32
                          and t.is_contiguous(),
                          "fused_update: p, g, m, v must be contiguous float32 "
                          "tensors on one CUDA device")
        _cuda.require(all(p.shape == g.shape == m.shape == v.shape
                          for p, g, m, v in zip(params, grads, mu, nu)),
                      "fused_update: p, g, m, v of a leaf must share a shape")
        n = len(params)
        leaves = [(params[i].numel(), *ptrs[i::n]) for i in range(n)]
        rows = chunk_rows(leaves, CHUNK)
        self._table = torch.tensor(rows, dtype=torch.int64).reshape(-1, 6).to(dev)
        self._tensors, self._ptrs = tensors, ptrs
        return self._table

    def kernel_step(self, params, grads, mu, nu, gnorm, sc: StepScalars) -> None:
        """The CUDA kernel: one launch over every leaf, on PyTorch's current
        stream, without synchronising. Every tensor f32, contiguous, on one
        card; gnorm a 0-dim f32 tensor there (read when clipping)."""
        h = self.hyper
        table = self._chunk_table(params, grads, mu, nu)
        dev = params[0].device
        if h.grad_clip > 0:
            _cuda.require(gnorm is not None and gnorm.is_cuda and gnorm.device == dev
                          and gnorm.dtype == torch.float32 and gnorm.numel() == 1,
                          "fused_update: clipping needs the global norm as one f32 on the card")
        # RAdam's branch is one host comparison, as in leaf_math_plain
        mode = 0 if h.kind == "adam" else 1 if sc.ro >= h.radam_threshold else 2
        lib = _cuda.library(_SOURCE, _SIGNATURES)
        rc = lib.srt_fused_update(
            table.data_ptr(), table.shape[0], gnorm.data_ptr() if h.grad_clip > 0 else None,
            1 - h.b1, h.b1, 1 - h.b2, h.b2, h.eps, h.grad_clip, h.l2_grad, h.l2_decay,
            mode, sc.bc1, sc.bc2, sc.step_size, sc.rect,
            dev.index or 0, _cuda.stream_of(params[0]),
        )
        _cuda.check(lib, rc, "fused_update")
        _cuda.LAUNCHES["fused_update"] += 1
