"""Optimizers and learning-rate schedules: the ``@optimizers`` and
``@schedules`` blocks of ``[training]``.

Counterpart of ``spacy_ray_tpu/training/optimizers.py``, with the same config
surface. Schedules are plain Python on the step count, in float32 and in the
reference's operation order. ``Adam.v1`` and ``RAdam.v1`` run the whole optax
0.2.3 chain (clip by global norm, classic L2, moments, bias correction,
rectification, decoupled decay, learning rate, apply) as one fused update
(``ops/fused_update.py``: the K5 kernel on ``cuda``, ``leaf_math_plain`` on
``cpu``). ``torch.optim.Adam`` places eps and the decay differently and is
not used. ``SGD.v1`` is a few plain tensor ops.

Optimizer state is ``{"count": int, "sched_count": int, "mu": {path: tensor},
"nu": {path: tensor}}``, keyed by the parameter paths of ``params.npz``;
:meth:`Optimizer.load_opt_state` takes a flat ``{"mu/<path>", "nu/<path>"}``
numpy tree.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, Iterable, List, Union

import numpy as np
import torch

from ..ops.fused_update import (
    FusedHyper, FusedUpdate, global_norm, safe_int32_increment, step_scalars,
)
from ..registry import registry

ScheduleLike = Union[float, Callable[[int], float], Iterable[float]]
#: iterable learning rates are read this far and then held at their last value
SCHEDULE_TABLE_STEPS = 100_000
f32 = np.float32


class Schedule:
    """A learning-rate schedule: a step -> float32 callable that also
    iterates (thinc schedules are generators)."""

    def __init__(self, fn: Callable[[int], np.float32]):
        self.fn = fn
        self._step = 0

    def __call__(self, step: int) -> np.float32:
        return self.fn(step)

    def __iter__(self):
        return self

    def __next__(self) -> float:
        val = float(self.fn(self._step))
        self._step += 1
        return val


def as_schedule_fn(value: ScheduleLike) -> Callable[[int], np.float32]:
    """A learn_rate config value as a step -> float32 function. An iterable
    (``compounding.v1`` used as a rate) is read for its first 100 000 values;
    later steps keep the last one."""
    if isinstance(value, Schedule):
        return value.fn
    if isinstance(value, (int, float)):
        rate = f32(value)
        return lambda step: rate
    if callable(value):
        return lambda step: f32(value(step))
    table = [f32(v) for v in itertools.islice(iter(value), SCHEDULE_TABLE_STEPS)]
    if not table:
        return lambda step: f32(0.0)
    return lambda step: table[min(int(step), len(table) - 1)]


@registry.schedules("warmup_linear.v1")
def warmup_linear(initial_rate: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warmup, then linear decay to 0."""
    warmup = max(int(warmup_steps), 0)
    decay_span = max(int(total_steps) - warmup, 1)

    def fn(step: int) -> np.float32:
        s = f32(step)
        frac = (s - f32(warmup)) / f32(decay_span)
        decayed = max(f32(initial_rate) * (f32(1.0) - frac), f32(0.0))
        if warmup == 0 or not s < warmup:
            return decayed
        return f32(initial_rate) * (s + f32(1.0)) / f32(max(warmup, 1))

    return Schedule(fn)


@registry.schedules("linear.v1")
def linear(initial_rate: float, final_rate: float, total_steps: int) -> Schedule:
    span = max(int(total_steps), 1)

    def fn(step: int) -> np.float32:
        frac = min(f32(step) / f32(span), f32(1.0))
        return f32(initial_rate) + f32(final_rate - initial_rate) * frac

    return Schedule(fn)


@registry.schedules("cosine.v1")
def cosine(initial_rate: float, total_steps: int, final_scale: float = 0.0) -> Schedule:
    span = max(int(total_steps), 1)

    def fn(step: int) -> np.float32:
        frac = min(f32(step) / f32(span), f32(1.0))
        wave = f32(1.0) + np.cos(f32(math.pi) * frac)
        return f32(initial_rate) * (f32(final_scale) + f32((1 - final_scale) * 0.5) * wave)

    return Schedule(fn)


def is_frozen(path: str) -> bool:
    """Is the leaf at ``path`` frozen: under a key that starts with
    ``frozen_`` (a static-vector table)? The JAX package masks such leaves
    out of its optax chain (``mask_frozen``: no update, no L2, no moments,
    no share in the global norm); here they are left out of the optimizer's
    leaves altogether, so the fused update never sees them."""
    return any(part.startswith("frozen_") for part in path.split("/"))


class Optimizer:
    """An update rule over named parameters. ``use_averages`` asks the loop
    to keep a running mean of the parameters for evaluation and the best
    model (thinc's averages)."""

    def __init__(self, lr_fn: Callable[[int], np.float32], grad_clip: float,
                 use_averages: bool = False):
        self.lr_fn = lr_fn
        self.grad_clip = float(grad_clip or 0.0)
        self.use_averages = use_averages
        self.has_moments = True

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        moments = self.has_moments
        return {
            "count": 0, "sched_count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()} if moments else {},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()} if moments else {},
        }

    def load_opt_state(self, state: Dict[str, Any], flat: Dict[str, Any]) -> None:
        """Fill ``state`` from a flat numpy tree: ``mu/<path>`` and
        ``nu/<path>`` for every parameter path (same shapes), and optionally
        ``count`` and ``sched_count``."""
        want = {f"{m}/{k}": t for m in ("mu", "nu") for k, t in state[m].items()}
        missing = sorted(set(want) - set(flat))
        bad = sorted(k for k in set(want) & set(flat)
                     if tuple(np.shape(flat[k])) != tuple(want[k].shape))
        extra = sorted(k for k in set(flat) - set(want) if k not in ("count", "sched_count"))
        if missing or bad or extra:
            raise ValueError(f"opt state does not match the parameters (missing: {missing[:5]}, "
                             f"shape-mismatched: {bad[:5]}, unexpected: {extra[:5]})")
        with torch.no_grad():
            for k, t in want.items():
                t.copy_(torch.from_numpy(np.array(flat[k], dtype=np.float32)))
        for key in ("count", "sched_count"):
            if key in flat:
                state[key] = int(np.asarray(flat[key]))

    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict[str, Any]) -> torch.Tensor:
        """Apply one step in place; returns the gradients' global norm (a
        0-dim f32 tensor on the device)."""
        raise NotImplementedError


class FusedOptimizer(Optimizer):
    """Adam or RAdam as the fused chain of ``ops/fused_update.py``."""

    def __init__(self, hyper: FusedHyper, lr_fn, use_averages: bool = False):
        super().__init__(lr_fn, hyper.grad_clip, use_averages)
        self.hyper = hyper
        self.fused = FusedUpdate(hyper)

    def update(self, params, grads, state) -> torch.Tensor:
        keys = list(params)
        g = [grads[k] for k in keys]
        gnorm = global_norm(g)
        sc = step_scalars(self.hyper, state["count"], state["sched_count"], self.lr_fn)
        self.fused.step([params[k] for k in keys], g, [state["mu"][k] for k in keys],
                        [state["nu"][k] for k in keys], gnorm, sc)
        state["count"] = safe_int32_increment(state["count"])
        state["sched_count"] = safe_int32_increment(state["sched_count"])
        return gnorm


class SGDOptimizer(Optimizer):
    """optax's clip -> (L2 into the gradient) -> -lr scale -> apply."""

    def __init__(self, lr_fn, L2: float, grad_clip: float):
        super().__init__(lr_fn, grad_clip)
        self.L2 = float(L2 or 0.0)
        self.has_moments = False

    def update(self, params, grads, state) -> torch.Tensor:
        keys = list(params)
        gnorm = global_norm([grads[k] for k in keys])
        step_size = float(f32(-1.0) * f32(self.lr_fn(state["sched_count"])))
        with torch.no_grad():
            for k in keys:
                p, g = params[k], grads[k]
                if self.grad_clip > 0:
                    g = torch.where(gnorm < self.grad_clip, g, (g / gnorm) * self.grad_clip)
                if self.L2:
                    g = g + self.L2 * p
                p.copy_(p + step_size * g)
        state["count"] = safe_int32_increment(state["count"])
        state["sched_count"] = safe_int32_increment(state["sched_count"])
        return gnorm


@registry.optimizers("Adam.v1")
def Adam(
    learn_rate: ScheduleLike = 0.001,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    L2: float = 0.0,
    grad_clip: float = 1.0,
    L2_is_weight_decay: bool = True,
    use_averages: bool = False,
) -> FusedOptimizer:
    hyper = FusedHyper(
        kind="adam", b1=float(beta1), b2=float(beta2), eps=float(eps),
        grad_clip=float(grad_clip) if grad_clip and grad_clip > 0 else 0.0,
        l2_grad=float(L2) if (L2 and not L2_is_weight_decay) else 0.0,
        l2_decay=float(L2) if (L2 and L2_is_weight_decay) else 0.0,
    )
    return FusedOptimizer(hyper, as_schedule_fn(learn_rate), use_averages=use_averages)


@registry.optimizers("RAdam.v1")
def RAdam(
    learn_rate: ScheduleLike = 0.001,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float = 1.0,
) -> FusedOptimizer:
    hyper = FusedHyper(
        kind="radam", b1=float(beta1), b2=float(beta2), eps=float(eps),
        grad_clip=float(grad_clip) if grad_clip and grad_clip > 0 else 0.0,
        l2_grad=0.0, l2_decay=float(weight_decay or 0.0),
    )
    return FusedOptimizer(hyper, as_schedule_fn(learn_rate))


@registry.optimizers("SGD.v1")
def SGD(learn_rate: ScheduleLike = 0.001, L2: float = 0.0,
        grad_clip: float = 1.0) -> SGDOptimizer:
    return SGDOptimizer(as_schedule_fn(learn_rate), L2,
                        grad_clip if grad_clip and grad_clip > 0 else 0.0)


def average_step(avg: List[torch.Tensor], params: List[torch.Tensor], t: int) -> None:
    """One running-mean step of ``use_averages``: ``a + (p - a) / t``, in
    place."""
    tt = float(f32(t))
    with torch.no_grad():
        for a, p in zip(avg, params):
            a.copy_(a + (p - a) / tt)
