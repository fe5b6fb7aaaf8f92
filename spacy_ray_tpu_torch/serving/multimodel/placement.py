"""Placement-aware scaling: which models the replicas host, not only how
many replicas run (``spacy_ray_tpu/serving/multimodel/placement.py``).

The :class:`~..fleet.autoscaler.AutoscalerPolicy` sizes the fleet from the
merged window p99. This policy reads the per-model window p99 (the merged
``by_model`` block) and the placement the router's probes learned from each
replica's ``/healthz``, and decides residency moves:

* a model whose window p99 breaches its target (the tightest class target
  of the manifest, else the fleet's default) on enough consecutive
  observations is loaded onto the ready replica with the fewest resident
  models that does not host it yet: the hot model's routing subset widens;
* a model that never breaches moves nowhere: replicas keep the residency
  their traffic gave them (LRU).

Decisions pass the same hysteresis as the replica count (consecutive
breaches, a cooldown, an injectable clock). The policy only decides; the
fleet applies a decision through the replica's ``/admin/models/load`` and
appends it to its placement ledger. Built only with a manifest; it calls no
telemetry itself.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping

__all__ = ["PlacementDecision", "PlacementPolicy"]


@dataclass(frozen=True)
class PlacementDecision:
    """One residency move: load ``model`` onto replica ``replica_id``."""

    model: str
    replica_id: int
    reason: str


@dataclass
class _ModelState:
    breach_streak: int = 0
    last_move_at: float = field(default=float("-inf"))


class PlacementPolicy:
    def __init__(self, registry: Any, *, default_p99_target_ms: float = 500.0,
                 breach_consecutive: int = 3, cooldown_s: float = 30.0,
                 min_window_samples: int = 20,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.registry = registry
        self.default_p99_target_ms = float(default_p99_target_ms)
        self.breach_consecutive = int(breach_consecutive)
        self.cooldown_s = float(cooldown_s)
        self.min_window_samples = int(min_window_samples)
        self.clock = clock
        self._state: Dict[str, _ModelState] = {}

    def _target_s(self, model: str) -> float:
        """The tightest class target any tenant could hold this model to;
        without classes, the fleet's default."""
        targets = [c.p99_target_ms for c in getattr(self.registry, "classes", {}).values()
                   if c.p99_target_ms is not None]
        return (min(targets) if targets else self.default_p99_target_ms) / 1e3

    def observe(self, by_model: Mapping[str, Mapping[str, Any]],
                placement: Mapping[int, List[str]],
                ready_replicas: List[int]) -> List[PlacementDecision]:
        """One observe-decide cycle. ``by_model``: model -> ``{"p99":
        seconds, "samples": int}`` (the merged window); ``placement``:
        replica id -> its resident models; ``ready_replicas``: the ids the
        router may route to."""
        now = self.clock()
        decisions: List[PlacementDecision] = []
        for model in sorted(by_model):
            obs = by_model[model]
            p99 = obs.get("p99")
            samples = int(obs.get("samples") or 0)
            state = self._state.setdefault(model, _ModelState())
            if (not isinstance(p99, (int, float)) or samples < self.min_window_samples
                    or float(p99) <= self._target_s(model)):
                state.breach_streak = 0
                continue
            state.breach_streak += 1
            if state.breach_streak < self.breach_consecutive:
                continue
            if now - state.last_move_at < self.cooldown_s:
                continue  # the cooldown defers; the streak stands
            hosts = {rid for rid, models in placement.items() if model in models}
            candidates = [rid for rid in ready_replicas if rid not in hosts]
            if not candidates:
                # every ready replica hosts it: the replica count is the next
                # lever, and that is the autoscaler's
                state.breach_streak = 0
                continue
            target = min(candidates, key=lambda rid: len(placement.get(rid, [])))
            decisions.append(PlacementDecision(
                model=model, replica_id=target,
                reason=(f"window p99 {float(p99) * 1e3:.0f}ms > target "
                        f"{self._target_s(model) * 1e3:.0f}ms for {state.breach_streak} "
                        "consecutive observations")))
            state.breach_streak = 0
            state.last_move_at = now
        return decisions
