"""SLO-driven autoscaling of the serving fleet
(``spacy_ray_tpu/serving/fleet/autoscaler.py``).

:class:`AutoscalerPolicy` takes one :class:`FleetObservation` a tick (the
worst replica's p99, the queued docs, the mean batch occupancy, the ready
count) and answers the replica count it wants, or None to hold:

* **Hysteresis.** Scaling up needs ``up_consecutive`` overloaded ticks in a
  row (p99 above target, or queued docs per ready replica above
  :data:`QUEUE_HIGH`); scaling down needs ``down_consecutive`` idle ticks
  (p99 under :data:`DOWN_FRAC` x target, occupancy under
  :data:`OCCUPANCY_LOW`, empty queues). One tick that does not confirm
  resets the streak, so a metric that crosses the line every other tick
  never scales.
* **Cooldown.** After a decision, ticks within ``cooldown_s`` (on the
  injected clock) are discarded, not banked: the last action has not landed.
* **Bounds.** Never below ``min_replicas`` nor above ``max_replicas``; a
  decision moves one replica.

Every decision is kept in :attr:`AutoscalerPolicy.decisions` and logged as
an ``autoscale-up``/``autoscale-down`` event; the policy makes no telemetry
call of its own.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ...training.resilience import log_event

__all__ = ["FleetObservation", "AutoscalerPolicy", "observation_from_snapshots"]

#: queued docs per ready replica that count as overload without a p99
QUEUE_HIGH = 32.0
#: an idle tick's p99 is under this share of the target...
DOWN_FRAC = 0.5
#: ...and its mean batch occupancy under this
OCCUPANCY_LOW = 2.0


@dataclass
class FleetObservation:
    """One tick of the fleet's SLO signal, already aggregated."""

    ready: int                         # replicas taking traffic
    p99_s: Optional[float] = None      # the worst replica's request-latency p99
    queue_depth: float = 0.0           # queued docs over all replicas
    occupancy: Optional[float] = None  # mean batch occupancy


def observation_from_snapshots(snaps: List[Dict[str, Any]], ready: int) -> FleetObservation:
    """An observation from the replicas' ``/metrics`` snapshots. The p99 is
    the worst replica's, read from its ``slo_window`` (the last seconds'
    load) where it has one: an empty window is no signal, not the older
    ring's spike. Missing pieces stay None (no signal, no pressure)."""
    p99s = []
    queue = 0.0
    occ_sum = occ_n = 0.0
    for snap in snaps:
        slo = snap.get("slo") or {}
        win = snap.get("slo_window")
        if isinstance(win, dict):
            p99 = win.get("request_latency_p99") if int(win.get("samples") or 0) > 0 else None
        else:
            p99 = slo.get("request_latency_p99")
        if isinstance(p99, (int, float)):
            p99s.append(float(p99))
        qd = (snap.get("gauges") or {}).get("queue_depth")
        if isinstance(qd, (int, float)):
            queue += float(qd)
        occ = slo.get("batch_occupancy_p50")
        if isinstance(occ, (int, float)):
            occ_sum += float(occ)
            occ_n += 1
    return FleetObservation(ready=int(ready), p99_s=max(p99s) if p99s else None,
                            queue_depth=queue, occupancy=(occ_sum / occ_n) if occ_n else None)


class AutoscalerPolicy:
    """The hysteresis policy of the module docstring: :meth:`observe` once a
    tick returns the desired replica count or None. Deterministic on its
    ``clock``."""

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        p99_target_s: float = 0.5,
        up_consecutive: int = 3,
        down_consecutive: int = 10,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas ({max_replicas}) must be >= min_replicas "
                             f"({min_replicas})")
        if up_consecutive < 1 or down_consecutive < 1:
            raise ValueError("hysteresis windows must be >= 1 observation")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.p99_target_s = float(p99_target_s)
        self.up_consecutive = int(up_consecutive)
        self.down_consecutive = int(down_consecutive)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_at: Optional[float] = None
        self.decisions: List[Dict[str, Any]] = []

    def _overloaded(self, obs: FleetObservation) -> bool:
        if obs.p99_s is not None and obs.p99_s > self.p99_target_s:
            return True
        return obs.queue_depth / max(obs.ready, 1) > QUEUE_HIGH

    def _idle(self, obs: FleetObservation) -> bool:
        if obs.queue_depth > 0:
            return False
        if obs.p99_s is not None and obs.p99_s > DOWN_FRAC * self.p99_target_s:
            return False
        return not (obs.occupancy is not None and obs.occupancy > OCCUPANCY_LOW)

    def observe(self, obs: FleetObservation) -> Optional[int]:
        """Classify the tick, advance the streaks, and return the desired
        count when a streak completes outside the cooldown."""
        over = self._overloaded(obs)
        idle = self._idle(obs)
        now = self.clock()
        if self._last_action_at is not None and now - self._last_action_at < self.cooldown_s:
            self._up_streak = self._down_streak = 0
            return None
        self._up_streak = self._up_streak + 1 if over else 0
        self._down_streak = self._down_streak + 1 if idle else 0
        if over and self._up_streak >= self.up_consecutive:
            desired = min(obs.ready + 1, self.max_replicas)
            if desired > obs.ready:
                self._record("up", obs, desired, now)
                return desired
            self._up_streak = 0  # pinned at the maximum: do not fire every tick
            return None
        if idle and self._down_streak >= self.down_consecutive:
            desired = max(obs.ready - 1, self.min_replicas)
            if desired < obs.ready:
                self._record("down", obs, desired, now)
                return desired
            self._down_streak = 0
            return None
        return None

    def _record(self, direction: str, obs: FleetObservation, desired: int, now: float) -> None:
        self._last_action_at = now
        self._up_streak = 0
        self._down_streak = 0
        decision = {
            "direction": direction,
            "from": obs.ready,
            "to": desired,
            "p99_s": obs.p99_s,
            "p99_target_s": self.p99_target_s,
            "queue_depth": obs.queue_depth,
            "occupancy": obs.occupancy,
        }
        self.decisions.append(decision)
        log_event(f"autoscale-{direction}",
                  f"scaling {obs.ready} -> {desired} replicas "
                  f"(p99 {obs.p99_s if obs.p99_s is not None else 'n/a'} vs "
                  f"target {self.p99_target_s}s, queue {obs.queue_depth:.0f}, "
                  f"occupancy {obs.occupancy if obs.occupancy is not None else 'n/a'})",
                  level=logging.INFO, **decision)
