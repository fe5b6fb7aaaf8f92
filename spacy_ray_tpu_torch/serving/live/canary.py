"""The canary guard: promote or roll back a generation under rollout
(``spacy_ray_tpu/serving/live/canary.py``).

The guard reads what the replicas already report: per-generation request
and error counters and the sliding-window latency percentiles
(``slo_window``), grouped by :func:`~...training.telemetry.merge_serving_snapshots`.
Each tick it answers one question: keep the canary, kill it, or keep
watching.

* **Counter deltas, not lifetimes.** A canary replica carries its counters
  from before the swap; :meth:`CanaryGuard.begin` snapshots both sides at
  the canary's start, so error rates cover the rollout's traffic only.
* **Hysteresis both ways.** A rollback needs ``bad_consecutive`` breaching
  ticks in a row; a promotion needs ``good_consecutive`` clean ticks and at
  least ``min_canary_requests`` canary requests.
* **Silence is not good news.** Missing percentiles or too few samples
  hold the rollout; only evidence promotes.

Every verdict is a structured :func:`~...training.resilience.log_event`
record; the controller turns it into admin calls.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ...training.resilience import log_event

__all__ = ["GenerationStats", "CanaryGuard"]


@dataclass
class GenerationStats:
    """One side's signal for one tick, from a merged snapshot (or built
    directly in tests)."""

    generation: Optional[int] = None
    requests: float = 0.0  # lifetime counter (the guard takes deltas)
    errors: float = 0.0  # lifetime counter (the guard takes deltas)
    window_samples: int = 0  # latency samples in the SLO window
    p99_s: Optional[float] = None  # window p99 (the worst replica's where merged)

    @classmethod
    def from_merged(cls, block: Optional[Dict[str, Any]],
                    generation: Optional[int] = None) -> "GenerationStats":
        """A merged metrics block distilled; what is missing stays at the
        no-signal defaults, which the guard holds on."""
        if not isinstance(block, dict):
            return cls(generation=generation)
        counters = block.get("counters") or {}
        win = block.get("slo_window") or {}
        p99 = win.get("request_latency_p99_worst")
        if not isinstance(p99, (int, float)):
            p99 = win.get("request_latency_p99")
        # errors for the guard: failed dispatches and timed-out requests. A
        # generation that misses every deadline answers no 500 and records
        # no latency sample; deadline_exceeded is then its only signal
        errors = (float(counters.get("errors") or 0.0)
                  + float(counters.get("deadline_exceeded") or 0.0))
        return cls(generation=block.get("generation", generation),
                   requests=float(counters.get("requests") or 0.0), errors=errors,
                   window_samples=int(win.get("samples") or 0),
                   p99_s=float(p99) if isinstance(p99, (int, float)) else None)


class CanaryGuard:
    """:meth:`observe` once a tick during a rollout returns ``"promote"``,
    ``"rollback"`` or None (keep watching).

    Rollback, either trigger for ``bad_consecutive`` ticks: the canary's
    error rate above ``error_rate_high`` and above the baseline's over the
    same interval; or its window p99 above ``p99_frac`` x the baseline's,
    both windows holding ``min_window_samples``.

    Promotion: ``good_consecutive`` clean ticks with at least
    ``min_canary_requests`` canary requests since :meth:`begin`, where clean
    includes a latency verdict: both windows comparable and the canary
    within budget, or a baseline with no latency signal at all (one
    replica, an idle baseline), where the error rate stands alone."""

    def __init__(self, *, p99_frac: float = 1.5, error_rate_high: float = 0.02,
                 min_window_samples: int = 20, min_canary_requests: int = 20,
                 bad_consecutive: int = 2, good_consecutive: int = 3) -> None:
        if p99_frac <= 0:
            raise ValueError("p99_frac must be > 0")
        if not 0.0 <= error_rate_high <= 1.0:
            raise ValueError("error_rate_high must be within 0..1")
        if bad_consecutive < 1 or good_consecutive < 1:
            raise ValueError("hysteresis windows must be >= 1 tick")
        self.p99_frac = float(p99_frac)
        self.error_rate_high = float(error_rate_high)
        self.min_window_samples = int(min_window_samples)
        self.min_canary_requests = int(min_canary_requests)
        self.bad_consecutive = int(bad_consecutive)
        self.good_consecutive = int(good_consecutive)
        self._bad_streak = 0
        self._good_streak = 0
        self._base0: Dict[str, float] = {}
        self.decisions: List[Dict[str, Any]] = []

    def begin(self, baseline: GenerationStats, canary: GenerationStats) -> None:
        """The canary starts: both sides' lifetime counters are the zero of
        every later tick."""
        self._bad_streak = self._good_streak = 0
        self._base0 = {"canary_requests": canary.requests, "canary_errors": canary.errors,
                       "baseline_requests": baseline.requests,
                       "baseline_errors": baseline.errors}

    def observe(self, baseline: GenerationStats, canary: GenerationStats) -> Optional[str]:
        c_req = max(canary.requests - self._base0.get("canary_requests", 0.0), 0.0)
        c_err = max(canary.errors - self._base0.get("canary_errors", 0.0), 0.0)
        b_req = max(baseline.requests - self._base0.get("baseline_requests", 0.0), 0.0)
        b_err = max(baseline.errors - self._base0.get("baseline_errors", 0.0), 0.0)
        c_rate = c_err / c_req if c_req > 0 else 0.0
        b_rate = b_err / b_req if b_req > 0 else 0.0

        reasons: List[str] = []
        if c_req >= self.min_canary_requests and c_rate > self.error_rate_high \
                and c_rate > b_rate:
            reasons.append(f"error rate {c_rate:.3f} > {self.error_rate_high:.3f} "
                           f"(baseline {b_rate:.3f})")
        latency_comparable = (canary.p99_s is not None and baseline.p99_s is not None
                              and canary.window_samples >= self.min_window_samples
                              and baseline.window_samples >= self.min_window_samples)
        if latency_comparable and canary.p99_s > self.p99_frac * baseline.p99_s:
            reasons.append(f"window p99 {canary.p99_s:.4f}s > {self.p99_frac:.2f} x "
                           f"baseline {baseline.p99_s:.4f}s")

        bad = bool(reasons)
        self._bad_streak = self._bad_streak + 1 if bad else 0
        if bad:
            self._good_streak = 0
        else:
            # a clean tick counts toward promotion once the canary saw real
            # traffic and carries a latency verdict; a baseline with signal
            # against a canary window too thin to compare is silence, which
            # holds (the controller's verdict timeout then rolls back)
            baseline_has_signal = (baseline.p99_s is not None
                                   and baseline.window_samples >= self.min_window_samples)
            latency_ok = not baseline_has_signal or (
                latency_comparable and canary.p99_s <= self.p99_frac * baseline.p99_s)
            if c_req >= self.min_canary_requests and latency_ok:
                self._good_streak += 1
        if self._bad_streak >= self.bad_consecutive:
            return self._decide("rollback", baseline, canary, c_req, c_rate, b_rate,
                                "; ".join(reasons))
        if self._good_streak >= self.good_consecutive:
            return self._decide("promote", baseline, canary, c_req, c_rate, b_rate,
                                f"canary healthy over {self._good_streak} consecutive tick(s)")
        return None

    def _decide(self, verdict: str, baseline: GenerationStats, canary: GenerationStats,
                c_req: float, c_rate: float, b_rate: float, why: str) -> str:
        decision = {
            "verdict": verdict,
            "canary_generation": canary.generation,
            "baseline_generation": baseline.generation,
            "canary_requests": c_req,
            "canary_error_rate": round(c_rate, 4),
            "baseline_error_rate": round(b_rate, 4),
            "canary_p99_s": canary.p99_s,
            "baseline_p99_s": baseline.p99_s,
            "why": why,
        }
        self.decisions.append(decision)
        self._bad_streak = self._good_streak = 0
        log_event(f"canary-{verdict}",
                  f"generation {canary.generation} vs {baseline.generation}: {verdict} ({why})",
                  level=logging.WARNING if verdict == "rollback" else logging.INFO, **decision)
        return verdict
