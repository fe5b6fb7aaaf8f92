"""Tenant admission: token-bucket quotas in front of the class-aware
batcher (``spacy_ray_tpu/serving/multimodel/admission.py``).

The quota (here) says whether a tenant is over its declared rate, in docs
per second, and sheds the request with ``QuotaExceeded`` (429) before it
reaches the queue; the fairness (the batcher's ``class_weights``) says who
of the admitted dispatches next. Buckets are per process. The controller
makes no telemetry call: the HTTP layer counts its rejects. The clock is
injectable.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Callable, Dict, Optional

from ..batcher import QuotaExceeded

if TYPE_CHECKING:  # pragma: no cover
    from .registry import ModelRegistry


class TokenBucket:
    """``rate`` tokens a second refill up to ``burst`` (default: one second
    of rate); ``try_acquire(n)`` spends ``n`` or nothing. Refilled lazily
    from the clock."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not (rate > 0):
            raise ValueError(f"rate must be > 0, got {rate!r}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else float(rate)
        if not (self.burst > 0):
            raise ValueError(f"burst must be > 0, got {burst!r}")
        self.clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def _refill(self, now: float) -> None:
        elapsed = now - self._last
        if elapsed > 0:
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self.clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def available(self) -> float:
        with self._lock:
            self._refill(self.clock())
            return self._tokens


class AdmissionController:
    """Per-tenant quotas and the tenant -> class mapping of one registry.
    Buckets exist only for tenants that declare a quota."""

    def __init__(self, registry: "ModelRegistry",
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.registry = registry
        self._buckets: Dict[str, TokenBucket] = {}
        for name, spec in registry.tenants.items():
            if spec.quota_docs_per_s is not None:
                self._buckets[name] = TokenBucket(spec.quota_docs_per_s,
                                                  burst=spec.quota_burst, clock=clock)
        self.rejected_quota = 0
        self._lock = threading.Lock()

    def admit(self, tenant: Optional[str], n_docs: int = 1) -> str:
        """Charge ``n_docs`` to ``tenant``'s bucket and return the SLO class
        its request rides in. Raises ``QuotaExceeded`` when the bucket cannot
        cover it; a tenant without a quota (the anonymous one too) always
        gets in."""
        spec = self.registry.tenant(tenant)
        bucket = self._buckets.get(spec.name) if tenant is not None else None
        if bucket is not None and not bucket.try_acquire(float(n_docs)):
            with self._lock:
                self.rejected_quota += 1
            raise QuotaExceeded(
                f"tenant {spec.name!r} is over quota "
                f"({spec.quota_docs_per_s:g} docs/s, burst "
                f"{bucket.burst:g}); retry after the bucket refills"
            )
        return spec.klass

    def stats(self) -> Dict[str, float]:
        """Remaining tokens per metered tenant and the shed count."""
        out: Dict[str, float] = {"rejected_quota": float(self.rejected_quota)}
        for name, bucket in self._buckets.items():
            out[f"tokens_{name}"] = bucket.available()
        return out
