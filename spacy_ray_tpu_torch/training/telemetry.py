"""Serving telemetry primitives: a metrics registry (counters, gauges,
histograms with a nearest-rank percentile ring, a sliding time window and
Prometheus bucket tables) and a bounded Chrome trace-event buffer.

The part of ``spacy_ray_tpu/training/telemetry.py`` that serving uses
(``LATENCY_BUCKETS``, ``OCCUPANCY_BUCKETS``, ``sanitize_json``,
``MetricsRegistry``, ``TraceBuffer``), copied unchanged so a snapshot and a
trace of the port read as the JAX package's. The training-loop telemetry,
device sampling and anomaly detection of that module are not ported yet.
Stdlib-only.
"""

from __future__ import annotations

import json
import math
import threading
import time
from bisect import bisect_left
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry",
    "TraceBuffer",
    "LATENCY_BUCKETS",
    "OCCUPANCY_BUCKETS",
    "sanitize_json",
]

# Shared Prometheus-style bucket tables (upper bounds, seconds unless
# noted). ONE table per quantity kind, used by every registry in the
# repo, so the cross-process exposition (replica, router, trainer) is
# mergeable by any scraper — summing `_bucket` series only means
# something when the boundaries agree.
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)
OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


# ----------------------------------------------------------------------
# Metrics registry
# ----------------------------------------------------------------------


def _nearest_rank(sorted_samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an ascending list (None when empty) —
    the ONE percentile convention, shared by the online histogram and the
    offline ``summarize_metrics`` so their p50/p95 can never diverge."""
    if not sorted_samples:
        return None
    idx = min(int(q * len(sorted_samples)), len(sorted_samples) - 1)
    return sorted_samples[idx]


def sanitize_json(obj: Any) -> Any:
    """Replace non-finite floats with their string names ("nan"/"inf") —
    ``json.dumps`` would otherwise emit bare ``NaN`` tokens, which are
    invalid JSON and break every non-Python consumer of the
    'machine-readable' jsonl files exactly when the NaN anomaly the files
    exist to capture occurs."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    return obj


class _Counter:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class _Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value: Optional[float] = None

    def set(self, v: Optional[float]) -> None:
        with self._lock:
            self.value = v


class _Histogram:
    """Running count/sum plus a bounded sample ring for percentiles.

    The ring doubles as the ROLLING window (rolling p50 for the
    step-time regression detector): percentiles describe the last
    ``max_samples`` observations, count/sum describe the whole run.

    ``window_s`` additionally keeps TIME-stamped samples so
    :meth:`window_snapshot` can answer "what do the last T seconds look
    like" — the count-based ring dilutes a fresh load spike among
    thousands of older samples exactly when a control loop (the fleet
    autoscaler) needs to see it. The timed buffer is hard-capped at
    8 × ``max_samples`` entries as a memory bound; at rates that
    overflow the cap within the window, the window percentiles describe
    the most recent cap-sized slice (still the freshest data).

    ``buckets`` (optional ascending upper bounds) arms Prometheus-style
    cumulative bucket counting over the WHOLE run (unlike the bounded
    percentile ring, bucket counts never forget) — the exact thing the
    text exposition's ``_bucket`` series needs, and the one histogram
    aggregate that merges exactly across replicas (counts are additive;
    percentiles are not).
    """

    __slots__ = (
        "_lock", "_samples", "count", "sum", "max", "min",
        "window_s", "_clock", "_timed", "buckets", "_bucket_counts",
    )

    def __init__(
        self,
        lock: threading.Lock,
        max_samples: int = 512,
        window_s: Optional[float] = None,
        clock: Callable[[], float] = time.perf_counter,
        buckets: Optional[Sequence[float]] = None,
    ):
        self._lock = lock
        self._samples: "deque[float]" = deque(maxlen=max_samples)
        self.count = 0
        self.sum = 0.0
        self.max: Optional[float] = None
        self.min: Optional[float] = None
        self.window_s = float(window_s) if window_s else None
        self._clock = clock
        self._timed: "deque[Tuple[float, float]]" = deque(
            maxlen=8 * max_samples
        )
        self.buckets: Optional[Tuple[float, ...]] = (
            tuple(sorted(float(b) for b in buckets)) if buckets else None
        )
        # one bin per bound plus the +Inf overflow bin; cumulated at
        # snapshot time so observe() stays a single increment
        self._bucket_counts: Optional[List[int]] = (
            [0] * (len(self.buckets) + 1) if self.buckets else None
        )

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self.count += 1
            self.sum += v
            self.max = v if self.max is None else max(self.max, v)
            self.min = v if self.min is None else min(self.min, v)
            if self._bucket_counts is not None:
                # first bound >= v (le is inclusive); beyond the last
                # bound lands in the +Inf bin
                self._bucket_counts[
                    bisect_left(self.buckets, v)
                ] += 1
            if self.window_s is not None:
                now = self._clock()
                self._timed.append((now, v))
                self._prune(now)

    def _prune(self, now: float) -> None:
        """Drop timed samples older than the window (caller holds lock)."""
        cutoff = now - (self.window_s or 0.0)
        while self._timed and self._timed[0][0] < cutoff:
            self._timed.popleft()

    def window_snapshot(self) -> Optional[Dict[str, Any]]:
        """p50/p95/p99 over the last ``window_s`` seconds only (None when
        the histogram has no time window configured). Pruning happens at
        read time too, so a quiet period empties the window instead of
        freezing its last busy picture."""
        if self.window_s is None:
            return None
        with self._lock:
            self._prune(self._clock())
            samples = sorted(v for _, v in self._timed)
        return {
            "window_s": self.window_s,
            "samples": len(samples),
            "p50": _nearest_rank(samples, 0.5),
            "p95": _nearest_rank(samples, 0.95),
            "p99": _nearest_rank(samples, 0.99),
        }

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1] over the rolling sample window (nearest-rank)."""
        with self._lock:
            samples = sorted(self._samples)
        return _nearest_rank(samples, q)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            samples = sorted(self._samples)
            count, total = self.count, self.sum
            mx, mn = self.max, self.min
            bins = (
                list(self._bucket_counts)
                if self._bucket_counts is not None else None
            )
        snap = {
            "count": count,
            "sum": round(total, 6),
            "min": mn,
            "max": mx,
            "p50": _nearest_rank(samples, 0.5),
            "p95": _nearest_rank(samples, 0.95),
            # tail percentile the serving SLO surface reads; same rolling
            # window and nearest-rank convention as p50/p95
            "p99": _nearest_rank(samples, 0.99),
        }
        if bins is not None:
            # cumulative [le, count] pairs, Prometheus convention; the
            # +Inf bin is implicit (== count) so JSON stays finite
            cum, pairs = 0, []
            for le, n in zip(self.buckets, bins):
                cum += n
                pairs.append([le, cum])
            snap["buckets"] = pairs
        return snap


class MetricsRegistry:
    """Named counters/gauges/histograms behind one lock.

    Get-or-create by name; hold instrument references on the hot path
    (the per-step cost is then one lock acquire per observation, and
    nothing at all when telemetry is disabled — the loop simply has no
    registry to call).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._lock = threading.Lock()
        self._clock = clock
        self._counters: Dict[str, _Counter] = {}
        self._gauges: Dict[str, _Gauge] = {}
        self._histograms: Dict[str, _Histogram] = {}

    def counter(self, name: str) -> _Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = _Counter(self._lock)
            return self._counters[name]

    def gauge(self, name: str) -> _Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = _Gauge(self._lock)
            return self._gauges[name]

    def histogram(
        self,
        name: str,
        max_samples: int = 512,
        window_s: Optional[float] = None,
        buckets: Optional[Sequence[float]] = None,
    ) -> _Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = _Histogram(
                    self._lock, max_samples, window_s=window_s,
                    clock=self._clock, buckets=buckets,
                )
            return self._histograms[name]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
            "histograms": {k: h.snapshot() for k, h in histograms.items()},
        }


# ----------------------------------------------------------------------
# Chrome trace-event span emitter
# ----------------------------------------------------------------------


class TraceBuffer:
    """Bounded, thread-safe Chrome trace-event buffer.

    Events use the complete-event form (``ph: "X"``) with microsecond
    timestamps relative to the buffer's construction; ``flush()`` writes
    a ``{"traceEvents": [...]}`` JSON object that chrome://tracing and
    ui.perfetto.dev load directly. Worker threads get their own ``tid``
    (with ``thread_name`` metadata rows) so pooled collation spans render
    as parallel tracks.

    ``set_recording(False)`` drops non-forced spans — the training loop
    gates the per-step/host-stage firehose to the ``trace_steps`` window
    while rare events (eval, checkpoints, anomalies) pass ``force=True``.
    ``flush()`` is re-entrant and atomic (tmp + replace): the watchdog
    flushes mid-run before a hard exit, finalize flushes again.
    """

    MAX_EVENTS = 200_000

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        pid: int = 0,
        max_events: int = MAX_EVENTS,
    ):
        self._clock = clock
        self._origin = clock()
        self._pid = int(pid)
        self._lock = threading.Lock()
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=max_events)
        self._tids: Dict[int, int] = {}
        self._tid_names: Dict[int, str] = {}
        self._recording = True
        self.dropped = 0

    def _tid(self) -> int:
        t = threading.current_thread()
        ident = t.ident or 0
        with self._lock:
            if ident not in self._tids:
                self._tids[ident] = len(self._tids)
                self._tid_names[self._tids[ident]] = t.name
            return self._tids[ident]

    def set_recording(self, on: bool) -> None:
        self._recording = bool(on)

    @property
    def recording(self) -> bool:
        return self._recording

    def now(self) -> float:
        """Clock read for callers that stamp their own t0."""
        return self._clock()

    def add_span(
        self,
        name: str,
        t0: float,
        dur: float,
        *,
        cat: str = "host",
        args: Optional[Dict[str, Any]] = None,
        force: bool = False,
    ) -> None:
        """One complete span: ``t0`` is a clock() stamp, ``dur`` seconds."""
        if not self._recording and not force:
            return
        ev = {
            "name": name,
            "ph": "X",
            "cat": cat,
            "ts": round((t0 - self._origin) * 1e6, 1),
            "dur": round(max(dur, 0.0) * 1e6, 1),
            "pid": self._pid,
            "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def add_instant(
        self,
        name: str,
        *,
        cat: str = "anomaly",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """A point-in-time marker (``ph: "i"``) — anomalies, signals."""
        ev = {
            "name": name,
            "ph": "i",
            "s": "g",  # global scope: draw the marker across all tracks
            "cat": cat,
            "ts": round((self._clock() - self._origin) * 1e6, 1),
            "pid": self._pid,
            "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    class _Span:
        __slots__ = ("_buf", "_name", "_cat", "_args", "_force", "_t0")

        def __init__(self, buf, name, cat, args, force):
            self._buf, self._name = buf, name
            self._cat, self._args, self._force = cat, args, force

        def __enter__(self):
            self._t0 = self._buf._clock()
            return self

        def __exit__(self, *exc: Any) -> None:
            self._buf.add_span(
                self._name,
                self._t0,
                self._buf._clock() - self._t0,
                cat=self._cat,
                args=self._args,
                force=self._force,
            )

    def span(
        self,
        name: str,
        *,
        cat: str = "host",
        force: bool = True,
        **args: Any,
    ) -> "TraceBuffer._Span":
        """Context manager emitting one span (forced by default — used for
        rare events like checkpoints that must outlive the step window)."""
        return TraceBuffer._Span(self, name, cat, args or None, force)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def anchor(self) -> Dict[str, float]:
        """The clock anchor a cross-process trace collector needs to put
        this buffer's events on a shared timeline: event timestamps are
        microseconds relative to ``origin`` on the buffer's own monotonic
        clock, and ``(clock_now, unix_now)`` is one simultaneous reading
        of that clock against the wall — enough to map any event to wall
        time without the processes sharing a clock. Exposed on each
        process's ``/healthz`` and ``/trace``."""
        return {
            "origin": self._origin,
            "clock_now": self._clock(),
            "unix_now": time.time(),
        }

    def payload(self) -> Dict[str, Any]:
        """The Chrome trace JSON object (thread_name metadata + events)
        — what ``flush`` writes and what the ``/trace`` endpoints serve."""
        with self._lock:
            events = list(self._events)
            names = dict(self._tid_names)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": self._pid,
                "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(names.items())
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
        }

    def flush(self, path: Path) -> int:
        """Write the buffer as Chrome trace JSON; returns events written."""
        payload = self.payload()
        # meta rows don't count toward the caller-visible event total
        n_events = sum(
            1 for e in payload["traceEvents"] if e.get("ph") != "M"
        )
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(payload), encoding="utf8")
        tmp.replace(path)
        return n_events
