"""Telemetry: the metrics registry and trace buffer that serving and
training share, the trainer's facade, and the offline summary
(``spacy_ray_tpu/training/telemetry.py``).

* the primitives (``LATENCY_BUCKETS``, ``STEP_SECONDS_BUCKETS``,
  ``OCCUPANCY_BUCKETS``, ``sanitize_json``, ``MetricsRegistry``,
  ``TraceBuffer``; ``merge_serving_snapshots``, with which the serving
  fleet's router merges its replicas' snapshots), copied unchanged so a
  snapshot, a trace and a fleet view of the port read as the JAX package's;
* the trainer's half: :class:`Telemetry` (``metrics.jsonl`` rows, the
  ``trace.json`` with its ``trace_steps`` window, one clock stamp a step),
  :class:`AnomalyDetectors` (NaN loss, loss spike, step-time regression,
  builds after warmup), :func:`sample_device_telemetry` (the caching
  allocator's counters), :func:`program_flops` (a FLOP counter over one
  microbatch's forward and backward plus the hand kernels' analytic
  count) and :func:`device_peak_flops` (a datasheet table), behind ``mfu``;
  The facade also holds the trainer's alert engine (``alerts.jsonl``,
  rate-limited at step boundaries and by a slow ticker thread) and, with an
  ``incident_dir``, the flight recorder that dumps a bundle when a
  detector or an alert trips (:mod:`~..alerting`, :mod:`~..incidents`);
* the trainer fleet's parts: the dynamics histograms' shared bucket tables
  (``STALENESS_BUCKETS``, ``FLEET_DYNAMICS_HISTOGRAMS``), the wire
  counters' names (``FLEET_WIRE_COUNTERS``), :class:`FleetDivergenceDetector`
  (the lead's cross-worker watch);
* :func:`summarize_metrics`: the text of ``telemetry summarize`` over a
  trainer's, a server's or a fleet worker's ``metrics.jsonl`` or a run
  directory (discovered by :func:`~.report.load_run`).

Stdlib-only at import; torch is imported by the functions that need it.
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
    "STEP_SECONDS_BUCKETS",
    "OCCUPANCY_BUCKETS",
    "STALENESS_BUCKETS",
    "FLEET_DYNAMICS_HISTOGRAMS",
    "FLEET_WIRE_COUNTERS",
    "FleetDivergenceDetector",
    "sanitize_json",
    "merge_serving_snapshots",
    "Telemetry",
    "AnomalyDetectors",
    "sample_device_telemetry",
    "program_flops",
    "device_peak_flops",
    "compile_count",
    "summarize_metrics",
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
STEP_SECONDS_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0,
)
OCCUPANCY_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
# the version lag of each ACCEPTED gradient push (shard versions, not
# seconds): the fleet's bounded-staleness evidence. A lag past max_staleness
# is discarded before it is observed, so the +Inf bin stays empty
STALENESS_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0)

# the trainer fleet's dynamics families and the bucket table of each: one
# definition for the owner side (fleet/peer.py), the worker side
# (fleet/worker.py), the run report and the tests. Keys are registry names
# (rendered as srt_training_* with a worker label)
FLEET_DYNAMICS_HISTOGRAMS = {
    "staleness": STALENESS_BUCKETS,
    "quorum_wait_seconds": LATENCY_BUCKETS,
    "apply_seconds": LATENCY_BUCKETS,
    "phase_data_seconds": STEP_SECONDS_BUCKETS,
    "phase_pull_seconds": STEP_SECONDS_BUCKETS,
    "phase_grad_seconds": STEP_SECONDS_BUCKETS,
    "phase_push_seconds": STEP_SECONDS_BUCKETS,
    "phase_apply_wait_seconds": STEP_SECONDS_BUCKETS,
}

# the fleet's wire-byte counters (fleet/peer.py COUNTER_NAMES mirrors them
# into each worker's registry): the _uncompressed twins count what the same
# payloads would cost as f32 full frames, so any two scrapes give the
# compression ratio
FLEET_WIRE_COUNTERS = (
    "wire_push_bytes",
    "wire_push_bytes_uncompressed",
    "wire_pull_bytes",
    "wire_pull_bytes_uncompressed",
)


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


def _merge_weighted(
    out: Dict[str, Any], key: str, pairs: List[Tuple[float, float]]
) -> None:
    """The one fleet-percentile merge rule (``merge_serving_snapshots``
    uses it for histogram percentiles, the ``slo`` block, and the
    ``slo_window`` block): a fleet p99 is not derivable from per-replica
    p99s, so report the weight-weighted mean under ``key`` AND the worst
    replica under ``key_worst`` — the honest bound an SLO check should
    use. Zero total weight (all-idle replicas) falls back to the
    unweighted mean; no values at all writes None for both."""
    if not pairs:
        out[key] = out[f"{key}_worst"] = None
        return
    total_w = sum(w for _, w in pairs)
    out[key] = (
        sum(v * w for v, w in pairs) / total_w
        if total_w > 0
        else sum(v for v, _ in pairs) / len(pairs)
    )
    out[f"{key}_worst"] = max(v for v, _ in pairs)


def merge_serving_snapshots(
    snaps: List[Dict[str, Any]], *, _tag_generations: bool = True
) -> Dict[str, Any]:
    """Merge per-replica ``ServingTelemetry.snapshot()`` payloads into
    one fleet view (the router's ``/metrics``) — one scrape instead of N.

    Merge rules, stated honestly:

    * **counters** — summed: counts of events are exactly additive.
    * **gauges** — reported as ``{sum, max, mean}`` per key: which
      aggregate is meaningful depends on the gauge (total queue depth is
      the ``sum``; a worst-replica occupancy is the ``max``) — the fleet
      view carries all three rather than guessing.
    * **histograms** — ``count``/``sum``/``min``/``max`` merge exactly.
      Percentiles do NOT: a fleet p99 cannot be derived from per-replica
      p99s (the underlying samples are gone). The merged view reports
      the count-weighted mean (``p50``/``p95``/``p99`` — a reasonable
      center) and the worst replica (``p99_worst`` etc.) — the honest
      bound an SLO check should use.
    * the ``slo`` block follows the histogram rule (weighted by the
      replica's latency sample count, worst alongside).
    * the ``slo_window`` block (sliding-window percentiles — recent
      load, not run lifetime) merges the same way, weighted by each
      replica's IN-WINDOW sample count, so the fleet view reacts to a
      spike as fast as the freshest replica does.
    * **generations** — when any snapshot carries a ``generation`` stamp
      (live serving: the checkpoint generation that replica's dispatch
      thread is running), the merged view adds ``by_generation``: the
      SAME merge re-run per generation group, so the slo_window
      percentiles (and error/request counters) are splittable by
      generation — the canary guard's entire signal. Replicas serving
      the model as loaded from disk (generation null) group under
      ``"none"``.
    * **models** — when any snapshot carries a ``models`` block
      (multi-model serving: model name → that engine's own snapshot,
      stamped per model by the replica), the merged view adds
      ``by_model``: the SAME merge re-run over each model's per-engine
      snapshots gathered across replicas — the per-model window p99 the
      placement policy and the per-class SLO story read.
    """
    merged: Dict[str, Any] = {
        "replicas": len(snaps),
        "counters": {},
        "gauges": {},
        "histograms": {},
        "slo": {},
    }
    if not snaps:
        return merged
    counters: Dict[str, float] = {}
    for snap in snaps:
        for k, v in (snap.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
    merged["counters"] = counters
    gauges: Dict[str, List[float]] = {}
    for snap in snaps:
        for k, v in (snap.get("gauges") or {}).items():
            if isinstance(v, (int, float)):
                gauges.setdefault(k, []).append(float(v))
    merged["gauges"] = {
        k: {
            "sum": sum(vs),
            "max": max(vs),
            "mean": sum(vs) / len(vs),
        }
        for k, vs in gauges.items()
    }

    def _weight(snap: Dict[str, Any], hist_key: str) -> float:
        h = (snap.get("histograms") or {}).get(hist_key) or {}
        c = h.get("count")
        return float(c) if isinstance(c, (int, float)) and c > 0 else 0.0

    hist_keys = {
        k for snap in snaps for k in (snap.get("histograms") or {})
    }
    for key in sorted(hist_keys):
        entries = [
            (snap.get("histograms") or {}).get(key) or {} for snap in snaps
        ]
        counts = [
            e.get("count") for e in entries
            if isinstance(e.get("count"), (int, float))
        ]
        sums = [
            e.get("sum") for e in entries
            if isinstance(e.get("sum"), (int, float))
        ]
        mins = [
            e.get("min") for e in entries
            if isinstance(e.get("min"), (int, float))
        ]
        maxs = [
            e.get("max") for e in entries
            if isinstance(e.get("max"), (int, float))
        ]
        out: Dict[str, Any] = {
            "count": sum(counts) if counts else 0,
            "sum": sum(sums) if sums else 0.0,
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
        }
        for q in ("p50", "p95", "p99"):
            _merge_weighted(out, q, [
                (float(e[q]), float(e.get("count") or 0))
                for e in entries
                if isinstance(e.get(q), (int, float))
            ])
        # cumulative buckets merge EXACTLY (counts are additive) — the
        # one fleet histogram aggregate with no approximation caveat —
        # but only when every replica counted against the same bounds;
        # mismatched tables are dropped rather than summed dishonestly
        bucketed = [e.get("buckets") for e in entries if e.get("buckets")]
        if bucketed and len(bucketed) == len(
            [e for e in entries if e.get("count") is not None]
        ):
            bounds = [tuple(float(b[0]) for b in bs) for bs in bucketed]
            if all(b == bounds[0] for b in bounds):
                out["buckets"] = [
                    [le, sum(float(bs[i][1]) for bs in bucketed)]
                    for i, le in enumerate(bounds[0])
                ]
        merged["histograms"][key] = out

    slo_keys = {k for snap in snaps for k in (snap.get("slo") or {})}
    for key in sorted(slo_keys):
        hist_key = (
            "batch_occupancy" if "occupancy" in key
            else "request_latency_seconds"
        )
        _merge_weighted(merged["slo"], key, [
            (float((snap.get("slo") or {})[key]), _weight(snap, hist_key))
            for snap in snaps
            if isinstance((snap.get("slo") or {}).get(key), (int, float))
        ])

    window_snaps = [
        snap.get("slo_window") for snap in snaps
        if isinstance(snap.get("slo_window"), dict)
    ]
    if window_snaps:
        win: Dict[str, Any] = {
            "window_s": max(
                float(w.get("window_s") or 0.0) for w in window_snaps
            ),
            "samples": sum(int(w.get("samples") or 0) for w in window_snaps),
        }
        win_keys = {
            k for w in window_snaps for k in w
            if k not in ("window_s", "samples")
        }
        for key in sorted(win_keys):
            _merge_weighted(win, key, [
                (float(w[key]), float(w.get("samples") or 0))
                for w in window_snaps
                if isinstance(w.get(key), (int, float))
            ])
        merged["slo_window"] = win

    if _tag_generations:
        gens = {snap.get("generation") for snap in snaps}
        if any(g is not None for g in gens):
            by_gen: Dict[str, Any] = {}
            for g in sorted(gens, key=lambda x: (x is None, x)):
                subset = [s for s in snaps if s.get("generation") == g]
                sub = merge_serving_snapshots(
                    subset, _tag_generations=False
                )
                sub["generation"] = g
                by_gen["none" if g is None else str(g)] = sub
            merged["by_generation"] = by_gen
        model_groups: Dict[str, List[Dict[str, Any]]] = {}
        for snap in snaps:
            models = snap.get("models")
            if not isinstance(models, dict):
                continue
            for name, msnap in models.items():
                if isinstance(msnap, dict):
                    model_groups.setdefault(str(name), []).append(msnap)
        if model_groups:
            by_model: Dict[str, Any] = {}
            for name in sorted(model_groups):
                sub = merge_serving_snapshots(
                    model_groups[name], _tag_generations=False
                )
                sub["model"] = name
                by_model[name] = sub
            merged["by_model"] = by_model
    return merged


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


# ----------------------------------------------------------------------
# Device sampling and the FLOP count
# ----------------------------------------------------------------------

#: dense bf16 peak FLOP/s per card from the vendors' datasheets, matched as
#: substrings of ``torch.cuda.get_device_name`` (first match wins: the PCIe
#: and NVL parts before the SXM "H100")
GPU_PEAK_BF16 = [
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),  # SXM5
    ("H200", 989e12),  # GH200 too
]


def compile_count() -> int:
    """Kernel-library loads and CUDA-graph captures of this process so far:
    what the port builds at run time, where the JAX package counts XLA
    compiles (ROADMAP C74)."""
    from ..ops import _cuda

    return _cuda.compile_count()


def _cuda_device(device: Any) -> Any:
    """``device`` as a CUDA ``torch.device``, or None when it is not one."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def sample_device_telemetry(device: Any = None) -> Dict[str, Any]:
    """One gauge sample of the training device: the caching allocator's
    bytes in use (``allocated_bytes.all.current``) and their peak
    (``allocated_bytes.all.peak``), the card's memory (``mem_get_info``'s
    total), its live blocks (``active.all.current``) and
    :func:`compile_count`. Off a card the memory keys are None, an honest
    absence, as the JAX package's on a backend without memory stats."""
    out: Dict[str, Any] = {
        "platform": None,
        "hbm_bytes_in_use": None,
        "hbm_peak_bytes": None,
        "hbm_bytes_limit": None,
        "live_buffers": None,
        "compile_count": compile_count(),
    }
    dev = _cuda_device(device)
    if dev is None:
        out["platform"] = "cpu" if device is not None else None
        return out
    out["platform"] = "gpu"
    try:
        import torch

        stats = torch.cuda.memory_stats(dev)
        out["hbm_bytes_in_use"] = stats.get("allocated_bytes.all.current")
        out["hbm_peak_bytes"] = stats.get("allocated_bytes.all.peak")
        out["live_buffers"] = stats.get("active.all.current")
        out["hbm_bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
    except Exception:
        pass
    return out


def program_flops(loss_fn: Callable[[], Any], params: Dict[str, Any], *,
                  n_micro: int = 1) -> Optional[float]:
    """FLOPs of one optimizer step: ``torch.utils.flop_counter.FlopCounterMode``
    over one microbatch's forward and backward (``loss_fn()`` then
    ``backward``), plus the hand kernels' analytic FLOPs, which no counter
    sees behind their ctypes calls (:func:`~..ops._cuda.kernel_flop_tally`),
    times ``n_micro``, the microbatches of a step. The probe leaves what it
    ran on as it found it: each of ``params``' gradients is put back, and
    the torch, CUDA, numpy and Python generators are restored, also when
    the probe raises (the caller reports why)."""
    import random

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import _cuda

    grads = {k: p.grad for k, p in params.items()}
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    states = (torch.get_rng_state(), torch.cuda.get_rng_state_all() if cuda else None,
              np.random.get_state(), random.getstate())
    try:
        for p in params.values():
            p.grad = None
        with _cuda.kernel_flop_tally() as tally:
            counter = FlopCounterMode(display=False)
            with counter:
                loss_fn().backward()
        flops = (float(counter.get_total_flops()) + tally[0]) * max(int(n_micro), 1)
        return flops if flops > 0 else None
    finally:
        for k, p in params.items():
            p.grad = grads[k]
        torch.set_rng_state(states[0])
        if states[1] is not None:
            torch.cuda.set_rng_state_all(states[1])
        np.random.set_state(states[2])
        random.setstate(states[3])


def warm_flop_counter() -> None:
    """Pay the FLOP counter's first use now: its first dispatched operation
    imports torch's compiler stack (~2 s on a host CPU), which would
    otherwise land inside the first evaluation, in the watchdog's window."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False):
        torch.zeros(1) + 1


def device_peak_flops(device: Any = None) -> Tuple[Optional[float], str]:
    """(datasheet dense bf16 peak FLOP/s of the card, its provenance); None
    off a card or for a card the table does not name. Never measured mid-run:
    a microbenchmark would take the very step time being measured."""
    import torch

    dev = _cuda_device(device)
    if dev is None:
        kind = "an unknown device" if device is None else torch.device(device).type
        return None, f"no datasheet peak for {kind}"
    try:
        name = torch.cuda.get_device_name(dev)
    except Exception as e:
        return None, f"device query failed: {type(e).__name__}"
    for sub, peak in GPU_PEAK_BF16:
        if sub in name:
            return peak, f"datasheet bf16 ({name})"
    return None, f"unknown GPU kind {name!r}"


# ----------------------------------------------------------------------
# Anomaly detection
# ----------------------------------------------------------------------


def _is_bad(v: float) -> bool:
    return math.isnan(v) or math.isinf(v)


class AnomalyDetectors:
    """Rolling-statistic checks over host scalars the loop already has (the
    losses drained at evaluations, the step's clock stamp): never a device
    sync. Each firing calls ``emit(event, message, **fields)`` once, which
    :class:`Telemetry` routes to ``log_event``, a ``metrics.jsonl`` anomaly
    row and a trace instant. Thresholds and clock are the JAX package's and
    injectable."""

    def __init__(self, emit: Callable[..., Any], *,
                 clock: Callable[[], float] = time.perf_counter, spike_factor: float = 4.0,
                 spike_min_history: int = 3, loss_window: int = 32, step_factor: float = 2.5,
                 step_warmup: int = 20, step_window: int = 128,
                 recompile_warmup_steps: int = 50):
        self.emit = emit
        self.clock = clock
        self.spike_factor = float(spike_factor)
        self.spike_min_history = int(spike_min_history)
        self.step_factor = float(step_factor)
        self.step_warmup = int(step_warmup)
        self.recompile_warmup_steps = int(recompile_warmup_steps)
        self._loss_history: "deque[float]" = deque(maxlen=int(loss_window))
        self._step_times: "deque[float]" = deque(maxlen=int(step_window))
        self._steps_observed = 0
        self._last_compile_count: Optional[int] = None
        self.fired: Dict[str, int] = {}

    def _fire(self, event: str, message: str, **fields: Any) -> None:
        self.fired[event] = self.fired.get(event, 0) + 1
        fields.setdefault("t", round(self.clock(), 6))
        self.emit(event, message, **fields)

    def check_loss(self, step: int, loss: float) -> None:
        """NaN or Inf, then a spike against the rolling median of the finite
        history (a NaN never enters the history)."""
        loss = float(loss)
        if _is_bad(loss):
            self._fire("nan-loss", f"non-finite loss {loss!r} at step {step}",
                       step=step, loss=str(loss))
            return
        history = sorted(self._loss_history)
        if len(history) >= self.spike_min_history:
            median = history[len(history) // 2]
            if median > 0 and loss > self.spike_factor * median:
                self._fire("loss-spike",
                           f"loss {loss:.4g} at step {step} is {loss / median:.1f}x the "
                           f"rolling median {median:.4g}",
                           step=step, loss=loss, median=median)
        self._loss_history.append(loss)

    def check_step_time(self, step: int, seconds: float) -> None:
        """A step slower than ``step_factor`` x the rolling p50, after
        ``step_warmup`` steps (builds and first allocations come first)."""
        seconds = float(seconds)
        self._steps_observed += 1
        if self._steps_observed > self.step_warmup and self._step_times:
            samples = sorted(self._step_times)
            p50 = samples[len(samples) // 2]
            if p50 > 0 and seconds > self.step_factor * p50:
                self._fire("step-time-regression",
                           f"step {step} took {seconds * 1e3:.1f}ms — {seconds / p50:.1f}x "
                           f"the rolling p50 {p50 * 1e3:.1f}ms",
                           step=step, seconds=seconds, p50=p50)
        self._step_times.append(seconds)

    def check_compiles(self, steps_run: int, count: int) -> None:
        """Fire when :func:`compile_count` grows after the warmup steps."""
        prev = self._last_compile_count
        self._last_compile_count = int(count)
        if prev is None:
            return
        if count > prev and steps_run > self.recompile_warmup_steps:
            self._fire("recompile-after-warmup",
                       f"{count - prev} new kernel build(s) or graph capture(s) after "
                       f"step {steps_run} (cumulative {count}) — check shape bucketing",
                       steps_run=steps_run, new_compiles=count - prev, compile_count=count)


class FleetDivergenceDetector:
    """Cross-worker convergence watch for the trainer fleet — the
    fleet-LEVEL twin of :class:`AnomalyDetectors` (which only sees one
    process's series). The lead worker polls every peer's ``/metrics``
    and feeds one ``observe(stats)`` call per poll; the detector flags a
    worker whose behavior diverges from the REST of the fleet:

    * ``nan`` — the worker's ``loss_nonfinite`` counter moved: it is
      training on NaN/Inf losses right now. Fires immediately (a NaN is
      unambiguous; no fleet comparison needed).
    * ``loss-outlier`` — the worker's recent-median loss exceeds
      ``spike_factor`` × the median of its PEERS' recent medians for
      ``confirm_polls`` consecutive polls. Comparing against peers (not
      history) is what keeps a uniformly-slow/uniformly-hot fleet quiet:
      when every worker's loss rises together the peer median rises with
      it and no one is an outlier. When the polled stats carry ``steps``
      the comparison is PACE-GATED: a worker is only judged once it has
      run ``min_steps`` (its loss ring must mean something), and only
      against peers within 2× of its step count — early training's
      steep loss decay makes rings at different step counts
      incomparable, and a worker merely running BEHIND is the slow-peer
      signal's business (push-stall, phase histograms), not a
      divergence.
    * ``discard-outlier`` — the share of gradients ARRIVING at this
      worker (it is the owner; discards are owner-side) that were
      discarded as stale since the last poll exceeds ``discard_rate``
      while the peer median share stays below half of it: ONE worker's
      shard version is outrunning its peers' pulls (a speed/placement
      outlier), not a fleet-wide knob problem (that is the
      fleet-discard-burn alert's job).

    No-signal discipline: a worker is only judged once it has been seen
    in ``min_polls`` polls (a just-joined/just-restarted worker's first
    samples are warmup, not divergence), loss modes need a finite loss
    median on BOTH sides, and each (worker, mode) pair re-arms only
    after ``rearm_s`` so a persistently-diverged worker emits a beat,
    not a storm. Pure host arithmetic with an injected clock — the test
    matrix drives it deterministically.
    """

    def __init__(
        self,
        emit: Callable[..., Any],
        *,
        spike_factor: float = 3.0,
        discard_rate: float = 0.5,
        min_polls: int = 3,
        confirm_polls: int = 2,
        min_received_delta: int = 4,
        min_steps: int = 8,
        pace_factor: float = 2.0,
        rearm_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.emit = emit
        self.spike_factor = float(spike_factor)
        self.discard_rate = float(discard_rate)
        self.min_polls = int(min_polls)
        self.confirm_polls = int(confirm_polls)
        self.min_received_delta = int(min_received_delta)
        self.min_steps = int(min_steps)
        self.pace_factor = float(pace_factor)
        self.rearm_s = float(rearm_s)
        self.clock = clock
        self._polls: Dict[int, int] = {}
        self._prev: Dict[int, Dict[str, float]] = {}
        self._loss_strikes: Dict[int, int] = {}
        self._disc_strikes: Dict[int, int] = {}
        self._last_fire: Dict[Tuple[int, str], float] = {}
        self.fired: Dict[str, int] = {}

    def _fire(
        self, worker: int, mode: str, message: str, **fields: Any
    ) -> bool:
        now = self.clock()
        last = self._last_fire.get((worker, mode))
        if last is not None and now - last < self.rearm_s:
            return False
        self._last_fire[(worker, mode)] = now
        self.fired[mode] = self.fired.get(mode, 0) + 1
        self.emit(
            "fleet-divergence",
            message,
            worker=int(worker),
            mode=mode,
            **fields,
        )
        return True

    @staticmethod
    def _median(values: List[float]) -> Optional[float]:
        if not values:
            return None
        s = sorted(values)
        return s[len(s) // 2]

    def observe(self, stats: Dict[int, Dict[str, Any]]) -> List[str]:
        """One fleet poll: ``stats[worker]`` carries whatever that
        worker's ``/metrics`` exposed — ``loss`` (recent median, may be
        None), ``received``/``discarded``/``loss_nonfinite`` counter
        values. Returns the modes fired this poll."""
        fired: List[str] = []
        deltas: Dict[int, Dict[str, float]] = {}
        for w, row in stats.items():
            self._polls[w] = self._polls.get(w, 0) + 1
            prev = self._prev.get(w) or {}
            cur = {
                k: float(row.get(k) or 0.0)
                for k in ("received", "discarded", "loss_nonfinite")
            }
            deltas[w] = {
                k: max(cur[k] - float(prev.get(k) or 0.0), 0.0) for k in cur
            }
            self._prev[w] = cur
            # first poll: the counter's CURRENT value is the delta — a
            # worker whose NaNs all landed before the watch's first
            # scrape of it (fast fault inside the first poll interval)
            # must not have them baselined away forever
            nan_delta = (
                deltas[w]["loss_nonfinite"] if prev
                else cur["loss_nonfinite"]
            )
            if nan_delta > 0:
                if self._fire(
                    w,
                    "nan",
                    f"fleet worker {w} is training on non-finite losses "
                    f"({int(nan_delta)} NaN/Inf step(s) since the last "
                    "poll)",
                    nonfinite=int(nan_delta),
                ):
                    fired.append("nan")

        def judgeable(w: int) -> bool:
            return self._polls.get(w, 0) >= self.min_polls

        finite_loss = {
            w: float(row["loss"])
            for w, row in stats.items()
            if isinstance(row.get("loss"), (int, float))
            and math.isfinite(float(row["loss"]))
        }
        steps_of = {
            w: float(row["steps"])
            for w, row in stats.items()
            if isinstance(row.get("steps"), (int, float))
        }

        def pace_ok(w: int, pw: int) -> bool:
            """Loss rings are only comparable between workers at a
            similar point in training (absent step counts, compare
            unconditionally — the unit-test/bare-ledger shape)."""
            sw, sp = steps_of.get(w), steps_of.get(pw)
            if sw is None or sp is None:
                return True
            hi, lo = max(sw, sp), min(sw, sp)
            return lo > 0 and hi / lo <= self.pace_factor

        for w in sorted(stats):
            loss = finite_loss.get(w)
            if loss is not None and steps_of.get(w) is not None and (
                steps_of[w] < self.min_steps
            ):
                loss = None  # ring too young to mean anything
            peers = [v for pw, v in finite_loss.items()
                     if pw != w and judgeable(pw) and pace_ok(w, pw)]
            peer_median = self._median(peers)
            outlier = (
                judgeable(w)
                and loss is not None
                and peer_median is not None
                and peer_median > 0
                and loss > self.spike_factor * peer_median
            )
            self._loss_strikes[w] = (
                self._loss_strikes.get(w, 0) + 1 if outlier else 0
            )
            if self._loss_strikes[w] >= self.confirm_polls:
                if self._fire(
                    w,
                    "loss-outlier",
                    f"fleet worker {w} loss {loss:.4g} is "
                    f"{loss / peer_median:.1f}x the peer median "
                    f"{peer_median:.4g} ({self._loss_strikes[w]} "
                    "consecutive polls)",
                    loss=loss,
                    peer_median=peer_median,
                ):
                    fired.append("loss-outlier")

        disc_share: Dict[int, float] = {}
        for w, d in deltas.items():
            if d["received"] >= self.min_received_delta:
                disc_share[w] = d["discarded"] / d["received"]
        for w in sorted(stats):
            share = disc_share.get(w)
            peers = [v for pw, v in disc_share.items()
                     if pw != w and judgeable(pw)]
            peer_median = self._median(peers)
            outlier = (
                judgeable(w)
                and share is not None
                and peer_median is not None
                and share >= self.discard_rate
                and peer_median < self.discard_rate / 2
            )
            self._disc_strikes[w] = (
                self._disc_strikes.get(w, 0) + 1 if outlier else 0
            )
            if self._disc_strikes[w] >= self.confirm_polls:
                if self._fire(
                    w,
                    "discard-outlier",
                    f"fleet worker {w}: {share * 100:.0f}% of the "
                    "gradients arriving at it were discarded as stale "
                    f"since the last poll (peer median "
                    f"{peer_median * 100:.0f}%) — its shard version is "
                    "outrunning its peers",
                    discard_share=share,
                    peer_median=peer_median,
                ):
                    fired.append("discard-outlier")
        return fired


# ----------------------------------------------------------------------
# The trainer's facade
# ----------------------------------------------------------------------


class Telemetry:
    """What the training loop holds, behind one nullable handle: the loop
    guards every call with ``if tel is not None``, so with telemetry off
    nothing is constructed and nothing is called. One host clock stamp per
    step (:meth:`step_boundary`); device sampling, percentiles, the
    detectors and the file writes happen at evaluations.

    ``metrics_dir`` gets ``metrics.jsonl`` (``step``, ``eval`` and
    ``anomaly`` rows) and ``trace.json`` (Chrome trace; ``step`` spans only
    for the steps in ``trace_steps``, rarer spans always). ``device`` is
    the training device, for the memory gauges and the datasheet peak
    behind ``mfu``; ``process_index`` is the trace's pid (a fleet worker's
    id).

    With ``alerting`` the facade holds an :class:`~..alerting.AlertEngine`
    over ``alert_rules`` (``default_training_rules()`` when None), sinking
    its transitions into ``alerts.jsonl``; it is evaluated at most once per
    ``alert_interval_s``, at step boundaries and, so that a wedged loop
    still pages, by a daemon ticker thread on wall time that
    :meth:`loop_start` starts; an evaluation boundary forces a pass. With ``incident_dir`` a
    :class:`~..incidents.FlightRecorder` named ``process_name`` keeps the
    same snapshots and dumps a bundle when a detector trips or an alert
    fires (once per storm)."""

    def __init__(self, metrics_dir: Path, *, trace_steps: Tuple[int, int] = (0, 50),
                 anomaly_detection: bool = True, clock: Callable[[], float] = time.perf_counter,
                 device: Any = None, process_index: int = 0,
                 alerting: bool = True,
                 alert_rules: Optional[List[Any]] = None, alert_interval_s: float = 5.0,
                 incident_dir: Optional[Path] = None, process_name: str = "trainer"):
        self.metrics_dir = Path(metrics_dir)
        self.metrics_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.metrics_dir / "metrics.jsonl"
        self.trace_path = self.metrics_dir / "trace.json"
        self.clock = clock
        self.device = device
        self.trace_steps = (int(trace_steps[0]), int(trace_steps[1]))
        self.registry = MetricsRegistry(clock=clock)
        self.trace = TraceBuffer(clock=clock, pid=int(process_index))
        # the host sampler lives inside the facade: telemetry off reads no /proc
        from .hoststats import ProcessSampler

        self.hoststats = ProcessSampler(clock=clock)
        self.detectors: Optional[AnomalyDetectors] = None
        if anomaly_detection:
            self.detectors = AnomalyDetectors(self._emit_anomaly, clock=clock)
        # the diagnosis layer lives inside the facade too: telemetry off
        # builds neither the engine nor the recorder
        self.recorder = None
        if incident_dir:
            from ..incidents import FlightRecorder

            # a fleet-wide incidents dir gets bundles whose flight files and
            # timeline tracks name the worker that wrote them
            self.recorder = FlightRecorder(incident_dir=Path(incident_dir),
                                           process_name=str(process_name), clock=clock)
        self.alerts = None
        self.alert_interval_s = float(alert_interval_s)
        self._last_alert_eval: Optional[float] = None
        if alerting:
            from ..alerting import AlertEngine, default_training_rules

            self.alerts = AlertEngine(
                alert_rules if alert_rules is not None else default_training_rules(),
                clock=clock, sink_path=self.metrics_dir / "alerts.jsonl",
                on_firing=self.recorder.alert_hook() if self.recorder is not None else None,
                source="trainer")
        if self.recorder is not None:
            self.recorder.attach(trace=self.trace,
                                 alerts_fn=self.alerts.states if self.alerts is not None else None)
        # a hung step reaches no boundary, and every boundary that runs has
        # just moved the steps counter: without a ticker on wall time the
        # training-stalled rule could never fire in the failure it exists
        # for. It shares the boundaries' rate limit, so it adds nothing to a
        # healthy loop (and an unadvanced fake clock keeps tests exact)
        self._alert_stop = threading.Event()
        self._alert_ticker: Optional[threading.Thread] = None
        self._compiles_at_start = compile_count()
        self._step_hist = self.registry.histogram("step_seconds", buckets=STEP_SECONDS_BUCKETS)
        self._words = self.registry.counter("words")
        self._steps = self.registry.counter("steps")
        self._anomalies = self.registry.counter("anomalies")
        # made at the first step_boundary(loss=...), so a run that streams no
        # loss keeps its exposition as it was
        self._loss_hist: Optional[_Histogram] = None
        self._loss_nonfinite: Optional[_Counter] = None
        self._rows: List[Dict[str, Any]] = []
        self._rows_lock = threading.Lock()
        self._last_boundary: Optional[float] = None
        self._t0 = clock()
        self.flops_per_step: Optional[float] = None
        self._flops_probed = False
        self._peak: Optional[float] = None
        self._peak_kind: Optional[str] = None
        self._handle: Optional[Any] = None
        self._finalized = False

    def _alert_tick_loop(self) -> None:
        import logging

        logger = logging.getLogger("spacy_ray_tpu_torch.training")
        while not self._alert_stop.wait(self.alert_interval_s):
            try:
                self.maybe_evaluate_alerts()
            except Exception:
                # a ticker that died silently would take the stall rule with it
                logger.exception("telemetry alert ticker pass failed")

    def _emit_anomaly(self, event: str, message: str, **fields: Any) -> None:
        from .resilience import log_event

        log_event(event, message, **fields)
        self._anomalies.inc()
        self._append_row({"kind": "anomaly", "anomaly": event, "message": message, **fields})
        self.trace.add_instant(event, args={"message": message})
        if self.recorder is not None:
            # the moment the last N seconds are worth keeping (the recorder's
            # rate limit makes a storm one bundle); a fleet divergence names
            # its worker and mode in incident.json
            self.recorder.trip(f"anomaly-{event}", message,
                               **{k: fields[k] for k in ("step", "worker", "mode")
                                  if fields.get(k) is not None})

    def maybe_evaluate_alerts(self, *, force: bool = False) -> None:
        """One alert pass when ``alert_interval_s`` has passed since the
        last (or ``force``): the registry snapshot with the host sample under
        ``process`` goes to the flight recorder's ring and the engine. The
        hot path pays one clock compare; the ticker thread calls it too."""
        if self.alerts is None and self.recorder is None:
            return
        now = self.clock()
        if (not force and self._last_alert_eval is not None
                and now - self._last_alert_eval < self.alert_interval_s):
            return
        self._last_alert_eval = now
        snap = self.registry.snapshot()
        snap["process"] = self.hoststats.sample()
        if self.recorder is not None:
            self.recorder.record(snap)
        if self.alerts is not None:
            self.alerts.evaluate(snap)

    def _append_row(self, row: Dict[str, Any]) -> None:
        with self._rows_lock:
            self._rows.append(row)

    def append_row(self, row: Dict[str, Any]) -> None:
        """Buffer one more ``metrics.jsonl`` row, written with the next
        flush (a fleet worker's ``kind: "fleet"`` exit row)."""
        self._append_row(dict(row))

    def _flush_rows(self) -> None:
        with self._rows_lock:
            rows, self._rows = self._rows, []
        if not rows:
            return
        if self._handle is None:
            self._handle = open(self.metrics_path, "a", encoding="utf8")
        for row in rows:
            # a NaN loss row stays valid JSON
            self._handle.write(json.dumps(sanitize_json(row), default=float) + "\n")
        self._handle.flush()

    def loop_start(self) -> None:
        """Arm the step clock and start the alert ticker right before the
        first step: a run that fails in its set-up leaves no thread behind,
        and its set-up time counts toward no stall."""
        self._last_boundary = self.clock()
        self.trace.set_recording(self.trace_steps[0] <= 0 < self.trace_steps[1])
        if self.alerts is not None and self._alert_ticker is None and not self._finalized:
            self._alert_ticker = threading.Thread(target=self._alert_tick_loop,
                                                  name="telemetry-alerts", daemon=True)
            self._alert_ticker.start()

    def step_boundary(self, *, step: int, epoch: int, n_words: int, steps_run: int,
                      inner_steps: int = 1, loss: Optional[float] = None) -> None:
        """The one hot-path hook: a clock stamp, a histogram observation, a
        buffered row, a span, and the trace window's gate. ``loss`` (a host
        float, when the caller has one) lands on the row: finite values feed
        the ``loss`` histogram, non-finite ones count ``loss_nonfinite``.
        ``inner_steps`` > 1 splits one stamp's window and words evenly over
        that many steps (kept for the JAX package's ``steps_per_dispatch`` callers;
        the port's loop runs single steps). Then the rate-limited alert
        pass (:meth:`maybe_evaluate_alerts`)."""
        now = self.clock()
        prev = self._last_boundary
        self._last_boundary = now
        k = max(int(inner_steps), 1)
        self._steps.inc(k)
        self._words.inc(n_words)
        if prev is not None:
            dur = (now - prev) / k
            for i in range(k):
                step_i = step - k + 1 + i
                words_i = n_words // k
                self._step_hist.observe(dur)
                args: Dict[str, Any] = {"step": step_i, "words": words_i}
                row: Dict[str, Any] = {
                    "kind": "step", "step": step_i, "epoch": epoch,
                    "t": round(prev + (i + 1) * dur - self._t0, 6),
                    "step_seconds": round(dur, 6), "words": words_i,
                }
                if k > 1:
                    args["dispatch_k"] = k
                    row["dispatch_k"] = k
                if loss is not None and i == k - 1:
                    loss_f = float(loss)
                    row["loss"] = loss_f
                    if math.isfinite(loss_f):
                        if self._loss_hist is None:
                            self._loss_hist = self.registry.histogram("loss", max_samples=64)
                        self._loss_hist.observe(loss_f)
                    else:
                        if self._loss_nonfinite is None:
                            self._loss_nonfinite = self.registry.counter("loss_nonfinite")
                        self._loss_nonfinite.inc()
                self.trace.add_span("step", prev + i * dur, dur, cat="step", args=args)
                self._append_row(row)
                if self.detectors is not None:
                    self.detectors.check_step_time(step_i, dur)
        self.maybe_evaluate_alerts()
        # the span above was gated at the previous boundary (the completed
        # step's own index); this gates the next step
        start, stop = self.trace_steps
        self.trace.set_recording(start <= steps_run < stop)

    def eval_boundary(self, *, step: int, epoch: int, steps_run: int,
                      losses: Dict[str, float], score: Optional[float], eval_seconds: float,
                      flops_fn: Optional[Callable[[], Optional[float]]] = None,
                      wps: Optional[float] = None) -> Dict[str, Any]:
        """Sample the gauges, run the detectors, write the rows; returns the
        snapshot the training logger puts in its row. ``flops_fn`` is probed
        at the first evaluation only."""
        device = sample_device_telemetry(self.device)
        reg = self.registry
        if device["hbm_peak_bytes"] is not None:
            reg.gauge("hbm_peak_bytes").set(device["hbm_peak_bytes"])
        if device["hbm_bytes_in_use"] is not None:
            reg.gauge("hbm_bytes_in_use").set(device["hbm_bytes_in_use"])
        if device["live_buffers"] is not None:
            reg.gauge("live_buffers").set(device["live_buffers"])
        compiles = device["compile_count"] - self._compiles_at_start
        reg.gauge("compile_count").set(compiles)
        if not self._flops_probed and flops_fn is not None:
            self._flops_probed = True
            try:
                self.flops_per_step = flops_fn()
            except Exception:
                self.flops_per_step = None
            self._peak, self._peak_kind = device_peak_flops(self.device)
        hist = self._step_hist
        p50 = hist.percentile(0.5)
        p95 = hist.percentile(0.95)
        mfu = None
        if self.flops_per_step and self._peak and p50:
            # the host's step time: the chip's use over the whole pipeline
            mfu = self.flops_per_step / p50 / self._peak
        loss_total = sum(float(v) for v in losses.values()) if losses else None
        if self.detectors is not None:
            if loss_total is not None:
                self.detectors.check_loss(step, loss_total)
            if score is not None and _is_bad(float(score)):
                self.detectors._fire("nan-score", f"non-finite eval score {score!r} at step "
                                     f"{step}", step=step)
            self.detectors.check_compiles(steps_run, compiles)
        row: Dict[str, Any] = {
            "kind": "eval", "step": step, "epoch": epoch,
            "t": round(self.clock() - self._t0, 6),
            "loss_total": loss_total, "losses": dict(losses), "score": score,
            "eval_seconds": round(eval_seconds, 6), "wps": wps,
            "step_seconds_p50": p50, "step_seconds_p95": p95,
            "hbm_bytes_in_use": device["hbm_bytes_in_use"],
            "hbm_peak_bytes": device["hbm_peak_bytes"],
            "hbm_bytes_limit": device["hbm_bytes_limit"],
            "live_buffers": device["live_buffers"], "compile_count": compiles,
            "flops_per_step": self.flops_per_step,
            "mfu": round(mfu, 5) if mfu is not None else None,
            "platform": device["platform"],
        }
        row["process"] = self.hoststats.sample()
        self._append_row(row)
        self._flush_rows()
        self.maybe_evaluate_alerts(force=True)
        return {
            "step_seconds_p50": p50, "step_seconds_p95": p95,
            "hbm_peak_bytes": device["hbm_peak_bytes"], "live_buffers": device["live_buffers"],
            "compile_count": compiles, "mfu": row["mfu"], "trace_events": len(self.trace),
        }

    def rearm_step_clock(self) -> None:
        """Re-stamp the step clock after evaluation and checkpointing, which
        must not count as the next step's time."""
        self._last_boundary = self.clock()

    def emergency_flush(self) -> None:
        """Best-effort flush before a hard exit (the watchdog's ``os._exit``:
        no ``finally`` runs after it)."""
        try:
            self._flush_rows()
        except Exception:
            pass
        try:
            self.trace.flush(self.trace_path)
        except Exception:
            pass

    def finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        self._alert_stop.set()
        if self._alert_ticker is not None:
            self._alert_ticker.join(timeout=2.0)
            self._alert_ticker = None
        self._flush_rows()
        self.trace.flush(self.trace_path)
        if self._handle is not None:
            self._handle.close()
            self._handle = None


# ----------------------------------------------------------------------
# Offline summary (`telemetry summarize metrics.jsonl`)
# ----------------------------------------------------------------------


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


def _fmt_ms(v: Any) -> str:
    return f"{float(v) * 1e3:.1f}ms" if isinstance(v, (int, float)) else "-"


def _summarize_serving_rows(servings: List[Dict[str, Any]]) -> List[str]:
    """The serving section of ``telemetry summarize``: built from the
    LAST ``kind: "serving"`` row (each row is a cumulative snapshot, so
    the newest supersedes the rest) — request/reject totals, the SLO
    percentiles (lifetime ring AND sliding window), and per-generation
    rows when the snapshot carries a ``by_generation`` split."""
    last = servings[-1]
    counters = last.get("counters") or {}
    lines: List[str] = []
    reqs = int(counters.get("requests") or 0)
    rejects = {
        k: int(counters.get(k) or 0)
        for k in (
            "rejected_queue_full", "rejected_draining",
            "deadline_exceeded", "errors",
        )
        if counters.get(k)
    }
    line = (
        f"serving: requests {reqs:,}  docs {int(counters.get('docs') or 0):,}"
        f"  batches {int(counters.get('batches') or 0):,}"
    )
    if counters.get("swaps"):
        line += f"  swaps {int(counters['swaps'])}"
    gen = last.get("generation")
    if gen is not None:
        line += f"  generation {gen}"
    lines.append(line)
    if rejects:
        lines.append(
            "  rejects: "
            + "  ".join(f"{k} {v}" for k, v in sorted(rejects.items()))
        )
    else:
        lines.append("  rejects: none")
    slo = last.get("slo") or {}
    if slo:
        lines.append(
            "  latency (lifetime ring): "
            f"p50 {_fmt_ms(slo.get('request_latency_p50'))}  "
            f"p95 {_fmt_ms(slo.get('request_latency_p95'))}  "
            f"p99 {_fmt_ms(slo.get('request_latency_p99'))}"
        )
    win = last.get("slo_window")
    if isinstance(win, dict):
        lines.append(
            f"  latency (last {float(win.get('window_s') or 0):.0f}s, "
            f"{int(win.get('samples') or 0)} sample(s)): "
            f"p50 {_fmt_ms(win.get('request_latency_p50'))}  "
            f"p99 {_fmt_ms(win.get('request_latency_p99'))}"
        )
    by_gen = last.get("by_generation")
    if isinstance(by_gen, dict) and by_gen:
        lines.append("  by generation:")
        for key in sorted(by_gen):
            sub = by_gen[key] or {}
            sub_counters = sub.get("counters") or {}
            sub_win = sub.get("slo_window") or {}
            lines.append(
                f"    gen {key:>6s}: requests "
                f"{int(sub_counters.get('requests') or 0):,}  window p99 "
                f"{_fmt_ms(sub_win.get('request_latency_p99'))}"
            )
    return lines


def _summarize_fleet_rows(fleet_rows: List[Dict[str, Any]]) -> List[str]:
    """The trainer-fleet section of ``telemetry summarize``: built from
    the ``kind: "fleet"`` exit row each fleet worker appends at finalize
    (the newest per worker wins) — per-worker version/counters, the
    phase-share split, and the dynamics-histogram digest (staleness,
    quorum wait, apply)."""
    by_worker: Dict[int, Dict[str, Any]] = {}
    for row in fleet_rows:
        w = row.get("worker")
        if isinstance(w, int):
            by_worker[w] = row
    if not by_worker:
        return []
    any_row = next(iter(by_worker.values()))
    lines = [
        f"trainer fleet: {any_row.get('n_workers')} worker(s)  "
        f"quorum {any_row.get('quorum')}  "
        f"max_staleness {any_row.get('max_staleness')}"
    ]
    for w in sorted(by_worker):
        row = by_worker[w]
        c = row.get("counters") or {}
        hists = row.get("histograms") or {}
        phases = row.get("phases") or {}
        total = sum(float(v) for v in phases.values()) or 1.0
        share = "  ".join(
            f"{p} {100 * float(phases.get(p, 0.0)) / total:.0f}%"
            for p in ("data", "pull", "grad", "push", "apply_wait")
            if p in phases
        )
        lines.append(
            f"  worker {w}: version {row.get('version')}  "
            f"pushed {int(c.get('grad_pushed') or 0)}  "
            f"received {int(c.get('grad_received') or 0)}  "
            f"applied {int(c.get('grad_applied') or 0)}  "
            f"discarded {int(c.get('grad_discarded') or 0)}  "
            f"push-failed {int(c.get('push_failed') or 0)}"
        )
        if share:
            lines.append(f"    phases: {share}")
        st = hists.get("staleness") or {}
        if st.get("count"):
            buckets = st.get("buckets") or []
            bl = "  ".join(
                f"<={int(le)}: {int(cum)}" for le, cum in buckets
                if cum
            )
            lines.append(
                f"    staleness (accepted pushes): n={st['count']}  "
                f"max {st.get('max')}  {bl}"
            )
        qw, ap = hists.get("quorum_wait_seconds") or {}, hists.get(
            "apply_seconds"
        ) or {}
        if qw.get("count") or ap.get("count"):
            lines.append(
                f"    quorum-wait p50 {_fmt_ms(qw.get('p50'))} "
                f"p99 {_fmt_ms(qw.get('p99'))}  "
                f"apply p50 {_fmt_ms(ap.get('p50'))} "
                f"p99 {_fmt_ms(ap.get('p99'))}"
            )
    return lines


def _summarize_run_dir(run_dir: Path) -> str:
    """``telemetry summarize <run-dir>``: a trainer-fleet run directory
    (``fleet-worker-*.json`` ledgers + ``metrics/fleet-worker-*/
    metrics.jsonl``) gets a fleet digest; a plain run directory holding
    one ``metrics.jsonl`` falls through to the file summary. Discovery
    is :func:`~.report.load_run` — the ONE definition of the run-dir
    layout, shared with ``telemetry report``."""
    from .report import load_run

    run_dir = Path(run_dir)
    run = load_run(run_dir)  # ValueError when not a run directory
    workers = run["workers"]
    ledgers = {
        w: e["ledger"] for w, e in workers.items() if "ledger" in e
    }
    metrics_paths = [
        workers[w]["metrics_path"]
        for w in sorted(workers)
        if workers[w].get("metrics_path")
    ]
    if not ledgers and len(metrics_paths) == 1:
        # a plain single-process run: the file summary IS the digest
        return summarize_metrics(metrics_paths[0])
    lines: List[str] = [f"telemetry summary (fleet run dir): {run_dir}"]
    if ledgers:
        rows = [ledgers[w] for w in sorted(ledgers)]
        total_words = sum(int(r.get("words_seen") or 0) for r in rows)
        slowest = max(float(r.get("seconds") or 0.0) for r in rows)
        lines.append(
            f"workers: {len(rows)}  total words {total_words:,}  "
            f"slowest worker {slowest:.1f}s"
            + (
                f"  ({total_words / slowest:,.0f} words/s fleet-wide)"
                if slowest > 0
                else ""
            )
        )
        for r in rows:
            c = r.get("counters") or {}
            phases = r.get("phases") or {}
            total = sum(float(v) for v in phases.values()) or 1.0
            wait_pct = 100 * float(phases.get("apply_wait") or 0.0) / total
            lines.append(
                f"  worker {r.get('worker')}: steps {r.get('steps')}  "
                f"words {int(r.get('words_seen') or 0):,}  "
                f"version {r.get('version')}  "
                f"discarded {int(c.get('grad_discarded') or 0)}  "
                f"push-failed {int(c.get('push_failed') or 0)}  "
                f"apply-wait {wait_pct:.0f}%"
                + ("  [interrupted]" if r.get("interrupted") else "")
            )
    for mp in metrics_paths:
        try:
            lines.append("")
            lines.append(summarize_metrics(mp))
        except (OSError, ValueError) as e:
            lines.append(f"  ({Path(mp).parent.name}: {e})")
    return "\n".join(lines)


def summarize_metrics(path: Path) -> str:
    """Digest a ``metrics.jsonl``: training rows (step-time percentiles,
    device gauges), serving rows (``kind: "serving"`` snapshots: SLO
    window, rejects, by-generation split), trainer-fleet rows (``kind:
    "fleet"`` exit rows: counters, phase share, staleness/quorum-wait/apply
    digest), plus the anomaly digest. Given a DIRECTORY, digests a fleet run
    dir (per-worker ledgers + metrics files) or its single
    ``metrics.jsonl``. Pure
    file-in/text-out so the CLI subcommand and the round-trip test share
    one implementation.

    Raises ValueError when the target holds no telemetry rows (a wrong
    path must not print an empty-but-plausible report)."""
    path = Path(path)
    if path.is_dir():
        return _summarize_run_dir(path)
    steps: List[Dict[str, Any]] = []
    evals: List[Dict[str, Any]] = []
    anomalies: List[Dict[str, Any]] = []
    servings: List[Dict[str, Any]] = []
    fleet_rows: List[Dict[str, Any]] = []
    with open(path, encoding="utf8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # torn concurrent write: skip, don't abort
            kind = row.get("kind")
            if kind == "step":
                steps.append(row)
            elif kind == "eval":
                evals.append(row)
            elif kind == "anomaly":
                anomalies.append(row)
            elif kind == "serving":
                servings.append(row)
            elif kind == "fleet":
                fleet_rows.append(row)
    if (
        not steps and not evals and not anomalies and not servings
        and not fleet_rows
    ):
        raise ValueError(f"{path} contains no telemetry rows")

    lines: List[str] = [f"telemetry summary: {path}"]
    if servings:
        lines.extend(_summarize_serving_rows(servings))
    if fleet_rows:
        lines.extend(_summarize_fleet_rows(fleet_rows))
    if steps:
        durs = sorted(float(s["step_seconds"]) for s in steps)
        words = sum(int(s.get("words") or 0) for s in steps)
        total = sum(durs)
        line = (
            f"steps: {len(durs)}  words: {words:,}  "
            f"step-time p50 {_nearest_rank(durs, 0.5) * 1e3:.1f}ms  "
            f"p95 {_nearest_rank(durs, 0.95) * 1e3:.1f}ms  "
            f"max {durs[-1] * 1e3:.1f}ms"
        )
        if total > 0:
            line += f"  ({words / total:,.0f} words/s overall)"
        lines.append(line)
    if evals:
        last = evals[-1]
        lines.append(
            f"device: platform={last.get('platform')}  "
            f"hbm_peak={_fmt_bytes(last.get('hbm_peak_bytes'))}  "
            f"live_buffers={last.get('live_buffers')}  "
            f"compiles={last.get('compile_count')}"
        )
        if isinstance(last.get("mfu"), (int, float)):
            lines.append(f"mfu (e2e, p50 step): {last['mfu']:.4f}")
        # sanitize_json stores a NaN score as the string "nan" — keep only
        # finite numerics, or the digest of a NaN run (the headline use
        # case) would crash on the format specifier
        scores = [
            e.get("score")
            for e in evals
            if isinstance(e.get("score"), (int, float))
            and math.isfinite(float(e["score"]))
        ]
        if scores:
            lines.append(
                f"evals: {len(evals)}  last score {scores[-1]:.4f}  "
                f"best {max(scores):.4f}"
            )
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for a in anomalies:
        by_kind.setdefault(str(a.get("anomaly")), []).append(a)
    if by_kind:
        lines.append(f"anomalies: {len(anomalies)}")
        for name in sorted(by_kind):
            rows = by_kind[name]
            anom_steps = [r.get("step") for r in rows if r.get("step") is not None]
            where = (
                f" (steps {min(anom_steps)}..{max(anom_steps)})"
                if anom_steps
                else ""
            )
            lines.append(f"  {name:24s} x{len(rows)}{where}")
    else:
        lines.append("anomalies: none")
    return "\n".join(lines)
