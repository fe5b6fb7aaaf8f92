"""The serving fleet's router (``spacy_ray_tpu/serving/fleet/router.py``):
one HTTP front end balancing ``/v1/parse`` over N replicas.

* **Picks.** Least outstanding requests among the ready replicas, ties to
  the lowest id. With a model manifest the pick runs within the replicas
  hosting the named model; with length routing a request's length bucket
  maps to one replica of the pool unless that replica is
  :data:`AFFINITY_SLACK` requests above the least loaded (then it spills); during a declared
  rollout (``canary_generation``) an error-diffusion accumulator splits
  ``canary_fraction`` of the picks onto the canary generation.
* **Readiness is probed.** A prober GETs every replica's ``/healthz``: 200
  puts it in rotation and teaches the router its generation and resident
  models; 503 (warming, draining) or a socket error takes it out. A forward
  that fails at the socket, or that the replica answers with its own 503
  draining/warming, takes the replica out at once and retries on another
  (one attempt per ready replica, plus one): a replica's crash costs a
  retry, not a client's 5xx. With no replica ready the answer is a typed 503
  ``no_replica`` at once.
* **The response cache** (``cache_bytes`` > 0) is a byte-capped LRU of 200
  bodies keyed by the request's texts (and model), each stamped with the
  generation that computed it: a hit must match the one generation every
  ready replica serves, the cache is bypassed while they straddle
  generations, and :meth:`Router.flush_cache` drops everything. A matching
  ``If-None-Match`` is answered 304 at the edge without a forward.
  Otherwise the router forwards bytes and parses no JSON.
* ``/metrics`` is the fleet's view: every ready replica's snapshot merged
  by :func:`~...training.telemetry.merge_serving_snapshots`, with the
  router's own counters, the cache's ledger and the roster of replicas
  (``?format=prometheus``: per-replica series labelled ``replica_id``),
  and with an alert engine its ``alerts`` summary and ``srt_alert_*``
  families. ``/admin/alerts`` lists every router rule's state
  (``{"alerts": "disabled"}`` without an engine). Each probe's ``/healthz``
  payload joins the replica's ``health_history``.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ...training.resilience import log_event
from ..batcher import (
    REQUEST_ID_HEADER,
    Draining,
    ServingError,
    UnknownModel,
    cache_key_for,
    clean_request_id,
    etag_for,
    if_none_match_hit,
    mint_request_id,
)
from ..multimodel.registry import TENANT_HEADER
from .replica import ReplicaHandle

__all__ = [
    "NoReplicaAvailable",
    "ResponseCache",
    "GENERATION_MIXED",
    "RouterTelemetry",
    "Router",
    "RouterHTTPServer",
]

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

MAX_BODY_BYTES = 8 << 20  # the replica's own cap
#: the control plane's timeout (probes, scrapes); a forward's is longer
PROBE_TIMEOUT_S = 5.0
FORWARD_TIMEOUT_S = 60.0
#: how many requests above the least loaded a length bucket's replica may
#: be before its requests spill to the least loaded
AFFINITY_SLACK = 2
#: the router's trace ring
TRACE_MAX_EVENTS = 100_000


class NoReplicaAvailable(ServingError):
    """No replica is ready (all warming, crashed or draining): a typed 503
    the moment it is known."""

    http_status = 503
    code = "no_replica"


#: the ready replicas straddle generations: no single stamp vouches for a
#: cached body, so the cache is bypassed until the fleet converges
GENERATION_MIXED = object()


def _length_bucket_hint(texts: List[str]) -> int:
    """A request's length bucket for affinity routing: the whitespace word
    count of its longest text (the shape a batch pads to) against the
    engine's bucket table. A miss near a boundary only weakens affinity."""
    from ...training.batcher import DEFAULT_LENGTH_BUCKETS

    est = max(len(t.split()) for t in texts)
    for i, bucket in enumerate(DEFAULT_LENGTH_BUCKETS):
        if est <= bucket:
            return i
    return len(DEFAULT_LENGTH_BUCKETS) - 1


class ResponseCache:
    """Byte-capped LRU of ``/v1/parse`` 200 bodies, keyed by
    :func:`~..batcher.cache_key_for` (the replica's ETag is that key plus the
    generation) and stamped with the generation that computed them.

    :meth:`get` takes the generation the caller expects: an entry of another
    generation is dropped and counted as a stale invalidation, never served.
    :meth:`put` refuses a body larger than the whole cap and replaces an
    entry of another generation. Thread-safe; the counters feed
    ``/metrics``, per model too."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[bytes, Tuple[Any, bytes]]" = OrderedDict()
        self._nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_invalidations = 0
        self.flushes = 0
        self.not_modified = 0  # 304s: the client already held the body
        self.by_model: Dict[str, Dict[str, int]] = {}

    key_for = staticmethod(cache_key_for)

    def _tally(self, model: Optional[str], field: str) -> None:
        """The caller holds ``_lock``."""
        if model is None:
            return
        ledger = self.by_model.setdefault(
            model, {"hits": 0, "misses": 0, "stale_invalidations": 0})
        ledger[field] = ledger.get(field, 0) + 1

    def get(self, key: bytes, generation: Any = None,
            model: Optional[str] = None) -> Optional[bytes]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                self._tally(model, "misses")
                return None
            stored_gen, body = entry
            if stored_gen != generation:
                del self._entries[key]
                self._nbytes -= len(body)
                self.stale_invalidations += 1
                self.misses += 1
                self._tally(model, "stale_invalidations")
                self._tally(model, "misses")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self._tally(model, "hits")
            return body

    def put(self, key: bytes, body: bytes, generation: Any = None) -> None:
        if len(body) > self.max_bytes:
            return  # one oversized body must not flush the cache
        with self._lock:
            if key in self._entries:
                old_gen, old_body = self._entries[key]
                if old_gen == generation:
                    return
                self._nbytes -= len(old_body)
                del self._entries[key]
            self._entries[key] = (generation, body)
            self._nbytes += len(body)
            while self._nbytes > self.max_bytes and len(self._entries) > 1:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._nbytes -= len(evicted)
                self.evictions += 1

    def count_not_modified(self, model: Optional[str] = None) -> None:
        with self._lock:
            self.not_modified += 1
            self._tally(model, "not_modified")

    def flush(self) -> int:
        """Drop every entry (a promotion); returns how many."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._nbytes = 0
            if n:
                self.flushes += 1
        return n

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "cache_hits": self.hits,
                "cache_misses": self.misses,
                "cache_evictions": self.evictions,
                "cache_stale_invalidations": self.stale_invalidations,
                "cache_flushes": self.flushes,
                "cache_not_modified": self.not_modified,
                "cache_entries": len(self._entries),
                "cache_bytes": self._nbytes,
            }
            if self.by_model:
                out["by_model"] = {m: dict(ledger)
                                   for m, ledger in sorted(self.by_model.items())}
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class RouterTelemetry:
    """The router's own metrics over the telemetry primitives: its latency
    histogram (admission to answer), routed, retried, rejected and cache-hit
    counters, the ready gauge, split and affinity tallies, a ``route`` span
    per forward and an instant per reroute or reject, and the router
    process's host sample. A router built without it makes no telemetry
    call at all."""

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter) -> None:
        from ...training.hoststats import ProcessSampler
        from ...training.telemetry import LATENCY_BUCKETS, MetricsRegistry, TraceBuffer

        self.registry = MetricsRegistry(clock=clock)
        self.trace = TraceBuffer(clock=clock, max_events=TRACE_MAX_EVENTS)
        self.hoststats = ProcessSampler(clock=clock)
        self._latency = self.registry.histogram("router_latency_seconds", 2048,
                                                buckets=LATENCY_BUCKETS)
        self._requests = self.registry.counter("requests")
        self._routed = self.registry.counter("routed")
        self._retries = self.registry.counter("retries")
        self._rej_no_replica = self.registry.counter("rejected_no_replica")
        self._rej_draining = self.registry.counter("rejected_draining")
        self._rej_unknown_model = self.registry.counter("rejected_unknown_model")
        self._cache_hits = self.registry.counter("cache_hits")
        self._ready = self.registry.gauge("ready_replicas")
        self._replicas = self.registry.gauge("replicas")
        # a ready replica whose scrape failed is counted, not silently left
        # out of the fleet's view
        self._scrape_failures = self.registry.counter("scrape_failures")
        self._canary_picks = self.registry.counter("routed_canary")
        self._baseline_picks = self.registry.counter("routed_baseline")
        self._affinity_picks = self.registry.counter("length_affinity_picks")
        self._affinity_spills = self.registry.counter("length_affinity_spills")

    def now(self) -> float:
        return self.trace.now()

    def request(self) -> None:
        self._requests.inc()

    def routed(self, latency_s: float, *, request_id: Optional[str] = None,
               t0: Optional[float] = None, replica_id: Optional[int] = None) -> None:
        self._routed.inc()
        self._latency.observe(latency_s)
        if t0 is not None:
            # the router's half of the request's trace: the same id as the
            # replica's ``request`` span
            args: Dict[str, Any] = {}
            if request_id is not None:
                args["request_id"] = request_id
            if replica_id is not None:
                args["replica"] = replica_id
            self.trace.add_span("route", t0, max(self.now() - t0, 0.0), cat="fleet",
                                args=args or None)

    def retry(self, replica_id: int, error: str, request_id: Optional[str] = None) -> None:
        self._retries.inc()
        args = {"replica": replica_id, "error": error}
        if request_id is not None:
            args["request_id"] = request_id
        self.trace.add_instant("reroute", cat="fleet", args=args)

    def rejected(self, error: ServingError, request_id: Optional[str] = None) -> None:
        if isinstance(error, Draining):
            self._rej_draining.inc()
        elif isinstance(error, UnknownModel):
            self._rej_unknown_model.inc()
        else:
            self._rej_no_replica.inc()
        args = {"error": str(error)}
        if request_id is not None:
            args["request_id"] = request_id
        self.trace.add_instant(f"reject:{error.code}", cat="fleet", args=args)

    def scrape_failed(self, replica_id: int) -> None:
        self._scrape_failures.inc()

    def cache_hit(self) -> None:
        self._cache_hits.inc()

    def split_pick(self, canary: bool) -> None:
        (self._canary_picks if canary else self._baseline_picks).inc()

    def affinity_pick(self, *, spilled: bool) -> None:
        (self._affinity_spills if spilled else self._affinity_picks).inc()

    def replica_counts(self, ready: int, total: int) -> None:
        self._ready.set(ready)
        self._replicas.set(total)

    def snapshot(self) -> Dict[str, Any]:
        snap = self.registry.snapshot()
        snap["slo"] = {
            "router_latency_p50": self._latency.percentile(0.50),
            "router_latency_p95": self._latency.percentile(0.95),
            "router_latency_p99": self._latency.percentile(0.99),
        }
        return snap


class Router:
    """Balancing and health over the handles ``replicas()`` returns (the
    supervisor's live view, so scaling needs no registration; tests pass a
    static list). ``registry`` (a manifest's
    :class:`~..multimodel.registry.ModelRegistry`) resolves the model a
    request names; without it the single-model path is unchanged.
    ``canary_fraction`` splits traffic only while ``canary_generation`` is
    set (a rollout controller sets it; the fleet builds the router with 0).
    """

    def __init__(
        self,
        replicas: Callable[[], List[ReplicaHandle]],
        *,
        telemetry: Optional[RouterTelemetry] = None,
        cache_bytes: int = 0,
        probe_interval_s: float = 0.5,
        canary_fraction: float = 0.0,
        registry: Optional[Any] = None,
        length_routing: bool = False,
    ) -> None:
        self.replicas = replicas
        self.tel = telemetry
        self.length_routing = bool(length_routing)
        self.registry = registry
        self.cache = ResponseCache(cache_bytes) if cache_bytes > 0 else None
        self.probe_interval_s = float(probe_interval_s)
        self.canary_fraction = float(canary_fraction)
        self.canary_generation: Optional[int] = None
        self._split_lock = threading.Lock()
        self._split_acc = 0.0
        # the fleet's alert engine and flight recorder (None with telemetry off)
        self.alerts: Optional[Any] = None
        self.recorder: Optional[Any] = None
        self._stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        self._scrape_lock = threading.Lock()
        self.scrape_failures: Dict[int, int] = {}  # replica id -> failed scrapes
        self._cache_bypass_lock = threading.Lock()
        self.cache_mixed_bypasses = 0
        self.draining = False
        self._inflight_lock = threading.Lock()
        self._inflight = 0
        self._idle = threading.Condition(self._inflight_lock)

    # -- health probing --------------------------------------------------
    def probe_once(self) -> int:
        """Probe every addressed replica's ``/healthz`` and set its ready
        flag, generation and resident models; returns how many are ready."""
        handles = self.replicas()
        n_ready = 0
        for h in handles:
            addr = h.address
            if addr is None or h.stopping or not h.alive:
                self._mark_unready(h, "no address" if addr is None else "down")
                continue
            try:
                status, raw = self._get_aux(h, addr, "/healthz", PROBE_TIMEOUT_S)
                ok = status == 200
            except OSError:
                ok, raw = False, b""
            if not ok:
                self._mark_unready(h, "healthz != 200")
                continue
            try:
                health = json.loads(raw)
            except ValueError:
                health = {}
            if isinstance(health, dict):
                gen = health.get("generation")
                swaps = health.get("swap_count")
                resident = health.get("resident_models")
                default_model = health.get("default_model")
                with h.lock:
                    h.generation = gen if isinstance(gen, int) else None
                    if isinstance(swaps, int):
                        h.swap_count = swaps
                    h.resident_models = (
                        {str(m): (info if isinstance(info, dict) else {})
                         for m, info in resident.items()}
                        if isinstance(resident, dict) else {})
                    h.default_model = default_model if isinstance(default_model, str) else None
                    h.health_history.append({"unix_time": round(time.time(), 3),
                                             "health": health})
            self._mark_ready(h)
            n_ready += 1
        if self.tel is not None:
            self.tel.replica_counts(n_ready, len(handles))
        return n_ready

    def _mark_ready(self, h: ReplicaHandle) -> None:
        with h.lock:
            was = h.ready
            h.ready = True
        if not was:
            log_event("replica-ready", f"replica {h.replica_id} ready at {h.host}:{h.port}",
                      level=logging.INFO, replica=h.replica_id)

    def _mark_unready(self, h: ReplicaHandle, reason: str) -> None:
        with h.lock:
            was = h.ready
            h.ready = False
        h.close_conns()  # pooled connections to a gone replica are all stale
        if was:
            log_event("replica-unready", f"replica {h.replica_id} removed from rotation "
                      f"({reason})", replica=h.replica_id, reason=reason)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:  # the prober must survive anything
                logger.exception("health probe pass failed")
            self._stop.wait(self.probe_interval_s)

    def start(self) -> "Router":
        self._prober = threading.Thread(target=self._probe_loop, daemon=True,
                                        name="fleet-prober")
        self._prober.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
            self._prober = None
        for h in self.replicas():
            h.close_conns()

    # -- the cache's generation rules ------------------------------------
    def cache_generation(self, model: Optional[str] = None) -> Any:
        """The generation a cache hit must match: the one every ready
        replica serves (with ``model``: every ready replica hosting it), or
        :data:`GENERATION_MIXED` when they straddle generations or none
        hosts the model yet."""
        if model is not None:
            hosts = [h for h in self.ready_handles() if model in h.resident_models]
            if not hosts:
                return GENERATION_MIXED
            gens = {h.resident_models[model].get("generation") for h in hosts}
            return next(iter(gens)) if len(gens) == 1 else GENERATION_MIXED
        gens = {h.generation for h in self.ready_handles()}
        return next(iter(gens)) if len(gens) == 1 else GENERATION_MIXED

    def count_cache_bypass(self) -> None:
        with self._cache_bypass_lock:
            self.cache_mixed_bypasses += 1

    def cache_stats(self) -> Optional[Dict[str, Any]]:
        """The cache's counters and the router's mixed-generation bypasses:
        the one ledger ``/metrics`` and its Prometheus text read."""
        if self.cache is None:
            return None
        stats = self.cache.stats()
        with self._cache_bypass_lock:
            stats["cache_mixed_generation_bypasses"] = self.cache_mixed_bypasses
        return stats

    def flush_cache(self, reason: str = "") -> int:
        """Drop the whole cache (a promotion: the fleet's generation
        changed); a no-op without one."""
        if self.cache is None:
            return 0
        n = self.cache.flush()
        if n:
            log_event("cache-flush", f"response cache flushed ({n} entr(ies))"
                      + (f": {reason}" if reason else ""),
                      level=logging.INFO, entries=n, reason=reason)
        return n

    # -- picks -----------------------------------------------------------
    def ready_handles(self) -> List[ReplicaHandle]:
        return [h for h in self.replicas()
                if h.ready and not h.stopping and h.address is not None]

    def pick(self, model: Optional[str] = None,
             length_bucket: Optional[int] = None) -> ReplicaHandle:
        """Least outstanding over the ready set, ties to the lowest id.
        ``model`` narrows the pool to its hosts (the whole ready set when
        none hosts it yet: the chosen replica loads it); during a declared
        rollout the split accumulator picks the canary or the baseline side;
        then, with length routing and a hint, the bucket's replica of the
        pool unless it is more than :data:`AFFINITY_SLACK` above the least
        loaded. Raises :class:`NoReplicaAvailable` with nothing ready."""
        ready = self.ready_handles()
        if not ready:
            raise NoReplicaAvailable("no replica is ready (all warming, draining, or down)")
        if model is not None:
            hosting = [h for h in ready if model in h.resident_models]
            if hosting:
                ready = hosting
        pool = ready
        target = self.canary_generation
        if self.canary_fraction > 0.0 and target is not None:
            canary = [h for h in ready if h.generation == target]
            baseline = [h for h in ready if h.generation != target]
            if canary and baseline:
                with self._split_lock:
                    self._split_acc += min(self.canary_fraction, 1.0)
                    take_canary = self._split_acc >= 1.0 - 1e-9
                    if take_canary:
                        self._split_acc -= 1.0
                pool = canary if take_canary else baseline
                if self.tel is not None:
                    self.tel.split_pick(take_canary)
        if self.length_routing and length_bucket is not None and len(pool) > 1:
            ordered = sorted(pool, key=lambda h: h.replica_id)
            chosen = ordered[length_bucket % len(ordered)]
            floor = min(h.outstanding for h in pool)
            if chosen.outstanding <= floor + AFFINITY_SLACK:
                if self.tel is not None:
                    self.tel.affinity_pick(spilled=False)
                return chosen
            if self.tel is not None:
                self.tel.affinity_pick(spilled=True)
        return min(pool, key=lambda h: (h.outstanding, h.replica_id))

    # -- forwarding ------------------------------------------------------
    def forward_parse(
        self,
        body: bytes,
        request_id: Optional[str] = None,
        *,
        model: Optional[str] = None,
        explicit_model: bool = False,
        tenant: Optional[str] = None,
        length_bucket: Optional[int] = None,
        if_none_match: Optional[str] = None,
    ) -> Tuple[int, bytes, Optional[int], Optional[str]]:
        """Forward one ``/v1/parse`` body: pick, post; on a socket failure or
        the replica's own 503 draining/warming take the replica out of
        rotation and retry on another, at most one attempt per ready replica
        plus one (``/v1/parse`` is pure, so a resend is safe). Any other
        status (429, 504, ...) is the replica's answer and is passed through.
        Returns ``(status, payload, replica_id, etag)``. A model the client
        named goes to ``/v1/models/<name>/parse``; ``tenant`` and
        ``if_none_match`` ride along as headers, ``request_id`` as
        ``X-SRT-Request-Id``."""
        if self.draining:
            raise Draining("fleet is draining; not admitting requests")
        path = (f"/v1/models/{model}/parse" if model is not None and explicit_model
                else "/v1/parse")
        extra_headers: Optional[Dict[str, str]] = None
        if tenant or if_none_match:
            extra_headers = {}
            if tenant:
                extra_headers[TENANT_HEADER] = tenant
            if if_none_match:
                extra_headers["If-None-Match"] = if_none_match
        with self._inflight_lock:
            self._inflight += 1
        try:
            attempts = 0
            max_attempts = max(len(self.ready_handles()), 1) + 1
            last_err: Optional[Exception] = None
            while attempts < max_attempts:
                attempts += 1
                h = self.pick(model, length_bucket=length_bucket)
                addr = h.address
                if addr is None:
                    continue
                with h.lock:
                    h.outstanding += 1
                try:
                    status, payload, etag = self._post(
                        h, addr, path, body, FORWARD_TIMEOUT_S,
                        request_id=request_id, extra_headers=extra_headers)
                    if status == 503 and self._replica_unavailable(payload):
                        last_err = OSError(f"replica {h.replica_id} answered 503 "
                                           "(draining/warming)")
                        self._mark_unready(h, "replica 503 draining/warming")
                        if self.tel is not None:
                            self.tel.retry(h.replica_id, "Replica503", request_id)
                        continue
                    return status, payload, h.replica_id, etag
                except OSError as e:
                    # crashed or restarting: out of rotation now, back when
                    # its /healthz answers 200 again
                    last_err = e
                    self._mark_unready(h, f"forward failed: {e!r}")
                    if self.tel is not None:
                        self.tel.retry(h.replica_id, type(e).__name__, request_id)
                finally:
                    with h.lock:
                        h.outstanding -= 1
            raise NoReplicaAvailable(f"request failed on {attempts} replica attempt(s); "
                                     f"last error: {last_err!r}")
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                self._idle.notify_all()

    @staticmethod
    def _replica_unavailable(payload: bytes) -> bool:
        """Whether a 503 body is the replica's own draining or warming (the
        only statuses retried elsewhere; only 503 bodies are parsed)."""
        try:
            err = json.loads(payload)
        except ValueError:
            return False
        return isinstance(err, dict) and err.get("error") in ("draining", "warming")

    @staticmethod
    def _post(h: ReplicaHandle, addr: Tuple[str, int], path: str, body: bytes,
              timeout_s: float, request_id: Optional[str] = None,
              extra_headers: Optional[Dict[str, str]] = None
              ) -> Tuple[int, bytes, Optional[str]]:
        """POST over a pooled keep-alive connection. A pooled connection
        may be stale (a restart severs the whole pool at once): a failure on
        one tries the next pooled one, then one fresh dial, whose failure
        raises OSError. Returns ``(status, payload, etag)``."""
        headers = {"Content-Type": "application/json"}
        if request_id is not None:
            headers[REQUEST_ID_HEADER] = request_id
        if extra_headers:
            headers.update(extra_headers)
        conn = h.checkout_conn()
        while True:
            fresh = conn is None
            if fresh:
                conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout_s)
            try:
                conn.request("POST", path, body, headers)
                resp = conn.getresponse()
                payload = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if not fresh:
                    conn = h.checkout_conn()
                    continue
                if not isinstance(e, OSError):
                    raise OSError(f"replica HTTP protocol error: {e!r}")
                raise
            if resp.will_close:
                conn.close()
            else:
                h.checkin_conn(conn)
            return resp.status, payload, resp.getheader("ETag")

    @staticmethod
    def _get_aux(h: ReplicaHandle, addr: Tuple[str, int], path: str,
                 timeout_s: float) -> Tuple[int, bytes]:
        """GET over a pooled control-plane connection, with :meth:`_post`'s
        rule for stale ones."""
        conn = h.checkout_aux_conn()
        while True:
            fresh = conn is None
            if fresh:
                conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout_s)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                payload = resp.read()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if not fresh:
                    conn = h.checkout_aux_conn()
                    continue
                if not isinstance(e, OSError):
                    raise OSError(f"replica HTTP protocol error: {e!r}")
                raise
            if resp.will_close:
                conn.close()
            else:
                h.checkin_aux_conn(conn)
            return resp.status, payload

    # -- placement (multi-model) -------------------------------------------
    def placement(self) -> Dict[int, List[str]]:
        """Replica id -> the models its last probe said it hosts."""
        return {h.replica_id: sorted(h.resident_models) for h in self.replicas()}

    def load_model(self, replica_id: int, model: str) -> Tuple[int, bytes]:
        """POST ``/admin/models/load`` to one replica on a fresh connection;
        raises :class:`NoReplicaAvailable` when it has no address."""
        handle = next((h for h in self.replicas() if h.replica_id == replica_id), None)
        addr = handle.address if handle is not None else None
        if addr is None:
            raise NoReplicaAvailable(f"replica {replica_id} is not addressable")
        body = json.dumps({"model": model}).encode("utf8")
        conn = http.client.HTTPConnection(addr[0], addr[1], timeout=FORWARD_TIMEOUT_S)
        try:
            conn.request("POST", "/admin/models/load", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = resp.read()
        finally:
            conn.close()
        if resp.status == 200 and handle is not None:
            with handle.lock:  # picks see the new host before the next probe
                handle.resident_models.setdefault(model, {})
        return resp.status, payload

    # -- fleet metrics -------------------------------------------------------
    def scrape_replica_metrics(self) -> List[Dict[str, Any]]:
        """GET ``/metrics`` of every ready replica, one thread each (a hung
        replica bounds the pass at one timeout); each snapshot is tagged
        ``replica_id``. A ready replica whose scrape failed is left out and
        counted in :attr:`scrape_failures`."""
        handles = [h for h in self.ready_handles() if h.address is not None]
        results: List[Optional[Dict[str, Any]]] = [None] * len(handles)

        def scrape(i: int, h: ReplicaHandle) -> None:
            addr = h.address
            if addr is None:
                return
            try:
                status, raw = self._get_aux(h, addr, "/metrics", PROBE_TIMEOUT_S)
                if status == 200:
                    snap = json.loads(raw)
                    if isinstance(snap, dict):
                        snap["replica_id"] = h.replica_id
                        results[i] = snap
            except (OSError, ValueError):
                pass

        if len(handles) == 1:
            scrape(0, handles[0])
        elif handles:
            threads = [threading.Thread(target=scrape, args=(i, h), daemon=True,
                                        name=f"scrape-replica-{h.replica_id}")
                       for i, h in enumerate(handles)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + PROBE_TIMEOUT_S + 1.0
            for t in threads:
                t.join(timeout=max(deadline - time.monotonic(), 0.0))
        # read the results once, past the deadline: a straggler landing later
        # is neither merged nor both merged and counted as failed
        final = list(results)
        for h, snap in zip(handles, final):
            if snap is None:
                with self._scrape_lock:
                    self.scrape_failures[h.replica_id] = (
                        self.scrape_failures.get(h.replica_id, 0) + 1)
                if self.tel is not None:
                    self.tel.scrape_failed(h.replica_id)
        return [snap for snap in final if snap is not None]

    def scrape_failure_stats(self) -> Dict[str, int]:
        with self._scrape_lock:
            return {str(k): v for k, v in sorted(self.scrape_failures.items())}

    def scrape_replica_exemplars(self) -> List[Dict[str, Any]]:
        """GET ``/admin/exemplars`` of every ready replica, in turn, each
        payload tagged ``replica_id``."""
        out: List[Dict[str, Any]] = []
        for h in self.ready_handles():
            addr = h.address
            if addr is None:
                continue
            try:
                status, raw = self._get_aux(h, addr, "/admin/exemplars", PROBE_TIMEOUT_S)
                if status == 200:
                    payload = json.loads(raw)
                    if isinstance(payload, dict):
                        payload["replica_id"] = h.replica_id
                        out.append(payload)
            except (OSError, ValueError):
                continue
        return out

    def fleet_metrics(self) -> Dict[str, Any]:
        """``/metrics``: the replicas' snapshots merged, the roster, the
        scrape failures, with a manifest the placement, with telemetry the
        router's snapshot and host sample, and the cache's ledger."""
        from ...training.telemetry import merge_serving_snapshots

        out: Dict[str, Any] = {"fleet": merge_serving_snapshots(self.scrape_replica_metrics())}
        out["replicas"] = [h.describe() for h in self.replicas()]
        out["scrape_failures"] = self.scrape_failure_stats()
        if self.registry is not None:
            out["placement"] = {str(rid): models
                                for rid, models in sorted(self.placement().items())}
            out["models"] = self.registry.names()
            out["default_model"] = self.registry.default_model
        if self.tel is not None:
            out["router"] = self.tel.snapshot()
            out["process"] = self.tel.hoststats.sample()
        if self.alerts is not None:
            out["alerts"] = self.alerts.summary()
        cache_stats = self.cache_stats()
        if cache_stats is not None:
            out["cache"] = cache_stats
        return out

    def prometheus_metrics(self) -> str:
        """``/metrics?format=prometheus``: each replica's series labelled
        ``replica_id`` (counters and buckets sum exactly across replicas),
        the fleet's window percentiles from the merged view (count-weighted
        mean and worst replica; per generation and per model), the router's
        own series under ``srt_router`` with its process family, the scrape
        failures per replica and the cache's counters."""
        from ...training.hoststats import add_process_family
        from ...training.prometheus import PromFamilies
        from ...training.telemetry import merge_serving_snapshots

        snaps = self.scrape_replica_metrics()
        merged = merge_serving_snapshots(snaps)
        fam = PromFamilies()
        for snap in snaps:
            labels = {"replica_id": snap.get("replica_id")}
            fam.add_snapshot(snap, prefix="srt_serving", labels=labels)
            gen = snap.get("generation")
            if gen is not None:
                fam.add("srt_serving_generation_id", "gauge", gen, labels)
        win = merged.get("slo_window")
        if isinstance(win, dict):
            for q in ("p50", "p95", "p99"):
                for suffix in ("", "_worst"):
                    fam.add("srt_fleet_request_latency_window_seconds", "gauge",
                            win.get(f"request_latency_{q}{suffix}"),
                            {"quantile": q.replace("p", "0."),
                             "aggregate": "worst_replica" if suffix else "count_weighted_mean"})
        by_gen = merged.get("by_generation")
        if isinstance(by_gen, dict):
            for gen_key, sub in sorted(by_gen.items()):
                sub_win = (sub or {}).get("slo_window")
                if isinstance(sub_win, dict):
                    fam.add("srt_fleet_generation_request_latency_window_seconds", "gauge",
                            sub_win.get("request_latency_p99"),
                            {"generation": gen_key, "quantile": "0.99"})
        by_model = merged.get("by_model")
        if isinstance(by_model, dict):
            for model_name, sub in sorted(by_model.items()):
                if not isinstance(sub, dict):
                    continue
                fam.add_snapshot(sub, prefix="srt_fleet_model", labels={"model": model_name})
                sub_win = sub.get("slo_window")
                if isinstance(sub_win, dict):
                    for q in ("p50", "p95", "p99"):
                        fam.add("srt_fleet_model_request_latency_window_seconds", "gauge",
                                sub_win.get(f"request_latency_{q}"),
                                {"model": model_name, "quantile": q.replace("p", "0.")})
        if self.tel is not None:
            tel_snap = self.tel.snapshot()
            if self.cache is not None:
                # the cache's ledger below is the srt_router_cache_* source
                (tel_snap.get("counters") or {}).pop("cache_hits", None)
            fam.add_snapshot(tel_snap, prefix="srt_router")
            # the router process's own family, unlabelled (the replicas'
            # are on their own endpoints)
            add_process_family(fam, self.tel.hoststats.sample())
        for rid, n in self.scrape_failure_stats().items():
            fam.add("srt_router_replica_scrape_failures_total", "counter", n,
                    {"replica_id": rid})
        if self.alerts is not None:
            self.alerts.add_prometheus(fam)
        cache_stats = self.cache_stats()
        if cache_stats is not None:
            for key in ("cache_hits", "cache_misses", "cache_evictions",
                        "cache_stale_invalidations", "cache_flushes",
                        "cache_mixed_generation_bypasses", "cache_not_modified"):
                fam.add(f"srt_router_{key}_total", "counter", cache_stats.get(key))
            for key in ("cache_entries", "cache_bytes"):
                fam.add(f"srt_router_{key}", "gauge", cache_stats.get(key))
            for model_name, ledger in sorted((cache_stats.get("by_model") or {}).items()):
                for key in ("hits", "misses", "stale_invalidations", "not_modified"):
                    fam.add(f"srt_router_model_cache_{key}_total", "counter",
                            ledger.get(key), {"model": model_name})
        fam.add("srt_fleet_replicas", "gauge", merged.get("replicas"))
        return fam.render()

    # -- drain -----------------------------------------------------------
    def begin_drain(self) -> None:
        self.draining = True

    def wait_inflight(self, timeout_s: float) -> bool:
        """Block until every forwarded request has been answered (the
        replicas behind them are still up); False at the timeout."""
        deadline = time.monotonic() + float(timeout_s)
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(timeout=min(remaining, 0.1))
        return True


class RouterHTTPServer(ThreadingHTTPServer):
    """The router's listener: handler threads proxy bytes, the replicas do
    the JSON work."""

    daemon_threads = True

    def __init__(self, addr: Tuple[str, int], router: Router) -> None:
        super().__init__(addr, _RouterHandler)
        self.router = router


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    server: RouterHTTPServer

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _reply_bytes(self, status: int, body: bytes, request_id: Optional[str] = None,
                     content_type: str = "application/json",
                     etag: Optional[str] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        if request_id is not None:
            self.send_header(REQUEST_ID_HEADER, request_id)
        if etag is not None:
            self.send_header("ETag", etag)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _reply_not_modified(self, etag: Optional[str], request_id: Optional[str] = None) -> None:
        self.send_response(304)
        if etag:
            self.send_header("ETag", etag)
        if request_id is not None:
            self.send_header(REQUEST_ID_HEADER, request_id)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _reply(self, status: int, payload: Dict[str, Any],
               request_id: Optional[str] = None) -> None:
        self._reply_bytes(status, json.dumps(payload).encode("utf8"), request_id)

    def _reply_error(self, err: ServingError, request_id: Optional[str] = None) -> None:
        self._reply(err.http_status, {"error": err.code, "message": str(err)}, request_id)

    def do_GET(self) -> None:  # noqa: N802
        from ...training.telemetry import sanitize_json

        router = self.server.router
        parsed = urlparse(self.path)
        self.path = parsed.path
        if self.path == "/healthz":
            replicas = [h.describe() for h in router.replicas()]
            n_ready = sum(1 for r in replicas if r["ready"])
            payload: Dict[str, Any] = {"replicas": replicas}
            if router.tel is not None:
                payload["anchor"] = router.tel.trace.anchor()  # the trace clock's anchor
            if router.draining:
                self._reply(503, {"status": "draining", **payload})
            elif n_ready == 0:
                self._reply(503, {"status": "unavailable", "ready": 0, **payload})
            else:
                self._reply(200, {"status": "ok", "ready": n_ready, **payload})
        elif self.path == "/metrics":
            if (parse_qs(parsed.query).get("format") or [""])[0] == "prometheus":
                from ...training.prometheus import EXPOSITION_CONTENT_TYPE

                self._reply_bytes(200, router.prometheus_metrics().encode("utf8"),
                                  content_type=EXPOSITION_CONTENT_TYPE)
                return
            self._reply(200, sanitize_json(router.fleet_metrics()))
        elif self.path == "/trace":
            if router.tel is None:
                self._reply(200, {"trace": "disabled"})
                return
            payload = router.tel.trace.payload()
            payload["anchor"] = router.tel.trace.anchor()
            payload["role"] = "router"
            self._reply(200, sanitize_json(payload))
        elif self.path == "/admin/exemplars":
            self._reply(200, sanitize_json({"replicas": router.scrape_replica_exemplars()}))
        elif self.path == "/admin/alerts":
            if router.alerts is None:
                self._reply(200, {"alerts": "disabled"})
            else:
                self._reply(200, sanitize_json({"alerts": router.alerts.states()}))
        else:
            self._reply(404, {"error": "not_found", "message": self.path})

    def do_POST(self) -> None:  # noqa: N802
        router = self.server.router
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            self.close_connection = True
            self._reply(400, {"error": "bad_request",
                              "message": f"Content-Length must be 0..{MAX_BODY_BYTES}"})
            return
        body = self.rfile.read(length)  # read before any early answer
        registry = router.registry
        if self.path != "/v1/parse" and not (
                registry is not None and self.path.startswith("/v1/models/")):
            self._reply(404, {"error": "not_found", "message": self.path})
            return
        # the fleet-wide request id (a sane client id is kept): forwarded,
        # stamped on the route span and echoed whatever the outcome
        request_id = clean_request_id(self.headers.get(REQUEST_ID_HEADER)) or mint_request_id()
        if router.tel is not None:
            router.tel.request()
        model_name: Optional[str] = None
        explicit_model = False
        tenant: Optional[str] = None
        if registry is not None:
            try:
                model_name, explicit_model = registry.resolve_model(self.path, self.headers)
            except UnknownModel as e:
                if router.tel is not None:
                    router.tel.rejected(e, request_id)
                self._reply_error(e, request_id)
                return
            tenant = self.headers.get(TENANT_HEADER)
        if router.draining:
            err = Draining("fleet is draining; not admitting requests")
            if router.tel is not None:
                router.tel.rejected(err, request_id)
            self._reply_error(err, request_id)
            return
        # the texts are parsed only when the cache or length routing needs
        # them; otherwise the router forwards bytes
        inm = self.headers.get("If-None-Match")
        texts: Optional[List[str]] = None
        if router.cache is not None or router.length_routing:
            texts = self._texts_from(body)
        length_bucket = (_length_bucket_hint(texts)
                         if router.length_routing and texts is not None else None)
        cache_key: Optional[bytes] = None
        cache_gen: Any = GENERATION_MIXED
        if router.cache is not None:
            cache_gen = router.cache_generation(model_name)
            if texts is not None:
                if cache_gen is GENERATION_MIXED:
                    # ready replicas straddle generations: no hit, no store,
                    # and If-None-Match neither answered nor forwarded. An
                    # empty ready set is no rollout: not counted
                    if router.ready_handles():
                        router.count_cache_bypass()
                        inm = None
                else:
                    # converged: the ETag is known here, so a matching
                    # If-None-Match is a 304 without a forward
                    edge_etag = etag_for(texts, model_name or "", cache_gen)
                    if if_none_match_hit(inm, edge_etag):
                        router.cache.count_not_modified(model_name)
                        self._reply_not_modified(edge_etag, request_id)
                        return
                    cache_key = ResponseCache.key_for(texts, model=model_name or "")
                    hit = router.cache.get(cache_key, cache_gen, model=model_name)
                    if hit is not None:
                        if router.tel is not None:
                            router.tel.cache_hit()
                        self._reply_bytes(200, hit, request_id, etag=edge_etag)
                        return
        t0 = time.perf_counter()
        span_t0 = router.tel.now() if router.tel is not None else None
        try:
            status, payload, replica_id, fwd_etag = router.forward_parse(
                body, request_id=request_id, model=model_name, explicit_model=explicit_model,
                tenant=tenant, length_bucket=length_bucket, if_none_match=inm)
        except ServingError as e:
            if router.tel is not None:
                router.tel.rejected(e, request_id)
            self._reply_error(e, request_id)
            return
        if router.tel is not None:
            router.tel.routed(time.perf_counter() - t0, request_id=request_id, t0=span_t0,
                              replica_id=replica_id)
        if status == 200 and cache_key is not None:
            # stamped with the serving replica's probe-learned generation
            # (per model with a manifest); a swap between the last probe and
            # this forward can stamp a newer body with the older generation,
            # never an older body with the newer one
            serving = next((h for h in router.replicas() if h.replica_id == replica_id), None)
            if serving is None:
                gen = cache_gen
            elif model_name is not None:
                gen = (serving.resident_models.get(model_name) or {}).get("generation")
            else:
                gen = serving.generation
            router.cache.put(cache_key, payload, gen)
        if status == 304:
            # the replica's own conditional answer, counted in the one ledger
            if router.cache is not None:
                router.cache.count_not_modified(model_name)
            self._reply_not_modified(fwd_etag, request_id)
            return
        self._reply_bytes(status, payload, request_id, etag=fwd_etag)

    @staticmethod
    def _texts_from(body: bytes) -> Optional[List[str]]:
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            return None
        texts = payload.get("texts") if isinstance(payload, dict) else None
        if isinstance(texts, list) and texts and all(isinstance(t, str) for t in texts):
            return texts
        return None
