"""The LRU hot set of warmed engines one serving process holds
(``spacy_ray_tpu/serving/multimodel/residency.py``).

Up to ``capacity`` engines, each an ``InferenceEngine`` with its own
dispatch thread and warmed buckets, keyed by registry name:

* a request for a resident model takes one dict lookup under the manager's
  lock and is never blocked by another model's load;
* a request for a known model that is not resident loads it (pipeline from
  disk, warmup, the decode graphs' capture) outside the lock; concurrent
  requests for it wait on that one load;
* past capacity the least recently used engine that is not pinned is
  evicted: its queued batches finish (``drain``), then it stops and gives
  its device memory back (``release`` on the port's engine).

The manager makes no telemetry call; the clock is injectable.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..batcher import ServingError

logger = logging.getLogger("spacy_ray_tpu_torch.serving")


class ResidencyManager:
    """``engine_factory(spec) -> engine`` returns a started, warmed engine;
    the manager decides which engines exist. ``pinned`` models (normally
    the manifest's default) are never the LRU victim; when every other
    resident is pinned the hot set may exceed its capacity instead."""

    def __init__(self, registry: Any, engine_factory: Callable[[Any], Any], *,
                 capacity: int = 2, evict_drain_s: float = 5.0,
                 pinned: Optional[set] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.registry = registry
        self.engine_factory = engine_factory
        self.capacity = int(capacity)
        self.evict_drain_s = float(evict_drain_s)
        self.pinned = set(pinned or ())
        self.clock = clock
        self._lock = threading.Lock()
        self._engines: Dict[str, Any] = {}
        self._last_used: Dict[str, float] = {}
        self._loading: Dict[str, threading.Event] = {}
        self._load_errors: Dict[str, str] = {}
        self.loads = 0
        self.evictions = 0

    def adopt(self, name: str, engine: Any) -> None:
        """Register an engine built elsewhere (the server's default engine,
        which the server's lifecycle warms and starts) without counting a
        load."""
        self.registry.spec(name)
        with self._lock:
            self._engines[name] = engine
            self._last_used[name] = self.clock()

    # -- hot path --------------------------------------------------------
    def engine_for(self, name: str, *, load: bool = True) -> Any:
        """The engine serving ``name``, loaded into the hot set when absent
        (and ``load``). Raises ``UnknownModel`` for a name the registry does
        not know, ``ServingError`` when the model is not resident and
        ``load`` is False, or when its load failed (it stays non-resident; a
        later request tries again)."""
        spec = self.registry.spec(name)
        while True:
            with self._lock:
                engine = self._engines.get(name)
                if engine is not None:
                    self._last_used[name] = self.clock()
                    return engine
                if not load:
                    raise ServingError(f"model {name!r} is not resident on this replica")
                ev = self._loading.get(name)
                if ev is None:
                    ev = self._loading[name] = threading.Event()
                    break  # this thread leads the load
            ev.wait()
            with self._lock:
                err = self._load_errors.get(name)
            if err is not None:
                raise ServingError(f"model {name!r} failed to load: {err}")
        return self._load(name, spec, ev)

    def _load(self, name: str, spec: Any, ev: threading.Event) -> Any:
        """The leader's load, outside the lock; then insert and evict past
        capacity."""
        started = self.clock()
        try:
            engine = self.engine_factory(spec)
        except Exception as exc:
            with self._lock:
                self._load_errors[name] = str(exc)
                self._loading.pop(name, None)
            ev.set()
            logger.exception("model %r load failed", name)
            raise ServingError(f"model {name!r} failed to load: {exc}")
        victims: List[Any] = []
        with self._lock:
            self._engines[name] = engine
            self._last_used[name] = self.clock()
            self._load_errors.pop(name, None)
            self._loading.pop(name, None)
            self.loads += 1
            while len(self._engines) > self.capacity:
                lru = min((m for m in self._engines if m != name and m not in self.pinned),
                          key=lambda m: self._last_used[m], default=None)
                if lru is None:
                    break
                victims.append((lru, self._engines.pop(lru)))
                self._last_used.pop(lru, None)
                self.evictions += 1
        ev.set()
        for victim_name, victim in victims:
            self._retire(victim_name, victim)
        del victims
        logger.info("model %r resident after %.2fs (hot set: %s)",
                    name, self.clock() - started, self.resident())
        return engine

    def _retire(self, name: str, engine: Any) -> None:
        """Evict at the dispatch boundary: queued batches finish, then the
        engine stops and releases its device memory."""
        try:
            engine.drain(self.evict_drain_s)
        except Exception:
            logger.exception("evicting model %r: drain failed", name)
        try:
            release = getattr(engine, "release", None)
            (release or engine.stop)()
        except Exception:
            logger.exception("evicting model %r: stop failed", name)
        logger.info("model %r evicted (LRU)", name)

    # -- introspection ---------------------------------------------------
    def engines(self) -> Dict[str, Any]:
        """A point-in-time copy of the hot set."""
        with self._lock:
            return dict(self._engines)

    def resident(self) -> List[str]:
        """Resident model names, least to most recently used."""
        with self._lock:
            return sorted(self._engines, key=lambda m: self._last_used[m])

    def resident_info(self) -> Dict[str, Dict[str, Any]]:
        """Per-model generation, swap count and warm state (``/healthz``)."""
        with self._lock:
            engines = dict(self._engines)
        return {name: {"generation": getattr(engine, "serving_generation", None),
                       "swap_count": int(getattr(engine, "swap_count", 0) or 0),
                       "warmed": bool(getattr(engine, "warmed", False))}
                for name, engine in engines.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"resident": sorted(self._engines, key=lambda m: self._last_used[m]),
                    "capacity": self.capacity, "loads": self.loads,
                    "evictions": self.evictions,
                    "residency_swaps": self.loads + self.evictions}

    # -- lifecycle -------------------------------------------------------
    def begin_drain(self) -> None:
        with self._lock:
            engines = list(self._engines.items())
        for _, engine in engines:
            batcher = getattr(engine, "batcher", None)
            if batcher is not None:
                batcher.begin_drain()

    def stop_all(self, drain_timeout_s: Optional[float] = None) -> bool:
        """Drain and stop every resident engine (shutdown). True iff every
        drain finished in time."""
        timeout = self.evict_drain_s if drain_timeout_s is None else float(drain_timeout_s)
        with self._lock:
            engines = list(self._engines.items())
            self._engines.clear()
            self._last_used.clear()
        clean = True
        for name, engine in engines:
            try:
                if not engine.drain(timeout):
                    clean = False
            except Exception:
                logger.exception("stopping model %r: drain failed", name)
                clean = False
            try:
                engine.stop()
            except Exception:
                logger.exception("stopping model %r: stop failed", name)
                clean = False
        return clean
