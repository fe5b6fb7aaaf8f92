"""The live fleet controller: roll each new checkpoint generation across a
serving fleet, canary first, then promote or roll back on the guard's
verdict (``spacy_ray_tpu/serving/live/controller.py``).

It runs in the fleet's router process, which never touches the card: new
generations are found by the standard-library digest scan of
:func:`~.watcher.scan_intact_generations`, and each replica loads the
parameters itself behind its ``/admin/swap``. One rollout at a time::

    idle --(a new intact generation)--> canary
      the canary subset swapped through POST /admin/swap
      the router splits traffic by generation (canary_fraction)
      the guard watches the two sides' error rates and window p99
    --promote--> the rest swapped, the generation is current --> idle
    --rollback--> POST /admin/rollback to the canaries, stamp rejected --> idle

During a rollout the two sides are grouped by replica id, not by the
generation in the scraped metrics: the probe learns a swap up to one probe
interval late, and the counters' zero must be taken at the swap itself.

A 409 from ``/admin/swap`` (a torn generation on the replica's own read, a
tree that does not match) rejects the stamp for good; a transport error (a
replica restarting) aborts the attempt and the next poll retries. A rollout
without a verdict within ``verdict_timeout_s`` rolls back. While idle the
controller heals stragglers: a replica restarted from the model on disk
(generation None) is swapped to the fleet's current generation.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ...training.resilience import log_event
from .canary import CanaryGuard, GenerationStats
from .watcher import scan_intact_generations

__all__ = ["LiveFleetController"]

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

#: a replica's ``/admin/swap`` stages the generation before it answers
ADMIN_TIMEOUT_S = 120.0


def _admin_post(addr: Tuple[str, int], path: str, payload: Dict[str, Any],
                timeout_s: float) -> Tuple[int, Dict[str, Any]]:
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout_s)
    try:
        conn.request("POST", path, json.dumps(payload).encode("utf8"),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    try:
        parsed = json.loads(raw)
    except ValueError:
        parsed = {}
    return resp.status, parsed if isinstance(parsed, dict) else {}


class LiveFleetController:
    """Ticks through :meth:`poll_once` (tests call it directly) or a thread
    (:meth:`start`); ``router`` gives the ready replicas, the traffic split,
    the cache and the metrics scrape."""

    def __init__(self, ckpt_dir, router, *, canary_fraction: float = 0.25,
                 interval_s: float = 2.0, guard: Optional[CanaryGuard] = None,
                 verdict_timeout_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.ckpt_dir = Path(ckpt_dir)
        self.router = router
        self.canary_fraction = float(canary_fraction)
        self.interval_s = float(interval_s)
        self.guard = guard or CanaryGuard()
        self.verdict_timeout_s = float(verdict_timeout_s)
        self.clock = clock
        self.phase = "idle"  # "idle" | "canary"
        self.current: Optional[int] = None  # the fleet-wide generation
        self.target: Optional[int] = None  # the generation under canary
        self.canary_ids: List[int] = []
        self.rejected: Set[int] = set()  # stamps rolled back or refused
        self._verdict_deadline: Optional[float] = None
        self.rollouts = 0
        self.promotes = 0
        self.rollbacks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _side_stats(self, snaps: List[Dict[str, Any]], canary: bool) -> GenerationStats:
        from ...training.telemetry import merge_serving_snapshots

        ids = set(self.canary_ids)
        side = [s for s in snaps if (s.get("replica_id") in ids) == canary]
        return GenerationStats.from_merged(
            merge_serving_snapshots(side, _tag_generations=False),
            generation=self.target if canary else self.current)

    def poll_once(self) -> Optional[str]:
        """One observe-decide-act cycle: "canary", "promote", "rollback",
        "heal" or None (nothing happened)."""
        if self.phase == "canary":
            return self._guard_tick()
        # only the stamps a rollout could take are hashed, their parameters
        # alone (a swap reads nothing else): an idle tick hashes nothing
        candidates = scan_intact_generations(self.ckpt_dir, newer_than=self.current,
                                             skip=self.rejected, params_only=True)
        if candidates:
            return self._begin_rollout(max(candidates))
        return self._heal_stragglers()

    def _begin_rollout(self, stamp: int) -> Optional[str]:
        ready = self.router.ready_handles()
        if not ready:
            return None  # nobody to roll to; the next tick retries
        n = len(ready)
        k = max(1, int(round(self.canary_fraction * n))) if 0.0 < self.canary_fraction < 1.0 \
            else n
        if k >= n:
            # no baseline to guard against: every replica is swapped (one
            # replica, or the canary off); each flips between dispatches
            ok = True
            for h in ready:
                if not self._swap_one(h, stamp):
                    ok = False
            if not ok:
                return None  # partial: the next tick retries (a swap is idempotent)
            self.current = stamp
            self.rollouts += 1
            # the generation changed fleet-wide: stamped keys cannot hit the
            # old entries any more; the flush returns their bytes at once
            self.router.flush_cache(f"direct rollout to gen {stamp}")
            log_event("live-rollout-direct",
                      f"generation {stamp} rolled out to all {n} replica(s) "
                      "(no canary split configured/possible)",
                      level=logging.INFO, generation=stamp, replicas=n)
            return "promote"
        # the youngest replicas canary (the oldest hold the longest-proven baseline)
        canaries = sorted(ready, key=lambda h: -h.replica_id)[:k]
        snaps = self.router.scrape_replica_metrics()
        self.canary_ids = [h.replica_id for h in canaries]
        self.target = stamp
        baseline0 = self._side_stats(snaps, canary=False)
        canary0 = self._side_stats(snaps, canary=True)
        swapped: List[Any] = []
        for h in canaries:
            if self._swap_one(h, stamp):
                swapped.append(h)
                continue
            for done in swapped:  # abort: the flipped canaries go back
                self._rollback_one(done)
            self.canary_ids = []
            self.target = None
            return None
        self.guard.begin(baseline0, canary0)
        self._verdict_deadline = self.clock() + self.verdict_timeout_s
        self.phase = "canary"
        # the router splits for this rollout only: outside one, replicas on
        # two generations (a restarted one on the disk model) split nothing
        self.router.canary_generation = stamp
        self.rollouts += 1
        log_event("live-canary-start",
                  f"generation {stamp} canarying on replica(s) {self.canary_ids} ({k}/{n}; "
                  f"fraction {self.canary_fraction:.2f} of traffic)",
                  level=logging.INFO, generation=stamp, canary_ids=list(self.canary_ids),
                  replicas=n)
        return "canary"

    def _guard_tick(self) -> Optional[str]:
        stamp = self.target
        # every canary gone (scaled down, crashed): no evidence will come;
        # abort without rejecting the stamp, whose quality was never judged
        ids = set(self.canary_ids)
        if not any(h.replica_id in ids for h in self.router.ready_handles()):
            self._finish_rollout()
            log_event("live-canary-aborted",
                      f"every canary replica for generation {stamp} left the fleet "
                      "(scale-down or crash) — rollout aborted, stamp stays eligible for "
                      "a fresh canary", generation=stamp, canary_ids=sorted(ids))
            return None
        snaps = self.router.scrape_replica_metrics()
        verdict = self.guard.observe(self._side_stats(snaps, canary=False),
                                     self._side_stats(snaps, canary=True))
        if verdict is None and self._verdict_deadline is not None \
                and self.clock() >= self._verdict_deadline:
            verdict = "rollback"
            log_event("canary-verdict-timeout",
                      f"generation {stamp} produced no guard verdict within "
                      f"{self.verdict_timeout_s:.0f}s — rolling back (generations ship on "
                      "evidence, not silence)", generation=stamp)
        if verdict == "promote":
            return self._promote()
        if verdict == "rollback":
            return self._rollback()
        return None

    def _promote(self) -> str:
        stamp = self.target
        for h in self.router.ready_handles():
            if h.generation != stamp:
                self._swap_one(h, stamp)
        self.current = stamp
        self.promotes += 1
        # the fleet converged on stamp: the old generation's cache entries
        # cannot hit; the flush returns their bytes
        self.router.flush_cache(f"promoted gen {stamp}")
        self._finish_rollout()
        log_event("live-promote", f"generation {stamp} promoted fleet-wide",
                  level=logging.INFO, generation=stamp)
        return "promote"

    def _rollback(self) -> str:
        stamp = self.target
        ids = set(self.canary_ids)
        for h in self.router.ready_handles():
            if h.replica_id in ids:
                self._rollback_one(h)
        self.rejected.add(stamp)
        self.rollbacks += 1
        self._finish_rollout()
        log_event("live-rollback",
                  f"generation {stamp} rolled back off the canary set {sorted(ids)}; stamp "
                  "rejected until a newer one appears",
                  generation=stamp, canary_ids=sorted(ids))
        return "rollback"

    def _finish_rollout(self) -> None:
        self.phase = "idle"
        self.target = None
        self.canary_ids = []
        self._verdict_deadline = None
        self.router.canary_generation = None

    def _heal_stragglers(self) -> Optional[str]:
        """A replica restarted from the disk model (generation None) is
        brought to the fleet's generation, so the split stays two-sided
        only during rollouts."""
        if self.current is None:
            return None
        healed = False
        for h in self.router.ready_handles():
            if h.generation != self.current:
                healed = self._swap_one(h, self.current) or healed
        return "heal" if healed else None

    def _swap_one(self, handle, stamp: int) -> bool:
        addr = handle.address
        if addr is None:
            return False
        try:
            status, payload = _admin_post(addr, "/admin/swap",
                                          {"dir": str(self.ckpt_dir), "generation": int(stamp)},
                                          ADMIN_TIMEOUT_S)
        except OSError as e:
            log_event("live-swap-error",
                      f"replica {handle.replica_id}: /admin/swap unreachable ({e!r}) — will "
                      "retry", replica=handle.replica_id, generation=int(stamp))
            return False
        if status == 200:
            # the split and the straggler check read the handle: no wait for
            # the next probe
            with handle.lock:
                handle.generation = int(stamp)
            return True
        if status == 409:
            # the replica verified and refused (torn on its read, another
            # tree): final for this stamp
            self.rejected.add(int(stamp))
        log_event("live-swap-refused",
                  f"replica {handle.replica_id} refused swap to generation {stamp}: HTTP "
                  f"{status} {payload.get('message', '')}"
                  + (" — stamp rejected" if status == 409 else ""),
                  replica=handle.replica_id, generation=int(stamp), status=status)
        return False

    def _rollback_one(self, handle) -> bool:
        addr = handle.address
        if addr is None:
            return False
        try:
            status, payload = _admin_post(addr, "/admin/rollback", {}, ADMIN_TIMEOUT_S)
        except OSError:
            # a replica that died mid-rollout restarts from the disk model:
            # rolled back already
            return False
        if status == 200:
            gen = payload.get("generation")
            with handle.lock:
                handle.generation = gen if isinstance(gen, int) else None
            return True
        return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # the rollout loop must survive anything
                logger.exception("live fleet controller tick failed")
            self._stop.wait(self.interval_s)

    def start(self) -> "LiveFleetController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="live-controller")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
