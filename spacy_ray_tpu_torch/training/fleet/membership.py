"""Elastic membership of a trainer fleet: leases, epochs and the survivors'
re-shard (``spacy_ray_tpu/training/fleet/membership.py``).

* :class:`LeaseTracker` — a peer is dead only when BOTH its lease expired
  (no successful ``/healthz`` for ``lease_s`` seconds) AND it missed
  ``miss_threshold`` probes in a row. ``/healthz`` is answered by each
  worker's HTTP thread, so a slow worker (a long step, an evaluation) keeps
  answering and is never evicted.
* :class:`Membership` — the fleet's truth: an epoch that only grows and the
  sorted ids of the active workers. Every eviction or admission bumps the
  epoch; pushes, pulls and generations carry it, and an owner discards (and
  counts, ``epoch_fenced``) a frame stamped with another epoch, so a worker
  still on an old membership cannot write into the new layout.
* :class:`RankedLayout` — the re-shard: the ownership rule of
  :class:`~.ownership.OwnershipLayout` over the survivor count, addressed by
  original worker id (the ids map to dense ranks inside).
* :class:`PeerBackoff` — a pull target that keeps failing costs one
  ``fleet-peer-unreachable`` event and a capped exponential backoff, not a
  ``quorum_wait_s`` every step.
* :class:`MembershipLedger` — the append-only ``fleet-membership.jsonl``
  of evictions, admissions and applies in the run directory.

Numpy and :mod:`.ownership` only. Left out with the pieces that use it: the
by-shape index of optimizer-state leaves.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .ownership import IndexT, OwnershipLayout

__all__ = ["LeaseTracker", "Membership", "MembershipLedger", "PeerBackoff", "RankedLayout",
           "read_membership_ledger"]


class LeaseTracker:
    """A lease and a count of consecutive missed probes per peer.

    The verdict needs both: ``lease_s`` bounds how long a peer may go
    unheard, ``miss_threshold`` asks that the silence be seen by that many
    failed probes in a row. Either alone evicts by accident (a long pause
    and one unlucky probe; a fast probe loop burning its misses inside a
    second). Thread-safe; ``clock`` can be replaced in tests.
    """

    def __init__(self, peers: Iterable[int], *, lease_s: float, miss_threshold: int = 3,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if float(lease_s) <= 0:
            raise ValueError(f"lease_s must be > 0, got {lease_s}")
        if int(miss_threshold) < 1:
            raise ValueError(f"miss_threshold must be >= 1, got {miss_threshold}")
        self.lease_s = float(lease_s)
        self.miss_threshold = int(miss_threshold)
        self.clock = clock
        self._lock = threading.Lock()
        now = self.clock()
        # a new peer starts with a full lease: the grace of its start
        self._last_ok: Dict[int, float] = {int(p): now for p in peers}
        self._misses: Dict[int, int] = {int(p): 0 for p in self._last_ok}

    def peers(self) -> List[int]:
        with self._lock:
            return sorted(self._last_ok)

    def add(self, peer: int) -> None:
        with self._lock:
            if int(peer) not in self._last_ok:
                self._last_ok[int(peer)] = self.clock()
                self._misses[int(peer)] = 0

    def remove(self, peer: int) -> None:
        with self._lock:
            self._last_ok.pop(int(peer), None)
            self._misses.pop(int(peer), None)

    def observe(self, peer: int, ok: bool) -> None:
        """Record one probe of ``peer``."""
        p = int(peer)
        with self._lock:
            if p not in self._last_ok:
                return
            if ok:
                self._last_ok[p] = self.clock()
                self._misses[p] = 0
            else:
                self._misses[p] += 1

    def dead(self, peer: int) -> bool:
        p = int(peer)
        with self._lock:
            last = self._last_ok.get(p)
            if last is None:
                return False
            return self.clock() - last > self.lease_s and self._misses[p] >= self.miss_threshold

    def expired(self) -> List[int]:
        """Every tracked peer past both gates."""
        with self._lock:
            now = self.clock()
            return sorted(p for p, last in self._last_ok.items()
                          if now - last > self.lease_s
                          and self._misses[p] >= self.miss_threshold)


class RankedLayout:
    """An :class:`~.ownership.OwnershipLayout` over the active workers,
    addressed by original worker id.

    The base layout is built for ``len(active)`` workers; ids are translated
    to dense ranks at every call. An id outside the active set owns nothing:
    its slices were re-owned at the epoch bump, which the epoch fence
    enforces on the wire.
    """

    def __init__(self, template: Any, active: Sequence[int]) -> None:
        self.active = tuple(sorted(int(w) for w in set(active)))
        if not self.active:
            raise ValueError("RankedLayout needs at least one active worker")
        self._rank: Dict[int, int] = {w: r for r, w in enumerate(self.active)}
        self.base = OwnershipLayout(template, len(self.active))
        self.n_workers = self.base.n_workers
        self.paths = self.base.paths
        self.shapes = self.base.shapes
        self.axes = self.base.axes

    def rank_of(self, worker: int) -> Optional[int]:
        return self._rank.get(int(worker))

    def _rank_or_raise(self, worker: int) -> int:
        r = self.rank_of(worker)
        if r is None:
            raise ValueError(f"worker {worker} is not in the active set")
        return r

    def owns(self, ordinal: int, worker: int) -> bool:
        r = self.rank_of(worker)
        return False if r is None else self.base.owns(ordinal, r)

    def index(self, ordinal: int, worker: int) -> Optional[IndexT]:
        return self.base.index(ordinal, self._rank_or_raise(worker))

    def key_index(self, key: str, worker: int) -> Optional[IndexT]:
        return self.base.key_index(key, self._rank_or_raise(worker))

    def index_for_shape(self, shape: Sequence[int], worker: int) -> Optional[IndexT]:
        return self.base.index_for_shape(shape, self._rank_or_raise(worker))

    slice_with = staticmethod(OwnershipLayout.slice_with)

    def owned_keys(self, worker: int) -> List[str]:
        r = self.rank_of(worker)
        return [] if r is None else self.base.owned_keys(r)

    def flat_slices(self, tree: Any, worker: int) -> Dict[str, np.ndarray]:
        r = self.rank_of(worker)
        return {} if r is None else self.base.flat_slices(tree, r)

    def slice_tree(self, tree: Any, worker: int) -> Dict[str, Any]:
        r = self.rank_of(worker)
        return {} if r is None else self.base.slice_tree(tree, r)

    def merge_flat(self, full: Any, worker: int, flat: Dict[str, np.ndarray], *,
                   add: bool = False) -> None:
        self.base.merge_flat(full, self._rank_or_raise(worker), flat, add=add)

    def signature(self) -> str:
        """The digest peers must agree on. It includes the active ids: two
        fleets at different memberships slice differently."""
        text = "active=" + ",".join(map(str, self.active)) + "|" + self.base.signature()
        return hashlib.sha256(text.encode("utf8")).hexdigest()[:16]


class Membership:
    """``(epoch, active ids)``, immutable: :meth:`evict` and :meth:`admit`
    return the next membership at ``epoch + 1``. The lead is the lowest
    active id, so when the lead dies the next-lowest survivor takes over the
    verdicts with no election."""

    def __init__(self, active: Sequence[int], epoch: int = 0) -> None:
        self.active: Tuple[int, ...] = tuple(sorted(int(w) for w in set(active)))
        if not self.active:
            raise ValueError("membership needs at least one active worker")
        self.epoch = int(epoch)
        if self.epoch < 0:
            raise ValueError(f"membership epoch must be >= 0, got {self.epoch}")

    @property
    def lead(self) -> int:
        return self.active[0]

    def __contains__(self, worker: int) -> bool:
        return int(worker) in self.active

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Membership) and self.epoch == other.epoch
                and self.active == other.active)

    def __repr__(self) -> str:
        return f"Membership(epoch={self.epoch}, active={list(self.active)})"

    def evict(self, worker: int) -> "Membership":
        if int(worker) not in self.active:
            raise ValueError(f"worker {worker} is not active")
        survivors = tuple(w for w in self.active if w != int(worker))
        if not survivors:
            raise ValueError("cannot evict the last active worker")
        return Membership(survivors, self.epoch + 1)

    def admit(self, worker: int) -> "Membership":
        if int(worker) in self.active:
            raise ValueError(f"worker {worker} is already active")
        return Membership(self.active + (int(worker),), self.epoch + 1)

    def layout(self, template: Any) -> RankedLayout:
        return RankedLayout(template, self.active)

    def to_wire(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "active": list(self.active), "lead": self.lead}

    @classmethod
    def from_wire(cls, payload: Any) -> "Membership":
        """A ``/membership`` body, validated: malformed input raises
        ValueError (a 400 at the server, never a handler traceback)."""
        if not isinstance(payload, dict):
            raise ValueError("membership payload must be a JSON object")
        epoch = payload.get("epoch")
        active = payload.get("active")
        if not isinstance(epoch, int) or isinstance(epoch, bool) or epoch < 0:
            raise ValueError(f"membership epoch must be an int >= 0, got {epoch!r}")
        if (not isinstance(active, (list, tuple)) or not active
                or not all(isinstance(w, int) and not isinstance(w, bool) and w >= 0
                           for w in active)):
            raise ValueError(f"membership active set must be a non-empty list of worker "
                             f"ids, got {active!r}")
        return cls(active, epoch)


class PeerBackoff:
    """A capped exponential backoff per unreachable peer. ``record_failure``
    returns True once per outage (the cue for the one
    ``fleet-peer-unreachable`` event); while a peer backs off, ``skip`` is
    True and the pull spends no wait on it."""

    def __init__(self, *, base_s: float = 1.0, cap_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.clock = clock
        self._delay: Dict[int, float] = {}
        self._until: Dict[int, float] = {}

    def record_failure(self, peer: int) -> bool:
        p = int(peer)
        first = p not in self._delay
        delay = self.base_s if first else min(self._delay[p] * 2.0, self.cap_s)
        self._delay[p] = delay
        self._until[p] = self.clock() + delay
        return first

    def record_success(self, peer: int) -> bool:
        """Clear ``peer``'s outage; True when one was in progress."""
        p = int(peer)
        was_down = p in self._delay
        self._delay.pop(p, None)
        self._until.pop(p, None)
        return was_down

    def skip(self, peer: int) -> bool:
        until = self._until.get(int(peer))
        return until is not None and self.clock() < until

    def current_delay(self, peer: int) -> float:
        return self._delay.get(int(peer), 0.0)


class MembershipLedger:
    """The append-only ``fleet-membership.jsonl``: one JSON row per event,
    written by the worker that saw it (the acting lead for a verdict, each
    worker for its own apply). A ledger without a path writes nothing."""

    def __init__(self, path: Optional[Path]) -> None:
        self.path = Path(path) if path is not None else None
        self._lock = threading.Lock()

    def append(self, event: str, **fields: Any) -> None:
        if self.path is None:
            return
        line = json.dumps({"ts": time.time(), "event": str(event), **fields},
                          sort_keys=True) + "\n"
        try:
            with self._lock:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.path, "a", encoding="utf8") as f:
                    f.write(line)
        except OSError:
            pass  # the ledger is evidence, never a reason to crash


def read_membership_ledger(path: Path) -> List[Dict[str, Any]]:
    """Every well-formed row of a ``fleet-membership.jsonl`` (a line being
    appended while it is read is skipped)."""
    out: List[Dict[str, Any]] = []
    try:
        text = Path(path).read_text(encoding="utf8")
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict):
            out.append(row)
    return out
