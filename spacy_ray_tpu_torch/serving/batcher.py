"""Micro-batching for online serving: a bounded request queue from which
the one dispatch thread takes whole requests into the next device batch
(``spacy_ray_tpu/serving/batcher.py``).

* ``submit`` runs on the HTTP handler threads. It admits the request or
  raises a typed error the server maps to an HTTP status.
* ``next_batch`` runs on the dispatch thread, under one of two admission
  disciplines (``mode``):

  - ``"continuous"`` (the default): whatever is queued the moment the
    thread is free fills the batch (up to ``max_batch_docs``) and is
    dispatched at once; the batch running on the device is the coalescing
    window.
  - ``"window"``: block for the first request, then coalesce follow-ups
    until ``max_batch_docs`` are in hand or ``max_wait_s`` has passed
    since the first; a request whose deadline passes inside the window is
    completed with ``DeadlineExceeded`` at its end.

  Requests whose deadline has passed are completed with
  ``DeadlineExceeded`` here, before they cost a dispatch.
* ``class_weights`` turns on weighted fair queuing over SLO classes: one
  queue per class, drained by deficit round robin, so that under
  saturation each class's share of dispatched docs follows its weight.
  Without it the batcher keeps its single FIFO.

The strong ETag of a ``/v1/parse`` response and the request-id helpers live
here too, as in the JAX package. The clock is injectable.
"""

from __future__ import annotations

import hashlib
import re
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

#: the header that carries a request's trace id in and out
REQUEST_ID_HEADER = "X-SRT-Request-Id"
# a client-supplied id is echoed back only if it is a sane header token
# (\Z, not $: "id\n" must not reach a response header)
_REQUEST_ID_RE = re.compile(r"\A[A-Za-z0-9._:-]{1,128}\Z")


def cache_key_for(texts: List[str], model: str = "") -> bytes:
    """Digest identifying a ``/v1/parse`` input (and model: the empty model
    is the single-model path)."""
    h = hashlib.sha256()
    if model:
        h.update(model.encode("utf8", "surrogatepass"))
        h.update(b"\x01")
    for t in texts:
        h.update(t.encode("utf8", "surrogatepass"))
        h.update(b"\x00")  # ["ab"] != ["a", "b"]
    return h.digest()


def etag_for(texts: List[str], model: str = "", generation: Optional[int] = None) -> str:
    """Strong, quoted ETag of a ``/v1/parse`` response: a response is a
    function of the texts, the model and the generation serving it, so the
    tag is known at admission."""
    h = hashlib.sha256(cache_key_for(texts, model))
    h.update(b"\x02")
    h.update(repr(generation).encode("utf8"))
    return '"' + h.hexdigest()[:32] + '"'


def if_none_match_hit(header: Optional[str], etag: str) -> bool:
    """Whether an ``If-None-Match`` header matches ``etag``: comma lists,
    ``*`` and weak comparison (a ``W/`` prefix still matches)."""
    if not header:
        return False
    for candidate in header.split(","):
        candidate = candidate.strip()
        if candidate == "*":
            return True
        if candidate.startswith("W/"):
            candidate = candidate[2:].strip()
        if candidate == etag:
            return True
    return False


def mint_request_id() -> str:
    return uuid.uuid4().hex[:16]


def clean_request_id(raw: Optional[str]) -> Optional[str]:
    """The client-supplied id if it is a sane header token, else None."""
    if isinstance(raw, str) and _REQUEST_ID_RE.match(raw):
        return raw
    return None


class ServingError(Exception):
    """Base of the typed serving errors; ``http_status`` is the status the
    HTTP front end answers with."""

    http_status = 500
    code = "internal"


class QueueFull(ServingError):
    http_status = 429
    code = "queue_full"


class Draining(ServingError):
    http_status = 503
    code = "draining"


class NotReady(ServingError):
    """The bucket warmup sweep has not finished."""

    http_status = 503
    code = "warming"


class DeadlineExceeded(ServingError):
    http_status = 504
    code = "deadline_exceeded"


class RequestTooLarge(ServingError):
    """More docs than ``max_batch_docs``, or a doc longer than the warmed
    shape cap."""

    http_status = 413
    code = "request_too_large"


class SwapFailed(ServingError):
    """A hot-swap or rollback could not be honored: the candidate generation
    is torn (``CheckpointCorrupt``), its tree does not match the resident
    one, or there is no previous resident to roll back to. The engine keeps
    serving the current generation."""

    http_status = 409
    code = "swap_failed"


class QuotaExceeded(ServingError):
    """A tenant's token bucket cannot cover the request: over the tenant's
    quota, apart from how full the queue is."""

    http_status = 429
    code = "quota_exceeded"


class UnknownModel(ServingError):
    """The request named a model the registry does not know (path segment
    or ``X-SRT-Model``): a 404, never the default model under that name."""

    http_status = 404
    code = "unknown_model"


class ServeRequest:
    """One admitted request: tokenized docs plus completion plumbing. The
    handler thread blocks on ``wait``; the dispatch thread annotates
    ``docs`` in place (or sets ``error``) and completes it. ``klass`` is
    the SLO class whose queue it rides in a class-aware batcher.

    Stamps for telemetry (the engine's clock): ``started_at`` when batch
    assembly takes the request off the queue, ``dispatched_at`` when its
    batch is handed to the device, ``latency_s`` admission to completion
    (set by the submitting thread), ``device_s`` the predict time of its
    batch, results on the host (kept off ``batch_info``, so a response's
    body depends only on the parameters and the texts)."""

    __slots__ = ("docs", "deadline", "enqueued_at", "_done", "error", "batch_info",
                 "request_id", "started_at", "dispatched_at", "latency_s", "device_s",
                 "klass")

    def __init__(self, docs: List[Any], deadline: float, enqueued_at: float,
                 request_id: Optional[str] = None, klass: str = "default"):
        self.docs = docs
        self.deadline = float(deadline)
        self.enqueued_at = float(enqueued_at)
        self.klass = str(klass)
        self.request_id = request_id or mint_request_id()
        self.started_at: Optional[float] = None
        self.dispatched_at: Optional[float] = None
        self.latency_s: Optional[float] = None
        self.device_s: Optional[float] = None
        self._done = threading.Event()
        self.error: Optional[ServingError] = None
        self.batch_info: Dict[str, Any] = {}

    def complete(self, error: Optional[ServingError] = None) -> None:
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class DynamicBatcher:
    """Bounded queue + batch assembly. Occupancy is counted in docs, since
    docs are what fill a padded device batch. ``rejected_full``,
    ``rejected_draining``, ``expired`` and ``served_docs_by_class`` (the
    latter only with ``class_weights``) count what it shed and served.

    The mode defaults to ``"continuous"`` here and in the engine (the JAX
    class defaults to ``"window"``, its engine to continuous)."""

    MODES = ("window", "continuous")

    def __init__(self, *, max_queue_docs: int = 128, max_batch_docs: int = 16,
                 max_wait_s: float = 0.005, mode: str = "continuous",
                 clock: Callable[[], float] = time.monotonic,
                 class_weights: Optional[Dict[str, float]] = None) -> None:
        if max_batch_docs < 1:
            raise ValueError("max_batch_docs must be >= 1")
        if max_queue_docs < max_batch_docs:
            raise ValueError(
                f"max_queue_docs ({max_queue_docs}) must be >= max_batch_docs "
                f"({max_batch_docs}) or a full batch could never be admitted"
            )
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {list(self.MODES)}, got {mode!r}")
        self.max_queue_docs = int(max_queue_docs)
        self.max_batch_docs = int(max_batch_docs)
        self.max_wait_s = float(max_wait_s)
        self.mode = mode
        self.clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: Deque[ServeRequest] = deque()
        self._queued_docs = 0
        self._draining = False
        self._closed = False
        self.rejected_full = 0
        self.rejected_draining = 0
        self.expired = 0
        self.class_weights: Optional[Dict[str, float]] = None
        if class_weights is not None:
            if not class_weights:
                raise ValueError("class_weights must not be empty")
            for k, w in class_weights.items():
                if not (float(w) > 0):
                    raise ValueError(f"class weight must be > 0, got {k}={w!r}")
            self.class_weights = {k: float(w) for k, w in class_weights.items()}
            self._cqueues: Dict[str, Deque[ServeRequest]] = {
                k: deque() for k in self.class_weights}
            self._corder: List[str] = list(self.class_weights)
            self._deficit: Dict[str, float] = {k: 0.0 for k in self._corder}
            self._rr_idx = 0
            self._turn_open = False
            self._recompute_quantum()
        self.served_docs_by_class: Dict[str, int] = {}

    def _recompute_quantum(self) -> None:
        # one turn of the lightest class must afford the largest request
        assert self.class_weights is not None
        self._quantum = self.max_batch_docs / min(self.class_weights.values())

    def _class_queue(self, klass: str) -> Deque[ServeRequest]:
        """``klass``'s queue; an unknown class registers itself at weight 1.0."""
        assert self.class_weights is not None
        q = self._cqueues.get(klass)
        if q is None:
            self.class_weights[klass] = 1.0
            q = self._cqueues[klass] = deque()
            self._corder.append(klass)
            self._deficit[klass] = 0.0
            self._recompute_quantum()
        return q

    def _has_queued(self) -> bool:
        if self.class_weights is None:
            return bool(self._queue)
        return any(self._cqueues.values())

    # -- producer side (HTTP handler threads) --------------------------
    def submit(self, request: ServeRequest) -> None:
        n = len(request.docs)
        if n > self.max_batch_docs:
            raise RequestTooLarge(
                f"request carries {n} docs; max_batch_docs is "
                f"{self.max_batch_docs} — split the request"
            )
        with self._lock:
            if self._draining or self._closed:
                self.rejected_draining += 1
                raise Draining("server is draining; not admitting requests")
            if self._queued_docs + n > self.max_queue_docs:
                self.rejected_full += 1
                raise QueueFull(
                    f"queue holds {self._queued_docs} docs (limit {self.max_queue_docs})"
                )
            if self.class_weights is None:
                self._queue.append(request)
            else:
                self._class_queue(request.klass).append(request)
            self._queued_docs += n
            self._nonempty.notify()

    # -- consumer side (the one dispatch thread) ------------------------
    def queue_depth(self) -> int:
        with self._lock:
            return self._queued_docs

    def _expire(self, req: ServeRequest, now: float) -> None:
        self._queued_docs -= len(req.docs)
        self.expired += 1
        req.complete(DeadlineExceeded(
            f"deadline passed {now - req.deadline:.3f}s before dispatch "
            f"(queued {now - req.enqueued_at:.3f}s)"
        ))

    def _pop_ready(self, batch: List[ServeRequest], now: float) -> None:
        """Move queued requests into ``batch`` up to ``max_batch_docs``, whole
        requests only, completing expired ones. Caller holds the lock."""
        if self.class_weights is not None:
            self._pop_ready_wfq(batch, now)
            return
        have = sum(len(r.docs) for r in batch)
        while self._queue:
            head = self._queue[0]
            if head.deadline <= now:
                self._expire(self._queue.popleft(), now)
                continue
            if have + len(head.docs) > self.max_batch_docs:
                break
            self._queue.popleft()
            self._queued_docs -= len(head.docs)
            head.started_at = now
            batch.append(head)
            have += len(head.docs)

    def _expire_head(self, q: Deque[ServeRequest], now: float) -> None:
        while q and q[0].deadline <= now:
            self._expire(q.popleft(), now)

    def _pop_ready_wfq(self, batch: List[ServeRequest], now: float) -> None:
        """Deficit round robin over the class queues: a class's turn grants
        it ``weight * quantum`` docs of credit, spent on whole requests while
        credit and batch room last. The pointer and the deficits persist
        across batches (a turn cut short by a full batch resumes in the
        next one); an emptied queue forfeits its credit. Caller holds the
        lock."""
        have = sum(len(r.docs) for r in batch)
        idle_turns = 0
        while have < self.max_batch_docs and idle_turns < len(self._corder):
            k = self._corder[self._rr_idx % len(self._corder)]
            q = self._cqueues[k]
            self._expire_head(q, now)
            if not q:
                self._deficit[k] = 0.0
                self._rr_idx += 1
                self._turn_open = False
                idle_turns += 1
                continue
            if not self._turn_open:
                self._deficit[k] += self.class_weights[k] * self._quantum
                self._turn_open = True
            served = False
            while q:
                self._expire_head(q, now)
                if not q:
                    break
                cost = len(q[0].docs)
                if have + cost > self.max_batch_docs:
                    return  # the turn stays open for the next batch
                if cost > self._deficit[k]:
                    break
                head = q.popleft()
                self._queued_docs -= cost
                head.started_at = now
                batch.append(head)
                have += cost
                self._deficit[k] -= cost
                self.served_docs_by_class[k] = self.served_docs_by_class.get(k, 0) + cost
                served = True
            if not q:
                self._deficit[k] = 0.0
            self._rr_idx += 1
            self._turn_open = False
            idle_turns = 0 if served else idle_turns + 1

    def next_batch(self, poll_s: float = 0.05) -> Optional[List[ServeRequest]]:
        """Block for the next batch. None means closed and empty (the
        dispatch thread's exit signal); an empty list means every popped
        request had expired. ``poll_s`` bounds each wait on the condition."""
        with self._lock:
            while not self._has_queued():
                if self._closed:
                    return None
                self._nonempty.wait(timeout=poll_s)
            batch: List[ServeRequest] = []
            first_at = self.clock()
            self._pop_ready(batch, first_at)
            if self.mode == "continuous":
                return batch
            while sum(len(r.docs) for r in batch) < self.max_batch_docs and not self._closed:
                remaining = self.max_wait_s - (self.clock() - first_at)
                if remaining <= 0:
                    break
                self._nonempty.wait(timeout=min(remaining, poll_s))
                self._pop_ready(batch, self.clock())
            # deadlines that passed during the window
            now = self.clock()
            kept: List[ServeRequest] = []
            for r in batch:
                if r.deadline <= now:
                    self.expired += 1
                    r.complete(DeadlineExceeded(
                        f"deadline passed {now - r.deadline:.3f}s into the coalescing window"
                    ))
                else:
                    kept.append(r)
            return kept

    # -- drain / close --------------------------------------------------
    def begin_drain(self) -> None:
        """Stop admitting; queued requests still dispatch."""
        with self._lock:
            self._draining = True
            self._nonempty.notify_all()

    def close(self) -> None:
        with self._lock:
            self._draining = True
            self._closed = True
            self._nonempty.notify_all()

    def fail_all_queued(self, error: ServingError) -> int:
        """Complete every queued request with ``error`` (hard stop); returns
        how many were failed."""
        with self._lock:
            n = 0
            queues: List[Deque[ServeRequest]] = [self._queue]
            if self.class_weights is not None:
                queues.extend(self._cqueues.values())
            for q in queues:
                while q:
                    req = q.popleft()
                    self._queued_docs -= len(req.docs)
                    req.complete(error)
                    n += 1
            return n
