"""Continuous micro-batching for online serving: a bounded request queue
from which the one dispatch thread takes whole requests into the next
device batch (``spacy_ray_tpu/serving/batcher.py`` in its default
``continuous`` mode).

* ``submit`` runs on the HTTP handler threads. It admits the request or
  raises a typed error the server maps to an HTTP status.
* ``next_batch`` runs on the dispatch thread. Whatever is queued the moment
  the thread is free fills the batch (up to ``max_batch_docs``) and is
  dispatched at once: the batch running on the device is the coalescing
  window. Requests whose deadline has passed are completed with
  ``DeadlineExceeded`` here, before they cost a dispatch.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional


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


class ServeRequest:
    """One admitted request: tokenized docs plus completion plumbing. The
    handler thread blocks on ``wait``; the dispatch thread annotates
    ``docs`` in place (or sets ``error``) and completes it.

    Stamps for telemetry (the engine's clock): ``started_at`` when batch
    assembly takes the request off the queue, ``dispatched_at`` when its
    batch is handed to the device, ``latency_s`` admission to completion
    (set by the submitting thread), ``device_s`` the predict time of its
    batch, results on the host (kept off ``batch_info``, so a response's
    body depends only on the parameters and the texts)."""

    __slots__ = ("docs", "deadline", "enqueued_at", "_done", "error", "batch_info",
                 "request_id", "started_at", "dispatched_at", "latency_s", "device_s")

    def __init__(self, docs: List[Any], deadline: float, enqueued_at: float,
                 request_id: Optional[str] = None):
        self.docs = docs
        self.deadline = float(deadline)
        self.enqueued_at = float(enqueued_at)
        self.request_id = request_id or uuid.uuid4().hex[:16]
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
    """Bounded queue + continuous batch assembly. Occupancy is counted in
    docs, since docs are what fill a padded device batch."""

    def __init__(self, *, max_queue_docs: int = 128, max_batch_docs: int = 16,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_batch_docs < 1:
            raise ValueError("max_batch_docs must be >= 1")
        if max_queue_docs < max_batch_docs:
            raise ValueError(
                f"max_queue_docs ({max_queue_docs}) must be >= max_batch_docs "
                f"({max_batch_docs}) or a full batch could never be admitted"
            )
        self.max_queue_docs = int(max_queue_docs)
        self.max_batch_docs = int(max_batch_docs)
        self.clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: Deque[ServeRequest] = deque()
        self._queued_docs = 0
        self._draining = False
        self._closed = False

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
                raise Draining("server is draining; not admitting requests")
            if self._queued_docs + n > self.max_queue_docs:
                raise QueueFull(
                    f"queue holds {self._queued_docs} docs (limit {self.max_queue_docs})"
                )
            self._queue.append(request)
            self._queued_docs += n
            self._nonempty.notify()

    # -- consumer side (the one dispatch thread) ------------------------
    def queue_depth(self) -> int:
        with self._lock:
            return self._queued_docs

    def next_batch(self) -> Optional[List[ServeRequest]]:
        """Block for the next batch. None means closed and empty (the
        dispatch thread's exit signal); an empty list means every popped
        request had expired."""
        with self._lock:
            while not self._queue:
                if self._closed:
                    return None
                self._nonempty.wait(timeout=0.05)
            now = self.clock()
            batch: List[ServeRequest] = []
            have = 0
            while self._queue:
                head = self._queue[0]
                if head.deadline <= now:
                    self._queue.popleft()
                    self._queued_docs -= len(head.docs)
                    head.complete(DeadlineExceeded(
                        f"deadline passed {now - head.deadline:.3f}s before dispatch "
                        f"(queued {now - head.enqueued_at:.3f}s)"
                    ))
                    continue
                if have + len(head.docs) > self.max_batch_docs:
                    break  # whole requests only
                self._queue.popleft()
                self._queued_docs -= len(head.docs)
                head.started_at = now
                batch.append(head)
                have += len(head.docs)
            return batch

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

    def fail_all_queued(self, error: ServingError) -> None:
        """Complete every queued request with ``error`` (hard stop)."""
        with self._lock:
            while self._queue:
                self._queue.popleft().complete(error)
            self._queued_docs = 0
