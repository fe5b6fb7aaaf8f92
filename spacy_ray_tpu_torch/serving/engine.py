"""Online inference engine: the pipeline's parameters on the device, a
precision overlay built once, a warmup sweep over the (B, T) padding
buckets, and ONE dispatch thread running coalesced batches through
``predict_docs`` (``spacy_ray_tpu/serving/engine.py`` without telemetry and
hot-swap).

One thread owns the device: the HTTP handler threads tokenize and wait, the
dispatch thread pins each batch to its (B, T) bucket, so live traffic only
ever meets shapes the warmup sweep already ran (on the card that sweep also
builds the kernels and settles the library's first-call work).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..training.batcher import DEFAULT_LENGTH_BUCKETS, bucket_batch_size, bucket_length
from .batcher import (
    DeadlineExceeded,
    Draining,
    DynamicBatcher,
    RequestTooLarge,
    ServeRequest,
    ServingError,
)
from .overlay import build_params_overlay

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

SERVING_DEFAULTS: Dict[str, Any] = {
    "max_batch_docs": 16,
    "max_queue_docs": 128,
    "timeout_s": 10.0,
    "max_doc_len": 64,
    "precision": "auto",
}


def warmup_buckets(max_batch_docs: int, max_doc_len: int,
                   length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS
                   ) -> List[Tuple[int, int]]:
    """Every (B, T) admission can produce: the batch buckets up to the
    padded max batch, and every length bucket a doc of 1..max_doc_len
    tokens can round to (including multiples of the top bucket)."""
    b_cap = bucket_batch_size(int(max_batch_docs))
    t_cap = bucket_length(int(max_doc_len), length_buckets)
    bs: List[int] = []
    b = 1
    while b <= b_cap:
        bs.append(bucket_batch_size(b))
        b = bucket_batch_size(b) + 1
    top = length_buckets[-1]
    ts = {t for t in length_buckets if t <= t_cap}
    ts.update(range(2 * top, t_cap + 1, top))
    ts.add(t_cap)
    return [(b, t) for b in bs for t in sorted(ts)]


class InferenceEngine:
    """Owns the pipeline, the served overlay and the dispatch thread."""

    def __init__(
        self,
        nlp,
        *,
        max_batch_docs: int = SERVING_DEFAULTS["max_batch_docs"],
        max_queue_docs: int = SERVING_DEFAULTS["max_queue_docs"],
        timeout_s: float = SERVING_DEFAULTS["timeout_s"],
        max_doc_len: int = SERVING_DEFAULTS["max_doc_len"],
        precision: str = SERVING_DEFAULTS["precision"],
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if nlp.model is None:
            raise ValueError(
                "serving needs an initialized or loaded pipeline "
                "(load a model directory with Pipeline.from_disk)"
            )
        self.nlp = nlp
        self.max_batch_docs = int(max_batch_docs)
        self.max_doc_len = int(max_doc_len)
        self.timeout_s = float(timeout_s)
        self.clock = clock
        self.batcher = DynamicBatcher(
            max_queue_docs=max_queue_docs, max_batch_docs=max_batch_docs, clock=clock
        )
        self.precision = precision
        self.overlay = build_params_overlay(nlp.params, precision, nlp.device)
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Condition(threading.Lock())
        self._active_batches = 0
        self._started = False
        self.ready = False
        self.warmed: List[Tuple[int, int]] = []

    # -- lifecycle ------------------------------------------------------
    def warmup(self) -> List[Tuple[int, int]]:
        """Run the forward once at every admissible (B, T) bucket, on the
        calling thread, before dispatch starts."""
        from ..pipeline.doc import Doc

        grid = warmup_buckets(self.max_batch_docs, self.max_doc_len,
                              self.nlp.length_buckets)
        for B, T in grid:
            docs = [Doc(words=["the"] * T) for _ in range(B)]
            self.nlp.predict_docs(docs, batch_size=B, overlay=self.overlay.overlay,
                                  pad_batch_to=B, pad_len_to=T)
        self.warmed = grid
        return grid

    def start(self, *, warmup: bool = True) -> "InferenceEngine":
        if self._started:
            return self
        if warmup:
            self.warmup()
        self._started = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="serve-dispatch", daemon=True)
        self._thread.start()
        self.ready = True
        return self

    # -- submission (handler threads) -----------------------------------
    def submit_texts(self, texts: Sequence[str], timeout_s: Optional[float] = None,
                     request_id: Optional[str] = None) -> ServeRequest:
        docs = [self.nlp.tokenizer(t) for t in texts]
        return self.submit_docs(docs, timeout_s=timeout_s, request_id=request_id)

    def submit_docs(self, docs: List[Any], timeout_s: Optional[float] = None,
                    request_id: Optional[str] = None) -> ServeRequest:
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        too_long = [i for i, d in enumerate(docs) if len(d) > self.max_doc_len]
        if too_long:
            raise RequestTooLarge(
                f"doc(s) {too_long} exceed max_doc_len={self.max_doc_len} "
                "tokens (the warmed shape cap) — split or truncate"
            )
        now = self.clock()
        req = ServeRequest(docs, deadline=now + timeout, enqueued_at=now,
                           request_id=request_id)
        self.batcher.submit(req)
        # +grace: the dispatch thread owns deadline accounting
        req.wait(timeout + 1.0)
        if not req.done:
            raise DeadlineExceeded(f"request not completed within {timeout:.3f}s")
        if req.error is not None:
            raise req.error
        return req  # docs annotated in place; batch_info says how it ran

    # -- dispatch (one thread) ------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            batch = self.batcher.next_batch()
            if batch is None:
                return
            if not batch:
                continue
            with self._idle:
                self._active_batches += 1
            try:
                self._run_batch(batch)
            finally:
                with self._idle:
                    self._active_batches -= 1
                    self._idle.notify_all()

    def _run_batch(self, requests: List[ServeRequest]) -> None:
        docs = [d for r in requests for d in r.docs]
        n = len(docs)
        B = bucket_batch_size(n)
        T = bucket_length(max((len(d) for d in docs), default=1), self.nlp.length_buckets)
        info = {"occupancy": n, "B": B, "T": T, "generation": None}
        try:
            self.nlp.predict_docs(docs, batch_size=n, overlay=self.overlay.overlay,
                                  pad_batch_to=B, pad_len_to=T)
        except Exception as e:  # a poisoned batch must not kill the server
            logger.exception("dispatch of %d docs (B=%d, T=%d) failed", n, B, T)
            err = ServingError(f"inference failed: {type(e).__name__}: {e}")
            for r in requests:
                r.batch_info = dict(info)
                r.complete(err)
            return
        for r in requests:
            r.batch_info = dict(info)
            r.complete()

    # -- drain / stop ----------------------------------------------------
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop admitting, finish every queued and in-flight batch, stop the
        dispatch thread. False when the queue did not drain in time."""
        self.batcher.begin_drain()
        deadline = time.monotonic() + float(timeout_s)
        with self._idle:
            while self.batcher.queue_depth() > 0 or self._active_batches > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(timeout=min(remaining, 0.1))
        self.stop()
        return True

    def stop(self) -> None:
        """Hard stop: close the batcher, fail what is still queued, join."""
        self.ready = False
        self.batcher.close()
        self.batcher.fail_all_queued(Draining("server shut down"))
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._started = False
