"""Online inference engine: the pipeline's parameters on the device, a
precision overlay built once, a warmup sweep over the (B, T) padding
buckets, ONE dispatch thread running coalesced batches through
``predict_docs``, serving telemetry and the hot-swap of checkpoint
generations (``spacy_ray_tpu/serving/engine.py``).

One thread owns the device: the HTTP handler threads tokenize and wait, the
dispatch thread pins each batch to its (B, T) bucket, so live traffic only
ever meets shapes the warmup sweep already ran (on the card that sweep also
builds the kernels, settles the library's first-call work and captures the
heads' decode graphs).

Telemetry is a nullable :class:`ServingTelemetry` (the JAX package's
instruments, names and snapshot keys). When it is off the engine holds None
and makes no telemetry call. A batch's span and its requests' completion
are taken after ``predict_docs`` returns, which is after the annotations
(the results copied to the host) are written: on ``cuda`` the enqueue
returns long before the card finishes.

Hot-swap. The decode graphs read the heads' parameters at the addresses
they were captured with, so a flip that swapped references would leave
them serving the old generation. The port's flip therefore exchanges
VALUES: the candidate is staged off the dispatch thread (read, checked
against the resident tree, copied to the device on a side stream, its
overlay built), then, at a batch boundary, every live parameter and its
staged twin swap contents in place. The staged bank then holds the
displaced generation, which stays resident for :meth:`rollback` (the same
exchange, no load). Every graph, warmed program and overlay stays valid.
The exchange runs on the engine's own stage stream and waits for that
stream alone, so a swap of one engine does not wait for the batches of the
other engines of the process.

Several engines in one process (multi-model serving): every piece of the
engine's device work holds :data:`~..devices.DEVICE_GATE` shared, so
another engine's decode-graph capture never meets it. An engine evicted
from the hot set gives its device memory back with :meth:`release`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices import DEVICE_GATE
from ..models.core import param_paths
from ..training.batcher import DEFAULT_LENGTH_BUCKETS, bucket_batch_size, bucket_length
from ..training.checkpoint import flatten, unflatten
from .batcher import (
    DeadlineExceeded,
    Draining,
    DynamicBatcher,
    RequestTooLarge,
    ServeRequest,
    ServingError,
    SwapFailed,
)
from .overlay import OverlayResult, build_params_overlay

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

#: the serving knobs' defaults (the JAX package's): ``max_wait_s`` applies in
#: ``window`` batching only
SERVING_DEFAULTS: Dict[str, Any] = {
    "max_batch_docs": 16,
    "max_wait_s": 0.005,
    "max_queue_docs": 128,
    "timeout_s": 10.0,
    "max_doc_len": 64,
    "batching": "continuous",
    "precision": "auto",
    "slo_window_s": 30.0,
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


class ServingTelemetry:
    """Serving's SLO surface over the registry and trace buffer
    (``training/telemetry.py``): the request latency histogram (p50/p95/p99,
    and over the last ``slo_window_s`` seconds), queue and dispatch waits,
    batch occupancy, queue depth, request/doc/batch counters, one counter
    per typed reject, padding and real tokens, the swap instruments, a ring
    of p99-outlier exemplars, and trace spans per batch and request. The
    JAX package's ``ServingTelemetry``, instrument for instrument."""

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 slo_window_s: float = SERVING_DEFAULTS["slo_window_s"],
                 exemplar_capacity: int = 64) -> None:
        from ..training.hoststats import ProcessSampler
        from ..training.telemetry import (
            LATENCY_BUCKETS,
            OCCUPANCY_BUCKETS,
            MetricsRegistry,
            TraceBuffer,
        )

        self.registry = MetricsRegistry(clock=clock)
        self.trace = TraceBuffer(clock=clock, pid=0, max_events=100_000)
        self.hoststats = ProcessSampler(clock=clock)
        reg = self.registry
        self._latency = reg.histogram("request_latency_seconds", 2048,
                                      window_s=slo_window_s or None, buckets=LATENCY_BUCKETS)
        self._queue_wait = reg.histogram("queue_wait_seconds", 2048, buckets=LATENCY_BUCKETS)
        self._dispatch_wait = reg.histogram("dispatch_wait_seconds", 2048,
                                            buckets=LATENCY_BUCKETS)
        self._occupancy = reg.histogram("batch_occupancy", 1024, buckets=OCCUPANCY_BUCKETS)
        self._queue_depth = reg.gauge("queue_depth")
        self._last_occ = reg.gauge("last_batch_occupancy")
        self._requests = reg.counter("requests")
        self._docs = reg.counter("docs")
        self._batches = reg.counter("batches")
        self._pad_tokens = reg.counter("pad_tokens")
        self._real_tokens = reg.counter("real_tokens")
        self._not_modified = reg.counter("not_modified")
        self._rej_full = reg.counter("rejected_queue_full")
        self._rej_drain = reg.counter("rejected_draining")
        self._rej_quota = reg.counter("rejected_quota")
        self._deadline = reg.counter("deadline_exceeded")
        self._errors = reg.counter("errors")
        self._swaps = reg.counter("swaps")
        self._rollbacks = reg.counter("rollbacks")
        self._swap_total = reg.histogram("swap_seconds", 256)
        self._swap_stage = reg.histogram("swap_stage_seconds", 256)
        self._swap_flip = reg.histogram("swap_flip_seconds", 256)
        self._generation = reg.gauge("serving_generation")
        self._exemplars: "deque" = deque(maxlen=int(exemplar_capacity))
        self._exemplar_count = reg.counter("slow_exemplars")
        self._exemplar_lock = threading.Lock()
        self._exemplar_seen = 0
        self._exemplar_threshold: Optional[float] = None

    _EXEMPLAR_REFRESH = 64
    _EXEMPLAR_MIN_SAMPLES = 100

    def now(self) -> float:
        return self.trace.now()

    def request_admitted(self, n_docs: int, queue_depth: int) -> None:
        self._requests.inc()
        self._docs.inc(n_docs)
        self._queue_depth.set(queue_depth)

    def request_rejected(self, error: ServingError, request_id: Optional[str] = None) -> None:
        if isinstance(error, Draining):
            self._rej_drain.inc()
        elif isinstance(error, DeadlineExceeded):
            self._deadline.inc()
        elif error.code == "queue_full":
            self._rej_full.inc()
        elif error.code == "quota_exceeded":
            self._rej_quota.inc()
        else:
            self._errors.inc()
        args = {"error": str(error)}
        if request_id is not None:
            args["request_id"] = request_id
        self.trace.add_instant(f"reject:{error.code}", cat="serve", args=args)

    def request_completed(self, *, latency_s: float, queue_wait_s: Optional[float],
                          t0: Optional[float], error: Optional[ServingError],
                          dispatch_wait_s: Optional[float] = None,
                          request_id: Optional[str] = None) -> None:
        if error is not None:
            self.request_rejected(error, request_id)
        else:
            self._latency.observe(latency_s)
            if queue_wait_s is not None:
                self._queue_wait.observe(queue_wait_s)
            if dispatch_wait_s is not None:
                self._dispatch_wait.observe(dispatch_wait_s)
        if t0 is not None:
            args: Dict[str, Any] = {"error": error.code if error is not None else None}
            if request_id is not None:
                args["request_id"] = request_id
            self.trace.add_span("request", t0, max(self.now() - t0, 0.0), cat="serve",
                                args=args)

    def conditional_hit(self) -> None:
        self._not_modified.inc()

    def batch_span(self, occupancy: int, B: int, T: int,
                   request_ids: Optional[List[str]] = None,
                   real_tokens: Optional[int] = None):
        self._batches.inc()
        self._occupancy.observe(occupancy)
        self._last_occ.set(occupancy)
        if real_tokens is not None:
            self._real_tokens.inc(real_tokens)
            self._pad_tokens.inc(max(B * T - real_tokens, 0))
        kwargs: Dict[str, Any] = {"occupancy": occupancy, "B": B, "T": T}
        if request_ids:
            kwargs["request_ids"] = request_ids
        return self.trace.span("serve_batch", cat="serve", **kwargs)

    def consider_exemplar(self, *, request_id: str, latency_s: float,
                          stages: Dict[str, Optional[float]], **meta: Any) -> bool:
        """Record the request in the exemplar ring iff its latency is
        strictly above the latency ring's p99 (refreshed every
        ``_EXEMPLAR_REFRESH`` completions, once ``_EXEMPLAR_MIN_SAMPLES``
        exist). ``stages``: queue_wait, dispatch_wait, device, serialize
        seconds (None: unobserved). True when recorded."""
        with self._exemplar_lock:
            self._exemplar_seen += 1
            if (self._exemplar_threshold is None
                    or self._exemplar_seen % self._EXEMPLAR_REFRESH == 0):
                if self._latency.count >= self._EXEMPLAR_MIN_SAMPLES:
                    self._exemplar_threshold = self._latency.percentile(0.99)
            threshold = self._exemplar_threshold
            if threshold is None or latency_s <= threshold:
                return False
            self._exemplars.append({
                "request_id": request_id,
                "latency_s": round(float(latency_s), 6),
                "t": round(self.now(), 6),
                "stages": {k: (round(float(v), 6) if v is not None else None)
                           for k, v in stages.items()},
                **meta,
            })
        self._exemplar_count.inc()
        return True

    def exemplars(self) -> Dict[str, Any]:
        """The ``/admin/exemplars`` payload: the ring (newest last) and the
        threshold that admitted its members."""
        with self._exemplar_lock:
            return {"threshold_s": self._exemplar_threshold, "count": len(self._exemplars),
                    "exemplars": list(self._exemplars)}

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(depth)

    def swap_completed(self, *, stage_s: float, flip_s: float, t0: Optional[float],
                       generation: Optional[int], rollback: bool = False) -> None:
        """One resident-generation flip: counters, the stage/flip/total
        histograms, the generation gauge, and the staging and flip spans."""
        self._swaps.inc()
        if rollback:
            self._rollbacks.inc()
        self._swap_stage.observe(stage_s)
        self._swap_flip.observe(flip_s)
        self._swap_total.observe(stage_s + flip_s)
        if generation is not None:
            self._generation.set(float(generation))
        if t0 is not None:
            args = {"generation": generation, "rollback": rollback}
            self.trace.add_span("swap_stage", t0, max(stage_s, 0.0), cat="serve", args=args)
            self.trace.add_span("swap_flip", t0 + stage_s, max(flip_s, 0.0), cat="serve",
                                args=args)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/metrics`` payload: the registry's snapshot, ``slo`` (the
        sample ring's percentiles), ``slo_window`` (the last
        ``slo_window_s`` seconds) and ``process`` (the host's view)."""
        snap = self.registry.snapshot()
        snap["slo"] = {
            "request_latency_p50": self._latency.percentile(0.50),
            "request_latency_p95": self._latency.percentile(0.95),
            "request_latency_p99": self._latency.percentile(0.99),
            "batch_occupancy_p50": self._occupancy.percentile(0.50),
            "dispatch_wait_p50": self._dispatch_wait.percentile(0.50),
            "dispatch_wait_p99": self._dispatch_wait.percentile(0.99),
        }
        win = self._latency.window_snapshot()
        if win is not None:
            snap["slo_window"] = {
                "window_s": win["window_s"],
                "samples": win["samples"],
                "request_latency_p50": win["p50"],
                "request_latency_p95": win["p95"],
                "request_latency_p99": win["p99"],
            }
        snap["process"] = self.hoststats.sample()
        return snap


def _spec(flat: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """path -> (shape, dtype name): the fingerprint a candidate tree must
    match for the warmed shapes and the captured graphs to keep applying."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat.items()}


class InferenceEngine:
    """Owns the pipeline, the served overlay and the dispatch thread.
    ``batching`` is the batcher's admission discipline (``max_wait_s`` its
    window); ``class_weights`` turns on weighted fair queuing over SLO
    classes (None: one FIFO)."""

    def __init__(
        self,
        nlp,
        *,
        max_batch_docs: int = SERVING_DEFAULTS["max_batch_docs"],
        max_wait_s: float = SERVING_DEFAULTS["max_wait_s"],
        max_queue_docs: int = SERVING_DEFAULTS["max_queue_docs"],
        timeout_s: float = SERVING_DEFAULTS["timeout_s"],
        max_doc_len: int = SERVING_DEFAULTS["max_doc_len"],
        batching: str = SERVING_DEFAULTS["batching"],
        precision: str = SERVING_DEFAULTS["precision"],
        telemetry: Optional[ServingTelemetry] = None,
        clock: Callable[[], float] = time.monotonic,
        class_weights: Optional[Dict[str, float]] = None,
    ) -> None:
        if nlp.model is None:
            raise ValueError(
                "serving needs an initialized or loaded pipeline "
                "(load a model directory with Pipeline.from_disk)"
            )
        self.nlp = nlp
        self._tokenizer = nlp.tokenizer  # outlives release(): a late request gets Draining
        self.max_batch_docs = int(max_batch_docs)
        self.max_doc_len = int(max_doc_len)
        self.timeout_s = float(timeout_s)
        self.tel = telemetry
        self.clock = clock
        self.batching = batching
        self.batcher = DynamicBatcher(
            max_queue_docs=max_queue_docs, max_batch_docs=max_batch_docs,
            max_wait_s=max_wait_s, mode=batching, clock=clock, class_weights=class_weights,
        )
        self.precision = precision
        with DEVICE_GATE.shared():
            self.overlay = build_params_overlay(nlp.params, precision, nlp.device)
            self._stage_stream = (torch.cuda.Stream(device=nlp.device)
                                  if nlp.device.type == "cuda" else None)
        # the live parameters (the tensors the models and the decode graphs
        # read) and their fingerprint; the generation they hold (None: the
        # model as loaded) and ONE previous resident kept staged for rollback
        self._live = param_paths(nlp.model)
        self._live_spec = _spec(self._live)
        self.serving_generation: Optional[int] = None
        self.swap_count = 0
        self._previous: Optional[Tuple[Optional[int], OverlayResult,
                                       Dict[str, torch.Tensor]]] = None
        self._swap_lock = threading.Lock()      # one swap or rollback at a time
        self._resident_lock = threading.Lock()  # held by a batch and by a flip
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Condition(threading.Lock())
        self._active_batches = 0
        self._started = False
        self.ready = False
        self.warmed: List[Tuple[int, int]] = []
        self.warmup_s: Optional[float] = None
        #: device bytes :meth:`release` gave back, and what stayed allocated
        self.released_bytes: Optional[int] = None
        self.allocated_after_release: Optional[int] = None

    # -- lifecycle ------------------------------------------------------
    def warmup(self) -> List[Tuple[int, int]]:
        """Run the forward once at every admissible (B, T) bucket, on the
        calling thread, before dispatch starts (on the card this captures
        the heads' decode graphs)."""
        from ..pipeline.doc import Doc

        t0 = time.perf_counter()
        grid = warmup_buckets(self.max_batch_docs, self.max_doc_len,
                              self.nlp.length_buckets)
        for B, T in grid:
            docs = [Doc(words=["the"] * T) for _ in range(B)]
            with DEVICE_GATE.shared():
                self.nlp.predict_docs(docs, batch_size=B, overlay=self.overlay.overlay,
                                      pad_batch_to=B, pad_len_to=T)
        self.warmed = grid
        self.warmup_s = time.perf_counter() - t0
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
                     request_id: Optional[str] = None, klass: str = "default"
                     ) -> ServeRequest:
        docs = [self._tokenizer(t) for t in texts]
        return self.submit_docs(docs, timeout_s=timeout_s, request_id=request_id, klass=klass)

    def submit_docs(self, docs: List[Any], timeout_s: Optional[float] = None,
                    request_id: Optional[str] = None, klass: str = "default"
                    ) -> ServeRequest:
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        too_long = [i for i, d in enumerate(docs) if len(d) > self.max_doc_len]
        if too_long:
            err: ServingError = RequestTooLarge(
                f"doc(s) {too_long} exceed max_doc_len={self.max_doc_len} "
                "tokens (the warmed shape cap) — split or truncate"
            )
            if self.tel is not None:
                self.tel.request_rejected(err, request_id)
            raise err
        now = self.clock()
        req = ServeRequest(docs, deadline=now + timeout, enqueued_at=now,
                           request_id=request_id, klass=klass)
        t0 = self.tel.now() if self.tel is not None else None
        try:
            self.batcher.submit(req)
        except ServingError as e:
            if self.tel is not None:
                self.tel.request_rejected(e, req.request_id)
            raise
        if self.tel is not None:
            self.tel.request_admitted(len(docs), self.batcher.queue_depth())
        # +grace: the dispatch thread owns deadline accounting
        req.wait(timeout + 1.0)
        req.latency_s = self.clock() - req.enqueued_at
        if not req.done:
            err = DeadlineExceeded(f"request not completed within {timeout:.3f}s")
            if self.tel is not None:
                self.tel.request_completed(latency_s=req.latency_s,
                                           queue_wait_s=self._since_enqueue(req.started_at, req),
                                           t0=t0, error=err, request_id=req.request_id)
            raise err
        if self.tel is not None:
            self.tel.request_completed(
                latency_s=req.latency_s, queue_wait_s=self._since_enqueue(req.started_at, req),
                t0=t0, error=req.error,
                dispatch_wait_s=self._since_enqueue(req.dispatched_at, req),
                request_id=req.request_id)
        if req.error is not None:
            raise req.error
        return req  # docs annotated in place; batch_info says how it ran

    @staticmethod
    def _since_enqueue(stamp: Optional[float], req: ServeRequest) -> Optional[float]:
        return None if stamp is None else stamp - req.enqueued_at

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
        # the dispatch boundary: the batch holds the resident lock from here
        # to its results on the host, so a flip lands between batches and no
        # batch mixes generations or carries another generation's stamp
        with self._resident_lock:
            overlay, generation = self.overlay.overlay, self.serving_generation
            dispatched_at = self.clock()
            for r in requests:
                r.dispatched_at = dispatched_at
            info = {"occupancy": n, "B": B, "T": T, "generation": generation}
            try:
                if self.tel is not None:
                    with self.tel.batch_span(n, B, T, [r.request_id for r in requests],
                                             real_tokens=sum(len(d) for d in docs)), \
                            DEVICE_GATE.shared():
                        self.nlp.predict_docs(docs, batch_size=n, overlay=overlay,
                                              pad_batch_to=B, pad_len_to=T)
                    self.tel.set_queue_depth(self.batcher.queue_depth())
                else:
                    with DEVICE_GATE.shared():
                        self.nlp.predict_docs(docs, batch_size=n, overlay=overlay,
                                              pad_batch_to=B, pad_len_to=T)
            except Exception as e:  # a poisoned batch must not kill the server
                logger.exception("dispatch of %d docs (B=%d, T=%d) failed", n, B, T)
                err = ServingError(f"inference failed: {type(e).__name__}: {e}")
                for r in requests:
                    r.batch_info = dict(info)
                    r.complete(err)
                return
        # predict_docs returned after writing the annotations: the results
        # were on the host, so this is the batch's device time as a caller
        # waits for it
        device_s = round(self.clock() - dispatched_at, 6)
        for r in requests:
            r.device_s = device_s
            r.batch_info = dict(info)
            r.complete()

    # -- hot-swap ---------------------------------------------------------
    def _stage(self, params: Dict[str, Any]) -> Tuple[OverlayResult, Dict[str, torch.Tensor]]:
        """Check the candidate against the resident tree, copy it to the
        device (a side stream on the card, so the dispatch thread's work is
        not queued behind it) and build its overlay, with the engine's
        precision knob. Raises :class:`SwapFailed` on any mismatch; the
        engine keeps serving what it served."""
        flat = flatten(params) if any(isinstance(v, dict) for v in params.values()) else params
        got = _spec({k: np.asarray(v) if not isinstance(v, torch.Tensor) else v
                     for k, v in flat.items()})
        if got != self._live_spec:
            want = self._live_spec
            missing = sorted(set(want) - set(got))[:4]
            extra = sorted(set(got) - set(want))[:4]
            changed = sorted(k for k in set(want) & set(got) if want[k] != got[k])[:4]
            raise SwapFailed(
                "candidate param tree does not match the resident one "
                f"(missing: {missing}, unexpected: {extra}, reshaped/retyped: {changed}) "
                f"— swap refused, still serving generation {self.serving_generation}")
        device = self.nlp.device
        with DEVICE_GATE.shared(), torch.no_grad(), self._on_stage_stream():
            bank = {k: (flat[k].to(device, copy=True) if isinstance(flat[k], torch.Tensor)
                        else torch.from_numpy(np.array(flat[k])).to(device))
                    for k in self._live}
            overlay = build_params_overlay(unflatten(bank), self.precision, device)
            if self._stage_stream is not None:
                self._stage_stream.synchronize()
        return overlay, bank

    def _on_stage_stream(self):
        return (torch.cuda.stream(self._stage_stream) if self._stage_stream is not None
                else nullcontext())

    def _exchange(self, bank: Dict[str, torch.Tensor]) -> None:
        """Swap the contents of every live parameter with its twin in
        ``bank``, in place (the live tensors keep their addresses). Runs
        under the resident lock, so no batch of this engine is in flight
        (each ends with its results on the host), on the stage stream, which
        it waits for before the next batch may read the parameters."""
        with DEVICE_GATE.shared(), torch.no_grad(), self._on_stage_stream():
            for k, live in self._live.items():
                other = bank[k]
                held = live.clone()
                live.copy_(other)
                other.copy_(held)
            if self._stage_stream is not None:
                self._stage_stream.synchronize()

    def swap_params(self, params: Dict[str, Any], generation: int) -> Dict[str, Any]:
        """Hot-swap the served parameters to ``params`` (a flat
        ``{path: array}`` or nested tree: a checkpoint generation's
        parameters). Staging runs on the calling thread while the dispatch
        thread keeps serving; the flip waits for the batch in flight and
        exchanges values in place. The displaced generation stays staged
        for :meth:`rollback`. Raises :class:`SwapFailed` on a tree that
        does not match."""
        t_wall = self.clock()
        t0 = self.tel.now() if self.tel is not None else None
        with self._swap_lock:
            self._check_resident()
            overlay, bank = self._stage(params)
            stage_s = self.clock() - t_wall
            t_wait = self.clock()
            with self._resident_lock:
                t_flip = self.clock()
                self._exchange(bank)
                prev = (self.serving_generation, self.overlay, bank)
                self.overlay = overlay
                self.serving_generation = int(generation)
                self.swap_count += 1
                self._previous = prev
                flip_s = self.clock() - t_flip
            wait_s = t_flip - t_wait
        if self.tel is not None:
            self.tel.swap_completed(stage_s=stage_s, flip_s=flip_s, t0=t0,
                                    generation=int(generation))
        logger.info("hot-swapped serving params to generation %s (from %s; staged %.1f ms, "
                    "flip %.3f ms; precision %s)", generation, prev[0],
                    stage_s * 1e3, flip_s * 1e3, overlay.label)
        return {"generation": int(generation), "previous_generation": prev[0],
                "swap_count": self.swap_count, "stage_s": stage_s, "flip_s": flip_s,
                "wait_s": wait_s, "precision_label": overlay.label}

    def rollback(self) -> Dict[str, Any]:
        """Roll back to the previous resident generation: its values are
        staged on the device and its overlay built, so this is the flip
        alone. The displaced generation becomes the previous one (rollback
        is its own inverse). Raises :class:`SwapFailed` without one."""
        t0 = self.tel.now() if self.tel is not None else None
        with self._swap_lock:
            self._check_resident()
            if self._previous is None:
                raise SwapFailed(
                    "no previous resident generation to roll back to "
                    f"(serving generation {self.serving_generation}, "
                    f"{self.swap_count} swap(s) so far)")
            t_wait = self.clock()
            with self._resident_lock:
                t_flip = self.clock()
                gen, overlay, bank = self._previous
                self._exchange(bank)
                displaced = (self.serving_generation, self.overlay, bank)
                self.overlay = overlay
                self.serving_generation = gen
                self.swap_count += 1
                self._previous = displaced
                flip_s = self.clock() - t_flip
            wait_s = t_flip - t_wait
        if self.tel is not None:
            self.tel.swap_completed(stage_s=0.0, flip_s=flip_s, t0=t0, generation=gen,
                                    rollback=True)
        logger.info("rolled serving params back to generation %s (from %s; flip %.3f ms)",
                    gen, displaced[0], flip_s * 1e3)
        return {"generation": gen, "displaced_generation": displaced[0],
                "swap_count": self.swap_count, "flip_s": flip_s, "wait_s": wait_s,
                "precision_label": self.overlay.label}

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

    def release(self) -> None:
        """Stop, then drop every device tensor the engine holds: the
        pipeline (its parameters and the decode graphs with their memory
        pools), the overlay, the staged rollback bank and the stage stream.
        It takes the swap and resident locks before the device gate, in the
        order a swap takes them, so a swap in progress ends first and a later
        one raises :class:`SwapFailed`. The drop and the garbage collection
        that frees the pipeline's reference cycles hold the gate exclusively,
        so that no capture is open while the tensors and graphs go and
        ``released_bytes`` (the allocated bytes given back) and
        ``allocated_after_release`` read the card quiescent. The allocator
        keeps the freed blocks cached for the other engines. A late request
        still tokenizes and gets ``Draining``."""
        import gc

        self.stop()
        with self._swap_lock, self._resident_lock:
            cuda = self.nlp is not None and self.nlp.device.type == "cuda"
            with DEVICE_GATE.exclusive():
                before = torch.cuda.memory_allocated() if cuda else 0
                self.nlp = None
                self._live = {}
                self._previous = None
                self.overlay = dataclasses.replace(self.overlay, overlay=None)
                self._stage_stream = None
                gc.collect()
                if cuda:
                    self.allocated_after_release = torch.cuda.memory_allocated()
                    self.released_bytes = before - self.allocated_after_release

    def _check_resident(self) -> None:
        if self.nlp is None:
            raise SwapFailed("the engine was evicted and released its parameters "
                             "— swap refused")
