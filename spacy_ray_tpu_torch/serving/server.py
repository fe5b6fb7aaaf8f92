"""HTTP front end for the serving engine (``spacy_ray_tpu/serving/server.py``):
a stdlib ``ThreadingHTTPServer`` and graceful drain.

* ``POST /v1/parse`` — body ``{"texts": [...], "timeout_ms": optional}``;
  answers ``{"docs": [...], "batch": {"occupancy", "B", "T", "generation"}}``
  with docs in the JAX package's JSON schema and a strong ``ETag`` (the
  texts, the model and the generation serving it: known at admission, so an
  ``If-None-Match`` that matches is answered 304 without a dispatch). Typed
  errors map to 429 queue full or over quota, 503 draining or warming, 504
  deadline, 413 too large, 404 unknown model, 400 malformed.
* Multi-model serving (``serve --model-manifest``): ``POST
  /v1/models/<name>/parse`` or ``X-SRT-Model`` names the model (the
  manifest's default otherwise); ``X-SRT-Tenant`` is charged against the
  tenant's quota before the queue and picks its SLO class; the engine comes
  from the residency's hot set, loaded on first use. ``POST
  /admin/models/load`` ``{"model": <name>}`` loads a manifest model. Without
  a manifest none of this is built and the single model is served as
  before.
* ``GET /healthz`` — 200 with the engine's labels, the served generation,
  the kernel launch counts and the peak device memory while serving (with
  a manifest also the resident models, the residency's counts and the
  default model); 503 while warming or draining.
* ``GET /metrics`` — the :class:`~.engine.ServingTelemetry` snapshot with
  ``generation`` and ``swap_count``, with a manifest a ``models`` block of
  each resident engine's snapshot and the residency's counts
  (``?format=prometheus``: the text exposition, the models' series
  labelled ``model``); with an alert engine an ``alerts`` summary and the
  ``srt_alert_*`` families; with telemetry off, ``{"telemetry": "disabled",
  ...}`` and a comment-only exposition. ``GET /trace`` — the Chrome trace of
  the telemetry's buffer. ``GET /admin/exemplars`` — the p99-outlier ring.
  ``GET /admin/alerts`` — every rule's state (``{"alerts": "disabled"}``
  without an engine).
* ``POST /admin/swap`` ``{"dir": <checkpoint dir>, "generation": optional}``
  — hot-swap to a checkpoint generation (the newest intact one by
  default); ``POST /admin/rollback`` — back to the previous resident. With
  ``"model": <name>`` they act on that resident model's engine. Both
  answer 403 unless ``dir`` is a configured swap directory (``serve
  --swap-dir`` or ``--watch``; with none configured the admin surface is
  off), 409 ``swap_failed`` for a torn generation, a mismatched tree or
  nothing to roll back to; the server keeps serving.

A :class:`~.live.CheckpointWatcher` (``serve --watch``) starts once the
engine is warm and stops when the drain begins. With telemetry on and an
:class:`~..alerting.AlertEngine` or a :class:`~..incidents.FlightRecorder`
given, an observer thread snapshots the telemetry every
``observe_interval_s`` (the first tick at once), feeds the recorder's ring
and black box and evaluates the rules; it stops before the drain. SIGTERM/SIGINT stop
admission, let every queued and in-flight batch finish (every resident
engine's), close the listener and exit 0 (1 when the drain timed out).
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import torch

from ..ops import _cuda
from ..pipeline.doc import doc_to_json
from ..training.checkpoint import CheckpointCorrupt, Checkpoints
from ..training.hoststats import add_process_family
from ..training.prometheus import EXPOSITION_CONTENT_TYPE, PromFamilies
from ..training.telemetry import sanitize_json
from ..training.resilience import log_event
from .batcher import (
    REQUEST_ID_HEADER,
    Draining,
    NotReady,
    ServingError,
    SwapFailed,
    UnknownModel,
    clean_request_id,
    etag_for,
    if_none_match_hit,
)
from .engine import InferenceEngine, ServingTelemetry

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

MAX_BODY_BYTES = 8 << 20


class ServingHTTPServer(ThreadingHTTPServer):
    """One handler thread per connection; handlers tokenize and block in
    ``engine.submit_texts`` — only the dispatch thread touches the device."""

    daemon_threads = True

    def __init__(self, addr: Tuple[str, int], engine: InferenceEngine,
                 telemetry: Optional[ServingTelemetry] = None) -> None:
        super().__init__(addr, _Handler)
        self.engine = engine
        self.tel = telemetry
        #: multi-model serving (all None without a manifest): the registry
        #: resolves names, the residency holds the engines, the admission
        #: controller meters tenants
        self.registry = None
        self.residency = None
        self.admission = None
        #: the alert engine /admin/alerts and the /metrics alerts block read
        #: (None unless telemetry is on and one was built)
        self.alerts = None
        self.draining = False
        #: the checkpoint directories /admin/swap may load from; empty turns
        #: the admin surface off (403): a client-supplied path must never
        #: point the server at weights someone else controls
        self.allowed_swap_dirs: List[str] = []


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True
    server: ServingHTTPServer

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _reply(self, status: int, payload: Dict[str, Any],
               request_id: Optional[str] = None, etag: Optional[str] = None) -> None:
        body = json.dumps(payload).encode("utf8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        if request_id is not None:
            self.send_header(REQUEST_ID_HEADER, request_id)
        if etag is not None:
            self.send_header("ETag", etag)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_not_modified(self, etag: str, request_id: Optional[str] = None) -> None:
        """Body-less 304 (with Content-Length 0, for keep-alive clients)."""
        self.send_response(304)
        self.send_header("ETag", etag)
        if request_id is not None:
            self.send_header(REQUEST_ID_HEADER, request_id)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _reply_error(self, err: ServingError, request_id: Optional[str] = None) -> None:
        self._reply(err.http_status, {"error": err.code, "message": str(err)}, request_id)

    def _reply_text(self, status: int, text: str, content_type: str) -> None:
        body = text.encode("utf8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        parsed = urlparse(self.path)
        route = {"/metrics": lambda: self._get_metrics(parse_qs(parsed.query)),
                 "/trace": self._get_trace, "/admin/exemplars": self._get_exemplars,
                 "/admin/alerts": self._get_alerts,
                 "/healthz": self._get_healthz}.get(parsed.path)
        if route is None:
            self._reply(404, {"error": "not_found", "message": self.path})
        else:
            route()

    def _get_healthz(self) -> None:
        engine = self.server.engine
        if self.server.draining:
            self._reply(503, {"status": "draining"})
        elif not engine.ready:
            self._reply(503, {"status": "warming", "warmed_buckets": len(engine.warmed)})
        else:
            payload = {
                "status": "ok",
                "pipeline": list(engine.nlp.pipe_names),
                "warmed_buckets": len(engine.warmed),
                "max_batch_docs": engine.max_batch_docs,
                "max_doc_len": engine.max_doc_len,
                "batching": engine.batching,
                "precision": engine.overlay.resolved,
                "precision_label": engine.overlay.label,
                "generation": engine.serving_generation,
                "swap_count": engine.swap_count,
                "device": str(engine.nlp.device),
                "kernel_launches": _cuda.launch_counts(),
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(engine.nlp.device)
                                      if engine.nlp.device.type == "cuda" else None),
            }
            if self.server.residency is not None:
                payload["resident_models"] = self.server.residency.resident_info()
                payload["residency"] = self.server.residency.stats()
                if self.server.registry is not None:
                    payload["default_model"] = self.server.registry.default_model
            if self.server.tel is not None:
                payload["anchor"] = self.server.tel.trace.anchor()
            self._reply(200, payload)

    def _get_metrics(self, query: Dict[str, Any]) -> None:
        tel, engine = self.server.tel, self.server.engine
        prometheus = (query.get("format") or [""])[0] == "prometheus"
        if tel is None:
            if prometheus:
                self._reply_text(200, "# srt telemetry disabled\n", EXPOSITION_CONTENT_TYPE)
            else:
                self._reply(200, {"telemetry": "disabled",
                                  "generation": engine.serving_generation,
                                  "swap_count": engine.swap_count})
            return
        snap = tel.snapshot()
        snap["generation"] = engine.serving_generation
        snap["swap_count"] = engine.swap_count
        residency = self.server.residency
        if residency is not None:
            # each resident engine's own telemetry, keyed by model
            models: Dict[str, Any] = {}
            for name, eng in sorted(residency.engines().items()):
                if eng.tel is None:
                    continue
                msnap = eng.tel.snapshot()
                msnap["model"] = name
                msnap["generation"] = eng.serving_generation
                msnap["swap_count"] = eng.swap_count
                models[name] = msnap
            if models:
                snap["models"] = models
            snap["residency"] = residency.stats()
        alerts = self.server.alerts
        if alerts is not None:
            snap["alerts"] = alerts.summary()
        if not prometheus:
            self._reply(200, sanitize_json(snap))
            return
        fam = PromFamilies()
        fam.add_snapshot(snap, prefix="srt_serving")
        add_process_family(fam, snap.get("process"))
        if engine.serving_generation is not None:
            fam.add("srt_serving_generation_id", "gauge", engine.serving_generation)
        fam.add("srt_serving_swap_count", "gauge", engine.swap_count)
        win = snap.get("slo_window")
        if isinstance(win, dict):
            for q in ("p50", "p95", "p99"):
                fam.add("srt_serving_request_latency_window_seconds", "gauge",
                        win.get(f"request_latency_{q}"),
                        {"quantile": q.replace("p", "0."),
                         "window_s": int(win.get("window_s") or 0)})
        for name, msnap in sorted((snap.get("models") or {}).items()):
            fam.add_snapshot(msnap, prefix="srt_serving", labels={"model": name})
            mwin = msnap.get("slo_window")
            if isinstance(mwin, dict):
                for q in ("p50", "p95", "p99"):
                    fam.add("srt_serving_request_latency_window_seconds", "gauge",
                            mwin.get(f"request_latency_{q}"),
                            {"model": name, "quantile": q.replace("p", "0."),
                             "window_s": int(mwin.get("window_s") or 0)})
        if alerts is not None:
            alerts.add_prometheus(fam)
        self._reply_text(200, fam.render(), EXPOSITION_CONTENT_TYPE)

    def _get_trace(self) -> None:
        tel = self.server.tel
        if tel is None:
            self._reply(200, {"trace": "disabled"})
            return
        payload = tel.trace.payload()
        payload["anchor"] = tel.trace.anchor()
        payload["role"] = "replica"
        self._reply(200, sanitize_json(payload))

    def _get_exemplars(self) -> None:
        tel = self.server.tel
        if tel is None:
            self._reply(200, {"exemplars": "disabled"})
            return
        self._reply(200, sanitize_json(tel.exemplars()))

    def _get_alerts(self) -> None:
        alerts = self.server.alerts
        if alerts is None:
            self._reply(200, {"alerts": "disabled"})
            return
        self._reply(200, sanitize_json({"alerts": alerts.states()}))

    def do_POST(self) -> None:  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            self.close_connection = True  # body not consumed
            self._reply(400, {"error": "bad_request",
                              "message": f"Content-Length must be 0..{MAX_BODY_BYTES}"})
            return
        body = self.rfile.read(length)  # consume before any reply (keep-alive)
        if self.path in ("/admin/swap", "/admin/rollback"):
            self._handle_admin(body)
            return
        if self.path == "/admin/models/load":
            self._handle_model_load(body)
            return
        if self.path != "/v1/parse" and not (self.server.registry is not None
                                             and self.path.startswith("/v1/models/")):
            self._reply(404, {"error": "not_found", "message": self.path})
            return
        request_id = clean_request_id(self.headers.get(REQUEST_ID_HEADER))
        tel = self.server.tel
        if self.server.draining:
            self._reply_error(Draining("server is draining"), request_id)
            return
        if not self.server.engine.ready:
            self._reply_error(NotReady("bucket warmup in progress; not admitting yet"),
                              request_id)
            return
        # the model (path > X-SRT-Model > default); an unknown name is a 404
        model_name: Optional[str] = None
        if self.server.registry is not None:
            try:
                model_name, _ = self.server.registry.resolve_model(self.path, self.headers)
            except UnknownModel as e:
                if tel is not None:
                    tel.request_rejected(e, request_id)
                self._reply_error(e, request_id)
                return
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            self._reply(400, {"error": "bad_request", "message": "body is not JSON"},
                        request_id)
            return
        texts = payload.get("texts") if isinstance(payload, dict) else None
        if not isinstance(texts, list) or not texts or not all(
            isinstance(t, str) for t in texts
        ):
            self._reply(400, {
                "error": "bad_request",
                "message": 'body must be {"texts": [<non-empty list of strings>], '
                           '"timeout_ms": optional int}',
            }, request_id)
            return
        timeout_s = None
        if isinstance(payload.get("timeout_ms"), (int, float)):
            timeout_s = max(float(payload["timeout_ms"]) / 1000.0, 1e-3)
        # the tenant's quota, charged in docs before the queue, and its class
        klass = "default"
        if self.server.admission is not None:
            from .multimodel.registry import TENANT_HEADER

            try:
                klass = self.server.admission.admit(self.headers.get(TENANT_HEADER),
                                                    n_docs=len(texts))
            except ServingError as e:
                if tel is not None:
                    tel.request_rejected(e, request_id)
                self._reply_error(e, request_id)
                return
        # a named model's engine from the hot set (loaded on first use)
        engine = self.server.engine
        if self.server.residency is not None and model_name is not None:
            try:
                engine = self.server.residency.engine_for(model_name)
            except ServingError as e:
                if tel is not None:
                    tel.request_rejected(e, request_id)
                self._reply_error(e, request_id)
                return
        # the ETag is known here, before any inference: a match skips the
        # queue, the device and the serialization
        admission_etag = etag_for(texts, model_name or "", engine.serving_generation)
        if if_none_match_hit(self.headers.get("If-None-Match"), admission_etag):
            if engine.tel is not None:
                engine.tel.conditional_hit()
            self._reply_not_modified(admission_etag, request_id)
            return
        try:
            req = engine.submit_texts(texts, timeout_s=timeout_s, request_id=request_id,
                                      klass=klass)
        except ServingError as e:
            self._reply_error(e, request_id)
            return
        t_ser = time.perf_counter()
        docs = [doc_to_json(d) for d in req.docs]
        serialize_s = time.perf_counter() - t_ser
        # the exemplar judged against the serving engine's own traffic
        tel = engine.tel
        if tel is not None and req.latency_s is not None:
            # the per-stage breakdown of a p99 outlier
            def since(stamp):
                return None if stamp is None else stamp - req.enqueued_at

            tel.consider_exemplar(
                request_id=req.request_id, latency_s=req.latency_s,
                stages={"queue_wait": since(req.started_at),
                        "dispatch_wait": since(req.dispatched_at),
                        "device": req.device_s, "serialize": serialize_s},
                n_docs=len(req.docs), B=req.batch_info.get("B"), T=req.batch_info.get("T"),
                generation=req.batch_info.get("generation"))
        # the tag of the generation the batch ran on (a swap can land between
        # admission and dispatch)
        self._reply(200, {"docs": docs, "batch": req.batch_info}, req.request_id,
                    etag=etag_for(texts, model_name or "", req.batch_info.get("generation")))

    def _handle_model_load(self, body: bytes) -> None:
        """``/admin/models/load`` ``{"model": <name>}``: load a manifest model
        into the hot set on this handler thread (resident models keep
        serving). The loadable set is the manifest, so no allowlist."""
        if self.server.residency is None:
            self._reply(403, {"error": "forbidden",
                              "message": "multi-model serving is not configured "
                                         "(serve --model-manifest)"})
            return
        if self.server.draining:
            self._reply_error(Draining("server is draining; no loads"))
            return
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            self._reply(400, {"error": "bad_request", "message": "body is not JSON"})
            return
        name = payload.get("model") if isinstance(payload, dict) else None
        if not isinstance(name, str) or not name:
            self._reply(400, {"error": "bad_request",
                              "message": 'body must be {"model": <manifest model name>}'})
            return
        try:
            self.server.residency.engine_for(name)
        except ServingError as e:
            self._reply_error(e)
            return
        self._reply(200, {"model": name, "resident": self.server.residency.resident(),
                          "residency": self.server.residency.stats()})

    def _handle_admin(self, body: bytes) -> None:
        """``/admin/swap`` and ``/admin/rollback`` (module docstring). The
        staging runs on this handler thread while the dispatch thread keeps
        serving."""
        engine = self.server.engine
        if self.server.draining:
            self._reply_error(Draining("server is draining; no swaps"))
            return
        # {"model": <name>}: a resident model's engine (a swap never loads)
        model = None
        if body:
            try:
                parsed = json.loads(body)
                if isinstance(parsed, dict):
                    model = parsed.get("model")
            except ValueError:
                pass  # the swap path answers 400
        if isinstance(model, str) and model:
            if self.server.residency is None:
                self._reply(403, {"error": "forbidden",
                                  "message": "per-model swap needs multi-model serving "
                                             "(serve --model-manifest)"})
                return
            try:
                engine = self.server.residency.engine_for(model, load=False)
            except ServingError as e:
                self._reply_error(e)
                return
        allowed = self.server.allowed_swap_dirs
        if not allowed:
            # rollback too: an ungated rollback on an open port would let any
            # client toggle the served generation
            self._reply(403, {"error": "forbidden",
                              "message": "admin swap/rollback is disabled: no swap "
                                         "directory configured (serve --watch/--swap-dir)"})
            return
        if self.path == "/admin/rollback":
            try:
                self._reply(200, engine.rollback())
            except ServingError as e:
                self._reply_error(e)
            return
        if not engine.ready:
            self._reply_error(NotReady("bucket warmup in progress; not swapping yet"))
            return
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            self._reply(400, {"error": "bad_request", "message": "body is not JSON"})
            return
        ckpt_dir = payload.get("dir") if isinstance(payload, dict) else None
        generation = payload.get("generation") if isinstance(payload, dict) else None
        if (not isinstance(ckpt_dir, str) or not ckpt_dir
                or not (generation is None or isinstance(generation, int))):
            self._reply(400, {"error": "bad_request",
                              "message": 'body must be {"dir": <checkpoint dir>, '
                                         '"generation": optional int}'})
            return
        try:
            requested = Path(ckpt_dir).resolve()
        except OSError:
            requested = None
        if requested is None or not any(requested == Path(d).resolve() for d in allowed):
            self._reply(403, {"error": "forbidden",
                              "message": "dir is not an allowed swap directory "
                                         "(configure via serve --watch/--swap-dir)"})
            return
        try:
            ckpts = Checkpoints(requested)
            if generation is None:
                generation = ckpts.latest_intact_generation()
                if generation is None:
                    raise SwapFailed(f"no intact checkpoint generation in {ckpt_dir}")
            state = ckpts.load_generation_params(generation)
            result = engine.swap_params(state["params"], generation)
        except CheckpointCorrupt as e:
            self._reply_error(SwapFailed(str(e)))
            return
        except ServingError as e:
            self._reply_error(e)
            return
        self._reply(200, result)


class Server:
    """Lifecycle: start the listener, warm and start the engine (then the
    watcher, if any), wait for a shutdown request (signal or
    :meth:`request_shutdown`), drain, exit. ``registry``, ``residency`` and
    ``admission`` are multi-model serving's (all None without a manifest);
    the watcher's directory joins the swap allowlist. ``alerts`` and
    ``recorder`` (built only with telemetry on) are fed by the observer
    thread every ``observe_interval_s``."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 8080, *, telemetry: Optional[ServingTelemetry] = None,
                 drain_timeout_s: float = 30.0, swap_dirs: Optional[List[str]] = None,
                 watcher: Optional[Any] = None, registry: Optional[Any] = None,
                 residency: Optional[Any] = None, admission: Optional[Any] = None,
                 alerts: Optional[Any] = None, recorder: Optional[Any] = None,
                 observe_interval_s: float = 2.0) -> None:
        self.engine = engine
        self.tel = telemetry
        self.alerts = alerts
        self.recorder = recorder
        self.observe_interval_s = float(observe_interval_s)
        self._observer: Optional[threading.Thread] = None
        self._observer_stop = threading.Event()
        self.drain_timeout_s = float(drain_timeout_s)
        self.watcher = watcher
        self.registry = registry
        self.residency = residency
        self.admission = admission
        self.httpd = ServingHTTPServer((host, port), engine, telemetry)
        self.httpd.alerts = alerts
        self.httpd.registry = registry
        self.httpd.residency = residency
        self.httpd.admission = admission
        dirs = [str(d) for d in (swap_dirs or [])]
        if watcher is not None and str(watcher.ckpt_dir) not in dirs:
            dirs.append(str(watcher.ckpt_dir))
        self.httpd.allowed_swap_dirs = dirs
        self._stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    def start(self) -> Tuple[str, int]:
        """Start the listener thread (the engine is started separately, so
        /healthz answers "warming" during the sweep) and, with telemetry on
        and an alert engine or a recorder, the observer thread."""
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="serve-http", daemon=True,
        )
        self._serve_thread.start()
        if self.tel is not None and (self.alerts is not None or self.recorder is not None):
            self._observer = threading.Thread(target=self._observe_loop, name="serve-observer",
                                              daemon=True)
            self._observer.start()
        return self.address

    def observe_tick(self) -> None:
        """One observer tick: the telemetry's snapshot (with the served
        generation and swap count) into the recorder's ring, whose black box
        survives a SIGKILL, and through the alert rules."""
        snap = self.tel.snapshot()
        snap["generation"] = self.engine.serving_generation
        snap["swap_count"] = self.engine.swap_count
        if self.recorder is not None:
            self.recorder.record(snap)
        if self.alerts is not None:
            self.alerts.evaluate(snap)

    def _observe_loop(self) -> None:
        """The first tick at once, so that a replica that dies young still
        leaves a black box; a failing tick is logged and serving goes on."""
        while True:
            try:
                self.observe_tick()
            except Exception:
                logger.exception("observer tick failed")
            if self._observer_stop.wait(self.observe_interval_s):
                return

    def request_shutdown(self, signum: Optional[int] = None, frame: Any = None) -> None:
        """Signal-safe: flag writes and an Event only."""
        self.httpd.draining = True
        self._stop.set()

    def start_watcher(self) -> None:
        """Start the watcher (once the engine is warm: a swap must not race
        the warmup sweep)."""
        if self.watcher is not None and not self._stop.is_set():
            self.watcher.start()

    def wait(self) -> int:
        """Block until shutdown is requested, then drain. 0 for a clean
        drain, 1 when in-flight work was abandoned at the timeout."""
        self._stop.wait()
        self.httpd.draining = True
        self._observer_stop.set()
        if self._observer is not None:
            self._observer.join(timeout=5.0)
            self._observer = None
        if self.watcher is not None:
            self.watcher.stop()  # a swap mid-drain serves nobody
        self.engine.batcher.begin_drain()
        if self.residency is not None:
            self.residency.begin_drain()
        log_event("serve-drain", "shutdown requested — draining "
                  f"{self.engine.batcher.queue_depth()} queued doc(s)", level=logging.INFO)
        clean = self.engine.drain(self.drain_timeout_s)
        if not clean:
            log_event("serve-drain-timeout",
                      f"drain exceeded {self.drain_timeout_s:.1f}s — hard stop")
            self.engine.stop()
        if self.residency is not None and not self.residency.stop_all(self.drain_timeout_s):
            clean = False
        self.httpd.shutdown()
        self.httpd.server_close()
        return 0 if clean else 1

    def run(self, *, warmup: bool = True) -> int:
        """The CLI path: signal handlers, listener, warmup, watcher, serve,
        drain."""
        previous = {s: signal.signal(s, self.request_shutdown)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            host, port = self.start()
            print(f"serving on http://{host}:{port}", flush=True)
            self.engine.start(warmup=warmup)
            print(f"warmed {len(self.engine.warmed)} (B, T) bucket programs; ready",
                  flush=True)
            if self.watcher is not None and not self._stop.is_set():
                self.start_watcher()
                print(f"watching {self.watcher.ckpt_dir} for new checkpoint generations "
                      f"(every {self.watcher.interval_s:.1f}s)", flush=True)
            rc = self.wait()
            print("drained; exiting 0" if rc == 0 else "drain timed out; exiting 1",
                  flush=True)
            return rc
        finally:
            for s, h in previous.items():
                signal.signal(s, h)
