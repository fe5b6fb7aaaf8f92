"""HTTP front end for the serving engine (``spacy_ray_tpu/serving/server.py``
for one model): a stdlib ``ThreadingHTTPServer`` and graceful drain.

* ``POST /v1/parse`` — body ``{"texts": [...], "timeout_ms": optional}``;
  answers ``{"docs": [...], "batch": {"occupancy", "B", "T", "generation"}}``
  with docs in the JAX package's JSON schema. Typed errors map to 429 queue
  full, 503 draining or warming, 504 deadline, 413 too large, 400 malformed.
* ``GET /healthz`` — 200 with the engine's labels, the served generation
  and the kernel launch counts while serving; 503 while warming or
  draining.
* ``GET /metrics`` — the :class:`~.engine.ServingTelemetry` snapshot with
  ``generation`` and ``swap_count`` (``?format=prometheus``: the text
  exposition); with telemetry off, ``{"telemetry": "disabled", ...}`` and
  a comment-only exposition. ``GET /trace`` — the Chrome trace of the
  telemetry's buffer. ``GET /admin/exemplars`` — the p99-outlier ring.
* ``POST /admin/swap`` ``{"dir": <checkpoint dir>, "generation": optional}``
  — hot-swap to a checkpoint generation (the newest intact one by
  default); ``POST /admin/rollback`` — back to the previous resident. Both
  answer 403 unless ``dir`` is a configured swap directory (``serve
  --swap-dir``; with none configured the admin surface is off), 409
  ``swap_failed`` for a torn generation, a mismatched tree or nothing to
  roll back to; the server keeps serving.

SIGTERM/SIGINT stop admission, let every queued and in-flight batch finish,
close the listener and exit 0 (1 when the drain timed out).
"""

from __future__ import annotations

import json
import logging
import re
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..ops import _cuda
from ..pipeline.doc import doc_to_json
from ..training.checkpoint import CheckpointCorrupt, Checkpoints
from ..training.hoststats import add_process_family
from ..training.prometheus import EXPOSITION_CONTENT_TYPE, PromFamilies
from ..training.telemetry import sanitize_json
from .batcher import Draining, NotReady, ServingError, SwapFailed
from .engine import InferenceEngine, ServingTelemetry

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

MAX_BODY_BYTES = 8 << 20
REQUEST_ID_HEADER = "X-SRT-Request-Id"
# a client-supplied id is echoed back only if it is a sane header token
_REQUEST_ID_RE = re.compile(r"\A[A-Za-z0-9._:-]{1,128}\Z")


class ServingHTTPServer(ThreadingHTTPServer):
    """One handler thread per connection; handlers tokenize and block in
    ``engine.submit_texts`` — only the dispatch thread touches the device."""

    daemon_threads = True

    def __init__(self, addr: Tuple[str, int], engine: InferenceEngine,
                 telemetry: Optional[ServingTelemetry] = None) -> None:
        super().__init__(addr, _Handler)
        self.engine = engine
        self.tel = telemetry
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
               request_id: Optional[str] = None) -> None:
        body = json.dumps(payload).encode("utf8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        if request_id is not None:
            self.send_header(REQUEST_ID_HEADER, request_id)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

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
                "batching": "continuous",
                "precision": engine.overlay.resolved,
                "precision_label": engine.overlay.label,
                "generation": engine.serving_generation,
                "swap_count": engine.swap_count,
                "device": str(engine.nlp.device),
                "kernel_launches": _cuda.launch_counts(),
            }
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
        if self.path != "/v1/parse":
            self._reply(404, {"error": "not_found", "message": self.path})
            return
        request_id = self.headers.get(REQUEST_ID_HEADER)
        if request_id is not None and not _REQUEST_ID_RE.match(request_id):
            request_id = None
        engine = self.server.engine
        if self.server.draining:
            self._reply_error(Draining("server is draining"), request_id)
            return
        if not engine.ready:
            self._reply_error(NotReady("bucket warmup in progress; not admitting yet"),
                              request_id)
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
        try:
            req = engine.submit_texts(texts, timeout_s=timeout_s, request_id=request_id)
        except ServingError as e:
            self._reply_error(e, request_id)
            return
        t_ser = time.perf_counter()
        docs = [doc_to_json(d) for d in req.docs]
        serialize_s = time.perf_counter() - t_ser
        tel = self.server.tel
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
        self._reply(200, {"docs": docs, "batch": req.batch_info}, req.request_id)

    def _handle_admin(self, body: bytes) -> None:
        """``/admin/swap`` and ``/admin/rollback`` (module docstring). The
        staging runs on this handler thread while the dispatch thread keeps
        serving."""
        engine = self.server.engine
        if self.server.draining:
            self._reply_error(Draining("server is draining; no swaps"))
            return
        allowed = self.server.allowed_swap_dirs
        if not allowed:
            # rollback too: an ungated rollback on an open port would let any
            # client toggle the served generation
            self._reply(403, {"error": "forbidden",
                              "message": "admin swap/rollback is disabled: no swap "
                                         "directory configured (serve --swap-dir)"})
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
                                         "(configure with serve --swap-dir)"})
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
    """Lifecycle: start the listener, warm and start the engine, wait for a
    shutdown request (signal or :meth:`request_shutdown`), drain, exit."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 8080, *, telemetry: Optional[ServingTelemetry] = None,
                 drain_timeout_s: float = 30.0, swap_dirs: Optional[List[str]] = None
                 ) -> None:
        self.engine = engine
        self.tel = telemetry
        self.drain_timeout_s = float(drain_timeout_s)
        self.httpd = ServingHTTPServer((host, port), engine, telemetry)
        self.httpd.allowed_swap_dirs = [str(d) for d in (swap_dirs or [])]
        self._stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    def start(self) -> Tuple[str, int]:
        """Start the listener thread (the engine is started separately, so
        /healthz answers "warming" during the sweep)."""
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="serve-http", daemon=True,
        )
        self._serve_thread.start()
        return self.address

    def request_shutdown(self, signum: Optional[int] = None, frame: Any = None) -> None:
        """Signal-safe: flag writes and an Event only."""
        self.httpd.draining = True
        self._stop.set()

    def wait(self) -> int:
        """Block until shutdown is requested, then drain. 0 for a clean
        drain, 1 when in-flight work was abandoned at the timeout."""
        self._stop.wait()
        self.httpd.draining = True
        clean = self.engine.drain(self.drain_timeout_s)
        if not clean:
            logger.error("drain exceeded %.1fs — hard stop", self.drain_timeout_s)
            self.engine.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        return 0 if clean else 1

    def run(self) -> int:
        """The CLI path: signal handlers, listener, warmup, serve, drain."""
        previous = {s: signal.signal(s, self.request_shutdown)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            host, port = self.start()
            print(f"serving on http://{host}:{port}", flush=True)
            self.engine.start()
            print(f"warmed {len(self.engine.warmed)} (B, T) bucket programs; ready",
                  flush=True)
            rc = self.wait()
            print("drained; exiting 0" if rc == 0 else "drain timed out; exiting 1",
                  flush=True)
            return rc
        finally:
            for s, h in previous.items():
                signal.signal(s, h)
