"""HTTP front end for the serving engine (``spacy_ray_tpu/serving/server.py``
for one model): a stdlib ``ThreadingHTTPServer`` and graceful drain.

* ``POST /v1/parse`` — body ``{"texts": [...], "timeout_ms": optional}``;
  answers ``{"docs": [...], "batch": {"occupancy", "B", "T", "generation"}}``
  with docs in the JAX package's JSON schema. Typed errors map to 429 queue
  full, 503 draining or warming, 504 deadline, 413 too large, 400 malformed.
* ``GET /healthz`` — 200 with the engine's labels and the kernel launch
  counts while serving; 503 while warming or draining.

SIGTERM/SIGINT stop admission, let every queued and in-flight batch finish,
close the listener and exit 0 (1 when the drain timed out).
"""

from __future__ import annotations

import json
import logging
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..ops import _cuda
from ..pipeline.doc import doc_to_json
from .batcher import Draining, NotReady, ServingError
from .engine import InferenceEngine

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

MAX_BODY_BYTES = 8 << 20
REQUEST_ID_HEADER = "X-SRT-Request-Id"
# a client-supplied id is echoed back only if it is a sane header token
_REQUEST_ID_RE = re.compile(r"\A[A-Za-z0-9._:-]{1,128}\Z")


class ServingHTTPServer(ThreadingHTTPServer):
    """One handler thread per connection; handlers tokenize and block in
    ``engine.submit_texts`` — only the dispatch thread touches the device."""

    daemon_threads = True

    def __init__(self, addr: Tuple[str, int], engine: InferenceEngine) -> None:
        super().__init__(addr, _Handler)
        self.engine = engine
        self.draining = False


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

    def do_GET(self) -> None:  # noqa: N802
        if self.path.split("?", 1)[0] != "/healthz":
            self._reply(404, {"error": "not_found", "message": self.path})
            return
        engine = self.server.engine
        if self.server.draining:
            self._reply(503, {"status": "draining"})
        elif not engine.ready:
            self._reply(503, {"status": "warming", "warmed_buckets": len(engine.warmed)})
        else:
            self._reply(200, {
                "status": "ok",
                "pipeline": list(engine.nlp.pipe_names),
                "warmed_buckets": len(engine.warmed),
                "max_batch_docs": engine.max_batch_docs,
                "max_doc_len": engine.max_doc_len,
                "batching": "continuous",
                "precision": engine.overlay.resolved,
                "precision_label": engine.overlay.label,
                "device": str(engine.nlp.device),
                "kernel_launches": _cuda.launch_counts(),
            })

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
        self._reply(200, {"docs": [doc_to_json(d) for d in req.docs],
                          "batch": req.batch_info}, req.request_id)


class Server:
    """Lifecycle: start the listener, warm and start the engine, wait for a
    shutdown request (signal or :meth:`request_shutdown`), drain, exit."""

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 8080, *, drain_timeout_s: float = 30.0) -> None:
        self.engine = engine
        self.drain_timeout_s = float(drain_timeout_s)
        self.httpd = ServingHTTPServer((host, port), engine)
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
