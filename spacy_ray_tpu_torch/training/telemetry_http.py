"""The trainer's telemetry endpoint (``spacy_ray_tpu/training/telemetry_http.py``):
``/metrics`` (JSON, or Prometheus text with ``?format=prometheus``),
``/healthz`` (liveness and the clock anchor with which ``telemetry
collect-trace`` places the trainer's spans on a fleet's timeline),
``/trace`` (the live Chrome-trace buffer) and ``/admin/alerts`` (the alert
engine's per-rule states, or ``{"alerts": "disabled"}`` with
``[training] alerting = false``).

On with ``[training] metrics_port`` or ``train --metrics-port`` (0 = off),
and only with telemetry on: the server serves the :class:`~.telemetry.
Telemetry` it is given and is never built without one. Its handler threads
only read the registry snapshot, the trace payload and the alert states,
never the loop's state. The reply functions are shared with a trainer-fleet
worker's peer server (``fleet/peer.py``), which adds its ``worker`` label.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .telemetry import Telemetry, sanitize_json

__all__ = [
    "TelemetryHTTPServer",
    "metrics_reply",
    "trace_reply",
    "alerts_reply",
]

logger = logging.getLogger("spacy_ray_tpu_torch.training")

#: what this server's ``/healthz`` and ``/trace`` name the process
#: (``telemetry collect-trace`` titles its track with it)
ROLE = "trainer"


# -- reply builders: what /metrics, /trace and /admin/alerts serve ---------


def metrics_reply(tel: Any, fmt: str, *, labels: Optional[Dict[str, Any]] = None,
                  json_extra: Optional[Dict[str, Any]] = None) -> Tuple[bytes, str]:
    """``(body, content_type)`` of a trainer's ``/metrics``: the registry
    snapshot and the host sample (``srt_process_*``, one family across every
    role) as Prometheus text with ``labels`` on every family (a fleet
    worker's ``worker``), then the alert series; or as JSON with the sample
    under ``process``, ``json_extra`` merged in and the engine's summary
    under ``alerts``."""
    alerts = tel.alerts
    sampler = tel.hoststats
    if fmt == "prometheus":
        from .hoststats import add_process_family
        from .prometheus import EXPOSITION_CONTENT_TYPE, PromFamilies

        fam = PromFamilies()
        fam.add_snapshot(tel.registry.snapshot(), prefix="srt_training", labels=labels)
        add_process_family(fam, sampler.sample(), labels=labels)
        if alerts is not None:
            alerts.add_prometheus(fam)
        return fam.render().encode("utf8"), EXPOSITION_CONTENT_TYPE
    snap = tel.registry.snapshot()
    snap["process"] = sampler.sample()
    if json_extra:
        snap.update(json_extra)
    if alerts is not None:
        snap["alerts"] = alerts.summary()
    return json.dumps(sanitize_json(snap)).encode("utf8"), "application/json"


def trace_reply(tel: Any, role: str) -> Dict[str, Any]:
    """The live Chrome-trace payload + the clock anchor a cross-process
    collector needs to place it on a shared timeline, and the ``role``
    (``trainer``, ``fleet-worker``) its track is titled with."""
    payload = tel.trace.payload()
    payload["anchor"] = tel.trace.anchor()
    payload["role"] = role
    return payload


def alerts_reply(tel: Any) -> Dict[str, Any]:
    """``/admin/alerts``: every rule's state, firing first."""
    if tel.alerts is None:
        return {"alerts": "disabled"}
    return {"alerts": tel.alerts.states()}


class _TelemetryHTTPD(ThreadingHTTPServer):
    daemon_threads = True
    tel: Telemetry


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: _TelemetryHTTPD

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _reply_json(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(sanitize_json(payload)).encode("utf8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler naming)
        tel = self.server.tel
        parsed = urlparse(self.path)
        if parsed.path == "/healthz":
            self._reply_json(
                200,
                {
                    "status": "ok",
                    "role": ROLE,
                    "anchor": tel.trace.anchor(),
                },
            )
        elif parsed.path == "/metrics":
            fmt = (parse_qs(parsed.query).get("format") or [""])[0]
            body, content_type = metrics_reply(tel, fmt)
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif parsed.path == "/admin/alerts":
            self._reply_json(200, alerts_reply(tel))
        elif parsed.path == "/trace":
            self._reply_json(200, trace_reply(tel, ROLE))
        else:
            self._reply_json(
                404, {"error": "not_found", "message": parsed.path}
            )


class TelemetryHTTPServer:
    """Lifecycle wrapper: ``start()`` binds and serves on a daemon
    thread, ``stop()`` tears down. Constructed only when telemetry is on
    AND a port is configured."""

    def __init__(
        self,
        telemetry: Telemetry,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self.httpd = _TelemetryHTTPD((host, int(port)), _Handler)
        self.httpd.tel = telemetry
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="telemetry-http",
            daemon=True,
        )
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
