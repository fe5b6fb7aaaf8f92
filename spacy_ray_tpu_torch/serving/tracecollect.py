"""Trace collection across processes: the Perfetto buffers of a serving
fleet's router and replicas (or of any endpoints with ``/trace``) merged
into one timeline file (``spacy_ray_tpu/serving/tracecollect.py``;
``telemetry collect-trace``).

Each process's :class:`~..training.telemetry.TraceBuffer` stamps events in
microseconds from its own origin on its own monotonic clock: exact within a
process, meaningless across two. The bridge is the clock anchor each
process gives on ``/healthz`` and ``/trace``, one simultaneous reading
``(origin, clock_now, unix_now)`` of the buffer's clock and the wall clock;
an event then lies at ``unix_now - (clock_now - (origin + ts/1e6))`` on the
wall clock. No clock sync, one exchange per process.

The merged file keeps one Chrome-trace ``pid`` per source process, with
``process_name`` metadata, so a request's spans (the router's ``route``,
the replica's ``request`` and ``serve_batch``, all with its
``request_id``) show as one hop across tracks.

A trainer fleet's workers (``--fleet-base-port N --workers K``) serve their
``/trace`` and anchor on their peer ports when their telemetry is on; an
endpoint that gives no trace (telemetry off) is skipped and named. Standard
library only; it runs anywhere.
"""

from __future__ import annotations

import http.client
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse

__all__ = [
    "merge_process_traces",
    "fetch_json",
    "fleet_worker_urls",
    "collect_fleet_traces",
    "write_merged_trace",
]


def fleet_worker_urls(base_port: int, workers: int, host: str = "127.0.0.1") -> List[str]:
    """The endpoints of a trainer fleet: worker k listens on ``base_port +
    k`` (no router to discover it through); ``collect-trace
    --fleet-base-port N --workers K`` expands through here."""
    if int(workers) <= 0:
        raise ValueError(f"workers must be positive, got {workers}")
    return [f"http://{host}:{int(base_port) + k}" for k in range(int(workers))]


def _anchor_offset_us(anchor: Optional[Dict[str, Any]]) -> Optional[float]:
    """Microseconds to add to an event's ``ts`` to put it on the unix
    timeline; None for a missing or malformed anchor (the process is skipped,
    not guessed)."""
    if not isinstance(anchor, dict):
        return None
    try:
        origin = float(anchor["origin"])
        clock_now = float(anchor["clock_now"])
        unix_now = float(anchor["unix_now"])
    except (KeyError, TypeError, ValueError):
        return None
    return (unix_now - clock_now + origin) * 1e6


def _timed(ev: Dict[str, Any]) -> bool:
    return ev.get("ph") != "M" and isinstance(ev.get("ts"), (int, float))


def merge_process_traces(processes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One Chrome-trace object from ``[{"name", "trace": {"traceEvents"},
    "anchor"}, ...]``: each source gets its ``pid`` (0.. in input order) and
    a ``process_name`` row; timestamps go onto one timeline whose zero is the
    earliest event of all. A source without a usable anchor is skipped and
    named in ``otherData.skipped``."""
    shifted: List[List[Dict[str, Any]]] = []
    skipped: List[str] = []
    merged_names: List[str] = []
    for proc in processes:
        name = str(proc.get("name") or f"process-{len(shifted)}")
        offset = _anchor_offset_us(proc.get("anchor"))
        events = list((proc.get("trace") or {}).get("traceEvents") or [])
        if offset is None:
            skipped.append(name)
            continue
        pid = len(shifted)
        out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": {"name": name}}]
        for ev in events:
            ev = dict(ev)
            ev["pid"] = pid
            if _timed(ev):
                ev["ts"] = float(ev["ts"]) + offset
            out.append(ev)
        shifted.append(out)
        merged_names.append(name)
    all_ts = [ev["ts"] for events in shifted for ev in events if _timed(ev)]
    t0 = min(all_ts) if all_ts else 0.0
    merged: List[Dict[str, Any]] = []
    for events in shifted:
        for ev in events:
            if _timed(ev):
                ev["ts"] = round(ev["ts"] - t0, 1)
            merged.append(ev)
    return {"traceEvents": merged, "displayTimeUnit": "ms",
            "otherData": {"merged_from": merged_names, "skipped": skipped,
                          "epoch_origin_us": t0}}


def fetch_json(base_url: str, path: str, timeout_s: float = 10.0) -> Tuple[int, Any]:
    """GET ``base_url + path`` and parse the JSON: (status, payload or None).
    A transport failure, a malformed port or a scheme other than http and
    https raises OSError."""
    parsed = urlparse(base_url if "//" in base_url else f"http://{base_url}")
    host = parsed.hostname or "127.0.0.1"
    scheme = parsed.scheme or "http"
    try:
        port = parsed.port
    except ValueError as e:
        raise OSError(f"invalid port in {base_url!r}: {e}")
    if scheme == "https":
        conn: http.client.HTTPConnection = http.client.HTTPSConnection(
            host, port or 443, timeout=timeout_s)
    elif scheme == "http":
        conn = http.client.HTTPConnection(host, port or 80, timeout=timeout_s)
    else:
        raise OSError(f"unsupported URL scheme {scheme!r} in {base_url!r}")
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
    except http.client.HTTPException as e:
        # a peer exiting mid-response raises HTTPException, not OSError: the
        # callers handle a gone endpoint as OSError
        raise OSError(f"HTTP exchange with {base_url!r} failed: {e}")
    finally:
        conn.close()
    try:
        return resp.status, json.loads(raw)
    except ValueError:
        return resp.status, None


def collect_fleet_traces(base_urls: List[str], *, discover: bool = True,
                         timeout_s: float = 10.0) -> Dict[str, Any]:
    """``/healthz`` (the anchor) and ``/trace`` of every endpoint, merged. An
    endpoint whose ``/healthz`` lists ``replicas`` (the fleet's router) has
    each of them collected too when ``discover`` is on. Endpoints that do
    not answer or give no trace (telemetry off) are named in
    ``otherData.skipped``."""
    # (name, url, the /healthz payload of discovery or None): each endpoint
    # costs one /healthz
    targets: List[Tuple[str, str, Optional[Dict[str, Any]]]] = []
    seen: set = set()
    for base in base_urls:
        if base in seen:
            continue
        seen.add(base)
        name, replicas = base, []
        try:
            _, health = fetch_json(base, "/healthz", timeout_s)
        except OSError:
            health = None
        if isinstance(health, dict):
            if isinstance(health.get("replicas"), list):
                name, replicas = f"router {base}", health["replicas"]
            elif health.get("role"):
                name = f"{health['role']} {base}"
            else:
                name = f"replica {base}"
        targets.append((name, base, health if isinstance(health, dict) else None))
        if discover:
            parsed = urlparse(base if "//" in base else f"http://{base}")
            for row in replicas:
                port = row.get("port")
                if not isinstance(port, int):
                    continue
                url = f"http://{row.get('host') or parsed.hostname or '127.0.0.1'}:{port}"
                if url not in seen:
                    seen.add(url)
                    targets.append((f"replica-{row.get('id', '?')} {url}", url, None))
    processes: List[Dict[str, Any]] = []
    unreachable: List[str] = []
    for name, base, health in targets:
        try:
            if health is None:
                _, raw_health = fetch_json(base, "/healthz", timeout_s)
                health = raw_health if isinstance(raw_health, dict) else None
            _, trace = fetch_json(base, "/trace", timeout_s)
        except OSError:
            unreachable.append(name)
            continue
        if not isinstance(trace, dict) or "traceEvents" not in trace:
            unreachable.append(name)
            continue
        anchor = trace.get("anchor")
        if not isinstance(anchor, dict) and health is not None:
            anchor = health.get("anchor")
        processes.append({"name": name, "trace": trace, "anchor": anchor})
    merged = merge_process_traces(processes)
    merged["otherData"]["skipped"] = sorted(set(merged["otherData"]["skipped"])
                                            | set(unreachable))
    return merged


def write_merged_trace(merged: Dict[str, Any], path: Path) -> Path:
    """Write atomically (a temporary file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(merged), encoding="utf8")
    tmp.replace(path)
    return path
