"""Flight recorder + incident bundles: the forensic layer that turns
"something fired at 03:12" into an on-disk record an operator can read
the next morning.

Three producers write the SAME bundle format (``incidents/<utc-stamp>-
<source>/``):

* :class:`FlightRecorder` — each process keeps a bounded ring of recent
  metric snapshots next to the telemetry objects it already holds (the
  ``TraceBuffer`` span ring, the slow-request exemplars, the alert
  states). When an alert fires or an anomaly detector trips, ``trip()``
  retroactively dumps the last N seconds into a bundle — the data was
  already in memory; the incident only decides it is worth keeping.
* the **black box**: a recorder given a ``blackbox_path`` additionally
  persists its payload to that one file (atomic replace) every tick, so
  a process that dies by SIGKILL — which by definition cannot dump —
  still leaves its final pre-crash state on disk for whoever supervises
  it.
* :func:`write_crash_bundle` — the fleet supervisor's view of a dead
  replica: exit code/signal, the stdout/stderr tail it was already
  draining, the effective replica argv, the generation and last
  ``/healthz`` payloads the router had learned, plus the replica's
  black box and the router's own flight payload — so the bundle's
  merged timeline crosses the process boundary.

``telemetry postmortem <dir>`` renders a bundle as a human-readable
report: the manifest, the exit status, the alert states at capture, a
metric digest of the flight ring, the stderr tail, and a merged
cross-process timeline built with the SAME clock-anchor merge the live
trace collector uses (:func:`~.serving.tracecollect.merge_process_traces`
— one merge implementation, live or post-hoc).

The port's copy of ``spacy_ray_tpu/incidents.py``: standard library only,
with the JAX package's bundle layout and names, so that either package's
``telemetry postmortem`` renders the other's bundles.
"""

from __future__ import annotations

import json
import os
import shutil
import signal as _signal
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FlightRecorder",
    "write_crash_bundle",
    "find_bundle",
    "load_bundle",
    "render_postmortem",
    "render_bundle",
    "merged_bundle_trace",
]


def _slug(s: str) -> str:
    out = "".join(c if c.isalnum() or c in "-_" else "-" for c in str(s))
    return out.strip("-") or "incident"


def _stamp(unix_t: float) -> str:
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(unix_t))


def _wall(unix_t: Optional[float]) -> str:
    if not isinstance(unix_t, (int, float)):
        return "-"
    frac = float(unix_t) - int(unix_t)
    return time.strftime(
        "%Y-%m-%d %H:%M:%S", time.gmtime(unix_t)
    ) + f".{int(frac * 1000):03d}Z"


def _atomic_write(path: Path, payload: Any) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(payload, default=str), encoding="utf8")
    tmp.replace(path)


_STAGING_LOCK = threading.Lock()
_STAGING_N = 0


def _publish_bundle(
    incident_dir: Path,
    unix_t: float,
    source: str,
    write: Callable[[Path], None],
) -> Path:
    """Build a bundle in a hidden staging dir, then RENAME it to its
    final ``<stamp>-<source>`` name: consumers polling the incidents
    root (a test, a CI artifact sweep, ``postmortem`` picking the
    newest) must never observe a half-written bundle — the dir appears
    with all of its files or not at all. The rename doubles as the
    collision check: two processes tripping the same fleet-wide source
    in the same second both publish (the loser retries with a suffix);
    a check-then-create would silently lose one side's dump."""
    global _STAGING_N
    incident_dir = Path(incident_dir)
    incident_dir.mkdir(parents=True, exist_ok=True)
    with _STAGING_LOCK:
        _STAGING_N += 1
        serial = _STAGING_N
    staging = incident_dir / f".staging-{os.getpid()}-{serial}"
    staging.mkdir()
    try:
        write(staging)
        base = f"{_stamp(unix_t)}-{_slug(source)}"
        n = 1
        while True:
            target = incident_dir / (base if n == 1 else f"{base}-{n}")
            try:
                staging.rename(target)
                return target
            except OSError:
                if target.exists():
                    n += 1
                    continue
                raise
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise


def exit_signal_name(rc: Optional[int]) -> Optional[str]:
    """Symbolic signal name for a negative Popen returncode (the
    subprocess convention: rc == -N means 'killed by signal N')."""
    if rc is None or rc >= 0:
        return None
    try:
        return _signal.Signals(-rc).name
    except ValueError:
        return f"signal {-rc}"


class FlightRecorder:
    """Bounded ring of metric snapshots + handles to the live telemetry
    objects, dumpable retroactively.

    ``record(snapshot)`` is the only periodic call (the owning process's
    observer ticker drives it); everything else happens on the rare trip
    path. Construction is gated on telemetry being enabled — with
    telemetry off the recorder does not exist and makes zero ring
    writes and zero incident I/O (guard-tested).
    """

    def __init__(
        self,
        *,
        incident_dir: Optional[Path] = None,
        blackbox_path: Optional[Path] = None,
        process_name: str = "process",
        capacity: int = 256,
        window_s: float = 300.0,
        min_trip_interval_s: float = 30.0,
        trace_tail_events: int = 5000,
        blackbox_interval_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        unix: Callable[[], float] = time.time,
    ) -> None:
        self.incident_dir = (
            Path(incident_dir) if incident_dir is not None else None
        )
        self.blackbox_path = (
            Path(blackbox_path) if blackbox_path is not None else None
        )
        self.process_name = str(process_name)
        self.window_s = float(window_s)
        self.min_trip_interval_s = float(min_trip_interval_s)
        self.trace_tail_events = int(trace_tail_events)
        self.blackbox_interval_s = float(blackbox_interval_s)
        self.clock = clock
        self.unix = unix
        self._last_blackbox: Optional[float] = None
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._trace: Optional[Any] = None
        self._alerts_fn: Optional[Callable[[], Any]] = None
        self._exemplars_fn: Optional[Callable[[], Any]] = None
        self._last_trip: Optional[float] = None
        self.records = 0
        self.trips = 0
        self.suppressed = 0

    def attach(
        self,
        *,
        trace: Optional[Any] = None,
        alerts_fn: Optional[Callable[[], Any]] = None,
        exemplars_fn: Optional[Callable[[], Any]] = None,
    ) -> "FlightRecorder":
        """Late-bind the live telemetry objects whose state a dump
        captures (the span ring, the alert states, the exemplars)."""
        if trace is not None:
            self._trace = trace
        if alerts_fn is not None:
            self._alerts_fn = alerts_fn
        if exemplars_fn is not None:
            self._exemplars_fn = exemplars_fn
        return self

    # -- the periodic tick ---------------------------------------------
    def record(self, snapshot: Dict[str, Any]) -> None:
        """Append one metric snapshot to the ring (pruning past the time
        window) and, when a black-box path is configured, persist the
        payload atomically — the SIGKILL-survivable copy. The ring feeds
        every tick; the black-box FILE rewrites at most every
        ``blackbox_interval_s`` (first record always persists): the
        serialization is the expensive part, and crash evidence needs to
        be recent, not tick-fresh — the copy may lag the crash by up to
        the interval."""
        now = self.clock()
        with self._lock:
            self._ring.append(
                {
                    "t": round(now, 3),
                    "unix_time": round(self.unix(), 3),
                    "snapshot": snapshot,
                }
            )
            cutoff = now - self.window_s
            while self._ring and self._ring[0]["t"] < cutoff:
                self._ring.popleft()
            self.records += 1
            persist = self.blackbox_path is not None and (
                self._last_blackbox is None
                or now - self._last_blackbox >= self.blackbox_interval_s
            )
            if persist:
                self._last_blackbox = now
        if persist:
            try:
                _atomic_write(self.blackbox_path, self.payload())
            except OSError:
                pass  # a full disk must not take the serving path down

    def alert_hook(self) -> Callable[[Any, Any], Any]:
        """The canonical ``AlertEngine(on_firing=...)`` callback: dump a
        bundle named after the firing rule. ONE definition, so the three
        production wirings (serve CLI, fleet, trainer telemetry) cannot
        drift on the trip-call contract."""

        def hook(rule: Any, st: Any) -> Any:
            return self.trip(
                f"alert-{rule.name}",
                st.detail or rule.name,
                severity=rule.severity,
                value=st.value,
            )

        return hook

    # -- payload / dump -------------------------------------------------
    def payload(self) -> Dict[str, Any]:
        """Everything a bundle keeps: the snapshot ring plus the live
        trace buffer (with its clock anchor, so the postmortem's merge
        can place these spans on a wall-clock timeline), the alert
        states, and the slow-request exemplars."""
        with self._lock:
            snaps = list(self._ring)
        out: Dict[str, Any] = {
            "process": self.process_name,
            "written_unix": round(self.unix(), 3),
            "window_s": self.window_s,
            "snapshots": snaps,
        }
        if self._trace is not None:
            trace = self._trace.payload()
            events = trace.get("traceEvents") or []
            if len(events) > self.trace_tail_events:
                # bound what each payload (and thus every 2s black-box
                # rewrite) serializes: a full 100k-event span ring is
                # tens of MB of JSON per tick, and the postmortem only
                # reads the tail anyway — metadata rows (thread names)
                # are kept, the span tail capped
                meta = [e for e in events if e.get("ph") == "M"]
                rest = [e for e in events if e.get("ph") != "M"]
                trace["traceEvents"] = (
                    meta + rest[-self.trace_tail_events:]
                )
                trace["truncated_events"] = len(rest) - self.trace_tail_events
            trace["anchor"] = self._trace.anchor()
            out["trace"] = trace
        if self._alerts_fn is not None:
            try:
                out["alerts"] = self._alerts_fn()
            except Exception:
                out["alerts"] = None
        if self._exemplars_fn is not None:
            try:
                out["exemplars"] = self._exemplars_fn()
            except Exception:
                out["exemplars"] = None
        return out

    def trip(
        self, source: str, reason: str, **fields: Any
    ) -> Optional[Path]:
        """Dump the last N seconds into ``incidents/<stamp>-<source>/``.
        Rate-limited (``min_trip_interval_s``) so an alert storm or a
        firing-every-step detector writes ONE bundle, not hundreds; the
        bundle that exists already holds the window the storm happened
        in. Returns the bundle dir, or None (disabled / rate-limited)."""
        if self.incident_dir is None:
            return None
        now = self.clock()
        with self._lock:
            if (
                self._last_trip is not None
                and now - self._last_trip < self.min_trip_interval_s
            ):
                self.suppressed += 1
                return None
            self._last_trip = now
        unix_t = self.unix()

        def write(b: Path) -> None:
            _atomic_write(
                b / "incident.json",
                {
                    "source": source,
                    "reason": reason,
                    "process": self.process_name,
                    "unix_time": round(unix_t, 3),
                    **fields,
                },
            )
            _atomic_write(
                b / f"flight-{_slug(self.process_name)}.json",
                self.payload(),
            )

        try:
            bundle = _publish_bundle(self.incident_dir, unix_t, source, write)
        except OSError:
            return None
        self.trips += 1
        try:
            from .training.resilience import log_event

            log_event(
                "incident-bundle",
                f"{source}: flight-recorder dump written to {bundle}",
                source=source,
                bundle=str(bundle),
            )
        except Exception:
            pass
        return bundle


# ----------------------------------------------------------------------
# Crash postmortems (the fleet supervisor's producer)
# ----------------------------------------------------------------------


def write_crash_bundle(
    incident_dir: Path,
    *,
    process_name: str,
    rc: Optional[int],
    argv: Optional[Sequence[str]] = None,
    output_tail: Sequence[str] = (),
    generation: Optional[int] = None,
    health_history: Sequence[Dict[str, Any]] = (),
    blackbox_path: Optional[Path] = None,
    process_started_unix: Optional[float] = None,
    extra_flights: Optional[Dict[str, Dict[str, Any]]] = None,
    replica_id: Optional[int] = None,
    slot: Optional[int] = None,
    unix: Callable[[], float] = time.time,
) -> Path:
    """One dead process → one bundle. The supervisor calls this the
    moment it observes the exit, BEFORE restart bookkeeping wipes the
    handle (generation, tail): the restart keeps the fleet serving; this
    keeps the evidence.

    * ``incident.json`` — exit code + symbolic signal (SIGKILL et al.),
      the effective argv, generation, replica/slot identity;
    * ``stderr.txt`` — the supervised output tail (stderr is merged into
      stdout by the spawn, so this is the process's last words);
    * ``health.json`` — the last ``/healthz`` payloads the router saw;
    * ``flight-<name>.json`` — the dead process's black box (its final
      pre-crash span ring and metric snapshots), if one was configured
      and survived, plus any ``extra_flights`` (e.g. the router's own
      recorder payload — giving the postmortem a cross-process timeline).
    """
    unix_t = unix()
    source = (
        f"crash-replica-{replica_id}" if replica_id is not None else "crash"
    )

    def write(b: Path) -> None:
        # read the black box FIRST: its verdict belongs in the manifest.
        # A crash-looping successor that died before its recorder's
        # first persist leaves its PREDECESSOR's file on the slot —
        # presenting that as the dead process's final state would be a
        # forensic lie, so a payload written before this incarnation
        # spawned is skipped and named stale (1s slack for clock grain).
        blackbox_raw: Optional[str] = None
        blackbox_status = "absent"
        if blackbox_path is not None:
            try:
                raw = Path(blackbox_path).read_text(encoding="utf8")
                payload = json.loads(raw)
                written = payload.get("written_unix")
                if (
                    process_started_unix is not None
                    and isinstance(written, (int, float))
                    and written < process_started_unix - 1.0
                ):
                    blackbox_status = "stale-skipped (predates this process)"
                else:
                    blackbox_raw = raw
                    blackbox_status = "ok"
            except (OSError, ValueError):
                pass  # no black box survived: honest without it
        _atomic_write(
            b / "incident.json",
            {
                "source": "crash",
                "process": process_name,
                "unix_time": round(unix_t, 3),
                "replica_id": replica_id,
                "slot": slot,
                "exit_code": rc,
                "exit_signal": exit_signal_name(rc),
                "generation": generation,
                "argv": list(argv) if argv is not None else None,
                "blackbox": blackbox_status,
            },
        )
        (b / "stderr.txt").write_text(
            "\n".join(str(line) for line in output_tail) + "\n",
            encoding="utf8",
        )
        if health_history:
            _atomic_write(b / "health.json", list(health_history))
        if blackbox_raw is not None:
            payload = json.loads(blackbox_raw)
            name = _slug(str(payload.get("process") or process_name))
            (b / f"flight-{name}.json").write_text(
                blackbox_raw, encoding="utf8"
            )
        for name, payload in (extra_flights or {}).items():
            _atomic_write(b / f"flight-{_slug(name)}.json", payload)

    bundle = _publish_bundle(Path(incident_dir), unix_t, source, write)
    try:
        from .training.resilience import log_event

        log_event(
            "incident-bundle",
            f"crash postmortem for {process_name} (rc={rc}) written to "
            f"{bundle}",
            rc=rc,
            bundle=str(bundle),
        )
    except Exception:
        pass
    return bundle


# ----------------------------------------------------------------------
# Bundle reading + the `telemetry postmortem` report
# ----------------------------------------------------------------------


def find_bundle(path: Path) -> Path:
    """Resolve a postmortem target: either a bundle dir itself (holds
    ``incident.json``) or an incidents ROOT, in which case the newest
    bundle (lexicographic UTC-stamp dir names sort chronologically) is
    picked. Raises FileNotFoundError with an actionable message."""
    path = Path(path)
    if (path / "incident.json").is_file():
        return path
    if path.is_dir():
        bundles = sorted(
            d for d in path.iterdir()
            if d.is_dir()
            and not d.name.startswith(".")  # in-flight staging dirs
            and (d / "incident.json").is_file()
        )
        if bundles:
            return bundles[-1]
    raise FileNotFoundError(
        f"{path} is neither an incident bundle (no incident.json) nor a "
        "directory containing one"
    )


def load_bundle(bundle_dir: Path) -> Dict[str, Any]:
    bundle_dir = Path(bundle_dir)
    out: Dict[str, Any] = {
        "dir": str(bundle_dir),
        "incident": json.loads(
            (bundle_dir / "incident.json").read_text(encoding="utf8")
        ),
        "stderr": None,
        "health": None,
        "flights": [],
    }
    stderr = bundle_dir / "stderr.txt"
    if stderr.is_file():
        out["stderr"] = stderr.read_text(encoding="utf8")
    health = bundle_dir / "health.json"
    if health.is_file():
        try:
            out["health"] = json.loads(health.read_text(encoding="utf8"))
        except ValueError:
            pass
    for f in sorted(bundle_dir.glob("flight-*.json")):
        try:
            out["flights"].append(json.loads(f.read_text(encoding="utf8")))
        except ValueError:
            continue  # a torn flight file: skip it, keep the rest
    return out


def merged_bundle_trace(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """Merge every flight payload's trace onto one wall-clock timeline —
    the SAME clock-anchor merge ``telemetry collect-trace`` runs against
    live endpoints, applied post-hoc to the bundle's frozen buffers."""
    from .serving.tracecollect import merge_process_traces

    processes = []
    for flight in bundle.get("flights") or []:
        trace = flight.get("trace")
        if not isinstance(trace, dict):
            continue
        processes.append(
            {
                "name": str(flight.get("process") or "process"),
                "trace": trace,
                "anchor": trace.get("anchor"),
            }
        )
    return merge_process_traces(processes)


def _counter_digest(snaps: List[Dict[str, Any]]) -> List[str]:
    """first→last movement of the headline counters across the flight
    ring — which signals were moving in the captured window."""
    if not snaps:
        return []
    first = (snaps[0].get("snapshot") or {})
    last = (snaps[-1].get("snapshot") or {})

    def counters(s: Dict[str, Any]) -> Dict[str, Any]:
        c = s.get("counters")
        if isinstance(c, dict):
            return c
        c = (s.get("router") or {}).get("counters")  # router composite
        return c if isinstance(c, dict) else {}

    c0, c1 = counters(first), counters(last)
    lines = []
    for key in sorted(set(c0) | set(c1)):
        v0, v1 = c0.get(key), c1.get(key)
        if not isinstance(v1, (int, float)):
            continue
        if isinstance(v0, (int, float)) and v1 != v0:
            lines.append(f"    {key:28s} {v0:g} -> {v1:g}")
        elif not isinstance(v0, (int, float)):
            lines.append(f"    {key:28s} {v1:g}")
    return lines


def render_postmortem(path: Path, *, timeline_events: int = 40) -> str:
    """The ``telemetry postmortem`` report from a path (resolve + load +
    render). Callers that already hold a loaded bundle (the CLI, which
    also merges the trace for ``--trace-out``) use
    :func:`render_bundle` directly and load once."""
    return render_bundle(
        load_bundle(find_bundle(Path(path))),
        timeline_events=timeline_events,
    )


def render_bundle(
    bundle: Dict[str, Any], *, timeline_events: int = 40
) -> str:
    """Pure loaded-bundle-in/text-out report renderer."""
    inc = bundle["incident"]
    lines: List[str] = [f"postmortem: {bundle['dir']}"]
    src = inc.get("source")
    lines.append(f"source: {src}  process: {inc.get('process')}")
    lines.append(f"time:   {_wall(inc.get('unix_time'))}")
    if src == "crash":
        sig = inc.get("exit_signal")
        lines.append(
            f"exit:   code {inc.get('exit_code')}"
            + (f" (killed by {sig})" if sig else "")
        )
        if inc.get("replica_id") is not None:
            lines.append(
                f"replica: id {inc.get('replica_id')}  "
                f"slot {inc.get('slot')}"
            )
    else:
        lines.append(f"reason: {inc.get('reason')}")
        # whatever the tripper stamped beyond the standard envelope —
        # the fleet divergence trip's worker/mode, an alert trip's
        # severity/value — is evidence, not metadata to drop
        extras = {
            k: v
            for k, v in inc.items()
            if k not in (
                "source", "reason", "process", "unix_time", "generation",
                "argv", "exit_code", "exit_signal", "replica_id", "slot",
            )
            and v is not None
        }
        if extras:
            lines.append(
                "detail: "
                + "  ".join(f"{k}={extras[k]}" for k in sorted(extras))
            )
    lines.append(f"generation: {inc.get('generation')}")
    if inc.get("argv"):
        lines.append("argv:   " + " ".join(str(a) for a in inc["argv"]))

    # alert states at capture (from any flight that recorded them)
    alert_rows = [
        row
        for flight in bundle["flights"]
        for row in (flight.get("alerts") or [])
        if isinstance(row, dict)
    ]
    active = [r for r in alert_rows if r.get("state") != "inactive"]
    if alert_rows:
        lines.append(
            f"-- alerts at capture ({len(active)} active of "
            f"{len(alert_rows)}) --"
        )
        for row in active or alert_rows[:3]:
            lines.append(
                f"    {row.get('state', '?'):8s} "
                f"{row.get('alert', '?')} [{row.get('severity', '?')}]  "
                f"{row.get('detail', '')}"
            )

    for flight in bundle["flights"]:
        snaps = flight.get("snapshots") or []
        if not snaps:
            continue
        span = (snaps[-1].get("unix_time") or 0) - (
            snaps[0].get("unix_time") or 0
        )
        lines.append(
            f"-- flight ring [{flight.get('process')}]: {len(snaps)} "
            f"snapshot(s) over {span:.1f}s --"
        )
        lines.extend(_counter_digest(snaps))

    if bundle.get("health"):
        last = bundle["health"][-1]
        lines.append(
            f"-- last health ({_wall(last.get('unix_time'))}) --"
        )
        lines.append(
            "    " + json.dumps(last.get("health"), sort_keys=True)[:240]
        )

    if bundle.get("stderr"):
        tail = bundle["stderr"].rstrip("\n").splitlines()
        lines.append(f"-- output tail ({len(tail)} line(s)) --")
        lines.extend(f"    {line}" for line in tail)

    merged = merged_bundle_trace(bundle)
    events = [
        e for e in merged.get("traceEvents") or [] if e.get("ph") != "M"
    ]
    if events:
        pid_names = {
            e.get("pid"): (e.get("args") or {}).get("name")
            for e in merged.get("traceEvents") or []
            if e.get("ph") == "M" and e.get("name") == "process_name"
        }
        origin_us = float(
            (merged.get("otherData") or {}).get("epoch_origin_us") or 0.0
        )
        events.sort(key=lambda e: float(e.get("ts") or 0.0))
        shown = events[-int(timeline_events):]
        lines.append(
            f"-- timeline (last {len(shown)} of {len(events)} event(s), "
            f"{len(pid_names)} process track(s)) --"
        )
        for e in shown:
            wall = _wall((origin_us + float(e.get("ts") or 0.0)) / 1e6)
            who = pid_names.get(e.get("pid"), e.get("pid"))
            dur = e.get("dur")
            dur_txt = (
                f" ({float(dur) / 1e3:.1f}ms)"
                if isinstance(dur, (int, float))
                else ""
            )
            args = e.get("args") or {}
            note = ""
            for key in ("request_id", "step", "generation", "error"):
                if args.get(key) is not None:
                    note += f" {key}={args[key]}"
            lines.append(
                f"    {wall}  [{who}] {e.get('name')}{dur_txt}{note}"
            )
    else:
        lines.append("-- timeline: no trace in bundle --")
        skipped = (merged.get("otherData") or {}).get("skipped")
        if skipped:
            lines.append(f"    (skipped unanchored: {skipped})")
    return "\n".join(lines)
