"""Host-resource truth: ``/proc``-based process sampling plus
cgroup-aware core accounting — the live resource signals every role in
the system exports and the bench's machine-derived contention stamp.

Two consumers, one module:

* **Live surfaces.** A :class:`ProcessSampler` owned by each role's
  telemetry facade (trainer ``Telemetry``, fleet peer, serving
  ``ServingTelemetry``, ``RouterTelemetry``) and ticked by the role's
  EXISTING observer/alert thread — no new thread anywhere. Its sample
  dict rides the JSON ``/metrics`` payload under a top-level
  ``"process"`` key, renders as the ``srt_process_*`` gauge family in
  the Prometheus exposition (one family name across all four surfaces,
  deliberately OUTSIDE the per-role ``srt_training``/``srt_serving``/
  ``srt_router`` prefixes), and is injected into alert-engine snapshots
  so the leak rules read ``process.rss_bytes`` / ``process.open_fds``
  with the same dotted-path grammar as every other rule.

* **The bench stamp.** ``bench.py`` used to hand-maintain
  ``cores_available`` / ``contended`` constants; :func:`effective_cores`
  (min of cpu_count, sched affinity, and the cgroup cpu quota — v2
  ``cpu.max`` or v1 ``cfs_quota_us``/``cfs_period_us``) and
  :func:`contention_probe` (core arithmetic + a short busy-spin
  efficiency check) mechanize them, and :func:`host_block` is the
  ``host`` dict every bench record now carries for the run ledger
  (``runledger.py``) to ingest.

Honesty rules, same as the exposition layer: a field whose ``/proc``
file is missing or unparsable is ``None`` (no-signal), never a fake 0 —
the Prometheus renderer already omits ``None`` gauges, and the alert
engine already treats a missing path as no-signal. ``cpu_percent`` is a
delta over the previous reading; the baseline is primed at
construction, so the first sample reports utilization since the facade
came up (never a meaningless since-boot average), and stays ``None``
only when no wall time has passed or ``stat`` is unreadable.

Stdlib-only and jax-free: importable by the router, ``telemetry top``,
and the ledger CLI without dragging in an accelerator runtime.

The port's copy of ``spacy_ray_tpu/training/hoststats.py``, unchanged: the
serving engine's ``/metrics`` reads it.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "ProcessSampler",
    "PROCESS_GAUGE_FIELDS",
    "add_process_family",
    "effective_cores",
    "contention_probe",
    "host_block",
]


# Sample-dict keys exported as ``srt_process_<key>`` gauges, with the
# unit discipline of the rest of the plane (bytes are bytes, percents
# are 0-100, totals are since-process-start). Order is exposition order.
PROCESS_GAUGE_FIELDS: Tuple[str, ...] = (
    "cpu_percent",
    "cpu_seconds_total",
    "rss_bytes",
    "rss_peak_bytes",
    "threads",
    "open_fds",
    "ctx_switches_voluntary",
    "ctx_switches_involuntary",
    "io_read_bytes",
    "io_write_bytes",
)


def _read_text(path: str) -> Optional[str]:
    try:
        with open(path, "r", encoding="ascii", errors="replace") as f:
            return f.read()
    except OSError:
        return None


class ProcessSampler:
    """Reads ``/proc/self/{stat,status,io}`` + the fd table into one
    flat dict of numbers.

    Internally rate-limited: callers cheaper than ``min_interval_s``
    apart get the cached sample, so both the /metrics handler threads
    and the observer tickers may call :meth:`sample` freely without
    multiplying ``/proc`` reads (and without a dedicated sampler
    thread). The clock is injected for the same reason the alert
    engine's is — deterministic tests.

    ``proc_root`` points at a fake ``/proc/self`` directory in tests;
    every field degrades independently to ``None`` when its file is
    absent there (or on a hostile real ``/proc``).
    """

    def __init__(
        self,
        *,
        proc_root: str = "/proc/self",
        clock: Callable[[], float] = time.monotonic,
        clk_tck: Optional[float] = None,
        min_interval_s: float = 1.0,
    ) -> None:
        self.proc_root = str(proc_root)
        self.clock = clock
        if clk_tck is None:
            try:
                clk_tck = float(os.sysconf("SC_CLK_TCK"))
            except (ValueError, OSError, AttributeError):
                clk_tck = 100.0
        self.clk_tck = float(clk_tck) or 100.0
        self.min_interval_s = float(min_interval_s)
        self._last_t: Optional[float] = None
        self._last_cpu_s: Optional[float] = None
        self._cached: Optional[Dict[str, Any]] = None
        # prime the cpu baseline: the first real sample then reports
        # utilization since construction instead of an honest-but-empty
        # None (scrape-once consumers never see the gauge otherwise)
        primed = self._read_stat().get("cpu_seconds_total")
        if primed is not None:
            self._last_cpu_s = primed
            self._last_t = self.clock()

    # -- field readers -------------------------------------------------
    def _read_stat(self) -> Dict[str, Any]:
        """utime/stime (ticks -> seconds) + thread count from
        ``stat``'s fixed-position fields; the comm field may contain
        spaces/parens, so split AFTER the last ``)``."""
        raw = _read_text(os.path.join(self.proc_root, "stat"))
        out: Dict[str, Any] = {
            "cpu_seconds_total": None,
            "threads": None,
        }
        if raw is None:
            return out
        rest = raw.rpartition(")")[2].split()
        # rest[0] is field 3 (state); utime/stime are fields 14/15,
        # num_threads field 20 (man proc(5), 1-based)
        try:
            utime = float(rest[11])
            stime = float(rest[12])
            out["cpu_seconds_total"] = (utime + stime) / self.clk_tck
        except (IndexError, ValueError):
            pass
        try:
            out["threads"] = int(rest[17])
        except (IndexError, ValueError):
            pass
        return out

    def _read_status(self) -> Dict[str, Any]:
        raw = _read_text(os.path.join(self.proc_root, "status"))
        out: Dict[str, Any] = {
            "rss_bytes": None,
            "rss_peak_bytes": None,
            "ctx_switches_voluntary": None,
            "ctx_switches_involuntary": None,
        }
        if raw is None:
            return out
        keymap = {
            "VmRSS": ("rss_bytes", 1024),
            "VmHWM": ("rss_peak_bytes", 1024),
            "voluntary_ctxt_switches": ("ctx_switches_voluntary", 1),
            "nonvoluntary_ctxt_switches": ("ctx_switches_involuntary", 1),
        }
        for line in raw.splitlines():
            name, sep, value = line.partition(":")
            if not sep or name not in keymap:
                continue
            field, scale = keymap[name]
            try:
                out[field] = int(value.split()[0]) * scale
            except (IndexError, ValueError):
                pass
        return out

    def _read_io(self) -> Dict[str, Any]:
        raw = _read_text(os.path.join(self.proc_root, "io"))
        out: Dict[str, Any] = {
            "io_read_bytes": None,
            "io_write_bytes": None,
        }
        if raw is None:
            return out
        for line in raw.splitlines():
            name, sep, value = line.partition(":")
            if not sep:
                continue
            key = {
                "read_bytes": "io_read_bytes",
                "write_bytes": "io_write_bytes",
            }.get(name.strip())
            if key is None:
                continue
            try:
                out[key] = int(value.strip())
            except ValueError:
                pass
        return out

    def _count_fds(self) -> Optional[int]:
        try:
            return len(os.listdir(os.path.join(self.proc_root, "fd")))
        except OSError:
            return None

    # -- the sample ----------------------------------------------------
    def sample(self, *, force: bool = False) -> Dict[str, Any]:
        """One flat dict of the :data:`PROCESS_GAUGE_FIELDS` numbers
        (cached inside ``min_interval_s`` unless ``force``)."""
        now = self.clock()
        if (
            not force
            and self._cached is not None
            and self._last_t is not None
            and now - self._last_t < self.min_interval_s
        ):
            return self._cached
        out: Dict[str, Any] = {}
        out.update(self._read_stat())
        out.update(self._read_status())
        out.update(self._read_io())
        out["open_fds"] = self._count_fds()
        cpu_s = out.get("cpu_seconds_total")
        cpu_pct: Optional[float] = None
        if (
            cpu_s is not None
            and self._last_cpu_s is not None
            and self._last_t is not None
        ):
            wall = now - self._last_t
            if wall > 0:
                cpu_pct = max(cpu_s - self._last_cpu_s, 0.0) / wall * 100.0
        out["cpu_percent"] = cpu_pct
        self._last_t = now
        if cpu_s is not None:
            self._last_cpu_s = cpu_s
        self._cached = out
        return out


def add_process_family(
    fam: Any,
    sample: Optional[Dict[str, Any]],
    labels: Optional[Dict[str, Any]] = None,
) -> None:
    """Render one sample as the ``srt_process_*`` gauge family onto a
    ``PromFamilies`` — the ONE exposition spelling all four surfaces
    share (the per-role snapshot prefixes would otherwise fragment the
    family into ``srt_serving_process_rss_bytes`` etc., and a fleet
    dashboard's leak panel would need a query per role)."""
    if not sample:
        return
    for key in PROCESS_GAUGE_FIELDS:
        fam.add(f"srt_process_{key}", "gauge", sample.get(key), labels)


# -- core accounting ---------------------------------------------------
def _cgroup_quota_cores(cgroup_root: str) -> Tuple[Optional[float], Optional[str]]:
    """(quota in cores, "v2"|"v1") — None where unlimited or unreadable."""
    raw = _read_text(os.path.join(cgroup_root, "cpu.max"))
    if raw is not None:
        parts = raw.split()
        if parts and parts[0] != "max":
            try:
                period = float(parts[1]) if len(parts) > 1 else 100000.0
                if period > 0:
                    return float(parts[0]) / period, "v2"
            except ValueError:
                pass
        if parts:
            return None, "v2"
    quota_raw = _read_text(os.path.join(cgroup_root, "cpu.cfs_quota_us"))
    period_raw = _read_text(os.path.join(cgroup_root, "cpu.cfs_period_us"))
    if quota_raw is not None and period_raw is not None:
        try:
            quota = float(quota_raw.split()[0])
            period = float(period_raw.split()[0])
        except (IndexError, ValueError):
            return None, "v1"
        if quota > 0 and period > 0:
            return quota / period, "v1"
        return None, "v1"
    return None, None


def effective_cores(
    *,
    cgroup_root: str = "/sys/fs/cgroup",
    affinity: Optional[int] = None,
    cpu_count: Optional[int] = None,
) -> Dict[str, Any]:
    """The cores this process can ACTUALLY burn: min of the visible CPU
    count, the sched affinity mask, and the cgroup cpu quota — with
    provenance, because the bench's ``host`` block records not just the
    number but why (a ``cores: 1`` from a cgroup quota on a 64-core box
    is a very different run from a real single-core host)."""
    if cpu_count is None:
        cpu_count = os.cpu_count()
    if affinity is None:
        try:
            affinity = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            affinity = None
    quota, cg_version = _cgroup_quota_cores(cgroup_root)
    candidates = []
    if cpu_count:
        candidates.append((float(cpu_count), "cpu_count"))
    if affinity:
        candidates.append((float(affinity), "affinity"))
    if quota is not None:
        candidates.append((quota, "cgroup_quota"))
    if candidates:
        value, source = min(candidates, key=lambda c: c[0])
        cores = max(1, int(math.floor(value + 1e-9)))
    else:
        cores, source = 1, "unknown"
    return {
        "cores": cores,
        "source": source,
        "cpu_count": cpu_count,
        "affinity": affinity,
        "cgroup_quota": quota,
        "cgroup_version": cg_version,
    }


def contention_probe(
    cores_needed: int,
    *,
    cores: Optional[Dict[str, Any]] = None,
    cgroup_root: str = "/sys/fs/cgroup",
    spin_s: float = 0.05,
    efficiency_floor: float = 0.80,
    clock: Callable[[], float] = time.perf_counter,
    cpu_time: Callable[[], float] = time.process_time,
) -> Dict[str, Any]:
    """The machine-derived ``contended`` verdict: a run wanting
    ``cores_needed`` cores is contended when the host cannot grant them
    (core arithmetic) OR when a short single-thread busy-spin gets
    materially less cpu-time than wall-time (neighbors on the same
    core — the signal core counts can't see). Both clocks are injected
    so tests script the spin deterministically."""
    if cores is None:
        cores = effective_cores(cgroup_root=cgroup_root)
    n = int(cores.get("cores") or 1)
    out: Dict[str, Any] = {
        "contended": False,
        "reason": None,
        "cores": n,
        "cores_needed": int(cores_needed),
        "spin_efficiency": None,
    }
    if n < int(cores_needed):
        out["contended"] = True
        out["reason"] = (
            f"cores {n} < needed {int(cores_needed)} ({cores.get('source')})"
        )
        return out
    eff = _spin_efficiency(spin_s, clock, cpu_time)
    out["spin_efficiency"] = eff
    if eff is not None and eff < float(efficiency_floor):
        out["contended"] = True
        out["reason"] = (
            f"spin efficiency {eff:.2f} < {float(efficiency_floor):.2f}"
        )
    return out


def _spin_efficiency(
    spin_s: float,
    clock: Callable[[], float],
    cpu_time: Callable[[], float],
) -> Optional[float]:
    """cpu-time / wall-time of a short busy loop, clamped to [0, 1]."""
    try:
        t0 = clock()
        c0 = cpu_time()
        x = 0
        while clock() - t0 < spin_s:
            x += 1  # pure-python busy work; the GIL is held throughout
        wall = clock() - t0
        cpu = cpu_time() - c0
    except Exception:
        return None
    if wall <= 0:
        return None
    return max(0.0, min(cpu / wall, 1.0))


def host_block(
    *,
    cores_needed: Optional[int] = None,
    sampler: Optional[ProcessSampler] = None,
    cgroup_root: str = "/sys/fs/cgroup",
) -> Dict[str, Any]:
    """The ``host`` dict a bench record carries: machine-derived core
    accounting (+ the contention verdict when the caller says how many
    cores the arm wants) and the process RSS peak — everything the run
    ledger needs to decide whether a record is baseline-worthy."""
    cores = effective_cores(cgroup_root=cgroup_root)
    out: Dict[str, Any] = dict(cores)
    if cores_needed is not None:
        probe = contention_probe(
            int(cores_needed), cores=cores, cgroup_root=cgroup_root
        )
        out["contended"] = probe["contended"]
        out["contention_reason"] = probe["reason"]
        out["spin_efficiency"] = probe["spin_efficiency"]
    if sampler is None:
        sampler = ProcessSampler()
    s = sampler.sample(force=True)
    out["rss_peak_bytes"] = s.get("rss_peak_bytes")
    out["rss_bytes"] = s.get("rss_bytes")
    return out
