"""``telemetry top``: a terminal dashboard over the ``/metrics`` endpoints
of the port's processes (``spacy_ray_tpu/top.py``).

Polls each given base URL's ``/metrics`` (the JSON form: a replica's, a
fleet router's, a trainer's ``--metrics-port`` or a trainer-fleet worker's
peer port) and renders one screen per refresh: request rate (counter deltas
between polls), window p50/p99, batch occupancy, queue depth, the served
generation and swap count, typed rejects, scrape failures, the process
columns every endpoint carries (cpu% / rss / open fds, from the ``process``
block), the alert column and, for a trainer, step rate, words/s and the
anomaly count; a trainer-fleet worker adds its version, epoch, pushes,
discards, apply-wait share, staleness and wire.

The clock, the fetch and the output stream are injected: :func:`render` is
rows in, text out and :class:`TopModel` is delta arithmetic, so both run on
synthetic payloads and a fake clock. Standard library only; the rows and the
screen are the JAX package's.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional, TextIO

__all__ = ["TopModel", "classify_payload", "render", "run_top"]

CLEAR = "\x1b[2J\x1b[H"


def classify_payload(payload: Dict[str, Any]) -> str:
    """Which kind of endpoint answered: ``router`` (fleet view),
    ``trainer`` (step histograms, or a trainer-fleet worker's ledger —
    a telemetry-off fleet worker serves counters + a ``fleet_worker``
    gauge and no histograms at all), or ``serving`` (a single
    replica)."""
    if "fleet" in payload:
        return "router"
    hists = payload.get("histograms") or {}
    if "step_seconds" in hists:
        return "trainer"
    if (payload.get("gauges") or {}).get("fleet_worker") is not None:
        return "trainer"
    return "serving"


def _get(d: Optional[Dict[str, Any]], *keys: str) -> Any:
    cur: Any = d
    for k in keys:
        if not isinstance(cur, dict):
            return None
        cur = cur.get(k)
    return cur


def _fmt_ms(v: Any) -> str:
    return f"{float(v) * 1e3:7.1f}ms" if isinstance(v, (int, float)) else "      -"


def _fmt_rate(v: Optional[float]) -> str:
    return f"{v:7.1f}/s" if isinstance(v, (int, float)) else "      -"


def _fmt_int(v: Any) -> str:
    return f"{int(v):,}" if isinstance(v, (int, float)) else "-"


def _fmt_pct(v: Any) -> str:
    return f"{float(v):.0f}%" if isinstance(v, (int, float)) else "-"


def _fmt_bytes(v: Any) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    if v >= 1 << 30:
        return f"{v / (1 << 30):.2f}GB"
    return f"{v / (1 << 20):.0f}MB"


def _process_cols(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The host-resource columns every row kind shares, from the
    payload's top-level ``process`` block (hoststats.ProcessSampler on
    each surface). Absent block = absent columns, honest dashes."""
    proc = payload.get("process")
    if not isinstance(proc, dict):
        return {"cpu_pct": None, "rss": None, "fds": None}
    return {
        "cpu_pct": proc.get("cpu_percent"),
        "rss": proc.get("rss_bytes"),
        "fds": proc.get("open_fds"),
    }


def _fmt_host(row: Dict[str, Any]) -> str:
    return (
        f"cpu {_fmt_pct(row.get('cpu_pct'))}  "
        f"rss {_fmt_bytes(row.get('rss'))}  "
        f"fd {_fmt_int(row.get('fds'))}"
    )


class TopModel:
    """Holds the previous poll's counters per URL and turns the current
    poll into a display row (rates = counter deltas / elapsed)."""

    def __init__(self) -> None:
        self._prev: Dict[str, Any] = {}  # url -> (t, counters dict)
        # consecutive failed scrapes per URL: a fleet worker exiting
        # mid-poll is COUNTED (and shown), never allowed to break the
        # refresh loop
        self._failures: Dict[str, int] = {}

    def _rates(
        self, url: str, counters: Dict[str, Any], now: float
    ) -> Dict[str, Optional[float]]:
        prev = self._prev.get(url)
        self._prev[url] = (now, dict(counters))
        if prev is None:
            return {}
        t_prev, prev_counters = prev
        dt = now - t_prev
        if dt <= 0:
            return {}
        out: Dict[str, Optional[float]] = {}
        for key, value in counters.items():
            if isinstance(value, (int, float)) and isinstance(
                prev_counters.get(key), (int, float)
            ):
                out[key] = max(float(value) - float(prev_counters[key]), 0.0) / dt
        return out

    def update(
        self, url: str, payload: Optional[Dict[str, Any]], now: float
    ) -> Dict[str, Any]:
        """One endpoint's display row. ``payload`` None = unreachable."""
        if payload is None:
            self._failures[url] = self._failures.get(url, 0) + 1
            return {
                "url": url, "kind": "down",
                "failures": self._failures[url],
            }
        self._failures[url] = 0
        kind = classify_payload(payload)
        if kind == "router":
            fleet = payload.get("fleet") or {}
            counters = dict(fleet.get("counters") or {})
            router = payload.get("router") or {}
            for k, v in (router.get("counters") or {}).items():
                counters[f"router.{k}"] = v
            # per-model counters (multi-model fleets) join the same
            # delta arithmetic under a "model.<name>." prefix, so each
            # model's req/s and quota-reject/s come for free
            by_model = fleet.get("by_model") or {}
            for mname, sub in by_model.items():
                if not isinstance(sub, dict):
                    continue
                for k, v in (sub.get("counters") or {}).items():
                    if isinstance(v, (int, float)):
                        counters[f"model.{mname}.{k}"] = v
            # the edge cache's ledger (router /metrics "cache" block —
            # the same surface the Zipfian bench record reads): lifetime
            # hit rate over hits+misses; None when the cache is off
            cache = payload.get("cache")
            cache_hit_rate = None
            if isinstance(cache, dict):
                hits = cache.get("cache_hits") or 0
                misses = cache.get("cache_misses") or 0
                if hits + misses > 0:
                    cache_hit_rate = hits / (hits + misses)
                else:
                    cache_hit_rate = 0.0
            rates = self._rates(url, counters, now)
            replicas = payload.get("replicas") or []
            # per-model rows: window p99 from the merged by_model view,
            # cache hit % from the per-model cache ledger, and the
            # resident-replica count from the probe-learned placement
            placement = payload.get("placement") or {}
            cache_by_model = (
                cache.get("by_model") if isinstance(cache, dict) else None
            ) or {}
            models: List[Dict[str, Any]] = []
            for mname in sorted(by_model):
                sub = by_model[mname] if isinstance(
                    by_model[mname], dict
                ) else {}
                ledger = cache_by_model.get(mname) or {}
                m_hits = ledger.get("hits") or 0
                m_misses = ledger.get("misses") or 0
                models.append({
                    "name": mname,
                    "req_s": rates.get(f"model.{mname}.requests"),
                    "p99": _get(sub, "slo_window", "request_latency_p99"),
                    "cache_hit_rate": (
                        m_hits / (m_hits + m_misses)
                        if (m_hits + m_misses) > 0 else None
                    ),
                    "hosts": sum(
                        1 for ms in placement.values()
                        if mname in (ms or [])
                    ),
                    "quota_s": rates.get(
                        f"model.{mname}.rejected_quota"
                    ),
                })
            return {
                "url": url,
                "kind": kind,
                "req_s": rates.get("router.requests"),
                "p50": _get(fleet, "slo_window", "request_latency_p50"),
                "p99": _get(fleet, "slo_window", "request_latency_p99"),
                "p99_worst": _get(
                    fleet, "slo_window", "request_latency_p99_worst"
                ),
                "queue_depth": _get(fleet, "gauges", "queue_depth", "sum"),
                "occupancy": _get(
                    fleet, "histograms", "batch_occupancy", "p50"
                ),
                "ready": sum(1 for r in replicas if r.get("ready")),
                "replicas": len(replicas),
                "generations": sorted(
                    {
                        str(r.get("generation"))
                        for r in replicas if r.get("ready")
                    }
                ),
                "swaps": sum(
                    int(r.get("swap_count") or 0) for r in replicas
                ),
                "reject_s": (
                    (rates.get("router.rejected_no_replica") or 0.0)
                    + (rates.get("router.rejected_draining") or 0.0)
                    + (rates.get("rejected_queue_full") or 0.0)
                    + (rates.get("deadline_exceeded") or 0.0)
                ) if rates else None,
                "scrape_failures": sum(
                    int(v) for v in (payload.get("scrape_failures") or {}).values()
                ),
                "cache_hit_rate": cache_hit_rate,
                "cache_bypasses": (
                    cache.get("cache_mixed_generation_bypasses")
                    if isinstance(cache, dict) else None
                ),
                # the fleet-wide padded-token share from the engines'
                # dispatch assembly, and the cache ledger's 304s
                "pad_share": _pad_share(counters),
                "not_modified": (
                    cache.get("cache_not_modified")
                    if isinstance(cache, dict) else None
                ),
                "quota_s": rates.get("rejected_quota"),
                "models": models,
                "alerts": payload.get("alerts"),
                **_process_cols(payload),
            }
        if kind == "trainer":
            counters = dict(payload.get("counters") or {})
            hists = payload.get("histograms") or {}
            # per-phase histogram SUMS are monotone like counters, so
            # feeding them through the same delta arithmetic yields
            # "seconds of phase X per wall second" — the apply-wait
            # share column is their ratio over all phases
            for name, h in hists.items():
                if (
                    name.startswith("phase_")
                    and isinstance(h, dict)
                    and isinstance(h.get("sum"), (int, float))
                ):
                    counters[f"hist.{name}.sum"] = float(h["sum"])
            rates = self._rates(url, counters, now)
            phase_rates = {
                k: v for k, v in rates.items()
                if k.startswith("hist.phase_") and isinstance(v, float)
            }
            apply_wait_pct = None
            if phase_rates:
                total = sum(phase_rates.values())
                wait = phase_rates.get("hist.phase_apply_wait_seconds.sum")
                if total > 0 and wait is not None:
                    apply_wait_pct = wait / total
                elif wait is not None:
                    apply_wait_pct = 0.0
            # fleet workers (training/fleet/) are trainers with a worker
            # id, a shard version, and the async plane's push/discard
            # counters — each worker is its own scrape URL, so the
            # per-worker columns come for free from per-row rates
            worker = _get(payload, "gauges", "fleet_worker")
            discard_rate = None
            push_s = rates.get("grad_pushed")
            recv_s = rates.get("grad_received")
            disc_s = rates.get("grad_discarded")
            if isinstance(recv_s, float) and isinstance(disc_s, float):
                discard_rate = disc_s / recv_s if recv_s > 0 else 0.0
            # the wire column: push MB/s actually sent plus the
            # compression ratio (uncompressed/actual) — same counter-
            # delta arithmetic, two more monotone series
            wire_push_bps = rates.get("wire_push_bytes")
            wire_push_raw_bps = rates.get("wire_push_bytes_uncompressed")
            wire_ratio = None
            if (
                isinstance(wire_push_bps, float)
                and isinstance(wire_push_raw_bps, float)
                and wire_push_bps > 0
            ):
                wire_ratio = wire_push_raw_bps / wire_push_bps
            return {
                "url": url,
                "kind": kind,
                "steps_s": rates.get("steps"),
                "words_s": rates.get("words"),
                "step_p50": _get(hists, "step_seconds", "p50"),
                "step_p95": _get(hists, "step_seconds", "p95"),
                "anomalies": counters.get("anomalies"),
                "compiles": _get(payload, "gauges", "compile_count"),
                "hbm_peak": _get(payload, "gauges", "hbm_peak_bytes"),
                "alerts": payload.get("alerts"),
                "worker": worker,
                "version": _get(payload, "gauges", "param_version"),
                "epoch": _get(payload, "gauges", "membership_epoch"),
                "evictions": counters.get("evictions"),
                "push_s": push_s,
                "discard_s": disc_s,
                "discard_rate": discard_rate,
                "apply_wait_pct": apply_wait_pct,
                "staleness_max": _get(hists, "staleness", "max"),
                "wire_push_bps": wire_push_bps,
                "wire_ratio": wire_ratio,
                **_process_cols(payload),
            }
        counters = dict(payload.get("counters") or {})
        # a multi-model replica's /metrics carries per-engine snapshots
        # under "models": same prefix trick as the router view
        replica_models = payload.get("models") or {}
        for mname, msnap in replica_models.items():
            if not isinstance(msnap, dict):
                continue
            for k, v in (msnap.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    counters[f"model.{mname}.{k}"] = v
        rates = self._rates(url, counters, now)
        models = []
        for mname in sorted(replica_models):
            msnap = replica_models[mname] if isinstance(
                replica_models[mname], dict
            ) else {}
            models.append({
                "name": mname,
                "req_s": rates.get(f"model.{mname}.requests"),
                "p99": _get(msnap, "slo_window", "request_latency_p99"),
                "cache_hit_rate": None,
                "hosts": None,
                "quota_s": rates.get(f"model.{mname}.rejected_quota"),
            })
        return {
            "url": url,
            "kind": kind,
            "req_s": rates.get("requests"),
            "p50": _get(payload, "slo_window", "request_latency_p50"),
            "p99": _get(payload, "slo_window", "request_latency_p99"),
            "queue_depth": _get(payload, "gauges", "queue_depth"),
            "occupancy": _get(payload, "gauges", "last_batch_occupancy"),
            "generation": payload.get("generation"),
            "swaps": payload.get("swap_count"),
            "reject_s": (
                (rates.get("rejected_queue_full") or 0.0)
                + (rates.get("rejected_draining") or 0.0)
                + (rates.get("deadline_exceeded") or 0.0)
            ) if rates else None,
            "exemplars": counters.get("slow_exemplars"),
            "pad_share": _pad_share(counters),
            "quota_s": rates.get("rejected_quota"),
            "models": models,
            "alerts": payload.get("alerts"),
            **_process_cols(payload),
        }


def _pad_share(counters: Dict[str, Any]) -> Optional[float]:
    """Lifetime padded-token share from the pad/real counter pair the
    engine's dispatch assembly exports; None before any batch ran (or
    against an older endpoint without the counters)."""
    pad = counters.get("pad_tokens")
    real = counters.get("real_tokens")
    if not isinstance(pad, (int, float)) or not isinstance(
        real, (int, float)
    ):
        return None
    total = pad + real
    return (pad / total) if total > 0 else None


def _fmt_alerts(block: Any) -> str:
    """The alert column: ``FIRING name[+k]`` when anything is firing,
    ``pending n`` while confirming, ``ok`` when the endpoint runs an
    alert engine with nothing active, ``-`` when it has none."""
    if not isinstance(block, dict):
        return "-"
    firing = int(block.get("firing") or 0)
    pending = int(block.get("pending") or 0)
    if firing:
        names = block.get("firing_names") or []
        first = names[0] if names else "?"
        more = f"+{firing - 1}" if firing > 1 else ""
        return f"FIRING {first}{more}"
    if pending:
        return f"pending {pending}"
    return "ok"


def _model_lines(row: Dict[str, Any], lines: List[str]) -> None:
    """Per-model sub-rows (multi-model serving): req/s, window p99,
    cache hit %, resident-replica count, quota-reject/s."""
    for m in row.get("models") or []:
        hr = m.get("cache_hit_rate")
        cache_s = f"{hr * 100:.0f}%" if isinstance(hr, float) else "-"
        hosts = m.get("hosts")
        hosts_s = _fmt_int(hosts) if hosts is not None else "-"
        lines.append(
            f"    model {m.get('name')}  "
            f"req {_fmt_rate(m.get('req_s'))}  "
            f"p99 {_fmt_ms(m.get('p99'))}  "
            f"cache {cache_s}  "
            f"hosts {hosts_s}  "
            f"429-quota {_fmt_rate(m.get('quota_s'))}"
        )


def render(rows: List[Dict[str, Any]], *, now_label: str = "") -> str:
    """Rows → one dashboard screen (pure; no I/O, no clock)."""
    lines = [f"srt telemetry top{('  ' + now_label) if now_label else ''}"]
    for row in rows:
        kind = row.get("kind")
        if kind == "down":
            n_fail = row.get("failures")
            tail = (
                f" ({int(n_fail)} failed scrape(s))"
                if isinstance(n_fail, (int, float)) and n_fail > 1
                else ""
            )
            lines.append(f"  {row['url']}: UNREACHABLE{tail}")
            continue
        if kind == "router":
            gens = ",".join(row.get("generations") or []) or "-"
            lines.append(
                f"  router  {row['url']}  "
                f"ready {row.get('ready')}/{row.get('replicas')}"
            )
            lines.append(
                f"    req {_fmt_rate(row.get('req_s'))}  "
                f"win p50 {_fmt_ms(row.get('p50'))}  "
                f"p99 {_fmt_ms(row.get('p99'))}  "
                f"worst {_fmt_ms(row.get('p99_worst'))}"
            )
            hr = row.get("cache_hit_rate")
            cache_s = f"{hr * 100:.0f}%" if isinstance(hr, float) else "-"
            ps = row.get("pad_share")
            pad_s = f"{ps * 100:.0f}%" if isinstance(ps, float) else "-"
            lines.append(
                f"    queue {_fmt_int(row.get('queue_depth'))}  "
                f"occ p50 {_fmt_int(row.get('occupancy'))}  "
                f"gen [{gens}]  swaps {_fmt_int(row.get('swaps'))}  "
                f"rej {_fmt_rate(row.get('reject_s'))}  "
                f"429-quota {_fmt_rate(row.get('quota_s'))}  "
                f"cache {cache_s}  "
                f"pad {pad_s}  "
                f"304 {_fmt_int(row.get('not_modified'))}  "
                f"scrape-fail {_fmt_int(row.get('scrape_failures'))}  "
                f"{_fmt_host(row)}  "
                f"alerts {_fmt_alerts(row.get('alerts'))}"
            )
            _model_lines(row, lines)
        elif kind == "trainer":
            worker = row.get("worker")
            tag = (
                f"  [fleet worker {int(worker)}]"
                if isinstance(worker, (int, float))
                else ""
            )
            lines.append(f"  trainer {row['url']}{tag}")
            lines.append(
                f"    steps {_fmt_rate(row.get('steps_s'))}  "
                f"words {_fmt_rate(row.get('words_s'))}  "
                f"step p50 {_fmt_ms(row.get('step_p50'))}  "
                f"p95 {_fmt_ms(row.get('step_p95'))}"
            )
            if isinstance(worker, (int, float)):
                dr = row.get("discard_rate")
                dr_s = f"{dr * 100:.0f}%" if isinstance(dr, float) else "-"
                aw = row.get("apply_wait_pct")
                aw_s = f"{aw * 100:.0f}%" if isinstance(aw, float) else "-"
                sm = row.get("staleness_max")
                sm_s = f"{int(sm)}" if isinstance(sm, (int, float)) else "-"
                wb = row.get("wire_push_bps")
                wb_s = (
                    f"{wb / 1e6:.2f}MB/s" if isinstance(wb, float) else "-"
                )
                wr = row.get("wire_ratio")
                wr_s = f"{wr:.1f}x" if isinstance(wr, float) else "-"
                lines.append(
                    f"    ver {_fmt_int(row.get('version'))}  "
                    f"epoch {_fmt_int(row.get('epoch'))}  "
                    f"evict {_fmt_int(row.get('evictions'))}  "
                    f"push {_fmt_rate(row.get('push_s'))}  "
                    f"disc {_fmt_rate(row.get('discard_s'))}  "
                    f"disc-rate {dr_s}  "
                    f"wait {aw_s}  "
                    f"stale-max {sm_s}  "
                    f"wire {wb_s} ({wr_s})"
                )
            lines.append(
                f"    anomalies {_fmt_int(row.get('anomalies'))}  "
                f"compiles {_fmt_int(row.get('compiles'))}  "
                f"{_fmt_host(row)}  "
                f"alerts {_fmt_alerts(row.get('alerts'))}"
            )
        else:
            lines.append(
                f"  replica {row['url']}  "
                f"gen {row.get('generation') if row.get('generation') is not None else '-'}"
                f"  swaps {_fmt_int(row.get('swaps'))}"
            )
            ps = row.get("pad_share")
            pad_s = f"{ps * 100:.0f}%" if isinstance(ps, float) else "-"
            lines.append(
                f"    req {_fmt_rate(row.get('req_s'))}  "
                f"win p50 {_fmt_ms(row.get('p50'))}  "
                f"p99 {_fmt_ms(row.get('p99'))}  "
                f"queue {_fmt_int(row.get('queue_depth'))}  "
                f"occ {_fmt_int(row.get('occupancy'))}  "
                f"rej {_fmt_rate(row.get('reject_s'))}  "
                f"429-quota {_fmt_rate(row.get('quota_s'))}  "
                f"pad {pad_s}  "
                f"slow-exemplars {_fmt_int(row.get('exemplars'))}  "
                f"{_fmt_host(row)}  "
                f"alerts {_fmt_alerts(row.get('alerts'))}"
            )
            _model_lines(row, lines)
    return "\n".join(lines) + "\n"


def _default_fetch(url: str, timeout_s: float) -> Optional[Dict[str, Any]]:
    from .serving.tracecollect import fetch_json

    try:
        status, payload = fetch_json(url, "/metrics", timeout_s)
    except OSError:
        return None
    return payload if status == 200 and isinstance(payload, dict) else None


def run_top(
    urls: List[str],
    *,
    interval_s: float = 2.0,
    iterations: Optional[int] = None,
    out: TextIO = sys.stdout,
    fetch: Callable[[str, float], Optional[Dict[str, Any]]] = _default_fetch,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    timeout_s: float = 5.0,
) -> int:
    """The poll-render loop. ``iterations=None`` runs until Ctrl-C."""
    model = TopModel()
    n = 0

    def poll(url: str) -> Optional[Dict[str, Any]]:
        # ANY scrape failure (transport OSError, a peer dying between
        # the status line and the body, torn JSON) is one endpoint's
        # "down" row this refresh — never the whole loop's crash
        try:
            return fetch(url, timeout_s)
        except Exception:
            return None

    try:
        while iterations is None or n < iterations:
            now = clock()
            rows = [model.update(u, poll(u), now) for u in urls]
            label = time.strftime("%H:%M:%S")
            out.write(CLEAR + render(rows, now_label=label))
            out.flush()
            n += 1
            if iterations is not None and n >= iterations:
                break
            sleep(interval_s)
    except KeyboardInterrupt:
        out.write("\n")
    return 0
