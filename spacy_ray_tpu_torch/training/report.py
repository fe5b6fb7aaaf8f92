"""``telemetry report <run-dir>`` — one markdown report per training
run, digested from the artifacts the run already writes: the per-worker
``fleet-worker-*.json`` ledgers, each worker's ``metrics.jsonl`` (step
rows with per-step loss, eval rows, anomaly rows, the ``kind: "fleet"``
exit row carrying the dynamics histograms), and the alert-transition
``alerts.jsonl`` sinks.

The port's copy of ``spacy_ray_tpu/training/report.py``: standard library
only, so it runs anywhere the ledgers can be copied to, and it renders a run
directory written by either package as the JAX package's report does. This
module holds the one definition of the run directory's layout
(:func:`load_run`), which ``telemetry summarize`` reads too.

Layout expectations (what the trainer-fleet writers produce):

* ``<run-dir>/fleet-worker-{k}.json`` — exit ledger per worker;
* ``<run-dir>/metrics/fleet-worker-{k}/metrics.jsonl`` + ``alerts.jsonl``
  (``--metrics-dir <run-dir>/metrics``, the tests' convention) — an
  explicit ``metrics_dir`` can point elsewhere;
* a single-process run (``metrics.jsonl`` directly under the run dir or
  its ``metrics/``) gets the same report minus the fleet-only sections.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "build_run_report",
    "load_run",
    "fleet_exit_rows",
    "sum_staleness",
    "sparkline",
]

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 40) -> str:
    """Downsampled unicode sparkline (empty string when no finite
    values) — the loss-curve-at-a-glance the report tables carry."""
    finite = [v for v in values if isinstance(v, (int, float))
              and math.isfinite(float(v))]
    if not finite:
        return ""
    if len(finite) > width:
        # mean-pool into `width` cells so the shape survives
        out: List[float] = []
        n = len(finite)
        for i in range(width):
            lo, hi = i * n // width, max((i + 1) * n // width, i * n // width + 1)
            chunk = finite[lo:hi]
            out.append(sum(chunk) / len(chunk))
        finite = out
    lo, hi = min(finite), max(finite)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(finite)
    return "".join(
        _SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)), len(_SPARK) - 1)]
        for v in finite
    )


def _read_jsonl(path: Path) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue  # torn concurrent write: skip, don't abort
                if isinstance(row, dict):
                    rows.append(row)
    except OSError:
        pass
    return rows


def load_run(
    run_dir: Path, metrics_dir: Optional[Path] = None
) -> Dict[str, Any]:
    """Gather everything the report renders: per-worker ledgers, metrics
    rows, and alert transitions. Raises ValueError when the directory
    holds neither ledgers nor metrics (a wrong path must not produce an
    empty-but-plausible report)."""
    run_dir = Path(run_dir)
    mdir = Path(metrics_dir) if metrics_dir is not None else run_dir / "metrics"
    workers: Dict[int, Dict[str, Any]] = {}
    for p in sorted(run_dir.glob("fleet-worker-*.json")):
        try:
            ledger = json.loads(p.read_text(encoding="utf8"))
        except ValueError:
            continue
        w = ledger.get("worker")
        if isinstance(w, int):
            workers.setdefault(w, {})["ledger"] = ledger
    for d in sorted(mdir.glob("fleet-worker-*")) if mdir.is_dir() else []:
        try:
            w = int(d.name.rsplit("-", 1)[-1])
        except ValueError:
            continue
        entry = workers.setdefault(w, {})
        entry["metrics_path"] = d / "metrics.jsonl"
        entry["rows"] = _read_jsonl(d / "metrics.jsonl")
        entry["alerts"] = _read_jsonl(d / "alerts.jsonl")
    if not workers:
        single: Optional[Path] = None
        for candidate in (run_dir / "metrics.jsonl", mdir / "metrics.jsonl"):
            if candidate.is_file():
                single = candidate
                break
        if single is None:
            raise ValueError(
                f"{run_dir} holds no fleet-worker-*.json ledgers, no "
                f"{mdir}/fleet-worker-*/metrics.jsonl, and no "
                "metrics.jsonl — not a run directory this report reads"
            )
        workers[0] = {
            "metrics_path": single,
            "rows": _read_jsonl(single),
            "alerts": _read_jsonl(run_dir / "alerts.jsonl")
            or _read_jsonl(mdir / "alerts.jsonl"),
        }
    return {
        "run_dir": run_dir,
        "workers": workers,
        # elastic-membership transition ledger (evict/admit/apply rows,
        # written by the acting lead) — absent file reads as []
        "membership": _read_jsonl(run_dir / "fleet-membership.jsonl"),
    }


def fleet_exit_rows(run: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
    """worker → its newest ``kind: "fleet"`` exit row, from a
    :func:`load_run` result (workers without one are absent)."""
    out: Dict[int, Dict[str, Any]] = {}
    for w, entry in run["workers"].items():
        row = _fleet_row(entry.get("rows") or [])
        if row is not None:
            out[w] = row
    return out


def sum_staleness(rows: Any) -> Optional[Dict[str, Any]]:
    """Cross-worker staleness histogram from fleet exit rows: cumulative
    buckets on the SHARED table sum exactly per ``le``. The one
    aggregation rule, the report's totals column. None when no row
    carries counts."""
    buckets: Dict[float, int] = {}
    count = 0
    mx: Optional[float] = None
    for row in rows:
        st = (row.get("histograms") or {}).get("staleness") or {}
        for le, cum in st.get("buckets") or []:
            buckets[float(le)] = buckets.get(float(le), 0) + int(cum)
        count += int(st.get("count") or 0)
        if isinstance(st.get("max"), (int, float)):
            mx = max(mx or 0.0, float(st["max"]))
    if not count:
        return None
    return {
        "count": count,
        "max": mx,
        "buckets": [[le, buckets[le]] for le in sorted(buckets)],
    }


def _fleet_row(rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    for row in reversed(rows):
        if row.get("kind") == "fleet":
            return row
    return None


def _pct(part: float, total: float) -> str:
    return f"{100 * part / total:.0f}%" if total > 0 else "-"


def _fmt_ms(v: Any) -> str:
    return f"{float(v) * 1e3:.1f}ms" if isinstance(v, (int, float)) else "-"


def _loss_series(rows: List[Dict[str, Any]]) -> List[Tuple[int, float]]:
    out = []
    for row in rows:
        if row.get("kind") != "step":
            continue
        loss = row.get("loss")
        if isinstance(loss, str):
            # sanitize_json stores non-finite losses as "nan"/"inf"
            # strings (valid JSON); float() parses them back — they must
            # show up in the trajectory as non-finite points, not vanish
            try:
                loss = float(loss)
            except ValueError:
                continue
        if isinstance(loss, (int, float)):
            out.append((int(row.get("step") or 0), float(loss)))
    return out


def _sample(series: List[Tuple[int, float]], n: int = 8) -> List[Tuple[int, float]]:
    if len(series) <= n:
        return series
    idx = [round(i * (len(series) - 1) / (n - 1)) for i in range(n)]
    return [series[i] for i in idx]


def build_run_report(
    run_dir: Path,
    metrics_dir: Optional[Path] = None,
    *,
    run: Optional[Dict[str, Any]] = None,
) -> str:
    """The markdown run report (see module docstring). Sections appear
    only when their evidence exists — an honest report of what the run
    recorded, not a template of dashes. Pass an already-:func:`load_run`
    result via ``run`` to skip the second read."""
    if run is None:
        run = load_run(run_dir, metrics_dir)
    workers = run["workers"]
    ids = sorted(workers)
    ledgers = {
        w: e["ledger"] for w, e in workers.items() if "ledger" in e
    }
    fleet_rows = fleet_exit_rows(run)
    lines: List[str] = [f"# Training run report: `{run['run_dir']}`", ""]

    # -- fleet header ---------------------------------------------------
    if ledgers:
        any_l = next(iter(ledgers.values()))
        total_words = sum(int(l.get("words_seen") or 0) for l in ledgers.values())
        slowest = max(float(l.get("seconds") or 0.0) for l in ledgers.values())
        wps = f"{total_words / slowest:,.0f}" if slowest > 0 else "-"
        lines += [
            f"Async trainer fleet: **{any_l.get('n_workers')} worker(s)**, "
            f"quorum {any_l.get('quorum')}, "
            f"max staleness {any_l.get('max_staleness')} — "
            f"{total_words:,} words over {slowest:.1f}s "
            f"(slowest worker) = **{wps} words/s** fleet-wide.",
            "",
            "## Per-worker summary",
            "",
            "| worker | steps | words | seconds | version | pushed "
            "| received | applied | discarded | push-failed | interrupted |",
            "|---|---|---|---|---|---|---|---|---|---|---|",
        ]
        for w in ids:
            l = ledgers.get(w)
            if not l:
                continue
            c = l.get("counters") or {}
            lines.append(
                f"| {w} | {l.get('steps')} "
                f"| {int(l.get('words_seen') or 0):,} "
                f"| {float(l.get('seconds') or 0.0):.1f} "
                f"| {l.get('version')} "
                f"| {int(c.get('grad_pushed') or 0)} "
                f"| {int(c.get('grad_received') or 0)} "
                f"| {int(c.get('grad_applied') or 0)} "
                f"| {int(c.get('grad_discarded') or 0)} "
                f"| {int(c.get('push_failed') or 0)} "
                f"| {'yes' if l.get('interrupted') else 'no'} |"
            )
        lines.append("")

    # -- membership timeline (elastic fleet) -----------------------------
    member_rows = run.get("membership") or []
    if member_rows:
        final_epoch = max(
            (int(r.get("epoch") or 0) for r in member_rows), default=0
        )
        lines += [
            "## Membership timeline",
            "",
            f"Final membership epoch **{final_epoch}** across "
            f"{len(member_rows)} recorded transition(s).",
            "",
            "| unix time | event | epoch | detail | active |",
            "|---|---|---|---|---|",
        ]
        for row in sorted(
            member_rows, key=lambda r: float(r.get("ts") or 0.0)
        ):
            ev = row.get("event")
            if ev == "evict":
                detail = (
                    f"lead {row.get('lead')} evicted {row.get('evicted')}"
                )
            elif ev == "admit":
                detail = (
                    f"lead {row.get('lead')} admitted {row.get('admitted')}"
                )
            elif ev == "apply":
                detail = (
                    f"worker {row.get('worker')} re-owned "
                    f"{row.get('resharded')} shard group(s), "
                    f"opt from {row.get('opt_source')}"
                )
            elif ev == "join-requested":
                detail = f"worker {row.get('worker')} asked to rejoin"
            else:
                detail = "-"
            active = row.get("active")
            lines.append(
                f"| {float(row.get('ts') or 0.0):.1f} | {ev} "
                f"| {row.get('epoch')} | {detail} "
                f"| {active if active is not None else '-'} |"
            )
        lines.append("")

    # -- phase share ----------------------------------------------------
    phase_names = ("data", "pull", "grad", "push", "apply_wait")
    phase_rows = []
    for w in ids:
        src = ledgers.get(w) or fleet_rows.get(w) or {}
        phases = src.get("phases") or {}
        if phases:
            phase_rows.append((w, phases))
    if phase_rows:
        lines += [
            "## Phase share (per-worker loop seconds)",
            "",
            "| worker | " + " | ".join(phase_names) + " | total s |",
            "|---|" + "---|" * (len(phase_names) + 1),
        ]
        for w, phases in phase_rows:
            total = sum(float(v) for v in phases.values())
            lines.append(
                f"| {w} | "
                + " | ".join(
                    _pct(float(phases.get(p) or 0.0), total)
                    for p in phase_names
                )
                + f" | {total:.1f} |"
            )
        lines.append("")

    # -- loss trajectories ---------------------------------------------
    loss_by_worker = {
        w: _loss_series(workers[w].get("rows") or []) for w in ids
    }
    if any(loss_by_worker.values()):
        lines += ["## Per-worker loss trajectories", ""]
        for w in ids:
            series = loss_by_worker[w]
            if not series:
                continue
            finite = [v for _, v in series if math.isfinite(v)]
            nonfinite = len(series) - len(finite)
            spark = sparkline([v for _, v in series])
            head = (
                f"- worker {w} ({len(series)} step(s)"
                + (f", {nonfinite} non-finite" if nonfinite else "")
                + f"): `{spark}`"
            )
            if finite:
                head += (
                    f" first {finite[0]:.4g} last {finite[-1]:.4g} "
                    f"min {min(finite):.4g}"
                )
            lines.append(head)
            sampled = _sample(series)
            lines.append(
                "  steps "
                + "  ".join(
                    f"{s}:{v:.3g}" if math.isfinite(v) else f"{s}:nan"
                    for s, v in sampled
                )
            )
        lines.append("")

    # -- staleness / dynamics histograms --------------------------------
    stale = {
        w: (r.get("histograms") or {}).get("staleness")
        for w, r in fleet_rows.items()
    }
    stale = {w: h for w, h in stale.items() if isinstance(h, dict) and h.get("count")}
    merged_stale = sum_staleness(fleet_rows.values())
    if stale and merged_stale:
        totals = {float(le): int(cum) for le, cum in merged_stale["buckets"]}
        lines += [
            "## Staleness histogram (version lag of accepted pushes, "
            "cumulative)",
            "",
            "| le | " + " | ".join(f"worker {w}" for w in sorted(stale))
            + " | total |",
            "|---|" + "---|" * (len(stale) + 1),
        ]
        for le in sorted(totals):
            cells = []
            for w in sorted(stale):
                cum = dict(
                    (float(b[0]), int(b[1]))
                    for b in stale[w].get("buckets") or []
                ).get(le, 0)
                cells.append(str(cum))
            lines.append(
                f"| {int(le)} | " + " | ".join(cells)
                + f" | {totals[le]} |"
            )
        counts = "  ".join(
            f"worker {w}: n={stale[w]['count']} max={stale[w].get('max')}"
            for w in sorted(stale)
        )
        lines += ["", f"accepted-push totals: {counts}", ""]

    # -- wire table (the compression ledger) -----------------------------
    wire_rows = []
    for w in ids:
        src = ledgers.get(w) or fleet_rows.get(w) or {}
        c = src.get("counters") or {}
        if any(c.get(k) for k in ("wire_push_bytes", "wire_pull_bytes")):
            wire_rows.append((w, src, c))
    if wire_rows:
        lines += [
            "## Wire bytes (actual vs f32-equivalent)",
            "",
            "| worker | codec | delta window | pushed | pushed f32-eq "
            "| push ratio | pulled | pulled f32-eq | pull ratio |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for w, src, c in wire_rows:
            def _mb(name: str) -> float:
                return float(c.get(name) or 0) / 1e6

            def _ratio(actual: str, raw: str) -> str:
                a, r = float(c.get(actual) or 0), float(c.get(raw) or 0)
                return f"{r / a:.1f}x" if a > 0 else "-"

            lines.append(
                f"| {w} | {src.get('grad_compression') or '-'} "
                f"| {src.get('param_delta_window', '-')} "
                f"| {_mb('wire_push_bytes'):.2f}MB "
                f"| {_mb('wire_push_bytes_uncompressed'):.2f}MB "
                f"| {_ratio('wire_push_bytes', 'wire_push_bytes_uncompressed')} "
                f"| {_mb('wire_pull_bytes'):.2f}MB "
                f"| {_mb('wire_pull_bytes_uncompressed'):.2f}MB "
                f"| {_ratio('wire_pull_bytes', 'wire_pull_bytes_uncompressed')} |"
            )
        lines.append("")
    timing = []
    for w in sorted(fleet_rows):
        h = fleet_rows[w].get("histograms") or {}
        qw, ap = h.get("quorum_wait_seconds") or {}, h.get("apply_seconds") or {}
        if qw.get("count") or ap.get("count"):
            timing.append(
                f"| {w} | {_fmt_ms(qw.get('p50'))} | {_fmt_ms(qw.get('p99'))} "
                f"| {_fmt_ms(ap.get('p50'))} | {_fmt_ms(ap.get('p99'))} "
                f"| {int(ap.get('count') or 0)} |"
            )
    if timing:
        lines += [
            "## Quorum-wait & apply timing",
            "",
            "| worker | quorum-wait p50 | p99 | apply p50 | p99 | applies |",
            "|---|---|---|---|---|---|",
            *timing,
            "",
        ]

    # -- host resources (hoststats eval-row blocks) ---------------------
    host_rows = []
    for w in ids:
        procs = [
            r.get("process")
            for r in workers[w].get("rows") or []
            if isinstance(r.get("process"), dict)
        ]
        if procs:
            host_rows.append((w, procs))
    if host_rows:
        def _hb(v: Any) -> str:
            if not isinstance(v, (int, float)):
                return "-"
            return (
                f"{v / (1 << 30):.2f}GB" if v >= 1 << 30
                else f"{v / (1 << 20):.0f}MB"
            )

        lines += [
            "## Host resources",
            "",
            "Per-worker `/proc` truth sampled at eval boundaries "
            "(training/hoststats; docs/OBSERVABILITY.md \"Host resources "
            "& the run ledger\"). High involuntary ctx switches with low "
            "cpu% = the host is contended, not the model slow.",
            "",
            "| worker | cpu% last | cpu% max | rss | rss peak | threads "
            "| fds | ctx vol | ctx invol |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for w, procs in host_rows:
            last = procs[-1]
            cpus = [
                float(p["cpu_percent"]) for p in procs
                if isinstance(p.get("cpu_percent"), (int, float))
            ]
            peaks = [
                float(p["rss_peak_bytes"]) for p in procs
                if isinstance(p.get("rss_peak_bytes"), (int, float))
            ]
            lines.append(
                f"| {w} "
                f"| {f'{cpus[-1]:.0f}' if cpus else '-'} "
                f"| {f'{max(cpus):.0f}' if cpus else '-'} "
                f"| {_hb(last.get('rss_bytes'))} "
                f"| {_hb(max(peaks) if peaks else None)} "
                f"| {last.get('threads') if last.get('threads') is not None else '-'} "
                f"| {last.get('open_fds') if last.get('open_fds') is not None else '-'} "
                f"| {last.get('ctx_switches_voluntary') if last.get('ctx_switches_voluntary') is not None else '-'} "
                f"| {last.get('ctx_switches_involuntary') if last.get('ctx_switches_involuntary') is not None else '-'} |"
            )
        lines.append("")

    # -- alert & anomaly timeline --------------------------------------
    alert_events: List[Tuple[float, str]] = []
    for w in ids:
        for row in workers[w].get("alerts") or []:
            t = row.get("unix_time")
            if isinstance(t, (int, float)):
                alert_events.append((
                    float(t),
                    f"[worker {w}] {row.get('alert')} "
                    f"{row.get('from')} → {row.get('to')} "
                    f"({row.get('severity')}): {row.get('detail')}",
                ))
    anomaly_events: List[Tuple[float, str]] = []
    for w in ids:
        for row in workers[w].get("rows") or []:
            if row.get("kind") != "anomaly":
                continue
            t = row.get("t")
            anomaly_events.append((
                float(t) if isinstance(t, (int, float)) else 0.0,
                f"[worker {w}] {row.get('anomaly')}: {row.get('message')}",
            ))
    if alert_events or anomaly_events:
        lines += ["## Alert & anomaly timeline", ""]
        for t, text in sorted(alert_events):
            lines.append(f"- unix {t:.1f}  {text}")
        for t, text in sorted(anomaly_events):
            lines.append(f"- t+{t:.1f}s  {text}")
        lines.append("")
    else:
        lines += ["## Alert & anomaly timeline", "", "- none recorded", ""]
    return "\n".join(lines)
