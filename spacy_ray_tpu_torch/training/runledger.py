"""The run ledger and regression sentry (``spacy_ray_tpu/training/runledger.py``):
performance history across runs.

Bench session records (``BENCH_SESSION.jsonl``) and ``telemetry report`` run
directories are normalized into rows keyed by **(spec name, platform, shape,
config labels)**, so that a record is only compared with its peers:

* ``list``/``show`` — the history of each key, and whether it is clean;
* ``diff`` — two records compared, the delta judged against the records'
  own noise evidence (per-rep dispersion, the matmul-reprobe stamps);
  records of two platforms are refused (a CPU number against a card's is
  not a delta);
* ``regress`` — a fresh record judged against the latest clean baseline of
  its key with a noise-aware threshold; only a confirmed regression fails.

Trust rules:

* a record whose post-run matmul reprobe fell below ``CLEAN_REPROBE_RATIO``
  (or that stamped ``contended``) is no baseline, and a contended fresh
  record never confirms a regression;
* the noise band of a comparison is the largest of a floor, both records'
  per-rep dispersion and both records' reprobe slack (1 - reprobe ratio);
  a delta inside it is "within noise";
* torn or foreign lines of a session file are counted and skipped.

Standard library only; the rows, keys, verdicts and text are the JAX
package's, over the port's run directories (:mod:`.report`).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "LedgerError",
    "CLEAN_REPROBE_RATIO",
    "NOISE_FLOOR",
    "normalize_record",
    "ingest_session",
    "ingest_run_dir",
    "row_key",
    "dispersion",
    "noise_band",
    "diff_rows",
    "latest_clean_baseline",
    "regress",
    "render_rows",
    "render_diff",
    "render_verdicts",
]


class LedgerError(ValueError):
    """A refused comparison (cross-platform, unknown selector) — the
    CLI maps it to exit 2, distinct from a confirmed regression's 1."""


# The JAX package's bench.py CLEAN_REPROBE_RATIO: below this post-run
# matmul reprobe ratio a record may not serve as a cross-run baseline.
CLEAN_REPROBE_RATIO = 0.94

# The minimum relative band any verdict must clear (the JAX package's
# floor, from its bench records on its own hosts): a sub-5% delta between
# two records is never treated as signal without cleaner evidence.
NOISE_FLOOR = 0.05

# Config labels that make two records different ARMS rather than two
# measurements of the same thing (codec, sharding mode, precision,
# quorum topology). Status strings like "active (pallas)" keep only
# their first token — the parenthetical detail varies by host probe.
_LABEL_FIELDS = (
    "grad_compression",
    "param_delta_window",
    "update_sharding",
    "fused_update",
    "param_shadow",
    "flash",
    "precision_label",
    "batching",
    "mode",
    "quorum",
    "max_staleness",
)

_SHAPE_FIELDS = ("B", "T", "devices", "workers", "replicas")


def _norm_label(v: Any) -> Any:
    if isinstance(v, str) and " (" in v:
        return v.split(" (", 1)[0]
    return v


def _label_is_default(key: str, v: Any) -> bool:
    """A knob at its OFF default is the same arm as history that
    predates the knob: older records omit the field entirely, so
    stamping the default into the key would fragment the append-only
    history into spurious before/after arms (the bench-gate smoke would
    forever see "no-baseline"). f32 gradients are "no compression",
    window 0 is "no delta pulls"."""
    if v in (False, "off", "none", "disabled"):
        return True
    if key == "param_delta_window" and not v:
        return True
    if key == "grad_compression" and v == "f32":
        return True
    return False


def normalize_record(
    rec: Dict[str, Any], *, source: str = ""
) -> Optional[Dict[str, Any]]:
    """One session record → one ledger row, or None for rows that carry
    no comparable measurement (skip stubs, records without a value)."""
    if not isinstance(rec, dict) or rec.get("skipped"):
        return None
    name = rec.get("name")
    value = rec.get("value")
    if not name or not isinstance(value, (int, float)):
        return None
    shape = {
        k: rec[k] for k in _SHAPE_FIELDS
        if isinstance(rec.get(k), (int, float))
    }
    labels = {}
    for k in _LABEL_FIELDS:
        if rec.get(k) is None:
            continue
        v = _norm_label(rec[k])
        if not _label_is_default(k, v):
            labels[k] = v
    reps = rec.get("wps_reps")
    return {
        "name": str(name),
        "platform": rec.get("platform"),
        "metric": rec.get("metric"),
        "unit": rec.get("unit"),
        "value": float(value),
        "shape": shape,
        "labels": labels,
        "contended": rec.get("contended"),
        "peak_reprobe_ratio": rec.get("peak_reprobe_ratio"),
        "n_reps": rec.get("n_reps"),
        "reps": [float(r) for r in reps] if isinstance(reps, list) else None,
        "rep_min": rec.get("wps_min"),
        "rep_max": rec.get("wps_max"),
        "host": rec.get("host") if isinstance(rec.get("host"), dict) else None,
        "recorded_at": rec.get("recorded_at"),
        "run_id": rec.get("run_id"),
        "source": source,
    }


def ingest_session(path: Path) -> Tuple[List[Dict[str, Any]], int]:
    """(rows in file order, count of torn/foreign lines skipped)."""
    rows: List[Dict[str, Any]] = []
    skipped = 0
    try:
        text = Path(path).read_text(encoding="utf8")
    except OSError as e:
        raise LedgerError(f"cannot read session file {path}: {e}")
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            skipped += 1  # torn concurrent append: skip, never abort
            continue
        row = normalize_record(rec, source=f"{path}:{i}")
        if row is None:
            skipped += 1
            continue
        rows.append(row)
    return rows, skipped


def ingest_run_dir(run_dir: Path) -> List[Dict[str, Any]]:
    """A ``telemetry report`` run directory → ledger rows: the fleet's
    aggregate words/s from the per-worker exit ledgers (the same
    arithmetic bench.py commits), or a single-process run's newest eval
    row (wps + step time). Host truth rides along when the run's rows
    carry ``process`` blocks."""
    from .report import load_run

    run = load_run(Path(run_dir))
    rows: List[Dict[str, Any]] = []
    workers = run["workers"]
    ledgers = [
        e["ledger"] for e in workers.values() if isinstance(e.get("ledger"), dict)
    ]
    rss_peak = None
    platform = None
    for entry in workers.values():
        for r in entry.get("rows") or []:
            platform = r.get("platform") or platform
            proc = r.get("process")
            if isinstance(proc, dict) and isinstance(
                proc.get("rss_peak_bytes"), (int, float)
            ):
                rss_peak = max(rss_peak or 0, proc["rss_peak_bytes"])
    if ledgers:
        words = sum(float(l.get("words_seen") or 0) for l in ledgers)
        secs = max(float(l.get("seconds") or 0) for l in ledgers)
        if secs > 0:
            rec = {
                "name": "telemetry_run_fleet",
                "metric": f"run-dir words/s ({len(ledgers)} workers)",
                "value": round(words / secs, 1),
                "unit": "words/s",
                "platform": platform,
                "workers": len(ledgers),
                "grad_compression": ledgers[0].get("grad_compression"),
                "quorum": ledgers[0].get("quorum"),
                "host": {"rss_peak_bytes": rss_peak} if rss_peak else None,
            }
            row = normalize_record(rec, source=str(run_dir))
            if row is not None:
                rows.append(row)
        return rows
    for entry in workers.values():
        evals = [
            r for r in (entry.get("rows") or []) if r.get("kind") == "eval"
        ]
        if not evals:
            continue
        last = evals[-1]
        rec = {
            "name": "telemetry_run",
            "metric": "run-dir eval words/s",
            "value": last.get("wps"),
            "unit": "words/s",
            "platform": last.get("platform"),
            "host": {"rss_peak_bytes": rss_peak} if rss_peak else None,
        }
        row = normalize_record(rec, source=str(run_dir))
        if row is not None:
            rows.append(row)
    return rows


def row_key(row: Dict[str, Any]) -> str:
    """The comparability key: records compare only within it."""
    shape = ",".join(f"{k}={row['shape'][k]:g}" for k in sorted(row["shape"]))
    labels = ",".join(f"{k}={row['labels'][k]}" for k in sorted(row["labels"]))
    return "|".join(
        p for p in (
            row["name"], str(row.get("platform") or "?"), shape, labels
        ) if p
    )


def is_clean(row: Dict[str, Any]) -> bool:
    """Baseline-worthy: not contended, and any reprobe stamp at or
    above the clean edge. An unstamped record (no reprobe machinery on
    that spec) counts as clean unless it stamped contended."""
    if row.get("contended"):
        return False
    ratio = row.get("peak_reprobe_ratio")
    return ratio is None or float(ratio) >= CLEAN_REPROBE_RATIO


def dispersion(row: Dict[str, Any]) -> Optional[float]:
    """Relative per-rep spread ((max-min)/value) — the record's own
    run-to-run noise evidence."""
    lo, hi = row.get("rep_min"), row.get("rep_max")
    if (
        isinstance(lo, (int, float)) and isinstance(hi, (int, float))
        and row["value"] > 0
    ):
        return max(float(hi) - float(lo), 0.0) / float(row["value"])
    return None


def _reprobe_slack(row: Dict[str, Any]) -> Optional[float]:
    ratio = row.get("peak_reprobe_ratio")
    if isinstance(ratio, (int, float)):
        return max(1.0 - float(ratio), 0.0)
    return None


def noise_band(
    a: Dict[str, Any], b: Dict[str, Any], *, floor: float = NOISE_FLOOR
) -> float:
    """The relative band a delta must clear to be signal: the max of
    the floor, both records' rep dispersion, and both records' reprobe
    slack (a 0.88 reprobe means the host was ~12% depressed — a 12%
    delta between such records proves nothing)."""
    candidates = [float(floor)]
    for row in (a, b):
        d = dispersion(row)
        if d is not None:
            candidates.append(d)
        s = _reprobe_slack(row)
        if s is not None:
            candidates.append(s)
    return max(candidates)


def _lower_is_better(row: Dict[str, Any]) -> bool:
    unit = str(row.get("unit") or "")
    return "second" in unit or unit.endswith("ms") or unit.startswith("ms")


def diff_rows(
    a: Dict[str, Any], b: Dict[str, Any], *, floor: float = NOISE_FLOOR
) -> Dict[str, Any]:
    """Compare two ledger rows (a = older/baseline, b = newer).
    Raises :class:`LedgerError` on a cross-platform pair; returns the
    delta judged against the pair's noise band, with contended arms and
    key mismatches flagged rather than hidden."""
    if (a.get("platform") or "?") != (b.get("platform") or "?"):
        raise LedgerError(
            f"refusing cross-platform diff: {a['name']} is "
            f"{a.get('platform')!r}, {b['name']} is {b.get('platform')!r} "
            "— a delta across platforms is a category error, not a number"
        )
    warnings: List[str] = []
    if row_key(a) != row_key(b):
        warnings.append(
            f"keys differ ({row_key(a)} vs {row_key(b)}): this is an A/B "
            "across configs, not a history delta"
        )
    for label, row in (("a", a), ("b", b)):
        if row.get("contended"):
            warnings.append(
                f"arm {label} is CONTENDED (reprobe "
                f"{row.get('peak_reprobe_ratio')}): its value is a floor, "
                "not a measurement"
            )
    band = noise_band(a, b, floor=floor)
    delta = (
        (b["value"] - a["value"]) / a["value"] if a["value"] else math.inf
    )
    lower_better = _lower_is_better(a)
    if abs(delta) <= band:
        verdict = "within-noise"
    elif (delta < 0) != lower_better:
        # moved the wrong way for this unit's direction: a drop in a
        # higher-is-better metric, or a rise in seconds/step
        verdict = "regressed"
    else:
        verdict = "improved"
    return {
        "a": {"value": a["value"], "recorded_at": a.get("recorded_at"),
              "source": a.get("source")},
        "b": {"value": b["value"], "recorded_at": b.get("recorded_at"),
              "source": b.get("source")},
        "unit": a.get("unit"),
        "delta_pct": round(delta * 100.0, 2),
        "band_pct": round(band * 100.0, 2),
        "verdict": verdict,
        "warnings": warnings,
    }


def latest_clean_baseline(
    rows: List[Dict[str, Any]], key: str
) -> Optional[Dict[str, Any]]:
    """Newest clean row for ``key`` in file order (the session file is
    append-only, so file order IS time order even when older records
    predate the recorded_at stamp)."""
    for row in reversed(rows):
        if row_key(row) == key and is_clean(row):
            return row
    return None


def regress(
    fresh: List[Dict[str, Any]],
    baseline_rows: List[Dict[str, Any]],
    *,
    floor: float = NOISE_FLOOR,
) -> List[Dict[str, Any]]:
    """The sentry: one verdict per fresh row.

    * ``regression`` — fresh is CLEAN and fell beyond the noise band
      vs the latest clean baseline (the only verdict that exits 1);
    * ``untrusted`` — fresh is contended/dirty: whatever it measured,
      contention already explains it (warn, never block CI on it);
    * ``ok`` / ``improved`` / ``within-noise`` — self-describing;
    * ``no-baseline`` — first record for its key: it BECOMES history.
    """
    verdicts: List[Dict[str, Any]] = []
    for row in fresh:
        key = row_key(row)
        base = latest_clean_baseline(baseline_rows, key)
        entry: Dict[str, Any] = {
            "name": row["name"],
            "key": key,
            "fresh_value": row["value"],
            "unit": row.get("unit"),
            "host": row.get("host"),
        }
        if base is None:
            entry.update(verdict="no-baseline", reason=(
                "no clean committed record for this key — this record "
                "becomes the baseline"
            ))
            verdicts.append(entry)
            continue
        d = diff_rows(base, row, floor=floor)
        entry.update(
            baseline_value=base["value"],
            baseline_recorded_at=base.get("recorded_at"),
            delta_pct=d["delta_pct"],
            band_pct=d["band_pct"],
        )
        if not is_clean(row):
            entry.update(verdict="untrusted", reason=(
                f"fresh record is contended (reprobe "
                f"{row.get('peak_reprobe_ratio')}) — a drop here is "
                "explained by the host, not the code"
            ))
        elif d["verdict"] == "regressed":
            entry.update(verdict="regression", reason=(
                f"clean fresh record fell {abs(d['delta_pct']):.1f}% vs "
                f"the clean baseline, beyond the {d['band_pct']:.1f}% "
                "noise band"
            ))
        elif d["verdict"] == "improved":
            entry.update(verdict="improved", reason=(
                f"{abs(d['delta_pct']):.1f}% better than baseline "
                f"(band {d['band_pct']:.1f}%)"
            ))
        else:
            entry.update(verdict="ok", reason=(
                f"delta {d['delta_pct']:+.1f}% within the "
                f"{d['band_pct']:.1f}% noise band"
            ))
        verdicts.append(entry)
    return verdicts


# -- rendering ---------------------------------------------------------
def render_rows(rows: List[Dict[str, Any]], *, skipped: int = 0) -> str:
    """``ledger list``: one line per key — history depth, clean count,
    latest value."""
    by_key: Dict[str, List[Dict[str, Any]]] = {}
    for row in rows:
        by_key.setdefault(row_key(row), []).append(row)
    lines = [f"run ledger: {len(rows)} records, {len(by_key)} keys"
             + (f" ({skipped} torn/stub lines skipped)" if skipped else "")]
    for key in sorted(by_key):
        hist = by_key[key]
        clean = sum(1 for r in hist if is_clean(r))
        last = hist[-1]
        stamp = last.get("recorded_at") or "-"
        lines.append(
            f"  {key}\n"
            f"    n={len(hist)} clean={clean} latest={last['value']:g} "
            f"{last.get('unit') or ''} @ {stamp}"
        )
    return "\n".join(lines)


def render_history(rows: List[Dict[str, Any]], name: str) -> str:
    """``ledger show NAME``: every record for keys under ``name``, in
    file order, with the trust stamps visible."""
    picked = [r for r in rows if r["name"] == name]
    if not picked:
        return f"no ledger rows named {name!r}"
    lines = [f"history for {name!r}: {len(picked)} record(s)"]
    for r in picked:
        ratio = r.get("peak_reprobe_ratio")
        disp = dispersion(r)
        lines.append(
            f"  {r.get('recorded_at') or '-':22s} {r['value']:>12g} "
            f"{(r.get('unit') or ''):14s} "
            f"reprobe={ratio if ratio is not None else '-':<6} "
            f"disp={f'{disp * 100:.1f}%' if disp is not None else '-':<6} "
            f"{'CONTENDED' if r.get('contended') else 'clean':<9} "
            f"{row_key(r)}"
        )
    return "\n".join(lines)


def render_diff(d: Dict[str, Any]) -> str:
    lines = [
        f"a: {d['a']['value']:g} {d.get('unit') or ''} "
        f"@ {d['a'].get('recorded_at') or '-'}",
        f"b: {d['b']['value']:g} {d.get('unit') or ''} "
        f"@ {d['b'].get('recorded_at') or '-'}",
        f"delta: {d['delta_pct']:+.2f}%  noise band: ±{d['band_pct']:.2f}%  "
        f"verdict: {d['verdict']}",
    ]
    for w in d.get("warnings") or []:
        lines.append(f"warning: {w}")
    return "\n".join(lines)


def render_verdicts(verdicts: List[Dict[str, Any]]) -> str:
    lines: List[str] = []
    for v in verdicts:
        head = f"[{v['verdict'].upper()}] {v['key']}"
        val = f"fresh={v['fresh_value']:g} {v.get('unit') or ''}"
        if v.get("baseline_value") is not None:
            val += (
                f" baseline={v['baseline_value']:g}"
                f" delta={v['delta_pct']:+.1f}%"
                f" band=±{v['band_pct']:.1f}%"
            )
        lines.append(head)
        lines.append(f"  {val}")
        lines.append(f"  {v.get('reason')}")
    n_reg = sum(1 for v in verdicts if v["verdict"] == "regression")
    lines.append(
        f"{len(verdicts)} verdict(s), {n_reg} confirmed regression(s)"
    )
    return "\n".join(lines)
