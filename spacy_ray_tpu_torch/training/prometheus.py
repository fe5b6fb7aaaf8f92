"""Prometheus text exposition (version 0.0.4) for the repo's metric
registries — the bridge from the bespoke JSON ``/metrics`` payloads to
any off-the-shelf scraper.

The JSON snapshots stay the in-repo contract (the autoscaler, the canary
guard, ``bench.py`` all read them); this module renders the SAME
snapshot dicts as standard exposition text, so ``GET
/metrics?format=prometheus`` on a replica, the router, or the trainer
needs no second bookkeeping path that could drift from the JSON one.

Honesty rules, because exposition semantics are a contract with the
scraper:

* counters render as ``<name>_total`` with ``# TYPE ... counter``;
* gauges with a ``None`` value are OMITTED (an absent series is the
  exposition spelling of "this backend doesn't report that"), never
  rendered as a fake 0;
* histograms WITH cumulative bucket tables (``_Histogram(buckets=...)``)
  render as real Prometheus histograms — ``_bucket{le="..."}`` series
  (cumulative, ``+Inf`` == ``_count``), ``_sum``, ``_count`` — which a
  scraper may sum across replicas exactly;
* histograms WITHOUT buckets render as summaries (``{quantile="..."}``
  from the bounded sample ring) — the honest label for percentiles that
  cannot be aggregated downstream.

Stdlib-only; safe to import in processes that never load jax (the
router, ``telemetry top``).

The port's copy of ``spacy_ray_tpu/training/prometheus.py``, unchanged: the
serving engine's ``/metrics`` reads it.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["PromFamilies", "render_snapshot", "metric_name", "EXPOSITION_CONTENT_TYPE"]

EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INVALID_NAME_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def metric_name(prefix: str, name: str) -> str:
    """``<prefix>_<name>`` with every invalid character collapsed to
    ``_`` — registry names are free-form strings; exposition names are
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = _INVALID_NAME_CHARS.sub("_", f"{prefix}_{name}")
    return out if not out[:1].isdigit() else f"_{out}"


def _escape_label(v: Any) -> str:
    return "".join(_LABEL_ESCAPES.get(c, c) for c in str(v))


def _fmt_value(v: Any) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else _fmt_value(bound)


class PromFamilies:
    """Collects samples grouped into metric families, then renders the
    whole exposition in one pass — the grouping is what lets the router
    emit one ``# TYPE`` header above N replicas' labeled series (the
    format forbids repeating it per label set)."""

    def __init__(self) -> None:
        # name -> (type, [(sorted label items, value)])
        self._families: "Dict[str, Tuple[str, List[Tuple[Tuple[Tuple[str, str], ...], str]]]]" = {}
        self._order: List[str] = []

    def add(
        self,
        name: str,
        mtype: str,
        value: Any,
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        if value is None:
            return  # absent, not zero — the honest-gauge rule
        if name not in self._families:
            self._families[name] = (mtype, [])
            self._order.append(name)
        family_type, samples = self._families[name]
        if family_type != mtype:
            raise ValueError(
                f"metric family {name!r} registered as {family_type}, "
                f"re-added as {mtype}"
            )
        items = tuple(
            sorted((str(k), _escape_label(v)) for k, v in (labels or {}).items())
        )
        samples.append((items, _fmt_value(value)))

    # -- snapshot ingestion -------------------------------------------
    def add_snapshot(
        self,
        snapshot: Dict[str, Any],
        *,
        prefix: str,
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Ingest one ``MetricsRegistry.snapshot()``-shaped dict (the
        ``counters``/``gauges``/``histograms`` triple every telemetry
        facade in this repo emits) under ``prefix`` with ``labels`` on
        every series."""
        for key, value in sorted((snapshot.get("counters") or {}).items()):
            if isinstance(value, (int, float)):
                self.add(
                    metric_name(prefix, f"{key}_total"), "counter",
                    value, labels,
                )
        for key, value in sorted((snapshot.get("gauges") or {}).items()):
            if isinstance(value, (int, float)):
                self.add(metric_name(prefix, key), "gauge", value, labels)
        for key, hist in sorted((snapshot.get("histograms") or {}).items()):
            if isinstance(hist, dict):
                self.add_histogram(metric_name(prefix, key), hist, labels)

    def add_histogram(
        self,
        name: str,
        hist: Dict[str, Any],
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One histogram snapshot: real ``_bucket`` exposition when a
        cumulative bucket table exists, summary quantiles otherwise."""
        count = hist.get("count") or 0
        total = hist.get("sum") or 0.0
        base = dict(labels or {})
        buckets = hist.get("buckets")
        if buckets:
            for le, cum in buckets:
                self.add(
                    f"{name}_bucket", "histogram", cum,
                    {**base, "le": _fmt_le(float(le))},
                )
            self.add(
                f"{name}_bucket", "histogram", count, {**base, "le": "+Inf"}
            )
            self.add(f"{name}_sum", "histogram", total, base)
            self.add(f"{name}_count", "histogram", count, base)
            return
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            v = hist.get(key)
            if isinstance(v, (int, float)):
                self.add(name, "summary", v, {**base, "quantile": q})
        self.add(f"{name}_sum", "summary", total, base)
        self.add(f"{name}_count", "summary", count, base)

    # -- rendering -----------------------------------------------------
    def render(self) -> str:
        lines: List[str] = []
        typed: set = set()
        for name in self._order:
            mtype, samples = self._families[name]
            # one TYPE line per family; _bucket/_sum/_count share their
            # parent histogram/summary family's header
            family = re.sub(r"_(bucket|sum|count)$", "", name) if mtype in (
                "histogram", "summary"
            ) else name
            if family not in typed:
                typed.add(family)
                lines.append(f"# TYPE {family} {mtype}")
            for items, value in samples:
                if items:
                    label_s = ",".join(f'{k}="{v}"' for k, v in items)
                    lines.append(f"{name}{{{label_s}}} {value}")
                else:
                    lines.append(f"{name} {value}")
        return "\n".join(lines) + ("\n" if lines else "")


def render_snapshot(
    snapshot: Dict[str, Any],
    *,
    prefix: str,
    labels: Optional[Dict[str, Any]] = None,
) -> str:
    """One registry snapshot → exposition text (the replica/trainer
    case; the router assembles a multi-source :class:`PromFamilies`)."""
    fam = PromFamilies()
    fam.add_snapshot(snapshot, prefix=prefix, labels=labels)
    return fam.render()
