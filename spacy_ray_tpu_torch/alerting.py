"""In-process alert engine (``spacy_ray_tpu/alerting.py``): declarative
rules evaluated over telemetry snapshots, with the Prometheus alerting state
machine (inactive -> pending -> firing -> resolved) and the multi-window
error-budget burn rate of the SRE workbook.

Each process (a trainer, a trainer-fleet worker; the server and the fleet
router once they carry an engine) evaluates its own rule set against its
own registry snapshots on a slow cadence (seconds), and the alert state
goes everywhere the metrics already go:

* Prometheus series (``srt_alert_state{alert,severity}`` 0/1/2 and
  ``srt_alert_fired_total{alert}``) through :meth:`AlertEngine.add_prometheus`;
* ``/admin/alerts`` (:meth:`AlertEngine.states`);
* an ``alerts`` block in the ``/metrics`` JSON (:meth:`AlertEngine.summary`);
* a JSONL sink, one row per state transition;
* ``resilience.log_event``;
* an ``on_firing`` hook, through which the flight recorder dumps the last
  N seconds into an incident bundle (:mod:`~.incidents`).

Three rule kinds: :class:`BurnRateRule` (a ``(long_s, short_s, factor)``
window pair is breached when both windows burn the error budget at
``factor`` or more; any breached pair activates the rule),
:class:`ThresholdRule` (a snapshot value, or with ``window_s`` a counter's
increase over the trailing window, against a bound) and
:class:`AbsenceRule` (a counter that stopped moving for ``stale_s``).

The clock is injected end to end: the tests drive every window with a fake
clock. Standard library only; the rules, names, parameters, transitions,
sink rows and exposition text are the JAX package's.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple, Union,
)

__all__ = [
    "SnapshotHistory",
    "AlertRule",
    "ThresholdRule",
    "AbsenceRule",
    "BurnRateRule",
    "AlertState",
    "AlertEngine",
    "STATE_VALUES",
    "DEFAULT_BURN_WINDOWS",
    "default_serving_rules",
    "default_router_rules",
    "default_training_rules",
    "process_rules",
]

# numeric encoding of the alert state for the Prometheus gauge — the
# same 0/1/2 convention Prometheus's own ALERTS series implies
STATE_VALUES = {"inactive": 0, "pending": 1, "firing": 2}

# (long_s, short_s, factor) pairs, SRE-workbook shape scaled to this
# repo's process lifetimes (a serving replica lives minutes-to-days, not
# the 30-day SLO month the book's 14.4x/6x factors assume): the fast
# pair pages when ~a quarter of the budget burns within a minute; the
# slow pair tickets a smolder that would exhaust the budget in tens of
# minutes. Both windows of a pair must burn — that is what makes the
# alert resolve quickly once the bleeding stops.
DEFAULT_BURN_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 60.0, 14.4),
    (1800.0, 300.0, 6.0),
)


def _lookup(snapshot: Optional[Dict[str, Any]], path: str) -> Optional[float]:
    """Dotted-path numeric lookup (``"counters.requests"``,
    ``"router.slo_window.request_latency_p99"``); None when any segment
    is missing or the leaf is not a number."""
    cur: Any = snapshot
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return float(cur) if isinstance(cur, (int, float)) else None


class SnapshotHistory:
    """Bounded time-series of the values the rules actually read.

    The engine does NOT retain whole registry snapshots (a burn-rate
    rule with a 30-minute window at a 2 s cadence would pin ~900 full
    histogram snapshots): at append time it extracts only the paths its
    rules reference, so each retained sample is a handful of floats.
    """

    def __init__(self, paths: Sequence[str], *, max_samples: int = 4096):
        self.paths = tuple(dict.fromkeys(paths))  # de-duped, order kept
        self._samples: "deque[Tuple[float, Dict[str, Optional[float]]]]" = (
            deque(maxlen=int(max_samples))
        )
        self._latest: Optional[Dict[str, Any]] = None

    def append(self, now: float, snapshot: Dict[str, Any]) -> None:
        self._latest = snapshot
        self._samples.append(
            (float(now), {p: _lookup(snapshot, p) for p in self.paths})
        )

    def __len__(self) -> int:
        return len(self._samples)

    def value(self, path: str) -> Optional[float]:
        """The path's value in the NEWEST snapshot (full-snapshot lookup,
        so threshold rules may read paths outside the extracted set)."""
        return _lookup(self._latest, path)

    def _at_or_before(self, t: float) -> Optional[Dict[str, Optional[float]]]:
        """Newest sample with timestamp <= t; None when history does not
        reach back that far (an honest no-signal, never a guess)."""
        found = None
        for ts, values in self._samples:
            if ts <= t:
                found = values
            else:
                break
        return found

    def span_s(self, now: float) -> float:
        """Seconds of history retained (0 when empty)."""
        if not self._samples:
            return 0.0
        return max(float(now) - self._samples[0][0], 0.0)

    def delta(
        self,
        path: str,
        window_s: float,
        now: float,
        *,
        allow_partial: bool = False,
    ) -> Optional[float]:
        """Counter increase over the trailing ``window_s``: newest value
        minus the value at (now - window_s). When the history does not
        reach back that far, None — unless ``allow_partial``, which
        falls back to the OLDEST sample: a count over a shorter span
        understates the window total, but a RATIO of two same-span
        partial deltas (the burn rate) is unbiased, and without it a
        process failing 100% of its requests from boot would be
        page-blind for its first ``window_s`` seconds."""
        if not self._samples:
            return None
        base = self._at_or_before(now - float(window_s))
        if base is None:
            if not allow_partial:
                return None
            base = self._samples[0][1]
        cur = self._samples[-1][1].get(path)
        if cur is None:
            return None
        prev = base.get(path)
        if prev is None:
            # the counter was born INSIDE the window (its instrument is
            # created lazily, after the base snapshot was taken): its
            # oldest observed value is the honest base. Without this, a
            # rule watching a lazily-created counter stays no-signal for
            # as long as the window reaches back past the birth — the
            # fleet divergence_flags counter hit exactly this.
            for _, values in self._samples:
                v = values.get(path)
                if v is not None:
                    prev = v
                    break
        if prev is None:
            return None
        # counter resets (process restart feeding one engine) clamp to 0
        return max(cur - prev, 0.0)


class AlertRule:
    """Base: name, severity, for-duration. Subclasses implement
    ``evaluate(history, now) -> (active, value, detail)`` where
    ``active`` is True/False, or None for "no signal" (not enough
    history / no traffic) — treated as not-active by the state machine
    but reported honestly in the detail string."""

    def __init__(
        self,
        name: str,
        *,
        severity: str = "page",
        for_s: float = 0.0,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        self.name = str(name)
        self.severity = str(severity)
        self.for_s = float(for_s)
        self.labels = dict(labels or {})

    def paths(self) -> List[str]:
        """Snapshot paths this rule reads (what the history retains)."""
        return []

    def evaluate(
        self, history: SnapshotHistory, now: float
    ) -> Tuple[Optional[bool], Optional[float], str]:
        raise NotImplementedError


_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class ThresholdRule(AlertRule):
    """``value(path) OP threshold`` — or, with ``window_s``, the
    counter's trailing-window increase compared against the bound (the
    scrape-failure rule: "this counter moved N times in the last W
    seconds" is an event-rate condition, not a level).

    ``arm_when=(op, value)`` keeps the rule no-signal until the path has
    EVER satisfied that precondition — the "it must have worked once
    before its absence is an incident" gate. The no-ready-replica rule
    uses it: during a fleet cold start every replica legitimately
    answers 503 "warming" for however long the bucket compile sweep
    takes (minutes), and paging on every clean boot would train
    operators to ignore the page that matters. Arming is persistent.

    ``partial=True`` (only meaningful with ``window_s``) judges the
    delta over however much history exists when the full window isn't
    retained yet — the same boot-blindness fix the burn rules carry: a
    partial-span count can only UNDERSTATE the window total, so a
    ``>=`` rule fires earlier but never spuriously. The
    fleet-worker-diverging rule uses it (a worker diverging in a run's
    first ``window_s`` must not be page-blind).
    """

    def __init__(
        self,
        name: str,
        path: str,
        op: str,
        threshold: float,
        *,
        window_s: Optional[float] = None,
        arm_when: Optional[Tuple[str, float]] = None,
        partial: bool = False,
        **kw: Any,
    ) -> None:
        super().__init__(name, **kw)
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        self.path = str(path)
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s) if window_s else None
        self.partial = bool(partial)
        if arm_when is not None and arm_when[0] not in _OPS:
            raise ValueError(
                f"arm_when op must be one of {sorted(_OPS)}, "
                f"got {arm_when[0]!r}"
            )
        self.arm_when = (
            (arm_when[0], float(arm_when[1])) if arm_when else None
        )
        self._armed = arm_when is None

    def paths(self) -> List[str]:
        return [self.path]

    def evaluate(
        self, history: SnapshotHistory, now: float
    ) -> Tuple[Optional[bool], Optional[float], str]:
        if self.window_s is not None:
            v = history.delta(
                self.path, self.window_s, now, allow_partial=self.partial
            )
            what = f"Δ{self.window_s:.0f}s({self.path})"
        else:
            v = history.value(self.path)
            what = self.path
        if v is None:
            return None, None, f"{what}: no signal"
        if not self._armed:
            op, bound = self.arm_when  # type: ignore[misc]
            if _OPS[op](v, bound):
                self._armed = True
            else:
                return None, v, (
                    f"{what} = {v:.6g}: not armed (never {op} {bound:g})"
                )
        active = _OPS[self.op](v, self.threshold)
        return active, v, f"{what} = {v:.6g} {self.op} {self.threshold:.6g}"


class AbsenceRule(AlertRule):
    """Fires when the watched counter has not CHANGED for ``stale_s`` —
    the signal-died failure mode. A path that was never observed at all
    is no-signal (the subsystem may simply not be running); staleness
    only starts counting once the signal has existed.

    ``arm_above``: stay no-signal until the value has EVER exceeded this
    bound — ThresholdRule's ``arm_when`` gate for the absence shape. The
    fleet push-stalled rule uses it: a topology that legitimately never
    pushes to peers (a fleet of one; peers that own no shards) exports a
    counter frozen at 0, and "it must have moved once before its freeze
    is an incident" is the difference between that and a wedged peer
    loop. Arming is persistent."""

    def __init__(
        self,
        name: str,
        path: str,
        stale_s: float,
        *,
        arm_above: Optional[float] = None,
        **kw: Any,
    ) -> None:
        super().__init__(name, **kw)
        self.path = str(path)
        self.stale_s = float(stale_s)
        self.arm_above = float(arm_above) if arm_above is not None else None
        self._armed = arm_above is None
        self._last_value: Optional[float] = None
        self._last_change: Optional[float] = None

    def paths(self) -> List[str]:
        return [self.path]

    def evaluate(
        self, history: SnapshotHistory, now: float
    ) -> Tuple[Optional[bool], Optional[float], str]:
        v = history.value(self.path)
        if not self._armed:
            if v is not None and v > self.arm_above:
                self._armed = True
            else:
                return None, v, (
                    f"{self.path}: not armed (never > {self.arm_above:g})"
                )
        if v is not None and v != self._last_value:
            self._last_value = v
            self._last_change = now
        if self._last_change is None:
            return None, None, f"{self.path}: never observed"
        age = now - self._last_change
        return (
            age >= self.stale_s,
            age,
            f"{self.path} unchanged for {age:.1f}s "
            f"(stale after {self.stale_s:.0f}s)",
        )


class BurnRateRule(AlertRule):
    """Multi-window error-budget burn rate (SRE workbook ch. 5).

    ``bad`` counters over ``total`` give the error rate; dividing by the
    budget ``1 - slo`` gives the burn rate (burn 1.0 = spending the
    budget exactly as fast as the SLO allows). A window pair activates
    when BOTH its long and short windows burn at ≥ ``factor``; the rule
    is active when ANY pair is. Zero traffic in a window is no-signal
    for that pair (no requests burn no budget), and the rule only
    reports no-signal when EVERY pair lacks signal.

    Early-life semantics: once the history spans a pair's SHORT window,
    its long-window burn is computed over whatever span exists (the
    ratio is unbiased; Prometheus ``increase()`` extrapolates the same
    way) — a replica failing everything from boot pages after
    ``short_s``, not after ``long_s`` of blindness. Before the short
    window is spanned the pair is no-signal.
    """

    def __init__(
        self,
        name: str,
        *,
        total: Union[str, Sequence[str]],
        bad: Union[str, Sequence[str]],
        slo: float = 0.99,
        windows: Sequence[Tuple[float, float, float]] = DEFAULT_BURN_WINDOWS,
        **kw: Any,
    ) -> None:
        super().__init__(name, **kw)
        if not 0.0 < slo < 1.0:
            raise ValueError(f"slo must be in (0, 1), got {slo}")
        # total may be a LIST summed like bad: when a telemetry surface
        # counts rejected work in separate counters that never reach the
        # main requests counter (a pre-admission 429 is still a request
        # the caller made), the denominator must include them or a
        # 100%-rejection outage reads as "no traffic, no burn"
        self.total = (
            [total] if isinstance(total, str) else [str(t) for t in total]
        )
        self.bad = [bad] if isinstance(bad, str) else [str(b) for b in bad]
        self.slo = float(slo)
        self.budget = 1.0 - self.slo
        self.windows = tuple(
            (float(l), float(s), float(f)) for l, s, f in windows
        )
        if not self.windows:
            raise ValueError("windows must name at least one pair")
        for long_s, short_s, factor in self.windows:
            if short_s > long_s:
                raise ValueError(
                    f"short window {short_s} exceeds long window {long_s}"
                )
            if factor <= 0:
                raise ValueError(f"factor must be > 0, got {factor}")

    def paths(self) -> List[str]:
        return [*self.total, *self.bad]

    def _burn(
        self, history: SnapshotHistory, window_s: float, now: float
    ) -> Optional[float]:
        d_total: Optional[float] = None
        for path in self.total:
            d = history.delta(path, window_s, now, allow_partial=True)
            if d is not None:
                d_total = (d_total or 0.0) + d
        if d_total is None or d_total <= 0:
            return None  # no traffic in the window: no burn signal
        d_bad = 0.0
        for path in self.bad:
            d = history.delta(path, window_s, now, allow_partial=True)
            if d is not None:
                d_bad += d
        return (d_bad / d_total) / self.budget

    def evaluate(
        self, history: SnapshotHistory, now: float
    ) -> Tuple[Optional[bool], Optional[float], str]:
        any_signal = False
        active = False
        worst: Optional[float] = None
        details: List[str] = []
        span = history.span_s(now)
        for long_s, short_s, factor in self.windows:
            if span < short_s:
                # too young to judge even the short window: one bad
                # request at tick 2 must not page anyone
                details.append(
                    f"{long_s:.0f}s/{short_s:.0f}s: no signal "
                    f"(history {span:.0f}s < {short_s:.0f}s)"
                )
                continue
            b_long = self._burn(history, long_s, now)
            b_short = self._burn(history, short_s, now)
            if b_long is None or b_short is None:
                details.append(f"{long_s:.0f}s/{short_s:.0f}s: no signal")
                continue
            any_signal = True
            pair_hit = b_long >= factor and b_short >= factor
            active = active or pair_hit
            candidate = min(b_long, b_short)  # the pair's binding burn
            if worst is None or candidate > worst:
                worst = candidate
            details.append(
                f"{long_s:.0f}s/{short_s:.0f}s: burn {b_long:.2f}/"
                f"{b_short:.2f} vs {factor:g}x"
            )
        if not any_signal:
            return None, None, "; ".join(details)
        return active, worst, "; ".join(details)


class AlertState:
    """One rule's live state: the Prometheus alerting lifecycle plus the
    bookkeeping the exports read."""

    __slots__ = (
        "state", "since", "value", "detail", "fired_count",
        "last_transition", "last_fired", "last_resolved",
    )

    def __init__(self) -> None:
        self.state = "inactive"
        self.since: Optional[float] = None
        self.value: Optional[float] = None
        self.detail = ""
        self.fired_count = 0
        self.last_transition: Optional[float] = None
        self.last_fired: Optional[float] = None
        self.last_resolved: Optional[float] = None


class AlertEngine:
    """Evaluate a rule set against a stream of snapshots; hold per-rule
    state machines; export and emit transitions.

    ``evaluate(snapshot)`` is the one entry point — the owning process's
    observer ticker (serving replica / fleet router) or the training
    loop's rate-limited boundary hook calls it every few seconds. With
    telemetry disabled the engine is never constructed at all (the
    repo-wide zero-calls contract, guard-tested).
    """

    def __init__(
        self,
        rules: Sequence[AlertRule],
        *,
        clock: Callable[[], float] = time.monotonic,
        unix: Callable[[], float] = time.time,
        sink_path: Optional[Path] = None,
        on_firing: Optional[Callable[[AlertRule, AlertState], Any]] = None,
        max_samples: int = 4096,
        source: str = "",
    ) -> None:
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules = list(rules)
        self.clock = clock
        self.unix = unix
        self.sink_path = Path(sink_path) if sink_path is not None else None
        self.on_firing = on_firing
        self.source = str(source)
        self.history = SnapshotHistory(
            [p for r in self.rules for p in r.paths()],
            max_samples=max_samples,
        )
        self._states: Dict[str, AlertState] = {
            r.name: AlertState() for r in self.rules
        }
        self._lock = threading.Lock()
        self.evaluations = 0
        self.transitions = 0

    # -- evaluation ----------------------------------------------------
    def evaluate(self, snapshot: Dict[str, Any]) -> List[str]:
        """One pass over every rule; returns the names of rules that
        TRANSITIONED this pass (diagnostic convenience for tests)."""
        now = self.clock()
        changed: List[str] = []
        fired: List[Tuple[AlertRule, AlertState]] = []
        emits: List[Tuple[AlertRule, str, str, bool, Any, str]] = []
        with self._lock:
            self.evaluations += 1
            self.history.append(now, snapshot)
            for rule in self.rules:
                st = self._states[rule.name]
                active, value, detail = rule.evaluate(self.history, now)
                st.value = value
                st.detail = detail
                if active:
                    if st.state == "inactive":
                        if rule.for_s > 0:
                            self._transition(rule, st, "pending", now, emits)
                            changed.append(rule.name)
                        else:
                            self._transition(rule, st, "firing", now, emits)
                            changed.append(rule.name)
                            fired.append((rule, st))
                    elif (
                        st.state == "pending"
                        and st.since is not None
                        and now - st.since >= rule.for_s
                    ):
                        self._transition(rule, st, "firing", now, emits)
                        changed.append(rule.name)
                        fired.append((rule, st))
                else:
                    # not-active AND no-signal both resolve: an alert
                    # held open on a dead signal would never page anyone
                    # about the right thing (AbsenceRule exists for the
                    # dead-signal case itself)
                    if st.state in ("pending", "firing"):
                        self._transition(rule, st, "inactive", now, emits)
                        changed.append(rule.name)
        # emission (sink-file I/O, log_event) and hooks run OUTSIDE the
        # engine lock: a slow disk under the sink, or the flight
        # recorder re-entering states()/summary(), must never stall the
        # /metrics and /admin/alerts readers that share this lock
        for rule, old, new, resolved, value, detail in emits:
            self._emit(rule, old, new, resolved, value, detail)
        for rule, st in fired:
            if self.on_firing is not None:
                try:
                    self.on_firing(rule, st)
                except Exception:
                    pass  # an incident dump must never break evaluation
        return changed

    def _transition(
        self,
        rule: AlertRule,
        st: AlertState,
        new: str,
        now: float,
        emits: List[Tuple[AlertRule, str, str, bool, Any, str]],
    ) -> None:
        old = st.state
        st.state = new
        st.since = now
        st.last_transition = now
        self.transitions += 1
        if new == "firing":
            st.fired_count += 1
            st.last_fired = now
        resolved = old == "firing" and new == "inactive"
        if resolved:
            st.last_resolved = now
        # the emit payload is captured NOW (st can be re-evaluated by a
        # racing pass once the lock drops); the I/O happens after release
        emits.append((rule, old, new, resolved, st.value, st.detail))

    def _emit(
        self,
        rule: AlertRule,
        old: str,
        new: str,
        resolved: bool,
        value: Any,
        detail: str,
    ) -> None:
        event = "alert-resolved" if resolved else f"alert-{new}"
        row = {
            "kind": "alert",
            "alert": rule.name,
            "severity": rule.severity,
            "from": old,
            "to": new,
            "value": value,
            "detail": detail,
            "unix_time": round(self.unix(), 3),
        }
        if self.source:
            row["source"] = self.source
        if rule.labels:
            row["labels"] = dict(rule.labels)
        try:
            from .training.resilience import log_event

            log_event(
                event,
                f"{rule.name} [{rule.severity}] {old} -> {new}: {detail}",
                alert=rule.name,
                severity=rule.severity,
                value=value,
            )
        except Exception:
            pass
        if self.sink_path is not None:
            try:
                self.sink_path.parent.mkdir(parents=True, exist_ok=True)
                with open(self.sink_path, "a", encoding="utf8") as f:
                    f.write(json.dumps(row, default=str) + "\n")
            except OSError:
                pass  # a full disk must not take the serving path down

    # -- exports -------------------------------------------------------
    def states(self) -> List[Dict[str, Any]]:
        """The ``/admin/alerts`` payload: one row per rule, firing
        first, then pending, then inactive (each alphabetical)."""
        with self._lock:
            rows = [
                {
                    "alert": rule.name,
                    "severity": rule.severity,
                    "state": st.state,
                    "since": st.since,
                    "value": st.value,
                    "detail": st.detail,
                    "fired_count": st.fired_count,
                    "last_resolved": st.last_resolved,
                    **({"labels": dict(rule.labels)} if rule.labels else {}),
                }
                for rule in self.rules
                for st in (self._states[rule.name],)
            ]
        rows.sort(
            key=lambda r: (-STATE_VALUES[r["state"]], r["alert"])
        )
        return rows

    def summary(self) -> Dict[str, Any]:
        """The compact block the ``/metrics`` JSON payload carries (and
        ``telemetry top`` renders): counts plus the firing names."""
        with self._lock:
            states = {
                name: st.state for name, st in self._states.items()
            }
        firing = sorted(n for n, s in states.items() if s == "firing")
        pending = sorted(n for n, s in states.items() if s == "pending")
        return {
            "rules": len(states),
            "firing": len(firing),
            "pending": len(pending),
            "firing_names": firing,
            "pending_names": pending,
        }

    def add_prometheus(self, fam: Any) -> None:
        """Append the alert series to a ``PromFamilies``: state gauge
        (0 inactive / 1 pending / 2 firing) and fired-count counter,
        labeled by alert name and severity."""
        with self._lock:
            rows = [
                (rule, self._states[rule.name]) for rule in self.rules
            ]
        for rule, st in rows:
            labels = {"alert": rule.name, "severity": rule.severity}
            fam.add(
                "srt_alert_state", "gauge", STATE_VALUES[st.state], labels
            )
            fam.add(
                "srt_alert_fired_total", "counter", st.fired_count,
                {"alert": rule.name},
            )


# ----------------------------------------------------------------------
# Default rule sets
# ----------------------------------------------------------------------


def process_rules(
    *,
    rss_growth_bytes: float = 256 * 1024 * 1024,
    rss_window_s: float = 600.0,
    fd_limit: float = 512.0,
    fd_for_s: float = 60.0,
) -> List[AlertRule]:
    """The host-resource leak detectors every role set carries, reading
    the ``process`` block hoststats injects into each role's alert
    snapshot:

    * ``process-rss-growth`` — NET RSS growth beyond
      ``rss_growth_bytes`` inside the trailing ``rss_window_s``. The
      windowed delta clamps decreases to zero, so a sawtooth allocator
      that keeps returning memory stays quiet while a monotone leak
      accumulates; no ``partial``, so a process younger than the window
      is no-signal — a short-lived CLI run can't page.
    * ``process-fd-leak`` — open fds above ``fd_limit`` held for
      ``fd_for_s``, ARMED only after the process has been seen healthy
      (fd count at or below half the limit): a deliberately fd-hungry
      deployment that BOOTS above the gate never arms (that's its
      normal, not a leak), short-lived processes rarely live long
      enough to arm-then-breach, and a missing ``/proc`` surface is
      plain no-signal.

    Both are tickets, not pages: a leak is a trend to fix this week,
    not an outage to wake someone for — the watchdog and the burn rules
    own the acute failure modes.
    """
    return [
        ThresholdRule(
            "process-rss-growth",
            "process.rss_bytes",
            ">=",
            float(rss_growth_bytes),
            window_s=float(rss_window_s),
            severity="ticket",
        ),
        ThresholdRule(
            "process-fd-leak",
            "process.open_fds",
            ">",
            float(fd_limit),
            arm_when=("<=", float(fd_limit) / 2.0),
            for_s=float(fd_for_s),
            severity="ticket",
        ),
    ]


def default_serving_rules(
    *,
    p99_target_s: float = 0.5,
    slo: float = 0.99,
    windows: Sequence[Tuple[float, float, float]] = DEFAULT_BURN_WINDOWS,
) -> List[AlertRule]:
    """A serving replica's defaults, evaluated over its own
    ``ServingTelemetry.snapshot()``: the request-success error budget
    (typed rejects + errors over requests), the sliding-window p99
    against the SLO target, and the host-resource leak detectors
    (:func:`process_rules`)."""
    return [
        BurnRateRule(
            "serving-error-budget-burn",
            # `requests` only counts ADMITTED requests; queue-full 429s
            # are rejected BEFORE admission and land only in their own
            # counter — the denominator must include them, or a replica
            # rejecting 100% of its traffic would read as "no traffic,
            # no burn" and the page would sleep through the outage
            total=[
                "counters.requests",
                "counters.rejected_queue_full",
            ],
            bad=[
                "counters.errors",
                "counters.deadline_exceeded",
                "counters.rejected_queue_full",
            ],
            slo=slo,
            windows=windows,
            severity="page",
        ),
        ThresholdRule(
            "serving-latency-slo",
            "slo_window.request_latency_p99",
            ">",
            float(p99_target_s),
            for_s=30.0,
            severity="page",
        ),
    ] + process_rules()


def default_router_rules(
    *,
    p99_target_s: float = 0.5,
    slo: float = 0.99,
    windows: Sequence[Tuple[float, float, float]] = DEFAULT_BURN_WINDOWS,
) -> List[AlertRule]:
    """The fleet router's defaults, evaluated over the composite
    ``{"router": RouterTelemetry.snapshot(), "replicas": [...]}``
    snapshot the fleet observer builds every tick."""
    return [
        # shed requests ARE the error budget at the fleet edge: a 503
        # no_replica storm is the fleet-down signal
        BurnRateRule(
            "fleet-reject-burn",
            total="router.counters.requests",
            bad=[
                "router.counters.rejected_no_replica",
                "router.counters.rejected_draining",
            ],
            slo=slo,
            windows=windows,
            severity="page",
        ),
        # armed only once the fleet has been ready at least once: a cold
        # start's minutes-long warmup (every replica 503 "warming") is a
        # boot, not an outage — paging on every clean start would bury
        # the real one
        ThresholdRule(
            "no-ready-replica",
            "router.gauges.ready_replicas",
            "<",
            1.0,
            for_s=10.0,
            arm_when=(">=", 1.0),
            severity="page",
        ),
        # a READY replica whose
        # /metrics scrape keeps failing is an observability hole exactly
        # where an SLO breach would hide — 3+ failed scrapes inside two
        # minutes is a pattern, not a blip
        ThresholdRule(
            "replica-unscrapable",
            "router.counters.scrape_failures",
            ">=",
            3.0,
            window_s=120.0,
            for_s=0.0,
            severity="page",
        ),
        ThresholdRule(
            "fleet-latency-slo",
            "router.slo.router_latency_p99",
            ">",
            float(p99_target_s),
            for_s=30.0,
            severity="page",
        ),
        # the router's own host truth rides the composite snapshot at
        # top level (fleet.observe_tick), same dotted paths as the
        # other roles
    ] + process_rules()


def default_training_rules(
    *,
    stall_s: float = 300.0,
    anomaly_burst: int = 5,
    fleet: bool = False,
    push_stall_s: float = 120.0,
    discard_rate: float = 0.30,
    discard_window_s: float = 120.0,
) -> List[AlertRule]:
    """The trainer's defaults, evaluated over its registry snapshot at
    (rate-limited) step boundaries: a stalled step counter — the
    watchdog's signal, visible BEFORE the watchdog's hard exit — and an
    anomaly-detector burst.

    ``fleet=True`` (each trainer-fleet worker's engine) adds the async
    plane's two failure modes:

    * ``fleet-grad-push-stalled`` — this worker's grad-push counter
      stopped moving: a wedged peer loop pages on wall time BEFORE the
      watchdog's rc-79 hard exit (the same before-the-watchdog
      discipline as training-stalled, but on the fleet's own signal —
      a worker can be stepping-by-the-clock yet pushing nothing when
      its peers are gone).
    * ``fleet-discard-burn`` — the stale-gradient discard RATE burns
      past ``discard_rate`` (default >30% of received gradients
      discarded inside ``discard_window_s``): the quorum/staleness
      knobs are mis-set for this fleet's speed skew, and most of the
      compute is being thrown away. Expressed as a single-pair
      burn-rate rule (the ratio machinery) with budget ``discard_rate``
      and factor 1.0 — burn ≥ 1 ⟺ discards/received ≥ the threshold.
    * ``fleet-worker-diverging`` — the lead's cross-worker convergence
      watch (``FleetDivergenceDetector``: loss z-outlier vs the peer
      median, NaN training, one-worker discard outlier) flagged a
      worker inside the trailing window. Only the lead's
      ``divergence_flags`` counter ever moves, so the rule is silent on
      every other worker's engine; the flag's anomaly row + incident
      bundle name the diverging worker.
    * ``fleet-owner-evicted`` — the lease verdict fired: the acting
      lead declared a peer dead and bumped the membership epoch
      (the fleet's ownership failover). Training continues on the
      survivors by design, but an eviction is capacity loss plus an
      optimizer-moment restore on every re-sharded slice — a human
      should know within the window. Only the acting lead's
      ``evictions`` counter moves (``partial=True`` keeps the other
      engines silent); the eviction's structured event and the
      ``fleet-membership.jsonl`` ledger row name the evicted worker.
    """
    rules: List[AlertRule] = [
        AbsenceRule(
            "training-stalled",
            "counters.steps",
            stale_s=float(stall_s),
            severity="page",
        ),
        ThresholdRule(
            "anomaly-burst",
            "counters.anomalies",
            ">=",
            float(anomaly_burst),
            window_s=600.0,
            severity="ticket",
        ),
    ]
    if fleet:
        rules.extend(
            [
                AbsenceRule(
                    "fleet-grad-push-stalled",
                    "counters.grad_pushed",
                    stale_s=float(push_stall_s),
                    # counts PEER deliveries only (self-submit excluded —
                    # worker.py), so a frozen value means this worker
                    # stopped talking to its fleet; arm_above keeps a
                    # topology that never pushes (fleet of one) silent
                    arm_above=0.0,
                    severity="page",
                ),
                BurnRateRule(
                    "fleet-discard-burn",
                    total=["counters.grad_received"],
                    bad=["counters.grad_discarded"],
                    slo=1.0 - float(discard_rate),
                    windows=(
                        (
                            float(discard_window_s),
                            float(discard_window_s) / 4.0,
                            1.0,
                        ),
                    ),
                    severity="page",
                ),
                ThresholdRule(
                    "fleet-worker-diverging",
                    "counters.divergence_flags",
                    ">=",
                    1.0,
                    window_s=600.0,
                    for_s=0.0,
                    partial=True,
                    severity="page",
                ),
                ThresholdRule(
                    "fleet-owner-evicted",
                    "counters.evictions",
                    ">=",
                    1.0,
                    window_s=600.0,
                    for_s=0.0,
                    partial=True,
                    severity="page",
                ),
            ]
        )
    rules.extend(process_rules())
    return rules
