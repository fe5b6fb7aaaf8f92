"""The port's alert engine (``spacy_ray_tpu_torch/alerting.py``) held against
the JAX package's (``spacy_ray_tpu/alerting.py``) on the CPU.

Every scenario of JAX's ``tests/test_alerting.py`` runs once with each
package's module on the same snapshots and the same fake clocks (the wall
clock of the sink rows too), and the transcripts must be equal: each
evaluation's per-rule states and summary, the sink's rows, the Prometheus
text, what an ``on_firing`` hook that re-enters the engine saw, and the
errors. The default rule sets are compared rule by rule (class, name,
paths, parameters). The trainer's surfaces (``/admin/alerts``, the alert
series and the ``alerts`` block of ``/metrics``) are compared over both
packages' telemetry endpoints.
"""

import http.client
import json
import threading
from types import SimpleNamespace

import pytest

import spacy_ray_tpu.alerting as j_alerting
import spacy_ray_tpu.training.prometheus as j_prom
import spacy_ray_tpu.training.telemetry as j_tel
import spacy_ray_tpu.training.telemetry_http as j_http
import spacy_ray_tpu_torch.alerting as p_alerting
import spacy_ray_tpu_torch.training.prometheus as p_prom
import spacy_ray_tpu_torch.training.telemetry as p_tel
import spacy_ray_tpu_torch.training.telemetry_http as p_http

PKGS = {
    "jax": SimpleNamespace(A=j_alerting, prom=j_prom, tel=j_tel, http=j_http),
    "port": SimpleNamespace(A=p_alerting, prom=p_prom, tel=p_tel, http=p_http),
}


def both(scenario, *args, **kwargs):
    """``scenario(pkg, ...)`` with each package; the results must be equal.
    Returns the port's."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _counters(**kw):
    return {"counters": dict(kw)}


def _engine(pkg, rules, clock, **kw):
    return pkg.A.AlertEngine(rules, clock=clock, unix=lambda: 1.7e9 + clock.t, **kw)


def _transcript(eng, clock, snapshots):
    """Evaluate each ``(dt, snapshot)`` and keep what every export says."""
    out = []
    for dt, snap in snapshots:
        clock.advance(dt)
        changed = eng.evaluate(snap)
        out.append((changed, eng.states(), eng.summary()))
    return out


def _first_state(transcript, i):
    return transcript[i][1][0]["state"]


# ----------------------------------------------------------------------
# SnapshotHistory
# ----------------------------------------------------------------------


def test_history_delta_and_value_match_jax():
    def run(pkg):
        h = pkg.A.SnapshotHistory(["counters.x"])
        h.append(0.0, _counters(x=10))
        h.append(5.0, _counters(x=20))
        got = [h.delta("counters.x", 60.0, 5.0), h.delta("counters.x", 5.0, 5.0),
               h.delta("counters.x", 60.0, 5.0, allow_partial=True), h.span_s(5.0)]
        h.append(10.0, _counters(x=3))  # a reset clamps to zero
        got.append(h.delta("counters.x", 5.0, 10.0))
        h2 = pkg.A.SnapshotHistory(["counters.x"])
        h2.append(0.0, {"slo_window": {"p99": 0.25}, "counters": {"x": 1}})
        got += [h2.value("slo_window.p99"), h2.value("slo_window.missing"), len(h2)]
        # a counter born inside the window: its oldest observed value is the base
        h3 = pkg.A.SnapshotHistory(["counters.late"])
        h3.append(0.0, _counters())
        h3.append(5.0, _counters(late=2))
        h3.append(10.0, _counters(late=5))
        got.append(h3.delta("counters.late", 8.0, 10.0))
        return got

    got = both(run)
    assert got[:5] == [None, 10.0, 10.0, 5.0, 0.0] and got[5:8] == [0.25, None, 1]
    assert got[8] == 3.0


# ----------------------------------------------------------------------
# Threshold and absence rules
# ----------------------------------------------------------------------


def _threshold_cases():
    p99 = lambda v: {"slo_window": {"p99": v}}  # noqa: E731
    return {
        "for_duration_lifecycle": (
            lambda A: [A.ThresholdRule("p99-slo", "slo_window.p99", ">", 0.5, for_s=30.0)],
            [(0, p99(0.1)), (10, p99(0.9)), (10, p99(0.9)), (25, p99(0.9)), (5, p99(0.2))],
            ["inactive", "pending", "pending", "firing", "inactive"]),
        "pending_cancelled_by_recovery": (
            lambda A: [A.ThresholdRule("p99-slo", "slo_window.p99", ">", 0.5, for_s=30.0)],
            [(0, p99(0.9)), (10, p99(0.1))], ["pending", "inactive"]),
        "no_signal_is_inactive": (
            lambda A: [A.ThresholdRule("p99-slo", "slo_window.p99", ">", 0.5)],
            [(0, {})], ["inactive"]),
        "window_delta_mode": (
            lambda A: [A.ThresholdRule("burst", "counters.x", ">=", 3.0, window_s=60.0)],
            [(10, _counters(x=0))] * 7 + [(10, _counters(x=3))] + [(10, _counters(x=3))] * 7,
            ["inactive"] * 7 + ["firing"] + ["firing"] * 5 + ["inactive"] * 2),
        "partial_window_fires_early": (
            lambda A: [A.ThresholdRule("diverging", "counters.flags", ">=", 1.0,
                                       window_s=600.0, partial=True)],
            [(5, _counters(flags=0)), (5, _counters(flags=1))], ["inactive", "firing"]),
        "arm_when_gate": (
            lambda A: [A.ThresholdRule("no-ready", "gauges.ready", "<", 1.0, for_s=10.0,
                                       arm_when=(">=", 1.0))],
            [(15, {"gauges": {"ready": 0}})] * 3 + [(5, {"gauges": {"ready": 2}}),
                                                   (5, {"gauges": {"ready": 0}}),
                                                   (15, {"gauges": {"ready": 0}})],
            ["inactive"] * 4 + ["pending", "firing"]),
        "absence_fires_and_resolves": (
            lambda A: [A.AbsenceRule("stalled", "counters.steps", stale_s=60.0)],
            [(0, _counters(steps=1))] + [(10, _counters(steps=1))] * 5
            + [(15, _counters(steps=1)), (1, _counters(steps=2))],
            ["inactive"] * 6 + ["firing", "inactive"]),
        "absence_never_observed_is_no_signal": (
            lambda A: [A.AbsenceRule("stalled", "counters.steps", stale_s=60.0)],
            [(500, {})], ["inactive"]),
        "absence_arm_above": (
            lambda A: [A.AbsenceRule("push-stalled", "counters.pushed", stale_s=30.0,
                                     arm_above=0.0)],
            [(20, _counters(pushed=0))] * 3 + [(1, _counters(pushed=1))]
            + [(20, _counters(pushed=1))] * 2,
            ["inactive"] * 5 + ["firing"]),
    }


@pytest.mark.parametrize("case", sorted(_threshold_cases()))
def test_threshold_and_absence_transcripts_equal_jax(case):
    rules, snaps, want = _threshold_cases()[case]

    def run(pkg):
        clock = FakeClock()
        return _transcript(_engine(pkg, rules(pkg.A), clock), clock, snaps)

    got = both(run)
    assert [_first_state(got, i) for i in range(len(got))] == want


# ----------------------------------------------------------------------
# Burn rate: the window-pair matrix
# ----------------------------------------------------------------------

FAST = (300.0, 60.0, 14.4)
SLOW = (1800.0, 300.0, 6.0)


def _traffic(phases):
    """``[(ticks, error fraction)]`` of 100 requests a 10-s tick, as
    cumulative counters."""
    requests = errors = 0
    out = []
    for ticks, frac in phases:
        for _ in range(ticks):
            requests += 100
            errors += int(100 * frac)
            out.append((10.0, _counters(requests=requests, errors=errors)))
    return out


BURN_CASES = {
    "fast_pair_fires_on_total_outage": ((FAST,), [(35, 0.0), (7, 1.0)]),
    "below_factor_never_fires_fast_pair": ((FAST,), [(80, 0.08)]),
    "slow_pair_confirms_moderate_burn": ((FAST, SLOW), [(200, 0.08)]),
    "boot_time_outage_pages_after_short_window": ((FAST,), [(12, 1.0)]),
    "short_burst_does_not_sustain_long_window": (((300.0, 60.0, 50.0),), [(35, 0.0), (6, 0.6)]),
    "resolves_on_recovery": ((FAST,), [(35, 0.0), (12, 1.0), (30, 0.0)]),
    "zero_traffic_is_no_signal": ((FAST,), [(40, 0.0)]),
}


@pytest.mark.parametrize("case", sorted(BURN_CASES))
def test_burn_rate_transcripts_equal_jax(case):
    windows, phases = BURN_CASES[case]
    snaps = _traffic(phases)
    if case == "zero_traffic_is_no_signal":
        snaps = [(10.0, _counters(requests=0, errors=0))] * 40

    def run(pkg):
        clock = FakeClock()
        eng = _engine(pkg, [pkg.A.BurnRateRule("budget-burn", total="counters.requests",
                                               bad="counters.errors", slo=0.99,
                                               windows=windows)], clock)
        return _transcript(eng, clock, snaps)

    got = both(run)
    states = [_first_state(got, i) for i in range(len(got))]
    fired = [i for i, s in enumerate(states) if s == "firing"]
    if case in ("below_factor_never_fires_fast_pair", "short_burst_does_not_sustain_long_window",
                "zero_traffic_is_no_signal"):
        assert not fired
    elif case == "slow_pair_confirms_moderate_burn":
        assert fired and 300.0 <= (fired[0] + 1) * 10.0 <= 700.0
    elif case == "boot_time_outage_pages_after_short_window":
        assert fired and 60.0 <= (fired[0] + 1) * 10.0 <= 90.0
    elif case == "resolves_on_recovery":
        assert fired and states[-1] == "inactive"
    else:
        assert fired


def test_burn_rule_validation_and_duplicate_names_raise_as_jax():
    def run(pkg):
        A = pkg.A
        errors = []
        for kw in ({"slo": 1.5}, {"windows": ()}, {"windows": ((60.0, 300.0, 2.0),)},
                   {"windows": ((300.0, 60.0, 0.0),)}):
            with pytest.raises(ValueError) as e:
                A.BurnRateRule("x", total="a", bad="b", **kw)
            errors.append(str(e.value))
        for bad in (lambda: A.ThresholdRule("x", "a", "!=", 1.0),
                    lambda: A.ThresholdRule("x", "a", ">", 1.0, arm_when=("~", 1.0)),
                    lambda: A.AlertEngine([A.ThresholdRule("dup", "a", ">", 1.0),
                                           A.AbsenceRule("dup", "b", stale_s=1.0)])):
            with pytest.raises(ValueError) as e:
                bad()
            errors.append(str(e.value))
        return errors

    assert len(both(run)) == 7


# ----------------------------------------------------------------------
# The engine: sink, hooks, exports
# ----------------------------------------------------------------------


def test_sink_rows_record_every_transition_as_jax(tmp_path):
    def run(pkg):
        clock = FakeClock()
        sink = tmp_path / pkg.A.__name__ / "alerts.jsonl"
        eng = _engine(pkg, [pkg.A.ThresholdRule("slo", "gauges.v", ">", 1.0, for_s=10.0,
                                                labels={"model": "cnn"})],
                      clock, sink_path=sink, source="test")
        _transcript(eng, clock, [(0, {"gauges": {"v": 5.0}}), (15, {"gauges": {"v": 5.0}}),
                                 (5, {"gauges": {"v": 0.0}})])
        return [json.loads(x) for x in sink.read_text(encoding="utf8").splitlines()]

    rows = both(run)
    assert [(r["from"], r["to"]) for r in rows] == [
        ("inactive", "pending"), ("pending", "firing"), ("firing", "inactive")]
    assert all(r["kind"] == "alert" and r["source"] == "test"
               and r["labels"] == {"model": "cnn"} for r in rows)


def test_on_firing_hook_reenters_the_engine_and_fires_once_per_firing_as_jax():
    def run(pkg):
        clock = FakeClock()
        captured = []
        eng = _engine(pkg, [pkg.A.ThresholdRule("slo", "gauges.v", ">", 1.0)], clock,
                      on_firing=lambda rule, st: captured.append(
                          (rule.name, st.fired_count, eng.states(), eng.summary())))
        done = []
        t = threading.Thread(target=lambda: done.append(
            _transcript(eng, clock, [(1, {"gauges": {"v": v}}) for v in (5.0, 5.0, 5.0)]
                        + [(0, {"gauges": {"v": 0.0}}), (1, {"gauges": {"v": 5.0}})])))
        t.start()
        t.join(timeout=10.0)
        assert done, "evaluate() deadlocked inside the on_firing hook"
        return captured, done[0]

    captured, _ = both(run)
    assert [(c[0], c[1]) for c in captured] == [("slo", 1), ("slo", 2)]
    assert captured[0][2][0]["state"] == "firing" and captured[0][3]["firing"] == 1


def test_prometheus_export_and_summary_equal_jax():
    def run(pkg):
        clock = FakeClock()
        eng = _engine(pkg, [pkg.A.ThresholdRule("hot", "gauges.v", ">", 1.0),
                            pkg.A.ThresholdRule("cold", "gauges.v", "<", -1.0),
                            pkg.A.ThresholdRule("warm", "gauges.v", ">", 1.0, for_s=60.0,
                                                severity="ticket")], clock)
        eng.evaluate({"gauges": {"v": 5.0}})
        fam = pkg.prom.PromFamilies()
        eng.add_prometheus(fam)
        return fam.render(), eng.summary(), eng.evaluations, eng.transitions

    text, summary, _, _ = both(run)
    assert 'srt_alert_state{alert="hot",severity="page"} 2' in text
    assert 'srt_alert_state{alert="cold",severity="page"} 0' in text
    assert 'srt_alert_state{alert="warm",severity="ticket"} 1' in text
    assert 'srt_alert_fired_total{alert="hot"} 1' in text
    assert summary == {"rules": 3, "firing": 1, "pending": 1, "firing_names": ["hot"],
                       "pending_names": ["warm"]}


# ----------------------------------------------------------------------
# The default rule sets
# ----------------------------------------------------------------------


def _describe(rule):
    return (type(rule).__name__, {k: v for k, v in vars(rule).items()})


RULE_SETS = {
    "process": lambda A: A.process_rules(),
    "process_tuned": lambda A: A.process_rules(rss_growth_bytes=1 << 20, rss_window_s=60.0,
                                               fd_limit=64.0, fd_for_s=5.0),
    "serving": lambda A: A.default_serving_rules(),
    "serving_tuned": lambda A: A.default_serving_rules(p99_target_s=0.1, slo=0.999,
                                                       windows=((60.0, 10.0, 2.0),)),
    "router": lambda A: A.default_router_rules(),
    "router_tuned": lambda A: A.default_router_rules(p99_target_s=0.25, slo=0.95),
    "training": lambda A: A.default_training_rules(),
    "training_fleet": lambda A: A.default_training_rules(fleet=True),
    "training_fleet_tuned": lambda A: A.default_training_rules(
        stall_s=60.0, anomaly_burst=2, fleet=True, push_stall_s=30.0, discard_rate=0.5,
        discard_window_s=60.0),
}


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_default_rule_sets_equal_jax_rule_by_rule(name):
    def run(pkg):
        rules = RULE_SETS[name](pkg.A)
        pkg.A.AlertEngine(rules)  # unique names
        return [(_describe(r), r.paths()) for r in rules]

    described = both(run)
    names = [d[0][1]["name"] for d in described]
    if not name.startswith("process"):
        assert {"process-rss-growth", "process-fd-leak"} <= set(names)
    if name.startswith("training_fleet"):
        assert {"fleet-grad-push-stalled", "fleet-discard-burn", "fleet-worker-diverging",
                "fleet-owner-evicted"} <= set(names)
    assert p_alerting.STATE_VALUES == j_alerting.STATE_VALUES
    assert p_alerting.DEFAULT_BURN_WINDOWS == j_alerting.DEFAULT_BURN_WINDOWS
    assert p_alerting.__all__ == j_alerting.__all__


def _router_snap(*, requests=0, no_replica=0, draining=0, ready=2, scrape_failures=0, p99=None):
    return {"router": {"counters": {"requests": requests, "rejected_no_replica": no_replica,
                                    "rejected_draining": draining,
                                    "scrape_failures": scrape_failures},
                       "gauges": {"ready_replicas": ready},
                       "slo": {"router_latency_p99": p99}}}


def _role_cases():
    failures = [0] * 13 + [1, 2, 3] + [3] * 15
    admitted = [100 * (i + 1) for i in range(8)] + [800] * 7
    rejected = [0] * 8 + [100 * (i + 1) for i in range(7)]
    mb = 1024 * 1024
    return {
        "router_scrape_failures_page": (
            lambda A: A.default_router_rules(), "replica-unscrapable",
            [(10, _router_snap(scrape_failures=f)) for f in failures]),
        "router_no_ready_replica_arms_after_first_ready": (
            lambda A: A.default_router_rules(), "no-ready-replica",
            [(15, _router_snap(ready=0))] * 20 + [(5, _router_snap(ready=2)),
                                                  (5, _router_snap(ready=0)),
                                                  (15, _router_snap(ready=0)),
                                                  (1, _router_snap(ready=2))]),
        "router_latency_slo_and_reject_burn": (
            lambda A: A.default_router_rules(p99_target_s=0.5), "fleet-latency-slo",
            [(10, _router_snap(requests=100 * i, no_replica=50 * i, p99=1.5))
             for i in range(1, 12)] + [(5, _router_snap(requests=1200, p99=0.1))]),
        "serving_burn_on_full_rejection_outage": (
            lambda A: A.default_serving_rules(), "serving-error-budget-burn",
            [(10, {"counters": {"requests": a, "rejected_queue_full": r}})
             for a, r in zip(admitted, rejected)]),
        "process_rss_monotone_leak": (
            lambda A: A.process_rules(), "process-rss-growth",
            [(60, {"process": {"rss_bytes": 500 * mb, "open_fds": 10}})] * 11
            + [(60, {"process": {"rss_bytes": (500 + 50 * i) * mb, "open_fds": 10}})
               for i in range(1, 7)]
            + [(60, {"process": {"rss_bytes": 800 * mb, "open_fds": 10}})] * 11),
        "process_rss_sawtooth_stays_quiet": (
            lambda A: A.process_rules(), "process-rss-growth",
            [(60, {"process": {"rss_bytes": (500 + (100 if i % 2 else 0)) * mb,
                               "open_fds": 10}}) for i in range(30)]),
        "process_rss_short_lived_is_no_signal": (
            lambda A: A.process_rules(), "process-rss-growth",
            [(0, {"process": {"rss_bytes": 100 * mb}}), (30, {"process": {"rss_bytes": 500 * mb}})]),
        "process_fd_leak_arms_after_healthy_baseline": (
            lambda A: A.process_rules(), "process-fd-leak",
            [(30, {"process": {"rss_bytes": mb, "open_fds": 600}})] * 10
            + [(30, {"process": {"rss_bytes": mb, "open_fds": 40}}),
               (30, {"process": {"rss_bytes": mb, "open_fds": 700}}),
               (90, {"process": {"rss_bytes": mb, "open_fds": 700}}),
               (10, {"process": {"rss_bytes": mb, "open_fds": 50}})]),
        "process_missing_proc_is_no_signal": (
            lambda A: A.process_rules(), "process-fd-leak",
            [(60, {"process": {"rss_bytes": None, "open_fds": None}})] * 25),
        "training_fleet_rules": (
            lambda A: A.default_training_rules(fleet=True), "fleet-owner-evicted",
            [(5, {"counters": {"steps": 10 * i, "anomalies": 0, "grad_pushed": 5 * i,
                               "grad_received": 10 * i, "grad_discarded": 4 * i,
                               "divergence_flags": 0, "evictions": 1 if i > 6 else 0}})
             for i in range(1, 40)] + [(200, {"counters": {"steps": 390}})]),
    }


@pytest.mark.parametrize("case", sorted(_role_cases()))
def test_role_rule_sets_transcripts_equal_jax(case):
    rules, watched, snaps = _role_cases()[case]

    def run(pkg):
        clock = FakeClock()
        eng = _engine(pkg, rules(pkg.A), clock)
        return _transcript(eng, clock, snaps)

    got = both(run)
    states = [next(r["state"] for r in t[1] if r["alert"] == watched) for t in got]
    if case in ("process_rss_sawtooth_stays_quiet", "process_rss_short_lived_is_no_signal",
                "process_missing_proc_is_no_signal"):
        assert set(states) == {"inactive"}
    elif case == "router_no_ready_replica_arms_after_first_ready":
        assert states[19] == "inactive" and states[-3:] == ["pending", "firing", "inactive"]
    else:
        assert "firing" in states


# ----------------------------------------------------------------------
# The trainer's surfaces
# ----------------------------------------------------------------------


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_a_firing_rule_is_visible_on_the_trainers_endpoint_as_jax(tmp_path):
    """A telemetry facade with an alert rule on a fake clock: driven to
    firing, its ``/admin/alerts``, the alert series of its Prometheus text and
    the ``alerts`` block of its ``/metrics`` JSON equal JAX's, and its sink
    rows too; resolved, every rule is inactive."""
    def run(pkg):
        clock = FakeClock()
        tel = pkg.tel.Telemetry(
            tmp_path / pkg.A.__name__, clock=clock, anomaly_detection=False,
            alert_interval_s=1e9, alert_rules=[
                pkg.A.ThresholdRule("words-burst", "counters.words", ">=", 100.0,
                                    for_s=10.0),
                pkg.A.AbsenceRule("training-stalled", "counters.steps", stale_s=300.0)])
        srv = pkg.http.TelemetryHTTPServer(tel, port=0)
        _, port = srv.start()
        try:
            tel.loop_start()
            for step in range(1, 5):
                clock.advance(6.0)
                tel.step_boundary(step=step, epoch=0, n_words=60, steps_run=step)
                tel.maybe_evaluate_alerts(force=True)
            alerts = json.loads(_get(port, "/admin/alerts")[1])
            text = _get(port, "/metrics?format=prometheus")[1].decode()
            block = json.loads(_get(port, "/metrics")[1])["alerts"]
        finally:
            srv.stop()
            tel.finalize()
        sink = [json.loads(x) for x in open(tmp_path / pkg.A.__name__ / "alerts.jsonl")]
        for row in sink:
            row.pop("unix_time")
        return ([{k: v for k, v in r.items() if k != "since"} for r in alerts["alerts"]],
                [x for x in text.splitlines() if "srt_alert" in x], block, sink)

    alerts, series, block, sink = both(run)
    assert alerts[0]["alert"] == "words-burst" and alerts[0]["state"] == "firing"
    assert 'srt_alert_state{alert="words-burst",severity="page"} 2' in series
    assert block["firing_names"] == ["words-burst"]
    assert [(r["from"], r["to"]) for r in sink] == [("inactive", "pending"),
                                                     ("pending", "firing")]
    assert all(r["source"] == "trainer" for r in sink)
