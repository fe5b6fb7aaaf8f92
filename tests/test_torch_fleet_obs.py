"""The trainer fleet's telemetry in the port held against the JAX package's
on the CPU: the dynamics families' Prometheus grammar with the ``worker``
label and their shared bucket tables, the owner's dynamics histograms and
``grad_apply`` spans, the ``FleetDivergenceDetector`` matrix (nan,
loss-outlier with its pace gate, discard-outlier, re-arm) on one fake
clock, a peer server's ``/metrics``, ``/trace`` and ``/admin/alerts``,
``telemetry summarize`` and ``report`` of one fleet run directory,
``collect-trace`` over two port peer servers, and the loss streaming of
``step_boundary``; each scenario runs with each package and the results
must be equal.

End to end in the port: a two-worker thread fleet at the three-round
lockstep parity setting ends with bit-equal parameters with telemetry on
and off; and two ``train --fleet-workers 2 --metrics-dir`` runs as
processes: the first with a NaN rule (worker 0's divergence watch names
each diverging worker in an anomaly row and a bundle, the alert fires) and
worker 1 SIGKILLed, evicted and left out of the lead's next generation; the
second resumes that generation, in which worker 1 is no longer a member: it
logs ``fleet-resume-evicted``, asks the lead to rejoin and is admitted
(``fleet-membership.jsonl``'s ``admit`` row), both workers stepping on at
the new epoch. The run directory's report and summary are the JAX
package's text.
"""

import http.client
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import spacy_ray_tpu.serving.tracecollect as j_tc
import spacy_ray_tpu.training.fleet.peer as j_peer
import spacy_ray_tpu.training.prometheus as j_prom
import spacy_ray_tpu.training.report as j_report
import spacy_ray_tpu.training.telemetry as j_tel
import spacy_ray_tpu_torch as P
import spacy_ray_tpu_torch.serving.tracecollect as p_tc
import spacy_ray_tpu_torch.training.fleet.peer as p_peer
import spacy_ray_tpu_torch.training.prometheus as p_prom
import spacy_ray_tpu_torch.training.report as p_report
import spacy_ray_tpu_torch.training.telemetry as p_tel
from spacy_ray_tpu.util import write_synth_jsonl
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.training.fleet import worker as p_worker
from spacy_ray_tpu_torch.training.fleet.membership import read_membership_ledger

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 240  # the test workers share the host's cores

PKGS = {
    "jax": SimpleNamespace(name="jax", tel=j_tel, prom=j_prom, peer=j_peer, report=j_report,
                           tc=j_tc),
    "port": SimpleNamespace(name="port", tel=p_tel, prom=p_prom, peer=p_peer, report=p_report,
                            tc=p_tc),
}


def both(scenario, *args, **kwargs):
    """``scenario(pkg, ...)`` with each package; the results must be equal.
    Returns the port's."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# The dynamics families
# ----------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"\n]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"\n]*")*\})?'
    r" (-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$")
_TYPE_RE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram|summary)$")


def _fake_worker_registry(pkg, worker, staleness_obs, phase_obs):
    """The instruments a fleet worker and its owner make, driven by hand."""
    H = pkg.tel.FLEET_DYNAMICS_HISTOGRAMS
    reg = pkg.tel.MetricsRegistry(clock=FakeClock())
    st = reg.histogram("staleness", buckets=H["staleness"])
    qw = reg.histogram("quorum_wait_seconds", buckets=H["quorum_wait_seconds"])
    ap = reg.histogram("apply_seconds", buckets=H["apply_seconds"])
    for lag in staleness_obs:
        st.observe(float(lag))
        qw.observe(0.01 * (worker + 1))
        ap.observe(0.002 * (worker + 1))
    for name, values in phase_obs.items():
        h = reg.histogram(f"phase_{name}_seconds", buckets=H[f"phase_{name}_seconds"])
        for v in values:
            h.observe(v)
    reg.counter("grad_received").inc(len(staleness_obs))
    reg.gauge("fleet_worker").set(worker)
    return reg


def test_dynamics_families_render_jaxs_grammar_with_the_worker_label():
    def run(pkg):
        reg = _fake_worker_registry(pkg, 1, [0, 0, 1, 2], {"grad": [0.1, 0.2],
                                                          "apply_wait": [0.01]})
        return pkg.prom.render_snapshot(reg.snapshot(), prefix="srt_training",
                                        labels={"worker": "1"})

    text = both(run)
    for line in text.splitlines():
        assert (_TYPE_RE.match(line) if line.startswith("# ") else _SAMPLE_RE.match(line)), line
    for family in ("srt_training_staleness", "srt_training_quorum_wait_seconds",
                   "srt_training_apply_seconds", "srt_training_phase_grad_seconds",
                   "srt_training_phase_apply_wait_seconds"):
        assert f"# TYPE {family} histogram" in text
        buckets = re.findall(rf'^{family}_bucket{{le="([^"]+)",worker="1"}} (\d+)$', text, re.M)
        counts = [int(c) for _, c in buckets]
        assert buckets[-1][0] == "+Inf" and counts == sorted(counts)
        count = re.search(rf'^{family}_count{{worker="1"}} (\d+)$', text, re.M)
        assert int(count.group(1)) == counts[-1]
    assert len(re.findall(r'^srt_training_staleness_bucket\{', text, re.M)) == \
        len(p_tel.STALENESS_BUCKETS) + 1
    for name in ("STALENESS_BUCKETS", "FLEET_DYNAMICS_HISTOGRAMS", "FLEET_WIRE_COUNTERS"):
        assert getattr(p_tel, name) == getattr(j_tel, name)


def test_dynamics_buckets_sum_exactly_across_workers():
    pkg = PKGS["port"]
    reg0 = _fake_worker_registry(pkg, 0, [0, 0, 1], {"grad": [0.1]})
    reg1 = _fake_worker_registry(pkg, 1, [0, 2, 3, 8], {"grad": [0.3, 0.9]})
    union = _fake_worker_registry(pkg, 2, [0, 0, 1, 0, 2, 3, 8], {"grad": [0.1, 0.3, 0.9]})

    def buckets(reg, name):
        return {float(le): int(c) for le, c in reg.snapshot()["histograms"][name]["buckets"]}

    for name in ("staleness", "phase_grad_seconds"):
        b0, b1, bu = buckets(reg0, name), buckets(reg1, name), buckets(union, name)
        assert set(b0) == set(b1) == set(bu)
        assert all(b0[le] + b1[le] == bu[le] for le in bu)


def test_the_owner_observes_its_dynamics_as_jax():
    def run(pkg):
        reg = pkg.tel.MetricsRegistry()
        trace = pkg.tel.TraceBuffer()
        versions = []
        counters = pkg.peer.FleetCounters(registry=reg)
        owner = pkg.peer.OwnerState(
            worker_id=0, n_workers=3, quorum=2, max_staleness=2,
            apply_fn=lambda p, s, g: ({"x": p["x"] + g["x"]}, s),
            slice_params={"x": np.zeros(4, np.float32)}, opt_state={}, counters=counters,
            registry=reg, trace=trace, on_version=versions.append)
        g = {"x": np.ones(4, np.float32)}
        got = [owner.submit(1, 0, g), owner.submit(2, 0, g), owner.submit(1, 0, g),
               owner.submit(2, 1, g), owner.submit(1, 5, g)]  # the last from the future
        snap = reg.snapshot()
        hist = {k: (v["count"], v["buckets"]) for k, v in snap["histograms"].items()
                if k != "quorum_wait_seconds" and k != "apply_seconds"}
        timed = {k: snap["histograms"][k]["count"] for k in ("quorum_wait_seconds",
                                                             "apply_seconds")}
        spans = [(e["name"], e["args"]) for e in trace.payload()["traceEvents"]
                 if e.get("ph") == "X"]
        off = pkg.peer.OwnerState(
            worker_id=0, n_workers=3, quorum=2, max_staleness=2,
            apply_fn=lambda p, s, g: (p, s), slice_params={"x": np.zeros(4, np.float32)},
            opt_state={}, counters=pkg.peer.FleetCounters())
        return (got, hist, timed, spans, versions, snap["counters"],
                (off._staleness_hist, off.trace))

    got, hist, timed, spans, versions, counters, off = both(run)
    assert [a for a, _ in got] == [True, True, True, True, False]
    assert hist["staleness"][0] == 4 and timed == {"quorum_wait_seconds": 2, "apply_seconds": 2}
    assert dict((le, n) for le, n in hist["staleness"][1])[0.0] == 3
    assert spans == [("grad_apply", {"version": 1, "contributors": 2}),
                     ("grad_apply", {"version": 2, "contributors": 2})]
    assert versions == [0, 1, 2] and counters["applies"] == 2 and off == (None, None)


# ----------------------------------------------------------------------
# The divergence detector
# ----------------------------------------------------------------------


def _row(loss, received=0, discarded=0, nonfinite=0, steps=None):
    row = {"loss": loss, "received": received, "discarded": discarded,
           "loss_nonfinite": nonfinite}
    if steps is not None:
        row["steps"] = steps
    return row


def _discard_polls():
    polls = [{w: _row(1.0, received=40) for w in range(3)}] * 4
    for i in range(3):
        polls.append({0: _row(1.0, received=40 * (5 + i)),
                      1: _row(1.0, received=40 * (5 + i), discarded=30 * (i + 1)),
                      2: _row(1.0, received=40 * (5 + i))})
    return polls


DIVERGENCE = {
    "loss_outlier_names_its_worker": (
        {}, [{0: _row(1.0), 1: _row(1.1), 2: _row(0.9)}] * 4
        + [{0: _row(1.0), 1: _row(9.0), 2: _row(0.9)}] * 2, [(1, "loss-outlier")]),
    "uniform_slow_fleet_stays_quiet": (
        {}, [{w: _row(1.0 * (1 + i), received=8 * (i + 1)) for w in range(3)}
             for i in range(12)], []),
    "no_signal_on_a_just_joined_worker": (
        {"min_polls": 3, "confirm_polls": 2},
        [{0: _row(1.0), 1: _row(1.1)}] * 6
        + [{0: _row(1.0), 1: _row(1.1), 2: _row(50.0)}] * 4, [(2, "loss-outlier")]),
    "nan_fires_immediately": (
        {}, [{0: _row(1.0), 1: _row(1.0)}, {0: _row(1.0), 1: _row(None, nonfinite=2)}],
        [(1, "nan")]),
    "nan_before_the_first_poll_fires": (
        {}, [{0: _row(1.0), 1: _row(None, nonfinite=3)}], [(1, "nan")]),
    "discard_outlier": ({}, _discard_polls(), [(1, "discard-outlier")]),
    "rearm_suppresses_a_storm": (
        {"rearm_s": 120.0}, [{0: _row(1.0), 1: _row(9.0), 2: _row(0.9)}] * 10,
        [(1, "loss-outlier")]),
    "pace_gate_skips_young_and_behind_workers": (
        {}, [{0: _row(1.0, steps=40 + i), 1: _row(9.0, steps=12 + i),
              2: _row(0.9, steps=41 + i)} for i in range(6)]
        + [{0: _row(1.0, steps=3), 1: _row(9.0, steps=3), 2: _row(1.0, steps=3)}] * 4, []),
    "pace_gate_judges_workers_at_a_like_pace": (
        {}, [{0: _row(1.0, steps=40 + i), 1: _row(9.0, steps=30 + i),
              2: _row(0.9, steps=41 + i)} for i in range(6)], [(1, "loss-outlier")]),
}


@pytest.mark.parametrize("case", sorted(DIVERGENCE))
def test_the_divergence_detector_fires_as_jax(case):
    kw, polls, want = DIVERGENCE[case]

    def run(pkg):
        clock = FakeClock()
        fired = []
        det = pkg.tel.FleetDivergenceDetector(
            lambda event, message, **fields: fired.append({"event": event,
                                                          "message": message, **fields}),
            clock=clock, **kw)
        per_poll = []
        for rows in polls:
            clock.t += 10.0
            per_poll.append(det.observe(rows))
        if case == "rearm_suppresses_a_storm":
            clock.t += 200.0
            for _ in range(3):
                clock.t += 10.0
                per_poll.append(det.observe(polls[0]))
        return fired, per_poll, det.fired

    fired, _, counts = both(run)
    got = sorted({(f["worker"], f["mode"]) for f in fired})
    assert got == want
    assert all(f["event"] == "fleet-divergence" and f"worker {f['worker']}" in f["message"]
               for f in fired)
    if case == "rearm_suppresses_a_storm":
        assert counts == {"loss-outlier": 2}


# ----------------------------------------------------------------------
# Summaries and the run report of one fleet run directory
# ----------------------------------------------------------------------


def _synth_run_dir(tmp_path, n=2, with_nan=False):
    """JAX's test fleet run directory: ledgers, per-worker metrics files
    with step rows (a NaN as its sanitized string), exit rows, an anomaly
    row and an alert row."""
    run = tmp_path / "out"
    for k in range(n):
        ledger = {"worker": k, "steps": 20, "words_seen": 4000 + 100 * k,
                  "seconds": 10.0 + k, "interrupted": False, "resumed_from": None,
                  "n_workers": n, "quorum": n - 1, "max_staleness": 1, "version": 20,
                  "counters": {"grad_pushed": 20, "grad_received": 20, "grad_applied": 18,
                               "grad_discarded": 2, "push_failed": 0, "pull_failed": 0,
                               "apply_wait_timeouts": 0, "pull_wait_timeouts": 0,
                               "applies": 18, "wire_push_bytes": 1_000_000 * (k + 1),
                               "wire_push_bytes_uncompressed": 4_000_000 * (k + 1),
                               "wire_pull_bytes": 2_000_000,
                               "wire_pull_bytes_uncompressed": 3_000_000},
                  "grad_compression": "int8", "param_delta_window": 4,
                  "phases": {"data": 1.0, "pull": 0.5, "grad": 6.0, "push": 0.5,
                             "apply_wait": 2.0}}
        run.mkdir(parents=True, exist_ok=True)
        (run / f"fleet-worker-{k}.json").write_text(json.dumps(ledger), encoding="utf8")
        mdir = run / "metrics" / f"fleet-worker-{k}"
        mdir.mkdir(parents=True)
        rows = []
        for s in range(1, 21):
            loss = 5.0 / s + 0.1 * k
            if with_nan and k == 1 and s == 10:
                loss = float("nan")
            rows.append({"kind": "step", "step": s, "epoch": 0, "t": 0.1 * s,
                         "step_seconds": 0.1, "words": 200,
                         "loss": "nan" if math.isnan(loss) else loss})
        rows.append({"kind": "eval", "step": 20, "epoch": 0, "t": 2.0,
                     "process": {"cpu_percent": 90.0 + k, "rss_bytes": 300 << 20,
                                 "rss_peak_bytes": 310 << 20, "threads": 12, "open_fds": 30,
                                 "ctx_switches_voluntary": 100,
                                 "ctx_switches_involuntary": 7}})
        if with_nan and k == 0:
            rows.append({"kind": "anomaly", "anomaly": "fleet-divergence",
                         "message": "fleet worker 1 is training on non-finite losses",
                         "worker": 1, "mode": "nan", "t": 1.0})
        rows.append({"kind": "fleet", "worker": k, "n_workers": n, "quorum": n - 1,
                     "max_staleness": 1, "version": 20, "counters": ledger["counters"],
                     "phases": ledger["phases"],
                     "histograms": {
                         "staleness": {"count": 18, "sum": 6.0, "min": 0, "max": 1, "p50": 0,
                                       "p95": 1, "p99": 1,
                                       "buckets": [[b, 12 if b == 0 else 18]
                                                   for b in p_tel.STALENESS_BUCKETS]},
                         "quorum_wait_seconds": {"count": 18, "sum": 0.9, "min": 0.01,
                                                 "max": 0.2, "p50": 0.05, "p95": 0.15,
                                                 "p99": 0.2},
                         "apply_seconds": {"count": 18, "sum": 0.36, "min": 0.01,
                                           "max": 0.04, "p50": 0.02, "p95": 0.03,
                                           "p99": 0.04}}})
        (mdir / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n",
                                            encoding="utf8")
        if with_nan and k == 0:
            (mdir / "alerts.jsonl").write_text(json.dumps(
                {"kind": "alert", "alert": "fleet-worker-diverging", "severity": "page",
                 "from": "inactive", "to": "firing", "value": 1.0,
                 "detail": "divergence_flags moved", "unix_time": 1700000000.0,
                 "source": "trainer"}) + "\n", encoding="utf8")
    (run / "fleet-membership.jsonl").write_text("\n".join(json.dumps(r) for r in (
        {"event": "evict", "lead": 0, "evicted": [1], "epoch": 1, "active": [0], "ts": 5.0},
        {"event": "admit", "lead": 0, "admitted": [1], "epoch": 2, "active": [0, 1],
         "ts": 9.0})) + "\n", encoding="utf8")
    return run


@pytest.mark.parametrize("target", ["run_dir", "worker_metrics_file", "plain_run_dir"])
def test_summarize_a_fleet_run_as_jax(target, tmp_path):
    run = _synth_run_dir(tmp_path)
    if target == "plain_run_dir":
        path = tmp_path / "plain"
        path.mkdir()
        (path / "metrics.jsonl").write_text(json.dumps(
            {"kind": "step", "step": 1, "epoch": 0, "t": 0.1, "step_seconds": 0.1,
             "words": 10}) + "\n", encoding="utf8")
    else:
        path = run if target == "run_dir" else run / "metrics" / "fleet-worker-0" / "metrics.jsonl"
    text = both(lambda pkg: pkg.tel.summarize_metrics(path))
    if target == "run_dir":
        assert "fleet run dir" in text and "workers: 2" in text and "apply-wait" in text
        assert "trainer fleet: 2 worker(s)" in text
        assert "staleness (accepted pushes): n=18" in text
    elif target == "worker_metrics_file":
        assert "phases:" in text and "quorum-wait p50" in text
    else:
        assert "steps: 1" in text
    empty = tmp_path / "empty"
    empty.mkdir()

    def errors(pkg):
        with pytest.raises(ValueError) as e:
            pkg.tel.summarize_metrics(empty)
        return str(e.value)

    both(errors)


@pytest.mark.parametrize("with_nan", [False, True])
def test_the_run_report_is_jaxs(with_nan, tmp_path, capsys):
    import spacy_ray_tpu.cli as j_cli
    import spacy_ray_tpu_torch.__main__ as p_cli

    run = _synth_run_dir(tmp_path, with_nan=with_nan)
    report = both(lambda pkg: pkg.report.build_run_report(run))
    for cli in (j_cli, p_cli):  # the command prints it and writes --out
        assert cli.telemetry_command(["report", str(run), "--out", str(tmp_path / "r.md")]) == 0
        assert capsys.readouterr().out == report + "\n"
        assert (tmp_path / "r.md").read_text(encoding="utf8") == report
        assert cli.telemetry_command(["report", str(tmp_path / "absent")]) == 1
    for section in ("## Per-worker summary", "## Membership timeline", "## Phase share",
                    "## Per-worker loss trajectories", "## Staleness histogram",
                    "## Wire bytes", "## Quorum-wait & apply timing", "## Host resources",
                    "## Alert & anomaly timeline"):
        assert section in report
    assert "| 0 | 12 | 12 | 24 |" in report
    if with_nan:
        assert "1 non-finite" in report and "fleet-worker-diverging" in report
    run_struct = both(lambda pkg: pkg.report.load_run(run))
    assert sorted(run_struct["workers"]) == [0, 1]
    staleness = both(lambda pkg: pkg.report.sum_staleness(
        pkg.report.fleet_exit_rows(pkg.report.load_run(run)).values()))
    assert staleness["count"] == 36
    assert both(lambda pkg: pkg.report.sparkline([3.0, 2.0, float("nan"), 1.0])) == "█▄▁"

    def empty(pkg):
        (tmp_path / "nothing").mkdir(exist_ok=True)
        with pytest.raises(ValueError) as e:
            pkg.report.build_run_report(tmp_path / "nothing")
        return str(e.value)

    both(empty)
    assert p_report.__all__ == j_report.__all__


# ----------------------------------------------------------------------
# A peer server's telemetry and collect-trace over two of them
# ----------------------------------------------------------------------


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _peer_servers(pkg, tmp_path, *, telemetry=True, n=2):
    servers = []
    for k in range(n):
        tel = (pkg.tel.Telemetry(tmp_path / pkg.name / f"fleet-worker-{k}", process_index=k,
                                 anomaly_detection=False, alert_interval_s=1e9)
               if telemetry else None)
        counters = pkg.peer.FleetCounters(registry=tel.registry if tel else None)
        owner = pkg.peer.OwnerState(
            worker_id=k, n_workers=n, quorum=1, max_staleness=1,
            apply_fn=lambda p, s, g: ({"x": p["x"] + g["x"]}, s),
            slice_params={"x": np.zeros(2, np.float32)}, opt_state={}, counters=counters,
            registry=tel.registry if tel else None, trace=tel.trace if tel else None)
        owner.submit(1 - k, 0, {"x": np.ones(2, np.float32)})
        if tel is not None:
            tel.maybe_evaluate_alerts(force=True)
        server = pkg.peer.PeerServer(owner, worker_id=k, layout_signature="sig",
                                     counters=counters, tel=tel)
        server.start()
        servers.append((server, tel))
    return servers


def _stop(servers):
    for server, tel in servers:
        server.stop()
        if tel is not None:
            tel.finalize()


def test_a_peer_server_serves_its_workers_telemetry_as_jax(tmp_path):
    """With telemetry: the Prometheus text's training families with the
    worker label, the alert series, the live ``/admin/alerts`` and the
    ``/trace`` with its role and anchor; without: the ledger-only
    exposition, ``{"alerts": "disabled"}`` and 404 for ``/trace``."""
    def run(pkg):
        out = {}
        for telemetry in (True, False):
            servers = _peer_servers(pkg, tmp_path / str(telemetry), telemetry=telemetry)
            try:
                port = servers[1][0].address[1]
                text = _get(port, "/metrics?format=prometheus")[1].decode()
                trace_status, trace = _get(port, "/trace")
                trace = json.loads(trace)
                health = json.loads(_get(port, "/healthz")[1])
                metrics = json.loads(_get(port, "/metrics")[1])
                alerts = json.loads(_get(port, "/admin/alerts")[1])
            finally:
                _stop(servers)
            out[telemetry] = {
                # the owner's timed families by their counts (their seconds are real)
                "training": [x for x in text.splitlines() if "srt_training" in x
                             and not re.search(r"_(quorum_wait|apply)_seconds_(sum|bucket)", x)],
                "alert_series": [x for x in text.splitlines() if "srt_alert" in x],
                "process_labelled": all('worker="1"' in x for x in text.splitlines()
                                        if x.startswith("srt_process_")),
                "trace": (trace_status, trace.get("role"), sorted(trace.get("anchor") or {}),
                          [e["name"] for e in trace.get("traceEvents", [])
                           if e.get("ph") == "X"]),
                "health_anchor": "anchor" in health,
                "metrics": (metrics.get("worker"), metrics["counters"].get("applies"),
                            metrics.get("alerts")),
                "alerts": (alerts["alerts"] if alerts["alerts"] == "disabled" else
                           [(r["alert"], r["state"]) for r in alerts["alerts"]]),
            }
        return out

    out = both(run)
    on, off = out[True], out[False]
    assert 'srt_training_staleness_bucket{le="0",worker="1"} 1' in on["training"]
    assert 'srt_training_applies_total{worker="1"} 1' in on["training"]
    assert 'srt_alert_state{alert="fleet-owner-evicted",severity="page"} 0' not in \
        on["alert_series"]  # the engine runs the default training rules
    assert on["alert_series"] and on["process_labelled"] and on["health_anchor"]
    assert on["trace"][:3] == (200, "fleet-worker", ["clock_now", "origin", "unix_now"])
    assert on["trace"][3] == ["grad_apply"]
    assert on["metrics"][0] == 1 and on["metrics"][2]["rules"] == 4
    assert ("training-stalled", "inactive") in on["alerts"]
    assert off["alerts"] == "disabled" and off["trace"][0] == 404 and not off["health_anchor"]
    assert 'srt_training_applies_total{worker="1"} 1' in off["training"]


def test_collect_trace_merges_two_port_peer_servers_as_jax_collects(tmp_path):
    """Both packages' collectors over the same two port peer servers, each
    with its own telemetry and clock anchor: one timeline, two
    ``fleet-worker`` tracks, each with its owner's ``grad_apply``."""
    servers = _peer_servers(PKGS["port"], tmp_path)
    try:
        urls = [f"http://127.0.0.1:{s.address[1]}" for s, _ in servers]

        def run(pkg):
            merged = pkg.tc.collect_fleet_traces(urls, discover=True)
            tracks = sorted(e["args"]["name"] for e in merged["traceEvents"]
                            if e.get("ph") == "M" and e.get("name") == "process_name")
            names = sorted((e["pid"], e["name"]) for e in merged["traceEvents"]
                           if e.get("ph") != "M")
            return tracks, names, merged["otherData"]["skipped"]

        tracks, names, skipped = both(run)
    finally:
        _stop(servers)
    assert len(tracks) == 2 and all(t.startswith("fleet-worker http://") for t in tracks)
    assert len({pid for pid, name in names if name == "grad_apply"}) == 2 and not skipped


def test_step_boundary_streams_the_loss_and_counts_a_nan_as_jax(tmp_path):
    def run(pkg):
        clock = FakeClock()
        tel = pkg.tel.Telemetry(tmp_path / pkg.name, clock=clock, alerting=False,
                                anomaly_detection=False)
        tel.loop_start()
        for i, loss in enumerate((1.0, 2.0, 3.0, float("nan")), start=1):
            clock.t += 0.1
            tel.step_boundary(step=i, epoch=0, n_words=10, steps_run=i, loss=loss)
        snap = tel.registry.snapshot()
        bare = pkg.tel.Telemetry(tmp_path / f"{pkg.name}-bare", alerting=False,
                                 anomaly_detection=False)
        bare.loop_start()
        bare.step_boundary(step=1, epoch=0, n_words=10, steps_run=1)
        bare_snap = bare.registry.snapshot()
        bare.finalize()
        tel.append_row({"kind": "fleet", "worker": 0})
        tel.finalize()
        rows = [json.loads(x) for x in (tmp_path / pkg.name / "metrics.jsonl").read_text()
                .splitlines()]
        return (snap["histograms"]["loss"]["count"], snap["counters"]["loss_nonfinite"],
                [r.get("loss") for r in rows if r["kind"] == "step"], rows[-1],
                "loss" in bare_snap["histograms"], "loss_nonfinite" in bare_snap["counters"])

    count, nonfinite, losses, last, bare_hist, bare_counter = both(run)
    assert (count, nonfinite) == (3, 1) and losses == [1.0, 2.0, 3.0, "nan"]
    assert last == {"kind": "fleet", "worker": 0} and not bare_hist and not bare_counter


# ----------------------------------------------------------------------
# End to end in the port
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_obs")
    write_synth_jsonl(d / "train.jsonl", 120, kind="tagger", seed=0)
    write_synth_jsonl(d / "dev.jsonl", 30, kind="tagger", seed=1)
    return d


def _config(text, data, **over):
    cfg = P.Config.from_str(text)
    return cfg.apply_overrides({"paths.train": str(data / "train.jsonl"),
                                "paths.dev": str(data / "dev.jsonl"), **over})


def _thread_fleet(cfg, n, **kw):
    from test_torch_fleet_train import run_thread_fleet

    return run_thread_fleet(p_worker.train_fleet_worker, cfg, None, n, quorum=2, staleness=0,
                            device="cpu", peer_lease_s=0, grad_compression="f32",
                            param_delta_window=0, **kw)


def test_telemetry_on_and_off_train_a_thread_fleet_to_bit_equal_parameters(
        data, tagger_config_text, tmp_path, monkeypatch):
    """Three applied rounds at the lockstep parity setting (quorum 2, S 0,
    f32, full pulls), dropout 0: the same parameters, losses and counters
    with every worker's telemetry on (rows, histograms, alerts, the lead's
    divergence watch) as with it off."""
    cfg = _config(tagger_config_text, data, **{"training.max_steps": 4,
                                               "training.eval_frequency": 100,
                                               "training.dropout": 0.0})
    off = _thread_fleet(cfg, 2)
    monkeypatch.setattr(p_worker, "WATCH_INTERVAL_S", 0.2)  # the watch polls within the run
    on = _thread_fleet(cfg, 2, metrics_dir=tmp_path / "metrics")
    for k in (0, 1):
        p_off = {key: v.numpy() for key, v in param_paths(off[k][0].model).items()}
        p_on = {key: v.numpy() for key, v in param_paths(on[k][0].model).items()}
        assert set(p_off) == set(p_on)
        assert all(np.array_equal(p_off[key], p_on[key]) for key in p_off), k
        assert off[k][1].step_losses == on[k][1].step_losses
        assert off[k][1].fleet["counters"] == on[k][1].fleet["counters"]
        rows = [json.loads(x) for x in open(tmp_path / "metrics" / f"fleet-worker-{k}"
                                            / "metrics.jsonl")]
        exit_row = [r for r in rows if r["kind"] == "fleet"]
        assert [r["loss"] for r in rows if r["kind"] == "step"] == on[k][1].step_losses
        assert len(exit_row) == 1 and exit_row[0]["histograms"]["apply_seconds"]["count"] == \
            exit_row[0]["counters"]["applies"] == 4
        assert all(exit_row[0]["histograms"][f"phase_{p}_seconds"]["count"] == 4
                   for p in p_worker.PHASES)


def test_a_worker_whose_peer_port_is_taken_leaves_no_alert_ticker(
        data, tagger_config_text, tmp_path):
    """A worker with telemetry on whose peer port is taken fails in its
    set-up, before its first step: no ``telemetry-alerts`` thread is left
    evaluating rules for the failed run, and nothing is written under its
    metrics directory but the directory."""
    cfg = _config(tagger_config_text, data, **{"training.max_steps": 2})
    before = set(threading.enumerate())
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen(1)
        port = held.getsockname()[1]
        with pytest.raises(OSError, match="pick a free --fleet-base-port"):
            p_worker.train_fleet_worker(cfg, None, worker_id=0, n_workers=1, base_port=port,
                                        device="cpu", stdout_log=False,
                                        metrics_dir=tmp_path / "metrics")
    assert not [t for t in set(threading.enumerate()) - before
                if t.name == "telemetry-alerts" and t.is_alive()]
    assert not any((tmp_path / "metrics" / "fleet-worker-0").iterdir())


def _cli(cfg_path, data, out, port, *extra, steps, eval_every=2):
    return [sys.executable, "-m", "spacy_ray_tpu_torch", "train", str(cfg_path), "--device",
            "cpu", "--output", str(out), "--paths.train", str(data / "train.jsonl"),
            "--paths.dev", str(data / "dev.jsonl"), "--training.max_steps", str(steps),
            "--training.eval_frequency", str(eval_every), "--fleet-workers", "2",
            "--quorum", "1", "--max-staleness", "1", "--fleet-base-port", str(port),
            "--peer-lease-s", "1", "--cpu-cores", "", *extra]


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", **extra}


def _json(port, path):
    try:
        return json.loads(_get(port, path)[1])
    except (OSError, ValueError):
        return None


def _wait(pred, what, proc):
    deadline = time.monotonic() + JOIN_S
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        if proc.poll() is not None:
            pytest.fail(f"the fleet exited {proc.returncode} before {what}: "
                        f"{proc.stderr.read()[-3000:]}")
        time.sleep(0.1)
    pytest.fail(f"no {what} in {JOIN_S} s")


def _children(pid):
    out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(pid)], capture_output=True,
                         text=True)
    return [int(x) for x in out.stdout.split()]


def _worker_pid(coordinator, k):
    for pid in _children(coordinator):
        try:
            argv = Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if b"--fleet-worker-id" in argv and argv[argv.index(b"--fleet-worker-id") + 1] == \
                str(k).encode():
            return pid
    return None


def test_a_cli_fleet_names_its_diverging_workers_and_an_evicted_worker_rejoins(
        tagger_config_text, data, tmp_path):
    from test_torch_fleet_train import _two_free_consecutive_ports

    cfg_path = tmp_path / "tagger.cfg"
    cfg_path.write_text(tagger_config_text, encoding="utf8")
    out, metrics, incidents = tmp_path / "out", tmp_path / "out" / "metrics", tmp_path / "inc"
    base = _two_free_consecutive_ports()
    # the first run: both workers poison their 3rd step; worker 1 is
    # SIGKILLed once the lead's watch flagged it, and evicted. The anomaly
    # detectors are off, so that the watch is the lead's one source of
    # bundles: its recorder writes one bundle a 30-s storm over every source,
    # and a step-time regression past the detector's 20-step warmup, before
    # the watch's first poll (a step slowed by the host's load), would take it.
    # chip_smoke.py's train:fleet_elastic runs the detectors beside the watch
    # and holds the lead to one bundle in that storm
    first = subprocess.Popen(
        _cli(cfg_path, data, out, base, "--metrics-dir", str(metrics),
             "--training.incident_dir", str(incidents), "--training.anomaly_detection",
             "false", steps=100000),
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=_env(SPACY_RAY_TPU_FAULT_PLAN="step:3:nan"))
    try:
        scraped = _wait(lambda: (lambda m: m if m and m["counters"].get(
            "divergence_flags", 0) >= 2 else None)(_json(base, "/metrics")),
            "the divergence watch's flags", first)
        text = _get(base + 1, "/metrics?format=prometheus")[1].decode()
        victim = _worker_pid(first.pid, 1)
        os.kill(victim, signal.SIGKILL)
        _wait(lambda: any(r["event"] == "apply" and r.get("epoch") == 1
                          for r in read_membership_ledger(out / "fleet-membership.jsonl")),
              "the lead's re-shard after the eviction", first)
        _wait(lambda: {"fleet-worker-diverging", "fleet-owner-evicted"} <= {
            r["alert"] for r in (_json(base, "/admin/alerts") or {}).get("alerts", [])
            if r["state"] == "firing"}, "the lead's two alerts firing", first)
        first.send_signal(signal.SIGTERM)
        first_rc = first.wait(timeout=JOIN_S)
        first_err = first.stderr.read()
    finally:
        if first.poll() is None:
            first.kill()
    assert first_rc == 75, first_err[-3000:]
    assert 'srt_training_phase_grad_seconds_count{worker="1"}' in text
    rows = [json.loads(x) for x in open(metrics / "fleet-worker-0" / "metrics.jsonl")]
    flagged = sorted((r["worker"], r["mode"]) for r in rows
                     if r["kind"] == "anomaly" and r["anomaly"] == "fleet-divergence")
    assert flagged == [(0, "nan"), (1, "nan")] and scraped["counters"]["divergence_flags"] == 2
    bundles = sorted(b.name for b in incidents.iterdir())
    manifests = [json.loads((incidents / b / "incident.json").read_text()) for b in bundles]
    assert ("anomaly-fleet-divergence", "fleet-worker-0", "nan") in [
        (m["source"], m["process"], m["mode"]) for m in manifests]
    alerts = [json.loads(x) for x in open(metrics / "fleet-worker-0" / "alerts.jsonl")]
    firing = {r["alert"] for r in alerts if r["to"] == "firing"}
    assert {"fleet-worker-diverging", "fleet-owner-evicted"} <= firing
    lead = json.loads((out / "fleet-worker-0.json").read_text())
    assert lead["membership_epoch"] == 1 and lead["active"] == [0]
    # the report and the summary of the run directory are JAX's text
    report = both(lambda pkg: pkg.report.build_run_report(out))
    assert "## Membership timeline" in report and "evicted [1]" in report
    both(lambda pkg: pkg.tel.summarize_metrics(out))

    # the second run resumes the lead's generation (epoch 1, active [0]):
    # worker 1 asks to rejoin and the lead admits it
    second = subprocess.Popen(
        _cli(cfg_path, data, out, base, "--resume", "--metrics-dir", str(metrics),
             steps=100000), cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=_env())
    try:
        _wait(lambda: (lambda m: m and m["gauges"].get("membership_epoch") == 2
                       and m["counters"].get("steps", 0) >= 2)(_json(base + 1, "/metrics")),
              "worker 1's steps at the admitted epoch", second)
        second.send_signal(signal.SIGTERM)
        second_rc = second.wait(timeout=JOIN_S)
        second_err = second.stderr.read()
    finally:
        if second.poll() is None:
            second.kill()
    assert second_rc == 75, second_err[-3000:]
    assert "[fleet-resume-evicted] worker 1 resumed into membership epoch 1" in second_err
    ledger = read_membership_ledger(out / "fleet-membership.jsonl")
    assert [r for r in ledger if r["event"] == "admit"][-1]["admitted"] == [1]
    rejoined = json.loads((out / "fleet-worker-1.json").read_text())
    # the lead may commit another generation at epoch 1 before worker 1 loads one
    assert rejoined["resumed_from"] >= lead["steps"] and rejoined["membership_epoch"] == 2
    assert rejoined["active"] == [0, 1] and rejoined["steps"] > rejoined["resumed_from"]
    assert [e["epoch"] for e in rejoined["owner_epochs"]] == [1, 2]
