"""The port's flight recorder and incident bundles
(``spacy_ray_tpu_torch/incidents.py``) held against the JAX package's
(``spacy_ray_tpu/incidents.py``) on the CPU.

Every scenario of JAX's ``tests/test_incidents.py`` runs once with each
package on the same inputs and fake clocks (the wall clock too): the ring's
pruning, the black box, the trip's rate limit, crash bundles, ``find_bundle``
and the postmortem text must be equal, bundles file for file but for the
directory they were written under. A bundle written by either package
renders in the other as in its own, and both ``telemetry postmortem``
commands print the same report and merged trace. The trainer's wiring
through each package's ``Telemetry``: an anomaly storm trips one bundle,
the stall rule fires through the boundary hook and, on wall time, while
the loop is wedged.
"""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import spacy_ray_tpu.alerting as j_alerting
import spacy_ray_tpu.cli as j_cli
import spacy_ray_tpu.incidents as j_inc
import spacy_ray_tpu.training.telemetry as j_tel
import spacy_ray_tpu_torch.__main__ as p_cli
import spacy_ray_tpu_torch.alerting as p_alerting
import spacy_ray_tpu_torch.incidents as p_inc
import spacy_ray_tpu_torch.training.telemetry as p_tel

PKGS = {
    "jax": SimpleNamespace(name="jax", inc=j_inc, tel=j_tel, A=j_alerting,
                           telemetry_command=j_cli.telemetry_command),
    "port": SimpleNamespace(name="port", inc=p_inc, tel=p_tel, A=p_alerting,
                            telemetry_command=p_cli.telemetry_command),
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


def read_bundle(bundle: Path, root: Path):
    """A bundle's files, parsed, with ``root`` written as ``<root>``."""
    out = {}
    for f in sorted(bundle.iterdir()):
        text = f.read_text(encoding="utf8").replace(str(root), "<root>")
        out[f.name] = json.loads(text) if f.suffix == ".json" else text
    return out


def _fake_flight(name, *, events, unix_base):
    """A flight payload whose trace is anchored so event k lands at
    ``unix_base + k`` seconds on the merged timeline."""
    return {"process": name, "snapshots": [],
            "trace": {"traceEvents": [{"name": ev, "ph": "X", "ts": k * 1e6, "dur": 1000.0,
                                       "pid": 0, "tid": 0} for k, ev in enumerate(events)],
                      "anchor": {"origin": 0.0, "clock_now": 0.0, "unix_now": unix_base}}}


# ----------------------------------------------------------------------
# The recorder: ring, black box, trip
# ----------------------------------------------------------------------


def test_ring_prunes_by_window_and_caps_by_capacity_as_jax():
    def run(pkg):
        clock = FakeClock()
        rec = pkg.inc.FlightRecorder(capacity=4, window_s=25.0, clock=clock,
                                     unix=lambda: 1000.0 + clock.t)
        for i in range(10):
            clock.advance(10.0)
            rec.record({"i": i})
        return rec.payload(), rec.records

    payload, records = both(run)
    assert [s["snapshot"]["i"] for s in payload["snapshots"]] == [7, 8, 9] and records == 10


def test_blackbox_persists_atomically_and_rate_limited_as_jax(tmp_path):
    def run(pkg):
        clock = FakeClock()
        bb = tmp_path / pkg.name / "bb.json"
        rec = pkg.inc.FlightRecorder(blackbox_path=bb, process_name="replica-7",
                                     blackbox_interval_s=10.0, clock=clock,
                                     unix=lambda: 1000.0 + clock.t)
        seen = []
        for i, dt in enumerate((0.0, 2.0, 2.0, 2.0, 2.0, 3.0)):
            clock.advance(dt)
            rec.record({"counters": {"requests": i}})
            seen.append(json.loads(bb.read_text(encoding="utf8")))
        return seen, bb.with_name(bb.name + ".tmp").exists(), rec.records

    seen, tmp_left, records = both(run)
    assert [len(s["snapshots"]) for s in seen] == [1, 1, 1, 1, 1, 6]
    assert seen[0]["process"] == "replica-7" and not tmp_left and records == 6


def test_trip_writes_a_bundle_once_per_storm_as_jax(tmp_path):
    def run(pkg):
        root = tmp_path / pkg.name
        clock = FakeClock()
        rec = pkg.inc.FlightRecorder(incident_dir=root, min_trip_interval_s=30.0, clock=clock,
                                     unix=lambda: 1.7e9 + clock.t, process_name="trainer")
        rec.record({"counters": {"requests": 3}})
        first = rec.trip("alert-slo", "p99 over budget", severity="page", value=0.9)
        clock.advance(5.0)
        storm = rec.trip("alert-slo", "again")
        clock.advance(30.0)
        later = rec.trip("anomaly-nan-loss", "later", step=4)
        off = pkg.inc.FlightRecorder()  # no incident dir: the ring only
        off.record({"x": 1})
        return ([read_bundle(b, root) for b in (first, later)], [b.name for b in (first, later)],
                storm, rec.trips, rec.suppressed, off.trip("alert", "x"), off.trips)

    bundles, names, storm, trips, suppressed, off_trip, off_trips = both(run)
    assert names[0].endswith("-alert-slo") and names[1].endswith("-anomaly-nan-loss")
    assert bundles[0]["incident.json"]["severity"] == "page"
    assert bundles[0]["flight-trainer.json"]["snapshots"][0]["snapshot"]["counters"] == {
        "requests": 3}
    assert storm is None and (trips, suppressed) == (2, 1) and off_trip is None and off_trips == 0


def test_same_second_same_source_bundles_never_clobber_as_jax(tmp_path):
    def run(pkg):
        rec = pkg.inc.FlightRecorder(incident_dir=tmp_path / pkg.name, min_trip_interval_s=0.0,
                                     clock=FakeClock(), unix=FakeClock(1000.0))
        return [rec.trip("alert-x", "one").name, rec.trip("alert-x", "two").name]

    names = both(run)
    assert names == ["19700101T001640Z-alert-x", "19700101T001640Z-alert-x-2"]


def test_flight_payload_bounds_the_trace_tail_as_jax():
    def run(pkg):
        clock = FakeClock()
        tb = pkg.tel.TraceBuffer(clock=clock)
        for i in range(50):
            clock.advance(0.01)
            tb.add_span(f"s{i}", tb.now(), 0.001, force=True)
        rec = pkg.inc.FlightRecorder(trace_tail_events=10, unix=lambda: 5.0)
        rec.attach(trace=tb)
        payload = rec.payload()
        payload["trace"]["anchor"].pop("unix_now")  # the wall clock's reading
        return payload

    trace = both(run)["trace"]
    spans = [e for e in trace["traceEvents"] if e.get("ph") != "M"]
    assert len(spans) == 10 and spans[-1]["name"] == "s49" and trace["truncated_events"] == 40


def test_exit_signal_name_as_jax():
    got = both(lambda pkg: [pkg.inc.exit_signal_name(rc) for rc in (-9, -15, -2, 0, 1, None)])
    assert got == ["SIGKILL", "SIGTERM", "SIGINT", None, None, None]


# ----------------------------------------------------------------------
# Crash bundles and the postmortem
# ----------------------------------------------------------------------


def _crash(pkg, root: Path, *, stale=False, blackbox=True, unix=1.7e9):
    bb = root / "bb.json"
    if blackbox:
        flight = _fake_flight("replica-3", events=["serve_batch", "request"], unix_base=100.0)
        flight["written_unix"] = 100.0 if stale else 600.0
        root.mkdir(parents=True, exist_ok=True)
        bb.write_text(json.dumps(flight), encoding="utf8")
    return pkg.inc.write_crash_bundle(
        root / "incidents", process_name="replica-3", rc=-9 if blackbox else 1,
        argv=["python", "-m", "spacy_ray_tpu", "serve", "model"],
        output_tail=["serving on http://127.0.0.1:1234", "ValueError: boom"], generation=5,
        health_history=[{"unix_time": 99.0, "health": {"status": "ok", "generation": 5}}],
        blackbox_path=bb if blackbox else None, process_started_unix=500.0,
        extra_flights={"router": _fake_flight("router", events=["route"], unix_base=101.5)},
        replica_id=3, slot=1, unix=lambda: unix)


@pytest.mark.parametrize("kind", ["with_blackbox", "stale_blackbox", "no_blackbox"])
def test_crash_bundle_files_and_postmortem_equal_jax(kind, tmp_path):
    def run(pkg):
        root = tmp_path / pkg.name
        bundle = _crash(pkg, root, stale=kind == "stale_blackbox",
                        blackbox=kind != "no_blackbox")
        loaded = pkg.inc.load_bundle(bundle)
        merged = pkg.inc.merged_bundle_trace(loaded)
        return (read_bundle(bundle, root), merged,
                pkg.inc.render_postmortem(bundle).replace(str(root), "<root>"))

    files, merged, report = both(run)
    inc = files["incident.json"]
    assert inc["replica_id"] == 3 and inc["slot"] == 1 and inc["generation"] == 5
    if kind == "with_blackbox":
        assert inc["exit_signal"] == "SIGKILL" and inc["blackbox"] == "ok"
        assert sorted(n for n in files if n.startswith("flight-")) == [
            "flight-replica-3.json", "flight-router.json"]
        assert "killed by SIGKILL" in report and "[router] route" in report
        assert "[replica-3] serve_batch" in report
        spans = sorted((e["ts"], e["name"]) for e in merged["traceEvents"] if e.get("ph") == "X")
        assert [n for _, n in spans] == ["serve_batch", "request", "route"]
    elif kind == "stale_blackbox":
        assert inc["blackbox"].startswith("stale-skipped") and "flight-replica-3.json" not in files
    else:
        assert "exit:   code 1" in report and "killed by" not in report
        assert "ValueError: boom" in report


def test_find_bundle_resolves_the_newest_as_jax(tmp_path):
    def run(pkg):
        root = tmp_path / pkg.name
        old = pkg.inc.write_crash_bundle(root, process_name="a", rc=1, unix=lambda: 1000.0)
        new = pkg.inc.write_crash_bundle(root, process_name="b", rc=2, unix=lambda: 2000.0)
        with pytest.raises(FileNotFoundError) as e:
            pkg.inc.find_bundle(root / "nope")
        return (pkg.inc.find_bundle(root) == new, pkg.inc.find_bundle(old) == old,
                str(e.value).replace(str(root), "<root>"))

    assert both(run)[:2] == (True, True)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_bundle_of_either_package_renders_in_the_other_as_in_its_own(writer, tmp_path):
    """A crash bundle and a trainer's anomaly bundle written by ``writer``:
    both packages' ``render_postmortem`` and ``merged_bundle_trace`` give
    the same text and trace."""
    root = tmp_path / "bundles"
    w = PKGS[writer]
    crash = _crash(w, root / "crash")
    clock = FakeClock()
    tel = w.tel.Telemetry(tmp_path / "tel", clock=clock, incident_dir=root / "anomaly",
                          alert_interval_s=1e9)
    tel.trace.add_span("step", clock(), 0.01, force=True, args={"step": 3})
    tel.maybe_evaluate_alerts(force=True)
    tel.detectors.check_loss(3, float("nan"))
    tel.finalize()
    anomaly = w.inc.find_bundle(root / "anomaly")

    def run(pkg):
        return [(pkg.inc.render_postmortem(b), pkg.inc.merged_bundle_trace(pkg.inc.load_bundle(b)))
                for b in (crash, anomaly)]

    (crash_text, _), (anomaly_text, _) = both(run)
    assert "source: crash" in crash_text
    assert "source: anomaly-nan-loss  process: trainer" in anomaly_text
    assert "detail: step=3" in anomaly_text and "[trainer] step" in anomaly_text


def test_postmortem_commands_print_the_same_report_and_trace(tmp_path, capsys):
    bundle_root = tmp_path / "incidents"
    bb = tmp_path / "bb.json"
    bb.write_text(json.dumps(_fake_flight("replica-1", events=["x"], unix_base=50.0)),
                  encoding="utf8")
    j_inc.write_crash_bundle(bundle_root, process_name="replica-1", rc=-9, output_tail=["boom"],
                             blackbox_path=bb, replica_id=1, slot=0, unix=lambda: 1.7e9)

    def run(pkg):
        out_trace = tmp_path / f"{pkg.name}.json"
        rc = pkg.telemetry_command(["postmortem", str(bundle_root), "--trace-out",
                                    str(out_trace)])
        out = capsys.readouterr().out.replace(str(out_trace), "<trace>")
        absent = pkg.telemetry_command(["postmortem", str(tmp_path / "absent")])
        err = capsys.readouterr().err
        return rc, out, json.loads(out_trace.read_text(encoding="utf8")), absent, err

    rc, out, trace, absent, err = both(run)
    assert rc == 0 and "killed by SIGKILL" in out and out.endswith(
        "merged bundle trace written to <trace>\n")
    assert trace["otherData"]["merged_from"] == ["replica-1"]
    assert absent == 1 and "neither an incident bundle" in err


# ----------------------------------------------------------------------
# The trainer's wiring through Telemetry
# ----------------------------------------------------------------------


def test_the_trainers_anomaly_trips_one_bundle_per_storm_as_jax(tmp_path):
    def run(pkg):
        root = tmp_path / pkg.name
        clock = FakeClock()
        tel = pkg.tel.Telemetry(root / "tel", clock=clock, incident_dir=root / "inc",
                                alert_interval_s=1e9)
        assert tel.recorder is not None and tel.alerts is not None
        tel.detectors.check_loss(3, float("nan"))
        tel.detectors.check_loss(4, float("nan"))
        tel.detectors.check_loss(5, float("nan"))
        suppressed = tel.recorder.suppressed
        tel.finalize()
        bundles = sorted(d for d in (root / "inc").iterdir() if d.is_dir())
        manifest = json.loads((bundles[0] / "incident.json").read_text())
        manifest.pop("unix_time")
        flight = json.loads((bundles[0] / "flight-trainer.json").read_text())
        return (len(bundles), manifest, suppressed,
                [r["alert"] for r in flight["alerts"]], flight["process"])

    n, manifest, suppressed, rules, process = both(run)
    assert n == 1 and suppressed == 2 and process == "trainer"
    assert manifest["source"] == "anomaly-nan-loss" and manifest["step"] == 3
    assert "training-stalled" in rules


def test_the_stall_alert_fires_through_the_boundary_hook_as_jax(tmp_path):
    def run(pkg):
        root = tmp_path / pkg.name
        clock = FakeClock()
        tel = pkg.tel.Telemetry(root, clock=clock, anomaly_detection=False)
        tel.maybe_evaluate_alerts(force=True)
        evals0 = tel.alerts.evaluations
        for _ in range(50):  # inside the interval: a clock compare each
            tel.maybe_evaluate_alerts()
        rate_limited = tel.alerts.evaluations == evals0
        clock.advance(400.0)
        tel.maybe_evaluate_alerts()
        firing = {r["alert"]: r["state"] for r in tel.alerts.states()}
        clock.advance(10.0)
        tel.registry.counter("steps").inc()
        tel.maybe_evaluate_alerts(force=True)
        after = {r["alert"]: r["state"] for r in tel.alerts.states()}
        tel.finalize()
        rows = [json.loads(x) for x in (root / "alerts.jsonl").read_text().splitlines()]
        return rate_limited, firing, after, [(r["alert"], r["from"], r["to"]) for r in rows]

    rate_limited, firing, after, rows = both(run)
    assert rate_limited and firing["training-stalled"] == "firing"
    assert after["training-stalled"] == "inactive"
    assert rows == [("training-stalled", "inactive", "firing"),
                    ("training-stalled", "firing", "inactive")]


def test_the_stall_alert_fires_while_the_loop_is_wedged(tmp_path):
    """No boundary after the first pass: the ticker thread evaluates the
    stall rule on wall time, in both packages; finalize stops it. The
    port's ticker starts with the loop (``loop_start``), not before."""
    def run(pkg):
        tel = pkg.tel.Telemetry(
            tmp_path / pkg.name, anomaly_detection=False, alert_interval_s=0.05,
            alert_rules=[pkg.A.AbsenceRule("training-stalled", "counters.steps", stale_s=0.3)])
        try:
            if pkg.name == "port":
                assert tel._alert_ticker is None
            tel.loop_start()
            tel.maybe_evaluate_alerts(force=True)
            deadline = time.monotonic() + 10.0
            state = None
            while time.monotonic() < deadline:
                state = tel.alerts.states()[0]["state"]
                if state == "firing":
                    break
                time.sleep(0.05)
        finally:
            tel.finalize()
        return state, tel._alert_ticker is None

    assert both(run) == ("firing", True)


def test_alerting_off_builds_no_engine_and_no_recorder_without_a_dir(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("an alert engine was built with alerting off")

    monkeypatch.setattr(p_alerting.AlertEngine, "__init__", boom)
    monkeypatch.setattr(p_inc.FlightRecorder, "__init__", boom)
    tel = p_tel.Telemetry(tmp_path / "tel", alerting=False)
    assert tel.alerts is None and tel.recorder is None and tel._alert_ticker is None
    tel.maybe_evaluate_alerts(force=True)  # nothing to do, no raise
    tel.finalize()
    assert p_inc.__all__ == j_inc.__all__
