"""Serving-side alerts and incidents of the port (``serving/server.py``,
``serving/fleet/``, ``serve --incidents-dir``, ``serve-fleet
--incidents-dir``) held against the JAX package's on the CPU.

Each scenario runs once with each package on the same inputs and fake clocks
(the host sampler faked in both) and the results must be equal:

* a server's observer ticks over one request sequence: every tick's rule
  states, ``/admin/alerts``, the ``/metrics`` ``alerts`` block and the
  ``srt_alert_*`` series;
* ``Fleet.observe_tick`` over one router script: the router rules' states
  tick by tick (``no-ready-replica`` silent through the warm-up, armed by
  the first ready replica, firing after it) and ``/admin/alerts``;
* the replica argv with the incident flags, from ``build_serve_cmd`` and
  from ``FleetConfig`` (the package name aside);
* a stub replica SIGKILLed under each supervisor, whose crash hook is the
  fleet's: the bundle's files, ``incident.json`` field for field (the
  interpreter, package name and times aside) and the postmortem's verdict;
* with telemetry off (JAX ``tests/test_incidents.py:464-510``): no alert
  engine, no recorder, no crash hook, no replica flag, no directory and no
  observer thread, ``__init__`` of both classes monkeypatched to raise.

End to end on the CPU (JAX ``tests/test_fleet.py:1595``): ``serve-fleet
--device cpu --incidents-dir D --observe-interval-s 0.25`` on a small CNN
model, one replica SIGKILLed under two clients: no 5xx but 503, a crash
bundle with the signal, the banner in the output tail, a non-empty
pre-crash span ring from the black box and the router's health history,
and ``telemetry postmortem`` naming SIGKILL.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

import spacy_ray_tpu.alerting as j_A
import spacy_ray_tpu.incidents as j_inc
import spacy_ray_tpu.serving.batcher as j_batcher
import spacy_ray_tpu.serving.engine as j_engine
import spacy_ray_tpu.serving.server as j_server
import spacy_ray_tpu_torch as P
import spacy_ray_tpu_torch.__main__ as p_cli
import spacy_ray_tpu_torch.alerting as p_A
import spacy_ray_tpu_torch.incidents as p_inc
import spacy_ray_tpu_torch.serving.batcher as p_batcher
import spacy_ray_tpu_torch.serving.engine as p_engine
import spacy_ray_tpu_torch.serving.server as p_server
from spacy_ray_tpu_torch.util import synth_corpus

from test_torch_serving_fleet import PKGS as FLEET
from test_torch_serving_fleet import PROCESS_SAMPLE, SLEEP_SCRIPT, _supervisor, _wait_until
from test_torch_serving_fleet_cli import CFG, TEXTS

REPO = Path(__file__).resolve().parent.parent

PKGS = {
    "jax": SimpleNamespace(name="jax", A=j_A, inc=j_inc, engine=j_engine, server=j_server,
                           batcher=j_batcher, fleet=FLEET["jax"], pkg="spacy_ray_tpu"),
    "port": SimpleNamespace(name="port", A=p_A, inc=p_inc, engine=p_engine, server=p_server,
                            batcher=p_batcher, fleet=FLEET["port"], pkg="spacy_ray_tpu_torch"),
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


@pytest.fixture
def fake_host(monkeypatch):
    """Every process sample of both packages is one fixed dict."""
    for pkg in FLEET.values():
        monkeypatch.setattr(pkg.host.ProcessSampler, "sample",
                            lambda self, force=False: dict(PROCESS_SAMPLE))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode("utf8")


def _serve_http(httpd):
    """What ``start()`` runs for the listener, without the observer thread:
    the tests tick by hand."""
    threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()


def _states(engine):
    return [(s["alert"], s["state"]) for s in engine.states()]


# ----------------------------------------------------------------------
# The server's observer
# ----------------------------------------------------------------------


class StubEngine:
    """What the server's observer and ``/metrics`` read of an engine."""

    ready = True
    serving_generation = 7
    swap_count = 2
    warmed = []


def _server_observer_scenario(pkg, tmp_path):
    clock, unix = FakeClock(100.0), FakeClock(1.7e9)
    tel = pkg.engine.ServingTelemetry(clock=clock, slo_window_s=60.0)
    alerts = pkg.A.AlertEngine(pkg.A.default_serving_rules(p99_target_s=0.5), clock=clock,
                               unix=unix, sink_path=tmp_path / pkg.name / "alerts.jsonl",
                               source="replica")
    server = pkg.server.Server(StubEngine(), "127.0.0.1", 0, telemetry=tel, alerts=alerts,
                               observe_interval_s=3600.0)
    server._observer_stop.set()  # each _observe_loop() call is then one tick
    _serve_http(server.httpd)
    port = server.httpd.server_address[1]
    ticks = []
    try:
        for tick in range(20):
            slow = 4 <= tick < 14
            for i in range(6):
                tel.request_admitted(1, 0)
                tel.request_completed(latency_s=0.8 if slow else 0.01, queue_wait_s=0.001,
                                      t0=None, error=None)
            if tick in (5, 6):  # queue-full rejects burn the error budget
                for _ in range(4):
                    tel.request_rejected(pkg.batcher.QueueFull("full"))
            server._observe_loop()
            ticks.append(_states(alerts))
            clock.advance(5.0)
            unix.advance(5.0)
        admin = json.loads(_get(port, "/admin/alerts"))
        block = json.loads(_get(port, "/metrics"))["alerts"]
        series = [x for x in _get(port, "/metrics?format=prometheus").splitlines()
                  if "srt_alert" in x]
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()
    sink = [json.loads(x) for x in open(tmp_path / pkg.name / "alerts.jsonl")]
    return ticks, admin, block, series, sink


def test_the_servers_observer_gives_jaxs_states_admin_alerts_and_metrics(tmp_path, fake_host):
    ticks, admin, block, series, sink = both(_server_observer_scenario, tmp_path)
    slo = [dict(t)["serving-latency-slo"] for t in ticks]
    # the window p99 above 0.5 s from tick 4 on, 30 s pending, firing until
    # the slow requests leave the 60 s window
    assert slo[3] == "inactive" and slo[4] == "pending" and slo[10] == "firing"
    assert "firing" in {r["state"] for r in admin["alerts"]}
    assert block["firing"] >= 1 and "serving-latency-slo" in block["firing_names"]
    assert 'srt_alert_state{alert="serving-latency-slo",severity="page"} 2' in series
    assert ("pending", "firing") in [(r["from"], r["to"]) for r in sink]
    assert all(r["source"] == "replica" for r in sink)


def _observe_tick_failure_scenario(pkg, caplog):
    """A snapshot that raises is logged and the loop goes on."""
    class Broken:
        def snapshot(self):
            raise RuntimeError("snapshot torn")

    alerts = pkg.A.AlertEngine(pkg.A.default_serving_rules(), source="replica")
    server = pkg.server.Server(StubEngine(), "127.0.0.1", 0, telemetry=Broken(), alerts=alerts)
    server._observer_stop.set()
    try:
        caplog.clear()
        server._observe_loop()
        return ["observer tick failed" in r.getMessage() for r in caplog.records], \
            alerts.evaluations
    finally:
        server.httpd.server_close()


def test_a_failing_observer_tick_is_logged_and_serving_goes_on(caplog):
    logged, evaluations = both(_observe_tick_failure_scenario, caplog)
    assert logged == [True] and evaluations == 0


# ----------------------------------------------------------------------
# The fleet's observer: the router rules
# ----------------------------------------------------------------------


def _fleet_observe_scenario(pkg, tmp_path):
    F = pkg.fleet.F
    clock, unix = FakeClock(50.0), FakeClock(1.7e9)
    fleet = F.Fleet(F.FleetConfig(model_path="m", device="cpu", port=0, telemetry=True,
                                  p99_target_ms=500.0))
    fleet.tel = fleet.router.tel = pkg.fleet.router.RouterTelemetry(clock=clock)
    fleet.alerts.clock, fleet.alerts.unix = clock, unix
    _serve_http(fleet.httpd)
    port = fleet.httpd.server_address[1]
    ticks = []
    try:
        for tick in range(40):
            ready = 0 if tick < 6 or 14 <= tick < 18 else 1  # warm-up, then an outage
            fleet.tel.replica_counts(ready, 1)
            for _ in range(5):
                fleet.tel.request()
                if ready:
                    fleet.tel.routed(0.9 if tick >= 8 else 0.02)
                else:
                    fleet.tel.rejected(pkg.fleet.router.NoReplicaAvailable("none ready"))
            if tick in (9, 10, 11):
                fleet.tel.scrape_failed(0)
            fleet.observe_tick()
            ticks.append(_states(fleet.alerts))
            clock.advance(5.0)
            unix.advance(5.0)
        admin = json.loads(_get(port, "/admin/alerts"))
        block = json.loads(_get(port, "/metrics"))["alerts"]
        series = [x for x in fleet.router.prometheus_metrics().splitlines() if "srt_alert" in x]
    finally:
        fleet.httpd.shutdown()
        fleet.httpd.server_close()
    return ticks, admin, block, series


def test_fleet_observe_tick_gives_jaxs_router_rule_states(tmp_path, fake_host):
    ticks, admin, block, series = both(_fleet_observe_scenario, tmp_path)
    names = [name for name, _ in ticks[0]]
    assert sorted(names) == sorted(r.name for r in p_A.default_router_rules())
    no_ready = [dict(t)["no-ready-replica"] for t in ticks]
    assert set(no_ready[:6]) == {"inactive"}  # a cold start is a boot, not an outage
    assert no_ready[14] == "pending" and no_ready[16] == "firing" and no_ready[-1] != "firing"
    # 3 failed scrapes inside 120 s, judged once the history spans the window
    unscrapable = [dict(t)["replica-unscrapable"] for t in ticks]
    assert unscrapable[23] == "inactive" and unscrapable[26] == "firing"
    assert "firing" in {dict(t)["fleet-latency-slo"] for t in ticks}
    assert [r["alert"] for r in admin["alerts"]] == names
    assert isinstance(block["firing"], int)
    assert any(x.startswith('srt_alert_state{alert="no-ready-replica"') for x in series)


# ----------------------------------------------------------------------
# The replica argv
# ----------------------------------------------------------------------


def _argv_scenario(pkg, tmp_path):
    F = pkg.fleet.F
    inc = str(tmp_path / "inc")
    direct = pkg.fleet.replica.build_serve_cmd(
        "m", device="cpu", port=0, max_batch=4, swap_dir="w", incidents_dir=inc,
        blackbox=inc + "/blackbox/slot-0.json", observe_interval_s=0.25, model_manifest="mm",
        resident_models=2)
    config = F.FleetConfig(model_path="m", device="cpu", port=0, max_batch=4,
                           incidents_dir=inc, observe_interval_s=0.25, batching="continuous",
                           max_wait_ms=5.0)
    off = F.FleetConfig(model_path="m", device="cpu", port=0, incidents_dir=inc,
                        telemetry=False)
    return [[a.replace(pkg.pkg, "<pkg>") for a in argv]
            for argv in (direct, config.build_cmd(1), off.build_cmd(0))], \
        config.blackbox_path(3)


def test_the_replica_argv_with_the_incident_flags_equals_jaxs(tmp_path):
    (direct, config, off), blackbox = both(_argv_scenario, tmp_path)
    inc = str(tmp_path / "inc")
    assert direct[direct.index("--incidents-dir") + 1] == inc
    assert direct[direct.index("--observe-interval-s") + 1] == "0.25"
    assert config[config.index("--blackbox") + 1] == f"{inc}/blackbox/slot-1.json"
    assert config[config.index("--batching") + 1] == "continuous"
    assert "--incidents-dir" not in off and "--blackbox" not in off and "--no-telemetry" in off
    assert blackbox == f"{inc}/blackbox/slot-3.json"


# ----------------------------------------------------------------------
# A crash bundle from a stub replica killed under each supervisor
# ----------------------------------------------------------------------


def _crash_scenario(pkg, tmp_path, monkeypatch):
    F = pkg.fleet.F
    inc = tmp_path / pkg.name
    fleet = F.Fleet(F.FleetConfig(model_path="m", device="cpu", port=0,
                                  incidents_dir=str(inc), observe_interval_s=0.25))
    fleet.httpd.server_close()
    sup = _supervisor(pkg.fleet, monkeypatch, SLEEP_SCRIPT, on_crash=fleet._on_replica_crash,
                      max_restarts_per_replica=0)
    [handle] = sup.start(1)
    try:
        assert _wait_until(lambda: handle.address is not None)
        handle.generation = 40
        handle.health_history.append({"unix_time": 1.0, "health": {"status": "ok",
                                                                   "generation": 40}})
        box = Path(fleet.config.blackbox_path(handle.slot))
        box.parent.mkdir(parents=True, exist_ok=True)
        box.write_text(json.dumps({
            "process": f"replica-pid{handle.proc.pid}", "written_unix": time.time() + 5.0,
            "snapshots": [], "trace": {"traceEvents": [
                {"name": "request", "ph": "X", "ts": 0.0, "dur": 10.0, "pid": 0, "tid": 0}],
                "anchor": {"origin": 0.0, "clock_now": 0.0, "unix_now": time.time()}}}),
            encoding="utf8")
        os.kill(handle.proc.pid, signal.SIGKILL)
        assert _wait_until(lambda: inc.is_dir() and any(
            "crash-replica" in d.name for d in inc.iterdir()), timeout=20)
    finally:
        sup.stop_all()
    [bundle] = [d for d in inc.iterdir() if "crash-replica" in d.name]
    manifest = json.loads((bundle / "incident.json").read_text(encoding="utf8"))
    manifest.pop("unix_time")
    manifest["argv"] = [a.replace(str(inc), "<inc>").replace(pkg.pkg, "<pkg>")
                        for a in manifest["argv"]]
    report = pkg.inc.render_postmortem(bundle)
    return (manifest, sorted(f.name.split("-pid")[0] for f in bundle.iterdir()),
            (bundle / "stderr.txt").read_text(encoding="utf8"),
            json.loads((bundle / "health.json").read_text(encoding="utf8")),
            "killed by SIGKILL" in report, bundle.name.split("-", 1)[-1])


def test_a_killed_stub_replica_leaves_jaxs_crash_bundle(tmp_path, monkeypatch):
    manifest, files, tail, health, killed, source = both(_crash_scenario, tmp_path,
                                                         monkeypatch)
    assert manifest["exit_code"] == -9 and manifest["exit_signal"] == "SIGKILL"
    assert manifest["source"] == "crash" and manifest["blackbox"] == "ok"
    assert manifest["generation"] == 40 and manifest["replica_id"] == 0
    assert "--incidents-dir" in manifest["argv"]
    assert files == ["flight-replica", "flight-router.json", "health.json", "incident.json",
                     "stderr.txt"]
    assert "serving on http://127.0.0.1:59000" in tail
    assert health[0]["health"]["generation"] == 40 and killed
    assert source == "crash-replica-0"


def _hook_failure_scenario(pkg, monkeypatch, caplog):
    """A crash hook that raises is logged; the replica is restarted."""
    def hook(handle, rc):
        raise RuntimeError("disk full")

    sup = _supervisor(pkg.fleet, monkeypatch, SLEEP_SCRIPT, on_crash=hook)
    [handle] = sup.start(1)
    try:
        assert _wait_until(lambda: handle.address is not None)
        first = handle.proc.pid
        caplog.clear()
        os.kill(first, signal.SIGKILL)
        assert _wait_until(lambda: handle.proc.pid != first and handle.address is not None)
        return handle.restarts, any("crash-incident hook failed" in r.getMessage()
                                    for r in caplog.records)
    finally:
        sup.stop_all()


def test_a_failing_crash_hook_is_logged_and_the_replica_restarted(monkeypatch, caplog):
    assert both(_hook_failure_scenario, monkeypatch, caplog) == (1, True)


# ----------------------------------------------------------------------
# Telemetry off: nothing of the diagnosis layer is built
# ----------------------------------------------------------------------


def _boom(*a, **k):
    raise AssertionError("the diagnosis layer was built with telemetry off")


def _telemetry_off_fleet_scenario(pkg, tmp_path, monkeypatch):
    monkeypatch.setattr(pkg.A.AlertEngine, "__init__", _boom)
    monkeypatch.setattr(pkg.inc.FlightRecorder, "__init__", _boom)
    F = pkg.fleet.F
    fleet = F.Fleet(F.FleetConfig(model_path="unused", device="cpu", port=0, telemetry=False,
                                  incidents_dir=str(tmp_path / pkg.name)))
    try:
        cmd = fleet.config.build_cmd(0)
        return (fleet.alerts, fleet.recorder, fleet.supervisor.on_crash,
                "--incidents-dir" in cmd or "--blackbox" in cmd,
                "--observe-interval-s" in cmd, (tmp_path / pkg.name).exists())
    finally:
        fleet.httpd.server_close()
        monkeypatch.undo()


def test_a_fleet_with_telemetry_off_builds_no_alerts_recorder_or_flags(tmp_path, monkeypatch):
    assert both(_telemetry_off_fleet_scenario, tmp_path, monkeypatch) == (
        None, None, None, False, False, False)


def _server_no_observer_scenario(pkg):
    before = set(threading.enumerate())
    server = pkg.server.Server(StubEngine(), "127.0.0.1", 0)
    try:
        server.start()
        return server._observer, [t.name for t in set(threading.enumerate()) - before
                                  if t.name == "serve-observer"]
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()


def test_a_server_without_alerts_or_recorder_starts_no_observer():
    assert both(_server_no_observer_scenario) == (None, [])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_model")
    nlp = P.Pipeline.from_config(P.Config.from_str(CFG), device="cpu")
    nlp.initialize(lambda: synth_corpus(64, "tagger", seed=0), seed=0)
    nlp.to_disk(root / "model")
    return root / "model"


def test_serve_no_telemetry_builds_no_engine_recorder_or_directory(model_dir, tmp_path,
                                                                  monkeypatch):
    monkeypatch.setattr(p_A.AlertEngine, "__init__", _boom)
    monkeypatch.setattr(p_inc.FlightRecorder, "__init__", _boom)
    server = p_cli.build_server([str(model_dir), "--device", "cpu", "--port", "0",
                                 "--no-telemetry", "--no-warmup", "--incidents-dir",
                                 str(tmp_path / "inc"), "--blackbox",
                                 str(tmp_path / "bb.json"), "--observe-interval-s", "0.05"])
    try:
        server.start()
        assert server.alerts is None and server.recorder is None and server._observer is None
        assert _get(server.address[1], "/admin/alerts") == '{"alerts": "disabled"}'
        time.sleep(0.2)
        assert not (tmp_path / "inc").exists() and not (tmp_path / "bb.json").exists()
    finally:
        server.request_shutdown()
        assert server.wait() == 0


def test_serve_arms_the_engine_and_recorder_as_the_jax_command(model_dir, tmp_path):
    """``serve --incidents-dir D --blackbox F``: the serving rules with the
    p99 target, the sink and the recorder's hook, the recorder named after
    the process; the observer's first tick persists the black box at once,
    the ticker stops with the drain."""
    server = p_cli.build_server([str(model_dir), "--device", "cpu", "--port", "0",
                                 "--no-warmup", "--incidents-dir", str(tmp_path / "inc"),
                                 "--blackbox", str(tmp_path / "bb.json"),
                                 "--alert-p99-ms", "250", "--observe-interval-s", "0.05"])
    alerts, recorder = server.alerts, server.recorder
    assert [r.name for r in alerts.rules] == [r.name for r in j_A.default_serving_rules()]
    slo = next(r for r in alerts.rules if r.name == "serving-latency-slo")
    assert slo.threshold == 0.25 and alerts.source == "replica"
    assert alerts.sink_path == tmp_path / "inc" / "alerts.jsonl"
    assert recorder.process_name == f"replica-pid{os.getpid()}"
    assert recorder.incident_dir == tmp_path / "inc"
    assert server.observe_interval_s == 0.05
    try:
        _, port = server.start()
        server.engine.start(warmup=False)
        assert _wait_until(lambda: (tmp_path / "bb.json").is_file())
        box = json.loads((tmp_path / "bb.json").read_text(encoding="utf8"))
        assert box["process"] == recorder.process_name and box["snapshots"]
        snap = box["snapshots"][0]["snapshot"]
        assert snap["generation"] is None and snap["swap_count"] == 0
        assert sorted(r["alert"] for r in json.loads(_get(port, "/admin/alerts"))["alerts"]) \
            == sorted(r.name for r in alerts.rules)
        assert json.loads(_get(port, "/metrics"))["alerts"]["firing"] == 0
    finally:
        server.request_shutdown()
        assert server.wait() == 0
    assert server._observer is None and recorder.records >= 1


# ----------------------------------------------------------------------
# End to end: a real CPU fleet, a replica SIGKILLed under load
# ----------------------------------------------------------------------


def _post(port, texts, timeout=60.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/parse",
                                 data=json.dumps({"texts": texts}).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def test_a_sigkilled_replica_leaves_a_crash_bundle_the_postmortem_renders(model_dir,
                                                                          tmp_path):
    inc = tmp_path / "incidents"
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve-fleet", str(model_dir),
         "--replicas", "2", "--device", "cpu", "--port", "0", "--max-batch", "4",
         "--max-doc-len", "32", "--probe-interval-s", "0.1", "--drain-timeout-s", "20",
         "--max-wait-ms", "2", "--incidents-dir", str(inc), "--observe-interval-s", "0.25"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)}, start_new_session=True)
    lines = []
    threading.Thread(target=lambda: lines.extend(l.rstrip() for l in proc.stdout),
                     daemon=True).start()
    pids, stop, failures = set(), threading.Event(), []
    try:
        assert _wait_until(lambda: any(l.startswith("fleet ready: 2") for l in lines),
                           timeout=120, interval=0.1), lines
        banner = [l for l in lines if l.startswith("fleet serving on http://")][0]
        port = int(banner.split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)[1])
        roster = {r["id"]: r for r in json.loads(_get(port, "/metrics"))["replicas"]}
        pids = {r["pid"] for r in roster.values()}
        victim, slot = roster[0]["pid"], roster[0]["slot"]
        blackbox = inc / "blackbox" / f"slot-{slot}.json"

        def client():
            while not stop.is_set():
                try:
                    status, _ = _post(port, TEXTS[:2])
                except OSError:
                    continue
                if status >= 500 and status != 503:
                    failures.append(status)

        clients = [threading.Thread(target=client) for _ in range(2)]
        for th in clients:
            th.start()

        def spans_persisted():
            try:
                box = json.loads(blackbox.read_text(encoding="utf8"))
            except (OSError, ValueError):
                return False
            return any(e.get("ph") == "X" for e in (box.get("trace") or {}).get(
                "traceEvents") or [])

        # the black box rewrites at most every ~10 s: wait for one with spans
        assert _wait_until(spans_persisted, timeout=60, interval=0.1), \
            "the replica's black box never held a span"
        os.kill(victim, signal.SIGKILL)

        def crash_bundles():
            return [d for d in inc.iterdir() if d.is_dir() and "crash-replica" in d.name]

        assert _wait_until(crash_bundles, timeout=60, interval=0.1), "no crash bundle"
        stop.set()
        for th in clients:
            th.join(timeout=60)
        assert not failures, failures[:5]
        [bundle] = crash_bundles()
        manifest = json.loads((bundle / "incident.json").read_text(encoding="utf8"))
        assert manifest["exit_code"] == -9 and manifest["exit_signal"] == "SIGKILL"
        assert manifest["blackbox"] == "ok" and "serve" in manifest["argv"]
        assert "serving on http://" in (bundle / "stderr.txt").read_text(encoding="utf8")
        replica_flights = [json.loads(f.read_text(encoding="utf8"))
                           for f in bundle.glob("flight-replica*.json")]
        assert [e for fl in replica_flights for e in fl["trace"]["traceEvents"]
                if e.get("ph") == "X"], "the pre-crash span ring is empty"
        assert (bundle / "flight-router.json").is_file() and (bundle / "health.json").is_file()
        out = subprocess.run([sys.executable, "-m", "spacy_ray_tpu_torch", "telemetry",
                              "postmortem", str(bundle)], cwd=REPO, capture_output=True,
                             text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
        assert out.returncode == 0 and "killed by SIGKILL" in out.stdout
        assert "timeline" in out.stdout
        alerts = json.loads(_get(port, "/admin/alerts"))["alerts"]
        assert sorted(r["alert"] for r in alerts) == sorted(
            r.name for r in p_A.default_router_rules())

        def restarted():
            r0 = {r["id"]: r for r in json.loads(_get(port, "/metrics"))["replicas"]}[0]
            return r0["ready"] and r0["pid"] != victim and r0["pid"]

        back = _wait_until(restarted, timeout=60, interval=0.1)  # before the drain
        assert back, lines[-20:]
        pids.add(json.loads(_get(port, "/metrics"))["replicas"][0]["pid"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0, lines[-20:]
    finally:
        stop.set()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
