"""The port's placement of models across a serving fleet
(``serving/multimodel/placement.py`` and ``Fleet.placement_tick``) held
against the JAX package's on the same inputs, on the CPU: the policy's
decisions and reasons on one fake clock, and the fleet's tick (loads,
events, the ``placement_decisions`` counter, trace instants and the
``placement.jsonl`` ledger, ``unix_time`` aside) over stubbed routers and
over stub replicas reached through HTTP. Then ``serve-fleet --autoscale
--model-manifest`` builds the policy in both CLIs."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

import spacy_ray_tpu.cli as j_cli
import spacy_ray_tpu.serving.fleet as j_fleet
import spacy_ray_tpu.serving.multimodel as j_mm
import spacy_ray_tpu.training.resilience as j_res
import spacy_ray_tpu_torch.__main__ as p_cli
import spacy_ray_tpu_torch.serving.fleet as p_fleet
import spacy_ray_tpu_torch.serving.multimodel as p_mm
import spacy_ray_tpu_torch.training.resilience as p_res

from test_torch_serving_fleet import norm

PKGS = {
    "jax": SimpleNamespace(F=j_fleet, mm=j_mm, res=j_res, cli=j_cli, tag="jax"),
    "port": SimpleNamespace(F=p_fleet, mm=p_mm, res=p_res, cli=p_cli, tag="port"),
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

    def advance(self, dt):
        self.t += dt


MANIFEST = {
    "default_model": "alpha",
    "models": {"alpha": {"path": "models/alpha"}, "beta": {"path": "models/beta"}},
    "classes": {"gold": {"weight": 4, "p99_target_ms": 500},
                "batch": {"weight": 1, "p99_target_ms": 5000}},
    "tenants": {"acme": {"class": "gold", "quota_docs_per_s": 10, "quota_burst": 10},
                "bulk": {"class": "batch"}},
}


def write_manifest(tmp_path):
    p = tmp_path / "manifest.json"
    p.write_text(json.dumps(MANIFEST), encoding="utf-8")
    return p


def _registry3(pkg):
    return pkg.mm.ModelRegistry({n: pkg.mm.ModelSpec(n, f"/m/{n}") for n in ("a", "b", "c")},
                                "a")


def _policy(pkg, clock, registry=None):
    return pkg.mm.PlacementPolicy(registry if registry is not None else _registry3(pkg),
                                  default_p99_target_ms=500.0, breach_consecutive=2,
                                  cooldown_s=30.0, min_window_samples=5, clock=clock)


def _decisions(ds):
    return [(d.model, d.replica_id, d.reason) for d in ds]


# ----------------------------------------------------------------------
# The policy: hysteresis over per-model window p99 (JAX test_multimodel.py)
# ----------------------------------------------------------------------


def _streak_then_cooldown(pkg):
    clock = FakeClock()
    pol = _policy(pkg, clock)
    hot = {"b": {"p99": 1.0, "samples": 50}}
    placement = {0: ["a", "b"], 1: ["a"]}
    out = [_decisions(pol.observe(hot, placement, [0, 1]))]
    for dt in (1, 1, 1, 31):  # the cooldown defers the standing breach
        clock.advance(dt)
        out.append(_decisions(pol.observe(hot, placement, [0, 1])))
    return out


def test_placement_breach_streak_then_cooldown():
    out = both(_streak_then_cooldown)
    assert [len(o) for o in out] == [0, 1, 0, 0, 1]
    assert out[1][0][:2] == ("b", 1) and "p99" in out[1][0][2]
    assert out[4][0][1] == 1


def _recovery_and_thin_windows(pkg):
    pol = _policy(pkg, FakeClock())
    placement = {0: ["b"], 1: []}
    return [_decisions(pol.observe({"b": {"p99": p99, "samples": n}}, placement, [0, 1]))
            for p99, n in ((1.0, 50), (0.1, 50), (1.0, 50), (1.0, 2), (1.0, 50), (1.0, 50))]


def test_placement_recovery_and_thin_windows_reset_streak():
    out = both(_recovery_and_thin_windows)
    assert [len(o) for o in out] == [0, 0, 0, 0, 0, 1] and out[5][0][1] == 1


def _fewest_resident_and_saturation(pkg):
    clock = FakeClock()
    pol = _policy(pkg, clock)
    hot = {"b": {"p99": 1.0, "samples": 50}}
    placement = {0: ["b"], 1: ["a", "c"], 2: []}
    out = [_decisions(pol.observe(hot, placement, [1, 2])),
           _decisions(pol.observe(hot, placement, [1, 2]))]
    clock.advance(31)
    saturated = {0: ["b"], 1: ["b"], 2: ["b"]}
    out += [_decisions(pol.observe(hot, saturated, [0, 1, 2])),
            _decisions(pol.observe(hot, saturated, [0, 1, 2]))]
    return out


def test_placement_targets_fewest_resident_and_saturation_is_no_op():
    out = both(_fewest_resident_and_saturation)
    assert out[1][0][1] == 2  # the replica with the fewest resident models
    assert out[2] == [] and out[3] == []  # every ready replica hosts it


def _class_target(pkg):
    reg = pkg.mm.ModelRegistry(
        {"m": pkg.mm.ModelSpec("m", "/m")}, "m",
        classes={"gold": pkg.mm.ClassSpec("gold", weight=4.0, p99_target_ms=50.0)})
    pol = _policy(pkg, FakeClock(100.0), registry=reg)
    hot = {"m": {"p99": 0.1, "samples": 50}}  # under the 500 ms default, over gold's 50
    return [_decisions(pol.observe(hot, {0: ["m"]}, [0, 1])) for _ in range(2)]


def test_placement_class_target_overrides_default():
    out = both(_class_target)
    assert out[0] == [] and out[1][0][:2] == ("m", 1) and "target 50ms" in out[1][0][2]


# ----------------------------------------------------------------------
# Fleet.placement_tick (JAX test_multimodel.py test_fleet_placement_tick_appends_ledger)
# ----------------------------------------------------------------------


def _model_snap(requests, p99=0.01):
    return {"counters": {"requests": requests}, "gauges": {"queue_depth": 1},
            "histograms": {}, "slo_window": {"request_latency_p99": p99, "samples": requests}}


def _fleet(pkg, tmp_path, **kw):
    return pkg.F.Fleet(pkg.F.FleetConfig(
        model_path=str(tmp_path / "alpha"), port=0, device="cpu", replicas=0,
        autoscale=True, up_consecutive=1, model_manifest=str(write_manifest(tmp_path)),
        incidents_dir=str(tmp_path / "incidents"), **kw))


def _stub_router(fleet, loads, status=200):
    fleet.router.ready_handles = lambda: [SimpleNamespace(replica_id=0),
                                          SimpleNamespace(replica_id=1)]
    fleet.router.placement = lambda: {0: ["alpha", "beta"], 1: ["alpha"]}

    def load_model(rid, model, **kw):
        loads.append((rid, model))
        if status is None:
            raise OSError("replica went away")
        return status, b"{}"

    fleet.router.load_model = load_model


def _tick_outcome(pkg, fleet, tmp_path, decisions, loads):
    ledger = tmp_path / "incidents" / "placement.jsonl"
    lines = [json.loads(l) for l in ledger.read_text().splitlines()] if ledger.exists() else []
    for line in lines:
        assert isinstance(line.pop("unix_time"), float)
    out = {"decisions": _decisions(decisions), "loads": loads, "ledger": lines,
           "events": norm(pkg.res.drain_events())}
    if fleet.tel is not None:
        out["counter"] = fleet.tel.snapshot()["counters"].get("placement_decisions")
        out["instants"] = [e["args"] for e in fleet.tel.trace.payload()["traceEvents"]
                           if e.get("name") == "placement"]
    return out


def _placement_tick(pkg, tmp_path, telemetry, status):
    tmp_path = tmp_path / pkg.tag
    tmp_path.mkdir()
    pkg.res.drain_events()
    fleet = _fleet(pkg, tmp_path, telemetry=telemetry)
    try:
        loads = []
        _stub_router(fleet, loads, status)
        snap = {**_model_snap(400), "models": {"alpha": _model_snap(200, p99=0.005),
                                               "beta": _model_snap(200, p99=10.0)}}
        decisions = fleet.placement_tick([snap])
        return _tick_outcome(pkg, fleet, tmp_path, decisions, loads)
    finally:
        fleet.httpd.server_close()


@pytest.mark.parametrize("telemetry, status", [(False, 200), (True, 200), (True, 409),
                                               (True, None)])
def test_fleet_placement_tick_loads_and_appends_the_ledger_as_jax(tmp_path, telemetry, status):
    out = both(_placement_tick, tmp_path, telemetry, status)
    assert out["decisions"][0][:2] == ("beta", 1) and out["loads"] == [(1, "beta")]
    [line] = out["ledger"]
    assert line["model"] == "beta" and line["replica_id"] == 1 and line["reason"]
    assert line["status"] == status
    assert [e["event"] for e in out["events"]] == ["placement-move"]
    if telemetry:
        assert out["counter"] == 1 and out["instants"] == [{"model": "beta", "replica": 1}]


def _autoscale_ticks(pkg, tmp_path):
    """``autoscale_tick`` scrapes once and hands the snapshots to the
    placement half: three ticks over a breach that stands."""
    tmp_path = tmp_path / pkg.tag
    tmp_path.mkdir()
    pkg.res.drain_events()
    fleet = _fleet(pkg, tmp_path, telemetry=True, cooldown_s=2.5)
    try:
        loads, scaled = [], []
        _stub_router(fleet, loads)
        snap = {**_model_snap(400), "models": {"alpha": _model_snap(200, p99=0.005),
                                               "beta": _model_snap(200, p99=10.0)}}
        fleet.router.scrape_replica_metrics = lambda: [dict(snap, replica_id=0)]
        fleet.supervisor.scale_to = scaled.append
        desired = [fleet.autoscale_tick() for _ in range(3)]
        out = _tick_outcome(pkg, fleet, tmp_path, [], loads)
        out.update(desired=desired, scaled=scaled)
        return out
    finally:
        fleet.httpd.server_close()


def test_autoscale_tick_runs_placement_on_the_same_scrape_as_jax(tmp_path):
    out = both(_autoscale_ticks, tmp_path)
    # the first tick moves beta; the cooldown holds the rest
    assert out["loads"] == [(1, "beta")] and out["counter"] == 1


# ----------------------------------------------------------------------
# placement_tick through HTTP: probes learn the residency, a load is a POST
# ----------------------------------------------------------------------


class _ModelHost(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _reply(self, status, payload):
        body = json.dumps(payload).encode("utf8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        host = self.server.host
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", "default_model": "alpha",
                              "resident_models": {m: {"generation": None}
                                                  for m in host["resident"]}})
        elif self.path == "/metrics":
            self._reply(200, host["snapshot"])
        else:
            self._reply(404, {"error": "not_found"})

    def do_POST(self):  # noqa: N802
        host = self.server.host
        body = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
        host["posts"].append((self.path, body))
        if self.path == "/admin/models/load":
            host["resident"].append(body["model"])
            self._reply(200, {"model": body["model"], "resident": host["resident"]})
        else:
            self._reply(404, {"error": "not_found"})


def _over_http(pkg, tmp_path):
    tmp_path = tmp_path / pkg.tag
    tmp_path.mkdir()
    pkg.res.drain_events()
    hosts, servers = [], []
    for resident, p99 in ((["alpha", "beta"], 10.0), (["alpha"], None)):
        models = {"alpha": _model_snap(100, p99=0.005)}
        if p99 is not None:
            models["beta"] = _model_snap(100, p99=p99)
        host = {"resident": list(resident), "posts": [],
                "snapshot": {**_model_snap(200), "models": models}}
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _ModelHost)
        httpd.daemon_threads = True
        httpd.host = host
        threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()
        hosts.append(host)
        servers.append(httpd)
    fleet = _fleet(pkg, tmp_path, telemetry=True)
    try:
        handles = []
        for i, httpd in enumerate(servers):
            h = pkg.F.ReplicaHandle(i)
            h.set_address("127.0.0.1", httpd.server_address[1])
            handles.append(h)
        fleet.router.replicas = lambda: handles
        fleet.router.probe_once()
        before = fleet.router.placement()
        decisions = fleet.placement_tick()
        after_tick = fleet.router.placement()
        fleet.router.probe_once()
        out = _tick_outcome(pkg, fleet, tmp_path, decisions, [])
        out.update(before=before, after_tick=after_tick, after_probe=fleet.router.placement(),
                   posts=[h["posts"] for h in hosts])
        return out
    finally:
        fleet.httpd.server_close()
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()


def test_placement_tick_over_http_loads_onto_the_replica_without_the_model(tmp_path):
    out = both(_over_http, tmp_path)
    assert out["before"] == {0: ["alpha", "beta"], 1: ["alpha"]}
    assert out["posts"] == [[], [("/admin/models/load", {"model": "beta"})]]
    assert out["after_tick"] == out["after_probe"] == {0: ["alpha", "beta"],
                                                        1: ["alpha", "beta"]}
    assert out["ledger"][0]["status"] == 200


# ----------------------------------------------------------------------
# serve-fleet --autoscale --model-manifest: accepted, the policy built
# ----------------------------------------------------------------------


def _cli_fleet(pkg, tmp_path, monkeypatch, argv):
    built = []

    class Recorded(pkg.F.Fleet):
        def run(self, **kw):
            built.append(self)
            self.httpd.server_close()
            return 0

    monkeypatch.setattr(pkg.F, "Fleet", Recorded)
    rc = pkg.cli.main(["serve-fleet", "m", "--device", "cpu", "--port", "0", *argv])
    fleet = built[0]
    pol = fleet.placement_policy
    return rc, (pol.default_p99_target_ms, pol.breach_consecutive, pol.cooldown_s,
                pol.min_window_samples, sorted(pol.registry.names()))


def test_serve_fleet_autoscale_with_a_manifest_builds_the_placement_policy(tmp_path,
                                                                          monkeypatch):
    argv = ["--autoscale", "--model-manifest", str(write_manifest(tmp_path)),
            "--p99-target-ms", "250", "--up-consecutive", "2", "--cooldown-s", "5"]
    rc, policy = both(_cli_fleet, tmp_path, monkeypatch, argv)
    assert rc == 0 and policy == (250.0, 2, 5.0, 20, ["alpha", "beta"])
