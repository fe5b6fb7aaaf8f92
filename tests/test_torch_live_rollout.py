"""The port's live rollout (``serving/live/canary.py``, ``controller.py``,
the router's canary split and ``serve-fleet --watch``) held against the JAX
package's on the same inputs, on the CPU. Each scenario runs once with each
package's classes (fresh stub replicas and a generation written by JAX's
``TrainCheckpoint`` each time) and the two results must be equal: picks and
split counters, the guard's verdicts and decisions, the controller's admin
calls in order, phases, counters, rejected stamps, the handles' generations
and the event records; then the flags of both CLIs build the same fleet."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import spacy_ray_tpu.cli as j_cli
import spacy_ray_tpu.serving.fleet as j_fleet
import spacy_ray_tpu.serving.live as j_live
import spacy_ray_tpu.training.resilience as j_res
import spacy_ray_tpu_torch.__main__ as p_cli
import spacy_ray_tpu_torch.serving.fleet as p_fleet
import spacy_ray_tpu_torch.serving.live as p_live
import spacy_ray_tpu_torch.training.resilience as p_res
from spacy_ray_tpu.training.checkpoint import TrainCheckpoint as JCheckpoint

from test_torch_serving_fleet import norm

PKGS = {
    "jax": SimpleNamespace(F=j_fleet, live=j_live, res=j_res, cli=j_cli, tag="jax"),
    "port": SimpleNamespace(F=p_fleet, live=p_live, res=p_res, cli=p_cli, tag="port"),
}


def both(scenario, *args, **kwargs):
    """``scenario(pkg, ...)`` with each package; the results must be equal.
    Returns the port's."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def save_generation(path, stamp):
    """One generation as the JAX trainer writes it (the serving side reads
    the parameters only)."""
    JCheckpoint.save(path, params={"w": {"kernel": np.ones((2, 2), np.float32)}},
                     opt_state={"note": np.zeros(1, np.float32)}, step=stamp, epoch=0,
                     rng=np.zeros(2, np.uint32), best_score=0.0, best_step=0, keep=8)


# ----------------------------------------------------------------------
# The router's split by generation (JAX test_live.py:640-682)
# ----------------------------------------------------------------------


def _handles(pkg, gens):
    out = []
    for i, gen in enumerate(gens):
        h = pkg.F.ReplicaHandle(i)
        h.set_address("127.0.0.1", 9000 + i)
        h.ready = True
        h.generation = gen
        out.append(h)
    return out


def _counters(tel):
    c = tel.snapshot()["counters"]
    return c.get("routed_canary", 0), c.get("routed_baseline", 0)


def _exact_fraction(pkg):
    handles = _handles(pkg, [None, None, 40])
    tel = pkg.F.RouterTelemetry()
    router = pkg.F.Router(lambda: handles, telemetry=tel, canary_fraction=0.25)
    router.canary_generation = 40  # the controller declares the rollout
    picks = [router.pick().replica_id for _ in range(100)]
    return picks, _counters(tel)


def test_router_canary_split_is_the_exact_fraction_as_jax():
    picks, counters = both(_exact_fraction)
    assert picks.count(2) == 25 and counters == (25, 75)


def _only_during_rollout(pkg):
    handles = _handles(pkg, [None, 40, 40])  # replica 0 restarted on the disk model
    tel = pkg.F.RouterTelemetry()
    router = pkg.F.Router(lambda: handles, telemetry=tel, canary_fraction=0.25)
    handles[0].outstanding = 3
    picks = [router.pick().replica_id for _ in range(30)]
    before = _counters(tel)
    router.canary_generation = 40
    during = router.pick().replica_id
    router.canary_generation = None
    router.tel = tel2 = pkg.F.RouterTelemetry()
    after = [router.pick().replica_id for _ in range(10)]
    return picks, before, during, after, _counters(tel2)


def test_router_splits_only_during_a_declared_rollout_as_jax():
    picks, before, _, after, counters = both(_only_during_rollout)
    assert 0 not in picks and before == (0, 0) and counters == (0, 0)


def _least_outstanding_within_side(pkg):
    handles = _handles(pkg, [None, 40, 40])
    handles[1].outstanding = 5
    router = pkg.F.Router(lambda: handles, canary_fraction=1.0)  # always the canary
    router.canary_generation = 40
    return [router.pick().replica_id for _ in range(3)]


def test_router_split_prefers_least_outstanding_within_a_side_as_jax():
    assert both(_least_outstanding_within_side) == [2, 2, 2]


# ----------------------------------------------------------------------
# The guard (JAX test_live.py:702-779)
# ----------------------------------------------------------------------


def _stats(pkg, gen, requests, errors, p99=None, samples=0):
    return pkg.live.GenerationStats(generation=gen, requests=requests, errors=errors,
                                    window_samples=samples, p99_s=p99)


def _guard_run(pkg, kw, begin, ticks):
    """Verdicts of ``ticks`` ((baseline, canary) stat tuples) after
    ``begin``, the decisions and the events."""
    pkg.res.drain_events()
    g = pkg.live.CanaryGuard(**kw)
    g.begin(*(_stats(pkg, *s) for s in begin))
    verdicts = [g.observe(_stats(pkg, *b), _stats(pkg, *c)) for b, c in ticks]
    return verdicts, g.decisions, pkg.res.drain_events()


GUARD_CASES = {
    "promotes_after_clean_ticks_with_traffic": (
        dict(min_canary_requests=10, good_consecutive=2, bad_consecutive=2),
        ((None, 1000, 5, 0.02, 100), (40, 500, 3)),
        [((None, 1000, 5, 0.02, 100), (40, 505, 3)),
         ((None, 1100, 5, 0.02, 100), (40, 515, 3, 0.022, 30)),
         ((None, 1200, 5, 0.02, 100), (40, 530, 3, 0.021, 40))],
        [None, None, "promote"]),
    "rolls_back_on_error_rate": (
        dict(min_canary_requests=10, bad_consecutive=2, error_rate_high=0.05),
        ((None, 1000, 0), (40, 500, 100)),
        [((None, 1050, 0), (40, 540, 120)), ((None, 1100, 0), (40, 545, 125))],
        [None, "rollback"]),
    "rolls_back_on_p99_regression": (
        dict(min_canary_requests=5, bad_consecutive=2, p99_frac=1.5, min_window_samples=10),
        ((None, 0, 0), (40, 0, 0)),
        [((None, 500, 0, 0.01, 100), (40, 50, 0, 0.9, 30))] * 2,
        [None, "rollback"]),
    "silence_does_not_promote_against_a_live_baseline": (
        dict(min_canary_requests=10, good_consecutive=2, min_window_samples=20),
        ((None, 0, 0), (40, 0, 0)),
        [((None, 1000, 0, 0.02, 100), (40, 50, 0, 0.5, 3))] * 6,
        [None] * 6),
    "holds_without_comparable_signal": (
        dict(min_canary_requests=10, bad_consecutive=1, min_window_samples=20),
        ((None, 0, 0), (40, 0, 0)),
        [((None, 100, 0, 0.01, 5), (40, 50, 0, 0.9, 30)),
         ((None, 150, 0), (40, 80, 0)), ((None, 200, 0), (40, 110, 0))],
        [None, None, "promote"]),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_verdicts_and_decisions_match_jax(case):
    kw, begin, ticks, want = GUARD_CASES[case]
    verdicts, decisions, events = both(_guard_run, kw, begin, ticks)
    assert verdicts == want
    assert [d["verdict"] for d in decisions] == [v for v in want if v]
    assert [e["event"] for e in events] == [f"canary-{v}" for v in want if v]


def _timeouts_as_errors(pkg):
    pkg.res.drain_events()
    block = {"generation": 40, "counters": {"requests": 100.0, "errors": 0.0,
                                            "deadline_exceeded": 60.0},
             "slo_window": {"window_s": 30.0, "samples": 0}}
    stats = pkg.live.GenerationStats.from_merged(block)
    g = pkg.live.CanaryGuard(min_canary_requests=10, bad_consecutive=2)
    g.begin(_stats(pkg, None, 0, 0), pkg.live.GenerationStats(generation=40))
    base = _stats(pkg, None, 500, 0)
    return (vars(stats), vars(pkg.live.GenerationStats.from_merged(None, 7)),
            [g.observe(base, stats) for _ in range(2)], g.decisions)


def test_guard_counts_timeouts_as_errors_as_jax():
    stats, empty, verdicts, _ = both(_timeouts_as_errors)
    assert stats["errors"] == 60.0 and empty["generation"] == 7
    assert verdicts == [None, "rollback"]


@pytest.mark.parametrize("kw", [dict(p99_frac=0), dict(error_rate_high=1.5),
                                dict(bad_consecutive=0), dict(good_consecutive=0)])
def test_guard_refuses_bad_bounds_as_jax(kw):
    def refusal(pkg):
        with pytest.raises(ValueError) as e:
            pkg.live.CanaryGuard(**kw)
        return str(e.value)

    assert both(refusal)


# ----------------------------------------------------------------------
# The controller on stub replicas (JAX test_live.py:907-1025)
# ----------------------------------------------------------------------


class _StubReplica:
    """``/healthz`` and ``/metrics`` from mutable state; ``/admin/swap`` and
    ``/admin/rollback`` logged and flipping the generation (JAX's stub)."""

    def __init__(self):
        self.state = state = {"generation": None, "swap_count": 0, "requests": 0.0,
                              "errors": 0.0, "p99": 0.01, "samples": 50,
                              "refuse_swap": False, "admin_log": []}

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, status, payload):
                body = json.dumps(payload).encode("utf8")
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok", "generation": state["generation"],
                                      "swap_count": state["swap_count"]})
                    return
                self._reply(200, {
                    "generation": state["generation"], "swap_count": state["swap_count"],
                    "counters": {"requests": state["requests"], "errors": state["errors"]},
                    "histograms": {"request_latency_seconds": {"count": state["samples"]}},
                    "slo_window": {"window_s": 30.0, "samples": state["samples"],
                                   "request_latency_p99": state["p99"]}})

            def do_POST(self):  # noqa: N802
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length")
                                                      or 0)) or b"{}")
                state["admin_log"].append((self.path, body))
                if self.path == "/admin/swap":
                    if state["refuse_swap"]:
                        self._reply(409, {"error": "swap_failed", "message": "scripted refusal"})
                        return
                    state["prev"] = state["generation"]
                    state["generation"] = body.get("generation")
                    state["swap_count"] += 1
                    self._reply(200, {"generation": state["generation"],
                                      "swap_count": state["swap_count"]})
                elif self.path == "/admin/rollback":
                    state["generation"] = state.get("prev")
                    state["swap_count"] += 1
                    self._reply(200, {"generation": state["generation"]})
                else:
                    self._reply(404, {"error": "not_found"})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def port(self):
        return self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class StubFleet:
    """``n`` stub replicas, their handles and a router over them; ``ckpt``
    is a fresh checkpoint directory for the package's run."""

    def __init__(self, pkg, tmp_path, n=2, **router_kw):
        self.ckpt = tmp_path / pkg.tag
        self.ckpt.mkdir()
        self.stubs = [_StubReplica() for _ in range(n)]
        self.handles = []
        for i, s in enumerate(self.stubs):
            h = pkg.F.ReplicaHandle(i)
            h.set_address("127.0.0.1", s.port)
            h.ready = True
            self.handles.append(h)
        self.router = pkg.F.Router(lambda: self.handles, **router_kw)
        pkg.res.drain_events()

    def admin(self):
        """Each stub's admin calls, the checkpoint directory named <ckpt>."""
        return [[(path, {k: ("<ckpt>" if v == str(self.ckpt) else v) for k, v in body.items()})
                 for path, body in s.state["admin_log"]] for s in self.stubs]

    def gens(self):
        return [h.generation for h in self.handles]

    def close(self):
        for s in self.stubs:
            s.close()


def _ctl_state(ctl):
    return {"phase": ctl.phase, "current": ctl.current, "target": ctl.target,
            "canary_ids": list(ctl.canary_ids), "rejected": sorted(ctl.rejected),
            "rollouts": ctl.rollouts, "promotes": ctl.promotes, "rollbacks": ctl.rollbacks,
            "split": ctl.router.canary_generation}


def _events(pkg):
    return [{k: v for k, v in e.items()} for e in norm(pkg.res.drain_events())]


def _canary_then_promote(pkg, tmp_path):
    fleet = StubFleet(pkg, tmp_path, canary_fraction=0.5)
    try:
        save_generation(fleet.ckpt, 40)
        ctl = pkg.live.LiveFleetController(
            fleet.ckpt, fleet.router, canary_fraction=0.5,
            guard=pkg.live.CanaryGuard(min_canary_requests=10, good_consecutive=2,
                                       bad_consecutive=2), verdict_timeout_s=300.0)
        out = [(ctl.poll_once(), _ctl_state(ctl), fleet.admin(), fleet.gens())]
        for _ in range(2):  # healthy canary traffic on the stubs' counters
            fleet.stubs[1].state["requests"] += 20
            fleet.stubs[0].state["requests"] += 20
            out.append((ctl.poll_once(), _ctl_state(ctl), fleet.admin(), fleet.gens()))
        out.append(ctl.guard.decisions)
        out.append(_events(pkg))
        return out
    finally:
        fleet.close()


def test_controller_canary_then_promote_as_jax(tmp_path):
    out = both(_canary_then_promote, tmp_path)
    first, last = out[0], out[2]
    assert first[0] == "canary" and first[1]["canary_ids"] == [1] and first[1]["split"] == 40
    assert first[2] == [[], [("/admin/swap", {"dir": "<ckpt>", "generation": 40})]]
    assert first[3] == [None, 40]
    assert last[0] == "promote" and last[1]["phase"] == "idle" and last[1]["current"] == 40
    assert last[1]["split"] is None and last[3] == [40, 40]
    assert [e["event"] for e in out[4]] == ["live-canary-start", "canary-promote",
                                            "live-promote"]


def _forced_regression(pkg, tmp_path):
    fleet = StubFleet(pkg, tmp_path, canary_fraction=0.5)
    try:
        save_generation(fleet.ckpt, 50)
        ctl = pkg.live.LiveFleetController(
            fleet.ckpt, fleet.router, canary_fraction=0.5,
            guard=pkg.live.CanaryGuard(min_canary_requests=10, bad_consecutive=2,
                                       error_rate_high=0.05), verdict_timeout_s=300.0)
        out = [ctl.poll_once()]
        for _ in range(2):  # the new generation errs on half its traffic
            fleet.stubs[1].state["requests"] += 30
            fleet.stubs[1].state["errors"] += 15
            fleet.stubs[0].state["requests"] += 30
            out.append(ctl.poll_once())
        out += [_ctl_state(ctl), fleet.admin(), fleet.gens(), _events(pkg)]
        out.append((ctl.poll_once(), ctl.phase))  # the rejected stamp is not retried
        save_generation(fleet.ckpt, 60)
        out.append((ctl.poll_once(), ctl.target))  # a newer one is
        return out
    finally:
        fleet.close()


def test_controller_forced_regression_rolls_back_as_jax(tmp_path):
    out = both(_forced_regression, tmp_path)
    assert out[:3] == ["canary", None, "rollback"]
    state, admin, gens, events = out[3:7]
    assert state["rejected"] == [50] and state["rollbacks"] == 1 and state["split"] is None
    assert ("/admin/rollback", {}) in admin[1] and gens == [None, None]
    assert {"canary-rollback", "live-rollback"} <= {e["event"] for e in events}
    assert out[7] == (None, "idle") and out[8] == ("canary", 60)


def _canaries_leave(pkg, tmp_path):
    fleet = StubFleet(pkg, tmp_path, canary_fraction=0.5)
    try:
        save_generation(fleet.ckpt, 70)
        ctl = pkg.live.LiveFleetController(fleet.ckpt, fleet.router, canary_fraction=0.5,
                                           guard=pkg.live.CanaryGuard(min_canary_requests=10))
        out = [ctl.poll_once(), list(ctl.canary_ids)]
        fleet.handles[1].ready = False  # scaled down, or crashed
        pkg.res.drain_events()
        out += [ctl.poll_once(), _ctl_state(ctl), _events(pkg)]
        fleet.handles[1].ready = True
        out += [ctl.poll_once(), ctl.target, fleet.admin()]
        return out
    finally:
        fleet.close()


def test_controller_aborts_without_rejecting_when_the_canaries_leave_as_jax(tmp_path):
    out = both(_canaries_leave, tmp_path)
    assert out[:3] == ["canary", [1], None]
    assert out[3]["phase"] == "idle" and out[3]["rejected"] == [] and out[3]["split"] is None
    assert [e["event"] for e in out[4]] == ["live-canary-aborted"]
    assert out[5:7] == ["canary", 70]


def _direct_and_heal(pkg, tmp_path):
    fleet = StubFleet(pkg, tmp_path, n=1)
    try:
        save_generation(fleet.ckpt, 40)
        ctl = pkg.live.LiveFleetController(fleet.ckpt, fleet.router, canary_fraction=0.25)
        out = [ctl.poll_once(), _ctl_state(ctl)]
        fleet.stubs[0].state["generation"] = None  # restarted from the disk model
        fleet.handles[0].generation = None
        out += [ctl.poll_once(), fleet.gens(), ctl.poll_once(), fleet.admin(), _events(pkg)]
        return out
    finally:
        fleet.close()


def test_controller_direct_rollout_and_straggler_heal_as_jax(tmp_path):
    out = both(_direct_and_heal, tmp_path)
    assert out[0] == "promote" and out[1]["current"] == 40 and out[1]["phase"] == "idle"
    assert out[2:5] == ["heal", [40], None]
    assert [e["event"] for e in out[6]] == ["live-rollout-direct"]


def _refused(pkg, tmp_path):
    fleet = StubFleet(pkg, tmp_path, n=1)
    try:
        fleet.stubs[0].state["refuse_swap"] = True
        save_generation(fleet.ckpt, 40)
        ctl = pkg.live.LiveFleetController(fleet.ckpt, fleet.router, canary_fraction=0.0)
        return [ctl.poll_once(), sorted(ctl.rejected), ctl.poll_once(), fleet.admin(),
                _events(pkg)]
    finally:
        fleet.close()


def test_controller_rejects_a_stamp_on_409_as_jax(tmp_path):
    out = both(_refused, tmp_path)
    assert out[:3] == [None, [40], None] and len(out[3][0]) == 1  # not retried
    assert [e["event"] for e in out[4]] == ["live-swap-refused"]
    assert out[4][0]["status"] == 409 and "stamp rejected" in out[4][0]["message"]


def _timeout(pkg, tmp_path):
    """No verdict within the timeout: rolled back on the controller's clock."""
    fleet = StubFleet(pkg, tmp_path, canary_fraction=0.5)
    try:
        save_generation(fleet.ckpt, 40)
        clock = [0.0]
        ctl = pkg.live.LiveFleetController(
            fleet.ckpt, fleet.router, canary_fraction=0.5, verdict_timeout_s=5.0,
            guard=pkg.live.CanaryGuard(min_canary_requests=1000), clock=lambda: clock[0])
        out = [ctl.poll_once(), ctl.poll_once()]
        clock[0] = 5.0
        out += [ctl.poll_once(), _ctl_state(ctl), fleet.admin(), _events(pkg)]
        return out
    finally:
        fleet.close()


def test_controller_rolls_back_a_canary_without_a_verdict_as_jax(tmp_path):
    out = both(_timeout, tmp_path)
    assert out[:3] == ["canary", None, "rollback"] and out[3]["rejected"] == [40]
    assert "canary-verdict-timeout" in [e["event"] for e in out[5]]


# ----------------------------------------------------------------------
# train-and-serve's bootstrap copy of the run's first best-model
# ----------------------------------------------------------------------


def _best_model(out):
    best = out / "best-model"
    best.mkdir(parents=True)
    (best / "config.cfg").write_text("[nlp]\npipeline = []\n", encoding="utf8")
    (best / "meta.json").write_text("{}", encoding="utf8")
    np.savez(best / "params.npz", w=np.arange(6, dtype=np.float32))
    return best


def _bootstrap(pkg, tmp_path):
    out = tmp_path / pkg.tag
    best = _best_model(out)
    snap = pkg.live.wait_for_best_model(out, threading.Event(), timeout_s=5.0, settle_s=0.0,
                                        poll_s=0.01)
    return snap.relative_to(out), {f.name: f.read_bytes() == (best / f.name).read_bytes()
                                   for f in snap.iterdir()}


def test_the_bootstrap_copies_the_first_best_model_as_jax(tmp_path):
    snap, same = both(_bootstrap, tmp_path)
    assert str(snap) == "serve-bootstrap"
    assert same == {"config.cfg": True, "meta.json": True, "params.npz": True}


def test_a_bootstrap_copy_that_overlapped_a_rewrite_is_taken_again(tmp_path, monkeypatch):
    """The trainer rewrites best-model/ in place with plain writes: a copy
    that caught a half-written params file while the source changed is
    thrown away and copied again (JAX's keeps the first copy, ROADMAP
    C73); a source whose params never close as an archive is never
    served."""
    import shutil

    best = _best_model(tmp_path)
    copies, real = [], shutil.copytree

    def racing_copy(src, dst, **kw):
        real(src, dst, **kw)
        copies.append(dst)
        if len(copies) == 1:  # the rewrite lands during the first copy
            data = (best / "params.npz").read_bytes()
            (dst / "params.npz").write_bytes(data[: len(data) // 2])
            (best / "params.npz").write_bytes(data)
        return dst

    monkeypatch.setattr(shutil, "copytree", racing_copy)
    snap = p_live.wait_for_best_model(tmp_path, threading.Event(), timeout_s=5.0, settle_s=0.0,
                                      poll_s=0.01)
    assert len(copies) == 2
    assert (snap / "params.npz").read_bytes() == (best / "params.npz").read_bytes()
    monkeypatch.setattr(shutil, "copytree", real)
    torn = tmp_path / "torn"
    (_best_model(torn) / "params.npz").write_bytes(b"PK\x03\x04 half an archive")
    assert p_live.wait_for_best_model(torn, threading.Event(), timeout_s=0.3, settle_s=0.0,
                                      poll_s=0.01) is None


# ----------------------------------------------------------------------
# serve-fleet's rollout flags in both CLIs
# ----------------------------------------------------------------------


def _cli_fleet(pkg, monkeypatch, argv):
    built = []

    class Recorded(pkg.F.Fleet):
        def run(self, **kw):
            built.append(self)
            self.httpd.server_close()
            return 0

    monkeypatch.setattr(pkg.F, "Fleet", Recorded)
    rc = pkg.cli.main(["serve-fleet", "m", "--device", "cpu", "--port", "0", *argv])
    fleet = built[0]
    cfg, ctl = fleet.config, fleet.controller
    out = {"rc": rc, "router_fraction": fleet.router.canary_fraction,
           "config": {k: getattr(cfg, k) for k in (
               "watch_dir", "watch_interval_s", "canary_fraction", "guard_p99_frac",
               "guard_error_rate", "guard_min_samples", "guard_verdict_timeout_s")},
           "argv": fleet.config.build_cmd(0)[3:]}
    if ctl is not None:
        g = ctl.guard
        out["controller"] = (str(ctl.ckpt_dir), ctl.canary_fraction, ctl.interval_s,
                             ctl.verdict_timeout_s)
        out["guard"] = (g.p99_frac, g.error_rate_high, g.min_window_samples,
                        g.min_canary_requests, g.bad_consecutive, g.good_consecutive)
    return out


@pytest.mark.parametrize("argv", [
    [],
    ["--watch", "ckpt"],
    ["--watch", "ckpt", "--canary-fraction", "0.5", "--watch-interval-s", "0.5",
     "--guard-p99-frac", "3", "--guard-error-rate", "0.1", "--guard-min-samples", "10",
     "--guard-verdict-timeout-s", "30"],
])
def test_serve_fleet_rollout_flags_build_the_fleet_jax_builds(argv, monkeypatch):
    out = both(_cli_fleet, monkeypatch, argv)
    assert out["rc"] == 0
    if argv:
        assert "controller" in out and "--swap-dir" in out["argv"]
        assert out["router_fraction"] == out["config"]["canary_fraction"]
    else:
        assert "controller" not in out and out["router_fraction"] == 0.0


def test_the_controllers_admin_timeout_is_jaxs_default():
    import dataclasses
    import inspect

    from spacy_ray_tpu_torch.serving.fleet.fleet import (GUARD_BAD_CONSECUTIVE,
                                                         GUARD_GOOD_CONSECUTIVE)
    from spacy_ray_tpu_torch.serving.live.controller import ADMIN_TIMEOUT_S
    from spacy_ray_tpu_torch.serving.live.orchestrator import TRAIN_GRACE_S

    jax_ctl = inspect.signature(j_live.LiveFleetController).parameters
    jax_tns = inspect.signature(j_live.TrainAndServe).parameters
    assert ADMIN_TIMEOUT_S == jax_ctl["admin_timeout_s"].default == 120.0
    assert TRAIN_GRACE_S == jax_tns["train_grace_s"].default == 75.0
    jax_cfg = {f.name: f.default for f in dataclasses.fields(j_fleet.FleetConfig)}
    assert GUARD_BAD_CONSECUTIVE == jax_cfg["guard_bad_consecutive"] == 2
    assert GUARD_GOOD_CONSECUTIVE == jax_cfg["guard_good_consecutive"] == 3
