"""The port's ``telemetry top`` (``spacy_ray_tpu_torch/top.py``) held against
the JAX package's (``spacy_ray_tpu/top.py``) on the CPU.

The cases of JAX's ``tests/test_observability.py`` and
``tests/test_fleet_obs.py`` run once with each package on the same payloads
and fake clocks: the rows (rates from counter deltas, the process columns,
the fleet worker's apply-wait share and staleness, the scrape-failure
streak) and the rendered screens must be equal, and ``run_top`` survives a
fetch that raises in both. Then the payloads of the port's own endpoints (a
``serve`` in this process, a router over it, a trainer's telemetry endpoint
and a trainer-fleet worker's peer server) classify and render as JAX's do,
and both ``telemetry top`` commands print the same screens over them.
"""

import functools
import io
import json
import re
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import spacy_ray_tpu.cli as j_cli
import spacy_ray_tpu.serving.tracecollect as j_tc
import spacy_ray_tpu.top as j_top
import spacy_ray_tpu_torch as P
import spacy_ray_tpu_torch.__main__ as p_cli
import spacy_ray_tpu_torch.serving.tracecollect as p_tc
import spacy_ray_tpu_torch.top as p_top
import spacy_ray_tpu_torch.training.telemetry as p_tel
import spacy_ray_tpu_torch.training.telemetry_http as p_http
from spacy_ray_tpu_torch.util import synth_corpus

from test_torch_serving_fleet_cli import CFG, TEXTS

PKGS = {
    "jax": SimpleNamespace(name="jax", top=j_top, tc=j_tc, cli=j_cli),
    "port": SimpleNamespace(name="port", top=p_top, tc=p_tc, cli=p_cli),
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
        self.t += 1.0
        return self.t


def _router_payload(requests, ready=2):
    return {
        "fleet": {
            "replicas": ready,
            "counters": {"requests": requests, "deadline_exceeded": 0},
            "gauges": {"queue_depth": {"sum": 5, "max": 3, "mean": 2.5}},
            "histograms": {"batch_occupancy": {"p50": 4}},
            "slo_window": {"request_latency_p50": 0.012, "request_latency_p99": 0.080,
                           "request_latency_p99_worst": 0.110},
        },
        "router": {"counters": {"requests": requests, "rejected_no_replica": 0,
                                "rejected_draining": 0}},
        "replicas": [{"id": 0, "ready": True, "generation": 7, "swap_count": 2},
                     {"id": 1, "ready": True, "generation": 7, "swap_count": 2}],
        "scrape_failures": {"1": 3},
    }


def _fleet_payload(steps, pushed, received, discarded, wait_sum, grad_sum, stale_max=1):
    return {
        "counters": {"steps": steps, "words": steps * 100, "grad_pushed": pushed,
                     "grad_received": received, "grad_discarded": discarded},
        "gauges": {"fleet_worker": 1, "param_version": steps},
        "histograms": {
            "step_seconds": {"p50": 0.01, "p95": 0.02},
            "staleness": {"count": received, "max": stale_max},
            "phase_grad_seconds": {"count": steps, "sum": grad_sum},
            "phase_apply_wait_seconds": {"count": steps, "sum": wait_sum},
        },
    }


# ----------------------------------------------------------------------
# JAX's cases (test_observability.py:687-800, test_fleet_obs.py:639-690)
# ----------------------------------------------------------------------


def test_router_rates_come_from_counter_deltas_as_jax():
    def run(pkg):
        model = pkg.top.TopModel()
        first = model.update("http://r", _router_payload(100), now=10.0)
        row = model.update("http://r", _router_payload(150), now=20.0)
        return first, row, pkg.top.render([row], now_label="12:00:00")

    first, row, screen = both(run)
    assert first["kind"] == "router" and first["req_s"] is None  # the first poll
    assert row["req_s"] == pytest.approx(5.0)  # (150 - 100) / 10 s
    assert row["p99"] == 0.080 and row["ready"] == 2 and row["scrape_failures"] == 3
    assert row["generations"] == ["7"] and row["swaps"] == 4
    assert "80.0ms" in screen and "5.0/s" in screen and "gen [7]" in screen


def test_serving_and_trainer_rows_as_jax():
    serving = {"counters": {"requests": 10, "slow_exemplars": 1},
               "gauges": {"queue_depth": 2, "last_batch_occupancy": 3}, "histograms": {},
               "slo_window": {"request_latency_p50": 0.004, "request_latency_p99": 0.020},
               "generation": 5, "swap_count": 1}
    trainer = {"counters": {"steps": 40, "words": 80_000, "anomalies": 2},
               "gauges": {"compile_count": 12},
               "histograms": {"step_seconds": {"p50": 0.5, "p95": 0.9}}}

    def run(pkg):
        model = pkg.top.TopModel()
        model.update("s", serving, now=0.0)
        model.update("t", trainer, now=0.0)
        srow = model.update("s", {**serving, "counters": {"requests": 30, "slow_exemplars": 1}},
                            now=10.0)
        trow = model.update("t", {**trainer, "counters": {"steps": 60, "words": 120_000,
                                                          "anomalies": 2}}, now=10.0)
        kinds = [pkg.top.classify_payload(p) for p in (serving, trainer)]
        return kinds, srow, trow, pkg.top.render([srow, trow, {"url": "x", "kind": "down"}])

    kinds, srow, trow, screen = both(run)
    assert kinds == ["serving", "trainer"]
    assert srow["req_s"] == pytest.approx(2.0) and srow["generation"] == 5
    assert trow["steps_s"] == pytest.approx(2.0) and trow["words_s"] == pytest.approx(4000.0)
    assert "replica s" in screen and "trainer t" in screen and "UNREACHABLE" in screen
    assert "anomalies 2" in screen


def test_process_columns_of_every_row_kind_as_jax():
    proc = {"cpu_percent": 37.2, "rss_bytes": 512 * 1024 * 1024, "open_fds": 23}
    serving = {"counters": {"requests": 10}, "gauges": {"queue_depth": 0}, "histograms": {},
               "slo_window": {"request_latency_p99": 0.020}, "generation": 1,
               "swap_count": 0, "process": proc}
    trainer = {"counters": {"steps": 40, "words": 80_000}, "gauges": {}, "histograms": {},
               "process": proc}
    router = dict(_router_payload(100))
    router["process"] = {"cpu_percent": 3.0, "rss_bytes": 3 * (1 << 30), "open_fds": 99}

    def run(pkg):
        model = pkg.top.TopModel()
        rows = [model.update(u, p, now=0.0) for u, p in (("s", serving), ("t", trainer),
                                                           ("r", router))]
        bare = model.update("s2", {k: v for k, v in serving.items() if k != "process"},
                            now=0.0)
        return rows, bare, pkg.top.render(rows), pkg.top.render([bare])

    (srow, trow, rrow), bare, screen, bare_screen = both(run)
    assert srow["cpu_pct"] == pytest.approx(37.2) and trow["fds"] == 23
    assert rrow["rss"] == 3 * (1 << 30)
    assert screen.count("cpu 37%  rss 512MB  fd 23") == 2
    assert "cpu 3%  rss 3.00GB  fd 99" in screen
    assert bare["cpu_pct"] is None and "cpu -  rss -  fd -" in bare_screen


def test_run_top_rates_on_the_second_screen_as_jax():
    def run(pkg):
        payloads = iter([_router_payload(0), _router_payload(40)])
        clock = iter([0.0, 2.0])
        out = io.StringIO()
        rc = pkg.top.run_top(["http://r"], interval_s=0.0, iterations=2, out=out,
                             fetch=lambda url, timeout_s: next(payloads),
                             clock=lambda: next(clock), sleep=lambda s: None)
        return rc, _screens(out.getvalue())

    rc, screens = both(run)
    assert rc == 0 and len(screens) == 2 and "20.0/s" in screens[1]  # (40 - 0) / 2 s


def test_fleet_worker_apply_wait_and_staleness_columns_as_jax():
    def run(pkg):
        model = pkg.top.TopModel()
        model.update("http://t:1", _fleet_payload(100, 200, 200, 0, 10.0, 30.0), now=100.0)
        row = model.update("http://t:1", _fleet_payload(110, 220, 220, 5, 12.0, 36.0),
                           now=110.0)
        return row, pkg.top.render([row])

    row, text = both(run)
    # over 10 s: apply wait 2.0 s, grad 6.0 s -> a 25% wait share
    assert row["apply_wait_pct"] == pytest.approx(0.25) and row["staleness_max"] == 1
    assert "wait 25%" in text and "stale-max 1" in text


def test_scrape_failures_are_counted_and_a_raising_fetch_is_survived_as_jax():
    def run(pkg):
        model = pkg.top.TopModel()
        model.update("http://t:1", None, now=1.0)
        down = model.update("http://t:1", None, now=2.0)
        model.update("http://t:1", _fleet_payload(1, 1, 1, 0, 0.1, 0.1), now=3.0)
        again = model.update("http://t:1", None, now=4.0)

        def bomb_fetch(url, timeout_s):
            raise RuntimeError("connection torn mid-poll")

        out = io.StringIO()
        rc = pkg.top.run_top(["http://t:1"], iterations=2, interval_s=0.0, out=out,
                             fetch=bomb_fetch, clock=FakeClock(), sleep=lambda s: None)
        return down, pkg.top.render([down]), again["failures"], rc, _screens(out.getvalue())

    down, text, streak, rc, screens = both(run)
    assert down == {"url": "http://t:1", "kind": "down", "failures": 2}
    assert "UNREACHABLE (2 failed scrape(s))" in text
    assert streak == 1  # a recovered endpoint restarts the streak
    assert rc == 0 and all("UNREACHABLE" in s for s in screens)


_LABEL = re.compile(r"^(srt telemetry top)  \d\d:\d\d:\d\d$", re.M)


def _screens(text):
    """The refreshes of a ``run_top`` output, their wall-clock label cut."""
    return [_LABEL.sub(r"\1", s) for s in text.split(p_top.CLEAR) if s]


# ----------------------------------------------------------------------
# The port's own endpoints
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("top_model")
    nlp = P.Pipeline.from_config(P.Config.from_str(CFG), device="cpu")
    nlp.initialize(lambda: synth_corpus(64, "tagger", seed=0), seed=0)
    nlp.to_disk(root / "model")
    return root / "model"


@pytest.fixture
def endpoints(model_dir, tmp_path):
    """A port ``serve`` (telemetry and alerts on) behind a port router, a
    trainer's telemetry endpoint after four steps, and a trainer-fleet
    worker's peer server: their base URLs by kind, after a few requests."""
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.serving.fleet import (
        ReplicaHandle,
        Router,
        RouterHTTPServer,
        RouterTelemetry,
    )
    from spacy_ray_tpu_torch.training.fleet import peer as ppeer

    server = build_server([str(model_dir), "--device", "cpu", "--port", "0", "--max-batch",
                           "4", "--max-doc-len", "32", "--no-warmup"])
    _, sport = server.start()
    server.engine.start(warmup=False)
    handle = ReplicaHandle(0)
    handle.set_address("127.0.0.1", sport)
    router = Router(lambda: [handle], telemetry=RouterTelemetry())
    router.probe_once()
    httpd = RouterHTTPServer(("127.0.0.1", 0), router)
    threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    rport = httpd.server_address[1]
    trainer = p_tel.Telemetry(tmp_path / "trainer", anomaly_detection=False)
    trainer.loop_start()
    for step in range(1, 5):
        trainer.step_boundary(step=step, epoch=0, n_words=60, steps_run=step)
    tsrv = p_http.TelemetryHTTPServer(trainer, port=0)
    _, tport = tsrv.start()
    wtel = p_tel.Telemetry(tmp_path / "fleet-worker-1", process_index=1,
                           anomaly_detection=False, alerting=False)
    wtel.registry.gauge("fleet_worker").set(1)  # as train_fleet_worker sets it
    counters = ppeer.FleetCounters(registry=wtel.registry)
    owner = ppeer.OwnerState(
        worker_id=1, n_workers=2, quorum=1, max_staleness=1,
        apply_fn=lambda p, s, g: ({"x": p["x"] + g["x"]}, s),
        slice_params={"x": np.zeros(2, np.float32)}, opt_state={}, counters=counters,
        registry=wtel.registry, trace=wtel.trace)
    owner.submit(0, 0, {"x": np.ones(2, np.float32)})
    wsrv = ppeer.PeerServer(owner, worker_id=1, layout_signature="sig", counters=counters,
                            tel=wtel, port=0)
    wsrv.start()
    try:
        for i in range(3):
            req = urllib.request.Request(f"http://127.0.0.1:{rport}/v1/parse",
                                         data=json.dumps({"texts": TEXTS[i:i + 2]}).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
        yield {"router": f"http://127.0.0.1:{rport}", "replica": f"http://127.0.0.1:{sport}",
               "trainer": f"http://127.0.0.1:{tport}",
               "worker": f"http://127.0.0.1:{wsrv.address[1]}"}
    finally:
        wsrv.stop()
        wtel.finalize()
        tsrv.stop()
        trainer.finalize()
        httpd.shutdown()
        httpd.server_close()
        server.request_shutdown()
        assert server.wait() == 0


def test_the_ports_endpoints_classify_and_render_as_jax(endpoints):
    payloads = {kind: p_tc.fetch_json(url, "/metrics")[1] for kind, url in endpoints.items()}

    def run(pkg):
        model = pkg.top.TopModel()
        rows = [model.update(endpoints[k], payloads[k], now=5.0) for k in payloads]
        return ({k: pkg.top.classify_payload(p) for k, p in payloads.items()},
                pkg.top.render(rows))

    kinds, screen = both(run)
    assert kinds == {"router": "router", "replica": "serving", "trainer": "trainer",
                     "worker": "trainer"}
    assert f"router  {endpoints['router']}  ready 1/1" in screen
    assert f"replica {endpoints['replica']}" in screen
    assert f"trainer {endpoints['trainer']}" in screen
    assert f"trainer {endpoints['worker']}  [fleet worker 1]" in screen
    assert "scrape-fail 0" in screen and "UNREACHABLE" not in screen
    assert "alerts ok" in screen  # the replica's and the trainer's engines, nothing firing


def test_both_top_commands_print_the_same_screens_over_the_ports_endpoints(
        endpoints, monkeypatch):
    """Each endpoint scraped once and the same payload handed to both
    commands (the process columns move between scrapes): two refreshes,
    one row a URL, no scrape failure, and equal screens. (``run_top``'s
    stream is its import's ``sys.stdout``: each command's goes to a buffer.)"""
    urls = list(endpoints.values())
    seen, fetch = {}, p_tc.fetch_json

    def fetch_once(base_url, path, timeout_s=10.0):
        if base_url not in seen:
            seen[base_url] = fetch(base_url, path, timeout_s)
        return seen[base_url]

    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.tc, "fetch_json", fetch_once)

    def run(pkg):
        out = io.StringIO()
        monkeypatch.setattr(pkg.top, "run_top", functools.partial(pkg.top.run_top, out=out))
        rc = pkg.cli.main(["telemetry", "top", *urls, "--iterations", "2",
                           "--interval-s", "0"])
        return rc, _screens(out.getvalue())

    rc, screens = both(run)
    assert rc == 0 and len(screens) == 2
    for screen in screens:
        assert all(screen.count(f" {u}") == 1 for u in urls)
        assert "UNREACHABLE" not in screen


def test_top_needs_a_url_in_both_commands(capsys):
    def run(pkg):
        with pytest.raises(SystemExit) as e:
            pkg.cli.main(["telemetry", "top"])
        return e.value.code, "the following arguments are required: URL" in \
            capsys.readouterr().err

    assert both(run) == (2, True)
