"""The port's trace collection (``serving/tracecollect.py``, ``telemetry
collect-trace``) held against the JAX package's, on the CPU: the merge of
fake clocks gives equal events; both collectors over one live port fleet
(a port server behind a port router) give the same merged structure; the
trainer fleet's endpoints and the command's argument errors are equal;
and the port's trainer-fleet workers' traces merge, a worker with its
telemetry off skipped as JAX skips an untraced endpoint."""

import json
import socket
import threading
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import spacy_ray_tpu.cli as j_cli
import spacy_ray_tpu.serving.tracecollect as j_tc
import spacy_ray_tpu.training.telemetry as j_tel
import spacy_ray_tpu_torch as P
import spacy_ray_tpu_torch.__main__ as p_cli
import spacy_ray_tpu_torch.serving.tracecollect as p_tc
import spacy_ray_tpu_torch.training.telemetry as p_tel
from spacy_ray_tpu_torch.util import synth_corpus

from test_torch_serving_fleet_cli import CFG, TEXTS

PKGS = {
    "jax": SimpleNamespace(tc=j_tc, tel=j_tel, cli=j_cli),
    "port": SimpleNamespace(tc=p_tc, tel=p_tel, cli=p_cli),
}


def both(scenario, *args, **kwargs):
    """``scenario(pkg, ...)`` with each package; the results must be equal.
    Returns the port's."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# ----------------------------------------------------------------------
# The merge under fake clocks (JAX test_observability.py:447-499)
# ----------------------------------------------------------------------


def _aligned(pkg):
    clock_a = [1000.0]
    buf_a = pkg.tel.TraceBuffer(clock=lambda: clock_a[0])
    clock_a[0] = 1000.010
    buf_a.add_span("route", clock_a[0], 0.005, cat="fleet", force=True)
    clock_b = [7.0]  # another origin; its span starts inside A's
    buf_b = pkg.tel.TraceBuffer(clock=lambda: clock_b[0])
    clock_b[0] = 7.012
    buf_b.add_span("request", clock_b[0], 0.002, cat="serve", force=True)
    return pkg.tc.merge_process_traces([
        {"name": "router", "trace": buf_a.payload(),
         "anchor": {"origin": 1000.0, "clock_now": 1000.020, "unix_now": 500.0}},
        {"name": "replica-0", "trace": buf_b.payload(),
         "anchor": {"origin": 7.0, "clock_now": 7.020, "unix_now": 500.0}},
        {"name": "lost", "trace": buf_b.payload(), "anchor": {"origin": "x"}},
    ])


def test_merge_process_traces_aligns_fake_clocks_as_jax():
    merged = both(_aligned)
    events = {e["name"]: e for e in merged["traceEvents"] if e.get("ph") == "X"}
    assert events["route"]["ts"] == 0.0
    assert events["request"]["ts"] == pytest.approx(2000.0, abs=1.0)
    assert events["route"]["pid"] == 0 and events["request"]["pid"] == 1
    assert merged["otherData"]["merged_from"] == ["router", "replica-0"]
    assert merged["otherData"]["skipped"] == ["lost"]


def _unanchored(pkg):
    buf = pkg.tel.TraceBuffer(clock=lambda: 3.0)
    buf.add_span("x", 3.0, 0.001, force=True)
    return pkg.tc.merge_process_traces([
        {"name": "anchored", "trace": buf.payload(),
         "anchor": {"origin": 3.0, "clock_now": 3.5, "unix_now": 9.0}},
        {"name": "lost", "trace": buf.payload(), "anchor": None},
        {"trace": {}, "anchor": {"origin": 0.0, "clock_now": 0.0, "unix_now": 0.0}},
    ])


def test_merge_skips_unanchored_processes_as_jax():
    merged = both(_unanchored)
    assert merged["otherData"]["merged_from"] == ["anchored", "process-1"]
    assert merged["otherData"]["skipped"] == ["lost"]


@pytest.mark.parametrize("anchor", [None, {}, {"origin": 1}, {"origin": "a", "clock_now": 1,
                                                               "unix_now": 2},
                                    {"origin": 1.0, "clock_now": 2.0, "unix_now": 10.0}])
def test_anchor_offsets_as_jax(anchor):
    both(lambda pkg: pkg.tc._anchor_offset_us(anchor))


# ----------------------------------------------------------------------
# Collection from live endpoints
# ----------------------------------------------------------------------


class _TraceHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):  # noqa: N802
        buf = self.server.buf
        if self.path == "/healthz":
            payload = {"status": "ok", "anchor": buf.anchor()}
        elif self.path == "/trace" and self.server.traced:
            payload = dict(buf.payload())
        else:
            payload = {"error": "not_found"}
        body = json.dumps(payload).encode("utf8")
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _serve(buf, traced=True):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _TraceHandler)
    httpd.daemon_threads = True
    httpd.buf, httpd.traced = buf, traced
    threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return httpd


def shape(merged, urls):
    """The merged trace without its clock readings: the sources, the
    skipped, and each process's event names and phases."""
    def plain(s):
        for i, url in enumerate(urls):
            s = s.replace(url, f"<url{i}>")
        return s

    per_pid = Counter((e["pid"], e.get("name"), e.get("ph")) for e in merged["traceEvents"]
                      if e.get("ph") != "M")
    names = sorted((e["pid"], plain(e["args"]["name"])) for e in merged["traceEvents"]
                   if e.get("name") == "process_name")
    other = merged["otherData"]
    return {"merged_from": [plain(n) for n in other["merged_from"]],
            "skipped": [plain(n) for n in other["skipped"]], "names": names,
            "events": sorted(per_pid.items()), "zero": min(
                (e["ts"] for e in merged["traceEvents"] if e.get("ph") != "M"), default=None)}


def test_collect_from_stub_endpoints_as_jax():
    bufs = [p_tel.TraceBuffer() for _ in range(3)]
    for i, buf in enumerate(bufs):
        buf.add_span(f"span-{i}", buf.now(), 0.001, force=True)
    servers = [_serve(bufs[0]), _serve(bufs[1]), _serve(bufs[2], traced=False)]
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    urls.append(f"http://127.0.0.1:{dead.getsockname()[1]}")  # nothing listens
    dead.close()
    try:
        got = both(lambda pkg: shape(pkg.tc.collect_fleet_traces(urls + urls[:1],
                                                                 timeout_s=5.0), urls))
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
    assert got["merged_from"] == ["replica <url0>", "replica <url1>"]
    assert got["skipped"] == ["<url3>", "replica <url2>"] and got["zero"] == 0.0


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracecollect")
    nlp = P.Pipeline.from_config(P.Config.from_str(CFG), device="cpu")
    nlp.initialize(lambda: synth_corpus(64, "tagger", seed=0), seed=0)
    nlp.to_disk(root / "model")
    return root / "model"


def test_collect_over_a_live_port_server_behind_a_port_router_as_jax(model_dir):
    """One port ``serve`` (in this process) behind a port router with its
    telemetry: a few requests through the router, then both collectors from
    the router's URL alone. Three processes' worth of sources: the router and
    its discovered replica, the replica's URL given twice dropped."""
    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.serving.fleet import (
        ReplicaHandle,
        Router,
        RouterHTTPServer,
        RouterTelemetry,
    )

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
    try:
        import urllib.request

        for i in range(3):
            req = urllib.request.Request(
                f"http://127.0.0.1:{rport}/v1/parse", data=json.dumps(
                    {"texts": TEXTS[i:i + 2]}).encode(), headers={"X-SRT-Request-Id": f"r{i}"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
        urls = [f"http://127.0.0.1:{rport}", f"http://127.0.0.1:{sport}"]
        got = both(lambda pkg: shape(pkg.tc.collect_fleet_traces(urls[:1]), urls))
        assert got["merged_from"] == ["router <url0>", "replica-0 <url1>"]
        assert got["skipped"] == [] and got["zero"] == 0.0
        events = dict(got["events"])
        assert events[(0, "route", "X")] == 3 and events[(1, "request", "X")] == 3
        # the replica listed again by URL is collected once
        again = both(lambda pkg: shape(pkg.tc.collect_fleet_traces(urls), urls))
        assert again["merged_from"] == got["merged_from"]
        out = p_tc.collect_fleet_traces(urls[:1])
        rids = {e["args"].get("request_id") for e in out["traceEvents"]
                if e.get("name") in ("route", "request")}
        assert {"r0", "r1", "r2"} <= rids  # one request's spans on both tracks
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.request_shutdown()
        assert server.wait() == 0


# ----------------------------------------------------------------------
# Trainer fleets, the command line (JAX test_fleet_obs.py:505-535)
# ----------------------------------------------------------------------


def _worker_urls(pkg):
    out = [pkg.tc.fleet_worker_urls(47200, 3), pkg.tc.fleet_worker_urls(9000, 1, "10.0.0.5")]
    for workers in (0, -1):
        with pytest.raises(ValueError) as e:
            pkg.tc.fleet_worker_urls(9000, workers)
        out.append(str(e.value))
    return out


def test_fleet_worker_urls_as_jax():
    out = both(_worker_urls)
    assert out[0] == ["http://127.0.0.1:47200", "http://127.0.0.1:47201",
                      "http://127.0.0.1:47202"]
    assert out[1] == ["http://10.0.0.5:9000"]


@pytest.mark.parametrize("argv, says", [
    ([], "give endpoint URLs"),
    (["--fleet-base-port", "47200"], "--fleet-base-port and --workers go together"),
    (["--workers", "2"], "--fleet-base-port and --workers go together"),
    (["--fleet-base-port", "47200", "--workers", "0"], "--workers must be positive"),
    (["http://127.0.0.1:1"], "the following arguments are required: --out"),
])
def test_collect_trace_argument_errors_exit_2_as_jax(argv, says, tmp_path, capsys):
    def run(pkg):
        out = [*argv] if "--out" in says else [*argv, "--out", str(tmp_path / "x")]
        with pytest.raises(SystemExit) as e:
            pkg.cli.main(["telemetry", "collect-trace", *out])
        return e.value.code, says in capsys.readouterr().err

    assert both(run) == (2, True)


def test_telemetry_subcommands_that_wait_exit_2_and_unknown_ones_print_usage(
        tmp_path, capsys):
    """``top`` and ``ledger`` are listed in the usage and run (0 with their
    arguments, argparse's 2 without); no subcommand or an unknown one prints
    the usage (1)."""
    from spacy_ray_tpu_torch.__main__ import main

    assert main(["telemetry"]) == 1 and main(["telemetry", "nope"]) == 1
    err = capsys.readouterr().err
    for sub in ("collect-trace", "summarize", "postmortem", "report", "top <url>",
                "ledger {list|show|diff|regress}"):
        assert sub in err
    session = tmp_path / "session.jsonl"
    session.write_text(json.dumps({"name": "x", "value": 1.0, "platform": "gpu"}) + "\n",
                       encoding="utf8")
    assert main(["telemetry", "ledger", "list", "--session", str(session)]) == 0
    assert capsys.readouterr().out.startswith("run ledger: 1 records, 1 keys")
    assert main(["telemetry", "top", "http://127.0.0.1:9", "--iterations", "1",
                 "--interval-s", "0"]) == 0
    for sub in ("top", "ledger"):
        with pytest.raises(SystemExit) as e:
            main(["telemetry", sub])
        assert e.value.code == 2
    assert "not part of the port yet" not in capsys.readouterr().err


def test_telemetry_summarize_is_ported(tmp_path, capsys):
    from spacy_ray_tpu_torch.__main__ import main

    path = tmp_path / "metrics.jsonl"
    path.write_text(json.dumps({"kind": "step", "step": 1, "step_seconds": 0.25,
                                "words": 10}) + "\n", encoding="utf8")
    assert main(["telemetry", "summarize", str(path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"telemetry summary: {path}") and "step-time p50 250.0ms" in out
    assert "not part of the port yet" not in capsys.readouterr().err


def test_collect_trace_skips_port_trainer_fleet_workers_as_jax_skips_untraced(tmp_path,
                                                                              capsys):
    """Three port peer servers (a trainer fleet's endpoints): workers 0 and
    1 run their telemetry and serve ``/trace`` with an anchor, worker 2's is
    off. Both CLIs' ``collect-trace --fleet-base-port B --workers 3`` merge
    the two traced workers' ``grad_apply`` spans onto two ``fleet-worker``
    tracks and skip worker 2 as untraced, with the same output."""
    from spacy_ray_tpu_torch.training.fleet import peer as ppeer

    base = _three_free_ports()
    servers = []
    try:
        for k in range(3):
            tel = (p_tel.Telemetry(tmp_path / f"fleet-worker-{k}", process_index=k,
                                   anomaly_detection=False, alerting=False)
                   if k < 2 else None)
            counters = ppeer.FleetCounters(registry=tel.registry if tel else None)
            owner = ppeer.OwnerState(
                worker_id=k, n_workers=3, quorum=1, max_staleness=1,
                apply_fn=lambda p, s, g: ({"x": p["x"] + g["x"]}, s),
                slice_params={"x": np.zeros(2, np.float32)}, opt_state={}, counters=counters,
                registry=tel.registry if tel else None, trace=tel.trace if tel else None)
            owner.submit((k + 1) % 3, 0, {"x": np.ones(2, np.float32)})
            srv = ppeer.PeerServer(owner, worker_id=k, layout_signature="sig",
                                   counters=counters, tel=tel, port=base + k)
            srv.start()
            servers.append((srv, tel))

        def run(pkg):
            out = tmp_path / f"{id(pkg)}.json"
            rc = pkg.cli.main(["telemetry", "collect-trace", "--fleet-base-port", str(base),
                               "--workers", "3", "--out", str(out)])
            said = capsys.readouterr().out.replace(str(out), "<out>")
            for k in range(3):
                said = said.replace(str(base + k), f"<b{k}>")
            merged = json.loads(out.read_text())
            tracks = sorted(e["args"]["name"].replace(str(base), "<b0>").replace(
                str(base + 1), "<b1>") for e in merged["traceEvents"]
                if e.get("name") == "process_name")
            spans = sorted(e["name"] for e in merged["traceEvents"] if e.get("ph") == "X")
            return rc, said, tracks, spans

        rc, said, tracks, spans = both(run)
        assert rc == 0 and said.startswith("merged 2 event(s) from 2 process(es) into <out>")
        assert "(skipped: ['fleet-worker http://127.0.0.1:<b2>'])" in said
        assert tracks == ["fleet-worker http://127.0.0.1:<b0>",
                          "fleet-worker http://127.0.0.1:<b1>"]
        assert spans == ["grad_apply", "grad_apply"]
    finally:
        for srv, tel in servers:
            srv.stop()
            if tel is not None:
                tel.finalize()


def _three_free_ports():
    for _ in range(50):
        socks = []
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
            socks.append(s)
            for k in (1, 2):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no three consecutive free ports")


def test_collect_trace_writes_the_merged_file(tmp_path, capsys):
    buf = p_tel.TraceBuffer()
    buf.add_span("only", buf.now(), 0.001, force=True)
    httpd = _serve(buf)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        rc = p_cli.main(["telemetry", "collect-trace", url, "--out",
                         str(tmp_path / "sub" / "t.json")])
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert rc == 0
    assert capsys.readouterr().out.startswith("merged 1 event(s) from 1 process(es) into ")
    merged = json.loads((tmp_path / "sub" / "t.json").read_text())
    assert merged["traceEvents"][0]["name"] == "process_name"
    assert [e["name"] for e in merged["traceEvents"] if e["ph"] != "M"] == ["only"]
