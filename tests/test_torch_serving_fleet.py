"""The port's serving fleet (``spacy_ray_tpu_torch/serving/fleet/``) held
against the JAX package's on the same inputs, on the CPU.

Every scenario runs once with each package's classes, on fresh stub
replicas (the ``serve`` HTTP surface without an engine), the same scripts
and the same fake clocks, and the two results must be equal: picks,
statuses, payload bytes, ETags, cache and telemetry counters, Prometheus
text (the process sampler and the router's clock faked in both), merged
snapshots, autoscaler decisions and their event records, supervisor
restarts. No model and no ``serve`` process: the supervisor runs tiny
Python scripts that print the banner and exit on cue.
"""

import http.client
import json
import re
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

import spacy_ray_tpu.serving.batcher as j_batcher
import spacy_ray_tpu.serving.fleet as j_fleet
import spacy_ray_tpu.serving.fleet.autoscaler as j_autoscaler
import spacy_ray_tpu.serving.fleet.replica as j_replica
import spacy_ray_tpu.serving.fleet.router as j_router
import spacy_ray_tpu.training.hoststats as j_host
import spacy_ray_tpu.training.resilience as j_res
import spacy_ray_tpu.training.telemetry as j_tel
import spacy_ray_tpu_torch.serving.batcher as p_batcher
import spacy_ray_tpu_torch.serving.fleet as p_fleet
import spacy_ray_tpu_torch.serving.fleet.autoscaler as p_autoscaler
import spacy_ray_tpu_torch.serving.fleet.replica as p_replica
import spacy_ray_tpu_torch.serving.fleet.router as p_router
import spacy_ray_tpu_torch.training.batcher as p_train_batcher
import spacy_ray_tpu_torch.training.hoststats as p_host
import spacy_ray_tpu_torch.training.resilience as p_res
import spacy_ray_tpu_torch.training.telemetry as p_tel

PKGS = {
    "jax": SimpleNamespace(F=j_fleet, router=j_router, res=j_res, tel=j_tel, host=j_host,
                           batcher=j_batcher, autoscaler=j_autoscaler, replica=j_replica),
    "port": SimpleNamespace(F=p_fleet, router=p_router, res=p_res, tel=p_tel, host=p_host,
                            batcher=p_batcher, autoscaler=p_autoscaler, replica=p_replica),
}

#: JAX's keyword arguments that the port reads as module constants (no
#: caller of the port sets them): keyword -> (module, constant)
PORT_CONSTANTS = {
    "queue_high": ("autoscaler", "QUEUE_HIGH"),
    "max_restarts_per_replica": ("replica", "MAX_RESTARTS_PER_REPLICA"),
    "monitor_poll_s": ("replica", "MONITOR_POLL_S"),
    "grace_s": ("replica", "REPLICA_STOP_GRACE_S"),
}


def settle(pkg, kw, monkeypatch):
    """``kw`` for JAX as they are; for the port, the keywords of
    :data:`PORT_CONSTANTS` set as its module constants (undone at the test's
    end) and the rest returned."""
    if pkg is PKGS["jax"]:
        return dict(kw)
    rest = {}
    for key, value in kw.items():
        if key in PORT_CONSTANTS:
            module, name = PORT_CONSTANTS[key]
            monkeypatch.setattr(getattr(pkg, module), name, value)
        else:
            rest[key] = value
    return rest


def both(scenario, *args, **kwargs):
    """``scenario(pkg, ...)`` with each package; the results must be equal.
    Returns the port's."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


_ADDR = re.compile(r"127\.0\.0\.1:\d+|'127\.0\.0\.1', \d+")


def norm(obj):
    """``obj`` with every loopback address and port replaced (the stubs of
    the two runs listen on different ports)."""
    if isinstance(obj, str):
        return _ADDR.sub("<addr>", obj)
    if isinstance(obj, dict):
        return {k: (None if k == "port" else norm(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(norm(v) for v in obj)
    return obj


def events(pkg):
    """The package's kept event records, cleared, addresses normalised."""
    return norm(pkg.res.drain_events())


# ----------------------------------------------------------------------
# Stub replicas: the serve HTTP surface without an engine (JAX's pattern)
# ----------------------------------------------------------------------


class _StubServer(ThreadingHTTPServer):
    daemon_threads = True


class _StubHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        pass

    def _reply(self, status, payload, etag=None):
        body = json.dumps(payload).encode("utf8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        if etag:
            self.send_header("ETag", etag)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        stub = self.server.stub
        if self.path == "/healthz":
            if stub.warming:
                self._reply(503, {"status": "warming"})
            else:
                payload = {"status": "ok", "swap_count": stub.swap_count}
                if stub.generation is not None:
                    payload["generation"] = stub.generation
                if stub.resident is not None:
                    payload["resident_models"] = stub.resident
                    payload["default_model"] = "a"
                self._reply(200, payload)
        elif self.path == "/metrics":
            self._reply(200, stub.snapshot)
        elif self.path == "/admin/exemplars":
            self._reply(200, {"exemplars": [{"stub": stub.tag}]})
        else:
            self._reply(404, {"error": "not_found"})

    def do_POST(self):  # noqa: N802
        stub = self.server.stub
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length)
        with stub.lock:
            stub.parse_calls += 1
            stub.seen.append((self.path, self.headers.get("X-SRT-Tenant"),
                              self.headers.get("If-None-Match"), body))
        if stub.draining:
            self._reply(503, {"error": "draining", "message": "draining; not admitting"})
            return
        if stub.status != 200:
            self._reply(stub.status, {"error": "queue_full", "message": "stub"})
            return
        if stub.etag is not None:
            inm = self.headers.get("If-None-Match")
            if inm is not None and inm in (stub.etag, "*"):
                self.send_response(304)
                self.send_header("ETag", stub.etag)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
        if stub.latency_s:
            time.sleep(stub.latency_s)
        batch = {"occupancy": 1}
        if stub.generation is not None:
            batch["generation"] = stub.generation
        self._reply(200, {"docs": [{"stub": stub.tag, "gen": stub.generation}],
                          "batch": batch}, etag=stub.etag)


class StubReplica:
    """One fake replica; its behaviour changes mid-test (``warming`` flips
    readiness, ``close()`` is a crash)."""

    def __init__(self, *, warming=False, latency_s=0.0, snapshot=None, tag="stub",
                 generation=None, etag=None, resident=None, status=200):
        self.warming = warming
        self.draining = False
        self.latency_s = latency_s
        self.generation = generation
        self.etag = etag
        self.resident = resident
        self.status = status
        self.swap_count = 0
        self.snapshot = snapshot or {"counters": {}, "gauges": {}, "histograms": {}, "slo": {}}
        self.tag = tag
        self.parse_calls = 0
        self.seen = []
        self.lock = threading.Lock()
        self.httpd = _StubServer(("127.0.0.1", 0), _StubHandler)
        self.httpd.stub = self
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def make_handle(pkg, replica_id, stub, *, ready=True):
    h = pkg.F.ReplicaHandle(replica_id)
    h.set_address("127.0.0.1", stub.port)
    h.ready = ready
    return h


def post(port, payload, headers=None, path="/v1/parse", timeout=30.0):
    """(status, body bytes, headers without the per-request id)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        conn.request("POST", path, json.dumps(payload).encode("utf8"), hdrs)
        resp = conn.getresponse()
        got = {k: v for k, v in resp.getheaders() if k not in ("Date", "Server")}
        if "X-SRT-Request-Id" not in (headers or {}):
            got.pop("X-SRT-Request-Id", None)
        return resp.status, resp.read(), got
    finally:
        conn.close()


def get(port, path, timeout=10.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class Served:
    """A RouterHTTPServer on an ephemeral port, closed with its stubs."""

    def __init__(self, pkg, router, stubs=()):
        self.httpd = pkg.F.RouterHTTPServer(("127.0.0.1", 0), router)
        self.port = self.httpd.server_address[1]
        self.stubs = list(stubs)
        threading.Thread(target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        for s in self.stubs:
            try:
                s.close()
            except OSError:
                pass


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class FakeTime:
    """The router module's ``time``: ``perf_counter`` steps 1 ms a call;
    the rest is the real module's."""

    def __init__(self):
        self._t = 50.0
        self._lock = threading.Lock()

    def perf_counter(self):
        with self._lock:
            self._t += 0.001
            return self._t

    def __getattr__(self, name):
        return getattr(time, name)


PROCESS_SAMPLE = {"rss_bytes": 1.0e8, "cpu_seconds": 2.5, "threads": 7, "open_fds": 12}


@pytest.fixture
def fake_host(monkeypatch):
    """The router's host sampler and clock faked in both packages."""
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.host.ProcessSampler, "sample",
                            lambda self, force=False: dict(PROCESS_SAMPLE))
        monkeypatch.setattr(pkg.router, "time", FakeTime())


def tel_counters(tel):
    return tel.snapshot()["counters"]


# ----------------------------------------------------------------------
# Picks, probes, retries, the typed 503
# ----------------------------------------------------------------------


def _pick_scenario(pkg):
    stubs = [StubReplica(tag=f"s{i}") for i in range(3)]
    handles = [make_handle(pkg, i, s) for i, s in enumerate(stubs)]
    for h, n in zip(handles, (2, 0, 1)):
        h.outstanding = n
    router = pkg.F.Router(lambda: handles)
    picks = [router.pick().replica_id]
    handles[1].ready = False
    picks.append(router.pick().replica_id)
    handles[2].outstanding = 2  # a tie with replica 0: the lowest id wins
    picks.append(router.pick().replica_id)
    for s in stubs:
        s.close()
    return picks


def test_pick_least_outstanding_with_lowest_id_ties():
    assert both(_pick_scenario) == [1, 2, 0]


def _no_replica_scenario(pkg):
    stub = StubReplica(warming=True)
    handle = make_handle(pkg, 0, stub, ready=False)
    router = pkg.F.Router(lambda: [handle], telemetry=pkg.F.RouterTelemetry(clock=FakeClock()))
    with pytest.raises(pkg.F.NoReplicaAvailable) as err:
        router.pick()
    with Served(pkg, router, [stub]) as srv:
        status, body, headers = post(srv.port, {"texts": ["x"]})
        hstatus, health = get(srv.port, "/healthz")
    health = json.loads(health)
    health.pop("anchor")
    return {"raised": (err.value.http_status, err.value.code, str(err.value)),
            "post": (status, json.loads(body), headers), "healthz": (hstatus, norm(health)),
            "counters": tel_counters(router.tel), "events": events(pkg)}


def test_no_ready_replica_is_a_typed_503():
    out = both(_no_replica_scenario)
    assert out["post"][0] == 503 and out["post"][1]["error"] == "no_replica"
    assert out["healthz"][0] == 503 and out["healthz"][1]["status"] == "unavailable"
    assert out["counters"]["rejected_no_replica"] == 1


def _warming_scenario(pkg):
    stub = StubReplica(warming=True)
    handle = make_handle(pkg, 0, stub, ready=False)
    router = pkg.F.Router(lambda: [handle])
    seen = []
    for warming in (True, False, True, False):
        stub.warming = warming
        seen.append((router.probe_once(), handle.ready))
    stub.close()
    return {"probes": seen, "events": events(pkg)}


def test_warming_replica_leaves_rotation_and_is_readded():
    out = both(_warming_scenario)
    assert out["probes"] == [(0, False), (1, True), (0, False), (1, True)]
    assert [e["event"] for e in out["events"]] == [
        "replica-ready", "replica-unready", "replica-ready"]


def _reroute_scenario(pkg, fault):
    bad = StubReplica(tag="bad")
    good = StubReplica(tag="good")
    handles = [make_handle(pkg, 0, bad), make_handle(pkg, 1, good)]
    router = pkg.F.Router(lambda: handles, telemetry=pkg.F.RouterTelemetry(clock=FakeClock()))
    if fault == "crash":
        bad.close()  # every pick of it fails at the socket
    else:
        bad.draining = True  # a scale-down's SIGTERM landed before the probe saw it
    answers = []
    with Served(pkg, router, [good] + ([bad] if fault != "crash" else [])) as srv:
        for _ in range(5):
            status, body, _ = post(srv.port, {"texts": ["x"]})
            answers.append((status, json.loads(body)["docs"][0]["stub"]))
    counters = tel_counters(router.tel)
    return {"answers": answers, "ready": [h.ready for h in handles],
            "counters": {k: counters[k] for k in ("requests", "routed", "retries")},
            "events": [e["event"] for e in events(pkg)], "good_calls": good.parse_calls,
            "bad_calls": bad.parse_calls}


@pytest.mark.parametrize("fault", ["crash", "draining"])
def test_a_failed_or_draining_replica_is_retried_elsewhere_with_no_5xx(fault):
    out = both(_reroute_scenario, fault)
    assert out["answers"] == [(200, "good")] * 5
    assert out["ready"] == [False, True]
    assert out["counters"] == {"requests": 5, "routed": 5, "retries": 1}
    assert out["events"] == ["replica-unready"]
    assert out["bad_calls"] == (0 if fault == "crash" else 1)


def _passthrough_scenario(pkg):
    stub = StubReplica(status=429)
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle])
    with Served(pkg, router, [stub]) as srv:
        status, body, headers = post(srv.port, {"texts": ["x"]})
    return status, body, headers, handle.ready


def test_another_replica_status_is_passed_through():
    status, body, _, ready = both(_passthrough_scenario)
    assert status == 429 and json.loads(body)["error"] == "queue_full" and ready


def _all_dead_scenario(pkg):
    stub = StubReplica()
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle])
    stub.close()
    with pytest.raises(pkg.F.NoReplicaAvailable) as err:
        router.forward_parse(b'{"texts": ["x"]}')
    return norm(str(err.value)), handle.ready


def test_forward_when_every_replica_is_dead_raises_the_typed_error():
    msg, ready = both(_all_dead_scenario)
    # the first attempt takes the replica out; the retry finds none ready
    assert msg == "no replica is ready (all warming, draining, or down)" and not ready


def _draining_router_scenario(pkg):
    stub = StubReplica()
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle], telemetry=pkg.F.RouterTelemetry(clock=FakeClock()))
    router.begin_drain()
    with Served(pkg, router, [stub]) as srv:
        status, body, _ = post(srv.port, {"texts": ["x"]})
        hstatus, _ = get(srv.port, "/healthz")
    quiet = router.wait_inflight(1.0)
    return status, json.loads(body), hstatus, quiet, tel_counters(router.tel), stub.parse_calls


def test_a_draining_router_admits_nothing():
    status, body, hstatus, quiet, counters, calls = both(_draining_router_scenario)
    assert (status, body["error"], hstatus, quiet, calls) == (503, "draining", 503, True, 0)
    assert counters["rejected_draining"] == 1


# ----------------------------------------------------------------------
# The response cache
# ----------------------------------------------------------------------


def _lru_scenario(pkg):
    cache = pkg.F.ResponseCache(100)
    k = cache.key_for
    cache.put(k(["a"]), b"x" * 40)
    cache.put(k(["b"]), b"y" * 40)
    got = [cache.get(k(["a"]))]
    cache.put(k(["c"]), b"z" * 40)  # over the cap: evicts the least recent, b
    got += [cache.get(k(["b"])), cache.get(k(["a"])), cache.get(k(["c"]))]
    cache.put(k(["big"]), b"w" * 1000)  # larger than the cap: refused
    got.append(cache.get(k(["big"])))
    got.append(k(["ab"]) != k(["a", "b"]))
    return got, cache.stats(), len(cache)


def test_response_cache_byte_cap_and_lru():
    got, stats, n = both(_lru_scenario)
    assert got == [b"x" * 40, None, b"x" * 40, b"z" * 40, None, True]
    assert stats["cache_evictions"] == 1 and n == 2


def _generation_stamp_scenario(pkg):
    cache = pkg.F.ResponseCache(1 << 20)
    k = cache.key_for
    cache.put(k(["a"]), b"gen1", 1)
    got = [cache.get(k(["a"]), 1), cache.get(k(["a"]), 2), len(cache)]
    cache.put(k(["a"]), b"gen2", 2)
    cache.put(k(["a"]), b"gen2-again", 2)  # the same generation: kept as it was
    got.append(cache.get(k(["a"]), 2))
    cache.put(k(["a"]), b"gen3", 3)  # a newer generation replaces it
    got.append(cache.get(k(["a"]), 3))
    cache.put(k(["m"]), b"m", 3)
    got += [cache.get(k(["m"]), 3, model="tagger"), cache.get(k(["q"]), 3, model="tagger")]
    cache.count_not_modified("tagger")
    got.append(cache.flush())
    got.append(cache.get(k(["a"]), 3))
    return got, cache.stats()


def test_response_cache_generation_stamps_invalidation_and_flush():
    got, stats = both(_generation_stamp_scenario)
    assert got == [b"gen1", None, 0, b"gen2", b"gen3", b"m", None, 2, None]
    assert stats["cache_stale_invalidations"] == 1 and stats["cache_flushes"] == 1
    assert stats["by_model"] == {"tagger": {"hits": 1, "misses": 1, "stale_invalidations": 0,
                                            "not_modified": 1}}


def _cache_http_scenario(pkg, cache_bytes):
    stub = StubReplica(tag="origin")
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle], telemetry=pkg.F.RouterTelemetry(clock=FakeClock()),
                          cache_bytes=cache_bytes)
    body = {"texts": ["the cat runs", "a dog sleeps"]}
    with Served(pkg, router, [stub]) as srv:
        answers = [post(srv.port, body), post(srv.port, body),
                   post(srv.port, {"texts": ["different text"]}),
                   post(srv.port, {"not_texts": 1})]
        metrics = json.loads(get(srv.port, "/metrics")[1])
    return {"answers": answers, "parse_calls": stub.parse_calls,
            "cache": router.cache_stats(), "metrics_cache": metrics.get("cache"),
            "counters": tel_counters(router.tel)}


@pytest.mark.parametrize("cache_bytes", [1 << 20, 0])
def test_the_cache_serves_repeats_byte_equal_without_a_forward(cache_bytes):
    out = both(_cache_http_scenario, cache_bytes)
    first, second = out["answers"][:2]
    assert first[0] == second[0] == 200 and first[1] == second[1]
    if cache_bytes:
        assert out["parse_calls"] == 3
        assert out["cache"]["cache_hits"] == 1 and out["cache"]["cache_misses"] == 2
        assert out["metrics_cache"] == {**out["cache"], "cache_mixed_generation_bypasses": 0}
        assert out["counters"]["cache_hits"] == 1
        assert second[2]["ETag"] == p_batcher.etag_for(["the cat runs", "a dog sleeps"], "", None)
    else:
        assert out["parse_calls"] == 4 and out["cache"] is None
        assert out["metrics_cache"] is None


def test_fleet_config_arms_the_cache_by_default():
    assert p_fleet.FleetConfig(model_path="m").cache_mb == j_fleet.FleetConfig(model_path="m").cache_mb > 0


def _promotion_scenario(pkg):
    stub = StubReplica(tag="origin", generation=1)
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle], cache_bytes=1 << 20)
    body = {"texts": ["the cat runs"]}
    seen = []
    with Served(pkg, router, [stub]) as srv:
        router.probe_once()
        for _ in range(2):
            seen.append((json.loads(post(srv.port, body)[1])["docs"][0]["gen"], stub.parse_calls))
        stub.generation, stub.swap_count = 2, 1  # a promotion, learned by the probe
        router.probe_once()
        for _ in range(2):
            seen.append((json.loads(post(srv.port, body)[1])["docs"][0]["gen"], stub.parse_calls))
        flushed = router.flush_cache("promotion")
    return seen, router.cache.stats(), flushed, events(pkg)


def test_a_promotion_never_serves_a_stale_cached_body():
    seen, stats, flushed, evs = both(_promotion_scenario)
    assert seen == [(1, 1), (1, 1), (2, 2), (2, 2)]
    assert stats["cache_stale_invalidations"] == 1 and flushed == 1
    assert evs[-1]["event"] == "cache-flush"


def _mixed_scenario(pkg):
    s1, s2 = StubReplica(tag="old", generation=1), StubReplica(tag="new", generation=2)
    h1, h2 = make_handle(pkg, 0, s1), make_handle(pkg, 1, s2)
    router = pkg.F.Router(lambda: [h1, h2], cache_bytes=1 << 20)
    body = {"texts": ["same text"]}
    out = []
    with Served(pkg, router, [s1, s2]) as srv:
        router.probe_once()
        out.append(router.cache_generation() is pkg.router.GENERATION_MIXED)
        post(srv.port, body)
        post(srv.port, body)
        out.append((s1.parse_calls + s2.parse_calls, len(router.cache), router.cache_stats()))
        h1.ready = h2.ready = False  # an empty ready set is no rollout window
        out.append(post(srv.port, body)[0])
        h1.ready = h2.ready = True
        out.append(post(srv.port, {"not_texts": 1})[0])
        out.append(router.cache_stats()["cache_mixed_generation_bypasses"])
        s1.generation = 2  # converged
        router.probe_once()
        out.append(router.cache_generation())
        post(srv.port, body)
        post(srv.port, body)
        out.append((len(router.cache), router.cache_stats()))
    return out


def test_the_cache_is_bypassed_while_generations_are_mixed():
    out = both(_mixed_scenario)
    assert out[0] is True and out[1][:2] == (2, 0)
    assert out[1][2]["cache_mixed_generation_bypasses"] == 2
    assert out[2:6] == [503, 200, 2, 2]
    assert out[6][0] == 1 and out[6][1]["cache_hits"] == 1


# ----------------------------------------------------------------------
# 304s at the edge and from the replica
# ----------------------------------------------------------------------


def _edge_304_scenario(pkg):
    texts = ["the cat runs"]
    etag = pkg.batcher.etag_for
    stub = StubReplica(tag="origin", generation=1, etag=etag(texts, "", 1))
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle], cache_bytes=1 << 20)
    body = {"texts": texts}
    seen = []
    with Served(pkg, router, [stub]) as srv:
        router.probe_once()
        first = post(srv.port, body)
        tag1 = first[2]["ETag"]
        seen += [first, post(srv.port, body, {"If-None-Match": tag1}), post(srv.port, body),
                 stub.parse_calls, router.cache.stats()]
        stub.generation, stub.etag = 2, etag(texts, "", 2)
        router.probe_once()
        stale = post(srv.port, body, {"If-None-Match": tag1})
        seen += [stale, post(srv.port, body, {"If-None-Match": stale[2]["ETag"]}),
                 stub.parse_calls, router.cache.stats()]
    return seen


def test_the_edge_answers_304_and_a_promotion_changes_the_tag():
    seen = both(_edge_304_scenario)
    first, revalidated, repeat, calls, stats = seen[:5]
    assert first[0] == 200 and revalidated[:2] == (304, b"")
    assert revalidated[2]["ETag"] == first[2]["ETag"] == repeat[2]["ETag"]
    assert repeat[0] == 200 and calls == 1
    assert stats["cache_not_modified"] == 1 and stats["cache_hits"] == 1
    stale, again, calls2, stats2 = seen[5:]
    assert stale[0] == 200 and stale[2]["ETag"] != first[2]["ETag"]
    assert again[:2] == (304, b"") and calls2 == 2 and stats2["cache_not_modified"] == 2


def _replica_304_scenario(pkg, case):
    generation = None if case == "cache off" else 1
    stubs = [StubReplica(tag="a", generation=generation, etag='"abc"')]
    if case == "mixed":
        stubs.append(StubReplica(tag="b", generation=2, etag='"abc"'))
    handles = [make_handle(pkg, i, s) for i, s in enumerate(stubs)]
    router = pkg.F.Router(lambda: handles, cache_bytes=0 if case == "cache off" else 1 << 20)
    with Served(pkg, router, stubs) as srv:
        router.probe_once()
        inm = "*" if case == "mixed" else '"abc"'
        answer = post(srv.port, {"texts": ["x"]}, {"If-None-Match": inm})
    forwarded = [s.seen[-1][2] for s in stubs if s.seen]
    return answer, forwarded, router.cache_stats()


@pytest.mark.parametrize("case", ["cache off", "cache armed", "mixed"])
def test_the_replica_304_passes_through_and_mixed_generations_drop_the_validator(case):
    (status, body, headers), forwarded, stats = both(_replica_304_scenario, case)
    if case == "mixed":
        assert status == 200 and json.loads(body)["docs"] and forwarded == [None]
        assert stats["cache_mixed_generation_bypasses"] == 1
        assert stats["cache_not_modified"] == 0
    else:
        assert (status, body, headers["ETag"]) == (304, b"", '"abc"')
        assert forwarded == ['"abc"']
        if stats is not None:
            assert stats["cache_not_modified"] == 1 and stats["cache_entries"] == 0


# ----------------------------------------------------------------------
# Length routing
# ----------------------------------------------------------------------


def _addressed(pkg, n, port=19000):
    handles = []
    for i in range(n):
        h = pkg.F.ReplicaHandle(i)
        h.set_address("127.0.0.1", port + i)
        h.ready = True
        handles.append(h)
    return handles


def _length_degenerate_scenario(pkg):
    handles = _addressed(pkg, 3)
    for h, n in zip(handles, (2, 0, 1)):
        h.outstanding = n
    tel = pkg.F.RouterTelemetry(clock=FakeClock())
    off = pkg.F.Router(lambda: handles, length_routing=False)
    on = pkg.F.Router(lambda: handles, length_routing=True, telemetry=tel)
    single = _addressed(pkg, 1, port=19100)
    on_single = pkg.F.Router(lambda: single, length_routing=True, telemetry=tel)
    picks = [off.pick(length_bucket=3).replica_id, on.pick().replica_id,
             on_single.pick(length_bucket=5).replica_id]
    handles[2].resident_models = {"m": {}}
    picks.append(on.pick(model="m", length_bucket=0).replica_id)
    return picks, tel_counters(tel)


def test_length_routing_degenerate_cases_are_least_outstanding():
    picks, counters = both(_length_degenerate_scenario)
    assert picks == [1, 1, 0, 2]
    assert counters["length_affinity_picks"] == counters["length_affinity_spills"] == 0


def _affinity_scenario(pkg):
    tel = pkg.F.RouterTelemetry(clock=FakeClock())
    handles = _addressed(pkg, 2)
    router = pkg.F.Router(lambda: handles, length_routing=True, telemetry=tel)
    picks = [router.pick(length_bucket=b).replica_id for b in range(4)]
    handles[0].outstanding = 3  # past the slack: spill
    picks.append(router.pick(length_bucket=0).replica_id)
    handles[0].outstanding = 0
    skewed = []
    for _ in range(12):  # every request of one bucket
        h = router.pick(length_bucket=1)
        h.outstanding += 1
        skewed.append(h.replica_id)
    return picks, skewed, [h.outstanding for h in handles], tel_counters(tel)


def test_length_affinity_maps_buckets_and_spills_past_the_slack():
    picks, skewed, outstanding, counters = both(_affinity_scenario)
    assert picks == [0, 1, 0, 1, 1]
    assert set(skewed) == {0, 1} and abs(outstanding[0] - outstanding[1]) <= 3
    assert counters["length_affinity_spills"] >= 2 and counters["length_affinity_picks"] >= 5


def _bimodal_scenario(pkg, use_affinity):
    pattern = [5, 5, 100, 5, 100, 100, 5, 100] * 8
    handles = _addressed(pkg, 2, port=19200)
    router = pkg.F.Router(lambda: handles, length_routing=use_affinity,
                          telemetry=pkg.F.RouterTelemetry(clock=FakeClock()))
    assigned = {0: [], 1: []}
    for n_words in pattern:
        hint = pkg.router._length_bucket_hint(["w " * n_words]) if use_affinity else None
        h = router.pick(length_bucket=hint)
        assigned[h.replica_id].append(n_words)
        h.outstanding += 1
    return assigned


def _pad(lengths, batch=4):
    pad = 0
    for i in range(0, len(lengths), batch):
        chunk = lengths[i:i + batch]
        t = next((b for b in p_train_batcher.DEFAULT_LENGTH_BUCKETS if b >= max(chunk)),
                 max(chunk))
        pad += len(chunk) * t - sum(chunk)
    return pad


def test_length_affinity_cuts_padding_on_a_bimodal_mix():
    blind, affine = both(_bimodal_scenario, False), both(_bimodal_scenario, True)
    assert all(len(set(v)) == 1 for v in affine.values())
    assert min(len(v) for v in affine.values()) >= 16
    assert _pad(affine[0]) + _pad(affine[1]) < _pad(blind[0]) + _pad(blind[1])
    for texts in (["a"], ["w " * 16], ["w " * 17], ["w " * 600, "x"]):
        assert p_router._length_bucket_hint(texts) == j_router._length_bucket_hint(texts)


# ----------------------------------------------------------------------
# Pooled connections, models, tenants
# ----------------------------------------------------------------------


def _stale_pool_scenario(pkg):
    live, gone = StubReplica(tag="live"), StubReplica()
    gone.close()  # the old incarnation's port: dials are refused
    h = make_handle(pkg, 0, live)
    for _ in range(3):
        h.checkin_conn(http.client.HTTPConnection("127.0.0.1", gone.port, timeout=5.0))
    router = pkg.F.Router(lambda: [h])
    with Served(pkg, router, [live]) as srv:
        answers = [post(srv.port, {"texts": ["x"]})[:2] for _ in range(4)]
        ready_after_forwards = h.ready
        live.snapshot = {"counters": {"requests": 7}, "gauges": {}, "histograms": {}, "slo": {}}
        h.ready = False
        for _ in range(2):
            h.checkin_aux_conn(http.client.HTTPConnection("127.0.0.1", gone.port, timeout=5.0))
        probed = router.probe_once()
        for _ in range(2):
            h.checkin_aux_conn(http.client.HTTPConnection("127.0.0.1", gone.port, timeout=5.0))
        snaps = router.scrape_replica_metrics()
    return answers, ready_after_forwards, live.parse_calls, probed, snaps


def test_stale_pooled_connections_drain_to_a_fresh_dial():
    answers, ready, calls, probed, snaps = both(_stale_pool_scenario)
    assert [a[0] for a in answers] == [200] * 4 and ready and calls == 4
    assert probed == 1 and snaps[0]["counters"]["requests"] == 7 and snaps[0]["replica_id"] == 0


def _manifest(tmp_path):
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps({
        "models": {"a": {"path": str(tmp_path)}, "b": {"path": str(tmp_path)}},
        "default_model": "a",
        "tenants": {"acme": {"class": "default"}},
    }))
    return str(path)


def _model_scenario(pkg, manifest):
    from importlib import import_module

    registry = import_module(pkg.F.__name__.rsplit(".", 1)[0] + ".multimodel").ModelRegistry
    stubs = [StubReplica(tag="r0", resident={"a": {"generation": None}}),
             StubReplica(tag="r1", resident={"a": {"generation": None},
                                              "b": {"generation": 3}})]
    handles = [make_handle(pkg, i, s) for i, s in enumerate(stubs)]
    tel = pkg.F.RouterTelemetry(clock=FakeClock())
    router = pkg.F.Router(lambda: handles, telemetry=tel, cache_bytes=1 << 20,
                          registry=registry.from_manifest(manifest))
    out = []
    with Served(pkg, router, stubs) as srv:
        router.probe_once()
        out.append(router.placement())
        out.append(router.cache_generation("b"))
        out.append(router.cache_generation("zzz") is pkg.router.GENERATION_MIXED)
        out.append(post(srv.port, {"texts": ["hi"]}, path="/v1/models/b/parse")[:2])
        out.append(post(srv.port, {"texts": ["hi"]}, path="/v1/models/b/parse")[:2])
        out.append(post(srv.port, {"texts": ["hi"]}, {"X-SRT-Tenant": "acme"})[:2])
        out.append(post(srv.port, {"texts": ["hi"]}, path="/v1/models/nope/parse")[:2])
        out.append([s.seen for s in stubs])
        metrics = json.loads(get(srv.port, "/metrics")[1])
        out.append({k: metrics[k] for k in ("placement", "models", "default_model", "cache")})
        out.append(tel_counters(tel))
    return norm(out)


def test_models_route_within_their_hosts_and_unknown_ones_are_404(tmp_path):
    out = both(_model_scenario, _manifest(tmp_path))
    assert out[0] == {0: ["a"], 1: ["a", "b"]} and out[1] == 3 and out[2] is True
    assert out[3][0] == out[4][0] == 200 and out[3][1] == out[4][1]
    assert out[6][0] == 404 and json.loads(out[6][1])["error"] == "unknown_model"
    seen0, seen1 = out[7]
    assert [s[0] for s in seen1] == ["/v1/models/b/parse"]  # the repeat was a cache hit
    assert seen0 == [("/v1/parse", "acme", None, b'{"texts": ["hi"]}')]
    assert out[8]["cache"]["by_model"]["b"] == {"hits": 1, "misses": 1, "stale_invalidations": 0}
    assert out[9]["rejected_unknown_model"] == 1


def _load_model_scenario(pkg):
    stub = StubReplica()
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle])
    with Served(pkg, router, [stub]):
        status, _ = router.load_model(0, "b")
        with pytest.raises(pkg.F.NoReplicaAvailable):
            router.load_model(7, "b")
    return status, stub.seen[-1][0], router.placement()


def test_load_model_posts_the_admin_route():
    assert both(_load_model_scenario) == (200, "/admin/models/load", {0: ["b"]})


# ----------------------------------------------------------------------
# The fleet's /metrics
# ----------------------------------------------------------------------


def _snap(n_requests, p99, queue_depth, generation=None, window=None, models=None):
    snap = {
        "counters": {"requests": n_requests, "docs": 2 * n_requests},
        "gauges": {"queue_depth": queue_depth, "last_batch_occupancy": 4},
        "histograms": {
            "request_latency_seconds": {
                "count": n_requests, "sum": 0.1 * n_requests, "min": 0.01, "max": p99,
                "p50": p99 / 3, "p95": p99 / 2, "p99": p99,
                "buckets": [[0.1, n_requests // 2], [1.0, n_requests]]},
            "batch_occupancy": {"count": n_requests // 2, "sum": 2.0 * n_requests, "min": 1,
                                "max": 8, "p50": 4, "p95": 6, "p99": 8},
        },
        "slo": {"request_latency_p50": p99 / 3, "request_latency_p95": p99 / 2,
                "request_latency_p99": p99, "batch_occupancy_p50": 4},
    }
    if generation is not None:
        snap["generation"] = generation
    if window is not None:
        snap["slo_window"] = {"window_s": 30.0, "samples": window,
                              "request_latency_p99": p99 * 2, "request_latency_p50": p99}
    if models is not None:
        snap["models"] = models
    return snap


MERGE_CASES = {
    "plain": [_snap(10, 0.3, 4), _snap(30, 0.1, 2)],
    "empty": [],
    "one": [_snap(5, 0.2, 0)],
    "idle": [_snap(0, 0.2, 0, window=0), _snap(0, 0.4, 1, window=0)],
    "generations": [_snap(10, 0.3, 4, generation=1, window=10),
                    _snap(30, 0.1, 2, generation=2, window=5), _snap(3, 0.5, 0, window=3)],
    "models": [_snap(10, 0.3, 4, models={"a": _snap(4, 0.2, 1), "b": _snap(6, 0.3, 3)}),
               _snap(30, 0.1, 2, models={"a": _snap(30, 0.1, 2)})],
    "bucket tables differ": [_snap(10, 0.3, 4),
                             {**_snap(30, 0.1, 2), "histograms": {"request_latency_seconds": {
                                 "count": 30, "buckets": [[0.5, 30]]}}}],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_serving_snapshots_matches_jax(case):
    snaps = MERGE_CASES[case]
    merged = p_tel.merge_serving_snapshots(json.loads(json.dumps(snaps)))
    assert merged == j_tel.merge_serving_snapshots(json.loads(json.dumps(snaps)))
    assert merged["replicas"] == len(snaps)
    if case == "plain":
        lat = merged["histograms"]["request_latency_seconds"]
        assert lat["p99"] == pytest.approx((0.3 * 10 + 0.1 * 30) / 40)
        assert lat["p99_worst"] == 0.3 and lat["buckets"] == [[0.1, 20.0], [1.0, 40.0]]
        assert merged["gauges"]["queue_depth"] == {"sum": 6.0, "max": 4.0, "mean": 3.0}
    if case == "generations":
        assert sorted(merged["by_generation"]) == ["1", "2", "none"]
    if case == "models":
        assert merged["by_model"]["a"]["counters"]["requests"] == 34


def _fleet_metrics_scenario(pkg):
    stubs = [StubReplica(tag="a", snapshot=_snap(10, 0.3, 4, generation=1, window=10)),
             StubReplica(tag="b", snapshot=_snap(30, 0.1, 2, generation=1, window=4))]
    handles = [make_handle(pkg, i, s) for i, s in enumerate(stubs)]
    tel = pkg.F.RouterTelemetry(clock=FakeClock())
    router = pkg.F.Router(lambda: handles, telemetry=tel, cache_bytes=1 << 20)
    with Served(pkg, router, stubs) as srv:
        router.probe_once()
        post(srv.port, {"texts": ["a"]})
        post(srv.port, {"texts": ["a"]})
        body = json.loads(get(srv.port, "/metrics")[1])
        text_first = router.prometheus_metrics()
        exemplars = json.loads(get(srv.port, "/admin/exemplars")[1])
        alerts = json.loads(get(srv.port, "/admin/alerts")[1])
        trace = json.loads(get(srv.port, "/trace")[1])
        missing = get(srv.port, "/nope")
        stubs[0].close()
        handles[0].close_conns()  # a process death severs every socket
        handles[0].ready = True  # stale: the scrape must tolerate it
        after = json.loads(get(srv.port, "/metrics")[1])
        text_after = router.prometheus_metrics()
    body["router"]["histograms"]["router_latency_seconds"].pop("window", None)
    return norm({"metrics": body, "prometheus": text_first, "exemplars": exemplars,
                 "alerts": alerts, "trace_spans": sorted(e["name"] for e in trace["traceEvents"]),
                 "missing": missing[0], "after": {k: after[k] for k in (
                     "fleet", "scrape_failures")}, "prometheus_after": text_after})


def test_router_metrics_merge_the_replicas_and_name_the_missing_one(fake_host):
    out = both(_fleet_metrics_scenario)
    m = out["metrics"]
    assert m["fleet"]["replicas"] == 2 and m["fleet"]["counters"]["requests"] == 40
    assert [r["id"] for r in m["replicas"]] == [0, 1] and m["process"] == PROCESS_SAMPLE
    assert m["router"]["counters"]["routed"] == 1 and m["cache"]["cache_hits"] == 1
    assert [e["replica_id"] for e in out["exemplars"]["replicas"]] == [0, 1]
    assert out["alerts"] == {"alerts": "disabled"} and out["missing"] == 404
    assert "route" in out["trace_spans"]
    assert out["after"]["fleet"]["replicas"] == 1 and out["after"]["scrape_failures"] == {"0": 1}
    text = out["prometheus"]
    assert 'srt_serving_requests_total{replica_id="0"} 10' in text
    assert "srt_router_cache_hits_total 1" in text
    assert len([ln for ln in text.splitlines()
                if ln.startswith("srt_router_cache_hits_total")]) == 1
    # the /metrics scrape and this one
    assert 'srt_router_replica_scrape_failures_total{replica_id="0"} 2' in out["prometheus_after"]


# ----------------------------------------------------------------------
# The autoscaler
# ----------------------------------------------------------------------


def hot(ready):
    return dict(ready=ready, p99_s=0.5, queue_depth=0.0, occupancy=8.0)


def cold(ready):
    return dict(ready=ready, p99_s=0.01, queue_depth=0.0, occupancy=1.0)


def _script(name):
    """(policy kwargs, [(observation, seconds to advance after it)])."""
    if name == "up after consecutive breaches":
        return {}, [(hot(1), 2)] * 3
    if name == "oscillation never flaps":
        return {}, [(hot(1), 2), (cold(1), 2)] * 20
    if name == "cooldown blocks back to back":
        return {}, [(hot(1), 1)] * 3 + [(hot(2), 1)] * 10 + [(hot(2), 30)] + [(hot(2), 1)] * 3
    if name == "cooldown ends on its clock":
        return {}, [(hot(1), 1)] * 3 + [(hot(2), 5)] * 12
    if name == "down and bounds":
        return {}, ([(cold(3), 2)] * 5 + [(cold(1), 60)] + [(cold(1), 2)] * 20
                    + [(hot(4), 60)] + [(hot(4), 2)] * 20)
    if name == "queue pressure without p99":
        return {"queue_high": 16.0}, [(dict(ready=2, p99_s=None, queue_depth=80.0), 2)] * 3
    if name == "pinned at max does not refire":
        return {"max_replicas": 2}, [(hot(2), 1)] * 8
    if name == "occupancy keeps it up":
        return {}, [(dict(ready=3, p99_s=0.01, queue_depth=0.0, occupancy=6.0), 2)] * 12
    raise KeyError(name)


AUTOSCALER_SCRIPTS = ["up after consecutive breaches", "oscillation never flaps",
                      "cooldown blocks back to back", "cooldown ends on its clock",
                      "down and bounds",
                      "queue pressure without p99", "pinned at max does not refire",
                      "occupancy keeps it up"]


def _autoscaler_scenario(pkg, name, monkeypatch):
    kwargs, script = _script(name)
    kw = dict(min_replicas=1, max_replicas=4, p99_target_s=0.2, up_consecutive=3,
              down_consecutive=5, cooldown_s=30.0)
    kw.update(kwargs)
    clock = FakeClock()
    policy = pkg.F.AutoscalerPolicy(clock=clock, **settle(pkg, kw, monkeypatch))
    pkg.res.drain_events()
    answers = []
    for obs, dt in script:
        answers.append(policy.observe(pkg.F.FleetObservation(**obs)))
        clock.advance(dt)
    return answers, policy.decisions, events(pkg)


@pytest.mark.parametrize("name", AUTOSCALER_SCRIPTS)
def test_autoscaler_scripts_decide_as_jax(name, monkeypatch):
    answers, decisions, evs = both(_autoscaler_scenario, name, monkeypatch)
    fired = [a for a in answers if a is not None]
    expect = {"up after consecutive breaches": [2], "oscillation never flaps": [],
              "cooldown blocks back to back": [2, 3], "cooldown ends on its clock": [2, 3],
              "down and bounds": [2],
              "queue pressure without p99": [3], "pinned at max does not refire": [],
              "occupancy keeps it up": []}[name]
    assert fired == expect
    assert [e["event"] for e in evs] == [f"autoscale-{d['direction']}" for d in decisions]
    assert [(e["from"], e["to"]) for e in evs] == [(d["from"], d["to"]) for d in decisions]


def _observation_scenario(pkg):
    snaps = [_snap(10, 0.3, 4), _snap(30, 0.1, 2)]
    windowed = [_snap(10, 0.3, 4, window=5), _snap(30, 0.1, 2, window=0)]
    return [pkg.F.observation_from_snapshots(s, ready=r).__dict__
            for s, r in ((snaps, 2), ([], 1), (windowed, 2))]


def test_observation_from_snapshots_matches_jax():
    full, empty, windowed = both(_observation_scenario)
    assert full == {"ready": 2, "p99_s": 0.3, "queue_depth": 6.0, "occupancy": 4.0}
    assert empty["p99_s"] is None and empty["queue_depth"] == 0.0
    assert windowed["p99_s"] == 0.6  # the window's p99; an empty window is no signal


@pytest.mark.parametrize("kwargs", [dict(min_replicas=0),
                                    dict(min_replicas=3, max_replicas=2),
                                    dict(up_consecutive=0)])
def test_autoscaler_rejects_bad_bounds_as_jax(kwargs):
    msgs = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError) as err:
            pkg.F.AutoscalerPolicy(**kwargs)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _fleet_tick_scenario(pkg):
    stubs = [StubReplica(snapshot=_snap(10, 0.9, 4)), StubReplica(snapshot=_snap(10, 0.1, 0))]
    handles = [make_handle(pkg, i, s) for i, s in enumerate(stubs)]
    fleet = pkg.F.Fleet(pkg.F.FleetConfig(model_path="m", device="cpu", port=0, telemetry=False,
                                          autoscale=True, up_consecutive=2, p99_target_ms=500.0))
    fleet.router.replicas = lambda: handles
    threading.Thread(target=fleet.httpd.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()  # what start() runs, without spawning
    scaled = []
    fleet.supervisor.scale_to = scaled.append
    decisions = [fleet.autoscale_tick() for _ in range(3)]
    pkg.res.drain_events()
    fleet.request_shutdown(signal.SIGTERM)
    rc = fleet.wait()
    for s in stubs:
        s.close()
    return decisions, scaled, rc, fleet.router.draining, [e["event"] for e in events(pkg)]


def test_the_fleet_autoscale_tick_and_drain_match_jax():
    decisions, scaled, rc, draining, evs = both(_fleet_tick_scenario)
    assert decisions == [None, 3, None] and scaled == [3]
    assert rc == 0 and draining
    assert evs == ["fleet-drain", "fleet-replicas-stopped"]


# ----------------------------------------------------------------------
# Telemetry off: no telemetry object is built
# ----------------------------------------------------------------------


def _telemetry_off_scenario(pkg, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("telemetry built on the disabled path")

    monkeypatch.setattr(pkg.tel.MetricsRegistry, "__init__", boom)
    monkeypatch.setattr(pkg.tel.TraceBuffer, "__init__", boom)
    monkeypatch.setattr(pkg.host.ProcessSampler, "__init__", boom)
    stub = StubReplica(snapshot=_snap(10, 0.3, 4))
    handle = make_handle(pkg, 0, stub)
    router = pkg.F.Router(lambda: [handle], telemetry=None)
    with Served(pkg, router, [stub]) as srv:
        router.probe_once()
        status = post(srv.port, {"texts": ["x"]})[0]
        metrics = json.loads(get(srv.port, "/metrics")[1])
        trace = json.loads(get(srv.port, "/trace")[1])
    fleet = pkg.F.Fleet(pkg.F.FleetConfig(model_path="m", device="cpu", port=0,
                                          telemetry=False))
    fleet.httpd.server_close()
    clock = FakeClock()
    policy = pkg.F.AutoscalerPolicy(clock=clock, p99_target_s=0.2)
    for _ in range(3):
        policy.observe(pkg.F.FleetObservation(**hot(1)))
        clock.advance(1)
    monkeypatch.undo()
    return (status, "router" in metrics, "process" in metrics,
            metrics["fleet"]["counters"]["requests"], trace, fleet.tel, len(policy.decisions))


def test_telemetry_off_builds_no_telemetry(monkeypatch):
    out = both(_telemetry_off_scenario, monkeypatch)
    assert out == (200, False, False, 10, {"trace": "disabled"}, None, 1)


# ----------------------------------------------------------------------
# The supervisor against a fake serve
# ----------------------------------------------------------------------

SLEEP_SCRIPT = ("import signal, sys, time\n"
                "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
                "print('serving on http://127.0.0.1:59000', flush=True)\n"
                "while True:\n"
                "    time.sleep(0.05)\n")
CRASH_SCRIPT = ("print('serving on http://127.0.0.1:59001', flush=True)\n"
                "raise SystemExit(1)\n")


def _wait_until(cond, timeout=15.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def _supervisor(pkg, monkeypatch, script, seen=None, **kw):
    """A supervisor of ``script`` whose restarts come at once (the port's
    backoff base set to 0, JAX's policy given) and whose monitor polls fast."""
    def build(slot):
        if seen is not None:
            seen.append(slot)
        return [sys.executable, "-c", script]

    kw.setdefault("monitor_poll_s", 0.02)
    kw.setdefault("grace_s", 10.0)
    if pkg is PKGS["jax"]:
        kw["restart_policy"] = pkg.res.RetryPolicy(max_retries=10, base_delay=0.0, jitter=0.0)
    else:
        monkeypatch.setattr(pkg.replica, "RESTART_BASE_DELAY_S", 0.0)
    return pkg.F.ReplicaSupervisor(build, **settle(pkg, kw, monkeypatch))


def _banner_scenario(pkg, monkeypatch):
    sup = _supervisor(pkg, monkeypatch, SLEEP_SCRIPT)
    [handle] = sup.start(1)
    try:
        assert _wait_until(lambda: handle.address is not None)
        described = handle.describe()
        return handle.address, handle.alive, {k: described[k] for k in (
            "id", "slot", "alive", "host", "port", "restarts", "ready")}, sup.stop_all()
    finally:
        sup.stop_all()


def test_supervisor_reads_the_banner_and_stops_clean(monkeypatch):
    address, alive, described, clean = both(_banner_scenario, monkeypatch)
    assert address == ("127.0.0.1", 59000) and alive and clean
    assert (described["host"], described["port"]) == ("127.0.0.1", 59000)  # the banner's


def _giving_up_scenario(pkg, monkeypatch):
    sup = _supervisor(pkg, monkeypatch, CRASH_SCRIPT, max_restarts_per_replica=2)
    pkg.res.drain_events()
    [handle] = sup.start(1)
    try:
        assert _wait_until(lambda: handle.restarts >= 3)
        time.sleep(0.3)  # time for a wrong supervisor to restart once more
        gone = _wait_until(lambda: sup.replica_count == 0)
        crashed = [(e["event"], e.get("restart"), e.get("rc")) for e in pkg.res.drain_events()
                   if e["event"] in ("replica-crash", "replica-giving-up")]
        sup.scale_to(1)
        [fresh] = sup.handles()
        return (handle.restarts, handle.alive, gone, crashed, fresh.replica_id, fresh.slot,
                sup.replica_count)
    finally:
        sup.stop_all()


def test_supervisor_restarts_crashes_until_its_cap_then_frees_the_slot(monkeypatch):
    restarts, alive, gone, crashed, fresh_id, fresh_slot, count = both(_giving_up_scenario,
                                                                       monkeypatch)
    assert (restarts, alive, gone) == (3, False, True)
    assert crashed == [("replica-crash", 1, 1), ("replica-crash", 2, 1),
                       ("replica-giving-up", None, 1)]
    assert (fresh_id, fresh_slot, count) == (1, 0, 1)


def _scale_scenario(pkg, monkeypatch):
    seen = []
    sup = _supervisor(pkg, monkeypatch, SLEEP_SCRIPT, seen=seen)
    sup.start(2)
    try:
        out = [sup.replica_count]
        sup.scale_to(3)
        out.append(sup.replica_count)
        assert _wait_until(lambda: all(h.address for h in sup.handles()))
        sup.scale_to(1)  # the two youngest go
        assert _wait_until(lambda: sup.replica_count == 1)
        out.append([h.replica_id for h in sup.handles()])
        sup.scale_to(2)  # the new replica takes the lowest free slot
        assert _wait_until(lambda: sup.replica_count == 2)
        out.append(sorted((h.replica_id, h.slot) for h in sup.handles()))
        out.append(list(seen))
        return out
    finally:
        sup.stop_all()


def test_supervisor_scales_up_and_down_and_reuses_freed_slots(monkeypatch):
    out = both(_scale_scenario, monkeypatch)
    assert out == [2, 3, [0], [(0, 0), (3, 1)], [0, 1, 2, 1]]


def _draining_scenario(pkg, monkeypatch):
    sup = _supervisor(pkg, monkeypatch, SLEEP_SCRIPT)
    [handle] = sup.start(1)
    try:
        assert _wait_until(lambda: handle.address is not None)
        sup.begin_drain()
        handle.proc.kill()  # a crash during the drain
        handle.proc.wait(timeout=10)
        time.sleep(0.3)
        return handle.restarts, sup.stop_all()
    finally:
        sup.stop_all()


def test_supervisor_restarts_nothing_while_draining(monkeypatch):
    restarts, clean = both(_draining_scenario, monkeypatch)
    assert restarts == 0 and clean is False  # the killed replica's exit was not 0


# ----------------------------------------------------------------------
# The replica's argv, the shutdown coordinator's hooks
# ----------------------------------------------------------------------


def test_build_serve_cmd_matches_jax_but_for_the_package():
    kw = dict(device="cpu", port=7, max_batch=4, max_wait_ms=5, queue_size=64, timeout_ms=900,
              max_doc_len=32, drain_timeout_s=3, batching="window", precision="f32",
              no_telemetry=True, model_manifest="m.json", resident_models=2)
    port, ref = p_fleet.build_serve_cmd("model", **kw), j_fleet.build_serve_cmd("model", **kw)
    assert port[:3] == [sys.executable, "-m", "spacy_ray_tpu_torch"]
    assert port[3:] == ref[3:] and ref[2] == "spacy_ray_tpu"
    assert p_fleet.build_serve_cmd("model")[-2:] == ["--device", "cuda"]


def test_fleet_config_builds_the_replicas_argv_and_env_by_slot():
    cfg = dict(model_path="m", device="cpu", base_port=9000, max_batch=8,
               visible_devices=["0", "1"], visible_devices_env="CUDA_VISIBLE_DEVICES")
    port, ref = p_fleet.FleetConfig(**cfg), j_fleet.FleetConfig(**cfg)
    for slot in range(3):
        assert port.build_cmd(slot)[3:] == ref.build_cmd(slot)[3:]
        assert "--port" in port.build_cmd(slot)
        # JAX pins its own platform in the child's environment; the port's
        # replica reads --device alone
        assert port.build_env(slot) == {k: v for k, v in ref.build_env(slot).items()
                                        if k != "JAX_PLATFORMS"}
    assert port.build_cmd(1)[port.build_cmd(1).index("--port") + 1] == "9001"
    assert p_fleet.FleetConfig(model_path="m").build_cmd(0)[9:11] == ["--device", "cuda"]


def _shutdown_hooks(pkg):
    out = []
    coord = pkg.res.ShutdownCoordinator()
    got = []
    coord.add_callback(got.append)
    coord.add_callback(lambda signum: 1 / 0)  # a broken hook breaks nothing
    coord.add_callback(lambda signum: got.append(("second", signum)))
    coord.install()
    try:
        signal.raise_signal(signal.SIGTERM)
        out.append(("sigterm", coord.requested, list(got)))
        coord.request()
        out.append(("request", list(got)))
    finally:
        coord.restore()
    return out


def test_shutdown_coordinator_hooks_match_jax():
    assert both(_shutdown_hooks) == [
        ("sigterm", True, [signal.SIGTERM, ("second", signal.SIGTERM)]),
        ("request", [signal.SIGTERM, ("second", signal.SIGTERM), None, ("second", None)])]
