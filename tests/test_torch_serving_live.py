"""The port's serving telemetry and hot-swap against the JAX package's, on
the CPU.

* ``ServingTelemetry``: the same hook calls on a fake clock give the same
  snapshot in both packages (``process``, the host's own view, aside), and
  one snapshot renders the same Prometheus text; the exemplar ring catches
  p99 outliers and stays bounded; with telemetry off nothing of
  ``training/telemetry.py`` is constructed; ``/metrics`` (JSON, Prometheus
  and both disabled forms), ``/trace`` and ``/admin/exemplars`` over HTTP.
* Hot-swap (JAX ``tests/test_live.py``): a swap under concurrent load
  answers every request with exactly the generation stamped on it; a
  rollback restores byte-identical responses; a swap's responses equal a
  fresh engine's loaded with that generation; a mismatched tree, a torn
  generation and nothing to roll back to are refused (409) while the old
  generation keeps serving; ``/admin/swap`` needs an allowlisted directory
  (403); ``Checkpoints`` reads a JAX-written generation's parameters
  bit-equal, and JAX reads the port's.

The hot-swap's answers are compared as the JSON the server sends: equal
bytes, not a tolerance. The switch-MoE fixture (``tests/data/jax_moe``) is
served one request at a time, because an expert's capacity depends on the
padded batch, so a response depends on what it was batched with.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import spacy_ray_tpu as J
from spacy_ray_tpu.serving.engine import ServingTelemetry as JTelemetry
from spacy_ray_tpu.training import checkpoint as jckpt
from spacy_ray_tpu.training.prometheus import render_snapshot as j_render

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.serving.batcher import SwapFailed
from spacy_ray_tpu_torch.serving.engine import InferenceEngine, ServingTelemetry
from spacy_ray_tpu_torch.serving.server import Server
from spacy_ray_tpu_torch.training import telemetry as ptelemetry
from spacy_ray_tpu_torch.training.checkpoint import (
    CheckpointCorrupt,
    Checkpoints,
    TrainCheckpoint,
    flatten,
)
from spacy_ray_tpu_torch.training.prometheus import render_snapshot as p_render

from test_torch_pipeline import TAGS, TRF_TAGGER_CFG

REPO = Path(__file__).resolve().parent.parent
JAX_MOE = REPO / "tests" / "data" / "jax_moe"
TEXTS = ["the cat runs fast", "Paris is big .", "hi there", "a dog sat on the mat today",
         "we saw them", "Berlin and Rome are old cities ."]


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _drive(tel, clk):
    """One sequence of every hook, as an engine and a server make them."""
    from spacy_ray_tpu.serving import batcher as jb
    from spacy_ray_tpu_torch.serving import batcher as pb

    mod = jb if isinstance(tel, JTelemetry) else pb
    for i in range(150):
        tel.request_admitted(1 + i % 3, i % 5)
        t0 = tel.now()
        with tel.batch_span(1 + i % 4, 4, 16, [f"r{i}"], real_tokens=20 + i % 7):
            clk.advance(0.004 + 0.0001 * (i % 11))
        tel.set_queue_depth(i % 3)
        tel.request_completed(latency_s=0.005 + 0.0002 * (i % 13), queue_wait_s=0.001,
                              t0=t0, error=None, dispatch_wait_s=0.0015,
                              request_id=f"r{i}")
        clk.advance(0.01)
    tel.request_rejected(mod.QueueFull("full"), "q1")
    tel.request_rejected(mod.Draining("bye"), "d1")
    tel.request_completed(latency_s=1.0, queue_wait_s=None, t0=tel.now(),
                          error=mod.DeadlineExceeded("late"), request_id="late")
    tel.request_rejected(mod.RequestTooLarge("big"))
    tel.conditional_hit()
    tel.swap_completed(stage_s=0.25, flip_s=0.001, t0=tel.now(), generation=40)
    tel.swap_completed(stage_s=0.0, flip_s=0.0005, t0=tel.now(), generation=None,
                       rollback=True)
    for i in range(70):
        tel.consider_exemplar(request_id=f"x{i}", latency_s=0.001 * i,
                              stages={"device": 0.001, "serialize": None}, B=4, T=16)
    clk.advance(5.0)


def test_telemetry_snapshot_trace_and_exposition_equal_jax_on_a_fake_clock():
    snaps, traces, exemplars = [], [], []
    for cls in (JTelemetry, ServingTelemetry):
        clk = FakeClock()
        tel = cls(clock=clk.now, slo_window_s=10.0)
        _drive(tel, clk)
        snap = tel.snapshot()
        assert isinstance(snap.pop("process"), dict)
        snaps.append(snap)
        trace = tel.trace.payload()
        traces.append([{k: v for k, v in e.items() if k != "tid"}
                       for e in trace["traceEvents"] if e["ph"] != "M"])
        exemplars.append(tel.exemplars())
    assert snaps[1] == snaps[0]
    assert traces[1] == traces[0]
    assert exemplars[1] == exemplars[0] and exemplars[0]["count"] > 0
    assert set(snaps[0]) == {"counters", "gauges", "histograms", "slo", "slo_window"}
    assert snaps[0]["counters"]["swaps"] == 2 and snaps[0]["counters"]["rollbacks"] == 1
    assert p_render(snaps[1], prefix="srt_serving") == j_render(snaps[0], prefix="srt_serving")


def test_exemplar_ring_catches_p99_outliers_and_stays_bounded():
    tel = ServingTelemetry(clock=lambda: 0.0, exemplar_capacity=4)
    assert not tel.consider_exemplar(request_id="early", latency_s=99.0, stages={})
    for _ in range(200):
        tel.request_completed(latency_s=0.010, queue_wait_s=0.001, t0=None, error=None)
    for _ in range(2):  # past the refresh cadence: the threshold is learned
        assert not tel.consider_exemplar(request_id="fast", latency_s=0.010, stages={})
    assert tel.consider_exemplar(
        request_id="slow-0", latency_s=0.5,
        stages={"queue_wait": 0.4, "dispatch_wait": 0.45, "device": 0.04, "serialize": 0.001},
        n_docs=2, B=2, T=16, generation=None)
    payload = tel.exemplars()
    assert payload["count"] == 1 and payload["exemplars"][0]["stages"]["queue_wait"] == 0.4
    for i in range(1, 10):
        tel.consider_exemplar(request_id=f"slow-{i}", latency_s=1.0, stages={})
    payload = tel.exemplars()
    assert payload["count"] == 4
    assert [e["request_id"] for e in payload["exemplars"]] == [f"slow-{i}" for i in range(6, 10)]
    assert tel.snapshot()["counters"]["slow_exemplars"] == 10


def _post(port, body, path="/v1/parse"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


@pytest.fixture(scope="module")
def dense_gens(tmp_path_factory):
    """A small trf + tagger model directory and a checkpoint directory with
    two generations of its tree: stamp 10 (the model's own parameters) and
    stamp 20 (drawn from another seed, with the same labels)."""
    root = tmp_path_factory.mktemp("dense")
    cfg = P.Config.from_str(TRF_TAGGER_CFG).interpolate()
    flats = []
    for seed in (0, 1):
        nlp = P.Pipeline.from_config(cfg, device="cpu")
        nlp.initialize(labels={"tagger": sorted(TAGS)}, seed=seed)
        if seed == 0:
            nlp.to_disk(root / "model")
        flats.append({k: v.numpy().copy() for k, v in flatten(nlp.params).items()})
    ckpt = root / "last-model"
    for stamp, flat in zip((10, 20), flats):
        TrainCheckpoint.save(ckpt, params=flat, opt_state={"mu": {}, "nu": {}, "count": 0,
                                                           "sched_count": 0},
                             step=stamp, epoch=0, best_score=0.0, best_step=0)
    return root / "model", ckpt, flats


def _served(nlp_dir, **kw):
    nlp = P.Pipeline.from_disk(nlp_dir, device="cpu")
    tel = kw.pop("telemetry", None)
    engine = InferenceEngine(nlp, max_batch_docs=4, max_doc_len=16, timeout_s=30.0,
                             telemetry=tel)
    engine.start()
    return engine


def _truth(model_dir, flat, texts):
    """Tags of a fresh pipeline loaded with ``flat``, one text at a time."""
    nlp = P.Pipeline.from_disk(model_dir, device="cpu")
    nlp.load_params(flat)
    return {t: nlp(t).tags for t in texts}


def test_swap_under_concurrent_load_answers_the_stamped_generation(dense_gens):
    model_dir, ckpt, flats = dense_gens
    truth = {None: _truth(model_dir, flats[0], TEXTS), 20: _truth(model_dir, flats[1], TEXTS)}
    assert truth[None] != truth[20]
    tel = ServingTelemetry()
    engine = _served(model_dir, telemetry=tel)
    server = Server(engine, port=0, telemetry=tel)
    _, port = server.start()
    results, lock, stop = [], threading.Lock(), threading.Event()

    def client(k):
        i = 0
        while not stop.is_set():
            text = TEXTS[(k + i) % len(TEXTS)]
            status, body = _post(port, {"texts": [text]})
            with lock:
                results.append((text, status, json.loads(body)))
            i += 1

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and len(results) < 12:
            time.sleep(0.01)
        state = Checkpoints(ckpt).load_generation_params(20)
        out = engine.swap_params(state["params"], 20)
        assert out["generation"] == 20 and out["previous_generation"] is None
        while time.monotonic() < deadline and sum(
                1 for _, _, p in list(results) if p["batch"]["generation"] == 20) < 12:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        server.request_shutdown()
        assert server.wait() == 0
    assert all(s == 200 for _, s, _ in results)
    assert {p["batch"]["generation"] for _, _, p in results} == {None, 20}
    for text, _, payload in results:
        assert payload["docs"][0]["tags"] == truth[payload["batch"]["generation"]][text]
    snap = tel.snapshot()
    assert snap["counters"]["swaps"] == 1 and snap["gauges"]["serving_generation"] == 20.0
    assert snap["counters"]["requests"] == len(results)


def test_refusals_keep_the_old_generation_serving(dense_gens, tmp_path):
    model_dir, ckpt, flats = dense_gens
    engine = _served(model_dir)
    try:
        before = engine.submit_texts(TEXTS[:2])
        before = [d.tags for d in before.docs]
        with pytest.raises(SwapFailed, match="no previous resident"):
            engine.rollback()
        bad = dict(flats[1])
        bad.pop(next(iter(bad)))
        bad["extra/leaf"] = np.zeros(3, np.float32)
        with pytest.raises(SwapFailed, match="does not match the resident"):
            engine.swap_params(bad, 99)
        reshaped = {k: (v[:1] if k.endswith("tagger/1_output/b") else v)
                    for k, v in flats[1].items()}
        with pytest.raises(SwapFailed, match="reshaped"):
            engine.swap_params(reshaped, 99)
        assert engine.serving_generation is None and engine.swap_count == 0
        after = engine.submit_texts(TEXTS[:2])
        assert [d.tags for d in after.docs] == before
        assert after.batch_info["generation"] is None
    finally:
        engine.stop()


def _server(model_dir, swap_dirs, telemetry=True, **kw):
    nlp = P.Pipeline.from_disk(model_dir, device="cpu")
    tel = ServingTelemetry() if telemetry else None
    engine = InferenceEngine(nlp, max_batch_docs=4, max_doc_len=32, telemetry=tel, **kw)
    server = Server(engine, port=0, telemetry=tel, swap_dirs=swap_dirs)
    _, port = server.start()
    engine.start()
    return server, port


def test_admin_swap_and_rollback_over_http_with_the_allowlist(dense_gens, tmp_path):
    model_dir, ckpt, flats = dense_gens
    closed, cport = _server(model_dir, [])
    server, port = _server(model_dir, [str(ckpt)])
    try:
        for path in ("/admin/swap", "/admin/rollback"):
            status, body = _post(cport, {"dir": str(ckpt)}, path)
            assert status == 403 and json.loads(body)["error"] == "forbidden"
        status, body = _post(port, {"dir": str(tmp_path)}, "/admin/swap")
        assert status == 403
        status, body = _post(port, {"dir": str(ckpt / ".." / "last-model")}, "/admin/swap")
        result = json.loads(body)
        assert status == 200 and result["generation"] == 20  # the newest by default
        assert result["flip_s"] >= 0 and result["stage_s"] > 0
        status, body = _post(port, {"texts": TEXTS[:3]})
        swapped = json.loads(body)
        assert swapped["batch"]["generation"] == 20
        want = _truth(model_dir, flats[1], TEXTS[:3])
        assert [d["tags"] for d in swapped["docs"]] == [want[t] for t in TEXTS[:3]]
        status, body = _post(port, {"dir": str(ckpt), "generation": 10}, "/admin/swap")
        assert status == 200 and json.loads(body)["previous_generation"] == 20
        status, body = _post(port, b"", "/admin/rollback")
        assert status == 200 and json.loads(body)["generation"] == 20
        status, body = _post(port, {"texts": TEXTS[:3]})
        assert body == json.dumps(swapped).encode()  # byte-identical after rollback
        health = json.loads(_get(port, "/healthz")[1])
        assert health["generation"] == 20 and health["swap_count"] == 3
        status, body = _post(port, {"dir": str(ckpt), "generation": "x"}, "/admin/swap")
        assert status == 400
    finally:
        for s in (closed, server):
            s.request_shutdown()
            assert s.wait() == 0


def test_a_torn_generation_is_refused_409_and_serving_goes_on(dense_gens, tmp_path):
    model_dir, ckpt, _ = dense_gens
    torn = tmp_path / "torn"
    torn.mkdir()
    for f in ckpt.iterdir():
        (torn / f.name).write_bytes(f.read_bytes())
    data = bytearray((torn / "params-20.npz").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (torn / "params-20.npz").write_bytes(bytes(data))
    assert Checkpoints(torn).latest_intact_generation() == 10
    server, port = _server(model_dir, [str(torn)])
    try:
        status, body = _post(port, {"dir": str(torn), "generation": 20}, "/admin/swap")
        payload = json.loads(body)
        assert status == 409 and payload["error"] == "swap_failed"
        assert "digest mismatch" in payload["message"]
        status, body = _post(port, {"dir": str(torn), "generation": 30}, "/admin/swap")
        assert status == 409  # no such generation: its meta is missing
        status, body = _post(port, {"texts": TEXTS[:1]})
        assert status == 200 and json.loads(body)["batch"]["generation"] is None
        status, body = _post(port, {"dir": str(torn)}, "/admin/swap")  # falls back to 10
        assert status == 200 and json.loads(body)["generation"] == 10
    finally:
        server.request_shutdown()
        assert server.wait() == 0


def test_metrics_trace_and_exemplars_over_http(dense_gens):
    model_dir, ckpt, _ = dense_gens
    server, port = _server(model_dir, [str(ckpt)])
    off, off_port = _server(model_dir, [], telemetry=False)
    try:
        for t in TEXTS:
            assert _post(port, {"texts": [t]})[0] == 200
        assert _post(port, {"texts": ["x " * 40]})[0] == 413
        status, body, ctype = _get(port, "/metrics")
        snap = json.loads(body)
        assert status == 200 and ctype == "application/json"
        assert set(snap) >= {"counters", "gauges", "histograms", "slo", "slo_window",
                             "process", "generation", "swap_count"}
        assert snap["counters"]["requests"] == len(TEXTS) and snap["counters"]["errors"] == 1
        assert snap["counters"]["batches"] == len(TEXTS)
        assert snap["histograms"]["request_latency_seconds"]["count"] == len(TEXTS)
        status, body, ctype = _get(port, "/metrics?format=prometheus")
        text = body.decode()
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        families = {}
        for line in text.splitlines():
            if line.startswith("# TYPE"):
                _, _, name, kind = line.split()
                families[name] = kind
            elif line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                float(value)
        assert families["srt_serving_requests_total"] == "counter"
        assert families["srt_serving_request_latency_seconds"] == "histogram"
        assert "srt_serving_swap_count" in families
        status, body, _ = _get(port, "/trace")
        trace = json.loads(body)
        spans = [e for e in trace["traceEvents"] if e.get("name") == "serve_batch"]
        assert len(spans) == len(TEXTS) and all(e["ph"] == "X" for e in spans)
        assert trace["role"] == "replica" and "anchor" in trace
        status, body, _ = _get(port, "/admin/exemplars")
        assert status == 200 and set(json.loads(body)) == {"threshold_s", "count", "exemplars"}
        # a Server given no alert engine answers JAX's disabled form
        status, body, _ = _get(port, "/admin/alerts")
        assert status == 200 and json.loads(body) == {"alerts": "disabled"}
        # telemetry off: the disabled forms
        off_snap = json.loads(_get(off_port, "/metrics")[1])
        assert off_snap == {"telemetry": "disabled", "generation": None, "swap_count": 0}
        assert _get(off_port, "/metrics?format=prometheus")[1] == b"# srt telemetry disabled\n"
        assert json.loads(_get(off_port, "/trace")[1]) == {"trace": "disabled"}
        assert json.loads(_get(off_port, "/admin/exemplars")[1]) == {"exemplars": "disabled"}
    finally:
        for s in (server, off):
            s.request_shutdown()
            assert s.wait() == 0


def test_disabled_telemetry_makes_zero_calls(dense_gens, monkeypatch):
    model_dir, _, _ = dense_gens

    def boom(*a, **k):
        raise AssertionError("telemetry constructed on the disabled path")

    from spacy_ray_tpu_torch.training import hoststats

    for cls in (ptelemetry.MetricsRegistry, ptelemetry.TraceBuffer, hoststats.ProcessSampler):
        monkeypatch.setattr(cls, "__init__", boom)
    for name in ("request_admitted", "request_completed", "batch_span", "request_rejected",
                 "swap_completed", "consider_exemplar"):
        monkeypatch.setattr(ServingTelemetry, name, boom)
    server, port = _server(model_dir, [], telemetry=False)
    try:
        assert _post(port, {"texts": TEXTS[:2]})[0] == 200
        assert _post(port, {"texts": ["x " * 40]})[0] == 413
        body = _get(port, "/metrics?format=prometheus")[1]
        assert b"srt_process" not in body
    finally:
        server.request_shutdown()
        assert server.wait() == 0


def test_moe_swap_and_rollback_give_a_fresh_engines_bytes(tmp_path):
    """The JAX-written switch-MoE fixture, one request at a time: after a
    swap every response is byte-identical to a fresh engine loaded with
    that generation, and after the rollback to the first responses."""
    base = P.Pipeline.from_disk(JAX_MOE, device="cpu")
    flat_a = {k: v.numpy().copy() for k, v in flatten(base.params).items()}
    rng = np.random.default_rng(0)
    flat_b = {k: (v + rng.normal(0, 0.5 * (v.std() + 1e-2), v.shape)).astype(np.float32)
              for k, v in flat_a.items()}
    ckpt = tmp_path / "last-model"
    TrainCheckpoint.save(ckpt, params=flat_b, opt_state={"mu": {}, "nu": {}, "count": 0,
                                                         "sched_count": 0},
                         step=7, epoch=0, best_score=0.0, best_step=0)
    texts = json.loads((JAX_MOE / "answers.json").read_text())["texts"][:6]

    def answers(server_port):
        out = []
        for t in texts:
            status, body = _post(server_port, {"texts": [t]})
            assert status == 200
            out.append(json.loads(body))
        return out

    def strip(payloads):
        return [json.dumps({"docs": p["docs"], "batch": {**p["batch"], "generation": None}})
                for p in payloads]

    server, port = _server(JAX_MOE, [str(ckpt)], max_queue_docs=16)
    nlp_b = P.Pipeline.from_disk(JAX_MOE, device="cpu")
    nlp_b.load_params(flat_b)
    fresh = Server(InferenceEngine(nlp_b, max_batch_docs=4, max_doc_len=32), port=0)
    _, fport = fresh.start()
    fresh.engine.start()
    try:
        first = answers(port)
        assert _post(port, {"dir": str(ckpt)}, "/admin/swap")[0] == 200
        swapped = answers(port)
        assert all(p["batch"]["generation"] == 7 for p in swapped)
        assert strip(swapped) == strip(answers(fport))
        assert strip(swapped) != strip(first)
        assert _post(port, {}, "/admin/rollback")[0] == 200
        assert answers(port) == first
    finally:
        for s in (server, fresh):
            s.request_shutdown()
            assert s.wait() == 0


def test_checkpoints_reads_generations_of_both_packages_bit_equal(dense_gens, tmp_path):
    _, ckpt, flats = dense_gens
    jdir = tmp_path / "jax_ckpt"
    nested = {}
    for k, v in flats[1].items():
        node = nested
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    jckpt.TrainCheckpoint.save(jdir, params=nested, opt_state={"count": np.zeros(())},
                               step=30, epoch=1, rng=np.zeros(2, np.uint32), best_score=0.5,
                               best_step=30)
    got = Checkpoints(jdir)
    assert got.generations() == [30] and got.latest_intact_generation() == 30
    state = got.load_generation_params(30)
    assert state["step"] == 30 and set(state["params"]) == set(flats[1])
    assert all(np.array_equal(state["params"][k], v) for k, v in flats[1].items())
    # and the JAX reader on the port's generations
    jview = jckpt.Checkpoints(ckpt)
    assert jview.generations() == Checkpoints(ckpt).generations() == [10, 20]
    jflat = jckpt._flatten(jview.load_generation_params(20)["params"])
    assert all(np.array_equal(np.asarray(jflat[k]), v) for k, v in flats[1].items())
    with pytest.raises(CheckpointCorrupt):
        Checkpoints(jdir).load_generation_params(31)
