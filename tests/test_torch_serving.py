"""The port's serving stack on the CPU: continuous batcher units, the
engine, and the HTTP server held against the JAX server's response shape on
the same small transformer + tagger model directory."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import spacy_ray_tpu as J
from spacy_ray_tpu.serving.engine import InferenceEngine as JEngine
from spacy_ray_tpu.serving.server import Server as JServer

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.serving.batcher import (
    DeadlineExceeded, Draining, DynamicBatcher, QueueFull, RequestTooLarge, ServeRequest,
)
from spacy_ray_tpu_torch.serving.engine import InferenceEngine, warmup_buckets
from spacy_ray_tpu_torch.serving.server import Server

from test_torch_pipeline import TAGS, TRF_TAGGER_CFG, _gold

REPO = Path(__file__).resolve().parent.parent
TEXTS = ["the cat runs fast", "Paris is big .", "hi"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    nlp = J.Pipeline.from_config(J.Config.from_str(TRF_TAGGER_CFG).interpolate())
    egs = _gold()
    nlp.initialize(lambda: egs, seed=1)
    path = tmp_path_factory.mktemp("serve_model")
    nlp.to_disk(path)
    return path


def _post(port, body, path="/v1/parse"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(port, path="/healthz"):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def port_server(model_dir):
    nlp = P.Pipeline.from_disk(model_dir, device="cpu")
    engine = InferenceEngine(nlp, max_batch_docs=4, max_doc_len=32)
    server = Server(engine, port=0)
    _, port = server.start()
    engine.start()
    yield server, port
    server.request_shutdown()
    server.wait()


def test_parse_and_healthz_have_the_jax_servers_shape(model_dir, port_server):
    _, port = port_server
    jnlp = J.Pipeline.from_disk(model_dir)
    jengine = JEngine(jnlp, max_batch_docs=4, max_doc_len=32)
    jserver = JServer(jengine, port=0)
    _, jport = jserver.start()
    jengine.start()
    try:
        js, jbody, _ = _post(jport, {"texts": TEXTS})
        ps, pbody, _ = _post(port, {"texts": TEXTS})
        assert js == ps == 200
        assert set(pbody) == set(jbody) == {"docs", "batch"}
        assert pbody["batch"] == jbody["batch"]  # occupancy, B, T, generation
        assert pbody["docs"] == jbody["docs"]  # tokens, spaces and the same tags
        assert all(len(d["tags"]) == len(d["tokens"]) for d in pbody["docs"])

        jh, ph = _get(jport)[1], _get(port)[1]
        shared = {"status", "pipeline", "warmed_buckets", "max_batch_docs",
                  "max_doc_len", "batching", "precision"}
        assert shared <= set(jh) and shared <= set(ph)
        assert {k: ph[k] for k in shared} == {k: jh[k] for k in shared}
        assert ph["device"] == "cpu"
        assert set(ph["kernel_launches"]) == {
            "hash_embed_gather_sum", "flash_attention_fwd", "int8_weight_matmul",
            "hash_embed_table_grad", "flash_attention_bwd", "fused_update"}
    finally:
        jserver.request_shutdown()
        jserver.wait()


def test_typed_errors_map_to_statuses(port_server):
    _, port = port_server
    assert _post(port, {"texts": ["a"] * 5})[0] == 413  # > max_batch_docs
    assert _post(port, {"texts": [" ".join(["w"] * 40)]})[0] == 413  # > max_doc_len
    assert _post(port, b"not json")[0] == 400
    assert _post(port, {"texts": []})[0] == 400
    assert _post(port, {"texts": ["a"]}, path="/v2/nope")[0] == 404
    # /metrics exists since the serving telemetry; this server has none
    assert _get(port, "/metrics") == (200, {"telemetry": "disabled", "generation": None,
                                            "swap_count": 0})
    # no alert engine without telemetry: JAX's disabled answer
    assert _get(port, "/admin/alerts") == (200, {"alerts": "disabled"})
    status, _, headers = _post(port, {"texts": ["a b"]})
    assert status == 200 and "X-SRT-Request-Id" in headers


def test_concurrent_requests_equal_single_predict(model_dir, port_server):
    _, port = port_server
    nlp = P.Pipeline.from_disk(model_dir, device="cpu")
    texts = [f"word{i} " * (1 + i % 7) + "." for i in range(16)]
    want = {t: nlp(t).tags for t in texts}
    got, errors = {}, []

    def client(ts):
        for t in ts:
            status, body, _ = _post(port, {"texts": [t]})
            if status != 200:
                errors.append(body)
            got[t] = body["docs"][0]["tags"]

    threads = [threading.Thread(target=client, args=(texts[i::4],)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors and got == want


def test_engine_drains_and_rejects_after(model_dir):
    nlp = P.Pipeline.from_disk(model_dir, device="cpu")
    engine = InferenceEngine(nlp, max_batch_docs=2, max_doc_len=16)
    assert engine.overlay.resolved == "f32"
    engine.start(warmup=False)
    req = engine.submit_texts(["a b c"])
    assert req.batch_info == {"occupancy": 1, "B": 1, "T": 16, "generation": None}
    assert req.docs[0].tags and all(t in TAGS for t in req.docs[0].tags)
    assert engine.drain(timeout_s=5.0)
    with pytest.raises(Draining):
        engine.submit_texts(["a"])


def test_warmup_grid_covers_admissible_shapes():
    assert warmup_buckets(8, 128) == [(b, t) for b in (1, 2, 4, 8) for t in (16, 32, 64, 128)]
    assert (1, 1024) in warmup_buckets(1, 1000)  # multiples of the top bucket


def test_batcher_continuous_admission():
    now = [0.0]
    b = DynamicBatcher(max_queue_docs=4, max_batch_docs=3, clock=lambda: now[0])
    reqs = [ServeRequest([1, 2], deadline=10, enqueued_at=0),
            ServeRequest([1], deadline=10, enqueued_at=0),
            ServeRequest([1], deadline=0.5, enqueued_at=0)]
    for r in reqs[:2]:
        b.submit(r)
    with pytest.raises(QueueFull):
        b.submit(ServeRequest([1, 2], deadline=10, enqueued_at=0))
    with pytest.raises(RequestTooLarge):
        b.submit(ServeRequest([1] * 4, deadline=10, enqueued_at=0))
    assert b.next_batch() == reqs[:2]  # whole requests, dispatched at once
    b.submit(reqs[2])
    now[0] = 1.0
    assert b.next_batch() == []  # expired before dispatch
    assert isinstance(reqs[2].error, DeadlineExceeded)
    b.close()
    assert b.next_batch() is None
    with pytest.raises(Draining):
        b.submit(ServeRequest([1], deadline=10, enqueued_at=0))


def test_serve_cli_on_cpu_answers_and_drains_on_sigterm(model_dir):
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve", str(model_dir),
         "--device", "cpu", "--port", "0", "--max-batch", "2", "--max-doc-len", "16"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "ready" in line:
                break
        port = int([l for l in lines if l.startswith("serving on")][0].rsplit(":", 1)[1])
        status, body, _ = _post(port, {"texts": ["the cat"]})
        assert status == 200 and len(body["docs"][0]["tags"]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
