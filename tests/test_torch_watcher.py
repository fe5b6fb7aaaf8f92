"""The port's checkpoint watcher against the JAX package's: the stdlib scan
of intact generations over directories written by either package's
``TrainCheckpoint``, a torn generation skipped with one event, the newest
generation delivered once, a failed subscriber retried, and ``serve
--watch`` on the CPU answering each generation as a fresh engine of it
does."""

import json
import time
import urllib.request

import numpy as np
import pytest

from spacy_ray_tpu.serving.live.watcher import CheckpointWatcher as JWatcher
from spacy_ray_tpu.serving.live.watcher import scan_intact_generations as j_scan
from spacy_ray_tpu.training import resilience as JR
from spacy_ray_tpu.training.checkpoint import TrainCheckpoint as JCheckpoint

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.__main__ import build_server
from spacy_ray_tpu_torch.serving.live import CheckpointWatcher, scan_intact_generations
from spacy_ray_tpu_torch.training import resilience as PR
from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint, flatten

from test_torch_pipeline import TAGS, TRF_TAGGER_CFG

TINY = {"w": {"kernel": np.ones((2, 2), np.float32)}}
PORT_OPT = {"mu": {}, "nu": {}, "count": 0, "sched_count": 0}
TEXTS = ["the cat runs fast", "Paris is big .", "hi there", "a dog sleeps"]


def _jax_gen(path, stamp, params=TINY, keep=8):
    JCheckpoint.save(path, params=params, opt_state={"note": np.zeros(1, np.float32)},
                     step=stamp, epoch=0, rng=np.zeros(2, np.uint32), best_score=0.0,
                     best_step=0, keep=keep)


def _port_gen(path, stamp, params=TINY, keep=8):
    TrainCheckpoint.save(path, params=flatten(params) if "w" in params else params,
                         opt_state=PORT_OPT, step=stamp, epoch=0, best_score=0.0,
                         best_step=0, keep=keep)


def _scans(path):
    calls = [{}, {"params_only": True}, {"newer_than": 5}, {"newer_than": 5, "skip": {15}},
             {"newer_than": 15}, {"skip": {5}, "params_only": True}]
    return [(scan_intact_generations(path, **kw), j_scan(path, **kw)) for kw in calls]


def test_scan_of_jax_written_generations_equals_jaxs(tmp_path):
    for stamp in (5, 15, 25):
        _jax_gen(tmp_path, stamp)
    (tmp_path / "opt_state-15.pkl").write_bytes(b"torn")
    torn = tmp_path / "params-25.npz"
    torn.write_bytes(torn.read_bytes()[:-7])
    (tmp_path / "train_meta-99.json").write_text("{not json", encoding="utf8")
    (tmp_path / "train_meta-x.json").write_text("{}", encoding="utf8")
    scans = _scans(tmp_path)
    assert all(got == want for got, want in scans)
    assert scans[0][0] == [5] and scans[1][0] == [5, 15]
    assert scan_intact_generations(tmp_path / "nope") == j_scan(tmp_path / "nope") == []


def test_scan_of_port_written_generations(tmp_path):
    for stamp in (5, 15):
        _port_gen(tmp_path, stamp)
    # params only (what a swap reads): the same as JAX's scan
    assert scan_intact_generations(tmp_path, params_only=True) == \
        j_scan(tmp_path, params_only=True) == [5, 15]
    # with the optimizer state: the port checks its own opt_state-N.npz (the
    # JAX scan looks for its pickle, absent here, and finds nothing)
    assert scan_intact_generations(tmp_path) == [5, 15]
    assert j_scan(tmp_path) == []
    (tmp_path / "opt_state-15.npz").write_bytes(b"torn")
    assert scan_intact_generations(tmp_path) == [5]
    assert scan_intact_generations(tmp_path, params_only=True) == [5, 15]


def _torn_run(watcher_cls, drain, tmp_path, write):
    write(tmp_path, 10)
    write(tmp_path, 20)
    torn = tmp_path / "params-20.npz"
    torn.write_bytes(torn.read_bytes()[:-7])
    drain()
    got = []
    w = watcher_cls(tmp_path, lambda s, st: got.append((s, int(st["step"]))))
    out = [w.poll_once(), w.poll_once(), w.poll_once()]
    events = [(e["event"], e["stamp"]) for e in drain()]
    write(tmp_path, 30)
    out.append(w.poll_once())
    return out, got, events, (w.polls, w.delivered, w.skipped, w.current)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_torn_generation_is_skipped_with_one_event_as_jax(writer, tmp_path):
    write = _jax_gen if writer == "jax" else _port_gen
    got = _torn_run(CheckpointWatcher, PR.drain_events, tmp_path / "p", write)
    want = _torn_run(JWatcher, JR.drain_events, tmp_path / "j", write)
    assert got == want
    assert got[0] == [10, None, None, 30]
    assert got[2] == [("live-generation-skipped", 20), ("live-generation", 10)]


def test_the_newest_generation_is_delivered_once(tmp_path):
    got = []
    w = CheckpointWatcher(tmp_path, lambda s, st: got.append((s, st["step"])))
    assert w.poll_once() is None
    _port_gen(tmp_path, 10)
    _jax_gen(tmp_path, 20)  # either package's generations in one directory
    assert w.poll_once() == 20
    assert w.poll_once() is None
    _port_gen(tmp_path, 30)
    assert w.poll_once() == 30
    assert got == [(20, 20), (30, 30)] and w.delivered == 2 and w.current == 30


def test_a_failed_subscriber_gets_the_generation_again(tmp_path):
    calls = []

    def flaky(stamp, state):
        calls.append(stamp)
        if len(calls) == 1:
            raise RuntimeError("device hiccup")

    _port_gen(tmp_path, 10)
    w = CheckpointWatcher(tmp_path, flaky, interval_s=0.01)
    with pytest.raises(RuntimeError):
        w.poll_once()
    assert w.current is None and w.delivered == 0
    assert w.poll_once() == 10 and calls == [10, 10]
    # the thread loop survives a failing subscriber
    w2 = CheckpointWatcher(tmp_path, lambda s, st: 1 / 0, interval_s=0.01).start()
    time.sleep(0.1)
    assert w2.polls >= 2 and w2._thread.is_alive()
    w2.stop()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A small trf + tagger model directory and three parameter sets of its
    tree (seeds 0, 1, 2)."""
    root = tmp_path_factory.mktemp("watch")
    cfg = P.Config.from_str(TRF_TAGGER_CFG).interpolate()
    flats = []
    for seed in (0, 1, 2):
        nlp = P.Pipeline.from_config(cfg, device="cpu")
        nlp.initialize(labels={"tagger": sorted(TAGS)}, seed=seed)
        if seed == 0:
            nlp.to_disk(root / "model")
        flats.append({k: v.numpy().copy() for k, v in flatten(nlp.params).items()})
    return root / "model", flats


def _fresh(model_dir, flat):
    """Each text's doc from a fresh engine of ``flat`` (one text a request)."""
    from spacy_ray_tpu_torch.pipeline.doc import doc_to_json
    from spacy_ray_tpu_torch.serving.engine import InferenceEngine

    nlp = P.Pipeline.from_disk(model_dir, device="cpu")
    nlp.load_params(flat)
    engine = InferenceEngine(nlp, max_batch_docs=4, max_doc_len=16).start()
    try:
        return {t: [doc_to_json(d) for d in engine.submit_texts([t]).docs] for t in TEXTS}
    finally:
        engine.stop()


def _post(port, texts):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/parse",
                                 data=json.dumps({"texts": texts}).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read()), dict(r.headers)


def _generation(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        return json.loads(r.read())["generation"]


def _wait_for(port, stamp, timeout=20.0):
    end = time.monotonic() + timeout
    while _generation(port) != stamp:
        assert time.monotonic() < end, f"generation {stamp} never served"
        time.sleep(0.02)


def test_serve_watch_answers_each_generation_as_a_fresh_engine(trained, tmp_path):
    model_dir, flats = trained
    ckpt = tmp_path / "last-model"
    server = build_server([str(model_dir), "--device", "cpu", "--port", "0", "--max-batch",
                           "4", "--max-doc-len", "16", "--watch", str(ckpt),
                           "--watch-interval-s", "0.05"])
    assert server.httpd.allowed_swap_dirs == [str(ckpt)]
    _, port = server.start()
    server.engine.start()
    server.start_watcher()
    served = {}
    try:
        served[None] = {t: _post(port, [t]) for t in TEXTS}
        for stamp, flat in ((10, flats[1]), (20, flats[2])):
            _port_gen(ckpt, stamp, params=flat)
            _wait_for(port, stamp)
            served[stamp] = {t: _post(port, [t]) for t in TEXTS}
        # a torn, newer generation is never served
        _port_gen(ckpt, 30, params=flats[1])
        torn = ckpt / "params-30.npz"
        torn.write_bytes(torn.read_bytes()[: torn.stat().st_size // 2])
        time.sleep(0.3)
        assert _generation(port) == 20
        assert server.watcher.skipped >= 1 and server.watcher.current == 20
    finally:
        server.request_shutdown()
        assert server.wait() == 0
    assert not server.watcher._thread
    for stamp, flat in ((None, flats[0]), (10, flats[1]), (20, flats[2])):
        want = _fresh(model_dir, flat)
        for t in TEXTS:
            body, headers = served[stamp][t]
            assert body["batch"]["generation"] == stamp
            assert body["docs"] == want[t]
    tags = [[served[s][t][0]["docs"][0]["tags"] for t in TEXTS] for s in (None, 10, 20)]
    assert tags[0] != tags[1] != tags[2]
    etags = {s: served[s][TEXTS[0]][1]["ETag"] for s in (None, 10, 20)}
    assert len(set(etags.values())) == 3  # a new generation, a new ETag
