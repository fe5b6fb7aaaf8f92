"""Several serving engines on one card: a model loaded (its decode graphs
captured) while another engine's dispatch serves a client loop, load and
evict cycles that give the memory back, and a per-model hot-swap served
through the model's replayed graphs.

Every test here needs an NVIDIA card, carries the ``cuda`` marker and skips
without one. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_serving.py
"""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import spacy_ray_tpu_torch as P

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
TEXTS = json.loads((DATA / "jax_moe" / "answers.json").read_text(encoding="utf8"))["texts"]
MEMORY_DRIFT_BYTES = 64 << 20  # chip_smoke.py's serve:multimodel bound


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs and the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _engine(path, **kw):
    from spacy_ray_tpu_torch.serving.engine import InferenceEngine

    return InferenceEngine(P.Pipeline.from_disk(path, device="cuda"), max_batch_docs=4,
                           max_doc_len=32, **kw)


def _answers(engine, texts=TEXTS):
    from spacy_ray_tpu_torch.pipeline.doc import doc_to_json

    return [json.dumps([doc_to_json(d) for d in engine.submit_texts([t]).docs])
            for t in texts]


@pytest.mark.cuda
def test_a_model_loads_and_captures_while_another_engine_serves():
    from spacy_ray_tpu_torch.devices import DEVICE_GATE

    _card()
    serving = _engine(DATA / "jax_md").start()
    want = _answers(serving)
    errors, done, stop = [], [], threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            try:
                got = _answers(serving, [TEXTS[i % len(TEXTS)]])
                if got != [want[i % len(TEXTS)]]:
                    errors.append(("differs", i))
            except Exception as e:  # noqa: BLE001 - counted, then asserted on
                errors.append(repr(e))
            done.append(i)
            i += 1

    threads = [threading.Thread(target=client) for _ in range(2)]
    for th in threads:
        th.start()
    before = (DEVICE_GATE.exclusive_acquisitions, DEVICE_GATE.contended)
    loaded = []
    try:
        for _ in range(2):
            eng = _engine(DATA / "jax_moe").start()
            assert len(eng.nlp.decode_graphs) > 0
            loaded.append(_answers(eng))
            eng.release()
    finally:
        stop.set()
        for th in threads:
            th.join()
        serving.stop()
    assert not errors and len(done) > 0
    assert loaded[0] == loaded[1]
    assert DEVICE_GATE.exclusive_acquisitions > before[0]
    print({"captures": DEVICE_GATE.exclusive_acquisitions - before[0],
           "contended": DEVICE_GATE.contended - before[1], "requests": len(done)})


def _param_bytes(engine) -> int:
    seen, total = set(), 0
    for t in engine._live.values():
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


@pytest.mark.cuda
def test_five_load_and_evict_cycles_give_the_memory_back():
    from spacy_ray_tpu_torch.serving.multimodel import ModelRegistry, ModelSpec, ResidencyManager

    _card()
    reg = ModelRegistry({n: ModelSpec(n, str(DATA / f"jax_{n}")) for n in ("moe", "md", "nel")},
                        "moe")
    evicted = []

    def factory(spec):
        return _engine(spec.path).start()

    res = ResidencyManager(reg, factory, capacity=2, pinned={"moe"})
    retire = res._retire

    def watched(name, engine):
        size = _param_bytes(engine)
        retire(name, engine)
        evicted.append((name, size, engine.released_bytes, engine.allocated_after_release))

    res._retire = watched
    res.adopt("moe", factory(reg.spec("moe")))
    for i in range(11):  # md, nel, md, ...: ten evictions, five of each
        eng = res.engine_for("md" if i % 2 == 0 else "nel")
        _answers(eng, TEXTS[:2])
    res.stop_all(10.0)
    assert len(evicted) == 10
    for name, size, freed, _ in evicted:
        assert freed >= 0.9 * size, (name, size, freed)
    after = [a for _, _, _, a in evicted]
    assert abs(after[-1] - after[1]) <= MEMORY_DRIFT_BYTES, after  # both evict nel


@pytest.mark.cuda
def test_a_per_model_swap_serves_the_new_generation_through_its_graphs(tmp_path):
    import urllib.request

    from spacy_ray_tpu_torch.__main__ import build_server
    from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint, flatten

    _card()
    nlp = P.Pipeline.from_disk(DATA / "jax_moe", device="cpu")
    rng = np.random.default_rng(0)
    flat_b = {k: (v.numpy() + rng.normal(0, 0.5 * (float(v.std()) + 1e-2), v.shape)
                  ).astype(np.float32) for k, v in flatten(nlp.params).items()}
    ckpt = tmp_path / "last-model"
    TrainCheckpoint.save(ckpt, params=flat_b, opt_state={"mu": {}, "nu": {}, "count": 0,
                                                         "sched_count": 0},
                         step=7, epoch=0, best_score=0.0, best_step=0)
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"default_model": "md", "models": {
        "md": {"path": str(DATA / "jax_md")}, "moe": {"path": str(DATA / "jax_moe")}}}))
    server = build_server(["x", "--model-manifest", str(manifest), "--port", "0",
                           "--max-batch", "4", "--max-doc-len", "32", "--swap-dir", str(ckpt)])
    _, port = server.start()
    server.engine.start()

    def post(model, text):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{model}/parse",
                                     data=json.dumps({"texts": [text]}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read()), r.headers["ETag"]

    try:
        before = {m: [post(m, t) for t in TEXTS[:6]] for m in ("md", "moe")}
        moe = server.residency.engine_for("moe", load=False)
        graphs, replays = moe.nlp.decode_graphs, moe.nlp.decode_graphs.replays
        req = urllib.request.Request(f"http://127.0.0.1:{port}/admin/swap", data=json.dumps(
            {"model": "moe", "dir": str(ckpt), "generation": 7}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            assert json.loads(r.read())["generation"] == 7
        after = {m: [post(m, t) for t in TEXTS[:6]] for m in ("md", "moe")}
        assert moe.nlp.decode_graphs is graphs and graphs.replays > replays
    finally:
        server.request_shutdown()
        assert server.wait() == 0
    from spacy_ray_tpu_torch.serving.engine import InferenceEngine

    nlp_b = P.Pipeline.from_disk(DATA / "jax_moe", device="cuda")
    nlp_b.load_params(flat_b)  # before the engine builds its overlay from them
    fresh = InferenceEngine(nlp_b, max_batch_docs=4, max_doc_len=32).start()
    try:
        want = _answers(fresh, TEXTS[:6])
    finally:
        fresh.stop()
    assert [json.dumps(b["docs"]) for b, _ in after["moe"]] == want
    assert [b["batch"]["generation"] for b, _ in after["moe"]] == [7] * 6
    assert all(a[1] != b[1] for a, b in zip(before["moe"], after["moe"]))
    assert [e for _, e in before["md"]] == [e for _, e in after["md"]]
