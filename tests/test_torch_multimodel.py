"""The port's multi-model, multi-tenant serving against the JAX package's:
the manifest registry (parse, resolution precedence, validation errors),
token-bucket admission on a fake clock, the LRU residency with a fake
engine factory (load and eviction order, stats, one leader load, a failed
load retried), and a manifest of JAX-written pipelines served over HTTP by
the port and by the JAX server with one scripted request sequence (statuses
200/304/404/429, ETags, docs, /healthz and residency). Last, the committed
JAX-written md, linker and MoE directories served through one port manifest
with two resident engines, answering as JAX does."""

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import spacy_ray_tpu as J
from spacy_ray_tpu.serving import multimodel as JM
from spacy_ray_tpu.serving.engine import InferenceEngine as JEngine
from spacy_ray_tpu.serving.engine import ServingTelemetry as JTelemetry
from spacy_ray_tpu.serving.server import Server as JServer
from spacy_ray_tpu.training.corpus import _doc_to_json as j_doc_to_json

from spacy_ray_tpu_torch.__main__ import build_server
from spacy_ray_tpu_torch.serving import multimodel as PM
from spacy_ray_tpu_torch.serving.batcher import UnknownModel, etag_for

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


FULL = {
    "default_model": "alpha",
    "models": {"alpha": {"path": "models/alpha"}, "beta": {"path": "/abs/beta"},
               "g.2-x_y": {"path": "g"}},
    "classes": {"gold": {"weight": 4, "p99_target_ms": 500},
                "batch": {"weight": 1, "p99_target_ms": 5000}, "plain": {}},
    "tenants": {"acme": {"class": "gold", "quota_docs_per_s": 200, "quota_burst": 400},
                "bulk": {"class": "batch"}, "metered": {"quota_docs_per_s": 5}},
}
MANIFESTS = {
    "full": FULL,
    "single_model_no_default": {"models": {"only": {"path": "o"}}},
    "not_an_object": [1, 2],
    "no_models": {"default_model": "a"},
    "empty_models": {"models": {}},
    "model_without_path": {"models": {"a": {"dir": "x"}}},
    "default_not_a_model": {"default_model": "z", "models": {"a": {"path": "a"}}},
    "two_models_no_default": {"models": {"a": {"path": "a"}, "b": {"path": "b"}}},
    "bad_model_name": {"models": {"a/b": {"path": "a"}}},
    "zero_weight": {"models": {"a": {"path": "a"}}, "classes": {"c": {"weight": 0}}},
    "class_not_object": {"models": {"a": {"path": "a"}}, "classes": {"c": 3}},
    "tenant_unknown_class": {"models": {"a": {"path": "a"}},
                             "tenants": {"t": {"class": "nope"}}},
    "tenant_zero_quota": {"models": {"a": {"path": "a"}},
                          "tenants": {"t": {"quota_docs_per_s": 0}}},
    "tenant_not_object": {"models": {"a": {"path": "a"}}, "tenants": {"t": "gold"}},
}


def _load(mod, path):
    try:
        reg = mod.ModelRegistry.from_manifest(str(path))
    except ValueError as e:
        return ("ValueError", str(e))
    return ("ok", reg.describe(), {n: s.path for n, s in reg.models.items()},
            reg.class_weights(), {c: reg.p99_target_ms(c) for c in reg.classes},
            {t: (s.klass, s.quota_docs_per_s, s.quota_burst) for t, s in reg.tenants.items()},
            [(reg.tenant(t).name, reg.tenant(t).klass, reg.tenant(t).quota_docs_per_s)
             for t in (None, "acme", "stranger", "metered")])


@pytest.mark.parametrize("name", MANIFESTS)
def test_registry_parses_and_refuses_manifests_as_jax(name, tmp_path):
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps(MANIFESTS[name]), encoding="utf-8")
    got, want = _load(PM, path), _load(JM, path)
    assert got == want
    assert (got[0] == "ok") == (name in ("full", "single_model_no_default"))


RESOLVE = [
    ("/v1/parse", {}), ("/v1/parse", {"X-SRT-Model": "beta"}),
    ("/v1/models/beta/parse", {"X-SRT-Model": "alpha"}), ("/v1/models/g.2-x_y/parse", {}),
    ("/v1/models/nope/parse", {}), ("/v1/models/a b/parse", {}), ("/v1/models//parse", {}),
    ("/v1/models/beta", {}), ("/v1/parse", {"X-SRT-Model": "nope"}),
    ("/v1/parse", {"X-SRT-Model": ""}), ("/v1/models/" + "x" * 65 + "/parse", {}),
]


def _resolve(mod, reg, path, headers):
    try:
        return reg.resolve_model(path, headers)
    except Exception as e:  # the typed 404 of either package
        return (type(e).__name__, e.http_status, e.code, str(e))


def test_resolution_precedence_and_404s_match_jax(tmp_path):
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps(FULL), encoding="utf-8")
    preg, jreg = PM.ModelRegistry.from_manifest(path), JM.ModelRegistry.from_manifest(path)
    got = [_resolve(PM, preg, p, h) for p, h in RESOLVE]
    assert got == [_resolve(JM, jreg, p, h) for p, h in RESOLVE]
    assert got[:4] == [("alpha", False), ("beta", True), ("beta", True), ("g.2-x_y", True)]
    assert got[9] == ("alpha", False)  # an empty header names no model
    assert all(g[:3] == ("UnknownModel", 404, "unknown_model") for g in got[4:9] + got[10:])
    assert (PM.MODEL_HEADER, PM.TENANT_HEADER, PM.MODEL_PATH_RE.pattern) == (
        JM.MODEL_HEADER, JM.TENANT_HEADER, JM.MODEL_PATH_RE.pattern)


def _bucket_script(mod):
    clock = FakeClock(10.0)
    bucket = mod.TokenBucket(5.0, burst=10.0, clock=clock)
    out = []
    for dt, n in [(0, 3), (0, 3), (0, 3), (0, 3), (0.1, 1), (0.2, 2), (1.0, 5), (0, 1),
                  (3.0, 10), (0, 0.5), (100, 11), (0, 10)]:
        clock.t += dt
        out.append((bucket.try_acquire(n), round(bucket.available(), 9)))
    for bad in ((0, None), (1, 0), (-1, 2)):
        try:
            mod.TokenBucket(bad[0], burst=bad[1], clock=clock)
            out.append("built")
        except ValueError as e:
            out.append(str(e))
    return out


def _admission_script(mod, path):
    clock = FakeClock(0.0)
    adm = mod.AdmissionController(mod.ModelRegistry.from_manifest(path), clock=clock)
    out = []
    for dt, tenant, n in [(0, "metered", 2), (0, "metered", 2), (0, "metered", 2),
                          (0.1, "metered", 1), (0, None, 50), (0, "acme", 399), (0, "acme", 2),
                          (0, "stranger", 9), (0, "bulk", 9), (1.0, "metered", 5),
                          (0, "metered", 1), (0.01, "acme", 3)]:
        clock.t += dt
        try:
            out.append(adm.admit(tenant, n_docs=n))
        except Exception as e:  # either package's QuotaExceeded
            out.append((type(e).__name__, e.code, e.http_status, str(e)))
    out.append(adm.stats())
    return out


def test_token_bucket_and_admission_match_jax_on_a_fake_clock(tmp_path):
    assert _bucket_script(PM) == _bucket_script(JM)
    path = tmp_path / "manifest.json"
    path.write_text(json.dumps(FULL), encoding="utf-8")
    got = _admission_script(PM, path)
    assert got == _admission_script(JM, path)
    assert got[:2] == got[3:5] == ["default", "default"]  # refilled 0.5 docs in 0.1 s
    assert got[2][:3] == ("QuotaExceeded", "quota_exceeded", 429)


class FakeEngine:
    def __init__(self, name, log):
        self.name, self.log = name, log
        self.warmed = [(1, 1)]
        self.serving_generation = None if name == "a" else len(log)
        self.swap_count = len(name)

    def drain(self, timeout):
        self.log.append(("drain", self.name))
        return True

    def stop(self):
        self.log.append(("stop", self.name))


def _residency_script(mod):
    clock, log = FakeClock(), []
    reg = mod.ModelRegistry({n: mod.ModelSpec(n, f"/m/{n}") for n in "abcd"}, "a")

    def factory(spec):
        log.append(("load", spec.name))
        return FakeEngine(spec.name, log)

    res = mod.ResidencyManager(reg, factory, capacity=2, pinned={"a"}, clock=clock)
    res.adopt("a", FakeEngine("a", log))
    out = []
    for name in "bcbdaacdbb":
        clock.t += 1.0
        out.append((res.engine_for(name).name, res.resident(), res.stats(),
                    res.resident_info()))
    for name, load in (("c", False), ("a", False), ("zz", True)):
        try:
            out.append(res.engine_for(name, load=load).name)
        except Exception as e:
            out.append((type(e).__name__, e.http_status, str(e)))
    res.begin_drain()
    out.append(res.stop_all(1.0))
    out.append(res.stats())
    return out, log


def test_residency_loads_and_evicts_in_jaxs_order():
    got, want = _residency_script(PM), _residency_script(JM)
    assert got == want
    assert [e for e in got[1] if e[0] == "load"] == [
        ("load", n) for n in "bcbdcdb"]  # the pinned default never evicted


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_one_leader_load_under_concurrent_requests_and_a_failed_load_retries(impl):
    mod = JM if impl == "jax" else PM
    reg = mod.ModelRegistry({n: mod.ModelSpec(n, f"/m/{n}") for n in "ab"}, "a")
    release, calls = threading.Event(), []

    def factory(spec):
        calls.append(spec.name)
        if len(calls) == 1:
            raise RuntimeError("disk hiccup")
        release.wait(10)
        return FakeEngine(spec.name, [])

    res = mod.ResidencyManager(reg, factory, capacity=2)
    with pytest.raises(Exception, match="failed to load: disk hiccup"):
        res.engine_for("b")
    assert res.stats()["loads"] == 0 and res.resident() == []
    got = []
    threads = [threading.Thread(target=lambda: got.append(res.engine_for("b")))
               for _ in range(8)]
    for th in threads:
        th.start()
    release.set()
    for th in threads:
        th.join(10)
    assert calls == ["b", "b"]  # one failed load, then one leader for eight requests
    assert len(got) == 8 and len({id(e) for e in got}) == 1
    assert res.stats()["loads"] == 1


# -- HTTP: a manifest of JAX-written pipelines, served by both -------------

MM_CFG = """
[nlp]
lang = "en"
pipeline = ["tok2vec","tagger"]

[components]

[components.tok2vec]
factory = "tok2vec"

[components.tok2vec.model]
@architectures = "spacy.HashEmbedCNN.v2"
width = 64
depth = 2
embed_size = 512

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 64
"""
MM_TEXTS = ["the cat runs fast today", "a dog sleeps near the door",
            "rain falls softly on the roof"]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    from spacy_ray_tpu.util import synth_corpus

    root = tmp_path_factory.mktemp("mm")
    for seed, name in enumerate(("alpha", "beta", "gamma")):
        nlp = J.Pipeline.from_config(J.Config.from_str(MM_CFG))
        egs = synth_corpus(64, "tagger", seed=seed)
        nlp.initialize(lambda: iter(egs), seed=seed)
        nlp.to_disk(root / name)
    path = root / "manifest.json"
    path.write_text(json.dumps({
        "default_model": "alpha",
        "models": {n: {"path": n} for n in ("alpha", "beta", "gamma")},
        "classes": {"gold": {"weight": 4, "p99_target_ms": 500},
                    "batch": {"weight": 1, "p99_target_ms": 5000}},
        "tenants": {"acme": {"class": "gold"}, "bulk": {"class": "batch"},
                    "metered": {"class": "batch", "quota_docs_per_s": 1, "quota_burst": 2}},
    }), encoding="utf-8")
    return path


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
            return r.status, (json.loads(body) if body else None), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, (json.loads(body) if body else None), dict(e.headers)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        raw = r.read()
    return raw.decode() if "prometheus" in path else json.loads(raw)


def _script(port):
    """The scripted sequence; each entry (status, ETag, docs or error code)."""
    out = []

    def call(path, payload, headers=None):
        status, body, hdrs = _post(port, path, payload, headers)
        doc_part = (body.get("docs") if status == 200 else
                    body.get("error") if isinstance(body, dict) else body)
        out.append((path, status, hdrs.get("ETag"), doc_part))
        return hdrs.get("ETag")

    tag = call("/v1/parse", {"texts": MM_TEXTS[:2]}, {"X-SRT-Tenant": "acme"})
    call("/v1/parse", {"texts": MM_TEXTS[:2]}, {"If-None-Match": tag})
    call("/v1/parse", {"texts": MM_TEXTS[:2]}, {"If-None-Match": '"other"'})
    call("/v1/models/beta/parse", {"texts": MM_TEXTS}, {"X-SRT-Tenant": "bulk"})
    btag = call("/v1/parse", {"texts": MM_TEXTS}, {"X-SRT-Model": "beta"})
    call("/v1/models/beta/parse", {"texts": MM_TEXTS}, {"If-None-Match": f"W/{btag}"})
    call("/v1/models/nope/parse", {"texts": MM_TEXTS})
    call("/v1/models/bad name/parse".replace(" ", "%20"), {"texts": MM_TEXTS})
    call("/v1/parse", {"texts": MM_TEXTS}, {"X-SRT-Model": "nope"})
    for _ in range(3):
        call("/v1/parse", {"texts": MM_TEXTS[:1]}, {"X-SRT-Tenant": "metered"})
    out.append(("load", *_post(port, "/admin/models/load", {"model": "gamma"})[:2]))
    call("/v1/models/gamma/parse", {"texts": MM_TEXTS[2:]})
    call("/v1/models/beta/parse", {"texts": MM_TEXTS[1:]})  # evicted by gamma: reloaded
    out.append(("swap", _post(port, "/admin/swap", {"model": "gamma", "dir": "/x"})[:2]))
    out.append(("load_bad", _post(port, "/admin/models/load", {"model": 3})[:2]))
    health = _get(port, "/healthz")
    metrics = _get(port, "/metrics")
    prom = _get(port, "/metrics?format=prometheus")
    return out, health, metrics, prom


def _jax_server(path):
    registry = JM.ModelRegistry.from_manifest(str(path))

    def build(p, tel):
        return JEngine(J.Pipeline.from_disk(Path(p)), max_batch_docs=4, max_queue_docs=64,
                       timeout_s=30.0, max_doc_len=16, telemetry=tel,
                       class_weights=registry.class_weights())

    def factory(spec):
        return build(spec.path, JTelemetry()).start()

    tel = JTelemetry()
    engine = build(registry.spec("alpha").path, tel)
    residency = JM.ResidencyManager(registry, factory, capacity=2, pinned={"alpha"})
    residency.adopt("alpha", engine)
    engine.start()
    return JServer(engine, "127.0.0.1", 0, telemetry=tel, registry=registry,
                   residency=residency, admission=JM.AdmissionController(registry))


def test_manifest_served_over_http_answers_as_the_jax_server(manifest):
    jserver = _jax_server(manifest)
    _, jport = jserver.start()
    try:
        want = _script(jport)
    finally:
        jserver.request_shutdown()
        assert jserver.wait() == 0
    server = build_server(["ignored", "--model-manifest", str(manifest), "--device", "cpu",
                           "--port", "0", "--max-batch", "4", "--max-doc-len", "16",
                           "--queue-size", "64", "--timeout-ms", "30000"])
    _, port = server.start()
    server.engine.start()
    try:
        got = _script(port)
    finally:
        server.request_shutdown()
        assert server.wait() == 0
    assert got[0] == want[0]
    statuses = [e[1] for e in got[0] if isinstance(e[1], int)]
    assert statuses == [200, 304, 200, 200, 200, 304, 404, 404, 404, 200, 200, 429,
                        200, 200, 200]  # ..., /admin/models/load, gamma, beta again
    health, jhealth = got[1], want[1]
    assert set(jhealth) - {"anchor"} <= set(health)
    for key in ("status", "batching", "resident_models", "residency", "default_model",
                "generation", "swap_count", "max_batch_docs", "max_doc_len"):
        assert health[key] == jhealth[key], key
    assert health["residency"] == {"resident": ["alpha", "beta"], "capacity": 2, "loads": 3,
                                   "evictions": 2, "residency_swaps": 5}
    assert set(got[2]["models"]) == set(want[2]["models"]) == {"alpha", "beta"}
    assert got[2]["residency"] == want[2]["residency"]
    assert got[2]["models"]["alpha"]["counters"]["not_modified"] == 1
    assert 'model="beta"' in got[3] and 'model="beta"' in want[3]


def test_without_a_manifest_no_multi_model_route_exists(manifest):
    server = build_server([str(manifest.parent / "alpha"), "--device", "cpu", "--port", "0",
                           "--max-batch", "4", "--max-doc-len", "16"])
    assert server.registry is server.residency is server.admission is None
    _, port = server.start()
    server.engine.start()
    try:
        assert _post(port, "/v1/models/alpha/parse", {"texts": ["a"]})[0] == 404
        assert _post(port, "/admin/models/load", {"model": "alpha"})[0] == 403
        status, body, hdrs = _post(port, "/v1/parse", {"texts": MM_TEXTS[:1]},
                                   {"X-SRT-Model": "beta", "X-SRT-Tenant": "metered"})
        assert status == 200  # the headers name nothing this server knows
        assert hdrs["ETag"] == etag_for(MM_TEXTS[:1], "", None)
        assert _post(port, "/v1/parse", {"texts": MM_TEXTS[:1]},
                     {"If-None-Match": hdrs["ETag"]})[0] == 304
        assert "resident_models" not in _get(port, "/healthz")
    finally:
        server.request_shutdown()
        assert server.wait() == 0


def test_jax_written_md_linker_and_moe_dirs_served_through_one_manifest(tmp_path):
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({
        "default_model": "md",
        "models": {n: {"path": str(DATA / f"jax_{n}")} for n in ("md", "nel", "moe")},
    }), encoding="utf-8")
    moe = json.loads((DATA / "jax_moe" / "answers.json").read_text(encoding="utf8"))
    nel = json.loads((DATA / "jax_nel" / "answers.json").read_text(encoding="utf8"))
    jmd = J.Pipeline.from_disk(DATA / "jax_md")
    server = build_server(["ignored", "--model-manifest", str(manifest), "--device", "cpu",
                           "--port", "0", "--max-batch", "4", "--max-doc-len", "32",
                           "--resident-models", "2"])
    _, port = server.start()
    server.engine.start()
    try:
        for i, text in enumerate(moe["texts"]):
            for model in ("moe", "nel", "md") if i < 4 else ("moe", "nel"):
                status, body, _ = _post(port, f"/v1/models/{model}/parse", {"texts": [text]})
                assert status == 200, body
                doc = body["docs"][0]
                if model == "moe":
                    assert [body["batch"]["B"], body["batch"]["T"]] == moe["buckets"][i]
                    assert [doc["tags"], doc["heads"], doc["deps"]] == [
                        moe["tags"][i], moe["heads"][i], moe["deps"][i]]
                    assert [e[:3] for e in doc.get("ents", [])] == moe["ents"][i]
                elif model == "nel":
                    assert [e if len(e) > 3 else [*e, ""] for e in doc.get("ents", [])] == \
                        nel["ents"][i]
                else:
                    jdoc = jmd.tokenizer(text)
                    jmd.predict_docs([jdoc])
                    assert doc == j_doc_to_json(jdoc)
        stats = _get(port, "/healthz")["residency"]
    finally:
        server.request_shutdown()
        assert server.wait() == 0
    assert stats["capacity"] == 2 and stats["resident"][-1] == "nel"
    assert stats["loads"] >= 8 and stats["evictions"] == stats["loads"] - 1


def test_a_swap_for_a_model_that_is_not_resident_is_refused(manifest):
    server = build_server(["ignored", "--model-manifest", str(manifest), "--device", "cpu",
                           "--port", "0", "--max-batch", "4", "--max-doc-len", "16",
                           "--swap-dir", str(manifest.parent)])
    _, port = server.start()
    server.engine.start()
    try:
        status, body, _ = _post(port, "/admin/swap", {"model": "beta", "dir": "x"})
        assert (status, body["error"]) == (500, "internal")  # JAX's: not resident here
        status, body, _ = _post(port, "/admin/swap", {"model": "nope", "dir": "x"})
        assert (status, body["error"]) == (404, "unknown_model")
        status, body, _ = _post(port, "/admin/swap", {"model": "alpha",
                                                      "dir": str(manifest.parent)})
        assert (status, body["error"]) == (409, "swap_failed")  # no generation there
    finally:
        server.request_shutdown()
        assert server.wait() == 0
    with pytest.raises(UnknownModel):
        server.registry.spec("nope")


def test_the_device_gate_keeps_an_exclusive_hold_alone():
    """Many threads hold the gate shared while others take it exclusively
    (some upgrading from a shared hold): no shared holder is ever inside
    while an exclusive one is, and every section ran."""
    import sys
    import time

    from spacy_ray_tpu_torch.devices import DeviceGate

    gate, state, lock, errors, done = DeviceGate(), {"shared": 0, "excl": 0}, \
        threading.Lock(), [], []

    def inside(kind):
        with lock:
            state[kind] += 1
            if state["excl"] > 1 or (state["excl"] and state["shared"]):
                errors.append(dict(state))
        time.sleep(1e-4)  # let the others run inside
        with lock:
            state[kind] -= 1

    def worker(i):
        for k in range(200):
            if (i + k) % 17 == 0:
                with gate.shared():  # an upgrade, as a capture inside a warmup
                    with gate.exclusive():
                        inside("excl")
            elif (i + k) % 11 == 0:
                with gate.exclusive():
                    inside("excl")
            else:
                with gate.shared():
                    with gate.shared():
                        inside("shared")
        done.append(i)

    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(previous)
    assert not any(th.is_alive() for th in threads)
    assert not errors and sorted(done) == list(range(16))
    assert gate.exclusive_acquisitions == sum(
        1 for i in range(16) for k in range(200) if (i + k) % 17 == 0 or (i + k) % 11 == 0)


def test_launch_counts_lose_no_update_across_threads():
    import sys

    from spacy_ray_tpu_torch.ops import _cuda

    before = _cuda.launch_counts()["fused_update"]
    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_cuda.count_launch("fused_update")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(previous)
    assert not any(th.is_alive() for th in threads)
    assert _cuda.launch_counts()["fused_update"] == before + 16 * 2000


def test_a_swap_overlapping_an_eviction_of_its_engine_ends_and_the_next_is_refused(manifest):
    """A per-model swap still staging when the residency evicts that engine:
    ``release`` waits for the swap (it takes the swap lock before the device
    gate, as the swap does), both return, and a swap after it is refused."""
    import time

    import spacy_ray_tpu_torch as P
    from spacy_ray_tpu_torch.serving.batcher import SwapFailed
    from spacy_ray_tpu_torch.serving.engine import InferenceEngine
    from spacy_ray_tpu_torch.training.checkpoint import load_params

    engine = InferenceEngine(P.Pipeline.from_disk(manifest.parent / "alpha", device="cpu"),
                             max_batch_docs=4, max_doc_len=16).start()
    beta = load_params(manifest.parent / "beta" / "params.npz")
    staging, stage = threading.Event(), engine._stage

    def slow_stage(params):
        staging.set()
        time.sleep(0.5)  # the eviction's release() starts inside this window
        return stage(params)

    engine._stage = slow_stage
    results = {}

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # recorded, and the assertions below say which
            results[name] = e

    swap = threading.Thread(target=run, args=("swap", lambda: engine.swap_params(beta, 7)),
                            daemon=True)
    swap.start()
    assert staging.wait(10)
    release = threading.Thread(target=run, args=("release", engine.release), daemon=True)
    release.start()
    swap.join(30)
    release.join(30)
    assert not swap.is_alive() and not release.is_alive()
    assert results["swap"]["generation"] == 7 and results["release"] is None
    assert engine.nlp is None and engine._previous is None
    with pytest.raises(SwapFailed, match="evicted"):
        engine.swap_params(beta, 8)
    with pytest.raises(SwapFailed, match="evicted"):
        engine.rollback()
