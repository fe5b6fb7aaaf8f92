"""The port's trainer fleet end to end on the CPU: two workers as threads of
this process with real loopback HTTP, against the JAX package's
``train_fleet_worker`` at its parity point (f32 wire, full pulls, no
membership), on its int8 wire with delta pulls (the tolerance in that
test's docstring) and resumed from a generation; three int8 workers losing
one; a re-shard carving its moments from a generation; a fleet generation
resumed by a fleet and by one process; the wire's flags; the ``train
--fleet-workers`` coordinator as processes, with a worker SIGKILLed and
restarted under ``--max-restarts``; and SIGTERM to a one-process run.

Tolerances. Three applied rounds at S 0, quorum 2, dropout 0, from the same
parameters (one model directory both configs source): each leaf's change
from the start within 1e-4 x that leaf's max |change| in JAX, the float32
measure of ``test_float32_gradients_of_one_batch_match_jax``; versions and
counters equal. The run uses Adam.v1 with ``eps`` 1e-3: at the default
1e-8, Adam's ``m / (sqrt(v) + eps)`` turns the float32 summation-order
differences of gradient elements that cancel to near zero into update
differences of up to 5e-3 of the max change (10 to 18 of the 36,864
elements of each maxout ``W`` on this corpus, measured); with ``eps`` 1e-3
the update stays near linear in the gradient and the worst leaf measured
5e-6. No maxout near-tie moved a leaf past 1e-5 here, so none is nudged.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu.ops.fused_update import make_fused_transformation
from spacy_ray_tpu.parallel.step import make_shard_apply
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training import optimizers as jopt
from spacy_ray_tpu.training.checkpoint import TrainCheckpoint as JCheckpoint
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.training.fleet import membership as jmem
from spacy_ray_tpu.training.fleet import ownership as jown
from spacy_ray_tpu.training.fleet import peer as jpeer
from spacy_ray_tpu.training.fleet import wire as jwire
from spacy_ray_tpu.training.fleet import worker as jworker_mod
from spacy_ray_tpu.training.fleet.worker import train_fleet_worker as j_worker
from spacy_ray_tpu.util import write_synth_jsonl

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.pipeline.language import Pipeline as PPipeline
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint as PCheckpoint
from spacy_ray_tpu_torch.training.fleet import membership as pmem
from spacy_ray_tpu_torch.training.fleet import ownership as pown
from spacy_ray_tpu_torch.training.fleet import peer as ppeer
from spacy_ray_tpu_torch.training.fleet import wire as pwire
from spacy_ray_tpu_torch.training.fleet import worker as pworker
from spacy_ray_tpu_torch.training.fleet.membership import read_membership_ledger
from spacy_ray_tpu_torch.training.loop import train as p_train

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 240  # every join and quorum wait allows minutes: the test workers share the cores


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_train")
    write_synth_jsonl(d / "train.jsonl", 120, kind="tagger", seed=0)
    write_synth_jsonl(d / "dev.jsonl", 30, kind="tagger", seed=1)
    return d


def _config(pkg, text, data, **over):
    cfg = pkg.Config.from_str(text)
    return cfg.apply_overrides({"paths.train": str(data / "train.jsonl"),
                                "paths.dev": str(data / "dev.jsonl"), **over})


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def run_thread_fleet(worker_fn, cfg, out, n, *, quorum, staleness, overrides=None, **kw):
    """N fleet workers as threads with real HTTP peer servers on loopback;
    returns {worker id: (nlp, TrainResult)}. ``overrides`` gives one
    worker's own keyword arguments."""
    ports = _free_ports(n)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    results, errors = {}, {}

    def run(k):
        try:
            results[k] = worker_fn(cfg, out, worker_id=k, n_workers=n, quorum=quorum,
                                   max_staleness=staleness, port=ports[k], peer_urls=urls,
                                   stdout_log=False, quorum_wait_s=float(JOIN_S),
                                   **{**kw, **(overrides or {}).get(k, {})})
        except Exception as e:  # surfaced below
            errors[k] = e

    threads = [threading.Thread(target=run, args=(k,), name=f"fleet-{k}") for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not [t.name for t in threads if t.is_alive()], "fleet workers wedged"
    assert not errors, errors
    return results


JAX_PARITY = {"grad_compression": "f32", "param_delta_window": 0, "peer_lease_s": 0,
              "install_signal_handlers": False}


@pytest.fixture(scope="module")
def source(data, tagger_config_text, tmp_path_factory):
    """One initialized tagger pipeline both packages' fleets source."""
    d = tmp_path_factory.mktemp("fleet_source")
    jnlp = J.Pipeline.from_config(_config(J, tagger_config_text, data).interpolate())
    egs = list(jcorpus.Corpus(data / "train.jsonl")())
    jnlp.initialize(lambda: egs, seed=0)
    jnlp.to_disk(d)
    return d, {k: np.asarray(v) for k, v in _flatten(jnlp.params).items()}


def _sourced(pkg, text, data, src, steps):
    cfg = _config(pkg, text, data, **{"training.max_steps": steps,
                                      "training.eval_frequency": 100,
                                      "training.dropout": 0.0,
                                      "training.optimizer.eps": 1e-3})
    for name in ("tok2vec", "tagger"):
        cfg["components"][name] = {"source": str(src)}
    return cfg


@pytest.fixture(scope="module")
def f32_fleets(data, tagger_config_text, source):
    """The port's and JAX's 2-worker thread fleets at the parity point, 4 steps."""
    src, _ = source
    port = run_thread_fleet(pworker.train_fleet_worker,
                            _sourced(P, tagger_config_text, data, src, 4), None, 2,
                            quorum=2, staleness=0, device="cpu", peer_lease_s=0,
                            grad_compression="f32", param_delta_window=0)
    jax_ = run_thread_fleet(j_worker, _sourced(J, tagger_config_text, data, src, 4), None, 2,
                            quorum=2, staleness=0, **JAX_PARITY)
    return port, jax_


def test_three_rounds_match_the_jax_thread_fleet(source, f32_fleets):
    # 4 steps: a worker's model holds the slices pulled at its last step's
    # top, so after 3 applied rounds in both packages
    _, start = source
    port, jax_ = f32_fleets
    for k in (0, 1):
        pflat = {key: v.numpy() for key, v in param_paths(port[k][0].model).items()}
        jflat = {key: np.asarray(v) for key, v in _flatten(jax_[k][0].params).items()}
        assert set(pflat) == set(jflat) == set(start)
        for key, s0 in start.items():
            dj, dp = jflat[key] - s0, pflat[key] - s0
            scale = np.abs(dj).max()
            assert scale > 0, key
            assert np.abs(dp - dj).max() <= 1e-4 * scale, (k, key)
        pf, jf = port[k][1].fleet, jax_[k][1].fleet
        assert pf["version"] == jf["version"] == 4
        assert pf["quorum"] == jf["quorum"] == 2
        shared = set(pf["counters"]) & set(jf["counters"])
        assert shared == set(jf["counters"])
        # an f32 push is its own uncompressed size in the port; JAX counts a
        # startup template's, whose meta lacks the stamp's digits, the epoch
        # and the codec (ROADMAP C51)
        own = "wire_push_bytes_uncompressed"
        assert {c: pf["counters"][c] for c in shared - {own}} == \
            {c: jf["counters"][c] for c in shared - {own}}
        assert pf["counters"][own] == pf["counters"]["wire_push_bytes"]
        assert 0 < pf["counters"][own] - jf["counters"][own] <= 64 * pf["counters"]["grad_pushed"]
        assert pf["counters"]["grad_applied"] == 8 and pf["counters"]["grad_pushed"] == 4
        assert (pf["grad_compression"], pf["param_delta_window"]) == ("f32", 0)
        assert port[k][1].final_step == jax_[k][1].final_step == 4


def test_three_int8_rounds_with_delta_pulls_match_the_jax_thread_fleet(
        data, tagger_config_text, source, f32_fleets, monkeypatch):
    """The parity run with the wire on in both packages: int8 pushes with
    error feedback and delta pulls at a window of 4. Versions, every counter
    (both _uncompressed ones too), the codecs and the served frames are
    equal. The first round's pushes differ only where the two packages'
    float32 gradients straddle an int8 rounding tie: such an element moves
    by one step of its leaf (error feedback carries the difference into the
    next round), in at most 1e-3 of the elements; scales and f32 leaves
    within 1e-5 relative. From there the rounds drift apart: a one-step
    difference in a pulled parameter can move a maxout near-tie, whose
    gradient then differs by several steps. So after three rounds each
    leaf's change is held in norm: within 5e-3 of JAX's (measured <= 1.8e-3)
    and within half of what the codec itself moves it, the port's int8 run
    against its f32 run (measured 0.003-0.019)."""
    src, start = source
    wire = {"grad_compression": "int8", "param_delta_window": 4}
    served = {"port": [], "jax": []}
    pushes = {"port": [], "jax": []}

    def recorder(cls, name):
        real = cls.request

        def request(self, method, path, *a, **kw):
            out = real(self, method, path, *a, **kw)
            if path.startswith("/params") and out[0] == 200:
                served[name].append((path, out[1].get("X-SRT-Codec")))
            elif path == "/grad":
                pushes[name].append(kw["body"])
            return out
        return request

    monkeypatch.setattr(pworker._PeerClient, "request", recorder(pworker._PeerClient, "port"))
    monkeypatch.setattr(jworker_mod._PeerClient, "request",
                        recorder(jworker_mod._PeerClient, "jax"))
    port = run_thread_fleet(pworker.train_fleet_worker,
                            _sourced(P, tagger_config_text, data, src, 4), None, 2,
                            quorum=2, staleness=0, device="cpu", peer_lease_s=0, **wire)
    jax_ = run_thread_fleet(j_worker, _sourced(J, tagger_config_text, data, src, 4), None, 2,
                            quorum=2, staleness=0, **{**JAX_PARITY, **wire})
    # one full pull each (nothing known), then one delta a step
    assert sorted(served["port"]) == sorted(served["jax"])
    assert sorted(c for _, c in served["port"]) == ["delta"] * 6 + ["f32"] * 2
    frames = {}
    for name, bodies in pushes.items():
        for body in bodies:
            meta, arrays = jwire.decode_arrays(body)
            frames.setdefault((meta["worker"], meta["stamp"]), {})[name] = (len(body), arrays)
    assert sorted(frames) == [(w, s) for w in (0, 1) for s in range(4)]
    assert all(f["port"][0] == f["jax"][0] for f in frames.values())
    for w in (0, 1):
        (_, pa), (_, ja) = frames[(w, 0)]["port"], frames[(w, 0)]["jax"]
        assert sorted(pa) == sorted(ja)
        moved = total = 0
        for key in pa:
            if pa[key].dtype == np.int8:
                step = np.abs(pa[key].astype(np.int64) - ja[key].astype(np.int64))
                assert step.max() <= 1, key
                moved, total = moved + int(step.sum()), total + step.size
            else:
                np.testing.assert_allclose(pa[key], ja[key], rtol=1e-5, atol=0)
        assert total > 0 and moved <= 1e-3 * total, (moved, total)
    f32_port = f32_fleets[0]
    for k in (0, 1):
        pflat = {key: v.numpy() for key, v in param_paths(port[k][0].model).items()}
        jflat = {key: np.asarray(v) for key, v in _flatten(jax_[k][0].params).items()}
        fflat = {key: v.numpy() for key, v in param_paths(f32_port[k][0].model).items()}
        for key, s0 in start.items():
            dj, dp, df = jflat[key] - s0, pflat[key] - s0, fflat[key] - s0
            apart = np.linalg.norm(dp - dj) / np.linalg.norm(dj)
            codec = np.linalg.norm(dp - df) / np.linalg.norm(df)
            assert apart <= 5e-3 and apart <= 0.5 * codec, (k, key, apart, codec)
        pf, jf = port[k][1].fleet, jax_[k][1].fleet
        assert pf["version"] == jf["version"] == 4
        assert pf["counters"] == jf["counters"]
        assert (pf["grad_compression"], pf["param_delta_window"]) == \
            (jf["grad_compression"], jf["param_delta_window"]) == ("int8", 4)
        c = pf["counters"]
        assert c["wire_push_bytes"] <= 0.30 * c["wire_push_bytes_uncompressed"]
        assert c["wire_pull_bytes"] < c["wire_pull_bytes_uncompressed"]


def jax_opt_flat(tree):
    """A JAX Adam.v1 state (or an owner's) by the port's flat names:
    ``[1].mu['a']['W']`` is ``mu/a/W``, ``[1].count`` and ``[2].count`` are
    ``count`` and ``sched_count``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        m = re.fullmatch(r"\[(\d)\]\.count", key)
        if m:
            out[{"1": "count", "2": "sched_count"}[m.group(1)]] = np.asarray(leaf)
            continue
        m = re.fullmatch(r"\[1\]\.(mu|nu)((?:\['[^']*'\])+)", key)
        assert m, key
        out[m.group(1) + "/" + "/".join(re.findall(r"\['([^']*)'\]", m.group(2)))] = \
            np.asarray(leaf)
    return out


def jax_opt_tree(tx, template, flat):
    """``flat`` (the port's names) as ``tx``'s optax state over ``template``."""
    struct = jax.eval_shape(tx.init, template)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(struct)
    names = list(jax_opt_flat(jax.tree_util.tree_unflatten(
        treedef, [np.zeros(s.shape, s.dtype) for _, s in leaves])))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[n], dtype=s.dtype) for n, (_, s) in zip(names, leaves)])


def settled_checkpoints(monkeypatch, want):
    """Both packages' leads ask a peer for its part only once the peer's
    owner has reached version ``want``: a lead cuts its generation as soon
    as its own owner has applied the round, when the peer's may still be one
    round behind, so without this the two packages' generations can be cut
    at different versions."""
    for module in (pworker, jworker_mod):
        real = module._PeerClient.request

        def request(self, method, path, *a, real=real, **kw):
            if path == "/checkpoint":
                deadline = time.monotonic() + JOIN_S
                while time.monotonic() < deadline and json.loads(
                        real(self, "GET", "/healthz")[2])["version"] < want:
                    time.sleep(0.01)
            return real(self, method, path, *a, **kw)

        monkeypatch.setattr(module._PeerClient, "request", request)


@pytest.fixture(scope="module")
def resumed_fleets(data, tagger_config_text, source, tmp_path_factory):
    """Both packages' 2-worker thread fleets at the parity point with an
    output directory: 3 steps (the lead commits a generation at its end,
    every owner at version 3), then 2 more resumed from a generation: the
    port's from its own, JAX's from the port's written in JAX's format (the
    same bits; see the test)."""
    src, _ = source
    with pytest.MonkeyPatch.context() as mp:
        settled_checkpoints(mp, 3)
        return _resumed_fleets(data, tagger_config_text, src, tmp_path_factory)


def _resumed_fleets(data, tagger_config_text, src, tmp_path_factory):
    port_kw = {"device": "cpu", "peer_lease_s": 0, "grad_compression": "f32",
               "param_delta_window": 0}
    out = tmp_path_factory.mktemp("resume_port")
    run_thread_fleet(pworker.train_fleet_worker, _sourced(P, tagger_config_text, data, src, 3),
                     out, 2, quorum=2, staleness=0, **port_kw)
    pgen = PCheckpoint.load(out / "last-model")
    port = run_thread_fleet(pworker.train_fleet_worker,
                            _sourced(P, tagger_config_text, data, src, 5), out, 2, quorum=2,
                            staleness=0, resume=True, **port_kw)
    jout = tmp_path_factory.mktemp("resume_jax")
    jcfg = _sourced(J, tagger_config_text, data, src, 3)
    run_thread_fleet(j_worker, jcfg, jout, 2, quorum=2, staleness=0, **JAX_PARITY)
    jgen = JCheckpoint.load(jout / "last-model")
    # the port's generation as a JAX one: its params, and its moments as
    # optax's Adam.v1 state under the config's optimizer
    from_port = tmp_path_factory.mktemp("resume_jax_from_port") / "last-model"
    template = pown.tree_from_flat(pgen["params"])
    JCheckpoint.save(from_port, params=template,
                     opt_state=jax_opt_tree(J.registry.resolve(
                         jcfg.interpolate()["training"]["optimizer"]), template,
                         pgen["opt_state"]),
                     step=3, epoch=pgen["epoch"], rng=jgen["rng"],
                     best_score=pgen["best_score"], best_step=pgen["best_step"],
                     extra=jgen["extra"])
    jax_ = run_thread_fleet(j_worker, _sourced(J, tagger_config_text, data, src, 5),
                            from_port.parent, 2, quorum=2, staleness=0, resume=True,
                            **JAX_PARITY)
    return (pgen, port), (jgen, jax_)


def test_a_resumed_thread_fleet_matches_jax_s(source, resumed_fleets):
    """The generation each package's fleet commits after 3 rounds, and 2 more
    rounds resumed from a generation. The assembled moments equal JAX's
    optax moments by path within 1e-4 x each leaf's max |moment| in JAX
    (measured <= 1.4e-6), the parameters within 1e-4 x each leaf's max
    |change| (the tolerance of ``test_three_rounds_match_the_jax_thread_fleet``;
    measured <= 5.2e-6), counts and versions exactly. After the resumed
    rounds each leaf's change from the start is within that tolerance of
    JAX's, every owner having started from its generation's version and
    moments. JAX resumes the port's generation there, not its own: from its
    own, the first resumed batch (the shard's first again) meets a maxout
    near-tie that turns the two packages' float32 differences of ~2e-6 into
    2.5e-4 of one maxout ``W``'s change (31 of its 36,864 elements,
    measured), the C17/C48 effect, not the resume's."""
    _, start = source
    (pgen, port), (jgen, jax_) = resumed_fleets
    assert pgen["step"] == jgen["step"] == 3 and pgen["format"] == 2
    assert pgen["extra"]["fleet"]["versions"] == jgen["extra"]["fleet"]["versions"] == [3, 3]
    assert pgen["extra"]["fleet"]["active"] == jgen["extra"]["fleet"]["active"] == [0, 1]
    jmoments = jax_opt_flat(jgen["opt_state"])
    assert sorted(pgen["opt_state"]) == sorted(jmoments)
    for key, want in jmoments.items():
        got = pgen["opt_state"][key]
        if key in ("count", "sched_count"):
            assert int(got) == int(want) == 3
            continue
        scale = np.abs(want).max()
        assert scale > 0 and np.abs(got - want).max() <= 1e-4 * scale, key
    jparams = {key: np.asarray(v) for key, v in _flatten(jgen["params"]).items()}
    for key, s0 in start.items():
        dj = jparams[key] - s0
        assert np.abs(pgen["params"][key] - s0 - dj).max() <= 1e-4 * np.abs(dj).max(), key
    for k in (0, 1):
        pf, jf = port[k][1].fleet, jax_[k][1].fleet
        assert pf["version"] == jf["version"] == 5 and port[k][1].final_step == 5
        assert pf["resume"] and pf["resumed_from"] == 3
        first = pf["owner_epochs"][0]
        assert (first["opt_source"], first["opt_step"], first["version_start"]) == \
            ("checkpoint", 3, 3)
        pflat = {key: v.numpy() for key, v in param_paths(port[k][0].model).items()}
        jflat = {key: np.asarray(v) for key, v in _flatten(jax_[k][0].params).items()}
        for key, s0 in start.items():
            dj, dp = jflat[key] - s0, pflat[key] - s0
            assert np.abs(dp - dj).max() <= 1e-4 * np.abs(dj).max(), (k, key)


@pytest.fixture(scope="module")
def fleet_run(data, tagger_config_text, tmp_path_factory):
    """One 2-worker port fleet of 12 steps at S 0, quorum 2 (JAX's
    ``fleet_run``), evaluated every 6."""
    out = tmp_path_factory.mktemp("fleet_out")
    cfg = _config(P, tagger_config_text, data,
                  **{"training.max_steps": 12, "training.eval_frequency": 6})
    return out, run_thread_fleet(pworker.train_fleet_worker, cfg, out, 2, quorum=2,
                                 staleness=0, device="cpu")


def test_fleet_trains_and_learns(fleet_run):
    # JAX's test_fleet_trains_and_learns checks, on the port
    out, results = fleet_run
    r0 = results[0][1]
    assert r0.final_step == 12
    assert r0.best_score > 0.8, r0.best_score
    assert [h["step"] for h in r0.history] == [6, 12]
    for k, (_, r) in results.items():
        fl = r.fleet
        assert fl["version"] == 12
        c = fl["counters"]
        assert c["grad_discarded"] == c["push_failed"] == c["apply_wait_timeouts"] == 0
        assert c["pull_failed"] == c["pull_wait_timeouts"] == 0
        assert c["grad_applied"] + c["grad_discarded"] == c["grad_received"] == 24
        assert fl["phases"]["grad"] > 0 and fl["phases"]["push"] >= 0
        assert all(len(v) == 12 for v in fl["phase_steps_s"].values())
        # the default wire on the CPU: int8 pushes, delta pulls; the codec's
        # seconds a step lie within their phases'
        assert (fl["grad_compression"], fl["param_delta_window"]) == ("int8", 4)
        assert all(len(v) == 12 for v in fl["codec_steps_s"].values())
        for part, phase in (("push_encode", "push"), ("pull_decode", "pull")):
            assert all(0 <= a <= b for a, b in zip(fl["codec_steps_s"][part],
                                                   fl["phase_steps_s"][phase])), part
        assert sum(fl["codec_steps_s"]["push_encode"]) > 0
        ledger = json.loads((out / f"fleet-worker-{k}.json").read_text("utf8"))
        assert ledger["counters"] == c and ledger["steps"] == 12
        assert len(ledger["step_losses"]) == 12 and "launches" in ledger
    assert results[0][1].step_losses[-1] < results[0][1].step_losses[0]


def test_fleet_models_load_in_jax_and_tag_the_same(fleet_run, data):
    out, _ = fleet_run
    for d in ("best-model", "last-model"):
        jnlp = J.Pipeline.from_disk(out / d)
        pnlp = P.Pipeline.from_disk(out / d, device="cpu")
        for eg in list(pcorpus.Corpus(data / "dev.jsonl")())[:10]:
            text = " ".join(eg.reference.words)
            assert pnlp(text).tags == jnlp(text).tags
    meta = json.loads((out / "last-model" / "train_meta.json").read_text("utf8"))
    assert meta["step"] == 12 and meta["format"] == 2 and meta["opt_shards"] == 2


def test_resume_continues_a_fleet_generation(fleet_run, data, tagger_config_text, tmp_path):
    """The fleet run's last generation (step 12) holds one optimizer part per
    owner, each written by its owner; a one-process ``train(resume=True)``
    continues it to step 14 with the parts' moments and count, and a fleet
    ``resume=True`` starts each owner at its version and moments."""
    out, results = fleet_run
    meta = json.loads((out / "last-model" / "train_meta.json").read_text("utf8"))
    parts = [f"opt_state-12.part{k}of2.npz" for k in (0, 1)]
    assert set(meta["digests"]) == {"params-12.npz", *parts}
    assert [results[k][1].fleet["opt_parts"][-1] for k in (0, 1)] == parts
    assert results[0][1].fleet["generations"] == [6, 12]
    # the lead cuts the generation as soon as its own owner has applied the
    # round; the peer's owner may still be one round behind (JAX's too)
    versions = meta["extra"]["fleet"]["versions"]
    assert versions[0] == 12 and versions[1] in (11, 12), versions
    # each worker's seed generator as hex; the meta's own rng is the lead's,
    # which a one-process resume takes (ROADMAP C53, C54)
    rngs = meta["extra"]["fleet"]["rngs"]
    assert meta["rng"] == rngs[0] != rngs[1]
    assert all(len(bytes.fromhex(r)) == torch.Generator().get_state().numel() for r in rngs)
    assert int(PCheckpoint.load(out / "last-model")["opt_state"]["count"]) == 12
    one, fleet = tmp_path / "one", tmp_path / "fleet"
    for d in (one, fleet):
        shutil.copytree(out, d)
    cfg = _config(P, tagger_config_text, data, **{"training.max_steps": 14,
                                                  "training.eval_frequency": 2})
    _, r = p_train(cfg, one, device="cpu", resume=True, stdout_log=False)
    assert r.final_step == 14 and len(r.step_losses) == 2
    after = PCheckpoint.load(one / "last-model")
    assert (after["step"], after["format"], int(after["opt_state"]["count"])) == (14, 1, 14)
    resumed = run_thread_fleet(pworker.train_fleet_worker, cfg, fleet, 2, quorum=2, staleness=0,
                               device="cpu", resume=True)
    for k, (_, r) in resumed.items():
        fl = r.fleet
        assert (fl["resumed_from"], fl["version"], r.final_step) == (12, versions[k] + 2, 14)
        assert (fl["owner_epochs"][0]["opt_source"], fl["owner_epochs"][0]["version_start"]) \
            == ("checkpoint", versions[k])
    gen = PCheckpoint.load(fleet / "last-model")
    assert (gen["step"], gen["format"], int(gen["opt_state"]["count"])) == (14, 2, 14)


def test_peers_follow_the_lead_and_the_peer_timeout_reaches_the_clients(
        data, tagger_config_text, tmp_path, monkeypatch):
    # the lead stops at 6 steps and finalizes; the other worker, at quorum 1
    # and S 1, stops soon after instead of training on to 400; both
    # workers' peer clients take [training] fleet_peer_timeout_s, and the
    # clients of their membership threads' liveness probes
    # fleet_probe_timeout_s
    timeouts = []

    class Recording(pworker._PeerClient):
        def __init__(self, url, timeout=10.0):
            timeouts.append(timeout)
            super().__init__(url, timeout)

    monkeypatch.setattr(pworker, "_PeerClient", Recording)
    cfg = _config(P, tagger_config_text, data, **{"training.max_steps": 400,
                                                  "training.eval_frequency": 4,
                                                  "training.fleet_peer_timeout_s": 37.5,
                                                  "training.fleet_probe_timeout_s": 2.5})
    results = run_thread_fleet(pworker.train_fleet_worker, cfg, tmp_path / "out", 2, quorum=1,
                               staleness=1, device="cpu",
                               overrides={0: {"max_steps_override": 6}})
    assert results[0][1].final_step == 6
    assert results[1][1].final_step < 100, results[1][1].final_step
    # ... and the lead's /checkpoint client the CHECKPOINT_TIMEOUT_S of its own
    assert sorted(timeouts) == [2.5, 2.5, 37.5, 37.5, pworker.CHECKPOINT_TIMEOUT_S]
    assert pworker.CHECKPOINT_TIMEOUT_S == 600.0


def test_fleet_worker_without_a_card_raises(data, tagger_config_text, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(P, tagger_config_text, data)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pworker.train_fleet_worker(cfg, None, worker_id=0, n_workers=2, device=device,
                                       port=0, peer_urls=["http://127.0.0.1:1"] * 2)


def test_a_config_the_fleet_cannot_train_is_refused(data, tagger_config_text):
    for over, match in (({"training.accumulate_gradient": 2}, "accumulate_gradient"),
                        ({"training.frozen_components": ["tagger"]}, "frozen_components"),
                        ({"training.optimizer.use_averages": True}, "use_averages")):
        cfg = _config(P, tagger_config_text, data, **over)
        with pytest.raises(ValueError, match=match):
            pworker.train_fleet_worker(cfg, None, worker_id=0, n_workers=2, device="cpu",
                                       port=0, peer_urls=["http://127.0.0.1:1"] * 2)
    with pytest.raises(ValueError, match="quorum"):
        pworker.train_fleet_worker(_config(P, tagger_config_text, data), None, worker_id=0,
                                   n_workers=2, quorum=3, device="cpu")


class Killed(RuntimeError):
    pass


def test_an_int8_fleet_that_loses_a_worker_resets_its_residuals_and_pulls_whole(
        data, tagger_config_text, tmp_path, monkeypatch):
    """Three workers as threads on the int8 wire with delta pulls (width 32,
    24 steps, lease 1 s, 2 misses, probes every 0.2 s); worker 2 raises at its
    2nd step. The survivors re-shard at epoch 1: each resets its push
    residuals (none left after), its first pull from each peer at the new
    epoch is a full frame from nothing known, deltas follow, and each owner
    applied + discarded <= received. From their 8th step the survivors wait
    (at most 60 s) for the eviction's ledger row."""
    out = tmp_path / "out"
    cfg = _config(P, tagger_config_text, data, **{"components.tok2vec.model.width": 32,
                                                  "training.max_steps": 24,
                                                  "training.eval_frequency": 8})
    real_loss, calls = PPipeline.loss, {}

    def loss(self, *a, **kw):
        me = int(threading.current_thread().name.rsplit("-", 1)[1])
        calls[me] = calls.get(me, 0) + 1
        if me == 2 and calls[me] == 2:
            raise Killed("worker 2 killed at its step 2")
        if calls[me] >= 8:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not any(
                    r.get("event") == "evict"
                    for r in read_membership_ledger(out / "fleet-membership.jsonl")):
                time.sleep(0.05)
        return real_loss(self, *a, **kw)

    pulls, resets = [], []
    real_request, real_reset = pworker._PeerClient.request, pwire.GradCompressor.reset

    def request(self, method, path, *a, **kw):
        reply = real_request(self, method, path, *a, **kw)
        if path.startswith("/params") and reply[0] == 200:
            pulls.append((threading.current_thread().name, self.port, path,
                          (kw.get("headers") or {}).get("X-SRT-Epoch"),
                          reply[1].get("X-SRT-Codec")))
        return reply

    def reset(self):
        held = len(self._residual)
        real_reset(self)
        resets.append((threading.current_thread().name, held, len(self._residual)))

    monkeypatch.setattr(PPipeline, "loss", loss)
    monkeypatch.setattr(pworker._PeerClient, "request", request)
    monkeypatch.setattr(pwire.GradCompressor, "reset", reset)
    ports = _free_ports(3)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    results, errors = {}, {}

    def run(k):
        try:
            results[k] = pworker.train_fleet_worker(
                cfg, out, worker_id=k, n_workers=3, quorum=0, max_staleness=1, port=ports[k],
                peer_urls=urls, device="cpu", stdout_log=False, quorum_wait_s=60.0,
                peer_lease_s=1.0, lease_miss_threshold=2, lease_poll_s=0.2,
                grad_compression="int8", param_delta_window=4)
        except Exception as e:  # the victim's, checked below
            errors[k] = e

    threads = [threading.Thread(target=run, args=(k,), name=f"fleet-int8-{k}") for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not [t.name for t in threads if t.is_alive()], "fleet workers wedged"
    assert set(errors) == {2} and isinstance(errors[2], Killed), errors
    for k in (0, 1):
        fleet = results[k][1].fleet
        assert fleet["membership_epoch"] == 1 and fleet["active"] == [0, 1], fleet
        assert (fleet["grad_compression"], fleet["param_delta_window"]) == ("int8", 4)
        c = fleet["counters"]
        assert c["grad_applied"] + c["grad_discarded"] <= c["grad_received"], c
        assert c["wire_push_bytes"] <= 0.30 * c["wire_push_bytes_uncompressed"], c
        name = f"fleet-int8-{k}"
        mine = [r for r in resets if r[0] == name]
        assert len(mine) == 1 and mine[0][1] > 0 and mine[0][2] == 0, resets
        peer_port = ports[1 - k]
        after = [(path, codec) for t, port, path, epoch, codec in pulls
                 if t == name and port == peer_port and epoch == "1"]
        assert after and after[0] == ("/params?known=-1", "f32"), after[:3]
        assert "delta" in [codec for _, codec in after[1:]], after
        before = [codec for t, port, _, epoch, codec in pulls
                  if t == name and port == peer_port and epoch == "0"]
        assert "delta" in before, before


def test_a_reshard_carves_the_adopted_moments_from_the_generation(data, tagger_config_text,
                                                                 tmp_path, monkeypatch):
    """Three workers as threads (width 32, 24 steps evaluated every 8, lease
    1 s, 2 misses, probes every 0.2 s); worker 2 raises at its 10th step,
    once the generation of step 8 is committed. Each survivor's re-shard
    carves its moments from that generation (``opt_source`` "checkpoint" at
    step 8, on its owner row and its ``apply`` row) instead of starting
    them fresh. Then, from that generation, each survivor's first apply after
    the re-shard matches JAX's owner carved by JAX's
    ``local_opt_from_canonical`` from the same moments, within 1e-6 x each
    leaf's max |value| (``test_first_apply_after_a_reshard_matches_jax``'s
    measure)."""
    out = tmp_path / "out"
    cfg = _config(P, tagger_config_text, data, **{"components.tok2vec.model.width": 32,
                                                  "training.max_steps": 24,
                                                  "training.eval_frequency": 8,
                                                  "training.keep_checkpoints": 5})
    real_loss, calls = PPipeline.loss, {}

    def loss(self, *a, **kw):
        me = int(threading.current_thread().name.rsplit("-", 1)[1])
        calls[me] = calls.get(me, 0) + 1
        if me == 2 and calls[me] == 10:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not (
                    out / "last-model" / "train_meta-8.json").exists():
                time.sleep(0.05)
            raise Killed("worker 2 killed at its step 10")
        if me != 2 and calls[me] >= 12:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not any(
                    r.get("event") == "evict"
                    for r in read_membership_ledger(out / "fleet-membership.jsonl")):
                time.sleep(0.05)
        return real_loss(self, *a, **kw)

    monkeypatch.setattr(PPipeline, "loss", loss)
    ports = _free_ports(3)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    results, errors = {}, {}

    def run(k):
        try:
            results[k] = pworker.train_fleet_worker(
                cfg, out, worker_id=k, n_workers=3, quorum=0, max_staleness=1, port=ports[k],
                peer_urls=urls, device="cpu", stdout_log=False, quorum_wait_s=60.0,
                peer_lease_s=1.0, lease_miss_threshold=2, lease_poll_s=0.2)
        except Exception as e:  # the victim's, checked below
            errors[k] = e

    threads = [threading.Thread(target=run, args=(k,), name=f"fleet-carve-{k}")
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not [t.name for t in threads if t.is_alive()], "fleet workers wedged"
    assert set(errors) == {2} and isinstance(errors[2], Killed), errors
    applies = {r["worker"]: r for r in read_membership_ledger(out / "fleet-membership.jsonl")
               if r["event"] == "apply"}
    for k in (0, 1):
        fleet = results[k][1].fleet
        assert fleet["membership_epoch"] == 1 and fleet["active"] == [0, 1], fleet
        epochs = fleet["owner_epochs"]
        assert [(e["epoch"], e["opt_source"], e["opt_step"]) for e in epochs] == \
            [(0, "init", None), (1, "checkpoint", 8)]
        assert (applies[k]["opt_source"], applies[k]["opt_step"]) == ("checkpoint", 8)
        c = fleet["counters"]
        assert c["grad_applied"] + c["grad_discarded"] <= c["grad_received"], c
        assert epochs[1]["applies"] > 0
    # the first apply after the re-shard from generation 8, against JAX's
    gen = PCheckpoint._load_generation(out / "last-model", json.loads(
        (out / "last-model" / "train_meta-8.json").read_text("utf8")))
    assert gen["format"] == 2 and gen["extra"]["fleet"]["active"] == [0, 1, 2]
    template = pown.tree_from_flat(gen["params"])
    hyper = {"learn_rate": 0.001, "beta1": 0.9, "beta2": 0.999, "grad_clip": 1.0}
    jtx = jopt.Adam(**hyper)
    owner_tx = jopt.OptimizerWrapper(
        make_fused_transformation(reference_tx=jtx.tx, **{**jtx.fusable, "grad_clip": 0.0}))
    owner_tx.applies_updates = True
    p_owner_opt, _ = pworker.owner_optimizer(popt.Adam(**hyper))
    after, jafter = pmem.Membership([0, 1]).layout(template), jmem.Membership([0, 1]).layout(
        template)
    jcanon = jax_opt_tree(owner_tx, template, gen["opt_state"])
    rng = np.random.default_rng(11)
    for w in (0, 1):
        slices = after.flat_slices(template, w)
        sa = pworker.SliceApply(p_owner_opt, torch.device("cpu"))
        pparams, pstate = sa.init(slices, pown.local_opt_from_canonical(
            p_owner_opt, after, gen["opt_state"], w, slices))
        assert pstate["count"] == int(gen["opt_state"]["count"]) > 0
        powner = ppeer.OwnerState(worker_id=w, n_workers=3, quorum=1, max_staleness=1,
                                  apply_fn=sa, slice_params=pparams, opt_state=pstate,
                                  counters=ppeer.FleetCounters(), version=17)
        jslice = jafter.slice_tree(template, w)
        jowner = jpeer.OwnerState(
            worker_id=w, n_workers=3, quorum=1, max_staleness=1,
            apply_fn=make_shard_apply(owner_tx, donate=False),
            slice_params=jax.tree_util.tree_map(jnp.asarray, jslice),
            opt_state=jown.local_opt_from_canonical(owner_tx, jafter, jcanon, w, jslice),
            counters=jpeer.FleetCounters(), version=17)
        for sender, stamp in ((0, 17), (1, 18), (0, 17)):
            g = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
                 for k, v in pparams.items()}
            assert powner.submit(sender, stamp, g) == jowner.submit(sender, stamp, g)
        assert powner.version == jowner.version == 19
        pflat, jflat = powner.current_flat()[1], jowner.current_flat()[1]
        assert sorted(pflat) == sorted(jflat) == sorted(slices)
        for k in jflat:
            scale = max(np.abs(jflat[k]).max(), 1e-30)
            assert np.abs(pflat[k] - jflat[k]).max() <= 1e-6 * scale, (w, k)


def test_the_error_feedback_ablation_keeps_no_residual(data, tagger_config_text, monkeypatch):
    # grad_error_feedback=False (JAX's ablation control) reaches each worker's
    # compressor: its int8 pushes carry no residual from round to round
    made = []
    real_init = pwire.GradCompressor.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(pwire.GradCompressor, "__init__", init)
    cfg = _config(P, tagger_config_text, data, **{"components.tok2vec.model.width": 32,
                                                  "training.max_steps": 3,
                                                  "training.eval_frequency": 100})
    results = run_thread_fleet(pworker.train_fleet_worker, cfg, None, 2, quorum=2, staleness=0,
                               device="cpu", peer_lease_s=0, grad_compression="int8",
                               grad_error_feedback=False)
    assert len(made) == 2 and all(not c.error_feedback and not c._residual for c in made)
    for _, r in results.values():
        c = r.fleet["counters"]
        assert c["grad_pushed"] == 3 and c["wire_push_bytes"] <= 0.30 * c[
            "wire_push_bytes_uncompressed"]


def test_grad_compression_and_delta_window_flags_reach_the_worker(monkeypatch, tmp_path):
    import inspect

    from spacy_ray_tpu_torch.__main__ import train_command
    from spacy_ray_tpu_torch.training.fleet import coordinator as pcoord

    pk = inspect.signature(pworker.train_fleet_worker).parameters
    jk = inspect.signature(j_worker).parameters
    for name in ("grad_compression", "param_delta_window", "grad_error_feedback"):
        assert pk[name].default == jk[name].default, name
    seen = {}

    def fake_train(config, output, *, device, resume, fleet):
        seen.clear()
        seen.update(fleet)
        raise SystemExit(0)

    monkeypatch.setattr("spacy_ray_tpu_torch.training.loop.train", fake_train)
    cfg = tmp_path / "c.cfg"
    cfg.write_text("[nlp]\npipeline = []\n", encoding="utf8")
    argv = [str(cfg), "--device", "cpu", "--fleet-workers", "2", "--fleet-worker-id", "1"]
    with pytest.raises(SystemExit):
        train_command(argv)
    assert (seen["grad_compression"], seen["param_delta_window"]) == ("auto", 4)
    for codec in ("auto", "f32", "bf16", "int8"):
        with pytest.raises(SystemExit):
            train_command(argv + ["--grad-compression", codec, "--param-delta-window", "0"])
        assert (seen["grad_compression"], seen["param_delta_window"]) == (codec, 0)
    for bad in (["--grad-compression", "zstd"], ["--param-delta-window", "-1"],
                ["--param-delta-window", "x"]):
        with pytest.raises(SystemExit) as e:
            train_command(argv + bad)
        assert e.value.code == 2, bad
    # the coordinator hands each worker its own argv, the flags with it
    child = pcoord.worker_cmd([str(cfg), "--grad-compression", "bf16",
                               "--param-delta-window", "2"], 1)
    assert child[-6:] == ["--grad-compression", "bf16", "--param-delta-window", "2",
                          "--fleet-worker-id", "1"]


# ---------------------------------------------------------------- the coordinator


def _cli(cfg_path, data, out, port, *extra, steps=4):
    return [sys.executable, "-m", "spacy_ray_tpu_torch", "train", str(cfg_path), "--device",
            "cpu", "--output", str(out), "--paths.train", str(data / "train.jsonl"),
            "--paths.dev", str(data / "dev.jsonl"), "--training.max_steps", str(steps),
            "--training.eval_frequency", "2", "--fleet-workers", "2", "--quorum", "2",
            "--max-staleness", "0", "--fleet-base-port", str(port), *extra]


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def _children(pid):
    out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(pid)], capture_output=True,
                         text=True)
    return [int(x) for x in out.stdout.split()]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    with open(f"/proc/{pid}/stat") as f:  # a zombie is gone
        return f.read().split()[2] != "Z"


def _two_free_consecutive_ports():
    for _ in range(50):
        base = _free_ports(1)[0]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            continue
    raise RuntimeError("no two consecutive free ports")


@pytest.fixture(scope="module")
def cfg_path(tagger_config_text, tmp_path_factory):
    p = tmp_path_factory.mktemp("fleet_cli") / "tagger.cfg"
    p.write_text(tagger_config_text, encoding="utf8")
    return p


def test_cli_fleet_trains_as_two_processes(cfg_path, data, tmp_path):
    out = tmp_path / "out"
    res = subprocess.run(_cli(cfg_path, data, out, _two_free_consecutive_ports()), cwd=REPO,
                         capture_output=True, text=True, timeout=JOIN_S, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Done. steps=4" in res.stdout and "Done. fleet worker 1: steps=4" in res.stdout
    for k in (0, 1):
        ledger = json.loads((out / f"fleet-worker-{k}.json").read_text("utf8"))
        assert ledger["version"] == 4 and ledger["counters"]["grad_discarded"] == 0
    assert (out / "best-model" / "params.npz").exists()


def test_cli_coordinator_ends_when_a_worker_is_killed(cfg_path, data, tmp_path):
    # --peer-lease-s 1: worker 1 is SIGKILLed once training is under way; at
    # quorum 2 worker 0 cannot step on until it evicts it (lease 1 s, 3 missed
    # probes 2 s apart), re-shards over itself alone at quorum 1 and finishes;
    # the coordinator reports the degraded success
    out = tmp_path / "out"
    steps = 60
    proc = subprocess.Popen(_cli(cfg_path, data, out, _two_free_consecutive_ports(),
                                 "--peer-lease-s", "1", "--training.eval_frequency", "10",
                                 steps=steps), cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=_env())
    try:
        deadline = time.monotonic() + JOIN_S
        while len(_children(proc.pid)) < 2 and time.monotonic() < deadline:
            time.sleep(0.2)
        kids = _children(proc.pid)
        assert len(kids) == 2
        while not (out / "best-model").exists() and time.monotonic() < deadline:
            time.sleep(0.2)  # training is under way
        worker_1 = next(k for k in kids
                        if Path(f"/proc/{k}/cmdline").read_bytes().split(b"\0")[-2:-1] == [b"1"])
        os.kill(worker_1, signal.SIGKILL)
        # stated bound: the eviction within ~7 s, then 50 steps of one worker
        rc = proc.wait(timeout=150)
        err = proc.stderr.read()
        assert rc == 0, err[-3000:]
        assert "fleet-degraded-success" in err
        assert not [k for k in kids if _alive(k)]
    finally:
        if proc.poll() is None:
            proc.kill()
    rows = read_membership_ledger(out / "fleet-membership.jsonl")
    evicts = [r for r in rows if r["event"] == "evict"]
    assert evicts and evicts[0]["evicted"] == [1] and evicts[0]["active"] == [0], rows
    assert [r["worker"] for r in rows if r["event"] == "apply"] == [0]
    ledger = json.loads((out / "fleet-worker-0.json").read_text("utf8"))
    assert ledger["steps"] == steps and ledger["membership_epoch"] == 1
    assert ledger["active"] == [0] and ledger["quorum"] == 1
    assert ledger["counters"]["evictions"] == 1 and ledger["counters"]["shards_adopted"] > 0
    assert not (out / "fleet-worker-1.json").exists()


def test_cli_coordinator_relays_sigterm_and_returns_75(cfg_path, data, tmp_path):
    proc = subprocess.Popen(_cli(cfg_path, data, tmp_path / "out", _two_free_consecutive_ports(),
                                 steps=100000), cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())
    try:
        deadline = time.monotonic() + JOIN_S
        while not (tmp_path / "out" / "best-model").exists() and time.monotonic() < deadline:
            time.sleep(0.2)
        kids = _children(proc.pid)
        assert len(kids) == 2
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=150)
        assert proc.returncode == 75, err[-3000:]
        assert "Interrupted at step" in out
        assert not [k for k in kids if _alive(k)]
    finally:
        if proc.poll() is None:
            proc.kill()


def test_a_taken_base_port_fails_with_its_number(data, tagger_config_text):
    # worker k binds base + k and raises with that port; no other is chosen
    cfg = _config(P, tagger_config_text, data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        base = s.getsockname()[1]
        with pytest.raises(OSError, match=f"127.0.0.1:{base} .*--fleet-base-port"):
            pworker.train_fleet_worker(cfg, None, worker_id=0, n_workers=2, device="cpu",
                                       base_port=base)


def test_cli_restarts_a_killed_worker_which_resumes_and_rejoins(cfg_path, data, tmp_path):
    """``train --fleet-workers 2 --max-restarts 1`` at quorum 1, S 1, a
    generation every 5 steps: worker 1 is SIGKILLed once a generation is
    committed and its version is >= 3. Its supervisor starts it again with
    ``--resume``; it resumes the newest generation (one committed before the
    kill: the lead's later ones abort while it is down) and rejoins while
    the lead steps on alone; the fleet exits 0 with one ``supervisor-restart``
    and applied + discarded <= received on every worker."""
    out = tmp_path / "out"
    base = _two_free_consecutive_ports()
    proc = subprocess.Popen(_cli(cfg_path, data, out, base, "--max-restarts", "1", "--quorum",
                                 "1", "--max-staleness", "1", "--training.eval_frequency", "5",
                                 steps=300), cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=_env())

    def version_of_1():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{base + 1}/healthz", timeout=2) as r:
                return json.loads(r.read()).get("version")
        except (OSError, ValueError):
            return None

    try:
        deadline = time.monotonic() + JOIN_S
        while time.monotonic() < deadline and not (
                (out / "last-model" / "train_meta.json").exists()
                and (version_of_1() or 0) >= 3):
            time.sleep(0.1)
        committed = PCheckpoint.generation_stamps(out / "last-model")
        assert committed, "no generation before the kill"
        worker_1 = next(k for k in _children(proc.pid)
                        if Path(f"/proc/{k}/cmdline").read_bytes().split(b"\0")[-2:-1] == [b"1"])
        os.kill(worker_1, signal.SIGKILL)
        rc = proc.wait(timeout=150)
        err = proc.stderr.read()
        assert rc == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert err.count("[supervisor-restart]") == 1, err[-3000:]
    resumed = re.findall(r"\[fleet-resume\] worker 1 resumed from checkpoint step (\d+) "
                         r"\(shard version (\d+)\)", err)
    assert len(resumed) == 1, err[-3000:]
    step, version = map(int, resumed[0])
    assert step >= committed[-1] and step % 5 == 0 and version > 0
    ledgers = {k: json.loads((out / f"fleet-worker-{k}.json").read_text("utf8")) for k in (0, 1)}
    assert ledgers[1]["resume"] and ledgers[1]["resumed_from"] == step
    first = ledgers[1]["owner_epochs"][0]
    assert (first["opt_source"], first["version_start"]) == ("checkpoint", version)
    assert ledgers[0]["steps"] == 300 and ledgers[1]["version"] > version
    for led in ledgers.values():
        c = led["counters"]
        assert c["grad_applied"] + c["grad_discarded"] <= c["grad_received"], c
    assert ledgers[0]["counters"]["push_failed"] > 0  # the lead stepped on while it was down


def test_sigterm_to_a_one_process_run_writes_a_generation_and_resumes_bit_exactly(
        cfg_path, data, tmp_path, tagger_config_text):
    """SIGTERM to a one-process ``train`` (no fleet) stops it at the next step
    boundary with that step's generation written and exit 75 (JAX's
    ``tests/test_checkpoint_fallback.py`` preemption drill); ``--resume``
    continues it, and its final parameters equal, bit for bit, those of one
    run to the same step without the stop."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "spacy_ray_tpu_torch", "train", str(cfg_path), "--device",
           "cpu", "--output", str(out), "--paths.train", str(data / "train.jsonl"),
           "--paths.dev", str(data / "dev.jsonl"), "--training.eval_frequency", "5"]
    proc = subprocess.Popen(cmd + ["--training.max_steps", "100000"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env())
    try:
        deadline = time.monotonic() + JOIN_S
        while time.monotonic() < deadline and not (out / "last-model" / "train_meta.json").exists():
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, stderr[-3000:]
    stopped = int(re.search(r"Interrupted at step (\d+)", stdout).group(1))
    assert "[preempted] shutdown signal at step" in stderr
    gen = PCheckpoint.load(out / "last-model")
    assert gen["step"] == stopped and gen["format"] == 1
    steps = stopped + 7
    res = subprocess.run(cmd + ["--resume", "--training.max_steps", str(steps)], cwd=REPO,
                         capture_output=True, text=True, timeout=JOIN_S, env=_env())
    assert res.returncode == 0 and f"Done. steps={steps}" in res.stdout, res.stderr[-3000:]
    cfg = _config(P, tagger_config_text, data, **{"training.max_steps": steps,
                                                  "training.eval_frequency": 5})
    p_train(cfg, tmp_path / "straight", device="cpu", stdout_log=False)
    with np.load(out / "last-model" / "params.npz") as a, \
            np.load(tmp_path / "straight" / "last-model" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
