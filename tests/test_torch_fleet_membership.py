"""The trainer fleet's elastic membership in the port against the JAX
package, on the CPU: the lease verdicts on fake clocks, ``Membership`` and
its wire form, ``RankedLayout`` over configs/cnn.cfg's parameters, the
pull backoff, the ledger, the epoch fences of the peer server and their
counters, a JAX lead's broadcast adopted by a port server, the first owner
apply after a re-shard, the coordinator's exit codes, and a thread fleet of
three workers that loses one (worker 2, then the lead) and finishes.

Tolerances: verdicts, memberships, layouts, wire bodies, replies and
counters exactly; the owner apply after a re-shard (K5's plain version)
within 1e-6 x each leaf's max |value| of JAX's shard apply, the measure of
``test_owner_slice_apply_matches_jax_shard_apply``.
"""

import inspect
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from spacy_ray_tpu.ops.fused_update import make_fused_transformation
from spacy_ray_tpu.parallel.step import make_shard_apply
from spacy_ray_tpu.training import optimizers as jopt
from spacy_ray_tpu.training.checkpoint import Checkpoints as JCheckpoints
from spacy_ray_tpu.training.fleet import coordinator as jcoord
from spacy_ray_tpu.training.fleet import membership as jmem
from spacy_ray_tpu.training.fleet import peer as jpeer
from spacy_ray_tpu.training.fleet import wire as jwire
from spacy_ray_tpu.training.fleet.worker import _PeerClient as JClient
from spacy_ray_tpu.training.fleet.worker import train_fleet_worker as j_worker
from spacy_ray_tpu.util import write_synth_jsonl

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.__main__ import train_command
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.pipeline.language import Pipeline as PPipeline
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint as PCheckpoint
from spacy_ray_tpu_torch.training.fleet import coordinator as pcoord
from spacy_ray_tpu_torch.training.fleet import membership as pmem
from spacy_ray_tpu_torch.training.fleet import ownership as pown
from spacy_ray_tpu_torch.training.fleet import peer as ppeer
from spacy_ray_tpu_torch.training.fleet import worker as pworker
from spacy_ray_tpu_torch.udgen import write_ud_jsonl

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 240  # each thread join: the test workers share the cores
PKGS = (jmem, pmem)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# ---------------------------------------------------------------- LeaseTracker

#: JAX's fake-clock sequences (tests/test_fleet_membership.py) as scripts:
#: ("adv", s), ("obs", peer, ok), ("add", peer), ("rm", peer), ("dead", peer),
#: ("expired",), ("peers",); the outputs of both trackers are compared
SLOW_BUT_ANSWERING = [op for _ in range(50) for op in (
    ("adv", 9.9), ("obs", 1, False), ("obs", 1, False), ("dead", 1), ("obs", 1, True),
    ("dead", 1))] + [("obs", 1, False)] * 10 + [("obs", 1, True), ("adv", 9.0), ("dead", 1)]
LEASE_SCRIPTS = {
    "both_factors": ([1, 2], 10.0, 3, [
        ("adv", 11.0), ("dead", 1), ("obs", 2, True), *[("obs", 2, False)] * 5, ("dead", 2),
        *[("obs", 1, False)] * 3, ("dead", 1), ("expired",)]),
    "slow_but_answering": ([1], 10.0, 3, SLOW_BUT_ANSWERING),
    "startup_grace_add_remove": ([1], 5.0, 2, [
        ("adv", 3.0), ("add", 3), ("obs", 3, False), ("obs", 3, False), ("adv", 3.0),
        ("dead", 3), ("adv", 3.0), ("dead", 3), ("rm", 3), ("dead", 3), ("peers",),
        ("obs", 3, False), ("peers",), ("expired",)]),
}


def run_lease(pkg, peers, lease_s, misses, script):
    clock = FakeClock()
    tr = pkg.LeaseTracker(peers, lease_s=lease_s, miss_threshold=misses, clock=clock)
    outputs = []
    for op, *args in script:
        if op == "adv":
            clock.advance(*args)
        elif op == "obs":
            tr.observe(*args)
        elif op == "add":
            tr.add(*args)
        elif op == "rm":
            tr.remove(*args)
        elif op == "dead":
            outputs.append(("dead", args[0], tr.dead(args[0])))
        else:
            outputs.append((op, getattr(tr, op)()))
    return outputs


@pytest.mark.parametrize("name", sorted(LEASE_SCRIPTS))
def test_lease_verdicts_equal_jax_on_a_fake_clock(name):
    peers, lease_s, misses, script = LEASE_SCRIPTS[name]
    want = run_lease(jmem, peers, lease_s, misses, script)
    assert run_lease(pmem, peers, lease_s, misses, script) == want
    verdicts = [out[2] for out in want if out[0] == "dead"]
    if name == "slow_but_answering":
        assert not any(verdicts)  # a worker that keeps answering is never evicted
    else:
        assert any(verdicts) and not all(verdicts)


def test_lease_tracker_refuses_what_jax_refuses():
    for kw in ({"lease_s": 0.0}, {"lease_s": -1.0}, {"lease_s": 5.0, "miss_threshold": 0}):
        for pkg in PKGS:
            with pytest.raises(ValueError):
                pkg.LeaseTracker([1], **kw)


# ---------------------------------------------------------------- Membership


def test_membership_evict_admit_and_wire_equal_jax():
    ops = [("evict", 0), ("admit", 0), ("evict", 2), ("evict", 1), ("admit", 2)]
    ms = {pkg: [pkg.Membership(range(3))] for pkg in PKGS}
    for op, w in ops:
        for pkg, chain in ms.items():
            chain.append(getattr(chain[-1], op)(w))
    for jm, pm in zip(ms[jmem], ms[pmem]):
        assert (pm.epoch, pm.active, pm.lead) == (jm.epoch, jm.active, jm.lead)
        assert pm.to_wire() == jm.to_wire()
        assert (0 in pm) == (0 in jm)
        # both ways over the wire's JSON
        assert pmem.Membership.from_wire(json.loads(json.dumps(jm.to_wire()))) == pm
        assert jmem.Membership.from_wire(json.loads(json.dumps(pm.to_wire()))) == jm
    assert [m.active for m in ms[pmem]] == [(0, 1, 2), (1, 2), (0, 1, 2), (0, 1), (0,), (0, 2)]
    assert ms[pmem][1].lead == 1  # the next-lowest survivor leads
    assert repr(ms[pmem][-1]) == repr(ms[jmem][-1])


BAD_WIRE = [None, [], "x", {"epoch": 1}, {"epoch": -1, "active": [0]},
            {"epoch": True, "active": [0]}, {"epoch": 1, "active": []},
            {"epoch": 1, "active": [0, "1"]}, {"epoch": 1, "active": [0, -2]},
            {"epoch": 1, "active": [True]}, {"epoch": 1.5, "active": [0]}]


@pytest.mark.parametrize("i", range(len(BAD_WIRE)))
def test_membership_from_wire_refuses_like_jax(i):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.Membership.from_wire(BAD_WIRE[i])


def test_membership_validation_errors_like_jax():
    cases = [lambda pkg: pkg.Membership([]), lambda pkg: pkg.Membership([0], epoch=-1),
             lambda pkg: pkg.Membership([1, 2], 1).evict(0),
             lambda pkg: pkg.Membership([5]).evict(5),
             lambda pkg: pkg.Membership(range(3)).admit(1)]
    for case in cases:
        msgs = []
        for pkg in PKGS:
            with pytest.raises(ValueError) as e:
                case(pkg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- RankedLayout


@pytest.fixture(scope="module")
def cnn_template(tmp_path_factory):
    """configs/cnn.cfg's parameter tree (the port's pipeline on the CPU),
    filled from a seed."""
    d = tmp_path_factory.mktemp("membership_cnn")
    write_ud_jsonl(d / "train.jsonl", 40, seed=0, max_sents=2)
    cfg = P.Config.from_disk(REPO / "configs" / "cnn.cfg")
    cfg["paths"] = {"train": str(d / "train.jsonl"), "dev": str(d / "train.jsonl")}
    nlp = PPipeline.from_config(cfg.interpolate(), device="cpu")
    from spacy_ray_tpu_torch.training.corpus import Corpus

    egs = list(Corpus(d / "train.jsonl")())
    nlp.initialize(lambda: egs, seed=0)
    rng = np.random.default_rng(7)
    flat = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
            for k, v in param_paths(nlp.model).items()}
    return pown.tree_from_flat(flat)


ACTIVE_SETS = ([0, 1, 2], [0, 2], [1])


@pytest.mark.parametrize("active", ACTIVE_SETS, ids=lambda a: "-".join(map(str, a)))
def test_ranked_layout_equals_jax_over_cnn_cfg(cnn_template, active):
    jl, pl = jmem.RankedLayout(cnn_template, active), pmem.RankedLayout(cnn_template, active)
    assert pl.signature() == jl.signature()
    assert pl.active == jl.active and pl.n_workers == jl.n_workers == len(active)
    assert pl.axes == jl.axes and pl.shapes == jl.shapes
    for w in range(3):
        assert pl.rank_of(w) == jl.rank_of(w)
        assert pl.owned_keys(w) == jl.owned_keys(w)
        pf, jf = pl.flat_slices(cnn_template, w), jl.flat_slices(cnn_template, w)
        assert list(pf) == list(jf)
        assert all(np.array_equal(pf[k], jf[k]) for k in jf)
        assert jax.tree_util.tree_structure(pl.slice_tree(cnn_template, w)) == \
            jax.tree_util.tree_structure(jl.slice_tree(cnn_template, w))
        for i, path in enumerate(pl.paths):
            key = "/".join(path)
            assert pl.owns(i, w) == jl.owns(i, w)
            if w in active:
                assert pl.key_index(key, w) == jl.key_index(key, w)
                assert pl.index(i, w) == jl.index(i, w)
            else:
                for lay in (pl, jl):
                    with pytest.raises(ValueError, match="not in the active set"):
                        lay.key_index(key, w)
    # the survivors' slices rebuild the whole tree; a worker outside owns nothing
    zeros = pown.tree_from_flat({pown.path_key(path): np.zeros_like(leaf)
                                 for path, leaf in pown.iter_leaves(cnn_template)})
    for w in active:
        pl.merge_flat(zeros, w, pl.flat_slices(cnn_template, w))
    for path, leaf in pown.iter_leaves(cnn_template):
        node = zeros
        for p in path:
            node = node[p]
        assert np.array_equal(node, leaf), path
    outside = next(w for w in range(4) if w not in active)
    assert pl.owned_keys(outside) == [] and pl.slice_tree(cnn_template, outside) == {}
    with pytest.raises(ValueError):
        pl.merge_flat(zeros, outside, {})


def test_ranked_layout_signatures_follow_the_active_set(cnn_template):
    sigs = {tuple(a): pmem.RankedLayout(cnn_template, a).signature()
            for a in ([0, 1], [0, 2], [0, 1, 2])}
    assert len(set(sigs.values())) == 3
    assert sigs[(0, 1)] == jmem.RankedLayout(cnn_template, [0, 1]).signature()
    with pytest.raises(ValueError):
        pmem.RankedLayout(cnn_template, [])


# ---------------------------------------------------------------- PeerBackoff, the ledger


def test_peer_backoff_delays_equal_jax():
    script = ["skip", "fail", "fail", "delay", "fail", "fail", "fail", "fail", "fail",
              "delay", "skip", ("adv", 5.0), "skip", "ok", "ok", "delay", "fail", "delay",
              ("adv", 0.5), "skip", ("adv", 0.6), "skip"]
    outs = []
    for pkg in PKGS:
        clock = FakeClock()
        b = pkg.PeerBackoff(base_s=1.0, cap_s=4.0, clock=clock)
        out = []
        for op in script:
            if isinstance(op, tuple):
                clock.advance(op[1])
            elif op == "fail":
                out.append(b.record_failure(7))
            elif op == "ok":
                out.append(b.record_success(7))
            elif op == "delay":
                out.append(b.current_delay(7))
            else:
                out.append(b.skip(7))
        outs.append(out)
    assert outs[1] == outs[0]
    # one event per outage, capped doubling, no wait mid-outage
    assert outs[0][:4] == [False, True, False, 2.0] and 4.0 in outs[0]


def test_membership_ledger_rows_like_jax(tmp_path):
    rows = {}
    for pkg in PKGS:
        path = tmp_path / pkg.__name__.split(".")[0] / "fleet-membership.jsonl"
        ledger = pkg.MembershipLedger(path)
        ledger.append("evict", lead=0, evicted=[2], epoch=1, active=[0, 1])
        ledger.append("apply", worker=1, epoch=1, active=[0, 1], resharded=3,
                      opt_source="fresh-init")
        with path.open("a", encoding="utf8") as f:
            f.write("{torn json\n\n[1, 2]\n")
        pkg.MembershipLedger(None).append("evict", epoch=1)  # no path: no file, no error
        rows[pkg] = path
    for reader in PKGS:
        got = [reader.read_membership_ledger(rows[pkg]) for pkg in PKGS]
        assert [{k: v for k, v in r.items() if k != "ts"} for r in got[0]] == \
            [{k: v for k, v in r.items() if k != "ts"} for r in got[1]]
        assert [r["event"] for r in got[1]] == ["evict", "apply"]
        assert all(isinstance(r["ts"], float) for r in got[1])
        assert reader.read_membership_ledger(tmp_path / "missing.jsonl") == []
    raw = [json.loads(line) for line in rows[pmem].read_text().splitlines()[:2]]
    assert list(raw[0]) == sorted(raw[0])  # sorted keys, as JAX writes them


# ---------------------------------------------------------------- the fences


def _server(pkg, epoch=0, active=(0, 1), quorum=1):
    counters = pkg.FleetCounters()
    owner = pkg.OwnerState(worker_id=1, n_workers=2, quorum=quorum, max_staleness=0,
                           apply_fn=lambda p, o, g: ({"x": p["x"] + g["x"]}, o),
                           slice_params={"x": np.zeros(4, np.float32)}, opt_state={},
                           counters=counters)
    server = pkg.PeerServer(owner, worker_id=1, layout_signature="sig", counters=counters)
    if epoch:
        server.set_membership(jmem.Membership(active, epoch) if pkg is jpeer
                              else pmem.Membership(active, epoch), "sig-e")
    host, port = server.start()
    return server, counters, f"http://{host}:{port}"


def _http(url, method, path, body=None, headers=None):
    req = urllib.request.Request(url + path, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _reply(status, headers, body):
    """(status, the X-SRT-Epoch header, the JSON body without a 400's
    free-text message, or a frame's arrays)."""
    try:
        payload = json.loads(body) if body else None
    except ValueError:
        payload = {k: v.tolist() for k, v in jwire.decode_arrays(body)[1].items()}
    if isinstance(payload, dict):
        payload.pop("message", None)
    return status, headers.get("X-SRT-Epoch"), payload


G = {"x": np.ones(4, np.float32)}
FENCE_REQUESTS = {
    "grad": [("POST", "/grad", jwire.encode_grads({"worker": 0, "stamp": 0, "epoch": 1}, G)),
             ("POST", "/grad", jwire.encode_grads({"worker": 0, "stamp": 0}, G)),
             ("POST", "/grad", jwire.encode_grads({"worker": 0, "stamp": 0, "epoch": 2}, G)),
             ("POST", "/grad", jwire.encode_grads({"worker": 0, "stamp": 1, "epoch": 3}, G))],
    "params": [("GET", "/params?known=-1", None, {"X-SRT-Epoch": "1"}),
               ("GET", "/params?known=-1", None, None),
               ("GET", "/params?known=-1", None, {"X-SRT-Epoch": "2"}),
               ("GET", "/params?known=0", None, {"X-SRT-Epoch": "2"}),
               ("GET", "/params?known=0", None, {"X-SRT-Epoch": "x"})],
    "membership": [
        ("POST", "/membership", json.dumps(jmem.Membership([0, 1, 2], 1).to_wire()).encode()),
        ("POST", "/membership", json.dumps(jmem.Membership([0, 1, 2], 2).to_wire()).encode()),
        ("POST", "/membership", json.dumps(jmem.Membership([0, 1], 5).to_wire()).encode()),
        ("POST", "/membership", json.dumps(jmem.Membership([0, 1], 4).to_wire()).encode()),
        ("POST", "/membership", b'{"epoch": 9}'), ("POST", "/membership", b"not json"),
        ("GET", "/membership", None),
        ("POST", "/membership/join", json.dumps({"worker": 2}).encode()),
        ("POST", "/membership/join", json.dumps({"worker": 2}).encode()),
        ("POST", "/membership/join", json.dumps({"worker": -1}).encode()),
        ("POST", "/membership/join", json.dumps({"worker": True}).encode()),
        ("POST", "/membership/join", b"{}")],
}


@pytest.mark.parametrize("route", sorted(FENCE_REQUESTS))
def test_epoch_fences_and_counters_equal_jax(route):
    """A port server and a JAX server at membership epoch 2 answer the same
    requests alike: /grad 200 with ``fenced`` for another epoch (an absent
    one is 0), /params 409 with the live epoch, POST /membership 409 for an
    epoch not newer, the highest queued epoch winning; the counters too."""
    got = {}
    for pkg in (jpeer, ppeer):
        server, counters, url = _server(pkg, epoch=2)
        try:
            replies = []
            for method, path, body, *hdr in FENCE_REQUESTS[route]:
                status, headers, data = _http(url, method, path, body, hdr[0] if hdr else None)
                replies.append(_reply(status, headers, data))
            pending = server.take_pending_membership()
            got[pkg] = (replies, counters.snapshot(), server.drain_join_requests(),
                        None if pending is None else (pending.epoch, pending.active),
                        server.epoch)
        finally:
            server.stop()
    (jr, jc, jj, jp, je), (pr, pc, pj, pp, pe) = got[jpeer], got[ppeer]
    assert pr == jr
    assert {k: pc[k] for k in pc} == {k: jc[k] for k in pc}
    assert (pj, pp, pe) == (jj, jp, je)
    if route == "grad":
        assert pc["epoch_fenced"] == 3 and pc["applies"] == 1
    elif route == "params":
        assert pc["epoch_fenced"] == 2 and [r[0] for r in pr] == [409, 409, 200, 204, 400]
    else:
        assert pc["epoch_fenced"] == 2 and pp == (5, (0, 1)) and pj == [2]


def test_a_jax_lead_broadcast_is_adopted_by_the_port():
    """JAX's own peer client posts a JAX ``Membership`` to a port server:
    it is queued, and once the worker sets it the server fences on it and
    advertises it as a JAX server does."""
    server, counters, url = _server(ppeer)
    jserver, _, jurl = _server(jpeer)
    try:
        m = jmem.Membership([0, 1], 1)
        status, _, reply = JClient(url).request("POST", "/membership",
                                                body=json.dumps(m.to_wire()).encode(),
                                                content_type="application/json")
        assert status == 200 and json.loads(reply) == {"adopted": True, "epoch": 1}
        assert server.pending_membership_epoch() == 1
        pm = server.take_pending_membership()
        assert isinstance(pm, pmem.Membership) and pm.to_wire() == m.to_wire()
        server.set_membership(pm, "sig-1")
        jserver.set_membership(m, "sig-1")
        for u in (url, jurl):
            assert JClient(u).request("GET", "/params?known=-1")[0] == 409
        got = [json.loads(_http(u, "GET", "/membership")[2]) for u in (url, jurl)]
        assert got[0] == got[1] == {"epoch": 1, "active": [0, 1], "lead": 0}
        health = json.loads(_http(url, "GET", "/healthz")[2])
        assert health["epoch"] == 1 and health["layout"] == "sig-1"
        assert json.loads(_http(url, "GET", "/metrics")[2])["gauges"]["membership_epoch"] == 1
        assert counters.snapshot()["epoch_fenced"] == 1
    finally:
        server.stop()
        jserver.stop()


# ---------------------------------------------------------------- the first apply after a re-shard


def test_first_apply_after_a_reshard_matches_jax(cnn_template):
    """From one host tree and the same pushes: the owner each survivor of
    [0, 1, 2] -> [0, 1] builds over its re-sharded slices (fresh moments, the
    version kept) applies as JAX's shard apply over the clip-free fused
    chain does, at the survivors' auto quorum of 1."""
    hyper = {"learn_rate": 0.001, "beta1": 0.9, "beta2": 0.999, "grad_clip": 1.0}
    jtx = jopt.Adam(**hyper)
    owner_tx = jopt.OptimizerWrapper(
        make_fused_transformation(reference_tx=jtx.tx, **{**jtx.fusable, "grad_clip": 0.0}))
    owner_tx.applies_updates = True
    p_owner_opt, _ = pworker.owner_optimizer(popt.Adam(**hyper))
    before = pmem.RankedLayout(cnn_template, [0, 1, 2])
    after, jafter = (pkg.Membership(range(3)).evict(2).layout(cnn_template) for pkg in PKGS)
    assert after.signature() == jafter.signature()
    rng = np.random.default_rng(11)
    quorum = pworker.resolve_quorum(0, len(after.active))
    assert quorum == 1
    for w in (0, 1):
        changed = [k for k in after.owned_keys(w)
                   if k not in before.owned_keys(w)
                   or before.key_index(k, w) != after.key_index(k, w)]
        assert changed  # the re-shard moved this survivor's slices
        sa = pworker.SliceApply(p_owner_opt, torch.device("cpu"))
        pparams, pstate = sa.init(after.flat_slices(cnn_template, w))
        pc, jc = ppeer.FleetCounters(), jpeer.FleetCounters()
        powner = ppeer.OwnerState(worker_id=w, n_workers=3, quorum=quorum, max_staleness=1,
                                  apply_fn=sa, slice_params=pparams, opt_state=pstate,
                                  counters=pc, version=17)
        jslice = jax.tree_util.tree_map(jnp.asarray, jafter.slice_tree(cnn_template, w))
        jowner = jpeer.OwnerState(worker_id=w, n_workers=3, quorum=quorum, max_staleness=1,
                                  apply_fn=make_shard_apply(owner_tx, donate=False),
                                  slice_params=jslice, opt_state=owner_tx.init(jslice),
                                  counters=jc, version=17)
        for sender, stamp in ((0, 17), (1, 18), (0, 17)):
            g = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
                 for k, v in pparams.items()}
            assert powner.submit(sender, stamp, g) == jowner.submit(sender, stamp, g)
        assert powner.version == jowner.version == 19
        pv, pflat = powner.current_flat()
        jv, jflat = jowner.current_flat()
        assert list(pflat) == list(jflat) == after.owned_keys(w)
        for k in jflat:
            scale = max(np.abs(jflat[k]).max(), 1e-30)
            assert np.abs(pflat[k] - jflat[k]).max() <= 1e-6 * scale, (w, k)
        assert pc.snapshot() == {k: v for k, v in jc.snapshot().items() if k in pc.snapshot()}
        # a retired owner (the re-shard after this one) applies no more
        powner.retire()
        assert powner.submit(1, 19, g) == (False, 19)
        assert pc.snapshot()["epoch_fenced"] == 1 and powner.version == 19


# ---------------------------------------------------------------- the coordinator, the CLI


@pytest.mark.parametrize("codes", [[0, 0, 0], [0, 137, 0], [137, 0], [75, 0, 137], [1, 137],
                                   [137, 137, 1], [0, 75]])
def test_coordinator_exit_codes_equal_jax(codes, monkeypatch):
    class Fake:
        made = []

        def __init__(self, build_cmd, max_restarts, grace_s=0.0):
            self.rc = codes[len(Fake.made)]
            Fake.made.append(self)

        def run(self):
            return self.rc

        def request_shutdown(self):
            pass

    monkeypatch.setattr(jcoord, "Supervisor", Fake)
    want = jcoord.run_fleet([], n_workers=len(codes), pin_cores=False)
    assert pcoord.fleet_exit_code(codes) == want
    assert want == (75 if 75 in codes else 0 if 0 in codes else codes[0])


def test_peer_lease_knobs_equal_jax_and_reach_the_worker(monkeypatch, tmp_path):
    pk = inspect.signature(pworker.train_fleet_worker).parameters
    jk = inspect.signature(j_worker).parameters
    for name in ("peer_lease_s", "lease_miss_threshold", "lease_poll_s", "probe_timeout_s"):
        assert pk[name].default == jk[name].default, name
    seen = {}

    def fake_train(config, output, *, device, resume, fleet):
        seen.update(fleet)
        raise SystemExit(0)

    monkeypatch.setattr("spacy_ray_tpu_torch.training.loop.train", fake_train)
    cfg = tmp_path / "c.cfg"
    cfg.write_text("[nlp]\npipeline = []\n", encoding="utf8")
    argv = [str(cfg), "--device", "cpu", "--fleet-workers", "3", "--fleet-worker-id", "1"]
    with pytest.raises(SystemExit):
        train_command(argv + ["--peer-lease-s", "2.5"])
    assert seen["peer_lease_s"] == 2.5 and seen["n_workers"] == 3
    with pytest.raises(SystemExit):
        train_command(argv)
    assert seen["peer_lease_s"] == 60.0
    with pytest.raises(SystemExit) as e:
        train_command(argv + ["--peer-lease-s", "-1"])
    assert e.value.code == 2


# ---------------------------------------------------------------- a thread fleet loses a worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("membership_data")
    write_synth_jsonl(d / "train.jsonl", 120, kind="tagger", seed=0)
    write_synth_jsonl(d / "dev.jsonl", 30, kind="tagger", seed=1)
    return d


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class Killed(RuntimeError):
    pass


@pytest.mark.parametrize("victim", [2, 0])
def test_thread_fleet_evicts_a_dead_worker_and_finishes(victim, data, tagger_config_text,
                                                         tmp_path, monkeypatch):
    """Three workers as threads (width 32, 24 steps, lease 1 s, 2 misses,
    probes every 0.2 s); ``victim`` raises at its 2nd step (its server goes
    down with it). The acting lead evicts it, the survivors re-shard at epoch
    1 with the quorum re-resolved over them (auto: 1), the ledger records the
    eviction and the applies, and the run ends with a finite model. With the
    lead dead, worker 1 leads and writes the final generation, which JAX's
    checkpoint reader reads with the same membership. From their 8th step
    the survivors' steps wait (at most 60 s) for the eviction's ledger row,
    so that the re-shard always comes before the end."""
    out = tmp_path / "out"
    cfg = P.Config.from_str(tagger_config_text).apply_overrides({
        "paths.train": str(data / "train.jsonl"), "paths.dev": str(data / "dev.jsonl"),
        "components.tok2vec.model.width": 32, "training.max_steps": 24,
        "training.eval_frequency": 8})
    real_loss = PPipeline.loss
    calls = {}

    def loss(self, *a, **kw):
        me = int(threading.current_thread().name.rsplit("-", 1)[1])
        calls[me] = calls.get(me, 0) + 1
        if me == victim and calls[me] == 2:
            raise Killed(f"worker {me} killed at its step 2")
        if calls[me] >= 8:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not any(
                    r.get("event") == "evict"
                    for r in pmem.read_membership_ledger(out / "fleet-membership.jsonl")):
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

    threads = [threading.Thread(target=run, args=(k,), name=f"fleet-mem-{k}")
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not [t.name for t in threads if t.is_alive()], "fleet workers wedged"
    survivors = [k for k in range(3) if k != victim]
    assert set(errors) == {victim} and isinstance(errors[victim], Killed), errors
    assert set(results) == set(survivors)
    lead = survivors[0]
    for k in survivors:
        fleet = results[k][1].fleet
        assert fleet["membership_epoch"] >= 1 and fleet["active"] == survivors, fleet
        assert fleet["quorum"] == 1
        assert fleet["counters"]["shards_adopted"] > 0
        assert results[k][1].final_step > 8
        epochs = fleet["owner_epochs"]
        assert [e["epoch"] for e in epochs][:2] == [0, 1] and epochs[1]["opt_source"] == \
            "fresh-init"
        template = pown.tree_from_flat(_template_of(results[k][0]))
        assert epochs[-1]["owned_shapes"] == {
            key: list(v.shape)
            for key, v in pmem.RankedLayout(template, survivors).flat_slices(template, k).items()}
        ledger = json.loads((out / f"fleet-worker-{k}.json").read_text("utf8"))
        assert ledger["membership_epoch"] == fleet["membership_epoch"]
        assert ledger["active"] == survivors
    assert results[lead][1].fleet["counters"]["evictions"] >= 1
    rows = pmem.read_membership_ledger(out / "fleet-membership.jsonl")
    evicts = [r for r in rows if r["event"] == "evict"]
    assert evicts and victim in evicts[0]["evicted"] and evicts[0]["active"] == survivors
    assert evicts[0]["lead"] == lead
    applies = [r for r in rows if r["event"] == "apply"]
    assert {r["worker"] for r in applies} == set(survivors)
    assert all(r["epoch"] == 1 and r["quorum"] == 1 for r in applies)
    # the final generation and models: finite, the membership as JAX's
    # generation reader (the one its serving watcher uses) reads it
    meta = PCheckpoint.load(out / "last-model")
    fleet_extra = meta["extra"]["fleet"]
    assert fleet_extra["worker"] == lead and meta["format"] == 2
    assert meta["opt_state"] and fleet_extra["versions"][victim] is None
    assert fleet_extra["epoch"] >= 1 and fleet_extra["active"] == survivors
    jgen = JCheckpoints(out / "last-model")
    stamp = jgen.latest_intact_generation(params_only=True)
    assert stamp == meta["step"] == 24
    assert jgen._meta_for(stamp)["extra"]["fleet"] == fleet_extra
    jparams = jgen.load_generation_params(stamp)["params"]
    assert len(_jflat(jparams)) == len(meta["params"]) > 0
    assert all(np.array_equal(np.asarray(v), meta["params"][k])
               for k, v in _jflat(jparams).items())
    for d in ("best-model", "last-model"):
        if (out / d / "params.npz").exists():
            with np.load(out / d / "params.npz") as f:
                assert f.files and all(np.isfinite(f[n]).all() for n in f.files), d
    assert (out / "best-model").exists() == (victim != 0)  # only worker 0 evaluates


def _template_of(nlp):
    return {k: v.detach().numpy() for k, v in param_paths(nlp.model).items()}


def _jflat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _jflat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}
