"""The trainer fleet's pieces in the port against the JAX package, on the CPU:
the ownership layout of configs/cnn.cfg's parameters (ordinals, axes,
slices, owned keys, signature), the f32 wire (frames byte-equal both ways,
every malformed frame refused), the owner's quorum / staleness / discard
outcomes and counters on one scripted sequence with the same fake apply,
the owner's slice apply against JAX's shard apply over the clip-free fused
chain, the worker-side clip scale, the peer server's routes, and the
coordinator's exits.

Tolerances: layouts, frames, outcomes and counters exactly; the slice apply
(K5's plain version) within 1e-6 x each leaf's max |value| of JAX's after
three applies (the PR 9 optimizer test's measure); the clip scale bit-equal.
"""

import json
import socket
import threading
import urllib.error
import urllib.request
from pathlib import Path

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
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.training.fleet import ownership as jown
from spacy_ray_tpu.training.fleet import peer as jpeer
from spacy_ray_tpu.training.fleet import wire as jwire
from spacy_ray_tpu.udgen import write_ud_jsonl as j_write_ud

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training.batcher import shard_stream
from spacy_ray_tpu_torch.training.fleet import ownership as pown
from spacy_ray_tpu_torch.training.fleet import peer as ppeer
from spacy_ray_tpu_torch.training.fleet import wire as pwire
from spacy_ray_tpu_torch.training.fleet.worker import (
    SliceApply, _PeerClient, clip_scale, owner_optimizer, resolve_quorum,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cnn_template(tmp_path_factory):
    """configs/cnn.cfg initialized by JAX on a pseudo-UD corpus: JAX's
    parameter tree, and the port's host tree of the same model directory."""
    d = tmp_path_factory.mktemp("fleet_cnn")
    j_write_ud(d / "train.jsonl", 60, seed=0, max_sents=2)
    cfg = J.Config.from_disk(REPO / "configs" / "cnn.cfg")
    cfg["paths"] = {"train": str(d / "train.jsonl"), "dev": str(d / "train.jsonl")}
    jnlp = J.Pipeline.from_config(cfg.interpolate())
    egs = list(jcorpus.Corpus(d / "train.jsonl")())
    jnlp.initialize(lambda: egs, seed=0)
    jnlp.to_disk(d / "model")
    pnlp = P.Pipeline.from_disk(d / "model", device="cpu")
    flat = {k: v.numpy().copy() for k, v in param_paths(pnlp.model).items()}
    with np.load(d / "model" / "params.npz") as f:
        npz_keys = list(f.files)
    jparams = jax.tree_util.tree_map(np.asarray, jnlp.params)
    return jparams, pown.tree_from_flat(flat), npz_keys


def test_shard_axis_matches_jax():
    shapes = [(), (16,), (16, 8), (3, 16), (7,), (5, 3), (8, 24, 4), (0, 4), (2, 2, 6), (96,)]
    for shape in shapes:
        for n in range(0, 9):
            assert pown.shard_axis(shape, n) == jown.shard_axis(shape, n), (shape, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_cnn_layout_equals_jax(cnn_template, n):
    jparams, ptree, npz_keys = cnn_template
    jl, pl = jown.OwnershipLayout(jparams, n), pown.OwnershipLayout(ptree, n)
    assert pl.paths == jl.paths and pl.shapes == jl.shapes and pl.axes == jl.axes
    assert len(pl.paths) == 26
    # the path keys are the flat-npz keys, in JAX's tree order
    assert [pown.path_key(p) for p in pl.paths] == list(_flatten(jparams))
    assert sorted(pown.path_key(p) for p in pl.paths) == sorted(npz_keys)
    for w in range(n):
        assert pl.owned_keys(w) == jl.owned_keys(w)
        for i in range(len(pl.paths)):
            assert pl.index(i, w) == jl.index(i, w)
            assert pl.owns(i, w) == jl.owns(i, w)
            key = pown.path_key(pl.paths[i])
            assert pl.key_index(key, w) == jl.key_index(key, w)
    assert pl.signature() == jl.signature()
    if n > 1:
        assert pl.signature() != pown.OwnershipLayout(ptree, 1).signature()


@pytest.mark.parametrize("n", [2, 3, 4])
def test_slices_equal_jax_and_merge_round_trips(cnn_template, n):
    jparams, ptree, _ = cnn_template
    pl, jl = pown.OwnershipLayout(ptree, n), jown.OwnershipLayout(jparams, n)
    zeros = jax.tree_util.tree_map(np.zeros_like, ptree)
    for w in range(n):
        mine, theirs = pl.flat_slices(ptree, w), jl.flat_slices(jparams, w)
        assert list(mine) == list(theirs)
        for k in mine:
            assert mine[k].flags["C_CONTIGUOUS"] and np.array_equal(mine[k], theirs[k]), k
        pl.merge_flat(zeros, w, mine)
    for key, leaf in _flatten(zeros).items():
        assert np.array_equal(leaf, _flatten(ptree)[key]), key
    with pytest.raises(ValueError, match="unknown param leaf"):
        pl.merge_flat(zeros, 0, {"nope": np.zeros(1, np.float32)})
    k0 = pl.owned_keys(1)[0]
    with pytest.raises(ValueError, match="shape mismatch"):
        pl.merge_flat(zeros, 1, {k0: np.zeros((1,), np.float32)})
    # a delta merge adds in place, as JAX's; a bad piece leaves every leaf as
    # it was (every piece is checked before one is written)
    piece, before = pl.flat_slices(ptree, 1)[k0], pl.flat_slices(zeros, 1)
    with pytest.raises(ValueError, match="unknown param leaf"):
        pl.merge_flat(zeros, 1, {k0: piece, "nope": piece}, add=True)
    assert all(np.array_equal(v, pl.flat_slices(zeros, 1)[k]) for k, v in before.items())
    jzeros = jax.tree_util.tree_map(np.array, zeros)
    pl.merge_flat(zeros, 1, {k0: piece}, add=True)
    jl.merge_flat(jzeros, 1, {k0: piece}, add=True)
    assert np.array_equal(pl.flat_slices(zeros, 1)[k0], before[k0] + piece)
    assert all(np.array_equal(a, b) for a, b in zip(_flatten(zeros).values(),
                                                    _flatten(jzeros).values()))


def test_shard_stream_equals_jax():
    from spacy_ray_tpu.training.batcher import shard_stream as j_shard

    for world in (1, 2, 3):
        for rank in range(world):
            assert list(shard_stream(range(11), rank, world)) == list(j_shard(range(11), rank,
                                                                              world))


# ---------------------------------------------------------------- wire


def _wire_cases():
    rng = np.random.default_rng(0)
    return [
        ({"worker": 1, "stamp": 7}, {"a/W": rng.normal(size=(3, 4)).astype(np.float32)}),
        ({"v": 1, "epoch": 0}, {"i": np.arange(6, dtype=np.int32).reshape(2, 3),
                                "s": np.array(3.5, dtype=np.float32),
                                "e": np.zeros((0, 4), np.float32),
                                "d": np.array([1.5, -2.0], dtype=np.float64)}),
        ({}, {}),
        ({"nested": {"x": [1, 2]}}, {"big": np.array([1.0, 2.0], dtype=">f4")}),
    ]


@pytest.mark.parametrize("case", range(4))
def test_frames_are_byte_equal_both_ways(case):
    meta, arrays = _wire_cases()[case]
    body = pwire.encode_arrays(meta, arrays)
    assert body == jwire.encode_arrays(meta, arrays)
    for decode in (pwire.decode_arrays, jwire.decode_arrays):
        m, out = decode(body)
        assert m == meta and list(out) == sorted(arrays)
        for k, v in arrays.items():
            # both packages send a 0-d array as shape (1,) (np.ascontiguousarray)
            want = np.ascontiguousarray(v)
            assert out[k].shape == want.shape and np.array_equal(out[k], want)
            assert out[k].dtype == v.dtype.newbyteorder("<")
    g = pwire.encode_grads(meta, arrays)
    assert g == jwire.encode_grads(meta, arrays)
    for decode in (pwire.decode_grads, jwire.decode_grads):
        m, out = decode(g)
        assert m == {**meta, "codec": "f32"}
        assert all(np.array_equal(out[k], np.ascontiguousarray(v)) for k, v in arrays.items())


def _malformed():
    good = jwire.encode_arrays({"v": 1}, {"x": np.ones(4, np.float32)})
    hdr = b'{"meta": {}, "arrays": [["x", "<f4", [4]]]}'
    frame = lambda h, data=b"": jwire.MAGIC + len(h).to_bytes(8, "big") + h + data  # noqa: E731
    return {
        "magic": b"NOPE" + good[4:],
        "short": good[:7],
        "truncated_data": good[:-3],  # the cases of JAX's test_wire_rejects_malformed
        "trailing": good + b"xx",
        "truncated_header": good[:20],
        "header_json": frame(b"{not json"),
        "header_utf8": frame(b"\xff\xfe"),
        "no_arrays": frame(b'{"meta": {}}'),
        "entry_arity": frame(b'{"meta": {}, "arrays": [["x", "<f4"]]}'),
        "entry_dtype": frame(b'{"meta": {}, "arrays": [["x", "nope", [4]]]}'),
        "entry_shape": frame(b'{"meta": {}, "arrays": [["x", "<f4", ["a"]]]}'),
        "missing_data": frame(hdr, b"\x00" * 8),
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_every_malformed_frame_is_refused_like_jax(name):
    body = _malformed()[name]
    with pytest.raises(jwire.WireError):
        jwire.decode_arrays(body)
    with pytest.raises(pwire.WireError):
        pwire.decode_arrays(body)
    with pytest.raises(pwire.WireError):
        pwire.decode_grads(body)


def test_compressed_frames_are_refused_and_epochs_read_as_jax():
    """Compressed grad frames decode as JAX's do, and epochs read as JAX's.
    (The name is the one this test had while the port refused these
    frames.) A bf16 or int8 frame of either package decodes in the other to
    the same f32 arrays bit for bit, the frames are byte-equal, a codec
    neither package knows passes its arrays through, and an int8 leaf
    without its scale is a WireError in both."""
    g = {"w": np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8),
         "b": np.linspace(-3, 2, 5, dtype=np.float32)}
    for codec in ("bf16", "int8"):
        body = jwire.encode_grads({"worker": 0, "stamp": 0}, g, codec)
        assert pwire.encode_grads({"worker": 0, "stamp": 0}, g, codec) == body
        (pm, pout), (jm, jout) = pwire.decode_grads(body), jwire.decode_grads(body)
        assert pm == jm == {"worker": 0, "stamp": 0, "codec": codec}
        assert sorted(pout) == sorted(jout) == ["b", "w"]
        for k in g:
            assert pout[k].dtype == np.float32 and pout[k].tobytes() == jout[k].tobytes()
    odd = jwire.encode_arrays({"codec": "zstd9"}, g)  # a codec neither package knows
    assert np.array_equal(pwire.decode_grads(odd)[1]["w"], jwire.decode_grads(odd)[1]["w"])
    q = jwire.compress_arrays({"w": g["w"]}, "int8")["w"]
    no_scale = jwire.encode_arrays({"codec": "int8"}, {"w": q})
    for wire in (jwire, pwire):
        with pytest.raises(wire.WireError, match="missing"):
            wire.decode_grads(no_scale)
    for meta in ({}, {"epoch": 0}, {"epoch": 3}, {"epoch": -1}, {"epoch": True},
                 {"epoch": "1"}, {"epoch": 1.0}):
        try:
            want = jwire.frame_epoch(meta)
        except jwire.WireError:
            with pytest.raises(pwire.WireError):
                pwire.frame_epoch(meta)
        else:
            assert pwire.frame_epoch(meta) == want


# ---------------------------------------------------------------- owner


def _owner(pkg, quorum, staleness, n=3, apply_fn=None, calls=None):
    applied = calls if calls is not None else []

    def fake_apply(params, opt_state, grads):
        applied.append({k: np.array(v) for k, v in grads.items()})
        return {"x": params["x"] + grads["x"]}, opt_state

    kw = dict(worker_id=0, n_workers=n, quorum=quorum, max_staleness=staleness,
              apply_fn=apply_fn or fake_apply, slice_params={"x": np.zeros(4, np.float32)},
              opt_state={"count": 0}, counters=pkg.FleetCounters())
    return pkg.OwnerState(**kw), applied


def _raising_apply():
    calls = {"n": 0}

    def apply_fn(params, opt_state, grads):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        return {"x": params["x"] + grads["x"]}, opt_state

    return apply_fn


G = {"x": np.ones(4, np.float32)}
H = {"x": np.arange(4, dtype=np.float32)}
#: (quorum, staleness, n_workers, raising apply, [(sender, stamp, grads)]): JAX's
#: owner tests (tests/test_training_fleet.py) as one script each, and more
SCRIPTS = {
    "quorum": (2, 0, 3, False, [(1, 0, G), (2, 0, H), (1, 1, G), (1, 1, H), (2, 1, G)]),
    "stale_and_future": (1, 0, 3, False, [(1, 0, G), (2, 0, G), (2, 5, G), (2, 1, H)]),
    "bounded": (1, 2, 3, False, [(1, 0, G), (1, 1, G), (2, 0, G), (2, 0, G), (0, 3, H),
                                 (0, 0, G), (1, 2, G)]),
    "structure_and_sender": (2, 0, 3, False, [
        (1, 0, {"y": G["x"]}), (1, 0, {"x": np.ones(5, np.float32)}), (99, 0, G),
        (-1, 0, G), (1, 0, G), (2, 0, G), (1, 1, {"x": G["x"], "z": G["x"]})]),
    "raising_apply": (2, 0, 3, True, [(1, 0, G), (2, 0, G), (1, 0, G), (2, 0, H), (1, 1, G)]),
    "quorum_all": (3, 1, 3, False, [(0, 0, G), (1, 0, G), (0, 0, H), (2, 0, G), (1, 0, G),
                                    (2, 1, H), (0, 1, G), (1, 0, G)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_owner_outcomes_and_counters_equal_jax(name):
    quorum, staleness, n, raising, script = SCRIPTS[name]
    runs = []
    for pkg in (jpeer, ppeer):
        owner, applied = _owner(pkg, quorum, staleness, n,
                                apply_fn=_raising_apply() if raising else None)
        outcomes = [owner.submit(w, s, g) for w, s, g in script]
        runs.append((outcomes, owner.counters.snapshot(), owner.version, applied,
                     owner.current_flat()))
    (jo, jc, jv, japp, jflat), (po, pc, pv, papp, pflat) = runs
    assert po == jo
    assert pv == jv and pflat[0] == jflat[0]
    assert {k: pc[k] for k in jc if k in pc} == {k: jc[k] for k in pc if k in jc}
    assert set(pc) - set(jc) == set()
    assert len(papp) == len(japp)
    for a, b in zip(papp, japp):
        assert all(np.array_equal(a[k], b[k]) for k in b)
    assert np.array_equal(pflat[1]["x"], jflat[1]["x"])


def test_owner_wait_version_above_and_encoded_as_jax():
    for pkg in (jpeer, ppeer):
        owner, _ = _owner(pkg, 1, 0)
        assert not owner.wait_version_above(0, timeout=0.05)
        threading.Timer(0.05, owner.submit, (1, 0, G)).start()
        assert owner.wait_version_above(0, timeout=30.0)
        assert owner.encoded(1) == (1, None)
    jo, _ = _owner(jpeer, 1, 0)
    po, _ = _owner(ppeer, 1, 0)
    for o in (jo, po):
        o.submit(2, 0, H)
    assert po.encoded(0) == jo.encoded(0) and po.encoded(None)[1] is not None
    with pytest.raises(ValueError, match="quorum"):
        _owner(ppeer, 4, 0)
    with pytest.raises(ValueError, match="max_staleness"):
        _owner(ppeer, 1, -1)


# ---------------------------------------------------------------- the slice apply


def test_owner_slice_apply_matches_jax_shard_apply(cnn_template):
    """Each owner's slices of cnn.cfg at N 2 through the port's owner apply
    (Adam.v1 as cnn.cfg sets it, its clip link moved to the worker) and
    through JAX's shard apply over the clip-free fused chain: params, mu
    and nu after three applies."""
    jparams, ptree, _ = cnn_template
    hyper = {"learn_rate": 0.001, "beta1": 0.9, "beta2": 0.999, "grad_clip": 1.0}
    jtx = jopt.Adam(**hyper)
    fused = make_fused_transformation(reference_tx=jtx.tx, **{**jtx.fusable, "grad_clip": 0.0})
    owner_tx = jopt.OptimizerWrapper(fused)
    owner_tx.applies_updates = True
    p_owner_opt, clip = owner_optimizer(popt.Adam(**hyper))
    assert clip == 1.0 and p_owner_opt.hyper.grad_clip == 0.0
    rng = np.random.default_rng(3)
    for w in range(2):
        jl, pl = jown.OwnershipLayout(jparams, 2), pown.OwnershipLayout(ptree, 2)
        jslice = jax.tree_util.tree_map(jnp.asarray, jl.slice_tree(jparams, w))
        jstate = owner_tx.init(jslice)
        japply = make_shard_apply(owner_tx, donate=False)
        sa = SliceApply(p_owner_opt, torch.device("cpu"))
        pparams, pstate = sa.init(pl.flat_slices(ptree, w))
        assert list(pparams) == pl.owned_keys(w)
        for _ in range(3):
            g = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
                 for k, v in pparams.items()}
            jslice, jstate = japply(jslice, jstate, jown.tree_from_flat(g))
            pparams, pstate = sa(pparams, pstate, g)
        moments = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
            names = [getattr(p, "name", getattr(p, "key", None)) for p in path]
            if "mu" in names or "nu" in names:
                m = "mu" if "mu" in names else "nu"
                key = "/".join(str(x) for x in names[names.index(m) + 1:])
                moments[f"{m}/{key}"] = np.asarray(leaf)
        assert len(moments) == 2 * len(pparams)
        jflat = {k: np.asarray(v) for k, v in _flatten(jslice).items()}
        for k, p in pparams.items():
            for got, want in ((p.numpy(), jflat[k]), (pstate["mu"][k].numpy(), moments[f"mu/{k}"]),
                              (pstate["nu"][k].numpy(), moments[f"nu/{k}"])):
                scale = max(np.abs(want).max(), 1e-30)
                assert np.abs(got - want).max() <= 1e-6 * scale, (w, k)
        assert pstate["count"] == 3


def test_worker_clip_scale_equals_jax_gstep():
    def jscale(gnorm, clip):
        return jnp.minimum(1.0, clip / jnp.maximum(gnorm, 1e-16))

    j_scale = jax.jit(jscale, static_argnums=1)
    vals = np.array([0.0, 1e-20, 1e-8, 0.3, 0.999999, 1.0, 1.0000001, 1.7, 3.3333, 1e6,
                     np.inf], np.float32)
    vals = np.concatenate([vals, np.random.default_rng(0).lognormal(0, 2, 200).astype(np.float32)])
    for clip in (1.0, 0.5, 5.0):
        for v in vals:
            got = clip_scale(torch.tensor(v), clip)
            want = np.asarray(j_scale(jnp.float32(v), clip))
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == want.astype(np.float32).tobytes(), (clip, v)
    g = np.random.default_rng(1).normal(size=(50,)).astype(np.float32)
    s = clip_scale(torch.tensor(np.float32(7.25)), 1.0)
    assert np.array_equal((torch.from_numpy(g) * s).numpy(),
                          np.asarray(jnp.asarray(g) * j_scale(jnp.float32(7.25), 1.0)))


def test_resolve_quorum_equals_jax():
    from spacy_ray_tpu.training.fleet.worker import resolve_quorum as j_resolve

    for n in range(1, 6):
        for q in (None, 0, 1, 2, 3):
            assert resolve_quorum(q, n) == j_resolve(q, n)


# ---------------------------------------------------------------- the peer server


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_peer_server_routes_and_a_jax_client():
    """The routes a peer calls, the 413 cap, 404 for ``/trace`` without
    telemetry and JAX's ``{"alerts": "disabled"}`` on ``/admin/alerts``,
    JAX's 503 for ``POST /checkpoint`` on a server without a checkpoint
    callback, the membership of a server no worker has set one on, and
    JAX's own peer client pulling from and pushing to the port."""
    from spacy_ray_tpu.training.fleet.worker import _PeerClient as JClient

    owner, _ = _owner(ppeer, 2, 0, n=2)
    port = _free_port()
    server = ppeer.PeerServer(owner, worker_id=0, layout_signature="sig", counters=owner.counters,
                              port=port, phases=lambda: {"grad": 1.5})
    server.start()
    try:
        status, _, body = _http(port, "GET", "/healthz")
        health = json.loads(body)
        assert status == 200 and health["layout"] == "sig"
        assert health["codecs"] == ["f32", "bf16", "int8", "delta"] == list(jwire.WIRE_CODECS)
        assert health["delta_window"] == 0
        assert health["version"] == 0 and health["role"] == "fleet-worker"
        jc = JClient(f"http://127.0.0.1:{port}")
        status, headers, body = jc.request("GET", "/params?known=-1")
        assert status == 200 and headers["X-SRT-Version"] == "0"
        assert jwire.decode_arrays(body)[1]["x"].tolist() == [0, 0, 0, 0]
        assert jc.request("GET", "/params?known=0")[0] == 204
        assert jc.request("GET", "/params?known=zz")[0] == 400
        assert jc.request("GET", "/params?known=0", headers={"X-SRT-Epoch": "2"})[0] == 409
        push = jwire.encode_grads({"worker": 1, "stamp": 0}, H)
        status, _, reply = jc.request("POST", "/grad", body=push)
        assert status == 200 and json.loads(reply) == {"accepted": True, "version": 0}
        push = pwire.encode_grads({"worker": 0, "stamp": 0, "epoch": 0}, G)
        status, _, reply = _PeerClient(f"http://127.0.0.1:{port}").request("POST", "/grad",
                                                                          body=push)
        assert json.loads(reply) == {"accepted": True, "version": 1}
        assert _http(port, "POST", "/grad", b"garbage")[0] == 400
        fenced = pwire.encode_grads({"worker": 1, "stamp": 1, "epoch": 4}, G)
        assert json.loads(_http(port, "POST", "/grad", fenced)[2])["fenced"] is True
        server.httpd.max_body_bytes = 10
        assert _http(port, "POST", "/grad", b"x" * 11)[0] == 413
        status, _, body = _http(port, "GET", "/membership")
        assert status == 200 and json.loads(body) == {"epoch": 0}
        for path in ("/checkpoint", "/trace"):  # /trace: no telemetry here
            assert _http(port, "GET", path)[0] == 404
        status, _, body = _http(port, "GET", "/admin/alerts")
        assert status == 200 and json.loads(body) == {"alerts": "disabled"}  # JAX's
        status, _, body = _http(port, "POST", "/checkpoint", b"{}")
        assert status == 503 and json.loads(body) == {"error": "not_ready"}
        status, _, body = _http(port, "GET", "/metrics")
        snap = json.loads(body)
        assert snap["phases"] == {"grad": 1.5} and snap["gauges"]["param_version"] == 1
        assert snap["counters"] == owner.counters.snapshot()
        assert snap["counters"]["grad_received"] == 2 and snap["counters"]["grad_discarded"] == 1
        assert snap["counters"]["epoch_fenced"] == 2
        assert not server.finalize_event.is_set()
        assert _http(port, "POST", "/finalize", b"{}")[0] == 200
        assert server.finalize_event.is_set()
        with pytest.raises(OSError, match=str(port)):
            ppeer.PeerServer(owner, worker_id=0, layout_signature="sig",
                             counters=owner.counters, port=port)
    finally:
        server.stop()
