"""The trainer fleet's compressed wire in the port against the JAX package, on
the CPU: the host int8 quantizer, the bf16 bits, grad frames of every codec
(byte-equal both ways), the fallbacks and malformed frames, delta frames,
error feedback over several rounds, codec resolution and negotiation, the
owner's delta chain under an apply both packages compute bit-exactly, the
delta negotiation over HTTP, and compressed pushes and delta pulls between
the two packages' clients and peer servers.

Tolerances: frames, pieces, residuals, quantized values and the chain are
compared byte for byte; the round trips keep JAX's bounds (int8 within
scale / 2 per element, bf16 within 2^-8 relative).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from spacy_ray_tpu.ops import int8_matmul as jint8
from spacy_ray_tpu.training.fleet import ownership as jown
from spacy_ray_tpu.training.fleet import peer as jpeer
from spacy_ray_tpu.training.fleet import wire as jwire
from spacy_ray_tpu.training.fleet.worker import _PeerClient as JClient

from spacy_ray_tpu_torch.ops import int8_matmul as pint8
from spacy_ray_tpu_torch.training.fleet import ownership as pown
from spacy_ray_tpu_torch.training.fleet import peer as ppeer
from spacy_ray_tpu_torch.training.fleet import wire as pwire
from spacy_ray_tpu_torch.training.fleet.worker import _PeerClient as PClient
from spacy_ray_tpu_torch.training.fleet.worker import merge_pulled


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------- leaf quantizers


def _int8_cases():
    rng = np.random.default_rng(0)
    return {
        "rank2": rng.normal(0, 0.02, (16, 24)).astype(np.float32),
        "rank3_big": (rng.normal(0, 3.0, (4, 8, 12)) * 100).astype(np.float32),
        "rank1": rng.normal(0, 1.0, 64).astype(np.float32),
        "rank0": np.float32(-0.75),
        "zeros": np.zeros((8, 8), np.float32),
        "dead_channel": np.concatenate([np.zeros((16, 1), np.float32),
                                        rng.normal(0, 1, (16, 1)).astype(np.float32)], axis=1),
        "empty1": np.zeros((0,), np.float32),
        "empty2": np.zeros((0, 4), np.float32),
        "empty3": np.zeros((2, 0, 3), np.float32),
        "ties": (np.arange(-10, 11, dtype=np.float32) * 0.5).reshape(3, 7),
        "float64_in": rng.normal(0, 1, (5, 6)),
    }


def test_int8_roundtrip_error_bounded_by_half_scale():
    for name, arr in _int8_cases().items():
        q, scale = pint8.quantize_int8_np(arr)
        assert q.dtype == np.int8 and scale.dtype == np.float32, name
        err = np.abs(pint8.dequantize_int8_np(q, scale) - np.asarray(arr, np.float32))
        assert np.all(err <= scale / 2 + 1e-7), name


@pytest.mark.parametrize("name", sorted(_int8_cases()))
def test_quantize_int8_np_is_bit_equal_to_jax(name):
    arr = _int8_cases()[name]
    (pq, ps), (jq, js) = pint8.quantize_int8_np(arr), jint8.quantize_int8_np(arr)
    assert _same(pq, jq) and _same(ps, js)
    assert _same(pint8.dequantize_int8_np(pq, ps), jint8.dequantize_int8_np(jq, js))
    if np.ndim(arr) == 2 and np.size(arr):
        # the host twin agrees with the port's torch quantizer (the serving overlay's)
        tq, ts = pint8.quantize_int8(torch.from_numpy(np.asarray(arr, np.float32)))
        assert np.array_equal(pq, tq.numpy())
        np.testing.assert_allclose(ps, ts.numpy(), rtol=1e-6)


def _bf16_inputs():
    rng = np.random.default_rng(2)
    bits = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001,
            0x7F800001, 0x7FFFFFFF, 0x00000001, 0x007FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
            0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001, 0xBF808000, 0xBF818000,
            0x0000_8000, 0x0001_8000, 0x4049_0FDB]
    return np.concatenate([
        np.array(bits, np.uint32).view(np.float32),
        rng.normal(0, 10, 199).astype(np.float32),
        (rng.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)).view(np.float32),
    ]).reshape(-1, 3)


def test_bf16_bits_are_bit_equal_to_jax_with_ties_zeros_inf_and_nan():
    a = _bf16_inputs()
    pb, jb = pwire._to_bf16_bits(a), jwire._to_bf16_bits(a)
    assert pb.dtype == np.uint16 and _same(pb, jb)
    assert _same(pwire._from_bf16_bits(pb), jwire._from_bf16_bits(jb))
    # round to nearest even at the ties: 1 + 2^-8 goes down, 1 + 3 x 2^-8 up
    ties = np.array([0x3F808000, 0x3F818000], np.uint32).view(np.float32)
    assert pwire._to_bf16_bits(ties).tolist() == [0x3F80, 0x3F82]
    exact = np.array([0.0, -0.0, 1.0, -2.5, 0.15625, np.inf, -np.inf], np.float32)
    assert _same(pwire._from_bf16_bits(pwire._to_bf16_bits(exact)), exact)
    assert np.isnan(pwire._from_bf16_bits(pwire._to_bf16_bits(np.float32(np.nan))))
    finite = a[np.isfinite(a) & (np.abs(a) < 1e38)]
    back = pwire._from_bf16_bits(pwire._to_bf16_bits(finite))
    assert np.all(np.abs(back - finite) <= np.abs(finite) * 2 ** -8 + 1e-38)


# ---------------------------------------------------------------- grad frames


def _grads(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "a/W": rng.normal(0, 0.1, (12, 8)).astype(np.float32),
        "a/b": rng.normal(0, 0.1, 12).astype(np.float32),
        "c/k": rng.normal(0, 0.1, (2, 3, 4)).astype(np.float32),
        "s": np.float32(0.25),
        "tiny": np.ones(3, np.float32),  # under INT8_MIN_LEAF: rides as f32
        "e": np.zeros((0, 4), np.float32),
    }


def test_codec_constants_equal_jax():
    assert pwire.WIRE_CODECS == jwire.WIRE_CODECS == ("f32", "bf16", "int8", "delta")
    assert pwire.SCALE_SUFFIX == jwire.SCALE_SUFFIX
    assert pwire.INT8_MIN_LEAF == jwire.INT8_MIN_LEAF
    assert not hasattr(pwire, "UNDECODED_CODECS")


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_grad_frames_are_byte_equal_both_ways(codec):
    grads = _grads()
    meta = {"worker": 1, "stamp": 4, "epoch": 2}
    body = pwire.encode_grads(meta, grads, codec)
    assert body == jwire.encode_grads(meta, grads, codec)
    assert _same_arrays(pwire.compress_arrays(grads, codec), jwire.compress_arrays(grads, codec))
    (pm, pout), (jm, jout) = pwire.decode_grads(body), jwire.decode_grads(body)
    assert pm == jm and pm["codec"] == codec
    assert _same_arrays(pout, jout) and set(pout) == set(grads)
    tol = {"f32": 0, "bf16": 2 ** -8, "int8": 2e-2}[codec]
    for k, g in grads.items():
        assert pout[k].dtype == np.float32
        np.testing.assert_allclose(pout[k].reshape(np.shape(g)), g, rtol=tol, atol=tol)
    assert np.array_equal(pout["tiny"], grads["tiny"])


def _same_arrays(a, b):
    return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)


def test_unknown_codec_passes_through_and_a_missing_scale_raises_in_both():
    grads = {"x": np.ones(8, np.float32)}
    body = jwire.encode_arrays({"worker": 0, "codec": "zstd-v9"}, grads)
    for wire in (pwire, jwire):
        meta, out = wire.decode_grads(body)
        assert meta["codec"] == "zstd-v9" and np.array_equal(out["x"], grads["x"])
        meta2, out2 = wire.decode_grads(wire.encode_arrays({"worker": 0}, grads))
        assert "codec" not in meta2 and np.array_equal(out2["x"], grads["x"])
    q, _ = pint8.quantize_int8_np(np.ones((8, 8), np.float32))
    for wire in (pwire, jwire):
        with pytest.raises(wire.WireError, match="missing"):
            wire.decompress_arrays({"w": q}, "int8")
        out = wire.decompress_arrays({"w": np.ones(3, np.float32)}, "int8")
        assert np.array_equal(out["w"], np.ones(3, np.float32))
        # a bf16 frame's non-uint16 leaf passes as declared
        assert wire.decompress_arrays({"w": np.ones(2, np.float32)}, "bf16")["w"].tolist() == [1, 1]


# ---------------------------------------------------------------- delta frames


def _pieces(wire):
    rng = np.random.default_rng(4)
    d1 = {"x": rng.normal(0, 1, (8, 8)).astype(np.float32), "b": np.ones(3, np.float32)}
    d2 = {"x": rng.normal(0, 1, (8, 8)).astype(np.float32)}
    d3 = {"b": rng.normal(0, 1, 3).astype(np.float32)}
    return [(1, "int8", wire.compress_arrays(d1, "int8")),
            (2, "int8", wire.compress_arrays(d2, "int8")),
            (3, "bf16", wire.compress_arrays(d3, "bf16"))], d1, d2, d3


def test_delta_frames_are_byte_equal_and_malformed_tables_raise_in_both():
    (pp, d1, d2, d3), (jp, *_) = _pieces(pwire), _pieces(jwire)
    meta = {"version": 3, "worker": 0, "base": 0}
    body = pwire.encode_delta_frame(meta, pp)
    assert body == jwire.encode_delta_frame(meta, jp)
    m, arrays = pwire.decode_arrays(body)
    assert m["codec"] == "delta" and m["pieces"] == [[1, "int8"], [2, "int8"], [3, "bf16"]]
    total, jtotal = pwire.decode_delta_frame(m, arrays), jwire.decode_delta_frame(m, arrays)
    assert _same_arrays(total, jtotal)
    np.testing.assert_allclose(total["x"], d1["x"] + d2["x"], atol=4e-2)
    np.testing.assert_allclose(total["b"], d1["b"] + d3["b"], rtol=2 ** -7)
    for wire in (pwire, jwire):
        with pytest.raises(wire.WireError):
            wire.decode_arrays(body[:-5])
        for bad in ({"pieces": "nope"}, {}, {"pieces": [[1]]}, {"pieces": [["a", "int8"]]},
                    {"pieces": 7}):
            with pytest.raises(wire.WireError):
                wire.decode_delta_frame(bad, arrays)


# ---------------------------------------------------------------- error feedback


@pytest.mark.parametrize("codec", ["int8", "bf16", "f32"])
def test_grad_compressor_rounds_are_byte_equal_to_jax(codec):
    """Four rounds to two peers (and one round whose slice shape changed):
    each frame byte-equal, the residuals equal after each round."""
    rng = np.random.default_rng(5)
    pc, jc = pwire.GradCompressor(codec), jwire.GradCompressor(codec)
    for t in range(5):
        for peer in (1, 2):
            g = {"w": rng.normal(0, 0.05, (16, 8) if t < 4 else (8, 8)).astype(np.float32),
                 "b": rng.normal(0, 0.05, 16).astype(np.float32),
                 "t": rng.normal(0, 1, 4).astype(np.float32)}
            meta = {"worker": 0, "stamp": t, "epoch": 0}
            assert pc.encode(peer, meta, g) == jc.encode(peer, meta, g)
            assert sorted(pc._residual) == sorted(jc._residual)
            assert all(_same(pc._residual[k], jc._residual[k]) for k in pc._residual)
    assert bool(pc._residual) == (codec != "f32")
    # an override codec (the negotiated one) keeps no residual at f32
    arrays, used = pc.compress(9, {"w": np.ones((8, 8), np.float32)}, "f32")
    assert used == "f32" and (9, "w") not in pc._residual
    pc.reset()
    assert not pc._residual


def test_error_feedback_telescopes_exactly():
    rng = np.random.default_rng(5)
    comp = pwire.GradCompressor("int8")
    raw_sum = np.zeros((16, 8), np.float32)
    deq_sum = np.zeros((16, 8), np.float32)
    for _ in range(3):
        g = rng.normal(0, 0.05, (16, 8)).astype(np.float32)
        raw_sum += g
        arrays, used = comp.compress(7, {"w": g})
        assert used == "int8"
        deq_sum += pwire.decompress_arrays(arrays, "int8")["w"]
    np.testing.assert_allclose(deq_sum + comp._residual[(7, "w")], raw_sum, atol=1e-4)


def test_error_feedback_is_load_bearing():
    step = 1.0 / 127
    g = np.zeros((4, 4), np.float32)
    g[0, 3] = 1.0
    g[3, 3] = 2.5e-3  # in the outlier's channel, under half a step

    def shipped(wire, error_feedback):
        comp = wire.GradCompressor("int8", error_feedback=error_feedback)
        total = 0.0
        for _ in range(6):
            arrays, _ = comp.compress(0, {"w": g})
            total += float(wire.decompress_arrays(arrays, "int8")["w"][3, 3])
        return total

    assert g[3, 3] < step / 2
    on, off = shipped(pwire, True), shipped(pwire, False)
    assert (on, off) == (shipped(jwire, True), shipped(jwire, False))
    assert off == 0.0 and on > 0.0 and abs(on - 6 * g[3, 3]) <= step
    comp = pwire.GradCompressor("int8", error_feedback=False)
    comp.compress(0, {"w": g})
    assert not comp._residual


# ---------------------------------------------------------------- negotiation


def test_resolve_grad_compression_and_negotiation_equal_jax():
    for req in ("auto", "AUTO", None, "", "f32", "bf16", "int8", "Int8"):
        for backend in ("cpu", "CPU", "cuda", "tpu", "gpu"):
            assert pwire.resolve_grad_compression(req, backend) == \
                jwire.resolve_grad_compression(req, backend), (req, backend)
    codec, reason = pwire.resolve_grad_compression("auto", "cuda")
    assert codec == "bf16" and "cuda" in reason
    assert pwire.resolve_grad_compression("auto", "cpu")[0] == "int8"
    for wire in (pwire, jwire):
        with pytest.raises(ValueError, match="auto|f32|bf16|int8"):
            wire.resolve_grad_compression("zstd", "cpu")
    for resolved in ("int8", "bf16", "f32"):
        for adv in (list(pwire.WIRE_CODECS), ["f32"], None, [], 17, "int8", ["bf16"],
                    ("f32", "int8"), {"x": 1}):
            assert pwire.negotiate_push_codec(resolved, adv) == \
                jwire.negotiate_push_codec(resolved, adv), (resolved, adv)
    assert pwire.negotiate_push_codec("int8", None) == "f32"


# ---------------------------------------------------------------- the owner's delta chain


def _exact_apply(params, opt_state, grads):
    # p - g in float32: both packages compute it bit for bit
    return {k: np.asarray(params[k], np.float32) - np.asarray(grads[k], np.float32)
            for k in params}, opt_state


def _slices():
    return {"x": np.zeros((64, 64), np.float32), "b": np.full(16, 0.5, np.float32),
            "still": np.ones(10, np.float32)}


def _owners(window, budget=8 << 20, codec="int8", slices=None):
    return [pkg.OwnerState(worker_id=0, n_workers=2, quorum=1, max_staleness=10,
                           apply_fn=_exact_apply, slice_params=dict(slices or _slices()),
                           opt_state={}, counters=pkg.FleetCounters(), delta_window=window,
                           delta_codec=codec, delta_budget_bytes=budget)
            for pkg in (ppeer, jpeer)]


def _push_rounds(owners, n, seed=6):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        g = {k: rng.normal(0, 0.1, v.shape).astype(np.float32)
             for k, v in owners[0]._host_flat.items()}
        if "still" in g:
            g["still"] = np.zeros_like(g["still"])  # a leaf the apply leaves unchanged
        for o in owners:
            assert o.submit(1, o.version, g)[0]


def _pieces_equal(po, jo):
    assert sorted(po._delta_pieces) == sorted(jo._delta_pieces)
    for v in po._delta_pieces:
        (pc, pp, pn), (jc, jp, jn) = po._delta_pieces[v], jo._delta_pieces[v]
        assert (pc, pn) == (jc, jn) and _same_arrays(pp, jp)
        assert "still" not in pp
    assert po._delta_bytes == jo._delta_bytes
    assert _same_arrays(po._wire_flat, jo._wire_flat)


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_owner_delta_pieces_and_frames_are_byte_equal_to_jax(codec):
    po, jo = _owners(window=4, codec=codec)
    _push_rounds([po, jo], 3)
    _pieces_equal(po, jo)
    assert po.encoded_for(3, accept_delta=True) == jo.encoded_for(3, accept_delta=True) == \
        (3, None, "current")
    for known in (None, -1, 0, 1, 2):
        for accept in (True, False):
            assert po.encoded_for(known, accept) == jo.encoded_for(known, accept), (known, accept)
    v, body, served = po.encoded_for(2, accept_delta=True)
    assert (v, served) == (3, "delta")
    assert len(body) < len(po.encoded_for(None, True)[1]) * (0.30 if codec == "int8" else 0.55)
    assert po.encoded(2) == jo.encoded(2) and po.encoded(2)[1] == po.encoded_for(None)[1]
    if codec == "bf16":
        # three stacked bf16 pieces outweigh the full frame: it is served instead
        assert po.encoded_for(0, True)[2] == "f32"
        return
    # a skipping puller's frame sums the same pieces in the same order as
    # stepwise pulls; from the zero start of "x" it lands on the chain exactly
    m, a = pwire.decode_arrays(po.encoded_for(0, True)[1])
    assert m["base"] == 0 and m["pieces"] == [[1, codec], [2, codec], [3, codec]]
    skip = pwire.decode_delta_frame(m, a)
    stepwise = {}
    for v in (1, 2, 3):
        piece_codec, piece, _ = po._delta_pieces[v]
        for k, d in jwire.decompress_arrays(piece, piece_codec).items():
            stepwise[k] = d if k not in stepwise else stepwise[k] + d
    assert _same_arrays(skip, stepwise)
    assert _same(skip["x"], po._wire_flat["x"])
    assert np.max(np.abs(po._wire_flat["x"] - po._host_flat["x"])) < 2e-2


def test_owner_delta_window_miss_budget_eviction_and_tiny_slices_fall_back_as_jax():
    po, jo = _owners(window=2)
    _push_rounds([po, jo], 4)
    _pieces_equal(po, jo)
    assert sorted(po._delta_pieces) == [3, 4]
    for known in (0, 1, 2, 3):
        assert po.encoded_for(known, True) == jo.encoded_for(known, True)
    v, body, codec = po.encoded_for(0, accept_delta=True)  # 4 behind a window of 2
    assert (v, codec) == (4, "f32")
    assert np.array_equal(pwire.decode_arrays(body)[1]["x"], po._host_flat["x"])
    assert po.encoded_for(3, True)[2] == "delta" and po.encoded_for(1, True)[2] == "f32"
    po, jo = _owners(window=4, budget=1)  # only the newest piece is kept
    _push_rounds([po, jo], 3)
    _pieces_equal(po, jo)
    assert list(po._delta_pieces) == [3]
    assert po.encoded_for(2, True)[2] == "delta" and po.encoded_for(1, True)[2] == "f32"
    assert po.encoded_for(1, True) == jo.encoded_for(1, True)
    # a slice so small that the delta's header outweighs its savings
    po, jo = _owners(window=4, slices={"x": np.zeros(4, np.float32)})
    _push_rounds([po, jo], 1)
    assert po.encoded_for(0, True) == jo.encoded_for(0, True)
    assert po.encoded_for(0, True)[2] == "f32" and 1 in po._delta_pieces
    po, jo = _owners(window=0)  # no window: no chain, full frames
    _push_rounds([po, jo], 2)
    assert po._wire_flat is None and po.encoded_for(1, True) == jo.encoded_for(1, True)
    assert po.encoded_for(1, True)[2] == "f32"


def test_a_retired_owner_drops_its_chain():
    po, _ = _owners(window=4)
    _push_rounds([po], 2)
    assert po._delta_pieces and po.encoded_for(1, True)[2] == "delta"
    po.retire()
    assert po._wire_flat is None and not po._delta_pieces and not po._delta_cache
    assert po.encoded_for(1, True)[2] == "f32"


# ---------------------------------------------------------------- over HTTP


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def test_delta_negotiation_over_http_against_the_port_server():
    po, jo = _owners(window=4)
    _push_rounds([po, jo], 2)
    srv = ppeer.PeerServer(po, worker_id=0, layout_signature="sig", counters=po.counters,
                           port=0)
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        health = json.loads(_get(f"{base}/healthz")[2])
        assert health["codecs"] == list(jwire.WIRE_CODECS) and health["delta_window"] == 4
        status, headers, body = _get(f"{base}/params?known=1", {"X-SRT-Accept": "delta"})
        assert status == 200 and headers["X-SRT-Codec"] == "delta"
        assert headers["X-SRT-Version"] == "2"
        assert body == jo.encoded_for(1, accept_delta=True)[1]
        meta, arrays = jwire.decode_arrays(body)
        piece_codec, piece, _ = po._delta_pieces[2]
        assert _same_arrays(jwire.decode_delta_frame(meta, arrays),
                            jwire.decompress_arrays(piece, piece_codec))
        status, headers, body = _get(f"{base}/params?known=1")
        assert headers["X-SRT-Codec"] == "f32"
        assert np.array_equal(jwire.decode_arrays(body)[1]["x"], po._host_flat["x"])
        status, headers, _ = _get(f"{base}/params?known=2", {"X-SRT-Accept": "delta"})
        assert status == 204 and headers["X-SRT-Version"] == "2"
        status, headers, _ = _get(f"{base}/params?known=-1", {"X-SRT-Accept": "delta"})
        assert headers["X-SRT-Codec"] == "f32"  # the chain holds no piece 0
        # an int8 push whose leaf lost its scale is a 400 (its sender counts
        # push_failed), never an f32 reading of the int8 bytes
        q, _ = pint8.quantize_int8_np(np.ones((64, 64), np.float32))
        no_scale = jwire.encode_arrays({"worker": 1, "stamp": 2, "codec": "int8"}, {"x": q})
        status, _, reply = JClient(base).request("POST", "/grad", body=no_scale)
        assert status == 400 and json.loads(reply)["error"] == "bad_payload"
        assert po.counters.snapshot()["grad_received"] == 2
    finally:
        srv.stop()


# ---------------------------------------------------------------- across packages


def _layout_tree():
    rng = np.random.default_rng(8)
    return {"a": {"W": rng.normal(0, 1, (64, 48)).astype(np.float32),
                  "b": rng.normal(0, 1, 12).astype(np.float32)},
            "c": rng.normal(0, 1, (4, 96)).astype(np.float32), "s": np.float32(0.5)}


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_compressed_pushes_and_delta_pulls_cross_packages(server_pkg):
    """A client of one package pushes int8 and bf16 frames (error feedback
    on) to the other package's peer server and follows its delta pulls: the
    owner applies exactly the frames' decoded gradients; a puller taking one
    piece a pull lands on the owner's wire chain bit for bit, one that skips
    a version on its slices plus the pieces' sum, and a pull without the
    header on the parameters."""
    tree = _layout_tree()
    cpkg = {"wire": jwire, "own": jown, "client": JClient} if server_pkg == "port" else \
        {"wire": pwire, "own": pown, "client": PClient}
    spkg = ppeer if server_pkg == "port" else jpeer
    slices = cpkg["own"].OwnershipLayout(tree, 2).flat_slices(tree, 1)
    assert sorted(slices) == ["a/W", "a/b", "c"]  # a/b: 6 elements, f32 in an int8 frame
    applied = []

    def apply_fn(params, opt_state, grads):
        flat_p, flat_g = _flatten(params), _flatten(grads)
        applied.append(flat_g)
        new, _ = _exact_apply(flat_p, opt_state, flat_g)
        return (new if server_pkg == "port" else jown.tree_from_flat(new)), opt_state

    owner = spkg.OwnerState(
        worker_id=1, n_workers=2, quorum=1, max_staleness=0, apply_fn=apply_fn,
        slice_params=dict(slices) if server_pkg == "port" else jown.tree_from_flat(slices),
        opt_state={}, counters=spkg.FleetCounters(), delta_window=4, delta_codec="int8")
    srv = spkg.PeerServer(owner, worker_id=1, layout_signature="sig", counters=owner.counters,
                          port=0)
    host, port = srv.start()
    client = cpkg["client"](f"http://{host}:{port}")
    layout = cpkg["own"].OwnershipLayout(tree, 2)
    held = cpkg["own"].tree_from_flat({k: np.array(v) for k, v in _flatten(tree).items()})
    comp = cpkg["wire"].GradCompressor("int8")
    rng = np.random.default_rng(9)
    known, served = 0, []
    try:
        health = json.loads(client.request("GET", "/healthz")[2])
        assert cpkg["wire"].negotiate_push_codec("int8", health["codecs"]) == "int8"
        assert health["delta_window"] == 4
        for rnd, codec in enumerate(["int8", "bf16", "int8", "int8", "bf16", "int8"]):
            g = {k: rng.normal(0, 0.1, v.shape).astype(np.float32) for k, v in slices.items()}
            body = comp.encode(1, {"worker": 0, "stamp": rnd, "epoch": 0}, g, codec)
            want = pwire.decode_grads(body)[1]
            status, _, reply = client.request("POST", "/grad", body=body)
            assert status == 200 and json.loads(reply) == {"accepted": True, "version": rnd + 1}
            assert _same_arrays(applied[-1], want)
            if rnd == 3:
                continue  # the next pull skips a version
            hdrs = {} if rnd == 5 else {"X-SRT-Accept": "delta"}
            status, headers, body = client.request("GET", f"/params?known={known}",
                                                   headers=hdrs)
            meta, arrays = cpkg["wire"].decode_arrays(body)
            served.append(headers["X-SRT-Codec"])
            before = layout.flat_slices(held, 1)
            if headers["X-SRT-Codec"] == "delta":
                assert meta["base"] == known
                layout.merge_flat(held, 1, cpkg["wire"].decode_delta_frame(meta, arrays),
                                  add=True)
            else:
                layout.merge_flat(held, 1, arrays)
            known = int(meta["version"])
            mine = layout.flat_slices(held, 1)
            if rnd < 3:  # one piece a pull: exactly the chain
                assert _same_arrays(mine, owner._wire_flat)
            elif rnd == 4:  # pieces 4 and 5 summed, then added
                total = {}
                for v in (4, 5):
                    pc, piece, _ = owner._delta_pieces[v]
                    for k, d in jwire.decompress_arrays(piece, pc).items():
                        total[k] = d if k not in total else total[k] + d
                assert all(_same(mine[k], before[k] + total[k]) for k in mine)
                assert all(np.abs(mine[k] - owner._wire_flat[k]).max() < 1e-5 for k in mine)
            else:  # a full pull: the parameters
                assert _same_arrays(mine, owner._host_flat)
        assert served == ["delta", "delta", "delta", "delta", "f32"]
        c = owner.counters.snapshot()
        assert c["grad_received"] == c["grad_applied"] == c["applies"] == 6
    finally:
        client.close()
        srv.stop()


def test_a_pulled_frame_merges_whole_or_not_at_all():
    """The worker's pull merge: a full frame writes the owner's slices, a
    delta frame on the known version adds the pieces; a delta on another
    base, one naming an unknown leaf, a malformed piece table and a
    truncated frame raise (the puller counts pull_failed) and change
    nothing."""
    tree = _layout_tree()
    layout = pown.OwnershipLayout(tree, 2)
    slices = layout.flat_slices(tree, 1)
    owner = ppeer.OwnerState(worker_id=1, n_workers=2, quorum=1, max_staleness=10,
                             apply_fn=_exact_apply, slice_params=dict(slices), opt_state={},
                             counters=ppeer.FleetCounters(), delta_window=4)
    _push_rounds([owner], 2)
    held = pown.tree_from_flat({k: np.array(v) for k, v in _flatten(tree).items()})

    def snapshot():
        return {k: np.array(v) for k, v in _flatten(held).items()}

    delta = owner.encoded_for(1, accept_delta=True)[1]
    bad = {
        "other_base": (delta, 0, pwire.WireError),
        "unknown_leaf": (pwire.encode_delta_frame(
            {"version": 2, "worker": 1, "base": 1},
            [(2, "int8", {**owner._delta_pieces[2][1], "nope": np.ones(8, np.float32)})]),
            1, ValueError),
        "piece_table": (pwire.encode_arrays({"version": 2, "codec": "delta", "base": 1,
                                             "pieces": "x"}, {}), 1, pwire.WireError),
        "truncated": (delta[:-3], 1, pwire.WireError),
        "no_version": (pwire.encode_arrays({"worker": 1}, slices), 1, KeyError),
    }
    for name, (body, known, error) in bad.items():
        before = snapshot()
        with pytest.raises(error):
            merge_pulled(layout, held, 1, known, body)
        assert _same_arrays(snapshot(), before), name
    # one piece on the known version: exactly the chain
    assert merge_pulled(layout, held, 1, -1, owner.encoded_for(None)[1]) == (2, False)
    assert _same_arrays(layout.flat_slices(held, 1), owner._host_flat)
    # a puller following a fresh owner's chain one piece a pull lands on it
    held = pown.tree_from_flat({k: np.array(v) for k, v in _flatten(tree).items()})
    owner = ppeer.OwnerState(worker_id=1, n_workers=2, quorum=1, max_staleness=10,
                             apply_fn=_exact_apply, slice_params=dict(slices), opt_state={},
                             counters=ppeer.FleetCounters(), delta_window=4)
    for known in (0, 1, 2):
        _push_rounds([owner], 1, seed=known)
        assert merge_pulled(layout, held, 1, known,
                            owner.encoded_for(known, accept_delta=True)[1]) == (known + 1, True)
        assert _same_arrays(layout.flat_slices(held, 1), owner._wire_flat)
    other = {k: v for k, v in _flatten(held).items() if k not in slices}
    assert all(_same(v, _flatten(tree)[k]) for k, v in other.items())


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flatten(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}
