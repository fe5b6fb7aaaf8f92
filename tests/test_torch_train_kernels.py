"""The training slice's kernel modules against the JAX package, on the CPU.

The plain PyTorch versions (what CPU tensors run) of the hash-embed table
gradient, the flash-attention backward (K3) and the fused Adam/RAdam update
(K5) are held against the JAX functions they replace, on the same inputs
made with numpy from a seed. The CUDA kernels themselves are held against
these plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``).

Tolerances and why:
* table gradient: bit-equal to the same sums in the kernel's order (pieces
  of at most C sorted pairs, then each row's pieces); 1e-5 relative to
  max |ct| against the JAX scatter-add (another summation order);
* K3: 1e-3 in f32 (the JAX kernel tests' bound) and 5e-2 in bf16 (the JAX
  kernel probe's), against the interpret-mode kernel's VJP with a nonzero
  lse cotangent and against the dense reference's gradients;
* K5: 1 ulp against the JAX leaf math and the optax chains run op by op
  (measured 0 on the per-element chain); 1e-6 against the compiled
  interpret-mode kernel, which XLA CPU contracts into FMAs (the JAX probe's
  bound); the global norm sums in another order than optax's and is held to
  4 ulp of it on its own, the chains run with optax's norm;
* schedules and step scalars: bit-equal to the JAX functions run eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import spacy_ray_tpu.ops.flash_attention as fa
import spacy_ray_tpu.ops.fused_update as fu
from spacy_ray_tpu.ops.pallas_kernels import _reference_lookup, _table_grad
from spacy_ray_tpu.training import optimizers as jopt

from spacy_ray_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_bwd, mask_to_bias,
)
from spacy_ray_tpu_torch.ops.fused_update import (
    FusedHyper, FusedUpdate, global_norm, leaf_math_plain, step_scalars,
)
from spacy_ray_tpu_torch.ops.pallas_kernels import (
    TABLE_GRAD_CHUNK, hash_embed_lookup, hash_embed_table_grad, hash_embed_table_grad_plain,
)
from spacy_ray_tpu_torch.training import optimizers as popt

f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fa, "_INTERPRET", True)


# ------------------------------------------------------ table gradient


def _piecewise_table_grad(ct, ids, rows):
    """The kernel's order of summation as a numpy loop: the (row, pair)
    pairs stably sorted by row and cut into chunks of C; each piece (row and
    chunk) summed from zero in ascending (token, j) order, each row the sum
    of its pieces from zero in chunk order."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    out = np.zeros((rows, ct.shape[1]), f32)
    piece = None
    for k, pair in enumerate(order):
        row = flat[pair]
        if piece is None or row != flat[order[k - 1]] or k % TABLE_GRAD_CHUNK == 0:
            if piece is not None:
                out[flat[order[k - 1]]] = out[flat[order[k - 1]]] + piece
            piece = np.zeros(ct.shape[1], f32)
        piece = piece + ct[pair // 4]
    if piece is not None:
        out[flat[order[-1]]] = out[flat[order[-1]]] + piece
    return out


def _check_table_grad(ct, ids, rows):
    got = hash_embed_table_grad_plain(_t(ct), _t(ids), rows).numpy()
    want = np.asarray(_table_grad(jnp.asarray(ids), jnp.asarray(ct), rows))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(ct).max())
    assert np.array_equal(got.view(np.uint32), _piecewise_table_grad(ct, ids, rows).view(np.uint32))
    assert np.all(got[np.setdiff1d(np.arange(rows), ids)] == 0)  # untouched rows
    return got


@pytest.mark.parametrize("rows,N,D", [(50, 300, 16), (500, 512, 64)])
def test_table_grad_plain_matches_jax_and_is_ordered(rows, N, D):
    rng = np.random.default_rng(rows)
    ct = (rng.standard_normal((N, D)) * 10.0 ** rng.integers(-3, 3, (N, 1))).astype(f32)
    ids = rng.integers(0, rows, (N, 4)).astype(np.int32)
    _check_table_grad(ct, ids, rows)


@pytest.mark.parametrize("lead,n_skew", [(0, 2000), (1, 3000), (TABLE_GRAD_CHUNK - 1, 4100)])
def test_table_grad_plain_skewed_row_over_many_chunks(lead, n_skew):
    # one row takes thousands of pairs (batch padding's), rows 7 and 11 take
    # exactly C and C + 1, rows 0-2 take `lead` pairs so those runs start at
    # different places in their chunk; rows 12-19 stay untouched
    C = TABLE_GRAD_CHUNK
    rows, N, D = 300, 1600, 16
    rng = np.random.default_rng(lead)
    flat = rng.integers(20, rows, 4 * N)
    pos = rng.permutation(4 * N - 4)  # the last token's pairs keep random rows
    for row, count in ((3, n_skew), (7, C), (11, C + 1), (int(rng.integers(0, 3)), lead)):
        flat[pos[:count]] = row
        pos = pos[count:]
    ids = flat.reshape(N, 4).astype(np.int32)
    ct = (rng.standard_normal((N, D)) * 0.01).astype(f32)
    ct[-1] *= 300.0  # max |ct| ~ 10: the skewed row's rounding stays far inside 1e-5 of it
    got = _check_table_grad(ct, ids, rows)
    assert np.count_nonzero(ids == 3) == n_skew and -(-n_skew // C) >= 30
    assert np.all(got[12:20] == 0)


def test_hash_embed_lookup_gradient_matches_jax_grad():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((64, 96)).astype(f32)
    ids = rng.integers(0, 64, (3, 37, 4)).astype(np.int32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jnp.sin(_reference_lookup(t, ids))))(
        jnp.asarray(table)))
    t = _t(table).requires_grad_(True)
    torch.sin(hash_embed_lookup(t, _t(ids))).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-4)


# ------------------------------------------------------------------ K3


def _attn_inputs(B, T, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, T, H, Dh)).astype(f32) for _ in range(4))
    dlse = rng.standard_normal((B, T, H)).astype(f32)
    lens = np.array([T] + [max(T - 17 * i, 2) for i in range(1, B - 1)] + [0])
    mask = np.arange(T)[None, :] < lens[:, None]  # last row: every key masked
    return q, k, v, do, dlse, mask, lens


def _port_grads(q, k, v, do, dlse, mask, dtype=torch.float32):
    tq, tk, tv = (_t(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    o, lse = FlashAttention.apply(tq, tk, tv, mask_to_bias(_t(mask)), q.shape[-1] ** -0.5)
    cts = (_t(do).to(dtype), None if dlse is None else _t(dlse))
    outs = (o, lse) if dlse is not None else (o,)
    grads = torch.autograd.grad(outs, (tq, tk, tv), cts[:len(outs)])
    return [g.float().numpy() for g in grads]


def _kernel_vjp(q, k, v, do, dlse, mask, dtype=jnp.float32):
    """The interpret-mode Pallas kernel's VJP, in the trunk's layout."""
    B, T, H, Dh = q.shape
    lay = lambda x: fa._to_kernel_layout(jnp.asarray(x, dtype))  # noqa: E731
    fl = fa._make_flash_lse(1.0 / Dh ** 0.5)
    (o, lse), vjp = jax.vjp(fl, lay(q), lay(k), lay(v), fa._mask_to_bias(jnp.asarray(mask)))
    dlse_k = jnp.pad(jnp.asarray(dlse).transpose(0, 2, 1), ((0, 0), (0, 0), (0, lse.shape[2] - T)))
    dq, dk, dv, _ = vjp((lay(do), dlse_k))
    return [np.asarray(x[:, :, :T, :Dh].astype(jnp.float32)).transpose(0, 2, 1, 3)
            for x in (dq, dk, dv)]


@pytest.mark.parametrize("B,T,H,Dh", [(3, 40, 2, 16), (3, 130, 2, 16)])
def test_attention_bwd_plain_matches_interpreted_kernel_vjp(interpret, B, T, H, Dh):
    q, k, v, do, dlse, mask, lens = _attn_inputs(B, T, H, Dh, seed=T)
    got = _port_grads(q, k, v, do, dlse, mask)
    want = _kernel_vjp(q, k, v, do, dlse, mask)
    real = lens > 0  # the all-masked row differs by construction (Queue C 1)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[real], w[real], atol=1e-3)


def test_attention_bwd_plain_bf16_matches_interpreted_kernel_vjp(interpret):
    q, k, v, do, dlse, mask, lens = _attn_inputs(2, 130, 2, 32, seed=9)
    got = _port_grads(q, k, v, do, dlse, mask, torch.bfloat16)
    want = _kernel_vjp(q, k, v, do, dlse, mask, jnp.bfloat16)
    real = lens > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[real], w[real], atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)])
def test_attention_bwd_plain_matches_reference_gradients(dtype, tol):
    q, k, v, do, _, mask, lens = _attn_inputs(3, 33, 2, 16, seed=2)
    got = _port_grads(q, k, v, do, None, mask, dtype)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: fa.reference_attention(a, b, c, jnp.asarray(mask)),
                     *(jnp.asarray(x, jd) for x in (q, k, v)))
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(do, jd))]
    real = lens > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[real], w[real], atol=tol, rtol=tol)


def test_attention_bwd_all_masked_row_finite_with_lse_cotangent():
    q, k, v, do, dlse, mask, _ = _attn_inputs(2, 9, 1, 16, seed=3)
    for g in _port_grads(q, k, v, do, dlse, mask):
        assert np.isfinite(g).all()


# ------------------------------------------------------------------ K5


def _ulp(a, b):
    a, b = (np.asarray(x, f32).view(np.int32).astype(np.int64) for x in (a, b))
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max())


HYPERS = [
    FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.01),
    FusedHyper("adam", 0.9, 0.999, 1e-8, 0.0, 0.01, 0.0),
    FusedHyper("radam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0),
    FusedHyper("radam", 0.9, 0.99, 1e-6, 0.5, 0.0, 0.01),
]


def _leaf_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(f32), (rng.standard_normal(n) * 0.1).astype(f32),
            (rng.standard_normal(n) * 0.01).astype(f32),
            np.abs(rng.standard_normal(n) * 0.01).astype(f32))


@pytest.mark.parametrize("hyper", HYPERS, ids=lambda h: f"{h.kind}-clip{h.grad_clip}-l2{h.l2_grad}")
@pytest.mark.parametrize("gnorm", [0.3, 2.3])
def test_leaf_math_plain_matches_jax_leaf_math_and_kernel(hyper, gnorm):
    p, g, m, v = _leaf_inputs(4321, seed=int(gnorm * 10))
    jh = fu.FusedHyper(*hyper)
    scal = [f32(gnorm), f32(0.271), f32(0.00299), f32(-0.001), f32(6.0), f32(0.8)]
    got = leaf_math_plain(*map(_t, (p, g, m, v)), torch.tensor(scal[0]),
                          *(float(x) for x in scal[1:]), hyper=hyper)
    eager = fu._leaf_math(*map(jnp.asarray, (p, g, m, v)), *map(jnp.asarray, scal), jh)
    kernel = fu._kernel_leaf(*map(jnp.asarray, (p, g, m, v)), jnp.asarray(scal), jh,
                             interpret=True)
    for a, e, k in zip(got, eager, kernel):
        assert _ulp(a.numpy(), e) <= 1
        np.testing.assert_allclose(a.numpy(), np.asarray(k), atol=1e-6, rtol=1e-6)


def test_step_scalars_match_jax_update_scalars():
    # the reference's scalars as its train step computes them: traced, with
    # the count an int32 array (b ** count is then float32 pow, not the
    # repeated product eager JAX takes for a concrete exponent)
    def scalars(ci, b1, b2):
        bc1 = 1 - b1 ** ci
        bc2 = 1 - b2 ** ci
        ro_inf = 2.0 / (1 - b2) - 1
        b2t = b2 ** ci
        ro = ro_inf - 2 * ci * b2t / (1 - b2t)
        rect = jnp.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
        return bc1, bc2, ro, rect

    for b1, b2 in ((0.9, 0.999), (0.8, 0.99)):
        jitted = jax.jit(lambda ci: scalars(ci, b1, b2))
        for count in list(range(0, 40)) + [997, 4999, 19999]:
            want = [np.asarray(x) for x in jitted(jnp.asarray(count + 1, jnp.int32))]
            sc = step_scalars(FusedHyper("radam", b1, b2, 1e-8, 1.0, 0.0, 0.0), count, count,
                              lambda s: f32(0.001))
            assert (f32(sc.bc1), f32(sc.bc2), f32(sc.ro)) == tuple(want[:3]), count
            assert np.isnan(want[3]) == np.isnan(sc.rect)
            if not np.isnan(want[3]):  # XLA may fold the rect division: 1 ulp
                assert _ulp(f32(sc.rect), want[3]) <= 1
            assert sc.step_size == float(f32(-0.001))


@pytest.mark.parametrize("name,args", [
    ("warmup_linear", dict(initial_rate=0.001, warmup_steps=25, total_steps=200)),
    ("warmup_linear", dict(initial_rate=0.003, warmup_steps=0, total_steps=50)),
    ("linear", dict(initial_rate=0.002, final_rate=0.0001, total_steps=90)),
    ("cosine", dict(initial_rate=0.001, total_steps=120, final_scale=0.1)),
])
def test_schedules_match_jax(name, args):
    jfn = getattr(jopt, name)(**args).fn
    pfn = getattr(popt, name)(**args).fn
    for step in range(0, 260, 7):
        want = np.asarray(jfn(step))
        got = pfn(step)
        # np.cos and XLA's cos may differ by an ulp, which the products carry
        assert _ulp(got, want) <= (2 if name == "cosine" else 0), (step, got, want)


def test_iterable_learn_rate_holds_its_last_value():
    fn = popt.as_schedule_fn([0.1, 0.2, 0.3])
    assert [float(fn(s)) for s in (0, 1, 2, 5, 10 ** 6)] == [float(f32(x)) for x in
                                                           (0.1, 0.2, 0.3, 0.3, 0.3)]


def _chain_pair(kind, clip, l2, decay_mode):
    """The JAX optax chain and the port's optimizer from one config; Adam
    under warmup_linear, RAdam at a constant rate."""
    if kind == "adam":
        cfg = dict(grad_clip=clip, L2=l2, L2_is_weight_decay=decay_mode)
        return (jopt.Adam(learn_rate=jopt.warmup_linear(0.01, 3, 20), **cfg).tx,
                popt.Adam(learn_rate=popt.warmup_linear(0.01, 3, 20), **cfg))
    cfg = dict(learn_rate=0.01, grad_clip=clip, weight_decay=l2)
    return jopt.RAdam(**cfg).tx, popt.RAdam(**cfg)


@pytest.mark.parametrize("kind,clip,l2,decay_mode,scale", [
    ("adam", 1.0, 0.0, True, 10.0),     # clip active
    ("adam", 1.0, 0.0, True, 0.001),    # clip inactive
    ("adam", 0.0, 0.01, False, 1.0),    # classic L2 into the gradient
    ("adam", 1.0, 0.01, True, 1.0),     # decoupled decay
    ("radam", 1.0, 0.0, True, 10.0),    # rectified from step 6
])
def test_optimizer_matches_optax_chain_over_steps(monkeypatch, kind, clip, l2, decay_mode,
                                                  scale):
    # the whole chain (scalars, clip, moments, state) to 1 ulp, with the
    # port's global norm replaced by optax's value: the two norms sum in
    # other orders (checked on their own below), and Adam's normalised step
    # turns an ulp of the clip scale into ulps of every parameter
    monkeypatch.setattr(popt, "global_norm", lambda gs: torch.tensor(np.asarray(
        optax.global_norm([jnp.asarray(x.numpy()) for x in gs]))))
    rng = np.random.default_rng(11)
    shapes = {"a/W": (13, 7), "a/b": (7,), "c": (300,)}
    params = {k: rng.standard_normal(s).astype(f32) for k, s in shapes.items()}
    jtx, popt_ = _chain_pair(kind, clip, l2, decay_mode)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    tstate = popt_.init(tp)
    for step in range(8):
        grads = {k: (rng.standard_normal(s) * scale).astype(f32) for k, s in shapes.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        popt_.update(tp, {k: _t(v) for k, v in grads.items()}, tstate)
        adam_state = next(x for x in jstate if hasattr(x, "mu"))
        for k in shapes:
            for m in ("mu", "nu"):
                assert _ulp(tstate[m][k].numpy(), getattr(adam_state, m)[k]) <= 1, (step, k, m)
            # eager optax forms b ** count by repeated products, the traced
            # train step (and the port, test_step_scalars_match_...) by pow:
            # an ulp apart, which moves a step of lr * |u| <= 0.01 by about
            # 1e-9. RAdam's ro subtracts nearly equal numbers (1 - b2**count
            # is 0.006 at count 6), which turns that ulp into ~1e-5 of rect
            atol = 1e-5 if kind == "radam" else 1e-9
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1.2e-7, atol=atol)
    assert tstate["count"] == 8


@pytest.mark.parametrize("clip,l2,scale", [(1.0, 0.0, 10.0), (1.0, 0.01, 1e-3), (0.0, 0.0, 1.0)])
def test_sgd_matches_optax_chain_over_steps(monkeypatch, clip, l2, scale):
    monkeypatch.setattr(popt, "global_norm", lambda gs: torch.tensor(np.asarray(
        optax.global_norm([jnp.asarray(x.numpy()) for x in gs]))))
    rng = np.random.default_rng(3)
    shapes = {"w": (11, 5), "b": (40,)}
    params = {k: rng.standard_normal(s).astype(f32) for k, s in shapes.items()}
    jtx = jopt.SGD(learn_rate=0.05, L2=l2, grad_clip=clip)
    ptx = popt.SGD(learn_rate=0.05, L2=l2, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    tstate = ptx.init(tp)
    for _ in range(4):
        grads = {k: (rng.standard_normal(s) * scale).astype(f32) for k, s in shapes.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ptx.update(tp, {k: _t(v) for k, v in grads.items()}, tstate)
        for k in shapes:
            assert _ulp(tp[k].numpy(), jp[k]) <= 1, k
    assert tstate["mu"] == {} and tstate["count"] == 4


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_norm_matches_optax_within_float32_rounding(scale):
    rng = np.random.default_rng(5)
    grads = [(rng.standard_normal(s) * scale).astype(f32) for s in ((13, 7), (7,), (3000,))]
    got = global_norm([_t(g) for g in grads])
    want = np.asarray(optax.global_norm([jnp.asarray(g) for g in grads]))
    assert got.dtype == torch.float32 and got.shape == ()
    assert _ulp(got.numpy(), want) <= 4


def test_fused_optimizer_state_round_trips_through_load_opt_state():
    opt = popt.Adam(learn_rate=0.001)
    params = {"x/W": torch.ones(3, 2), "b": torch.zeros(4)}
    state = opt.init(params)
    flat = {"mu/x/W": np.full((3, 2), 0.5, f32), "nu/x/W": np.full((3, 2), 0.25, f32),
            "mu/b": np.ones(4, f32), "nu/b": np.ones(4, f32), "count": np.asarray(7)}
    opt.load_opt_state(state, flat)
    assert state["count"] == 7 and float(state["mu"]["x/W"][0, 0]) == 0.5
    del flat["nu/b"]
    with pytest.raises(ValueError, match="nu/b"):
        opt.load_opt_state(state, flat)


# ----------------------------------------------------- dispatch rules


def test_training_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        hash_embed_table_grad(torch.zeros(2, 8), torch.zeros(2, 4, dtype=torch.int32), 5)
    q = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, q, q, torch.zeros(1, 4), q, torch.zeros(1, 4, 1), q, None, 0.25)
    p = [torch.zeros(5)]
    with pytest.raises(ValueError, match="CUDA"):
        FusedUpdate(HYPERS[0]).kernel_step(p, p, p, p, torch.zeros(()),
                                           step_scalars(HYPERS[0], 0, 0, lambda s: 0.1))

