"""The port's kernel modules against the JAX package, on the CPU.

Each kernel's plain PyTorch version (what a CPU tensor runs) is held against
the Pallas kernel run in interpret mode and against the JAX reference, on
the same inputs made with numpy from a seed. The CUDA kernels themselves are
held against these plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``).

Tolerances: K1 1e-5 (four f32 adds; the JAX probe's bound), K2 1e-4 in f32
and 2e-2 in bf16 (the JAX kernel tests' bounds), K4 1e-4 (the JAX probe's
bound); hashing and quantization bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacy_ray_tpu.ops.flash_attention as fa
from spacy_ray_tpu.ops import hashing as jhash
from spacy_ray_tpu.ops import int8_matmul as ji8
from spacy_ray_tpu.ops.pallas_kernels import TOKEN_BLOCK, _pallas_lookup_raw, _reference_lookup

from spacy_ray_tpu_torch.ops import hashing as thash
from spacy_ray_tpu_torch.ops.flash_attention import (
    NEG, flash_attention, flash_attention_fwd, flash_attention_plain, mask_to_bias,
)
from spacy_ray_tpu_torch.ops.int8_matmul import (
    int8_matmul, int8_matmul_plain, int8_weight_matmul, quantize_int8, split_k,
)
from spacy_ray_tpu_torch.ops.pallas_kernels import (
    hash_embed_gather_sum, hash_embed_gather_sum_plain, hash_embed_lookup,
)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fa, "_INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("rows,D,N", [(500, 64, TOKEN_BLOCK), (250, 96, 2 * TOKEN_BLOCK)])
def test_hash_embed_plain_matches_pallas_kernel(rows, D, N):
    rng = np.random.default_rng(rows)
    table = rng.standard_normal((rows, D)).astype(np.float32)
    ids = rng.integers(0, rows, (N, 4)).astype(np.int32)
    got = hash_embed_gather_sum_plain(_t(table), _t(ids)).numpy()
    kernel = np.asarray(_pallas_lookup_raw(jnp.asarray(table), jnp.asarray(ids),
                                           interpret=True))
    ref = np.asarray(_reference_lookup(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_allclose(got, kernel, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("rows,D,N", [(500, 64, TOKEN_BLOCK), (40, 772, 2 * TOKEN_BLOCK)])
def test_hash_embed_plain_matches_pallas_kernel_on_repeated_ids(rows, D, N):
    # batch padding as training makes it: half the tokens name one quadruple
    # (with a row twice in it), the rest a handful of rows
    rng = np.random.default_rng(D)
    table = rng.standard_normal((rows, D)).astype(np.float32)
    ids = rng.integers(0, 6, (N, 4)).astype(np.int32)
    ids[rng.permutation(N)[: N // 2]] = (3, rows - 1, 3, 0)
    got = hash_embed_gather_sum_plain(_t(table), _t(ids)).numpy()
    kernel = np.asarray(_pallas_lookup_raw(jnp.asarray(table), jnp.asarray(ids),
                                           interpret=True))
    np.testing.assert_allclose(got, kernel, atol=1e-5)
    want = ((table[ids[:, 0]] + table[ids[:, 1]]) + table[ids[:, 2]]) + table[ids[:, 3]]
    assert np.array_equal(got, want)  # the kernel's order of the four adds


def test_hash_embed_lookup_any_token_count():
    # the port pads nothing: [B, T, 4] ids with B*T not a multiple of 256
    rng = np.random.default_rng(1)
    table = rng.standard_normal((300, 32)).astype(np.float32)
    ids = rng.integers(0, 300, (3, 7, 4)).astype(np.int32)
    got = hash_embed_lookup(_t(table), _t(ids))
    assert got.shape == (3, 7, 32)
    ref = np.asarray(_reference_lookup(jnp.asarray(table), jnp.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


# ------------------------------------------------------------------ K2


def _qkv_mask(B, T, H, Dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, Dh)).astype(dtype) for _ in range(3))
    lens = np.array([T] + [max(T - 17 * i, 2) for i in range(1, B - 1)] + [0])
    mask = np.arange(T)[None, :] < lens[:, None]  # last row: every key masked
    return q, k, v, mask, lens


@pytest.mark.parametrize("B,T,H,Dh", [(3, 40, 2, 16), (3, 130, 4, 16)])
def test_flash_plain_matches_pallas_kernel_and_reference(interpret, B, T, H, Dh):
    q, k, v, mask, lens = _qkv_mask(B, T, H, Dh, seed=T)
    o, lse = flash_attention(_t(q), _t(k), _t(v), _t(mask))
    o, lse = o.numpy(), lse.numpy()
    assert o.shape == (B, T, H, Dh) and lse.shape == (B, T, H)
    assert np.isfinite(o).all() and np.isfinite(lse).all()

    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    kernel_o = np.asarray(fa.flash_attention(jq, jk, jv, jm))
    ref_o = np.asarray(fa.reference_attention(jq, jk, jv, jm))
    _, kernel_lse = fa._fwd_raw(
        fa._to_kernel_layout(jq), fa._to_kernel_layout(jk), fa._to_kernel_layout(jv),
        fa._mask_to_bias(jm), scale=1.0 / Dh ** 0.5,
    )
    kernel_lse = np.asarray(kernel_lse)[:, :, :T].transpose(0, 2, 1)

    # every row against the dense reference, the all-masked one included
    # (a uniform average over its T keys)
    np.testing.assert_allclose(o, ref_o, atol=1e-4)
    # rows with a real key against the Pallas kernel; the all-masked row
    # differs there by construction (the TPU kernel averages over the padded
    # 128-multiple of keys, whose padded values are zero)
    real = lens > 0
    np.testing.assert_allclose(o[real], kernel_o[real], atol=1e-4)
    np.testing.assert_allclose(lse[real], kernel_lse[real], atol=1e-4)


def test_flash_plain_bf16_matches_pallas_kernel(interpret):
    q, k, v, mask, lens = _qkv_mask(2, 130, 2, 32, seed=7)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    o, _ = flash_attention(tq, tk, tv, _t(mask))
    assert o.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    kernel_o = np.asarray(fa.flash_attention(jq, jk, jv, jnp.asarray(mask))).astype(np.float32)
    real = lens > 0
    np.testing.assert_allclose(o.float().numpy()[real], kernel_o[real], atol=2e-2)


def test_flash_all_masked_row_is_finite_uniform_average():
    q, k, v, mask, _ = _qkv_mask(2, 9, 1, 16, seed=3)
    o, lse = flash_attention_plain(_t(q), _t(k), _t(v), mask_to_bias(_t(mask)), 0.25)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o[-1].numpy(), np.broadcast_to(v[-1].mean(0), o[-1].shape),
                               atol=1e-6)
    assert mask_to_bias(_t(mask))[-1].eq(NEG).all()


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("M,K,N", [(33, 96, 160), (130, 200, 64)])
def test_int8_plain_matches_pallas_kernel(M, K, N):
    rng = np.random.default_rng(M)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q8, scale = ji8.quantize_int8(jnp.asarray(w))
    kernel = np.asarray(ji8._int8_matmul_raw(jnp.asarray(x), q8, scale, interpret=True))
    got = int8_matmul_plain(_t(x), _t(np.asarray(q8)), _t(np.asarray(scale))).numpy()
    np.testing.assert_allclose(got, kernel, atol=1e-4, rtol=1e-4)
    lead = int8_matmul(_t(x).reshape(1, M, K), _t(np.asarray(q8)), _t(np.asarray(scale)))
    assert lead.shape == (1, M, N)
    np.testing.assert_allclose(lead[0].numpy(), kernel, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("M,K,N", [(33, 96, 160), (130, 200, 64)])
def test_int8_matmul_bf16_x_matches_f32_x_and_pallas_kernel(M, K, N):
    # the serving path hands the kernel bf16 activations as they are (no cast
    # to f32 first): the same values in f32 give the same output
    rng = np.random.default_rng(M + 1)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    xb = _t(rng.standard_normal((M, K)).astype(np.float32)).to(torch.bfloat16)
    x_vals = xb.float().numpy()
    q8, scale = ji8.quantize_int8(jnp.asarray(w))
    kernel = np.asarray(ji8._int8_matmul_raw(jnp.asarray(x_vals), q8, scale, interpret=True))
    q, s = _t(np.asarray(q8)), _t(np.asarray(scale))
    got_b = int8_matmul(xb.reshape(1, M, K), q, s)
    got_f = int8_matmul(_t(x_vals).reshape(1, M, K), q, s)
    assert got_b.dtype == torch.float32 and got_b.shape == (1, M, N)
    assert torch.equal(got_b, got_f)
    np.testing.assert_allclose(got_b[0].numpy(), kernel, atol=1e-4, rtol=1e-4)


def test_int8_f32_x_as_two_bf16_parts_is_within_tolerance():
    # the kernel's f32 path: x = hi + lo with hi = bf16(x), lo = bf16(x - hi),
    # both products exact against the int8 weight (|q| <= 127), summed in f32;
    # the split loses about 2**-16 of |x|, far inside 1e-4 of max |out|
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((64, 768)).astype(np.float32))
    q8, s = quantize_int8(_t((rng.standard_normal((768, 96)) * 0.05).astype(np.float32)))
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    assert not torch.equal(hi, x)  # x is not bf16-exact
    assert (x - hi - lo).abs().max() <= 2.0 ** -16 * x.abs().max()
    split = (hi @ q8.float() + lo @ q8.float()) * s
    want = int8_matmul_plain(x, q8, s)
    assert (split - want).abs().max() <= 1e-4 * want.abs().max()
    assert (hi @ q8.float() * s - want).abs().max() > 1e-4 * want.abs().max()  # hi alone is not


@pytest.mark.parametrize("shape", [(96, 160), (3, 40, 24), (7, 5)])
def test_quantize_int8_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0  # a zero channel takes the 1e-12 scale floor
    w[..., 1] = np.round(w[..., 1] * 4) / 4  # exact halves exercise half-to-even
    jq, js = (np.asarray(a) for a in ji8.quantize_int8(jnp.asarray(w)))
    tq, ts = (a.numpy() for a in quantize_int8(_t(w)))
    assert tq.dtype == np.int8 and np.array_equal(tq, jq)
    assert ts.dtype == np.float32 and np.array_equal(ts.view(np.uint32), js.view(np.uint32))


# ------------------------------------------------------------- hashing


@pytest.mark.parametrize("seed,n_rows", [(0, 500), (12345, 20000), (0x7FFFFFFF, 7)])
def test_hash_embed_ids_bit_equal(seed, n_rows):
    rng = np.random.default_rng(seed % 1000)
    keys = rng.integers(0, 2 ** 32, (5, 33, 2), dtype=np.uint64).astype(np.uint32)
    keys[0, :4] = [[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [1, 0xFFFFFFFF], [0xFFFFFFFF, 0]]
    want = np.asarray(jhash.hash_embed_ids(jnp.asarray(keys), seed, n_rows))
    got = thash.hash_embed_ids(_t(keys.astype(np.int64)), seed, n_rows)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # and the raw 32-bit hashes against the numpy oracle
    h_np = thash.murmur3_x86_128_u64_np(keys[..., 0], keys[..., 1], seed)
    h_t = thash.murmur3_x86_128_u64(_t(keys[..., 0].astype(np.int64)),
                                    _t(keys[..., 1].astype(np.int64)), seed)
    for a, b in zip(h_t, h_np):
        assert np.array_equal(a.numpy(), b.astype(np.int64))


@pytest.mark.parametrize("s", ["", "a", "norm=the", "shape=Xxxxx", "suf=ing",
                               "pre=é", "a much longer attribute string of 40+ bytes"])
def test_hash_string_and_split_match_jax(s):
    assert thash.hash_string_u64(s) == jhash.hash_string_u64(s)
    keys = np.array([jhash.hash_string_u64(s), 2 ** 64 - 1], dtype=np.uint64)
    assert np.array_equal(thash.split_u64(keys), jhash.split_u64(keys))


# ----------------------------------------------------- dispatch rules


def test_kernel_wrappers_refuse_cpu_tensors():
    # a wrapper launches its CUDA kernel or raises; it never runs the plain
    # version itself
    with pytest.raises(ValueError, match="CUDA"):
        hash_embed_gather_sum(torch.zeros(4, 8), torch.zeros(2, 4, dtype=torch.int32))
    q = torch.zeros(1, 4, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q, torch.zeros(1, 4), 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        int8_weight_matmul(torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int8),
                           torch.ones(4))


@pytest.mark.parametrize("M,K,N", [(1024, 768, 2304), (1024, 3072, 768), (64, 768, 768),
                                   (64, 3072, 768), (37, 50, 70), (1, 3, 5), (8, 4000, 16)])
def test_int8_split_k_covers_k_once(M, K, N):
    # the K ranges of the int8 kernel's splits tile [0, K) exactly, in
    # whole K steps, none empty, and never more than the K steps allow; K
    # is split only where the 128 x 128 output tiles leave SMs idle
    splits, chunk = split_k(M, N, K, n_sm=132)
    assert splits >= 1 and chunk % 32 == 0
    assert (splits - 1) * chunk < K <= splits * chunk
    if splits > 1:
        assert chunk >= 4 * 32
    tiles = -(-M // 128) * -(-N // 128)
    if tiles >= 132:
        assert splits == 1
    assert splits * tiles < 2 * 132 or splits == 1

