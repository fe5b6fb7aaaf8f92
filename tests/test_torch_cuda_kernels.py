"""The hash-embed, int8 and training kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc, carries the ``cuda`` marker
and skips without a card. The file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_*.py

Tolerances are those of ``chip_smoke.py``: K1 and its table gradient
bit-equal (the same f32 adds in the same order; the gradient against the
CPU plain version, and two runs bit-identical), K4 within 1e-4 of max |out|
for bf16 and f32 x, K2 and K3 in f32 within 1e-4 and 1e-3, K5 within 1 ulp.
"""

import pytest
import torch

from chip_smoke import ulp_diff
from spacy_ray_tpu_torch.ops import _cuda
from spacy_ray_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain,
    mask_to_bias,
)
from spacy_ray_tpu_torch.ops.fused_update import (
    FusedHyper, FusedUpdate, global_norm, leaf_math_plain, step_scalars,
)
from spacy_ray_tpu_torch.ops.int8_matmul import (
    int8_matmul, int8_matmul_plain, int8_weight_matmul, quantize_int8, split_k,
)
from spacy_ray_tpu_torch.ops.pallas_kernels import (
    TABLE_GRAD_CHUNK, hash_embed_gather_sum, hash_embed_gather_sum_plain, hash_embed_table_grad,
    hash_embed_table_grad_plain,
)

HYPERS = [
    FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.01),
    FusedHyper("adam", 0.9, 0.999, 1e-8, 0.0, 0.01, 0.0),
    FusedHyper("radam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0),
    FusedHyper("radam", 0.9, 0.99, 1e-6, 0.5, 0.0, 0.01),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda"), torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    dev, g = _card()
    table = torch.randn(1000, 64, device=dev, generator=g)
    ids = torch.randint(0, 1000, (77, 4), device=dev, generator=g, dtype=torch.int32)
    assert torch.equal(hash_embed_gather_sum(table, ids), hash_embed_gather_sum_plain(table, ids))
    qkv = torch.randn(3, 70, 3 * 64, device=dev, generator=g)
    q, k, v = (x.view(3, 70, 4, 16) for x in qkv.split(64, dim=-1))
    mask = torch.arange(70, device=dev)[None] < torch.tensor([70, 33, 0], device=dev)[:, None]
    bias = mask_to_bias(mask)
    o, lse = flash_attention_fwd(q, k, v, bias, 0.25)
    o2, lse2 = flash_attention_plain(q, k, v, bias, 0.25)
    torch.testing.assert_close(o, o2, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, lse2, atol=1e-4, rtol=0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # K4: bf16 x (the serving path's), f32 x whose values are not bf16-exact,
    # ragged M, N and K, K not a multiple of 16, rows not 16-byte aligned,
    # and shapes whose K is split across CTAs
    for M, K, N in ((33, 96, 40), (37, 50, 70), (130, 200, 64), (129, 771, 136), (20, 768, 70),
                    (64, 3072, 768), (1024, 768, 768), (1024, 768, 2304), (1, 8, 16)):
        w8, s = quantize_int8(torch.randn(K, N, device=dev, generator=g) * 0.05)
        x = torch.randn(M, K, device=dev, generator=g)
        for xx in (x, x.to(torch.bfloat16)):
            got = int8_weight_matmul(xx, w8, s)
            want = int8_matmul_plain(xx, w8, s)
            assert got.dtype == torch.float32
            assert (got - want).abs().max() <= 1e-4 * want.abs().max(), (M, K, N, xx.dtype)
    assert not torch.equal(x, x.to(torch.bfloat16).float())
    assert split_k(20, 70, 768, n_sm)[0] > 1 and split_k(1024, 768, 768, n_sm)[0] > 1
    assert split_k(1024, 2304, 768, n_sm)[0] == 1
    # int8_matmul hands bf16 activations to the kernel as they are
    w8, s = quantize_int8(torch.randn(768, 96, device=dev, generator=g) * 0.05)
    xb = torch.randn(2, 64, 768, device=dev, generator=g).to(torch.bfloat16)
    before = _cuda.LAUNCHES["int8_weight_matmul"]
    got = int8_matmul(xb, w8, s)
    assert _cuda.LAUNCHES["int8_weight_matmul"] == before + 1
    assert torch.equal(got.reshape(128, -1), int8_weight_matmul(xb.reshape(128, 768), w8, s))


@pytest.mark.cuda
def test_cuda_table_grad_matches_plain_version():
    dev, g = _card()
    C = TABLE_GRAD_CHUNK
    # tables from a few dozen rows to the 768-wide training shape, sorted on
    # int16 keys, and one of more than 2**15 rows, sorted on int32 keys
    for rows, N, D in ((97, 300, 64), (20000, 8192, 768), (500, 2000, 16), (40000, 4096, 64)):
        ct = torch.randn(N, D, device=dev, generator=g)
        uniform = torch.randint(0, rows, (N, 4), device=dev, generator=g, dtype=torch.int32)
        # skewed: most pairs on one row (batch padding's), rows with exactly
        # C and C + 1 pairs, the rest on a few dozen rows
        skewed = torch.randint(0, 40, (N * 4,), device=dev, generator=g, dtype=torch.int32)
        perm = torch.randperm(N * 4, device=dev, generator=g)
        skewed[perm[: N * 2]] = 3
        skewed[perm[N * 2: N * 2 + C]] = rows - 1
        skewed[perm[N * 2 + C: N * 2 + 2 * C + 1]] = rows - 2
        for ids in (uniform, skewed.reshape(N, 4)):
            got = hash_embed_table_grad(ct, ids, rows)
            again = hash_embed_table_grad(ct, ids, rows)
            assert torch.equal(got, again)  # no atomics: runs are bit-identical
            want = hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows)
            assert torch.equal(got.cpu(), want), (rows, N, D)


@pytest.mark.cuda
def test_cuda_attention_bwd_matches_plain_version():
    dev, g = _card()
    qkv = torch.randn(3, 70, 3 * 64, device=dev, generator=g)
    q, k, v = (x.view(3, 70, 4, 16) for x in qkv.split(64, dim=-1))
    mask = torch.arange(70, device=dev)[None] < torch.tensor([70, 33, 0], device=dev)[:, None]
    bias = mask_to_bias(mask)
    o, lse = flash_attention_fwd(q, k, v, bias, 0.25)
    do = torch.randn(3, 70, 4, 16, device=dev, generator=g)
    dlse = torch.randn(3, 70, 4, device=dev, generator=g)
    for a, b in zip(flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, 0.25),
                    flash_attention_bwd_plain(q, k, v, bias, o, lse, do, dlse, 0.25)):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_fused_update_matches_plain_version():
    dev, g = _card()
    for hyper in HYPERS:
        P, G, M, V = ([torch.randn(s, device=dev, generator=g) * sc for s in ((700, 3), (70001,))]
                      for sc in (1.0, 0.1, 0.01, 0.01))
        V = [v.abs() for v in V]
        gn = global_norm(G)
        sc = step_scalars(hyper, 6, 6, lambda s: 0.001)
        want = [leaf_math_plain(p, gg, m, v, gn, *sc, hyper=hyper) for p, gg, m, v in zip(P, G, M, V)]
        FusedUpdate(hyper).step(P, G, M, V, gn, sc)
        for got, w in zip(zip(P, M, V), want):
            for a, b in zip(got, w):
                assert ulp_diff(torch, a, b) <= 1
