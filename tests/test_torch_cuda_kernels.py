"""The hash-embed, int8 and training kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc, carries the ``cuda`` marker
and skips without a card. The file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_*.py

Tolerances are those of ``chip_smoke.py``: K1 and its table gradient
bit-equal (the same f32 adds in the same order; the gradient against the
CPU plain version, and two runs bit-identical), K4 within 1e-4 of max |out|
for bf16 and f32 x, K2 and K3 in f32 within 1e-4 and 1e-3, K5 within 1 ulp
(0 ulp, bit-equal, on odd-sized and misaligned leaves).
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


@pytest.mark.cuda
def test_cuda_gather_sum_bit_equal_at_every_shape():
    # uniform ids, and half the tokens on one quadruple (batch padding's)
    dev, g = _card()
    for D in (4, 64, 96, 768, 772):
        table = torch.randn(3000, D, device=dev, generator=g)
        for N in (1, 3, 128, 1024, 8192):
            ids = torch.randint(0, 3000, (N, 4), device=dev, generator=g, dtype=torch.int32)
            rep = ids.clone()
            rep[torch.randperm(N, device=dev, generator=g)[: N // 2]] = torch.tensor(
                [7, 2999, 7, 0], device=dev, dtype=torch.int32)
            for x in (ids, rep):
                got = hash_embed_gather_sum(table, x)
                assert torch.equal(got, hash_embed_gather_sum_plain(table, x)), (D, N)


@pytest.mark.cuda
def test_cuda_fused_update_odd_and_misaligned_leaves_bit_equal():
    # leaves of odd sizes, as views at float offsets 0-3 into larger buffers:
    # p, g, m, v at one offset (scalar head and tail, vector body) and each at
    # its own (scalar chunks); RAdam unrectified (count 1) and rectified
    # (count 6); clipping that scales (g ~ 0.1) and that does not (g ~ 1e-6)
    dev, g = _card()
    sizes = (1, 3, 4, 5, 65535, 65537, 262147)
    for hyper in HYPERS:
        for count in (1, 6):
            for g_scale in (0.1, 1e-6):
                leaves = ([], [], [], [])
                for j, n in enumerate(sizes):
                    for offs in ((j % 4,) * 4, tuple((j + k) % 4 for k in range(4))):
                        for X, o, s in zip(leaves, offs, (1.0, g_scale, 0.01, 0.01)):
                            buf = torch.randn(n + 4, device=dev, generator=g) * s
                            X.append(buf[o:o + n])
                P, G, M, V = leaves
                for v in V:
                    v.abs_()
                gn = global_norm(G)
                sc = step_scalars(hyper, count, count, lambda s: 0.001)
                want = [leaf_math_plain(p, gg, m, v, gn, *sc, hyper=hyper)
                        for p, gg, m, v in zip(P, G, M, V)]
                FusedUpdate(hyper).step(P, G, M, V, gn, sc)
                for got, w in zip(zip(P, M, V), want):
                    for a, b in zip(got, w):
                        assert ulp_diff(torch, a, b) == 0, (hyper, count, g_scale, a.numel())


@pytest.mark.cuda
def test_cuda_table_grad_at_the_cnn_tables_bit_equal():
    # configs/cnn.cfg's tables (2000 and 1000 rows, D 96) on corpus-like
    # ids: a zipfian vocabulary of keys hashed as HashEmbed hashes them, and
    # a third of the tokens batch padding (the zero key)
    dev, g = _card()
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids

    N, D = 8192, 96
    vocab = torch.randint(1, 2 ** 32, (300, 2), device=dev, generator=g)
    zipf = 1.0 / torch.arange(1, 301, device=dev, dtype=torch.float32)
    words = torch.multinomial(zipf, N, replacement=True, generator=g)
    keys = vocab[words]
    keys[torch.randperm(N, device=dev, generator=g)[: N // 3]] = 0
    ct = torch.randn(N, D, device=dev, generator=g)
    for rows, seed in ((2000, 11), (1000, 12), (1000, 13)):
        ids = hash_embed_ids(keys, seed, rows)
        got = hash_embed_table_grad(ct, ids, rows)
        assert torch.equal(got, hash_embed_table_grad(ct, ids, rows))
        # the CPU plain version sums in the kernel's order (index_add_ on the
        # card adds with atomics, in no fixed order)
        assert torch.equal(got.cpu(), hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows))
        assert torch.equal(hash_embed_gather_sum(got, ids), hash_embed_gather_sum_plain(got, ids))


@pytest.mark.cuda
def test_cuda_fused_update_over_the_cnn_pipelines_leaves_bit_equal():
    # every leaf of configs/cnn.cfg and sm.cfg (LayerNorm g/b of 96, maxout
    # b [96, 3], the heads' odd-sized biases) as consecutive views of one
    # buffer, each buffer at its own float offset, under the three hyper sets
    import spacy_ray_tpu_torch as P
    from pathlib import Path

    dev, g = _card()
    labels = {"tagger": ["ADJ", "NOUN", "VERB"], "parser": ["ROOT", "nsubj", "obj"],
              "ner": ["LOC", "PER"]}
    for name in ("cnn", "sm"):
        cfg = P.Config.from_disk(Path(__file__).resolve().parent.parent / "configs" / f"{name}.cfg")
        cfg["paths"] = {"train": "-", "dev": "-"}
        nlp = P.Pipeline.from_config(cfg.interpolate(), device="cpu")
        nlp.initialize(labels={k: v for k, v in labels.items() if k in nlp.pipe_names})
        shapes = [tuple(p.shape) for p in nlp.model.parameters()]
        assert (96,) in shapes and (96, 3) in shapes
        total = sum(torch.Size(s).numel() for s in shapes)
        for hyper in HYPERS[:3]:
            bufs = [torch.randn(total + 3, device=dev, generator=g) * s
                    for s in (1.0, 1e-3, 1e-4, 1e-4)]
            bufs[3].abs_()
            leaves = ([], [], [], [])
            for X, buf, start in zip(leaves, bufs, (1, 2, 3, 0)):
                o = start
                for s in shapes:
                    n = torch.Size(s).numel()
                    X.append(buf[o:o + n].view(s))
                    o += n
            Pl, G, M, V = leaves
            gn = global_norm(G)
            sc = step_scalars(hyper, 4, 4, lambda s: 0.001)
            want = [leaf_math_plain(p, gg, m, v, gn, *sc, hyper=hyper)
                    for p, gg, m, v in zip(Pl, G, M, V)]
            FusedUpdate(hyper).step(Pl, G, M, V, gn, sc)
            for got, w in zip(zip(Pl, M, V), want):
                for a, b in zip(got, w):
                    assert ulp_diff(torch, a, b) == 0, (name, hyper, a.shape)


@pytest.mark.cuda
def test_cuda_hash_embed_at_the_spancat_microbatch_bit_equal():
    # configs/spancat.cfg's first microbatch: batch_by_words 2000 over span
    # docs and cat docs in turn (~264 docs of ~9 words: B 512, T 32, N 16384,
    # most of it batch padding), the trunk's four tables (D 96)
    from pathlib import Path

    import spacy_ray_tpu_torch as P
    from spacy_ray_tpu_torch.models.layers import HashEmbed
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.util import synth_corpus

    dev, g = _card()
    cfg = P.Config.from_disk(Path(__file__).resolve().parent.parent / "configs" / "spancat.cfg")
    cfg["paths"] = {"train": "-", "dev": "-"}
    cfg = cfg.interpolate()
    nlp = P.Pipeline.from_config(cfg, device=dev)
    nlp.initialize(labels={"spancat": ["GPE", "ORG", "PERSON"],
                           "textcat_multilabel": ["FOOD", "SPORTS", "TECH"]})
    egs = [eg for pair in zip(synth_corpus(1000, "spancat", 0), synth_corpus(1000, "textcat", 1))
           for eg in pair]
    batch = next(iter(registry.resolve(cfg["training"]["batcher"])(egs)))
    keys = nlp.collate(batch)["tokens"].attr_keys
    assert keys.shape[0] * keys.shape[1] >= 8192
    tables = [m for m in nlp.model.modules() if isinstance(m, HashEmbed)]
    assert [m.dims["rows"] for m in tables] == [2000, 1000, 1000, 1000]
    for m in tables:
        rows = m.dims["rows"]
        ids = hash_embed_ids(keys[..., m.attr_index, :].reshape(-1, 2), m.seed, rows)
        table = torch.randn(rows, 96, device=dev, generator=g)
        assert torch.equal(hash_embed_gather_sum(table, ids), hash_embed_gather_sum_plain(table, ids))
        ct = torch.randn(ids.shape[0], 96, device=dev, generator=g)
        got = hash_embed_table_grad(ct, ids, rows)
        assert torch.equal(got, hash_embed_table_grad(ct, ids, rows))
        assert torch.equal(got.cpu(), hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spancat", "textcat", "tokcls"])
def test_cuda_fused_update_over_the_classifiers_leaves_bit_equal(name):
    # spancat.cfg's leaves; spaCy's default textcat over cnn.cfg's trunk, its
    # BOW table [262144, 3] with a gradient that is zero but on ~1 % of rows
    # (those a microbatch touches); the token classifiers' odd-sized heads
    import chip_smoke
    import spacy_ray_tpu_torch as P

    dev, g = _card()
    cfg = chip_smoke.pipeline_config(name, ("-", "-")).interpolate()
    nlp = P.Pipeline.from_config(cfg, device="cpu")
    labels = {"spancat": ["GPE", "ORG", "PERSON"], "textcat_multilabel": ["A", "B", "C"],
              "textcat": ["FOOD", "SPORTS", "TECH"], "tagger": ["DT", "NN", "VBD"],
              "morphologizer": ["NOUN|Number=Sing", "VERB|Tense=Past", "X"], "senter": ["I", "S"],
              "trainable_lemmatizer": ["null", '["s","a","b"]']}
    nlp.initialize(labels={k: v for k, v in labels.items() if k in nlp.pipe_names})
    shapes = [tuple(p.shape) for p in nlp.model.parameters()]
    if name == "textcat":
        assert (262144, 3) in shapes
    total = sum(torch.Size(s).numel() for s in shapes)
    for hyper in HYPERS[:3]:
        bufs = [torch.randn(total + 3, device=dev, generator=g) * s
                for s in (1.0, 1e-3, 1e-4, 1e-4)]
        bufs[3].abs_()
        leaves = ([], [], [], [])
        for X, buf, start in zip(leaves, bufs, (1, 2, 3, 0)):
            o = start
            for s in shapes:
                n = torch.Size(s).numel()
                X.append(buf[o:o + n].view(s))
                o += n
        Pl, G, M, V = leaves
        for grad in G:
            if grad.shape[0] == 262144:
                grad[torch.rand(grad.shape[0], device=dev, generator=g) > 0.01] = 0
        gn = global_norm(G)
        sc = step_scalars(hyper, 4, 4, lambda s: 0.001)
        want = [leaf_math_plain(p, gg, m, v, gn, *sc, hyper=hyper)
                for p, gg, m, v in zip(Pl, G, M, V)]
        FusedUpdate(hyper).step(Pl, G, M, V, gn, sc)
        for got, w in zip(zip(Pl, M, V), want):
            for a, b in zip(got, w):
                assert ulp_diff(torch, a, b) == 0, (name, hyper, a.shape)


@pytest.mark.cuda
def test_cuda_hash_embed_at_the_md_tables_bit_equal():
    # spaCy md's tables (5000, 1000 and 2500 rows, D 96) on corpus-like ids
    # at a training microbatch (N 8192, a third of it padding) and at one
    # request (N 128): K1 fwd and its table gradient bit-equal
    dev, g = _card()
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids

    vocab = torch.randint(1, 2 ** 32, (2000, 2), device=dev, generator=g)
    zipf = 1.0 / torch.arange(1, 2001, device=dev, dtype=torch.float32)
    for N in (8192, 128):
        keys = vocab[torch.multinomial(zipf, N, replacement=True, generator=g)]
        keys[torch.randperm(N, device=dev, generator=g)[: N // 3]] = 0
        ct = torch.randn(N, 96, device=dev, generator=g)
        for rows, seed in ((5000, 21), (1000, 22), (2500, 23)):
            ids = hash_embed_ids(keys, seed, rows)
            table = torch.randn(rows, 96, device=dev, generator=g)
            assert torch.equal(hash_embed_gather_sum(table, ids),
                               hash_embed_gather_sum_plain(table, ids))
            got = hash_embed_table_grad(ct, ids, rows)
            assert torch.equal(got, hash_embed_table_grad(ct, ids, rows))
            assert torch.equal(got.cpu(), hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows))


@pytest.mark.cuda
def test_cuda_fused_update_over_the_md_leaves_without_the_frozen_tables(tmp_path):
    # the md layout at full size (two trunks over 20000 x 300 vectors): the
    # leaves the training loop hands K5 are every parameter but the two
    # frozen tables, and K5's plan covers them and nothing else, at 0 ulp
    import numpy as np

    import chip_smoke
    import spacy_ray_tpu_torch as P
    from spacy_ray_tpu_torch.models.core import param_paths
    from spacy_ray_tpu_torch.pipeline.vectors import Vectors
    from spacy_ray_tpu_torch.training.loop import _named_params

    dev, g = _card()
    words = [f"w{i}" for i in range(20000)]
    Vectors(words, np.random.default_rng(0).normal(size=(20000, 300)).astype(np.float32)
            ).to_disk(tmp_path / "vectors.npz")
    attr = [{"patterns": [[{"TAG": "NN"}]], "attrs": {"POS": "NOUN"}}]
    ents = [{"label": "ORG", "pattern": "Acme Corp"}]
    cfg = chip_smoke.md_config(("-", "-"), tmp_path / "vectors.npz", attr, ents).interpolate()
    nlp = P.Pipeline.from_config(cfg, device=dev)
    nlp.initialize(labels={"tagger": ["DT", "NN", "VBD"], "parser": ["ROOT", "nsubj", "obj"],
                           "ner": ["GPE", "ORG"]})
    nlp.model.requires_grad_(True)
    leaves = _named_params(nlp)
    frozen = [t for k, t in param_paths(nlp.model).items() if k.endswith("frozen_table")]
    assert len(frozen) == 2 and all(t.shape == (20000, 300) for t in frozen)
    assert len(leaves) == len(param_paths(nlp.model)) - 2
    params = [p.detach() for p in leaves.values()]
    for hyper in HYPERS[:3]:
        G = [torch.randn(p.shape, device=dev, generator=g) * 1e-3 for p in params]
        M = [torch.randn(p.shape, device=dev, generator=g) * 1e-4 for p in params]
        V = [torch.rand(p.shape, device=dev, generator=g) * 1e-6 for p in params]
        gn = global_norm(G)
        sc = step_scalars(hyper, 4, 4, lambda s: 0.001)
        want = [leaf_math_plain(p, gg, m, v, gn, *sc, hyper=hyper)
                for p, gg, m, v in zip(params, G, M, V)]
        fused = FusedUpdate(hyper)
        fused.step(params, G, M, V, gn, sc)
        for got, w in zip(zip(params, M, V), want):
            for a, b in zip(got, w):
                assert ulp_diff(torch, a, b) == 0, (hyper, a.shape)
        # the plan's chunks: every trainable element once, no frozen byte
        table = fused._table.cpu()
        assert int(table[:, 4].sum()) == sum(p.numel() for p in params)
        for t in frozen:
            lo, hi = t.data_ptr(), t.data_ptr() + t.numel() * 4
            assert not ((table[:, 0] >= lo) & (table[:, 0] < hi)).any()
    assert all(torch.equal(t.cpu(), torch.from_numpy(Vectors.from_disk(
        tmp_path / "vectors.npz").table)) for t in frozen)


@pytest.mark.cuda
def test_cuda_hash_embed_at_the_linker_tables_bit_equal():
    # the entity linker's own HashEmbedCNN (spaCy's nel_emerson trunk:
    # 2000 and 3 x 1000 rows, D 96) at a training microbatch and one request
    dev, g = _card()
    from spacy_ray_tpu_torch.ops.hashing import hash_embed_ids

    vocab = torch.randint(1, 2 ** 32, (2000, 2), device=dev, generator=g)
    zipf = 1.0 / torch.arange(1, 2001, device=dev, dtype=torch.float32)
    for N in (8192, 128):
        keys = vocab[torch.multinomial(zipf, N, replacement=True, generator=g)]
        keys[torch.randperm(N, device=dev, generator=g)[: N // 3]] = 0
        ct = torch.randn(N, 96, device=dev, generator=g)
        for rows, seed in ((2000, 31), (1000, 32), (1000, 33), (1000, 34)):
            ids = hash_embed_ids(keys, seed, rows)
            table = torch.randn(rows, 96, device=dev, generator=g)
            assert torch.equal(hash_embed_gather_sum(table, ids),
                               hash_embed_gather_sum_plain(table, ids))
            got = hash_embed_table_grad(ct, ids, rows)
            assert torch.equal(got, hash_embed_table_grad(ct, ids, rows))
            assert torch.equal(got.cpu(), hash_embed_table_grad_plain(ct.cpu(), ids.cpu(), rows))


def _nel_on_the_card(tmp_path, dev):
    """chip_smoke.nel_config at the linker's full width over a small md
    source (width 32, 200 x 24 vectors) saved from the card, with a one-alias
    KB; and one collated batch of linked mentions."""
    import numpy as np

    import chip_smoke
    import spacy_ray_tpu_torch as P
    from spacy_ray_tpu_torch.pipeline.kb import KnowledgeBase
    from spacy_ray_tpu_torch.pipeline.vectors import Vectors

    rng = np.random.default_rng(0)
    Vectors([f"w{i}" for i in range(200)], rng.normal(size=(200, 24)).astype(np.float32)
            ).to_disk(tmp_path / "vectors.npz")
    md = chip_smoke.md_config(("-", "-"), tmp_path / "vectors.npz",
                              [{"patterns": [[{"TAG": "NN"}]], "attrs": {"POS": "NOUN"}}],
                              [{"label": "ORG", "pattern": "Acme Corp"}], width=32, depth=2,
                              rows=(500, 100, 250, 250), hidden=32).interpolate()
    src = P.Pipeline.from_config(md, device=dev)
    src.initialize(labels={"tagger": ["DT", "NN", "VBD"], "parser": ["ROOT", "nsubj", "obj"],
                           "ner": ["GPE", "ORG"]})
    src.to_disk(tmp_path / "md")
    kb = KnowledgeBase(64)
    for k in range(5):
        kb.add_entity(f"Q{k}", 1.0, rng.normal(size=64))
    kb.add_alias("Acme Corp", [f"Q{k}" for k in range(5)], [0.3, 0.2, 0.2, 0.2, 0.1])
    kb.to_disk(tmp_path / "kb.npz")
    cfg = chip_smoke.nel_config(("-", "-"), tmp_path / "md", tmp_path / "kb.npz")
    nlp = P.Pipeline.from_config(cfg.interpolate(), device=dev)
    nlp.initialize(seed=0)
    egs = []
    for i in range(16):
        words = ["w1", "saw", "Acme", "Corp", "w2"][: 4 + i % 2]
        ent = P.Span(2, 4, "ORG", kb_id=f"Q{i % 5}")
        eg = P.Example.from_gold(P.Doc(words=words, ents=[ent]))
        eg.predicted.ents = [P.Span(2, 4, "ORG")]
        egs.append(eg)
    return nlp, nlp.collate(egs, with_targets=True)


@pytest.mark.cuda
def test_cuda_frozen_trunks_launch_no_table_gradient_and_k5_covers_them(tmp_path):
    # an entity linker added to a frozen md source: a microbatch's backward
    # launches K1 bwd for the linker's 4 tables and for no frozen trunk; K5
    # runs over every parameter (the frozen components' with zero
    # gradients) but the frozen tables at 0 ulp, and at L2 0 leaves the
    # frozen components bit-equal
    from spacy_ray_tpu_torch.models.core import param_paths
    from spacy_ray_tpu_torch.training.loop import _named_params

    dev, g = _card()
    nlp, batch = _nel_on_the_card(tmp_path, dev)
    nlp.requires_grad_(True)
    leaves = _named_params(nlp)
    _cuda.reset_launch_counts()
    loss, metrics = nlp.loss(batch["tokens"], batch["targets"], dropout=0.0)
    loss.backward()
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["hash_embed_table_grad"] == 4
    assert {"loss_ner", "loss_entity_linker"} <= set(metrics)
    frozen_keys = [k for k in leaves if not k.startswith("entity_linker/")]
    assert frozen_keys and all(leaves[k].grad is None for k in frozen_keys)
    params = [p.detach() for p in leaves.values()]
    before = {k: p.detach().clone() for k, p in leaves.items()}
    G = [(p.grad if p.grad is not None else torch.zeros_like(p)).detach()
         for p in leaves.values()]
    tables = [t for k, t in param_paths(nlp.model).items() if k.endswith("frozen_table")]
    # sm.cfg's Adam.v1 (no L2): the frozen leaves stay bit-equal; then an
    # L2 into the gradient (HYPERS[1]) moves them, as JAX's chain does
    for hyper, frozen_move in ((FusedHyper("adam", 0.9, 0.999, 1e-8, 1.0, 0.0, 0.0), False),
                               (HYPERS[1], True)):
        M = [torch.zeros_like(p) for p in params]
        V = [torch.zeros_like(p) for p in params]
        gn = global_norm(G)
        sc = step_scalars(hyper, 0, 0, lambda s: 0.001)
        want = [leaf_math_plain(p, gg, m, v, gn, *sc, hyper=hyper)
                for p, gg, m, v in zip(params, G, M, V)]
        fused = FusedUpdate(hyper)
        fused.step(params, G, M, V, gn, sc)
        for got, w in zip(zip(params, M, V), want):
            for a, b in zip(got, w):
                assert ulp_diff(torch, a, b) == 0, (hyper, a.shape)
        table = fused._table.cpu()
        assert int(table[:, 4].sum()) == sum(p.numel() for p in params)
        for t in tables:
            lo, hi = t.data_ptr(), t.data_ptr() + t.numel() * 4
            assert not ((table[:, 0] >= lo) & (table[:, 0] < hi)).any()
        moved = [not torch.equal(before[k], leaves[k].detach()) for k in frozen_keys]
        # an L2 moves every frozen leaf but those still all zero (fresh biases)
        assert moved == [frozen_move and bool(before[k].any()) for k in frozen_keys]
        assert any(moved) == frozen_move


PRETRAIN_CFG = """
[nlp]
lang = "en"
pipeline = ["tok2vec"]

[components.tok2vec]
factory = "tok2vec"

[components.tok2vec.model]
@architectures = "spacy.HashEmbedCNN.v2"
width = 64
depth = 2
embed_size = 300
window_size = 1
maxout_pieces = 2
subword_features = true
pretrained_vectors = null

[corpora.pretrain]
@readers = "spacy.JsonlCorpus.v1"
path = "{raw}"

[pretraining]
max_steps = 6
batch_size = 8

[pretraining.objective]
type = "characters"
n_characters = 3
hidden_size = 32
"""


@pytest.mark.cuda
def test_cuda_pretraining_runs_the_kernels_and_its_file_loads_bit_equal(tmp_path):
    import contextlib
    import itertools
    import json

    import numpy as np

    from chip_smoke import plain_kernels
    from spacy_ray_tpu_torch import Config, Pipeline
    from spacy_ray_tpu_torch.models.core import Context, param_paths
    from spacy_ray_tpu_torch.training.corpus import use_raw_text_tokenizer
    from spacy_ray_tpu_torch.training.pretrain import Pretraining, pretrain

    _card()
    texts = ["The quick brown fox jumps over the lazy dog.", "Naïve café — 日本 too!",
             "Hash embeddings use murmur keys for subword features."]
    with open(tmp_path / "raw.jsonl", "w", encoding="utf8") as f:
        for t in texts * 6:
            f.write(json.dumps({"text": t}) + "\n")
    cfg = Config.from_str(PRETRAIN_CFG.replace("{raw}", str(tmp_path / "raw.jsonl")))
    _cuda.reset_launch_counts()
    stats = pretrain(cfg, tmp_path / "out")
    launches = _cuda.launch_counts()
    assert stats["steps"] == 6 and np.isfinite(stats["loss"])
    assert launches["hash_embed_gather_sum"] == launches["hash_embed_table_grad"] == 6 * 4
    assert launches["fused_update"] == 6
    # one batch's gradients with the kernels against the plain versions
    run = Pretraining(cfg)
    with use_raw_text_tokenizer(run.nlp.tokenizer):
        egs = list(itertools.islice(run.corpus(), 8))
    tokens, targets, _ = run.batch(egs)
    params = run.params()
    for p in params.values():
        p.requires_grad_(True)
    grads = []
    for plain in (False, True):
        for p in params.values():
            p.grad = None
        with plain_kernels() if plain else contextlib.nullcontext():
            run.loss_fn(tokens, targets, Context(train=True))[0].backward()
        grads.append({k: p.grad.clone() for k, p in params.items()})
    for k in params:
        scale = grads[1][k].abs().max().item()
        assert (grads[0][k] - grads[1][k]).abs().max().item() <= 1e-4 * max(scale, 1e-30), k
    # [initialize] init_tok2vec on the card: the trunk is the file, bit for bit
    cfg["initialize"] = {"init_tok2vec": str(tmp_path / "out" / "model-last.npz")}
    nlp = Pipeline.from_config(cfg.interpolate())
    nlp.initialize(seed=3)
    with np.load(tmp_path / "out" / "model-last.npz") as saved:
        have = param_paths(nlp.model["tok2vec"])
        assert set(have) == set(saved.files)
        for k in saved.files:
            assert np.array_equal(have[k].cpu().numpy(), saved[k]), k


@pytest.mark.cuda
def test_cuda_init_weights_from_a_roberta_layout_file_bit_equal(tmp_path):
    import numpy as np

    from chip_smoke import write_roberta_checkpoint
    from spacy_ray_tpu_torch import Config, Pipeline
    from spacy_ray_tpu_torch.models.core import param_paths
    from spacy_ray_tpu_torch.models.pretrained import hf_encoder_to_native
    from spacy_ray_tpu_torch.pipeline.doc import Doc, Example

    _card()
    hf = write_roberta_checkpoint(tmp_path / "r.safetensors", layers=2, width=64, ffn=256,
                                  pos_rows=130)
    want = hf_encoder_to_native(hf, native_pos_rows=128)
    cfg = Config.from_str(f"""
[nlp]
pipeline = ["transformer"]

[components.transformer]
factory = "transformer"

[components.transformer.model]
@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 64
depth = 2
n_heads = 4
max_len = 128
embed_size = 500
init_weights = "{tmp_path / 'r.safetensors'}"
""")
    nlp = Pipeline.from_config(cfg.interpolate())
    nlp.initialize(seed=0)
    have = param_paths(nlp.model["transformer"])
    assert len(want) == 2 * 12 + 1
    for k, v in want.items():
        assert np.array_equal(have[k].cpu().numpy(), v), k
    _cuda.reset_launch_counts()
    tokens = nlp.collate([Example.from_gold(Doc(words=w))
                          for w in (["a", "b", "c"], ["d"] * 40)])["tokens"]
    with torch.inference_mode():
        out = nlp.forward(tokens)["transformer"].X
    assert torch.isfinite(out).all() and _cuda.launch_counts()["flash_attention_fwd"] == 2
