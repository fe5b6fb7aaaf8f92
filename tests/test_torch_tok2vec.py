"""The port's CNN trunk against the JAX package, on the CPU: ``seq2col``,
the ``HashEmbed`` tables of configs/cnn.cfg, ``HashEmbedCNN``, the cnn.cfg
and sm.cfg pipelines (parameter paths, model directories both ways), the
architecture registrations, dropout and the native murmur.

Tolerances: ``seq2col`` and the murmur keys exact (copies and integer
hashes); HashEmbed within 1e-6 (the same four f32 rows summed; JAX's plain
reference sums with ``jnp.sum``, the Pallas kernel in the kernel's order);
the trunk within 1e-5 max abs (f32 matmuls in another summation order);
decoded tags, heads, deps and entities identical.
"""

import random
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu import udgen as judgen
from spacy_ray_tpu.models import core as jcore
from spacy_ray_tpu.models import layers as jlayers
from spacy_ray_tpu.models import tok2vec as jt2v
from spacy_ray_tpu.ops import ops as jops
from spacy_ray_tpu.ops.pallas_kernels import TOKEN_BLOCK, _pallas_lookup_raw, _reference_lookup
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.types import TokenBatch as JTokenBatch

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models import tok2vec as pt2v
from spacy_ray_tpu_torch.models.core import Context, param_paths
from spacy_ray_tpu_torch.models.layers import Dropout
from spacy_ray_tpu_torch.native import hash_strings_u64
from spacy_ray_tpu_torch.ops import ops as pops
from spacy_ray_tpu_torch.ops.hashing import hash_string_u64
from spacy_ray_tpu_torch.registry import registry
from spacy_ray_tpu_torch.types import Padded

REPO = Path(__file__).resolve().parent.parent
TEXTS = [
    "The cat sat on the mat .",
    "Hello world",
    "Paris and London are cities , said Mr Smith of the U.S. in 1984 .",
    "She said (quietly) that it's fine!",
    "A much longer sentence , with commas , 3.5 numbers and well-known hyphens "
    "plus don't contractions that run past sixteen tokens .",
]


def _ragged(seed, B=4, T=11, D=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = [T, 1, 0, 6][:B]
    mask = np.arange(T)[None, :] < np.array(lengths)[:, None]
    return X, mask


@pytest.mark.parametrize("window", [1, 2])
def test_seq2col_equals_jax_with_ragged_masks(window):
    X, mask = _ragged(window)
    want = np.asarray(jops.seq2col(jnp.asarray(X), window, jnp.asarray(mask)))
    got = pops.seq2col(torch.from_numpy(X), window, torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 11, 5 * (2 * window + 1))
    assert np.array_equal(got, want)
    # [T, D] input, and no mask: zeros past the edges only
    assert np.array_equal(pops.seq2col(torch.from_numpy(X[0]), window).numpy(),
                          np.asarray(jops.seq2col(jnp.asarray(X[0]), window)))
    # a real token next to padding reads zeros there, not the padding's values
    row = got[1, 0].reshape(2 * window + 1, 5)
    assert np.all(row[window + 1:] == 0) and np.array_equal(row[window], X[1, 0])


def test_mish_equals_jax_including_its_saturated_ends():
    x = np.concatenate([np.linspace(-30, 30, 601), [-100.0, -20.0, 20.0, 88.0, 100.0, 0.0]])
    x = x.astype(np.float32)
    want = np.asarray(jops.mish(jnp.asarray(x)))
    got = pops.mish(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    # 1e-6 absolute, and relative where |x| > 1: tanh rounds to one ulp of 1
    # apart near saturation in the two libraries, one ulp of x in the product
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got[x >= 20], x[x >= 20]) and np.abs(got[x <= -20]).max() < 1e-7


def _jax_params(model, seed=0):
    import jax

    return jcore.prune_empty(model.init(jax.random.PRNGKey(seed)))


def _load(pmodel, jparams):
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    have = param_paths(pmodel)
    assert set(have) == set(flat)
    with torch.no_grad():
        for k, t in have.items():
            t.copy_(torch.from_numpy(np.array(flat[k])))


def _tokens(texts, T=None):
    nlp = P.Pipeline.from_config(P.Config.from_str('[nlp]\npipeline = []\n'), device="cpu")
    nlp.initialize()
    batch = nlp.collate([P.Example.from_gold(nlp.tokenizer(t)) for t in texts], pad_len_to=T)
    tok = batch["tokens"]
    jtok = JTokenBatch(attr_keys=jnp.asarray(tok.attr_keys.numpy().astype(np.uint32)),
                        mask=jnp.asarray(tok.mask.numpy()))
    return tok, jtok


def _interpreted_k1(table, ids):
    """The JAX layer's lookup through the Pallas kernel in interpret mode
    (ids padded to a TOKEN_BLOCK multiple)."""
    lead = ids.shape[:-1]
    flat = ids.reshape(-1, 4).astype(jnp.int32)
    n = flat.shape[0]
    pad = (-n) % TOKEN_BLOCK
    out = _pallas_lookup_raw(table, jnp.pad(flat, ((0, pad), (0, 0))), interpret=True)[:n]
    return out.reshape(*lead, table.shape[1])


def _reference_k1(table, ids):
    lead = ids.shape[:-1]
    return _reference_lookup(table, ids.reshape(-1, 4)).reshape(*lead, table.shape[1])


@pytest.mark.parametrize("k1", ["interpret", "reference"])
def test_hash_embed_at_cnn_cfg_tables_equals_jax_k1(k1):
    tok, jtok = _tokens(TEXTS)
    impl = _interpreted_k1 if k1 == "interpret" else _reference_k1
    for i, (attr, rows) in enumerate(zip(pt2v.ATTRS, (2000, 1000, 1000, 1000))):
        seed = hash_string_u64(f"hashembed-{attr}-{i}") & 0x7FFFFFFF
        jlayer = jlayers.HashEmbed(96, rows, seed=seed, attr_index=i)
        jparams = _jax_params(jlayer, seed=i)
        with mock.patch.object(jlayers, "hash_embed_lookup", impl):
            want = np.asarray(jlayer.apply(jparams, jtok).X)
        player = pt2v.HashEmbed(96, rows, seed=seed, attr_index=i)
        _load(player, jparams)
        got = player(tok).X.numpy()
        assert got.shape == want.shape == (8, 32, 96)  # B and T padded to buckets
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k1", ["interpret", "reference"])
def test_hash_embed_cnn_forward_equals_jax(k1):
    # cnn.cfg's widths (96, embed_size 2000) at depth 2, window 1, 3 pieces
    jmodel = jt2v.HashEmbedCNN(width=96, depth=2, embed_size=2000)
    pmodel = registry.get("architectures", "spacy.HashEmbedCNN.v2")(
        width=96, depth=2, embed_size=2000)
    jparams = _jax_params(jmodel, seed=3)
    _load(pmodel, jparams)
    tok, jtok = _tokens(TEXTS)
    impl = _interpreted_k1 if k1 == "interpret" else _reference_k1
    with mock.patch.object(jlayers, "hash_embed_lookup", impl):
        want = jmodel.apply(jparams, jtok)
    with torch.inference_mode():
        got = pmodel(tok, None, Context())
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    err = np.abs(got.X.numpy() - np.asarray(want.X)).max()
    assert err <= 1e-5, err


def test_architectures_register_the_jax_names_and_paths():
    for name in ("spacy.MultiHashEmbed.v1", "spacy.MultiHashEmbed.v2",
                 "spacy.MaxoutWindowEncoder.v1", "spacy.MaxoutWindowEncoder.v2",
                 "spacy.Tok2Vec.v1", "spacy.Tok2Vec.v2", "spacy.HashEmbedCNN.v1",
                 "spacy.HashEmbedCNN.v2", "spacy.TorchBiLSTMEncoder.v1"):
        registry.get("architectures", name)
    with pytest.raises(NotImplementedError):
        registry.get("architectures", "spacy.TorchBiLSTMEncoder.v1")(width=96)
    # static vectors: the active vectors' table, frozen, at the JAX paths;
    # with no vectors loaded both packages raise alike
    for m in (jt2v, pt2v):
        with pytest.raises(ValueError, match="no vectors are loaded"):
            m.HashEmbedCNN(96, 2, 2000, pretrained_vectors="x.npz")
        with pytest.raises(ValueError, match="no vectors are loaded"):
            m.MultiHashEmbed(96, include_static_vectors=True)
    table = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    words = ["a", "b", "c", "d", "e", "f", "g"]
    from spacy_ray_tpu.pipeline import vectors as jvec
    from spacy_ray_tpu_torch.pipeline import vectors as pvec

    with jvec.use_vectors(jvec.Vectors(words, table)), pvec.use_vectors(pvec.Vectors(words, table)):
        for build in (lambda m: m.HashEmbedCNN(96, 2, 2000, pretrained_vectors="x.npz"),
                      lambda m: m.MultiHashEmbedV1(32, rows=500, also_use_static_vectors=True)):
            jmodel, pmodel = build(jt2v), build(pt2v)
            jflat = {k: tuple(np.shape(v)) for k, v in _flatten(_jax_params(jmodel)).items()}
            pflat = {k: tuple(v.shape) for k, v in param_paths(pmodel).items()}
            assert pflat == jflat
            frozen = [k for k in pflat if k.endswith("4_static_vectors/frozen_table")]
            assert len(frozen) == 1 and pflat[frozen[0]] == (7, 5)
            assert frozen[0] not in {k.replace(".", "/") for k, _ in pmodel.named_parameters()}
    cases = [
        (lambda m: m.HashEmbedCNN(width=96, depth=2, embed_size=2000, dropout=0.2), 3),
        (lambda m: m.HashEmbedCNN(width=32, depth=1, embed_size=300, window_size=2,
                                  maxout_pieces=2, subword_features=False), 1),
        (lambda m: m.Tok2Vec(m.MultiHashEmbedV1(width=32, rows=500),
                             m.MaxoutWindowEncoder(width=32, depth=3)), 1),
        (lambda m: m.Tok2Vec(m.MultiHashEmbedV1(width=32, rows=500, also_embed_subwords=False),
                             m.MaxoutWindowEncoder(width=32, window_size=2, depth=1)), 1),
    ]
    for build, n_inputs in cases:
        jmodel, pmodel = build(jt2v), build(pt2v)
        jflat = {k: tuple(np.shape(v)) for k, v in _flatten(_jax_params(jmodel)).items()}
        pflat = {k: tuple(v.shape) for k, v in param_paths(pmodel).items()}
        assert pflat == jflat
        assert isinstance(pmodel, pt2v.Tok2VecModel)
    # the Dropout shifts the encoder's chain index from 1_ to 2_, as in JAX
    with_drop = param_paths(pt2v.HashEmbedCNN(width=96, depth=1, embed_size=2000, dropout=0.2))
    assert "2_maxout_window_encoder/0_res_0/inner/1_maxout/W" in with_drop
    plain = param_paths(pt2v.HashEmbedCNN(width=96, depth=4, embed_size=2000))
    assert tuple(plain["0_multi_hash_embed/0_embeds/1_embed_prefix/E"].shape) == (1000, 96)
    assert tuple(plain["0_multi_hash_embed/1_mix/b"].shape) == (96, 3)
    assert tuple(plain["1_maxout_window_encoder/0_res_0/inner/1_maxout/W"].shape) == (288, 288)
    assert len(plain) == 24 and sum(t.numel() for t in plain.values()) == 924768


def test_dropout_site_and_trunk_contexts():
    x = Padded(X=torch.ones(2, 50, 8), mask=torch.ones(2, 50, dtype=torch.bool))
    layer = Dropout(0.5)
    assert layer(x, Context()) is x  # predicting: identity
    assert layer(x, Context(train=True)) is x  # no seed: no dropout
    assert layer(x, Context(train=True, dropout=0.0, seed=1)) is x  # [training] dropout 0
    a = layer(x, Context(train=True, seed=1)).X
    assert torch.equal(a, layer(x, Context(train=True, seed=1)).X)
    kept = a != 0
    assert torch.all(a[kept] == 2.0) and 0.35 < kept.float().mean() < 0.65
    b = layer(x, Context(train=True, dropout=0.1, seed=1)).X  # the override's rate
    assert torch.all(b[b != 0] == torch.tensor(1.0) / 0.9) and (b != 0).float().mean() > 0.8
    # a HashEmbedCNN with a dropout: trained twice with one seed, the same
    # output; predicting, the same as without the dropout
    t2v = pt2v.HashEmbedCNN(width=16, depth=1, embed_size=100, dropout=0.3)
    t2v.init_parameters(torch.Generator().manual_seed(0))
    tok, _ = _tokens(TEXTS[:2])
    ctx = Context(train=True, seed=5)
    assert torch.equal(t2v(tok, None, ctx).X, t2v(tok, None, ctx).X)
    assert not torch.equal(t2v(tok, None, ctx).X, t2v(tok, None, Context()).X)
    with pytest.raises(ValueError, match="transformer trunk"):
        t2v(tok, {"layer_0": {}}, Context())


def _jax_pipeline(name, tmp_path, seed=0):
    cfg = J.Config.from_disk(REPO / "configs" / f"{name}.cfg")
    cfg["paths"] = {"train": "-", "dev": "-"}
    nlp = J.Pipeline.from_config(cfg.interpolate())
    egs = judgen.synth_ud_corpus(40, seed=seed, max_sents=2)
    nlp.initialize(lambda: egs, seed=seed)
    nlp.to_disk(tmp_path)
    return nlp


def _annotations(doc):
    return (doc.tags, doc.heads, doc.deps, [(e.start, e.end, e.label) for e in doc.ents])


@pytest.mark.parametrize("name", ["cnn", "sm"])
def test_cnn_pipelines_load_both_ways_and_annotate_identically(name, tmp_path):
    jnlp = _jax_pipeline(name, tmp_path / "jax")
    pnlp = P.Pipeline.from_disk(tmp_path / "jax", device="cpu")
    jflat = {k: tuple(np.shape(v)) for k, v in _flatten(jnlp.params).items()}
    pflat = {k: tuple(v.shape) for k, v in param_paths(pnlp.model).items()}
    assert pflat == jflat and len(pflat) == {"cnn": 26, "sm": 34}[name]
    texts = TEXTS + [" ".join(d.words) for d in
                     (eg.reference for eg in judgen.synth_ud_corpus(8, seed=9, max_sents=2))]
    for t in texts:
        assert _annotations(pnlp(t)) == _annotations(jnlp(t)), t
    # and back: a port model directory (other weights) in the JAX package
    cfg = P.Config.from_disk(REPO / "configs" / f"{name}.cfg")
    cfg["paths"] = {"train": "-", "dev": "-"}
    port = P.Pipeline.from_config(cfg.interpolate(), device="cpu")
    port.initialize(labels={n: pnlp.components[n].labels for n in pnlp.head_names()}, seed=7)
    port.to_disk(tmp_path / "port")
    back = J.Pipeline.from_disk(tmp_path / "port")
    for t in texts:
        assert _annotations(back(t)) == _annotations(port(t)), t


def test_native_murmur_is_bit_equal_to_hash_string_u64():
    rng = random.Random(0)
    alphabet = ([chr(c) for c in range(32, 127)] + list("éüßçñøæ€—“”…") + list("日本語中文한국어")
                + ["\U0001F600", "\U0001F4A9", "́", "\x00"])
    strings = ["", "a", "norm=the", "x" * 16, "y" * 17, "z" * 300]
    strings += ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
                for _ in range(12000)]
    keys = hash_strings_u64(strings)
    assert keys.dtype == np.uint64 and keys.shape == (len(strings),)
    assert [int(k) for k in keys] == [hash_string_u64(s) for s in strings]
    assert int(hash_strings_u64(["coffee"], seed=7)[0]) == hash_string_u64("coffee", seed=7)
