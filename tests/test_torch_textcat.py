"""The port's text classifiers on the CPU against the JAX package: the
hashed bag-of-words scores (unigrams and bigrams over keys that overflow
uint32), and for spaCy's default ``textcat`` (``TextCatEnsemble.v2`` with an
inline ``HashEmbedCNN.v2`` and a ``TextCatBOW.v3`` whose ``nO = null``), a BOW
alone, ``TextCatCNN.v2`` and an exclusive ``TextCatReduce.v1`` with every
pool: the targets, one batch's loss and every leaf's gradient with carried
weights, the cats decoded from either package's model directory by the
other, and the ensemble's refusal of a listener.

Tolerances: the loss (float32) within 1e-5 relative; each leaf's gradient
within 1e-4 of its max |g|, computed in float64 by both packages, dropout
off; BOW scores within 1e-6; cats within 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.types import TokenBatch as JTokenBatch
from spacy_ray_tpu.util import synth_corpus as j_synth_corpus

import torch

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.types import TokenBatch as PTokenBatch
from spacy_ray_tpu_torch.util import synth_corpus as p_synth_corpus

from test_torch_cnn_train import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    _assert_grads_close, _port_loss_and_grads, one_torch_thread,
)

REPO = Path(__file__).resolve().parent.parent

TRUNK = """
@architectures = "spacy.HashEmbedCNN.v2"
width = 32
depth = 1
embed_size = 256
"""
LISTENER = """
@architectures = "spacy.Tok2VecListener.v1"
width = 32
"""

#: each case: (factory, pipeline has a tok2vec component, model block)
CASES = {
    # spaCy's default textcat: the ensemble, its BOW's nO left to inference
    "ensemble": ("textcat", False, f"""
[components.textcat.model]
@architectures = "spacy.TextCatEnsemble.v2"
nO = null

[components.textcat.model.tok2vec]
{TRUNK}
[components.textcat.model.linear_model]
@architectures = "spacy.TextCatBOW.v3"
exclusive_classes = true
ngram_size = 1
no_output_layer = false
length = 262144
nO = null
"""),
    "bow_bigrams": ("textcat_multilabel", False, """
[components.textcat.model]
@architectures = "spacy.TextCatBOW.v2"
exclusive_classes = false
ngram_size = 2
length = 4096
"""),
    "cnn": ("textcat_multilabel", True, f"""
[components.textcat.model]
@architectures = "spacy.TextCatCNN.v2"
exclusive_classes = false

[components.textcat.model.tok2vec]
{LISTENER}"""),
    "reduce_all_pools": ("textcat", True, f"""
[components.textcat.model]
@architectures = "spacy.TextCatReduce.v1"
exclusive_classes = true
use_reduce_first = true
use_reduce_last = true
use_reduce_max = true
use_reduce_mean = true

[components.textcat.model.tok2vec]
{LISTENER}"""),
}

LEAVES = {"ensemble": 16, "bow_bigrams": 2, "cnn": 14, "reduce_all_pools": 14}


def case_config(pkg, case):
    factory, shared, model = CASES[case]
    pipeline = '["tok2vec", "textcat"]' if shared else '["textcat"]'
    trunk = f"[components.tok2vec]\nfactory = \"tok2vec\"\n\n[components.tok2vec.model]\n{TRUNK}"
    text = (f"[nlp]\nlang = \"en\"\npipeline = {pipeline}\n\n"
            + (trunk if shared else "")
            + f"\n[components.textcat]\nfactory = \"{factory}\"\n" + model)
    return pkg.Config.from_str(text)


def _randomize_zero_leaves(params, seed):
    """The BOW table and the biases start at zero: give every all-zero leaf
    random values so that they take part in the comparison."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        return jnp.asarray(rng.normal(scale=0.3, size=a.shape).astype(np.float32)
                           if not a.any() else a)

    return jax.tree_util.tree_map(fill, params)


@pytest.fixture(scope="module")
def examples():
    return j_synth_corpus(60, "textcat", seed=0), p_synth_corpus(60, "textcat", seed=0)


@pytest.fixture(scope="module", params=list(CASES))
def carried(request, examples, tmp_path_factory):
    """The case's pipeline initialized by JAX (every zero leaf randomized),
    loaded by the port from its model directory."""
    jegs, pegs = examples
    jnlp = J.Pipeline.from_config(case_config(J, request.param).interpolate())
    jnlp.initialize(lambda: jegs, seed=0)
    jnlp.params = _randomize_zero_leaves(jnlp.params, 1)
    model_dir = tmp_path_factory.mktemp(f"textcat_{request.param}")
    jnlp.to_disk(model_dir)
    return request.param, jnlp, P.Pipeline.from_disk(model_dir, device="cpu"), model_dir


def test_param_paths_shapes_and_targets_match_jax(carried, examples):
    case, jnlp, pnlp, _ = carried
    jshapes = {k: tuple(v.shape) for k, v in _flatten(jnlp.params).items()}
    pshapes = {k.replace(".", "/"): tuple(v.shape) for k, v in pnlp.model.state_dict().items()}
    assert jshapes == pshapes and len(pshapes) == LEAVES[case]
    if case == "ensemble":
        assert pshapes["textcat/linear/W"] == (262144, 3)
        assert {"textcat/neural/W", "textcat/neural/b", "textcat/linear/b"} <= set(pshapes)
        assert any(k.startswith("textcat/neural/tok2vec/") for k in pshapes)
    if case == "reduce_all_pools":
        assert pshapes["textcat/W"] == (4 * 32, 3)
    jb = jnlp.collate(examples[0][:12])
    pb = pnlp.collate(examples[1][:12], with_targets=True)
    for key, v in jb["targets"]["textcat"].items():
        assert np.array_equal(np.asarray(v), pb["targets"]["textcat"][key].numpy()), key


def test_loss_and_gradients_of_one_batch_match_jax(carried, examples):
    case, jnlp, pnlp, _ = carried
    jb = jnlp.collate(examples[0][:12])
    pb = pnlp.collate(examples[1][:12], with_targets=True)
    loss_fn = jnlp.make_loss_fn(dropout=0.0)
    jloss = float(jax.jit(loss_fn)(jnlp.params, jb["tokens"], jb["targets"],
                                   jax.random.PRNGKey(0))[0])
    ploss = float(_port_loss_and_grads(pnlp, pb)[0])
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss)
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype=jnp.float64),
                                          jnlp.params)
        jgrads = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], jb["targets"],
                                                    jax.random.PRNGKey(0))[0]))(params64)
        jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    pnlp.model.double()
    try:
        _assert_grads_close(_port_loss_and_grads(pnlp, pb)[2], jflat, LEAVES[case], np.float64)
    finally:
        pnlp.model.float()


def _cats(nlp, egs):
    docs = [type(eg.reference)(words=list(eg.reference.words)) for eg in egs]
    nlp.predict_docs(docs)
    return [d.cats for d in docs]


def test_cats_of_a_model_dir_match_jax_both_ways(carried, examples, tmp_path):
    case, jnlp, pnlp, model_dir = carried
    jegs, pegs = examples
    # written by JAX, read by the port
    jcats, pcats = _cats(jnlp, jegs), _cats(pnlp, pegs)
    assert all(list(p) == list(j) == ["FOOD", "SPORTS", "TECH"] for p, j in zip(pcats, jcats))
    np.testing.assert_allclose([list(c.values()) for c in pcats],
                               [list(c.values()) for c in jcats], rtol=0, atol=1e-5)
    if CASES[case][0] == "textcat":  # softmax: each doc's cats sum to 1
        np.testing.assert_allclose([sum(c.values()) for c in pcats], 1.0, atol=1e-6)
    # written by the port (its own initialize), read by JAX
    fresh = P.Pipeline.from_config(case_config(P, case), device="cpu")
    fresh.initialize(lambda: pegs, seed=3)
    with torch.no_grad():
        for p in fresh.model.parameters():
            if not p.any():
                p.normal_(0.0, 0.3)
    fresh.to_disk(tmp_path / "port")
    back = J.Pipeline.from_disk(tmp_path / "port")
    np.testing.assert_allclose([list(c.values()) for c in _cats(fresh, pegs)],
                               [list(c.values()) for c in _cats(back, jegs)], rtol=0, atol=1e-5)


@pytest.mark.parametrize("ngram_size", [1, 2, 3])
def test_bow_scores_match_jax_on_keys_that_overflow_uint32(ngram_size):
    rng = np.random.default_rng(ngram_size)
    B, T, length, nO = 4, 9, 1000, 3
    keys = rng.integers(0, 2 ** 32, size=(B, T, 4, 2), dtype=np.uint64)
    keys[0, :, 0] = 2 ** 32 - 1 - rng.integers(0, 5, size=(T, 2))  # every product wraps
    mask = np.ones((B, T), bool)
    mask[1, 6:] = False
    mask[2, 1:] = False  # one token: no bigram at all
    mask[3, 4] = False   # a hole: the n-grams over it are dropped
    W = rng.normal(size=(length, nO)).astype(np.float32)
    b = rng.normal(size=nO).astype(np.float32)
    jmodel = J.registry.get("architectures", "spacy.TextCatBOW.v3")(
        ngram_size=ngram_size, nO=nO, length=length)
    jout = jmodel.apply({"W": jnp.asarray(W), "b": jnp.asarray(b)},
                        JTokenBatch(attr_keys=jnp.asarray(keys.astype(np.uint32)),
                                    mask=jnp.asarray(mask)))
    pmodel = P.registry.get("architectures", "spacy.TextCatBOW.v3")(
        ngram_size=ngram_size, nO=nO, length=length)
    with torch.no_grad():
        pmodel.W.copy_(torch.from_numpy(W))
        pmodel.b.copy_(torch.from_numpy(b))
    pout = pmodel(PTokenBatch(attr_keys=torch.from_numpy(keys.astype(np.int64)),
                              mask=torch.from_numpy(mask)))
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-6)
    # the rows in uint32 numpy arithmetic, for the wrapped products
    from spacy_ray_tpu_torch.models.heads import bow_ngram_rows

    lo, hi = keys[..., 0, 0].astype(np.uint32), keys[..., 0, 1].astype(np.uint32)
    with np.errstate(over="ignore"):
        want = lo ^ (hi >> np.uint32(1))
        for k, (rows, _) in enumerate(bow_ngram_rows(torch.from_numpy(keys.astype(np.int64)),
                                                     torch.from_numpy(mask), ngram_size,
                                                     length)):
            if k:
                want = want * np.uint32(2654435761) + np.roll(lo, -k, axis=1)
            np.testing.assert_array_equal(rows.numpy(), want % np.uint32(length))


def test_ensemble_refuses_a_listener_as_jax_does():
    cfg = {"@architectures": "spacy.TextCatEnsemble.v2",
           "tok2vec": {"@architectures": "spacy.Tok2VecListener.v1", "width": 32},
           "linear_model": {"@architectures": "spacy.TextCatBOW.v3"}}
    with pytest.raises(ValueError) as jerr:
        J.registry.resolve(dict(cfg))
    with pytest.raises(ValueError) as perr:
        P.registry.resolve(dict(cfg))
    assert str(perr.value) == str(jerr.value)
    assert "INLINE tok2vec" in str(perr.value)


def test_ensemble_inherits_nO_and_checks_a_given_one():
    trunk = P.Config.from_str(f"[t]\n{TRUNK}")["t"]
    model = P.registry.resolve({"@architectures": "spacy.TextCatEnsemble.v2", "nO": 5,
                                "tok2vec": dict(trunk),
                                "linear_model": {"@architectures": "spacy.TextCatBOW.v3",
                                                 "length": 64}})
    assert model.linear.W.shape == (64, 5) and model.neural.W.shape == (64, 5)
    with pytest.raises(ValueError, match="linear_model nO=4 != 5"):
        P.registry.resolve({"@architectures": "spacy.TextCatEnsemble.v2", "nO": 5,
                            "tok2vec": dict(trunk),
                            "linear_model": {"@architectures": "spacy.TextCatBOW.v3",
                                             "nO": 4, "length": 64}})
