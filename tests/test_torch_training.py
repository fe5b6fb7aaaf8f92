"""The port's training step against the JAX package's, on the CPU, at a small
size (width 64, depth 2, 4 heads, embed_size 500), with carried weights.

The JAX package builds and initializes the model and saves it; the port
loads the same directory. Inputs are the same docs; dropout is off where the
two are compared (their dropout bits come from different generators).

Tolerances and why:
* one batch: loss within 1e-5 relative, each gradient leaf within 1e-4 of
  its max |g| (the same f32 math in other summation orders);
* five Adam steps: per-step losses within 1e-4 relative; parameters within
  10 * lr at worst and 99.9 % of elements within 1e-5. Adam's normalised
  update turns f32 noise in a near-zero gradient into a step of +-lr, so a
  few elements may move a whole step apart while the rest agree closely;
* targets, batches and shuffle order identical.
"""

import numpy as np
import pytest
import torch

import jax
import optax
import spacy_ray_tpu as J
from spacy_ray_tpu.training import batcher as jbatcher
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training import optimizers as jopt
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.util import write_synth_jsonl as j_write_synth

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models.core import Context
from spacy_ray_tpu_torch.ops.ops import dropout
from spacy_ray_tpu_torch.training import batcher as pbatcher
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin

TRF_TAGGER_CFG = """
[nlp]
lang = "en"
pipeline = ["transformer", "tagger"]

[components]

[components.transformer]
factory = "transformer"

[components.transformer.model]
@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 64
depth = 2
n_heads = 4
ffn_mult = 4
dropout = 0.1
max_len = 512
embed_size = 500
remat = true

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 64
"""


@pytest.fixture(scope="module")
def corpus_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "train.jsonl"
    j_write_synth(path, 60, kind="tagger", seed=0)
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory, corpus_path):
    """(JAX pipeline, port pipeline) with the same weights and labels."""
    jnlp = J.Pipeline.from_config(J.Config.from_str(TRF_TAGGER_CFG).interpolate())
    egs = list(jcorpus.Corpus(corpus_path)())
    jnlp.initialize(lambda: egs, seed=0)
    path = tmp_path_factory.mktemp("jax_model")
    jnlp.to_disk(path)
    pnlp = P.Pipeline.from_disk(path, device="cpu")
    return jnlp, pnlp


@pytest.fixture(scope="module")
def jax_value_and_grad(models):
    """The JAX loss and gradients, jitted once for the module's batches."""
    return jax.jit(jax.value_and_grad(models[0].make_loss_fn(dropout=0.0), has_aux=True))


def _batches(path, n, size):
    jeg = list(jcorpus.Corpus(path)())[:n]
    peg = list(pcorpus.Corpus(path)())[:n]
    return [jeg[i:i + size] for i in range(0, n, size)], [peg[i:i + size] for i in range(0, n, size)]


def _port_loss_and_grads(pnlp, batch):
    pnlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in pnlp.model.named_parameters()}
    for p in params.values():
        p.grad = None
    loss, metrics = pnlp.loss(batch["tokens"], batch["targets"], dropout=0.0)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in params.items()}
    pnlp.model.requires_grad_(False)
    return float(loss.detach()), metrics, grads


def test_collated_targets_identical(models, corpus_path):
    jnlp, pnlp = models
    jb_all, pb_all = _batches(corpus_path, 12, 6)
    for jeg, peg in zip(jb_all, pb_all):
        jb = jnlp.collate(jeg)
        pb = pnlp.collate(peg, with_targets=True)
        for key in ("tags", "tag_mask"):
            assert np.array_equal(np.asarray(jb["targets"]["tagger"][key]),
                                  pb["targets"]["tagger"][key].numpy())
        assert np.array_equal(np.asarray(jb["tokens"].attr_keys).astype(np.int64),
                              pb["tokens"].attr_keys.numpy())


def test_loss_and_gradients_of_one_batch_match_jax(models, corpus_path, jax_value_and_grad):
    jnlp, pnlp = models
    jeg, peg = (b[0] for b in _batches(corpus_path, 8, 8))
    jb = jnlp.collate(jeg)
    pb = pnlp.collate(peg, with_targets=True)
    (jloss, jmetrics), jgrads = jax_value_and_grad(
        jnlp.params, jb["tokens"], jb["targets"], jax.random.PRNGKey(0))
    ploss, pmetrics, pgrads = _port_loss_and_grads(pnlp, pb)
    assert abs(ploss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(pmetrics) == set(jmetrics) == {"loss_tagger", "tagger_tag_acc_batch"}
    np.testing.assert_allclose(float(pmetrics["tagger_tag_acc_batch"]),
                               float(jmetrics["tagger_tag_acc_batch"]), atol=1e-6)
    jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    assert set(jflat) == set(pgrads)
    for k, g in jflat.items():
        np.testing.assert_allclose(pgrads[k], g, rtol=0, atol=1e-4 * max(np.abs(g).max(), 1e-30),
                                   err_msg=k)


def test_five_adam_steps_match_jax(models, corpus_path, jax_value_and_grad):
    jnlp, pnlp = models
    lr = 0.001
    jb_all, pb_all = _batches(corpus_path, 40, 8)
    jtx = jopt.Adam(learn_rate=lr, grad_clip=1.0).tx
    vg = jax_value_and_grad
    jupdate = jax.jit(jtx.update)
    jparams = jnlp.params
    jstate = jtx.init(jparams)
    pnlp2 = P.Pipeline.from_config(P.Config.from_str(TRF_TAGGER_CFG).interpolate(), device="cpu")
    pnlp2.initialize(labels={"tagger": jnlp.components["tagger"].labels})
    pnlp2.load_params({k: np.asarray(v) for k, v in _flatten(jparams).items()})
    pnlp2.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in pnlp2.model.named_parameters()}
    opt = popt.Adam(learn_rate=lr, grad_clip=1.0)
    state = opt.init(params)
    for jeg, peg in zip(jb_all, pb_all):
        jb = jnlp.collate(jeg)
        (jloss, _), jgrads = vg(jparams, jb["tokens"], jb["targets"], jax.random.PRNGKey(0))
        upd, jstate = jupdate(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        pb = pnlp2.collate(peg, with_targets=True)
        for p in params.values():
            p.grad = None
        loss, _ = pnlp2.loss(pb["tokens"], pb["targets"], dropout=0.0)
        loss.backward()
        with torch.no_grad():
            opt.update(params, {k: p.grad for k, p in params.items()}, state)
        assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    diffs = np.concatenate([
        np.abs(params[k].detach().numpy() - np.asarray(v)).ravel()
        for k, v in _flatten(jparams).items()])
    assert diffs.max() <= 10 * lr
    assert np.mean(diffs <= 1e-5) >= 0.999


def test_batch_by_words_and_shuffle_order_identical(corpus_path):
    jc = jcorpus.Corpus(corpus_path, shuffle=True, seed=3)
    pc = pcorpus.Corpus(corpus_path, shuffle=True, seed=3)
    jb = jbatcher.batch_by_words(size=120, tolerance=0.2)
    pb = pbatcher.batch_by_words(size=120, tolerance=0.2)
    for _ in range(2):  # two epochs: the shuffle is seeded per epoch
        jbs = [[eg.reference.words for eg in b] for b in jb(jc())]
        pbs = [[eg.reference.words for eg in b] for b in pb(pc())]
        assert jbs == pbs and len(jbs) > 3
    seq_j = jbatcher.batch_by_sequence(size=7)
    seq_p = pbatcher.batch_by_sequence(size=7)
    assert ([len(b) for b in seq_j(jc())] == [len(b) for b in seq_p(pc())])
    comp = list(zip(range(5), pbatcher.compounding(1.0, 8.0, 2.0)))
    assert [v for _, v in comp] == [1.0, 2.0, 4.0, 8.0, 8.0]


def test_corpus_limit_split_and_unported_formats(tmp_path, corpus_path):
    long = tmp_path / "long.jsonl"
    long.write_text('{"tokens": ' + str(["w"] * 25).replace("'", '"') + ', "tags": '
                    + str(["X"] * 25).replace("'", '"') + "}\n")
    pieces = list(pcorpus.Corpus(long, max_length=10)())
    assert [len(e) for e in pieces] == [10, 10, 5]
    assert len(list(pcorpus.Corpus(corpus_path, limit=7)())) == 7
    # the binary corpora are read now (tests/test_torch_corpus.py holds them
    # against the JAX readers); a suffix no reader knows still raises
    docs = [eg.reference for eg in pcorpus.Corpus(corpus_path, limit=7)()]
    write_docbin(tmp_path / "x.spacy", docs)
    pcorpus.DocBin(docs).to_disk(tmp_path / "x.msgdoc")
    for suffix in (".spacy", ".msgdoc"):
        back = [eg.reference for eg in pcorpus.Corpus(tmp_path / f"x{suffix}")()]
        assert [(d.words, d.tags) for d in back] == [(d.words, d.tags) for d in docs]
    bad = tmp_path / "x.txt"
    bad.write_text("")
    with pytest.raises(ValueError, match="Unsupported corpus format"):
        list(pcorpus.Corpus(bad)())


def _trunk_loss_grads(nlp, batch, remat: bool, seed):
    trunk = nlp.components["transformer"].model
    trunk.remat = remat
    nlp.model.requires_grad_(True)
    try:
        for p in nlp.model.parameters():
            p.grad = None
        loss, _ = nlp.loss(batch["tokens"], batch["targets"], dropout=0.1, seed=seed)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in nlp.model.parameters()]
    finally:
        trunk.remat = True
        nlp.model.requires_grad_(False)


def test_dropout_under_remat_gives_the_same_gradients(models, corpus_path):
    _, pnlp = models
    peg = list(pcorpus.Corpus(corpus_path)())[:6]
    batch = pnlp.collate(peg, with_targets=True)
    on = _trunk_loss_grads(pnlp, batch, True, seed=123)
    off = _trunk_loss_grads(pnlp, batch, False, seed=123)
    plain = _trunk_loss_grads(pnlp, batch, False, seed=None)
    assert on[0] == off[0] and on[0] != plain[0]  # the masks are drawn, and drawn alike
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))
    other = _trunk_loss_grads(pnlp, batch, True, seed=124)
    assert other[0] != on[0]


def test_dropout_op_semantics():
    x = torch.ones(1000, 50)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert dropout(x, 0.0, g) is x and dropout(x, 0.5, None) is x
    assert Context(train=False, dropout=0.3).dropout_rate(0.1) == 0.0
    assert Context(train=True, dropout=None).dropout_rate(0.1) == 0.1
