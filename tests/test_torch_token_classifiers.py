"""The port's per-token classifiers beside the tagger (``morphologizer``,
``senter``, ``trainable_lemmatizer``) on configs/cnn.cfg's trunk (cut), and
the ``spacy.Tagger.v1`` name, on the CPU against the JAX package: the edit
trees, the labels, the targets, one batch's loss and every leaf's gradient
with carried weights, and the annotations and scores of a model directory
trained by the port and read by both packages.

Tolerances: the loss (float32) within 1e-5 relative; each leaf's gradient
within 1e-4 of its max |g|, computed in float64 by both packages, dropout
off; annotations identical; scores equal.
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu.pipeline.components import edit_tree_lemmatizer as jetl
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.udgen import write_ud_jsonl as j_write_ud

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.pipeline.components import edit_tree_lemmatizer as petl
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training.loop import train as p_train

from test_torch_cnn_train import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    _assert_grads_close, _port_loss_and_grads, one_torch_thread,
)

REPO = Path(__file__).resolve().parent.parent
HEADS = {"tagger": "spacy.Tagger.v2", "morphologizer": "spacy.Tagger.v2",
         "senter": "spacy.Tagger.v2", "trainable_lemmatizer": "spacy.Tagger.v2"}


def tokcls_config(pkg, data=None, tagger_arch="spacy.Tagger.v2", heads=tuple(HEADS)):
    """configs/cnn.cfg with its trunk cut to width 32, depth 1, embed 256 and
    the listed heads, each a tagger head over a listener."""
    cfg = pkg.Config.from_disk(REPO / "configs" / "cnn.cfg")
    cfg["nlp"]["pipeline"] = ["tok2vec", *heads]
    cfg["components"]["tok2vec"]["model"].update(width=32, depth=1, embed_size=256)
    for head in heads:
        block = {"factory": head, "model": {
            "@architectures": tagger_arch if head == "tagger" else HEADS[head],
            "tok2vec": {"@architectures": "spacy.Tok2VecListener.v1", "width": 32}}}
        if head == "trainable_lemmatizer":
            block.update(min_tree_freq=3, top_k=3)
        cfg["components"][head] = block
    cfg["training"].pop("score_weights")  # the components' defaults
    if data is not None:
        cfg["paths"] = {"train": str(data / "train.jsonl"), "dev": str(data / "dev.jsonl")}
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokcls_data")
    j_write_ud(d / "train.jsonl", 120, seed=0, max_sents=3)
    j_write_ud(d / "dev.jsonl", 30, seed=1, max_sents=3)
    return d


# ------------------------------------------------------------ edit trees


def test_edit_trees_match_jax(data):
    pairs = [(w, l) for eg in jcorpus.Corpus(data / "train.jsonl")()
             for w, l in zip(eg.reference.words, eg.reference.lemmas)]
    pairs += [("ran", "run"), ("better", "good"), ("children", "child"), ("a", ""),
              ("", "x"), ("unhappily", "happy"), ("geese", "goose"), ("Mice", "mouse")]
    for form, lemma in pairs:
        tree = petl.build_tree(form, lemma)
        assert tree == jetl.build_tree(form, lemma)
        assert petl.tree_key(tree) == jetl.tree_key(tree)
        assert petl.tree_from_key(petl.tree_key(tree)) == tree
        for other in ("runs", "walked", "geese", "x", "", form):
            assert petl.apply_tree(tree, other) == jetl.apply_tree(tree, other)
        assert petl.apply_tree(tree, form) == lemma


def test_labels_match_jax(data):
    jegs = list(jcorpus.Corpus(data / "train.jsonl")())
    pegs = list(pcorpus.Corpus(data / "train.jsonl")())
    jnlp = J.Pipeline.from_config(tokcls_config(J, data).interpolate())
    pnlp = P.Pipeline.from_config(tokcls_config(P, data).interpolate(), device="cpu")
    n_trees = []
    for name in HEADS:
        for freq in ((1, 3, 10 ** 6) if name == "trainable_lemmatizer" else (None,)):
            jc, pc = jnlp.components[name], pnlp.components[name]
            if freq is not None:
                jc.min_tree_freq = pc.min_tree_freq = freq
            jc.labels, pc.labels = [], []
            jc.add_labels_from(jegs)
            jc.finish_labels()
            pc.add_labels_from(pegs)
            pc.finish_labels()
            assert pc.labels == jc.labels, (name, freq)
            if freq is not None:
                assert pc.labels[0] == petl.tree_key(None)  # the identity first
                n_trees.append(len(pc.labels))
    assert pnlp.components["senter"].labels == ["I", "S"]
    assert n_trees[0] >= n_trees[1] > n_trees[2] == 1  # min_tree_freq 1, 3, 10 ** 6


# ------------------------------------------------- carried: one batch


@pytest.fixture(scope="module")
def carried(data, tmp_path_factory):
    jnlp = J.Pipeline.from_config(tokcls_config(J, data).interpolate())
    egs = list(jcorpus.Corpus(data / "train.jsonl")())
    jnlp.initialize(lambda: egs, seed=0)
    model_dir = tmp_path_factory.mktemp("tokcls_carried")
    jnlp.to_disk(model_dir)
    pnlp = P.Pipeline.from_disk(model_dir, device="cpu")
    jb = jnlp.collate(egs[:12])
    pb = pnlp.collate(list(pcorpus.Corpus(data / "train.jsonl")())[:12], with_targets=True)
    return jnlp, pnlp, jb, pb


def test_targets_and_param_paths_match_jax(carried):
    jnlp, pnlp, jb, pb = carried
    assert set(jb["targets"]) == set(pb["targets"]) == set(HEADS)
    for head, t in jb["targets"].items():
        for key, v in t.items():
            assert np.array_equal(np.asarray(v), pb["targets"][head][key].numpy()), (head, key)
        assert pb["targets"][head]["tag_mask"].any(), head
    jshapes = {k: tuple(v.shape) for k, v in _flatten(jnlp.params).items()}
    pshapes = {k.replace(".", "/"): tuple(v.shape) for k, v in pnlp.model.state_dict().items()}
    assert jshapes == pshapes
    assert pshapes["senter/1_output/W"] == (32, 2)
    lem = pnlp.components["trainable_lemmatizer"]
    assert lem.labels[0] == petl.tree_key(None) and len(lem.labels) > 2


def test_loss_and_gradients_of_one_batch_match_jax(carried):
    jnlp, pnlp, jb, pb = carried
    loss_fn = jnlp.make_loss_fn(dropout=0.0)
    jloss, jmetrics = jax.jit(loss_fn)(jnlp.params, jb["tokens"], jb["targets"],
                                       jax.random.PRNGKey(0))
    ploss, pmetrics, _ = _port_loss_and_grads(pnlp, pb)
    assert set(pmetrics) == set(jmetrics)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for head in HEADS:
        jl = float(jmetrics[f"loss_{head}"])
        assert abs(float(pmetrics[f"loss_{head}"]) - jl) <= 1e-5 * abs(jl), head
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype=jnp.float64),
                                          jnlp.params)
        jgrads = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], jb["targets"],
                                                    jax.random.PRNGKey(0))[0]))(params64)
        jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    pnlp.model.double()
    try:
        _assert_grads_close(_port_loss_and_grads(pnlp, pb)[2], jflat, 12 + 2 * len(HEADS),
                            np.float64)
    finally:
        pnlp.model.float()


# ------------------------------------ trained by the port, read by both


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """The port's ``train`` loop, 40 steps evaluated every 20."""
    out = tmp_path_factory.mktemp("tokcls_trained")
    cfg = tokcls_config(P, data)
    cfg["training"].update(max_steps=40, eval_frequency=20)
    _, result = p_train(cfg, out, device="cpu", stdout_log=False)
    return out / "best-model", result


def test_port_loop_trains_every_head(trained):
    _, result = trained
    for head in HEADS:
        losses = [s[head] for s in result.step_head_losses]
        assert np.mean(losses[-5:]) <= np.mean(losses[:5]) * 2 / 3, head
    scores = result.history[-1]["other_scores"]
    for key in ("tag_acc", "pos_acc", "morph_acc", "lemma_acc", "sents_f"):
        assert scores[key] > 0.5, (key, scores[key])


def test_annotations_and_scores_of_the_model_dir_match_jax(trained, data):
    model_dir, _ = trained
    jnlp = J.Pipeline.from_disk(model_dir)
    pnlp = P.Pipeline.from_disk(model_dir, device="cpu")
    jegs = list(jcorpus.Corpus(data / "dev.jsonl")())
    pegs = list(pcorpus.Corpus(data / "dev.jsonl")())
    jscores, pscores = jnlp.evaluate(jegs), pnlp.evaluate(pegs)
    for jeg, peg in zip(jegs, pegs):
        for attr in ("tags", "pos", "morphs", "sent_starts", "lemmas"):
            assert getattr(peg.predicted, attr) == getattr(jeg.predicted, attr), attr
    assert pscores == jscores
    assert {"morph_per_feat", "sents_f", "lemma_acc", "pos_acc"} <= set(pscores)
    # the scorers on predictions that differ from the gold
    for jeg, peg in zip(jegs, pegs):
        for eg in (jeg, peg):
            eg.predicted.morphs = [m.replace("Sing", "Plur") for m in eg.predicted.morphs]
            eg.predicted.sent_starts = [-1] + eg.predicted.sent_starts[1:]
            eg.predicted.lemmas = [l.upper() if i % 3 else l
                                   for i, l in enumerate(eg.predicted.lemmas)]
    for name in HEADS:
        assert pnlp.components[name].score(pegs) == jnlp.components[name].score(jegs), name
    # no gold annotation: None keys, as in JAX
    for eg in jegs + pegs:
        eg.reference.morphs = eg.reference.pos = eg.reference.lemmas = None
        eg.reference.sent_starts = None
    for name in ("morphologizer", "senter", "trainable_lemmatizer"):
        ps = pnlp.components[name].score(pegs)
        assert ps == jnlp.components[name].score(jegs) and all(v is None for v in ps.values())


@pytest.mark.parametrize("arch", ["spacy.Tagger.v1", "spacy.Tagger.v2"])
def test_tagger_architecture_names_resolve_and_load_both_ways(arch, data, tmp_path):
    egs = list(pcorpus.Corpus(data / "train.jsonl")())
    pnlp = P.Pipeline.from_config(tokcls_config(P, data, arch, ("tagger",)).interpolate(),
                                  device="cpu")
    pnlp.initialize(lambda: egs, seed=0)
    pnlp.to_disk(tmp_path / "port")
    jnlp = J.Pipeline.from_disk(tmp_path / "port")
    assert jnlp.config["components"]["tagger"]["model"]["@architectures"] == arch
    jnlp.to_disk(tmp_path / "jax")
    back = P.Pipeline.from_disk(tmp_path / "jax", device="cpu")
    texts = [" ".join(eg.reference.words) for eg in egs[:8]]
    assert [back(t).tags for t in texts] == [jnlp(t).tags for t in texts] == [
        pnlp(t).tags for t in texts]


def test_tagger_with_an_inline_trunk_trains_and_tags_as_jax(data, tmp_path):
    # a head whose tok2vec is a full HashEmbedCNN block, not a listener: the
    # chain hands its context to the trunk by keyword (the trunk's second
    # argument is its overlay)
    egs = list(jcorpus.Corpus(data / "train.jsonl")())
    cfg = tokcls_config(J, data, heads=("tagger",))
    cfg["nlp"]["pipeline"] = ["tagger"]
    cfg["components"]["tagger"]["model"]["tok2vec"] = dict(cfg["components"]["tok2vec"]["model"])
    jnlp = J.Pipeline.from_config(cfg.interpolate())
    jnlp.initialize(lambda: egs, seed=0)
    jnlp.to_disk(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    assert not pnlp.components["tagger"].listens
    jb = jnlp.collate(egs[:8])
    pb = pnlp.collate(list(pcorpus.Corpus(data / "train.jsonl")())[:8], with_targets=True)
    jloss = float(jnlp.make_loss_fn(dropout=0.0)(jnlp.params, jb["tokens"], jb["targets"],
                                                 jax.random.PRNGKey(0))[0])
    ploss, _, grads = _port_loss_and_grads(pnlp, pb)
    assert abs(float(ploss) - jloss) <= 1e-5 * abs(jloss)
    assert any(k.startswith("tagger/0_hash_embed_cnn/") for k in grads)
    texts = [" ".join(eg.reference.words) for eg in egs[:8]]
    assert [pnlp(t).tags for t in texts] == [jnlp(t).tags for t in texts]
