"""The port's parser head against the JAX package's, on the CPU, at a small
size (trunk width 32, depth 1, 2 heads, embed 300; hidden width 16).

The transition system, the pseudo-projective transform and the pseudo-UD
corpus are host code copied from the JAX package: their outputs must be
equal. The decodes get the same X and upper weights (numpy, from seeds) in
both packages and must give the same integers. The loss and gradients of
one batch: the parser's loss within 1e-5 relative, each gradient leaf
within 1e-4 of its max |g| (the same f32 math in other summation orders). A
JAX model directory with tagger, parser and NER, loaded by the port, must
tag, parse and find entities identically.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu import udgen as judgen
from spacy_ray_tpu.models import parser as jparser
from spacy_ray_tpu.pipeline import nonproj as jnonproj
from spacy_ray_tpu.pipeline import scoring as jscoring
from spacy_ray_tpu.pipeline import transition as jtransition
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training.checkpoint import _flatten

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch import udgen as pudgen
from spacy_ray_tpu_torch.models import parser as pparser
from spacy_ray_tpu_torch.pipeline import nonproj as pnonproj
from spacy_ray_tpu_torch.pipeline import scoring as pscoring
from spacy_ray_tpu_torch.pipeline import transition as ptransition
from spacy_ray_tpu_torch.pipeline.doc import doc_to_json
from spacy_ray_tpu_torch.training import corpus as pcorpus

FULL_CFG = """
[nlp]
lang = "en"
pipeline = ["transformer", "tagger", "parser", "ner"]

[components.transformer]
factory = "transformer"

[components.transformer.model]
@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 32
depth = 1
n_heads = 2
ffn_mult = 2
dropout = 0.1
max_len = 512
embed_size = 300

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32

[components.parser]
factory = "parser"

[components.parser.model]
@architectures = "spacy.TransitionBasedParser.v2"
state_type = "parser"
hidden_width = 16
maxout_pieces = 2

[components.parser.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32

[components.ner]
factory = "ner"

[components.ner.model]
@architectures = "spacy.TransitionBasedParser.v2"
state_type = "ner"
hidden_width = 16
maxout_pieces = 2

[components.ner.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32
"""


def _heads_trees(n_docs, seed):
    """(heads, deps) of the pseudo-UD corpus, non-projective docs included."""
    return [(eg.reference.heads, eg.reference.deps)
            for eg in judgen.synth_ud_corpus(n_docs, seed=seed, max_sents=2)]


def test_udgen_corpus_equals_jax():
    for seed in (0, 3):
        jdocs = [jcorpus._doc_to_json(eg.reference)
                 for eg in judgen.synth_ud_corpus(40, seed=seed)]
        pegs = pudgen.synth_ud_corpus(40, seed=seed)
        assert [doc_to_json(eg.reference) for eg in pegs] == jdocs
        assert all(eg.reference.ents_annotated for eg in pegs)


def test_transition_and_nonproj_equal_jax_on_udgen():
    trees = _heads_trees(300, seed=1)
    n_lifted = 0
    for heads, deps in trees:
        assert ptransition.is_projective(heads) == jtransition.is_projective(heads)
        jp, pp = jnonproj.projectivize(heads, deps), pnonproj.projectivize(heads, deps)
        assert pp == jp
        proj_heads, deco, lifted = pp
        n_lifted += lifted > 0
        assert pnonproj.deprojectivize(proj_heads, deco) == jnonproj.deprojectivize(proj_heads, deco)
        labels = sorted(set(deco))
        ids = [labels.index(d) for d in deco]
        jo = jtransition.gold_oracle(proj_heads, ids, len(labels))
        po = ptransition.gold_oracle(proj_heads, ids, len(labels))
        assert (jo is None) == (po is None)
        if jo is not None:
            for a, b in zip(jo, po):
                assert np.array_equal(a, b)
        # the unlifted non-projective tree: both oracles refuse it
        if lifted:
            assert ptransition.gold_oracle(heads, ids, len(labels)) is None
            assert jtransition.gold_oracle(heads, ids, len(labels)) is None
    assert n_lifted > 0  # the corpus's crossing arcs were exercised
    assert pnonproj.projectivize([5, 0], ["a", "b"]) is None  # malformed
    assert pnonproj.decompose_label("nmod||nsubj") == ("nmod", "nsubj")


def _upper_pair(rng, D, H, Pc, n_labels):
    nA = 2 + 2 * n_labels
    params = {"hidden_W": (rng.standard_normal((12 * D, H * Pc)) * 0.3).astype(np.float32),
              "hidden_b": (rng.standard_normal((H, Pc)) * 0.1).astype(np.float32),
              "out_W": rng.standard_normal((H, nA)).astype(np.float32),
              "out_b": rng.standard_normal(nA).astype(np.float32)}
    fns = jparser.ParserModelFns(12, D, H, Pc, nA)
    upper = pparser.ParserUpper(12, D, H, Pc, nA)
    with torch.no_grad():
        for k, v in params.items():
            getattr(upper, k).copy_(torch.from_numpy(v))
    return fns, {k: jnp.asarray(v) for k, v in params.items()}, upper


@pytest.mark.parametrize("seed", range(4))
def test_decode_parser_greedy_and_beam_equal_jax(seed):
    rng = np.random.default_rng(seed)
    B, T, D, n_labels = 5, 18, 8, int(rng.integers(1, 7))
    fns, jparams, upper = _upper_pair(rng, D, 6, 2, n_labels)
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([T, 1, 0, int(rng.integers(2, T)), int(rng.integers(2, T))], np.int32)
    px, plen = torch.from_numpy(X), torch.from_numpy(lengths).long()
    jh, jl = jparser.decode_parser(fns, jparams, jnp.asarray(X), jnp.asarray(lengths), n_labels)
    ph, pl = pparser.decode_parser(upper, px, plen, n_labels)
    assert np.array_equal(ph.numpy(), np.asarray(jh))
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    jh, jl = jparser.decode_parser_beam(fns, jparams, jnp.asarray(X), jnp.asarray(lengths),
                                        n_labels, 4)
    ph, pl = pparser.decode_parser_beam(upper, px, plen, n_labels, 4)
    assert np.array_equal(ph.numpy(), np.asarray(jh))
    assert np.array_equal(pl.numpy(), np.asarray(jl))


def test_beam_top_k_breaks_ties_toward_the_lower_index_like_lax_top_k():
    x = np.array([[-1e9, 0.5, -1e9, 0.5, -1e9, -1e9, 2.0, -1e9]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    pv, pi = pparser._top_k_stable(torch.from_numpy(x), 5)
    assert pi.tolist() == np.asarray(ji).tolist() == [[6, 1, 3, 0, 2]]
    assert np.array_equal(pv.numpy(), np.asarray(jv))


def test_score_deps_and_sents_equal_jax():
    jegs = judgen.synth_ud_corpus(30, seed=2)
    pegs = pudgen.synth_ud_corpus(30, seed=2)
    rng = np.random.default_rng(0)
    for jeg, peg in zip(jegs, pegs):
        n = len(jeg)
        heads = [int(h) if rng.random() < 0.7 else int(rng.integers(0, n))
                 for h in jeg.reference.heads]
        deps = [d if rng.random() < 0.8 else d.upper() if rng.random() < 0.5 else "punct"
                for d in jeg.reference.deps]
        starts = [s if rng.random() < 0.9 else -s for s in jeg.reference.sent_starts]
        jeg.predicted = J.Doc(words=list(jeg.reference.words), heads=heads, deps=deps,
                              sent_starts=starts)
        peg.predicted = P.Doc(words=list(peg.reference.words), heads=list(heads),
                              deps=list(deps), sent_starts=list(starts))
    assert pscoring.score_deps(pegs) == jscoring.score_deps(jegs)
    assert pscoring.score_sents(pegs) == jscoring.score_sents(jegs)
    assert pscoring.score_deps([P.Example.from_gold(P.Doc(words=["a"]))]) == \
        jscoring.score_deps([J.Example.from_gold(J.Doc(words=["a"]))])


# ---------------------------------------------------------------- models


@pytest.fixture(scope="module")
def corpus_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ud") / "train.jsonl"
    judgen.write_ud_jsonl(path, 40, seed=0, max_sents=2)
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory, corpus_path):
    """(JAX pipeline, its directory, the port's load of it): tagger, parser
    and NER over one trunk, labels from the corpus."""
    jnlp = J.Pipeline.from_config(J.Config.from_str(FULL_CFG).interpolate())
    egs = list(jcorpus.Corpus(corpus_path)())
    jnlp.initialize(lambda: egs, seed=0)
    path = tmp_path_factory.mktemp("jax_full")
    jnlp.to_disk(path)
    return jnlp, path, P.Pipeline.from_disk(path, device="cpu")


@pytest.fixture(scope="module")
def one_batch_both(models, corpus_path):
    """The loss and gradients of one batch of 8 docs in both packages."""
    jnlp, _, pnlp = models
    jeg = list(jcorpus.Corpus(corpus_path)())[:8]
    peg = list(pcorpus.Corpus(corpus_path)())[:8]
    jb, pb = jnlp.collate(jeg), pnlp.collate(peg, with_targets=True)
    vg = jax.jit(jax.value_and_grad(jnlp.make_loss_fn(dropout=0.0), has_aux=True))
    (jloss, jmetrics), jgrads = vg(jnlp.params, jb["tokens"], jb["targets"],
                                   jax.random.PRNGKey(0))
    pnlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in pnlp.model.named_parameters()}
    for p in params.values():
        p.grad = None
    ploss, pmetrics = pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
    ploss.backward()
    pgrads = {k: p.grad.numpy().copy() for k, p in params.items()}
    pnlp.model.requires_grad_(False)
    jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    return (jb, pb, float(jloss), jmetrics, jflat), (float(ploss.detach()), pmetrics, pgrads)


def assert_head_matches(one_batch_both, head, metric):
    (jb, pb, jloss, jmetrics, jgrads), (ploss, pmetrics, pgrads) = one_batch_both
    for key in jb["targets"][head]:
        assert np.array_equal(np.asarray(jb["targets"][head][key]),
                              pb["targets"][head][key].numpy()), key
    jl, pl = float(jmetrics[f"loss_{head}"]), float(pmetrics[f"loss_{head}"])
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    assert abs(ploss - jloss) <= 1e-5 * abs(jloss)
    np.testing.assert_allclose(float(pmetrics[f"{head}_{metric}"]),
                               float(jmetrics[f"{head}_{metric}"]), atol=1e-6)
    assert set(pmetrics) == set(jmetrics)
    assert set(pgrads) == set(jgrads)
    leaves = [k for k in jgrads if k.startswith(f"{head}/") or k.startswith("transformer/")]
    assert any(k.startswith(f"{head}/upper/") for k in leaves)
    for k in leaves:
        g = jgrads[k]
        np.testing.assert_allclose(pgrads[k], g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30), err_msg=k)


def test_parser_loss_and_gradients_of_one_batch_match_jax(one_batch_both):
    assert_head_matches(one_batch_both, "parser", "parse_action_acc")


def test_full_jax_model_dir_parses_identically_in_the_port(models, corpus_path):
    jnlp, path, pnlp = models
    assert {n: pnlp.components[n].labels for n in pnlp.pipe_names} == \
        {n: jnlp.components[n].labels for n in jnlp.pipe_names}
    assert any(pnonproj.is_decorated(l) for l in pnlp.components["parser"].labels)
    texts = [" ".join(eg.reference.words) for eg in pcorpus.Corpus(corpus_path)()][:12]
    texts += ["Hello world", "a", " ".join(texts[:3])]
    for t in texts:
        jd, pd = jnlp(t), pnlp(t)
        assert pd.tags == jd.tags
        assert pd.heads == jd.heads and pd.deps == jd.deps, t
        assert [tuple(e) for e in pd.ents] == [tuple(e) for e in jd.ents]
    # scores of the same model on the same gold docs: the JAX keys, equal values
    jscores = jnlp.evaluate(list(jcorpus.Corpus(corpus_path)()))
    pscores = pnlp.evaluate(list(pcorpus.Corpus(corpus_path)()))
    assert pscores == jscores


def test_parser_set_annotations_deprojectivizes_and_marks_roots():
    comp = P.registry.get("factories", "parser")(name="parser", model={})
    comp.labels = ["det", "nmod||nsubj", "nsubj", "obj"]
    doc = P.Doc(words=["the", "cat", "saw", "in", "dogs"])
    # token 4 lifted to the root (2) with the decoration of its true head's
    # label: the search finds token 1 (nsubj) under 2
    out = {"heads": torch.tensor([[1, 2, 2, 4, 2]]), "labels": torch.tensor([[0, 2, 0, 0, 1]])}
    comp.set_annotations([doc], out, [5])
    jdoc = J.Doc(words=list(doc.words))
    jcomp = J.registry.get("factories", "parser")(name="parser", model={})
    jcomp.labels = list(comp.labels)
    jcomp.set_annotations([jdoc], {k: np.asarray(v) for k, v in out.items()}, [5])
    assert (doc.heads, doc.deps) == (jdoc.heads, jdoc.deps)
    assert doc.heads[4] == 1 and doc.deps[2] == "ROOT"
