"""The port's NER head against the JAX package's, on the CPU, at a small size
(trunk width 32, depth 1, 2 heads, embed 300; hidden width 16).

The BILUO decodes (greedy and Viterbi) get the same logits in both packages
and must give the same action ids, padding included. Span scoring, BILUO
conversion and the collated targets are host code and must be equal. The
loss and gradients of one batch: the NER loss within 1e-5 relative, each
gradient leaf within 1e-4 of its max |g|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu import udgen as judgen
from spacy_ray_tpu.models import parser as jparser
from spacy_ray_tpu.pipeline import scoring as jscoring
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training.checkpoint import _flatten

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch import udgen as pudgen
from spacy_ray_tpu_torch.models import parser as pparser
from spacy_ray_tpu_torch.pipeline import scoring as pscoring
from spacy_ray_tpu_torch.training import corpus as pcorpus

NER_CFG = """
[nlp]
lang = "en"
pipeline = ["transformer", "ner"]

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


@pytest.mark.parametrize("seed,n_labels", [(0, 1), (1, 3), (2, 5), (3, 0)])
def test_biluo_decodes_equal_jax(seed, n_labels):
    rng = np.random.default_rng(seed)
    B, T = 6, 14
    logits = (rng.standard_normal((B, T, 1 + 4 * n_labels)) * 2).astype(np.float32)
    # exact ties between actions, which both break toward the lower index
    logits[0, :, :] = np.round(logits[0, :, :])
    lengths = np.array([T, 1, 0, 2, int(rng.integers(3, T)), T - 1], np.int32)
    pl, plen = torch.from_numpy(logits), torch.from_numpy(lengths).long()
    for jfn, pfn in ((jparser.decode_biluo_viterbi, pparser.decode_biluo_viterbi),
                     (jparser.decode_biluo, pparser.decode_biluo)):
        want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(lengths), n_labels))
        got = pfn(pl, plen, n_labels).numpy()
        assert np.array_equal(got, want), jfn.__name__


def test_ner_window_features_equal_jax():
    lengths = np.array([5, 0, 9, 1], np.int32)
    want = np.asarray(jparser.ner_window_features(9, jnp.asarray(lengths)))
    assert np.array_equal(pparser.ner_window_features(9, torch.from_numpy(lengths)).numpy(), want)


def test_biluo_round_trip_and_span_scores_equal_jax():
    jegs = judgen.synth_ud_corpus(40, seed=4)
    pegs = pudgen.synth_ud_corpus(40, seed=4)
    rng = np.random.default_rng(1)
    for i, (jeg, peg) in enumerate(zip(jegs, pegs)):
        tags = jeg.reference.ents_biluo()
        assert peg.reference.ents_biluo() == tags
        assert [tuple(s) for s in P.Doc.spans_from_biluo(tags)] == \
            [tuple(s) for s in J.Doc.spans_from_biluo(tags)]
        # predictions: gold spans, some dropped, relabelled or shifted
        pred = []
        for s in jeg.reference.ents:
            r = rng.random()
            if r < 0.2:
                continue
            label = "ORG" if r < 0.35 else s.label
            end = s.end - 1 if r > 0.9 and s.end - s.start > 1 else s.end
            pred.append((s.start, end, label))
        # doc 0 unannotated on the gold side: its predictions are not scored
        annotated = None if i else False
        jeg.reference.ents_annotated = peg.reference.ents_annotated = annotated
        jeg.predicted = J.Doc(words=list(jeg.reference.words),
                              ents=[J.Span(*p) for p in pred])
        peg.predicted = P.Doc(words=list(peg.reference.words),
                              ents=[P.Span(*p) for p in pred])
    getter = (lambda d: d.ents)
    want = jscoring.score_spans(jegs, "ents", getter, lambda d: d.has_ents_annotation)
    got = pscoring.score_spans(pegs, "ents", getter, lambda d: d.has_ents_annotation)
    assert got == want and want["ents_per_type"] and 0 < want["ents_f"] < 1
    none = pscoring.score_spans([P.Example.from_gold(P.Doc(words=["a"]))], "ents", getter,
                                lambda d: d.has_ents_annotation)
    assert none == {"ents_p": None, "ents_r": None, "ents_f": None, "ents_per_type": None}


def test_ner_keeps_preset_entities_and_refuses_unknown_decodes():
    comp = P.registry.get("factories", "ner")(name="ner", model={})
    comp.labels = ["ORG", "PERSON"]
    doc = P.Doc(words=["a", "b", "c", "d"], ents=[P.Span(1, 2, "GPE")])
    # model: U-ORG at 0, B-PERSON L-PERSON over 1..2 (overlaps the preset), U-ORG at 3
    acts = torch.tensor([[4, 5, 7, 4]])
    comp.set_annotations([doc], {"actions": acts}, [4])
    assert [tuple(e) for e in doc.ents] == [(0, 1, "ORG"), (1, 2, "GPE"), (3, 4, "ORG")]
    with pytest.raises(ValueError, match="viterbi|greedy"):
        P.registry.get("factories", "ner")(name="ner", model={}, decode="beam")


@pytest.fixture(scope="module")
def ner_models(tmp_path_factory):
    path = tmp_path_factory.mktemp("ud") / "train.jsonl"
    judgen.write_ud_jsonl(path, 24, seed=5, max_sents=2)
    jnlp = J.Pipeline.from_config(J.Config.from_str(NER_CFG).interpolate())
    jegs = list(jcorpus.Corpus(path)())
    jnlp.initialize(lambda: jegs, seed=0)
    out = tmp_path_factory.mktemp("jax_ner")
    jnlp.to_disk(out)
    return jnlp, P.Pipeline.from_disk(out, device="cpu"), path


def test_ner_loss_and_gradients_of_one_batch_match_jax(ner_models):
    jnlp, pnlp, path = ner_models
    jb = jnlp.collate(list(jcorpus.Corpus(path)())[:8])
    pb = pnlp.collate(list(pcorpus.Corpus(path)())[:8], with_targets=True)
    for key in ("actions", "feats", "ner_mask"):
        assert np.array_equal(np.asarray(jb["targets"]["ner"][key]),
                              pb["targets"]["ner"][key].numpy()), key
    vg = jax.jit(jax.value_and_grad(jnlp.make_loss_fn(dropout=0.0), has_aux=True))
    (jloss, jmetrics), jgrads = vg(jnlp.params, jb["tokens"], jb["targets"],
                                   jax.random.PRNGKey(0))
    pnlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in pnlp.model.named_parameters()}
    ploss, pmetrics = pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
    ploss.backward()
    pnlp.model.requires_grad_(False)
    assert abs(float(ploss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(pmetrics) == set(jmetrics) == {"loss_ner", "ner_ner_action_acc"}
    np.testing.assert_allclose(float(pmetrics["ner_ner_action_acc"]),
                               float(jmetrics["ner_ner_action_acc"]), atol=1e-6)
    jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    assert set(jflat) == set(params) and "ner/upper/hidden_W" in jflat
    for k, g in jflat.items():
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30), err_msg=k)


def test_ner_decodes_of_a_loaded_jax_model_equal_jax(ner_models):
    jnlp, pnlp, path = ner_models
    texts = [" ".join(eg.reference.words) for eg in pcorpus.Corpus(path)()][:8]
    for decode in ("viterbi", "greedy"):
        jnlp.components["ner"].decode = pnlp.components["ner"].decode = decode
        for t in texts:
            assert [tuple(e) for e in pnlp(t).ents] == [tuple(e) for e in jnlp(t).ents]
    jnlp.components["ner"].decode = pnlp.components["ner"].decode = "viterbi"
