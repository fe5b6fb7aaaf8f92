"""The port's transformer + tagger pipeline against the JAX package, on the
CPU, at a small size (width 64, depth 2, 4 heads, embed_size 500).

The JAX package builds, initializes and saves the model; the port loads the
same directory. Tolerances: trunk and tagger outputs within 1e-4 in f32
(measured ~1e-6: the same f32 math in another summation order), tags and
collated inputs identical.
"""

import numpy as np
import pytest
import torch

import spacy_ray_tpu as J
from spacy_ray_tpu import udgen as judgen
from spacy_ray_tpu.ops import int8_matmul as ji8
from spacy_ray_tpu.serving.overlay import build_params_overlay as j_overlay
from spacy_ray_tpu.training.checkpoint import _flatten

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.models.transformer import resolve_compute_dtype
from spacy_ray_tpu_torch.registry import RegistryError
from spacy_ray_tpu_torch.serving.overlay import build_params_overlay as p_overlay

from test_torch_parser import FULL_CFG

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

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = ${components.transformer.model.width}
"""

TEXTS = [
    "The cat sat on the mat .",
    "Hello world",
    "A much longer sentence , with commas , 3.5 numbers and U.S. abbreviations ; "
    "plus well-known hyphens and don't contractions that run past sixteen tokens .",
    "Paris",
    "She said (quietly) that it's fine!",
]
TAGS = ["DET", "NOUN", "VERB", "ADP", "PUNCT", "PROPN", "ADJ"]


def _gold(seed=0):
    rng = np.random.default_rng(seed)
    docs = []
    for t in TEXTS:
        words = t.split()
        docs.append(J.Doc(words=words, tags=[TAGS[i] for i in rng.integers(0, len(TAGS), len(words))]))
    return [J.Example.from_gold(d) for d in docs]


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    nlp = J.Pipeline.from_config(J.Config.from_str(TRF_TAGGER_CFG).interpolate())
    egs = _gold()
    nlp.initialize(lambda: egs, seed=0)
    path = tmp_path_factory.mktemp("jax_trf_tagger")
    nlp.to_disk(path)
    return nlp, path


@pytest.fixture(scope="module")
def port_nlp(jax_model):
    return P.Pipeline.from_disk(jax_model[1], device="cpu")


def _collate_both(jnlp, pnlp, texts, **pad):
    jdocs = [jnlp.tokenizer(t) for t in texts]
    pdocs = [pnlp.tokenizer(t) for t in texts]
    assert [d.words for d in jdocs] == [d.words for d in pdocs]
    jb = jnlp.collate([J.Example.from_gold(d) for d in jdocs], with_targets=False, **pad)
    pb = pnlp.collate([P.Example.from_gold(d) for d in pdocs], **pad)
    return jb, pb


def test_collate_keys_masks_and_buckets_identical(jax_model, port_nlp):
    jnlp, _ = jax_model
    for texts, pad in [(TEXTS, {}), (TEXTS[:1], {}), (TEXTS[:3], {}),
                       (TEXTS[1:3], {"pad_batch_to": 8, "pad_len_to": 64}),
                       ([" ".join(["word"] * 70)], {})]:
        jb, pb = _collate_both(jnlp, port_nlp, texts, **pad)
        jt, pt = jb["tokens"], pb["tokens"]
        assert (jt.batch_size, jt.seq_len) == (pt.batch_size, pt.seq_len)
        assert np.array_equal(np.asarray(jt.attr_keys).astype(np.int64), pt.attr_keys.numpy())
        assert np.array_equal(np.asarray(jt.mask), pt.mask.numpy())
        assert jb["lengths"] == pb["lengths"] and jb["n_words"] == pb["n_words"]


def test_trunk_and_tagger_outputs_match_jax(jax_model, port_nlp):
    jnlp, _ = jax_model
    jb, pb = _collate_both(jnlp, port_nlp, TEXTS)
    jout = jnlp.make_forward_fn()(jnlp.params, jb["tokens"])
    with torch.inference_mode():
        pout = port_nlp.forward(pb["tokens"])
    for name in ("transformer", "tagger"):
        np.testing.assert_allclose(pout[name].X.numpy(), np.asarray(jout[name].X), atol=1e-4)
        assert np.array_equal(pout[name].mask.numpy(), np.asarray(jout[name].mask))
    assert pout["transformer"].X.dtype == torch.float32  # "auto" = f32 on cpu


def test_loaded_jax_model_gives_identical_tags(jax_model, port_nlp):
    jnlp, _ = jax_model
    assert port_nlp.components["tagger"].labels == jnlp.components["tagger"].labels
    for t in TEXTS:
        assert port_nlp(t).tags == jnlp(t).tags


def test_param_paths_and_shapes_match_jax(jax_model, port_nlp, tmp_path):
    jnlp, _ = jax_model
    jflat = {k: v.shape for k, v in _flatten(jnlp.params).items()}
    pflat = {k: tuple(v.shape) for k, v in param_paths(port_nlp.model).items()}
    assert pflat == jflat
    assert "transformer/layer_1/qkv_W" in pflat and "tagger/1_output/W" in pflat
    # the full pipeline of configs/trf.cfg (tagger, parser and NER heads)
    # at a small width: the JAX package's directory loads with the same paths
    full = J.Pipeline.from_config(J.Config.from_str(FULL_CFG).interpolate())
    egs = judgen.synth_ud_corpus(20, seed=0, max_sents=2)
    full.initialize(lambda: egs, seed=0)
    full.to_disk(tmp_path)
    jflat = {k: v.shape for k, v in _flatten(full.params).items()}
    pflat = {k: tuple(v.shape) for k, v in
             param_paths(P.Pipeline.from_disk(tmp_path, device="cpu").model).items()}
    assert pflat == jflat
    for head in ("parser", "ner"):
        assert {k for k in pflat if k.startswith(head)} == {
            f"{head}/upper/{leaf}" for leaf in ("hidden_W", "hidden_b", "out_W", "out_b")}


def test_load_params_takes_jax_flat_tree_and_checks_it(jax_model):
    jnlp, path = jax_model
    nlp = P.Pipeline.from_disk(path, device="cpu")
    flat = {k: np.asarray(v) for k, v in _flatten(jnlp.params).items()}
    flat["tagger/1_output/b"] = flat["tagger/1_output/b"] + 1.0
    nlp.load_params(flat)
    assert np.allclose(nlp.params["tagger"]["1_output"]["b"].numpy(),
                       flat["tagger/1_output/b"])
    del flat["transformer/pos"]
    with pytest.raises(ValueError, match="transformer/pos"):
        nlp.load_params(flat)


def test_port_model_dir_loads_in_jax(tmp_path):
    nlp = P.Pipeline.from_config(P.Config.from_str(TRF_TAGGER_CFG).interpolate(), device="cpu")
    nlp.initialize(labels={"tagger": TAGS}, seed=3)
    nlp.to_disk(tmp_path)
    jnlp = J.Pipeline.from_disk(tmp_path)
    assert jnlp.components["tagger"].labels == TAGS
    for t in TEXTS:
        assert jnlp(t).tags == nlp(t).tags


def test_initialize_is_seeded_and_collects_labels():
    cfg = P.Config.from_str(TRF_TAGGER_CFG).interpolate()
    a = P.Pipeline.from_config(cfg, device="cpu")
    egs = [P.Example.from_gold(P.Doc(words=e.reference.words, tags=e.reference.tags))
           for e in _gold()]
    a.initialize(lambda: egs, seed=5)
    b = P.Pipeline.from_config(cfg, device="cpu")
    b.initialize(labels={"tagger": sorted(TAGS)}, seed=5)
    assert a.components["tagger"].labels == sorted(set(TAGS))
    pa, pb = param_paths(a.model), param_paths(b.model)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def test_int8_overlay_tags_match_jax_interpreted_kernel(jax_model, port_nlp, monkeypatch):
    jnlp, _ = jax_model
    monkeypatch.setenv("SRT_PALLAS_INT8", "1")
    monkeypatch.setattr(ji8, "_PROBE_CACHE", {})
    jres = j_overlay(jnlp.params, "int8")
    pres = p_overlay(port_nlp.params, "int8", port_nlp.device)
    assert jres.resolved == pres.resolved == "int8" and jres.n_overlaid == pres.n_overlaid == 8
    jdocs = jnlp.predict_docs([jnlp.tokenizer(t) for t in TEXTS], params=jres.params)
    pdocs = port_nlp.predict_docs([port_nlp.tokenizer(t) for t in TEXTS],
                                  overlay=pres.overlay)
    assert [d.tags for d in pdocs] == [d.tags for d in jdocs]
    jb, pb = _collate_both(jnlp, port_nlp, TEXTS)
    jout = jnlp.make_forward_fn()(jres.params, jb["tokens"])
    with torch.inference_mode():
        pout = port_nlp.forward(pb["tokens"], pres.overlay)
    np.testing.assert_allclose(pout["transformer"].X.numpy(),
                               np.asarray(jout["transformer"].X), atol=1e-4)


def test_bf16_overlay_matches_jax(jax_model, port_nlp):
    jnlp, _ = jax_model
    jres = j_overlay(jnlp.params, "bf16")
    pres = p_overlay(port_nlp.params, "bf16", port_nlp.device)
    assert jres.resolved == pres.resolved == "bf16" and jres.n_overlaid == pres.n_overlaid
    jb, pb = _collate_both(jnlp, port_nlp, TEXTS)
    jout = jnlp.make_forward_fn()(jres.params, jb["tokens"])
    with torch.inference_mode():
        pout = port_nlp.forward(pb["tokens"], pres.overlay)
    np.testing.assert_allclose(pout["transformer"].X.numpy(),
                               np.asarray(jout["transformer"].X), atol=1e-4)


@pytest.mark.parametrize("requested,resolved", [("auto", "f32"), ("f32", "f32")])
def test_precision_policy_on_cpu(port_nlp, requested, resolved):
    res = p_overlay(port_nlp.params, requested, torch.device("cpu"))
    assert res.resolved == resolved and res.overlay is None
    cuda = p_overlay(port_nlp.params, "auto", torch.device("cuda"))
    assert cuda.resolved == "bf16" and "cuda" in cuda.label


def test_compute_dtype_rule():
    assert resolve_compute_dtype("auto", torch.device("cpu")) == torch.float32
    assert resolve_compute_dtype("auto", torch.device("cuda")) == torch.bfloat16
    assert resolve_compute_dtype("float32", torch.device("cuda")) == torch.float32
    with pytest.raises(ValueError):
        resolve_compute_dtype("fp8", torch.device("cpu"))


def test_unknown_names_list_what_is_registered():
    cfg = P.Config.from_str(TRF_TAGGER_CFG.replace("spacy.Tagger.v2", "spacy.Nope.v1"))
    nlp = P.Pipeline.from_config(cfg.interpolate(), device="cpu")
    with pytest.raises(RegistryError, match="spacy.Tagger.v2"):
        nlp.initialize(labels={"tagger": TAGS})
    cfg = P.Config.from_str(TRF_TAGGER_CFG.replace('factory = "tagger"', 'factory = "nope"'))
    with pytest.raises(RegistryError, match="Available: attribute_ruler, entity_linker, "
                       "entity_ruler, lemmatizer, morphologizer, ner, parser, senter, "
                       "spancat, tagger, textcat, textcat_multilabel, tok2vec, "
                       "trainable_lemmatizer, transformer"):
        P.Pipeline.from_config(cfg.interpolate(), device="cpu")
