"""The port's entity linker against the JAX package, on the CPU: the
knowledge base files, the training targets (skipped and bucketed
mentions), one batch's loss and gradients, the decode (NIL, threshold and
near-tied candidates), the scores, model directories with the
``{name}.kb.npz`` sidecar both ways, ``evaluate``'s gold-mention seeding,
and the JAX-written ``tests/data/jax_nel`` directory.

Tolerances: KB contents, targets, kb_ids and scores exact; the loss within
1e-5 relative; each leaf's gradient within 1e-4 x its max |g|, both
packages in float64 around the linker's float32 scoring (JAX's casts).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu.pipeline import kb as jkb
from spacy_ray_tpu.pipeline.doc import Doc as JDoc, Example as JExample, Span as JSpan
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.types import Padded as JPadded

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.pipeline import kb as pkb
from spacy_ray_tpu_torch.pipeline.components.nel import pool_mentions
from spacy_ray_tpu_torch.training.loop import _named_params
from spacy_ray_tpu_torch.types import Padded

from test_torch_cnn_train import one_torch_thread  # noqa: F401  (the port on one thread)

REPO = Path(__file__).resolve().parent.parent
D = 16
CONTEXTS = [(["code", "in"], "Python", "Q_python_lang"),
            (["bite", "from"], "Python", "Q_python_snake"),
            (["compile", "some"], "Java", "Q_java_lang"),
            (["sail", "to"], "Java", "Q_java_island"),
            (["read", "about"], "Ruby Lane", "Q_ruby_lane")]

CFG = """
[nlp]
lang = "en"
pipeline = ["tok2vec","entity_linker"]

[components.tok2vec]
factory = "tok2vec"

[components.tok2vec.model]
@architectures = "spacy.HashEmbedCNN.v2"
width = 32
depth = 2
embed_size = 200
window_size = 1
maxout_pieces = 2
subword_features = true
pretrained_vectors = null

[components.entity_linker]
factory = "entity_linker"
n_candidates = 3

[components.entity_linker.model]
@architectures = "spacy.EntityLinker.v2"

[components.entity_linker.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32
"""


def _kb(mod):
    """Python and Java two candidates each; 'Ruby Lane' four, its gold
    (Q_ruby_lane) the lowest prior: past the top 3 at n_candidates 3."""
    rng = np.random.RandomState(0)
    kb = mod.KnowledgeBase(D)
    ents = ["Q_python_lang", "Q_python_snake", "Q_java_lang", "Q_java_island",
            "Q_ruby_a", "Q_ruby_b", "Q_ruby_c", "Q_ruby_lane"]
    for e in ents:
        kb.add_entity(e, freq=10.0, vector=rng.normal(size=D))
    kb.add_alias("Python", ["Q_python_lang", "Q_python_snake"], [0.6, 0.4])
    kb.add_alias("Java", ["Q_java_lang", "Q_java_island"], [0.7, 0.3])
    kb.add_alias("Ruby Lane", ["Q_ruby_a", "Q_ruby_b", "Q_ruby_c", "Q_ruby_lane"],
                 [0.4, 0.3, 0.2, 0.1])
    return kb


def _docs(mod, n, seed=0):
    """Docs of 1-4 mentions, each linked by the words before it; a mention
    without a kb_id now and then."""
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n):
        words, ents = ["I"], []
        for _ in range(rng.randint(1, 5)):
            pre, mention, ent = CONTEXTS[rng.randint(len(CONTEXTS))]
            words += pre
            start = len(words)
            words += mention.split()
            ents.append(mod.Span(start, len(words), "TOPIC",
                                 kb_id="" if rng.rand() < 0.1 else ent))
            words.append("today")
        docs.append(mod.Doc(words=words, ents=ents))
    return docs


class _J:
    Doc, Span, Example, KnowledgeBase = JDoc, JSpan, JExample, jkb.KnowledgeBase


class _P:
    Doc, Span, Example, KnowledgeBase = P.Doc, P.Span, P.Example, pkb.KnowledgeBase


def _jax_nlp(tmp_path=None, text=CFG):
    jnlp = J.Pipeline.from_config(J.Config.from_str(text))
    jnlp.components["entity_linker"].set_kb(_kb(jkb))
    jnlp.initialize(lambda: iter([JExample.from_gold(d) for d in _docs(_J, 16)]), seed=0)
    if tmp_path is not None:
        jnlp.to_disk(tmp_path)
    return jnlp


def _links(docs):
    return [[(e.start, e.end, e.label, e.kb_id) for e in d.ents] for d in docs]


def _shells(mod, docs):
    """Prediction shells holding the gold mentions (what an upstream NER sets)."""
    return [mod.Doc(words=list(d.words), ents=[mod.Span(e.start, e.end, e.label)
                                               for e in d.ents]) for d in docs]


# ------------------------------------------------------------ the KB


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kb_files_load_both_ways(writer, tmp_path):
    write, read = (pkb, jkb) if writer == "port" else (jkb, pkb)
    _kb(write).to_disk(tmp_path / "kb")  # the suffix-less name gets ".npz" both ways
    got = read.KnowledgeBase.from_disk(tmp_path / "kb")
    want = _kb(read)
    assert got.entities == want.entities and got.aliases == want.aliases
    assert got.entity_vector_length == D
    for alias in want.aliases + ["python", "unknown"]:
        a, b = got.candidates(alias), want.candidates(alias)
        assert [(c.entity, c.prior, c.freq) for c in a] == [(c.entity, c.prior, c.freq)
                                                            for c in b]
        assert all(np.array_equal(x.vector, y.vector) for x, y in zip(a, b))


def test_kb_refuses_as_jax():
    for mod in (pkb, jkb):
        kb = mod.KnowledgeBase(D)
        kb.add_entity("A", 1.0, np.zeros(D))
        with pytest.raises(ValueError, match="vector length"):
            kb.add_entity("B", 1.0, np.zeros(D + 1))
        with pytest.raises(ValueError, match="already in KB"):
            kb.add_entity("A", 1.0, np.zeros(D))
        with pytest.raises(ValueError, match="unknown entity"):
            kb.add_alias("x", ["missing"], [1.0])
        with pytest.raises(ValueError, match="sum"):
            kb.add_alias("x", ["A"], [1.5])


# ------------------------------------------------- targets and the loss


@pytest.mark.parametrize("use_gold_ents", [True, False])
def test_targets_match_jax_with_skipped_and_bucketed_mentions(use_gold_ents, tmp_path):
    jnlp = _jax_nlp(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    comps = (pnlp.components["entity_linker"], jnlp.components["entity_linker"])
    for comp in comps:
        comp.use_gold_ents = use_gold_ents
    batches = []
    for mod in (_P, _J):
        egs = [mod.Example.from_gold(d) for d in _docs(mod, 24, seed=3)]
        if not use_gold_ents:  # predicted: the gold mentions, every third doc's first one longer
            for i, eg in enumerate(egs):
                ents = [mod.Span(e.start, e.end, e.label) for e in eg.reference.ents]
                if i % 3 == 0:
                    ents[0] = mod.Span(ents[0].start, ents[0].end + 1, "TOPIC")
                eg.predicted = mod.Doc(words=list(eg.reference.words), ents=ents)
        batches.append(egs)
    # T 12 cuts the later mentions of long docs
    got = comps[0].make_targets(batches[0], 32, 12)
    want = comps[1].make_targets(batches[1], 32, 12)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    M = want["nel_mask"].shape[1]
    assert M >= 2 and M & (M - 1) == 0
    n_ruby = sum(e.kb_id == "Q_ruby_lane" for eg in batches[1] for e in eg.reference.ents)
    assert n_ruby > 0 and want["nel_mask"].sum() < sum(
        len(eg.reference.ents) for eg in batches[1])


def test_pool_mentions_is_the_span_mean():
    X = torch.randn(2, 7, 5, dtype=torch.float64)
    start = torch.tensor([[0, 2, 3], [6, 1, 0]])
    end = torch.tensor([[1, 5, 3], [7, 4, 1]])  # [3, 3) is empty: length 1
    got = pool_mentions(X, start, end)
    for b in range(2):
        for m in range(3):
            s, e = int(start[b, m]), int(end[b, m])
            want = X[b, s:e].sum(0) / max(e - s, 1)
            assert torch.allclose(got[b, m], want, atol=1e-12)


def test_loss_and_gradients_of_one_batch_match_jax(tmp_path):
    jnlp = _jax_nlp(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    jb = jnlp.collate([JExample.from_gold(d) for d in _docs(_J, 20, seed=5)])
    pb = pnlp.collate([P.Example.from_gold(d) for d in _docs(_P, 20, seed=5)],
                      with_targets=True)
    loss_fn = jnlp.make_loss_fn(dropout=0.0)
    jloss, jmetrics = jax.jit(loss_fn)(jnlp.params, jb["tokens"], jb["targets"],
                                       jax.random.PRNGKey(0))

    def port_loss_and_grads():
        pnlp.model.requires_grad_(True)
        params = _named_params(pnlp)
        for p in params.values():
            p.grad = None
        loss, metrics = pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
        loss.backward()
        pnlp.model.requires_grad_(False)
        return loss.detach(), metrics, {k: p.grad.numpy() for k, p in params.items()}

    ploss, pmetrics, _ = port_loss_and_grads()
    assert set(pmetrics) == set(jmetrics) == {"loss_entity_linker", "entity_linker_nel_acc"}
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(pmetrics["entity_linker_nel_acc"]) == float(jmetrics["entity_linker_nel_acc"])
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype=jnp.float64),
                                          jnlp.params)
        jgrads = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], jb["targets"],
                                                    jax.random.PRNGKey(0))[0]))(params64)
        jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    pnlp.model.double()
    pgrads = port_loss_and_grads()[2]
    assert set(pgrads) == set(jflat)
    assert "entity_linker/1_project/W" in pgrads
    for k, g in pgrads.items():
        np.testing.assert_allclose(g, jflat[k], rtol=0,
                                   atol=1e-4 * max(np.abs(jflat[k]).max(), 1e-30), err_msg=k)


# ------------------------------------------------------------ decode


@pytest.mark.parametrize("threshold,use_prior", [(0.0, True), (0.0, False), (0.6, True),
                                                 (0.99, False)])
def test_decode_gives_identical_kb_ids(threshold, use_prior, tmp_path):
    """The same projected rows decoded by both packages, with NIL for an
    unknown alias, under a threshold, and between near-tied candidates (two
    entities whose vectors differ in the last bit)."""
    jnlp = _jax_nlp(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    docs = {mod: _shells(mod, _docs(mod, 12, seed=9)) for mod in (_P, _J)}
    for mod in (_P, _J):
        docs[mod][0].ents.append(mod.Span(0, 1, "TOPIC"))  # "I": no candidates
        docs[mod].append(mod.Doc(words=["see", "Twin", "now"],
                                 ents=[mod.Span(1, 2, "TOPIC")]))
    base = np.random.RandomState(1).normal(size=D).astype(np.float32)
    twin = base.copy()
    twin[-1] = np.nextafter(twin[-1], np.float32(np.inf))
    for comp, mod in ((pnlp.components["entity_linker"], pkb),
                      (jnlp.components["entity_linker"], jkb)):
        comp.threshold, comp.use_prior = threshold, use_prior
        comp.kb.add_entity("Q_twin_1", 1.0, base)
        comp.kb.add_entity("Q_twin_2", 1.0, twin)
        comp.kb.add_alias("Twin", ["Q_twin_1", "Q_twin_2"], [0.5, 0.5])
    B, T = len(docs[_P]), 32
    X = np.random.RandomState(2).normal(size=(B, T, D)).astype(np.float32)
    X[-1, 1] = base * 3  # scores 3|base|^2 apart in the last bit
    lengths = [len(d) for d in docs[_P]]
    mask = np.arange(T)[None] < np.array(lengths)[:, None]
    pnlp.components["entity_linker"].set_annotations(
        docs[_P], Padded(torch.from_numpy(X), torch.from_numpy(mask)), lengths)
    jnlp.components["entity_linker"].set_annotations(
        docs[_J], JPadded(X=jnp.asarray(X), mask=jnp.asarray(mask)), lengths)
    got, want = _links(docs[_P]), _links(docs[_J])
    assert got == want
    kb_ids = [e[3] for d in got for e in d]
    assert "" in kb_ids and docs[_P][0].ents[-1].kb_id == ""
    if threshold < 0.5:
        assert any(k for k in kb_ids)


def test_model_forward_annotates_as_jax(tmp_path):
    jnlp = _jax_nlp(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    pdocs, jdocs = _shells(_P, _docs(_P, 20, seed=4)), _shells(_J, _docs(_J, 20, seed=4))
    pnlp.predict_docs(pdocs)
    jnlp.predict_docs(jdocs)
    assert _links(pdocs) == _links(jdocs)
    assert any(e[3] for d in _links(pdocs) for e in d)


def test_scores_equal_jax():
    comps = []
    for mod, pkg, kbmod in ((_P, P, pkb), (_J, J, jkb)):
        nlp = pkg.Pipeline.from_config(pkg.Config.from_str(CFG),
                                       **({"device": "cpu"} if pkg is P else {}))
        comps.append(nlp.components["entity_linker"])
    rng = np.random.RandomState(7)
    egs = {}
    for mod in (_P, _J):
        rng = np.random.RandomState(7)
        out = []
        for d in _docs(mod, 30, seed=8):
            pred = []
            for e in d.ents:  # right, wrong, NIL, shifted or missing
                r = rng.randint(5)
                if r == 0:
                    pred.append(mod.Span(e.start, e.end, e.label, kb_id=e.kb_id))
                elif r == 1:
                    pred.append(mod.Span(e.start, e.end, e.label, kb_id="Q_other"))
                elif r == 2:
                    pred.append(mod.Span(e.start, e.end, e.label))
                elif r == 3:
                    pred.append(mod.Span(e.start - 1, e.end, e.label, kb_id=e.kb_id))
            out.append(mod.Example(predicted=mod.Doc(words=list(d.words), ents=pred),
                                   reference=d))
        egs[mod] = out
    got, want = comps[0].score(egs[_P]), comps[1].score(egs[_J])
    assert got == want
    assert 0 < want["nel_micro_p"] < 1 and 0 < want["nel_micro_r"] < 1
    assert comps[0].score([]) == comps[1].score([])


# ------------------------------------------------- model directories


def test_model_dirs_with_the_kb_sidecar_load_both_ways(tmp_path):
    jnlp = _jax_nlp(tmp_path / "jax")
    jnlp.components["entity_linker"].threshold = 0.3
    jnlp.to_disk(tmp_path / "jax")
    assert (tmp_path / "jax" / "entity_linker.kb.npz").exists()
    pnlp = P.Pipeline.from_disk(tmp_path / "jax", device="cpu")
    comp = pnlp.components["entity_linker"]
    assert comp.table_data() == jnlp.components["entity_linker"].table_data()
    assert comp.kb.entities == jnlp.components["entity_linker"].kb.entities
    assert comp.model.dims["nO"] == D
    pnlp.to_disk(tmp_path / "port")
    again = J.Pipeline.from_disk(tmp_path / "port")
    data = json.loads((tmp_path / "port" / "components.json").read_text())
    assert data["entity_linker"] == jnlp.components["entity_linker"].table_data()
    for a, b in ((pnlp, jnlp), (pnlp, again)):
        pdocs, jdocs = _shells(_P, _docs(_P, 16, seed=6)), _shells(_J, _docs(_J, 16, seed=6))
        a.predict_docs(pdocs)
        b.predict_docs(jdocs)
        assert _links(pdocs) == _links(jdocs)


def test_a_linker_without_a_kb_raises_as_jax():
    for pkg, kw in ((P, {"device": "cpu"}), (J, {})):
        nlp = pkg.Pipeline.from_config(pkg.Config.from_str(CFG), **kw)
        with pytest.raises(ValueError, match="has no knowledge base"):
            nlp.initialize(seed=0)


# -------------------------------------------------- evaluate's seeding


@pytest.mark.parametrize("sets_ents", [False, True])
def test_evaluate_seeds_gold_mentions_unless_a_component_sets_ents(sets_ents, tmp_path):
    """use_gold_ents: evaluate's shells start with the gold boundaries
    (never kb_ids) when no component writes entities; when one does, none
    (mirrors tests/test_entity_linker.py)."""
    jnlp = _jax_nlp(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    dev = {mod: [mod.Example.from_gold(d) for d in _docs(mod, 10, seed=1)]
           for mod in (_P, _J)}
    for nlp in (pnlp, jnlp):
        nlp.components["tok2vec"].sets_ents = sets_ents
    try:
        got, want = pnlp.evaluate(dev[_P]), jnlp.evaluate(dev[_J])
    finally:
        for nlp in (pnlp, jnlp):
            nlp.components["tok2vec"].sets_ents = False
    assert got == want
    pred = [_links([eg.predicted])[0] for eg in dev[_P]]
    assert pred == [_links([eg.predicted])[0] for eg in dev[_J]]
    if sets_ents:
        assert not any(pred) and got["nel_micro_f"] == 0.0
    else:
        assert all(len(p) == len(eg.reference.ents) for p, eg in zip(pred, dev[_P]))
        assert got["nel_micro_f"] > 0


# -------------------------------------------- the JAX-written fixture


def test_committed_jax_nel_dir_links_as_jax_did():
    """tests/data/jax_nel (bin/make_jax_nel_fixture.py): the JAX package's
    own answers on a few dev docs, stored beside the model; the port loads
    the directory and gives the same kb_ids (chip_smoke.py serves it on
    the card)."""
    path = REPO / "tests" / "data" / "jax_nel"
    answers = json.loads((path / "answers.json").read_text())
    pnlp = P.Pipeline.from_disk(path, device="cpu")
    assert (path / "entity_linker.kb.npz").exists()
    docs = [pnlp.tokenizer(t) for t in answers["texts"]]
    pnlp.predict_docs(docs)
    got = [[[e.start, e.end, e.label, e.kb_id] for e in d.ents] for d in docs]
    assert got == answers["ents"]
    assert sum(bool(e[3]) for d in got for e in d) >= 5


def test_served_jax_nel_dir_answers_as_the_jax_server(tmp_path):
    """``POST /v1/parse`` over the JAX-written linker directory on the CPU:
    the port's server and the JAX package's give the same documents, each
    entity with its kb_id (``[start, end, label, kb_id]``)."""
    import urllib.request

    from spacy_ray_tpu.serving.engine import InferenceEngine as JEngine
    from spacy_ray_tpu.serving.server import Server as JServer
    from spacy_ray_tpu_torch.__main__ import build_server

    path = REPO / "tests" / "data" / "jax_nel"
    texts = json.loads((path / "answers.json").read_text())["texts"][:4]

    def post(port):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/parse",
                                     data=json.dumps({"texts": texts}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    server = build_server([str(path), "--device", "cpu", "--port", "0", "--max-batch", "4",
                           "--max-doc-len", "32"])
    jengine = JEngine(J.Pipeline.from_disk(path), max_batch_docs=4, max_doc_len=32)
    jserver = JServer(jengine, port=0)
    try:
        _, port = server.start()
        server.engine.start()
        _, jport = jserver.start()
        jengine.start()
        got, want = post(port), post(jport)
    finally:
        for s in (server, jserver):
            s.request_shutdown()
            s.wait()
    assert got["docs"] == want["docs"]
    ents = [e for d in got["docs"] for e in d.get("ents", [])]
    assert ents and all(len(e) == 4 and e[3].startswith("Q") for e in ents)
