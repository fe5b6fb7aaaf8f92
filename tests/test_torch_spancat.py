"""The port's span categorizer and configs/spancat.cfg (tok2vec + spancat +
textcat_multilabel) on the CPU against the JAX package: the pooling and
loss ops with their gradients (ties and all-padding rows included), the
span grid and representations, the suggesters, one batch's loss and every
leaf's gradient with carried weights, the ``train`` loops' dev scores, the
decodes and scores of either package's model directory in the other, the
commands a user runs, and the synthetic corpora.

Tolerances: the loss (float32) within 1e-5 relative; each leaf's gradient
within 1e-4 of its max |g|, computed in float64 by both packages, dropout
off; op values within 1e-6 and their gradients within 1e-6 (float32) or
1e-12 (float64); decodes identical (the same spans in the same order), cats
within 1e-5; scores equal; the loops' dev scores within 5 points (initial
weights differ).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu.ops import ops as JO
from spacy_ray_tpu.pipeline.components import spancat as jspancat
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.training.loop import train as j_train
from spacy_ray_tpu.util import write_synth_jsonl as j_write_synth

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.__main__ import main as p_main
from spacy_ray_tpu_torch.ops import ops as PO
from spacy_ray_tpu_torch.pipeline.components import spancat as pspancat
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training.loop import train as p_train
from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin
from spacy_ray_tpu_torch.util import write_synth_jsonl as p_write_synth

from test_torch_cnn_train import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    _assert_grads_close, _port_loss_and_grads, one_torch_thread,
)

REPO = Path(__file__).resolve().parent.parent
#: spancat.cfg cut as tests/test_spacy_docbin.py cuts it
CUT = {"width": 32, "depth": 1, "embed_size": 256}


def interleave(paths, out):
    """The docs of the .jsonl files at ``paths`` taken in turn into ``out``."""
    columns = [Path(p).read_text(encoding="utf8").splitlines() for p in paths]
    Path(out).write_text("".join(f"{line}\n" for row in zip(*columns) for line in row),
                         encoding="utf8")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Span docs and cat docs in turn (spancat learns from the first,
    textcat_multilabel from the second), as .jsonl and as .spacy."""
    d = tmp_path_factory.mktemp("spancat_data")
    for split, n, seed in (("train", 80, 0), ("dev", 24, 2)):
        j_write_synth(d / f"{split}_sc.jsonl", n, kind="spancat", seed=seed)
        j_write_synth(d / f"{split}_cat.jsonl", n, kind="textcat", seed=seed + 1)
        interleave([d / f"{split}_sc.jsonl", d / f"{split}_cat.jsonl"], d / f"{split}.jsonl")
        write_docbin(d / f"{split}.spacy", pcorpus.read_jsonl_docs(d / f"{split}.jsonl"))
    return d


def spancat_cfg(pkg, data, suffix=".jsonl", **training):
    cfg = pkg.Config.from_disk(REPO / "configs" / "spancat.cfg")
    cfg["paths"] = {"train": str(data / f"train{suffix}"), "dev": str(data / f"dev{suffix}")}
    cfg["components"]["tok2vec"]["model"].update(CUT)
    for head in ("spancat", "textcat_multilabel"):
        cfg["components"][head]["model"]["tok2vec"]["width"] = CUT["width"]
    cfg["training"].update(training)
    return cfg


# ------------------------------------------------------------------- ops


def _tied_inputs(rng, shape):
    """Small integers: many exact ties inside every max."""
    return rng.integers(-2, 3, size=shape).astype(np.float32)


def _jax_value_and_grad(fn, *arrays, dtype):
    with jax.enable_x64(dtype == np.float64):
        args = [jnp.asarray(a) for a in arrays]
        out, vjp = jax.vjp(fn, args[0])
        ct = jnp.asarray(np.random.default_rng(9).normal(size=out.shape).astype(dtype))
        return np.asarray(out), np.asarray(vjp(ct)[0]), np.asarray(ct)


def _port_value_and_grad(fn, x, ct):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    out.backward(torch.tensor(ct))
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", ["max_pool", "mean_pool"])
def test_pools_and_their_gradients_match_jax(op, dtype):
    rng = np.random.default_rng(0)
    X = _tied_inputs(rng, (5, 7, 4)).astype(dtype)
    mask = rng.random((5, 7)) < 0.6
    mask[1] = False  # an all-padding row pools to 0
    mask[2] = True
    jfn, pfn = getattr(JO, op), getattr(PO, op)
    jout, jgrad, ct = _jax_value_and_grad(lambda x: jfn(x, jnp.asarray(mask)), X, dtype=dtype)
    pout, pgrad = _port_value_and_grad(lambda x: pfn(x, torch.from_numpy(mask)), X, ct)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(pout, jout, rtol=0, atol=tol)
    np.testing.assert_allclose(pgrad, jgrad, rtol=0, atol=tol)
    assert not pout[1].any() and not pgrad[1].any()
    if op == "max_pool":  # ties split the cotangent: some gradient is fractional
        assert np.any((pgrad != np.round(pgrad)) & (pgrad != 0))


@pytest.mark.parametrize("mask_kind", ["rows", "spans", "none", "empty"])
def test_masked_sigmoid_bce_and_its_gradient_match_jax(mask_kind):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 6, 4)) * 4).astype(np.float32)
    labels = (rng.random((3, 6, 4)) < 0.3).astype(np.float32)
    mask = {"rows": rng.random(3) < 0.7, "spans": rng.random((3, 6)) < 0.5,
            "none": None, "empty": np.zeros((3, 6), bool)}[mask_kind]
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    jval, jgrad = jax.value_and_grad(
        lambda x: JO.masked_sigmoid_bce(x, jnp.asarray(labels), jm))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    pval = PO.masked_sigmoid_bce(x, torch.from_numpy(labels), pm)
    pval.backward()
    assert abs(pval.item() - float(jval)) <= 1e-6 * max(abs(float(jval)), 1.0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-7)
    if mask_kind == "spans":  # the denominator is valid rows x labels
        per = (np.maximum(logits, 0) - logits * labels
               + np.log1p(np.exp(-np.abs(logits)))) * mask[..., None]
        assert pval.item() == pytest.approx(per.sum() / (mask.sum() * 4), rel=1e-6)


def test_span_grid_and_span_reprs_match_jax():
    assert pspancat.span_grid(7, [1, 2, 3]) == jspancat.span_grid(7, [1, 2, 3])
    assert pspancat.span_grid(2, [1, 3]) == jspancat.span_grid(2, [1, 3]) == [(0, 1), (1, 1)]
    X = _tied_inputs(np.random.default_rng(2), (3, 6, 5))
    for sizes in ([1, 2, 3], [2, 4], [1, 7]):
        jout, jgrad, ct = _jax_value_and_grad(lambda x: jspancat.span_reprs(x, sizes), X,
                                              dtype=np.float32)
        pout, pgrad = _port_value_and_grad(lambda x: pspancat.span_reprs(x, sizes), X, ct)
        assert pout.shape == jout.shape == (3, len(pspancat.span_grid(6, sizes)), 10)
        np.testing.assert_allclose(pout, jout, rtol=0, atol=1e-6)
        np.testing.assert_allclose(pgrad, jgrad, rtol=0, atol=1e-5)


@pytest.mark.parametrize("block", [
    {"@misc": "spacy.ngram_suggester.v1", "sizes": [1, 2, 3]},
    {"@misc": "spacy.ngram_suggester.v1", "sizes": [2, 5]},
    {"@misc": "spacy.ngram_range_suggester.v1", "min_size": 1, "max_size": 4},
    {"@misc": "spacy.ngram_range_suggester.v1", "min_size": 2},
])
def test_suggesters_resolve_as_in_jax(block):
    assert P.registry.resolve(dict(block)) == J.registry.resolve(dict(block))


@pytest.mark.parametrize("bad", [{"min_size": 0}, {"min_size": 3, "max_size": 2}])
def test_range_suggester_refuses_what_jax_refuses(bad):
    block = {"@misc": "spacy.ngram_range_suggester.v1", **bad}
    with pytest.raises(ValueError) as jerr:
        J.registry.resolve(dict(block))
    with pytest.raises(ValueError, match=str(jerr.value)):
        P.registry.resolve(dict(block))


# ---------------------------------------------------- one batch, carried


@pytest.fixture(scope="module")
def carried(data, tmp_path_factory):
    """spancat.cfg (cut) initialized by JAX on the corpus, loaded by the
    port from its model directory; the same 12 docs collated by both."""
    jnlp = J.Pipeline.from_config(spancat_cfg(J, data).interpolate())
    egs = list(jcorpus.Corpus(data / "train.jsonl")())
    jnlp.initialize(lambda: egs, seed=0)
    model_dir = tmp_path_factory.mktemp("spancat_carried")
    jnlp.to_disk(model_dir)
    pnlp = P.Pipeline.from_disk(model_dir, device="cpu")
    jb = jnlp.collate(egs[:12])
    pb = pnlp.collate(list(pcorpus.Corpus(data / "train.spacy")())[:12], with_targets=True)
    return jnlp, pnlp, jb, pb


def test_targets_and_param_paths_match_jax(carried):
    jnlp, pnlp, jb, pb = carried
    for head, t in jb["targets"].items():
        for key, v in t.items():
            assert np.array_equal(np.asarray(v), pb["targets"][head][key].numpy()), (head, key)
    # a cat doc gives spancat negatives only; a span doc gives no cat target
    assert pb["targets"]["spancat"]["span_mask"][1].any()
    assert not pb["targets"]["spancat"]["span_target"][1].any()
    assert not pb["targets"]["textcat_multilabel"]["cats_mask"][0]
    jshapes = {k: tuple(v.shape) for k, v in _flatten(jnlp.params).items()}
    pshapes = {k.replace(".", "/"): tuple(v.shape) for k, v in pnlp.model.state_dict().items()}
    assert jshapes == pshapes
    assert {k for k in pshapes if not k.startswith("tok2vec/")} == {
        "spancat/hidden_W", "spancat/hidden_b", "spancat/out_W", "spancat/out_b",
        "textcat_multilabel/W", "textcat_multilabel/b"}
    assert pshapes["spancat/hidden_W"] == (64, 128)
    assert pshapes["textcat_multilabel/W"] == (64, 3)


def test_loss_and_gradients_of_one_batch_match_jax(carried):
    jnlp, pnlp, jb, pb = carried
    loss_fn = jnlp.make_loss_fn(dropout=0.0)
    jloss, jmetrics = jax.jit(loss_fn)(jnlp.params, jb["tokens"], jb["targets"],
                                       jax.random.PRNGKey(0))
    ploss, pmetrics, _ = _port_loss_and_grads(pnlp, pb)
    assert set(pmetrics) == set(jmetrics) == {"loss_spancat", "loss_textcat_multilabel"}
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for key, v in jmetrics.items():
        assert abs(float(pmetrics[key]) - float(v)) <= 1e-5 * abs(float(v)), key
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype=jnp.float64),
                                          jnlp.params)
        jgrads = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], jb["targets"],
                                                    jax.random.PRNGKey(0))[0]))(params64)
        jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    pnlp.model.double()
    try:
        _assert_grads_close(_port_loss_and_grads(pnlp, pb)[2], jflat, 18, np.float64)
    finally:
        pnlp.model.float()


# ------------------------------------------------- the loops and decodes


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """Both ``train`` loops on spancat.cfg (cut; 90 steps, where both loops'
    spans_sc_f have left the steep part of their curves)."""
    out = tmp_path_factory.mktemp("spancat_loops")
    kw = dict(max_steps=90, eval_frequency=45)
    _, presult = p_train(spancat_cfg(P, data, ".spacy", **kw), out / "port", device="cpu",
                         stdout_log=False)
    _, jresult = j_train(spancat_cfg(J, data, **kw), out / "jax", n_workers=1,
                         stdout_log=False)
    return out, presult, jresult


def test_port_loop_reaches_the_jax_loop_dev_scores(trained):
    _, presult, jresult = trained
    assert [h["step"] for h in presult.history] == [h["step"] for h in jresult.history] == [45, 90]
    for key in ("spans_sc_f", "cats_micro_f"):
        p, j = (r.history[-1]["other_scores"][key] for r in (presult, jresult))
        assert abs(p - j) <= 0.05, (key, p, j)
    assert presult.history[-1]["other_scores"]["cats_micro_f"] > 0.7
    assert presult.history[-1]["other_scores"]["spans_sc_f"] > 0.5
    for head in ("spancat", "textcat_multilabel"):
        losses = [s[head] for s in presult.step_head_losses]
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 2 / 3, head


def _docs(pkg, data):
    return [pkg.Doc(words=list(eg.reference.words))
            for eg in pcorpus.Corpus(data / "dev.spacy")()]


@pytest.mark.parametrize("trained_by", ["port", "jax"])
def test_model_dir_decodes_and_scores_identically_in_both(trained_by, trained, data):
    out = trained[0]
    model_dir = out / trained_by / "best-model"
    jnlp = J.Pipeline.from_disk(model_dir)
    pnlp = P.Pipeline.from_disk(model_dir, device="cpu")
    jdocs, pdocs = _docs(J, data), _docs(P, data)
    jnlp.predict_docs(jdocs)
    pnlp.predict_docs(pdocs)
    n_spans = 0
    for jd, pd in zip(jdocs, pdocs):
        assert [tuple(s) for s in pd.spans["sc"]] == [tuple(s) for s in jd.spans["sc"]]
        n_spans += len(pd.spans["sc"])
        assert list(pd.cats) == list(jd.cats) == ["FOOD", "SPORTS", "TECH"]
        np.testing.assert_allclose([pd.cats[k] for k in pd.cats],
                                   [jd.cats[k] for k in jd.cats], rtol=0, atol=1e-5)
    assert n_spans > 10
    jscores = jnlp.evaluate(list(jcorpus.Corpus(data / "dev.jsonl")()))
    pscores = pnlp.evaluate(list(pcorpus.Corpus(data / "dev.spacy")()))
    assert pscores == jscores
    assert {"spans_sc_per_type", "cats_macro_auc", "cats_f_per_type"} <= set(pscores)


def _scored_examples(pkg, gold_docs, rng_seed):
    """Gold docs of both kinds with predictions drawn around the gold."""
    rng = np.random.default_rng(rng_seed)
    egs = []
    for g in gold_docs:
        gold = pkg.Doc(words=list(g.words))
        gold.spans = {k: [pkg.Span(s.start, s.end, s.label) for s in v]
                      for k, v in g.spans.items()}
        gold.cats = dict(g.cats)
        pred = pkg.Doc(words=list(g.words))
        if "sc" in g.spans:
            pred.spans["sc"] = [pkg.Span(s.start, s.end, s.label) for s in g.spans["sc"]
                                if rng.random() < 0.7] + [pkg.Span(0, 1, "ORG")]
        if g.cats:
            pred.cats = {k: float(np.clip(v + rng.normal(scale=0.4), 0, 1))
                         for k, v in g.cats.items()}
        egs.append(pkg.Example(predicted=pred, reference=gold))
    return egs


@pytest.mark.parametrize("exclusive", [False, True])
def test_scores_of_the_same_predictions_match_jax(exclusive, data, carried):
    jnlp, pnlp = carried[:2]
    gold = [eg.reference for eg in pcorpus.Corpus(data / "dev.spacy")()]
    unannotated = {"spancat": [d for d in gold if "sc" not in d.spans],
                   "textcat_multilabel": [d for d in gold if not d.cats]}
    jt, pt = jnlp.components["textcat_multilabel"], pnlp.components["textcat_multilabel"]
    jt.exclusive = pt.exclusive = exclusive
    try:
        for name, bare in unannotated.items():
            jc, pc = jnlp.components[name], pnlp.components[name]
            ps = pc.score(_scored_examples(P, gold, 4))
            assert ps == jc.score(_scored_examples(J, gold, 4)), name
            assert all(v is not None for v in ps.values())
            assert ("cats_acc" in ps) == (exclusive and name != "spancat")
            # no gold annotation at all: every key None, as in JAX
            ps = pc.score(_scored_examples(P, bare, 4))
            assert ps == jc.score(_scored_examples(J, bare, 4)), name
            assert bare and all(v is None for v in ps.values())
    finally:
        jt.exclusive = pt.exclusive = False


def test_decode_order_threshold_and_max_positive(carried):
    """Labels over the threshold by (probability, label) descending, cut at
    max_positive, grid order outside; an empty result still sets the key."""
    jnlp, pnlp = carried[:2]
    jc, pc = jnlp.components["spancat"], pnlp.components["spancat"]
    labels = pc.labels  # GPE, ORG, PERSON
    rng = np.random.default_rng(5)
    probs = rng.choice([0.2, 0.5, 0.7, 0.9], size=(2, len(pspancat.span_grid(6, [1, 2, 3])),
                                                    len(labels))).astype(np.float32)
    probs[:, 3] = 0.7  # one span with three tied labels
    for threshold, max_positive in ((0.5, None), (0.6, 2), (0.95, 1)):
        jc.threshold = pc.threshold = threshold
        jc.max_positive = pc.max_positive = max_positive
        jdocs = [J.Doc(words=["w"] * n) for n in (6, 4)]
        pdocs = [P.Doc(words=["w"] * n) for n in (6, 4)]
        jc.set_annotations(jdocs, {"probs": probs}, [6, 4])
        pc.set_annotations(pdocs, {"probs": torch.from_numpy(probs)}, [6, 4])
        for jd, pd in zip(jdocs, pdocs):
            assert "sc" in pd.spans
            assert [tuple(s) for s in pd.spans["sc"]] == [tuple(s) for s in jd.spans["sc"]]
    assert [s.label for s in pdocs[0].spans["sc"]] == []
    jc.threshold = pc.threshold = 0.5
    jc.max_positive = pc.max_positive = None


# ----------------------------------------------------- entry points


def test_spancat_cfg_trains_evaluates_and_serves_through_the_entry_points(
        data, tmp_path, capsys):
    out = tmp_path / "out"
    overrides = [f"--components.tok2vec.model.{k}={v}" for k, v in CUT.items()] + [
        f"--components.{h}.model.tok2vec.width={CUT['width']}"
        for h in ("spancat", "textcat_multilabel")]
    assert p_main(["train", str(REPO / "configs" / "spancat.cfg"), "--output", str(out),
                   "--device", "cpu", "--paths.train", str(data / "train.spacy"),
                   "--paths.dev", str(data / "dev.spacy"), "--training.max_steps", "8",
                   "--training.eval_frequency", "4", *overrides]) == 0
    assert "Done. steps=8" in capsys.readouterr().out
    assert p_main(["evaluate", str(out / "best-model"), str(data / "dev.spacy"),
                   "--device", "cpu"]) == 0
    scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"spans_sc_f", "cats_micro_f", "cats_macro_auc", "spans_sc_per_type"} <= set(scores)
    import urllib.request

    from spacy_ray_tpu_torch.__main__ import build_server

    server = build_server([str(out / "best-model"), "--device", "cpu", "--port", "0",
                           "--max-batch", "4", "--max-doc-len", "32"])
    _, port = server.start()
    server.engine.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/parse",
            data=json.dumps({"texts": ["Alice Smith eats ham in Paris", "team win"]}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            docs = json.loads(r.read())["docs"]
    finally:
        server.request_shutdown()
        assert server.wait() == 0
    for d in docs:
        assert set(d["cats"]) == {"FOOD", "SPORTS", "TECH"}
        assert all(0 <= s < e <= len(d["tokens"]) for s, e, _ in d.get("spans", {}).get("sc", []))


@pytest.mark.parametrize("kind", ["tagger", "ner", "textcat", "spancat"])
def test_synthetic_corpora_are_written_byte_equal(kind, tmp_path):
    j_write_synth(tmp_path / "j.jsonl", 50, kind=kind, seed=7)
    p_write_synth(tmp_path / "p.jsonl", 50, kind=kind, seed=7)
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
