"""Sourced, frozen and annotating components and ``[training.before_update]``
in the port against the JAX package, on the CPU (mirrors
``tests/test_sourcing.py`` and the annotating and ``before_update`` cases
of ``tests/test_training_contract.py``).

The pipeline is ``chip_smoke.nel_config`` sourcing the NER and the entity
ruler of the committed JAX-written ``tests/data/jax_md`` (copied, so a run
can delete its source) and training an entity linker over a HashEmbedCNN
of width 32, depth 1, embed_size 200, on a seeded pseudo-UD corpus of 40
docs with a KB from ``chip_smoke.nel_assets``. Both packages' train loops
run 6 steps of 3 batches an epoch on it. Tolerances: the linker's training
mentions per batch, the ``(step, epoch)`` calls and every frozen parameter
exact; three optimizer steps at L2 0.01 within 1e-6 of each leaf's max.
"""

import io
import shutil
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import spacy_ray_tpu as J
from spacy_ray_tpu.pipeline.components import nel as jnel
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training import optimizers as jopt
from spacy_ray_tpu.training.checkpoint import _flatten, _unflatten
from spacy_ray_tpu.training.loop import train as j_train

import chip_smoke
import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.pipeline.components import nel as pnel
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training.checkpoint import load_params
from spacy_ray_tpu_torch.training.loop import _named_params
from spacy_ray_tpu_torch.training.loop import train as p_train
from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin
from spacy_ray_tpu_torch.udgen import write_ud_jsonl

from test_torch_cnn_train import one_torch_thread  # noqa: F401  (the port on one thread)

REPO = Path(__file__).resolve().parent.parent
JAX_MD = REPO / "tests" / "data" / "jax_md"
SOURCED = ["ner", "entity_ruler"]
SMALL = {"width": 32, "depth": 1, "embed_size": 200, "sourced": SOURCED}
STEPS = 6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The udgen corpus, the KB and the linker's corpora, and a copy of
    tests/data/jax_md to source from."""
    d = tmp_path_factory.mktemp("nel")
    for split, n, seed in (("train", 40, 0), ("dev", 10, 1)):
        write_ud_jsonl(d / f"{split}.jsonl", n, seed=seed, max_sents=2)
        write_docbin(d / f"{split}.spacy", pcorpus.read_jsonl_docs(d / f"{split}.jsonl"))
    kb, paths, counts = chip_smoke.nel_assets((d / "train.spacy", d / "dev.spacy"), d / "nel",
                                              dim=16)
    shutil.copytree(JAX_MD, d / "source")
    return {"dir": d, "kb": kb, "paths": paths, "source": d / "source", "counts": counts}


def _config(pkg, data, annotating=("ner",), **training):
    cfg = chip_smoke.nel_config(data["paths"], data["source"], data["kb"], **SMALL)
    cfg["training"].update(max_steps=STEPS, eval_frequency=3, **training)
    cfg["training"]["annotating_components"] = list(annotating)
    cfg["training"]["batcher"]["size"] = 300
    if pkg is P:
        return cfg
    chip_smoke.register_step_recorder(J.registry)
    return J.Config.from_str(cfg.to_str())


def _recording(monkeypatch, cls, sink):
    """Record the linker's targets at every collate with targets."""
    make = cls.make_targets

    def recorded(self, examples, B, T):
        out = make(self, examples, B, T)
        sink.append({k: np.asarray(out[k]) for k in ("nel_start", "nel_end", "nel_mask",
                                                      "nel_gold")})
        return out

    monkeypatch.setattr(cls, "make_targets", recorded)


@pytest.fixture(scope="module", params=["ner", "entity_ruler"])
def runs(request, data, tmp_path_factory):
    """Both packages' train loops on the same config, with the linker's
    targets and the before_update calls recorded."""
    out = tmp_path_factory.mktemp(f"runs_{request.param}")
    mp = pytest.MonkeyPatch()
    got = {}
    try:
        for pkg, cls, run in ((P, pnel.EntityLinkerComponent, "port"),
                              (J, jnel.EntityLinkerComponent, "jax")):
            targets = []
            _recording(mp, cls, targets)
            chip_smoke.STEP_CALLS.clear()
            cfg = _config(pkg, data, annotating=(request.param,))
            with redirect_stdout(io.StringIO()):
                if pkg is P:
                    nlp, result = p_train(cfg, out / run, device="cpu", stdout_log=False)
                else:
                    nlp, result = j_train(cfg, out / run, n_workers=1, stdout_log=False)
            got[run] = {"nlp": nlp, "result": result, "targets": targets,
                        "calls": list(chip_smoke.STEP_CALLS), "out": out / run}
    finally:
        mp.undo()
    return got


def test_linker_mentions_per_batch_and_before_update_calls_equal_jax(runs):
    port, jax_run = runs["port"], runs["jax"]
    assert port["result"].final_step == jax_run["result"].final_step == STEPS
    assert len(port["targets"]) == len(jax_run["targets"]) == STEPS
    for a, b in zip(port["targets"], jax_run["targets"]):
        for k in b:
            assert np.array_equal(a[k], b[k]), k
    assert sum(int(t["nel_mask"].sum()) for t in port["targets"]) > 0
    # (step, epoch) before every update, as the JAX loop numbers them
    assert port["calls"] == jax_run["calls"]
    assert [s for s, _ in port["calls"]] == list(range(STEPS))
    assert port["calls"][-1][1] >= 1  # the run crossed an epoch


def test_sourced_components_stay_bit_equal_in_model_and_saves(runs, data):
    run = runs["port"]
    nlp, out = run["nlp"], run["out"]
    assert nlp.sourced_components == {n: str(data["source"]) for n in SOURCED}
    src = load_params(JAX_MD / "params.npz")
    paths = param_paths(nlp.model)
    frozen = sorted(k for k in paths if k.split("/")[0] in SOURCED)
    assert any(k.endswith("frozen_table") for k in frozen)
    saved = [load_params(out / "best-model" / "params.npz"),
             load_params(out / "last-model" / f"params-{STEPS}.npz")]
    for k in frozen:
        assert np.array_equal(paths[k].numpy(), src[k]), k
        assert all(np.array_equal(flat[k], src[k]) for flat in saved), k
    # the linker trained; the NER's and the ruler's labels and patterns came along
    init = P.Pipeline.from_config(_config(P, data).interpolate(), device="cpu")
    init.initialize(seed=0)
    assert not np.array_equal(paths["entity_linker/1_project/W"].numpy(),
                              param_paths(init.model)["entity_linker/1_project/W"].numpy())
    jsrc = J.Pipeline.from_disk(JAX_MD)
    assert nlp.components["ner"].labels == jsrc.components["ner"].labels
    assert nlp.components["entity_ruler"].table_data() == \
        jsrc.components["entity_ruler"].table_data()
    # K5's leaves hold the frozen components' (zero gradients), not the tables
    leaves = _named_params(nlp)
    assert any(k.startswith("ner/") for k in leaves)
    assert not any("frozen_table" in k for k in leaves)


def test_sourced_model_reloads_without_its_source_in_both(runs, data):
    out = runs["port"]["out"]
    shutil.rmtree(data["source"])
    try:
        pnlp = P.Pipeline.from_disk(out / "best-model", device="cpu")
        jnlp = J.Pipeline.from_disk(out / "best-model")
        assert "source" not in pnlp.config["components"]["ner"]
        texts = [" ".join(eg.reference.words) for eg in pcorpus.Corpus(data["paths"][1])()]
        pdocs = [pnlp.tokenizer(t) for t in texts]
        jdocs = [jnlp.tokenizer(t) for t in texts]
        pnlp.predict_docs(pdocs)
        jnlp.predict_docs(jdocs)
        links = [[(e.start, e.end, e.label, e.kb_id) for e in d.ents] for d in pdocs]
        assert links == [[(e.start, e.end, e.label, e.kb_id) for e in d.ents] for d in jdocs]
        assert any(e[3] for d in links for e in d)
    finally:
        shutil.copytree(JAX_MD, data["source"])


def test_frozen_leaves_take_no_gradient_and_decay_as_jax_at_l2(data, tmp_path):
    """JAX keeps a frozen component's leaves in its optax chain with a zero
    gradient (stop_gradient), so an L2 decay still moves them: the port does
    the same. One batch's loss leaves them without a gradient (out of
    autograd); three steps of Adam.v1 at L2 0.01 (decoupled) equal JAX's
    masked chain within 1e-6 of each leaf's max, and at L2 0 they stay
    bit-equal."""
    jnlp = J.Pipeline.from_config(_config(J, data).interpolate())
    jnlp.initialize(lambda: iter([]), seed=0)
    jnlp.to_disk(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    assert pnlp.frozen_components == SOURCED
    egs = list(pcorpus.Corpus(data["paths"][0])())[:8]
    for eg in egs:  # mentions from the gold entities, as an annotator would set them
        eg.predicted = P.Doc(words=list(eg.reference.words),
                             ents=[P.Span(e.start, e.end, e.label) for e in eg.reference.ents])
    batch = pnlp.collate(egs, with_targets=True)
    pnlp.requires_grad_(True)
    params = _named_params(pnlp)
    assert all(p.requires_grad == (k.split("/")[0] not in SOURCED) for k, p in params.items())
    loss, metrics = pnlp.loss(batch["tokens"], batch["targets"], dropout=0.0)
    loss.backward()
    assert {"loss_ner", "loss_entity_linker"} <= set(metrics)
    assert all((p.grad is None) == (k.split("/")[0] in SOURCED) for k, p in params.items())

    jflat0 = _flatten(jnlp.params)
    tables = [k for k in jflat0 if "frozen_" in k]
    for L2 in (0.01, 0.0):
        pnlp2 = P.Pipeline.from_disk(tmp_path, device="cpu")
        pnlp2.requires_grad_(True)
        params = _named_params(pnlp2)
        assert set(jflat0) - set(params) == set(tables)
        jparams = jnlp.params
        jtx = jopt.mask_frozen(jopt.Adam(learn_rate=0.001, L2=L2, L2_is_weight_decay=True),
                               jparams)
        jstate = jtx.init(jparams)
        opt = popt.Adam(learn_rate=0.001, L2=L2, L2_is_weight_decay=True)
        state = opt.init(params)
        rng = np.random.default_rng(3)
        for _ in range(3):
            g = {k: (np.zeros_like(v) if k.split("/")[0] in SOURCED
                     else rng.normal(size=v.shape).astype(np.float32) * 1e-2)
                 for k, v in jflat0.items()}
            jgrads = jax.tree_util.tree_map(jnp.asarray, _unflatten(g))
            upd, jstate = jtx.update(jgrads, jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            with torch.no_grad():
                opt.update(params, {k: torch.from_numpy(g[k]) for k in params}, state)
        jflat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
        moved = 0
        for k, p in params.items():
            scale = max(np.abs(jflat[k]).max(), 1e-30)
            assert np.abs(p.detach().numpy() - jflat[k]).max() <= 1e-6 * scale, k
            if k.split("/")[0] in SOURCED:
                moved += not np.array_equal(p.detach().numpy(), np.asarray(jflat0[k]))
        n_frozen = sum(k.split("/")[0] in SOURCED for k in params)
        assert moved == (n_frozen if L2 else 0)
        for k in tables:
            assert np.array_equal(param_paths(pnlp2.model)[k].numpy(), np.asarray(jflat0[k]))


def test_a_frozen_listener_still_trains_the_shared_trunk_as_in_jax(data, tmp_path):
    """JAX stops the gradient at a frozen component's parameters, not at its
    loss: with configs/sm.cfg's shared trunk trainable and its tagger frozen,
    the tagger's loss still trains the trunk. One batch's gradients, in
    float64 in both packages (maxout near-ties, as in test_torch_cnn_train)
    and dropout off, within 1e-4 x max |g| of JAX's, the tagger's none; the
    control: leaving the tagger's loss out moves the trunk's gradient far
    beyond that tolerance."""
    cfg = J.Config.from_disk(REPO / "configs" / "sm.cfg")
    cfg["paths"] = {"train": str(data["dir"] / "train.jsonl"),
                    "dev": str(data["dir"] / "dev.jsonl")}
    cfg["training"]["frozen_components"] = ["tagger"]
    jnlp = J.Pipeline.from_config(cfg.interpolate())
    egs = list(jcorpus.Corpus(data["dir"] / "train.jsonl")())
    jnlp.initialize(lambda: egs, seed=0)
    jnlp.to_disk(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    assert pnlp.frozen_components == ["tagger"]
    jb = jnlp.collate(egs[:12])
    pb = pnlp.collate(list(pcorpus.Corpus(data["dir"] / "train.spacy")())[:12],
                      with_targets=True)
    loss_fn = jnlp.make_loss_fn(dropout=0.0)
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype=jnp.float64),
                                          jnlp.params)

        def jax_grads(targets):
            g = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], targets,
                                                   jax.random.PRNGKey(0))[0]))(params64)
            return {k: np.asarray(v) for k, v in _flatten(g).items()}

        jflat = jax_grads(jb["targets"])
        without = jax_grads({k: v for k, v in jb["targets"].items() if k != "tagger"})
    pnlp.model.double()
    pnlp.requires_grad_(True)
    params = _named_params(pnlp)
    loss, metrics = pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
    loss.backward()
    pnlp.requires_grad_(False)
    assert {"loss_tagger", "loss_parser", "loss_ner"} <= set(metrics)
    assert set(params) == set(jflat)
    for k, p in params.items():
        frozen = k.startswith("tagger/")
        assert (p.grad is None) == frozen, k
        got = np.zeros_like(jflat[k]) if frozen else p.grad.numpy()
        np.testing.assert_allclose(got, jflat[k], rtol=0,
                                   atol=1e-4 * max(np.abs(jflat[k]).max(), 1e-30), err_msg=k)
        assert not frozen or not jflat[k].any()
    trunk = [k for k in jflat if k.startswith("tok2vec/")]
    assert trunk and min(np.abs(jflat[k] - without[k]).max() / np.abs(jflat[k]).max()
                         for k in trunk) > 1e-2


# ------------------------------------------------------------ refusals


def _both(data, edit):
    """``edit(config)`` applied to each package's config; returns them."""
    out = []
    for pkg in (P, J):
        cfg = _config(pkg, data)
        edit(cfg)
        out.append((pkg, cfg))
    return out


def _from_config(pkg, cfg):
    cfg = cfg.interpolate()
    return (P.Pipeline.from_config(cfg, device="cpu") if pkg is P
            else J.Pipeline.from_config(cfg))


@pytest.mark.parametrize("case", ["extra_keys", "unknown_name", "width"])
def test_bad_sources_are_refused_as_in_jax(case, data):
    def edit(cfg):
        comps = cfg["components"]
        if case == "extra_keys":
            comps["ner"]["factory"] = "ner"
        elif case == "unknown_name":
            cfg["nlp"]["pipeline"] = ["tagger2"] + cfg["nlp"]["pipeline"]
            comps["tagger2"] = {"source": str(data["source"])}
        else:  # the source's trunk is 32 wide; a new tagger listens at 64
            cfg["nlp"]["pipeline"] = ["tok2vec", "tagger"] + cfg["nlp"]["pipeline"]
            comps["tok2vec"] = {"source": str(data["source"])}
            comps["tagger"] = {"factory": "tagger", "model": {
                "@architectures": "spacy.Tagger.v2",
                "tok2vec": {"@architectures": "spacy.Tok2VecListener.v1", "width": 64}}}

    match = {"extra_keys": "mixes source", "unknown_name": "has no component 'tagger2'",
             "width": "expects tok2vec width 64 but the pipeline trunk 'tok2vec' produces 32"}
    for pkg, cfg in _both(data, edit):
        with pytest.raises(ValueError, match=match[case]):
            nlp = _from_config(pkg, cfg)
            nlp.initialize(lambda: iter([]), seed=0)


def test_a_second_different_vectors_table_is_refused_as_in_jax(data, tmp_path):
    other = tmp_path / "other"
    shutil.copytree(data["source"], other)
    with np.load(other / "vectors.npz") as f:
        arrays = dict(f)
    arrays["vectors"] = arrays["vectors"] + 1.0
    np.savez(other / "vectors.npz", **arrays)

    def edit(cfg):
        cfg["components"]["entity_ruler"] = {"source": str(other)}

    for pkg, cfg in _both(data, edit):
        with pytest.raises(ValueError, match="different vectors table"):
            _from_config(pkg, cfg)


@pytest.mark.parametrize("key,name,hint", [("frozen_components", "nerr", "ner"),
                                           ("annotating_components", "entity_rulr",
                                            "entity_ruler")])
def test_unknown_component_lists_raise_the_jax_message(key, name, hint, data, tmp_path):
    msgs = []
    for pkg in (P, J):
        cfg = _config(pkg, data)
        cfg["training"][key] = [name]
        with pytest.raises(ValueError) as e:
            if pkg is P:
                p_train(cfg, None, device="cpu", stdout_log=False)
            else:
                j_train(cfg, None, n_workers=1, stdout_log=False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert f"[training] {key} names {name!r} — did you mean {hint!r}?" in msgs[0]


@pytest.mark.parametrize("case", ["no_annotator", "before_update_not_callable"])
def test_training_refusals_equal_jax(case, data):
    msgs = []
    for pkg in (P, J):
        cfg = _config(pkg, data)
        if case == "no_annotator":
            cfg["training"]["annotating_components"] = []
        else:
            cfg["training"]["before_update"] = {"some_key": 1}
        with pytest.raises(ValueError) as e:
            if pkg is P:
                p_train(cfg, None, device="cpu", stdout_log=False)
            else:
                j_train(cfg, None, n_workers=1, stdout_log=False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("use_gold_ents = false" if case == "no_annotator"
            else "must resolve to a callable") in msgs[0]
