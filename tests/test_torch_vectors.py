"""The port's static vectors and spaCy's md pipeline layout against the JAX
package, on the CPU: the ``Vectors`` asset and ``init-vectors``,
``StaticVectors`` and ``MultiHashEmbed`` with vectors, the cached vector
rows of ``collate``, one md batch's loss and gradients, the frozen tables
under the optimizer, and md model directories both ways.

The md layout is ``chip_smoke.md_config`` cut to width 32, depth 2, tables
of 500/100/250/250 rows and hidden 32, over 500 x 24 vectors made from a
seed, on a seeded pseudo-UD corpus of 60 docs. Tolerances: the vectors,
the npz files and the rows exact; forwards within 1e-5 and the loss within
1e-5 relative (float32); gradients within 1e-4 x max |g| per leaf in
float64; three optimizer steps within 1e-6 of each leaf's max; decoded
annotations identical.
"""

import gzip
import io
import zipfile
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import spacy_ray_tpu as J
from spacy_ray_tpu import cli as jcli
from spacy_ray_tpu.models import core as jcore
from spacy_ray_tpu.models import layers as jlayers
from spacy_ray_tpu.models import tok2vec as jt2v
from spacy_ray_tpu.pipeline import vectors as jvectors
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training import optimizers as jopt
from spacy_ray_tpu.training.checkpoint import _flatten, _unflatten
from spacy_ray_tpu.types import TokenBatch as JTokenBatch

import chip_smoke
import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.__main__ import main as pcli
from spacy_ray_tpu_torch.models import layers as players
from spacy_ray_tpu_torch.models import tok2vec as pt2v
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.pipeline import vectors as pvectors
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training.checkpoint import load_params
from spacy_ray_tpu_torch.training.loop import _named_params
from spacy_ray_tpu_torch.training.loop import train as p_train
from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin
from spacy_ray_tpu_torch.udgen import write_ud_jsonl

from test_torch_cnn_train import one_torch_thread  # noqa: F401  (the port on one thread)

REPO = Path(__file__).resolve().parent.parent
SMALL = {"width": 32, "depth": 2, "rows": (500, 100, 250, 250), "hidden": 32}
FROZEN = ("tok2vec/0_multi_hash_embed/0_embeds/4_static_vectors/frozen_table",
          "ner/tok2vec/0_multi_hash_embed/0_embeds/4_static_vectors/frozen_table")


@pytest.fixture(scope="module")
def md(tmp_path_factory):
    """A pseudo-UD corpus (.jsonl and .spacy), 500 x 24 vectors made from a
    seed through the port's init-vectors, the rule patterns from the corpus."""
    d = tmp_path_factory.mktemp("md")
    for split, n, seed in (("train", 60, 0), ("dev", 20, 1)):
        write_ud_jsonl(d / f"{split}.jsonl", n, seed=seed, max_sents=2)
        write_docbin(d / f"{split}.spacy", pcorpus.read_jsonl_docs(d / f"{split}.jsonl"))
    with redirect_stdout(io.StringIO()):
        vectors, attr, ents, counts = chip_smoke.md_assets(d / "train.spacy", d, rows=500,
                                                           dim=24)
    # the table reaches every branch of a lookup: exact, lower case, none
    assert counts["types_lower_case_fallback"] > 0 and counts["types_without_a_vector"] > 0
    return {"dir": d, "vectors": vectors, "attr": attr, "ents": ents}


def _config(pkg, md, **training):
    cfg = chip_smoke.md_config((md["dir"] / "train.spacy", md["dir"] / "dev.spacy"),
                               md["vectors"], md["attr"], md["ents"], **SMALL)
    cfg["training"].update(training)
    return cfg if pkg is P else J.Config.from_str(cfg.to_str())


def _jax_initialized(md, model_dir=None):
    jnlp = J.Pipeline.from_config(_config(J, md).interpolate())
    egs = list(jcorpus.Corpus(md["dir"] / "train.spacy")())
    jnlp.initialize(lambda: egs, seed=0)
    if model_dir is not None:
        jnlp.to_disk(model_dir)
    return jnlp


def _annotations(docs):
    return [(d.tags, d.pos, d.lemmas, d.heads, d.deps,
             [(e.start, e.end, e.label) for e in d.ents]) for d in docs]


def _annotate_both(pnlp, jnlp, path):
    """The same gold texts annotated by each package."""
    pdocs = [eg.reference.copy_shell() for eg in pcorpus.Corpus(path)()]
    jdocs = [eg.reference.copy_shell() for eg in jcorpus.Corpus(path)()]
    pnlp.predict_docs(pdocs)
    jnlp.predict_docs(jdocs)
    return _annotations(pdocs), _annotations(jdocs)


# ------------------------------------------------------------ the asset


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vectors_round_trip_between_the_packages(writer, tmp_path):
    rng = np.random.default_rng(0)
    words = ["the", "The", "cat", "the", "Paris", "paris", "dog", "cat", "Émile"]
    table = rng.normal(size=(len(words), 6)).astype(np.float32)
    write, read = ((pvectors, jvectors) if writer == "port" else (jvectors, pvectors))
    src = write.Vectors(words, table)
    assert len(src) == 7  # the second "the" and "cat" are dropped, the first kept
    src.to_disk(tmp_path / "v.npz")
    got = read.Vectors.from_disk(tmp_path / "v.npz")
    assert got.key_to_row == src.key_to_row
    assert np.array_equal(got.table, src.table) and got.table.dtype == np.float32
    assert got.table[got.row_of("cat")].tolist() == table[2].tolist()
    queries = ["the", "The", "THE", "Cat", "PARIS", "Paris", "DOG", "bird", "", "émile"]
    assert got.rows_of(queries).tolist() == src.rows_of(queries).tolist()
    assert got.rows_of(queries).tolist() == [0, 1, 0, 2, 4, 3, 5, -1, -1, -1]


def _member_bytes(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("kind", ["word2vec", "glove", "gz", "npz", "truncate"])
def test_init_vectors_writes_the_npz_jax_writes(kind, tmp_path):
    rng = np.random.default_rng(1)
    words = ["the", "cat", "The", "sat", "cat", "mat", "Émile", "3.5"]
    table = rng.normal(size=(len(words), 5)).astype(np.float32)
    lines = [w + " " + " ".join(f"{x:.6f}" for x in row) for w, row in zip(words, table)]
    header = [f"{len(words)} 5"] if kind in ("word2vec", "truncate", "gz") else []
    src = tmp_path / {"gz": "in.txt.gz", "npz": "in.npz"}.get(kind, "in.txt")
    if kind == "gz":
        with gzip.open(src, "wt", encoding="utf8") as f:
            f.write("\n".join(header + lines) + "\n")
    elif kind == "npz":
        jvectors.Vectors(words, table).to_disk(src)
    else:
        src.write_text("\n".join(header + lines) + "\n\n", encoding="utf8")
    extra = ["--truncate", "4"] if kind == "truncate" else []
    runs = []
    for name, cli in (("port", lambda a: pcli(["init-vectors", *a])),
                      ("jax", lambda a: jcli.main(["init-vectors", *a]))):
        out = tmp_path / f"{name}.npz"
        rc, said, _ = _run(cli, [str(src), str(out), *extra])
        assert rc == 0
        runs.append((said.replace(str(out), "<out>"), _member_bytes(out)))
    assert runs[0] == runs[1]
    got = pvectors.Vectors.from_disk(tmp_path / "port.npz")
    assert len(got) == (4 if kind == "truncate" else 7)


@pytest.mark.parametrize("text", ["", "the 1 2 3\ncat 4 5\n"], ids=["empty", "widths"])
def test_init_vectors_refuses_as_jax(text, tmp_path):
    src = tmp_path / "in.txt"
    src.write_text(text, encoding="utf8")
    runs = [_run(cli, [str(src), str(tmp_path / "out.npz")])
            for cli in (lambda a: pcli(["init-vectors", *a]),
                        lambda a: jcli.main(["init-vectors", *a]))]
    assert runs[0] == runs[1] and runs[0][0] == 1 and runs[0][2]
    assert not (tmp_path / "out.npz").exists()


# ------------------------------------------------------- the layers


def _token_batches(md, texts):
    """(port TokenBatch, JAX TokenBatch) of the texts with the md vectors'
    rows; the port's rows come from its collate."""
    nlp = P.Pipeline.from_config(P.Config.from_str('[nlp]\npipeline = []\n'), device="cpu")
    nlp.initialize()
    nlp.vectors = pvectors.Vectors.from_disk(md["vectors"])
    tok = nlp.collate([P.Example.from_gold(nlp.tokenizer(t)) for t in texts])["tokens"]
    jtok = JTokenBatch(attr_keys=jnp.asarray(tok.attr_keys.numpy().astype(np.uint32)),
                        mask=jnp.asarray(tok.mask.numpy()),
                        vector_rows=jnp.asarray(tok.vector_rows.numpy().astype(np.int32)))
    return tok, jtok


@pytest.mark.parametrize("layer", ["static_vectors", "multi_hash_embed"])
def test_static_vectors_forward_matches_jax(layer, md):
    words = [w for eg in pcorpus.Corpus(md["dir"] / "dev.spacy")() for w in eg.reference.words]
    texts = [" ".join(words[i:i + 9]) for i in range(0, 45, 9)] + ["Bibi NOTAWORD the"]
    tok, jtok = _token_batches(md, texts)
    rows = tok.vector_rows[tok.mask]
    assert (rows >= 0).any() and (rows < 0).any() and (tok.vector_rows[~tok.mask] == -1).all()
    jv, pv = jvectors.Vectors.from_disk(md["vectors"]), pvectors.Vectors.from_disk(md["vectors"])
    with jvectors.use_vectors(jv), pvectors.use_vectors(pv):
        if layer == "static_vectors":
            jmodel, pmodel = jlayers.StaticVectors(32), players.StaticVectors(32)
        else:
            kw = {"attrs": ["NORM", "PREFIX", "SUFFIX", "SHAPE"], "rows": [500, 100, 250, 250],
                  "include_static_vectors": True}
            jmodel, pmodel = jt2v.MultiHashEmbed(32, **kw), pt2v.MultiHashEmbed(32, **kw)
    jparams = jcore.prune_empty(jmodel.init(jax.random.PRNGKey(4)))
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    have = param_paths(pmodel)
    assert set(have) == set(flat)
    assert {k for k in have if "frozen" in k} == {"frozen_table" if layer == "static_vectors"
                                                  else "0_embeds/4_static_vectors/frozen_table"}
    with torch.no_grad():
        for k, t in have.items():
            t.copy_(torch.from_numpy(np.array(flat[k])))
    # the table is a buffer: no gradient, no optimizer leaf
    assert not any("frozen" in k for k, _ in pmodel.named_parameters())
    want = jmodel.apply(jparams, jtok, jcore.Context())
    got = pmodel(tok) if layer == "static_vectors" else pmodel(tok, None)
    err = np.abs(got.X.detach().numpy() - np.asarray(want.X)).max()
    assert err <= 1e-5, err
    if layer == "static_vectors":  # rows of -1 read zero vectors
        assert not got.X[~(tok.vector_rows >= 0)].any()


def test_collate_caches_the_rows_jax_looks_up(md, tmp_path):
    jnlp = _jax_initialized(md, tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    jegs = list(jcorpus.Corpus(md["dir"] / "train.spacy")())[:16]
    pegs = list(pcorpus.Corpus(md["dir"] / "train.spacy")())[:16]
    want = np.asarray(jnlp.collate(jegs)["tokens"].vector_rows)
    first = pnlp.collate(pegs)["tokens"].vector_rows.numpy()
    assert all(getattr(eg, "_vec_rows_cache", None) is not None for eg in pegs)
    again = pnlp.collate(pegs)["tokens"].vector_rows.numpy()  # from the cache
    assert np.array_equal(first, want) and np.array_equal(again, want)
    # a pipeline with other vectors looks the rows up again
    other = P.Pipeline.from_disk(tmp_path, device="cpu")
    other.vectors = pvectors.Vectors(["the"], np.ones((1, 24), np.float32))
    rows = other.collate(pegs)["tokens"].vector_rows
    assert set(rows.unique().tolist()) <= {-1, 0} and (rows == 0).any()


# ------------------------------------------------- the md pipeline


def test_md_batch_loss_and_gradients_match_jax(md, tmp_path):
    jnlp = _jax_initialized(md, tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    assert pnlp.pipe_names == ["tok2vec", "tagger", "parser", "attribute_ruler", "lemmatizer",
                               "ner", "entity_ruler"]
    jb = jnlp.collate(list(jcorpus.Corpus(md["dir"] / "train.spacy")())[:12])
    pb = pnlp.collate(list(pcorpus.Corpus(md["dir"] / "train.spacy")())[:12], with_targets=True)
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
    assert set(pmetrics) == set(jmetrics)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype=jnp.float64),
                                          jnlp.params)
        jgrads = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], jb["targets"],
                                                    jax.random.PRNGKey(0))[0]))(params64)
        jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    pnlp.model.double()
    pgrads = port_loss_and_grads()[2]
    # the frozen tables: JAX's gradient is zero (stop_gradient), the port has none
    assert set(jflat) - set(pgrads) == set(FROZEN)
    assert all(not jflat[k].any() for k in FROZEN)
    assert len(pgrads) == len(jflat) - 2
    for k, g in pgrads.items():
        assert g.dtype == jflat[k].dtype == np.float64
        np.testing.assert_allclose(g, jflat[k], rtol=0,
                                   atol=1e-4 * max(np.abs(jflat[k]).max(), 1e-30), err_msg=k)


def test_three_steps_leave_the_tables_and_match_jax_masked_chain(md, tmp_path):
    jnlp = _jax_initialized(md, tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    pnlp.model.requires_grad_(True)
    params = _named_params(pnlp)
    table = pvectors.Vectors.from_disk(md["vectors"]).table
    jparams = jnlp.params
    jflat = _flatten(jparams)
    assert set(jflat) - set(params) == set(FROZEN)
    rng = np.random.default_rng(5)
    jtx = jopt.mask_frozen(jopt.Adam(learn_rate=0.001, grad_clip=1.0), jparams)
    jstate = jtx.init(jparams)
    opt = popt.Adam(learn_rate=0.001, grad_clip=1.0)
    state = opt.init(params)
    for _ in range(3):
        g = {k: (np.zeros_like(v) if k in FROZEN
                 else rng.normal(size=v.shape).astype(np.float32) * 1e-2)
             for k, v in jflat.items()}
        jgrads = jax.tree_util.tree_map(jnp.asarray, _unflatten(g))
        upd, jstate = jtx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        with torch.no_grad():
            opt.update(params, {k: torch.from_numpy(g[k]) for k in params}, state)
    jflat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    for k, p in params.items():
        scale = max(np.abs(jflat[k]).max(), 1e-30)
        assert np.abs(p.detach().numpy() - jflat[k]).max() <= 1e-6 * scale, k
    paths = param_paths(pnlp.model)
    for k in FROZEN:
        assert np.array_equal(paths[k].numpy(), table) and np.array_equal(jflat[k], table)
    assert not any("frozen" in k for k in list(state["mu"]) + list(state["nu"]))


def test_a_frozen_parameter_is_refused(md, tmp_path):
    _jax_initialized(md, tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    sv = pnlp.model["tok2vec"].get_submodule("0_multi_hash_embed.0_embeds.4_static_vectors")
    table = sv.frozen_table
    del sv.frozen_table
    sv.frozen_table = torch.nn.Parameter(table)  # a table made a parameter by mistake
    with pytest.raises(ValueError, match="frozen_ marking"):
        _named_params(pnlp)


def test_md_trains_on_the_cpu_and_annotates_as_jax(md, tmp_path):
    # the port's train loop (Adam.v1 from sm.cfg), then --resume: the frozen
    # tables stay bit for bit in the model, in every params file and out of
    # the opt-state files; JAX loads the port's directory and annotates alike
    cfg = _config(P, md, max_steps=4, eval_frequency=2)
    cfg["training"]["batcher"]["size"] = 300
    nlp, result = p_train(cfg, tmp_path / "out", device="cpu", stdout_log=False)
    assert result.final_step == 4
    table = pvectors.Vectors.from_disk(md["vectors"]).table
    resumed = _config(P, md, max_steps=6, eval_frequency=2)
    resumed["training"]["batcher"]["size"] = 300
    nlp, result = p_train(resumed, tmp_path / "out", device="cpu", resume=True,
                          stdout_log=False)
    assert result.final_step == 6
    last = tmp_path / "out" / "last-model"
    for f in [last / "params-4.npz", last / "params-6.npz", last / "params.npz",
              tmp_path / "out" / "best-model" / "params.npz"]:
        flat = load_params(f)
        assert all(np.array_equal(flat[k], table) for k in FROZEN), f
    for f in (last / "opt_state-4.npz", last / "opt_state-6.npz"):
        keys = load_params(f)
        assert not any("frozen" in k for k in keys)
        assert len(keys) == 2 * len(_named_params(nlp)) + 2
    for k in FROZEN:
        assert np.array_equal(param_paths(nlp.model)[k].numpy(), table)
    assert "lemma_acc" in result.history[-1]["other_scores"]
    pnlp = P.Pipeline.from_disk(last, device="cpu")
    jnlp = J.Pipeline.from_disk(last)
    got, want = _annotate_both(pnlp, jnlp, md["dir"] / "dev.spacy")
    assert got == want
    assert any(a[5] for a in got) and all(a[1] and a[2] for a in got)


def test_jax_md_dir_loads_in_the_port_with_identical_annotations(md, tmp_path):
    jnlp = _jax_initialized(md, tmp_path / "jax")
    pnlp = P.Pipeline.from_disk(tmp_path / "jax", device="cpu")
    assert {p.name for p in (tmp_path / "jax").iterdir()} >= {"vectors.npz", "components.json"}
    assert pnlp.vectors.key_to_row == jnlp.vectors.key_to_row
    for name in ("attribute_ruler", "entity_ruler", "lemmatizer"):
        assert pnlp.components[name].table_data() == jnlp.components[name].table_data()
    got, want = _annotate_both(pnlp, jnlp, md["dir"] / "dev.spacy")
    assert got == want
    # and back: the port's to_disk of what it loaded, read by JAX
    pnlp.to_disk(tmp_path / "port")
    again = J.Pipeline.from_disk(tmp_path / "port")
    got2, want2 = _annotate_both(pnlp, again, md["dir"] / "dev.spacy")
    assert got2 == want2 == want


def test_committed_jax_md_dir_annotates_alike_in_both(md):
    # tests/data/jax_md: written by the JAX package (bin/make_jax_md_fixture.py);
    # chip_smoke.py serves it on the card
    path = REPO / "tests" / "data" / "jax_md"
    pnlp = P.Pipeline.from_disk(path, device="cpu")
    jnlp = J.Pipeline.from_disk(path)
    assert pnlp.vectors.table.shape == (1000, 24)
    got, want = _annotate_both(pnlp, jnlp, md["dir"] / "dev.spacy")
    assert got == want
    assert sum(len(a[5]) for a in got) > 0


def test_md_served_batches_carry_vector_rows_in_every_bucket(md):
    # the serving engine on the CPU over the committed JAX-written md
    # directory: the warmup sweep and live batches reach both trunks'
    # StaticVectors with their rows, and the answers equal predict_docs
    from unittest import mock

    from spacy_ray_tpu_torch.serving.engine import InferenceEngine

    nlp = P.Pipeline.from_disk(REPO / "tests" / "data" / "jax_md", device="cpu")
    seen = []
    forward = players.StaticVectors.forward

    def spy(self, batch):
        seen.append((tuple(batch.vector_rows.shape), tuple(batch.mask.shape)))
        return forward(self, batch)

    texts = [" ".join(eg.reference.words) for eg in pcorpus.Corpus(md["dir"] / "dev.spacy")()
             if len(eg.reference.words) <= 32][:6]
    with mock.patch.object(players.StaticVectors, "forward", spy):
        engine = InferenceEngine(nlp, max_batch_docs=4, max_doc_len=32)
        engine.start()
        try:
            assert {s[1] for s in seen} == set(engine.warmed)
            assert all(rows == mask for rows, mask in seen)
            assert len(seen) == 2 * len(engine.warmed)  # the shared trunk and the NER's
            served = [engine.submit_texts([t]).docs[0] for t in texts]
        finally:
            engine.stop()
    want = [nlp.tokenizer(t) for t in texts]
    nlp.predict_docs(want)
    assert _annotations(served) == _annotations(want)
