"""The port's corpora and host input path against the JAX package, on the
CPU: the ``.spacy``, ``.msgdoc`` and ``.conllu`` readers (and directories
of them), the ``.spacy`` writer both ways, ``spacy.batch_by_padded.v1``, the
per-Example feature cache of ``collate``, and ``[training]
prefetch_batches`` (validated, then ignored).

Every comparison here is exact: the same Docs field by field (the
entity-annotation marker included), the same file bytes, the same batches,
the same collated arrays.
"""

import dataclasses
import gzip
import json
from pathlib import Path
from unittest import mock

import pytest
import torch

import spacy_ray_tpu as J
from spacy_ray_tpu import udgen as judgen
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training import spacy_docbin as jdocbin

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch import udgen as pudgen
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training import spacy_docbin as pdocbin
from spacy_ray_tpu_torch.training.loop import IGNORED_KNOBS, validate_training

REPO = Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.spacy"))

CONLLU = """# sent_id = 1
# text = The cat's toys sat.
1\tThe\tthe\tDET\tDT\tDefinite=Def\t2\tdet\t_\t_
2-3\tcat's\t_\t_\t_\t_\t_\t_\t_\t_
2\tcat\tcat\tNOUN\tNN\tNumber=Sing\t5\tnsubj\t_\t_
3\t's\t's\tPART\t_\t_\t2\tcase\t_\t_
4\ttoys\ttoy\tNOUN\tNNS\t_\t5\t_\t_\t_
4.1\tgone\tgo\tVERB\t_\t_\t_\t_\t_\t_
5\tsat\tsit\tVERB\tVBD\t_\t0\troot\t_\t_
6\t.\t.\tPUNCT\t.\t_\t_\tpunct\t_\t_

1\tHello\thello\tINTJ\tUH\t_\t0\troot\t_\t_
"""


def _key(doc):
    """Every field of a Doc, in a form both packages' Docs share."""
    d = {f.name: getattr(doc, f.name) for f in dataclasses.fields(doc)}
    d["ents"] = [(s.start, s.end, s.label, s.kb_id) for s in doc.ents]
    d["spans"] = {g: [(s.start, s.end, s.label, s.kb_id) for s in v] for g, v in doc.spans.items()}
    return d


def _keys(docs):
    return [_key(d) for d in docs]


def _ud_docs(n=30, seed=0):
    return [eg.reference for eg in judgen.synth_ud_corpus(n, seed=seed, max_sents=3)]


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_spacy_fixtures_read_as_jax_reads_them(path):
    want = list(jdocbin.read_docbin(path))
    got = list(pdocbin.read_docbin(path))
    assert want and _keys(got) == _keys(want)
    assert any(d.ents_annotated is not None for d in got)
    # through the corpus reader (the docs split into Examples alike)
    assert _keys(eg.reference for eg in pcorpus.Corpus(path)()) == _keys(
        eg.reference for eg in jcorpus.Corpus(path)())


def test_spacy_writer_round_trips_both_ways(tmp_path):
    docs = _ud_docs()
    docs[0].ents_annotated = True
    docs[1].ents, docs[1].ents_annotated = [], True  # annotated, no entities
    docs[2].ents, docs[2].ents_annotated = [], False  # no entity annotation (ENT_IOB 0)
    docs[3].spans = {"sc": [J.Span(0, 2, "A", kb_id="Q1")]}
    docs[4].cats = {"POS": 1.0, "NEG": 0.0}
    pdocs = [doc for doc in pcorpus.read_jsonl_docs(_write_jsonl(tmp_path, docs))]
    for j, p in zip(docs, pdocs):  # the fields .jsonl does not carry
        p.ents_annotated = j.ents_annotated
        p.spans = {g: [P.Span(s.start, s.end, s.label, kb_id=s.kb_id) for s in v]
                   for g, v in j.spans.items()}
    assert _keys(pdocs) == _keys(docs)
    jdocbin.write_docbin(tmp_path / "jax.spacy", docs)
    pdocbin.write_docbin(tmp_path / "port.spacy", pdocs)
    assert (tmp_path / "jax.spacy").read_bytes() == (tmp_path / "port.spacy").read_bytes()
    from_jax = list(pdocbin.read_docbin(tmp_path / "jax.spacy"))
    from_port = list(jdocbin.read_docbin(tmp_path / "port.spacy"))
    assert _keys(from_jax) == _keys(from_port)
    assert [d.ents_annotated for d in from_jax[:3]] == [True, True, False]


def _write_jsonl(tmp_path, docs):
    path = tmp_path / "docs.jsonl"
    with open(path, "w", encoding="utf8") as f:
        for d in docs:
            f.write(json.dumps(jcorpus._doc_to_json(d)) + "\n")
    return path


def test_msgdoc_conllu_and_directories_read_as_in_jax(tmp_path):
    docs = _ud_docs(12, seed=1)
    jcorpus.DocBin(docs).to_disk(tmp_path / "a.msgdoc")
    (tmp_path / "b.conllu").write_text(CONLLU, encoding="utf8")
    jdocbin.write_docbin(tmp_path / "c.spacy", docs[:5])
    jcorpus.DocBin(docs[5:]).to_disk(tmp_path / "d.spacy")  # gzip'd JSON under .spacy
    _write_jsonl(tmp_path, docs[:3]).rename(tmp_path / "e.jsonl")
    (tmp_path / "ignored.txt").write_text("not a corpus")
    for path in sorted(tmp_path.iterdir()) + [tmp_path]:
        if path.suffix == ".txt":
            continue
        want = [eg.reference for eg in jcorpus.Corpus(path)()]
        got = [eg.reference for eg in pcorpus.Corpus(path)()]
        assert want and _keys(got) == _keys(want), path.name
    conllu = list(pcorpus.read_conllu_docs(tmp_path / "b.conllu"))
    assert [d.words for d in conllu] == [["The", "cat", "'s", "toys", "sat", "."], ["Hello"]]
    assert conllu[0].heads == [1, 4, 1, 4, 4, 5] and conllu[0].deps[3] == "dep"
    assert conllu[0].tags[2] == "PART" and conllu[0].morphs[0] == "Definite=Def"
    # the port's .msgdoc in the JAX package
    pcorpus.DocBin([eg.reference for eg in pcorpus.Corpus(tmp_path / "a.msgdoc")()]).to_disk(
        tmp_path / "port.msgdoc")
    with gzip.open(tmp_path / "port.msgdoc", "rt") as f, gzip.open(tmp_path / "a.msgdoc", "rt") as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError, match="Unsupported corpus format"):
        list(pcorpus.Corpus(tmp_path / "ignored.txt")())


@pytest.mark.parametrize("size, buffer, discard", [
    (300, 256, False), (120, 16, False), (120, 16, True), (60, 7, False),
])
def test_batch_by_padded_gives_jax_batches(size, buffer, discard):
    jeg = judgen.synth_ud_corpus(150, seed=2, max_sents=4)
    peg = pudgen.synth_ud_corpus(150, seed=2, max_sents=4)
    assert [len(e) for e in jeg] == [len(e) for e in peg]
    jidx = {id(e): i for i, e in enumerate(jeg)}
    pidx = {id(e): i for i, e in enumerate(peg)}
    for sched in (size, {"@schedules": "compounding.v1", "start": 20, "stop": size,
                         "compound": 1.1}):
        jb = J.registry.resolve({"@batchers": "spacy.batch_by_padded.v1", "size": sched,
                                 "buffer": buffer, "discard_oversize": discard})
        pb = P.registry.resolve({"@batchers": "spacy.batch_by_padded.v1", "size": sched,
                                 "buffer": buffer, "discard_oversize": discard})
        want = [[jidx[id(e)] for e in b] for b in jb(iter(jeg))]
        got = [[pidx[id(e)] for e in b] for b in pb(iter(peg))]
        assert got == want and len(got) > 3


def _cnn_nlp(corpus):
    cfg = P.Config.from_disk(REPO / "configs" / "sm.cfg")
    cfg["paths"] = {"train": str(corpus), "dev": str(corpus)}
    cfg = cfg.interpolate()
    nlp = P.Pipeline.from_config(cfg, device="cpu")
    nlp.initialize(P.registry.resolve(cfg["corpora"]["train"]), seed=0)
    return nlp, cfg


def test_collate_with_the_feature_cache_equals_collate_without(tmp_path):
    corpus = tmp_path / "train.spacy"
    pdocbin.write_docbin(corpus, [eg.reference for eg in pudgen.synth_ud_corpus(60, seed=3)])
    nlp, cfg = _cnn_nlp(corpus)
    reader = P.registry.resolve(cfg["corpora"]["train"])
    batcher = P.registry.resolve(cfg["training"]["batcher"])
    calls = []
    featurize = nlp.vocab.featurize
    with mock.patch.object(nlp.vocab, "featurize",
                           side_effect=lambda words: calls.append(len(words)) or featurize(words)):
        for epoch in range(3):  # shuffled: other batches each epoch, the same Examples
            for batch in batcher(reader()):
                cached = nlp.collate(batch, with_targets=True)
                fresh = nlp.collate([P.Example.from_gold(eg.reference) for eg in batch],
                                    with_targets=True)
                assert torch.equal(cached["tokens"].attr_keys, fresh["tokens"].attr_keys)
                assert torch.equal(cached["tokens"].mask, fresh["tokens"].mask)
                assert cached["n_words"] == fresh["n_words"]
                for head, t in fresh["targets"].items():
                    for k, v in t.items():
                        assert torch.equal(cached["targets"][head][k], v), (head, k)
    # the corpus's own Examples were featurized once each, in the first epoch
    # (one call per batch); every fresh copy again
    n_words = sum(len(eg) for eg in reader())
    assert sum(calls) == n_words + 3 * n_words


def test_prefetch_batches_is_validated():
    # the JAX loop collates on a thread; the port's loop collates inside the
    # step, so it takes the knob (listed in IGNORED_KNOBS) and checks it
    assert "prefetch_batches" in IGNORED_KNOBS
    validate_training({"prefetch_batches": 2})
    for bad in (-1, 1.5, True):
        with pytest.raises(ValueError, match="prefetch_batches"):
            validate_training({"prefetch_batches": bad})
