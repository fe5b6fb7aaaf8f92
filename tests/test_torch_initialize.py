"""The port's ``[initialize]`` block and ``Pipeline.evaluate`` keys against
the JAX package, on the CPU, at a small size (trunk width 32, depth 1).

* ``[initialize.components.<name>] labels``: a JSON list, read relative to
  the config's directory and kept in its order (the head's ids follow it),
  refused when empty or duplicated, as the JAX package does;
* ``[initialize] vectors`` loads the static vectors as the JAX package
  does (relative to the config's directory; a missing file raises), and a
  missing ``init_tok2vec`` file raises in both packages
  (``test_torch_pretrain.py`` loads real ones);
* ``evaluate`` returns the JAX package's score keys and nothing else; the
  words/s of the prediction come apart from them (``evaluate_timed``).
"""

import json

import numpy as np
import pytest

import spacy_ray_tpu as J
from spacy_ray_tpu import udgen as judgen
from spacy_ray_tpu.pipeline.vectors import Vectors as JVectors
from spacy_ray_tpu.training import corpus as jcorpus

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training.loop import weighted_score

from test_torch_parser import FULL_CFG


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("ud") / "train.jsonl"
    judgen.write_ud_jsonl(path, 30, seed=0, max_sents=2)
    return path


def _with_labels_files(tmp_path, files):
    """FULL_CFG saved in ``tmp_path`` with relative labels files."""
    text = FULL_CFG
    for name, labels in files.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(labels))
        text += f'\n[initialize.components.{name}]\nlabels = "{name}.json"\n'
    (tmp_path / "config.cfg").write_text(text)
    return tmp_path / "config.cfg"


def _initialized(pkg, cfg_path, corpus_path, reader):
    nlp = pkg.Pipeline.from_config(pkg.Config.from_disk(cfg_path).interpolate(),
                                   **({"device": "cpu"} if pkg is P else {}))
    egs = list(reader.Corpus(corpus_path)())
    nlp.initialize(lambda: egs, seed=0)
    return nlp


def test_labels_files_fix_the_label_order_as_in_jax(tmp_path, corpus, monkeypatch):
    collected = _initialized(P, _with_labels_files(tmp_path, {}), corpus, pcorpus)
    files = {name: collected.components[name].labels[::-1] for name in ("tagger", "parser")}
    cfg_path = _with_labels_files(tmp_path, files)
    monkeypatch.chdir(tmp_path.parent)  # relative paths resolve against the config
    pnlp = _initialized(P, cfg_path, corpus, pcorpus)
    jnlp = _initialized(J, cfg_path, corpus, jcorpus)
    for name in ("tagger", "parser"):
        assert pnlp.components[name].labels == files[name] != sorted(files[name])
        assert pnlp.components[name].labels == jnlp.components[name].labels
    # the NER has no file: both collect and sort
    assert pnlp.components["ner"].labels == jnlp.components["ner"].labels == \
        sorted(pnlp.components["ner"].labels)
    assert pnlp.model["parser"].upper.out_W.shape[1] == 2 + 2 * len(files["parser"])


@pytest.mark.parametrize("labels,match", [([], "non-empty JSON list"),
                                          (["NOUN", "VERB", "NOUN"], "duplicates"),
                                          ({"a": 1}, "non-empty JSON list")])
def test_bad_labels_files_raise_as_in_jax(tmp_path, corpus, labels, match):
    cfg_path = _with_labels_files(tmp_path, {"tagger": labels})
    for pkg, reader in ((P, pcorpus), (J, jcorpus)):
        with pytest.raises(ValueError, match=match):
            _initialized(pkg, cfg_path, corpus, reader)


@pytest.mark.parametrize("key", ["vectors", "init_tok2vec"])
def test_unported_initialize_keys_raise(tmp_path, corpus, key, monkeypatch):
    (tmp_path / "config.cfg").write_text(FULL_CFG + f'\n[initialize]\n{key} = "missing.npz"\n')
    # both keys are ported: a missing file raises in both packages
    for pkg, reader in ((P, pcorpus), (J, jcorpus)):
        with pytest.raises(FileNotFoundError):
            _initialized(pkg, tmp_path / "config.cfg", corpus, reader)
    if key == "init_tok2vec":  # tests/test_torch_pretrain.py loads real files
        return
    # a vectors file beside the config loads relative to it, the same in both
    words = ["the", "The", "a", "cat"] + [f"w{i}" for i in range(20)]
    table = np.random.default_rng(0).normal(size=(len(words), 8)).astype(np.float32)
    JVectors(words, table).to_disk(tmp_path / "vectors.npz")
    (tmp_path / "config.cfg").write_text(FULL_CFG + '\n[initialize]\nvectors = "vectors.npz"\n')
    monkeypatch.chdir(tmp_path.parent)
    pnlp = _initialized(P, tmp_path / "config.cfg", corpus, pcorpus)
    jnlp = _initialized(J, tmp_path / "config.cfg", corpus, jcorpus)
    assert pnlp.vectors.key_to_row == jnlp.vectors.key_to_row
    assert np.array_equal(pnlp.vectors.table, jnlp.vectors.table)
    rows = pnlp.collate(list(pcorpus.Corpus(corpus)())[:4])["tokens"].vector_rows
    want = jnlp.collate(list(jcorpus.Corpus(corpus)())[:4])["tokens"].vector_rows
    assert np.array_equal(rows.numpy(), np.asarray(want))


def test_evaluate_keys_equal_jax_and_carry_no_speed(tmp_path, corpus):
    cfg_path = _with_labels_files(tmp_path, {})
    jnlp = _initialized(J, cfg_path, corpus, jcorpus)
    jnlp.to_disk(tmp_path / "model")
    pnlp = P.Pipeline.from_disk(tmp_path / "model", device="cpu")
    jscores = jnlp.evaluate(list(jcorpus.Corpus(corpus)()))
    pscores = pnlp.evaluate(list(pcorpus.Corpus(corpus)()))
    assert set(pscores) == set(jscores) and "speed" not in pscores
    timed, words_per_s = pnlp.evaluate_timed(list(pcorpus.Corpus(corpus)()))
    assert timed == pscores and words_per_s > 0
    # the no-weights fallback averages accuracies only
    flat = {k: v for k, v in pscores.items() if isinstance(v, float)}
    assert 0.0 <= weighted_score(flat, {}) <= 1.0
