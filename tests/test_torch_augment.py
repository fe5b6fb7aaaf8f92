"""The port's corpus augmenters (``training/augment.py``: ``spacy.lower_case.v1``
and ``spacy.orth_variants.v1``) and the corpus's ``augmenter`` against the
JAX package, on the CPU.

The augmented stream must equal JAX's word for word and gold field for gold
field (every key of the corpus line schema), epoch after epoch: both draw
from ``random.Random(seed)`` in the same order. An augmented copy is a fresh
Example, so it misses the per-Example caches of the collate (features,
vector rows, targets) and collates as an uncached Example; an Example the
augmenter leaves alone is yielded as the same object and keeps its caches.
"""

import copy
import json
import random

import numpy as np
import pytest

import spacy_ray_tpu as J
from spacy_ray_tpu.training import corpus as jcorpus

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.pipeline.doc import doc_to_json
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training.loop import train as p_train

EPOCHS = 3
WORDS = ["the", "The", "cat", "Sat", "on", "A", "mat", "Paris", "it", "'s", "’s",
         "...", "…", "-", "—", "--", '"', "“", "”", "'", "‘", "’", "``", "''", "Big"]
TAGS = ["DT", "NN", "VBD", "IN", "NNP", "PRP", "POS", "NFP", ":", "``", "''"]
#: spaCy's English orth variants (lang/en): a single group and the quote pairs
EN_ORTH_VARIANTS = {
    "single": [{"tags": ["NFP"], "variants": ["…", "..."]},
               {"tags": [":"], "variants": ["-", "—", "–", "--", "---", "——"]}],
    "paired": [{"tags": ["``", "''"], "variants": [["'", "'"], ["‘", "’"]]},
               {"tags": ["``", "''"], "variants": [['"', '"'], ["“", "”"]]}],
}
#: untagged groups as well: a single group, a pair whose straight form sits at
#: both positions, and the ``/'' pair
UNTAGGED = {
    "single": [{"variants": ["'s", "’s"]}],
    "paired": [{"variants": [['"', '"'], ["“", "”"], ["``", "''"]]}],
}
AUGMENTERS = {
    "lower_case": ("spacy.lower_case.v1", {"level": 0.5, "seed": 3}),
    "orth_en": ("spacy.orth_variants.v1",
                {"level": 0.6, "lower": 0.3, "orth_variants": EN_ORTH_VARIANTS, "seed": 1}),
    "orth_untagged": ("spacy.orth_variants.v1",
                      {"level": 0.8, "lower": 0.0, "orth_variants": UNTAGGED, "seed": 2}),
    "lower_case_level_0": ("spacy.lower_case.v1", {"level": 0.0}),
    "orth_level_0": ("spacy.orth_variants.v1",
                     {"level": 0.0, "lower": 1.0, "orth_variants": EN_ORTH_VARIANTS}),
}


@pytest.fixture(scope="module")
def corpus_path(tmp_path_factory):
    """80 docs of 3-14 words with every gold field: tags, heads, deps,
    lemmas, an entity and a span group, drawn from a seed."""
    rng = random.Random(0)
    path = tmp_path_factory.mktemp("augment") / "train.jsonl"
    with open(path, "w", encoding="utf8") as f:
        for _ in range(80):
            n = rng.randint(3, 14)
            words = [rng.choice(WORDS) for _ in range(n)]
            tags = [{"...": "NFP", "…": "NFP", "-": ":", "—": ":", "--": ":", "``": "``",
                     "''": "''"}.get(w, rng.choice(TAGS)) for w in words]
            line = {"tokens": words, "tags": tags,
                    "heads": [max(0, i - 1) for i in range(n)],
                    "deps": ["ROOT"] + ["dep"] * (n - 1), "lemmas": [w.lower() for w in words],
                    "ents": [[0, 1, "X"]], "spans": {"sc": [[1, 2, "Y"]]},
                    "cats": {"A": 1.0}}
            f.write(json.dumps(line) + "\n")
    return path


def _streams(corpus_path, name, shuffle):
    fn_name, kwargs = AUGMENTERS[name]
    out = []
    for pkg, mod in ((P, pcorpus), (J, jcorpus)):
        aug = pkg.registry.get("augmenters", fn_name)(**copy.deepcopy(kwargs))
        corpus = mod.Corpus(corpus_path, shuffle=shuffle, seed=5, augmenter=aug)
        out.append((corpus, [list(corpus()) for _ in range(EPOCHS)]))
    return out


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_augmented_stream_equals_jax_over_three_epochs(corpus_path, name, shuffle):
    (pc, pstream), (_, jstream) = _streams(corpus_path, name, shuffle)
    changed = 0
    for pe, je in zip(pstream, jstream):
        assert len(pe) == len(je) == 80  # the variant replaces the original
        for p, j in zip(pe, je):
            assert doc_to_json(p.reference) == jcorpus._doc_to_json(j.reference)
            assert p.predicted.words == p.reference.words
            cached = any(p is c for c in pc._examples)
            changed += not cached
            if not cached:  # a copy keeps every gold field but the words
                orig = next(c for c in pc._examples
                            if c.reference.tags == p.reference.tags
                            and c.reference.heads == p.reference.heads
                            and len(c) == len(p))
                a, b = doc_to_json(p.reference), doc_to_json(orig.reference)
                assert {k: v for k, v in a.items() if k != "tokens"} == \
                    {k: v for k, v in b.items() if k != "tokens"}
    if name.endswith("level_0"):
        assert changed == 0  # the identity: the cached Examples themselves
    else:
        assert changed > 0


def test_orth_variants_pair_quotes_and_respect_tags(corpus_path):
    (pc, pstream), _ = _streams(corpus_path, "orth_untagged", False)
    pairs = [set(p) for p in UNTAGGED["paired"][0]["variants"]]
    quotes = set().union(*pairs)
    used = set()
    for epoch in pstream:
        for eg in epoch:
            if any(eg is c for c in pc._examples):
                continue
            # a copy's quotes all come from the one target pair of its doc
            found = set(eg.reference.words) & quotes
            assert any(found <= p for p in pairs), found
            used |= {i for i, p in enumerate(pairs) if found and found <= p}
    assert used == {0, 1, 2}
    aug = P.registry.get("augmenters", "spacy.orth_variants.v1")(
        level=1.0, orth_variants=EN_ORTH_VARIANTS)
    doc = P.Doc(words=["a", "...", "b", "..."], tags=["DT", "NN", "DT", "NFP"])
    out = next(aug(P.Example.from_gold(doc))).reference.words
    assert out[:3] == ["a", "...", "b"] and out[3] == "…"  # the NFP-tagged one only
    straight = P.Doc(words=['"', "x", '"', "y", '"', "z", '"'],
                     tags=["``", "NN", "''", "NN", "``", "NN", "''"])
    aug = P.registry.get("augmenters", "spacy.orth_variants.v1")(
        level=1.0, orth_variants={"paired": [{"variants": [['"', '"'], ["“", "”"]]}]},
        seed=0)
    for _ in range(20):
        ws = next(aug(P.Example.from_gold(straight))).reference.words
        assert ws in (['"', "x", '"', "y", '"', "z", '"'],
                      ["“", "x", "”", "y", "“", "z", "”"])  # open, close by occurrence


CFG = """
[paths]
train = "{train}"
dev = "{train}"

[nlp]
lang = "en"
pipeline = ["tok2vec","tagger"]

[components.tok2vec]
factory = "tok2vec"

[components.tok2vec.model]
@architectures = "spacy.HashEmbedCNN.v2"
width = 32
depth = 1
embed_size = 300
window_size = 1
maxout_pieces = 2
subword_features = true
pretrained_vectors = null

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32

[corpora.train]
@readers = "spacy.Corpus.v1"
path = ${{paths.train}}

[corpora.train.augmenter]
@augmenters = "spacy.orth_variants.v1"
level = 0.5
lower = 0.5
orth_variants = {variants}

[corpora.dev]
@readers = "spacy.Corpus.v1"
path = ${{paths.dev}}

[training]
max_steps = 6
eval_frequency = 3

[training.batcher]
@batchers = "spacy.batch_by_words.v1"
size = 200
"""


def _config(pkg, corpus_path):
    return pkg.Config.from_str(CFG.format(train=corpus_path,
                                          variants=json.dumps(EN_ORTH_VARIANTS)))


def test_config_resolved_augmenter_streams_equal_jax(corpus_path):
    streams = []
    for pkg in (P, J):
        corpus = pkg.registry.resolve(_config(pkg, corpus_path).interpolate()["corpora"]["train"])
        streams.append([[json.dumps(doc_to_json(eg.reference), sort_keys=True)
                         for eg in corpus()] for _ in range(EPOCHS)])
    assert streams[0] == streams[1]


def test_augmented_epoch_collates_as_the_uncached_collate(corpus_path):
    cfg = _config(P, corpus_path).interpolate()
    nlp = P.Pipeline.from_config(cfg, device="cpu")
    corpus = P.registry.resolve(cfg["corpora"]["train"])
    nlp.initialize(lambda: iter(list(pcorpus.Corpus(corpus_path)())), seed=0)
    list(corpus())  # epoch 1 fills the caches of the originals it yields
    for eg in corpus._examples:
        nlp.collate([eg], with_targets=True)
    epoch = list(corpus())
    copies = [eg for eg in epoch if not any(eg is c for c in corpus._examples)]
    kept = [eg for eg in epoch if any(eg is c for c in corpus._examples)]
    assert copies and kept
    assert all(getattr(eg, "_feat_cache", None) is None for eg in copies)
    assert all(getattr(eg, "_feat_cache", None) is not None for eg in kept)
    for i in range(0, len(epoch), 16):
        batch = epoch[i:i + 16]
        got = nlp.collate(batch, with_targets=True)
        fresh = [P.Example.from_gold(copy.deepcopy(eg.reference)) for eg in batch]
        want = nlp.collate(fresh, with_targets=True)
        assert np.array_equal(got["tokens"].attr_keys.numpy(), want["tokens"].attr_keys.numpy())
        assert np.array_equal(got["tokens"].mask.numpy(), want["tokens"].mask.numpy())
        for k, v in want["targets"]["tagger"].items():
            assert np.array_equal(got["targets"]["tagger"][k].numpy(), v.numpy()), k


def test_train_loop_runs_with_an_augmenter(corpus_path, tmp_path):
    seen = []

    @P.registry.callbacks("test_augment.record.v1")
    def make():
        return lambda nlp, info: seen.append(info["step"])

    cfg = _config(P, corpus_path)
    cfg["training"]["before_update"] = {"@callbacks": "test_augment.record.v1"}
    nlp, result = p_train(cfg, tmp_path / "out", device="cpu", stdout_log=False)
    assert result.final_step == 6 and seen == list(range(6))
    assert all(np.isfinite(result.step_losses))
