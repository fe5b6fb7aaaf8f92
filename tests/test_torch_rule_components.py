"""The port's rule components against the JAX package, on the CPU: the
token-pattern matcher, the attribute ruler, the rule and lookup lemmatizer
and the entity ruler.

All are host code copied from the JAX package, so the tests ask for
identical results: the same match ends at every start, the same
attributes, lemmas and entities, the same errors with the same messages,
and ``components.json`` tables that load in the other package.
"""

import json

import numpy as np
import pytest

from spacy_ray_tpu import udgen as judgen
from spacy_ray_tpu.pipeline import matcher as jmatcher
from spacy_ray_tpu.pipeline.components.attribute_ruler import (
    AttributeRulerComponent as JAttributeRuler,
)
from spacy_ray_tpu.pipeline.components.entity_ruler import EntityRulerComponent as JEntityRuler
from spacy_ray_tpu.pipeline.components.lemmatizer import LemmatizerComponent as JLemmatizer
from spacy_ray_tpu.pipeline.doc import Doc as JDoc
from spacy_ray_tpu.pipeline.doc import Span as JSpan

from spacy_ray_tpu_torch.pipeline import matcher as pmatcher
from spacy_ray_tpu_torch.pipeline.components.attribute_ruler import (
    AttributeRulerComponent as PAttributeRuler,
)
from spacy_ray_tpu_torch.pipeline.components.entity_ruler import (
    EntityRulerComponent as PEntityRuler,
)
from spacy_ray_tpu_torch.pipeline.components.lemmatizer import LemmatizerComponent as PLemmatizer
from spacy_ray_tpu_torch.pipeline.doc import Doc as PDoc
from spacy_ray_tpu_torch.pipeline.doc import Span as PSpan
from spacy_ray_tpu_torch import udgen as pudgen

WORDS = ["The", "NASA", "rocket", "launched", "at", "9", "pm", ",", "said", "Dr",
         "Smith", "of", "New", "York", "!", "3.5", "rockets", "rockets", "UK", "e-mail"]
TAGS = ["DT", "NNP", "NN", "VBD", "IN", "CD", "NN", ",", "VBD", "NNP", "NNP", "IN", "NNP",
        "NNP", ".", "CD", "NNS", "NNS", "NNP", "NN"]
POS = ["DET", "PROPN", "NOUN", "VERB", "ADP", "NUM", "NOUN", "PUNCT", "VERB", "PROPN",
       "PROPN", "ADP", "PROPN", "PROPN", "PUNCT", "NUM", "NOUN", "NOUN", "PROPN", "NOUN"]
LEMMAS = ["the", "NASA", "rocket", "launch", "at", "9", "pm", ",", "say", "Dr", "Smith",
          "of", "New", "York", "!", "3.5", "rocket", "rocket", "UK", "e-mail"]


def _docs(annotated=True):
    """The same doc in both packages, with or without TAG/POS/LEMMA."""
    extra = {"tags": TAGS, "pos": POS, "lemmas": LEMMAS} if annotated else {}
    return (JDoc(words=list(WORDS), **{k: list(v) for k, v in extra.items()}),
            PDoc(words=list(WORDS), **{k: list(v) for k, v in extra.items()}))


MATCH_CASES = {
    # every token key
    "text": [{"TEXT": "rockets"}],
    "lower": [{"LOWER": "the"}],
    "tag": [{"TAG": "NNP"}, {"TAG": "NNP"}],
    "pos": [{"POS": "PROPN"}],
    "lemma": [{"LEMMA": "rocket"}],
    "shape": [{"SHAPE": "Xx"}],
    "length": [{"LENGTH": 2}],
    "is_digit": [{"IS_DIGIT": True}],
    "is_alpha_false": [{"IS_ALPHA": False}],
    "is_title": [{"IS_TITLE": True}, {"IS_TITLE": True}],
    "is_upper": [{"IS_UPPER": True}],
    "is_lower": [{"IS_LOWER": True}, {"IS_LOWER": True}],
    "is_punct": [{"IS_PUNCT": True}],
    # every predicate
    "regex": [{"TEXT": {"REGEX": "^[A-Z]{2,4}$"}}],
    "in": [{"LOWER": {"IN": ["new", "york", "uk"]}}],
    "not_in": [{"POS": {"NOT_IN": ["NOUN", "PROPN", "PUNCT"]}}],
    "eq": [{"LENGTH": {"==": 6}}],
    "ne": [{"TAG": {"!=": "NNP"}}, {"TAG": "NNP"}],
    "ge": [{"LENGTH": {">=": 7}}],
    "le": [{"LENGTH": {"<=": 1}}],
    "gt_lt": [{"LENGTH": {">": 2, "<": 5}}],
    "str_compare": [{"LOWER": {">=": "s", "<": "t"}}],
    # every OP form
    "op_1": [{"TAG": "NNP", "OP": "1"}, {"TAG": "NNP"}],
    "op_negate": [{"IS_PUNCT": True, "OP": "!"}, {"IS_PUNCT": True}],
    "op_optional": [{"LOWER": "dr", "OP": "?"}, {"LOWER": "smith"}],
    "op_star": [{"TAG": "NNP", "OP": "*"}, {"TAG": "IN"}],
    "op_plus": [{"TAG": "NNP", "OP": "+"}],
    "op_exact": [{"LOWER": "rockets", "OP": "{2}"}],
    "op_range": [{"IS_ALPHA": True, "OP": "{1,3}"}, {"IS_PUNCT": True}],
    "op_at_least": [{"IS_ALPHA": True, "OP": "{2,}"}],
    "op_at_most": [{"TAG": "NNP", "OP": "{,2}"}, {"TAG": "NN"}],
    # backtracking: the greedy run must give a token back
    "backtrack": [{"IS_ALPHA": True, "OP": "+"}, {"LOWER": "york"}, {"IS_PUNCT": True}],
    "star_then_same": [{"LOWER": "rockets", "OP": "*"}, {"LOWER": "rockets"}],
}


@pytest.mark.parametrize("annotated", [True, False], ids=["annotated", "bare"])
@pytest.mark.parametrize("name", sorted(MATCH_CASES))
def test_matcher_matches_as_jax(name, annotated):
    pattern = MATCH_CASES[name]
    jdoc, pdoc = _docs(annotated)
    jmatcher.validate_token_patterns([pattern])
    pmatcher.validate_token_patterns([pattern])
    want = [jmatcher.match_pattern(jdoc, pattern, s) for s in range(len(WORDS))]
    got = [pmatcher.match_pattern(pdoc, pattern, s) for s in range(len(WORDS))]
    assert got == want
    if annotated or not {"TAG", "POS", "LEMMA"} & {k for t in pattern for k in t}:
        assert any(e is not None for e in got), "the case should match somewhere"


BAD_PATTERNS = {
    "unknown_key": [{"DEP": "nsubj"}],
    "bad_op": [{"TEXT": "a", "OP": "{3"}],
    "bad_op_word": [{"TEXT": "a", "OP": "many"}],
    "unknown_predicate": [{"TEXT": {"LIKE": "a"}}],
    "bad_regex": [{"TEXT": {"REGEX": "(unclosed"}}],
    "in_not_a_list": [{"LOWER": {"IN": "abc"}}],
    "length_vs_string": [{"LENGTH": {">=": "3"}}],
    "text_vs_number": [{"TEXT": {">": 3}}],
}


@pytest.mark.parametrize("name", sorted(BAD_PATTERNS))
def test_invalid_patterns_raise_as_jax(name):
    errors = []
    for mod in (jmatcher, pmatcher):
        with pytest.raises(Exception) as info:
            mod.validate_token_patterns([BAD_PATTERNS[name]])
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


RULES = [
    {"patterns": [[{"LOWER": "dr"}, {"TAG": "NNP"}]], "attrs": {"TAG": "TITLE", "LEMMA": "doctor"},
     "index": 0},
    # matches the doc as it came in: the rule above rewrites Dr's TAG, and
    # this one still sees NNP there
    {"patterns": [[{"TAG": "NNP", "OP": "+"}]], "attrs": {"POS": "X", "MORPH": "Proper=Yes"},
     "index": -1},
    {"patterns": [[{"LOWER": "rockets"}, {"LOWER": "rockets"}], [{"IS_DIGIT": True}]],
     "attrs": {"pos": "NUM_OR_NOUN"}, "index": -1},
]


def test_attribute_ruler_applies_as_jax():
    jdoc, pdoc = _docs()
    j = JAttributeRuler("attribute_ruler", patterns=RULES)
    p = PAttributeRuler("attribute_ruler", patterns=RULES)
    j.set_annotations([jdoc], None, [len(WORDS)])
    p.set_annotations([pdoc], None, [len(WORDS)])
    for field in ("tags", "pos", "lemmas", "morphs"):
        assert getattr(pdoc, field) == getattr(jdoc, field), field
    assert pdoc.tags[9] == "TITLE" and pdoc.pos[10] == "X" and pdoc.morphs[13] == "Proper=Yes"
    # a doc without tags: the TAG-keyed rules do not match, fields are created
    jbare, pbare = _docs(annotated=False)
    j.set_annotations([jbare], None, [len(WORDS)])
    p.set_annotations([pbare], None, [len(WORDS)])
    assert (pbare.tags, pbare.pos, pbare.morphs) == (jbare.tags, jbare.pos, jbare.morphs)
    # the rules round-trip through components.json both ways
    p2, j2 = PAttributeRuler("a"), JAttributeRuler("a")
    p2.load_table_data(json.loads(json.dumps(j.table_data())))
    j2.load_table_data(json.loads(json.dumps(p.table_data())))
    assert p2.patterns == j2.patterns == RULES


@pytest.mark.parametrize("bad", [
    {"patterns": [[{"LOWER": "new"}, {"LOWER": "york"}]], "attrs": {"TAG": "X"}, "index": 2},
    {"patterns": [[{"LOWER": "new"}, {"LOWER": "york"}]], "attrs": {"TAG": "X"}, "index": -3},
    {"patterns": [[{"LOWER": "new"}]], "attrs": {"DEP": "nsubj"}},
], ids=["index_past_the_end", "negative_index_before_the_start", "unsupported_attribute"])
def test_attribute_ruler_errors_as_jax(bad):
    errors = []
    for ruler, doc in ((JAttributeRuler, _docs()[0]), (PAttributeRuler, _docs()[1])):
        with pytest.raises(ValueError) as info:
            r = ruler("attribute_ruler", patterns=[bad])
            r.set_annotations([doc], None, [len(WORDS)])
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def _udgen_examples(n, seed):
    """The same pseudo-UD docs as (JAX Examples, port Examples)."""
    return (judgen.synth_ud_corpus(n, seed=seed, max_sents=2),
            pudgen.synth_ud_corpus(n, seed=seed, max_sents=2))


ENGLISH = [("was", "VERB"), ("children", "NOUN"), ("better", "ADJ"), ("better", "ADV"),
           ("boxes", "NOUN"), ("running", "VERB"), ("studies", "VERB"), ("happiest", "ADJ"),
           ("wolves", "NOUN"), ("Paris", "PROPN"), ("quickly", "ADV"), ("agreed", "VERB"),
           ("", "VERB"), ("sees", "VERB"), ("glasses", "NOUN")]


@pytest.mark.parametrize("mode", ["lookup", "rule", "tables_path"])
def test_lemmatizer_matches_jax(mode, tmp_path):
    kwargs = {"mode": "lookup" if mode == "lookup" else "rule"}
    if mode == "tables_path":
        tables = {"rules": {"NOUN": [["ves", "f"], ["s", ""]], "VERB": [["ing", ""], ["ed", ""]],
                            "PROPN": []},
                  "exceptions": {"VERB": {"was": "be"}, "NOUN": {"mice": "mouse"}},
                  "index": {"NOUN": ["wolf", "glass"], "VERB": ["run"]}}
        (tmp_path / "tables.json").write_text(json.dumps(tables), encoding="utf8")
        kwargs["tables_path"] = str(tmp_path / "tables.json")
    j, p = JLemmatizer("lemmatizer", **kwargs), PLemmatizer("lemmatizer", **kwargs)
    jtrain, ptrain = _udgen_examples(40, seed=0)
    j.add_labels_from(jtrain)
    p.add_labels_from(ptrain)
    for comp in (j, p):
        comp.finish_labels()
    assert p.table_data() == j.table_data()
    jdev, pdev = _udgen_examples(12, seed=1)
    pairs = [(w, pos) for eg in pdev for w, pos in zip(eg.reference.words, eg.reference.pos)]
    pairs += ENGLISH
    assert [p.lemmatize(w, pos) for w, pos in pairs] == [j.lemmatize(w, pos) for w, pos in pairs]
    # annotation and lemma_acc over predicted docs with gold POS
    for egs in (jdev, pdev):
        for eg in egs:
            eg.predicted.pos = list(eg.reference.pos)
    j.set_annotations([eg.predicted for eg in jdev], None, [len(eg) for eg in jdev])
    p.set_annotations([eg.predicted for eg in pdev], None, [len(eg) for eg in pdev])
    assert [eg.predicted.lemmas for eg in pdev] == [eg.predicted.lemmas for eg in jdev]
    assert p.score(pdev) == j.score(jdev)
    assert 0 < p.score(pdev)["lemma_acc"] <= 1
    # the tables load in the other package (components.json)
    p2, j2 = PLemmatizer("l"), JLemmatizer("l")
    p2.load_table_data(json.loads(json.dumps(j.table_data())))
    j2.load_table_data(json.loads(json.dumps(p.table_data())))
    assert [p2.lemmatize(w, pos) for w, pos in pairs] == [j2.lemmatize(w, pos) for w, pos in pairs]


ENT_PATTERNS = {
    "token": [
        {"label": "GPE", "pattern": [{"LOWER": "new"}, {"LOWER": "york"}]},
        {"label": "PERSON", "pattern": [{"LOWER": "dr", "OP": "?"}, {"IS_TITLE": True}]},
        {"label": "ORG", "pattern": [{"TEXT": {"REGEX": "^[A-Z]{2,4}$"}}]},
        {"label": "QUANTITY", "pattern": [{"TEXT": {"IN": ["9", "3.5"]}},
                                          {"IS_ALPHA": True, "OP": "?"}]},
    ],
    "phrase": [
        {"label": "ORG", "pattern": "NASA"},
        {"label": "GPE", "pattern": "New York!"},
        {"label": "GPE", "pattern": "U.S."},
        {"label": "PERSON", "pattern": "Dr Smith"},
        {"label": "PRODUCT", "pattern": "e-mail"},
    ],
}


@pytest.mark.parametrize("overwrite", [False, True], ids=["keep_ents", "overwrite_ents"])
@pytest.mark.parametrize("kind", ["token", "phrase"])
def test_entity_ruler_matches_jax(kind, overwrite):
    patterns = ENT_PATTERNS[kind]
    j = JEntityRuler("entity_ruler", patterns=patterns, overwrite_ents=overwrite)
    p = PEntityRuler("entity_ruler", patterns=patterns, overwrite_ents=overwrite)
    assert p.labels == j.labels and p._compiled == j._compiled
    docs = []
    for words, ents in ((WORDS, [(12, 13, "PERSON"), (1, 2, "ORG")]),
                        (["We", "left", "the", "U.S.", "for", "New", "York", "!"], []),
                        (["Dr", "Smith", "saw", "NASA", "at", "9", "pm"], [(4, 6, "TIME")])):
        docs.append((JDoc(words=list(words), ents=[JSpan(*e) for e in ents]),
                     PDoc(words=list(words), ents=[PSpan(*e) for e in ents])))
    for jd, pd in docs:
        j.set_annotations([jd], None, [len(jd)])
        p.set_annotations([pd], None, [len(pd)])
        assert [tuple(e) for e in pd.ents] == [(e.start, e.end, e.label) for e in jd.ents]
    assert any(len(pd.ents) > 1 for _, pd in docs)
    # the patterns load in the other package (components.json)
    p2, j2 = PEntityRuler("e"), JEntityRuler("e")
    p2.load_table_data(json.loads(json.dumps(j.table_data())))
    j2.load_table_data(json.loads(json.dumps(p.table_data())))
    assert p2.patterns == j2.patterns == patterns
    assert p2.overwrite_ents == j2.overwrite_ents == overwrite
    assert p2._compiled == j2._compiled


def test_entity_ruler_invalid_pattern_raises_as_jax():
    bad = [{"label": "X", "pattern": [{"TEXT": "a", "OP": "{2,x}"}]}]
    errors = []
    for ruler in (JEntityRuler, PEntityRuler):
        with pytest.raises(ValueError) as info:
            ruler("entity_ruler", patterns=bad)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert np.array_equal(sorted(pmatcher.SUPPORTED_TOKEN_KEYS),
                          sorted(jmatcher.SUPPORTED_TOKEN_KEYS))
