"""Pipeline components of the port; importing the package registers their
factories."""

from . import (  # noqa: F401
    attribute_ruler, edit_tree_lemmatizer, entity_ruler, lemmatizer, ner, nel, parser, spancat,
    tagger, textcat, tok2vec, token_classifiers,
)
