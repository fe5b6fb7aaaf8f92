"""Pipeline components of the port; importing the package registers their
factories."""

from . import (  # noqa: F401
    edit_tree_lemmatizer, ner, parser, spancat, tagger, textcat, tok2vec, token_classifiers,
)
