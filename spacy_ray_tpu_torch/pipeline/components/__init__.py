"""Pipeline components of the port; importing the package registers their
factories."""

from . import ner, parser, tagger, tok2vec  # noqa: F401
