"""Pipeline components of the serving slice; importing the package
registers their factories."""

from . import tagger, tok2vec  # noqa: F401
