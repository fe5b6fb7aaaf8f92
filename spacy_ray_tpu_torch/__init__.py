"""spacy-ray-tpu on PyTorch and CUDA: the port of the JAX package
``spacy_ray_tpu`` to an NVIDIA H100.

This package imports ``torch`` and never ``jax`` or ``spacy_ray_tpu``. The
module layout follows the JAX package so each part has a counterpart there.
It trains, evaluates and serves ``transformer`` and CNN ``tok2vec``
pipelines (static word vectors included) with tagger, parser, NER and
classifier heads and the rule components (``train``; ``Pipeline.from_disk``
-> ``InferenceEngine`` -> ``POST /v1/parse``), with the Pallas kernels of
that path rewritten as CUDA kernels for Hopper (``csrc/``). Entry points run on
``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .registry import registry  # noqa: E402,F401
from .config import Config  # noqa: E402,F401

# importing these registers the architectures and component factories
from . import models  # noqa: E402,F401
from .pipeline import components  # noqa: E402,F401
from .pipeline.doc import Doc, Example, Span  # noqa: E402,F401
from .pipeline.language import Pipeline  # noqa: E402,F401

__all__ = ["registry", "Config", "Pipeline", "Doc", "Example", "Span", "__version__"]
