"""Multi-model, multi-tenant serving in one process
(``spacy_ray_tpu/serving/multimodel``): the model registry and request
resolution, per-tenant token-bucket quotas in front of the SLO-class fair
queue, and the LRU hot set of warmed engines.

All of it is turned on by a manifest (``serve --model-manifest``); without
one none of these objects is built and the single-model path is unchanged.
The placement policy of the JAX package belongs to its serving fleet and is
not part of the port yet.
"""

from .admission import AdmissionController, TokenBucket
from .registry import (
    MODEL_HEADER,
    MODEL_PATH_RE,
    TENANT_HEADER,
    ClassSpec,
    ModelRegistry,
    ModelSpec,
    TenantSpec,
)
from .residency import ResidencyManager

__all__ = [
    "MODEL_HEADER",
    "TENANT_HEADER",
    "MODEL_PATH_RE",
    "ClassSpec",
    "TenantSpec",
    "ModelSpec",
    "ModelRegistry",
    "AdmissionController",
    "TokenBucket",
    "ResidencyManager",
]
