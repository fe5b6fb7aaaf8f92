"""The serving fleet (``spacy_ray_tpu/serving/fleet/``): a router over
replica processes, their supervisor and the SLO-driven autoscaler.

One :class:`~.fleet.Fleet` process runs the HTTP
:class:`~.router.Router` (least outstanding requests over probed replicas,
retries, a typed 503 when none is ready, the generation-stamped response
cache, length routing, the fleet's ``/metrics``), the
:class:`~.replica.ReplicaSupervisor` (one ``python -m spacy_ray_tpu_torch
serve`` process per replica, restarts with backoff, drains) and, with
``--autoscale``, the :class:`~.autoscaler.AutoscalerPolicy`. The entry
point is ``python -m spacy_ray_tpu_torch serve-fleet <model-dir>``.
"""

from .autoscaler import AutoscalerPolicy, FleetObservation, observation_from_snapshots
from .fleet import Fleet, FleetConfig
from .replica import ReplicaHandle, ReplicaSupervisor, build_serve_cmd
from .router import (
    GENERATION_MIXED,
    NoReplicaAvailable,
    ResponseCache,
    Router,
    RouterHTTPServer,
    RouterTelemetry,
)

__all__ = [
    "AutoscalerPolicy",
    "FleetObservation",
    "observation_from_snapshots",
    "Fleet",
    "FleetConfig",
    "ReplicaHandle",
    "ReplicaSupervisor",
    "build_serve_cmd",
    "NoReplicaAvailable",
    "ResponseCache",
    "GENERATION_MIXED",
    "Router",
    "RouterHTTPServer",
    "RouterTelemetry",
]
