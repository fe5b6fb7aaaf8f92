"""Live serving of a training run's checkpoints
(``spacy_ray_tpu/serving/live``): :func:`scan_intact_generations` and the
:class:`CheckpointWatcher` that hands each new intact generation to the
engine's hot-swap (``serve --watch``). The JAX package's canary, controller
and orchestrator drive a serving fleet and are not part of the port yet.
"""

from .watcher import CheckpointWatcher, scan_intact_generations

__all__ = ["CheckpointWatcher", "scan_intact_generations"]
