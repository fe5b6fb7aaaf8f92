"""Live serving of a training run's checkpoints
(``spacy_ray_tpu/serving/live``): a server or a fleet follows a running
training job without dropping a request.

* :mod:`.watcher`: :func:`scan_intact_generations` and the
  :class:`CheckpointWatcher` that hands each new intact generation to the
  engine's hot-swap (``serve --watch``);
* :mod:`.canary` and :mod:`.controller`: the fleet's rollout
  (``serve-fleet --watch``): a canary subset of replicas swapped first, the
  router splitting traffic by generation, then promotion or rollback on the
  guard's error-rate and window-p99 verdict;
* :mod:`.orchestrator`: a training process and a watching fleet as one
  process tree under one shutdown (``train-and-serve``).

The controller and the orchestrator run in the fleet's process, which
loads no parameters; the replicas do that behind ``/admin/swap``.
"""

from .canary import CanaryGuard, GenerationStats
from .controller import LiveFleetController
from .orchestrator import TrainAndServe, wait_for_best_model
from .watcher import CheckpointWatcher, scan_intact_generations

__all__ = [
    "CanaryGuard",
    "GenerationStats",
    "CheckpointWatcher",
    "LiveFleetController",
    "TrainAndServe",
    "scan_intact_generations",
    "wait_for_best_model",
]
