"""The asynchronous trainer fleet (``spacy_ray_tpu/training/fleet/``, its
core): every parameter slice owned by one worker process, gradients pushed
to their owners as f32 wire frames, the optimizer applied by the owner at a
quorum of workers, and gradients stamped with a stale version discarded.

* :mod:`.ownership` — which worker owns which slice of each leaf;
* :mod:`.wire` — the pickle-free array frames gradients and parameters ride in;
* :mod:`.peer` — the owner state (quorum buffer, staleness discard, apply)
  and each worker's HTTP peer server;
* :mod:`.worker` — a worker's pull -> grad -> push -> apply-wait loop;
* :mod:`.coordinator` — ``train --fleet-workers N``: spawns and ends the workers.
"""

from .ownership import OwnershipLayout, shard_axis  # noqa: F401
