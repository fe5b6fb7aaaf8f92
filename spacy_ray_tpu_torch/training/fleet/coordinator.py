"""The trainer fleet's coordinator: spawn the N worker processes and see
them to their end (``spacy_ray_tpu/training/fleet/coordinator.py``, without
restarts).

``train --fleet-workers N`` without ``--fleet-worker-id`` runs here. This
process never initialises CUDA: it starts ``python -m spacy_ray_tpu_torch
train <argv> --fleet-worker-id k`` for each ``k`` and waits for every one of
them. A worker that dies is left dead: with ``--peer-lease-s`` > 0 the
survivors evict it and re-shard its slices among themselves. The exit code:
0 when every worker exits 0, and also (with a ``fleet-degraded-success``
event) when some exit 0 and the rest died; otherwise
:data:`~..resilience.RC_PREEMPTED` if a worker returned it, else the first
non-zero code (a worker killed by signal ``s`` gives ``128 + s``). SIGTERM
or SIGINT to the coordinator is relayed to every worker (SIGTERM, then
SIGKILL after :data:`FLEET_SHUTDOWN_GRACE_S`) and the coordinator returns
``RC_PREEMPTED``. No worker outlives it on any of these paths. Restarting a
dead worker needs optimizer parts and ``--resume``, which are not ported yet.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List

from ..resilience import RC_PREEMPTED, log_event, terminate_with_grace

#: SIGTERM -> SIGKILL window for the workers: a stopping lead pulls the
#: newest slices and writes its models while its peers wait for /finalize
FLEET_SHUTDOWN_GRACE_S = 120.0


def worker_cmd(child_argv: List[str], worker_id: int) -> List[str]:
    return [sys.executable, "-m", "spacy_ray_tpu_torch", "train", *child_argv,
            "--fleet-worker-id", str(worker_id)]


def _exit_code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


def fleet_exit_code(codes: List[int]) -> int:
    """The fleet's code from its workers' (JAX's order): 0 when all are 0;
    ``RC_PREEMPTED`` when one was preempted; 0 when the survivors finished
    and the rest died (the degraded success); else the first bad code."""
    if all(rc == 0 for rc in codes):
        return 0
    if any(rc == RC_PREEMPTED for rc in codes):
        return RC_PREEMPTED
    if any(rc == 0 for rc in codes):
        lost = [w for w, rc in enumerate(codes) if rc != 0]
        log_event("fleet-degraded-success",
                  f"workers {lost} died (exit codes {codes}) and were left out; the "
                  "survivors finished cleanly — reporting rc=0", codes=codes, lost=lost)
        return 0
    first_bad = next(rc for rc in codes if rc != 0)
    log_event("fleet-failed", f"fleet worker exit codes {codes}; reporting rc={first_bad}",
              codes=codes)
    return first_bad


def run_fleet(child_argv: List[str], *, n_workers: int) -> int:
    """Run the fleet to its end; returns the exit code described above.
    ``child_argv`` is the workers' ``train`` argv without
    ``--fleet-worker-id``."""
    relayed = threading.Event()
    prev: Dict[int, Any] = {}
    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGTERM, signal.SIGINT):
            prev[signum] = signal.signal(signum, lambda s, f: relayed.set())
    procs: List[subprocess.Popen] = []
    try:
        for w in range(int(n_workers)):
            procs.append(subprocess.Popen(worker_cmd(child_argv, w)))
        while not relayed.is_set() and any(p.poll() is None for p in procs):
            time.sleep(0.2)
    finally:
        stoppers = [threading.Thread(target=terminate_with_grace,
                                     args=(p, FLEET_SHUTDOWN_GRACE_S))
                    for p in procs if p.poll() is None]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join()
        for signum, handler in prev.items():
            signal.signal(signum, handler)
    if relayed.is_set():
        return RC_PREEMPTED
    return fleet_exit_code([_exit_code(p.returncode) for p in procs])
