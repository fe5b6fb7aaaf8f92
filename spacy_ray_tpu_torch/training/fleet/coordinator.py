"""The trainer fleet's coordinator: spawn the N worker processes and see
them to their end (``spacy_ray_tpu/training/fleet/coordinator.py``, without
restarts).

``train --fleet-workers N`` without ``--fleet-worker-id`` runs here. This
process never initialises CUDA: it starts ``python -m spacy_ray_tpu_torch
train <argv> --fleet-worker-id k`` for each ``k`` and waits. It returns 0
when every worker exits 0. When a worker exits non-zero it stops the others
(SIGTERM, then SIGKILL after :data:`FLEET_SHUTDOWN_GRACE_S`) and returns that worker's code (a
worker killed by signal ``s`` gives ``128 + s``). SIGTERM or SIGINT to the
coordinator is relayed the same way and the coordinator returns
:data:`~..resilience.RC_PREEMPTED`. No worker outlives it on any of these
paths. Restarting a crashed worker needs membership and optimizer parts,
which are not ported yet: a dead worker ends the fleet.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..resilience import RC_PREEMPTED, log_event, terminate_with_grace

#: SIGTERM -> SIGKILL window for the workers: a stopping lead pulls the
#: newest slices and writes its models while its peers wait for /finalize
FLEET_SHUTDOWN_GRACE_S = 120.0


def worker_cmd(child_argv: List[str], worker_id: int) -> List[str]:
    return [sys.executable, "-m", "spacy_ray_tpu_torch", "train", *child_argv,
            "--fleet-worker-id", str(worker_id)]


def _exit_code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


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
    failed: Optional[tuple] = None
    try:
        for w in range(int(n_workers)):
            procs.append(subprocess.Popen(worker_cmd(child_argv, w)))
        while not relayed.is_set():
            codes = [p.poll() for p in procs]
            failed = next(((w, c) for w, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
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
    if failed is None:
        return 0
    w, rc = failed
    codes = [p.returncode for p in procs]
    log_event("fleet-failed", f"fleet worker {w} exited {rc}; the other workers were stopped "
              f"(exit codes {codes})", worker=w, codes=codes)
    return _exit_code(rc)
