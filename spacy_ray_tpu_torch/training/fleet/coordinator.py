"""The trainer fleet's coordinator: run the N worker processes, each under
a supervisor of its own, and see them to their end
(``spacy_ray_tpu/training/fleet/coordinator.py``).

``train --fleet-workers N`` without ``--fleet-worker-id`` runs here. This
process never initialises CUDA: one :class:`~..resilience.Supervisor` per
worker, each on a thread of its own, starts ``python -m spacy_ray_tpu_torch
train <argv> --fleet-worker-id k`` and, with ``max_restarts`` > 0, starts it
again with ``--resume`` after a nonzero exit: the worker reloads the last
committed generation and rejoins its peers, who keep stepping meanwhile.
A worker that is not restarted is left dead: with ``--peer-lease-s`` > 0
the survivors evict it and re-shard its slices among themselves. The exit
code: 0 when every worker exits 0, and also (with a
``fleet-degraded-success`` event) when some exit 0 and the rest exhausted
their restart budget; otherwise :data:`~..resilience.RC_PREEMPTED` if a
worker returned it, else the first non-zero code (a worker killed by signal
``s`` gives ``128 + s``). SIGTERM or SIGINT to the coordinator is relayed
to every supervisor (SIGTERM to its worker, then SIGKILL after
:data:`FLEET_SHUTDOWN_GRACE_S`) and the coordinator returns
``RC_PREEMPTED``. No worker outlives it on any of these paths.

With ``cpu_cores`` (workers on the CPU) each worker starts under ``taskset -c``
with the masks cycled over the workers, as the serving fleet pins its
replicas: co-scheduled processes that share every core thrash each other's
thread pools. Without ``taskset`` on the host they run unpinned, with a
``fleet-pinning-unavailable`` event.
"""

from __future__ import annotations

import shutil
import signal
import sys
import threading
from typing import Any, Dict, List, Optional

from ..resilience import RC_PREEMPTED, Supervisor, log_event, relaunch_argv

#: SIGTERM -> SIGKILL window for the workers: a stopping lead pulls the
#: newest slices, commits a generation (every owner writes its part) and
#: writes its models while its peers wait for /finalize
FLEET_SHUTDOWN_GRACE_S = 120.0


def worker_cmd(child_argv: List[str], worker_id: int, attempt: int = 0,
               taskset_prefix: Optional[List[str]] = None) -> List[str]:
    """Worker ``worker_id``'s argv for launch ``attempt`` (behind
    ``taskset_prefix`` when pinned): a relaunch resumes from the last
    committed generation."""
    return [*(taskset_prefix or []), *relaunch_argv(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "train", *child_argv,
         "--fleet-worker-id", str(worker_id)], attempt)]


def _exit_code(rc: int) -> int:
    return 128 - rc if rc < 0 else rc


def fleet_exit_code(codes: List[int]) -> int:
    """The fleet's code from its workers' (JAX's order): 0 when all are 0;
    ``RC_PREEMPTED`` when one was preempted; 0 when the survivors finished
    and the rest exhausted their restarts (the degraded success); else the
    first bad code."""
    if all(rc == 0 for rc in codes):
        return 0
    if any(rc == RC_PREEMPTED for rc in codes):
        return RC_PREEMPTED
    if any(rc == 0 for rc in codes):
        lost = [w for w, rc in enumerate(codes) if rc != 0]
        log_event("fleet-degraded-success",
                  f"workers {lost} exhausted their restart budget (exit codes {codes}) and "
                  "were left out; the survivors finished cleanly — reporting rc=0",
                  codes=codes, lost=lost)
        return 0
    first_bad = next(rc for rc in codes if rc != 0)
    log_event("fleet-failed", f"fleet worker exit codes {codes}; reporting rc={first_bad}",
              codes=codes)
    return first_bad


def run_fleet(child_argv: List[str], *, n_workers: int, max_restarts: int = 0,
              cpu_cores: Optional[List[str]] = None) -> int:
    """Run the fleet to its end; returns the exit code described above.
    ``child_argv`` is the workers' ``train`` argv without
    ``--fleet-worker-id``, ``--max-restarts`` and ``--cpu-cores``;
    ``max_restarts`` is each worker's own cap; worker ``k`` is pinned to
    ``cpu_cores[k % len(cpu_cores)]`` when given."""
    n_workers = int(n_workers)
    taskset = shutil.which("taskset") if cpu_cores else None
    if cpu_cores and taskset is None:
        log_event("fleet-pinning-unavailable", "cpu_cores set but taskset is unavailable; "
                  "fleet workers run unpinned")
    prefixes = [[taskset, "-c", cpu_cores[w % len(cpu_cores)]] if taskset and cpu_cores
                else None for w in range(n_workers)]
    supervisors = [Supervisor(lambda attempt, w=w: worker_cmd(child_argv, w, attempt,
                                                              prefixes[w]),
                              max_restarts, grace_s=FLEET_SHUTDOWN_GRACE_S)
                   for w in range(n_workers)]
    rcs: Dict[int, int] = {}
    threads = [threading.Thread(target=lambda w=w, sup=sup: rcs.__setitem__(w, sup.run()),
                                name=f"fleet-supervisor-{w}", daemon=True)
               for w, sup in enumerate(supervisors)]
    relayed = threading.Event()

    def relay(signum: int, frame: Any) -> None:
        relayed.set()
        for sup in supervisors:
            sup.request_shutdown()

    prev: Dict[int, Any] = {}
    if threading.current_thread() is threading.main_thread():
        for signum in (signal.SIGTERM, signal.SIGINT):
            prev[signum] = signal.signal(signum, relay)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for signum, handler in prev.items():
            signal.signal(signum, handler)
    if relayed.is_set():
        return RC_PREEMPTED
    return fleet_exit_code([_exit_code(rcs.get(w, 1)) for w in range(n_workers)])
