"""Structured resilience events, bounded retries and graceful termination
(``spacy_ray_tpu/training/resilience.py``).

* :func:`log_event`: a line on the training logger for people, and a
  record kept for machines until :func:`drain_events` takes it;
* :class:`RetryPolicy` and :func:`retry_io`: exponential backoff with
  jitter around a call that may fail transiently (the trainer fleet's
  gradient push);
* :func:`terminate_with_grace`: SIGTERM, a grace period, then SIGKILL (the
  fleet coordinator's shutdown of its workers);
* :data:`RC_PREEMPTED`: the exit code of a clean preemption.

The rest of the JAX module (watchdog, supervisor, shutdown coordinator,
fault plans) is not part of the port yet.
"""

from __future__ import annotations

import logging
import random
import subprocess
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

logger = logging.getLogger("spacy_ray_tpu_torch.training")

#: a clean preemption shutdown (EX_TEMPFAIL): safe to restart and resume
RC_PREEMPTED = 75

# bounded: a retry storm must not grow without bound before it is drained
_EVENTS: Deque[Dict[str, Any]] = deque(maxlen=256)
_EVENTS_LOCK = threading.Lock()


def log_event(event: str, message: str, level: int = logging.WARNING,
              **fields: Any) -> Dict[str, Any]:
    """Log ``[event] message`` and keep ``{"event", "message", **fields}``."""
    rec = {"event": event, "message": message, **fields}
    logger.log(level, "[%s] %s", event, message)
    with _EVENTS_LOCK:
        _EVENTS.append(rec)
    return rec


def drain_events() -> List[Dict[str, Any]]:
    """Return and clear the kept records."""
    with _EVENTS_LOCK:
        out = list(_EVENTS)
        _EVENTS.clear()
    return out


class RetryPolicy:
    """Exponential backoff with jitter:
    ``delay(attempt) = min(max_delay, base * 2**(attempt-1)) * (1 + U[0, jitter])``.
    The jitter decorrelates workers retrying against the same peer."""

    def __init__(self, max_retries: int = 3, base_delay: float = 0.5,
                 max_delay: float = 8.0, jitter: float = 0.5,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None) -> None:
        self.max_retries = max(int(max_retries), 0)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.sleep = sleep
        self.rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        base = min(self.max_delay, self.base_delay * (2.0 ** max(attempt - 1, 0)))
        return base * (1.0 + self.jitter * self.rng.random())


def retry_io(site: str, fn: Callable[[], Any], policy: Optional[RetryPolicy] = None,
             retry_on: Tuple[type, ...] = (OSError,)) -> Any:
    """Run ``fn``, retrying ``retry_on`` errors up to the policy's count with
    its backoff; each retry is a logged ``io-retry`` event. Errors that wear
    an OSError but cannot heal (a missing path, a permission) raise at once,
    as does everything outside ``retry_on``."""
    pol = policy or RetryPolicy()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if isinstance(e, (FileNotFoundError, NotADirectoryError, IsADirectoryError,
                              PermissionError)):
                raise
            attempt += 1
            if attempt > pol.max_retries:
                raise
            d = pol.delay(attempt)
            log_event("io-retry", f"{site}: {type(e).__name__}: {e} — retry "
                      f"{attempt}/{pol.max_retries} in {d:.2f}s", site=site, attempt=attempt)
            pol.sleep(d)


def terminate_with_grace(proc: "subprocess.Popen", grace_s: float = 10.0,
                         kill_grace_s: float = 5.0) -> Optional[int]:
    """SIGTERM, wait ``grace_s``, then SIGKILL: a child that ignores SIGTERM
    cannot hang its parent, and a healthy one gets the time to finish.
    Returns the child's return code (None if it outlived even SIGKILL)."""
    if proc.poll() is not None:
        return proc.returncode
    try:
        proc.terminate()
    except OSError:  # already gone
        return proc.poll()
    try:
        return proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        pass
    log_event("shutdown-escalated",
              f"child pid {proc.pid} ignored SIGTERM for {grace_s:.1f}s — SIGKILL",
              pid=proc.pid)
    try:
        proc.kill()
    except OSError:
        return proc.poll()
    try:
        return proc.wait(timeout=kill_grace_s)
    except subprocess.TimeoutExpired:  # an unkillable (D-state) child
        return None
