"""Structured resilience events, bounded retries and graceful termination
(``spacy_ray_tpu/training/resilience.py``).

* :func:`log_event`: a line on the training logger for people, and a
  record kept for machines until :func:`drain_events` takes it;
* :class:`RetryPolicy` and :func:`retry_io`: exponential backoff with
  jitter around a call that may fail transiently (the trainer fleet's
  gradient push);
* :func:`terminate_with_grace`: SIGTERM, a grace period, then SIGKILL (the
  fleet coordinator's shutdown of its workers);
* :data:`RC_PREEMPTED`: the exit code of a clean preemption;
* :class:`ShutdownCoordinator`: SIGTERM/SIGINT as a flag the training loop
  polls at step boundaries, and hooks run the moment the signal lands (the
  serving fleet's drain gate); one process: no multi-host agreement;
* :class:`Supervisor`: ``train --max-restarts N``, a child relaunched with
  ``--resume`` after a nonzero exit.

The rest of the JAX module (the hung-step watchdog, fault plans) is not
part of the port yet.
"""

from __future__ import annotations

import logging
import random
import signal
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


class ShutdownCoordinator:
    """SIGTERM/SIGINT -> a flag the training loop polls at step boundaries,
    so the generation a preemption writes is a consistent (params, optimizer
    state, data position) triple. The handler sets the flag and runs the
    hooks of :meth:`add_callback`; a second SIGINT falls through to the
    previous handler (normally KeyboardInterrupt). One process only: the JAX
    package's all-gather of the flag across hosts is not ported."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self) -> None:
        self._flag = threading.Event()
        self._prev: Dict[int, Any] = {}
        self._installed = False
        self._callbacks: List[Callable[[Optional[int]], Any]] = []

    def add_callback(self, fn: Callable[[Optional[int]], Any]) -> None:
        """Register ``fn(signum)``, run from :meth:`request` (so from the
        signal handler): it must only flip flags or set events. The serving
        fleet closes its admission gate with it the moment SIGTERM lands."""
        self._callbacks.append(fn)

    def request(self, signum: Optional[int] = None) -> None:
        self._flag.set()
        for cb in self._callbacks:
            try:
                cb(signum)
            except Exception:  # a broken hook must not break the handler
                pass

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def _handle(self, signum: int, frame: Any) -> None:
        if self._flag.is_set() and signum == signal.SIGINT:
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            raise KeyboardInterrupt
        self.request(signum)

    def install(self) -> "ShutdownCoordinator":
        """Install the handlers (main thread only: elsewhere a caller can
        still poll a flag set through :meth:`request`)."""
        if threading.current_thread() is not threading.main_thread():
            return self
        for signum in self.SIGNALS:
            try:
                self._prev[signum] = signal.signal(signum, self._handle)
            except (ValueError, OSError):
                pass
        self._installed = True
        return self

    def restore(self) -> None:
        if not self._installed:
            return
        for signum, prev in self._prev.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False


def relaunch_argv(cmd: List[str], attempt: int) -> List[str]:
    """``cmd`` for launch ``attempt`` (0 first) of a supervised child: every
    relaunch resumes from the last intact generation."""
    if attempt > 0 and "--resume" not in cmd:
        return [*cmd, "--resume"]
    return list(cmd)


class Supervisor:
    """``--max-restarts N``: relaunch the child after a nonzero exit.

    ``build_cmd(attempt)`` gives the child's argv for launch ``attempt`` (0
    first; :func:`relaunch_argv` appends ``--resume`` from attempt 1). A signal to the
    supervisor (or :meth:`request_shutdown`) is relayed to the child,
    SIGTERM then SIGKILL after ``grace_s``, and is a clean preemption
    (:data:`RC_PREEMPTED`), never a restart. A child that exits 0 ends
    supervision; one that keeps failing past ``max_restarts`` gives its
    last code."""

    def __init__(self, build_cmd: Callable[[int], List[str]], max_restarts: int, *,
                 grace_s: float = 10.0, popen: Callable[..., Any] = subprocess.Popen,
                 restart_delay_s: float = 1.0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.build_cmd = build_cmd
        self.max_restarts = max(int(max_restarts), 0)
        self.grace_s = float(grace_s)
        self.popen = popen
        self.restart_delay_s = float(restart_delay_s)
        self.sleep = sleep
        self.restarts_used = 0
        self._shutdown = threading.Event()
        self._child: Optional[Any] = None

    def _escalate(self, child: Any) -> None:
        # on a helper thread: a signal handler must not block for the grace
        threading.Thread(target=terminate_with_grace, args=(child, self.grace_s),
                         daemon=True, name="supervisor-escalate").start()

    def _relay(self, signum: int, frame: Any) -> None:
        self._shutdown.set()
        child = self._child
        if child is not None and child.poll() is None:
            self._escalate(child)

    def request_shutdown(self) -> None:
        """What a relayed signal does, for a parent that runs several
        supervisors on threads (the fleet coordinator): only its main thread
        owns the signal handlers."""
        self._relay(signal.SIGTERM, None)

    def run(self) -> int:
        prev_handlers: Dict[int, Any] = {}
        in_main = threading.current_thread() is threading.main_thread()
        if in_main:
            for signum in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev_handlers[signum] = signal.signal(signum, self._relay)
                except (ValueError, OSError):
                    pass
        try:
            attempt = 0
            while True:
                if self._shutdown.is_set():
                    # a signal between children launches no fresh one
                    return RC_PREEMPTED
                self._child = self.popen(self.build_cmd(attempt))
                if self._shutdown.is_set():
                    # the signal landed during popen: the relay saw no child
                    self._escalate(self._child)
                rc = self._child.wait()
                if rc == 0:
                    return 0
                if self._shutdown.is_set():
                    # the child may have died on the escalated SIGKILL: the
                    # tree's outcome is a clean preemption
                    return RC_PREEMPTED
                if self.restarts_used >= self.max_restarts:
                    log_event("supervisor-giving-up", f"child exited rc={rc}; "
                              f"{self.restarts_used} restart(s) used — giving up", rc=rc)
                    return rc
                self.restarts_used += 1
                attempt += 1
                log_event("supervisor-restart", f"child exited rc={rc} — restart "
                          f"{self.restarts_used}/{self.max_restarts} (resuming from the last "
                          "intact checkpoint)", rc=rc, restart=self.restarts_used)
                if self.restart_delay_s > 0:
                    self.sleep(self.restart_delay_s)
        finally:
            self._child = None
            if in_main:
                for signum, prev in prev_handlers.items():
                    try:
                        signal.signal(signum, prev)
                    except (ValueError, OSError):
                        pass
