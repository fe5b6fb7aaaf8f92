"""Structured resilience events, bounded retries, the hung-step watchdog,
fault plans and graceful termination (``spacy_ray_tpu/training/resilience.py``).

* :func:`log_event`: a line on the training logger for people, and a
  record kept for machines until :func:`drain_events` takes it (the
  ``JsonlLogger.v1`` rows carry them);
* :class:`RetryPolicy` and :func:`retry_io`: exponential backoff with
  jitter around a call that may fail transiently (corpus opens, checkpoint
  writes, the trainer fleet's gradient push); :func:`set_default_retry_policy`
  installs the policy of ``[training] io_retries`` / ``io_retry_base_s``;
* :class:`Watchdog`: a daemon thread fed a heartbeat after each step and
  evaluation; when none comes within its timeout it dumps every thread's
  stack (and the stats its caller gives it) and hard-exits
  :data:`RC_WATCHDOG`, for the supervisor to restart with ``--resume``;
* :class:`FaultPlan` (``SPACY_RAY_TPU_FAULT_PLAN``, the JAX package's name,
  so one drill spec drives either package): "fail site X on call N with
  kind K" at the sites of :data:`FAULT_SITES`, the ``nan`` poison the loop
  turns into a NaN loss, and the fleet's wire faults (corrupt, delay, dup,
  partition, heal); a rule no site would act on is refused when parsed;
* :func:`terminate_with_grace`: SIGTERM, a grace period, then SIGKILL (the
  fleet coordinator's shutdown of its workers);
* :data:`RC_PREEMPTED`: the exit code of a clean preemption;
* :class:`ShutdownCoordinator`: SIGTERM/SIGINT as a flag the training loop
  polls at step boundaries, and hooks run the moment the signal lands (the
  serving fleet's drain gate); one process: no multi-host agreement;
* :class:`Supervisor`: ``train --max-restarts N``, a child relaunched with
  ``--resume`` after a nonzero exit (a watchdog's 79 included).
"""

from __future__ import annotations

import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("spacy_ray_tpu_torch.training")

#: a clean preemption shutdown (EX_TEMPFAIL): safe to restart and resume
RC_PREEMPTED = 75
#: a hung step: the watchdog hard-exited the process; the last generation is
#: intact
RC_WATCHDOG = 79

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


_DEFAULT_RETRY = RetryPolicy()


def set_default_retry_policy(policy: RetryPolicy) -> RetryPolicy:
    """Install the policy :func:`retry_io` uses when given none (the training
    loops set it from ``[training] io_retries`` / ``io_retry_base_s``).
    Returns the previous one."""
    global _DEFAULT_RETRY
    prev = _DEFAULT_RETRY
    _DEFAULT_RETRY = policy
    return prev


def retry_io(site: str, fn: Callable[[], Any], policy: Optional[RetryPolicy] = None,
             retry_on: Tuple[type, ...] = (OSError,)) -> Any:
    """Run ``fn``, retrying ``retry_on`` errors up to the policy's count
    (the default policy's without one) with its backoff; each retry is a
    logged ``io-retry`` event. Errors that wear an OSError but cannot heal
    (a missing path, a permission) raise at once, as does everything outside
    ``retry_on``."""
    pol = policy or _DEFAULT_RETRY
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


class Watchdog:
    """A daemon thread that hard-exits the process when no heartbeat came
    within ``timeout_s``: a step wedged in a kernel or a collective raises
    nothing to catch. On firing it writes every Python thread's stack (the
    training thread's shows where it hangs) and ``stats_fn()``'s answer to
    ``stream`` (stderr), then calls ``exit_fn(RC_WATCHDOG)``
    (``os._exit``: no unwinding). ``clock``, ``sleep``, ``exit_fn`` and
    ``stream`` are injectable for tests."""

    def __init__(self, timeout_s: float, *, stats_fn: Optional[Callable[[], Any]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 exit_fn: Optional[Callable[[int], None]] = None, stream: Any = None) -> None:
        if timeout_s <= 0:
            raise ValueError("watchdog timeout_s must be > 0 (0 disables it)")
        self.timeout_s = float(timeout_s)
        self._stats_fn = stats_fn
        self._clock = clock
        self._sleep = sleep
        self._exit_fn = exit_fn or (lambda rc: os._exit(rc))
        self._stream = stream
        self._last_beat = clock()
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        """Feed the watchdog: after each completed step and evaluation."""
        self._last_beat = self._clock()

    def check(self) -> bool:
        """One poll: fire when the heartbeat is older than the timeout.
        True once it fired."""
        if self._fired:
            return True
        if self._clock() - self._last_beat <= self.timeout_s:
            return False
        self._fired = True
        self._dump()
        self._exit_fn(RC_WATCHDOG)
        return True

    def _dump(self) -> None:
        stream = self._stream if self._stream is not None else sys.stderr
        stalled = self._clock() - self._last_beat
        lines = [f"[watchdog] no step heartbeat for {stalled:.1f}s (timeout "
                 f"{self.timeout_s:.1f}s) — dumping threads and exiting {RC_WATCHDOG}"]
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            lines.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
            lines.append("".join(traceback.format_stack(frame)).rstrip())
        if self._stats_fn is not None:
            try:
                lines.append(f"[watchdog] input pipeline: {self._stats_fn()}")
            except Exception as e:  # diagnostics must never mask the exit
                lines.append(f"[watchdog] stats unavailable: {e!r}")
        try:
            stream.write("\n".join(lines) + "\n")
            stream.flush()
        except Exception:
            pass

    def _run(self) -> None:
        poll = min(self.timeout_s / 4.0, 1.0)
        while not self._stop.is_set():
            if self.check():
                return
            self._sleep(poll)

    def start(self) -> "Watchdog":
        self._last_beat = self._clock()
        self._thread = threading.Thread(target=self._run, daemon=True, name="train-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


#: the sites a fault rule may name; each is a :func:`maybe_fail` call in the
#: port (``collate`` where a step collates its microbatches)
FAULT_SITES = ("corpus-read", "collate", "checkpoint-write", "step", "grad-push",
               "param-pull", "checkpoint-wire")
FAULT_PLAN_ENV = "SPACY_RAY_TPU_FAULT_PLAN"

_FAULT_KINDS = ("oserror", "runtime", "sigterm", "nan")

#: wire faults: they raise nothing; they queue an action the fleet's wire
#: sites take with :func:`consume_wire_fault`, or (partition, heal) change
#: the peers :func:`partitioned` names
_WIRE_FAULT_KINDS = ("corrupt", "delay", "dup", "partition", "heal")

#: the sites that move bytes between fleet peers: the only ones a wire
#: fault may name (elsewhere it would act on nothing)
_WIRE_FAULT_SITES = ("grad-push", "param-pull", "checkpoint-wire")


class FaultInjected(RuntimeError):
    """An injected RuntimeError (tests catch exactly this)."""


class FaultPlan:
    """A deterministic "fail site X on call N with kind K" schedule:

        spec := rule ("," rule)*
        rule := site ":" call ":" kind [":" arg]

    ``site`` one of :data:`FAULT_SITES`, ``call`` the 1-based call number at
    that site. ``oserror`` raises OSError (the retried family), ``runtime``
    :class:`FaultInjected` (a crash), ``sigterm`` sends this process
    SIGTERM (a preemption at an exact step), ``nan`` poisons the site: the
    loop polls :func:`consume_poison` after ``maybe_fail("step")`` and
    reports that step's loss as NaN (the NaN-loss detector's drill; the
    training itself is untouched). The wire kinds, at the fleet's wire
    sites only: ``corrupt`` (the next frame gets a byte flipped,
    :func:`corrupt_bytes`), ``delay[:seconds]`` (the next call sleeps,
    default 1.0), ``dup`` (the next frame is sent twice),
    ``partition[:peer]`` (all traffic with ``peer``, or with every peer,
    fails as OSError until a ``heal``), ``heal[:peer]``. A rule that no site
    would act on (``nan`` off the step site, a wire kind off the wire sites)
    is refused. Counters are per site and per plan."""

    def __init__(self, rules: Sequence[Tuple[Any, ...]]) -> None:
        normalized: List[Tuple[str, int, str, Optional[str]]] = []
        for rule in rules:
            site, call, kind = rule[0], rule[1], rule[2]
            arg = rule[3] if len(rule) > 3 else None
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r} (known: {', '.join(FAULT_SITES)})")
            if kind not in _FAULT_KINDS and kind not in _WIRE_FAULT_KINDS:
                known = ", ".join(_FAULT_KINDS + _WIRE_FAULT_KINDS)
                raise ValueError(f"unknown fault kind {kind!r} (known: {known})")
            if call < 1:
                raise ValueError(f"fault call number must be >= 1, got {call}")
            if kind == "nan" and site != "step":
                raise ValueError(f"fault kind 'nan' is only wired at the 'step' site "
                                 f"(got {site!r}): the loop polls consume_poison there")
            if kind in _WIRE_FAULT_KINDS and site not in _WIRE_FAULT_SITES:
                raise ValueError(f"fault kind {kind!r} is only wired at the fleet wire "
                                 f"sites {', '.join(_WIRE_FAULT_SITES)} (got {site!r})")
            if arg is not None:
                if kind == "delay":
                    try:
                        float(arg)
                    except ValueError:
                        raise ValueError(f"delay arg {arg!r} is not a number of seconds")
                elif kind in ("partition", "heal"):
                    try:
                        int(arg)
                    except ValueError:
                        raise ValueError(f"{kind} arg {arg!r} is not a peer id")
                else:
                    raise ValueError(f"fault kind {kind!r} takes no arg (got {arg!r})")
            normalized.append((site, call, kind, arg))
        self.rules = normalized
        self._counts: Dict[str, int] = {}
        self._poisoned: set = set()
        self._wire_actions: Dict[str, List[Tuple[str, Optional[str]]]] = {}
        self._partitioned: set = set()
        self._partition_all = False
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules: List[Tuple[str, int, str, Optional[str]]] = []
        for chunk in spec.split(","):
            chunk = chunk.strip()
            if not chunk:
                continue
            parts = chunk.split(":")
            if len(parts) not in (3, 4):
                raise ValueError(f"bad fault rule {chunk!r} (want site:call:kind[:arg])")
            site, call_s, kind = parts[0], parts[1], parts[2]
            arg = parts[3].strip() if len(parts) == 4 else None
            try:
                call = int(call_s)
            except ValueError:
                raise ValueError(f"bad fault rule {chunk!r}: call {call_s!r} is not an int")
            rules.append((site.strip(), call, kind.strip().lower(), arg))
        return cls(rules)

    def check(self, site: str) -> None:
        """Count one call at ``site``; trigger the rules scheduled for it."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
        for r_site, r_call, r_kind, r_arg in self.rules:
            if r_site == site and r_call == n:
                self._trigger(site, n, r_kind, r_arg)

    def _trigger(self, site: str, call: int, kind: str, arg: Optional[str] = None) -> None:
        log_event("fault-injected", f"{site} call {call}: {kind}", site=site, call=call,
                  kind=kind, **({"arg": arg} if arg is not None else {}))
        if kind == "oserror":
            raise OSError(f"injected fault: {site} call {call}")
        if kind == "runtime":
            raise FaultInjected(f"injected fault: {site} call {call}")
        if kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        with self._lock:
            if kind == "nan":
                self._poisoned.add(site)
            elif kind in ("corrupt", "delay", "dup"):
                self._wire_actions.setdefault(site, []).append((kind, arg))
            elif kind == "partition":
                if arg is None:
                    self._partition_all = True
                else:
                    self._partitioned.add(int(arg))
            elif kind == "heal":
                if arg is None:
                    self._partition_all = False
                    self._partitioned.clear()
                else:
                    self._partitioned.discard(int(arg))

    def consume_poison(self, site: str) -> bool:
        """True exactly once per triggered ``nan`` rule at ``site``."""
        with self._lock:
            if site in self._poisoned:
                self._poisoned.discard(site)
                return True
        return False

    def consume_wire_fault(self, site: str) -> Optional[Tuple[str, Optional[str]]]:
        """The next queued ``(kind, arg)`` wire action at ``site`` (FIFO, each
        once), or None."""
        with self._lock:
            queue = self._wire_actions.get(site)
            if queue:
                return queue.pop(0)
        return None

    def partitioned(self, peer: Any) -> bool:
        """Is traffic with ``peer`` severed?"""
        with self._lock:
            if self._partition_all:
                return True
            try:
                return int(peer) in self._partitioned
            except (TypeError, ValueError):
                return False


_ACTIVE_PLAN: Optional[FaultPlan] = None


def set_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (None clears) the active plan; returns the previous one."""
    global _ACTIVE_PLAN
    prev = _ACTIVE_PLAN
    _ACTIVE_PLAN = plan
    return prev


def get_fault_plan() -> Optional[FaultPlan]:
    return _ACTIVE_PLAN


def activate_env_fault_plan() -> Optional[FaultPlan]:
    """Read :data:`FAULT_PLAN_ENV` and install its plan with fresh counters
    (at the start of a training run, so a relaunched child takes it from its
    environment); an empty variable leaves the active plan as it is."""
    spec = os.environ.get(FAULT_PLAN_ENV, "").strip()
    if not spec:
        return _ACTIVE_PLAN
    set_fault_plan(FaultPlan.parse(spec))
    return _ACTIVE_PLAN


def maybe_fail(site: str) -> None:
    """The fault hook of ``site``: one global read without a plan."""
    plan = _ACTIVE_PLAN
    if plan is not None:
        plan.check(site)


def consume_poison(site: str) -> bool:
    """Did a ``nan`` rule trigger at ``site`` since the last poll?"""
    plan = _ACTIVE_PLAN
    if plan is not None:
        return plan.consume_poison(site)
    return False


def consume_wire_fault(site: str) -> Optional[Tuple[str, Optional[str]]]:
    """The next queued wire action (corrupt, delay, dup) at ``site``, or None."""
    plan = _ACTIVE_PLAN
    if plan is not None:
        return plan.consume_wire_fault(site)
    return None


def partitioned(peer: Any) -> bool:
    """Is ``peer`` behind an injected partition? The fleet's wire sites raise
    the OSError a severed link raises when it is."""
    plan = _ACTIVE_PLAN
    if plan is not None:
        return plan.partitioned(peer)
    return False


def corrupt_bytes(body: bytes) -> bytes:
    """``body`` with its middle byte flipped: the ``corrupt`` kind's damage."""
    if not body:
        return body
    b = bytearray(body)
    b[len(b) // 2] ^= 0xFF
    return bytes(b)


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
