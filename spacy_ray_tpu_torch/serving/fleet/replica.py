"""Replica processes of the serving fleet (``spacy_ray_tpu/serving/fleet/replica.py``).

A replica is one ``python -m spacy_ray_tpu_torch serve`` process: one
engine, its own warmup, its own drain. :class:`ReplicaHandle` is how the
router and the supervisor see it (address, readiness, outstanding requests,
the generation it serves, pooled keep-alive connections);
:class:`ReplicaSupervisor` spawns the processes, learns each one's port from
its banner (:data:`BANNER_RE`), restarts a crashed one with backoff up to a
cap, scales the set with slot reuse and stops them all with the replica's
own graceful drain (:func:`~...training.resilience.terminate_with_grace`).
:func:`build_serve_cmd` is the one place that writes a replica's argv.

On the card every replica runs the kernels of its model's path (K1 fwd in
every trunk; K2, and K4 under ``--precision int8``, in a transformer's):
the fleet process itself runs none and never initialises CUDA.
"""

from __future__ import annotations

import http.client
import logging
import os
import re
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ...training.resilience import RetryPolicy, log_event, terminate_with_grace

__all__ = ["ReplicaHandle", "ReplicaSupervisor", "BANNER_RE", "build_serve_cmd"]

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

#: the line the server prints once it listens; the supervisor learns each
#: replica's ephemeral port from it
BANNER_RE = re.compile(r"serving on http://([^:\s]+):(\d+)")

#: restarts a crashed replica gets; past them it leaves the fleet
MAX_RESTARTS_PER_REPLICA = 3
#: the restart backoff (:class:`~...training.resilience.RetryPolicy`'s base
#: and cap, with its default jitter)
RESTART_BASE_DELAY_S = 0.5
RESTART_MAX_DELAY_S = 15.0
#: how often the supervisor looks for exited replicas
MONITOR_POLL_S = 0.2
#: a replica's own ``--drain-timeout-s``; the supervisor SIGKILLs a replica
#: still running ``REPLICA_STOP_GRACE_S`` after its SIGTERM
REPLICA_DRAIN_TIMEOUT_S = 30.0
REPLICA_STOP_GRACE_S = REPLICA_DRAIN_TIMEOUT_S + 15.0


class ReplicaHandle:
    """One replica as the fleet sees it: the process, its address, the
    router's accounting (outstanding requests, ready flag, the generation and
    resident models from ``/healthz``) and its restart history. ``lock``
    guards the mutable state the router and the supervisor share.

    ``replica_id`` grows forever (logs stay unambiguous across scale cycles);
    ``slot``, the device or core mask and base-port offset the replica holds,
    is recycled: a new replica takes the lowest slot no live handle holds.
    Two pools of keep-alive connections: the forwards' and the control
    plane's (probes and scrapes dial with a shorter timeout, and a probe on a
    forward's socket would take the forward's timeout to notice a hung
    replica)."""

    def __init__(self, replica_id: int, slot: Optional[int] = None) -> None:
        self.replica_id = int(replica_id)
        self.slot = self.replica_id if slot is None else int(slot)
        self.lock = threading.Lock()
        self.proc: Optional[subprocess.Popen] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.ready = False  # its /healthz answered 200 (warm, not draining)
        self.generation: Optional[int] = None  # None: the model as loaded from disk
        self.swap_count = 0
        # multi-model replicas: model name -> {"generation", "swap_count", ...}
        self.resident_models: Dict[str, Dict[str, Any]] = {}
        self.default_model: Optional[str] = None
        self.outstanding = 0  # requests forwarded to it and not yet answered
        self.restarts = 0
        self.stopping = False
        self.tail: "deque[str]" = deque(maxlen=40)  # its last output lines
        self._pool_lock = threading.Lock()
        self._pool: List[http.client.HTTPConnection] = []
        self.pool_cap = 16
        self._aux_pool: List[http.client.HTTPConnection] = []
        self.aux_pool_cap = 4

    def checkout_conn(self) -> Optional[http.client.HTTPConnection]:
        """An idle forward connection, or None (the caller dials)."""
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return None

    def checkin_conn(self, conn: http.client.HTTPConnection) -> None:
        """Keep a healthy connection for reuse; past the cap, or once the
        replica is stopping, close it."""
        with self._pool_lock:
            if not self.stopping and len(self._pool) < self.pool_cap:
                self._pool.append(conn)
                return
        conn.close()

    def checkout_aux_conn(self) -> Optional[http.client.HTTPConnection]:
        """An idle control-plane connection, or None (the caller dials)."""
        with self._pool_lock:
            if self._aux_pool:
                return self._aux_pool.pop()
        return None

    def checkin_aux_conn(self, conn: http.client.HTTPConnection) -> None:
        with self._pool_lock:
            if not self.stopping and len(self._aux_pool) < self.aux_pool_cap:
                self._aux_pool.append(conn)
                return
        conn.close()

    def close_conns(self) -> None:
        """Close every pooled connection (the replica died, left rotation or
        the fleet drains: its handler threads see EOF, not an idle socket)."""
        with self._pool_lock:
            pool, self._pool = self._pool, []
            aux, self._aux_pool = self._aux_pool, []
        for conn in pool + aux:
            try:
                conn.close()
            except OSError:
                pass

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        with self.lock:
            if self.host is None or self.port is None:
                return None
            return self.host, self.port

    def set_address(self, host: str, port: int) -> None:
        with self.lock:
            self.host, self.port = host, int(port)

    def clear_address(self) -> None:
        """Forget what the last process taught: a restarted replica boots
        from the model on disk and hosts only its default model."""
        with self.lock:
            self.host = self.port = None
            self.ready = False
            self.generation = None
            self.swap_count = 0
            self.resident_models = {}
            self.default_model = None
        self.close_conns()

    @property
    def alive(self) -> bool:
        p = self.proc
        if p is None:
            # a handle without a process (a static replica set): alive means
            # addressed, and the probe says the rest
            return self.host is not None
        return p.poll() is None

    def describe(self) -> Dict[str, Any]:
        proc = self.proc
        with self.lock:
            return {
                "id": self.replica_id,
                "slot": self.slot,
                "alive": self.alive,
                "ready": self.ready,
                "host": self.host,
                "port": self.port,
                "pid": proc.pid if proc is not None else None,
                "outstanding": self.outstanding,
                "restarts": self.restarts,
                "generation": self.generation,
                "swap_count": self.swap_count,
                "resident_models": sorted(self.resident_models),
                "default_model": self.default_model,
            }


class ReplicaSupervisor:
    """Spawn, watch, restart and scale the replica processes.

    ``build_cmd(slot)`` gives a replica's argv and ``build_env(slot)`` the
    variables added to its environment (a visible-device mask); both get the
    replica's recycled slot, so masks and base-port offsets stay within the
    configured layout however many replicas have ever existed.

    An exit while not ``stopping`` is a crash: the restart waits the
    backoff's delay and at most :data:`MAX_RESTARTS_PER_REPLICA` restarts
    are made; past the cap the replica
    leaves the active set (logged ``replica-giving-up``), its slot frees and a
    later :meth:`scale_to` spawns a fresh replica with its own budget. After
    :meth:`begin_drain` nothing is restarted."""

    def __init__(
        self,
        build_cmd: Callable[[int], List[str]],
        *,
        build_env: Optional[Callable[[int], Dict[str, str]]] = None,
    ) -> None:
        self.build_cmd = build_cmd
        self.build_env = build_env
        self._backoff = RetryPolicy(max_retries=MAX_RESTARTS_PER_REPLICA,
                                    base_delay=RESTART_BASE_DELAY_S,
                                    max_delay=RESTART_MAX_DELAY_S)
        self._lock = threading.Lock()
        self._handles: List[ReplicaHandle] = []
        self._next_id = 0
        self._draining = False
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._restart_at: Dict[int, float] = {}

    def _spawn(self, handle: ReplicaHandle) -> None:
        cmd = self.build_cmd(handle.slot)
        env = dict(os.environ)
        if self.build_env is not None:
            env.update(self.build_env(handle.slot))
        handle.clear_address()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env=env)
        handle.proc = proc
        log_event("replica-spawn", f"replica {handle.replica_id} spawned (pid {proc.pid})",
                  level=logging.INFO, replica=handle.replica_id, pid=proc.pid)
        threading.Thread(target=self._read_stdout, args=(handle, proc), daemon=True,
                         name=f"replica-{handle.replica_id}-stdout").start()

    def _read_stdout(self, handle: ReplicaHandle, proc: "subprocess.Popen") -> None:
        """Read the replica's output to its end (an unread pipe would block
        it): the banner gives its address, the tail is kept for crashes."""
        try:
            assert proc.stdout is not None
            for line in proc.stdout:
                handle.tail.append(line.rstrip("\n"))
                m = BANNER_RE.search(line)
                if m and handle.proc is proc:
                    handle.set_address(m.group(1), int(m.group(2)))
                logger.debug("[replica %d] %s", handle.replica_id, line.rstrip("\n"))
        except (ValueError, OSError):  # the pipe closed mid-read
            pass

    def _alloc_slot(self) -> int:
        """The lowest slot no active handle holds (the caller holds
        ``_lock``). A stopping replica's slot is free at once: its successor
        shares the mask only while the drain finishes."""
        used = {h.slot for h in self._handles if not h.stopping}
        slot = 0
        while slot in used:
            slot += 1
        return slot

    def _new_handle(self) -> ReplicaHandle:
        """A fresh replica, spawned (the caller holds ``_lock``)."""
        handle = ReplicaHandle(self._next_id, slot=self._alloc_slot())
        self._next_id += 1
        self._handles.append(handle)
        self._spawn(handle)
        return handle

    def start(self, n_replicas: int) -> List[ReplicaHandle]:
        with self._lock:
            for _ in range(int(n_replicas)):
                self._new_handle()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True,
                                         name="fleet-monitor")
        self._monitor.start()
        return self.handles()

    def handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return [h for h in self._handles if not h.stopping]

    def all_handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._handles)

    @property
    def replica_count(self) -> int:
        return len(self.handles())

    def _monitor_loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            for handle in self.handles():
                if self._draining or handle.stopping:
                    continue
                proc = handle.proc
                if proc is None or proc.poll() is None:
                    continue
                due = self._restart_at.get(handle.replica_id)
                if due is None:
                    self._on_exit(handle, proc.returncode, now)
                elif now >= due:
                    del self._restart_at[handle.replica_id]
                    self._spawn(handle)
            self._stop.wait(MONITOR_POLL_S)

    def _on_exit(self, handle: ReplicaHandle, rc: int, now: float) -> None:
        """A fresh crash: schedule the restart after its backoff, or give
        the replica up past the cap."""
        handle.clear_address()
        handle.restarts += 1
        if handle.restarts > MAX_RESTARTS_PER_REPLICA:
            log_event("replica-giving-up",
                      f"replica {handle.replica_id} exited rc={rc} after "
                      f"{handle.restarts - 1} restart(s) — removing it from the fleet",
                      replica=handle.replica_id, rc=rc)
            handle.stopping = True
            with self._lock:
                if handle in self._handles:
                    self._handles.remove(handle)
            return
        delay = self._backoff.delay(handle.restarts)
        tail = " | ".join(list(handle.tail)[-3:])
        log_event("replica-crash",
                  f"replica {handle.replica_id} exited rc={rc} — restart {handle.restarts}/"
                  f"{MAX_RESTARTS_PER_REPLICA} in {delay:.2f}s"
                  + (f" (last output: {tail})" if tail else ""),
                  replica=handle.replica_id, rc=rc, restart=handle.restarts,
                  delay_s=round(delay, 3))
        self._restart_at[handle.replica_id] = now + delay

    def scale_to(self, n: int) -> int:
        """Grow or shrink to ``n`` replicas. Growth spawns fresh processes
        (they join once their ``/healthz`` answers 200); a shrink SIGTERMs
        the youngest, each draining its own work, without blocking the
        caller. Returns ``n``."""
        n = int(n)
        with self._lock:
            active = [h for h in self._handles if not h.stopping]
            delta = n - len(active)
            for _ in range(max(delta, 0)):
                self._new_handle()
            if delta < 0:
                for handle in sorted(active, key=lambda h: h.replica_id, reverse=True)[:-delta]:
                    handle.stopping = True
                    handle.ready = False
                    threading.Thread(target=self._stop_one, args=(handle,), daemon=True,
                                     name=f"replica-{handle.replica_id}-stop").start()
        return n

    def _stop_one(self, handle: ReplicaHandle) -> Optional[int]:
        proc = handle.proc
        if proc is None:
            return None
        rc = terminate_with_grace(proc, grace_s=REPLICA_STOP_GRACE_S)
        log_event("replica-stopped", f"replica {handle.replica_id} stopped (rc={rc})",
                  level=logging.INFO, replica=handle.replica_id, rc=rc)
        with self._lock:
            if handle in self._handles:
                self._handles.remove(handle)
        return rc

    def begin_drain(self) -> None:
        """Restart nothing from now on: the fleet is going down."""
        self._draining = True

    def stop_all(self) -> bool:
        """SIGTERM every replica at once (each drains its admitted work),
        SIGKILL the ones past :data:`REPLICA_STOP_GRACE_S`, join the monitor. True when every
        replica exited 0."""
        self._draining = True
        self._stop.set()
        handles = self.all_handles()
        for h in handles:
            h.stopping = True
            h.ready = False
        results: Dict[int, Optional[int]] = {}
        threads = []
        for h in handles:
            if h.proc is None:
                continue

            def stop(h: ReplicaHandle = h) -> None:
                results[h.replica_id] = terminate_with_grace(h.proc, grace_s=REPLICA_STOP_GRACE_S)

            t = threading.Thread(target=stop, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=REPLICA_STOP_GRACE_S + 10.0)
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        clean = all(rc == 0 for rc in results.values())
        log_event("fleet-replicas-stopped",
                  f"{len(results)} replica(s) stopped "
                  f"({'all clean' if clean else 'NON-ZERO exits: ' + str(results)})",
                  level=logging.INFO if clean else logging.WARNING,
                  exits={str(k): v for k, v in results.items()})
        return clean


def build_serve_cmd(
    model_path: str,
    *,
    device: str = "cuda",
    port: int = 0,
    host: str = "127.0.0.1",
    max_batch: Optional[int] = None,
    max_wait_ms: Optional[float] = None,
    queue_size: Optional[int] = None,
    timeout_ms: Optional[float] = None,
    max_doc_len: Optional[int] = None,
    drain_timeout_s: Optional[float] = None,
    batching: Optional[str] = None,
    precision: Optional[str] = None,
    no_telemetry: bool = False,
    model_manifest: Optional[str] = None,
    resident_models: Optional[int] = None,
) -> List[str]:
    """A replica's ``python -m spacy_ray_tpu_torch serve`` argv (``None``
    leaves a flag at the server's default). ``device`` is ``cuda`` unless the
    fleet was asked for the CPU."""
    cmd = [sys.executable, "-m", "spacy_ray_tpu_torch", "serve", str(model_path),
           "--host", host, "--port", str(int(port)), "--device", device]
    if max_batch is not None:
        cmd += ["--max-batch", str(int(max_batch))]
    if max_wait_ms is not None:
        cmd += ["--max-wait-ms", str(float(max_wait_ms))]
    if queue_size is not None:
        cmd += ["--queue-size", str(int(queue_size))]
    if timeout_ms is not None:
        cmd += ["--timeout-ms", str(float(timeout_ms))]
    if max_doc_len is not None:
        cmd += ["--max-doc-len", str(int(max_doc_len))]
    if drain_timeout_s is not None:
        cmd += ["--drain-timeout-s", str(float(drain_timeout_s))]
    if batching is not None:
        cmd += ["--batching", str(batching)]
    if precision is not None:
        cmd += ["--precision", str(precision)]
    if model_manifest is not None:
        cmd += ["--model-manifest", str(model_manifest)]
    if resident_models is not None:
        cmd += ["--resident-models", str(int(resident_models))]
    if no_telemetry:
        cmd.append("--no-telemetry")
    return cmd
