"""Train and serve as one command: a training process and a serving fleet
sharing one checkpoint directory under one shutdown
(``spacy_ray_tpu/serving/live/orchestrator.py``; ``train-and-serve``)::

    train-and-serve                      this process, no CUDA
      |- python -m spacy_ray_tpu_torch train   writes <output>/last-model/
      |                                        generations (digest-stamped)
      |- Fleet (router + controller)     watches <output>/last-model
           |- serve replica #0..N-1      swapped through /admin/swap

* **Bootstrap.** The fleet needs a model directory before training wrote
  one: the caller's (``FleetConfig.model_path``, e.g. the last run's best
  model), or a copy of this run's first ``best-model/`` in
  ``<output>/serve-bootstrap`` (a copy: ``best-model/`` is rewritten in
  place at every improvement, and a replica must not read it mid-rewrite).
* **One SIGTERM drains both, in parallel.** The trainer gets it and stops at
  a step boundary with a generation written (exit
  :data:`~...training.resilience.RC_PREEMPTED`); the fleet's router stops
  admitting and its replicas finish their work. Exit 0 only if the fleet
  drained clean and the trainer exited 0 or RC_PREEMPTED.
* **A dead trainer does not stop serving.** Its crash is a loud event; the
  fleet goes on serving the last generation it took.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import threading
import time
import zipfile
from collections import deque
from pathlib import Path
from typing import List, Optional

from ...training.resilience import (
    RC_PREEMPTED,
    ShutdownCoordinator,
    log_event,
    terminate_with_grace,
)

__all__ = ["TrainAndServe", "wait_for_best_model"]

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

#: how long the trainer may take, after its SIGTERM, to write its generation
#: and exit before it is killed
TRAIN_GRACE_S = 75.0


def _files(path: Path):
    """Every file under ``path`` with its size and modification time."""
    return sorted((str(f.relative_to(path)), f.stat().st_size, f.stat().st_mtime_ns)
                  for f in path.rglob("*") if f.is_file())


def wait_for_best_model(output_dir, stop: threading.Event, *, timeout_s: float = 600.0,
                        settle_s: float = 1.0, poll_s: float = 0.5) -> Optional[Path]:
    """Wait until ``<output>/best-model`` holds a model (config and params),
    copy it to ``<output>/serve-bootstrap`` and return that path; None at
    the timeout or once ``stop`` is set. ``settle_s`` lets the writer finish
    the files written after params.npz.

    The trainer rewrites ``best-model/`` in place at every improvement,
    file by file and each with a plain write: a copy that overlapped a
    rewrite (a file of the source changed while it ran, or the copied
    params do not close as an archive) is thrown away and taken again."""
    output_dir = Path(output_dir)
    best = output_dir / "best-model"
    deadline = time.monotonic() + float(timeout_s)
    while not stop.is_set() and time.monotonic() < deadline:
        if (best / "config.cfg").exists() and (best / "params.npz").exists():
            stop.wait(settle_s)
            snapshot = output_dir / "serve-bootstrap"
            try:
                before = _files(best)
                shutil.rmtree(snapshot, ignore_errors=True)
                shutil.copytree(best, snapshot)
                whole = _files(best) == before and zipfile.is_zipfile(snapshot / "params.npz")
            except OSError:  # a file replaced or removed under the copy
                whole = False
            if whole:
                return snapshot
        stop.wait(poll_s)
    return None


class TrainAndServe:
    """Spawn the trainer, bootstrap a model, run the fleet, drain both.

    ``fleet_config.watch_dir`` names ``<output>/last-model`` (the CLI sets
    it); with an empty ``fleet_config.model_path``,
    :func:`wait_for_best_model` over ``output_dir`` gives one once training
    runs."""

    def __init__(self, train_cmd: List[str], fleet_config, *, output_dir,
                 bootstrap_timeout_s: float = 600.0) -> None:
        self.train_cmd = list(train_cmd)
        self.fleet_config = fleet_config
        self.output_dir = Path(output_dir)
        self.bootstrap_timeout_s = float(bootstrap_timeout_s)
        self.train_proc: Optional[subprocess.Popen] = None
        self.train_rc: Optional[int] = None
        self.fleet = None
        self.train_tail: "deque[str]" = deque(maxlen=40)
        self._shutdown = threading.Event()

    def request_shutdown(self, signum: Optional[int] = None) -> None:
        """Signal-safe: a flag, the fleet's drain gate, SIGTERM to the trainer."""
        self._shutdown.set()
        fleet = self.fleet
        if fleet is not None:
            fleet.request_shutdown(signum)
        proc = self.train_proc
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()  # the trainer's preemption path
            except OSError:
                pass

    def _spawn_train(self) -> None:
        self.train_proc = subprocess.Popen(self.train_cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=self._relay_train_output, daemon=True,
                         name="train-stdout").start()

    def _relay_train_output(self) -> None:
        proc = self.train_proc
        try:
            for line in proc.stdout:
                line = line.rstrip("\n")
                self.train_tail.append(line)
                print(f"[train] {line}", flush=True)
        except (ValueError, OSError):
            pass
        rc = proc.wait()
        self.train_rc = rc
        if self._shutdown.is_set() or rc in (0, RC_PREEMPTED):
            return
        tail = " | ".join(list(self.train_tail)[-3:])
        log_event("train-and-serve-trainer-crash",
                  f"training subprocess exited rc={rc} — the fleet keeps serving the last "
                  "promoted generation" + (f" (last output: {tail})" if tail else ""), rc=rc)

    def _stop_train(self) -> Optional[int]:
        proc = self.train_proc
        if proc is None:
            return None
        if proc.poll() is None:
            if self._shutdown.is_set():
                # the trainer has its SIGTERM and is writing its generation; a
                # second one could land after it restored the default handler
                # (-15 instead of 75): wait, and escalate past the grace only
                try:
                    rc: Optional[int] = proc.wait(timeout=TRAIN_GRACE_S)
                except subprocess.TimeoutExpired:
                    rc = terminate_with_grace(proc, grace_s=5.0)
            else:
                rc = terminate_with_grace(proc, grace_s=TRAIN_GRACE_S)
        else:
            rc = proc.returncode
        self.train_rc = rc
        return rc

    def _train_clean(self) -> bool:
        # 0: ran to its end; RC_PREEMPTED: stopped on our SIGTERM with a
        # generation written, the designed shutdown
        return self.train_rc in (0, RC_PREEMPTED)

    def run(self, *, banner: bool = True) -> int:
        from ..fleet import Fleet

        coordinator = ShutdownCoordinator()
        coordinator.add_callback(self.request_shutdown)
        coordinator.install()
        try:
            self._spawn_train()
            if banner:
                print(f"train-and-serve: training pid {self.train_proc.pid} -> "
                      f"{self.output_dir}", flush=True)
            if not self.fleet_config.model_path:
                model_path = wait_for_best_model(self.output_dir, self._shutdown,
                                                 timeout_s=self.bootstrap_timeout_s)
                if model_path is None:
                    rc = self._stop_train()
                    if self._shutdown.is_set():
                        # SIGTERM before serving began: clean if the trainer was
                        print(f"shutdown before fleet start; trainer exited {rc}", flush=True)
                        return 0 if self._train_clean() else 1
                    print(f"no best-model appeared within {self.bootstrap_timeout_s:.0f}s "
                          f"(trainer rc {rc}) — nothing to serve", flush=True)
                    return 1
                self.fleet_config.model_path = str(model_path)
                if banner:
                    print(f"bootstrapped serving model from {model_path}", flush=True)
            self.fleet = Fleet(self.fleet_config)
            if self._shutdown.is_set():
                # the SIGTERM landed between the bootstrap and the fleet
                self.fleet.request_shutdown()
            host, port = self.fleet.start()
            if banner:
                print(f"train-and-serve fleet on http://{host}:{port} "
                      f"({self.fleet_config.replicas} replica(s), watching "
                      f"{self.fleet_config.watch_dir})", flush=True)
            if self.fleet.wait_ready() and banner:
                print(f"fleet ready: {len(self.fleet.router.ready_handles())} replica(s) "
                      "warmed", flush=True)
            fleet_rc = self.fleet.wait()
            train_rc = self._stop_train()
            clean = fleet_rc == 0 and self._train_clean()
            print(f"train-and-serve drained (fleet rc {fleet_rc}, trainer rc {train_rc}"
                  f"{' = preempted-clean' if train_rc == RC_PREEMPTED else ''})", flush=True)
            return 0 if clean else 1
        except BaseException:
            # an orchestrator failure must not orphan the trainer: SIGTERM it
            # (and the fleet's drain gate), reap it, then raise
            self.request_shutdown()
            self._stop_train()
            raise
        finally:
            coordinator.restore()
