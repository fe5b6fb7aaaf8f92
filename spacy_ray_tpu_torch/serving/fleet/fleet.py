"""One serving fleet: the supervisor, the router and the autoscaler under
one lifecycle (``spacy_ray_tpu/serving/fleet/fleet.py``)::

            clients
               |
        RouterHTTPServer (:port)           this process, no CUDA
         /v1/parse /healthz /metrics[?format=prometheus] /trace /admin/exemplars
               |
        Router (least outstanding, probed, retries, response cache)
          |          |           |
       serve #0   serve #1 ... serve #N-1  replica processes, on the card
          ^---- ReplicaSupervisor (spawn, restart with backoff, scale)
                      ^---- AutoscalerPolicy (the replicas' SLO telemetry -> scale_to)

SIGTERM or SIGINT (through :meth:`~...training.resilience.ShutdownCoordinator.add_callback`)
closes the router's admission at once; then the router waits for its
forwarded requests, every replica gets SIGTERM and drains its own work, in
parallel, and the fleet exits 0 only if the router went quiet and every
replica exited 0.

Not here yet: the live rollout controller (``--watch``), placement of
models across replicas, the alert engine and the incident recorder.
"""

from __future__ import annotations

import logging
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ...training.resilience import ShutdownCoordinator, log_event
from .autoscaler import AutoscalerPolicy, observation_from_snapshots
from .replica import REPLICA_DRAIN_TIMEOUT_S, ReplicaSupervisor, build_serve_cmd
from .router import Router, RouterHTTPServer, RouterTelemetry

__all__ = ["FleetConfig", "Fleet"]

logger = logging.getLogger("spacy_ray_tpu_torch.serving")


@dataclass
class FleetConfig:
    """Everything a fleet needs; ``serve-fleet`` builds one from its flags.
    ``None`` leaves a replica's flag at the server's default."""

    model_path: str
    host: str = "127.0.0.1"
    port: int = 8090
    device: str = "cuda"
    replicas: int = 2
    min_replicas: int = 1
    max_replicas: int = 4
    max_batch: Optional[int] = None
    max_wait_ms: Optional[float] = None
    queue_size: Optional[int] = None
    timeout_ms: Optional[float] = None
    max_doc_len: Optional[int] = None
    batching: Optional[str] = None
    precision: Optional[str] = None
    # a manifest makes every replica a multi-model host and the router
    # resolve and route per model
    model_manifest: Optional[str] = None
    resident_models: Optional[int] = None
    # 0: ephemeral ports read from the banners; else base_port + slot
    base_port: int = 0
    # visible-device masks cycled by slot (on one card every replica shares
    # it, and a mask is a no-op)
    visible_devices: Optional[List[str]] = None
    visible_devices_env: str = "CUDA_VISIBLE_DEVICES"
    # ``taskset -c`` core masks cycled by slot, on the CPU only
    cpu_cores: Optional[List[str]] = None
    cache_mb: float = 32.0  # the router's response cache (0 = off)
    probe_interval_s: float = 0.5
    length_routing: bool = False
    autoscale: bool = False
    p99_target_ms: float = 500.0
    autoscale_interval_s: float = 2.0
    up_consecutive: int = 3
    down_consecutive: int = 10
    cooldown_s: float = 30.0
    drain_timeout_s: float = 60.0
    ready_timeout_s: float = 300.0
    telemetry: bool = True

    def build_cmd(self, slot: int) -> List[str]:
        """The argv of the replica in ``slot`` (slots recycle, so the masks
        and ports stay within the configured layout)."""
        port = 0 if self.base_port == 0 else self.base_port + slot
        prefix: List[str] = []
        if self.cpu_cores and self.device == "cpu":
            taskset = shutil.which("taskset")
            if taskset is None:
                logger.warning("cpu_cores set but taskset is unavailable; replica slot %d "
                               "spawns unpinned", slot)
            else:
                prefix = [taskset, "-c", self.cpu_cores[slot % len(self.cpu_cores)]]
        return prefix + build_serve_cmd(
            self.model_path, device=self.device, port=port, host="127.0.0.1",
            max_batch=self.max_batch, max_wait_ms=self.max_wait_ms, queue_size=self.queue_size,
            timeout_ms=self.timeout_ms, max_doc_len=self.max_doc_len,
            drain_timeout_s=REPLICA_DRAIN_TIMEOUT_S, batching=self.batching,
            precision=self.precision, no_telemetry=not self.telemetry,
            model_manifest=self.model_manifest, resident_models=self.resident_models)

    def build_env(self, slot: int) -> Dict[str, str]:
        env: Dict[str, str] = {}
        if self.visible_devices:
            env[self.visible_devices_env] = self.visible_devices[slot % len(self.visible_devices)]
        return env


class Fleet:
    """One fleet's lifecycle: :meth:`run` for the command line (signal
    handlers and banners), :meth:`start`, :meth:`request_shutdown` and
    :meth:`wait` for tests, with the same drain either way.

    With ``device`` ``cuda`` and no card it raises before it binds or spawns
    anything: replicas that cannot start would only crash-loop."""

    def __init__(self, config: FleetConfig) -> None:
        if config.device != "cpu":
            from ...devices import resolve_device

            resolve_device(config.device)
        self.config = config
        self.tel = RouterTelemetry() if config.telemetry else None
        self.supervisor = ReplicaSupervisor(config.build_cmd, build_env=config.build_env)
        self.registry = None
        if config.model_manifest:
            from ..multimodel import ModelRegistry

            self.registry = ModelRegistry.from_manifest(config.model_manifest)
        # no rollout controller declares a canary here: the split stays off
        self.router = Router(self.supervisor.handles, telemetry=self.tel,
                             cache_bytes=int(config.cache_mb * 1024 * 1024),
                             probe_interval_s=config.probe_interval_s,
                             length_routing=config.length_routing, canary_fraction=0.0,
                             registry=self.registry)
        self.policy: Optional[AutoscalerPolicy] = None
        if config.autoscale:
            self.policy = AutoscalerPolicy(
                min_replicas=config.min_replicas, max_replicas=config.max_replicas,
                p99_target_s=config.p99_target_ms / 1e3, up_consecutive=config.up_consecutive,
                down_consecutive=config.down_consecutive, cooldown_s=config.cooldown_s)
        self.httpd = RouterHTTPServer((config.host, config.port), self.router)
        self._stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None
        self._autoscale_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    def start(self) -> Tuple[str, int]:
        self.supervisor.start(self.config.replicas)
        self.router.start()
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever,
                                              kwargs={"poll_interval": 0.1}, name="fleet-http",
                                              daemon=True)
        self._serve_thread.start()
        if self.policy is not None:
            self._autoscale_thread = threading.Thread(target=self._autoscale_loop,
                                                      name="fleet-autoscaler", daemon=True)
            self._autoscale_thread.start()
        return self.address

    def wait_ready(self, n: Optional[int] = None, timeout_s: Optional[float] = None) -> bool:
        """Block until ``n`` replicas (all the initial ones by default) are
        ready, as the prober sees them; False at the timeout or on
        shutdown."""
        want = self.config.replicas if n is None else int(n)
        deadline = time.monotonic() + (self.config.ready_timeout_s if timeout_s is None
                                       else timeout_s)
        while time.monotonic() < deadline:
            if len(self.router.ready_handles()) >= want:
                return True
            if self._stop.is_set():
                return False
            time.sleep(0.1)
        return False

    def _autoscale_loop(self) -> None:
        while not self._stop.wait(self.config.autoscale_interval_s):
            if self.router.draining:
                return
            try:
                self.autoscale_tick()
            except Exception:  # the control loop must survive anything
                logger.exception("autoscaler tick failed")

    def autoscale_tick(self) -> Optional[int]:
        """One observe-decide-act cycle; returns the decision."""
        assert self.policy is not None
        snaps = self.router.scrape_replica_metrics()
        obs = observation_from_snapshots(snaps, ready=len(self.router.ready_handles()))
        desired = self.policy.observe(obs)
        if desired is not None:
            if self.tel is not None:
                self.tel.trace.add_instant("autoscale", cat="fleet",
                                           args={"from": obs.ready, "to": desired})
                self.tel.registry.counter("autoscale_decisions").inc()
            self.supervisor.scale_to(desired)
        return desired

    def request_shutdown(self, signum: Optional[int] = None) -> None:
        """Signal-safe (a flag and an event): admission closes at once; the
        thread in :meth:`wait` does the drain."""
        self.router.draining = True
        self._stop.set()

    def wait(self) -> int:
        self._stop.wait()
        self.router.begin_drain()
        self.supervisor.begin_drain()  # a crash during the drain stays down
        log_event("fleet-drain", "shutdown requested — draining router, then "
                  f"{self.supervisor.replica_count} replica(s)", level=logging.INFO)
        router_quiet = self.router.wait_inflight(self.config.drain_timeout_s)
        self.router.stop()
        replicas_clean = self.supervisor.stop_all()
        self.httpd.shutdown()
        self.httpd.server_close()
        clean = router_quiet and replicas_clean
        if not clean:
            log_event("fleet-drain-failed",
                      f"router_quiet={router_quiet} replicas_clean={replicas_clean}")
        return 0 if clean else 1

    def run(self, *, banner: bool = True) -> int:
        coordinator = ShutdownCoordinator()
        coordinator.add_callback(self.request_shutdown)
        coordinator.install()
        try:
            host, port = self.start()
            if banner:
                print(f"fleet serving on http://{host}:{port} ({self.config.replicas} "
                      f"replica(s), device {self.config.device})", flush=True)
            if self.wait_ready():
                if banner:
                    print(f"fleet ready: {len(self.router.ready_handles())} replica(s) warmed",
                          flush=True)
            elif not self._stop.is_set():
                print(f"fleet NOT ready within {self.config.ready_timeout_s:.0f}s — serving "
                      f"with {len(self.router.ready_handles())} ready replica(s)", flush=True)
            return self.wait()
        finally:
            coordinator.restore()
