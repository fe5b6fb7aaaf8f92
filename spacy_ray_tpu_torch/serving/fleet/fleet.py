"""One serving fleet: the supervisor, the router, the autoscaler and the
rollout controller under one lifecycle (``spacy_ray_tpu/serving/fleet/fleet.py``)::

            clients
               |
        RouterHTTPServer (:port)           this process, no CUDA
         /v1/parse /healthz /metrics[?format=prometheus] /trace /admin/exemplars
         /admin/alerts
               |
        Router (least outstanding, probed, retries, canary split, response cache)
          |          |           |
       serve #0   serve #1 ... serve #N-1  replica processes, on the card
          ^---- ReplicaSupervisor (spawn, restart with backoff, scale)
          |           ^---- AutoscalerPolicy (the replicas' SLO telemetry -> scale_to)
          |                 + PlacementPolicy (a manifest: /admin/models/load)
          ^---- LiveFleetController (--watch: /admin/swap, /admin/rollback)

SIGTERM or SIGINT (through :meth:`~...training.resilience.ShutdownCoordinator.add_callback`)
closes the router's admission at once; then the router waits for its
forwarded requests, every replica gets SIGTERM and drains its own work, in
parallel, and the fleet exits 0 only if the router went quiet and every
replica exited 0.

With ``watch_dir`` a :class:`~..live.LiveFleetController` rolls each new
checkpoint generation of that directory across the replicas (canary, the
router's split, the guard's verdict, promotion or rollback); it starts with
the fleet and stops first in the drain, so no swap reaches a draining fleet.
With a manifest and ``autoscale`` a :class:`~..multimodel.PlacementPolicy`
also decides which replicas host which models (:meth:`Fleet.placement_tick`),
and ``incidents_dir`` keeps its ledger.

With telemetry on, the router's :class:`~...alerting.AlertEngine` (the
router rules) is evaluated by an observer thread every
``observe_interval_s`` over the router's snapshot, the roster, the scrape
failures and the process sample (:meth:`Fleet.observe_tick`).
``incidents_dir`` also arms the router's
:class:`~...incidents.FlightRecorder` (a firing alert dumps a bundle there),
every replica's ``--incidents-dir``, ``--blackbox <dir>/blackbox/slot-N.json``
and ``--observe-interval-s``, and a crash bundle for each replica that dies
(:func:`~...incidents.write_crash_bundle`: the exit signal, its output tail,
argv, generation, the router's health history, its black box and the
router's own flight payload). With telemetry off none of it is built.
"""

from __future__ import annotations

import json
import logging
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ...training.resilience import ShutdownCoordinator, log_event
from .autoscaler import AutoscalerPolicy, observation_from_snapshots
from .replica import REPLICA_DRAIN_TIMEOUT_S, ReplicaSupervisor, build_serve_cmd
from .router import Router, RouterHTTPServer, RouterTelemetry

__all__ = ["FleetConfig", "Fleet"]

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

#: the canary guard's streaks: bad windows in a row that roll a generation
#: back, good windows in a row that promote it (JAX's defaults)
GUARD_BAD_CONSECUTIVE = 2
GUARD_GOOD_CONSECUTIVE = 3


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
    # the live rollout: a training run's checkpoint directory; each new
    # intact generation canaries on canary_fraction of the replicas (the
    # router splits traffic by generation), then the guard promotes it
    # fleet-wide or rolls it back on error rate or window p99
    watch_dir: Optional[str] = None
    watch_interval_s: float = 2.0
    canary_fraction: float = 0.25
    guard_p99_frac: float = 1.5
    guard_error_rate: float = 0.02
    guard_min_samples: int = 20
    guard_verdict_timeout_s: float = 120.0
    autoscale: bool = False
    p99_target_ms: float = 500.0
    autoscale_interval_s: float = 2.0
    up_consecutive: int = 3
    down_consecutive: int = 10
    cooldown_s: float = 30.0
    # the flight recorder's directory, fleet-wide (the router's bundles, the
    # replicas' alert bundles and black boxes, crash bundles) and the
    # placement ledger's (placement.jsonl); the recorder needs telemetry
    incidents_dir: Optional[str] = None
    observe_interval_s: float = 2.0
    # the router's reject burn-rate rule's SLO
    alert_slo: float = 0.99
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
        incidents = self.incidents_dir if self.telemetry else None
        return prefix + build_serve_cmd(
            self.model_path, device=self.device, port=port, host="127.0.0.1",
            max_batch=self.max_batch, max_wait_ms=self.max_wait_ms, queue_size=self.queue_size,
            timeout_ms=self.timeout_ms, max_doc_len=self.max_doc_len,
            drain_timeout_s=REPLICA_DRAIN_TIMEOUT_S, batching=self.batching,
            precision=self.precision, swap_dir=self.watch_dir, incidents_dir=incidents,
            blackbox=self.blackbox_path(slot) if incidents is not None else None,
            observe_interval_s=self.observe_interval_s if incidents is not None else None,
            no_telemetry=not self.telemetry, model_manifest=self.model_manifest,
            resident_models=self.resident_models)

    def blackbox_path(self, slot: int) -> str:
        """The black box of the replica in ``slot``: one file a slot, so a
        restarted replica's recorder takes over the file its predecessor's
        crash bundle was copied from."""
        return str(Path(self.incidents_dir) / "blackbox" / f"slot-{int(slot)}.json")

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
        # the alert engine whenever telemetry is on, the recorder and the
        # crash bundles only with an incidents directory; with telemetry off
        # neither exists, whatever incidents_dir says
        self.alerts = None
        self.recorder = None
        on_crash = None
        if config.telemetry:
            from ...alerting import AlertEngine, default_router_rules
            from ...incidents import FlightRecorder

            inc_dir = Path(config.incidents_dir) if config.incidents_dir else None
            if inc_dir is not None:
                self.recorder = FlightRecorder(incident_dir=inc_dir, process_name="router")
            self.alerts = AlertEngine(
                default_router_rules(p99_target_s=config.p99_target_ms / 1e3,
                                     slo=config.alert_slo),
                sink_path=inc_dir / "alerts.jsonl" if inc_dir is not None else None,
                on_firing=self.recorder.alert_hook() if self.recorder is not None else None,
                source="router")
            if self.recorder is not None:
                self.recorder.attach(trace=self.tel.trace, alerts_fn=self.alerts.states)
                on_crash = self._on_replica_crash
        self.supervisor = ReplicaSupervisor(config.build_cmd, build_env=config.build_env,
                                            on_crash=on_crash)
        self.registry = None
        if config.model_manifest:
            from ..multimodel import ModelRegistry

            self.registry = ModelRegistry.from_manifest(config.model_manifest)
        # the split is armed only with a watched directory, and acts only
        # while the controller declares a rollout
        self.router = Router(self.supervisor.handles, telemetry=self.tel,
                             cache_bytes=int(config.cache_mb * 1024 * 1024),
                             probe_interval_s=config.probe_interval_s,
                             length_routing=config.length_routing,
                             canary_fraction=config.canary_fraction if config.watch_dir else 0.0,
                             registry=self.registry)
        self.controller = None
        if config.watch_dir:
            from ..live import CanaryGuard, LiveFleetController

            self.controller = LiveFleetController(
                config.watch_dir, self.router, canary_fraction=config.canary_fraction,
                interval_s=config.watch_interval_s,
                guard=CanaryGuard(p99_frac=config.guard_p99_frac,
                                  error_rate_high=config.guard_error_rate,
                                  min_window_samples=config.guard_min_samples,
                                  min_canary_requests=config.guard_min_samples,
                                  bad_consecutive=GUARD_BAD_CONSECUTIVE,
                                  good_consecutive=GUARD_GOOD_CONSECUTIVE),
                verdict_timeout_s=config.guard_verdict_timeout_s)
        self.policy: Optional[AutoscalerPolicy] = None
        if config.autoscale:
            self.policy = AutoscalerPolicy(
                min_replicas=config.min_replicas, max_replicas=config.max_replicas,
                p99_target_s=config.p99_target_ms / 1e3, up_consecutive=config.up_consecutive,
                down_consecutive=config.down_consecutive, cooldown_s=config.cooldown_s)
        # with a manifest, each autoscale tick also decides which models need
        # another host (per-model window p99 against the tightest class
        # target), applied through /admin/models/load and kept in the ledger
        self.placement_policy = None
        self._placement_ledger: Optional[Path] = None
        if self.registry is not None and config.autoscale:
            from ..multimodel import PlacementPolicy

            self.placement_policy = PlacementPolicy(
                self.registry, default_p99_target_ms=config.p99_target_ms,
                breach_consecutive=config.up_consecutive, cooldown_s=config.cooldown_s)
            if config.incidents_dir:
                inc = Path(config.incidents_dir)
                inc.mkdir(parents=True, exist_ok=True)
                self._placement_ledger = inc / "placement.jsonl"
        self.router.alerts = self.alerts
        self.router.recorder = self.recorder
        self.httpd = RouterHTTPServer((config.host, config.port), self.router)
        self._stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None
        self._autoscale_thread: Optional[threading.Thread] = None
        self._observer_thread: Optional[threading.Thread] = None

    def _on_replica_crash(self, handle: Any, rc: int) -> None:
        """The supervisor's crash hook: one bundle for the dead replica, with
        the router's flight payload beside its black box so the postmortem's
        timeline crosses the two processes."""
        from ...incidents import write_crash_bundle

        write_crash_bundle(
            self.config.incidents_dir, process_name=f"replica-{handle.replica_id}", rc=rc,
            argv=self.config.build_cmd(handle.slot), output_tail=list(handle.tail),
            generation=handle.generation, health_history=list(handle.health_history),
            blackbox_path=self.config.blackbox_path(handle.slot),
            process_started_unix=handle.spawned_at_unix,
            extra_flights={"router": self.recorder.payload()}, replica_id=handle.replica_id,
            slot=handle.slot)

    def observe_tick(self) -> None:
        """One observer tick: the router's snapshot, the roster, the scrape
        failures and the router process's sample, into the recorder's ring
        and through the router rules (no replica is scraped)."""
        snap = {"router": self.tel.snapshot(),
                "replicas": [h.describe() for h in self.supervisor.handles()],
                "scrape_failures": self.router.scrape_failure_stats(),
                "process": self.tel.hoststats.sample()}
        if self.recorder is not None:
            self.recorder.record(snap)
        if self.alerts is not None:
            self.alerts.evaluate(snap)

    def _observe_loop(self) -> None:
        while True:
            try:
                self.observe_tick()
            except Exception:  # the observer must survive anything
                logger.exception("fleet observer tick failed")
            if self._stop.wait(self.config.observe_interval_s):
                return

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
        if self.alerts is not None or self.recorder is not None:
            self._observer_thread = threading.Thread(target=self._observe_loop,
                                                     name="fleet-observer", daemon=True)
            self._observer_thread.start()
        if self.controller is not None:
            self.controller.start()
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
        if self.placement_policy is not None:
            self.placement_tick(snaps)
        return desired

    def placement_tick(self, snaps: Optional[List[Dict[str, Any]]] = None):
        """The placement half of the scaling loop: the per-model window p99
        of the merged ``by_model`` view -> the models that need another
        host -> ``/admin/models/load`` and the ledger. Returns the decisions
        applied."""
        from ...training.telemetry import merge_serving_snapshots

        if snaps is None:
            snaps = self.router.scrape_replica_metrics()
        by_model: Dict[str, Dict[str, Any]] = {}
        for name, sub in (merge_serving_snapshots(snaps).get("by_model") or {}).items():
            win = (sub or {}).get("slo_window") or {}
            by_model[name] = {"p99": win.get("request_latency_p99"),
                              "samples": win.get("samples")}
        decisions = self.placement_policy.observe(
            by_model, self.router.placement(),
            [h.replica_id for h in self.router.ready_handles()])
        for d in decisions:
            try:
                status, _ = self.router.load_model(d.replica_id, d.model)
            except Exception as exc:  # a failed load is logged and ledgered
                status = None
                logger.warning("placement: load %r onto replica %d failed: %r",
                               d.model, d.replica_id, exc)
            log_event("placement-move",
                      f"model {d.model!r} -> replica {d.replica_id} (status {status}): "
                      f"{d.reason}", level=logging.INFO, model=d.model, replica=d.replica_id,
                      status=status)
            if self.tel is not None:
                self.tel.trace.add_instant("placement", cat="fleet",
                                           args={"model": d.model, "replica": d.replica_id})
                self.tel.registry.counter("placement_decisions").inc()
            if self._placement_ledger is not None:
                try:
                    with open(self._placement_ledger, "a", encoding="utf8") as fh:
                        fh.write(json.dumps({"unix_time": round(time.time(), 3),
                                             "model": d.model, "replica_id": d.replica_id,
                                             "status": status, "reason": d.reason}) + "\n")
                except OSError:
                    logger.exception("placement ledger append failed")
        return decisions

    def request_shutdown(self, signum: Optional[int] = None) -> None:
        """Signal-safe (a flag and an event): admission closes at once; the
        thread in :meth:`wait` does the drain."""
        self.router.draining = True
        self._stop.set()

    def wait(self) -> int:
        self._stop.wait()
        self.router.begin_drain()
        self.supervisor.begin_drain()  # a crash during the drain stays down
        if self.controller is not None:
            self.controller.stop()  # no swap into a draining fleet
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
