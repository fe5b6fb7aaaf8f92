"""One trainer-fleet worker: the pull -> grad -> push -> apply-wait loop
(``spacy_ray_tpu/training/fleet/worker.py``, its core).

Each of the N workers

* computes gradients on its own share of the corpus
  (:func:`~..batcher.shard_stream` by worker id);
* pushes each slice of its gradient to the slice's owner over HTTP (its own
  slice to its local :class:`~.peer.OwnerState`), with one bounded retry; a
  push that still fails is counted and dropped, never waited on. A push to a
  peer goes out in the codec both sides agree on (``grad_compression``,
  :func:`~.wire.negotiate_push_codec` against the peer's ``/healthz``) with
  error feedback per (peer, leaf) (:class:`~.wire.GradCompressor`); the
  worker's own slice goes to its owner uncompressed;
* waits (apply-wait) until its own slices' version passes the stamp it
  pushed against, at most ``quorum_wait_s``; a lost quorum is a counted
  timeout, not a wedge;
* pulls the other owners' newer slices at the top of the next step, through
  the staleness gate of :func:`train_fleet_worker`'s ``pull_peers``; with
  ``param_delta_window`` > 0 it asks for delta frames (the owners' wire
  chains, added onto the slices it holds) and takes a full frame when an
  owner cannot serve one.

The gradient clip: with a fused optimizer (``Adam.v1``, ``RAdam.v1``) the
worker scales its whole gradient by ``min(1, clip / max(gnorm, 1e-16))``
(the exact global norm of its gradient) and each owner runs the fused
update on its slice with the clip link off. Other optimizers run whole on
each slice, their clip norms taken over the slice.

The owner keeps its slice's parameters, moments and mean gradient on the
device in tensors that persist across applies (:class:`SliceApply`); the
apply copies the mean into them and never touches the model's own
parameters. The model takes the merged slices at pull time, in the training
thread.

Membership (``peer_lease_s > 0``): every worker leases its peers off
``/healthz`` on a thread of its own; the acting lead (the lowest active id
it still believes live) evicts a peer whose lease expired and that missed
``lease_miss_threshold`` probes in a row, admits queued joiners, bumps the
epoch and broadcasts the new membership. Each worker applies a membership
at a step boundary only (``apply_membership``): the slices re-shard over the
survivors (:class:`~.membership.RankedLayout`), the quorum re-resolves over
them, the owner is rebuilt over its new slices (its live moments kept when
its slices did not change; otherwise its moments and counts carved from the
last intact generation, fresh when there is none), and every frame from then
on carries the new epoch. Pulls from an unreachable owner back off
(:class:`~.membership.PeerBackoff`). ``peer_lease_s=0`` keeps the membership
the fleet started with.

Worker 0 logs and evaluates every ``eval_frequency`` steps and writes
``best-model/``. The lead (the lowest active id: worker 0 until it is
evicted) writes ``last-model/`` from the slices it pulled (the flat
``params.npz`` layout: either package loads them) and, every
``eval_frequency`` steps and at its end, commits a format-2 generation in
``last-model/`` (``fleet_checkpoint``): it writes its own optimizer part,
asks each peer for its part over ``POST /checkpoint`` (the owner writes it
and answers with its slices at that cut), merges the owners' slices into
the generation's params and commits the meta; a failed exchange aborts the
generation (``fleet-checkpoint-aborted``) and the previous one stays. An
acting lead other than worker 0 commits them without scores. With
``resume`` a worker continues the newest intact generation: its params,
step, epoch and best score, the membership it was committed under, this
owner's version, moments and counts, and this worker's seed generator; a
worker the generation no longer names asks to rejoin. A one-process ``train
--resume`` continues it too. As in the JAX package, the models hold the
slices as pulled at the top of the step they are written in.
At a clean end the lead writes its models and posts ``/finalize``; the
other workers keep serving its pulls and pushes until then (at most
``FINALIZE_WAIT_S``, or until the lead stops answering). Each worker writes
``fleet-worker-{k}.json``: counters, versions, its membership, the seconds
of each phase (data, pull, grad, push, apply_wait) in all and per step, the
wire codec's seconds a step within the push and pull phases (encoding the
pushes, decoding and merging the pulls), its losses, its kernels' launch
counts, whether and from which step it resumed, the parts it wrote, the
generations it committed and the wall time of its first push a peer
accepted; the run directory gets ``fleet-membership.jsonl``.

Resilience as in the one-process loop: the environment's fault plan and
the knobs' retry policy before the first read, the ``collate`` and ``step``
fault sites (a poisoned step reports a NaN loss), the wire sites
``param-pull``, ``grad-push`` and ``checkpoint-wire`` with the plan's wire
faults (corrupt, delay, dup, partition, heal), and the watchdog of
``[training] watchdog_timeout_s``, fed after each step. A pulled or pushed
frame and a checkpoint reply carry their CRC-32 in ``X-SRT-CRC32``; a
receiver refuses a frame whose bytes do not match it (a push: HTTP 400, a
counted discard at the owner and a failed push at the sender; a pull: a failed
pull; a checkpoint reply: the generation aborted).

Out of this piece (ROADMAP): the telemetry of a worker (``metrics_dir`` and
``metrics_port`` are refused), the dynamics histograms and alerts.
"""

from __future__ import annotations

import http.client
import io
import json
import random
import signal
import socket
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse

import numpy as np
import torch

from ...devices import DeviceLike, resolve_device
from ...models.core import param_paths
from ...ops import _cuda
from ...ops.fused_update import global_norm
from ...pipeline.language import Pipeline
from ...registry import registry
from .. import optimizers as _optimizers
from .. import resilience
from ..batcher import bucket_batch_size, bucket_length, shard_stream
from ..checkpoint import (
    CheckpointCorrupt, TrainCheckpoint, commit_fleet_generation, flatten, generator_state_hex,
    opt_part_name, set_generator_state, write_fleet_opt_part,
)
from ..resilience import RetryPolicy, Watchdog, log_event, maybe_fail, retry_io
from .membership import LeaseTracker, Membership, MembershipLedger, PeerBackoff
from .ownership import local_opt_from_canonical, opt_part_records, tree_from_flat
from .peer import FleetCounters, OwnerState, PeerServer
from .wire import (
    CRC_HEADER, GradCompressor, WireError, check_frame_crc, decode_arrays, decode_delta_frame,
    encode_arrays, frame_crc, negotiate_push_codec, resolve_grad_compression,
)

DEFAULT_FLEET_BASE_PORT = 47200
PHASES = ("data", "pull", "grad", "push", "apply_wait")
#: the wire codec's share of the push and pull phases, timed on its own;
#: ``crc`` is the frames' CRC-32, sent with a push and checked on a pull reply
CODEC_PARTS = ("push_encode", "pull_decode", "crc")
#: a failed push is retried this often (then counted and dropped)
PUSH_RETRIES = 1
#: how long a worker waits for every peer to answer ``/healthz`` at start
PEER_WAIT_S = 120.0
#: ... and a resumed one, which goes on without them after it: they may have
#: finished while it was down
REJOIN_WAIT_S = 15.0
#: how long a worker other than the lead keeps serving for the lead's
#: ``/finalize`` after its own last step
FINALIZE_WAIT_S = 600.0
#: how long the lead waits for a peer's answer to ``POST /checkpoint``: the
#: peer writes its optimizer part before it answers
CHECKPOINT_TIMEOUT_S = 600.0
#: the stamp a worker has pushed to an owner before its first push
_NEVER = -(10 ** 9)


def resolve_quorum(quorum: Optional[int], n_workers: int) -> int:
    """0 or None = auto: all workers but one, at least 1 (one lost worker
    cannot stall the fleet)."""
    if not quorum:
        return max(1, int(n_workers) - 1)
    return int(quorum)


class _PeerClient:
    """A persistent HTTP connection to one peer (keep-alive, one reconnect
    on a dead socket); every failure is an OSError."""

    def __init__(self, url: str, timeout: float = 10.0) -> None:
        parsed = urlparse(url)
        if parsed.scheme != "http":
            raise ValueError(f"fleet peers speak plain http, got {url!r}")
        self.host = parsed.hostname or "127.0.0.1"
        self.port = int(parsed.port or 80)
        self.timeout = float(timeout)
        self._conn: Optional[http.client.HTTPConnection] = None

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def request(self, method: str, path: str, body: Optional[bytes] = None,
                content_type: str = "application/octet-stream",
                headers: Optional[Dict[str, str]] = None) -> Tuple[int, Dict[str, str], bytes]:
        last: Optional[Exception] = None
        for _ in (0, 1):  # one transparent reconnect on a dead socket
            if self._conn is None:
                self._conn = http.client.HTTPConnection(self.host, self.port,
                                                        timeout=self.timeout)
            try:
                hdrs = {"Content-Type": content_type} if body else {}
                hdrs.update(headers or {})
                self._conn.request(method, path, body=body, headers=hdrs)
                resp = self._conn.getresponse()
                payload = resp.read()
                return resp.status, dict(resp.getheaders()), payload
            except (http.client.HTTPException, OSError, socket.timeout) as e:
                last = e
                self.close()
        raise OSError(f"peer {self.host}:{self.port} unreachable: {last}")


def merge_pulled(layout: Any, params_host: Any, owner: int, known: int,
                 body: bytes) -> Tuple[int, bool]:
    """Merge one ``/params`` reply body from ``owner`` into ``params_host``:
    a full frame over ``owner``'s slices, a delta frame (whose ``base`` must
    be ``known``) added onto them. Returns ``(version, is_delta)``. A
    malformed frame raises ``WireError``, ``KeyError``, ``TypeError`` or
    ``ValueError`` and changes nothing (the puller counts it as
    ``pull_failed``)."""
    meta, arrays = decode_arrays(body)
    version = int(meta["version"])
    if str(meta.get("codec") or "") != "delta":
        layout.merge_flat(params_host, owner, arrays)
        return version, False
    base = int(meta.get("base", -1))
    if base != known:
        raise WireError(f"delta frame base {base} does not match known version {known}")
    layout.merge_flat(params_host, owner, decode_delta_frame(meta, arrays), add=True)
    return version, True


def check_checkpoint_dir(out: Optional[Path], ckpt_dir: str) -> None:
    """Raise unless ``ckpt_dir`` is this worker's own ``<out>/last-model``:
    ``POST /checkpoint`` names the directory, and a request on the peer port
    must not make a worker write anywhere else (ROADMAP C55)."""
    if out is None or Path(ckpt_dir).resolve() != (Path(out) / "last-model").resolve():
        raise ValueError(f"this worker writes checkpoint parts only into its own output's "
                         f"last-model/, not {ckpt_dir!r}")


def clip_scale(gnorm: torch.Tensor, clip: float) -> torch.Tensor:
    """``min(1, clip / max(gnorm, 1e-16))`` in float32 on gnorm's device:
    the worker-side global-norm clip of a fused optimizer (an IEEE quotient:
    ``scalar / tensor`` would multiply by a reciprocal)."""
    g = torch.clamp(gnorm.to(torch.float32), min=1e-16)
    return torch.clamp(torch.full_like(g, clip).div(g), max=1.0)


class SliceApply:
    """An owner's optimizer over its slices, on one device: the slices'
    parameters, moments and mean gradient in tensors that live as long as
    the owner (the fused kernel's chunk table stays built), the mean copied
    in at each apply. ``apply(params, opt_state, grads)`` is the
    :class:`~.peer.OwnerState` apply function."""

    def __init__(self, optimizer: "_optimizers.Optimizer", device: torch.device) -> None:
        self.optimizer = optimizer
        self.device = device
        self._grads: Dict[str, torch.Tensor] = {}

    def init(self, flat: Dict[str, np.ndarray], opt_flat: Optional[Dict[str, np.ndarray]] = None
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """The slices' tensors and their optimizer state: fresh, or from
        ``opt_flat`` (:func:`~.ownership.local_opt_from_canonical`)."""
        params = {k: torch.tensor(np.ascontiguousarray(v, dtype=np.float32), device=self.device)
                  for k, v in flat.items()}
        self._grads = {k: torch.zeros_like(p) for k, p in params.items()}
        state = self.optimizer.init(params)
        if opt_flat is not None:
            self.optimizer.load_opt_state(state, opt_flat)
        return params, state

    def __call__(self, params: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
                 grads: Dict[str, np.ndarray]) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        with torch.no_grad():
            for k, g in grads.items():
                self._grads[k].copy_(torch.from_numpy(np.ascontiguousarray(g)))
            self.optimizer.update(params, self._grads, opt_state)
        return params, opt_state


def owner_optimizer(optimizer: "_optimizers.Optimizer") -> Tuple["_optimizers.Optimizer", float]:
    """``(the owners' optimizer, the workers' clip)``: a fused optimizer's
    chain with its clip link off and its clip moved to the worker; any other
    optimizer whole, clipping each slice by the slice's norm."""
    if isinstance(optimizer, _optimizers.FusedOptimizer):
        hyper = optimizer.hyper
        return _optimizers.FusedOptimizer(hyper._replace(grad_clip=0.0),
                                          optimizer.lr_fn), hyper.grad_clip
    log_event("fleet-per-shard-optimizer",
              "optimizer is not fused: the whole chain (its global-norm clip too) runs on "
              "each owner's slice, so clip norms are per slice, not global")
    return optimizer, 0.0


def refuse_fleet_telemetry(metrics_dir: Any, metrics_port: Any) -> None:
    """A fleet worker's telemetry (its metrics rows, endpoint, divergence
    detector and dynamics histograms) waits for ROADMAP Queue A item 4.3:
    asking for it raises instead of training without it."""
    if metrics_dir or metrics_port:
        raise ValueError(
            "fleet mode: a fleet worker's telemetry (metrics_dir / metrics_port) is not "
            "part of the port yet (ROADMAP.md Queue A item 4.3, fleet telemetry) — drop "
            "--metrics-dir/--metrics-port or train in one process")


def _check_fleet_config(T: Dict[str, Any], nlp: Pipeline, optimizer: Any) -> None:
    if int(T.get("accumulate_gradient") or 1) != 1:
        raise ValueError("fleet mode: accumulate_gradient > 1 is not supported — the quorum "
                         "is the accumulation")
    for key in ("annotating_components", "frozen_components"):
        if T.get(key):
            raise ValueError(f"fleet mode does not support {key} yet")
    if T.get("before_update"):
        raise ValueError("fleet mode does not run [training.before_update]")
    if optimizer.use_averages:
        raise ValueError("fleet mode does not support use_averages (the running mean needs "
                         "every applied parameter on one worker)")
    frozen = [k for k in param_paths(nlp.model) if _optimizers.is_frozen(k)]
    if frozen:
        raise ValueError(f"fleet mode does not train pipelines with frozen tables yet "
                         f"({frozen[0]}, ...)")


def train_fleet_worker(
    config: Any,
    output_path: Optional[Path] = None,
    *,
    worker_id: int,
    n_workers: int,
    quorum: int = 0,
    max_staleness: int = 1,
    base_port: int = DEFAULT_FLEET_BASE_PORT,
    port: Optional[int] = None,
    peer_urls: Optional[List[str]] = None,
    device: DeviceLike = None,
    stdout_log: bool = True,
    max_steps_override: Optional[int] = None,
    quorum_wait_s: float = 30.0,
    peer_lease_s: float = 60.0,
    lease_miss_threshold: int = 3,
    lease_poll_s: float = 2.0,
    probe_timeout_s: Optional[float] = None,
    grad_compression: str = "auto",
    param_delta_window: int = 4,
    grad_error_feedback: bool = True,
    resume: bool = False,
    metrics_dir: Optional[Path] = None,
    metrics_port: Optional[int] = None,
) -> Tuple[Pipeline, Any]:
    """Run one fleet worker; returns ``(nlp, TrainResult)`` as
    :func:`~..loop.train` does (whose ``fleet=`` mode calls this), with
    ``result.fleet`` holding the worker's ledger.

    Worker ``k`` serves its peer endpoint on ``127.0.0.1:base_port + k``
    (``port`` overrides it); its peers are ``peer_urls`` or
    ``http://127.0.0.1:base_port + i``. ``[training] fleet_peer_timeout_s``
    bounds each peer request. ``peer_lease_s`` > 0 arms membership (the
    module docstring): a peer is evicted once its lease expired and it
    missed ``lease_miss_threshold`` probes in a row, probed every
    ``lease_poll_s`` (at least 0.2) seconds, each probe bounded by
    ``probe_timeout_s`` (default ``[training] fleet_probe_timeout_s``); 0
    keeps the starting membership. ``grad_compression`` (``auto``, ``f32``,
    ``bf16``, ``int8``) is the push codec, resolved once against the device
    (:func:`~.wire.resolve_grad_compression`: ``auto`` is int8 on ``cpu``,
    bf16 on ``cuda``); ``param_delta_window`` is how many versions of
    compressed deltas an owner keeps for pulls (0: full pulls only); both
    fall back to f32 against a peer that does not advertise them.
    ``grad_error_feedback=False`` is the ablation of the error feedback,
    never for real runs. ``resume`` continues the newest intact generation in
    ``<output_path>/last-model`` (the module docstring), from scratch when
    there is none (``resume-failed``); :data:`CHECKPOINT_TIMEOUT_S` bounds
    the lead's ``POST /checkpoint`` to each peer. On the main thread, SIGTERM and
    SIGINT stop the worker at its next step (``result.interrupted``). Runs on
    ``cuda`` unless ``device`` is ``"cpu"``. A worker's telemetry is not part
    of the port yet: ``metrics_dir`` or ``metrics_port`` (here or in
    ``[training]``) raises."""
    from ..loop import (
        TrainResult, _named_params, _resolve_corpus, check_component_lists,
        default_pipeline_score_weights, resolve_training, weighted_score,
    )

    worker_id, n_workers = int(worker_id), int(n_workers)
    if not (0 <= worker_id < n_workers):
        raise ValueError(f"fleet worker id {worker_id} outside [0, {n_workers})")
    quorum_requested = int(quorum or 0)
    quorum = resolve_quorum(quorum, n_workers)
    if not (1 <= quorum <= n_workers):
        raise ValueError(f"quorum {quorum} outside [1, {n_workers}]")
    max_staleness = int(max_staleness)
    if max_staleness < 0:
        raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
    peer_lease_s = float(peer_lease_s)
    if peer_lease_s < 0:
        raise ValueError(f"peer_lease_s must be >= 0, got {peer_lease_s}")
    lease_miss_threshold = max(1, int(lease_miss_threshold))
    lease_poll_s = max(0.2, float(lease_poll_s))

    def quorum_for(n_active: int) -> int:
        """The quorum after a membership change: auto re-resolves over the
        survivors; an explicit quorum is clamped so that they can reach it."""
        if quorum_requested <= 0:
            return resolve_quorum(0, n_active)
        return max(1, min(quorum_requested, n_active))

    config = config.interpolate()
    T = resolve_training(config)
    refuse_fleet_telemetry(metrics_dir or T["metrics_dir"],
                           metrics_port if metrics_port is not None else T["metrics_port"])
    dev = resolve_device(device)
    peer_timeout = float(T.get("fleet_peer_timeout_s") or 10.0)
    probe_timeout = float(probe_timeout_s if probe_timeout_s is not None
                          else T.get("fleet_probe_timeout_s") or 5.0)
    if peer_timeout <= 0 or probe_timeout <= 0:
        raise ValueError("fleet_peer_timeout_s and fleet_probe_timeout_s must be > 0")
    seed = int(T.get("seed") or 0)
    random.seed(seed)
    np.random.seed(seed)
    resilience.activate_env_fault_plan()
    resilience.drain_events()
    resilience.set_default_retry_policy(RetryPolicy(
        max_retries=int(T["io_retries"]), base_delay=float(T["io_retry_base_s"])))

    corpora = {name: registry.resolve(block)
               for name, block in config.get("corpora", {}).items()}
    train_corpus = _resolve_corpus(config, corpora, T["train_corpus"])
    dev_corpus = _resolve_corpus(config, corpora, T["dev_corpus"])
    nlp = Pipeline.from_config(config, device=dev)
    nlp.initialize(train_corpus, seed=seed)
    check_component_lists(nlp, T)
    optimizer = registry.resolve(T.get("optimizer") or {"@optimizers": "Adam.v1"})
    if not isinstance(optimizer, _optimizers.Optimizer):
        raise TypeError("[training.optimizer] did not resolve to an optimizer")
    _check_fleet_config(T, nlp, optimizer)
    nlp.requires_grad_(True)
    params = _named_params(nlp)
    owner_opt, worker_clip = owner_optimizer(optimizer)
    batcher = registry.resolve(T.get("batcher") or {
        "@batchers": "spacy.batch_by_words.v1", "size": 1000, "tolerance": 0.2})
    dropout = float(T["dropout"])
    # one dropout seed a step, from a generator of this worker's own
    seeds = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, worker_id]).generate_state(2, np.uint64)[0] >> 1))

    out = Path(output_path) if output_path is not None else None
    step = epoch = 0
    best_score, best_step = -1.0, -1
    version = 0
    resumed_from: Optional[int] = None
    membership = Membership(range(n_workers))
    ckpt: Optional[Dict[str, Any]] = None
    if resume and out is not None:
        try:
            ckpt = TrainCheckpoint.load(out / "last-model")
        except CheckpointCorrupt as e:
            log_event("resume-failed", f"--resume found no intact checkpoint generation ({e}); "
                      "starting from scratch", worker=worker_id)
    if ckpt is not None:
        nlp.load_params(ckpt["params"])
        step, epoch = int(ckpt["step"]), int(ckpt["epoch"])
        best_score, best_step = float(ckpt["best_score"]), int(ckpt["best_step"])
        resumed_from = step
        fleet_extra = (ckpt.get("extra") or {}).get("fleet") or {}
        if fleet_extra.get("active"):
            # resume into the membership the generation was committed under
            try:
                ck_active = [int(a) for a in fleet_extra["active"]]
                if not all(0 <= a < n_workers for a in ck_active):
                    raise ValueError(f"ids {ck_active} outside [0, {n_workers})")
                membership = Membership(ck_active, int(fleet_extra.get("epoch") or 0))
            except (TypeError, ValueError) as e:
                log_event("fleet-resume-membership-invalid",
                          f"checkpoint extra.fleet.active is malformed ({e}); assuming the full "
                          "nominal fleet at epoch 0", worker=worker_id)
        versions = fleet_extra.get("versions") or []
        if worker_id < len(versions) and versions[worker_id] is not None:
            version = int(versions[worker_id])
        rngs = fleet_extra.get("rngs") or []
        if worker_id < len(rngs):
            # each worker's torch.Generator state, as hex (ROADMAP C53)
            set_generator_state(seeds, rngs[worker_id])
        log_event("fleet-resume", f"worker {worker_id} resumed from checkpoint step {step} "
                  f"(shard version {version})", worker=worker_id, step=step, version=version)
    # the host tree of the whole model: pulls merge into it, the model takes it
    params_host = tree_from_flat({k: p.detach().to("cpu", copy=True).numpy()
                                  for k, p in params.items()})
    host_leaves = flatten(params_host)  # the same arrays, by path: merges write into them
    layout = membership.layout(params_host)
    quorum = quorum_for(len(membership.active))
    # one codec a process; the codec of each push is negotiated against what
    # its peer's /healthz advertises, so an f32-only peer gets f32 frames
    wire_codec, wire_reason = resolve_grad_compression(grad_compression, dev.type)
    param_delta_window = max(0, int(param_delta_window))
    compressor = GradCompressor(wire_codec, error_feedback=bool(grad_error_feedback))
    peer_codecs: Dict[int, Any] = {}
    log_event("fleet-wire-codec", f"worker {worker_id}: grad compression {grad_compression} "
              f"-> {wire_codec} ({wire_reason}); param delta window {param_delta_window}",
              worker=worker_id, codec=wire_codec, delta_window=param_delta_window)
    counters = FleetCounters()
    slice_apply = SliceApply(owner_opt, dev)
    slice_flat = layout.flat_slices(params_host, worker_id)
    opt_source, opt_step = "init", None
    local_opt = None
    if ckpt is not None and worker_id in membership:
        local_opt = local_opt_from_canonical(owner_opt, layout, ckpt["opt_state"], worker_id,
                                             slice_flat)
        opt_source, opt_step = "checkpoint", resumed_from
    ckpt = None  # drop the loaded full trees
    slice_params, slice_opt = slice_apply.init(slice_flat, local_opt)
    owner = OwnerState(worker_id=worker_id, n_workers=n_workers, quorum=quorum,
                       max_staleness=max_staleness, apply_fn=slice_apply,
                       slice_params=slice_params, opt_state=slice_opt, counters=counters,
                       version=version, delta_window=param_delta_window,
                       delta_codec=wire_codec)
    owns_any = bool(layout.owned_keys(worker_id))
    if worker_id not in membership:
        # the generation was committed after this worker's eviction: it asks
        # the acting lead to admit it once its peers answer; until then every
        # frame it sends is fenced
        log_event("fleet-resume-evicted", f"worker {worker_id} resumed into membership epoch "
                  f"{membership.epoch} which no longer names it (active "
                  f"{list(membership.active)}) — requesting rejoin", worker=worker_id,
                  epoch=membership.epoch, active=list(membership.active))
    elif not owns_any:
        log_event("fleet-worker-owns-nothing",
                  f"worker {worker_id} owns no parameter slices at n_workers={n_workers} (no "
                  "axis divisible); it pushes gradients but applies nothing",
                  worker=worker_id, n_workers=n_workers)

    def owner_record(opt_source: str, opt_step: Optional[int] = None) -> Dict[str, Any]:
        """What the owner of this epoch holds, with the version and K5 count
        it starts from (the ledger's ``owner_epochs``); ``opt_source`` says
        where its moments came from (``init``, ``live``, ``checkpoint`` at
        generation ``opt_step``, ``fresh-init``)."""
        return {"epoch": membership.epoch, "active": list(membership.active),
                "quorum": quorum, "opt_source": opt_source, "opt_step": opt_step,
                "owned_shapes": {k: list(np.shape(v)) for k, v in owner.params.items()},
                "version_start": owner.version,
                "k5_start": _cuda.launch_counts().get("fused_update", 0)}

    owner_log = [owner_record(opt_source, opt_step)]
    retired_apply_s = 0.0  # the apply seconds of the owners re-shards replaced

    phases: Dict[str, float] = {p: 0.0 for p in PHASES}
    phase_steps: Dict[str, List[float]] = {p: [] for p in PHASES}
    codec_steps: Dict[str, List[float]] = {p: [] for p in CODEC_PARTS}
    codec_now: Dict[str, float] = {p: 0.0 for p in CODEC_PARTS}
    # the (step, seed-generator state) a checkpoint part records: the training
    # thread's as of its last step boundary, replaced whole so that a handler
    # thread reads one pair
    step_cut: List[Tuple[int, str]] = [(step, generator_state_hex(seeds))]
    swap_lock = threading.Lock()  # a re-shard's swap of membership, layout and owner
    written_parts: List[str] = []

    def checkpoint_cb(ckpt_dir: str, stamp: int) -> Dict[str, Any]:
        """This owner's part of generation ``stamp`` (``POST /checkpoint``, or
        the lead's own): written under the owner's lock, returned with the
        slices of the same cut. Only into this worker's own
        ``<output>/last-model``."""
        check_checkpoint_dir(out, ckpt_dir)
        with swap_lock:  # one membership's layout and owner
            lay, member, own = layout, membership, owner
        rank = lay.rank_of(worker_id)
        if rank is None:
            raise ValueError(f"worker {worker_id} is not in membership epoch {member.epoch} "
                             "— cannot contribute a checkpoint part")

        def writer(cur_version: int, opt_state: Any,
                   host_flat: Dict[str, np.ndarray]) -> Tuple[int, str, Dict[str, np.ndarray]]:
            n_leaves, records = opt_part_records(owner_opt, params_host, lay, opt_state,
                                                 worker_id)
            digest = write_fleet_opt_part(ckpt_dir, stamp=stamp, part=rank,
                                          parts=len(member.active), n_leaves=n_leaves,
                                          records=records)
            return cur_version, digest, host_flat

        cur_version, digest, host_flat = own.checkpoint_parts(writer)
        written_parts.append(opt_part_name(stamp, rank, len(member.active)))
        cut_step, cut_rng = step_cut[0]
        return {"meta": {"digest": digest, "version": cur_version, "part": rank,
                         "step": int(cut_step), "rng": cut_rng},
                "params": host_flat}

    server = PeerServer(owner, worker_id=worker_id, layout_signature=layout.signature(),
                        counters=counters,
                        port=int(port) if port is not None else int(base_port) + worker_id,
                        phases=lambda: dict(phases), checkpoint_cb=checkpoint_cb)
    server.set_membership(membership, layout.signature())
    server.start()
    urls = list(peer_urls) if peer_urls is not None else [
        f"http://127.0.0.1:{int(base_port) + i}" for i in range(n_workers)]
    if len(urls) != n_workers:
        server.stop()
        raise ValueError(f"peer_urls names {len(urls)} workers, fleet has {n_workers}")
    clients = {w: _PeerClient(urls[w], timeout=peer_timeout)
               for w in membership.active if w != worker_id}
    # the lead's /checkpoint exchanges: an owner answers only after its part
    # is written, so they get clients with a deadline of their own
    ckpt_clients: Dict[int, _PeerClient] = {}
    # what an exchange with each peer would cost as an f32 frame: the
    # _uncompressed counters' measure (the slices' shapes are fixed within
    # a membership)
    wire_full_bytes: Dict[int, int] = {}

    def measure_full_bytes() -> None:
        wire_full_bytes.clear()
        for w in clients:
            flat_w = layout.flat_slices(params_host, w)
            if flat_w:
                wire_full_bytes[w] = len(encode_arrays(
                    {"worker": worker_id, "stamp": 0},
                    {k: np.asarray(v, np.float32) for k, v in flat_w.items()}))

    measure_full_bytes()
    push_policy = RetryPolicy(max_retries=PUSH_RETRIES, base_delay=0.05,
                              max_delay=1.0)
    known: Dict[int, int] = {w: -1 for w in clients}
    last_stamp: Dict[int, int] = {w: _NEVER for w in clients}
    stop_requested = threading.Event()
    member_ledger = MembershipLedger(out / "fleet-membership.jsonl" if out is not None else None)
    backoff = PeerBackoff(base_s=1.0, cap_s=max(1.0, min(30.0, float(quorum_wait_s))))

    drifted: set = set()  # peers seen at another membership epoch

    def wait_for_peers() -> None:
        """Block until every peer answers ``/healthz`` with this layout's
        signature. A peer at another membership epoch (the fleet re-sharded
        while this worker was down) is synced after, not a failure. A cold
        start raises when a peer runs another layout or none answers in
        ``PEER_WAIT_S``; a resumed worker goes on after ``REJOIN_WAIT_S``
        (its peers may have finished; what it then fails to reach is
        counted)."""
        rejoining = resumed_from is not None
        wait_s = min(PEER_WAIT_S, REJOIN_WAIT_S) if rejoining else PEER_WAIT_S
        deadline = time.monotonic() + wait_s
        pending = set(clients)
        while pending:
            for w in sorted(pending):
                try:
                    status, _, body = clients[w].request("GET", "/healthz")
                except OSError:
                    continue
                if status != 200:
                    continue
                health = json.loads(body.decode("utf8"))
                peer_codecs[w] = health.get("codecs")  # none: it gets f32 pushes
                sig = health.get("layout")
                if sig != layout.signature():
                    peer_epoch = health.get("epoch")
                    if isinstance(peer_epoch, int) and not isinstance(peer_epoch, bool) \
                            and peer_epoch != membership.epoch:
                        log_event("fleet-membership-drift",
                                  f"worker {w} is at membership epoch {peer_epoch}, we are at "
                                  f"{membership.epoch} — syncing membership instead of failing "
                                  "the layout check", worker=worker_id, peer=w,
                                  peer_epoch=peer_epoch, epoch=membership.epoch)
                        drifted.add(w)
                        pending.discard(w)
                        continue
                    raise RuntimeError(
                        f"fleet worker {w} runs a different parameter layout ({sig} vs "
                        f"{layout.signature()}) — all workers must resolve the same config")
                pending.discard(w)
            if pending:
                if stop_requested.is_set() or (time.monotonic() > deadline and not rejoining):
                    raise RuntimeError(f"fleet peers never became reachable: {sorted(pending)} "
                                       f"(waited {wait_s:.0f}s)")
                if time.monotonic() > deadline:
                    log_event("fleet-peers-unreachable",
                              f"rejoined worker {worker_id}: peers {sorted(pending)} "
                              f"unreachable after {wait_s:.0f}s — proceeding (they may have "
                              "finished; lost RPCs are counted)", worker=worker_id,
                              peers=sorted(pending))
                    return
                time.sleep(0.1)

    join_sent = [-float("inf")]

    def request_join(m: Membership) -> None:
        """Ask ``m``'s lead to admit this worker at its next verdict; at most
        one request every 5 s (a fenced worker hits a fence every step)."""
        now = time.monotonic()
        if now - join_sent[0] < 5.0 or m.lead == worker_id:
            return
        join_sent[0] = now
        client = clients.get(m.lead)
        if client is None:
            client = clients[m.lead] = _PeerClient(urls[m.lead], timeout=peer_timeout)
        try:
            client.request("POST", "/membership/join",
                           body=json.dumps({"worker": worker_id}).encode("utf8"),
                           content_type="application/json")
        except OSError:
            return
        member_ledger.append("join-requested", worker=worker_id, epoch=m.epoch)
        log_event("fleet-join-requested", f"worker {worker_id} asked lead {m.lead} to rejoin "
                  f"the fleet (their membership epoch {m.epoch})", worker=worker_id,
                  lead=m.lead, epoch=m.epoch)

    def refresh_membership(w: int) -> None:
        """After a fence: take peer ``w``'s membership when it is newer (queued
        for the next step boundary), or ask to rejoin when it no longer names
        this worker. The training thread's (it shares the clients)."""
        client = clients.get(w)
        if client is None:
            return
        try:
            status, _, body = client.request("GET", "/membership")
            if status != 200:
                return
            m = Membership.from_wire(json.loads(body.decode("utf8")))
        except (OSError, ValueError):
            return
        if m.epoch <= membership.epoch:
            return
        if worker_id in m:
            server.queue_membership(m)
        else:
            request_join(m)

    def apply_membership(new_m: Membership) -> None:
        """The re-shard, at a step boundary only: retire the owner (after its
        apply in flight), fold its newest slices into ``params_host``, lay
        the slices out over ``new_m``'s active ids, rebuild the owner over
        its new slices (its live moments kept when they did not change;
        otherwise moments and counts carved from the last intact generation
        in ``last-model/``, fresh when there is none) and stamp the new
        epoch on what follows."""
        nonlocal membership, layout, owner, owns_any, quorum, slice_apply, retired_apply_s
        old_m, old_layout, old_owner = membership, layout, owner
        was_active = worker_id in old_m
        old_owner.retire()
        retired_apply_s += old_owner.apply_seconds
        if was_active:
            old_layout.merge_flat(params_host, worker_id, old_owner.current_flat()[1])
        old_index = {k: old_layout.key_index(k, worker_id)
                     for k in (old_layout.owned_keys(worker_id) if was_active else ())}
        new_layout = new_m.layout(params_host)
        quorum = quorum_for(len(new_m.active))
        now_active = worker_id in new_m
        owned = new_layout.owned_keys(worker_id)
        changed = [k for k in owned
                   if k not in old_index or old_index[k] != new_layout.key_index(k, worker_id)]
        opt_source, opt_step, opt_error = "fresh-init", None, None
        if now_active and not changed and set(owned) == set(old_index):
            # the same slices (a peer this worker took nothing from left):
            # the live tensors and moments go on; the old owner applies no more
            slice_params, slice_opt, opt_source = old_owner.params, old_owner.opt_state, "live"
        else:
            slice_apply = SliceApply(owner_opt, dev)
            slice_flat = new_layout.flat_slices(params_host, worker_id)
            local_opt, opt_error = None, "no output directory"
            if now_active and out is not None:
                try:
                    ck2 = TrainCheckpoint.load(out / "last-model")
                    local_opt = local_opt_from_canonical(owner_opt, new_layout,
                                                         ck2["opt_state"], worker_id, slice_flat)
                    opt_source, opt_step, opt_error = "checkpoint", int(ck2["step"]), None
                except (CheckpointCorrupt, OSError, KeyError, ValueError, TypeError) as e:
                    # a missing generation and a drifted optimizer or config
                    # both end here: the cause goes into the event and the row
                    opt_error = f"{type(e).__name__}: {e}"
            slice_params, slice_opt = slice_apply.init(slice_flat, local_opt)
            if local_opt is None and owned:
                log_event("fleet-opt-reinit", f"worker {worker_id}: no intact fleet checkpoint "
                          f"to carve adopted optimizer state from ({opt_error}) — fresh "
                          f"moments for {len(owned)} slices, {len(changed)} of them re-sharded",
                          worker=worker_id, epoch=new_m.epoch, resharded=len(changed),
                          cause=opt_error)
        new_owner = OwnerState(worker_id=worker_id, n_workers=n_workers, quorum=quorum,
                               max_staleness=max_staleness, apply_fn=slice_apply,
                               slice_params=slice_params, opt_state=slice_opt,
                               counters=counters, version=old_owner.version,
                               delta_window=param_delta_window, delta_codec=wire_codec)
        with swap_lock:
            membership, layout, owner = new_m, new_layout, new_owner
        server.set_owner(owner)
        server.set_membership(membership, layout.signature())
        owns_any = bool(owned)
        for w in [w for w in clients if w not in membership]:
            clients.pop(w).close()
            gone = ckpt_clients.pop(w, None)
            if gone is not None:
                gone.close()
            known.pop(w, None)
            last_stamp.pop(w, None)
            peer_codecs.pop(w, None)
        for w in membership.active:
            if w != worker_id and w not in clients:
                clients[w] = _PeerClient(urls[w], timeout=peer_timeout)
                try:
                    status, _, body = clients[w].request("GET", "/healthz")
                    if status == 200:
                        peer_codecs[w] = json.loads(body.decode("utf8")).get("codecs")
                except (OSError, ValueError):
                    pass
        # the old epoch's versions and delta chains describe another slice
        # geometry: pull whole; and the push residuals belong to its slices
        for w in clients:
            known[w], last_stamp[w] = -1, _NEVER
        measure_full_bytes()
        compressor.reset()
        if changed:
            counters.inc("shards_adopted", len(changed))
        owner_log.append(owner_record(opt_source, opt_step))
        member_ledger.append("apply", worker=worker_id, epoch=membership.epoch,
                             active=list(membership.active), resharded=len(changed),
                             opt_source=opt_source, opt_step=opt_step, opt_error=opt_error,
                             quorum=quorum,
                             version=owner.version, step=step)
        log_event("fleet-membership-applied", f"worker {worker_id}: membership epoch "
                  f"{membership.epoch} applied (active {list(membership.active)}, "
                  f"{len(changed)} slices re-sharded, optimizer {opt_source})",
                  worker=worker_id, epoch=membership.epoch, active=list(membership.active),
                  resharded=len(changed))
        if was_active and not now_active:
            log_event("fleet-self-evicted", f"worker {worker_id}: membership epoch "
                      f"{membership.epoch} no longer names this worker — requesting rejoin",
                      worker=worker_id, epoch=membership.epoch)
            request_join(membership)

    def pull_peers() -> Dict[int, int]:
        """Refresh non-owned shards; returns the version stamps the next
        push will carry (per owner).

        The staleness gate: a worker may run at most ``max_staleness``
        rounds ahead of any owner — it blocks (bounded by
        ``quorum_wait_s``) until owner ``w``'s version has passed
        ``last_stamp[w] - S``, i.e. until the round it last contributed
        to has closed, S rounds of slack allowed. At S=0 this is what
        makes quorum=N synchronous-equivalent: without it a fast worker
        re-pulls an owner mid-round, stamps the OLD version, and its
        push is discarded — wedging the round it was needed for.

        Every pull carries this worker's epoch; a 409 (the owner re-sharded
        past it) syncs the membership instead of merging. An owner that is
        unreachable, or misses the gate's deadline, costs one event and a
        backoff during which it is not asked."""
        self_version, self_flat = owner.current_flat()
        if worker_id in membership:
            layout.merge_flat(params_host, worker_id, self_flat)
        stamps = {worker_id: self_version}
        deadline = time.monotonic() + float(quorum_wait_s)
        headers = {"X-SRT-Epoch": str(membership.epoch)}
        if param_delta_window > 0:
            # an owner that cannot serve a delta answers with the full frame
            headers["X-SRT-Accept"] = "delta"
        fenced_by: Optional[int] = None
        for w, client in list(clients.items()):
            if backoff.skip(w):
                stamps[w] = known.get(w, -1)
                continue
            timed_out = unreachable = False
            while True:
                try:
                    if resilience.partitioned(w):
                        raise OSError(f"peer {w} partitioned (fault plan)")
                    maybe_fail("param-pull")
                    act = resilience.consume_wire_fault("param-pull")
                    if act is not None and act[0] == "delay":
                        time.sleep(float(act[1] or 1.0))
                    status, resp_headers, body = client.request(
                        "GET", f"/params?known={known[w]}", headers=headers)
                    if act is not None and act[0] == "dup":
                        # an idempotent GET: the second reply wins
                        status, resp_headers, body = client.request(
                            "GET", f"/params?known={known[w]}", headers=headers)
                    if act is not None and act[0] == "corrupt":
                        body = resilience.corrupt_bytes(body)
                except (OSError, resilience.FaultInjected):
                    counters.inc("pull_failed")
                    unreachable = True
                    break
                if status == 204:
                    v = int(resp_headers.get("X-SRT-Version", known[w]))
                elif status == 409:
                    fenced_by = w
                    break
                elif status == 200:
                    t_crc = time.perf_counter()
                    try:
                        check_frame_crc(body, resp_headers)
                    except WireError:
                        counters.refuse_crc()
                        counters.inc("pull_failed")
                        break
                    finally:
                        codec_now["crc"] += time.perf_counter() - t_crc
                    t_dec = time.perf_counter()
                    try:
                        v, is_delta = merge_pulled(layout, params_host, w, known[w], body)
                    except (WireError, KeyError, TypeError, ValueError):
                        counters.inc("pull_failed")
                        break
                    finally:
                        codec_now["pull_decode"] += time.perf_counter() - t_dec
                    counters.inc("wire_pull_bytes", len(body))
                    counters.inc("wire_pull_bytes_uncompressed",
                                 wire_full_bytes.get(w, len(body)) if is_delta else len(body))
                    if v < known[w]:
                        # a restarted owner is back at its checkpointed version:
                        # the rounds counted against its old lineage are void,
                        # or the staleness gate would wait for versions that
                        # will not come
                        last_stamp[w] = _NEVER
                        log_event("fleet-owner-regressed", f"owner {w} regressed to version "
                                  f"{v} (knew {known[w]}) — it restarted from its checkpoint; "
                                  "resyncing", owner=w, version=v, known=known[w])
                    known[w] = v
                else:
                    counters.inc("pull_failed")
                    break
                if v > last_stamp[w] - max_staleness or timed_out:
                    stamps[w] = v
                    break
                if time.monotonic() > deadline or stop_requested.is_set():
                    timed_out = True  # one last fetch, then go on
                    counters.inc("pull_wait_timeouts")
                    continue
                time.sleep(0.01)
            if unreachable or timed_out:
                if backoff.record_failure(w):
                    reason = "unreachable" if unreachable else "deadline"
                    log_event("fleet-peer-unreachable",
                              f"worker {worker_id}: owner {w} "
                              f"{'unreachable' if unreachable else 'missed its staleness deadline'}"
                              f" — pulls back off (cap {backoff.cap_s:.0f}s) until it answers",
                              worker=worker_id, owner=w, reason=reason)
            elif fenced_by != w and backoff.record_success(w):
                log_event("fleet-peer-recovered", f"worker {worker_id}: owner {w} answers "
                          "again — backoff cleared", worker=worker_id, owner=w)
            stamps.setdefault(w, known.get(w, -1))
        if fenced_by is not None:
            refresh_membership(fenced_by)
        return stamps

    def load_into_model() -> None:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(torch.from_numpy(host_leaves[k]))

    first_accepted: List[Optional[float]] = [None]  # wall time of the first push a peer took

    def push_grads(grads: Dict[str, Any], stamps: Dict[int, int]) -> None:
        """Each owner's slice of ``grads`` to its owner, stamped with the
        epoch, in the codec negotiated with it (error feedback per peer); a
        fenced reply syncs the membership."""
        fenced_peer: List[int] = []
        for w in list(membership.active):
            flat = layout.flat_slices(grads, w)
            if not flat:
                continue
            if w == worker_id:
                # not counted as a push: grad_pushed is the traffic to peers
                owner.submit(worker_id, stamps[worker_id], flat)
                continue
            if w not in clients:
                continue
            stamp = int(stamps.get(w, -1))
            codec_w = negotiate_push_codec(wire_codec, peer_codecs.get(w))
            t_enc = time.perf_counter()
            body = compressor.encode(w, {"worker": worker_id, "stamp": stamp,
                                         "epoch": int(membership.epoch)}, flat, codec_w)
            t_crc = time.perf_counter()
            codec_now["push_encode"] += t_crc - t_enc
            crc = {CRC_HEADER: frame_crc(body)}
            codec_now["crc"] += time.perf_counter() - t_crc
            # a wire fault covers one frame: a corrupted body stays corrupted
            # through the retries (the owner refuses it each time)
            act = resilience.consume_wire_fault("grad-push")
            if act is not None and act[0] == "corrupt":
                body = resilience.corrupt_bytes(body)
            elif act is not None and act[0] == "delay":
                time.sleep(float(act[1] or 1.0))
            dup = act is not None and act[0] == "dup"

            def send(w=w, body=body, dup=dup) -> None:
                maybe_fail("grad-push")
                if resilience.partitioned(w):
                    raise OSError(f"peer {w} partitioned (fault plan)")
                status, _, reply = clients[w].request("POST", "/grad", body=body, headers=crc)
                if status != 200:
                    raise OSError(f"peer {w} rejected grad push: HTTP {status}")
                if dup:
                    # the owner takes one contribution per (worker, stamp): the
                    # twin is a counted discard, never a second apply
                    clients[w].request("POST", "/grad", body=body, headers=crc)
                try:
                    answer = json.loads(reply.decode("utf8"))
                    if answer.get("fenced"):
                        fenced_peer.append(w)
                    elif answer.get("accepted") and first_accepted[0] is None:
                        first_accepted[0] = time.time()
                except (ValueError, AttributeError):
                    pass

            try:
                retry_io("grad-push", send, policy=push_policy)
                counters.inc("grad_pushed")
                counters.inc("wire_push_bytes", len(body))
                # an f32 frame is its own uncompressed size (ROADMAP C51)
                counters.inc("wire_push_bytes_uncompressed",
                             len(body) if codec_w == "f32" else wire_full_bytes.get(w, len(body)))
            except (OSError, resilience.FaultInjected):
                counters.inc("push_failed")  # dropped: a dead owner never stalls the fleet
            last_stamp[w] = stamp
        if fenced_peer:
            refresh_membership(fenced_peer[0])

    # lease-based liveness and the eviction verdict: every worker leases its
    # peers on its own clients (the training thread's are not thread-safe);
    # only the acting lead, the lowest active id it believes live, decides.
    # Verdicts are broadcast and queued here and applied at step boundaries
    member_stop = threading.Event()
    member_thread: Optional[threading.Thread] = None
    if n_workers > 1 and peer_lease_s > 0:
        def sync_from(probe: _PeerClient, m: Membership) -> None:
            """A peer is ahead of ``m``: this worker missed a broadcast."""
            try:
                status, _, body = probe.request("GET", "/membership")
                if status == 200:
                    newer = Membership.from_wire(json.loads(body.decode("utf8")))
                    if newer.epoch > m.epoch and worker_id in newer:
                        server.queue_membership(newer)
            except (OSError, ValueError):
                pass

        def membership_loop() -> None:
            probes = {w: _PeerClient(urls[w], timeout=probe_timeout)
                      for w in range(n_workers) if w != worker_id}
            tracker = LeaseTracker([w for w in membership.active if w != worker_id],
                                   lease_s=peer_lease_s, miss_threshold=lease_miss_threshold)
            # the epoch of this worker's last queued verdict: until the step
            # boundary applies it, the same peer must not be evicted again
            verdict_epoch = 0
            try:
                while not member_stop.wait(lease_poll_s):
                    m = membership  # one snapshot a round
                    if worker_id not in m or m.epoch < verdict_epoch:
                        continue
                    for w in tracker.peers():
                        if w not in m:
                            tracker.remove(w)
                    drift_from: Optional[int] = None
                    for w in m.active:
                        if w == worker_id:
                            continue
                        tracker.add(w)
                        ok = False
                        try:
                            status, _, body = probes[w].request("GET", "/healthz")
                            if status == 200:
                                ok = True
                                pe = json.loads(body.decode("utf8")).get("epoch")
                                if isinstance(pe, int) and not isinstance(pe, bool) \
                                        and pe > m.epoch:
                                    drift_from = w
                        except (OSError, ValueError):
                            ok = False
                        tracker.observe(w, ok)
                    if drift_from is not None:
                        sync_from(probes[drift_from], m)
                        continue  # probe again under the newer membership
                    live = [w for w in m.active if w == worker_id or not tracker.dead(w)]
                    if min(live) != worker_id:
                        continue  # not the acting lead this round
                    dead = [w for w in m.active if w not in live]
                    new_m = m
                    for w in dead:
                        new_m = new_m.evict(w)
                    joiners = sorted(j for j in server.drain_join_requests()
                                     if 0 <= j < n_workers and j not in new_m)
                    for j in joiners:
                        new_m = new_m.admit(j)
                    if new_m.epoch == m.epoch:
                        continue
                    if dead:
                        counters.inc("evictions", len(dead))
                        member_ledger.append("evict", lead=worker_id, evicted=dead,
                                             epoch=new_m.epoch, active=list(new_m.active))
                        log_event("fleet-owner-evicted",
                                  f"acting lead {worker_id}: evicting {dead} (lease "
                                  f"{peer_lease_s:g}s and {lease_miss_threshold} consecutive "
                                  f"misses both expired) — membership epoch {new_m.epoch}, "
                                  f"survivors {list(new_m.active)}", lead=worker_id,
                                  evicted=dead, epoch=new_m.epoch, active=list(new_m.active))
                    if joiners:
                        member_ledger.append("admit", lead=worker_id, admitted=joiners,
                                             epoch=new_m.epoch, active=list(new_m.active))
                        log_event("fleet-worker-admitted", f"acting lead {worker_id}: "
                                  f"admitting {joiners} at membership epoch {new_m.epoch}",
                                  lead=worker_id, admitted=joiners, epoch=new_m.epoch)
                    verdict_epoch = new_m.epoch
                    wire = json.dumps(new_m.to_wire()).encode("utf8")
                    for w in new_m.active:
                        if w != worker_id:
                            try:
                                probes[w].request("POST", "/membership", body=wire,
                                                  content_type="application/json")
                            except OSError:
                                pass  # it syncs off a peer's /healthz instead
                    server.queue_membership(new_m)
            finally:
                for probe in probes.values():
                    probe.close()

        member_thread = threading.Thread(target=membership_loop,
                                         name=f"fleet-membership-{worker_id}", daemon=True)

    if worker_id == 0:
        logger_cfg = T.get("logger") or {"@loggers": "spacy_ray_tpu.ConsoleLogger.v1"}
        log_step, log_finalize = registry.resolve(logger_cfg)(
            nlp, sys.stdout if stdout_log else io.StringIO(), sys.stderr)
        dev_examples = list(dev_corpus())
        score_weights = (dict(T.get("score_weights") or {})
                         or default_pipeline_score_weights(nlp))
    max_steps = int(max_steps_override or T["max_steps"] or 0)
    max_epochs = int(T["max_epochs"] or 0)
    eval_frequency = int(T["eval_frequency"] or 200)
    patience = int(T["patience"] or 0)
    keep = int(T.get("keep_checkpoints", 2) or 1)

    result = TrainResult()
    loss_accum: Dict[str, float] = {}
    words_since_log = 0

    def batches():
        nonlocal epoch
        while True:
            got_any = False
            stream = train_corpus()
            if n_workers > 1:
                stream = shard_stream(stream, worker_id, n_workers)
            for b in batcher(stream):
                got_any = True
                yield b
            if not got_any:
                raise ValueError(f"Training corpus is empty on worker {worker_id}'s shard")
            epoch += 1
            if max_epochs and epoch >= max_epochs:
                return

    def note_phase(name: str, t0: float, t1: float) -> None:
        phases[name] += t1 - t0
        phase_steps[name].append(t1 - t0)

    last_saved = [resumed_from if resumed_from is not None else -1]
    committed: List[int] = []

    def fleet_checkpoint() -> None:
        """The lead's generation at this step: its own part, then each peer's
        over ``POST /checkpoint`` (whose reply carries the owner's slices of
        the same cut, merged into the generation's params), then the commit.
        Any failed exchange aborts the generation, since a meta naming a
        missing part would poison every later load, and the previous one
        stays. A worker outside the membership commits nothing."""
        if out is None or step == last_saved[0] or worker_id not in membership:
            return
        stamp = int(step)
        ckpt_dir = out / "last-model"
        step_cut[0] = (step, generator_state_hex(seeds))
        mine = checkpoint_cb(str(ckpt_dir), stamp)
        digests = {int(mine["meta"]["part"]): str(mine["meta"]["digest"])}
        versions: List[Optional[int]] = [None] * n_workers
        rngs: List[Optional[str]] = [None] * n_workers
        versions[worker_id], rngs[worker_id] = int(mine["meta"]["version"]), mine["meta"]["rng"]
        assembled = tree_from_flat({k: np.array(a) for k, a in host_leaves.items()})
        layout.merge_flat(assembled, worker_id, mine["params"])
        req = json.dumps({"dir": str(ckpt_dir), "stamp": stamp,
                          "epoch": int(membership.epoch)}).encode("utf8")
        for w in sorted(clients):
            try:
                maybe_fail("checkpoint-wire")
                if resilience.partitioned(w):
                    raise OSError(f"peer {w} partitioned (fault plan)")
                act = resilience.consume_wire_fault("checkpoint-wire")
                if act is not None and act[0] == "delay":
                    time.sleep(float(act[1] or 1.0))
                client = ckpt_clients.get(w)
                if client is None:
                    client = ckpt_clients[w] = _PeerClient(urls[w],
                                                           timeout=CHECKPOINT_TIMEOUT_S)
                for _ in range(2 if act is not None and act[0] == "dup" else 1):
                    # a repeated request names the same stamp and part file
                    status, resp_headers, body = client.request(
                        "POST", "/checkpoint", body=req, content_type="application/json")
                    if status != 200:
                        raise OSError(f"peer {w} checkpoint: HTTP {status}")
                if act is not None and act[0] == "corrupt":
                    body = resilience.corrupt_bytes(body)
                try:
                    check_frame_crc(body, resp_headers)
                except WireError:
                    counters.refuse_crc()
                    raise
                meta_w, arrays = decode_arrays(body)
                digests[int(meta_w["part"])] = str(meta_w["digest"])
                versions[w], rngs[w] = int(meta_w["version"]), str(meta_w["rng"])
                layout.merge_flat(assembled, w, arrays)
            except (OSError, WireError, KeyError, ValueError, TypeError,
                    resilience.FaultInjected) as e:
                log_event("fleet-checkpoint-aborted", f"worker {w} failed the checkpoint "
                          f"exchange at step {stamp} ({type(e).__name__}: {e}); keeping the "
                          "previous generation", worker=w, step=stamp)
                return
        if sorted(digests) != list(range(len(membership.active))):
            log_event("fleet-checkpoint-aborted", f"the parts of step {stamp} came from ranks "
                      f"{sorted(digests)} of {len(membership.active)}; keeping the previous "
                      "generation", step=stamp)
            return
        commit_fleet_generation(
            ckpt_dir, params=assembled, step=stamp, epoch=epoch, rng=rngs[worker_id],
            best_score=best_score, best_step=best_step, opt_shards=len(membership.active),
            opt_digests=digests, keep=keep,
            extra={"fleet": {"n_workers": n_workers, "quorum": quorum,
                             "max_staleness": max_staleness, "worker": worker_id,
                             "epoch": membership.epoch, "active": list(membership.active),
                             "versions": versions, "rngs": rngs,
                             "grad_compression": wire_codec,
                             "param_delta_window": param_delta_window}})
        last_saved[0] = stamp
        committed.append(stamp)

    prev_handlers: Dict[int, Any] = {}
    if threading.current_thread() is threading.main_thread():
        def _on_signal(signum: int, frame: Any) -> None:
            stop_requested.set()

        for signum in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[signum] = signal.signal(signum, _on_signal)

    watchdog: Optional[Watchdog] = None
    if float(T["watchdog_timeout_s"]) > 0:
        watchdog = Watchdog(float(T["watchdog_timeout_s"]), stats_fn=lambda: {
            "fleet_worker": worker_id, "version": owner.version, **counters.snapshot()})
        watchdog.start()
    clean_exit = False
    start_time = last_log_time = time.perf_counter()
    try:
        wait_for_peers()
        for w in sorted(drifted):
            refresh_membership(w)
        if n_workers > 1 and worker_id not in membership:
            request_join(membership)
        if member_thread is not None:
            member_thread.start()
        batch_iter = batches()
        while not stop_requested.is_set():
            # the step boundary: a queued membership (a broadcast, this
            # worker's own verdict, a sync) applies before this step stamps
            pending = server.take_pending_membership()
            if pending is not None and pending.epoch > membership.epoch:
                apply_membership(pending)
            t0 = time.perf_counter()
            try:
                b = next(batch_iter)
            except StopIteration:
                break
            maybe_fail("collate")
            batch = nlp.collate(b, with_targets=True, pad_batch_to=bucket_batch_size(len(b)),
                                pad_len_to=bucket_length(max(len(eg) for eg in b),
                                                         nlp.length_buckets))
            n_words = int(batch["n_words"])
            t1 = time.perf_counter()
            note_phase("data", t0, t1)

            stamps = pull_peers()
            load_into_model()
            t2 = time.perf_counter()
            note_phase("pull", t1, t2)

            # the step site (a nan rule reports this step's loss as NaN)
            maybe_fail("step")
            poisoned = resilience.consume_poison("step")
            for p in params.values():
                p.grad = None
            mseed = int(torch.randint(0, 2 ** 62, (1,), generator=seeds))
            loss, metrics = nlp.loss(batch["tokens"], batch["targets"], dropout=dropout,
                                     seed=mseed)
            loss.backward()
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for k, p in params.items()}
            with torch.no_grad():
                gnorm = global_norm(list(grads.values()))
                if worker_clip > 0:
                    torch._foreach_mul_(list(grads.values()), clip_scale(gnorm, worker_clip))
            grads_host = tree_from_flat({k: g.to("cpu", copy=True).numpy()
                                         for k, g in grads.items()})
            loss_val = float("nan") if poisoned else float(loss.detach())
            head_losses = {k[5:]: float("nan") if poisoned else float(v)
                           for k, v in metrics.items() if k.startswith("loss_")}
            t3 = time.perf_counter()
            note_phase("grad", t2, t3)

            push_grads(grads_host, stamps)
            t4 = time.perf_counter()
            note_phase("push", t3, t4)
            for part in CODEC_PARTS:
                codec_steps[part].append(codec_now[part])
                codec_now[part] = 0.0

            if owns_any:
                deadline = time.monotonic() + float(quorum_wait_s)
                reached = fenced = False
                while not stop_requested.is_set():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    if owner.wait_version_above(stamps[worker_id], min(0.25, remaining)):
                        reached = True
                        break
                    pending_epoch = server.pending_membership_epoch()
                    if pending_epoch is not None and pending_epoch > membership.epoch:
                        # the survivors already stamp the new epoch: this
                        # epoch's quorum cannot complete; the apply comes next
                        fenced = True
                        break
                if not (reached or fenced or stop_requested.is_set()):
                    counters.inc("apply_wait_timeouts")
                    log_event("fleet-quorum-timeout",
                              f"worker {worker_id}: own shard stuck at version {owner.version} "
                              f"for {quorum_wait_s:.0f}s (quorum {quorum} not reached) — "
                              "proceeding", worker=worker_id, version=owner.version)
            note_phase("apply_wait", t4, time.perf_counter())

            step += 1
            result.words_seen += n_words
            words_since_log += n_words
            result.step_losses.append(loss_val)
            result.step_head_losses.append(head_losses)
            for key, value in head_losses.items():
                loss_accum[key] = loss_accum.get(key, 0.0) + value

            info: Optional[Dict[str, Any]] = None
            if worker_id == 0 and step % eval_frequency == 0:
                eval_t0 = time.perf_counter()
                scores, eval_wps = nlp.evaluate_timed(dev_examples)
                eval_seconds = time.perf_counter() - eval_t0
                score = weighted_score(scores, score_weights)
                now = time.perf_counter()
                wps = words_since_log / max(now - last_log_time, 1e-9)
                last_log_time, words_since_log = now, 0
                info = {"epoch": epoch, "step": step, "words": result.words_seen,
                        "losses": dict(loss_accum), "other_scores": scores, "score": score,
                        "wps": wps, "eval_seconds": eval_seconds, "eval_wps": eval_wps,
                        "fleet": {"worker": worker_id, "version": owner.version,
                                  "membership_epoch": membership.epoch,
                                  **counters.snapshot()}}
                result.history.append(info)
                loss_accum = {}
                if score > best_score:
                    best_score, best_step = score, step
                    if out is not None:
                        nlp.to_disk(out / "best-model")
                fleet_checkpoint()
            elif worker_id == membership.lead and step % eval_frequency == 0:
                # an acting lead other than worker 0 keeps the generations
                # going, without scores (the dev corpus stays with worker 0)
                fleet_checkpoint()
            step_cut[0] = (step, generator_state_hex(seeds))
            if worker_id == 0:
                log_step(info)
            if watchdog is not None:
                watchdog.beat()
            if max_steps and step >= max_steps:
                break
            if worker_id == 0 and patience and best_step >= 0 and step - best_step >= patience:
                break
            if worker_id != membership.lead and server.finalize_event.is_set():
                # the lead finished: pushes to it from here on could never be
                # written into a model
                log_event("fleet-finalized", f"worker {worker_id}: the lead finalized the "
                          f"fleet at our step {step} — stopping", worker=worker_id, step=step)
                break
        if stop_requested.is_set():
            result.interrupted = True
            log_event("preempted", f"fleet worker {worker_id}: shutdown signal at step {step}",
                      step=step, worker=worker_id)
        clean_exit = True
    finally:
        if watchdog is not None:
            watchdog.stop()
        member_stop.set()
        if member_thread is not None and member_thread.is_alive():
            member_thread.join(timeout=probe_timeout + lease_poll_s)
        for signum, prev in prev_handlers.items():
            signal.signal(signum, prev)
        try:
            if worker_id == membership.lead and clean_exit:
                # the last generation (the owners' slices and parts), the
                # models from the slices as pulled at the last step's top (the
                # JAX package's last-model/ too), then the peers may go
                if out is not None:
                    fleet_checkpoint()
                    nlp.requires_grad_(False)
                    nlp.to_disk(out / "last-model")
                for client in clients.values():
                    try:
                        client.request("POST", "/finalize", body=b"{}",
                                       content_type="application/json")
                    except OSError:
                        pass
            elif clean_exit:
                _await_finalize(server, clients.get(membership.lead), FINALIZE_WAIT_S,
                                worker_id)
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            result.seconds = time.perf_counter() - start_time
            result.best_score, result.best_step = best_score, best_step
            result.final_step, result.epoch = step, epoch
            ends = owner_log[1:] + [{"version_start": owner.version,
                                     "k5_start": _cuda.launch_counts().get("fused_update", 0)}]
            owner_epochs = [{**rec, "applies": end["version_start"] - rec["version_start"],
                             "k5_launches": end["k5_start"] - rec["k5_start"]}
                            for rec, end in zip(owner_log, ends)]
            result.fleet = {
                "worker": worker_id, "n_workers": n_workers, "quorum": quorum,
                "max_staleness": max_staleness, "version": owner.version,
                "membership_epoch": membership.epoch, "active": list(membership.active),
                "grad_compression": wire_codec, "param_delta_window": param_delta_window,
                "resume": bool(resume), "resumed_from": resumed_from,
                "opt_parts": list(written_parts), "generations": list(committed),
                "first_accepted_push_at": first_accepted[0],
                "counters": counters.snapshot(),
                "frames_crc_refused": counters.crc_refused,
                "phases": {p: round(v, 6) for p, v in phases.items()},
                "phase_steps_s": phase_steps,
                "codec_steps_s": codec_steps,
                "owner_apply_seconds": round(retired_apply_s + owner.apply_seconds, 6),
                "owner_epochs": owner_epochs,
                "launches": _cuda.launch_counts(),
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None),
            }
            if out is not None:
                out.mkdir(parents=True, exist_ok=True)
                ledger = {"worker": worker_id, "steps": step, "words_seen": result.words_seen,
                          "seconds": round(result.seconds, 6),
                          "interrupted": result.interrupted, "step_losses": result.step_losses,
                          "best_score": best_score, "best_step": best_step,
                          "history": [{"step": h["step"], "score": h["score"],
                                       "other_scores": h["other_scores"]}
                                      for h in result.history],
                          **result.fleet}
                (out / f"fleet-worker-{worker_id}.json").write_text(
                    json.dumps(ledger, indent=2), encoding="utf8")
            for client in [*clients.values(), *ckpt_clients.values()]:
                client.close()
            server.stop()
    nlp.requires_grad_(False)
    if worker_id == 0:
        log_finalize()
    return nlp, result


def _await_finalize(server: PeerServer, lead: Optional[_PeerClient], wait_s: float,
                    worker_id: int) -> None:
    """Keep serving until the lead posts ``/finalize`` (its last pull needs
    this worker's slices), at most ``wait_s``, or until the lead fails two
    liveness probes in a row."""
    deadline = time.monotonic() + float(wait_s)
    misses = 0
    while not server.finalize_event.wait(timeout=1.0):
        if time.monotonic() > deadline or lead is None:
            return
        try:
            lead.request("GET", "/healthz")
            misses = 0
        except OSError:
            misses += 1
            if misses >= 2:
                log_event("fleet-lead-gone", f"worker {worker_id}: lead unreachable while "
                          "awaiting finalize — exiting", worker=worker_id)
                return
