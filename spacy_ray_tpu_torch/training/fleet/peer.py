"""A fleet worker's peer plane: the owner of its parameter slices and the
HTTP server around it (``spacy_ray_tpu/training/fleet/peer.py``).

:class:`OwnerState` holds the one authoritative copy of this worker's
slices and their optimizer state. It buffers arriving gradients by sender,
discards (and counts) a gradient stamped more than ``max_staleness``
versions behind the slices' version or ahead of it, and once ``quorum``
distinct senders are buffered applies the optimizer to their mean and bumps
the version. The apply runs on the thread that completed the quorum (an
HTTP handler thread for a peer's push), under the owner's lock.

:class:`PeerServer` serves ``POST /grad`` (wire frames, never pickle),
``GET /params?known=V`` (the encoded slices, or 204 with ``X-SRT-Version``
when ``V`` is current; with ``X-SRT-Accept: delta`` the owner's compressed
pieces since ``V`` when it still holds them all and they are smaller, named
by ``X-SRT-Codec``), ``GET /healthz`` (worker id, layout signature,
version, the codecs it decodes, its delta window), ``GET /metrics``
(counters, version and the worker's phase seconds, as JSON), ``GET
/membership`` and ``POST /membership`` (a lead's broadcast, adopted only
at a strictly newer epoch and queued for the worker's next step boundary),
``POST /membership/join``, ``POST /finalize`` and ``POST /checkpoint`` (the
lead's ``{"dir", "stamp", "epoch"}``: this owner writes its part of that
generation through the worker's ``checkpoint_cb`` and answers with an f32
frame of its slices whose meta holds the part's ``digest``, the ``version``
and ``part`` it was cut at, the worker's ``step`` and ``rng``).
``/grad``, ``/params`` and ``/checkpoint`` fence a frame stamped with
another membership epoch than the live one (counted, ``epoch_fenced``). A
body over :data:`MAX_BODY_BYTES` gets 413 and a counted discard. The JAX
package's trace and alert routes answer 404 here.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..checkpoint import flatten_opt_state
from ..telemetry import sanitize_json
from .membership import Membership
from .wire import (
    CRC_HEADER, WIRE_CODECS, WireError, _compress_leaf, check_frame_crc, decode_grads,
    encode_arrays, encode_delta_frame, frame_crc, frame_epoch,
)

#: request-body ceiling (bytes): a bigger frame is hostile or corrupt, and is
#: refused before it is read into memory
MAX_BODY_BYTES = 1 << 30

logger = logging.getLogger("spacy_ray_tpu_torch.training")

#: the JAX package's counter names (Prometheus ``srt_training_<name>_total``)
COUNTER_NAMES = (
    "grad_pushed",          # worker: payloads delivered to peer owners (not to itself)
    "grad_received",        # owner: payloads that arrived
    "grad_applied",         # owner: buffered contributions folded into applies
    "grad_discarded",       # owner: payloads dropped (stale, future, malformed)
    "push_failed",          # worker: pushes that exhausted their retries
    "pull_failed",          # worker: parameter pulls that failed
    "apply_wait_timeouts",  # worker: quorum waits that timed out
    "pull_wait_timeouts",   # worker: staleness-gate waits that timed out
    "applies",              # owner: optimizer applies (version bumps)
    "wire_push_bytes",      # worker: bytes of delivered pushes
    "wire_push_bytes_uncompressed",  # worker: what they would cost as f32 frames
    "wire_pull_bytes",      # worker: bytes of 200 pull bodies
    "wire_pull_bytes_uncompressed",  # worker: what they would cost as full f32 frames
    "epoch_fenced",         # owner: frames and broadcasts stamped with a stale or foreign epoch
    "evictions",            # acting lead: workers it evicted
    "shards_adopted",       # worker: owned leaves whose slice a re-shard changed
)


class FleetCounters:
    """The fleet's ledger: thread-safe ints."""

    def __init__(self) -> None:
        self._v: Dict[str, int] = {n: 0 for n in COUNTER_NAMES}
        self._lock = threading.Lock()
        #: frames refused by their CRC-32: pushes at the owner, pull and
        #: checkpoint replies at the worker. The port's own (JAX sends no
        #: CRC, ROADMAP C80), so kept out of the JAX package's names
        self.crc_refused = 0

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._v[name] += int(n)

    def refuse_crc(self) -> None:
        with self._lock:
            self.crc_refused += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._v)


def host_copy(leaf: Any) -> np.ndarray:
    """A host numpy copy of a tensor (on any device) or an array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(np.asarray(leaf))


class OwnerState:
    """The authoritative owner of this worker's parameter slices.

    A gradient stamped ``s`` against the current version ``v`` is buffered
    when ``0 <= v - s <= max_staleness`` and discarded (and counted)
    otherwise: too stale, or from the future (a peer pushing against a
    version this owner never reached). The buffer is keyed by sender (a
    re-push before the apply replaces the earlier one); at ``quorum``
    senders their mean goes through ``apply_fn(params, opt_state, grads)
    -> (params, opt_state)``, the version bumps and waiters wake.

    ``params`` is a flat ``{path: leaf}`` dict (tensors on the card for a
    worker, numpy arrays in tests); the host copies of the slices that
    pulls are served from are taken after each apply. ``version`` is where
    the count starts: a re-sharded owner keeps its predecessor's.

    Delta pulls (``delta_window`` > 0): the owner keeps a deterministic f32
    wire chain, ``wire_v = wire_{v-1} + deq(Q(p_v - wire_{v-1}))`` with
    ``Q`` the ``delta_codec``, started at the slices it was built with. Each
    apply stores that version's compressed piece (the leaves that changed),
    the last ``delta_window`` of them within ``delta_budget_bytes``. A
    puller that follows the pieces lands exactly on ``wire_v`` however many
    versions it skipped, within one quantization step of the parameters; a
    pull the pieces cannot serve gets the full f32 frame.
    """

    def __init__(self, *, worker_id: int, n_workers: int, quorum: int, max_staleness: int,
                 apply_fn: Callable, slice_params: Dict[str, Any], opt_state: Any,
                 counters: FleetCounters, version: int = 0, delta_window: int = 0,
                 delta_codec: str = "int8", delta_budget_bytes: int = 8 << 20) -> None:
        if not (1 <= quorum <= n_workers):
            raise ValueError(f"quorum must be in [1, {n_workers}], got {quorum}")
        if max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        self.worker_id = int(worker_id)
        self.n_workers = int(n_workers)
        self.quorum = int(quorum)
        self.max_staleness = int(max_staleness)
        self.apply_fn = apply_fn
        self.params = slice_params
        self.opt_state = opt_state
        self.counters = counters
        self.version = int(version)
        self.lock = threading.Lock()
        self._cond = threading.Condition(self.lock)
        self._buffer: Dict[int, Dict[str, np.ndarray]] = {}
        self._host_flat: Dict[str, np.ndarray] = {k: host_copy(v)
                                                  for k, v in slice_params.items()}
        self._encoded: Optional[bytes] = None
        self.delta_window = max(0, int(delta_window))
        self.delta_codec = str(delta_codec)
        self.delta_budget_bytes = int(delta_budget_bytes)
        self._wire_flat: Optional[Dict[str, np.ndarray]] = (
            {k: np.asarray(v, dtype=np.float32).copy() for k, v in self._host_flat.items()}
            if self.delta_window > 0 else None)
        # version -> (piece codec, compressed arrays, their bytes)
        self._delta_pieces: Dict[int, Tuple[str, Dict[str, np.ndarray], int]] = {}
        self._delta_bytes = 0
        self._delta_cache: Dict[int, bytes] = {}  # known -> its assembled frame
        self.apply_seconds = 0.0
        self.retired = False

    def submit(self, worker: int, stamp: int,
               grads: Dict[str, np.ndarray]) -> Tuple[bool, int]:
        """One gradient payload from ``worker`` stamped against version
        ``stamp``; returns (accepted, current version). Checked in order: the
        sender's id, the stamp's lag, then the keys and shapes (a payload
        that does not match the owned slices is a counted discard, never a
        buffered entry that would make the next apply raise)."""
        with self._cond:
            if self.retired:
                # a re-shard replaced this owner between the fence and here
                self.counters.inc("epoch_fenced")
                return False, self.version
            self.counters.inc("grad_received")
            if not (0 <= int(worker) < self.n_workers):
                self.counters.inc("grad_discarded")
                return False, self.version
            lag = self.version - int(stamp)
            if lag < 0 or lag > self.max_staleness:
                self.counters.inc("grad_discarded")
                return False, self.version
            if set(grads) != set(self._host_flat) or any(
                    grads[k].shape != self._host_flat[k].shape for k in grads):
                self.counters.inc("grad_discarded")
                logger.warning("fleet owner %d: structurally mismatched gradient payload "
                               "from worker %s discarded (peer running a different "
                               "parameter layout?)", self.worker_id, worker)
                return False, self.version
            self._buffer[int(worker)] = grads
            if len(self._buffer) >= self.quorum:
                try:
                    self._apply_locked()
                except Exception:
                    # an apply that raises drops its round (counted) instead of
                    # leaving a buffer that raises again at every quorum
                    self.counters.inc("grad_discarded", len(self._buffer))
                    self._buffer.clear()
                    logger.exception("fleet owner %d: quorum apply failed; round dropped",
                                     self.worker_id)
            return True, self.version

    def _apply_locked(self) -> None:
        t0 = time.monotonic()
        n = len(self._buffer)
        mean_flat: Dict[str, np.ndarray] = {}
        for flat in self._buffer.values():
            for key, arr in flat.items():
                acc = mean_flat.get(key)
                mean_flat[key] = arr.astype(np.float32) if acc is None else acc + arr
        for key in mean_flat:
            mean_flat[key] = mean_flat[key] / np.float32(n)
        self.params, self.opt_state = self.apply_fn(self.params, self.opt_state, mean_flat)
        self._host_flat = {k: host_copy(v) for k, v in self.params.items()}
        self._encoded = None
        self.version += 1
        if self._wire_flat is not None:
            self._record_delta_locked()
        self.counters.inc("grad_applied", n)
        self.counters.inc("applies")
        self._buffer.clear()
        self.apply_seconds += time.monotonic() - t0
        self._cond.notify_all()

    def _record_delta_locked(self) -> None:
        """Advance the wire chain past the apply that just bumped the version
        and store its compressed piece (a leaf the apply left unchanged
        costs nothing: a missing key is a zero delta); then drop pieces
        older than the window, and the oldest over the byte budget (never
        the newest)."""
        assert self._wire_flat is not None
        piece: Dict[str, np.ndarray] = {}
        nbytes = 0
        for key, new in self._host_flat.items():
            delta = np.asarray(new, dtype=np.float32) - self._wire_flat[key]
            if not np.any(delta):
                continue
            entries, deq = _compress_leaf(self.delta_codec, key, delta)
            piece.update(entries)
            self._wire_flat[key] = self._wire_flat[key] + deq
            nbytes += sum(int(a.nbytes) for a in entries.values())
        self._delta_pieces[self.version] = (self.delta_codec, piece, nbytes)
        self._delta_bytes += nbytes
        self._delta_cache.clear()
        floor = self.version - self.delta_window
        for v in sorted(self._delta_pieces):
            over_budget = self._delta_bytes > self.delta_budget_bytes
            if v > floor and not (over_budget and v < self.version):
                break
            self._delta_bytes -= self._delta_pieces.pop(v)[2]

    def retire(self) -> None:
        """Apply no more: a re-shard replaces this owner. Waits for an apply
        in flight (it holds the lock); the buffered contributions of the old
        layout are counted as discarded, a later submit is fenced, and the
        wire chain and its frames go (the new owner starts its own)."""
        with self._cond:
            self.retired = True
            self.counters.inc("grad_discarded", len(self._buffer))
            self._buffer.clear()
            self._wire_flat = None
            self._delta_pieces.clear()
            self._delta_bytes = 0
            self._delta_cache.clear()
            self._cond.notify_all()

    def current_flat(self) -> Tuple[int, Dict[str, np.ndarray]]:
        """(version, owned slices): host copies replaced wholesale at each
        apply and never mutated, safe to merge without the lock."""
        with self.lock:
            return self.version, dict(self._host_flat)

    def encoded(self, known: Optional[int]) -> Tuple[int, Optional[bytes]]:
        """The full f32 frame of the current slices, or ``(version, None)``
        when ``known`` is current; one encode per version, however many
        pulls."""
        version, body, _ = self.encoded_for(known, accept_delta=False)
        return version, body

    def _full_encoded_locked(self) -> bytes:
        if self._encoded is None:
            self._encoded = encode_arrays({"version": self.version, "worker": self.worker_id},
                                          self._host_flat)
        return self._encoded

    def encoded_for(self, known: Optional[int],
                    accept_delta: bool = False) -> Tuple[int, Optional[bytes], str]:
        """``(version, body, codec)`` of one pull; ``body`` None (codec
        ``current``) when ``known`` is current. A delta frame (codec
        ``delta``) only when the puller accepts one, every piece from
        ``known + 1`` to the version is still held, and the frame is smaller
        than the full one; else the full f32 frame (``f32``). Delta frames
        are cached per ``known`` until the next apply."""
        with self.lock:
            if known is not None and int(known) == self.version:
                return self.version, None, "current"
            if (accept_delta and self._wire_flat is not None and known is not None
                    and 0 <= self.version - int(known) <= self.delta_window):
                k = int(known)
                needed = range(k + 1, self.version + 1)
                if all(v in self._delta_pieces for v in needed):
                    body = self._delta_cache.get(k)
                    if body is None:
                        body = encode_delta_frame(
                            {"version": self.version, "worker": self.worker_id, "base": k},
                            [(v,) + self._delta_pieces[v][:2] for v in needed])
                        self._delta_cache[k] = body
                    if len(body) < len(self._full_encoded_locked()):
                        return self.version, body, "delta"
            return self.version, self._full_encoded_locked(), "f32"

    def checkpoint_parts(self, writer: Callable[[int, Any, Dict[str, np.ndarray]], Any]) -> Any:
        """``writer(version, opt_flat, host_flat)`` under the owner's lock: no
        apply moves the version, the moments or the slices while the part is
        written, so the part and the slices it ships with are one cut. The
        moments live on the device and are updated in place, so the writer
        gets host copies taken inside the lock, by flat name
        (:func:`~..checkpoint.flatten_opt_state`). A retired owner refuses."""
        with self.lock:
            if self.retired:
                raise RuntimeError(f"fleet owner {self.worker_id} was retired by a re-shard; "
                                   "it writes no checkpoint part")
            return writer(self.version, flatten_opt_state(self.opt_state),
                          dict(self._host_flat))

    def wait_version_above(self, stamp: int, timeout: float) -> bool:
        """Block until the version exceeds ``stamp`` (the round this worker
        pushed to was applied, or a later one); False on timeout."""
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            while self.version <= int(stamp):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True


class _PeerHTTPD(ThreadingHTTPServer):
    """Tracks its connections so that :meth:`PeerServer.stop` severs the
    keep-alive ones too, as the death of the process would."""

    daemon_threads = True

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request: Any, client_address: Any) -> None:
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request: Any) -> None:
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            for close in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    close()
                except OSError:
                    pass

    owner: OwnerState
    worker_id: int
    layout_signature: str
    finalize_event: threading.Event
    counters: FleetCounters
    phases: Callable[[], Dict[str, float]]
    max_body_bytes: int
    # the epoch every frame is fenced against, the advertised membership, a
    # broadcast waiting for the worker's next step boundary, queued joiners
    epoch: int
    membership: Optional[Dict[str, Any]]
    membership_lock: threading.Lock
    pending_membership: Optional[Membership]
    join_requests: list
    checkpoint_cb: Optional[Callable[[str, int], Dict[str, Any]]]


class _PeerHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: _PeerHTTPD

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _reply_bytes(self, status: int, body: bytes, content_type: str,
                     headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, status: int, payload: Dict[str, Any],
                    headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(sanitize_json(payload)).encode("utf8")
        self._reply_bytes(status, body, "application/json", headers)

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler naming)
        parsed = urlparse(self.path)
        srv = self.server
        if parsed.path == "/healthz":
            self._reply_json(200, {
                "status": "ok", "role": "fleet-worker", "worker": srv.worker_id,
                "version": srv.owner.version, "layout": srv.layout_signature,
                "codecs": list(WIRE_CODECS), "delta_window": srv.owner.delta_window,
                "epoch": srv.epoch})
        elif parsed.path == "/membership":
            with srv.membership_lock:
                payload = dict(srv.membership or {})
            payload.setdefault("epoch", srv.epoch)
            self._reply_json(200, payload)
        elif parsed.path == "/params":
            self._params(parsed)
        elif parsed.path == "/metrics":
            self._reply_json(200, {"counters": srv.counters.snapshot(),
                                   "gauges": {"fleet_worker": srv.worker_id,
                                              "param_version": srv.owner.version,
                                              "membership_epoch": srv.epoch},
                                   "phases": srv.phases()})
        else:
            self._reply_json(404, {"error": "not_found", "message": parsed.path})

    def _params(self, parsed: Any) -> None:
        srv = self.server
        known_s = (parse_qs(parsed.query).get("known") or [None])[0]
        epoch_s = self.headers.get("X-SRT-Epoch")
        try:
            known = int(known_s) if known_s is not None else None
            epoch = int(epoch_s) if epoch_s is not None else 0
        except ValueError:
            self._reply_json(400, {"error": "bad_request",
                                   "message": f"known={known_s!r} or X-SRT-Epoch "
                                              f"{epoch_s!r} is not an int"})
            return
        if epoch != srv.epoch:
            # a puller at another epoch (absent header: 0) must not merge
            # this layout's slices: its offsets would be wrong
            srv.counters.inc("epoch_fenced")
            self._reply_json(409, {"error": "epoch_fenced", "epoch": srv.epoch},
                             headers={"X-SRT-Epoch": str(srv.epoch)})
            return
        # a puller that sends no X-SRT-Accept gets the full frame; the reply
        # names what was served
        accept = str(self.headers.get("X-SRT-Accept") or "")
        version, body, codec = srv.owner.encoded_for(known, accept_delta="delta" in accept)
        if body is None:
            self._reply_bytes(204, b"", "application/octet-stream",
                              headers={"X-SRT-Version": str(version)})
        else:
            self._reply_bytes(200, body, "application/octet-stream",
                              headers={"X-SRT-Version": str(version), "X-SRT-Codec": codec,
                                       CRC_HEADER: frame_crc(body)})

    def _body_or_413(self) -> Optional[bytes]:
        """The request body, or None after a 400 (a Content-Length that is
        not an int) or a 413 and a counted discard (one past the cap)."""
        srv = self.server
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            self._reply_json(400, {"error": "bad_request",
                                   "message": "Content-Length is not an int"})
            return None
        if length > srv.max_body_bytes:
            srv.counters.inc("grad_discarded")
            self._reply_json(413, {"error": "body_too_large",
                                   "message": f"{length} bytes exceeds the "
                                              f"{srv.max_body_bytes}-byte frame cap"})
            return None
        return self.rfile.read(length) if length > 0 else b""

    def _membership_broadcast(self) -> None:
        """A lead's broadcast: queued for the worker's next step boundary
        (the swap never runs on a handler thread) when its epoch is newer
        than the live one and than any queued one; 409 otherwise."""
        srv = self.server
        body = self._body_or_413()
        if body is None:
            return
        try:
            m = Membership.from_wire(json.loads(body.decode("utf8") or "{}"))
        except (ValueError, UnicodeDecodeError) as e:
            self._reply_json(400, {"error": "bad_request", "message": str(e)})
            return
        with srv.membership_lock:
            pending = srv.pending_membership
            if m.epoch <= srv.epoch and not (pending is not None and m.epoch > pending.epoch):
                # a lead re-broadcasting a dead membership is fenced like its pushes
                srv.counters.inc("epoch_fenced")
                self._reply_json(409, {"error": "epoch_fenced", "epoch": srv.epoch})
                return
            if pending is None or m.epoch > pending.epoch:
                srv.pending_membership = m  # racing broadcasts: the highest epoch wins
        self._reply_json(200, {"adopted": True, "epoch": m.epoch})

    def _join_request(self) -> None:
        srv = self.server
        body = self._body_or_413()
        if body is None:
            return
        try:
            joiner = json.loads(body.decode("utf8") or "{}")["worker"]
            if isinstance(joiner, bool) or not isinstance(joiner, int) or joiner < 0:
                raise ValueError(f"worker {joiner!r} is not an id")
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            self._reply_json(400, {"error": "bad_request", "message": str(e)})
            return
        with srv.membership_lock:
            if joiner not in srv.join_requests:
                srv.join_requests.append(joiner)
        self._reply_json(200, {"queued": True, "epoch": srv.epoch})

    def _checkpoint(self) -> None:
        """The lead asks this owner for its part of generation ``stamp`` in
        ``dir``: 503 without a callback, 400 on a bad body, 409 at another
        epoch (a generation is one membership's cut), 500 when the write
        raises, else the frame of the part's meta and the owner's slices."""
        srv = self.server
        if srv.checkpoint_cb is None:
            self._reply_json(503, {"error": "not_ready"})
            return
        body = self._body_or_413()
        if body is None:
            return
        try:
            req = json.loads(body.decode("utf8") or "{}")
            ckpt_dir = str(req["dir"])
            stamp = int(req["stamp"])
            epoch = frame_epoch(req if isinstance(req, dict) else {})
        except (WireError, ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            self._reply_json(400, {"error": "bad_request", "message": str(e)})
            return
        if epoch != srv.epoch:
            # parts written under different epochs slice differently and would
            # assemble into garbage: the lead keeps its previous generation
            srv.counters.inc("epoch_fenced")
            self._reply_json(409, {"error": "epoch_fenced", "epoch": srv.epoch})
            return
        try:
            result = srv.checkpoint_cb(ckpt_dir, stamp)
        except Exception as e:  # the lead aborts the generation on it
            logger.exception("fleet checkpoint part write failed")
            self._reply_json(500, {"error": "checkpoint_failed", "message": str(e)})
            return
        frame = encode_arrays(result["meta"], result["params"])
        self._reply_bytes(200, frame, "application/octet-stream",
                          headers={CRC_HEADER: frame_crc(frame)})

    def do_POST(self) -> None:  # noqa: N802
        parsed = urlparse(self.path)
        srv = self.server
        if parsed.path == "/grad":
            body = self._body_or_413()
            if body is None:
                return
            try:
                check_frame_crc(body, self.headers)
            except WireError as e:
                # a frame corrupted in flight: refused and counted, never applied
                srv.counters.refuse_crc()
                self._reply_json(400, {"error": "bad_payload", "message": str(e)})
                return
            try:
                # bf16 and int8 frames decode to f32 here, before the fence and
                # the owner's structural check; an unknown codec passes through
                meta, arrays = decode_grads(body)
                epoch = frame_epoch(meta)
                worker = int(meta["worker"])
                stamp = int(meta["stamp"])
            except (WireError, KeyError, TypeError, ValueError) as e:
                self._reply_json(400, {"error": "bad_payload", "message": str(e)})
                return
            if epoch != srv.epoch:
                # a push stamped with a dead membership's epoch describes a
                # layout that no longer exists: discarded before the buffer
                srv.counters.inc("epoch_fenced")
                self._reply_json(200, {"accepted": False, "fenced": True,
                                       "epoch": srv.epoch})
                return
            accepted, version = srv.owner.submit(worker, stamp, arrays)
            self._reply_json(200, {"accepted": accepted, "version": version})
        elif parsed.path == "/checkpoint":
            self._checkpoint()
        elif parsed.path == "/membership":
            self._membership_broadcast()
        elif parsed.path == "/membership/join":
            self._join_request()
        elif parsed.path == "/finalize":
            srv.finalize_event.set()
            self._reply_json(200, {"status": "finalizing"})
        else:
            self._reply_json(404, {"error": "not_found", "message": parsed.path})


class PeerServer:
    """One worker's peer endpoint on a daemon thread. ``phases`` returns the
    worker's per-phase seconds for ``/metrics``; ``checkpoint_cb(dir,
    stamp)`` writes this owner's part for ``POST /checkpoint`` and returns
    ``{"meta": ..., "params": owned slices}``."""

    def __init__(self, owner: OwnerState, *, worker_id: int, layout_signature: str,
                 counters: FleetCounters, host: str = "127.0.0.1", port: int = 0,
                 phases: Optional[Callable[[], Dict[str, float]]] = None,
                 checkpoint_cb: Optional[Callable[[str, int], Dict[str, Any]]] = None) -> None:
        try:
            self.httpd = _PeerHTTPD((host, int(port)), _PeerHandler)
        except OSError as e:
            raise OSError(e.errno, f"fleet worker {worker_id}: cannot bind {host}:{port} "
                                   f"({e.strerror}); pick a free --fleet-base-port") from e
        self.httpd.owner = owner
        self.httpd.worker_id = int(worker_id)
        self.httpd.layout_signature = layout_signature
        self.httpd.counters = counters
        self.httpd.finalize_event = threading.Event()
        self.httpd.phases = phases or dict
        self.httpd.max_body_bytes = int(MAX_BODY_BYTES)
        self.httpd.epoch = 0
        self.httpd.membership = None
        self.httpd.membership_lock = threading.Lock()
        self.httpd.pending_membership = None
        self.httpd.join_requests = []
        self.httpd.checkpoint_cb = checkpoint_cb
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.httpd.server_address[:2]
        return str(host), int(port)

    @property
    def finalize_event(self) -> threading.Event:
        return self.httpd.finalize_event

    @property
    def epoch(self) -> int:
        return self.httpd.epoch

    def set_membership(self, membership: Membership, layout_signature: str) -> None:
        """Make ``membership`` the fence's truth: called by the worker at the
        step boundary where it applies the re-shard, after :meth:`set_owner`."""
        with self.httpd.membership_lock:
            self.httpd.epoch = int(membership.epoch)
            self.httpd.membership = membership.to_wire()
            self.httpd.layout_signature = str(layout_signature)

    def set_owner(self, owner: OwnerState) -> None:
        """Swap in the re-sharded owner. Handler threads read ``owner`` per
        request, and an apply in flight keeps the old one (and its device
        buffers) alive until it returns."""
        self.httpd.owner = owner

    def queue_membership(self, membership: Membership) -> None:
        """Queue a membership this worker decided on or synced, for its next
        step boundary: the slot a broadcast lands in, the highest epoch wins."""
        with self.httpd.membership_lock:
            pending = self.httpd.pending_membership
            if pending is None or membership.epoch > pending.epoch:
                self.httpd.pending_membership = membership

    def take_pending_membership(self) -> Optional[Membership]:
        with self.httpd.membership_lock:
            m = self.httpd.pending_membership
            self.httpd.pending_membership = None
            return m

    def pending_membership_epoch(self) -> Optional[int]:
        """The queued epoch, not taken: when it is newer than the live one
        the survivors already stamp the new epoch, so the old quorum cannot
        complete and the apply-wait yields."""
        with self.httpd.membership_lock:
            m = self.httpd.pending_membership
            return None if m is None else m.epoch

    def drain_join_requests(self) -> list:
        with self.httpd.membership_lock:
            reqs = list(self.httpd.join_requests)
            self.httpd.join_requests.clear()
            return reqs

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        kwargs={"poll_interval": 0.2},
                                        name=f"fleet-peer-{self.httpd.worker_id}", daemon=True)
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.close_all_connections()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
