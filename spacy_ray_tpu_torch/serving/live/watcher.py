"""Checkpoint watcher: from a training run's checkpoint directory to a
serving engine's hot-swap (``spacy_ray_tpu/serving/live/watcher.py``).

The watcher polls a ``TrainCheckpoint`` directory (the trainer's
``last-model/``, written by either package), digest-verifies any generation
newer than the one it last delivered, and hands the verified parameters to
a subscriber (``engine.swap_params``). A torn or half-retired generation
raises ``CheckpointCorrupt``; the watcher logs one
``live-generation-skipped`` event per stamp and falls back to the next
newest intact one. It is re-checked on later polls (a race with the writer
heals itself), and a subscriber that fails gets the same generation again
at the next poll.

:func:`scan_intact_generations` is the same check with the standard
library alone, nothing deserialized.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set

from ...training.checkpoint import opt_file_names as _opt_file_names
from ...training.resilience import log_event

logger = logging.getLogger("spacy_ray_tpu_torch.serving")


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def scan_intact_generations(path, *, newer_than: Optional[int] = None, skip: Any = (),
                            params_only: bool = False) -> List[int]:
    """Stamps of every generation in ``path`` whose files digest-verify,
    ascending. A generation with unreadable meta, a missing file or a digest
    mismatch is left out without an event. ``newer_than`` and ``skip``
    filter before any hashing; ``params_only`` leaves the optimizer state
    unchecked (what a swap reads)."""
    path = Path(path)
    intact: List[int] = []
    for meta_path in path.glob("train_meta-*.json"):
        name = meta_path.name
        try:
            stamp = int(name[len("train_meta-"):-len(".json")])
        except ValueError:
            continue
        if newer_than is not None and stamp <= newer_than:
            continue
        if stamp in skip:
            continue
        try:
            meta = json.loads(meta_path.read_text(encoding="utf8"))
        except (OSError, ValueError):
            continue
        if not isinstance(meta, dict) or meta.get("stamp") != stamp:
            continue
        digests = meta.get("digests") or {}
        fnames = [f"params-{stamp}.npz"]
        if not params_only:
            fnames.extend(_opt_file_names(meta, stamp))
        ok = True
        for fname in fnames:
            f = path / fname
            try:
                if not f.exists():
                    ok = False
                    break
                expect = digests.get(fname)
                if expect is not None and _sha256(f) != expect:
                    ok = False
                    break
            except OSError:
                ok = False
                break
        if ok:
            intact.append(stamp)
    return sorted(intact)


class CheckpointWatcher:
    """Poll a checkpoint directory; deliver each new verified generation to
    ``on_generation(stamp, state)`` once, the newest first (``state`` is
    ``Checkpoints.load_generation_params``'s: params and step). Delivery
    runs on the watcher's thread, or the caller's in :meth:`poll_once`."""

    def __init__(self, ckpt_dir, on_generation: Callable[[int, Dict[str, Any]], None], *,
                 interval_s: float = 2.0) -> None:
        self.ckpt_dir = Path(ckpt_dir)
        self.on_generation = on_generation
        self.interval_s = float(interval_s)
        self.current: Optional[int] = None  # the newest stamp delivered
        self._warned: Set[int] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.polls = 0
        self.delivered = 0
        self.skipped = 0

    def poll_once(self) -> Optional[int]:
        """Scan once and deliver the newest intact generation newer than
        ``current`` (past torn ones); its stamp, or None."""
        from ...training.checkpoint import CheckpointCorrupt, Checkpoints

        self.polls += 1
        ckpts = Checkpoints(self.ckpt_dir)
        try:
            stamps = ckpts.generations()
        except OSError:
            return None
        floor = self.current if self.current is not None else -1
        for stamp in sorted(stamps, reverse=True):
            if stamp <= floor:
                break
            try:
                state = ckpts.load_generation_params(stamp)
            except CheckpointCorrupt as e:
                self.skipped += 1
                if stamp not in self._warned:
                    self._warned.add(stamp)
                    log_event(
                        "live-generation-skipped",
                        f"checkpoint generation {stamp} failed verification "
                        f"({e}) — skipped, trying the previous candidate",
                        stamp=int(stamp), path=str(self.ckpt_dir),
                    )
                continue
            log_event(
                "live-generation",
                f"verified checkpoint generation {stamp} "
                f"(step {state.get('step')}) — delivering to subscriber",
                level=logging.INFO, stamp=int(stamp), path=str(self.ckpt_dir),
            )
            # deliver first, advance after: a subscriber that fails gets this
            # generation again at the next poll
            self.on_generation(stamp, state)
            self.current = stamp
            self._warned.discard(stamp)
            self.delivered += 1
            return stamp
        return None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # a failed swap must not end the polling
                logger.exception("checkpoint watcher poll failed")
            self._stop.wait(self.interval_s)

    def start(self) -> "CheckpointWatcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ckpt-watcher")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
