"""Device selection for the port's entry points.

The card is the default. The CPU runs only when the caller asks for it
(``device="cpu"``, ``--device cpu``), as the tests do; with no card present
and no request for the CPU, an entry point raises instead of running
somewhere the caller did not ask for.

:data:`DEVICE_GATE` orders the threads of one process that use the card.
A CUDA graph capture (``torch.cuda.graph``, global capture mode) must not
meet another thread's allocation, synchronisation or launch on the legacy
stream, so a capture holds the gate exclusively while every other piece of
device work (a serving batch, a model load, a swap's staging and exchange)
holds it shared: batches of several engines run side by side, and a capture
waits for the batches in flight and holds new ones back until it ends.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when ``cuda`` is asked for (or
    defaulted to) and no card is present. On ``cuda`` it keeps float32
    matmuls and convolutions in full float32 (TF32 off)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: spacy_ray_tpu_torch runs on the "
                "card by default and does not fall back to the CPU — pass "
                "device='cpu' (--device cpu) to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    return dev


class DeviceGate:
    """A readers-writer gate over the card, writer-preferring and re-entrant
    per thread. A thread that holds it shared and asks for it exclusively
    (a capture inside a warmup's forward) gives up its shared hold while it
    waits and takes it back after. ``exclusive_acquisitions``,
    ``contended`` (how many of them found device work in flight) and
    ``exclusive_wait_s`` say what the captures cost the others."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._shared = 0
        self._writer: Optional[int] = None
        self._writers_waiting = 0
        self._local = threading.local()
        self.exclusive_acquisitions = 0
        self.contended = 0
        self.exclusive_wait_s = 0.0

    @contextmanager
    def shared(self) -> Iterator[None]:
        loc = self._local
        if getattr(loc, "shared", 0) or getattr(loc, "exclusive", 0):
            loc.shared = getattr(loc, "shared", 0) + 1
            try:
                yield
            finally:
                loc.shared -= 1
            return
        with self._cond:
            while self._writer is not None or self._writers_waiting:
                self._cond.wait()
            self._shared += 1
        loc.shared = 1
        try:
            yield
        finally:
            loc.shared = 0
            with self._cond:
                self._shared -= 1
                if self._shared == 0:
                    self._cond.notify_all()

    @contextmanager
    def exclusive(self) -> Iterator[None]:
        loc = self._local
        if getattr(loc, "exclusive", 0):
            loc.exclusive += 1
            try:
                yield
            finally:
                loc.exclusive -= 1
            return
        held = getattr(loc, "shared", 0)
        t0 = time.perf_counter()
        with self._cond:
            if held:
                self._shared -= 1
                self._cond.notify_all()
            self._writers_waiting += 1
            busy = self._shared > 0 or self._writer is not None
            while self._shared > 0 or self._writer is not None:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = threading.get_ident()
            self.exclusive_acquisitions += 1
            self.contended += int(busy)
            self.exclusive_wait_s += time.perf_counter() - t0
        loc.exclusive, loc.shared = 1, 0
        try:
            yield
        finally:
            loc.exclusive = 0
            with self._cond:
                self._writer = None
                if held:
                    self._shared += 1  # no other writer can hold it: we just did
                self._cond.notify_all()
            loc.shared = held


#: the process's gate over its card (module docstring)
DEVICE_GATE = DeviceGate()
