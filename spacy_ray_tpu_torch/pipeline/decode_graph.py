"""CUDA graphs of the heads' decodes, one per (component, B, T) bucket.

The parser's greedy decode is ``2T + 2`` steps of 22 small device
operations and the BILUO Viterbi ``T`` steps of 7 (5 forward, 2 back);
run eagerly, each is a launch the host has to enqueue. Both have a fixed
shape per (B, T) and no host synchronisation, so the first decode at a
bucket is captured into a ``torch.cuda.CUDAGraph`` (after one eager run on
a side stream that builds the decode's constants) and every later one
copies the trunk output and the lengths into the graph's input buffers and
replays it. The serving engine
warms every bucket it admits, so live traffic only replays.

A capture or replay that fails raises: nothing runs eagerly in a graph's
place. Each graph has its own memory pool (replays come in any order).
Graphs read the heads' parameters at their addresses, so in-place updates
are seen; rebuilding the models drops the graphs (``Pipeline``).

The capture itself (not the eager run before it) holds
:data:`~..devices.DEVICE_GATE` exclusively, with the cyclic garbage
collector paused, so no other thread of the process (another serving
engine's dispatch, a model load) touches the card while it is open; it
runs in CUDA's global capture mode, so a thread that did would fail loudly.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Dict, Tuple

import torch

from ..devices import DEVICE_GATE
from ..ops import _cuda

_SIDE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_SIDE_LOCK = threading.Lock()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream of ``device`` that every decode's eager run and capture
    use: a stream that runs a cuBLAS call keeps a workspace for the rest of
    the process, so a stream per capture would grow the allocated memory with
    every model load."""
    with _SIDE_LOCK:
        stream = _SIDE_STREAMS.get(device)
        if stream is None:
            stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
        return stream


class DecodeGraphs:
    """The captured decodes of one pipeline, and what capturing cost."""

    def __init__(self) -> None:
        self._graphs: Dict[Tuple[Any, ...], Tuple[torch.cuda.CUDAGraph, torch.Tensor,
                                                  torch.Tensor, Dict[str, torch.Tensor]]] = {}
        self.capture_seconds = 0.0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, name: str, comp, X: torch.Tensor, lengths: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        """``comp.device_decode(X, lengths)`` by replaying the bucket's graph.
        The returned tensors are the graph's output buffers: the next replay
        of the same bucket overwrites them."""
        key = (name, comp.decode_signature(), tuple(X.shape), X.dtype)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(comp, X, lengths)
        graph, x_in, len_in, out = entry
        x_in.copy_(X)
        len_in.copy_(lengths)
        graph.replay()
        self.replays += 1
        return out

    def _capture(self, comp, X: torch.Tensor, lengths: torch.Tensor):
        t0 = time.perf_counter()
        x_in, len_in = X.clone(), lengths.clone()
        side = _side_stream(X.device)
        side.wait_stream(torch.cuda.current_stream(X.device))
        with torch.cuda.stream(side):
            comp.device_decode(x_in, len_in)
        torch.cuda.current_stream(X.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # the capture alone holds the gate; capture_begin/capture_end rather
        # than torch.cuda.graph, whose entry empties the allocator's cache of
        # every engine of the process
        with DEVICE_GATE.exclusive():
            enabled = gc.isenabled()
            gc.disable()
            try:
                side.synchronize()
                with torch.cuda.stream(side):
                    graph.capture_begin()
                    try:
                        out = comp.device_decode(x_in, len_in)
                    finally:
                        graph.capture_end()
            finally:
                if enabled:
                    gc.enable()
        side.synchronize()
        _cuda.count_compile()
        self.capture_seconds += time.perf_counter() - t0
        return graph, x_in, len_in, out
