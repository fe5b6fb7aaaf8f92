"""Structured resilience events (``spacy_ray_tpu/training/resilience.py``
``log_event``): a line on the training logger for people, and a record kept
for machines until :func:`drain_events` takes it. The rest of the JAX
module (preemption, watchdog, supervisor) is not part of the port yet.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Any, Deque, Dict, List

logger = logging.getLogger("spacy_ray_tpu_torch.training")

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
