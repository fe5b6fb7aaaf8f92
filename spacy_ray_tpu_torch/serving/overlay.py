"""Serving precision overlay: reduced-precision copies of the trunk's
weights, built once when the engine starts, with a label that says what the
device really runs.

The policy of ``spacy_ray_tpu/serving/overlay.py``, with ``cuda`` in the
place of "accelerator":

* ``auto`` arms the bf16 overlay on ``cuda`` and resolves to f32 on ``cpu``
  (where the trunk computes in f32 anyway).
* An explicit ``bf16`` or ``int8`` is honoured on either device; on ``cpu``
  the label says it was forced. ``int8`` runs the int8 kernel on ``cuda``
  and its plain version on ``cpu``; there is no probe.
* The overlay is refused (f32 served, reason in the label) when the model
  has no transformer trunk, or a trunk layer carries leaves the overlay
  scheme does not know; ``int8`` is refused for an MoE trunk, whose expert
  weights the int8 overlay does not cover (JAX's label, word for word).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.transformer import (
    build_int8_overlay,
    build_param_shadow,
    int8_unsupported_leaves,
    shadow_coverage,
)

logger = logging.getLogger("spacy_ray_tpu_torch.serving")

PRECISION_CHOICES = ("auto", "f32", "bf16", "int8")


@dataclass(frozen=True)
class OverlayResult:
    """What the engine serves, with the reason attached."""

    requested: str                      # "auto" | "f32" | "bf16" | "int8"
    resolved: str                       # "f32" | "bf16" | "int8"
    label: str                          # e.g. "bf16 (overlay: 96 trunk leaves; ...)"
    reason: str
    overlay: Optional[Dict[str, Any]]   # the tree predict_docs takes, None for f32
    n_overlaid: int


def resolve_precision(requested: str, device: torch.device) -> Tuple[str, str]:
    """``(resolved, reason)`` for the requested knob on ``device``."""
    if requested not in PRECISION_CHOICES:
        raise ValueError(
            f"precision must be one of {list(PRECISION_CHOICES)}, got {requested!r}"
        )
    kind = device.type
    if requested == "f32":
        return "f32", "explicit f32"
    if requested == "auto":
        if kind == "cpu":
            return "f32", "auto resolves f32 on cpu"
        return "bf16", f"auto arms bf16 on {kind}"
    if kind == "cpu":
        what = "plain int8 matmul" if requested == "int8" else "bf16"
        return requested, f"forced {what} on cpu (auto would resolve f32 there)"
    what = "int8 kernel" if requested == "int8" else "bf16"
    return requested, f"explicit {what} on {kind}"


def build_params_overlay(params: Dict[str, Any], precision: str,
                         device: torch.device) -> OverlayResult:
    """Resolve the policy and build the overlay tree over ``params`` (the
    pipeline's nested parameter dict)."""
    resolved, reason = resolve_precision(precision, device)

    def f32(why: str) -> OverlayResult:
        label = "f32" if precision == "f32" else f"f32 ({why})"
        return OverlayResult(precision, "f32", label, why, None, 0)

    if resolved == "f32":
        return f32(reason)
    eligible, unknown = shadow_coverage(params)
    if unknown:
        why = (f"overlay refused: {len(unknown)} trunk leaf(s) unknown to the "
               f"overlay scheme ({', '.join(unknown[:4])})")
        logger.warning(why)
        return f32(why)
    if eligible == 0:
        return f32("overlay refused: no transformer trunk in the pipeline")
    if resolved == "int8":
        moe = int8_unsupported_leaves(params)
        if moe:
            return f32(f"overlay refused: {len(moe)} MoE expert weight leaf(s) "
                       f"outside int8 coverage ({', '.join(moe[:4])}"
                       + (", ..." if len(moe) > 4 else "") + ")")
        tree, n = build_int8_overlay(params)
        label = f"int8 (overlay: {n} trunk weights quantized per-channel; {reason})"
    else:
        tree, n = build_param_shadow(params), eligible
        label = f"bf16 (overlay: {n} trunk leaves; {reason})"
    logger.info("serving precision %s", label)
    return OverlayResult(precision, resolved, label, reason, tree, n)
