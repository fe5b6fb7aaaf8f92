"""Elementwise and small dense ops of the slice, on padded [B, T, D] tensors.

Same semantics as ``spacy_ray_tpu/ops/ops.py``: biased variance and eps
1e-5 in the layer norm, the tanh approximation of GELU, and maxout weights
laid out ``[nI, nO * nP]`` with the pieces innermost (part of the checkpoint
contract).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(
    X: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    mu = X.mean(dim=-1, keepdim=True)
    var = (X - mu).square().mean(dim=-1, keepdim=True)
    return (X - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu(X: torch.Tensor) -> torch.Tensor:
    return F.gelu(X, approximate="tanh")


def maxout(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X [..., nI], W [nI, nO * nP], b [nO, nP] -> [..., nO]."""
    nO, nP = b.shape
    h = X @ W
    h = h.reshape(*h.shape[:-1], nO, nP) + b
    return h.amax(dim=-1)
