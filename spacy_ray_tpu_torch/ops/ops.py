"""Elementwise and small dense ops, on padded [B, T, D] tensors.

Same semantics as ``spacy_ray_tpu/ops/ops.py``: the CNN's window
concatenation (``seq2col``: padding masked to zero before the shifts, zeros
past the sequence edges, offsets -nW .. +nW in order), biased variance and eps
1e-5 in the layer norm, the tanh approximation of GELU, mish (its softplus
JAX's ``logaddexp(X, 0)``), maxout weights laid
out ``[nI, nO * nP]`` with the pieces innermost (part of the checkpoint
contract), inverted dropout with keep = 1 - rate, the masked mean
cross-entropy and accuracy of the training loss, the masked binary
cross-entropy of the multilabel heads (its denominator is valid rows times
classes), and the masked mean and max pools (a max's gradient split evenly
over tied maxima, as ``jnp.max`` splits it; an all-padding row pools to 0). Dropout draws its bits from
an explicit ``torch.Generator``: the same distribution as ``jax.random``,
not the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def seq2col(X: torch.Tensor, window: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Concatenate each position's window of neighbours: X [B, T, D] (or
    [T, D]) -> [B, T, (2 * window + 1) * D], the offsets -window .. +window
    in that order. With a [B, T] ``mask``, X is masked first, so a real
    token next to padding reads zeros there, as it does past the edges."""
    squeeze = X.dim() == 2
    if squeeze:
        X = X[None]
        mask = mask[None] if mask is not None else None
    T = X.shape[1]
    if mask is not None:
        X = X * mask[..., None].to(X.dtype)
    padded = F.pad(X, (0, 0, window, window))
    out = torch.cat([padded[:, window + off: window + off + T]
                     for off in range(-window, window + 1)], dim=-1)
    return out[0] if squeeze else out


def layer_norm(
    X: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    mu = X.mean(dim=-1, keepdim=True)
    var = (X - mu).square().mean(dim=-1, keepdim=True)
    return (X - mu) * torch.rsqrt(var + eps) * scale + bias


def mish(X: torch.Tensor) -> torch.Tensor:
    """``X * tanh(softplus(X))``, softplus as JAX's ``logaddexp(X, 0)``."""
    return X * torch.tanh(torch.logaddexp(X, torch.zeros_like(X)))


def gelu(X: torch.Tensor) -> torch.Tensor:
    return F.gelu(X, approximate="tanh")


def maxout(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X [..., nI], W [nI, nO * nP], b [nO, nP] -> [..., nO]."""
    nO, nP = b.shape
    h = X @ W
    h = h.reshape(*h.shape[:-1], nO, nP) + b
    return h.amax(dim=-1)


def dropout(X: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability ``1 - rate``
    (a uniform draw below it) and scale the kept ones by ``1 / keep``;
    identity at rate 0 or without a generator (not training)."""
    if generator is None or rate <= 0.0:
        return X
    keep = 1.0 - rate
    mask = torch.rand(X.shape, generator=generator, device=X.device) < keep
    return torch.where(mask, X / keep, torch.zeros((), dtype=X.dtype, device=X.device))


def masked_softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean cross-entropy over valid positions, in f32. logits [B, T, C],
    labels [B, T] int, mask [B, T] bool; the denominator is at least 1."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.long()[..., None])[..., 0]
    mask_f = mask.float()
    return (ce * mask_f).sum() / torch.clamp(mask_f.sum(), min=1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(dim=-1)
    mask_f = mask.float()
    correct = (pred == labels.long()).float() * mask_f
    return correct.sum() / torch.clamp(mask_f.sum(), min=1.0)


def masked_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy in f32; logits and labels [..., C], the
    mask over the leading dims. The mask is widened to [..., 1], so the
    denominator is the count of valid rows times C (at least 1)."""
    logits = logits.float()
    labels = labels.float()
    per = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    if mask is None:
        return per.mean()
    mask_f = mask.float()
    while mask_f.dim() < per.dim():
        mask_f = mask_f[..., None]
    denom = torch.clamp(mask_f.sum() * per.shape[-1] / max(mask_f.shape[-1], 1), min=1.0)
    return (per * mask_f).sum() / denom


def mean_pool(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, D], [B, T] -> [B, D]: the mean over valid positions."""
    mask_f = mask.to(X.dtype)[..., None]
    return (X * mask_f).sum(dim=1) / torch.clamp(mask_f.sum(dim=1), min=1.0)


def max_pool(X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, D], [B, T] -> [B, D]: the max over valid positions, 0 for a
    row with none. ``amax`` splits the gradient evenly over ties."""
    neg = torch.finfo(X.dtype).min
    out = torch.where(mask[..., None], X, torch.full((), neg, dtype=X.dtype,
                                                     device=X.device)).amax(dim=1)
    return torch.where(mask.any(dim=1)[..., None], out, torch.zeros((), dtype=X.dtype,
                                                                   device=X.device))
