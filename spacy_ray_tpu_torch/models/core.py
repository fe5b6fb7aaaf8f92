"""Model core: named ``nn.Module`` layers whose parameter paths are the JAX
package's.

A JAX model's parameters are a nested dict keyed by stable path strings
(``transformer/embed/1_mix/W``; ``spacy_ray_tpu/models/core.py``). Here each
layer is an ``nn.Module`` registered under the same key, so ``state_dict()``
names are those paths with ``.`` for ``/`` (:func:`param_paths`), and one
flat ``params.npz`` loads in either package. Weights keep the JAX layout
(``W`` is ``[nI, nO]``, applied as ``X @ W``).

Initialisation is explicit: :meth:`Model.init_parameters` draws from a
``torch.Generator`` (the JAX initialisers' distributions, not their bits).

Parameters are created frozen (``requires_grad=False``), which is what
serving wants; training turns them trainable with ``requires_grad_(True)``
on the pipeline's models. A :class:`Context` carries the train flag, the
global dropout override, the integer seed that dropout masks derive from and
the sink that auxiliary losses (an MoE router's) are appended to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch import nn


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data), the role of ``jax.random.fold_in``
    (splitmix64 of the pair; not JAX's bits)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


@dataclass
class Context:
    """Per-call context of a forward: the train flag, the global training
    dropout override (``[training] dropout``; None keeps each layer's
    configured rate), the integer seed dropout masks derive from (None: no
    dropout), and ``aux_losses``, the list a layer with a regularizer term
    (the MoE router's load-balancing loss) appends to, which the loss sums
    into the total (None: no sink, the term is dropped). Counterpart of
    ``spacy_ray_tpu/models/core.py``'s Context, with a seed where JAX
    threads a key."""

    train: bool = False
    dropout: Optional[float] = None
    seed: Optional[int] = None
    aux_losses: Optional[List[Any]] = None

    def dropout_rate(self, configured: float) -> float:
        """The effective dropout rate at a site whose architecture default
        is ``configured``: 0 outside training."""
        if not self.train:
            return 0.0
        return self.dropout if self.dropout is not None else configured

    def fold_in(self, data: int) -> Optional[int]:
        return None if self.seed is None else fold_in(self.seed, data)

    def child(self, i: int) -> "Context":
        """The context of a chain's i-th child: the same flags and the same
        aux sink (the list itself, as JAX's ``split`` passes it on), the
        seed folded with ``i`` (JAX splits the key once per child)."""
        return Context(self.train, self.dropout, self.fold_in(i), self.aux_losses)

    def add_aux_loss(self, value: Any) -> None:
        """Append ``value`` to the sink; without one, drop it."""
        if self.aux_losses is not None:
            self.aux_losses.append(value)


class Model(nn.Module):
    """A named layer with static dims and free-form meta. A layer whose
    forward takes a :class:`Context` after its input (a dropout site, or a
    combinator with one inside) sets ``takes_ctx``."""

    takes_ctx = False

    def __init__(self, name: str, dims: Optional[Dict[str, int]] = None,
                 meta: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.name = name
        self.dims: Dict[str, int] = dict(dims or {})
        self.meta: Dict[str, Any] = dict(meta or {})

    def init_parameters(self, generator: torch.Generator) -> None:
        """Draw this layer's own parameters, then its children's, in order."""
        self.reset_own_parameters(generator)
        for child in self.children():
            if isinstance(child, Model):
                child.init_parameters(generator)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        """Layers with parameters of their own override this."""

    def walk(self):
        return (m for m in self.modules() if isinstance(m, Model))


def call(layer: nn.Module, x: Any, ctx: Optional[Context]) -> Any:
    """``layer(x)``, with ``ctx`` passed on (by keyword: a trunk's second
    argument is its overlay) to a layer that takes one."""
    return layer(x, ctx=ctx) if getattr(layer, "takes_ctx", False) else layer(x)


class Chain(Model):
    """Feed-forward composition; children keyed ``{i}_{name}``. Child ``i``
    runs under ``ctx.child(i)``."""

    takes_ctx = True

    def __init__(self, *layers: Model, name: str = "chain"):
        super().__init__(name)
        for i, layer in enumerate(layers):
            self.add_module(f"{i}_{layer.name}", layer)
        if layers and "nI" in layers[0].dims:
            self.dims["nI"] = layers[0].dims["nI"]
        if layers and "nO" in layers[-1].dims:
            self.dims["nO"] = layers[-1].dims["nO"]

    def forward(self, x: Any, ctx: Optional[Context] = None) -> Any:
        ctx = ctx or Context()
        for i, layer in enumerate(self.children()):
            x = call(layer, x, ctx.child(i))
        return x


class Residual(Model):
    """``x + layer(x)`` over Padded values, with the inner layer's mask; the
    inner layer's parameters sit under ``inner`` and it runs under the
    residual's own context (JAX ``models/core.py`` ``residual``)."""

    takes_ctx = True

    def __init__(self, layer: Model, name: str = "residual"):
        super().__init__(name, dims=dict(layer.dims))
        self.inner = layer

    def forward(self, x: Any, ctx: Optional[Context] = None) -> Any:
        out = call(self.inner, x, ctx)
        return type(out)(X=x.X + out.X, mask=out.mask)


def param_paths(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters and persistent buffers (the frozen tables of
    static vectors) under the JAX package's '/'-joined paths."""
    return {k.replace(".", "/"): v for k, v in module.state_dict().items()}


# ---------------------------------------------------------- initialisers


def glorot_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = t.shape[0], t.shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def normal_(t: torch.Tensor, stddev: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, stddev, generator=generator)


def zeros_param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def ones_param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape), requires_grad=False)


def empty_param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape), requires_grad=False)
