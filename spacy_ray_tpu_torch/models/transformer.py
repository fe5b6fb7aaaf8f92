"""Transformer trunk: hash-embed featurizer, learned positions, a stack of
pre-LN encoder layers (a dense FFN or a switch mixture of experts), a final
layer norm.

Counterpart of ``spacy_ray_tpu/models/transformer.py``: the layer
(``apply_transformer_layer``) with dropout on the attention and FFN outputs
in training, the switch-MoE FFN (``_moe_ffn``: top-1 routing, a capacity per
expert, the load-balancing loss into the context's aux sink), the layer
stack as a plain loop with a per-layer dropout seed folded from the step's
seed and the layer index (JAX: ``fold_in(key, li)``), remat through
``torch.utils.checkpoint``, ``_wdot`` with both weight encodings, the bf16 /
int8 serving overlays, ``init_weights`` (a local checkpoint loaded over the
seeded initialisation, ``models/pretrained.py``) and
``spacy-transformers.TransformerModel.v3`` on a local path. The layers'
parameters sit under ``layer_{i}``, the JAX package's checkpoint names.
Ring attention, pipeline parallelism and expert parallelism (the experts
over a mesh axis) are not ported yet: on one card every expert is local.

The MoE FFN dispatches by index where JAX contracts a ``[N, E, C]`` one-hot
with einsums: each token's slot ``expert * C + arrival`` is scattered into
an ``[E, C, D]`` buffer, the experts run as two batched matmuls, and each
token gathers its slot back. Every output of the one-hot products is a sum
with a single non-zero term, so the values are the same.

Remat recomputes each layer fully in the backward for every
``remat_policy`` ("nothing", "dots", "all_dots"); JAX's "dots" policies keep
the weight-matmul outputs instead. That changes memory and time, never
values. Dropout masks are drawn inside the checkpointed function from a
generator seeded with the layer's integer seed, so the recompute draws the
same masks (``torch.utils.checkpoint`` restores the default generators, not
an explicit one).

Precision: parameters are f32. Matmuls run in the compute dtype ("auto" =
bfloat16 on ``cuda``, float32 on ``cpu``); layer norms and the residual
stream stay f32. A serving overlay (``serving/overlay.py``) is a nested dict
``{"layer_i": {leaf: replacement}}`` passed down the forward: a bf16 copy of
a leaf, or an :class:`~..ops.int8_matmul.Int8Weight`.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import ops as O
from ..ops.flash_attention import KeyPadding, key_padding, masked_attention
from ..ops.int8_matmul import Int8Weight, int8_matmul, quantize_int8
from ..registry import registry
from ..types import Padded, TokenBatch
from .core import Context, Model, empty_param, normal_, ones_param, zeros_param
from .pretrained import load_trunk_weights
from .tok2vec import ATTRS, MultiHashEmbed

# Leaves the bf16 overlay covers: every weight/bias the layer casts to the
# compute dtype (matmul operands and the biases added to their outputs).
SHADOW_LEAF_NAMES = frozenset({
    "qkv_W", "qkv_b", "o_W", "o_b", "ffn_W1", "ffn_b1", "ffn_W2", "ffn_b2",
    "e_W1", "e_b1", "e_W2", "e_b2",
})
# Layer leaves that stay f32 by design (they feed f32 ops: the layer norms
# and the MoE router).
TRUNK_F32_LEAF_NAMES = frozenset({"ln1_g", "ln1_b", "ln2_g", "ln2_b", "router_W"})
# Leaves the int8 weight-only overlay quantizes: the dense matmul weights.
INT8_LEAF_NAMES = frozenset({"qkv_W", "o_W", "ffn_W1", "ffn_W2"})
# The MoE expert weights, which the int8 overlay does not cover: a trunk
# that has them is refused the overlay (serving/overlay.py).
INT8_UNSUPPORTED_LEAF_NAMES = frozenset({"e_W1", "e_W2"})

Overlay = Dict[str, Any]
REMAT_POLICIES = ("nothing", "dots", "all_dots")


def resolve_compute_dtype(name: str, device: torch.device) -> torch.dtype:
    """"auto" picks bfloat16 on ``cuda`` and float32 on ``cpu``."""
    if name == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    table = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in table:
        raise ValueError(
            "compute_dtype must be one of ['auto', 'bfloat16', 'float32'], "
            f"got {name!r}"
        )
    return table[name]


def _wdot(h: torch.Tensor, leaf, compute_dtype: torch.dtype) -> torch.Tensor:
    """Trunk weight matmul over either leaf encoding: a plain weight (cast to
    the compute dtype) or an int8 overlay leaf (the int8 kernel, f32
    accumulation, result cast to the compute dtype)."""
    if isinstance(leaf, Int8Weight):
        return int8_matmul(h, leaf.q8, leaf.scale).to(compute_dtype)
    return h @ leaf.to(compute_dtype)


def moe_capacity(capacity_factor: float, n_tokens: int, n_experts: int) -> int:
    """Slots per expert: ``capacity_factor * N / E`` truncated, at least 1,
    in Python floats as JAX computes it (N counts padding)."""
    return max(int(capacity_factor * n_tokens / max(n_experts, 1)), 1)


def moe_ffn(w, h: torch.Tensor, token_mask: torch.Tensor, *, capacity_factor: float,
            compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-transformer top-1 MoE FFN over flattened tokens (JAX
    ``_moe_ffn``). ``w(name)`` gives a leaf (the overlay's copy or the
    parameter); ``h`` [N, D] is the post-LN f32 stream, ``token_mask`` [N]
    bool. Returns ``(out [N, D] f32, aux)``: the routed expert's FFN times
    its gate probability (zero for padding and for tokens past their
    expert's capacity), and the load-balancing loss
    ``E * sum_e frac_e * mean_prob_e`` over real tokens."""
    N, D = h.shape
    E = w("e_W1").shape[0]
    maskf = token_mask.to(torch.float32)
    probs = torch.softmax(h @ w("router_W"), dim=-1)  # f32 routing
    idx = torch.argmax(probs, dim=-1)  # the first index on ties, as JAX
    gate = probs.gather(1, idx[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(idx, E).to(torch.float32) * maskf[:, None]
    C = moe_capacity(capacity_factor, N, E)
    # each token's arrival in its expert's queue; padding takes no slot
    arrival = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = (arrival < C) & token_mask
    # slot of a kept token; E * C, a spare row dropped below, for the rest
    slot = torch.where(keep, idx * C + arrival.to(idx.dtype),
                       torch.full_like(idx, E * C))
    src = torch.full((E * C + 1,), N, dtype=idx.dtype, device=h.device)
    src.scatter_(0, slot, torch.arange(N, device=h.device))
    h16 = torch.cat([h.to(compute_dtype), h.new_zeros((1, D), dtype=compute_dtype)])
    x_e = h16[src[:E * C]].view(E, C, D)  # empty slots read the zero row
    inner = O.gelu(torch.bmm(x_e, w("e_W1").to(compute_dtype))
                   + w("e_b1").to(compute_dtype)[:, None, :])
    y_e = (torch.bmm(inner, w("e_W2").to(compute_dtype))
           + w("e_b2").to(compute_dtype)[:, None, :])
    y_e = torch.cat([y_e.reshape(E * C, D), y_e.new_zeros((1, D))])
    y = y_e[slot].to(torch.float32) * gate[:, None]
    denom = torch.clamp(maskf.sum(), min=1.0)
    frac = onehot.sum(dim=0) / denom
    mean_prob = (probs * maskf[:, None]).sum(dim=0) / denom
    return y, float(E) * (frac * mean_prob).sum()


class TransformerLayer(Model):
    """Pre-LN encoder layer, its FFN dense or (``n_experts > 0``) a switch
    mixture of experts; parameters named as the JAX layer's."""

    def __init__(self, width: int, ffn: int, n_heads: int, name: str,
                 n_experts: int = 0, capacity_factor: float = 1.25):
        super().__init__(name, dims={"nO": width, "n_heads": n_heads,
                                     "n_experts": n_experts})
        self.capacity_factor = float(capacity_factor)
        self.qkv_W = empty_param(width, 3 * width)
        self.qkv_b = zeros_param(3 * width)
        self.o_W = empty_param(width, width)
        self.o_b = zeros_param(width)
        self.ln1_g, self.ln1_b = ones_param(width), zeros_param(width)
        self.ln2_g, self.ln2_b = ones_param(width), zeros_param(width)
        if n_experts > 0:
            self.router_W = empty_param(width, n_experts)
            self.e_W1 = empty_param(n_experts, width, ffn)
            self.e_b1 = zeros_param(n_experts, ffn)
            self.e_W2 = empty_param(n_experts, ffn, width)
            self.e_b2 = zeros_param(n_experts, width)
            self._weights = ("qkv_W", "o_W", "router_W", "e_W1", "e_W2")
        else:
            self.ffn_W1 = empty_param(width, ffn)
            self.ffn_b1 = zeros_param(ffn)
            self.ffn_W2 = empty_param(ffn, width)
            self.ffn_b2 = zeros_param(width)
            self._weights = ("qkv_W", "o_W", "ffn_W1", "ffn_W2")

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        for name in self._weights:
            normal_(getattr(self, name), 0.02, generator)

    def forward(self, X: torch.Tensor, keys: KeyPadding, mask: torch.Tensor,
                overlay: Optional[Overlay], compute_dtype: torch.dtype,
                dropout: float = 0.0, seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """X [B, T, D] f32, keys the trunk's key padding, mask its [B, T]
        token mask -> ``(X [B, T, D] f32, aux)``, aux the MoE router's
        load-balancing loss (None for a dense layer). With a seed and a
        positive rate, dropout hits the attention output and then the FFN
        output, both masks from one generator seeded here."""
        B, T, D = X.shape
        H = self.dims["n_heads"]
        cd = compute_dtype
        gen = None
        if seed is not None and dropout > 0:
            gen = torch.Generator(device=X.device)
            gen.manual_seed(seed)

        def w(name: str):
            leaf = overlay.get(name) if overlay else None
            return getattr(self, name) if leaf is None else leaf

        h = O.layer_norm(X, self.ln1_g, self.ln1_b).to(cd)
        qkv = _wdot(h, w("qkv_W"), cd) + w("qkv_b").to(cd)
        q, k, v = (x.view(B, T, H, D // H) for x in qkv.split(D, dim=-1))
        attn = masked_attention(q, k, v, keys).reshape(B, T, D)
        out = _wdot(attn, w("o_W"), cd) + w("o_b").to(cd)
        X = X + O.dropout(out.to(torch.float32), dropout, gen)

        h = O.layer_norm(X, self.ln2_g, self.ln2_b)
        aux = None
        if self.dims["n_experts"] > 0:
            out, aux = moe_ffn(w, h.reshape(B * T, D), mask.reshape(B * T),
                               capacity_factor=self.capacity_factor, compute_dtype=cd)
            out = out.reshape(B, T, D)
        else:
            inner = O.gelu(_wdot(h.to(cd), w("ffn_W1"), cd) + w("ffn_b1").to(cd))
            out = (_wdot(inner, w("ffn_W2"), cd) + w("ffn_b2").to(cd)).to(torch.float32)
        return X + O.dropout(out, dropout, gen), aux


class TransformerEncoder(Model):
    """Hash-embed featurized transformer trunk (tok2vec-compatible output).
    With ``n_experts > 0`` every layer's FFN is a switch mixture of experts,
    and in training the layers' summed aux loss times ``router_aux_weight``
    goes to the context's sink (JAX ``models/transformer.py:669-670``)."""

    takes_ctx = True  # a head's inline trunk gets the head's context

    def __init__(self, width: int, depth: int, n_heads: int, ffn_mult: int,
                 max_len: int, embed_size: int, compute_dtype: str,
                 dropout: float = 0.0, remat: bool = False,
                 init_weights: Optional[str] = None, n_experts: int = 0,
                 expert_capacity_factor: float = 1.25, router_aux_weight: float = 0.01):
        super().__init__(
            "transformer_encoder",
            dims={"nO": width, "depth": depth, "n_heads": n_heads, "n_experts": n_experts},
            meta={"compute_dtype_name": compute_dtype},
        )
        self.max_len = max_len
        self.dropout = dropout
        self.remat = remat
        self.init_weights = init_weights
        self.router_aux_weight = float(router_aux_weight)
        self.embed = MultiHashEmbed(
            width=width, attrs=list(ATTRS), rows=[embed_size] + [embed_size // 2] * 3
        )
        self.pos = empty_param(max_len, width)
        self.ln_f_g, self.ln_f_b = ones_param(width), zeros_param(width)
        for i in range(depth):
            self.add_module(f"layer_{i}", TransformerLayer(
                width, width * ffn_mult, n_heads, f"layer_{i}", n_experts=n_experts,
                capacity_factor=expert_capacity_factor))

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        normal_(self.pos, 0.02, generator)

    def init_parameters(self, generator: torch.Generator) -> None:
        """The seeded draw, then ``init_weights`` over it, as JAX orders them."""
        super().init_parameters(generator)
        if self.init_weights:
            load_trunk_weights(self, self.init_weights)

    def layers(self) -> List[TransformerLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.dims["depth"])]

    def forward(self, batch: TokenBatch, overlay: Optional[Overlay] = None,
                ctx: Optional[Context] = None) -> Padded:
        ctx = ctx or Context()
        emb: Padded = self.embed(batch)
        T = emb.X.shape[1]
        if T > self.max_len:
            warnings.warn(
                f"sequence length {T} exceeds transformer max_len {self.max_len}; "
                "positions beyond max_len reuse the last positional embedding",
                stacklevel=2,
            )
        pos_idx = torch.clamp(torch.arange(T, device=emb.X.device), max=self.max_len - 1)
        X = emb.X + self.pos[pos_idx][None, :, :]
        mask = emb.mask
        cd = resolve_compute_dtype(self.meta["compute_dtype_name"], X.device)
        rate = ctx.dropout_rate(self.dropout)
        remat = self.remat and ctx.train and torch.is_grad_enabled()
        keys = key_padding(mask)  # the attention bias and key extent, for every layer
        aux_total = None
        for li, layer in enumerate(self.layers()):
            args = (X, keys, mask, (overlay or {}).get(layer.name), cd, rate, ctx.fold_in(li))
            # under remat the recompute routes every token as the forward
            # did: the routing depends on the layer's inputs alone
            X, aux = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        if aux_total is not None:
            ctx.add_aux_loss(self.router_aux_weight * aux_total)
        X = O.layer_norm(X, self.ln_f_g, self.ln_f_b)
        return Padded(X=X * mask[..., None].to(X.dtype), mask=mask)


@registry.architectures("spacy_ray_tpu.TransformerEncoder.v1")
def make_transformer_encoder(
    width: int = 768,
    depth: int = 12,
    n_heads: int = 12,
    ffn_mult: int = 4,
    dropout: float = 0.1,
    max_len: int = 512,
    embed_size: int = 10000,
    remat: bool = True,
    remat_policy: str = "dots",
    compute_dtype: str = "auto",
    init_weights: Optional[str] = None,
    pp_microbatches: int = 0,
    n_experts: int = 0,
    expert_capacity_factor: float = 1.25,
    router_aux_weight: float = 0.01,
    scan_layers: bool = True,
) -> TransformerEncoder:
    """The JAX architecture's signature, so its configs resolve unchanged.
    ``dropout`` and ``remat`` act in training (every ``remat_policy``
    recomputes a layer fully); ``pp_microbatches`` and ``scan_layers`` shape
    multi-chip and compiled programs and are accepted and unused (the layers
    are never stacked: their names stay ``layer_{i}``); ``init_weights`` is
    a local .npz or .safetensors file (``models/pretrained.py``) loaded at
    initialisation; ``n_experts > 0`` makes every FFN a switch mixture of
    that many experts, ``expert_capacity_factor`` sizes their queues and
    ``router_aux_weight`` scales the load-balancing loss."""
    if width % n_heads != 0:
        raise ValueError(f"width {width} not divisible by n_heads {n_heads}")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {sorted(REMAT_POLICIES)}, "
                         f"got {remat_policy!r}")
    return TransformerEncoder(width, depth, n_heads, ffn_mult, max_len, embed_size,
                              compute_dtype, dropout=dropout, remat=remat,
                              init_weights=init_weights, n_experts=int(n_experts),
                              expert_capacity_factor=expert_capacity_factor,
                              router_aux_weight=router_aux_weight)


@registry.architectures("spacy-transformers.TransformerModel.v3")
def make_hf_transformer_model(
    name: str = "roberta-base",
    get_spans=None,
    tokenizer_config: Optional[dict] = None,
    transformer_config: Optional[dict] = None,
) -> TransformerEncoder:
    """spacy-transformers' registered name, so its configs resolve: ``name``
    must be a local .safetensors or .npz checkpoint, remapped into a
    RoBERTa-base-shaped trunk (``transformer_config`` may set width, depth,
    n_heads and max_len); a hub name raises, as nothing is downloaded."""
    if not Path(name).exists():
        raise NotImplementedError(
            f"{name!r} is not a local file, and downloading HuggingFace "
            "checkpoints is impossible in this zero-egress environment. "
            "Point `name` at a local .safetensors/.npz checkpoint, or use "
            '@architectures "spacy_ray_tpu.TransformerEncoder.v1" with '
            "init_weights=<path> (same RoBERTa-base shape)."
        )
    cfg = dict(transformer_config or {})
    return make_transformer_encoder(
        width=int(cfg.get("width", 768)), depth=int(cfg.get("depth", 12)),
        n_heads=int(cfg.get("n_heads", 12)), max_len=int(cfg.get("max_len", 512)),
        init_weights=name,
    )


# ------------------------------------------------------- serving overlays


def _trunk_layers(params: Dict[str, Any]):
    """(path, layer dict) of every ``layer_i`` dict in a nested param tree."""
    def rec(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                if str(k).startswith("layer_"):
                    yield path + (k,), v
                else:
                    yield from rec(v, path + (k,))

    yield from rec(params, ())


def _nest(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in items:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return out


def shadow_coverage(params: Dict[str, Any]) -> Tuple[int, List[str]]:
    """``(n_eligible, unknown)``: f32 trunk leaves the bf16 overlay would
    cover, and ``layer_i`` leaves in neither leaf set (a non-empty list means
    an overlay would only half cover the model and must be refused)."""
    eligible = 0
    unknown: List[str] = []
    for path, layer in _trunk_layers(params):
        for k, v in layer.items():
            if k in SHADOW_LEAF_NAMES:
                eligible += int(v.dtype == torch.float32)
            elif k not in TRUNK_F32_LEAF_NAMES:
                unknown.append("/".join(path + (k,)))
    return eligible, unknown


def build_param_shadow(params: Dict[str, Any], dtype: torch.dtype = torch.bfloat16):
    """Overlay tree of ``dtype`` copies of every f32 SHADOW_LEAF_NAMES leaf
    under a ``layer_i`` dict; None when there is none."""
    items = [
        (path + (k,), v.to(dtype))
        for path, layer in _trunk_layers(params)
        for k, v in layer.items()
        if k in SHADOW_LEAF_NAMES and v.dtype == torch.float32
    ]
    return _nest(items) or None


def int8_unsupported_leaves(params: Dict[str, Any]) -> List[str]:
    """Paths of trunk leaves the int8 overlay cannot cover (the MoE expert
    weights); a non-empty list means the overlay must be refused."""
    return ["/".join(path + (k,)) for path, layer in _trunk_layers(params)
            for k in layer if k in INT8_UNSUPPORTED_LEAF_NAMES]


def build_int8_overlay(params: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """Overlay tree replacing every f32 INT8_LEAF_NAMES leaf under a
    ``layer_i`` dict by its per-channel :class:`Int8Weight`. Biases, layer
    norms, embeddings and heads stay the f32 masters. Returns
    ``(tree, n_quantized)``."""
    items = [
        (path + (k,), Int8Weight(*quantize_int8(v)))
        for path, layer in _trunk_layers(params)
        for k, v in layer.items()
        if k in INT8_LEAF_NAMES and v.dtype == torch.float32
    ]
    return _nest(items), len(items)
