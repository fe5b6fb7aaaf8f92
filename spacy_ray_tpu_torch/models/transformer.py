"""Transformer trunk: hash-embed featurizer, learned positions, a stack of
dense pre-LN encoder layers, a final layer norm.

Counterpart of ``spacy_ray_tpu/models/transformer.py``: the dense layer
(``apply_transformer_layer``) with dropout on the attention and FFN outputs
in training, the layer stack as a plain loop with a per-layer dropout seed
folded from the step's seed and the layer index (JAX: ``fold_in(key, li)``),
remat through ``torch.utils.checkpoint``, ``_wdot`` with both weight
encodings, the bf16 / int8 serving overlays, ``init_weights`` (a local
checkpoint loaded over the seeded initialisation, ``models/pretrained.py``)
and ``spacy-transformers.TransformerModel.v3`` on a local path. The layers'
parameters sit under ``layer_{i}``, the JAX package's checkpoint names.
MoE, ring attention and pipeline parallelism are not ported yet.

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
})
# Layer leaves that stay f32 by design (they feed f32 layer norms).
TRUNK_F32_LEAF_NAMES = frozenset({"ln1_g", "ln1_b", "ln2_g", "ln2_b"})
# Leaves the int8 weight-only overlay quantizes: the dense matmul weights.
INT8_LEAF_NAMES = frozenset({"qkv_W", "o_W", "ffn_W1", "ffn_W2"})

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


class TransformerLayer(Model):
    """Dense pre-LN encoder layer; parameters named as the JAX layer's."""

    def __init__(self, width: int, ffn: int, n_heads: int, name: str):
        super().__init__(name, dims={"nO": width, "n_heads": n_heads})
        self.qkv_W = empty_param(width, 3 * width)
        self.qkv_b = zeros_param(3 * width)
        self.o_W = empty_param(width, width)
        self.o_b = zeros_param(width)
        self.ln1_g, self.ln1_b = ones_param(width), zeros_param(width)
        self.ln2_g, self.ln2_b = ones_param(width), zeros_param(width)
        self.ffn_W1 = empty_param(width, ffn)
        self.ffn_b1 = zeros_param(ffn)
        self.ffn_W2 = empty_param(ffn, width)
        self.ffn_b2 = zeros_param(width)

    def reset_own_parameters(self, generator: torch.Generator) -> None:
        for leaf in (self.qkv_W, self.o_W, self.ffn_W1, self.ffn_W2):
            normal_(leaf, 0.02, generator)

    def forward(self, X: torch.Tensor, keys: KeyPadding,
                overlay: Optional[Overlay], compute_dtype: torch.dtype,
                dropout: float = 0.0, seed: Optional[int] = None) -> torch.Tensor:
        """X [B, T, D] f32, keys the trunk's key padding -> [B, T, D] f32.
        With a seed and a positive rate, dropout hits the attention output
        and then the FFN output, both masks from one generator seeded here."""
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

        h = O.layer_norm(X, self.ln2_g, self.ln2_b).to(cd)
        inner = O.gelu(_wdot(h, w("ffn_W1"), cd) + w("ffn_b1").to(cd))
        out = _wdot(inner, w("ffn_W2"), cd) + w("ffn_b2").to(cd)
        return X + O.dropout(out.to(torch.float32), dropout, gen)


class TransformerEncoder(Model):
    """Hash-embed featurized transformer trunk (tok2vec-compatible output)."""

    def __init__(self, width: int, depth: int, n_heads: int, ffn_mult: int,
                 max_len: int, embed_size: int, compute_dtype: str,
                 dropout: float = 0.0, remat: bool = False,
                 init_weights: Optional[str] = None):
        super().__init__(
            "transformer_encoder",
            dims={"nO": width, "depth": depth, "n_heads": n_heads},
            meta={"compute_dtype_name": compute_dtype},
        )
        self.max_len = max_len
        self.dropout = dropout
        self.remat = remat
        self.init_weights = init_weights
        self.embed = MultiHashEmbed(
            width=width, attrs=list(ATTRS), rows=[embed_size] + [embed_size // 2] * 3
        )
        self.pos = empty_param(max_len, width)
        self.ln_f_g, self.ln_f_b = ones_param(width), zeros_param(width)
        for i in range(depth):
            self.add_module(
                f"layer_{i}", TransformerLayer(width, width * ffn_mult, n_heads, f"layer_{i}")
            )

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
        for li, layer in enumerate(self.layers()):
            args = (X, keys, (overlay or {}).get(layer.name), cd, rate, ctx.fold_in(li))
            X = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
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
    initialisation; MoE is not part of this port yet and raises."""
    if width % n_heads != 0:
        raise ValueError(f"width {width} not divisible by n_heads {n_heads}")
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {sorted(REMAT_POLICIES)}, "
                         f"got {remat_policy!r}")
    if n_experts:
        raise NotImplementedError("MoE trunks (n_experts > 0) are not ported yet")
    return TransformerEncoder(width, depth, n_heads, ffn_mult, max_len, embed_size,
                              compute_dtype, dropout=dropout, remat=remat,
                              init_weights=init_weights)


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
