"""The flat ``params.npz`` of a saved pipeline, in the JAX package's layout
(``spacy_ray_tpu/training/checkpoint.py`` ``save_params``/``load_params``):
one array per parameter, keyed by its '/'-joined path, e.g.
``transformer/layer_3/qkv_W``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {'/'-joined path: leaf}, paths in sorted order."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    else:
        out[prefix] = tree
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def save_params(path, params: Dict[str, Any]) -> None:
    """Write a nested or flat {path: tensor | array} tree as a flat npz."""
    flat = {
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in flatten(params).items()
    }
    np.savez(str(path), **flat)


def load_params(path) -> Dict[str, np.ndarray]:
    """Read a flat npz into {path: numpy array}."""
    with np.load(str(path)) as data:
        return {k: data[k] for k in data.files}
