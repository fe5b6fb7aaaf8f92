"""Which worker of a trainer fleet owns which slice of every parameter
(``spacy_ray_tpu/training/fleet/ownership.py``).

A leaf is sharded along its first axis that the worker count divides (and
that is at least that count); worker ``k`` owns the ``k``-th of those equal
spans. A leaf that no axis shards (a scalar, a small bias) is owned whole by
worker 0. The rule, the depth-first sorted-key walk and the signature string
are the JAX package's, so a port worker and a JAX worker over the same
parameter template name the same leaves, slices and layout.

Templates are nested dicts of numpy arrays whose '/'-joined paths are the
keys of the flat ``params.npz`` (:func:`tree_from_flat` nests such a flat
dict). Numpy only: the fleet moves its slices through host memory.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

PathT = Tuple[str, ...]
IndexT = Tuple[Tuple[int, int], ...]


def shard_axis(shape: Sequence[int], n_workers: int) -> Optional[int]:
    """The first axis divisible by (and at least) ``n_workers``; None when
    no axis is, and the leaf is owned whole by worker 0."""
    if n_workers <= 1:
        return None
    for axis, dim in enumerate(shape):
        if dim % n_workers == 0 and dim >= n_workers:
            return axis
    return None


def path_key(path: PathT) -> str:
    return "/".join(path)


def iter_leaves(tree: Any, prefix: PathT = ()) -> Iterator[Tuple[PathT, Any]]:
    """Depth-first walk of a nested dict with the keys of each level sorted
    (the JAX package's tree order), yielding ``(path, leaf)``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def tree_from_flat(flat: Dict[str, Any]) -> Dict[str, Any]:
    """'/'-joined path keys back into a nested dict."""
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


class OwnershipLayout:
    """The owner of each slice of every leaf of a parameter template, built
    once from the template's shapes; gradients share the parameters' tree,
    so one layout slices both."""

    def __init__(self, template: Any, n_workers: int) -> None:
        self.n_workers = max(int(n_workers), 1)
        self.paths: List[PathT] = []
        self.shapes: List[Tuple[int, ...]] = []
        self.axes: List[Optional[int]] = []
        self._by_key: Dict[str, int] = {}
        for path, leaf in iter_leaves(template):
            shape = tuple(int(d) for d in np.shape(leaf))
            self.paths.append(path)
            self.shapes.append(shape)
            self.axes.append(shard_axis(shape, self.n_workers))
            self._by_key[path_key(path)] = len(self.paths) - 1

    def owns(self, ordinal: int, worker: int) -> bool:
        """Does ``worker`` own a piece of leaf ``ordinal``? Every worker owns
        its slice of a sharded leaf; worker 0 owns an unsharded one."""
        if self.axes[ordinal] is None:
            return worker == 0
        return 0 <= worker < self.n_workers

    def index(self, ordinal: int, worker: int) -> Optional[IndexT]:
        """``worker``'s slice of leaf ``ordinal`` as ``((start, stop), ...)``
        over every axis, or None for a leaf owned whole."""
        axis = self.axes[ordinal]
        if axis is None:
            return None
        shape = self.shapes[ordinal]
        span = shape[axis] // self.n_workers
        return tuple((worker * span, (worker + 1) * span) if a == axis else (0, dim)
                     for a, dim in enumerate(shape))

    def key_index(self, key: str, worker: int) -> Optional[IndexT]:
        """:meth:`index` by '/'-joined path key."""
        ordinal = self._by_key.get(key)
        if ordinal is None:
            raise ValueError(f"unknown param leaf {key!r}")
        return self.index(ordinal, worker)

    @staticmethod
    def slice_with(arr: np.ndarray, index: Optional[IndexT]) -> np.ndarray:
        if index is None:
            return np.asarray(arr)
        return np.asarray(arr)[tuple(slice(a, b) for a, b in index)]

    def owned_keys(self, worker: int) -> List[str]:
        return [path_key(self.paths[i]) for i in range(len(self.paths))
                if self.owns(i, worker)]

    def flat_slices(self, tree: Any, worker: int) -> Dict[str, np.ndarray]:
        """``worker``'s slices of a params-shaped tree as a flat '/'-keyed
        dict of contiguous copies (safe to send or mutate after the tree
        moves on)."""
        out: Dict[str, np.ndarray] = {}
        for path, leaf in iter_leaves(tree):
            ordinal = self._by_key[path_key(path)]
            if self.owns(ordinal, worker):
                out[path_key(path)] = np.array(
                    self.slice_with(np.asarray(leaf), self.index(ordinal, worker)))
        return out

    def slice_tree(self, tree: Any, worker: int) -> Dict[str, Any]:
        """:meth:`flat_slices` nested: the owned paths only."""
        return tree_from_flat(self.flat_slices(tree, worker))

    def merge_flat(self, full: Any, worker: int, flat: Dict[str, np.ndarray], *,
                   add: bool = False) -> None:
        """Write ``worker``'s slices into the full tree of numpy arrays in
        place (a pull); with ``add`` add them to what is there instead (a
        delta pull, which may leave out the leaves that did not change). An
        unknown key or a piece of the wrong shape raises before anything is
        written: a peer sending another model is a config error, not data."""
        targets = []  # every piece is checked before any is written
        for key, piece in flat.items():
            ordinal = self._by_key.get(key)
            if ordinal is None:
                raise ValueError(f"unknown param leaf {key!r} in merge")
            node = full
            for p in self.paths[ordinal][:-1]:
                node = node[p]
            arr = node[self.paths[ordinal][-1]]
            index = self.index(ordinal, worker)
            where = (Ellipsis if index is None
                     else tuple(slice(a, b) for a, b in index))
            if np.shape(piece) != np.shape(arr[where]):
                raise ValueError(f"shape mismatch for {key!r}: {np.shape(piece)} vs "
                                 f"{np.shape(arr[where])}")
            targets.append((arr, where, piece))
        for arr, where, piece in targets:
            if add:
                arr[where] += piece
            else:
                arr[where] = piece

    def signature(self) -> str:
        """A digest of the paths, shapes and worker count that every peer
        must agree on (``/healthz`` carries it; startup checks it)."""
        text = f"n={self.n_workers}|" + "|".join(
            f"{path_key(p)}:{'x'.join(map(str, s))}" for p, s in zip(self.paths, self.shapes))
        return hashlib.sha256(text.encode("utf8")).hexdigest()[:16]
