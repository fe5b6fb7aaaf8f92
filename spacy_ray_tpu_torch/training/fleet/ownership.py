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

The optimizer half (:func:`opt_part_records`, :func:`local_opt_from_canonical`)
maps an owner's optimizer state over its slices to and from the one-process
state over the whole template, ``{"count", "sched_count", "mu/<path>",
"nu/<path>"}`` by flat name (``training/optimizers.py``): an owner's
checkpoint part holds its pieces of that state, and a resume or a re-shard
carves them back out.
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

    def index_for_shape(self, shape: Sequence[int], worker: int) -> Optional[IndexT]:
        """``worker``'s slice of any leaf of ``shape`` (an optimizer moment, a
        count) by the same rule as the parameters': None when no axis
        shards it."""
        axis = shard_axis(shape, self.n_workers)
        if axis is None:
            return None
        span = int(shape[axis]) // self.n_workers
        return tuple((worker * span, (worker + 1) * span) if a == axis else (0, int(d))
                     for a, d in enumerate(shape))

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


#: one record of an owner's checkpoint part: ``(flat name, slice index or
#: None for a whole leaf, the leaf's global shape, dtype, piece)``
OptRecord = Tuple[str, Optional[IndexT], Tuple[int, ...], str, np.ndarray]
_COUNTS = ("count", "sched_count")


def canonical_opt_leaves(optimizer: Any, template: Any) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``{flat name: (shape, dtype)}`` of ``optimizer``'s state over
    ``template`` (a nested or flat tree of parameters): the two counts, and
    ``mu/<path>`` and ``nu/<path>`` when the optimizer keeps moments."""
    leaves: Dict[str, Tuple[Tuple[int, ...], str]] = {c: ((), "int64") for c in _COUNTS}
    if getattr(optimizer, "has_moments", True):
        for path, leaf in iter_leaves(template):
            shape = tuple(int(d) for d in np.shape(leaf))
            for m in ("mu", "nu"):
                leaves[f"{m}/{path_key(path)}"] = (shape, "float32")
    return dict(sorted(leaves.items()))


def opt_part_records(optimizer: Any, param_template: Any, layout: Any,
                     local_opt: Dict[str, np.ndarray], worker: int) -> Tuple[int, List[OptRecord]]:
    """``(n_leaves, records)`` of ``worker``'s checkpoint part: its local
    optimizer state (over its slices, by flat name, host arrays) mapped onto
    the state over the whole ``param_template`` (``n_leaves`` names). A sliced leaf gives
    its owner's piece; a leaf no axis shards (the counts, a small bias's
    moments) is written whole by the rank-0 owner only: ``worker`` itself
    under an :class:`OwnershipLayout`, the lowest active id under a
    :class:`~.membership.RankedLayout`."""
    rank = worker
    rank_of = getattr(layout, "rank_of", None)
    if rank_of is not None:
        rank = rank_of(worker)
        if rank is None:
            raise ValueError(f"worker {worker} is not in the layout's active set")
    canonical = canonical_opt_leaves(optimizer, param_template)
    records: List[OptRecord] = []
    for name, piece in local_opt.items():
        piece = np.asarray(piece)
        if name not in canonical:
            raise ValueError(f"local optimizer leaf {name!r} has no canonical counterpart — "
                             "owned slice tree diverged from the param template")
        gshape = canonical[name][0]
        index = layout.index_for_shape(gshape, worker)
        if index is None:
            if rank != 0:
                continue  # the rank-0 owner writes the whole-leaf copies
            if piece.shape != gshape:
                raise ValueError(f"unshardable optimizer leaf {name!r} has local shape "
                                 f"{piece.shape}, canonical {gshape}")
        else:
            want = tuple(b - a for a, b in index)
            if piece.shape != want:
                raise ValueError(f"optimizer leaf {name!r}: local slice shape {piece.shape} "
                                 f"!= owner-shard shape {want}")
        records.append((name, index, gshape, str(piece.dtype), piece))
    return len(canonical), records


def local_opt_from_canonical(optimizer: Any, layout: Any, canonical_opt: Dict[str, Any],
                             worker: int, slice_params: Any) -> Dict[str, np.ndarray]:
    """The resume direction: ``worker``'s optimizer state over its slices
    (``slice_params``, flat or nested), carved out of the state over the
    whole model (``canonical_opt``, by flat name), as the flat numpy dict
    :meth:`~..optimizers.Optimizer.load_opt_state` reads. Bit-identical to
    what :func:`opt_part_records` wrote."""
    out: Dict[str, np.ndarray] = {}
    for name, (shape, _) in canonical_opt_leaves(optimizer, slice_params).items():
        if name not in canonical_opt:
            raise ValueError(f"checkpointed optimizer state has no leaf {name!r} — "
                             "optimizer config changed since the checkpoint was written?")
        full = np.asarray(canonical_opt[name])
        piece = OwnershipLayout.slice_with(full, layout.index_for_shape(full.shape, worker))
        if tuple(piece.shape) != shape:
            raise ValueError(f"optimizer leaf {name!r}: checkpoint slice shape {piece.shape} "
                             f"!= local shape {shape}")
        out[name] = np.array(piece)
    return out
