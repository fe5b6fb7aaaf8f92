"""Saved parameters and training checkpoints, in the JAX package's layout
(``spacy_ray_tpu/training/checkpoint.py``).

* ``save_params``/``load_params``: the flat ``params.npz`` of a saved
  pipeline, one array per parameter keyed by its '/'-joined path, e.g.
  ``transformer/layer_3/qkv_W``; either package loads the other's.
* :class:`TrainCheckpoint`: training generations in ``last-model/``.
  Generation ``stamp`` (the step it was written at) is ``params-{stamp}.npz``,
  ``opt_state-{stamp}.npz`` and ``train_meta-{stamp}.json`` (step, epoch,
  best score and step, the loop's RNG state and data position under
  ``extra``, and the SHA-256 of both array files); the pointer
  ``train_meta.json`` is written last with ``os.replace``. The newest
  ``keep`` generations stay, and ``load`` falls back past a torn or missing
  file to the newest intact one. The optimizer state file is the port's
  format (flat ``mu/<path>``, ``nu/<path>``, ``count``, ``sched_count``):
  the JAX package pickles optax's state instead, and neither reads the
  other's; the params files load in both.
* A trainer fleet's generation is format 2 (``meta["format"] == 2``,
  ``opt_shards`` N): each active owner writes its part of the optimizer
  state, ``opt_state-{stamp}.part{k}of{N}.npz`` (:func:`write_fleet_opt_part`;
  ``k`` its rank among the active ids), and the lead writes the params, the
  meta naming every part's digest, and the pointer
  (:func:`commit_fleet_generation`). A part holds its pieces under their
  flat names and a header (``part``, ``parts``, ``n_leaves``, ``stamp`` and a
  record of ``(name, index, global shape, dtype)`` per piece); ``load``
  assembles the parts into the one-process state, and a missing or torn
  part, a digest mismatch or a hole is a :class:`CheckpointCorrupt`. The JAX
  package's parts are pickles of optax's state, which this package does not
  read either.
* :class:`Checkpoints`: a reader of those generations beside a running
  trainer (the serving hot-swap), parameters only, digest-verified.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .resilience import retry_io

logger = logging.getLogger("spacy_ray_tpu_torch.training")


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


class CheckpointCorrupt(RuntimeError):
    """A checkpoint generation is torn, truncated or missing pieces."""


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_npz(path: Path, name: str, flat: Dict[str, Any]) -> str:
    """Write ``path/name`` through a tmp file and os.replace; its SHA-256
    (np.savez appends .npz to the tmp name)."""
    tmp = path / (name + ".tmp")
    save_params(tmp, flat)
    os.replace(tmp.with_suffix(tmp.suffix + ".npz"), path / name)
    return _sha256_file(path / name)


#: the layout version of a trainer fleet's generations (absent or 1: one file)
CHECKPOINT_FORMAT = 2
#: the entry of a part file that holds its header, as JSON
_PART_HEADER = "__part__"


def opt_part_name(stamp: int, part: int, parts: int) -> str:
    return f"opt_state-{int(stamp)}.part{int(part)}of{int(parts)}.npz"


def opt_file_names(meta: Dict[str, Any], stamp: int) -> List[str]:
    """The optimizer-state files a generation's meta commits to: a format-2
    generation's parts (this package's ``.npz`` when its digests name them,
    else the JAX package's pickles), or one file: this package's
    ``opt_state-N.npz`` when the digests name it, else the JAX package's
    pickle."""
    digests = meta.get("digests") or {}
    if int(meta.get("format", 1) or 1) >= 2:
        parts = int(meta.get("opt_shards", 1) or 1)
        names = [opt_part_name(stamp, k, parts) for k in range(parts)]
        if any(n in digests for n in names):
            return names
        return [f"opt_state-{int(stamp)}.part{k}of{parts}.pkl" for k in range(parts)]
    if f"opt_state-{int(stamp)}.npz" in digests:
        return [f"opt_state-{int(stamp)}.npz"]
    return [f"opt_state-{int(stamp)}.pkl"]


def _commit_meta(path: Path, stamp: int, meta: Dict[str, Any]) -> None:
    """The generation's meta first (it makes the generation loadable), the
    pointer last, each through a tmp file and os.replace."""
    text = json.dumps(meta, indent=2)
    for name in (f"train_meta-{int(stamp)}.json", "train_meta.json"):
        tmp = path / (name + ".tmp")
        tmp.write_text(text, encoding="utf8")
        os.replace(tmp, path / name)


def write_fleet_opt_part(path, *, stamp: int, part: int, parts: int, n_leaves: int,
                         records) -> str:
    """One fleet owner's part of generation ``stamp``:
    ``opt_state-{stamp}.part{part}of{parts}.npz``, through a tmp file and
    os.replace. ``records`` are ``(name, index, global shape, dtype, piece)``
    (:func:`~.fleet.ownership.opt_part_records`; ``index`` None for a whole
    leaf). Returns the file's SHA-256 for the meta the lead commits."""
    path = Path(path)
    table, arrays = [], {}
    for name, index, gshape, dtype, piece in records:
        table.append([str(name), None if index is None else [[int(a), int(b)] for a, b in index],
                      [int(d) for d in gshape], str(dtype)])
        arrays[str(name)] = np.asarray(piece)
    header = {"part": int(part), "parts": int(parts), "n_leaves": int(n_leaves),
              "stamp": int(stamp), "records": table}
    arrays[_PART_HEADER] = np.array(json.dumps(header))

    def write() -> str:
        path.mkdir(parents=True, exist_ok=True)
        return _write_npz(path, opt_part_name(stamp, part, parts), arrays)

    return retry_io("checkpoint-write", write)


def assemble_opt_parts(files: List[Path], stamp: int) -> Dict[str, np.ndarray]:
    """The one-process optimizer state (by flat name) from a format-2
    generation's digest-verified parts, in rank order. A header that names
    another part, count or stamp, a piece of the wrong shape, two pieces over
    one element, and any element no part covers raise
    :class:`CheckpointCorrupt`."""
    slots: Dict[str, np.ndarray] = {}
    covered: Dict[str, Optional[np.ndarray]] = {}  # None: a whole leaf
    n_leaves: Optional[int] = None
    for k, f in enumerate(files):
        try:
            with np.load(str(f), allow_pickle=False) as data:
                header = json.loads(str(data[_PART_HEADER][()]))
                said = (int(header["part"]), int(header["parts"]), int(header["stamp"]))
                if said != (k, len(files), int(stamp)):
                    raise CheckpointCorrupt(f"{f}: its header names part {said[0]} of "
                                            f"{said[1]} at stamp {said[2]}")
                if n_leaves is not None and int(header["n_leaves"]) != n_leaves:
                    raise CheckpointCorrupt(f"{f}: {header['n_leaves']} leaves, part 0 "
                                            f"says {n_leaves}")
                n_leaves = int(header["n_leaves"])
                for name, index, gshape, dtype in header["records"]:
                    piece, gshape = data[name], tuple(int(d) for d in gshape)
                    if index is None:
                        if name in slots or piece.shape != gshape:
                            raise CheckpointCorrupt(f"{f}: whole leaf {name!r} of shape "
                                                    f"{piece.shape} repeated or not {gshape}")
                        slots[name], covered[name] = np.array(piece), None
                        continue
                    where = tuple(slice(int(a), int(b)) for a, b in index)
                    if name not in slots:
                        slots[name] = np.empty(gshape, np.dtype(dtype))
                        covered[name] = np.zeros(gshape, dtype=bool)
                    mask = covered[name]
                    if mask is None or slots[name].shape != gshape or mask[where].any():
                        raise CheckpointCorrupt(f"{f}: piece {index} of {name!r} overlaps "
                                                "another part's")
                    slots[name][where] = piece
                    mask[where] = True
        except CheckpointCorrupt:
            raise
        except Exception as e:  # a torn zip raises many types
            raise CheckpointCorrupt(f"corrupt opt-state part {f}: {type(e).__name__}: {e}") from e
    holes = sorted(name for name, mask in covered.items() if mask is not None and not mask.all())
    if n_leaves is None or len(slots) != n_leaves or holes:
        raise CheckpointCorrupt(f"opt-state parts incomplete: {len(slots)} of "
                                f"{n_leaves if n_leaves is not None else '?'} leaves, holes in "
                                f"{holes[:5]}")
    return dict(sorted(slots.items()))


def commit_fleet_generation(path, *, params: Dict[str, Any], step: int, epoch: int,
                            rng: str, best_score: float, best_step: int, opt_shards: int,
                            opt_digests: Dict[int, str], extra: Optional[Dict[str, Any]] = None,
                            keep: int = 2) -> None:
    """The lead's half of a fleet generation, its owners' parts already on
    disk (their digests in ``opt_digests`` by rank): the assembled params,
    the format-2 meta naming every part's digest (``extra``'s fleet
    membership normalised by :func:`fleet_membership_extra`), the pointer,
    then the retention sweep. ``rng`` is the lead's seed generator state
    (:func:`generator_state_hex`), which a one-process resume takes."""
    path = Path(path)
    stamp, opt_shards = int(step), int(opt_shards)
    if sorted(int(k) for k in opt_digests) != list(range(opt_shards)):
        raise ValueError(f"fleet generation {stamp}: digests for parts {sorted(opt_digests)}, "
                         f"want 0..{opt_shards - 1}")
    meta: Dict[str, Any] = {
        "step": stamp, "epoch": int(epoch), "rng": rng or "",
        "best_score": float(best_score), "best_step": int(best_step),
        "extra": fleet_membership_extra(extra or {}), "stamp": stamp,
        "format": CHECKPOINT_FORMAT, "opt_shards": opt_shards,
    }

    def write_files() -> None:
        path.mkdir(parents=True, exist_ok=True)
        digests = {f"params-{stamp}.npz": _write_npz(path, f"params-{stamp}.npz", params)}
        for k, digest in sorted(opt_digests.items()):
            digests[opt_part_name(stamp, int(k), opt_shards)] = str(digest)
        meta["digests"] = digests
        _commit_meta(path, stamp, meta)

    retry_io("checkpoint-write", write_files)
    _retention_sweep(path, stamp, max(int(keep), 1))


def _gen_stamp(meta_path: Path) -> Optional[int]:
    name = meta_path.name
    if not (name.startswith("train_meta-") and name.endswith(".json")):
        return None
    try:
        return int(name[len("train_meta-"):-len(".json")])
    except ValueError:
        return None


def _retention_sweep(path: Path, stamp: int, keep: int) -> None:
    """Keep the generation just written and the newest ``keep - 1`` below
    it; stamps above it belong to an abandoned run (a restart without
    --resume counts from 0 into the same directory) and go, with tmp
    stragglers of crashed saves."""
    committed = sorted(s for s in (_gen_stamp(p) for p in path.glob("train_meta-*.json"))
                       if s is not None and s < stamp)
    retained = set(committed[-(keep - 1):]) if keep > 1 else set()
    retained.add(stamp)
    for prefix, suffix in (("params-", ".npz"), ("opt_state-", ".npz"),
                           ("train_meta-", ".json")):
        for old in path.glob(f"{prefix}*{suffix}"):
            try:  # "12", or "12.part0of2" (a fleet owner's part)
                old_stamp = int(old.name[len(prefix):-len(suffix)].split(".", 1)[0])
            except ValueError:
                continue
            if old_stamp not in retained:
                old.unlink(missing_ok=True)
    for pattern in ("*.tmp", "*.tmp.npz"):
        for stray in path.glob(pattern):
            stray.unlink(missing_ok=True)


def generator_state_hex(gen: torch.Generator) -> str:
    """A ``torch.Generator``'s state as hex: how a fleet generation's JSON
    keeps each worker's dropout-seed generator (ROADMAP C53)."""
    return bytes(gen.get_state().numpy()).hex()


def set_generator_state(gen: torch.Generator, value: Any) -> bool:
    """Restore ``gen`` from a saved state, hex (a fleet's) or a list of byte
    values (the one-process loop's); False when there is none."""
    if not value:
        return False
    data = bytes.fromhex(value) if isinstance(value, str) else bytes(int(b) for b in value)
    gen.set_state(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    return True


def flatten_opt_state(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """An optimizer state by flat name (``mu/<path>``, ``nu/<path>``,
    ``count``, ``sched_count``), its moments copied to the host."""
    flat = {f"{m}/{k}": (v.detach().to("cpu", copy=True).numpy()
                         if isinstance(v, torch.Tensor) else np.array(v))
            for m in ("mu", "nu") for k, v in state[m].items()}
    flat["count"] = np.asarray(state["count"], dtype=np.int64)
    flat["sched_count"] = np.asarray(state["sched_count"], dtype=np.int64)
    return flat


def fleet_membership_extra(extra: Dict[str, Any]) -> Dict[str, Any]:
    """``extra`` with its ``fleet`` block's membership normalised before it
    reaches disk, as the JAX package's ``commit_fleet_generation`` does: the
    epoch an int >= 0, ``active`` the sorted unique non-negative ids; a bad
    block raises (it would undo a failover for whoever reads it)."""
    fleet = extra.get("fleet")
    if not isinstance(fleet, dict) or not ("epoch" in fleet or "active" in fleet):
        return extra
    m_epoch = int(fleet.get("epoch", 0))
    active = sorted(int(w) for w in fleet.get("active") or [])
    if m_epoch < 0:
        raise ValueError(f"fleet membership epoch {m_epoch} is negative")
    if not active or len(set(active)) != len(active) or active[0] < 0:
        raise ValueError(f"fleet membership active set {active!r} must be non-empty, unique, "
                         "non-negative worker ids")
    return {**extra, "fleet": {**fleet, "epoch": m_epoch, "active": active}}


class TrainCheckpoint:
    """Training generations with history (layout in the module docstring)."""

    @staticmethod
    def save(path, *, params: Dict[str, Any], opt_state: Dict[str, Any], step: int,
             epoch: int, best_score: float, best_step: int,
             extra: Optional[Dict[str, Any]] = None, keep: int = 2) -> None:
        """Array files first, then the generation's meta, then the pointer:
        a crash at any point leaves the earlier generations loadable. The
        two array files are written and hashed on two threads at once (the
        writes and the hash release the interpreter lock)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        stamp = int(step)
        files = {f"params-{stamp}.npz": params,
                 f"opt_state-{stamp}.npz": flatten_opt_state(opt_state)}
        with ThreadPoolExecutor(max_workers=len(files)) as pool:
            jobs = {name: pool.submit(_write_npz, path, name, flat)
                    for name, flat in files.items()}
            digests = {name: job.result() for name, job in jobs.items()}
        meta = {
            "step": int(step), "epoch": int(epoch), "rng": [],
            "best_score": float(best_score), "best_step": int(best_step),
            "extra": fleet_membership_extra(extra or {}), "stamp": stamp, "digests": digests,
        }
        _commit_meta(path, stamp, meta)
        _retention_sweep(path, stamp, max(int(keep), 1))

    @staticmethod
    def _load_generation(path: Path, meta: Dict[str, Any]) -> Dict[str, Any]:
        """One generation, every file digest-verified; a format-2 fleet
        generation's parts assembled into the one-process optimizer state."""
        stamp = meta.get("stamp")
        if stamp is None:
            raise CheckpointCorrupt(f"{path}: a generation meta without a stamp")
        fmt = int(meta.get("format", 1) or 1)
        opt_names = opt_file_names(meta, int(stamp))
        if any(n.endswith(".pkl") for n in opt_names):
            raise CheckpointCorrupt(f"generation {stamp} in {path} holds the JAX package's "
                                    f"optimizer state ({opt_names[0]}), which this package "
                                    "does not read")
        files = [path / f"params-{int(stamp)}.npz"] + [path / n for n in opt_names]
        digests = meta.get("digests") or {}
        for f in files:
            if not f.exists():
                raise CheckpointCorrupt(f"checkpoint file missing: {f}")
            if f.name not in digests or _sha256_file(f) != digests[f.name]:
                raise CheckpointCorrupt(f"checkpoint digest mismatch: {f} (torn or tampered)")
        try:
            return {
                "params": load_params(files[0]),
                "opt_state": (assemble_opt_parts(files[1:], int(stamp)) if fmt >= 2
                              else load_params(files[1])),
                "step": int(meta["step"]),
                "epoch": int(meta["epoch"]),
                "best_score": float(meta["best_score"]),
                "best_step": int(meta["best_step"]),
                "rng": meta.get("rng") or [],
                "format": fmt,
                "extra": meta.get("extra", {}),
            }
        except CheckpointCorrupt:
            raise
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointCorrupt(f"corrupt checkpoint generation {stamp} in {path}: "
                                    f"{type(e).__name__}: {e}") from e

    @staticmethod
    def generation_stamps(path) -> List[int]:
        """Stamps of every generation whose meta was committed, ascending."""
        return sorted(s for s in (_gen_stamp(p) for p in Path(path).glob("train_meta-*.json"))
                      if s is not None)

    @staticmethod
    def load(path) -> Optional[Dict[str, Any]]:
        """The newest intact generation, or None when ``path`` holds none.
        The pointer is tried first, then every generation newest first; a
        corrupt one is logged and skipped. Raises :class:`CheckpointCorrupt`
        only when every generation present is corrupt."""
        path = Path(path)
        candidates: List[Tuple[int, Path]] = sorted(
            ((s, p) for p in path.glob("train_meta-*.json")
             if (s := _gen_stamp(p)) is not None), reverse=True)
        pointer = path / "train_meta.json"
        if pointer.exists():
            candidates.insert(0, (-1, pointer))
        if not candidates:
            return None
        tried = set()
        last_err: Optional[CheckpointCorrupt] = None
        for _, meta_path in candidates:
            try:
                try:
                    meta = json.loads(meta_path.read_text(encoding="utf8"))
                except (OSError, ValueError) as e:
                    raise CheckpointCorrupt(f"unreadable checkpoint meta {meta_path}: {e}") from e
                if not isinstance(meta, dict) or meta.get("stamp") in tried:
                    continue
                tried.add(meta.get("stamp"))
                state = TrainCheckpoint._load_generation(path, meta)
            except CheckpointCorrupt as e:
                last_err = e
                logger.warning("checkpoint fallback: %s; trying the previous generation", e)
                continue
            return state
        raise CheckpointCorrupt(f"no intact checkpoint generation in {path} "
                                f"(last error: {last_err})")


class Checkpoints:
    """Read-only view of a :class:`TrainCheckpoint` directory for a reader
    running beside the trainer that writes it (the serving hot-swap), of
    generations written by either package. Array files land before their
    generation's meta, every rename is atomic and retention deletes the
    oldest generations after a new one is committed, so a meta's existence
    means its files are complete, and a file that went missing or whose
    SHA-256 differs from the meta's raises :class:`CheckpointCorrupt`
    (JAX ``training/checkpoint.py`` ``Checkpoints``). Parameters only: the
    optimizer state files differ by design between the packages, and a
    swap discards them."""

    def __init__(self, path) -> None:
        self.path = Path(path)

    def generations(self) -> List[int]:
        """Committed generation stamps, ascending (a directory scan)."""
        return TrainCheckpoint.generation_stamps(self.path)

    def _meta_for(self, stamp: int) -> Dict[str, Any]:
        meta_path = self.path / f"train_meta-{int(stamp)}.json"
        try:
            meta = json.loads(meta_path.read_text(encoding="utf8"))
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(f"unreadable checkpoint meta {meta_path}: {e}") from e
        if not isinstance(meta, dict) or meta.get("stamp") != int(stamp):
            raise CheckpointCorrupt(
                f"generation meta {meta_path.name} carries stamp "
                f"{meta.get('stamp') if isinstance(meta, dict) else None!r}")
        return meta

    def _verified_params_file(self, stamp: int) -> Tuple[Path, Dict[str, Any]]:
        meta = self._meta_for(stamp)
        f = self.path / f"params-{int(stamp)}.npz"
        if not f.exists():
            raise CheckpointCorrupt(f"checkpoint file missing: {f}")
        expect = (meta.get("digests") or {}).get(f.name)
        if expect is not None and _sha256_file(f) != expect:
            raise CheckpointCorrupt(f"checkpoint digest mismatch: {f} (torn or tampered write)")
        return f, meta

    def latest_intact_generation(self) -> Optional[int]:
        """The newest stamp whose parameters file digest-verifies, or None;
        a torn newest generation falls back to the next (JAX's
        ``latest_intact_generation(params_only=True)``)."""
        for stamp in sorted(self.generations(), reverse=True):
            try:
                self._verified_params_file(stamp)
            except CheckpointCorrupt:
                continue
            return stamp
        return None

    def load_generation_params(self, stamp: int) -> Dict[str, Any]:
        """One generation's parameters, digest-verified:
        ``{"params": {path: array}, "step": int}``. Raises
        :class:`CheckpointCorrupt` on a torn, missing or retired piece."""
        f, meta = self._verified_params_file(stamp)
        try:
            params = load_params(f)
        except Exception as e:  # a corrupt zip raises many types
            raise CheckpointCorrupt(f"corrupt checkpoint generation stamp {stamp} in "
                                    f"{self.path}: {type(e).__name__}: {e}") from e
        return {"params": params, "step": int(meta.get("step", stamp))}
