"""Pretrained trunk weights from a local file (counterpart of
``spacy_ray_tpu/models/pretrained.py``): the ``init_weights`` of
``spacy_ray_tpu.TransformerEncoder.v1`` and the path of
``spacy-transformers.TransformerModel.v3``. Nothing is downloaded.

* ``.npz``, the native schema: keys are '/'-joined parameter paths of the
  trunk, as ``save_trunk_params`` writes them and the JAX package's trunk
  names them (``layer_{i}`` per layer, unstacked)::

      pos                     [max_len, width]   positional embeddings
      ln_f_g, ln_f_b          [width]            final layer norm
      layer_{i}/qkv_W         [width, 3*width]   fused q, k, v projection
      layer_{i}/qkv_b         [3*width]
      layer_{i}/o_W, o_b      [width, width], [width]
      layer_{i}/ln1_g|ln1_b   [width]            pre-attention layer norm
      layer_{i}/ffn_W1, ffn_b1, ffn_W2, ffn_b2
      layer_{i}/ln2_g|ln2_b   [width]            pre-FFN layer norm
      embed/...               hash-embed tables (optional)

* ``.safetensors``, read and written here (an 8-byte little-endian header
  length, a JSON header, the raw buffer; no package needed). A Hugging Face
  BERT/RoBERTa encoder's keys (``encoder.layer.N.attention...``) are
  remapped to the native schema: q, k and v fuse into ``qkv_W`` (each
  transposed, as torch's ``Linear`` stores ``[out, in]``), the FFN and the
  layer norms map by position, RoBERTa's two padding rows of the position
  table are skipped, and the embedding block is dropped (the trunk embeds
  by hashing). The trunk is pre-LN where BERT is post-LN: a remapped
  encoder is a warm start, not the same function.

Every merged tensor is shape-checked: a mismatch raises, but for ``pos``,
whose leading (length) dimension may differ (the shorter length is copied,
a longer trunk keeps its random tail). Keys absent from the file keep the
trunk's seeded initialisation.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..training.checkpoint import flatten, save_params
from .core import param_paths

_SAFETENSORS_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """{name: array} of a safetensors file; F64, F16 and BF16 come back as
    float32 (the trunk's parameters are f32)."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (header_len,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8: 8 + header_len].decode("utf8"))
    buf = raw[8 + header_len:]
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype_name = meta["dtype"]
        start, end = meta["data_offsets"]
        if dtype_name == "BF16":  # the high half of a float32
            bits = np.frombuffer(buf[start:end], dtype="<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(meta["shape"])
            continue
        dtype = _SAFETENSORS_DTYPES.get(dtype_name)
        if dtype is None:
            raise ValueError(f"{path}: unsupported dtype {dtype_name} for {name}")
        arr = np.frombuffer(buf[start:end], dtype=dtype).reshape(meta["shape"])
        if dtype_name in ("F64", "F16"):
            arr = arr.astype(np.float32)
        out[name] = arr
    return out


def write_safetensors(path, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: array} (float32, float64, float16, ints, bool) as
    safetensors, names in sorted order: the reader's inverse."""
    inv = {np.dtype(v): k for k, v in _SAFETENSORS_DTYPES.items()}
    header: Dict[str, Any] = {}
    offset = 0
    blobs: List[bytes] = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        dtype_name = inv.get(arr.dtype)
        if dtype_name is None:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        blob = arr.tobytes()
        header[name] = {"dtype": dtype_name, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    hj = json.dumps(header).encode("utf8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for blob in blobs:
            f.write(blob)


def load_flat(path) -> Dict[str, np.ndarray]:
    """A checkpoint file as a flat {key: array} dict; a directory (Hugging
    Face's save layout) resolves to its ``model.safetensors``."""
    path = Path(path)
    if path.is_dir():
        inner = path / "model.safetensors"
        if not inner.exists():
            raise ValueError(
                f"{path} is a directory without model.safetensors; point at "
                "the checkpoint file itself (.npz or .safetensors)"
            )
        path = inner
    if path.suffix == ".npz":
        with np.load(str(path)) as data:
            return {k: data[k] for k in data.files}
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    raise ValueError(
        f"Unsupported checkpoint format {path.suffix!r} (want .npz or .safetensors)"
    )


def save_trunk_params(path, trunk) -> None:
    """Write a trunk's parameters (a model, or a nested or flat tree) in
    the native .npz schema."""
    save_params(path, param_paths(trunk) if isinstance(trunk, nn.Module) else trunk)


def looks_like_hf_encoder(flat: Dict[str, np.ndarray]) -> bool:
    return any(".attention.self.query.weight" in k for k in flat)


def hf_encoder_to_native(flat: Dict[str, np.ndarray],
                         native_pos_rows: "int | None" = None) -> Dict[str, np.ndarray]:
    """Hugging Face BERT/RoBERTa encoder keys -> the native schema.

    The position table keeps all its rows for BERT and drops RoBERTa's two
    leading padding rows: a table exactly two rows longer than
    ``native_pos_rows`` is RoBERTa's, one of that length BERT's, and
    otherwise a ``roberta`` key prefix decides."""

    def find(suffix: str):
        for k, v in flat.items():
            if k.endswith(suffix):
                return v
        return None

    out: Dict[str, np.ndarray] = {}
    is_roberta = any("roberta" in k.lower() for k in flat)
    i = 0
    while True:
        pre = None
        for cand in (f"encoder.layer.{i}.", f"roberta.encoder.layer.{i}."):
            if any(k.startswith(cand) for k in flat):
                pre = cand
                break
        if pre is None:
            break
        q_w = flat[pre + "attention.self.query.weight"].T
        k_w = flat[pre + "attention.self.key.weight"].T
        v_w = flat[pre + "attention.self.value.weight"].T
        out[f"layer_{i}/qkv_W"] = np.concatenate([q_w, k_w, v_w], axis=1)
        out[f"layer_{i}/qkv_b"] = np.concatenate([
            flat[pre + "attention.self.query.bias"],
            flat[pre + "attention.self.key.bias"],
            flat[pre + "attention.self.value.bias"],
        ])
        out[f"layer_{i}/o_W"] = flat[pre + "attention.output.dense.weight"].T
        out[f"layer_{i}/o_b"] = flat[pre + "attention.output.dense.bias"]
        out[f"layer_{i}/ln1_g"] = flat[pre + "attention.output.LayerNorm.weight"]
        out[f"layer_{i}/ln1_b"] = flat[pre + "attention.output.LayerNorm.bias"]
        out[f"layer_{i}/ffn_W1"] = flat[pre + "intermediate.dense.weight"].T
        out[f"layer_{i}/ffn_b1"] = flat[pre + "intermediate.dense.bias"]
        out[f"layer_{i}/ffn_W2"] = flat[pre + "output.dense.weight"].T
        out[f"layer_{i}/ffn_b2"] = flat[pre + "output.dense.bias"]
        out[f"layer_{i}/ln2_g"] = flat[pre + "output.LayerNorm.weight"]
        out[f"layer_{i}/ln2_b"] = flat[pre + "output.LayerNorm.bias"]
        i += 1
    if i == 0:
        raise ValueError("no encoder.layer.N.* keys found in HF checkpoint")
    pos = find("position_embeddings.weight")
    if pos is not None:
        if native_pos_rows is not None and pos.shape[0] == native_pos_rows + 2:
            pos = pos[2:]
        elif native_pos_rows is not None and pos.shape[0] == native_pos_rows:
            pass
        elif is_roberta and pos.shape[0] > 2:
            pos = pos[2:]
        out["pos"] = pos
    return out


def merge_pretrained(params: Dict[str, Any], flat_loaded: Dict[str, np.ndarray]
                     ) -> Tuple[Dict[str, np.ndarray], Dict[str, List[str]]]:
    """Merge loaded tensors into a trunk's parameters (a nested or flat tree
    of tensors or arrays). Returns the merged flat {path: float32 array} and
    a report: ``loaded``, ``missing`` (a parameter the file lacks: it keeps
    its value) and ``unused`` (a tensor of the file no parameter takes).
    A shape mismatch raises, naming the key and both shapes, but for
    ``pos``'s length."""
    flat_params = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v)) for k, v in flatten(params).items()}
    loaded: List[str] = []
    unused = [k for k in flat_loaded if k not in flat_params]
    missing = [k for k in flat_params if k not in flat_loaded]
    merged: Dict[str, np.ndarray] = {}
    for key, cur in flat_params.items():
        if key not in flat_loaded:
            merged[key] = cur
            continue
        new = np.asarray(flat_loaded[key], dtype=np.float32)
        if tuple(new.shape) != tuple(cur.shape):
            if key == "pos" and new.shape[1:] == cur.shape[1:]:
                n = min(new.shape[0], cur.shape[0])
                out = np.array(cur, dtype=np.float32)
                out[:n] = new[:n]
                merged[key] = out
                loaded.append(key)
                continue
            raise ValueError(
                f"pretrained tensor {key!r} has shape {tuple(new.shape)}, "
                f"param expects {tuple(cur.shape)}"
            )
        merged[key] = new
        loaded.append(key)
    return merged, {"loaded": loaded, "missing": missing, "unused": unused}


def load_trunk_weights(trunk: nn.Module, path) -> Dict[str, List[str]]:
    """Load a checkpoint into ``trunk``'s parameters in place: read, remap a
    Hugging Face encoder, merge shape-checked, copy; print the one-line
    report and return it. A file none of whose tensors matched raises."""
    flat = load_flat(path)
    have = param_paths(trunk)
    if looks_like_hf_encoder(flat):
        pos = have.get("pos")
        flat = hf_encoder_to_native(
            flat, native_pos_rows=None if pos is None else int(pos.shape[0]))
    merged, report = merge_pretrained(have, flat)
    if not report["loaded"]:
        sample = ", ".join(sorted(flat)[:5])
        raise ValueError(
            f"no tensors in {path} matched the trunk schema — the file's "
            f"keys (e.g. {sample}) are neither the native layout "
            "(models/pretrained.py docstring) nor a recognizable "
            "BERT/RoBERTa encoder; refusing to train from scratch when "
            "pretrained weights were requested"
        )
    with torch.no_grad():
        for key in report["loaded"]:
            have[key].copy_(torch.tensor(merged[key]))
    print(
        f"[transformer] loaded {len(report['loaded'])} tensors from {path} "
        f"({len(report['missing'])} left at init, "
        f"{len(report['unused'])} unused in file)",
        flush=True,
    )
    return report
