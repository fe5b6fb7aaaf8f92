"""The model registry and request resolution of multi-model serving
(``spacy_ray_tpu/serving/multimodel/registry.py``).

One JSON manifest declares the models (name -> pipeline directory), the SLO
classes (a fair-queuing weight and a p99 target each) and the tenants (a
class and an optional token-bucket quota in docs per second).

Which model a request is for:

* the path ``/v1/models/<name>/parse`` names it and wins over the header;
* else the ``X-SRT-Model`` header on ``/v1/parse``;
* else the manifest's ``default_model``, so a client that never heard of
  models sees no difference;
* an unknown or malformed name is a typed 404 (``UnknownModel``), never the
  default model under another name.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..batcher import UnknownModel

MODEL_HEADER = "X-SRT-Model"
TENANT_HEADER = "X-SRT-Tenant"

#: /v1/models/<name>/parse, the name restricted to token characters
MODEL_PATH_RE = re.compile(r"\A/v1/models/([A-Za-z0-9._-]{1,64})/parse\Z")

_NAME_RE = re.compile(r"\A[A-Za-z0-9._-]{1,64}\Z")

DEFAULT_CLASS = "default"


@dataclass(frozen=True)
class ClassSpec:
    """One SLO class: its fair-queuing ``weight`` and window-p99 target."""

    name: str
    weight: float = 1.0
    p99_target_ms: Optional[float] = None


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: its class and an optional quota in docs per second
    (None: unlimited) with its burst."""

    name: str
    klass: str = DEFAULT_CLASS
    quota_docs_per_s: Optional[float] = None
    quota_burst: Optional[float] = None


@dataclass(frozen=True)
class ModelSpec:
    """One servable pipeline directory."""

    name: str
    path: str


class ModelRegistry:
    """The manifest, parsed and validated once (no I/O past the manifest
    file, no telemetry)."""

    def __init__(self, models: Dict[str, ModelSpec], default_model: str,
                 classes: Optional[Dict[str, ClassSpec]] = None,
                 tenants: Optional[Dict[str, TenantSpec]] = None) -> None:
        if not models:
            raise ValueError("manifest declares no models")
        for name in models:
            if not _NAME_RE.match(name):
                raise ValueError(f"invalid model name {name!r}")
        if default_model not in models:
            raise ValueError(
                f"default_model {default_model!r} is not in the manifest's "
                f"models ({sorted(models)})"
            )
        self.models: Dict[str, ModelSpec] = dict(models)
        self.default_model = default_model
        self.classes: Dict[str, ClassSpec] = dict(classes or {})
        # the anonymous tenant and any tenant without a class ride in it
        self.classes.setdefault(DEFAULT_CLASS, ClassSpec(DEFAULT_CLASS))
        for cname, spec in self.classes.items():
            if not (spec.weight > 0):
                raise ValueError(f"class {cname!r} weight must be > 0, got {spec.weight!r}")
        self.tenants: Dict[str, TenantSpec] = dict(tenants or {})
        for tname, tspec in self.tenants.items():
            if tspec.klass not in self.classes:
                raise ValueError(f"tenant {tname!r} names unknown class {tspec.klass!r}")
            if tspec.quota_docs_per_s is not None and not (tspec.quota_docs_per_s > 0):
                raise ValueError(f"tenant {tname!r} quota_docs_per_s must be > 0")

    @classmethod
    def from_manifest(cls, path) -> "ModelRegistry":
        """Parse a JSON manifest::

            {"default_model": "tagger",
             "models": {"tagger": {"path": "models/tagger"}, "ner": {"path": "models/ner"}},
             "classes": {"gold": {"weight": 4, "p99_target_ms": 500},
                         "batch": {"weight": 1, "p99_target_ms": 5000}},
             "tenants": {"acme": {"class": "gold", "quota_docs_per_s": 200,
                                  "quota_burst": 400}}}

        A relative model path resolves against the manifest's directory."""
        p = Path(path)
        raw = json.loads(p.read_text(encoding="utf-8"))
        if not isinstance(raw, dict):
            raise ValueError(f"manifest {path} is not a JSON object")
        models_raw = raw.get("models")
        if not isinstance(models_raw, dict) or not models_raw:
            raise ValueError(f"manifest {path} has no 'models' table")
        models: Dict[str, ModelSpec] = {}
        for name, m in models_raw.items():
            if not isinstance(m, dict) or "path" not in m:
                raise ValueError(f"manifest model {name!r} needs a 'path' entry")
            mpath = Path(str(m["path"]))
            if not mpath.is_absolute():
                mpath = p.parent / mpath
            models[str(name)] = ModelSpec(name=str(name), path=str(mpath))
        default_model = str(raw.get("default_model") or "")
        if not default_model:
            if len(models) == 1:
                default_model = next(iter(models))
            else:
                raise ValueError(
                    f"manifest {path} needs 'default_model' when it "
                    "declares more than one model"
                )
        classes: Dict[str, ClassSpec] = {}
        for cname, c in (raw.get("classes") or {}).items():
            if not isinstance(c, dict):
                raise ValueError(f"manifest class {cname!r} must be an object")
            classes[str(cname)] = ClassSpec(
                name=str(cname), weight=float(c.get("weight", 1.0)),
                p99_target_ms=(float(c["p99_target_ms"])
                               if c.get("p99_target_ms") is not None else None),
            )
        tenants: Dict[str, TenantSpec] = {}
        for tname, t in (raw.get("tenants") or {}).items():
            if not isinstance(t, dict):
                raise ValueError(f"manifest tenant {tname!r} must be an object")
            tenants[str(tname)] = TenantSpec(
                name=str(tname), klass=str(t.get("class", DEFAULT_CLASS)),
                quota_docs_per_s=(float(t["quota_docs_per_s"])
                                  if t.get("quota_docs_per_s") is not None else None),
                quota_burst=(float(t["quota_burst"])
                             if t.get("quota_burst") is not None else None),
            )
        return cls(models, default_model, classes=classes, tenants=tenants)

    # -- lookups ---------------------------------------------------------
    def names(self) -> List[str]:
        return sorted(self.models)

    def spec(self, name: str) -> ModelSpec:
        try:
            return self.models[name]
        except KeyError:
            raise UnknownModel(
                f"model {name!r} is not in the registry (known: {self.names()})"
            ) from None

    def class_weights(self) -> Dict[str, float]:
        """``{class: weight}`` for the batcher's weighted fair queue."""
        return {c.name: c.weight for c in self.classes.values()}

    def tenant(self, name: Optional[str]) -> TenantSpec:
        """A tenant header's spec; an unknown or absent tenant is the
        anonymous one (default class, no quota)."""
        if name is not None and name in self.tenants:
            return self.tenants[name]
        return TenantSpec(name=name or "anonymous")

    def p99_target_ms(self, klass: str) -> Optional[float]:
        spec = self.classes.get(klass)
        return spec.p99_target_ms if spec is not None else None

    def resolve_model(self, path: str, headers: Optional[Mapping[str, str]] = None
                      ) -> Tuple[str, bool]:
        """``(name, explicit)`` of the model a request names (module
        docstring); ``explicit`` is False for the default. Raises
        ``UnknownModel`` for an unknown name and for any path that is
        neither ``/v1/parse`` nor a well-formed ``/v1/models/<name>/parse``."""
        m = MODEL_PATH_RE.match(path)
        if m:
            name = m.group(1)
            self.spec(name)
            return name, True
        if path.startswith("/v1/models/"):
            raise UnknownModel(
                f"malformed model path {path!r} (expected /v1/models/<name>/parse)"
            )
        header = headers.get(MODEL_HEADER) if headers is not None else None
        if header:
            self.spec(header)
            return header, True
        return self.default_model, False

    def describe(self) -> Dict[str, Any]:
        """JSON-safe summary."""
        return {
            "default_model": self.default_model,
            "models": self.names(),
            "classes": {c.name: {"weight": c.weight, "p99_target_ms": c.p99_target_ms}
                        for c in self.classes.values()},
            "tenants": sorted(self.tenants),
        }
