"""Function registry behind the ``@architectures = "..."`` and
``factory = "..."`` references in ``config.cfg``.

The port's own registry object, with the same resolution rules as the JAX
package's (``spacy_ray_tpu/registry.py``): a config block holding an
``@<namespace>`` key is replaced by the registered function called with the
block's other keys, nested blocks first. Both packages register the same
``spacy.*`` names, so they must not share one table. :func:`import_code`
runs a user's Python file (the CLI's ``--code``) so that its registrations
exist before a config resolves.
"""

from __future__ import annotations

import importlib.util
import inspect
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional


class RegistryError(ValueError):
    pass


class _SubRegistry:
    """One named function table, e.g. ``registry.architectures``."""

    def __init__(self, namespace: str):
        self.namespace = namespace
        self._table: Dict[str, Callable] = {}

    def __call__(self, name: str):
        """Decorator: ``@registry.architectures("Foo.v1")``."""

        def decorator(f: Callable) -> Callable:
            self._table[name] = f
            return f

        return decorator

    def get(self, name: str) -> Callable:
        if name not in self._table:
            available = ", ".join(sorted(self._table)) or "<empty>"
            raise RegistryError(
                f"Can't find '{name}' in registry {self.namespace}. "
                f"Available: {available}"
            )
        return self._table[name]


class Registry:
    """Top-level registry of registries: model architectures, pipeline
    component factories, the training blocks (optimizers, schedules,
    batchers, corpus readers and their augmenters, loggers, the
    ``[training.before_update]`` callbacks) and ``misc`` (span suggesters)."""

    NAMESPACES = ("architectures", "factories", "optimizers", "schedules", "batchers",
                  "readers", "augmenters", "loggers", "callbacks", "misc")

    def __init__(self):
        for ns in self.NAMESPACES:
            setattr(self, ns, _SubRegistry(ns))

    def get(self, namespace: str, name: str) -> Callable:
        return self._ns(namespace).get(name)

    def _ns(self, namespace: str) -> _SubRegistry:
        sub = getattr(self, namespace, None)
        if not isinstance(sub, _SubRegistry):
            raise RegistryError(
                f"Unknown registry namespace '{namespace}'. "
                f"Available: {', '.join(self.NAMESPACES)}"
            )
        return sub

    def resolve(self, block: Any) -> Any:
        """Recursively resolve a config mapping, nested blocks first."""
        if isinstance(block, dict):
            ref_keys = [k for k in block if isinstance(k, str) and k.startswith("@")]
            resolved = {
                k: self.resolve(v)
                for k, v in block.items()
                if not (isinstance(k, str) and k.startswith("@"))
            }
            if not ref_keys:
                return resolved
            if len(ref_keys) > 1:
                raise RegistryError(
                    f"Config block has multiple registry references: {ref_keys}"
                )
            namespace = ref_keys[0][1:]
            name = block[ref_keys[0]]
            func = self.get(namespace, name)
            _validate_args(func, resolved, namespace, name)
            return func(**resolved)
        if isinstance(block, list):
            return [self.resolve(v) for v in block]
        return block


def _validate_args(
    func: Callable, kwargs: Dict[str, Any], namespace: str, name: str
) -> None:
    sig = inspect.signature(func)
    params = sig.parameters.values()
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
        unknown = set(kwargs) - set(sig.parameters)
        if unknown:
            raise RegistryError(
                f"Invalid argument(s) {sorted(unknown)} for "
                f'@{namespace} = "{name}" (accepts: {sorted(sig.parameters)})'
            )
    missing = [
        p.name
        for p in params
        if p.default is inspect.Parameter.empty
        and p.kind
        in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
        and p.name not in kwargs
    ]
    if missing:
        raise RegistryError(
            f'Missing required argument(s) {missing} for @{namespace} = "{name}"'
        )


registry = Registry()


def import_code(code_path: Optional[str]) -> None:
    """Import a user's Python file so that its registry decorators run,
    under the module name ``_user_code_<stem>``; None does nothing."""
    if code_path is None:
        return
    path = Path(code_path)
    if not path.exists():
        raise FileNotFoundError(f"--code path not found: {code_path}")
    module_name = f"_user_code_{path.stem}"
    spec = importlib.util.spec_from_file_location(module_name, str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"--code path is not a Python file: {code_path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
