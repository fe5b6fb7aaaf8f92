"""The ``config.cfg`` format: INI-style sections whose dots nest
(``[components.tagger.model]``), JSON-ish values, and ``${dotted.path}``
interpolation resolved against the root.

A copy of the parts of ``spacy_ray_tpu/config.py`` that loading and saving a
pipeline and the ``train`` command need (dotted command-line overrides such
as ``--paths.train x.jsonl --training.max_steps 40``), so a config written by
either package reads the same in both.
"""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

_VAR_RE = re.compile(r"\$\{([^}]+)\}")


class ConfigValidationError(ValueError):
    pass


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if raw == "":
        return ""
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        pass
    lowered = raw.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("null", "none"):
        return None
    return raw  # bare word -> string


def _format_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None:
        return "null"
    if isinstance(value, (str, list, tuple, dict)):
        return json.dumps(list(value) if isinstance(value, tuple) else value)
    if isinstance(value, float):
        return repr(value)
    return str(value)


def _is_continuation(line: str) -> bool:
    """A line inside a multi-line JSON value, not a new key."""
    return line.strip().startswith(("]", "}", '"', "'", "[", "{", ","))


class Config(dict):
    """Nested-dict config with parse/serialize/interpolate support.

    ``origin_path`` is the file the config was loaded from (set by
    :meth:`from_disk`, carried through :meth:`apply_overrides` and
    :meth:`interpolate`): relative paths inside the config, such as
    ``[initialize.components.<name>] labels``, resolve against its directory.
    """

    origin_path: Optional[Path] = None

    @classmethod
    def from_str(cls, text: str) -> "Config":
        root: Dict[str, Any] = {}
        section: Optional[Dict[str, Any]] = None
        pending_key: Optional[str] = None
        pending_lines: List[str] = []

        def flush_pending():
            nonlocal pending_key, pending_lines
            if pending_key is not None and section is not None:
                section[pending_key] = _parse_value("\n".join(pending_lines))
            pending_key, pending_lines = None, []

        for raw_line in text.splitlines():
            line = raw_line.strip()
            if not line or line.startswith(("#", ";")):
                continue
            if line.startswith("[") and line.endswith("]"):
                flush_pending()
                section = cls._ensure_section(root, line[1:-1].strip().split("."))
                continue
            if "=" in line and not (pending_lines and _is_continuation(line)):
                flush_pending()
                key, _, raw_value = line.partition("=")
                if section is None:
                    section = root
                pending_key = key.strip()
                pending_lines = [raw_value.strip()]
            elif pending_key is not None:
                pending_lines.append(line)
            else:
                raise ConfigValidationError(f"Can't parse config line: {raw_line!r}")
        flush_pending()
        return cls(root)

    @staticmethod
    def _ensure_section(root: Dict[str, Any], parts: List[str]) -> Dict[str, Any]:
        node = root
        for part in parts:
            nxt = node.get(part)
            if nxt is None:
                nxt = node[part] = {}
            elif not isinstance(nxt, dict):
                raise ConfigValidationError(
                    f"Section path {'.'.join(parts)} collides with value key {part!r}"
                )
            node = nxt
        return node

    @classmethod
    def from_disk(cls, path: Union[str, Path]) -> "Config":
        config = cls.from_str(Path(path).read_text(encoding="utf8"))
        config.origin_path = Path(path)
        return config

    def to_str(self) -> str:
        lines: List[str] = []

        def emit(section: Dict[str, Any], path: Tuple[str, ...]):
            scalars = {
                k: v for k, v in section.items()
                if not isinstance(v, dict) or k.startswith("@")
            }
            subsections = {
                k: v for k, v in section.items()
                if isinstance(v, dict) and not k.startswith("@")
            }
            if path:
                lines.append(f"[{'.'.join(path)}]")
            for k, v in scalars.items():
                lines.append(f"{k} = {_format_value(v)}")
            if path or scalars:
                lines.append("")
            for k, v in subsections.items():
                emit(v, path + (k,))

        emit(self, ())
        return "\n".join(lines).strip() + "\n"

    def to_disk(self, path: Union[str, Path]) -> None:
        Path(path).write_text(self.to_str(), encoding="utf8")

    def apply_overrides(self, overrides: Dict[str, Any]) -> "Config":
        """A copy with each ``dotted.key = value`` set (sections created as
        needed)."""
        out = Config(copy.deepcopy(dict(self)))
        out.origin_path = self.origin_path
        for dotted, value in overrides.items():
            node: Dict[str, Any] = out
            parts = dotted.split(".")
            for part in parts[:-1]:
                if part not in node or not isinstance(node[part], dict):
                    node[part] = {}
                node = node[part]
            node[parts[-1]] = value
        return out

    def interpolate(self) -> "Config":
        """Resolve ``${dotted.path}`` references against the root."""
        resolved = copy.deepcopy(dict(self))

        def lookup(dotted: str) -> Any:
            node: Any = resolved
            for part in dotted.split("."):
                if not isinstance(node, dict) or part not in node:
                    raise ConfigValidationError(
                        f"Can't interpolate ${{{dotted}}}: not found"
                    )
                node = node[part]
            return node

        def interp(value: Any, depth: int = 0) -> Any:
            if depth > 16:
                raise ConfigValidationError("Interpolation too deep (cycle?)")
            if isinstance(value, str):
                full = _VAR_RE.fullmatch(value)
                if full:
                    return interp(lookup(full.group(1)), depth + 1)
                return _VAR_RE.sub(
                    lambda m: str(interp(lookup(m.group(1)), depth + 1)), value
                )
            if isinstance(value, dict):
                return {k: interp(v, depth) for k, v in value.items()}
            if isinstance(value, list):
                return [interp(v, depth) for v in value]
            return value

        out = Config(interp(resolved))
        out.origin_path = self.origin_path
        return out


def load_config(
    path: Union[str, Path],
    overrides: Optional[Dict[str, Any]] = None,
    *,
    interpolate: bool = False,
) -> Config:
    """Load a config file with optional dotted overrides."""
    config = Config.from_disk(path)
    if overrides:
        config = config.apply_overrides(overrides)
    if interpolate:
        config = config.interpolate()
    return config


def parse_cli_overrides(args: List[str]) -> Dict[str, Any]:
    """Parse ``--training.max_steps 100 --paths.train x.jsonl`` (or
    ``--key=value``) extras into ``{dotted.key: value}``."""
    overrides: Dict[str, Any] = {}
    i = 0
    while i < len(args):
        arg = args[i]
        if not arg.startswith("--"):
            raise ConfigValidationError(f"Expected --dotted.name, got {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, _, raw = key.partition("=")
            overrides[key] = _parse_value(raw)
            i += 1
        else:
            if i + 1 >= len(args):
                raise ConfigValidationError(f"Override {arg!r} missing a value")
            overrides[key] = _parse_value(args[i + 1])
            i += 2
    return overrides
