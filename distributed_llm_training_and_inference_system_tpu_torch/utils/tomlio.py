"""TOML/JSON configuration IO (the JAX package's ``utils/tomlio.py``).

Reads use the standard library's ``tomllib``; the standard library has no
TOML writer, so ``dump_toml`` emits the text itself, character for
character as the JAX package's does (``init scaffold`` and ``hw probe
--emit`` write through it).
"""

from __future__ import annotations

import json
import tomllib
from datetime import date, datetime
from pathlib import Path
from typing import Any


def load_config_file(path: str | Path) -> dict[str, Any]:
    """Load a .toml or .json config file by suffix."""
    path = Path(path)
    if path.suffix == ".toml":
        with open(path, "rb") as f:
            return tomllib.load(f)
    if path.suffix == ".json":
        with open(path) as f:
            return json.load(f)
    raise ValueError(f"Unsupported config format: {path.suffix} ({path})")


def loads_toml(text: str) -> dict[str, Any]:
    return tomllib.loads(text)


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)  # JSON string escaping is valid TOML
    if isinstance(v, (datetime, date)):
        return v.isoformat()
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    if isinstance(v, dict):
        inner = ", ".join(f"{_key(k)} = {_fmt_value(x)}" for k, x in v.items())
        return "{ " + inner + " }"
    raise TypeError(f"Cannot serialise {type(v)} to TOML")


def _key(k: str) -> str:
    if k and all(c.isalnum() or c in "-_" for c in k):
        return k
    return json.dumps(k)


def _is_table(v: Any) -> bool:
    return isinstance(v, dict)


def _is_table_array(v: Any) -> bool:
    return isinstance(v, list) and len(v) > 0 and all(isinstance(x, dict) for x in v)


def dump_toml(data: dict[str, Any], path: str | Path | None = None) -> str:
    """Serialise a nested dict to TOML text; optionally write it to *path*."""
    lines: list[str] = []

    def emit_table(table: dict[str, Any], prefix: str) -> None:
        scalars = {k: v for k, v in table.items() if not _is_table(v) and not _is_table_array(v)}
        subtables = {k: v for k, v in table.items() if _is_table(v)}
        table_arrays = {k: v for k, v in table.items() if _is_table_array(v)}
        for k, v in scalars.items():
            lines.append(f"{_key(k)} = {_fmt_value(v)}")
        for k, v in subtables.items():
            name = f"{prefix}.{_key(k)}" if prefix else _key(k)
            lines.append("")
            lines.append(f"[{name}]")
            emit_table(v, name)
        for k, arr in table_arrays.items():
            name = f"{prefix}.{_key(k)}" if prefix else _key(k)
            for item in arr:
                lines.append("")
                lines.append(f"[[{name}]]")
                emit_table(item, name)

    emit_table(data, "")
    text = "\n".join(lines).lstrip("\n") + "\n"
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(text)
    return text
