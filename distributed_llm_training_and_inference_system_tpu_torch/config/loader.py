"""Layered config loading: defaults < file < environment < CLI overrides.

Counterpart of the JAX package's ``config/loader.py``. Environment
overrides use ``LLMCTL_<SECTION>__<FIELD>=value``, e.g.
``LLMCTL_TRAINING__MAX_STEPS=50``.
"""

from __future__ import annotations

import json
import os
import tomllib
from pathlib import Path
from typing import Any, Mapping

from .schema import RunConfig

ENV_PREFIX = "LLMCTL_"


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


def _coerce(text: str) -> Any:
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


def env_overrides(environ: Mapping[str, str] | None = None) -> dict[str, Any]:
    """Collect LLMCTL_SECTION__FIELD=value overrides into a nested dict."""
    environ = os.environ if environ is None else environ
    out: dict[str, Any] = {}
    for key, val in environ.items():
        if not key.startswith(ENV_PREFIX) or "__" not in key:
            continue
        section, field_ = key[len(ENV_PREFIX):].lower().split("__", 1)
        out.setdefault(section, {})[field_] = _coerce(val)
    return out


def deep_merge(base: dict, override: Mapping) -> dict:
    """Recursive dict merge; override wins; returns a new dict."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        elif v is not None:
            out[k] = v
    return out


def load_run_config(
    config_file: str | Path | None = None,
    cli_overrides: Mapping[str, Any] | None = None,
    environ: Mapping[str, str] | None = None,
) -> RunConfig:
    """Build a validated RunConfig from file < env < CLI layers."""
    raw: dict[str, Any] = {}
    base_dir = None
    if config_file is not None:
        raw = load_config_file(config_file)
        base_dir = Path(config_file).parent
    raw = deep_merge(raw, env_overrides(environ))
    if cli_overrides:
        raw = deep_merge(raw, cli_overrides)
    return RunConfig.from_dict(raw, base_dir=base_dir)
