"""Global flag registry (a copy of paddle_tpu/_core/flags.py's mechanism).

Only the flags this package reads are defined here.  Values come from the
defaults below, from ``FLAGS_*`` environment variables, or from
``set_flags``.
"""

from __future__ import annotations

import os
from typing import Any

__all__ = ["define_flag", "get_flags", "set_flags", "flag"]

_FLAGS: dict[str, dict[str, Any]] = {}


def _coerce(value, default):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


def _key(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def define_flag(name: str, default, help_str: str = ""):
    name = _key(name)
    env = os.environ.get(name)
    value = _coerce(env, default) if env is not None else default
    _FLAGS[name] = {"value": value, "default": default, "help": help_str}
    return value


def flag(name: str):
    return _FLAGS[_key(name)]["value"]


def get_flags(flags=None) -> dict:
    if flags is None:
        return {k: v["value"] for k, v in _FLAGS.items()}
    if isinstance(flags, str):
        flags = [flags]
    return {name: _FLAGS[_key(name)]["value"] for name in flags}


def set_flags(flags: dict):
    for name, value in flags.items():
        key = _key(name)
        if key not in _FLAGS:
            raise KeyError(f"unknown flag {key!r}")
        _FLAGS[key]["value"] = _coerce(value, _FLAGS[key]["default"])


define_flag(
    "FLAGS_decode_chunk",
    8,
    "Macro-step decode width D: GenerationEngine.step() advances D tokens "
    "per call; 1 = per-token steps",
)
define_flag(
    "FLAGS_prefill_chunk_blocks",
    0,
    "Interleaved chunked prefill budget in pool blocks; only 0 (atomic "
    "prefill at admission) is ported",
)
define_flag(
    "FLAGS_prefix_cache",
    False,
    "Radix/prefix KV reuse in GenerationEngine; not ported (must stay False)",
)
define_flag(
    "FLAGS_kv_cache_dtype",
    "bf16",
    "Paged-KV pool storage dtype: 'bf16' keeps pools in the model's dtype; "
    "'int8' is not ported",
)
