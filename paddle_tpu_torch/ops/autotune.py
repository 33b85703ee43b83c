"""Per-device verdict cache for the schedule searcher (counterpart of the
parts of paddle_tpu/ops/autotune.py that static/schedule_search.py uses).

Verdicts are kept per device kind (the CUDA device's name as a slug: a
config measured on one card must not silently apply to another) and per
(kernel, shape key).  They are read from and saved to
``FLAGS_autotune_cache_dir/<slug>.json`` when that flag is set, else
``~/.cache/paddle_tpu_torch/autotune/<slug>.json``.  Nothing is ever
written into the package directory, so a run leaves the checkout clean.

``validate_tile`` is the budget check of a candidate's working set: on
Hopper the shared memory one block may use (227 KB), where the JAX
package checked the TPU's VMEM.  The flash, norm and SwiGLU tuners of the
JAX module are not ported.
"""

from __future__ import annotations

import json
import os

import torch

from paddle_tpu_torch._core import flags as _flags

__all__ = ["AutotuneCache", "cache", "lookup", "record", "device_kind_slug",
           "validate_tile", "SMEM_BUDGET"]

SMEM_BUDGET = 232448  # bytes of shared memory one block may use on Hopper


def device_kind_slug(device=None) -> str:
    """``nvidia_h100_80gb_hbm3``-style slug of a CUDA device's name, or
    ``cpu``.  ``None`` is the current CUDA device when there is one."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return "".join(c if c.isalnum() else "_" for c in kind.lower()).strip("_")


def _key_str(key: dict) -> str:
    return "|".join(f"{k}={key[k]}" for k in sorted(key))


def cache_dir() -> str:
    d = str(_flags.flag("FLAGS_autotune_cache_dir") or "")
    return d or os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu_torch", "autotune")


class AutotuneCache:
    """Per-device-kind persistent (kernel, shape key) -> config cache."""

    def __init__(self, slug=None, directory=None):
        self.slug = slug or device_kind_slug()
        self.path = os.path.join(directory or cache_dir(), f"{self.slug}.json")
        self._data: dict = {}
        self._dirty = False
        try:
            with open(self.path) as f:
                self._data = json.load(f)
        except (OSError, ValueError):
            pass

    def get(self, kernel: str, key: dict):
        entry = self._data.get(kernel, {}).get(_key_str(key))
        return dict(entry["config"]) if entry else None

    def put(self, kernel: str, key: dict, config: dict, ms: float, meta=None):
        entry = {"config": dict(config), "ms": round(float(ms), 6),
                 **({"meta": meta} if meta else {})}
        self._data.setdefault(kernel, {})[_key_str(key)] = entry
        self._dirty = True

    def entries(self, kernel: str) -> dict:
        """Every recorded (shape key -> {config, ms, meta}) of ``kernel``."""
        return {k: dict(v) for k, v in self._data.get(kernel, {}).items()}

    def save(self):
        """Write the cache file if anything changed; returns its path."""
        if not self._dirty:
            return None
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)
        self._dirty = False
        return self.path


_CACHES: dict = {}


def cache(slug=None) -> AutotuneCache:
    """The process's cache object for ``slug`` in the configured directory
    (changing FLAGS_autotune_cache_dir takes effect at the next call)."""
    slug = slug or device_kind_slug()
    key = (slug, cache_dir())
    if key not in _CACHES:
        _CACHES[key] = AutotuneCache(slug, key[1])
    return _CACHES[key]


def lookup(kernel: str, key: dict, slug=None):
    """The cached config, or None when the geometry was never searched on
    this device kind (or the cache is off)."""
    if not _flags.flag("FLAGS_use_autotune_cache"):
        return None
    return cache(slug).get(kernel, key)


def record(kernel, key, config, ms, slug=None, save=True, meta=None):
    c = cache(slug)
    c.put(kernel, key, config, ms, meta=meta)
    if save:
        c.save()
    return c


def validate_tile(smem_bytes, budget=None):
    """None when a block's shared-memory working set fits the budget, else
    a human-readable reason."""
    b = SMEM_BUDGET if budget is None else int(budget)
    if int(smem_bytes) > b:
        return f"working set {int(smem_bytes)} bytes of shared memory > {b} budget"
    return None
