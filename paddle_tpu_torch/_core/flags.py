"""Global flag registry (a copy of paddle_tpu/_core/flags.py's mechanism).

Only the flags this package reads are defined here.  Values come from the
defaults below, from ``FLAGS_*`` environment variables, or from
``set_flags``.  Callbacks registered with ``on_change`` run after every
``set_flags`` that changed a value (the serving engine re-resolves its
schedule-search verdicts there).
"""

from __future__ import annotations

import os
from typing import Any

__all__ = ["define_flag", "get_flags", "set_flags", "flag", "on_change"]

_FLAGS: dict[str, dict[str, Any]] = {}
_listeners: list = []


def on_change(callback):
    """Register ``callback(changed_names)`` to run after each set_flags()."""
    _listeners.append(callback)
    return callback


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
    changed = []
    for name, value in flags.items():
        key = _key(name)
        if key not in _FLAGS:
            raise KeyError(f"unknown flag {key!r}")
        new = _coerce(value, _FLAGS[key]["default"])
        if new != _FLAGS[key]["value"]:
            _FLAGS[key]["value"] = new
            changed.append(key)
    if changed:
        for cb in list(_listeners):
            cb(changed)


define_flag(
    "FLAGS_decode_chunk",
    8,
    "Macro-step decode width D: GenerationEngine.step() advances D tokens "
    "per call; 1 = per-token steps",
)
define_flag(
    "FLAGS_prefill_chunk_blocks",
    0,
    "Per-macro-step prefill budget for interleaved chunked prefill, in pool "
    "blocks: each GenerationEngine.step() runs at most this many block-sized "
    "prefill chunks before the decode step (deadline pressure may double it). "
    "0 = atomic prefill at admission",
)
define_flag(
    "FLAGS_preempt_low_priority",
    True,
    "Allow the serving admission scheduler to preempt LOW-priority requests "
    "when a higher-priority request cannot be admitted: their pool pages are "
    "parked on the host and the stream resumes bit-identically on "
    "re-admission (serving.GenerationEngine)",
)
define_flag(
    "FLAGS_prefix_cache",
    False,
    "Radix/prefix KV reuse in GenerationEngine: admission references the "
    "longest cached prompt prefix's pool pages (page granularity) and "
    "prefills only the suffix",
)
define_flag(
    "FLAGS_kv_cache_dtype",
    "bf16",
    "Paged-KV pool storage dtype for serving.GenerationEngine: 'bf16' "
    "(default) keeps full-precision pools in the model's serving dtype; "
    "'int8' stores quantized values with per-block-per-head scales carried "
    "alongside the pool and dequantized as the decode step reads them "
    "(ops/paged_attention.QuantPool)",
)
define_flag(
    "FLAGS_schedule_search",
    False,
    "Cost-model-driven schedule search (static/schedule_search.py): "
    "enumerate candidate kernel configs, prune by roofline and the shared-"
    "memory budget, measure the survivors, and adopt only configs that beat "
    "the plain twin by the measured-win margin; losing geometries persist "
    "as disabled in the per-device autotune cache",
)
define_flag(
    "FLAGS_schedule_search_budget",
    6,
    "Max schedule candidates measured on device per searched geometry (the "
    "top-K survivors of the roofline and shared-memory prunes)",
)
define_flag(
    "FLAGS_schedule_search_min_win",
    1.05,
    "Measured-win gate margin: a searched kernel config must beat the plain "
    "twin by at least this ratio or the geometry is recorded as disabled "
    "for this device kind and never re-measured",
)
define_flag(
    "FLAGS_schedule_search_decode",
    True,
    "With FLAGS_schedule_search on, also point the searcher at the serving "
    "engine's decode hot chain (paged write -> gather -> dequant -> "
    "attention; ops/decode_chain.py) and its chunked-prefill attention core",
)
define_flag(
    "FLAGS_use_autotune_cache",
    True,
    "Consult and persist schedule-search verdicts in the per-device "
    "autotune cache (ops/autotune.py)",
)
define_flag(
    "FLAGS_autotune_cache_dir",
    "",
    "Where the autotune cache is read and saved (empty = "
    "~/.cache/paddle_tpu_torch/autotune; never the package directory)",
)
define_flag(
    "FLAGS_use_pallas_fusion",
    True,
    "Substitute attention/rms-norm/swiglu/matmul-epilogue/add-norm subgraphs "
    "in captured Programs with the port's hand-written kernels before they "
    "run (static.rewrite.PallasFusionPass; the name is the JAX package's)",
)
define_flag(
    "FLAGS_verify_programs",
    False,
    "Verify-mode for the static IR (static/verify.py in the JAX package); "
    "not ported: the port's Executor raises while it is on (ROADMAP.md "
    "A.5.1)",
)
define_flag(
    "FLAGS_lora_max_adapters",
    8,
    "Usable adapter slots in a serving AdapterPack (nn/lora.py): a "
    "GenerationEngine built with adapters= allocates this many "
    "hot-swappable LoRA slots plus the reserved slot 0 (the zero adapter, "
    "the base model).  The geometry is fixed at construction: "
    "register_adapter/evict_adapter write slot contents in place, so the "
    "captured decode steps are never recorded again on a swap",
)
define_flag(
    "FLAGS_engine_snapshot_dir",
    "",
    "Serving fault tolerance (serving/snapshot.py): directory for live "
    "GenerationEngine snapshots.  When set, engine.step() calls "
    "maybe_snapshot() at every macro-step boundary: a pending SIGTERM "
    "preemption (install_preemption_handler) or the "
    "FLAGS_engine_snapshot_interval period then commits a restorable "
    "snapshot through the atomic commit protocol of "
    "distributed/checkpoint/manager.py.  Empty disables the automatic "
    "path (explicit engine.snapshot(dir)/drain(dir) calls still work)",
)
define_flag(
    "FLAGS_engine_snapshot_interval",
    0,
    "Macro-steps between periodic live-engine snapshots "
    "(FLAGS_engine_snapshot_dir must be set; 0 = preemption-triggered "
    "only).  Snapshots are written at macro-step boundaries, never while "
    "a step runs",
)
define_flag(
    "FLAGS_scan_layers",
    False,
    "Force the LayerStack scan-over-layers layout for models with a "
    "fuse_layer_stack config knob (the JAX package's models/llama.py and "
    "models/gpt.py); not ported: a model built while it is on raises "
    "(ROADMAP.md A.3.4)",
)
