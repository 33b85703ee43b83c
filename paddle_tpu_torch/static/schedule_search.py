"""The schedule searcher and its measured-win gate (counterpart of the
search protocol of paddle_tpu/static/schedule_search.py:983-1154).

A spec describes one geometry of a searchable kernel (so far the serving
chains of ``ops.decode_chain``) and implements the protocol: ``key``,
``kernel_name``, ``label``/``config_label``, ``enumerate_configs``,
``roofline_ms``, ``smem_bytes``, ``reference`` (the plain twin),
``synthetic_args``, ``parity_ok``, ``build``.  ``ScheduleSearcher.search``
drives it: enumerate -> roofline prune -> shared-memory prune -> parity
against the twin -> measure -> measured-win gate -> persist in the
per-device autotune cache.  A cached verdict is served with no
measurement.

One deliberate difference from the JAX searcher, which skips a candidate
on any exception: here only a candidate the spec refuses for its geometry
(``build`` raising ``ValueError``) is skipped.  A CUDA build or launch
error propagates, so a broken kernel is never mistaken for a slow one.

The Program-subgraph matcher and its codegen (``build_kernel``,
``_build_kernel_ktiled``) are ROADMAP.md queue A item 5.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

__all__ = ["Decision", "ScheduleSearcher", "measure_override", "schedule_search_stats",
           "reset_schedule_search_stats"]

_COUNTERS = {
    "subgraphs_found": 0,   # fresh searches (cache service counted apart)
    "candidates": 0,        # configs enumerated across all searches
    "pruned_roofline": 0,   # dropped by the roofline ranking
    "pruned_smem": 0,       # dropped by the shared-memory budget
    "refused": 0,           # configs whose build refused the geometry
    "pruned_parity": 0,     # failed the parity gate against the twin (never timed)
    "measured": 0,          # candidates timed on the card
    "accepted": 0,          # geometries whose best config beat the twin
    "disabled": 0,          # geometries recorded as losing (or with no candidate)
    "cache_hits": 0,        # accepted configs served from the cache
    "disabled_hits": 0,     # disabled geometries skipped through the cache
}


def schedule_search_stats() -> dict:
    return dict(_COUNTERS)


def reset_schedule_search_stats():
    for k in _COUNTERS:
        _COUNTERS[k] = 0


_MEASURE_OVERRIDE = None


@contextlib.contextmanager
def measure_override(fn):
    """Route every measurement through ``fn(run, args, *, label, config)``
    -> ms; ``config`` is None for the plain twin.  The CPU tests decide
    through this."""
    global _MEASURE_OVERRIDE
    prev, _MEASURE_OVERRIDE = _MEASURE_OVERRIDE, fn
    try:
        yield
    finally:
        _MEASURE_OVERRIDE = prev


@dataclass
class Decision:
    """Outcome of one search."""

    status: str             # accepted | disabled | cache | cache_disabled
    config: dict | None = None
    kernel_ms: float = 0.0
    plain_ms: float = 0.0
    win: float = 0.0

    @property
    def accepted(self) -> bool:
        return self.status in ("accepted", "cache")


class ScheduleSearcher:
    """Enumerate -> roofline prune -> shared-memory prune -> parity ->
    measure -> gate -> persist."""

    def __init__(self, cost_model=None, budget=None, min_win=None, roofline_margin=1.5,
                 iters=10, warmup=2):
        from paddle_tpu_torch._core import flags

        if cost_model is None:
            from paddle_tpu_torch.cost_model import OpCostModel

            cost_model = OpCostModel()
        self.cost_model = cost_model
        self.budget = (int(flags.flag("FLAGS_schedule_search_budget"))
                       if budget is None else int(budget))
        self.min_win = (float(flags.flag("FLAGS_schedule_search_min_win"))
                        if min_win is None else float(min_win))
        self.roofline_margin = float(roofline_margin)
        self.iters = int(iters)
        self.warmup = int(warmup)

    def _measure_ms(self, label, fn, args, config):
        if _MEASURE_OVERRIDE is not None:
            return float(_MEASURE_OVERRIDE(fn, args, label=label, config=config))
        return self.cost_model.measure(label, fn, *args, iters=self.iters,
                                       warmup=self.warmup) * 1e3

    @staticmethod
    def _persist(spec, config, ms, meta):
        from paddle_tpu_torch._core import flags
        from paddle_tpu_torch.ops import autotune as at

        if flags.flag("FLAGS_use_autotune_cache"):
            at.record(spec.kernel_name(), spec.key(), config, ms, meta=meta)

    def search(self, spec) -> Decision:
        """Drive ``spec`` through the protocol.  Every candidate's numerics
        are held against the plain twin before it may be timed: one that
        fails parity is never accepted, however fast.  The specs' kernels
        update their inputs in place, so each parity run gets fresh
        ``synthetic_args()`` (the same values every call)."""
        from paddle_tpu_torch.ops import autotune as at

        cached = at.lookup(spec.kernel_name(), spec.key())
        if cached is not None:
            if cached.get("disabled"):
                _COUNTERS["disabled_hits"] += 1
                return Decision("cache_disabled")
            _COUNTERS["cache_hits"] += 1
            return Decision("cache", cached)

        _COUNTERS["subgraphs_found"] += 1
        candidates = spec.enumerate_configs()
        _COUNTERS["candidates"] += len(candidates)
        if not candidates:
            _COUNTERS["disabled"] += 1
            return Decision("disabled")
        ranked = [(spec.roofline_ms(c, self.cost_model), c) for c in candidates]
        best_roof = min(r for r, _ in ranked)
        kept = [(r, c) for r, c in ranked if r <= best_roof * self.roofline_margin]
        _COUNTERS["pruned_roofline"] += len(ranked) - len(kept)
        fit = [(r, c) for r, c in kept if at.validate_tile(spec.smem_bytes(c)) is None]
        _COUNTERS["pruned_smem"] += len(kept) - len(fit)
        fit.sort(key=lambda rc: rc[0])

        ref_fn = spec.reference()
        ref_out = None
        args = spec.synthetic_args()
        best_cfg, best_ms = None, float("inf")
        budget_left = max(1, self.budget)
        for _, cfg in fit:
            if budget_left <= 0:
                break
            try:
                fn = spec.build(cfg)
            except ValueError:
                _COUNTERS["refused"] += 1
                continue
            if ref_out is None:
                ref_out = ref_fn(*spec.synthetic_args())
            if not spec.parity_ok(fn, spec.synthetic_args(), ref_out):
                _COUNTERS["pruned_parity"] += 1
                continue
            ms = self._measure_ms(spec.label() + spec.config_label(cfg), fn, args, cfg)
            _COUNTERS["measured"] += 1
            budget_left -= 1
            if ms < best_ms:
                best_cfg, best_ms = dict(cfg), float(ms)

        if best_cfg is None:
            # nothing passed: not a measured loss, so nothing is persisted
            # and a later version gets to retry
            _COUNTERS["disabled"] += 1
            return Decision("disabled")

        plain_ms = float(self._measure_ms(f"{spec.label()}#plain", ref_fn, args, None))
        win = plain_ms / best_ms if best_ms > 0 else 0.0
        meta = {"win": round(win, 4), "plain_ms": round(plain_ms, 6)}
        if win >= self.min_win:
            self._persist(spec, best_cfg, best_ms, meta)
            _COUNTERS["accepted"] += 1
            return Decision("accepted", best_cfg, best_ms, plain_ms, win)
        self._persist(spec, {"disabled": True}, best_ms, meta)
        _COUNTERS["disabled"] += 1
        return Decision("disabled", None, best_ms, plain_ms, win)
