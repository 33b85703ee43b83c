"""Static-Program pass infrastructure (counterpart of
paddle_tpu/static/passes.py): the pass protocol, a pass manager, dead-code
elimination and ``apply_pass``.  Of the JAX package's registered passes
``dead_code_elimination``, ``pallas_fusion`` and the codegen passes
``generic_elementwise_fusion`` and ``schedule_search`` are ported; every
other name raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

__all__ = ["ProgramPass", "ProgramPassManager", "dead_code_elimination", "apply_pass"]

# op types never eliminated: the random ops a capture can record (dropping
# one would shift every later op's random stream)
_SIDE_EFFECT = frozenset({"torch.rand_like", "torch.randn_like", "torch.randint_like",
                          "torch.bernoulli", "Tensor.bernoulli", "torch.multinomial",
                          "Tensor.multinomial", "torch.normal", "torch.dropout"})


class ProgramPass:
    name = "base"

    def apply(self, program) -> int:
        """Mutate the program; return the number of changes."""
        raise NotImplementedError


class DeadCodeEliminationPass(ProgramPass):
    """Remove ops whose outputs no fetch, write or live op input reaches.
    With no fetch frontier nothing is provably dead, so nothing goes."""

    name = "dead_code_elimination"

    def __init__(self, fetch_vids=None):
        self._fetch_vids = set(fetch_vids or ())

    def apply(self, program) -> int:
        if not self._fetch_vids:
            return 0
        block = program.global_block()
        live = set(self._fetch_vids) | set(program.writes) | set(program.writes.values())
        keep = []
        for op in reversed(block.ops):
            if any(v in live for v in op.out_vids) or \
                    op.type.rsplit("::", 1)[-1] in _SIDE_EFFECT:
                keep.append(op)
                live.update(op.input_vids())
        removed = len(block.ops) - len(keep)
        block.ops = list(reversed(keep))
        if removed:
            program.version += 1
        return removed


def dead_code_elimination(program, fetch_vars=()):
    """Prune the op list down to what ``fetch_vars`` need; returns the
    number of removed ops."""
    return DeadCodeEliminationPass([v._vid for v in fetch_vars]).apply(program)


class ProgramPassManager:
    """Runs passes in order and returns the total number of changes."""

    def __init__(self, passes, fetch_vids=()):
        self._passes = list(passes)
        self._fetch_vids = tuple(fetch_vids)

    def run(self, program):
        return sum(p.apply(program) for p in self._passes)


def _pallas_fusion_factory(**kwargs):
    from .rewrite import PallasFusionPass

    return PallasFusionPass(**kwargs)


def _generic_elementwise_factory(**kwargs):
    from .rewrite import GenericElementwiseFusionPass

    return GenericElementwiseFusionPass(**kwargs)


def _schedule_search_factory(**kwargs):
    from .rewrite import ScheduleSearchPass

    return ScheduleSearchPass(**kwargs)


_REGISTRY = {
    "dead_code_elimination": DeadCodeEliminationPass,
    "pallas_fusion": _pallas_fusion_factory,
    "generic_elementwise_fusion": _generic_elementwise_factory,
    "schedule_search": _schedule_search_factory,
}
# the JAX package's other passes, each with the ROADMAP item that ports it
_UNPORTED = {
    "weight_only_quant": "queue A item 5 (static passes)",
    "auto_parallel_fp16": "queue A item 6",
    "auto_parallel_recompute": "queue A item 6",
    "auto_parallel_gradient_merge": "queue A item 6",
    "auto_parallel_sharding": "queue A item 6",
}


def apply_pass(program, name, **kwargs):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"program pass {name!r} is not ported yet (ROADMAP.md {_UNPORTED[name]})")
    if name not in _REGISTRY:
        raise ValueError(f"unknown program pass {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs).apply(program)
