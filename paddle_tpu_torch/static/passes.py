"""Static-Program pass infrastructure (counterpart of
paddle_tpu/static/passes.py): the pass protocol, a pass manager, dead-code
elimination and ``apply_pass``.  Of the JAX package's registered passes
``dead_code_elimination``, ``pallas_fusion`` and the codegen passes
``generic_elementwise_fusion`` and ``schedule_search`` are ported; every
other name raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from paddle_tpu_torch.framework.op_registry import base_op_type, side_effect_op_types

__all__ = ["ProgramPass", "ProgramPassManager", "dead_code_elimination", "apply_pass"]


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
            # a random op is never eliminated: dropping one would shift
            # every later op's random stream
            if any(v in live for v in op.out_vids) or \
                    base_op_type(op.type) in side_effect_op_types():
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
    """Runs passes in order and returns the total number of changes.  Under
    ``FLAGS_verify_programs`` the program is verified before the first
    pass and after each one, so the error names the pass that broke it."""

    def __init__(self, passes, fetch_vids=()):
        self._passes = list(passes)
        self._fetch_vids = tuple(fetch_vids)

    def _verify(self, program, where):
        from .verify import VerificationError, verify_program

        try:
            verify_program(program, self._fetch_vids)
        except VerificationError as e:
            raise VerificationError(e.violations, header=f"Program invalid {where}") from None

    def run(self, program):
        from paddle_tpu_torch._core import flags

        verify = flags.flag("FLAGS_verify_programs")
        if verify:
            self._verify(program, "BEFORE pass pipeline")
        total = 0
        for p in self._passes:
            total += p.apply(program)
            if verify:
                self._verify(program, f"after pass {getattr(p, 'name', type(p).__name__)!r}")
        return total


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
    "weight_only_quant": "A.5.6 (static passes)",
    "auto_parallel_fp16": "A.6",
    "auto_parallel_recompute": "A.6",
    "auto_parallel_gradient_merge": "A.6",
    "auto_parallel_sharding": "A.6",
}


def apply_pass(program, name, **kwargs):
    """Run the pass ``name`` (through the verifying pass manager while
    ``FLAGS_verify_programs`` is on)."""
    from paddle_tpu_torch._core import flags

    if name in _UNPORTED:
        raise NotImplementedError(
            f"program pass {name!r} is not ported yet (ROADMAP.md {_UNPORTED[name]})")
    if name not in _REGISTRY:
        raise ValueError(f"unknown program pass {name!r}; have {sorted(_REGISTRY)}")
    pass_ = _REGISTRY[name](**kwargs)
    if flags.flag("FLAGS_verify_programs"):
        return ProgramPassManager([pass_], kwargs.get("fetch_vids") or ()).run(program)
    return pass_.apply(program)
