"""Static-IR verifier and pass-differential checker (counterpart of
paddle_tpu/static/verify.py).

Two layers, as in the JAX package:

- ``ProgramVerifier``: structural checks over any Program.  Def-before-use
  (no dangling vids), every op type resolvable through the op registry
  (``framework/op_registry.py``), the kwargs the rewrite patterns gate on
  (gelu's ``approximate``, softmax's ``axis``, the norms' ``epsilon``), at
  most one live producer per vid on the fetch frontier (the Executor's
  last-writer-wins prune), and each op's output shapes and dtypes by
  abstract eval: its callable run on meta tensors (the counterpart of
  ``jax.eval_shape``), so a rewrite that changes an intermediate's shape
  or dtype is an error.  torch's ``matmul`` takes no transpose flags (a
  transpose is an op of its own), so the port requires none on ``matmul``.
- ``differential_check(reference, candidate, fetch_vids)``: replays both
  programs eagerly on the same feed, each from the same RNG state, and
  holds the fetches to a tolerance; the mechanical answer to "did this
  pass change numerics".

Wiring (all under ``FLAGS_verify_programs``): ``ProgramPassManager``
verifies before and after each pass, the Executor verifies each program
it records and differentially checks each rewrite stage against the
unrewritten program on the live feed, and ``save_inference_model``
checks the clone it exports.  ``verify_stats()`` reads the counters.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch.framework.op_registry import base_op_type, resolve_op_type

from .program import _to_meta, bind_op, prune_ops, suspend_capture

__all__ = [
    "Violation",
    "VerificationError",
    "DifferentialError",
    "ProgramVerifier",
    "verify_program",
    "differential_check",
    "track_programs",
    "verify_stats",
    "reset_verify_stats",
]

_COUNTERS = {
    "programs_verified": 0,
    "programs_failed": 0,
    "violations": 0,
    "abstract_eval_skips": 0,
    "differential_checks": 0,
    "differential_failures": 0,
    "differential_skips": 0,  # the reference program could not run
    "rewrites_refused": 0,  # PatternRewritePass rollbacks
}


def verify_stats(reset: bool = False) -> dict:
    out = dict(_COUNTERS)
    if reset:
        reset_verify_stats()
    return out


def reset_verify_stats():
    for k in _COUNTERS:
        _COUNTERS[k] = 0


@dataclass
class Violation:
    code: str  # dangling-vid | unknown-op-type | missing-kwargs | ...
    message: str
    op_index: int = -1
    op_type: str = ""

    def __str__(self):
        loc = f" [op#{self.op_index} {self.op_type}]" if self.op_index >= 0 else ""
        return f"{self.code}{loc}: {self.message}"


class VerificationError(RuntimeError):
    def __init__(self, violations, header="Program verification failed"):
        self.violations = list(violations)
        lines = [f"{header} ({len(self.violations)} violation(s)):"]
        lines += [f"  - {v}" for v in self.violations]
        super().__init__("\n".join(lines))


class DifferentialError(VerificationError):
    """The fetches differ between the original and the rewritten program."""


# kwargs the rewrite patterns gate on (static/rewrite.py)
_REQUIRED_KWARGS = {
    "gelu": ("approximate",),
    "softmax": ("axis",),
    "layer_norm": ("epsilon",),
    "rms_norm": ("epsilon",),
    "fused_rms_norm": ("epsilon",),
    "add_rms_norm": ("epsilon",),
    "add_layer_norm": ("epsilon",),
}


def _meta(var):
    return torch.empty(tuple(var.shape), dtype=var.dtype, device="meta")


class ProgramVerifier:
    """Structural and abstract-eval checks over a Program.

    ``check_registry`` / ``check_kwargs`` / ``abstract_eval`` toggle the
    tiers; ``strict_abstract`` makes an op that cannot run on meta tensors
    a violation instead of a counted skip."""

    def __init__(self, check_registry=True, check_kwargs=True, abstract_eval=True,
                 strict_abstract=False):
        self.check_registry = check_registry
        self.check_kwargs = check_kwargs
        self.abstract_eval = abstract_eval
        self.strict_abstract = strict_abstract

    def verify(self, program, fetch_vids=(), raise_on_error=False):
        violations = self._check_structure(program, fetch_vids)
        violations += self._check_live_producers(program, fetch_vids)
        _COUNTERS["programs_verified"] += 1
        if violations:
            _COUNTERS["programs_failed"] += 1
            _COUNTERS["violations"] += len(violations)
            if raise_on_error:
                raise VerificationError(violations)
        return violations

    # ------------------------------------------------------------ structure
    def _check_structure(self, program, fetch_vids):
        v = []
        defined = set(program.param_inits)
        for var in program.feed_vars:
            if var._vid not in program._var_by_vid:
                v.append(Violation("unregistered-feed", f"feed '{var.name}' (vid {var._vid}) "
                                   "is not registered in the program"))
            defined.add(var._vid)

        for i, op in enumerate(program.global_block().ops):
            if self.check_registry and not resolve_op_type(op.type):
                v.append(Violation("unknown-op-type", f"op type {op.type!r} does not resolve in "
                                   "the op registry (renamed op? unregistered extension? see "
                                   "framework.op_registry.register_op_type)", i, op.type))
            if self.check_kwargs:
                for k in _REQUIRED_KWARGS.get(base_op_type(op.type), ()):
                    if k not in op.kwargs:
                        v.append(Violation("missing-kwargs", f"op records no {k!r} kwarg; "
                                           "rewrite patterns gate on it and would mis-match "
                                           "this op", i, op.type))
            inputs_ok = True
            for vid in op.input_vids():
                var = program._var_by_vid.get(vid)
                if var is None:
                    v.append(Violation("unregistered-vid", f"input vid {vid} has no Variable",
                                       i, op.type))
                    inputs_ok = False
                elif vid not in defined:
                    v.append(Violation("dangling-vid", f"input vid {vid} ('{var.name}') is read "
                                       "before any feed, state or op defines it", i, op.type))
                    inputs_ok = False
            out_vars = []
            for vid in op.out_vids:
                var = program._var_by_vid.get(vid)
                if var is None:
                    v.append(Violation("unregistered-vid", f"output vid {vid} has no Variable",
                                       i, op.type))
                out_vars.append(var)
            if self.abstract_eval and inputs_ok and all(o is not None for o in out_vars):
                v += self._abstract_eval_op(program, i, op, out_vars)
            defined.update(op.out_vids)

        for tgt, src in program.writes.items():
            if tgt not in program._var_by_vid:
                v.append(Violation("bad-write", f"write target vid {tgt} has no Variable"))
            if src not in defined:
                v.append(Violation("bad-write", f"write source vid {src} is never defined"))
        for vid in fetch_vids:
            if vid not in defined:
                v.append(Violation("dangling-fetch", f"fetch vid {vid} is never defined by a "
                                   "feed, state var or op (a rewrite consumed its producer?)"))
        return v

    def _abstract_eval_op(self, program, i, op, out_vars):
        """Run the op on meta tensors: its recorded callable with meta
        inputs and consts, or, for an op a pass built, its ``fn``."""
        inputs = [_meta(program._var_by_vid[vid]) for vid in op.input_vids()]
        try:
            with suspend_capture():
                if op.impl is not None:
                    spec = [s if s[0] == "var" else ("const", _to_meta(s[1]))
                            for s in op.arg_spec]
                    out = bind_op(op.impl, spec, op.kwargs)(*inputs)
                else:
                    out = op.fn(*inputs)
            flat = pytree.tree_leaves(out)
        except Exception as e:  # an op that does not run on meta tensors
            _COUNTERS["abstract_eval_skips"] += 1
            if self.strict_abstract:
                return [Violation("abstract-eval-error", f"op failed abstract eval: {e!r}",
                                  i, op.type)]
            return []
        if len(flat) != len(op.out_vids):
            return [Violation("arity-mismatch", f"op produces {len(flat)} outputs but records "
                              f"{len(op.out_vids)} out vids", i, op.type)]
        v = []
        for var, o in zip(out_vars, flat):
            if tuple(var.shape) != tuple(o.shape):
                v.append(Violation("shape-mismatch", f"'{var.name}' recorded as "
                                   f"{tuple(var.shape)} but the op produces {tuple(o.shape)}",
                                   i, op.type))
            elif var.dtype != o.dtype:
                v.append(Violation("dtype-mismatch", f"'{var.name}' recorded as {var.dtype} "
                                   f"but the op produces {o.dtype}", i, op.type))
        return v

    # --------------------------------------------------- live producers
    def _check_live_producers(self, program, fetch_vids):
        """Prune as the Executor does (last writer wins), then require that
        no kept op redefines a vid whose earlier definition went unread:
        at most one live producer of a vid reaches the frontier (autodiff's
        ``share_loss`` re-binds the loss so that the forward chain drops)."""
        live = set(fetch_vids) | set(program.writes) | set(program.writes.values())
        v = []
        unread: dict[int, bool] = {}  # vid -> its latest definition not read yet
        for i, op in enumerate(prune_ops(program.global_block().ops, live)):
            for vid in op.input_vids():
                unread[vid] = False
            for vid in op.out_vids:
                if unread.get(vid, False):
                    var = program._var_by_vid.get(vid)
                    name = var.name if var is not None else vid
                    v.append(Violation("duplicate-producer", f"two live producers of '{name}' "
                                       f"(vid {vid}) reach the fetch frontier: the earlier "
                                       "definition is never read before this op redefines it "
                                       "(superseded chain not retired)", i, op.type))
                unread[vid] = True
        return v


def verify_program(program, fetch_vids=(), raise_on_error=True, **kwargs):
    """``ProgramVerifier(**kwargs).verify(...)``, raising by default."""
    return ProgramVerifier(**kwargs).verify(program, fetch_vids=fetch_vids,
                                            raise_on_error=raise_on_error)


# ---------------------------------------------------------------------------
# pass-differential checker


def _synthetic_feeds(feed_vars, seed, device):
    rng = np.random.default_rng(seed)
    feeds = []
    for var in feed_vars:
        shape = tuple(var.shape)
        if var.dtype.is_floating_point:
            feeds.append(torch.from_numpy(rng.standard_normal(shape)).to(device, var.dtype))
        elif var.dtype == torch.bool:
            feeds.append(torch.from_numpy(rng.integers(0, 2, shape).astype(bool)).to(device))
        else:  # small non-negative ints: valid ids in any vocabulary
            feeds.append(torch.from_numpy(rng.integers(0, 2, shape)).to(device, var.dtype))
    return feeds


def _replay(program, fetch_vids, feeds, device):
    """The fetches of ``program`` run eagerly on ``feeds``, the state its
    init values; torch's random state is restored afterwards (the RNG
    state var is only read: a replay's write is dropped)."""
    ops = prune_ops(program.global_block().ops, fetch_vids)
    run_fn, _, state_vids = program.as_function(list(fetch_vids), ops=ops)
    state = [program.state_init(vid, device) for vid in state_vids]
    feeds = [f.to(device, var.dtype) for f, var in zip(feeds, program.feed_vars)]
    devices = [device] if torch.device(device).type == "cuda" else []
    with torch.random.fork_rng(devices=devices), torch.no_grad():
        fetches, _ = run_fn(feeds, state)
    return [f.detach().to("cpu", torch.float64 if f.is_floating_point() else f.dtype)
            for f in fetches]


def differential_check(reference, candidate, fetch_vids, feeds=None, rtol=2e-3, atol=2e-3,
                       seed=0, raise_on_error=True, device=None):
    """Replay ``reference`` and ``candidate`` on the same feeds (positional,
    ``reference.feed_vars``' order; synthetic from ``seed`` if None) and
    compare the fetches.  Returns the mismatches as Violations; raises
    ``DifferentialError`` if there are any and ``raise_on_error``."""
    _COUNTERS["differential_checks"] += 1
    fetch_vids = list(fetch_vids)
    if device is None:
        device = feeds[0].device if feeds else "cpu"
    if feeds is None:
        feeds = _synthetic_feeds(reference.feed_vars, seed, device)
    try:
        ref_out = _replay(reference, fetch_vids, feeds, device)
    except Exception:
        # no oracle: the reference itself does not run eagerly
        _COUNTERS["differential_skips"] += 1
        return []
    violations = []
    try:
        cand_out = _replay(candidate, fetch_vids, feeds, device)
    except Exception as e:
        violations.append(Violation("differential-crash", "the rewritten program failed on "
                                    f"the differential feed: {e!r}"))
        cand_out = None
    for vid, a, b in zip(fetch_vids, ref_out, cand_out or ()):
        var = reference._var_by_vid.get(vid)
        name = var.name if var is not None else vid
        if a.shape != b.shape or a.dtype != b.dtype:
            violations.append(Violation("differential-mismatch", f"fetch '{name}': "
                                        f"{tuple(a.shape)}/{a.dtype} -> "
                                        f"{tuple(b.shape)}/{b.dtype}"))
        elif not a.is_floating_point():
            if not torch.equal(a, b):
                violations.append(Violation("differential-mismatch",
                                            f"fetch '{name}': integer values differ"))
        elif not torch.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
            err = float((a - b).abs().nan_to_num(0.0).max())
            violations.append(Violation("differential-mismatch", f"fetch '{name}': numerics "
                                        f"differ (max abs err {err:.3e} at rtol={rtol} "
                                        f"atol={atol}): the rewrite changed the computation"))
    if violations:
        _COUNTERS["differential_failures"] += 1
        if raise_on_error:
            raise DifferentialError(violations, header="Pass-differential check failed")
    return violations


@contextlib.contextmanager
def track_programs():
    """Collect every Program made (constructed or cloned) while active."""
    from . import program as _program

    seen: list = []
    _program._creation_hooks.append(seen.append)
    try:
        yield seen
    finally:
        _program._creation_hooks.remove(seen.append)
