"""Static-graph executor (counterpart of paddle_tpu/static/executor.py).

The JAX Executor compiles the Program's pruned op list with ``jax.jit``,
once per (program, version, feed shapes and dtypes, fetch set).  Here the
same key holds a captured run (``_core/graphs.py``): the first run of a key
copies the feeds into fixed buffers and runs the pruned op list eagerly
under ``torch.no_grad()`` on the Executor's device (building the kernels,
the searches' kernels and the Triton JIT; its fetches are that run's),
then records it as a CUDA graph; every later run copies the feeds in and
replays.  On the CPU the same body runs eagerly every time.  Before a run
the default pass pipeline (``PallasFusionPass`` while
``FLAGS_use_pallas_fusion`` is on, then ``ScheduleSearchPass`` on the
Executor's device while ``FLAGS_schedule_search`` is on, as in the JAX
package) rewrites the program, each stage memoised per (program version,
fetch set).  Persistent state (parameters) lives in a Scope keyed by var
id; the scope holds each parameter's own storage, except state a program
writes, which the scope holds in a copy that each run updates in place
(no program of this tier writes state yet).  A captured run reads the
scope's tensors it was recorded over: if the scope holds others, the key
is recorded again.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from paddle_tpu_torch._core import flags, graphs
from paddle_tpu_torch._core.device import resolve_device

from .program import Program, Variable, default_main_program

__all__ = ["Executor", "Scope", "global_scope", "scope_guard"]


class Scope:
    def __init__(self):
        self._vals: dict[int, torch.Tensor] = {}

    def find_var(self, vid):
        return self._vals.get(vid)

    def set_var(self, vid, val):
        self._vals[vid] = val


_global_scope = Scope()


def global_scope():
    return _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        global _global_scope
        self._prev = _global_scope
        _global_scope = self.scope
        return self.scope

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self._prev


def _unported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md A.5): the port's Executor "
        "would skip it, which is a different result")


def _fetch_numpy(t: torch.Tensor) -> np.ndarray:
    """A fresh array: a later run must not overwrite what the caller holds.
    numpy has no bf16: every bf16 value is exact in f32."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


class _CapturedRun:
    """One key's captured run: fixed feed buffers, the scope's state
    tensors it reads (and writes in place, where the program writes
    state), and the captured step returning the fetches."""

    def __init__(self, run_fn, feeds, state, written, place):
        self.feeds = [torch.empty(f.shape, dtype=f.dtype, device=place) for f in feeds]
        self.state = state

        @torch.no_grad()
        def body():
            fetches, new_state = run_fn(self.feeds, state)
            for i in written:
                state[i].copy_(new_state[i])
            return fetches

        self._copy_in(feeds)
        self.step = graphs.capture(body, place)

    def _copy_in(self, feeds):
        for buf, f in zip(self.feeds, feeds):
            buf.copy_(f)

    def first(self):
        """The fetches of the first run: the card's warm-up call, or on
        the CPU the body's first call."""
        if self.step.warm_outputs is not None:
            return self.step.warm_outputs
        return self.step.replay()

    def run(self, feeds):
        self._copy_in(feeds)
        return self.step.replay()


class Executor:
    """``Executor(place).run(program, feed, fetch_list)`` -> list of fetches.

    ``place=None`` means the CUDA card (and raises without one); pass
    ``place="cpu"`` for the plain versions on the CPU.  Feeds, parameters
    and captured consts must lie on that device: a torch tensor on another
    device raises, nothing is moved.  A numpy feed, which has no device, is
    copied there.  Feeds are cast to their ``static.data`` dtype."""

    def __init__(self, place=None):
        self.place = resolve_device(place)
        self._cache = {}   # (program, version, feed signature, fetch set) -> _CapturedRun
        self._pruned = {}  # (program, version, fetch set) -> program.as_function(...)

    def _check_device(self, what, t):
        if t.device != self.place:
            raise ValueError(f"{what} lies on {t.device}, the Executor runs on {self.place}; "
                             "nothing is moved silently")

    def _ensure_state(self, program: Program, scope: Scope):
        for vid, init in program.param_inits.items():
            if scope.find_var(vid) is None:
                self._check_device(f"parameter {program._var_by_vid[vid].name}", init)
                # state a program writes is updated in place: the scope's own copy
                scope.set_var(vid, init.detach().clone() if vid in program.writes
                              else init.detach())

    def _feed_value(self, var: Variable, value):
        """The feed in its ``static.data`` dtype: a torch tensor on the
        Executor's device, or a numpy value on the host (copied to the
        device by the run's copy into its feed buffer)."""
        if isinstance(value, torch.Tensor):
            self._check_device(f"feed '{var.name}'", value)
            return value.to(var.dtype)
        return torch.as_tensor(np.asarray(value), dtype=var.dtype)

    @staticmethod
    def _rewrite_stage(program, fetch_vids, stamp_attr, pass_cls):
        """One memoised fusion stage, per (version, fetch set): a SET, so
        alternating fetch lists do not re-pay the scan on every run."""
        seen = getattr(program, stamp_attr, None)
        if seen is None:
            seen = set()
            setattr(program, stamp_attr, seen)
        if (program.version, fetch_vids) in seen:
            return
        pass_cls(fetch_vids).apply(program)
        seen.add((program.version, fetch_vids))

    def _prune(self, program, fetch_vids):
        """The ops the fetch/write frontier needs (last writer wins), with
        the device of every captured const checked once."""
        live = set(fetch_vids) | set(program.writes) | set(program.writes.values())
        pruned = []
        for op in reversed(program.global_block().ops):
            if any(v in live for v in op.out_vids):
                pruned.append(op)
                live.difference_update(op.out_vids)
                live.update(op.input_vids())
        pruned.reverse()
        for op in pruned:
            for s in op.arg_spec:
                if s[0] == "const" and isinstance(s[1], torch.Tensor):
                    self._check_device(f"a const of op {op.type}", s[1])
        return pruned

    def _prepare(self, program, feed, fetch_list, scope):
        """Check and convert the run's arguments, run the pass pipeline;
        returns (program, scope, fetch vids, feed values), or None when
        there is nothing to run."""
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_list = fetch_list or []
        if flags.flag("FLAGS_verify_programs"):
            raise _unported("FLAGS_verify_programs (static/verify.py)")
        if not program.global_block().ops and not program.param_inits and not fetch_list:
            return None

        self._ensure_state(program, scope)
        fetch_vids = []
        for f in fetch_list:
            if isinstance(f, Variable):
                fetch_vids.append(f._vid)
            elif isinstance(f, str):
                fetch_vids.append(program.global_block().var(f)._vid)
            else:
                raise TypeError(f"bad fetch entry {f!r}")
        fetch_vids = tuple(fetch_vids)
        feed_vals = []
        for v in program.feed_vars:
            if v.name not in feed:
                raise KeyError(f"missing feed '{v.name}'")
            feed_vals.append(self._feed_value(v, feed[v.name]))

        if flags.flag("FLAGS_use_pallas_fusion"):
            from .rewrite import PallasFusionPass

            self._rewrite_stage(program, fetch_vids, "_pallas_fused_at", PallasFusionPass)
        if flags.flag("FLAGS_schedule_search"):
            # discovered reduction-/matmul-rooted subgraphs, searched on this
            # device after the named patterns took theirs; an accepted
            # verdict is served from the autotune cache on later programs
            from .rewrite import ScheduleSearchPass

            self._rewrite_stage(program, fetch_vids, "_sched_searched_at",
                                functools.partial(ScheduleSearchPass, device=self.place))
        return program, scope, fetch_vids, feed_vals

    def _function(self, program, fetch_vids):
        key = (program, program.version, fetch_vids)  # the program itself: its id may recur
        if key not in self._pruned:
            self._pruned[key] = program.as_function(list(fetch_vids),
                                                    ops=self._prune(program, fetch_vids))
        return self._pruned[key]

    @staticmethod
    def _results(fetches, return_numpy):
        if return_numpy:
            return [_fetch_numpy(t) for t in fetches]
        return [t.clone() for t in fetches]  # fresh: the next replay overwrites the graph's

    def run(self, program=None, feed=None, fetch_list=None, scope=None, return_numpy=True):
        """Run ``program`` on ``feed`` and return the ``fetch_list`` values:
        numpy arrays (a bf16 fetch comes back as exact float32, since numpy
        has no bf16) or, with ``return_numpy=False``, torch tensors on the
        Executor's device in their own dtype.  Either is the caller's own:
        no later run writes into it."""
        prepared = self._prepare(program, feed, fetch_list, scope)
        if prepared is None:
            return []
        program, scope, fetch_vids, feed_vals = prepared
        sig = tuple((tuple(f.shape), f.dtype) for f in feed_vals)
        key = (program, program.version, sig, fetch_vids)
        run_fn, _, state_vids = self._function(program, fetch_vids)
        state = [scope.find_var(vid) for vid in state_vids]
        entry = self._cache.get(key)
        if entry is not None and all(a is b for a, b in zip(entry.state, state)):
            fetches = entry.run(feed_vals)
        else:
            written = [i for i, vid in enumerate(state_vids) if vid in program.writes]
            entry = self._cache[key] = _CapturedRun(run_fn, feed_vals, state, written,
                                                    self.place)
            fetches = entry.first()
        return self._results(fetches, return_numpy)

    def _run_eager(self, program=None, feed=None, fetch_list=None, scope=None,
                   return_numpy=False):
        """``run()`` with the pruned op list run eagerly, op by op, and no
        captured step: the yardstick the timing tools and the card checks
        compare the replays with, not a run option."""
        prepared = self._prepare(program, feed, fetch_list, scope)
        if prepared is None:
            return []
        program, scope, fetch_vids, feed_vals = prepared
        run_fn, _, state_vids = self._function(program, fetch_vids)
        state = [scope.find_var(vid) for vid in state_vids]
        feed_vals = [f.to(self.place) for f in feed_vals]
        with torch.no_grad():
            fetches, new_state = run_fn(feed_vals, state)
            for t, vid, new in zip(state, state_vids, new_state):
                if vid in program.writes:
                    t.copy_(new)
        return self._results(fetches, return_numpy)

    def close(self):
        self._cache.clear()
        self._pruned.clear()
