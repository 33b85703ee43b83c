"""Captured steps: a body run once, then recorded as a CUDA graph.

The JAX package compiles its hot steps with ``jax.jit`` (the serving
macro-step, ``Executor.run``); XLA does that and the package has no file
of its own for it.  Here the same bodies are recorded once with
``torch.cuda.graph`` and replayed, so the host launches one graph where it
launched every kernel.  ``capture(fn, device)``:

- on a CUDA device calls ``fn()`` once, the warm-up (every kernel is
  built, every Triton kernel compiled, cuBLAS set up), on the stream the
  recording then uses, and records a second ``fn()`` into a graph with a
  memory pool of its own (nothing runs while it records);
- on the CPU keeps ``fn`` and calls it at every replay: the plain
  versions, as the JAX package's interpreted runs, with nothing to build
  and so no warm-up call;
- returns a ``Captured``, which holds the warm-up call's outputs.

``fn`` reads its inputs from tensors whose addresses do not change (the
caller copies new inputs into them before a replay) and returns tensors
that every replay overwrites: read or copy them before the next.

The kernel wrappers count a launch in Python where they launch
(``ops.count_launch``).  That code runs while the graph records, when
nothing launches, and never at a replay.  So the counters are put back as
they were after the recording, and every replay credits what the warm-up
call counted: the counters go on meaning kernels that ran on the card.  A
recording that counted other launches than its warm-up raises.

A call inside ``fn`` that a graph cannot hold (a host sync, a launch on
another stream) fails the capture, which raises with that op's error:
nothing runs ``fn`` eagerly in its place.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Captured", "capture"]

_STREAMS: dict = {}  # device index -> the side stream warm-ups and recordings run on


def _counters():
    from paddle_tpu_torch import ops

    return (ops._LAUNCHES, ops._YARDSTICKS)


def _snapshot():
    return tuple(dict(c) for c in _counters())


def _growth(before):
    """What each counter gained since ``before``, nonzero entries only."""
    return tuple({k: v - b[k] for k, v in c.items() if v != b[k]}
                 for c, b in zip(_counters(), before))


def _credit(growth):
    for counts, add in zip(_counters(), growth):
        for name, n in add.items():
            counts[name] += n


def _restore(snapshot):
    for counts, was in zip(_counters(), snapshot):
        counts.update(was)


class Captured:
    """A recorded step.  ``replay()`` runs it and returns its outputs;
    ``warm_outputs`` are the warm-up call's (None on the CPU, which makes
    none), ``launches`` what each replay adds to the launch counters (and
    the yardsticks'), ``capture_s`` the seconds of recording and
    instantiating the graph, ``graph_bytes`` the device memory its pool
    reserved."""

    def __init__(self, graph, outputs, launches, fn=None, warm_outputs=None, capture_s=0.0,
                 graph_bytes=0):
        self._graph = graph  # None on the CPU: fn runs at every replay
        self._fn = fn
        self.outputs = outputs
        self.warm_outputs = warm_outputs
        self.launches = launches
        self.capture_s = capture_s
        self.graph_bytes = graph_bytes

    def replay(self):
        if self._graph is None:
            return self._fn()
        self._graph.replay()
        _credit(self.launches)
        return self.outputs


def _side_stream(device):
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


def _warm(fn, device):
    """``fn()`` on the recording's stream, ordered after the work queued on
    the current one, which in turn waits for it."""
    stream, current = _side_stream(device), torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def _record(fn, device):
    """``fn()`` recorded into a new graph on the warm-up's stream; returns
    the graph, its outputs and the bytes its pool reserved."""
    # torch.cuda.graph empties the allocator's cache as it starts: do it
    # first, so the baseline holds only live tensors
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=_side_stream(device)):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")  # a hidden host sync names its op
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    grown = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0) - reserved
    return graph, out, grown


def capture(fn, device):
    """On a CUDA device warm ``fn`` up and record it; on the CPU keep it
    (module docstring).  Returns a ``Captured``."""
    device = torch.device(device)
    if device.type != "cuda":
        return Captured(None, None, ({}, {}), fn=fn)
    before = _snapshot()
    warm = _warm(fn, device)
    launches = _growth(before)
    recording = _snapshot()
    t0 = time.perf_counter()
    try:
        graph, out, graph_bytes = _record(fn, device)
    finally:
        recorded = _growth(recording)
        _restore(recording)
    if recorded != launches:
        raise RuntimeError(f"the recorded step counted launches {recorded}, its warm-up "
                           f"{launches}: the graph would replay other kernels than ran")
    return Captured(graph, out, launches, warm_outputs=warm,
                    capture_s=time.perf_counter() - t0, graph_bytes=graph_bytes)
