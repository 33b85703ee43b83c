"""paddle_tpu_torch.device — synchronisation and step timing
(counterpart of paddle_tpu/device).

On the card a CUDA stream runs in order and ``torch.cuda.synchronize``
waits for it, so neither helper needs the JAX package's readback barrier.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch._core.device import resolve_device

__all__ = ["synchronize", "time_step_ms"]


def synchronize(device=None):
    """Block until all work launched on the CUDA ``device`` (the current
    one by default) has finished; a CPU device has nothing to wait for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_step_ms(fn, args=(), *, inner=10, samples=2):
    """Steady-state ms per call of ``fn(*args)`` on the current CUDA card:
    the least over ``samples`` of the mean of ``inner`` back-to-back calls,
    timed with CUDA events after a synchronise.  Raises without a card."""
    resolve_device(None)
    best = float("inf")
    for _ in range(samples):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best
