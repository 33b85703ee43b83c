"""Cost model: roofline estimates and measured times on the card
(counterpart of paddle_tpu/cost_model/__init__.py, the two parts the
schedule searcher uses).

- ``OpCostModel.flops_time(flops, bytes)`` is the roofline estimate from
  the device's peak rate and memory bandwidth, which ranks candidates
  before any is run;
- ``OpCostModel.measure(name, fn, *args)`` times a callable on the CUDA
  card with CUDA events after a warm-up.  Each timed call is enqueued
  behind a spin on the card, so the events time the device and not the
  host's launch cost (the serving chains' wrappers take tens of µs of
  host time, as long as their kernels).

There is no measurement on the CPU: ``measure`` raises for a callable
whose inputs do not lie on a CUDA device (tests inject their times
through ``static.schedule_search.measure_override``).
"""

from __future__ import annotations

import torch

__all__ = ["OpCostModel", "device_peaks"]

_SPIN_CYCLES = 2_000_000  # about 1 ms of spinning at the H100's clock

# (peak TFLOP/s bf16 dense, memory GB/s) per device name, lower-cased
# substrings; NVIDIA's data sheet for the H100 SXM
_PEAKS = {
    "h100": (989.0, 3350.0),
    "cpu": (0.5, 50.0),
}


def device_peaks(device=None):
    """(peak TFLOP/s, memory GB/s) of ``device`` (default: the current CUDA
    card, else the CPU placeholder)."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    kind = torch.cuda.get_device_name(dev).lower() if dev.type == "cuda" else "cpu"
    for k, v in _PEAKS.items():
        if k in kind:
            return v
    # unknown device: a placeholder that keeps estimates finite (measured
    # times are the authoritative path)
    return (100.0, 500.0)


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif hasattr(a, "data") and isinstance(a.data, torch.Tensor):  # QuantPool
            yield a.data


class OpCostModel:
    """Measured times on the card beside the roofline estimate of
    ``device`` (default: the current CUDA card)."""

    def __init__(self, device=None):
        self.device = device

    def measure(self, name, fn, *args, iters=10, warmup=2):
        """Mean seconds a call of ``fn(*args)`` on the CUDA card: CUDA
        events around each of ``iters`` calls, after ``warmup`` calls."""
        devices = {t.device for t in _tensors(args)}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise RuntimeError(f"measure({name!r}) times on one CUDA device; the "
                               f"inputs lie on {sorted(map(str, devices))}")
        (device,) = devices
        with torch.cuda.device(device):
            for _ in range(warmup):
                fn(*args)
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
            for start, end in events:
                torch.cuda._sleep(_SPIN_CYCLES)
                start.record()
                fn(*args)
                end.record()
            torch.cuda.synchronize(device)
            return sum(s.elapsed_time(e) for s, e in events) / 1e3 / iters

    def flops_time(self, flops, mem_bytes=0):
        """Roofline estimate: max(compute-bound, bandwidth-bound) seconds."""
        peak_tflops, mem_gbs = device_peaks(self.device)
        return max(flops / (peak_tflops * 1e12), mem_bytes / (mem_gbs * 1e9))
