#!/usr/bin/env python3
"""Where the port's training time goes on the card.

    python3 tools/profile_torch_training.py

Builds the ``chip_smoke.py`` phase-4 configuration (bench.py's flagship
LLaMA, bf16, 8 layers, batch 4 x 1024) with ``TrainStep`` and AdamW,
runs 3 warm-up steps, then prints three JSON lines:

1. ms a step on the host clock over 10 unprofiled steps;
2. two ``TrainStep`` steps under ``torch.profiler``: the time the card was
   busy (kernel, copy and memset events only, overlaps counted once) and
   its share of the profiled wall time, the device events a step, and the
   kernels with the most device time;
3. one step split into its phases (forward and loss, backward,
   ``optimizer.step`` with ``clear_grad``), each under
   ``record_function`` and ended by a synchronise: device ms and events a
   phase, each device event counted in the phase whose host range holds
   its launch (the CUDA runtime call that carries its correlation id), so
   that no clock skew between the host and the card moves an event
   across phases.

Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

import profile_torch_serving as serving_profile

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("forward", "backward", "optimizer")


def step_ms(step, ids, labels, n=10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(ids, labels)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile_steps(step, ids, labels, n=2, top=25):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = step_ms(step, ids, labels, n)
    events = serving_profile.device_events(prof)
    busy_ms = serving_profile.busy_us(events) / 1e3 / n
    if not 0 < busy_ms <= wall_ms:
        raise RuntimeError(f"device busy {busy_ms} ms a step outside (0, wall {wall_ms} ms]")
    return {"profile": f"{n} TrainStep steps", "profiled_wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_events_per_step": len(events) / n,
            "top_kernels": serving_profile.top_kernels(events, top, per=n)}


def launch_times(prof):
    """The host start of each device event's launch: the CUDA runtime or
    driver call (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...) that
    carries the device event's correlation id.  Runtime calls are told
    from torch ops by name, since the two count their ids apart and the
    ids collide."""
    from torch.autograd import DeviceType

    runtime = {e.id: e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    return {e.id: runtime.get(e.id) for e in prof.events() if e.device_type != DeviceType.CPU}


def profile_phases(model, opt, loss_fn, ids, labels):
    """One step as TrainStep runs it, each phase in its own synchronised
    ``record_function`` range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def phase(name, fn):
        with record_function(name):
            out = fn()
            torch.cuda.synchronize()
        return out

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss = phase("forward", lambda: loss_fn(model, ids, labels))
        phase("backward", loss.backward)
        phase("optimizer", lambda: (opt.step(), opt.clear_grad()))
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name in PHASES and e.device_type == DeviceType.CPU}
    events = serving_profile.device_events(prof, exclude=PHASES)
    launched = launch_times(prof)
    by_phase = {name: [] for name in PHASES}
    for e in events:
        t = launched.get(e.id)
        phase = next((name for name in PHASES
                      if t is not None and ranges[name].start <= t < ranges[name].end), None)
        if phase is None:
            raise RuntimeError(f"device event {e.name[:80]} has no launch inside a phase")
        by_phase[phase].append(e)
    out = {}
    for name in PHASES:
        inside = by_phase[name]
        out[name] = {"host_ms": ranges[name].elapsed_us() / 1e3,
                     "device_busy_ms": serving_profile.busy_us(inside) / 1e3,
                     "device_events": len(inside),
                     "top_kernels": serving_profile.top_kernels(inside, 8)}
    return {"profile": "one step by phase", "phases": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    print(serving_profile.card_line(), flush=True)
    cfg = chip_smoke.train_config()
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g, device="cuda")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(), weight_decay=0.01)
    step = TrainStep(model, opt, chip_smoke._loss_fn)
    step_ms(step, ids, labels, n=3)  # warm-up
    print(json.dumps({"config": "bench.py flagship, bf16, 8 layers, batch 4 x 1024",
                      "step_ms": step_ms(step, ids, labels)}), flush=True)
    print(json.dumps(profile_steps(step, ids, labels)), flush=True)
    print(json.dumps(profile_phases(model, opt, chip_smoke._loss_fn, ids, labels)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
