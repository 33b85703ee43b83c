#!/usr/bin/env python3
"""Where the port's training time goes on the card.

    python3 tools/profile_torch_training.py [--lora | --gpt [--o1] | --resnet]

Builds the ``chip_smoke.py`` phase-4 configuration (bench.py's flagship
LLaMA, bf16, 8 layers, batch 4 x 1024) with ``TrainStep`` and AdamW,
runs 3 warm-up steps (the first records the step as a CUDA graph), then
prints four JSON lines:

1. ms a step on the host clock over 10 unprofiled steps (graph replays);
2. two ``TrainStep`` steps (replays), then two of its eager body
   (``_eager_step``), each pair under ``torch.profiler``: the time the
   card was busy (kernel, copy and memset events only, overlaps counted
   once) and its share of the profiled wall time, the device events a
   step, and the kernels with the most device time;
3. one step split into its phases (forward and loss, backward,
   ``optimizer.step`` with ``clear_grad``), each under
   ``record_function`` and ended by a synchronise: device ms and events a
   phase, each device event counted in the phase whose host range holds
   its launch (the CUDA runtime call that carries its correlation id), so
   that no clock skew between the host and the card moves an event
   across phases.

With ``--lora`` the model first takes ``chip_smoke.py`` phase 4b's
adapters (``apply_lora``, rank 16, the base frozen) and AdamW trains
them alone, at phase 4b's rate.  With ``--gpt`` the model is phase 4d's
GPT-2 small (f32, dropout 0.1, batch 8 x 1024; ``--o1`` under auto_cast
O1 bf16) with AdamW and ``ClipGradByGlobalNorm(1.0)``, and a fifth line
gives dropout's share: one eager step with each dropout's forward in its
own ``record_function`` range, the device time of the events launched
inside them (the mask's hash and the select) against the step's.  With
``--resnet`` the model is ``chip_smoke.py`` phase 4f's ResNet-50 under
auto_cast O1 bf16 (batch 256 x 3 x 224 x 224, Momentum(0.1),
CrossEntropyLoss; cuDNN's default algorithms), and the recorded graph is
dropped before the eager profiles, whose activations would not fit beside
its pool.  Needs one CUDA card.
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


def profile_steps(step, ids, labels, n=2, top=25, what="TrainStep"):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = step_ms(step, ids, labels, n)
    events = serving_profile.device_events(prof)
    busy_ms = serving_profile.busy_us(events) / 1e3 / n
    if not 0 < busy_ms <= wall_ms:
        raise RuntimeError(f"device busy {busy_ms} ms a step outside (0, wall {wall_ms} ms]")
    return {"profile": f"{n} {what} steps", "profiled_wall_ms_per_step": wall_ms,
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


def profile_dropout(model, opt, loss_fn, ids, labels):
    """One eager step with every dropout forward inside a ``dropout``
    range: device ms and events launched there, against the whole step's
    device ms.  The backward's share (one select a dropout) is not in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.nn.functional import common

    plain = common._dropout

    def ranged(v, **kw):
        with record_function("dropout"):
            return plain(v, **kw)

    common._dropout = ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss_fn(model, ids, labels).backward()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
    finally:
        common._dropout = plain
    ranges = [e.time_range for e in prof.events()
              if e.name == "dropout" and e.device_type == DeviceType.CPU]
    events = serving_profile.device_events(prof, exclude=("dropout",))
    launched = launch_times(prof)
    inside = [e for e in events if launched.get(e.id) is not None
              and any(r.start <= launched[e.id] < r.end for r in ranges)]
    step_busy = serving_profile.busy_us(events) / 1e3
    drop_busy = serving_profile.busy_us(inside) / 1e3
    return {"profile": "dropout's forward in one eager step", "dropouts": len(ranges),
            "dropout_device_ms": drop_busy, "dropout_device_events": len(inside),
            "step_device_busy_ms": step_busy, "dropout_share_of_busy": drop_busy / step_busy,
            "top_kernels": serving_profile.top_kernels(inside, 8)}


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
    if "--resnet" in sys.argv[1:]:
        return resnet_main(chip_smoke)
    if "--gpt" in sys.argv[1:]:
        return gpt_main(chip_smoke, "--o1" in sys.argv[1:])
    cfg = chip_smoke.train_config()
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g, device="cuda")
    lora = "--lora" in sys.argv[1:]
    config = "bench.py flagship, bf16, 8 layers, batch 4 x 1024"
    lr = 1e-4
    if lora:
        from paddle_tpu_torch.nn.lora import apply_lora

        apply_lora(model, rank=chip_smoke.LORA_RANK,
                   generator=torch.Generator(device="cuda").manual_seed(7))
        config += f", apply_lora rank {chip_smoke.LORA_RANK} (the adapters alone train)"
        lr = chip_smoke.LORA_TRAIN_LR
    opt = AdamW(learning_rate=lr, parameters=model.parameters(), weight_decay=0.01)
    step = TrainStep(model, opt, chip_smoke._loss_fn)
    step_ms(step, ids, labels, n=3)  # warm-up
    print(json.dumps({"config": config, "step_ms": step_ms(step, ids, labels)}), flush=True)
    print(json.dumps(profile_steps(step, ids, labels)), flush=True)
    print(json.dumps(profile_steps(step._eager_step, ids, labels, what="eager body")), flush=True)
    print(json.dumps(profile_phases(model, opt, chip_smoke._loss_fn, ids, labels)), flush=True)
    return 0


def gpt_main(chip_smoke, o1) -> int:
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = chip_smoke.gpt_config()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(21))
    g = torch.Generator(device="cuda").manual_seed(22)
    shape = (chip_smoke.GPT_BATCH, chip_smoke.GPT_SEQ)
    ids = torch.randint(0, cfg.vocab_size, shape, generator=g, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, shape, generator=g, device="cuda")
    loss_fn = chip_smoke._amp_loss_fn("bfloat16") if o1 else chip_smoke._loss_fn
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, opt, loss_fn)
    step_ms(step, ids, labels, n=3)  # warm-up
    config = (f"chip_smoke.py phase 4d: GPT-2 small, {'O1 bf16' if o1 else 'f32'}, dropout "
              f"{cfg.dropout}, batch {shape[0]} x {shape[1]}")
    print(json.dumps({"config": config, "step_ms": step_ms(step, ids, labels)}), flush=True)
    print(json.dumps(profile_steps(step, ids, labels)), flush=True)
    print(json.dumps(profile_steps(step._eager_step, ids, labels, what="eager body")), flush=True)
    print(json.dumps(profile_phases(model, opt, loss_fn, ids, labels)), flush=True)
    print(json.dumps(profile_dropout(model, opt, loss_fn, ids, labels)), flush=True)
    return 0


def resnet_main(chip_smoke) -> int:
    import gc

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(device="cuda", generator=torch.Generator(device="cuda").manual_seed(31))
    g = torch.Generator(device="cuda").manual_seed(32)
    batch = chip_smoke.RESNET_BATCH
    images = torch.randn(batch, 3, 224, 224, generator=g, device="cuda")
    labels = torch.randint(0, 1000, (batch,), generator=g, device="cuda", dtype=torch.int32)
    loss_fn = chip_smoke._resnet_loss_fn(True)
    opt = Momentum(0.1, parameters=model.parameters())
    step = TrainStep(model, opt, loss_fn)
    step_ms(step, images, labels, n=3)  # warm-up: the first call records the step
    config = f"chip_smoke.py phase 4f: ResNet-50, O1 bf16, batch {batch} x 3 x 224 x 224"
    print(json.dumps({"config": config, "step_ms": step_ms(step, images, labels),
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    print(json.dumps(profile_steps(step, images, labels)), flush=True)
    step._steps.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(profile_steps(step._eager_step, images, labels, what="eager body")),
          flush=True)
    print(json.dumps(profile_phases(model, opt, loss_fn, images, labels)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
