#!/usr/bin/env python3
"""Repeated-run timer of the port's hot steps on the card, eager against
captured (CUDA graphs), in one call.

    python3 tools/time_torch_steps.py [ROUNDS]      (default 10)

Workloads (``chip_smoke.py``'s configurations, seeded random weights):

- the decode step of D = 8 tokens for 4 resident requests on LLaMA-7B at
  full width and depth, bf16: the default engine, the chained bf16 and
  the chained int8 engine (``prefill_chunk=128``, FLAGS_schedule_search
  on with a fresh verdict cache, so their warm-up pass searches both
  serving chains and the run fails unless both are accepted);
- the speculative tick (K = 4, ``chip_smoke.py`` phase 3c) for the same 4
  requests on the same model: the model as its own draft, and the 2-layer
  early-exit draft;
- BERT-base's static batch, 32 x 128 bf16 ids with ragged padding,
  through ``static.Executor``: the fused program, and the same after
  ``generic_elementwise_fusion`` with FLAGS_schedule_search on;
- the flagship training step (bench.py's configuration, 4 x 1024 tokens,
  AdamW): TrainStep's eager body and its recorded step (``warmup()``).

Each workload runs ROUNDS samples eager (the engine's ``_step_eager``, the
Executor's ``_run_eager``, TrainStep's ``_eager_step``: every op launched
from the host) and ROUNDS captured (``step()`` / ``run()`` / the
TrainStep: one graph replay), in turns: eager then captured in even
rounds, captured then eager in odd ones.  A serving sample is one
``step()`` (host clock; the step ends in its device-to-host copy); a
static sample is 10 runs and a training sample one step, each ended by
``torch.cuda.synchronize()``.  Then one
more sample of each mode runs under ``torch.profiler`` for the device's
busy time (kernel, copy and memset events, overlaps once), whose share is
taken of the unprofiled median.  Prints the card's name and power limit,
one JSON line per workload and mode (median, quartiles, min, max, every
sample, busy share, device events) and a table of the medians.  Needs
one CUDA card.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

import profile_torch_serving as serving_profile

ROOT = Path(__file__).resolve().parents[1]
STATIC_RUNS = 10  # runs a static sample


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _busy(fn):
    """(device busy ms, device events) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _timed(fn)
    events = serving_profile.device_events(prof)
    return serving_profile.busy_us(events) / 1e3, len(events)


def _row(workload, mode, samples, fn, per=1):
    """One JSON line: the samples' statistics (each sample over ``per``
    units: ms a unit) and the device busy share of one profiled call."""
    ms = [s / per for s in samples]
    q1, med, q3 = statistics.quantiles(ms, n=4, method="inclusive")
    busy, events = _busy(fn)
    row = {"workload": workload, "mode": mode, "samples": len(ms), "median_ms": med,
           "q1_ms": q1, "q3_ms": q3, "iqr_ms": q3 - q1, "min_ms": min(ms), "max_ms": max(ms),
           "samples_ms": ms, "device_busy_ms": busy / per,
           "device_busy_share": busy / per / med, "device_events": events / per}
    print(json.dumps(row), flush=True)
    return row


def _interleaved(rounds, eager, graphed):
    """ROUNDS samples of each, in turns (eager first in even rounds)."""
    out = {"eager": [], "graphed": []}
    for r in range(rounds):
        order = (("eager", eager), ("graphed", graphed))
        for mode, fn in (order if r % 2 == 0 else order[::-1]):
            out[mode].append(fn())
    return out


def time_decode(chip_smoke, model, rounds, kv, rows):
    """The D = 8 decode step of the default (``kv`` None) or a chained
    engine, 4 requests resident for every sample."""
    from paddle_tpu_torch import set_flags

    kw = chip_smoke.CHAINED[kv] if kv else {}
    cache_dir = tempfile.mkdtemp(prefix="autotune-")
    if kv:
        set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": cache_dir})
    try:
        _, engine, prompts, _ = chip_smoke.build_engine(model, **kw)
        with torch.no_grad():
            for rid, p in prompts.items():  # every kernel built, the searches run
                engine.add_request("warm-" + rid, p, max_new_tokens=2)
            while engine.has_work():
                engine._step_eager()
            if kv and not (engine._decode_chain_cfg and engine._prefill_chain_cfg):
                raise RuntimeError(f"{kv}: a serving chain lost the measured-win gate: "
                                   f"{engine.decode_decision} {engine.prefill_decision}")
            warm = engine.warmup()
            d = engine._effective_chunk()
            new = (2 * rounds + 4) * d + 1  # no request finishes while samples run
            for rid, p in prompts.items():
                engine.add_request(rid, p, max_new_tokens=new)

            def step(fn):
                t0 = time.perf_counter()
                out = fn()
                ms = (time.perf_counter() - t0) * 1e3
                if len(out) != len(prompts):
                    raise RuntimeError(f"a request finished while timing: {sorted(out)}")
                return ms

            samples = _interleaved(rounds, lambda: step(engine._step_eager),
                                   lambda: step(engine.step))
            name = (f"decode step D={d} batch 4, "
                    + (f"chained {kv} ({engine._decode_chain_cfg})" if kv else "default"))
            for mode, fn in (("eager", engine._step_eager), ("graphed", engine.step)):
                row = _row(name, mode, samples[mode], fn)
                if mode == "graphed":
                    captured = engine._step_fns[d]
                    row.update(warmup_s=warm["seconds"], capture_s=captured.capture_s,
                               graph_bytes=captured.graph_bytes)
                    print(json.dumps({"workload": name, "warmup_s": warm["seconds"],
                                      "capture_s": captured.capture_s,
                                      "graph_bytes": captured.graph_bytes}), flush=True)
                rows.append(row)
    finally:
        set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
        shutil.rmtree(cache_dir, ignore_errors=True)


def time_spec(chip_smoke, model, rounds, tag, rows):
    """The speculative tick of 4 resident requests, with the model as its
    own draft (``tag`` "self") or the early-exit draft."""
    draft = model if tag == "self" else chip_smoke.early_exit_draft(
        model, chip_smoke.SPEC_DRAFT_LAYERS)
    engine = chip_smoke._spec_engine(model, draft)
    prompts = chip_smoke.serving_prompts(model.config)
    with torch.no_grad():
        # no request finishes while samples run: 2 ROUNDS + 8 ticks of up
        # to K + 1 tokens, the warm-up and the profiled ticks included
        new = (2 * rounds + 8) * (chip_smoke.SPEC_K + 1) + 1
        for rid, p in prompts.items():
            engine.add_request(rid, p, max_new_tokens=new)
        engine.step()  # the capture
        engine._step_eager()

        def tick(fn):
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1e3
            if len(out) != len(prompts):
                raise RuntimeError(f"a request finished while timing: {sorted(out)}")
            return ms

        before = engine.spec_stats()
        samples = _interleaved(rounds, lambda: tick(engine._step_eager),
                               lambda: tick(engine.step))
        stats = {k: v - before[k] for k, v in engine.spec_stats().items()}
        name = (f"speculative tick K={chip_smoke.SPEC_K} batch 4, draft "
                + ("self" if tag == "self" else f"early exit {chip_smoke.SPEC_DRAFT_LAYERS} layers"))
        for mode, fn in (("eager", engine._step_eager), ("graphed", engine.step)):
            row = _row(name, mode, samples[mode], fn)
            row.update(acceptance=stats["accepted"] / stats["proposed"],
                       tokens_per_lane_tick=stats["emitted"] / (stats["ticks"] * len(prompts)))
            if mode == "graphed":
                row.update(capture_s=engine._spec_fn.capture_s,
                           graph_bytes=engine._spec_fn.graph_bytes)
            print(json.dumps({k: row[k] for k in ("workload", "mode", "acceptance",
                                                   "tokens_per_lane_tick", "capture_s",
                                                   "graph_bytes") if k in row}), flush=True)
            rows.append(row)


def time_static(chip_smoke, rounds, rows):
    """BERT-base's static batch, fused and with the codegen passes."""
    from paddle_tpu_torch import set_flags, static
    from paddle_tpu_torch.models import BertConfig, BertForSequenceClassification
    from paddle_tpu_torch.ops import autotune as at

    cfg = BertConfig()
    model = BertForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(13)).to(torch.bfloat16).eval()
    (ids,) = chip_smoke.bert_batches(cfg, 1, torch.Generator(device="cuda").manual_seed(14))
    feed = {"ids": ids}
    for codegen in (False, True):
        prog, logits = chip_smoke.capture_bert(model)
        verdicts = tempfile.mkdtemp(prefix="autotune-")
        if codegen:
            static.passes.apply_pass(prog, "generic_elementwise_fusion",
                                     fetch_vids=[logits._vid])
            set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": verdicts})
            at._CACHES.clear()
        try:
            exe = static.Executor()

            def graphed():
                for _ in range(STATIC_RUNS):
                    exe.run(prog, feed=feed, fetch_list=[logits], return_numpy=False)

            def eager():
                for _ in range(STATIC_RUNS):
                    exe._run_eager(prog, feed=feed, fetch_list=[logits])

            for fn in (graphed, eager, graphed, eager):  # the search, the capture, warm
                fn()
            (got,) = exe.run(prog, feed=feed, fetch_list=[logits], return_numpy=False)
            (want,) = exe._run_eager(prog, feed=feed, fetch_list=[logits])
            if not torch.equal(got, want):
                raise RuntimeError("static BERT: the replay differs from the eager run")
            samples = _interleaved(rounds, lambda: _timed(eager), lambda: _timed(graphed))
            name = ("static BERT-base 32 x 128"
                    + (", + codegen passes" if codegen else ", PallasFusionPass"))
            for mode, fn in (("eager", eager), ("graphed", graphed)):
                rows.append(_row(name, mode, samples[mode], fn, per=STATIC_RUNS))
        finally:
            set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
            at._CACHES.clear()
            shutil.rmtree(verdicts, ignore_errors=True)


def time_training(chip_smoke, rounds, rows):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = chip_smoke.train_config()
    model = LlamaForCausalLM(cfg, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (4, 1024), generator=g, device="cuda")
    step = TrainStep(model, AdamW(learning_rate=1e-4, parameters=model.parameters(),
                                  weight_decay=0.01), chip_smoke._loss_fn)
    for _ in range(3):
        step._eager_step(ids, labels)
    step.warmup(ids, labels)
    step(ids, labels)
    samples = _interleaved(rounds, lambda: _timed(lambda: step._eager_step(ids, labels)),
                           lambda: _timed(lambda: step(ids, labels)))
    captured = next(iter(step._steps.values())).step
    for mode, fn in (("eager", lambda: step._eager_step(ids, labels)),
                     ("graphed", lambda: step(ids, labels))):
        row = _row("training step, flagship, 4 x 1024", mode, samples[mode], fn)
        if mode == "graphed":
            row.update(capture_s=captured.capture_s, graph_bytes=captured.graph_bytes)
            print(json.dumps({k: row[k] for k in ("workload", "mode", "capture_s",
                                                   "graph_bytes")}), flush=True)
        rows.append(row)


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    if not torch.cuda.is_available():
        print("time_torch_steps: no CUDA device", file=sys.stderr)
        return 2
    if rounds < 2:
        print("time_torch_steps: ROUNDS must be at least 2", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    card = serving_profile.card_line()
    print(card, flush=True)
    rows = []
    model = chip_smoke.build_model()
    for kv in (None, "bf16", "int8"):
        time_decode(chip_smoke, model, rounds, kv, rows)
    for tag in ("self", "early_exit"):
        time_spec(chip_smoke, model, rounds, tag, rows)
        gc.collect()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    time_static(chip_smoke, rounds, rows)
    time_training(chip_smoke, rounds, rows)
    print(f"\n{card}; medians of {rounds} samples (q1-q3), ms")
    print("| workload | mode | median | q1-q3 | min-max | device busy | busy share |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for r in rows:
        print(f"| {r['workload']} | {r['mode']} | {r['median_ms']} | {r['q1_ms']}-{r['q3_ms']} "
              f"| {r['min_ms']}-{r['max_ms']} | {r['device_busy_ms']} "
              f"| {r['device_busy_share']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
