#!/usr/bin/env python3
"""Where the port's static BERT time goes on the card.

    python3 tools/profile_torch_static_bert.py [--train]

Builds the ``chip_smoke.py`` phase-5 configuration (BERT-base, bf16,
batch 32 x 128 with ragged padding), captures it twice as a static
Program, and for six ways of running the same batch (the fused program
through ``static.Executor``, captured as a CUDA graph and replayed, and
the same through ``Executor._run_eager``, op by op; the same two after
``generic_elementwise_fusion`` with FLAGS_schedule_search on (a fresh
verdict cache: the first warm-up run searches); the unfused program with
FLAGS_use_pallas_fusion off, replayed; the eager forward of the model)
prints one JSON line
each: ms a batch on the host clock over 10 unprofiled runs after 3
warm-up runs, and two runs under ``torch.profiler``: the time the card
was busy (kernel, copy and memset events only, overlaps counted once),
its share of the unprofiled wall, the device events a run and the
kernels with the most device time.

``--train`` profiles the training cells instead (``chip_smoke.py``
phases 5b and 5c): the static train step (bf16, AdamW, dropout 0.1,
``AdamW.minimize`` in the Program) replayed and through
``Executor._run_eager``, and ``jit.TrainStep`` on the f32 model under
O1, recorded and eager; the same columns as above.

Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

import profile_torch_serving as serving_profile

ROOT = Path(__file__).resolve().parents[1]


def run_ms(fn, n=10):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def profile_runs(name, fn, n=2, top=12):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    wall_ms = run_ms(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_ms(fn, n)
    events = serving_profile.device_events(prof)
    busy_ms = serving_profile.busy_us(events) / 1e3 / n
    if not 0 < busy_ms <= wall_ms:
        raise RuntimeError(f"{name}: device busy {busy_ms} ms a run outside (0, {wall_ms}]")
    return {"run": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "device_events_per_run": len(events) / n,
            "top_kernels": serving_profile.top_kernels(events, top, per=n)}


def train_rows(chip_smoke):
    """The training cells' rows (``--train``)."""
    from paddle_tpu_torch import amp, static
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import BertConfig, BertForSequenceClassification
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig()
    g = torch.Generator(device="cuda").manual_seed(22)
    (ids,), (labels,) = chip_smoke.bert_batches(cfg, 1, g), chip_smoke.bert_labels(1, g)
    model = BertForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(21)).to(torch.bfloat16)
    main_prog, loss = chip_smoke._bert_train_program(model, chip_smoke.BERT_TRAIN_LR)
    exe = static.Executor()
    feed = {"ids": ids, "labels": labels}
    with static.scope_guard(static.Scope()):
        print(json.dumps(profile_runs("static train step (bf16, AdamW.minimize), graphed",
                                      lambda: exe.run(main_prog, feed=feed, fetch_list=[loss],
                                                      return_numpy=False))), flush=True)
        print(json.dumps(profile_runs("static train step (bf16, AdamW.minimize), eager",
                                      lambda: exe._run_eager(main_prog, feed=feed,
                                                             fetch_list=[loss]))), flush=True)
    del exe, main_prog, model
    torch.cuda.empty_cache()
    model = BertForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(23))

    def loss_fn(m, i, l):
        with amp.auto_cast(True, dtype="bfloat16"):
            return m(i, labels=l)[0]

    step = TrainStep(model, AdamW(chip_smoke.BERT_TRAIN_LR, parameters=model.parameters()),
                     loss_fn)
    print(json.dumps(profile_runs("TrainStep f32 under O1, recorded",
                                  lambda: step(ids, labels))), flush=True)
    print(json.dumps(profile_runs("TrainStep f32 under O1, eager",
                                  lambda: step._eager_step(ids, labels))), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_static_bert: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if "--train" in sys.argv[1:]:
        print(serving_profile.card_line(), flush=True)
        return train_rows(chip_smoke)
    from paddle_tpu_torch import set_flags, static
    from paddle_tpu_torch.models import BertConfig, BertForSequenceClassification

    print(serving_profile.card_line(), flush=True)
    cfg = BertConfig()
    model = BertForSequenceClassification(
        cfg, num_classes=2, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(13)).to(torch.bfloat16).eval()
    main_prog, logits = chip_smoke.capture_bert(model)
    plain_prog, plain_logits = chip_smoke.capture_bert(model)
    gen_prog, gen_logits = chip_smoke.capture_bert(model)
    static.passes.apply_pass(gen_prog, "generic_elementwise_fusion",
                             fetch_vids=[gen_logits._vid])
    (ids,) = chip_smoke.bert_batches(cfg, 1, torch.Generator(device="cuda").manual_seed(14))
    exe = static.Executor()

    def fused():
        exe.run(main_prog, feed={"ids": ids}, fetch_list=[logits], return_numpy=False)

    def fused_eager():
        exe._run_eager(main_prog, feed={"ids": ids}, fetch_list=[logits])

    def codegen():
        exe.run(gen_prog, feed={"ids": ids}, fetch_list=[gen_logits], return_numpy=False)

    def codegen_eager():
        exe._run_eager(gen_prog, feed={"ids": ids}, fetch_list=[gen_logits])

    def unfused():
        exe.run(plain_prog, feed={"ids": ids}, fetch_list=[plain_logits], return_numpy=False)

    def eager():
        with torch.no_grad():
            model(ids)

    print(json.dumps(profile_runs("static program, PallasFusionPass, graphed", fused)),
          flush=True)
    print(json.dumps(profile_runs("static program, PallasFusionPass, eager", fused_eager)),
          flush=True)
    with tempfile.TemporaryDirectory() as verdicts:
        set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": verdicts})
        try:
            row = profile_runs("static program, PallasFusionPass + codegen passes, graphed",
                               codegen)
            print(json.dumps(row), flush=True)
            row = profile_runs("static program, PallasFusionPass + codegen passes, eager",
                               codegen_eager)
        finally:
            set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
    row["op_types"] = sorted({op.type for op in gen_prog.global_block().ops
                              if op.type.startswith(("vpu_chain", "sched_chain"))})
    print(json.dumps(row), flush=True)
    set_flags({"FLAGS_use_pallas_fusion": False})
    try:
        print(json.dumps(profile_runs("static program, unfused", unfused)), flush=True)
    finally:
        set_flags({"FLAGS_use_pallas_fusion": True})
    print(json.dumps(profile_runs("eager forward", eager)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
