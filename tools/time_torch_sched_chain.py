#!/usr/bin/env python3
"""Time the schedule-searched subgraph kernels (#12 whole K, #13 split K)
of one checkout on the card.

    python3 tools/time_torch_sched_chain.py [ROOT] [TAG] [ROUNDS]

ROOT is the root of a checkout of this repository (default: this one), so
that two versions can be compared in one call on one card, in turns:

    python3 tools/time_torch_sched_chain.py build/parent parent 5
    python3 tools/time_torch_sched_chain.py . change 5
    python3 tools/time_torch_sched_chain.py . change 5
    python3 tools/time_torch_sched_chain.py build/parent parent 5

At chip_smoke.py's five cases (bench_schedule_search.py's three programs
at its chip shapes, BERT-base's pooler and attention logits), each
checkout's own schedule space: every enumerated config is first held
against the replay of the recorded ops (the parity gate's tolerance),
then ROUNDS (default 5) rounds time every config, the plain twin and, for
the matmul cases, ``torch.addmm`` of the product plus bias alone (TF32
off; a yardstick the port never calls), the order reversed every other
round.  Prints one JSON line per (case, config) with the median, the
least and the most microseconds over the rounds, a line per case with
the best whole-K and the best split config, and the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them.  CUDA events around each call, the L2
flushed before it and the launch enqueued behind a spin on the card, as
chip_smoke.py times.  Builds the checkout's generated sources into its
own build/kernels/codegen/ (one nvcc each, all together) and prints each
source's registers and spills from ``-Xptxas -v``.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

CASES = {  # chip_smoke.py's SCHED_CASES
    "softmax_f32": ("softmax", [("x", (8, 128, 512), "float32")]),
    "pooler_bf16": ("pooler", [("x", (32, 768), "bfloat16"), ("w", (768, 768), "bfloat16"),
                               ("b", (768,), "bfloat16")]),
    "softmax_bf16": ("softmax", [("x", (32, 12, 128, 128), "bfloat16")]),
    "matmul_mean_f32": ("matmul_mean", [("x", (1024, 512), "float32"),
                                        ("w", (512, 512), "float32"), ("b", (512,), "float32")]),
    "ktiled_f32": ("relu_linear", [("x", (1024, 2048), "float32"),
                                   ("w", (2048, 1024), "float32"), ("b", (1024,), "float32")]),
}


def _chains():
    from paddle_tpu_torch.nn import functional as PF

    def softmax(x):
        t = torch.exp(x - torch.max(x, -1, keepdim=True).values)
        return t / torch.sum(t, -1, keepdim=True)

    return {"softmax": softmax,
            "pooler": lambda x, w, b: PF.tanh(PF.linear(x, w, b)),
            "matmul_mean": lambda x, w, b: torch.mean(torch.relu(torch.matmul(x, w) + b), -1,
                                                      keepdim=True),
            "relu_linear": lambda x, w, b: torch.relu(torch.matmul(x, w) + b)}


def _spec(build, feeds):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import schedule_search as ss
    from paddle_tpu_torch.static.rewrite import ProgramGraph

    main = static.Program()
    with static.program_guard(main):
        out = build(*[static.data(n, list(s), d) for n, s, d in feeds])
    graph = ProgramGraph(main, (out._vid,))
    (spec,) = [sp for sp in (ss.match_subgraph(op, graph, device=torch.device("cuda"))
                             for op in main.global_block().ops) if sp]
    return spec


def _timer(flush):
    def time_us(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for s, e in zip(starts, ends):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters * 1e3

    return time_us


def _ptxas(log):
    """(registers min, max) and spill bytes of a source's kernels."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
    return {"kernels": len(regs), "registers": [min(regs), max(regs)] if regs else None,
            "spill_bytes": spills}


def main() -> int:
    args = sys.argv[1:]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    tag = args[1] if len(args) > 1 else str(root)
    rounds = int(args[2]) if len(args) > 2 else 5
    if not torch.cuda.is_available():
        print("time_torch_sched_chain: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root.resolve()))
    from paddle_tpu_torch.ops import _cuda_build
    from paddle_tpu_torch.static.schedule_search import parity_tolerance

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chains = _chains()
    specs = {name: _spec(chains[kind], feeds) for name, (kind, feeds) in CASES.items()}
    built = _cuda_build.build_generated([sp.source() for sp in specs.values()])
    for name, sp in specs.items():
        info = built[str(_cuda_build.generated_path(sp.source()))]
        print(json.dumps({"tag": tag, "card": card, "case": name, "nvcc_s": info["seconds"],
                          **_ptxas(info["log"])}), flush=True)
    time_us = _timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    with torch.no_grad():
        for name, sp in specs.items():
            args_ = sp.synthetic_args()
            want = sp.reference()(*args_)
            rtol, atol = parity_tolerance(sp.out_dtype, want)
            runs = {}
            for cfg in sp.enumerate_configs():
                fn = sp.build(cfg)
                got = fn(*args_)
                if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol,
                                      equal_nan=True):
                    raise AssertionError(f"{name} {sp.config_label(cfg)} disagrees with the "
                                         f"replay: {float((got.float() - want.float()).abs().max())}")
                split = bool(cfg.get("block_k")) and cfg["block_k"] < sp.k_dims[0]
                runs[sp.config_label(cfg)] = (fn, split)
            runs["plain"] = (sp.reference(), None)
            if sp.kind == "matmul":
                x = next(a for a, e in zip(args_, sp.ext) if e.role == "xrow")
                w = next(a for a, e in zip(args_, sp.ext) if e.role == "weight")
                b = next(a for a, e in zip(args_, sp.ext) if e.role == "bcast")
                runs["torch.addmm"] = (lambda *_, x=x, w=w, b=b: torch.addmm(b, x, w), None)
            order = list(runs)
            times = {k: [] for k in order}
            for r in range(rounds):
                for label in (order if r % 2 == 0 else order[::-1]):
                    fn, _ = runs[label]
                    times[label].append(time_us(lambda fn=fn: fn(*args_)))
            rows = []
            for label in order:
                t = times[label]
                rows.append({"tag": tag, "card": card, "case": name, "config": label,
                             "split": runs[label][1], "median_us": statistics.median(t),
                             "min_us": min(t), "max_us": max(t), "rounds": rounds})
                print(json.dumps(rows[-1]), flush=True)
            best = {}
            for kind, pick in (("whole", False), ("split", True)):
                mine = [r for r in rows if r["split"] is pick]
                if mine:
                    top = min(mine, key=lambda r: r["median_us"])
                    best[kind] = {"config": top["config"], "median_us": top["median_us"]}
            print(json.dumps({"tag": tag, "card": card, "case": name, "best": best,
                              "plain_us": statistics.median(times["plain"]),
                              "addmm_us": (statistics.median(times["torch.addmm"])
                                           if "torch.addmm" in times else None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
