#!/usr/bin/env python3
"""Time the generated elementwise-chain kernel (#11) of one checkout on the
card, and hold its outputs bit for bit against another checkout's.

    python3 tools/time_torch_vpu_chain.py [ROOT] [TAG] [ROUNDS]

ROOT is the root of a checkout of this repository (default: this one), so
that two versions can be compared in one call on one card, in turns:

    python3 tools/time_torch_vpu_chain.py build/parent parent 3
    python3 tools/time_torch_vpu_chain.py . change 3
    python3 tools/time_torch_vpu_chain.py . change 3
    python3 tools/time_torch_vpu_chain.py build/parent parent 3

At chip_smoke.py's three elementwise cases (tools/time_torch_vpu_variants.py
``cases``: the same seeded inputs in every run), each checkout's kernel at
its default launch config: ROUNDS (default 3) rounds time it and the plain
replay under chip_smoke.py's timer (CUDA events around each call, the L2
flushed before it, the launch enqueued behind a spin); one JSON line per
case gives the medians and the least and most microseconds.  Also the
host microseconds a call of the mask chain's kernel (the median of 1,000
calls, each timed on the host clock, nothing synchronised between them;
five such batches, the card synchronised between batches).
Each run saves its outputs under build/vpu_chain_outputs/TAG.pt and
checks them bit for bit against every other tag's saved there (the
directory is emptied by the first run of a call: pass ``--fresh``).
Prints the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.  Needs
one CUDA card.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "vpu_chain_outputs"


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--fresh"]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1]).resolve()
    tag = args[1] if len(args) > 1 else str(root)
    rounds = int(args[2]) if len(args) > 2 else 3
    if not torch.cuda.is_available():
        print("time_torch_vpu_chain: needs a CUDA card", file=sys.stderr)
        return 2
    if "--fresh" in sys.argv:
        shutil.rmtree(OUT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(root))
    import time_torch_vpu_variants as vv

    from paddle_tpu_torch.ops import _cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    case_defs = vv.cases()
    kernels = {name: vv.capture(build, feeds) for name, (build, feeds, _) in case_defs.items()}
    _cuda_build.build_generated([k.source for k in kernels.values()])
    time_us = vv.timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    outputs = {}
    with torch.no_grad():
        for name, (_, _, inputs) in case_defs.items():
            kernel = kernels[name]
            outputs[name] = kernel(*inputs).cpu()
            runs = {"kernel": lambda k=kernel, i=inputs: k(*i),
                    "plain": lambda k=kernel, i=inputs: k.replay(*i)}
            times = {k: [] for k in runs}
            for r in range(rounds):
                for key in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                    times[key].append(time_us(runs[key]))
            row = {"tag": tag, "card": card, "case": name,
                   "launch": list(kernel.default_launch()), "rounds": rounds}
            for key, t in times.items():
                row.update({f"{key}_median_us": statistics.median(t), f"{key}_min_us": min(t),
                            f"{key}_max_us": max(t)})
            print(json.dumps(row), flush=True)
        kernel, inputs = kernels["bert_mask"], case_defs["bert_mask"][2]
        for _ in range(50):
            kernel(*inputs)
        torch.cuda.synchronize()
        batches = []
        for _ in range(5):
            host = []
            for _ in range(1000):
                t0 = time.perf_counter_ns()
                kernel(*inputs)
                host.append((time.perf_counter_ns() - t0) / 1e3)
            torch.cuda.synchronize()
            batches.append(host)
    torch.save(outputs, OUT_DIR / f"{tag}.pt")
    equal = {}
    for other in sorted(OUT_DIR.glob("*.pt")):
        if other.stem == tag:
            continue
        theirs = torch.load(other)
        equal[other.stem] = {name: bool(torch.equal(outputs[name].view(torch.uint8),
                                                    theirs[name].view(torch.uint8)))
                             for name in outputs}
    print(json.dumps({"tag": tag, "card": card, "host_us_a_call_bert_mask": {
        "median_of_each_1000": [statistics.median(h) for h in batches],
        "min": min(min(h) for h in batches)}, "bit_equal_to": equal}), flush=True)
    if not all(all(v.values()) for v in equal.values()):
        print(f"time_torch_vpu_chain: outputs differ from another tree's: {equal}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
