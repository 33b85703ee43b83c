#!/usr/bin/env python3
"""Time design variants of the schedule-searched matmul kernels
(csrc/codegen/sched_chain.cuh) on the card: the kept template against
copies of it with one choice undone.

    python3 tools/time_torch_sched_variants.py [ROUNDS]

Each variant is the kept header with one text substitution, written with
the other templates into build/kernels/variants/<name>/ and compiled into
its own library directory with the same nvcc flags (one nvcc per
generated source and variant, all started together):

- ``w3``: the f32 product keeps three stages of w in flight (two kept);
- ``bk16`` / ``bk32``: the f32 k-step 16 or 32 deep at every width
  below 1,024 columns (kept: 32, but 16 for 8 x 8 tiles of 512 columns);
- ``warp4x8``: a warp's threads laid out 4 x 8 over the f32 thread grid
  (kept: along the row of the grid);
- ``ring2``: the bf16 product's copy ring two stages deep (kept: up to
  four).

At chip_smoke.py's pooler_bf16, matmul_mean_f32 and ktiled_f32 cases,
every enumerated config of each variant is first held against the replay
(the parity gate's tolerance), then ROUNDS (default 2) rounds time every
(variant, config), the order reversed every other round: CUDA events
around each call, the L2 flushed before it, the launch enqueued behind a
spin on the card (chip_smoke.py's Timer).  Prints one JSON line per
(case, variant, config) with the median and the spread, each source's
registers and spills from ``-Xptxas -v``, and the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

CASES = ("pooler_bf16", "matmul_mean_f32", "ktiled_f32")
_TXY = "  const int tx = threadIdx.x % T::kThN, ty = threadIdx.x / T::kThN;\n"
_TXY_4X8 = """  constexpr int kWM = T::kThM < 4 ? T::kThM : 4, kWN = 32 / kWM, kWarpsN = T::kThN / kWN;
  const int lane_ = threadIdx.x & 31, warp_ = threadIdx.x >> 5;
  const int tx = (warp_ % kWarpsN) * kWN + lane_ % kWN;
  const int ty = (warp_ / kWarpsN) * kWM + lane_ / kWN;
"""
_BK = "  static constexpr int kBK = BN >= 1024 ? 8 : BN >= 512 && kOut == 64 ? 16 : 32;"
VARIANTS = {
    "kept": [],
    "w3": [("  static constexpr int kStages = 2;", "  static constexpr int kStages = 3;")],
    "bk16": [(_BK, "  static constexpr int kBK = BN >= 1024 ? 8 : 16;")],
    "bk32": [(_BK, "  static constexpr int kBK = BN >= 1024 ? 8 : 32;")],
    "warp4x8": [(_TXY, _TXY_4X8)],
    "ring2": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 2;")],
}


def _variant_dir(name, subs):
    """build/kernels/variants/<name>/codegen: the templates with ``subs``
    applied to sched_chain.cuh, beside a copy of csrc/*.cuh."""
    from paddle_tpu_torch.ops import _cuda_build

    base = _cuda_build.BUILD_DIR / "variants" / name
    shutil.rmtree(base, ignore_errors=True)
    (base / "codegen").mkdir(parents=True)
    for h in _cuda_build.CSRC.glob("*.cuh"):
        shutil.copy(h, base / h.name)
    for h in (_cuda_build.CSRC / "codegen").glob("*.cuh"):
        text = h.read_text()
        if h.name == "sched_chain.cuh":
            for old, new in subs:
                if old not in text:
                    raise AssertionError(f"variant {name}: {old!r} is not in the kept header")
                text = text.replace(old, new)
        (base / "codegen" / h.name).write_text(text)
    return base


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    if not torch.cuda.is_available():
        print("time_torch_sched_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import time_torch_sched_chain as sched

    from paddle_tpu_torch.ops import _cuda_build
    from paddle_tpu_torch.static.schedule_search import parity_tolerance

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chains = sched._chains()
    specs = {n: sched._spec(chains[sched.CASES[n][0]], sched.CASES[n][1]) for n in CASES}
    kept_dir, kept_flags = _cuda_build.GEN_DIR, list(_cuda_build.GEN_FLAGS)
    setups, procs = {}, []
    for name, subs in VARIANTS.items():
        base = _variant_dir(name, subs)
        flags = kept_flags[:-4] + ["-I", str(base / "codegen"), "-I", str(base)]
        setups[name] = (base / "lib", flags)
        (base / "lib").mkdir()
        for case, sp in specs.items():
            _cuda_build.GEN_DIR, _cuda_build.GEN_FLAGS = base / "lib", flags
            lib = _cuda_build.generated_path(sp.source())
            cu = lib.with_suffix(".cu")
            cu.write_text(sp.source())
            cmd = [_cuda_build._nvcc(), *flags, "-o", str(lib), str(cu)]
            procs.append((name, case, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True)))
    for name, case, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}, case {case}:\n{log}")
        print(json.dumps({"card": card, "variant": name, "case": case,
                          **sched._ptxas(log)}), flush=True)
    time_us = sched._timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    try:
        with torch.no_grad():
            for case, sp in specs.items():
                args = sp.synthetic_args()
                want = sp.reference()(*args)
                rtol, atol = parity_tolerance(sp.out_dtype, want)
                runs = {}
                for name, (libdir, flags) in setups.items():
                    _cuda_build.GEN_DIR, _cuda_build.GEN_FLAGS = libdir, flags
                    for cfg in sp.enumerate_configs():
                        fn = sp.build(cfg)
                        got = fn(*args)  # resolves the variant's library now
                        if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
                            raise AssertionError(f"{case} {name} {sp.config_label(cfg)} "
                                                 "disagrees with the replay")
                        runs[name, sp.config_label(cfg)] = fn
                times = {k: [] for k in runs}
                order = list(runs)
                for r in range(rounds):
                    for k in (order if r % 2 == 0 else order[::-1]):
                        times[k].append(time_us(lambda fn=runs[k]: fn(*args)))
                for (name, label), t in times.items():
                    print(json.dumps({"card": card, "case": case, "variant": name,
                                      "config": label, "median_us": statistics.median(t),
                                      "spread_us": max(t) - min(t), "rounds": rounds}),
                          flush=True)
    finally:
        _cuda_build.GEN_DIR, _cuda_build.GEN_FLAGS = kept_dir, kept_flags
    return 0


if __name__ == "__main__":
    sys.exit(main())
