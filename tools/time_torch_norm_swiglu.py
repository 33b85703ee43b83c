#!/usr/bin/env python3
"""Time the port's RMSNorm and SwiGLU on the card: csrc/norm_swiglu.cu's
kernels against the Triton kernels they replaced, in turns.

    python3 tools/time_torch_norm_swiglu.py [ROUNDS]

At every shape the main paths give them (chip_smoke.py phase 2): RMSNorm
bf16 at [4 | 128 | 640 | 1024, 4096] and [4096, 2048], with and without
the residual; SwiGLU bf16 on the halves of one gate_up projection at
[4 | 128 | 640 | 1024, 11008] and [4096, 5632].  Each round times, one
after the other on the same inputs, the CUDA kernel as launched, the
Triton yardstick, one torch op that moves the same bytes (``copy``: a
copy of x for RMSNorm without the residual, a product of contiguous
halves for SwiGLU); ROUNDS (default 2) rounds, the order reversed every other round.  Every output
is first held against the plain version (2e-2; the residual sum
bit-exact).  Also, once a round: an empty kernel under the same timer
(floor) and, at the decode shapes, each kernel's queued cost a launch
(100 launches enqueued behind a spin on the card, events around the
batch, the L2 warm).

Prints one JSON line per (case, variant, round) with the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, the microseconds and the case's least
time (bytes: each input read once, each output written once, over 3.35
TB/s).  CUDA events around each call, the L2 flushed before it and the
launch enqueued behind a spin on the card (chip_smoke.py's Timer and
queued_ms).  Builds the kernels into build/kernels/ at first use.  Needs
one CUDA card.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12
ROOT = Path(__file__).resolve().parents[1]
RMS_SHAPES = [(4, 4096), (128, 4096), (640, 4096), (1024, 4096), (4096, 2048)]
SWIGLU_SHAPES = [(4, 11008), (128, 11008), (640, 11008), (1024, 11008), (4096, 5632)]


def _rms_cases(g):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import fused_norm as fn

    for rows, hidden in RMS_SHAPES:
        x, r = (torch.randn(rows, hidden, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        w = (1 + 0.1 * torch.randn(hidden, generator=g, device="cuda")).bfloat16()
        o = torch.empty_like(x)
        for res in (None, r):
            want = fn.rms_norm_plain(x if res is None else x + res, w, 1e-6)
            variants = {"cuda": lambda x=x, w=w, res=res: ops.fused_rms_norm(
                            x, w, epsilon=1e-6, residual=res),
                        "triton": lambda x=x, w=w, res=res: fn._rms_norm_triton(x, res, w, 1e-6)}
            for name, f in variants.items():
                got = f()
                got, s = got if isinstance(got, tuple) else (got, None)
                torch.cuda.synchronize()
                if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL) or (
                        res is not None and not torch.equal(s, x + res)):
                    raise RuntimeError(f"rms_norm [{rows}, {hidden}] {name} disagrees")
            if res is None:
                variants["copy"] = lambda x=x, o=o: o.copy_(x)
            n_io = 2 if res is None else 4
            bound = (n_io * x.numel() * 2 + hidden * 2) / HBM_BYTES_PER_S * 1e6
            yield (f"rms_norm [{rows}, {hidden}]" + (" + residual" if res is not None else ""),
                   rows == 4, bound, variants)


def _swiglu_cases(g):
    from paddle_tpu_torch import ops

    # the module (paddle_tpu_torch.ops exports the function of the same name)
    sw = importlib.import_module("paddle_tpu_torch.ops.swiglu")

    for rows, cols in SWIGLU_SHAPES:
        gate_up = torch.randn(rows, 2 * cols, generator=g, device="cuda").bfloat16()
        x, y = gate_up.chunk(2, dim=-1)
        want = sw.swiglu_plain(x, y)
        xc, yc, o = x.contiguous(), y.contiguous(), torch.empty_like(want)
        variants = {"cuda": lambda gu=gate_up: ops.swiglu(gu),
                    "triton": lambda x=x, y=y: sw._swiglu_triton(x, y)}
        for name, f in variants.items():
            got = f()
            torch.cuda.synchronize()
            if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL):
                raise RuntimeError(f"swiglu [{rows}, {cols}] {name} disagrees")
        variants["copy"] = lambda xc=xc, yc=yc, o=o: torch.mul(xc, yc, out=o)
        yield (f"swiglu [{rows}, {cols}]", rows == 4, 3 * rows * cols * 2 / HBM_BYTES_PER_S * 1e6,
               variants)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_norm_swiglu: no CUDA device; this tool runs on the card",
              file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from paddle_tpu_torch.ops._norm_swiglu import lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    timer = chip_smoke.Timer()

    def time_us(fn):
        return timer(fn, iters=20, warmup=3) * 1e3

    def queued_us(fn):
        return chip_smoke.queued_ms(fn) * 1e3

    def floor():
        if lib().paddle_empty_kernel(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the empty kernel failed")

    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        cases = list(_rms_cases(g)) + list(_swiglu_cases(g))
        for r in range(rounds):
            print(json.dumps({"card": card, "case": "empty kernel", "round": r,
                              "floor_us": time_us(floor), "floor_queued_us": queued_us(floor)}),
                  flush=True)
            for case, decode, bound, variants in cases:
                names = list(variants) if r % 2 == 0 else list(reversed(variants))
                for name in names:
                    row = {"card": card, "case": case, "variant": name, "round": r,
                           "us": time_us(variants[name]), "bound_us": bound}
                    if decode:
                        row["queued_us"] = queued_us(variants[name])
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
