#!/usr/bin/env python3
"""Time design variants of csrc/norm_swiglu.cu's RMSNorm on the card: the
kept kernel against copies of its source with one choice undone.

    python3 tools/time_torch_norm_variants.py [ROUNDS]

Each variant is the kept source with one text substitution, built with
the same nvcc flags into build/kernels/variants/ (one nvcc per variant,
all started together) and launched through its own paddle_rms_norm with
the geometry the wrapper picks (ops/fused_norm.py:rms_geometry):

- ``select``: a masked 16-byte load written as ``cond ? load : 0`` (a
  load and a select) instead of the predicated load;
- ``cap64``: ``__launch_bounds__(256, 4)``, 64 registers a thread,
  instead of ``(256, 2)``;
- ``lds_loop``: the cross-warp sum as a loop over the shared-memory
  partials instead of a second shuffle;
- ``ieee``: ``1 / sqrtf(sum / hidden + eps)`` instead of ``rsqrtf``.

At RMSNorm bf16 [4 | 128 | 640 | 1024, 4096], without the residual, each
variant's output is first held against the plain version (2e-2).  Each
round times every variant in turns (the order reversed every other
round): CUDA events around each call, the L2 flushed before it, the
launch enqueued behind a spin on the card (chip_smoke.py's Timer), and
at [4, 4096] also the queued cost a launch (chip_smoke.py's queued_ms:
100 launches behind a spin, the L2 warm).  Prints one JSON line per (shape, variant, round) with the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 4096), (128, 4096), (640, 4096), (1024, 4096)]

_PREDICATED = '''    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (RO) {'''
_SELECT = '''    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (e0 < n) {
      const uint4* src = reinterpret_cast<const uint4*>(row + e0);
      v = RO ? __ldg(src) : *src;
    }
    if (false) {'''
_SHUFFLE = '''    ss = lane < wpr ? part[rib * wpr + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);'''
_LOOP = '''    ss = 0.f;
    for (int k = 0; k < wpr; ++k) ss += part[rib * wpr + k];'''
VARIANTS = {
    "select": [(_PREDICATED, _SELECT),
               ("    } else {  // bytes this thread stored", "    } else if (false) {  //")],
    "cap64": [("__launch_bounds__(kBlock, 2) rms_norm_kernel",
               "__launch_bounds__(kBlock, 4) rms_norm_kernel")],
    "lds_loop": [(_SHUFFLE, _LOOP)],
    "ieee": [("rsqrtf(ss * a.inv_hidden + a.eps)",
              "1.0f / sqrtf(ss / static_cast<float>(a.hidden) + a.eps)")],
}


def _build(source):
    from paddle_tpu_torch.ops import _cuda_build as cb

    out = cb.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    texts = {"kept": source}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the kept source changed ({old[:40]!r})")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = out / f"norm_{name}.cu"
        cu.write_text(text)
        cmd = [cb._nvcc(), *cb.NVCC_FLAGS, "-o", str(out / f"libnorm_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"libnorm_{name}.so")).paddle_rms_norm
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 5 + [ctypes.c_longlong, i32, ctypes.c_float] + [i32] * 7
                       + [ptr])
        fn.restype = i32
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_norm_variants: no CUDA device; this tool runs on the card",
              file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from paddle_tpu_torch.ops import fused_norm as fn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = _build((ROOT / "paddle_tpu_torch" / "csrc" / "norm_swiglu.cu").read_text())
    timer = chip_smoke.Timer()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    for rows, hidden in SHAPES:
        x = torch.randn(rows, hidden, generator=g, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn(hidden, generator=g, device="cuda")).bfloat16()
        out = torch.empty_like(x)
        want = fn.rms_norm_plain(x, w, 1e-6)
        geo = fn.rms_geometry(rows, hidden, 2, fn.sm_count("cuda"))
        args = (x.data_ptr(), None, w.data_ptr(), out.data_ptr(), None, rows, hidden, 1e-6, 0, 0,
                geo["nv"], geo["warps_per_row"].bit_length() - 1, geo["rows_per_block"],
                int(geo["tiled"]), 1, stream)

        def launch(lib, args=args):
            if lib(*args) != 0:
                raise RuntimeError("a variant's launch failed")

        for name, lib in libs.items():
            out.zero_()
            launch(lib)
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), want.float(), atol=2e-2, rtol=2e-2):
                raise RuntimeError(f"variant {name} disagrees at [{rows}, {hidden}]")
        for r in range(rounds):
            names = list(libs) if r % 2 == 0 else list(reversed(libs))
            for name in names:
                call = functools.partial(launch, libs[name])
                row = {"card": card, "case": f"rms_norm [{rows}, {hidden}]", "variant": name,
                       "round": r, "us": timer(call, iters=20) * 1e3}
                if rows == 4:
                    row["queued_us"] = chip_smoke.queued_ms(call) * 1e3
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
