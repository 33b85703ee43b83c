#!/usr/bin/env python3
"""Time variants of the sm90 decode chain kernel against it, in turns.

    python3 tools/time_torch_decode_variants.py [ROUNDS]

Each variant is csrc/decode_chain_sm90.cu with a few text substitutions
(VARIANTS below): choices the kernel's design weighed (the register cap,
the ring's size, the cluster scheduling policy, the combine's programmatic
dependent launch) and, to see where the time goes, variants that drop one
stage of the work (the cluster merge, the consumers' arithmetic, the
token's write, the page copies).  The dropping variants give wrong
outputs: they are timed, not checked.  The kept kernel (``base``) is held
against the plain version.  All variants are compiled with the flags of
ops/_cuda_build.py into build/kernels/variants/, one nvcc each, all
started together, then timed on the same inputs in turns (the order
reversed every other round) at the geometries of
tools/time_torch_decode_chain.py: 7B (bf16 and int8 ``batch``, int8
``rows`` with 8 splits), GQA 32:8, ragged, and every row at length 1.

Prints one JSON line per (case, variant, round) with the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, the microseconds and the variant's
registers and spill bytes from -Xptxas -v.  CUDA events, the L2 flushed
before each call, as chip_smoke.py times.  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BOUNDS = "__launch_bounds__(kThreads, GT <= 2 ? kMinBlocks : 1)"
RING = "constexpr int kRingBytes = 32 * 1024;"
COMBINE_WAIT = ('asm volatile("griddepcontrol.wait;\\n" ::: "memory");'
                '  // the split kernel\'s partials')
VARIANTS = {
    "base": [],
    "no_register_cap": [(BOUNDS, "__launch_bounds__(kThreads)")],
    "cap_6_blocks": [(BOUNDS, "__launch_bounds__(kThreads, GT <= 2 ? 6 : 1)")],
    "ring_16k": [(RING, "constexpr int kRingBytes = 16 * 1024;")],
    "ring_64k": [(RING, "constexpr int kRingBytes = 64 * 1024;")],
    "cluster_spread": [
        ("cudaLaunchAttribute attr[1];", "cudaLaunchAttribute attr[2];"),
        ("  cfg.attrs = attr;\n  cfg.numAttrs = 1;",
         "  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;\n"
         "  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;\n"
         "  cfg.attrs = attr;\n  cfg.numAttrs = 2;")],
    "combine_without_pdl": [
        ("  c2.attrs = at2;\n  c2.numAttrs = 1;", "  c2.attrs = at2;\n  c2.numAttrs = 0;"),
        (COMBINE_WAIT, "")],
    # stages dropped: timed only, outputs wrong
    # the barrier stays: without it rank 0 may leave while others store into it
    "drop_cluster_merge": [
        ("        st_dsmem_f32(slot + 2 * GT + g * H + d, 0, as);", "        (void)as;"),
        ("    if (run == 0) {  // cluster rank 0", "    if (false) {  // cluster rank 0")],
    "drop_arithmetic": [("for (int j0 = warp * R; j0 < valid;", "for (int j0 = warp * R; j0 < 0;")],
    "drop_write": [("    if (writes && warp < 2) {", "    if (false) {"),
                   ("      if (writes && pg0 + i == pw) {", "      if (false) {")],
    "drop_page_copies": [
        ("        mbar_expect_tx(&full[s], 2 * page_bytes);\n"
         "        bulk_load(dst, kpool + off, page_bytes, &full[s]);\n"
         "        bulk_load(dst + page_elems, vpool + off, page_bytes, &full[s]);",
         "        mbar_arrive(&full[s]);")],
}
LENS_7B, LENS_RAGGED, LENS_FLOOR = [18, 160, 290, 680], [17, 32, 161, 256], [1, 1, 1, 1]
CASES = [("7B", 32, 32, LENS_7B, "bf16", 1), ("7B", 32, 32, LENS_7B, "int8", 1),
         ("7B", 32, 32, LENS_7B, "int8", 8), ("GQA", 32, 8, LENS_7B, "bf16", 1),
         ("ragged", 32, 32, LENS_RAGGED, "bf16", 1), ("floor", 32, 32, LENS_FLOOR, "bf16", 1),
         ("floor", 32, 32, LENS_FLOOR, "int8", 8)]


def variant_sources():
    """name -> the variant's source text; raises if a substitution no longer
    matches the kernel's source."""
    src = (ROOT / "paddle_tpu_torch" / "csrc" / "decode_chain_sm90.cu").read_text()
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old[:60]!r} does not match the source once")
            text = text.replace(old, new)
        out[name] = text
    return out


def _resources(log):
    """The G = 1, H 128 instantiations' registers and spill bytes."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"decode_chain_sm90_kernelI(\w+?)Li128ELi1E", line)
        if "Compiling entry" in line:
            cur = ("int8" if m and m.group(1) == "a" else "bf16") if m else None
        elif cur and "spill stores" in line:
            res.setdefault(cur, {})["spill_bytes"] = int(re.search(r"(\d+) bytes spill", line)[1])
        elif cur and "Used" in line:
            res.setdefault(cur, {})["registers"] = int(re.search(r"Used (\d+) reg", line)[1])
    return res


def build(sources):
    from paddle_tpu_torch.ops import _cuda_build as cb

    out_dir = cb.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        cmd = [cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns, res = {}, {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        res[name] = _resources(log)
        fn = ctypes.CDLL(str(so)).paddle_decode_chain_sm90
        fns[name] = fn
    return fns, res


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_decode_variants: no CUDA device; this tool runs on the card",
              file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import time_torch_decode_chain as T

    from paddle_tpu_torch.ops import decode_chain as dc

    fns, res = build(variant_sources())
    for fn in fns.values():
        fn.argtypes = dc._SIGNATURES["paddle_decode_chain_sm90"]
        fn.restype = ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    time_us = T._timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    try:
        for case, n, nkv, lens, kv, splits in CASES:
            (kc, vc), args = T._inputs(g, kv, n, nkv, lens)
            want, rk, rv = dc.decode_chain_plain(kc.clone(), vc.clone(), *args)
            dc._FNS["paddle_decode_chain_sm90"] = fns["base"]
            got = dc._decode_sm90(kc, vc, *args, splits)
            torch.cuda.synchronize()
            if T._differing(kc, rk) + T._differing(vc, rv) or not torch.allclose(
                    got.float(), want.float(), atol=T.TOL, rtol=T.TOL):
                raise RuntimeError(f"{case} {kv} splits {splits}: the kernel disagrees")
            for r in range(rounds):
                names = list(fns) if r % 2 == 0 else list(reversed(list(fns)))
                for name in names:
                    dc._FNS["paddle_decode_chain_sm90"] = fns[name]
                    us = time_us(functools.partial(dc._decode_sm90, kc, vc, *args, splits))
                    print(json.dumps({"card": card, "case": case, "pools": kv,
                                      "layout": "batch" if splits == 1 else f"rows{splits}",
                                      "variant": name, "round": r, "us": us,
                                      "resources": res[name].get(kv)}), flush=True)
    finally:
        dc._FNS.pop("paddle_decode_chain_sm90", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
