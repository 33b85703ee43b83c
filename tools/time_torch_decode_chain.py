#!/usr/bin/env python3
"""Time the port's decode chains on the card: the sm90 route, the general
kernel and the plain version, in turns.

    python3 tools/time_torch_decode_chain.py [ROUNDS]

At the chained engines' serving geometries (batch 4, H 128, block_size 16,
a 64-page table; chip_smoke.py phase 3): 7B (N = Nkv 32) and GQA 32:8 with
lengths 18/160/290/680, and the ragged case (N = Nkv 32, lengths
17/32/161/256: fresh pages and pages' last slots), and a floor case
(7B heads, every row at length 1: one page, the least work a launch
does).  For each, bf16 and
int8 pools under ``batch`` and int8 pools under ``rows`` with 2, 4 and 8
splits.  Each round times, one after the other on the same inputs:
``decode_chain_batch`` / ``decode_chain_rows`` as routed
(csrc/decode_chain_sm90.cu, ``batch`` in clusters of ``decode_cluster``'s
choice), ``batch`` at every other cluster size (1, 2, 4, 8), the general
kernel (csrc/decode_chain.cu) and the plain version; ROUNDS (default 2)
rounds, the order reversed every other round.  Every output is first
held against the plain version (pools bit-exact, outputs within 2e-2).

Prints one JSON line per (case, variant, round) with the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, the microseconds, and the case's
least time (bytes: each live K/V position read once, a scale a page for
int8, the token written, q, k_new, v_new, tables, lens and the output
once; over 3.35 TB/s).  CUDA events around each call, the L2 flushed
before it and the launch enqueued behind a spin on the card, as
chip_smoke.py times.  Builds the kernels into build/kernels/ at first use.
Needs one CUDA card.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12
B, H, BS, W = 4, 128, 16, 64
CASES = [("7B", 32, 32, [18, 160, 290, 680]), ("GQA", 32, 8, [18, 160, 290, 680]),
         ("ragged", 32, 32, [17, 32, 161, 256]), ("floor", 32, 32, [1, 1, 1, 1])]
KINDS = [("bf16", 1), ("int8", 1), ("int8", 2), ("int8", 4), ("int8", 8)]


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


def _inputs(g, kv, n, nkv, lens):
    """Pools over B x W pages (row i owns pages [i W, (i + 1) W)), random
    up to each row's last position, and the step's q, k_new, v_new,
    tables and lens, all on the card."""
    from paddle_tpu_torch.ops import paged_attention as pa

    pools = pa.alloc_paged_cache(B * W + B, nkv, BS, H, "int8" if kv == "int8" else
                                 torch.bfloat16, "cuda")
    live = (torch.arange(W * BS, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None] - 1).reshape(B * W, 1, BS, 1)
    for pool in pools:
        vals = torch.randn(B * W, nkv, BS, H, generator=g, device="cuda") * live
        pa.paged_pour_blocks(pool, vals, torch.arange(B * W, device="cuda"))
    q = torch.randn(B, n, H, generator=g, device="cuda").bfloat16()
    kn, vn = (torch.randn(B, nkv, H, generator=g, device="cuda").bfloat16() for _ in range(2))
    tables = torch.arange(B * W, device="cuda").reshape(B, W)
    return pools, (q, kn, vn, tables, torch.tensor(lens, device="cuda"))


def _bound_us(kv, n, nkv, lens):
    live, pages = sum(lens), sum(-(-x // BS) for x in lens)
    if kv == "int8":
        nbytes = 2 * (live * nkv * H + pages * nkv * 4) + 2 * B * nkv * (H + 4)
    else:
        nbytes = 2 * live * nkv * H * 2 + 2 * B * nkv * H * 2
    nbytes += (2 * B * n * H + 2 * B * nkv * H) * 2 + B * W * 8 + B * 8
    return nbytes / HBM_BYTES_PER_S * 1e6


def _differing(a, b):
    if hasattr(a, "scale"):
        return int((a.data != b.data).sum()) + int((a.scale != b.scale).sum())
    return int((a != b).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_decode_chain: no CUDA device; this tool runs on the card",
              file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from paddle_tpu_torch.ops import decode_chain as dc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    time_us = _timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    # the timer's floor: a kernel that does nothing, timed the same way
    for r in range(rounds):
        print(json.dumps({"card": card, "case": "null kernel", "variant": "torch.cuda._sleep(0)",
                          "round": r, "us": time_us(lambda: torch.cuda._sleep(0))}), flush=True)
    for case, n, nkv, lens in CASES:
        chosen = dc.decode_cluster(B, nkv, W, dc.sm_count("cuda"))
        for kv, splits in KINDS:
            (kc, vc), args = _inputs(g, kv, n, nkv, lens)
            want, rk, rv = dc.decode_chain_plain(kc.clone(), vc.clone(), *args)
            variants = {"sm90": functools.partial(dc._decode_sm90, kc, vc, *args, splits)}
            if splits == 1:
                variants.update({f"sm90_cluster{c}": functools.partial(
                    dc._decode_sm90, kc, vc, *args, 1, cluster=c)
                    for c in (1, 2, 4, 8) if c != chosen})
            variants["general"] = functools.partial(dc._decode_general, kc, vc, *args, splits)
            for name, fn in variants.items():
                got = fn()
                torch.cuda.synchronize()
                if _differing(kc, rk) + _differing(vc, rv) or not torch.allclose(
                        got.float(), want.float(), atol=TOL, rtol=TOL):
                    raise RuntimeError(f"{case} {kv} splits {splits} {name} disagrees with "
                                       "the plain version")
            variants["plain"] = lambda: dc.decode_chain_plain(rk, rv, *args)
            base = {"card": card, "case": case, "n": n, "nkv": nkv, "h": H, "bs": BS,
                    "lens": lens, "pools": kv,
                    "layout": "batch" if splits == 1 else f"rows{splits}",
                    "cluster": chosen if splits == 1 else None,
                    "bound_us": _bound_us(kv, n, nkv, lens)}
            for r in range(rounds):
                order = list(variants) if r % 2 == 0 else list(reversed(variants))
                for name in order:
                    plain = name == "plain"
                    us = time_us(variants[name], iters=3 if plain else 20,
                                 warmup=1 if plain else 3)
                    print(json.dumps({**base, "variant": name, "round": r, "us": us}),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
