#!/usr/bin/env python3
"""Time the port's matmul epilogue and prefill chain of one checkout on the card.

    python3 tools/time_torch_epilogue_prefill.py [ROOT] [TAG]

ROOT is the root of a checkout of this repository (default: this one),
so that two versions can be compared in one call on one card, in turns
(parent, change, change, parent), as tools/time_torch_flash.py does.

Prints one JSON line each:
  * the matmul epilogue at BERT-base's FFN product [4096, 768] x
    [768, 3072], bf16, bias and gelu: ``matmul_bias_act`` as routed
    (``us``), the general kernel of csrc/matmul_epilogue.cu on the same
    inputs where the checkout has two routes (``general_us``), and
    ``F.gelu(torch.addmm(...))`` (``library_us``, a yardstick only);
  * the prefill chain, a 128-token chunk q [1, 128, 32, 128] against
    T = 640, 256 and 128 positions, bf16, block_q 128 and 64:
    ``prefill_chain`` as routed, decode_chain.cu's bf16 kernel where the
    checkout has two routes, and scaled_dot_product_attention with the
    explicit bottom-right boolean mask.
Each kernel is first held against its plain version (2e-2: one bf16
rounding of the output).  CUDA events around each call, the L2 flushed
before it and the launch enqueued behind a spin on the card, as
chip_smoke.py times.  Builds the checkout's kernels into its own
build/kernels/ at first use.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

TOL = 2e-2


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


def _close(got, want, what):
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL):
        raise RuntimeError(f"{what}: off by {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_epilogue_prefill: no CUDA device; this tool runs on the card",
              file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    tag = sys.argv[2] if len(sys.argv) > 2 else str(root)
    sys.path.insert(0, str(root.resolve()))
    import torch.nn.functional as F

    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import decode_chain as dc
    from paddle_tpu_torch.ops import matmul_epilogue as me

    card = torch.cuda.get_device_name(0)
    time_us = _timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)

    x = (torch.randn(4096, 768, generator=g, device="cuda") / 768 ** 0.5).bfloat16()
    w = torch.randn(768, 3072, generator=g, device="cuda").bfloat16()
    b = (0.5 * torch.randn(3072, generator=g, device="cuda")).bfloat16()
    _close(ops.matmul_bias_act(x, w, b, "gelu"), me.matmul_bias_act_plain(x, w, b, "gelu"),
           f"{tag} matmul epilogue")
    row = {"tag": tag, "card": card, "kernel": "matmul_epilogue", "mkn": [4096, 768, 3072],
           "us": time_us(lambda: ops.matmul_bias_act(x, w, b, "gelu"))}
    if hasattr(me, "_launch"):
        row["general_us"] = time_us(lambda: me._launch("general", x, w, b, "gelu"))
    row["library_us"] = time_us(lambda: F.gelu(torch.addmm(b, x, w)))
    print(json.dumps(row), flush=True)

    s, n, h = 128, 32, 128
    for t in (640, 256, 128):
        q = torch.randn(1, s, n, h, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(1, t, n, h, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        want = dc.prefill_chain_plain(q, k, v)
        mask = torch.ones(s, t, dtype=torch.bool, device="cuda").tril(t - s)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        for bq in (128, 64):
            _close(dc.prefill_chain(q, k, v, block_q=bq), want, f"{tag} prefill T {t} q{bq}")
            row = {"tag": tag, "card": card, "kernel": "prefill_chain", "q": [1, s, n, h],
                   "t": t, "block_q": bq,
                   "us": time_us(lambda: dc.prefill_chain(q, k, v, block_q=bq))}
            if hasattr(dc, "_prefill_general"):
                row["general_us"] = time_us(lambda: dc._prefill_general(q, k, v, bq))
            row["library_us"] = time_us(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
