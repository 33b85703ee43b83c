#!/usr/bin/env python3
"""Time the port's flash-attention kernels of one checkout on the card.

    python3 tools/time_torch_flash.py [ROOT] [TAG]

ROOT is the root of a checkout of this repository (default: this one),
so that two versions can be compared in one call on one card, in turns:

    python3 tools/time_torch_flash.py parent/ parent
    python3 tools/time_torch_flash.py . change
    python3 tools/time_torch_flash.py . change
    python3 tools/time_torch_flash.py parent/ parent

At the training shape [4, 1024, 16, 128] and the serving prefill
[1, 640, 32, 128] (bf16, self-attention) it prints one JSON line each:
the forward's device microseconds causal and not, and torch's
scaled_dot_product_attention on the same inputs as a yardstick; each
forward is first held against the plain version (2e-2, one bf16
rounding of P and of the output).  At the training shape, causal and
not, a line each times the backward: the general kernels of
csrc/flash_attention_bwd.cu (``dq_us``, ``dkv_us``; the only ones of a
checkout from before the sm90 backward), the sm90 kernels where the
checkout has them (``dq_sm90_us``, ``dkv_sm90_us``), the whole
``flash_attention_bwd`` (``bwd_us``, delta included) and torch's
attention backward (``sdpa_bwd_us``, all three gradients).  CUDA events
around each call, the L2 flushed before it and the launch enqueued
behind a spin on the card, as chip_smoke.py times.  Builds the
checkout's kernels into its own build/kernels/ at first use.  Needs one
CUDA card.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import torch

SHAPES = ((4, 1024, 16, 128), (1, 640, 32, 128))  # (B, S, N, H)
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


def _time_backward(fa, ops, F, time_us, q, k, v, do, causal):
    scale = q.shape[-1] ** -0.5
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    if hasattr(fa, "_delta"):
        delta = fa._delta(o, do)
    else:  # a checkout from before the sm90 backward
        delta = fa._bwd_inputs(q, k, v, o, lse, do)[1]
    row = {"dq_us": time_us(lambda: fa._bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)),
           "dkv_us": time_us(lambda: fa._bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale))}
    if hasattr(fa, "_bwd_dq_sm90"):
        stats = fa._bwd_dq_sm90(q, k, v, o, do, lse, causal, scale)[1]
        row["dq_sm90_us"] = time_us(lambda: fa._bwd_dq_sm90(q, k, v, o, do, lse, causal, scale))
        row["dkv_sm90_us"] = time_us(lambda: fa._bwd_dkv_sm90(q, k, v, do, stats, causal,
                                                              scale))
    row["bwd_us"] = time_us(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    do_t = do.transpose(1, 2)
    row["sdpa_bwd_us"] = time_us(lambda: torch.autograd.grad(out, (qt, kt, vt), do_t,
                                                             retain_graph=True))
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_flash: no CUDA device; this tool runs on the card", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    tag = sys.argv[2] if len(sys.argv) > 2 else str(root)
    sys.path.insert(0, str(root.resolve()))
    import torch.nn.functional as F

    from paddle_tpu_torch import ops

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    time_us = _timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, s, n, h in SHAPES:
        q, k, v, do = (torch.randn(b, s, n, h, generator=g, device="cuda").bfloat16()
                       for _ in range(4))
        scale = h ** -0.5
        for causal in (True, False):
            out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
            want, want_lse = fa._reference_with_lse(q, k, v, causal, scale)
            err = max(float((out.float() - want.float()).abs().max()),
                      float((lse - want_lse).abs().max()))
            if err > TOL:
                raise RuntimeError(f"{tag} {(b, s, n, h)} causal={causal}: off by {err}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {"tag": tag, "card": torch.cuda.get_device_name(0), "shape": [b, s, n, h],
               "fwd_us": time_us(lambda: ops.flash_attention_fwd(q, k, v, causal=True)),
               "fwd_noncausal_us": time_us(lambda: ops.flash_attention_fwd(q, k, v,
                                                                           causal=False)),
               "sdpa_us": time_us(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                          is_causal=True))}
        print(json.dumps(row), flush=True)
        if b == 1:
            continue  # serving runs no backward
        for causal in (True, False):
            print(json.dumps({"tag": tag, "card": torch.cuda.get_device_name(0),
                              "shape": [b, s, n, h], "causal": causal,
                              **_time_backward(fa, ops, F, time_us, q, k, v, do, causal)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
