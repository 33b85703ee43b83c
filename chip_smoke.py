#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. Print the card's name and power limit (nvidia-smi) and build the
   kernels from the sources in this checkout: the CUDA C++ flash-attention
   forward and backward (the TMA/wgmma kernels of
   flash_attention_fwd_sm90.cu and flash_attention_bwd_sm90.cu and the
   general ones), the serving chains (the decode chains' Hopper kernel
   decode_chain_sm90.cu, the general decode_chain.cu, and the prefill
   chain's TMA/wgmma kernel prefill_chain_sm90.cu) and the matmul epilogue
   (matmul_epilogue_sm90.cu, TMA/wgmma, and the general
   matmul_epilogue.cu), RMSNorm and SwiGLU (norm_swiglu.cu) with nvcc,
   and the generated sources of the codegen cases of phase 2
   (csrc/codegen/ templates; one nvcc process per source, all started
   together), the Triton LayerNorm and the two Triton yardsticks (the
   RMSNorm and SwiGLU kernels norm_swiglu.cu replaced) at their first
   launch.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving and training shapes, in bf16, and time the kernel, the plain
   version and, where one exists, the one PyTorch call that computes the
   same function (a yardstick only: the port never calls it) with CUDA
   events, L2 flushed before every launch.  One JSON line per kernel and
   shape; also the plain backward of RMSNorm and SwiGLU at the training
   shapes.  First an empty kernel under the same timer (floor_ms) and
   queued (100 launches behind a spin on the card).  RMSNorm at [4 | 128 |
   640 | 1024, 4096] and [4096, 2048] with and without the residual (the
   sum bit-exact), SwiGLU at [4 | 128 | 640 | 1024, 11008] and [4096,
   5632] on the halves of one gate_up projection, each row with the Triton
   yardstick's time and error on the same inputs (triton_ms), the time of
   one torch op that moves the same bytes (copy_ms), the launch geometry,
   the instantiation's registers and spills from -Xptxas -v, and at the
   decode shape the queued cost a launch (queued_ms, the yardstick's
   beside it); f16 and f32, a 4095 tail, odd widths and an RMSNorm weight
   of another dtype than x (bf16 rows, f32 weight) against the plain
   versions.  The flash forward at the serving and training shapes (causal
   and not, bf16 and f16: the TMA/wgmma route, with the general kernel's
   time at the main shapes and the host cost of encoding the tensor maps)
   and at small sizes on the general route (f32, head dims 32, 96 and 256,
   strides that are not 16-byte multiples), each row naming its route;
   the flash backward likewise: the TMA/wgmma pair at the training shape
   causal and not (with the general kernels' times on the same inputs and
   delta's share of the whole), GQA, a ragged length, Sq < Sk, f16 and
   H 64, the general pair in bf16, f16 and f32 at head dims 32 to 256 and
   strided; f32 cases within 1e-4; both pairs on causal rows that see no
   key (Sq > Sk) against the plain version on every row.  Then llama_tiny in f32 takes a
   forward and a backward on the card against the CPU's plain run of the
   same weights.  The decode chains (bf16 and int8 pools; the split int8
   layout with 2, 4 and 8 splits) on their sm90 route (bulk page copies,
   clusters) at the 7B serving geometry, GQA 32:8, a ragged one, H 64 and a
   full table must leave the pools bit-exact (0 differing elements), as
   must decode_chain.cu's kernel timed beside them on the same inputs;
   each row names its cluster or splits and the kernel's registers; the prefill
   chain is held at a 128-token chunk against 128, 256 and 640 positions,
   200 (not a multiple of 64), 2048 (key splits and the combine launch)
   and, at H 64, 331, with both block_q (bf16 on
   the TMA/wgmma route, beside decode_chain.cu's bf16 kernel on the same
   inputs), and in f32 (the general route).  The fused LayerNorm at
   BERT-base's [4096, 768] rows (bf16 with and without the residual, f32)
   and a ragged hidden size; the matmul epilogue at BERT-base's FFN product
   for every activation, with and without bias, in bf16 and f16 (the
   TMA/wgmma route, beside the general kernel on the same inputs), at
   ragged M (100) and K 72, and on the general route in f32 and at an odd
   shape (M 100, K 72, N 130); every prefill-chain and epilogue row names
   its route and its kernels' registers and spills.
   The generated kernels: the elementwise chain (#11; BERT's mask chain
   and the JAX package's test chain at BERT-base's FFN size) at its
   default and tuned launch shapes, and every enumerated config of the
   schedule-search subgraphs (#12, #13 split-K: the BERT pooler,
   bench_schedule_search.py's three programs at its chip shapes, the
   softmax at BERT-base's logits), each against the replay of the
   recorded ops (bf16 one bf16 step, f32 1e-5), with registers and nvcc
   seconds from -Xptxas -v.
3. Serve 4 greedy requests (prompts of 17, 128, 250 and 640 tokens, 32 new
   tokens each) on LLaMA-7B at full width, bf16, all 32 layers, random
   weights from a seeded generator, each engine after one warm-up pass
   over the same prompts: the default GenerationEngine (the serving chains
   launch 0 times), then GenerationEngine(kv_cache_dtype="int8" and then
   "bf16", prefill_chunk=128) with FLAGS_schedule_search on and a fresh
   FLAGS_autotune_cache_dir, so the searcher measures both chains against
   their plain twins in every run and must accept both.  For each engine:
   the streams, that every kernel's launch counter grew by exactly what
   the run implies (the Triton yardsticks 0; every flash forward and
   every prefill chain on the
   TMA/wgmma route, every decode chain on decode_chain_sm90.cu's: 1,024
   launches, 32 layers x 32 token iterations, under the layout the search
   accepts), that its first-token logits of the longest prompt
   (through its own prefill path) match a forward built only from the
   plain versions; for the chained engines also the searcher's decisions
   and one decode step with the accepted config against the same step
   unfused (pools bit-exact).  Print prefill and decode tokens/s, peak
   memory and the pools' resident bytes.
4. Train the flagship configuration of bench.py (vocab 32000, hidden
   2048, FFN 5632, 8 layers, 16 heads, bf16) at full width and depth with
   TrainStep and AdamW on one seeded batch of 4 x 1024 tokens: check that
   the first step's loss and gradients match a backward through a forward
   built only from the plain versions, then run 3 warm-up and 10 timed
   steps, checking every step's launch counts (every flash forward and
   backward on the sm90 route, the Triton yardsticks 0) and that the
   loss falls.
   Print ms a step, tokens/s, the model-FLOP share and peak memory
   (tools/profile_torch_training.py says where the step's time goes).
5. Run BERT-base (12 layers, hidden 768, bf16, seeded random weights)
   through the static Program tier: capture
   BertForSequenceClassification under static.program_guard, run
   static.Executor (its PallasFusionPass puts the 25 residual adds +
   LayerNorms and the 12 linear + GELUs on the fused LayerNorm and
   matmul-epilogue kernels) on batches of 32 x 128 ids with ragged padding.
   Checks the op counts after the pass, every run's launches (every
   epilogue on the TMA/wgmma route), and the
   logits against the eager forward, the unfused program (the flag
   FLAGS_use_pallas_fusion off) and the f32 forward of the same weights;
   prints ms a batch, sequences/s, tokens/s and peak memory.
6. The codegen passes: the same BERT-base after pallas_fusion and
   generic_elementwise_fusion, run by the Executor with
   FLAGS_schedule_search on and a fresh verdict cache (op counts, every
   run's launches, the pooler's decision, logits as in phase 5, ms a
   batch); then bench_schedule_search.py's three programs through the
   Executor with the real search (decisions, outputs against the unfused
   program); then fresh captures of all four, whose verdicts must come
   from the cache with no new search.
7. Print the ``kernels`` JSON line (all thirteen kernels, launches by main
   path; the flash forward, the two backward kernels, the prefill chain and
   the matmul epilogue with their launches by route), then the result line.

The script needs the card: without CUDA, or run from a directory that
holds nothing else of the repository, it exits with a non-zero code
before printing any result.  It imports nothing of JAX or paddle_tpu.
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TOL = 2e-2                     # bf16: one rounding of the output (and of P in flash;
                               # of P and dS in its backward)
LOGITS_REL_TOL = 2e-2          # relative L2 of 32 bf16 layers, kernels vs plain versions
LOSS_REL_TOL = 1e-3            # first training loss, kernels vs plain versions: an f32
                               # mean over 4096 tokens of bf16 logits
GRAD_REL_TOL = 5e-2            # relative L2 of a bf16 gradient through 8 layers, kernels
                               # (P and dS rounded to bf16) vs plain versions (f32 inside)
CACHE_FLUSH_BYTES = 256 << 20  # > the 50 MB L2
SLEEP_CYCLES = 2_000_000       # about 1 ms of spinning at the H100's clock
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


class Timer:
    """Mean device time of one call, from CUDA events around each call
    with the L2 cache flushed before it (outside the events) and the
    launch enqueued behind a spin on the card."""

    def __init__(self):
        self.flush = torch.empty(CACHE_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for s, e in zip(starts, ends):
            self.flush.zero_()
            # keep the card busy while the host enqueues the call, so the
            # events time the device and not the host's launch cost
            torch.cuda._sleep(SLEEP_CYCLES)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(nbytes, flops, peak):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


F32_NORM_TOL = 1e-5   # f32 RMSNorm / SwiGLU: the sum of squares in another order, the
                      # sigmoid through the fast exponential
QUEUED = 100          # launches a queued_ms batch
QUEUE_SLEEP_CYCLES = 40_000_000  # ~20 ms of spinning: longer than enqueueing the batch
_MANGLED = {torch.bfloat16: "13__nv_bfloat16", torch.float16: "6__half", torch.float32: "f"}


def queued_ms(fn, n=QUEUED):
    """Device ms a launch when ``n`` launches wait in the stream's queue
    (enqueued behind a spin on the card, events around the batch, the L2
    warm): what an engine pays for a small launch between other queued
    launches, where chip_smoke's Timer isolates each one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def launch_floor(timer):
    """An empty kernel (csrc/norm_swiglu.cu's paddle_empty_kernel) under the
    same timer, and queued: the fixed cost every launch pays."""
    from paddle_tpu_torch.ops._norm_swiglu import lib

    fn = lib().paddle_empty_kernel

    def empty():
        check(fn(torch.cuda.current_stream().cuda_stream) == 0, "the empty kernel failed")

    row = {"check": "launch_floor", "floor_ms": timer(empty), "floor_queued_ms": queued_ms(empty)}
    emit(row)
    return row


def check_rms_norm(timer, F, logs, floor):
    """csrc/norm_swiglu.cu's RMSNorm against its plain version and the
    Triton kernel it replaced (the yardstick, timed beside it on the same
    inputs) at the serving and training shapes, with and without the
    residual; the residual sum must be bit-exact."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import fused_norm

    out = []
    g = torch.Generator(device=DEVICE).manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # serving (LLaMA-7B width: prefill, a chained prefill chunk, decode) first, then training
    for rows, hidden in ((640, 4096), (1024, 4096), (128, 4096), (4, 4096), (4096, 2048)):
        x = torch.randn(rows, hidden, generator=g, device=DEVICE).to(torch.bfloat16)
        r = torch.randn(rows, hidden, generator=g, device=DEVICE).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(torch.bfloat16)
        o = torch.empty_like(x)
        for res in (None, r):
            got = ops.fused_rms_norm(x, w, epsilon=1e-6, residual=res)
            yard, yard_s = fused_norm._rms_norm_triton(x, res, w, 1e-6)
            s_want = x + res if res is not None else None
            want = fused_norm.rms_norm_plain(x if res is None else s_want, w, 1e-6)
            torch.cuda.synchronize()
            o = got if res is None else got[0]
            err, yard_err = max_err(o, want), max_err(yard, want)
            check(torch.allclose(o.float(), want.float(), atol=TOL, rtol=TOL),
                  f"fused_rms_norm [{rows}, {hidden}] disagrees with its plain version: {err}")
            check(torch.allclose(yard.float(), want.float(), atol=TOL, rtol=TOL),
                  f"the Triton RMSNorm [{rows}, {hidden}] disagrees: {yard_err}")
            if res is not None:
                check(torch.equal(got[1], s_want) and torch.equal(yard_s, s_want),
                      f"fused_rms_norm [{rows}, {hidden}]: x + residual is not bit-exact")
            n_io = 2 if res is None else 4
            b_ms, b_by = bound_ms(n_io * x.numel() * 2 + hidden * 2,
                                  (4 if res is None else 5) * x.numel(), F32_FLOPS)
            # the shape the wrapper launched: 16-byte rows, the weight of x's dtype (code 0)
            geo = fused_norm.rms_geometry(rows, hidden, 2, sms, [x.data_ptr(), w.data_ptr()])
            part = (f"rms_norm_kernelI{_MANGLED[x.dtype]}Li0ELi{geo['nv']}"
                    f"ELb{int(res is not None)}ELb1ELb{int(geo['tiled'])}E")
            row = {"check": "fused_rms_norm", "shape": [rows, hidden],
                   "residual": res is not None, "max_abs_err": err,
                   "triton_max_abs_err": yard_err,
                   "ms": timer(lambda: ops.fused_rms_norm(x, w, epsilon=1e-6, residual=res)),
                   "triton_ms": timer(lambda: fused_norm._rms_norm_triton(x, res, w, 1e-6)),
                   "plain_ms": timer(lambda: fused_norm.rms_norm_plain(
                       x if res is None else x + res, w, 1e-6)),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": (timer(lambda: F.rms_norm(x, (hidden,), w, 1e-6))
                                  if res is None else None),
                   "floor_ms": floor["floor_ms"],
                   # one torch op moving the same bytes (x read once, written once)
                   "copy_ms": timer(lambda: o.copy_(x)) if res is None else None,
                   "geometry": geo, "registers": _registers(logs, "norm_swiglu", part)}
            if rows == 4:  # the decode shape: what the engine pays a launch
                row["queued_ms"] = queued_ms(
                    lambda: ops.fused_rms_norm(x, w, epsilon=1e-6, residual=res))
                row["triton_queued_ms"] = queued_ms(
                    lambda: fused_norm._rms_norm_triton(x, res, w, 1e-6))
            out.append(row)
            emit(row)
    return out


def check_swiglu(timer, logs, floor):
    """csrc/norm_swiglu.cu's SwiGLU on the halves of one gate_up projection
    (the main path's layout) against its plain version and the Triton
    kernel it replaced (the yardstick, timed beside it)."""
    from paddle_tpu_torch import ops

    # the module (paddle_tpu_torch.ops exports the function of the same name)
    swiglu_mod = importlib.import_module("paddle_tpu_torch.ops.swiglu")
    out = []
    g = torch.Generator(device=DEVICE).manual_seed(2)
    for rows, cols in ((640, 11008), (1024, 11008), (128, 11008), (4, 11008), (4096, 5632)):
        gate_up = torch.randn(rows, 2 * cols, generator=g, device=DEVICE).to(torch.bfloat16)
        x, y = gate_up.chunk(2, dim=-1)
        got = ops.swiglu(gate_up)
        yard = swiglu_mod._swiglu_triton(x, y)
        want = swiglu_mod.swiglu_plain(x, y)
        torch.cuda.synchronize()
        err, yard_err = max_err(got, want), max_err(yard, want)
        check(torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL),
              f"swiglu [{rows}, {cols}] disagrees with its plain version: {err}")
        check(torch.allclose(yard.float(), want.float(), atol=TOL, rtol=TOL),
              f"the Triton SwiGLU [{rows}, {cols}] disagrees: {yard_err}")
        b_ms, b_by = bound_ms(3 * rows * cols * 2, 5 * rows * cols, F32_FLOPS)
        geo = swiglu_mod.swiglu_grid(rows, cols, 2, x.stride(), (x.data_ptr(), y.data_ptr()))
        xc, yc, o = x.contiguous(), y.contiguous(), torch.empty_like(got)
        row = {"check": "swiglu", "shape": [rows, cols], "max_abs_err": err,
               "triton_max_abs_err": yard_err,
               "ms": timer(lambda: ops.swiglu(gate_up)),
               "triton_ms": timer(lambda: swiglu_mod._swiglu_triton(x, y)),
               "plain_ms": timer(lambda: swiglu_mod.swiglu_plain(x, y)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "floor_ms": floor["floor_ms"],
               # one torch op moving the same bytes (two inputs read, one output written)
               "copy_ms": timer(lambda: torch.mul(xc, yc, out=o)), "geometry": geo,
               "registers": _registers(logs, "norm_swiglu",
                                       f"swiglu_kernelI{_MANGLED[x.dtype]}Lb1E")}
        if rows == 4:
            row["queued_ms"] = queued_ms(lambda: ops.swiglu(gate_up))
            row["triton_queued_ms"] = queued_ms(lambda: swiglu_mod._swiglu_triton(x, y))
        out.append(row)
        emit(row)
    return out


def check_norm_swiglu_dtypes():
    """f16 and f32 (and a 4095 tail, f16 at hidden 100, an odd SwiGLU width),
    and RMSNorm weights of another dtype than x, against the plain
    versions: bf16 and f16 outputs within bf16's TOL, f32 within
    F32_NORM_TOL."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.fused_norm import rms_norm_plain
    from paddle_tpu_torch.ops.swiglu import swiglu_plain

    g = torch.Generator(device=DEVICE).manual_seed(12)
    errs = {}
    for dtype, tol in ((torch.float16, TOL), (torch.float32, F32_NORM_TOL)):
        for rows, hidden in ((640, 4096), (37, 4095), (4096, 100)):
            x = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype)
            r = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype)
            w = (1 + 0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(dtype)
            o, s = ops.fused_rms_norm(x, w, epsilon=1e-6, residual=r)
            want = rms_norm_plain(x + r, w, 1e-6)
            check(torch.equal(s, x + r) and torch.allclose(o.float(), want.float(), atol=tol,
                                                           rtol=tol),
                  f"fused_rms_norm {dtype} [{rows}, {hidden}]: {max_err(o, want)}")
            errs[f"rms_norm {dtype} {rows}x{hidden}"] = max_err(o, want)
        for rows, cols in ((640, 11008), (37, 689)):
            gate_up = torch.randn(rows, 2 * cols, generator=g, device=DEVICE).to(dtype)
            got, want = ops.swiglu(gate_up), swiglu_plain(*gate_up.chunk(2, dim=-1))
            check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                  f"swiglu {dtype} [{rows}, {cols}]: {max_err(got, want)}")
            errs[f"swiglu {dtype} {rows}x{cols}"] = max_err(got, want)
    # a weight of another dtype than x, taken in its own dtype (f32 in registers)
    for dtype, wdtype, tol in ((torch.bfloat16, torch.float32, TOL),
                               (torch.float16, torch.bfloat16, TOL),
                               (torch.float32, torch.bfloat16, F32_NORM_TOL)):
        for rows, hidden in ((640, 4096), (37, 4095)):
            x = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype)
            r = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype)
            w = (1 + 0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(wdtype)
            o, s = ops.fused_rms_norm(x, w, epsilon=1e-6, residual=r)
            want = rms_norm_plain(x + r, w, 1e-6)
            check(o.dtype == dtype and torch.equal(s, x + r)
                  and torch.allclose(o.float(), want.float(), atol=tol, rtol=tol),
                  f"fused_rms_norm {dtype}, {wdtype} weight [{rows}, {hidden}]: "
                  f"{max_err(o, want)}")
            errs[f"rms_norm {dtype} {wdtype} weight {rows}x{hidden}"] = max_err(o, want)
    emit({"check": "norm_swiglu_dtypes", "max_abs_err": errs,
          "tolerance": {"float16": TOL, "float32": F32_NORM_TOL}})


def _qkv(g, bsz, sq, sk, n, nkv, h, dtype=torch.bfloat16, layout="contiguous"):
    """q, k, v of the given dtype; layout "narrow" gives views of tensors H + 4
    wide, whose row strides are not 16-byte multiples (the general route)."""
    def make(*shape):
        if layout == "narrow":
            wide = torch.randn(*shape[:-1], shape[-1] + 4, generator=g, device=DEVICE)
            return wide.to(dtype)[..., :shape[-1]]
        return torch.randn(*shape, generator=g, device=DEVICE).to(dtype)

    return make(bsz, sq, n, h), make(bsz, sk, nkv, h), make(bsz, sk, nkv, h)


def _library_views(q, k, v):
    """[B, N, S, H] views for the library yardstick, K/V repeated for GQA
    (outside any timed call)."""
    group = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2), k.repeat_interleave(group, dim=2).transpose(1, 2),
            v.repeat_interleave(group, dim=2).transpose(1, 2))


def _library_sdpa(F, qt, kt, vt, causal=True):
    """torch's attention with the port's causal semantics: is_causal when
    Sq == Sk, else an explicit bottom-right mask (torch's is top-left)."""
    sq, sk = qt.shape[2], kt.shape[2]
    if not causal:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt)
    if sq == sk:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=DEVICE).tril(sk - sq)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def _allowed_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


F32_ATTN_TOL = 1e-4  # f32 FMA kernels against the plain f32 einsums: other summation orders

# (B, Sq, Sk, N, Nkv, H, causal, dtype, layout): the serving slice's prefill
# shapes (the longest prompt first), one ragged, one cross-length, one GQA,
# the training shape, both main shapes non-causal, an f16 serving prefill;
# then the general route's cases at small sizes (f32, head dims 32 and 96
# and 256, f16, strides that are not 16-byte multiples)
FLASH_CASES = [
    (1, 640, 640, 32, 32, 128, True, torch.bfloat16, "contiguous"),
    (1, 128, 128, 32, 32, 128, True, torch.bfloat16, "contiguous"),
    (1, 1000, 1000, 32, 32, 128, True, torch.bfloat16, "contiguous"),
    (1, 128, 640, 32, 32, 128, True, torch.bfloat16, "contiguous"),
    (1, 512, 512, 32, 8, 128, True, torch.bfloat16, "contiguous"),
    (4, 1024, 1024, 16, 16, 128, True, torch.bfloat16, "contiguous"),
    (1, 640, 640, 32, 32, 128, False, torch.bfloat16, "contiguous"),
    (4, 1024, 1024, 16, 16, 128, False, torch.bfloat16, "contiguous"),
    (1, 640, 640, 32, 32, 128, True, torch.float16, "contiguous"),
    (2, 256, 256, 4, 4, 64, True, torch.float32, "contiguous"),
    (2, 256, 256, 4, 4, 32, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 2, 96, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 4, 256, True, torch.float16, "contiguous"),
    (2, 256, 256, 4, 4, 128, True, torch.bfloat16, "narrow"),
]


def _route_of(added):
    """Which forward kernel a call launched, from the launch counts it added."""
    check(added["flash_attention_fwd"] == 1, f"flash forward launches {added}")
    return "sm90" if added["flash_attention_fwd_sm90"] == 1 else "general"


def check_flash(timer, F):
    """The forward against the plain version on every case of FLASH_CASES,
    each row naming the route that ran; the TMA kernel's host cost of
    encoding its tensor maps; the general kernel's time at the main shapes
    beside the TMA kernel's."""
    from paddle_tpu_torch import ops

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    out = []
    g = torch.Generator(device=DEVICE).manual_seed(3)
    for bsz, sq, sk, n, nkv, h, causal, dtype, layout in FLASH_CASES:
        q, k, v = _qkv(g, bsz, sq, sk, n, nkv, h, dtype, layout)
        scale = h ** -0.5
        before = ops.launch_counts()
        got, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        after = ops.launch_counts()
        route = _route_of({key: after[key] - before[key] for key in after})
        want, want_lse = fa._reference_with_lse(q, k, v, causal, scale)
        torch.cuda.synchronize()
        tol = F32_ATTN_TOL if dtype == torch.float32 else TOL
        err = max_err(got, want)
        shape = {"q": list(q.shape), "kv": list(k.shape), "causal": causal,
                 "dtype": str(dtype).replace("torch.", ""), "layout": layout}
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"flash_attention {shape} ({route}) disagrees with its plain version: {err}")
        lse_err = max_err(lse, want_lse)
        check(lse_err <= tol, f"flash_attention {shape}: lse off by {lse_err}")
        qt, kt, vt = _library_views(q, k, v)
        lib = _library_sdpa(F, qt, kt, vt, causal)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + bsz * n * sq * 4
        flops = 4 * bsz * n * h * _allowed_pairs(sq, sk, causal)
        b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS if dtype == torch.float32 else BF16_TC_FLOPS)
        row = {"check": "flash_attention_fwd", "shape": shape, "route": route,
               "max_abs_err": err, "tolerance": tol,
               "ms": timer(lambda: ops.flash_attention_fwd(q, k, v, causal=causal)),
               "plain_ms": timer(lambda: ops.flash_attention_reference(q, k, v, causal=causal),
                                 iters=3, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": timer(lib)}
        if route == "sm90" and layout == "contiguous" and sq >= 640:
            # the same call on the general kernel, and the sm90 launch's
            # host cost of encoding its three tensor maps
            args = (q, k, v, torch.empty_like(q), torch.empty_like(lse), bsz, sq, sk, n, nkv, h,
                    *q.stride(), *k.stride(), *v.stride(), *q.stride()[:3],
                    fa._DTYPES[dtype], scale, int(causal))
            row["general_ms"] = timer(lambda: fa._launch("flash_attention_fwd",
                                                         "paddle_flash_attention_fwd", *args))
            row["encode_us"] = _encode_us(q, k, v)
        out.append(row)
        emit(row)
    return out


def _encode_us(q, k, v, iters=2000):
    """Host microseconds the sm90 launch spends encoding its tensor maps."""
    import ctypes

    from paddle_tpu_torch.ops import _cuda_build

    fn = _cuda_build.load("flash_attention_fwd_sm90").paddle_flash_attention_fwd_sm90_encode_us
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
                   + [ctypes.c_int] * 2)
    fn.restype = ctypes.c_double
    b, sq, n, h = q.shape
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, k.shape[1], n, k.shape[2], h,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(q.dtype == torch.float16),
            iters)
    check(us > 0, "encoding the sm90 tensor maps failed")
    return us


# (B, Sq, Sk, N, Nkv, H, causal, dtype, layout): the sm90 route at the
# training shape causal and not (both routes timed there), GQA 16:4, a
# ragged length, Sq 256 against Sk 1024, f16 and H 64; then the general
# route at small sizes (f32, head dims 32, 96 and 256, rows that are not
# 16-byte multiples)
FLASH_BWD_CASES = [
    (4, 1024, 1024, 16, 16, 128, True, torch.bfloat16, "contiguous"),
    (4, 1024, 1024, 16, 16, 128, False, torch.bfloat16, "contiguous"),
    (2, 1024, 1024, 16, 4, 128, True, torch.bfloat16, "contiguous"),
    (2, 1000, 1000, 16, 16, 128, True, torch.bfloat16, "contiguous"),
    (2, 256, 1024, 16, 16, 128, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 4, 128, True, torch.float16, "contiguous"),
    (2, 512, 512, 8, 8, 64, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 2, 64, True, torch.float32, "contiguous"),
    (2, 200, 200, 4, 4, 32, True, torch.float32, "contiguous"),
    (2, 256, 256, 4, 4, 32, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 2, 96, True, torch.float16, "contiguous"),
    (2, 200, 200, 4, 4, 256, True, torch.float16, "contiguous"),
    (2, 256, 256, 4, 4, 128, True, torch.bfloat16, "narrow"),
]


def _bwd_route_of(added):
    """Which backward kernels a call launched, from the launch counts it added."""
    check(added["flash_attention_bwd_dq"] == 1 and added["flash_attention_bwd_dkv"] == 1,
          f"flash backward launches {added}")
    sm90 = (added["flash_attention_bwd_dq_sm90"], added["flash_attention_bwd_dkv_sm90"])
    check(sm90 in ((0, 0), (1, 1)), f"flash backward launches {added}")
    return "sm90" if sm90 == (1, 1) else "general"


def check_flash_bwd(timer, F):
    """The backward against the plain backward on every case of
    FLASH_BWD_CASES, each row naming its route, with each kernel's time
    (the route's own entry points), the whole backward's and delta's share
    of it; at the training shape also the general kernels on the same
    inputs."""
    from paddle_tpu_torch import ops

    # the module: ops.flash_attention is the function of the same name
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    out = []
    g = torch.Generator(device=DEVICE).manual_seed(4)
    for bsz, sq, sk, n, nkv, h, causal, dtype, layout in FLASH_BWD_CASES:
        scale = h ** -0.5
        shape = {"q": [bsz, sq, n, h], "kv": [bsz, sk, nkv, h], "causal": causal,
                 "dtype": str(dtype).replace("torch.", ""), "layout": layout}
        tol = F32_ATTN_TOL if dtype == torch.float32 else TOL
        peak = F32_FLOPS if dtype == torch.float32 else BF16_TC_FLOPS
        q, k, v = _qkv(g, bsz, sq, sk, n, nkv, h, dtype, layout)
        do = torch.randn(q.shape, generator=g, device=DEVICE).to(dtype)
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        before = ops.launch_counts()
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        after = ops.launch_counts()
        route = _bwd_route_of({key: after[key] - before[key] for key in after})
        want = ops.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            errs[name] = max_err(a, b)
            check(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol),
                  f"flash backward {shape} ({route}): {name} disagrees with its plain "
                  f"version: {errs[name]}")
        # each route's two kernels through their own entry points
        delta = fa._delta(o, do)
        general = (lambda: fa._bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale),
                   lambda: fa._bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale))
        kernels = general
        if route == "sm90":
            stats = fa._bwd_dq_sm90(q, k, v, o, do, lse, causal, scale)[1]
            kernels = (lambda: fa._bwd_dq_sm90(q, k, v, o, do, lse, causal, scale),
                       lambda: fa._bwd_dkv_sm90(q, k, v, do, stats, causal, scale))
        # the library yardstick: torch's attention backward on the same
        # inputs, the graph built outside the timed call
        qt, kt, vt = (t.detach().requires_grad_() for t in _library_views(q, k, v))
        lib_out = _library_sdpa(F, qt, kt, vt, causal)()
        do_t = do.transpose(1, 2)

        def lib():
            return torch.autograd.grad(lib_out, (qt, kt, vt), do_t, retain_graph=True)

        pairs = bsz * n * _allowed_pairs(sq, sk, causal)
        qbytes, kbytes = q.numel() * q.element_size(), k.numel() * k.element_size()
        rows = bsz * n * sq * 4  # one f32 per q row: lse, delta
        # dQ: reads q, k, v, dO, lse, delta (sm90: O and lse, writes delta
        # and lse beside dQ), writes dQ; S, dP, dS K
        dq_bytes = 3 * qbytes + 2 * kbytes + (qbytes + 3 * rows if route == "sm90" else 2 * rows)
        dq_bound = bound_ms(dq_bytes, 6 * h * pairs, peak)
        # dK/dV: reads q, k, v, dO, lse, delta, writes dK, dV; S, dP, P^T dO, dS^T Q
        dkv_bound = bound_ms(2 * qbytes + 4 * kbytes + 2 * rows, 8 * h * pairs, peak)
        # the whole backward: reads q, k, v, o, dO, lse, writes dQ, dK, dV
        pair_bound = bound_ms(4 * qbytes + 4 * kbytes + rows, 10 * h * pairs, peak)
        row = {"check": "flash_attention_bwd", "shape": shape, "route": route,
               "max_abs_err": errs, "tolerance": tol,
               "dq_ms": timer(kernels[0]), "dq_bound_ms": dq_bound[0],
               "dq_bound_by": dq_bound[1], "dkv_ms": timer(kernels[1]),
               "dkv_bound_ms": dkv_bound[0], "dkv_bound_by": dkv_bound[1],
               "ms": timer(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)),
               "bound_ms": pair_bound[0], "bound_by": pair_bound[1],
               "plain_ms": timer(lambda: ops.flash_attention_bwd_reference(
                   q, k, v, o, lse, do, causal=causal), iters=3, warmup=1),
               "library_ms": timer(lib)}
        # delta's share: the whole backward less its two kernels timed alone
        # (the torch passes on the general route; below 0 on the sm90 route,
        # whose second kernel finds its inputs in L2 only within the whole)
        row["delta_ms"] = row["ms"] - row["dq_ms"] - row["dkv_ms"]
        if route == "sm90" and (bsz, sq, n) == (4, 1024, 16):
            # the same inputs on the general kernels, delta included in
            # general_ms
            row["general_dq_ms"] = timer(general[0])
            row["general_dkv_ms"] = timer(general[1])
            row["general_ms"] = timer(lambda: (fa._delta(o, do), general[0](), general[1]()))
        out.append(row)
        emit(row)
        del lib_out
    return out


def check_flash_bwd_no_key_rows():
    """Causal with Sq > Sk (q [1, 300, 2, 64], k/v [1, 130, 1, 64]): rows
    0-169 see no key.  Both backward routes against the plain version on
    every row (bf16; the general route also in f32): dQ 0 there, nothing
    from them in dK, dO / Sk from each in every key's dV."""
    from paddle_tpu_torch import ops

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=DEVICE).manual_seed(30)
    row = {"check": "flash_attention_bwd_no_key_rows", "q": [1, 300, 2, 64],
           "kv": [1, 130, 1, 64], "max_abs_err": {}}
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, F32_ATTN_TOL)):
        q, do = (torch.randn(1, 300, 2, 64, generator=g, device=DEVICE).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(1, 130, 1, 64, generator=g, device=DEVICE).to(dtype)
                for _ in range(2))
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True)
        scale = 64 ** -0.5
        routes = {}
        if dtype == torch.bfloat16:
            dq, stats = fa._bwd_dq_sm90(q, k, v, out, do, lse, True, scale)
            routes["sm90"] = (dq, *fa._bwd_dkv_sm90(q, k, v, do, stats, True, scale))
        delta = fa._delta(out, do)
        routes["general"] = (fa._bwd_dq_cuda(q, k, v, do, lse, delta, True, scale),
                             *fa._bwd_dkv_cuda(q, k, v, do, lse, delta, True, scale))
        want = ops.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)
        torch.cuda.synchronize()
        for route, got in routes.items():
            key = f"{route}_{str(dtype).split('.')[-1]}"
            row["max_abs_err"][key] = {n: max_err(a, b)
                                       for n, a, b in zip(("dq", "dk", "dv"), got, want)}
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                check(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol),
                      f"flash backward, rows that see no key, {key}: {name} disagrees with "
                      f"its plain version: {max_err(a, b)}")
            check(not got[0][:, :170].any(), f"{key}: dQ of the rows that see no key is not 0")
    emit(row)
    return row


F32_MODEL_REL_TOL = 1e-4  # relative L2, f32 model on the card vs the CPU: sums in other orders


def f32_llama(card):
    """LlamaForCausalLM(llama_tiny(dtype="float32")) takes a forward and a
    backward on the card (f32 at head_dim 64: the general flash kernels,
    FMA) against the CPU's plain run of the same weights."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    model = LlamaForCausalLM(llama_tiny(dtype="float32"), device="cpu",
                             generator=torch.Generator().manual_seed(7))
    layers = model.config.num_hidden_layers
    ids = torch.randint(0, model.config.vocab_size, (2, 128),
                        generator=torch.Generator().manual_seed(8))
    runs = {}
    for device in ("cpu", DEVICE):
        model.to(device)
        model.zero_grad(set_to_none=True)
        ops.reset_launch_counts()
        loss, logits = model(ids.to(device), labels=ids.to(device))
        loss.backward()
        runs[device] = (ops.launch_counts(), logits.detach().cpu(),
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (cpu_counts, want, want_grads), (counts, got, grads) = runs["cpu"], runs[DEVICE]
    check(not any(cpu_counts.values()), f"f32 llama_tiny on the CPU launched {cpu_counts}")
    check(counts["flash_attention_fwd"] == layers and counts["flash_attention_fwd_sm90"] == 0
          and counts["flash_attention_bwd_dq"] == layers
          and counts["flash_attention_bwd_dkv"] == layers
          and counts["flash_attention_bwd_dq_sm90"] == 0
          and counts["flash_attention_bwd_dkv_sm90"] == 0,
          f"f32 llama_tiny on the card: flash launches {counts}")
    rel = {"logits": _rel_l2(got, want)}
    rel.update({n: _rel_l2(grads[n], want_grads[n]) for n in want_grads})
    worst = max(rel, key=rel.get)
    check(bool(torch.isfinite(got).all()) and rel[worst] <= F32_MODEL_REL_TOL,
          f"f32 llama_tiny: {worst} relative L2 {rel[worst]} > {F32_MODEL_REL_TOL}")
    row = {"f32_llama_tiny": "forward + backward, batch 2 x 128, against the CPU", "card": card,
           "launches": counts, "logits_rel_l2": rel["logits"],
           "max_grad_rel_l2": max(v for n, v in rel.items() if n != "logits"),
           "tolerance": F32_MODEL_REL_TOL}
    emit(row)
    return row


def _chain_pools(g, kv, b, w, nkv, h, bs, lens):
    """Pools over 260 pages as the engine holds them: row i owns pages
    [i * w, (i + 1) * w), poured with random K/V at its positions before
    lens - 1 and zeros after (as a prefill pour pads), so a length of
    bs * k + 1 writes a fresh page whose int8 scale starts from 0."""
    from paddle_tpu_torch.ops import paged_attention as pa

    pools = pa.alloc_paged_cache(b * w + b, nkv, bs, h, "int8" if kv == "int8" else
                                 torch.bfloat16, DEVICE)
    live = (torch.arange(w * bs, device=DEVICE)[None, :]
            < torch.tensor(lens, device=DEVICE)[:, None] - 1)            # [b, w * bs]
    live = live.reshape(b * w, 1, bs, 1)
    for pool in pools:
        vals = torch.randn(b * w, nkv, bs, h, generator=g, device=DEVICE) * live
        pa.paged_pour_blocks(pool, vals, torch.arange(b * w, device=DEVICE))
    return pools


# (case, N, Nkv, H, lens, table width): the chained engines' geometry at
# the 7B heads, GQA 32:8, a ragged case whose lengths land on a fresh page
# (bs * k + 1) and on a page's last slot (bs * k), H 64, and a full table
DECODE_CASES = [("7B", 32, 32, 128, [18, 160, 290, 680], 64),
                ("GQA", 32, 8, 128, [18, 160, 290, 680], 64),
                ("ragged", 32, 32, 128, [17, 32, 161, 256], 64),
                ("H64", 32, 32, 64, [18, 160, 290, 680], 64),
                ("full table", 32, 32, 128, [1024, 1024, 1024, 1024], 64)]


def check_decode_chains(timer, logs):
    """decode_chain_batch (bf16 and int8 pools) and decode_chain_rows (2, 4
    and 8 splits) on their sm90 route (decode_chain_sm90.cu), against the
    plain unfused ops on copies of the same pools, at every DECODE_CASES
    geometry; decode_chain.cu's kernel (the general route) on the same
    inputs must agree too and is timed beside it.  Each row names its route,
    its cluster or splits, and the sm90 kernels' registers, spills and
    dynamic shared memory."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import decode_chain as dc

    b, bs = 4, 16  # the phase-3 engine's batch and block size
    kinds = [("decode_chain_batch", "bf16", {"layout": "batch"}),
             ("decode_chain_batch", "int8", {"layout": "batch"}),
             ("decode_chain_rows", "int8", {"layout": "rows", "splits": 2}),
             ("decode_chain_rows", "int8", {"layout": "rows", "splits": 4}),
             ("decode_chain_rows", "int8", {"layout": "rows", "splits": 8})]
    out = {"decode_chain_batch": [], "decode_chain_rows": []}
    g = torch.Generator(device=DEVICE).manual_seed(8)
    for case, n, nkv, h, lens, w in DECODE_CASES:
        for name, kv, config in kinds:
            kc, vc = _chain_pools(g, kv, b, w, nkv, h, bs, lens)
            q = torch.randn(b, n, h, generator=g, device=DEVICE).to(torch.bfloat16)
            kn, vn = (torch.randn(b, nkv, h, generator=g, device=DEVICE).to(torch.bfloat16)
                      for _ in range(2))
            tables = torch.arange(b * w, device=DEVICE).reshape(b, w)
            lens_t = torch.tensor(lens, device=DEVICE)
            before = (kc.clone(), vc.clone())
            ref = (kc.clone(), vc.clone())
            gen = (kc.clone(), vc.clone())
            spec = dc.DecodeChainSpec(b, n, nkv, h, bs, w, b * w + b, kv=kv, device=DEVICE)
            fn = spec.build(config)
            splits = config.get("splits", 1)
            counts0 = ops.launch_counts()
            o, kc, vc = fn(kc, vc, q, kn, vn, tables, lens_t)
            counts1 = ops.launch_counts()
            route = "sm90" if counts1[f"{name}_sm90"] - counts0[f"{name}_sm90"] == 1 else "general"
            check(counts1[name] - counts0[name] == 1 and route == "sm90",
                  f"{name} {case} {kv}: route {route}")
            want, rk, rv = dc.decode_chain_plain(*ref, q, kn, vn, tables, lens_t)
            general = dc._decode_general(*gen, q, kn, vn, tables, lens_t, splits)
            torch.cuda.synchronize()
            differing = _differing(kc, rk) + _differing(vc, rv)
            shape = {"case": case, "pools": kv, "config": config, "b": b, "n": n, "nkv": nkv,
                     "h": h, "bs": bs, "w": w, "lens": lens}
            check(differing == 0, f"{name} {shape}: {differing} pool elements differ")
            check(_differing(gen[0], rk) + _differing(gen[1], rv) == 0,
                  f"{name} {shape}: the general kernel's pools differ")
            err = max_err(o, want)
            tol = dc._tolerance(torch.bfloat16, kv)
            check(torch.allclose(o.float(), want.float(), atol=tol, rtol=tol),
                  f"{name} {shape} disagrees with its plain version: {err}")
            check(torch.allclose(general.float(), want.float(), atol=tol, rtol=tol),
                  f"{name} {shape}: the general kernel disagrees with the plain version")
            # the least bytes of this call: each live K/V position read once
            # (a scale a page for int8), the token written (for int8 the
            # whole page where its scale grew), q, k_new, v_new, tables,
            # lens and the output once
            live, pages = sum(lens), sum(-(-x // bs) for x in lens)
            if kv == "int8":
                grew = sum(int((a.scale != p.scale).sum()) for a, p in zip((kc, vc), before))
                nbytes = 2 * (live * nkv * h + pages * nkv * 4)
                nbytes += (2 * b * nkv - grew) * h + grew * bs * h + 2 * b * nkv * 4
            else:
                nbytes = 2 * live * nkv * h * 2 + 2 * b * nkv * h * 2
            nbytes += (2 * b * n * h + 2 * b * nkv * h) * 2 + b * w * 8 + b * 8
            b_ms, b_by = bound_ms(nbytes, 4 * h * n * live, F32_FLOPS)
            parts = spec.parts(config)
            # the instantiation that ran: pool type, H, group rounded up to 1, 2, 4, 8
            group = next(x for x in (1, 2, 4, 8) if x >= n // nkv)
            pool_t = "a" if kv == "int8" else "13__nv_bfloat16"
            regs = _registers(logs, "decode_chain_sm90",
                              f"decode_chain_sm90_kernelI{pool_t}Li{h}ELi{group}E")
            row = {"check": name, "shape": shape, "route": route,
                   "cluster" if splits == 1 else "splits": parts, "max_abs_err": err,
                   "tolerance": tol, "pool_elements_differing": differing,
                   "ms": timer(lambda: fn(kc, vc, q, kn, vn, tables, lens_t)),
                   "general_ms": timer(lambda: dc._decode_general(*gen, q, kn, vn, tables,
                                                                  lens_t, splits)),
                   "plain_ms": timer(lambda: dc.decode_chain_plain(rk, rv, q, kn, vn, tables,
                                                                   lens_t), iters=3, warmup=1),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "registers": regs, "smem_bytes": spec.smem_bytes(config)}
            out[name].append(row)
            emit(row)
    return out


def _registers(logs, source, part):
    """Registers (min, max) and spill bytes of ``source``'s kernels whose
    mangled name holds ``part``, from phase 1's -Xptxas -v output."""
    res = [r for name, r in ptxas_resources(logs.get(source, "")).items() if part in name]
    if not res:
        return None  # the library was built before this run: no compiler output
    regs = [r["registers"] for r in res]
    return {"kernels": len(res), "registers": [min(regs), max(regs)],
            "spill_bytes": sum(r["spill_bytes"] for r in res)}


# (T, H, N, dtype): a 128-token chunk against the chained engines' lengths
# at the 7B heads (640 first: the longest), T not a multiple of 64, H 64,
# a long cache (2048: key splits and the combine launch); then f32 on the
# general route (FMA)
PREFILL_CASES = [(640, 128, 32, torch.bfloat16), (256, 128, 32, torch.bfloat16),
                 (128, 128, 32, torch.bfloat16), (200, 128, 32, torch.bfloat16),
                 (331, 64, 32, torch.bfloat16), (2048, 128, 32, torch.bfloat16),
                 (256, 128, 8, torch.float32)]


def check_prefill_chain(timer, F, logs):
    """prefill_chain against the plain masked attention on every case of
    PREFILL_CASES with both block_q, each row naming its route and its key
    splits; bf16 rows also time decode_chain.cu's bf16 kernel (the route
    bf16 took before the sm90 kernel) on the same inputs."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import decode_chain as dc

    out, s = [], 128
    g = torch.Generator(device=DEVICE).manual_seed(9)
    regs = {"sm90": _registers(logs, "prefill_chain_sm90", "prefill"),
            "general": _registers(logs, "decode_chain", "prefill")}
    for t, h, n, dtype in PREFILL_CASES:
        q, k, v = _qkv(g, 1, s, t, n, n, h, dtype)
        qt, kt, vt = _library_views(q, k, v)
        lib = _library_sdpa(F, qt, kt, vt)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = F32_FLOPS if dtype == torch.float32 else BF16_TC_FLOPS
        b_ms, b_by = bound_ms(nbytes, 4 * n * h * _allowed_pairs(s, t, True), peak)
        want = dc.prefill_chain_plain(q, k, v)
        plain_ms = timer(lambda: dc.prefill_chain_plain(q, k, v), iters=3, warmup=1)
        lib_ms = timer(lib)
        tol = dc._tolerance(dtype)
        for bq in (128, 64):
            before = ops.launch_counts()
            got = dc.prefill_chain(q, k, v, block_q=bq)
            after = ops.launch_counts()
            check(after["prefill_chain"] - before["prefill_chain"] == 1,
                  f"prefill_chain launches {after}")
            route = ("sm90" if after["prefill_chain_sm90"] - before["prefill_chain_sm90"] == 1
                     else "general")
            check(route == dc._prefill_route(dtype), f"prefill_chain {dtype}: route {route}")
            torch.cuda.synchronize()
            err = max_err(got, want)
            shape = {"q": list(q.shape), "kv": list(k.shape), "block_q": bq,
                     "dtype": str(dtype).split(".")[-1]}
            check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                  f"prefill_chain {shape} ({route}) disagrees with its plain version: {err}")
            row = {"check": "prefill_chain", "shape": shape, "route": route,
                   "splits": dc.prefill_splits(s, t, n, bq, dc.sm_count(q.device))
                   if route == "sm90" else 1,
                   "max_abs_err": err, "tolerance": tol,
                   "ms": timer(lambda: dc.prefill_chain(q, k, v, block_q=bq)),
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms, "registers": regs[route]}
            if route == "sm90":
                general = dc._prefill_general(q, k, v, bq)
                torch.cuda.synchronize()
                check(torch.allclose(general.float(), want.float(), atol=tol, rtol=tol),
                      f"prefill_chain {shape}: the general kernel disagrees")
                row["general_ms"] = timer(lambda: dc._prefill_general(q, k, v, bq))
            out.append(row)
            emit(row)
    return out


F32_TOL_LN = 2e-5              # f32 LayerNorm: kernel and plain sum in other orders
F32_TOL_MM = 1e-4              # f32 matmul epilogue: FMA vs the plain product, K <= 768


def check_layer_norm(timer, F):
    """fused_layer_norm against its plain version: BERT-base rows [4096,
    768] in bf16 with and without the residual, in f32, and a ragged
    hidden size (1000).  The written sum x + r must be bit-exact."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.fused_norm import layer_norm_plain

    out, eps = [], 1e-12
    g = torch.Generator(device=DEVICE).manual_seed(11)
    for rows, hidden, dtype, residual in ((4096, 768, torch.bfloat16, True),
                                          (4096, 768, torch.bfloat16, False),
                                          (4096, 768, torch.float32, True),
                                          (4096, 1000, torch.bfloat16, True)):
        x = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype)
        r = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype) if residual else None
        w = (1 + 0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(dtype)
        b = (0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(dtype)
        tol = TOL if dtype == torch.bfloat16 else F32_TOL_LN

        def kernel():
            return ops.fused_layer_norm(x, w, b, epsilon=eps, residual=r)

        def plain():
            s = x + r if residual else x
            return layer_norm_plain(s, w, b, eps), s

        got, want = kernel(), plain()
        if not residual:
            got = (got, x)
        torch.cuda.synchronize()
        err = max_err(got[0], want[0])
        shape = {"rows": [rows, hidden], "dtype": str(dtype).split(".")[-1],
                 "residual": residual}
        check(torch.allclose(got[0].float(), want[0].float(), atol=tol, rtol=tol),
              f"fused_layer_norm {shape} disagrees with its plain version: {err}")
        check(torch.equal(got[1], want[1]), f"fused_layer_norm {shape}: x + r is not bit-exact")
        elt = x.element_size()
        nbytes = ((4 if residual else 2) * x.numel() + 2 * hidden) * elt
        b_ms, b_by = bound_ms(nbytes, (9 if residual else 8) * x.numel(), F32_FLOPS)
        out.append({"check": "fused_layer_norm", "shape": shape, "max_abs_err": err,
                    "tolerance": tol, "ms": timer(kernel), "plain_ms": timer(plain),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": timer(lambda: F.layer_norm(x + r if residual else x, (hidden,),
                                                             w, b, eps))})
        emit(out[-1])
    return out


def _library_epilogue(F, x, w, bias, act):
    """One PyTorch call (two where no single call applies the activation)
    computing act(x @ w + bias): the yardstick only."""
    pre = (lambda: torch.addmm(bias, x, w)) if bias is not None else (lambda: torch.mm(x, w))
    post = {"none": lambda v: v, "relu": F.relu, "gelu": F.gelu, "silu": F.silu,
            "gelu_tanh": lambda v: F.gelu(v, approximate="tanh")}[act]
    return lambda: post(pre())


def check_matmul_epilogue(timer, F, logs):
    """matmul_bias_act against its plain version: BERT-base's FFN product
    [4096, 768] x [768, 3072] for every activation, with and without bias,
    in bf16 and f16 (the sm90 route), ragged M (100) and K 72 (sm90 too);
    then the general route: f32 at the FFN shape and an odd shape (M 100,
    K 72, N 130: 260-byte rows) in bf16, f16 and f32.  Each row names its
    route; sm90 rows also time the general kernel on the same inputs.  The
    first row (gelu with bias in bf16, the main path's call) comes first."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import matmul_epilogue as me

    out = []
    g = torch.Generator(device=DEVICE).manual_seed(12)
    acts = ["gelu"] + [a for a in me.ACTIVATIONS if a != "gelu"]
    ffn = (4096, 768, 3072)
    cases = [(*ffn, dt, act, bias) for dt in (torch.bfloat16, torch.float16)
             for act in acts for bias in (True, False)]
    cases += [(100, 768, 3072, torch.bfloat16, "gelu", True),
              (4096, 72, 3072, torch.bfloat16, "gelu", True)]
    cases += [(*ffn, torch.float32, act, bias) for act in acts for bias in (True, False)]
    cases += [(100, 72, 130, dt, act, True) for dt in (torch.bfloat16, torch.float32)
              for act in acts]
    cases += [(100, 72, 130, torch.float16, "gelu", True)]
    regs = {"sm90": _registers(logs, "matmul_epilogue_sm90", "matmul"),
            "general": _registers(logs, "matmul_epilogue", "matmul")}
    for m, k, n, dtype, act, bias in cases:
        x = (torch.randn(m, k, generator=g, device=DEVICE) / k ** 0.5).to(dtype)
        w = torch.randn(k, n, generator=g, device=DEVICE).to(dtype)
        bvec = (0.5 * torch.randn(n, generator=g, device=DEVICE)).to(dtype) if bias else None
        before = ops.launch_counts()
        got = ops.matmul_bias_act(x, w, bvec, act)
        after = ops.launch_counts()
        check(after["matmul_epilogue"] - before["matmul_epilogue"] == 1,
              f"matmul_bias_act launches {after}")
        route = ("sm90" if after["matmul_epilogue_sm90"] - before["matmul_epilogue_sm90"] == 1
                 else "general")
        want = me.matmul_bias_act_plain(x, w, bvec, act)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = F32_TOL_MM if dtype == torch.float32 else TOL
        shape = {"mkn": [m, k, n], "dtype": str(dtype).split(".")[-1], "activation": act,
                 "bias": bias}
        check(route == ("general" if dtype == torch.float32 or n % 8 else "sm90"),
              f"matmul_bias_act {shape}: route {route}")
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"matmul_bias_act {shape} ({route}) disagrees with its plain version: {err}")
        elt = x.element_size()
        nbytes = (m * k + k * n + m * n + (n if bias else 0)) * elt
        peak = F32_FLOPS if dtype == torch.float32 else BF16_TC_FLOPS
        b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, peak)
        row = {"check": "matmul_epilogue", "shape": shape, "route": route, "max_abs_err": err,
               "tolerance": tol,
               "ms": timer(lambda: ops.matmul_bias_act(x, w, bvec, act)),
               "plain_ms": timer(lambda: me.matmul_bias_act_plain(x, w, bvec, act)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": timer(_library_epilogue(F, x, w, bvec, act)),
               "registers": regs[route]}
        if route == "sm90":
            general = me._launch("general", x, w, bvec, act)
            torch.cuda.synchronize()
            check(torch.allclose(general.float(), want.float(), atol=tol, rtol=tol),
                  f"matmul_bias_act {shape}: the general kernel disagrees")
            row["general_ms"] = timer(lambda: me._launch("general", x, w, bvec, act))
        out.append(row)
        emit(row)
    return out


def triton_resources():
    """Registers, spills and shared memory of every compiled variant of
    the Triton LayerNorm and of the two Triton yardsticks (read from the
    JIT's cache after phase 2)."""
    fused_norm = importlib.import_module("paddle_tpu_torch.ops.fused_norm")
    swiglu = importlib.import_module("paddle_tpu_torch.ops.swiglu")
    kernels = {"fused_rms_norm": fused_norm._KERNELS["_rms_norm_kernel"],
               "fused_layer_norm": fused_norm._KERNELS["_layer_norm_kernel"],
               "swiglu": swiglu._KERNEL}
    out = {name: [{"registers": ck.n_regs, "spills": ck.n_spills,
                   "shared_bytes": ck.metadata.shared}
                  for entry in jit.device_caches.values() for ck in entry[0].values()]
           for name, jit in kernels.items()}
    emit({"triton_resources": out})


# ------------------------------------------------------- the codegen kernels

CODEGEN_F32_REL = 1e-5           # f32: 1e-5 relative (+ a tenth of it at the largest
                                 # magnitude: products summed in another order)
VPU_LAUNCHES = [(128, 4), (256, 4), (256, 8), (512, 8)]  # (threads, elements a thread)


def _capture(build, feeds):
    from paddle_tpu_torch import static

    main = static.Program()
    with static.program_guard(main):
        out = build(*[static.data(n, list(s), d) for n, s, d in feeds])
    return main, out


def bert_mask_chain(ids):
    """BertModel.forward's additive attention mask, the same ops."""
    m = (ids != 0).to(torch.int32)
    return (1 - m.float()) * -1e4


def jax_test_chain(a, b):
    """The JAX package's generic-fusion test chain (8 ops)."""
    return torch.sqrt(torch.exp(torch.tanh(a * b + a) * 0.5) + 1.0) * b


def softmax_dag(x):
    """The decomposed softmax of bench_schedule_search.py."""
    t = torch.exp(x - torch.max(x, -1, keepdim=True).values)
    return t / torch.sum(t, -1, keepdim=True)


def matmul_mean(x, w, b):
    return torch.mean(torch.relu(torch.matmul(x, w) + b), -1, keepdim=True)


def relu_linear(x, w, b):
    return torch.relu(torch.matmul(x, w) + b)


def pooler(x, w, b):
    from paddle_tpu_torch.nn import functional as PF

    return PF.tanh(PF.linear(x, w, b))


VPU_CASES = {  # name -> (chain, feeds): BERT's mask at phase 6's batch; the JAX test chain at
               # BERT-base's FFN activation size
    "bert_mask": (bert_mask_chain, [("ids", (32, 128), "int32")]),
    "jax_chain_bf16": (jax_test_chain, [("a", (4096, 3072), "bfloat16"),
                                        ("b", (4096, 3072), "bfloat16")]),
}
SCHED_CASES = {  # bench_schedule_search.py:106-108's shapes on the chip; BERT-base's pooler;
                 # the softmax at BERT-base's attention logits.  The first whole-K and the
                 # first split case are the ones the main paths run (phase 6).
    "softmax_f32": (softmax_dag, [("x", (8, 128, 512), "float32")]),
    "pooler_bf16": (pooler, [("x", (32, 768), "bfloat16"), ("w", (768, 768), "bfloat16"),
                             ("b", (768,), "bfloat16")]),
    "softmax_bf16": (softmax_dag, [("x", (32, 12, 128, 128), "bfloat16")]),
    "matmul_mean_f32": (matmul_mean, [("x", (1024, 512), "float32"),
                                      ("w", (512, 512), "float32"), ("b", (512,), "float32")]),
    "ktiled_f32": (relu_linear, [("x", (1024, 2048), "float32"), ("w", (2048, 1024), "float32"),
                                 ("b", (1024,), "float32")]),
}
SCHED_PROGRAMS = ("matmul_mean_f32", "ktiled_f32", "softmax_f32")  # phase 6's programs


def codegen_cases():
    """Phase 2's generated kernels, captured and discovered on the host:
    the elementwise chains' kernels and the subgraph specs, with every
    generated source (built together with csrc/ in phase 1)."""
    from paddle_tpu_torch.static import schedule_search as ss
    from paddle_tpu_torch.static.passes import apply_pass
    from paddle_tpu_torch.static.rewrite import ProgramGraph

    vpu, specs = {}, {}
    for name, (build, feeds) in VPU_CASES.items():
        main, out = _capture(build, feeds)
        check(apply_pass(main, "generic_elementwise_fusion", fetch_vids=[out._vid]) == 1,
              f"{name}: the elementwise chain was not fused")
        vpu[name] = main.global_block().ops[-1]
    for name, (build, feeds) in SCHED_CASES.items():
        main, out = _capture(build, feeds)
        graph = ProgramGraph(main, (out._vid,))
        found = [sp for sp in (ss.match_subgraph(op, graph, device=DEVICE)
                               for op in main.global_block().ops) if sp]
        check(len(found) == 1, f"{name}: {len(found)} subgraphs discovered")
        specs[name] = found[0]
    sources = {n: op.fn.source for n, op in vpu.items()}
    sources.update({n: sp.source() for n, sp in specs.items()})
    return vpu, specs, sources


def ptxas_resources(log):
    """(kernel -> registers, spill bytes) from nvcc's -Xptxas -v output."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "spill_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _resources(build_info, source):
    """The generated library's nvcc seconds, and its kernels' registers
    (min, max) and spill bytes, from -Xptxas -v."""
    from paddle_tpu_torch.ops import _cuda_build

    info = build_info.get(str(_cuda_build.generated_path(source)), {"log": "", "seconds": 0.0})
    res = ptxas_resources(info["log"])
    regs = [r["registers"] for r in res.values()] or [0]
    return {"nvcc_s": info["seconds"], "kernels": len(res), "registers": [min(regs), max(regs)],
            "spill_bytes": sum(r["spill_bytes"] for r in res.values())}


def _codegen_close(got, want, dtype):
    from paddle_tpu_torch.static.schedule_search import parity_tolerance

    rtol, atol = parity_tolerance(dtype, want)
    return bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol,
                               equal_nan=True)), rtol


def check_vpu_chains(timer, vpu, build_info):
    """#11 at its default and tuned launch shapes against the replay of
    the recorded ops: the mask chain bit-exact, bf16 within one bf16
    step.  Rows: the mask chain (the static BERT path's call) first."""
    g = torch.Generator(device=DEVICE).manual_seed(31)
    out = []
    for name, op in vpu.items():
        kernel = op.fn
        if name == "bert_mask":
            ids = torch.randint(0, 3, (32, 128), generator=g, device=DEVICE, dtype=torch.int32)
            inputs = [ids != 0]
        else:
            inputs = [torch.randn(*VPU_CASES[name][1][i][1], generator=g, device=DEVICE)
                      .to(torch.bfloat16) for i in range(2)]
        want = kernel.replay(*inputs)
        default = kernel.default_launch()
        launch_ms, err = {}, 0.0
        for launch in [default] + [l for l in VPU_LAUNCHES if l != default]:
            got = kernel(*inputs, launch=launch)
            torch.cuda.synchronize()
            ok, tol = _codegen_close(got, want, want.dtype)
            if name == "bert_mask":
                ok, tol = torch.equal(got, want), 0.0
            err = max(err, max_err(got, want))
            check(ok, f"vpu_chain {name} at launch {launch} disagrees with the replay: {err}")
            launch_ms[f"{launch[0]}x{launch[1]}"] = timer(
                lambda launch=launch: kernel(*inputs, launch=launch))
        nbytes = sum(t.numel() * t.element_size() for t in inputs) + want.numel() * \
            want.element_size()
        b_ms, b_by = bound_ms(nbytes, len(kernel.ops) * want.numel(), F32_FLOPS)
        out.append({"check": "vpu_chain", "case": name, "shape": {
                        "shape": list(want.shape), "inputs": [str(t.dtype).split(".")[-1]
                                                              for t in inputs],
                        "out": str(want.dtype).split(".")[-1], "ops": len(kernel.ops)},
                    "max_abs_err": err, "tolerance": tol,
                    "ms": launch_ms[f"{default[0]}x{default[1]}"], "launch_default": default,
                    "launch_ms": launch_ms, "plain_ms": timer(lambda: kernel.replay(*inputs)),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    **_resources(build_info, kernel.source)})
        emit(out[-1])
    return out


def _spec_bound(spec):
    nbytes = sum(math.prod(e.shape) * e.dtype.itemsize for e in spec.ext)
    nbytes += math.prod(spec.out_shape) * spec.out_dtype.itemsize
    flops = sum(2.0 * spec.rows * k * spec.cols for k in spec.k_dims)
    flops += (len(spec.ops) - len(spec.k_dims)) * spec.rows * spec.cols
    mm_bf16 = spec.kind == "matmul" and any(e.dtype == torch.bfloat16 for e in spec.ext)
    return bound_ms(nbytes, flops, BF16_TC_FLOPS if mm_bf16 else F32_FLOPS)


def check_sched_chains(timer, specs, build_info):
    """#12 and #13 at every enumerated config of each subgraph against the
    replay (the gate's twin) on the spec's synthetic inputs, within the
    parity gate's tolerance (bf16 one step, f32 1e-5).  Returns the rows of
    sched_chain (the best whole-K config of each case; the softmax program
    of phase 6 first) and of sched_chain_ktiled (the best split config;
    the BERT pooler first)."""
    F = torch.nn.functional
    whole, split = [], []
    for name, spec in specs.items():
        args = spec.synthetic_args()
        want = spec.reference()(*args)
        configs, err = [], 0.0
        for cfg in spec.enumerate_configs():
            fn = spec.build(cfg)
            got = fn(*args)
            torch.cuda.synchronize()
            ok, tol = _codegen_close(got, want, spec.out_dtype)
            e = max_err(got, want)
            err = max(err, e)
            check(ok, f"sched_chain {name} {spec.config_label(cfg)} disagrees with the "
                      f"replay: {e}")
            is_split = bool(cfg.get("block_k")) and cfg["block_k"] < spec.k_dims[0]
            configs.append({"config": spec.config_label(cfg), "split": is_split,
                            "ms": timer(lambda fn=fn: fn(*args)), "max_abs_err": e,
                            "smem_bytes": spec.smem_bytes(cfg)})
        b_ms, b_by = _spec_bound(spec)
        library = None
        if name.startswith("softmax"):
            library = timer(lambda: torch.softmax(args[0], -1))
        shape = {"rows": spec.rows, "cols": spec.cols, "k": list(spec.k_dims),
                 "dtype": str(spec.out_dtype).split(".")[-1], "ops": [o.type for o in spec.ops]}
        common = {"case": name, "shape": shape, "max_abs_err": err, "tolerance": tol,
                  "plain_ms": timer(lambda: spec.reference()(*args)), "bound_ms": b_ms,
                  "bound_by": b_by, "library_ms": library, **_resources(build_info,
                                                                          spec.source())}
        for rows_out, kernel, pick in ((whole, "sched_chain", False),
                                       (split, "sched_chain_ktiled", True)):
            mine = [c for c in configs if c["split"] == pick]
            if mine:
                best = min(mine, key=lambda c: c["ms"])
                rows_out.append({"check": kernel, **common, "ms": best["ms"],
                                 "config": best["config"], "configs": mine})
        emit({"check": "sched_chain configs", "case": name, "configs": configs})
    for row in whole + split:
        emit({k: v for k, v in row.items() if k != "configs"})
    return whole, split


def time_plain_backwards(timer):
    """The plain-torch backward of RMSNorm and SwiGLU at the training
    shapes (no kernel: the JAX package's backward is plain jnp too)."""
    from paddle_tpu_torch.ops.fused_norm import rms_norm_bwd
    from paddle_tpu_torch.ops.swiglu import swiglu_bwd

    g = torch.Generator(device=DEVICE).manual_seed(7)
    out = []
    rows, hidden = 4096, 2048
    x = torch.randn(rows, hidden, generator=g, device=DEVICE).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(torch.bfloat16)
    gy = torch.randn(rows, hidden, generator=g, device=DEVICE).to(torch.bfloat16)
    b_ms, b_by = bound_ms(3 * x.numel() * 2 + 2 * hidden * 2, 10 * x.numel(), F32_FLOPS)
    out.append({"check": "rms_norm_backward_plain", "shape": [rows, hidden],
                "plain_ms": timer(lambda: rms_norm_bwd(x, w, gy, 1e-6)),
                "bound_ms": b_ms, "bound_by": b_by})
    emit(out[-1])
    cols = 5632
    gate_up = torch.randn(rows, 2 * cols, generator=g, device=DEVICE).to(torch.bfloat16)
    xs, ys = gate_up.chunk(2, dim=-1)
    gy = torch.randn(rows, cols, generator=g, device=DEVICE).to(torch.bfloat16)
    b_ms, b_by = bound_ms(5 * rows * cols * 2, 10 * rows * cols, F32_FLOPS)
    out.append({"check": "swiglu_backward_plain", "shape": [rows, cols],
                "plain_ms": timer(lambda: swiglu_bwd(xs, ys, gy)),
                "bound_ms": b_ms, "bound_by": b_by})
    emit(out[-1])
    return out


def plain_forward(model, ids):
    """The model's forward built only from the plain versions of the
    three kernels (the weights and the matmuls are the model's own)."""
    from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
    from paddle_tpu_torch.ops import flash_attention_reference
    from paddle_tpu_torch.ops.fused_norm import rms_norm_plain
    from paddle_tpu_torch.ops.swiglu import swiglu_plain

    mm, eps = model.model, model.config.rms_norm_eps
    h = mm.embed_tokens(ids)
    for layer in mm.layers:
        a = layer.self_attn
        x = rms_norm_plain(h, layer.input_layernorm.weight, eps)
        b, s, _ = x.shape
        q = a.q_proj(x).reshape(b, s, a.num_heads, a.head_dim)
        k = a.k_proj(x).reshape(b, s, a.num_kv_heads, a.head_dim)
        v = a.v_proj(x).reshape(b, s, a.num_kv_heads, a.head_dim)
        q, k = apply_rotary_pos_emb(q, k, mm.rope_cos, mm.rope_sin)
        o = flash_attention_reference(q, k, v, causal=True)
        h = h + a.o_proj(o.reshape(b, s, a.num_heads * a.head_dim))
        x = rms_norm_plain(h, layer.post_attention_layernorm.weight, eps)
        gate, up = layer.mlp.gate_up_proj(x).chunk(2, dim=-1)
        h = h + layer.mlp.down_proj(swiglu_plain(gate, up))
    return model._logits(rms_norm_plain(h, mm.norm.weight, eps))


def model_config():
    from paddle_tpu_torch.models import llama_7b

    return llama_7b(dtype="bfloat16")


ENGINE_KW = dict(max_batch=4, block_size=16, num_blocks=256, decode_chunk=8)
SERVE_NEW = 32  # new tokens a request
# the searched serving chains: GenerationEngine(model, kv_cache_dtype=...,
# prefill_chunk=128) under FLAGS_schedule_search, on int8 or bf16 pools
CHAINED = {"int8": dict(kv_cache_dtype="int8", prefill_chunk=128),
           "bf16": dict(kv_cache_dtype="bf16", prefill_chunk=128)}


def build_model():
    """LLaMA-7B at full width and depth with seeded random weights."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = model_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, {cfg.dtype}, "
          f"{n_params} parameters, built in {time.perf_counter() - t0:.1f} s", flush=True)
    return model


def serving_prompts(cfg):
    g = torch.Generator().manual_seed(5)
    return {f"r{s}": torch.randint(0, cfg.vocab_size, (s,), generator=g).tolist()
            for s in (17, 128, 250, 640)}


def build_engine(model=None, **engine_kw):
    """The phase-3 configuration: the model (built when not given), an
    engine over it (``engine_kw`` adds to ENGINE_KW: a CHAINED entry for
    the chained engines, whose searches need FLAGS_schedule_search on at
    their first use), the prompts and the new-token budget."""
    from paddle_tpu_torch.serving import GenerationEngine

    model = model if model is not None else build_model()
    engine = GenerationEngine(model, **ENGINE_KW, **engine_kw, device=DEVICE)
    return model, engine, serving_prompts(model.config), SERVE_NEW


def expected_counts(engine, lengths, steps):
    """Every kernel's launches implied by one serving run: the prefill
    forwards (whole prompts, or prefill_chunk chunks: a chunk the accepted
    prefill config tiles runs the prefill chain, the rest flash attention),
    then steps x D decode token iterations (the accepted decode config's
    kernel, one launch a layer), 2L + 1 RMSNorms and L SwiGLUs a forward."""
    layers = engine.model.config.num_hidden_layers
    chunk, pf_cfg = engine.prefill_chunk, engine._prefill_chain_cfg
    forwards = flash = prefill_chain = 0
    for s0 in lengths:
        cuts = ([s0] if chunk is None or s0 <= chunk
                else [min(chunk, s0 - off) for off in range(0, s0, chunk)])
        for c in cuts:
            forwards += 1
            if chunk is not None and s0 > chunk and pf_cfg and c % pf_cfg["block_q"] == 0:
                prefill_chain += 1
            else:
                flash += 1
    iters = steps * engine._effective_chunk()
    want = {"fused_rms_norm": (2 * layers + 1) * (forwards + iters),
            "swiglu": layers * (forwards + iters), "flash_attention_fwd": layers * flash,
            "flash_attention_fwd_sm90": layers * flash,  # every LLaMA prefill takes the TMA kernel
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,  # serving: no backward
            "flash_attention_bwd_dq_sm90": 0, "flash_attention_bwd_dkv_sm90": 0,
            "decode_chain_batch": 0, "decode_chain_rows": 0,
            "decode_chain_batch_sm90": 0, "decode_chain_rows_sm90": 0,
            "prefill_chain": layers * prefill_chain,
            "prefill_chain_sm90": layers * prefill_chain,  # bf16 chunks take the TMA kernel
            "fused_layer_norm": 0, "matmul_epilogue": 0,  # LLaMA has neither
            "matmul_epilogue_sm90": 0,
            "vpu_chain": 0, "sched_chain": 0, "sched_chain_ktiled": 0}  # nor a static Program
    dec_cfg = engine._decode_chain_cfg
    if dec_cfg:  # bf16 models: every decode chain on the sm90 route
        want[f"decode_chain_{dec_cfg['layout']}"] = layers * iters
        want[f"decode_chain_{dec_cfg['layout']}_sm90"] = layers * iters
    return want


def serve_engine(engine, prompts, new):
    """One warm-up pass over the prompts (cuBLAS picks its algorithms per
    shape; the chained engines run their searches here), then the measured
    run with every launch count set to 0 just before it.  Checks the
    streams and the launch counts."""
    from paddle_tpu_torch import ops

    cfg = engine.model.config
    for rid, p in prompts.items():
        engine.add_request("warm-" + rid, p, max_new_tokens=2)
    while engine.has_work():
        engine.step()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    firsts = {rid: engine.add_request(rid, p, max_new_tokens=new) for rid, p in prompts.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = 0
    while engine.has_work():
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    check(not any(ops.yardstick_counts().values()),
          f"serving: a Triton yardstick launched: {ops.yardstick_counts()}")

    check(all(f is not None for f in firsts.values()), "a request was queued, not admitted")
    for rid in prompts:
        stream = engine.result(rid)
        check(len(stream) == new, f"{rid}: {len(stream)} tokens, expected {new}")
        check(all(0 <= t < cfg.vocab_size for t in stream), f"{rid}: token id out of range")
    lengths = [len(p) for p in prompts.values()]
    want = expected_counts(engine, lengths, steps)
    check(counts == want, f"launch counts {counts} != expected {want}")
    prefill_tokens, decode_tokens = sum(lengths), len(lengths) * (new - 1)
    return counts, {"requests": len(lengths), "prompt_lengths": lengths,
                    "new_tokens_each": new, "decode_chunk": engine._effective_chunk(),
                    "steps": steps, "launches": counts,
                    "triton_yardstick_launches": ops.yardstick_counts(),
                    "prefill_s": t1 - t0, "prefill_tokens_per_s": prefill_tokens / (t1 - t0),
                    "decode_s": t2 - t1, "decode_tokens_per_s": decode_tokens / (t2 - t1),
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "pool_bytes": engine.pool_bytes()}


def check_first_token(model, engine, ids, want_logits):
    """The longest request's first-token logits through the engine's own
    prefill path (whole, or chunked under its accepted prefill config)
    against a forward of plain versions only."""
    from paddle_tpu_torch.models.llama import _model_forward_cached, prefill_chain_scope

    cfg = model.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    caches = [(torch.zeros(1, 0, cfg.num_key_value_heads, head_dim, dtype=cfg.torch_dtype,
                           device=DEVICE),) * 2 for _ in range(cfg.num_hidden_layers)]
    chunk, s0 = engine.prefill_chunk, ids.shape[1]
    with torch.no_grad(), prefill_chain_scope(engine._prefill_chain_cfg if chunk else None):
        for off in range(0, s0, chunk or s0):
            h, caches = _model_forward_cached(model.model, ids[:, off:off + (chunk or s0)],
                                              caches, off)
        got = model._logits(h[:, -1:, :])[0, -1].float()
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    rel = float((got - want_logits).norm() / want_logits.norm())
    check(rel <= LOGITS_REL_TOL, f"first-token logits: relative L2 {rel} > {LOGITS_REL_TOL}")
    return got, {"first_token_logits_rel_l2": rel,
                 "first_token_logits_max_abs_err": float((got - want_logits).abs().max())}


def check_chained_step(model, engine):
    """One decode step with the engine's accepted decode config against the
    same step unfused, on copies of the engine's pools (4 rows owning
    disjoint pages, lengths 18, 160, 290, 680).  Each layer's chained and
    unfused step get the same input (the unfused step's hidden state), so
    their writes must leave the pools bit-exact; the logits of the whole
    chained step are held within LOGITS_REL_TOL relative L2 of the
    unfused one's."""
    from paddle_tpu_torch.models.llama import _decode_layer_paged, _decode_layers_paged

    mm, b, cfg = model.model, engine.max_batch, engine._decode_chain_cfg
    w = engine._max_blocks_per_seq
    tables = torch.arange(b * w, device=DEVICE).reshape(b, w)
    lens = torch.tensor([18, 160, 290, 680], device=DEVICE)
    h0 = mm.embed_tokens(torch.tensor([[11], [22], [33], [44]], device=DEVICE))
    h, differing = h0, 0
    for layer, kc, vc in zip(mm.layers, engine._kpools, engine._vpools):
        ref = _decode_layer_paged(layer, h, mm.rope_cos, mm.rope_sin, kc.clone(), vc.clone(),
                                  tables, lens)
        got = _decode_layer_paged(layer, h, mm.rope_cos, mm.rope_sin, kc.clone(), vc.clone(),
                                  tables, lens, cfg)
        differing += _differing(got[1], ref[1]) + _differing(got[2], ref[2])
        h = ref[0]
    check(differing == 0, f"chained decode step: {differing} pool elements differ from unfused")
    want = model._logits(mm.norm(h))[:, -1].float()
    hh, _, _ = _decode_layers_paged(mm.layers, h0, mm.rope_cos, mm.rope_sin,
                                    [p.clone() for p in engine._kpools],
                                    [p.clone() for p in engine._vpools], tables, lens, cfg)
    got = model._logits(mm.norm(hh))[:, -1].float()
    rel = float((got - want).norm() / want.norm())
    check(rel <= LOGITS_REL_TOL, f"chained decode step: logits relative L2 {rel}")
    return {"chained_step_pool_elements_differing": differing, "chained_step_logits_rel_l2": rel}


def _differing(a, b):
    """Elements (payload and scales of an int8 pool) that differ."""
    if hasattr(a, "scale"):
        return int((a.data != b.data).sum()) + int((a.scale != b.scale).sum())
    return int((a != b).sum())


def _decision(d):
    return None if d is None else {"status": d.status, "config": d.config,
                                   "kernel_ms": d.kernel_ms, "plain_ms": d.plain_ms,
                                   "win": d.win}


def serve(card):
    """Phase 3: the default engine, then the chained int8 and bf16 engines
    over the same model; returns each path's launch counts."""
    import tempfile

    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.serving import reset_schedule_decode_stats, schedule_decode_stats

    model = build_model()
    cfg = model.config
    prompts = serving_prompts(cfg)
    rid = max(prompts, key=lambda r: len(prompts[r]))
    ids = torch.tensor([prompts[rid]], device=DEVICE)
    with torch.no_grad():
        want_logits = plain_forward(model, ids)[0, -1].float()
    engine_name = f"llama_7b {cfg.dtype} {cfg.num_hidden_layers} layers"

    _, engine, _, new = build_engine(model)
    counts, result = serve_engine(engine, prompts, new)
    got, first = check_first_token(model, engine, ids, want_logits)
    check(int(got.argmax()) == engine.result(rid)[0],
          "the engine's first token is not the argmax of its prefill logits")
    paths = {"serving": counts}
    default_pool_bytes = result["pool_bytes"]
    emit({"engine": engine_name, "card": card, **result, **first})
    del engine
    for kv, kw in CHAINED.items():
        cache_dir = tempfile.mkdtemp(prefix="autotune-")  # the search runs every smoke run
        set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": cache_dir})
        reset_schedule_decode_stats()
        try:
            _, engine, _, _ = build_engine(model, **kw)
            counts, result = serve_engine(engine, prompts, new)
            stats = schedule_decode_stats()
            check(stats["decode_chains_accepted"] == 1 and stats["prefill_chains_accepted"] == 1,
                  f"{kv} chained engine: a chain lost the measured-win gate: {stats}, "
                  f"{_decision(engine.decode_decision)}, {_decision(engine.prefill_decision)}")
            layers = cfg.num_hidden_layers
            check(counts["prefill_chain"] == 6 * layers
                  and counts["flash_attention_fwd"] == 3 * layers,
                  f"{kv} chained engine: prefill launches {counts}")
            got, first = check_first_token(model, engine, ids, want_logits)
            check(int(got.argmax()) == engine.result(rid)[0],
                  f"{kv} chained engine: first token is not the argmax of its prefill logits")
            with torch.no_grad():
                step = check_chained_step(model, engine)
        finally:
            set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
            shutil.rmtree(cache_dir, ignore_errors=True)
        paths[f"serving_{kv}_chained"] = counts
        emit({"engine": f"{engine_name}, {kv} pools, prefill_chunk 128, schedule search",
              "card": card, **result, **first, **step,
              "decode_decision": _decision(engine.decode_decision),
              "prefill_decision": _decision(engine.prefill_decision),
              "schedule_decode_stats": stats,
              "pool_bytes_default_engine": default_pool_bytes})
        del engine
    return paths


def train_config():
    """The flagship training configuration of bench.py (its on-accelerator
    branch): full width and depth."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                       num_hidden_layers=8, num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=1024, dtype="bfloat16")


def _loss_fn(model, ids, labels):
    return model(ids, labels=labels)[0]


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def check_first_step(model, ids, labels):
    """The first step's loss and gradients through the kernels against a
    backward through a forward built only from the plain versions, from
    the same weights."""
    from paddle_tpu_torch.nn import functional as tF

    names = ["model.embed_tokens.weight", "model.layers.0.self_attn.q_proj.weight",
             "model.layers.7.mlp.down_proj.weight", "lm_head.weight"]
    params = dict(model.named_parameters())
    results = []
    for path in ("kernels", "plain"):
        model.zero_grad(set_to_none=True)
        if path == "kernels":
            loss = _loss_fn(model, ids, labels)
        else:
            logits = plain_forward(model, ids)
            loss = tF.cross_entropy(logits.float().reshape(-1, model.config.vocab_size),
                                    labels.reshape(-1))
        loss.backward()
        results.append((float(loss.detach()), {n: params[n].grad.clone() for n in names}))
    model.zero_grad(set_to_none=True)
    (k_loss, k_grads), (p_loss, p_grads) = results
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    check(loss_rel <= LOSS_REL_TOL, f"first training loss {k_loss} vs plain {p_loss}")
    rels = {}
    for n in names:
        check(bool(torch.isfinite(k_grads[n]).all()), f"non-finite gradient of {n}")
        rels[n] = _rel_l2(k_grads[n], p_grads[n])
        check(rels[n] <= GRAD_REL_TOL, f"first-step gradient of {n}: relative L2 {rels[n]} "
              f"> {GRAD_REL_TOL}")
    return {"loss": k_loss, "plain_loss": p_loss, "loss_rel_diff": loss_rel,
            "grad_rel_l2": rels}


def train(card):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = train_config()
    batch, seq, warmup, timed = 4, 1024, 3, 10
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=torch.Generator(device=DEVICE).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=DEVICE).manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device=DEVICE)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device=DEVICE)
    first = check_first_step(model, ids, labels)

    step = TrainStep(model, AdamW(learning_rate=1e-4, parameters=model.parameters(),
                                  weight_decay=0.01), _loss_fn)
    layers = cfg.num_hidden_layers
    # every flash forward and backward on the sm90 route
    per_step = {"fused_rms_norm": 2 * layers + 1, "swiglu": layers, "flash_attention_fwd": layers,
                "flash_attention_fwd_sm90": layers, "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers, "flash_attention_bwd_dq_sm90": layers,
                "flash_attention_bwd_dkv_sm90": layers, "decode_chain_batch": 0,
                "decode_chain_rows": 0, "decode_chain_batch_sm90": 0, "decode_chain_rows_sm90": 0,
                "prefill_chain": 0, "prefill_chain_sm90": 0,
                "fused_layer_norm": 0, "matmul_epilogue": 0, "matmul_epilogue_sm90": 0,
                "vpu_chain": 0, "sched_chain": 0, "sched_chain_ktiled": 0}
    losses, totals = [], dict.fromkeys(per_step, 0)
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        ops.reset_launch_counts()
        losses.append(step(ids, labels))
        counts = ops.launch_counts()
        check(counts == per_step, f"training step {i}: launch counts {counts} != {per_step}")
        check(not any(ops.yardstick_counts().values()),
              f"training step {i}: a Triton yardstick launched: {ops.yardstick_counts()}")
        if i >= warmup:
            totals = {k: totals[k] + counts[k] for k in totals}
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"the training loss did not fall: {losses}")

    tokens = batch * seq
    flops = (6 * n_params + 12 * layers * cfg.hidden_size * seq) * tokens
    result = {"trainer": f"bench.py flagship {cfg.dtype} {layers} layers, hidden "
                         f"{cfg.hidden_size}, batch {batch} x {seq}", "card": card,
              "parameters": n_params, "first_step": first, "losses": losses,
              "warmup_steps": warmup, "timed_steps": timed,
              "launches_per_step": per_step,
              "triton_yardstick_launches": ops.yardstick_counts(), "step_ms": step_ms,
              "tokens_per_s": tokens / (step_ms / 1e3),
              "model_flops_per_step": flops,
              "model_flop_share": flops / (step_ms / 1e3) / BF16_TC_FLOPS,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    return totals


BERT_BATCH, BERT_SEQ = 32, 128   # benchmarks/bench_bert.py's batch for BERT-base
BERT_LOGITS_REL_TOL = 5e-2       # relative L2 of bf16 logits against the f32 forward of the
                                 # same weights and against each other: the eager bf16
                                 # forward itself lies 0.035-0.039 from the f32 one on the
                                 # H100 (12 layers; PERF.md)
BERT_F32_RATIO = 1.5             # the fused program's distance from the f32 forward may be
                                 # at most this times the eager bf16 forward's (0.95-1.03
                                 # measured on the H100; the rest is room for the spread of
                                 # bf16 rounding over batches)


def bert_batches(cfg, n, g):
    """``n`` batches of ids with ragged lengths: pad id 0 after each
    sequence's length (8 ... 128), so the attention mask does work."""
    out = []
    for _ in range(n):
        ids = torch.randint(1, cfg.vocab_size, (BERT_BATCH, BERT_SEQ), generator=g,
                            device=DEVICE, dtype=torch.int32)
        lengths = torch.randint(8, BERT_SEQ + 1, (BERT_BATCH,), generator=g, device=DEVICE)
        lengths[0] = BERT_SEQ
        pos = torch.arange(BERT_SEQ, device=DEVICE)
        out.append(torch.where(pos[None, :] < lengths[:, None], ids, torch.zeros_like(ids)))
    return out


def capture_bert(model):
    from paddle_tpu_torch import static

    main = static.Program()
    with static.program_guard(main):
        logits = model(static.data("ids", [BERT_BATCH, BERT_SEQ], "int32"))
    return main, logits


def static_bert(card):
    """Phase 5: BERT-base (bf16, full width and depth, seeded random
    weights) captured as a static Program and run by the Executor, whose
    PallasFusionPass puts 25 add + LayerNorms and 12 linear + GELUs on the
    two kernels.  Checks the op counts after the pass, the launches of
    every run, and the logits against the eager forward and the unfused
    program; prints sequences/s, tokens/s, ms a batch and peak memory."""
    from collections import Counter

    from paddle_tpu_torch import ops, set_flags, static
    from paddle_tpu_torch.models import BertConfig, BertForSequenceClassification

    cfg = BertConfig()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model_f32 = BertForSequenceClassification(
        cfg, num_classes=2, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(13)).eval()
    model = copy.deepcopy(model_f32).to(torch.bfloat16).eval()
    n_params = sum(p.numel() for p in model.parameters())
    main, logits = capture_bert(model)
    plain_main, plain_logits = capture_bert(model)
    print(f"bert-base: {layers} layers, hidden {cfg.hidden_size}, bf16, {n_params} parameters, "
          f"built and captured twice in {time.perf_counter() - t0:.1f} s", flush=True)
    batches = bert_batches(cfg, 3, torch.Generator(device=DEVICE).manual_seed(14))
    exe = static.Executor()

    set_flags({"FLAGS_use_pallas_fusion": False})
    try:
        unfused = [exe.run(plain_main, feed={"ids": b}, fetch_list=[plain_logits],
                           return_numpy=False)[0] for b in batches]
    finally:
        set_flags({"FLAGS_use_pallas_fusion": True})
    check(not {"add_layer_norm", "matmul_epilogue"} & {op.type for op in
                                                       plain_main.global_block().ops},
          "the unfused program was fused")
    exe.run(main, feed={"ids": batches[0]}, fetch_list=[logits], return_numpy=False)  # the pass
    types = Counter(op.type for op in main.global_block().ops)
    check(types["add_layer_norm"] == 2 * layers + 1 and types["matmul_epilogue"] == layers
          and types["gelu"] == 0 and types["layer_norm"] == 0,
          f"static BERT: op counts after the pass {dict(types)}")

    per_run = dict.fromkeys(ops.launch_counts(), 0)
    # every linear + GELU on the TMA/wgmma epilogue
    per_run.update(fused_layer_norm=2 * layers + 1, matmul_epilogue=layers,
                   matmul_epilogue_sm90=layers)
    errs = []
    with torch.no_grad():
        for b, want_unfused in zip(batches, unfused):
            ops.reset_launch_counts()
            (got,) = exe.run(main, feed={"ids": b}, fetch_list=[logits], return_numpy=False)
            counts = ops.launch_counts()
            check(counts == per_run, f"static BERT: launches {counts} != {per_run}")
            eager, ref = model(b), model_f32(b)
            check(got.shape == (BERT_BATCH, 2) and bool(torch.isfinite(got).all()),
                  f"static BERT: logits {tuple(got.shape)} or not finite")
            errs.append({"fused_vs_eager": _rel_l2(got, eager),
                         "fused_vs_unfused": _rel_l2(got, want_unfused),
                         "unfused_vs_eager": _rel_l2(want_unfused, eager),
                         "fused_vs_f32": _rel_l2(got, ref), "eager_vs_f32": _rel_l2(eager, ref)})
            check(max(errs[-1].values()) <= BERT_LOGITS_REL_TOL,
                  f"static BERT: logits relative L2 {errs[-1]} > {BERT_LOGITS_REL_TOL}")
            check(errs[-1]["fused_vs_f32"] <= BERT_F32_RATIO * errs[-1]["eager_vs_f32"],
                  f"static BERT: the fused program is less accurate than eager: {errs[-1]}")

    warmup, timed = 3, 10
    totals = dict.fromkeys(per_run, 0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        b = batches[i % len(batches)]
        ops.reset_launch_counts()
        exe.run(main, feed={"ids": b}, fetch_list=[logits], return_numpy=False)
        counts = ops.launch_counts()
        check(counts == per_run, f"static BERT run {i}: launches {counts} != {per_run}")
        if i >= warmup:
            totals = {k: totals[k] + counts[k] for k in totals}
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3 / timed
    real = sum(int((batches[i % len(batches)] != 0).sum()) for i in range(warmup,
                                                                        warmup + timed))
    emit({"static_bert": f"bert-base bf16 {layers} layers, batch {BERT_BATCH} x {BERT_SEQ}, "
                         "ragged padding, static.Program + Executor (PallasFusionPass)",
          "card": card, "parameters": n_params, "op_counts_after_pass": dict(types),
          "launches_per_run": {k: v for k, v in per_run.items() if v},
          "logits_rel_l2": errs, "tolerance": BERT_LOGITS_REL_TOL,
          "f32_ratio_limit": BERT_F32_RATIO,
          "warmup_runs": warmup, "timed_runs": timed, "ms_per_batch": batch_ms,
          "sequences_per_s": BERT_BATCH / (batch_ms / 1e3),
          "tokens_per_s": BERT_BATCH * BERT_SEQ / (batch_ms / 1e3),
          "real_tokens_per_s": real / timed / (batch_ms / 1e3),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return totals, (model, model_f32, batches)


def _verdicts():
    """The search's verdicts in the current autotune cache: kernel ->
    {shape key: {config, ms, meta}}."""
    from paddle_tpu_torch.ops import autotune as at

    c = at.cache()
    return {k: c.entries(k) for k in ("schedule/matmul", "schedule/reduce")}


def _adopted(verdict):
    return verdict is not None and not verdict["config"].get("disabled")


def _sched_kernel(spec, config):
    """The launch counter a searched config runs on."""
    split = bool(config.get("block_k")) and config["block_k"] < spec.k_dims[0]
    return "sched_chain_ktiled" if split else "sched_chain"


def static_codegen(card, model, model_f32, batches):
    """Phase 6: the codegen passes on the card.  BERT-base (phase 5's
    weights and batches) after pallas_fusion and generic_elementwise_fusion,
    run by the Executor with FLAGS_schedule_search on and a fresh verdict
    cache; then bench_schedule_search.py's three programs through the
    Executor with the real search; then fresh captures of all four, whose
    verdicts must come from the cache with no new search."""
    from collections import Counter

    from paddle_tpu_torch import ops, set_flags, static
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.static import schedule_search as ss
    from paddle_tpu_torch.static.passes import apply_pass
    from paddle_tpu_torch.static.rewrite import PallasFusionPass, ProgramGraph

    layers = model.bert.config.num_hidden_layers
    cache_dir = tempfile.mkdtemp(prefix="pt_sched_verdicts_")
    set_flags({"FLAGS_autotune_cache_dir": cache_dir, "FLAGS_schedule_search": True})
    at._CACHES.clear()
    ss.reset_schedule_search_stats()
    totals = dict.fromkeys(ops.launch_counts(), 0)
    try:
        main, logits = capture_bert(model)
        PallasFusionPass([logits._vid]).apply(main)
        n_vpu = apply_pass(main, "generic_elementwise_fusion", fetch_vids=[logits._vid])
        graph = ProgramGraph(main, (logits._vid,))
        pooler_spec = [sp for sp in (ss.match_subgraph(op, graph) for op in graph.block.ops)
                       if sp]
        check(len(pooler_spec) == 1 and [o.type for o in pooler_spec[0].ops] == ["linear", "tanh"],
              f"static codegen BERT: discovered {[[o.type for o in sp.ops] for sp in pooler_spec]}")
        exe = static.Executor()
        t0 = time.perf_counter()
        exe.run(main, feed={"ids": batches[0]}, fetch_list=[logits], return_numpy=False)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        types = Counter(op.type for op in main.global_block().ops)
        verdicts = _verdicts()
        (pooler_key, pooler_verdict), = verdicts["schedule/matmul"].items()
        adopted = _adopted(pooler_verdict)
        check(n_vpu == 1 and types["vpu_chain_4"] == 1 and types["sched_chain_2"] == int(adopted)
              and types["tanh"] == 1 - int(adopted) and types["add_layer_norm"] == 2 * layers + 1
              and types["matmul_epilogue"] == layers,
              f"static codegen BERT: op counts after the passes {dict(types)}")
        per_run = dict.fromkeys(ops.launch_counts(), 0)
        per_run.update(fused_layer_norm=2 * layers + 1, matmul_epilogue=layers,
                       matmul_epilogue_sm90=layers, vpu_chain=1)
        if adopted:
            per_run[_sched_kernel(pooler_spec[-1], pooler_verdict["config"])] = 1
        errs = []
        with torch.no_grad():
            for b in batches:
                ops.reset_launch_counts()
                (got,) = exe.run(main, feed={"ids": b}, fetch_list=[logits], return_numpy=False)
                counts = ops.launch_counts()
                check(counts == per_run, f"static codegen BERT: launches {counts} != {per_run}")
                eager, ref = model(b), model_f32(b)
                check(got.shape == (BERT_BATCH, 2) and bool(torch.isfinite(got).all()),
                      f"static codegen BERT: logits {tuple(got.shape)} or not finite")
                errs.append({"fused_vs_eager": _rel_l2(got, eager), "fused_vs_f32": _rel_l2(got, ref),
                             "eager_vs_f32": _rel_l2(eager, ref)})
                check(max(errs[-1].values()) <= BERT_LOGITS_REL_TOL,
                      f"static codegen BERT: logits relative L2 {errs[-1]}")
                check(errs[-1]["fused_vs_f32"] <= BERT_F32_RATIO * errs[-1]["eager_vs_f32"],
                      f"static codegen BERT: less accurate than eager: {errs[-1]}")
        warmup, timed = 3, 10
        for i in range(warmup + timed):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            ops.reset_launch_counts()
            exe.run(main, feed={"ids": batches[i % len(batches)]}, fetch_list=[logits],
                    return_numpy=False)
            counts = ops.launch_counts()
            check(counts == per_run, f"static codegen BERT run {i}: launches {counts}")
            if i >= warmup:
                totals = {k: totals[k] + counts[k] for k in totals}
        torch.cuda.synchronize()
        batch_ms = (time.perf_counter() - t0) * 1e3 / timed
        emit({"static_codegen_bert": f"bert-base bf16 {layers} layers, batch {BERT_BATCH} x "
                                     f"{BERT_SEQ}, pallas_fusion + generic_elementwise_fusion + "
                                     "FLAGS_schedule_search", "card": card,
              "op_counts_after_passes": {k: v for k, v in types.items()
                                         if k.startswith(("vpu_", "sched_", "add_layer", "matmul_ep",
                                                          "tanh"))},
              "pooler_decision": {"key": pooler_key, **pooler_verdict, "adopted": adopted},
              "first_run_with_search_s": search_s, "launches_per_run":
                  {k: v for k, v in per_run.items() if v}, "logits_rel_l2": errs,
              "ms_per_batch": batch_ms, "sequences_per_s": BERT_BATCH / (batch_ms / 1e3),
              "schedule_search_stats": ss.schedule_search_stats()})

        g = torch.Generator(device=DEVICE).manual_seed(32)
        feeds = {}
        for name in SCHED_PROGRAMS:
            build, spec_feeds = SCHED_CASES[name]
            feeds[name] = {n: torch.randn(*shp, generator=g, device=DEVICE).to(
                getattr(torch, dt)) for n, shp, dt in spec_feeds}
            prog, out = _capture(build, spec_feeds)
            plain, pout = _capture(build, spec_feeds)
            set_flags({"FLAGS_schedule_search": False})
            (want,) = exe.run(plain, feed=feeds[name], fetch_list=[pout], return_numpy=False)
            set_flags({"FLAGS_schedule_search": True})
            exe.run(prog, feed=feeds[name], fetch_list=[out], return_numpy=False)  # the search
            spec = next(sp for sp in (ss.match_subgraph(op, ProgramGraph(plain, (pout._vid,)))
                                      for op in plain.global_block().ops) if sp)
            verdict = at.cache().get(spec.kernel_name(), spec.key())
            adopted = verdict is not None and not verdict.get("disabled")
            ops.reset_launch_counts()
            (got,) = exe.run(prog, feed=feeds[name], fetch_list=[out], return_numpy=False)
            counts = ops.launch_counts()
            want_counts = dict.fromkeys(counts, 0)
            if adopted:
                want_counts[_sched_kernel(spec, verdict)] = 1
            check(counts == want_counts, f"{name}: launches {counts} != {want_counts}")
            totals = {k: totals[k] + counts[k] for k in totals}
            ok, _ = _codegen_close(got, want, spec.out_dtype)
            check(ok, f"{name}: the searched program disagrees with the unfused one: "
                      f"{max_err(got, want)}")
            entry = _verdicts()[spec.kernel_name()][at._key_str(spec.key())]
            emit({"static_codegen_program": name, "card": card,
                  "op_types": [op.type for op in prog.global_block().ops],
                  "decision": {**entry, "adopted": adopted},
                  "max_abs_err_vs_unfused": max_err(got, want)})

        # a second capture of every program: verdicts from the cache, no search
        before = ss.schedule_search_stats()
        main2, logits2 = capture_bert(model)
        PallasFusionPass([logits2._vid]).apply(main2)
        apply_pass(main2, "generic_elementwise_fusion", fetch_vids=[logits2._vid])
        static.Executor().run(main2, feed={"ids": batches[0]}, fetch_list=[logits2],
                              return_numpy=False)
        for name in SCHED_PROGRAMS:
            prog, out = _capture(*SCHED_CASES[name])
            static.Executor().run(prog, feed=feeds[name], fetch_list=[out], return_numpy=False)
        after = ss.schedule_search_stats()
        served = (after["cache_hits"] + after["disabled_hits"]
                  - before["cache_hits"] - before["disabled_hits"])
        check(after["subgraphs_found"] == before["subgraphs_found"]
              and after["measured"] == before["measured"] and served == 4,
              f"static codegen: the second captures searched again: {before} -> {after}")
        emit({"static_codegen_cached": "BERT-base and the three programs captured again",
              "served_from_cache": served, "stats_before": before, "stats_after": after})
    finally:
        set_flags({"FLAGS_autotune_cache_dir": "", "FLAGS_schedule_search": False})
        at._CACHES.clear()
        shutil.rmtree(cache_dir, ignore_errors=True)
    return totals


def summarize(name, route, source, replaces, rows, launches, **pick):
    """One entry of the kernels line: the first row's numbers (``pick``
    renames a row's keys onto the entry's), every row kept under
    per_shape; ``launches`` maps each main path to its count."""
    top = rows[0]
    keys = {k: pick.get(k, k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    errs = [max(r["max_abs_err"][e] for e in pick["err"]) if "err" in pick else r["max_abs_err"]
            for r in rows]
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(errs), **{k: top[v] for k, v in keys.items()},
            "timed_shape": top["shape"], "tolerance": top.get("tolerance", TOL),
            "per_shape": [{k: v for k, v in r.items() if k != "configs"} for r in rows]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (paddle_tpu_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import _cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    vpu, specs, sources = codegen_cases()
    gen = {}
    gen_build = threading.Thread(
        target=lambda: gen.update(_cuda_build.build_generated(list(sources.values()))))
    gen_build.start()  # the generated sources build beside csrc/'s, one nvcc each
    try:
        logs = _cuda_build.build(["flash_attention_fwd", "flash_attention_fwd_sm90",
                                  "flash_attention_bwd", "flash_attention_bwd_sm90",
                                  "decode_chain", "decode_chain_sm90", "prefill_chain_sm90",
                                  "matmul_epilogue", "matmul_epilogue_sm90", "norm_swiglu"])
    finally:
        gen_build.join()
    check(len(gen) == len(set(sources.values())), "a generated source failed to build")
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log}", file=sys.stderr)
    for path, info in gen.items():
        print(f"nvcc {path} ({info['seconds']:.1f} s):\n{info['log']}", file=sys.stderr)
    print(f"built the CUDA kernels ({len(logs)} sources and {len(gen)} generated) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    timer = Timer()
    with torch.no_grad():
        floor = launch_floor(timer)
        rms = check_rms_norm(timer, F, logs, floor)
        sw = check_swiglu(timer, logs, floor)
        check_norm_swiglu_dtypes()
        fl = check_flash(timer, F)
        chains = check_decode_chains(timer, logs)
        pf = check_prefill_chain(timer, F, logs)
        ln = check_layer_norm(timer, F)
        mm = check_matmul_epilogue(timer, F, logs)
        vc = check_vpu_chains(timer, vpu, gen)
        sc, sk = check_sched_chains(timer, specs, gen)
    triton_resources()
    fb = check_flash_bwd(timer, F)
    check_flash_bwd_no_key_rows()
    f32_llama(card)
    with torch.no_grad():
        time_plain_backwards(timer)
        paths = serve(card)
    del timer
    gc.collect()  # the 7B engines are gone with serve(); return their memory
    torch.cuda.empty_cache()
    paths["training"] = train(card)
    gc.collect()
    torch.cuda.empty_cache()
    paths["static_bert"], bert = static_bert(card)
    paths["static_codegen"] = static_codegen(card, *bert)
    del bert
    llama_kernels = ("fused_rms_norm", "swiglu", "flash_attention_fwd", "flash_attention_fwd_sm90")
    codegen_kernels = ("vpu_chain", "sched_chain", "sched_chain_ktiled")
    for path, counts in paths.items():
        if path.startswith("static_"):
            check(counts["fused_layer_norm"] > 0 and counts["matmul_epilogue"] > 0
                  and not any(counts[k] for k in llama_kernels),
                  f"{path}: launches {counts}")
            # every static BERT epilogue launch on the sm90 route
            check(counts["matmul_epilogue_sm90"] == counts["matmul_epilogue"],
                  f"{path}: matmul_epilogue launches {counts['matmul_epilogue']}, of them "
                  f"{counts['matmul_epilogue_sm90']} on the sm90 route")
            ran = [k for k in codegen_kernels if counts[k] > 0]
            check(ran == ([] if path == "static_bert" else list(codegen_kernels)),
                  f"{path}: codegen kernels launched {ran}: {counts}")
            continue
        check(not any(counts[k] for k in codegen_kernels), f"{path}: launches {counts}")
        ran = [k for k in llama_kernels if counts[k] > 0]
        check(len(ran) == 4, f"{path}: a forward kernel was never launched: {counts}")
        # every LLaMA path's flash forward (H 128, bf16, contiguous) takes the TMA kernel
        check(counts["flash_attention_fwd_sm90"] == counts["flash_attention_fwd"],
              f"{path}: flash forward launches {counts['flash_attention_fwd']}, of them "
              f"{counts['flash_attention_fwd_sm90']} on the sm90 route")
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        # the training step's backward: launched, and every launch on the sm90 route
        check(paths["training"][name] > 0
              and paths["training"][f"{name}_sm90"] == paths["training"][name],
              f"training: {name} launches {paths['training'][name]}, of them "
              f"{paths['training'][f'{name}_sm90']} on the sm90 route")
    for kv in CHAINED:
        counts = paths[f"serving_{kv}_chained"]
        check(counts["prefill_chain"] > 0 and counts["decode_chain_batch"]
              + counts["decode_chain_rows"] > 0,
              f"serving_{kv}_chained: a serving chain was never launched: {counts}")
        # every chained prefill-chain and decode-chain launch on the sm90 route
        for chain in ("prefill_chain", "decode_chain_batch", "decode_chain_rows"):
            check(counts[f"{chain}_sm90"] == counts[chain],
                  f"serving_{kv}_chained: {chain} launches {counts[chain]}, of them "
                  f"{counts[f'{chain}_sm90']} on the sm90 route")

    def launches(name):
        return {path: counts[name] for path, counts in paths.items()}

    # the decode chain of each chained engine: the layout its search
    # accepted (batch or rows; int8 may take either), 1,024 launches each,
    # all on the sm90 route (checked above and in serve())
    check(sum(launches("decode_chain_batch").values())
          + sum(launches("decode_chain_rows").values()) > 0,
          "no decode chain was launched on a main path")
    bwd_src = "paddle_tpu_torch/csrc/flash_attention_bwd_sm90.cu"

    def routes(name, sm90_src, general_src):
        sm90 = sum(launches(f"{name}_sm90").values())
        return {"sm90": {"source": sm90_src, "launches": sm90},
                "general": {"source": general_src,
                            "launches": sum(launches(name).values()) - sm90}}

    chain_src = "paddle_tpu_torch/csrc/decode_chain.cu"
    decode_src = "paddle_tpu_torch/csrc/decode_chain_sm90.cu"
    kernels = [
        # the Triton kernels these replaced: yardsticks timed beside them
        # (triton_ms per shape), launched 0 times on every main path
        dict(summarize("fused_rms_norm", "cuda", "paddle_tpu_torch/csrc/norm_swiglu.cu",
                       "paddle_tpu/ops/fused_norm.py:42", rms, launches("fused_rms_norm")),
             triton_ms=rms[0]["triton_ms"], floor_ms=floor["floor_ms"],
             queued_ms=next(r["queued_ms"] for r in rms if "queued_ms" in r)),
        dict(summarize("swiglu", "cuda", "paddle_tpu_torch/csrc/norm_swiglu.cu",
                       "paddle_tpu/ops/swiglu.py:17", sw, launches("swiglu")),
             triton_ms=sw[0]["triton_ms"], floor_ms=floor["floor_ms"],
             queued_ms=next(r["queued_ms"] for r in sw if "queued_ms" in r)),
        # two routes each: the TMA/wgmma kernels (the main paths' launches)
        # and the general kernels (f32, other head dims and strides);
        # per_shape rows name the route each case ran
        dict(summarize("flash_attention_fwd", "cuda",
                       "paddle_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
                       "paddle_tpu/ops/flash_attention.py:97", fl, launches("flash_attention_fwd")),
             routes=routes("flash_attention_fwd",
                           "paddle_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
                           "paddle_tpu_torch/csrc/flash_attention_fwd.cu")),
        # each backward kernel's own time and bound; plain_ms and library_ms
        # compute dQ, dK and dV together (no call computes one alone)
        dict(summarize("flash_attention_bwd_dq", "cuda", bwd_src,
                       "paddle_tpu/ops/flash_attention.py:181", fb,
                       launches("flash_attention_bwd_dq"), ms="dq_ms", bound_ms="dq_bound_ms",
                       bound_by="dq_bound_by", err=("dq",)),
             routes=routes("flash_attention_bwd_dq", bwd_src,
                           "paddle_tpu_torch/csrc/flash_attention_bwd.cu")),
        dict(summarize("flash_attention_bwd_dkv", "cuda", bwd_src,
                       "paddle_tpu/ops/flash_attention.py:217", fb,
                       launches("flash_attention_bwd_dkv"), ms="dkv_ms", bound_ms="dkv_bound_ms",
                       bound_by="dkv_bound_by", err=("dk", "dv")),
             routes=routes("flash_attention_bwd_dkv", bwd_src,
                           "paddle_tpu_torch/csrc/flash_attention_bwd.cu")),
        dict(summarize("decode_chain_batch", "cuda", decode_src,
                       "paddle_tpu/ops/decode_chain.py:504", chains["decode_chain_batch"],
                       launches("decode_chain_batch")),
             routes=routes("decode_chain_batch", decode_src, chain_src)),
        dict(summarize("decode_chain_rows", "cuda", decode_src,
                       "paddle_tpu/ops/decode_chain.py:574", chains["decode_chain_rows"],
                       launches("decode_chain_rows")),
             routes=routes("decode_chain_rows", decode_src, chain_src)),
        dict(summarize("prefill_chain", "cuda", "paddle_tpu_torch/csrc/prefill_chain_sm90.cu",
                       "paddle_tpu/ops/decode_chain.py:917", pf, launches("prefill_chain")),
             routes=routes("prefill_chain", "paddle_tpu_torch/csrc/prefill_chain_sm90.cu",
                           chain_src)),
        summarize("fused_layer_norm", "triton", "paddle_tpu_torch/ops/fused_norm.py",
                  "paddle_tpu/ops/fused_norm.py:49", ln, launches("fused_layer_norm")),
        dict(summarize("matmul_epilogue", "cuda",
                       "paddle_tpu_torch/csrc/matmul_epilogue_sm90.cu",
                       "paddle_tpu/ops/matmul_epilogue.py:40", mm, launches("matmul_epilogue")),
             routes=routes("matmul_epilogue", "paddle_tpu_torch/csrc/matmul_epilogue_sm90.cu",
                           "paddle_tpu_torch/csrc/matmul_epilogue.cu")),
        summarize("vpu_chain", "cuda", "paddle_tpu_torch/csrc/codegen/vpu_chain.cuh",
                  "paddle_tpu/static/rewrite.py:804", vc, launches("vpu_chain")),
        summarize("sched_chain", "cuda", "paddle_tpu_torch/csrc/codegen/sched_chain.cuh",
                  "paddle_tpu/static/schedule_search.py:883", sc, launches("sched_chain")),
        summarize("sched_chain_ktiled", "cuda",
                  "paddle_tpu_torch/csrc/codegen/sched_chain_ktiled.cuh",
                  "paddle_tpu/static/schedule_search.py:773", sk, launches("sched_chain_ktiled")),
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
