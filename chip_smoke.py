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
   together, with the elementwise cases' arithmetic-floor builds), the
   Triton LayerNorm and the two Triton yardsticks (the RMSNorm and SwiGLU
   kernels norm_swiglu.cu replaced) at their first launch.
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
   beside it); f16 and f32 (phase 4c's [4096, 2048] RMSNorm and [4096,
   5632] SwiGLU among them), a 4095 tail, odd widths and an RMSNorm weight
   of another dtype than x (bf16 rows, f32 weight) against the plain
   versions.  The flash forward at the serving and training shapes (causal
   and not, bf16 and f16, the training shape in f16 for phase 4c: the
   TMA/wgmma route, with the general kernel's
   time at the main shapes and the host cost of encoding the tensor maps)
   and at small sizes on the general route (f32, head dims 32, 96 and 256,
   strides that are not 16-byte multiples), then at phase 3f's decode
   shapes (one query row against 129 and 159 cached keys, non-causal,
   the beam frontier's 8 rows, the verify's 5 rows bottom-right causal;
   bf16 and f16), and at phase 4d's GPT-2 shape ([8, 1024, 12, 64] causal:
   f32 on the general route, bf16 on the sm90 route), each row naming its
   route;
   the flash backward likewise: the TMA/wgmma pair at the training shape
   causal and not, and in f16 (phase 4c's shape; with the general kernels' times on the same inputs and
   delta's share of the whole), phase 4d's GPT-2 shape in f32 (general)
   and bf16 (sm90, with the general pair's times beside it), GQA, a ragged length, Sq < Sk, f16 and
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
   The generated kernels: the elementwise chain (#11; BERT's mask chain,
   and the JAX package's test chain and the wide-constant chain at
   BERT-base's FFN size) at every launch config of its persistent grid,
   beside a torch op that moves the same bytes and the same source built
   against its arithmetic floor (tools/time_torch_vpu_variants.py's
   ``floor``), and every enumerated config of the schedule-search
   subgraphs (#12, #13 split-K merged inside a cluster in one launch: the
   BERT pooler, bench_schedule_search.py's three
   programs at its chip shapes, the softmax at BERT-base's logits), each
   against the replay of the recorded ops (bf16 one bf16 step, f32 1e-5)
   and timed, with registers and nvcc seconds from -Xptxas -v; the
   matmul cases' yardstick is torch.addmm of the product plus bias
   alone (TF32 off), the softmax cases' torch.softmax.
3. Serve 4 greedy requests (prompts of 17, 128, 250 and 640 tokens, 32 new
   tokens each) on LLaMA-7B at full width, bf16, all 32 layers, random
   weights from a seeded generator, each engine after one warm-up pass
   over the same prompts: the default GenerationEngine (the serving chains
   launch 0 times), then GenerationEngine(kv_cache_dtype="int8" and then
   "bf16", prefill_chunk=128) with FLAGS_schedule_search on and a fresh
   FLAGS_autotune_cache_dir, so the searcher measures both chains against
   their plain twins in every run and must accept both.  Each engine
   serves the requests twice: through the eager body of its decode step
   (``_step_eager``, op by op), then, after ``warmup()`` captured the
   D-token step as a CUDA graph, by replays (``step()``); the streams must
   be equal.  For each pass:
   the streams, that every kernel's launch counter grew by exactly what
   the run implies (the Triton yardsticks 0; every flash forward and
   every prefill chain on the
   TMA/wgmma route, every decode chain on decode_chain_sm90.cu's: 1,024
   launches, 32 layers x 32 token iterations, under the layout the search
   accepts), that its first-token logits of the longest prompt
   (through its own prefill path) match a forward built only from the
   plain versions; for the chained engines also the searcher's decisions
   and one decode step with the accepted config against the same step
   unfused (pools bit-exact).  Print prefill and decode tokens/s of both
   passes, warmup()'s seconds, the capture's seconds and graph memory,
   peak memory and the pools' resident bytes.
3b. The admission features on phase 3's model: one 512-token system
   prompt (32 pages) shared by 8 requests with suffixes of 17, 40, 64,
   100, 128, 150, 180 and 200 tokens (first tokens all different), 32 new
   tokens each, greedy.  (a) GenerationEngine(kv_cache_dtype="int8",
   prefill_chunk=128, prefix_cache=True) with the schedule search (fresh
   cache), atomic admission: the eager body, then after ``warmup()`` the
   replays (streams equal); 7 prefix hits of 512 tokens each; the 32
   shared pages' int8 payload and scales unchanged by decoding (lanes
   finish mid-chunk at D = 8); each hit's first-token logits within
   LOGITS_REL_TOL of a prefix_cache=False engine's.  (b) bf16 pools,
   prefix_cache=True, prefill_chunk_blocks=4 (interleaved prefill; the
   prefill chain at chunk 16 must be counted disabled): the first four
   requests as "low", two steps, then the next two as "high", which find
   every lane taken: 2 preemptions (pages parked on the host) and 2
   re-admissions; every LOW stream bit-equal to an uninterrupted run of
   the same engine configuration, every stream bit-equal to an atomic
   engine with prefill_chunk=16 serving the same submissions.  Every
   pass's launch counts exactly as its admissions (hits' suffix-only
   prefills, one-block chunks) and decode steps imply, every flash and
   chain launch on its sm90 route.  Prints each request's prefill ms (hit
   against miss of the same request), park and unpark ms and bytes, the
   serving counters and decode tokens/s.
3c. Speculative decoding on phase 3's model, K = 4, phase 3's prompts
   and 32 new tokens each: (a) the model as its own draft (every proposal
   accepted), (b) a 2-layer draft of the 7B width whose embedding, first
   two layers, final norm and head are the model's own (early exit),
   each served through the eager tick (``_step_eager``) and then through
   the captured one (``step()``, the tick recorded at the first): streams,
   spec_stats and both pool sets equal, every pass's launches as its
   admissions (a target and a draft prefill each) and ticks imply (the
   capture's warm-up tick included), K + 2 dispatches a tick, and the
   streams against phase 3's plain greedy engine (equal, or parting at a
   token the plain engine chose by a top-2 margin below twice phase 3's
   first-token logit error against the plain versions); then (c) (b) with
   int8 pools and the prefix cache over two requests sharing phase 3b's
   512-token system prompt: the second hits its 32 pages, whose bytes in
   both pool sets decoding leaves unchanged, and the streams against a
   plain int8 prefix engine's (the margin twice the hit's first-token
   logit error against a forward of the model).  Prints acceptance,
   tokens a lane a tick, decode tokens/s, ms a tick, capture seconds and
   graph bytes.
3d. Multi-tenant LoRA on phase 3's model: phase 3's chained bf16 engine
   (its verdicts) with an adapter pack (rank 16, 4 slots; the pack's
   bytes printed), three seeded adapters t0-t2 and a base request over
   phase 3's prompts, 32 new tokens each, greedy: (a) the eager body's
   streams equal the graphed replays', (b) each request served alone on
   the same engine equals its stream in the mixed batch, (c) the base
   request equals phase 3's chained bf16 stream, (d) each adapter
   request's first-token logits are within LOGITS_REL_TOL of a forward of
   plain versions with the adapter's delta added (and each adapter moves
   those logits by more than 5 x LOGITS_REL_TOL), (e) a hot swap between
   steps (evict t2, register t3) records no step again and t3's stream
   equals a fresh engine's, (f) the launches equal phase 3's chained bf16
   engine's for the same submissions, (g) a speculative adapter engine
   (phase 3c's early-exit draft, K = 4) against the plain adapter engine
   (phase 3c's tie rule).  Prints the D = 8 step's ms graphed and eager
   beside phase 3's chained bf16 engine, the swap's ms and lora_stats().
3e. Snapshot, restore and drain on phase 3's model: a chained int8 engine
   with the prefix cache and the adapters serves phase 3b's 8 requests
   (adapters t0, t1 and the base model) on 4 lanes, is snapshotted after
   two steps into a temporary directory, finishes and is deleted;
   restore_engine builds a fresh engine, warmup() captures it, and it
   finishes: every stream bit for bit the original's, the cached pages'
   bytes and the adapter slots' epochs as at the snapshot.  Then a second
   engine is drained after two steps: add_request raises, its residents
   finish, and the engine restored from the drain serves the queue to
   the original's streams.  Prints the snapshot's bytes, save and restore
   ms and GB/s, and snapshot_stats().
3f. The model-level LlamaForCausalLM.generate on phase 3's model, 4
   prompts of 128 tokens, 32 new tokens each: (a) greedy on the paged
   cache at D = 8 through the eager body (``_generate_eager``) and then
   through the call's recording of the 8-token chunk, replayed twice (the
   7-token tail runs once, through the body; streams equal; the
   recording's seconds and graph bytes printed), and both ways at 17, 25,
   41 and 65 new tokens, which gives the length from which recording
   pays; (b) greedy on the naive cache (flash attention at Sq = 1,
   non-causal, against the growing cache) and phase 3's default engine
   serving the same prompts, each equal to (a) or parting at a token (a)
   chose by a top-2 margin below phase 3c's tie margin; (c) sampled
   (temperature 1.5, top_k 50, top_p 0.9, seed 3): D = 1, D = 8 and the
   eager body bit for bit; the naive cache equal, or parting at a token
   where the two runs' logits (each step's, kept by a spy) differ by less
   than the tie margin up to it, and every token of both runs is the
   Gumbel-max of its own run's filtered logits: the caches attend through different code
   (the flash kernel, the plain paged gather), and top-k and top-p cut
   bf16 logits, which tie in runs, so a difference within the margin can
   move a token across a cut; top_k = 1 equal to (a), or parting at a
   step whose top two bf16 logits tie (top-k keeps ties, as in the JAX
   package); (d) beam search, 4 beams over 2 prompts, 16 new tokens (the
   beams' scores printed); (e) speculative decoding with phase 3c's
   early-exit draft, K = 4, one prompt, against (b)'s stream under the
   tie rule (_spec_stats printed).  Every run's launches as its forwards
   imply, every flash forward on the sm90 route.  Prints ms a token and
   tokens/s of each mode.
4. Train the flagship configuration of bench.py (vocab 32000, hidden
   2048, FFN 5632, 8 layers, 16 heads, bf16) at full width and depth with
   TrainStep and AdamW on one seeded batch of 4 x 1024 tokens: check that
   the first step's loss and gradients match a backward through a forward
   built only from the plain versions, then run 3 warm-up and 10 timed
   eager steps (TrainStep's body, ``_eager_step``), checking every step's
   launch counts (every flash forward and backward on the sm90 route, the
   Triton yardsticks 0) and that the loss falls.  Then ``warmup()``
   records the step for the batch's signature, and every parameter, f32
   master, moment, beta power, the rate, the step count and every grad
   must be as they were; 10 graphed steps (replays, each crediting the
   eager step's launches) run from that state, then 10 eager steps from a
   copy of it: losses and every state tensor bit for bit.  Print graphed
   and eager ms a step, tokens/s, the model-FLOP share, warmup and
   capture seconds, the graph's bytes and peak memory
   (tools/profile_torch_training.py says where the step's time goes).
4b. The LoRA fine-tune on phase 4's model: apply_lora (rank 16) freezes
   the base, TrainStep with AdamW trains the adapters alone: 3 eager
   steps, warmup(), 5 graphed steps, each with phase 4's launches; the
   loss falls, every base parameter is bit for bit as it was and holds no
   grad, the optimizer holds the adapters' state alone.  Prints ms a step
   beside phase 4's full step.
4c. AMP O1 on phase 4's configuration built in f32 (542,148,608
   parameters): the first step's loss and gradients under
   auto_cast(bfloat16), and under auto_cast(float16) with the loss scaled
   by GradScaler's initial 2^16, against a forward of plain versions under
   the same auto_cast and scale; then (a) O1 bf16 and (b) O1 f16 with a GradScaler, each
   with TrainStep and AdamW: 3 eager steps (the attention in the AMP
   dtype), ``warmup()`` (every state tensor, the scaler's included, as
   it was), 10 graphed steps, then 10 eager steps from a copy of the
   state: losses, the scale and skip of every step and every state
   tensor bit for bit; every flash forward and backward on the sm90
   route; (c) (b)'s scaler set to 2^40, one graphed step: the found flag
   set, every parameter, moment and beta power bit for bit, the scale
   2^39.  Prints ms a step graphed and eager beside phase 4's.
4d. GPT-2 small (GPTConfig(): 124,475,904 parameters, f32, dropout 0.1,
   seeded random weights, one seeded batch of 8 x 1024 tokens), trained
   by TrainStep with AdamW, LinearWarmup into CosineAnnealingDecay and
   ClipGradByGlobalNorm(1.0): (a) the first step's loss and gradients
   against a backward through a forward of plain versions from the same
   RNG state (the same dropout masks), in f32 and under auto_cast O1
   bf16; (b) f32: 3 eager steps, ``warmup()`` (every state tensor as it
   was, the RNG counter included), 10 graphed steps, then 10 eager steps
   from a copy of that state: losses, every state tensor and the
   scheduler bit for bit, 25 dropouts a step, each eager step's mask unlike
   the step before's, every flash launch on the general route; (c) the
   same under auto_cast O1 bf16, every flash launch on the sm90 route (H
   64); (d) a dropout mask drawn on the card equals the CPU's from the
   same state.  Prints ms a step graphed and eager, tokens/s, the
   model-FLOP share (6N + 12 L H S a token, against 67 TFLOP/s f32 and
   989 TFLOP/s for O1) and dropout's share of the step (25 dropouts'
   forward and backward timed alone at [8, 1024, 768]).
4e. The optimizer tier on phase 4d's model under O1 bf16: Momentum (L2Decay,
   ClipGradByGlobalNorm), Adagrad (L1Decay), Adadelta (ClipGradByValue),
   RMSProp (centered, momentum, ClipGradByNorm), Lamb (the decay excluded
   by name), Adamax, NAdam, RAdam (its rectified branch first taken inside
   a replay), ASGD and Rprop, the LayerNorms' parameters with need_clip
   False and a zero L2Decay of their own, each rate from OneCycleLR: 2
   eager steps, ``warmup()`` (state unchanged), 3 graphed steps reading a
   new rate each, then 3 eager steps from a copy of the state: losses and
   every state tensor bit for bit, every loss finite.
4f. ResNet-50 (vision.models.resnet50(): 25,557,032 parameters, f32,
   seeded random weights; one seeded batch of 256 x 3 x 224 x 224 f32
   images with int32 labels over 1,000 classes, as
   benchmarks/bench_resnet.py feeds), TrainStep with Momentum(0.1) and
   CrossEntropyLoss: (a) the f32 first step's loss, gradients and new
   running statistics on the card against the port's CPU run of the same
   step from the same weights, at 8 images (TF32 off); (b) under
   auto_cast O1 bf16 with cudnn.deterministic: 3 eager steps,
   ``warmup()`` (every state tensor as it was, the running statistics
   included), 10 graphed steps, then 10 eager steps from a copy of that
   state: losses and every state tensor bit for bit; then two eager
   steps with cuDNN's default algorithms, twice from one state (their ms
   and whether they agree); (c) eval() logits at the same batch, finite,
   from the running statistics, which the eval forward leaves as they
   were.  No kernel of the port's runs here (0 launches of each).
   Prints ms a step graphed and eager, images/s, the model-FLOP share
   (the convolutions' and the head's multiply-adds from their shapes, x 3
   for a training step, against 989 TFLOP/s), the device busy share
   (torch.profiler over two steps) and peak memory.
5. Run BERT-base (12 layers, hidden 768, bf16, seeded random weights)
   through the static Program tier: capture
   BertForSequenceClassification under static.program_guard, run
   static.Executor (its PallasFusionPass puts the 25 residual adds +
   LayerNorms and the 12 linear + GELUs on the fused LayerNorm and
   matmul-epilogue kernels) on batches of 32 x 128 ids with ragged padding.
   The Executor captures the run as a CUDA graph at its first run and
   replays it.  Checks the op counts after the pass, every run's launches
   (every epilogue on the TMA/wgmma route), that every replay's logits
   are bit for bit the eager run's of the same batch (the pruned op list
   op by op, ``Executor._run_eager``) and that no run overwrites a fetch
   an earlier one returned, and the
   logits against the eager forward, the unfused program (the flag
   FLAGS_use_pallas_fusion off) and the f32 forward of the same weights;
   prints ms a batch replayed and eager, sequences/s, tokens/s and peak
   memory.
6. The codegen passes: the same BERT-base after pallas_fusion and
   generic_elementwise_fusion, run by the Executor with
   FLAGS_schedule_search on and a fresh verdict cache (op counts, every
   run's launches, the pooler's decision, logits as in phase 5 and bit
   for bit the eager run's, ms a batch replayed and eager); then
   bench_schedule_search.py's three programs through the Executor with
   the real search (each program's decision and win
   against the gate, outputs against the unfused program); then fresh
   captures of all four, whose verdicts must come from the cache with no
   new search.
7. Print the ``kernels`` JSON line (all thirteen kernels, launches by main
   path, phase 3b's two checked engines, phase 3c's three spec engines,
   phase 3d's adapter engines, phase 3e's snapshot engines, phase 3f's
   generate modes, phases 4, 4b, 4c and 4d's graphed and eager steps,
   phase 4e's optimizers and phase 4f's ResNet-50 (0 each) among them;
   the flash forward,
   the two backward kernels, the prefill chain and the matmul epilogue
   with their launches by route), then the result line.

The script needs the card: without CUDA, or run from a directory that
holds nothing else of the repository, it exits with a non-zero code
before printing any result.  It imports nothing of JAX or paddle_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import gc
import importlib
import json
import math
import shutil
import statistics
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
    """f16 and f32 (phase 4c's training shapes, a 4095 tail, hidden 100, an
    odd SwiGLU width),
    and RMSNorm weights of another dtype than x, against the plain
    versions: bf16 and f16 outputs within bf16's TOL, f32 within
    F32_NORM_TOL."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.fused_norm import rms_norm_plain
    from paddle_tpu_torch.ops.swiglu import swiglu_plain

    g = torch.Generator(device=DEVICE).manual_seed(12)
    errs = {}
    for dtype, tol in ((torch.float16, TOL), (torch.float32, F32_NORM_TOL)):
        for rows, hidden in ((640, 4096), (4096, 2048), (37, 4095), (4096, 100)):
            x = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype)
            r = torch.randn(rows, hidden, generator=g, device=DEVICE).to(dtype)
            w = (1 + 0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(dtype)
            o, s = ops.fused_rms_norm(x, w, epsilon=1e-6, residual=r)
            want = rms_norm_plain(x + r, w, 1e-6)
            check(torch.equal(s, x + r) and torch.allclose(o.float(), want.float(), atol=tol,
                                                           rtol=tol),
                  f"fused_rms_norm {dtype} [{rows}, {hidden}]: {max_err(o, want)}")
            errs[f"rms_norm {dtype} {rows}x{hidden}"] = max_err(o, want)
        for rows, cols in ((640, 11008), (4096, 5632), (37, 689)):
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
# the training shape, both main shapes non-causal, an f16 serving prefill,
# the training shape in f16 (phase 4c's O1 fp16);
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
    (4, 1024, 1024, 16, 16, 128, True, torch.float16, "contiguous"),
    # phase 4d's GPT-2 small: f32 on the general route, O1 bf16 on the sm90
    (8, 1024, 1024, 12, 12, 64, True, torch.float32, "contiguous"),
    (8, 1024, 1024, 12, 12, 64, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 4, 64, True, torch.float32, "contiguous"),
    (2, 256, 256, 4, 4, 32, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 2, 96, True, torch.bfloat16, "contiguous"),
    (2, 256, 256, 4, 4, 256, True, torch.float16, "contiguous"),
    (2, 256, 256, 4, 4, 128, True, torch.bfloat16, "narrow"),
    # phase 3f's generate(): a naive-cache decode row (Sq 1, non-causal) at
    # its first and last length, the beam frontier's 8 rows, the
    # speculative verify's K + 1 rows (bottom-right causal), in bf16 and f16
    (4, 1, 129, 32, 32, 128, False, torch.bfloat16, "contiguous"),
    (4, 1, 159, 32, 32, 128, False, torch.bfloat16, "contiguous"),
    (8, 1, 143, 32, 32, 128, False, torch.bfloat16, "contiguous"),
    (1, 5, 160, 32, 32, 128, True, torch.bfloat16, "contiguous"),
    (4, 1, 159, 32, 32, 128, False, torch.float16, "contiguous"),
    (1, 5, 160, 32, 32, 128, True, torch.float16, "contiguous"),
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
# training shape causal and not (both routes timed there), in f16 (phase
# 4c's O1 fp16), GQA 16:4, a ragged length, Sq 256 against Sk 1024, f16
# and H 64; then the general
# route at small sizes (f32, head dims 32, 96 and 256, rows that are not
# 16-byte multiples)
FLASH_BWD_CASES = [
    (4, 1024, 1024, 16, 16, 128, True, torch.bfloat16, "contiguous"),
    # phase 4d's GPT-2 small: f32 on the general route, O1 bf16 on the sm90
    (8, 1024, 1024, 12, 12, 64, True, torch.float32, "contiguous"),
    (8, 1024, 1024, 12, 12, 64, True, torch.bfloat16, "contiguous"),
    (4, 1024, 1024, 16, 16, 128, False, torch.bfloat16, "contiguous"),
    (4, 1024, 1024, 16, 16, 128, True, torch.float16, "contiguous"),
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
        if route == "sm90" and (bsz, sq, n) in ((4, 1024, 16), (8, 1024, 12)):
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


def wide_bias_chain(a):
    """tests/test_torch_codegen.py's wide-constant chain: c a captured f32
    constant of the last dim's width, made from a seed."""
    c = torch.randn(3072, generator=torch.Generator().manual_seed(7)).to(DEVICE)
    return torch.tanh(a * 2.0 + c) * 3.0


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


VPU_CASES = {  # name -> (chain, feeds): BERT's mask at phase 6's batch; the JAX test chain and
               # the wide-constant chain at BERT-base's FFN activation size
    "bert_mask": (bert_mask_chain, [("ids", (32, 128), "int32")]),
    "jax_chain_bf16": (jax_test_chain, [("a", (4096, 3072), "bfloat16"),
                                        ("b", (4096, 3072), "bfloat16")]),
    "wide_bias_bf16": (wide_bias_chain, [("a", (4096, 3072), "bfloat16")]),
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


def vpu_floor_libraries(vpu):
    """Each elementwise case's source built against the arithmetic floor of
    csrc/codegen/vpu_chain.cuh (tools/time_torch_vpu_variants.py: loads
    replaced by values made in registers, the store behind a condition that
    never holds), one nvcc each: case -> (library path, nvcc output)."""
    import time_torch_vpu_variants as vv  # tools/, on the path since main()

    built = vv.build_variant("floor", {name: op.fn.source for name, op in vpu.items()})
    return {name: built[name] for name in vpu}


def check_vpu_chains(timer, vpu, build_info, floor_libs):
    """#11 at every launch config against the replay of the recorded ops:
    the mask chain bit-exact, bf16 within one bf16 step; each case's time at
    its default config beside a torch op that moves the same bytes (copy_ms,
    the memory floor: tools/time_torch_vpu_variants.py's copy_fn) and the
    same source built against the arithmetic floor (floor_ms), with
    registers and spills.  Rows: the mask chain (the static BERT path's
    call) first."""
    import time_torch_vpu_variants as vv  # tools/, on the path since main()

    from paddle_tpu_torch.ops import _cuda_build

    g = torch.Generator(device=DEVICE).manual_seed(31)
    out = []
    for name, op in vpu.items():
        kernel = op.fn
        if name == "bert_mask":
            ids = torch.randint(0, 3, (32, 128), generator=g, device=DEVICE, dtype=torch.int32)
            inputs = [ids != 0]
        else:
            inputs = [torch.randn(*feed[1], generator=g, device=DEVICE).to(torch.bfloat16)
                      for feed in VPU_CASES[name][1]]
        want = kernel.replay(*inputs)
        launches = kernel.launches()
        default = launches[0]
        launch_ms, err = {}, 0.0
        for launch in launches:
            got = kernel(*inputs, launch=launch)
            torch.cuda.synchronize()
            ok, tol = _codegen_close(got, want, want.dtype)
            if name == "bert_mask":
                ok, tol = torch.equal(got, want), 0.0
            err = max(err, max_err(got, want))
            check(ok, f"vpu_chain {name} at launch {launch} disagrees with the replay: {err}")
            launch_ms["x".join(map(str, launch))] = timer(
                lambda launch=launch: kernel(*inputs, launch=launch))
        copy_ms = timer(vv.copy_fn(inputs, torch.empty_like(want)))
        floor_lib, floor_log = floor_libs[name]
        kernel._bind(ctypes.CDLL(str(floor_lib)))
        floor_ms = timer(lambda: kernel(*inputs, launch=default))
        kernel._bind(_cuda_build.load_generated(kernel.source))
        nbytes = sum(t.numel() * t.element_size() for t in inputs) + want.numel() * \
            want.element_size()
        b_ms, b_by = bound_ms(nbytes, len(kernel.ops) * want.numel(), F32_FLOPS)
        floor_res = ptxas_resources(floor_log)
        out.append({"check": "vpu_chain", "case": name, "shape": {
                        "shape": list(want.shape), "inputs": [str(t.dtype).split(".")[-1]
                                                              for t in inputs],
                        "out": str(want.dtype).split(".")[-1], "ops": len(kernel.ops)},
                    "max_abs_err": err, "tolerance": tol,
                    "ms": launch_ms["x".join(map(str, default))], "launch_default": default,
                    "launch_ms": launch_ms, "copy_ms": copy_ms, "floor_ms": floor_ms,
                    "plain_ms": timer(lambda: kernel.replay(*inputs)),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    **_resources(build_info, kernel.source),
                    "floor_registers": sorted({r["registers"] for r in floor_res.values()})})
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
        library, library_call = None, None
        if name.startswith("softmax"):
            library, library_call = timer(lambda: torch.softmax(args[0], -1)), "torch.softmax"
        elif spec.kind == "matmul":  # the product plus bias alone, TF32 off: a yardstick
            x, w, b = (next(a for a, e in zip(args, spec.ext) if e.role == role)
                       for role in ("xrow", "weight", "bcast"))
            library = timer(lambda: torch.addmm(b, x, w))
            library_call = "torch.addmm (the product plus bias only)"
        shape = {"rows": spec.rows, "cols": spec.cols, "k": list(spec.k_dims),
                 "dtype": str(spec.out_dtype).split(".")[-1], "ops": [o.type for o in spec.ops]}
        common = {"case": name, "shape": shape, "max_abs_err": err, "tolerance": tol,
                  "plain_ms": timer(lambda: spec.reference()(*args)), "bound_ms": b_ms,
                  "bound_by": b_by, "library_ms": library, "library_call": library_call,
                  **_resources(build_info, spec.source())}
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


def plain_forward(model, ids, adapter=None):
    """The model's forward built only from the plain versions of the
    three kernels (the weights and the matmuls are the model's own).
    ``adapter``: ``{target: (A [L, in, r], B [L, r, out])}`` and its
    scaling, as a pair; each target projection then adds ``(x @ A[l]) @
    B[l] * scaling`` to its output."""
    from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
    from paddle_tpu_torch.ops import flash_attention_reference
    from paddle_tpu_torch.ops.fused_norm import rms_norm_plain
    from paddle_tpu_torch.ops.swiglu import swiglu_plain

    mm, eps = model.model, model.config.rms_norm_eps

    def proj(li, name, lin, x):
        out = lin(x)
        if adapter is not None and name in adapter[0]:
            a, b = adapter[0][name]
            out = out + ((x @ a[li]) @ b[li] * adapter[1]).to(out.dtype)
        return out

    h = mm.embed_tokens(ids)
    for li, layer in enumerate(mm.layers):
        a = layer.self_attn
        x = rms_norm_plain(h, layer.input_layernorm.weight, eps)
        b, s, _ = x.shape
        q = proj(li, "self_attn.q_proj", a.q_proj, x).reshape(b, s, a.num_heads, a.head_dim)
        k = proj(li, "self_attn.k_proj", a.k_proj, x).reshape(b, s, a.num_kv_heads, a.head_dim)
        v = proj(li, "self_attn.v_proj", a.v_proj, x).reshape(b, s, a.num_kv_heads, a.head_dim)
        q, k = apply_rotary_pos_emb(q, k, mm.rope_cos, mm.rope_sin)
        o = flash_attention_reference(q, k, v, causal=True)
        h = h + proj(li, "self_attn.o_proj", a.o_proj, o.reshape(b, s, a.num_heads * a.head_dim))
        x = rms_norm_plain(h, layer.post_attention_layernorm.weight, eps)
        gate, up = proj(li, "mlp.gate_up_proj", layer.mlp.gate_up_proj, x).chunk(2, dim=-1)
        h = h + proj(li, "mlp.down_proj", layer.mlp.down_proj, swiglu_plain(gate, up))
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


def prefill_cuts(engine, s0, start=0):
    """The forwards of one admission prefill over prompt positions [start,
    s0) (start > 0 after a prefix hit), each as (tokens, runs the prefill
    chain): interleaved engines forward one block a chunk; atomic ones the
    whole span at once when it fits ``prefill_chunk``, else
    ``prefill_chunk``-token chunks; a chunk the accepted prefill config
    tiles runs the prefill chain, the rest flash attention."""
    pf_cfg = engine._prefill_chain_cfg
    if engine._prefill_chunk_blocks() > 0:
        chunk = engine.block_size
    elif engine.prefill_chunk is None or s0 - start <= engine.prefill_chunk:
        return [(s0 - start, False)]
    else:
        chunk = engine.prefill_chunk
    cuts = [min(chunk, s0 - off) for off in range(start, s0, chunk)]
    return [(c, bool(pf_cfg) and c % pf_cfg["block_q"] == 0) for c in cuts]


def expected_counts(engine, cuts, iters):
    """Every kernel's launches implied by one serving run: the prefill
    forwards ``cuts`` (``prefill_cuts`` of each admission), then ``iters``
    decode token iterations (the accepted decode config's kernel, one
    launch a layer), 2L + 1 RMSNorms and L SwiGLUs a forward."""
    layers = engine.model.config.num_hidden_layers
    forwards = len(cuts)
    prefill_chain = sum(chain for _, chain in cuts)
    flash = forwards - prefill_chain
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


def _served_pass(engine, prompts, new, step, tag):
    """Submit every prompt (rid ``tag + name``) and step with ``step``
    (the engine's captured ``step`` or its eager body) until idle, with
    every launch count and the peak memory set to 0 just before.  Returns
    the launch counts, the streams and the pass's numbers."""
    from paddle_tpu_torch import ops

    cfg = engine.model.config
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    firsts = {rid: engine.add_request(tag + rid, p, max_new_tokens=new)
              for rid, p in prompts.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = 0
    while engine.has_work():
        step()
        steps += 1
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    check(not any(ops.yardstick_counts().values()),
          f"serving: a Triton yardstick launched: {ops.yardstick_counts()}")
    check(all(f is not None for f in firsts.values()), "a request was queued, not admitted")
    streams = {rid: engine.result(tag + rid) for rid in prompts}
    for rid, stream in streams.items():
        check(len(stream) == new, f"{tag}{rid}: {len(stream)} tokens, expected {new}")
        check(all(0 <= t < cfg.vocab_size for t in stream), f"{tag}{rid}: token id out of range")
    lengths = [len(p) for p in prompts.values()]
    want = expected_counts(engine, [c for s0 in lengths for c in prefill_cuts(engine, s0)],
                           steps * engine._effective_chunk())
    check(counts == want, f"{tag or 'graphed '}launch counts {counts} != expected {want}")
    prefill_tokens, decode_tokens = sum(lengths), len(lengths) * (new - 1)
    return counts, streams, {
        "steps": steps, "prefill_s": t1 - t0, "prefill_tokens_per_s": prefill_tokens / (t1 - t0),
        "decode_s": t2 - t1, "decode_tokens_per_s": decode_tokens / (t2 - t1),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def serve_engine(engine, prompts, new):
    """One warm-up pass over the prompts through the eager body (cuBLAS
    picks its algorithms per shape; the chained engines run their searches
    here), a measured pass through the eager body, then ``warmup()``,
    which captures the D-token step as a CUDA graph, and the measured pass
    of replays.  Checks both passes' launch counts and that the graphed
    streams equal the eager ones; the streams are the result's
    ``streams``."""
    from paddle_tpu_torch import ops

    for rid, p in prompts.items():
        engine.add_request("warm-" + rid, p, max_new_tokens=2)
    while engine.has_work():
        engine._step_eager()
    eager_counts, eager_streams, eager = _served_pass(engine, prompts, new,
                                                      engine._step_eager, "eager-")
    report = engine.warmup()
    D = engine._effective_chunk()
    captured = engine._step_fns[D]
    counts, streams, graphed = _served_pass(engine, prompts, new, engine.step, "")
    check(streams == eager_streams, f"graphed streams differ from the eager body's: "
                                    f"{_stream_diff(streams, eager_streams)}")
    check(counts == eager_counts, f"graphed launches {counts} != eager {eager_counts}")
    lengths = [len(p) for p in prompts.values()]
    return counts, {"requests": len(lengths), "prompt_lengths": lengths,
                    "new_tokens_each": new, "decode_chunk": D,
                    "steps": graphed["steps"], "launches": counts,
                    "triton_yardstick_launches": ops.yardstick_counts(),
                    **{k: v for k, v in graphed.items() if k != "steps"},
                    "eager": eager, "streams_equal_eager": True,
                    "warmup": report, "capture_s": captured.capture_s,
                    "graph_bytes": captured.graph_bytes,
                    "decode_speedup": graphed["decode_tokens_per_s"] / eager["decode_tokens_per_s"],
                    "pool_bytes": engine.pool_bytes(), "streams": streams}


def _stream_diff(a, b):
    """The first differing position of each differing stream."""
    return {rid: next(((i, x, y) for i, (x, y) in enumerate(zip(a[rid], b[rid])) if x != y),
                      (min(len(a[rid]), len(b[rid])), None, None))
            for rid in a if a[rid] != b[rid]}


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
    chained = {}  # kv -> the engine's verdicts, its streams and its numbers (phases 3d, 3e)
    default_pool_bytes = result["pool_bytes"]
    plain = {"streams": result.pop("streams"),
             "logits_err": first["first_token_logits_max_abs_err"]}
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
            # before the flags change below, which re-arms every live engine's verdicts
            verdicts = verdicts_of(engine)
        finally:
            set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
            shutil.rmtree(cache_dir, ignore_errors=True)
        paths[f"serving_{kv}_chained"] = counts
        chained[kv] = {"verdicts": verdicts, "streams": result.pop("streams"),
                       "counts": counts, "result": result}
        emit({"engine": f"{engine_name}, {kv} pools, prefill_chunk 128, schedule search",
              "card": card, **result, **first, **step,
              "decode_decision": _decision(engine.decode_decision),
              "prefill_decision": _decision(engine.prefill_decision),
              "schedule_decode_stats": stats,
              "pool_bytes_default_engine": default_pool_bytes})
        del engine
    gc.collect()
    paths.update(serve_admission(card, model))
    gc.collect()
    paths.update(serve_spec(card, model, plain))
    gc.collect()
    paths.update(serve_lora(card, model, chained["bf16"], plain))
    gc.collect()
    paths.update(serve_snapshot(card, model, chained["int8"]))
    gc.collect()
    paths.update(serve_generate(card, model, plain))
    return paths


SYSTEM_TOKENS = 512  # the shared system prompt: 32 pages at block_size 16
ADMISSION_SUFFIXES = (17, 40, 64, 100, 128, 150, 180, 200)
INTERLEAVED_BLOCKS = 4  # phase 3b (b): prefill_chunk_blocks


def admission_prompts(cfg):
    """Phase 3b's traffic: one 512-token system prompt and 8 requests that
    share it, each with its own suffix; the suffixes' first tokens all
    differ, so a hit is exactly the system prompt's 32 pages."""
    g = torch.Generator().manual_seed(6)
    system = torch.randint(0, cfg.vocab_size, (SYSTEM_TOKENS,), generator=g).tolist()
    prompts = {}
    for i, n in enumerate(ADMISSION_SUFFIXES):
        suffix = torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
        suffix[0] = 1 + i
        prompts[f"s{n}"] = system + suffix
    return system, prompts


class AdmissionLog:
    """Times an engine's admission work on the card (a sync before and
    after each call): atomic admissions (``_try_admit``; with the logits
    its prefill gave the first token, and whether it hit the prefix
    cache), interleaved prefill chunks (``_prefill_chunk_step``, summed a
    request), parking and unparking (ms, and the bytes of a parked
    request's pages on the host)."""

    def __init__(self, engine):
        from paddle_tpu_torch import serving

        self.prefill, self.logits = {}, {}
        self.park_ms, self.unpark_ms, self.park_bytes = [], [], []
        model, stats = engine.model, serving._DECODE_STATS
        admit, chunk = engine._try_admit, engine._prefill_chunk_step
        park, unpark = engine._park_request, engine._try_unpark

        def timed(fn, arg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(arg)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def try_admit(req):
            logits, seen, hits = model._logits, [], stats["prefix_hits"]

            def spy(h):  # the admission's one _logits call: its prefill's last position
                seen.append(logits(h))
                return seen[-1]

            model._logits = spy
            try:
                ok, ms = timed(admit, req)
            finally:
                del model._logits
            if ok:
                self.prefill[req["rid"]] = {"ms": ms, "hit": stats["prefix_hits"] > hits}
                self.logits[req["rid"]] = seen[-1][0, -1].float()
            return ok

        def prefill_chunk_step(slot):
            rid, hit = slot.rid, bool(slot.prefill.matched)
            done, ms = timed(chunk, slot)
            row = self.prefill.setdefault(rid, {"ms": 0.0, "hit": hit, "chunks": 0})
            row["ms"] += ms
            row["chunks"] += 1
            return done

        def park_request(slot):
            rid = slot.rid
            _, ms = timed(park, slot)
            rec = engine._parked[rid]
            self.park_ms.append(ms)
            self.park_bytes.append(sum(t.numel() * t.element_size()
                                       for pages in rec["pages_k"] + rec["pages_v"]
                                       for t in pages.values()))

        def try_unpark(rid):
            ok, ms = timed(unpark, rid)
            if ok:
                self.unpark_ms.append(ms)
            return ok

        engine._try_admit, engine._prefill_chunk_step = try_admit, prefill_chunk_step
        engine._park_request, engine._try_unpark = park_request, try_unpark

    def report(self):
        return {"prefill_ms": {rid: round(r["ms"], 3) for rid, r in self.prefill.items()},
                "prefill_hit": {rid: r["hit"] for rid, r in self.prefill.items()},
                "park_ms": self.park_ms, "unpark_ms": self.unpark_ms,
                "park_bytes_each": self.park_bytes}


_COUNTER_KEYS = ("dispatches", "tokens", "macro_steps", "step_seconds", "sync_seconds",
                 "prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_evictions",
                 "prefill_chunks", "preemptions", "preempt_readmits", "admitted_high",
                 "admitted_normal", "admitted_low", "completed_high", "completed_normal",
                 "completed_low")


def admission_engine(model, **engine_kw):
    """A phase-3b engine over phase 3's model, its search verdicts resolved
    (the search runs here, outside the counted passes)."""
    from paddle_tpu_torch.serving import GenerationEngine

    engine = GenerationEngine(model, **ENGINE_KW, **engine_kw, device=DEVICE)
    engine._resolve_decode_chain()
    engine._resolve_prefill_chain()
    return engine


def admission_pass(engine, traffic, step, starts):
    """Drive ``traffic`` — ("add", rid, prompt, priority), ("step",), or
    ("call", fn) — with ``step`` (the captured ``step`` or the eager body),
    then step until idle, every launch count set to 0 just before.
    ``starts`` maps each request to where its prefill must start (its hit
    length).  Checks the launch counts against what the run implies, the
    streams' lengths and ids, and that the hits were the ones planned.
    Returns the counts, the streams, the counter deltas and the log."""
    from paddle_tpu_torch import ops, serving

    cfg = engine.model.config
    log = AdmissionLog(engine)
    torch.cuda.synchronize()
    before = serving.decode_stats()
    ops.reset_launch_counts()
    prompts = {}
    for op in traffic:
        if op[0] == "add":
            prompts[op[1]] = op[2]
            engine.add_request(op[1], op[2], max_new_tokens=SERVE_NEW, priority=op[3])
        elif op[0] == "step":
            step()
        else:
            op[1]()
    while engine.has_work():
        step()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    after = serving.decode_stats()
    delta = {k: after[k] - before[k] for k in _COUNTER_KEYS}
    check(not any(ops.yardstick_counts().values()),
          f"admission: a Triton yardstick launched: {ops.yardstick_counts()}")
    streams = {rid: engine.result(rid) for rid in prompts}
    for rid, stream in streams.items():
        check(len(stream) == SERVE_NEW, f"{rid}: {len(stream)} tokens, expected {SERVE_NEW}")
        check(all(0 <= t < cfg.vocab_size for t in stream), f"{rid}: token id out of range")
    hits = {rid: start > 0 for rid, start in starts.items()}
    check({rid: r["hit"] for rid, r in log.prefill.items()} == hits,
          f"prefix hits {log.report()['prefill_hit']} != planned {hits}")
    if engine._prefix is not None:
        check(delta["prefix_hits"] == sum(hits.values())
              and delta["prefix_hit_tokens"] == sum(starts.values()),
              f"prefix counters {delta}, planned starts {starts}")
    cuts = [c for rid, p in prompts.items() for c in prefill_cuts(engine, len(p), starts[rid])]
    if engine._prefill_chunk_blocks() > 0:
        check(delta["prefill_chunks"] == len(cuts),
              f"prefill chunks {delta['prefill_chunks']} != {len(cuts)} planned")
    want = expected_counts(engine, cuts, delta["dispatches"] * engine._effective_chunk())
    check(counts == want, f"admission launch counts {counts} != expected {want}")
    return counts, streams, delta, log


def _decode_rate(delta):
    return delta["tokens"] / delta["step_seconds"] if delta["step_seconds"] else 0.0


def _pages_of(engine, blocks):
    """The bytes of ``blocks`` in every layer's pools (payload, and int8
    scales)."""
    from paddle_tpu_torch.ops import paged_attention as pa

    return [t[blocks].clone() for pool in engine._kpools + engine._vpools
            for _, t in pa.pool_parts(pool)]


def _hit_vs_miss(hit_log, miss_log):
    """Prefill ms of the same request as a hit and as a miss."""
    return {rid: {"hit_ms": hit_log.prefill[rid]["ms"], "miss_ms": miss_log.prefill[rid]["ms"]}
            for rid in hit_log.prefill
            if rid in miss_log.prefill and hit_log.prefill[rid]["hit"]
            and not miss_log.prefill[rid]["hit"]}


def serve_admission(card, model):
    """Phase 3b: the admission features at LLaMA-7B width, over phase 3's
    model.  (a) chained int8 engines (prefill_chunk 128, the search on)
    with the prefix cache, atomic admission: 7 hits of 512 tokens, the
    shared pages untouched by decoding, each hit's first-token logits
    against a prefix-off engine's, the replayed streams equal to the eager
    body's.  (b) bf16 engines with the prefix cache and interleaved
    prefill (4 blocks a step): four LOW requests, then two HIGH ones that
    preempt two of them; streams against uninterrupted LOW requests and
    against atomic admission in one-block chunks.  Returns each checked
    path's launch counts."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.serving import reset_schedule_decode_stats, schedule_decode_stats

    system, prompts = admission_prompts(model.config)
    rids = list(prompts)
    name = f"llama_7b {model.config.dtype} {model.config.num_hidden_layers} layers"
    paths = {}
    cache_dir = tempfile.mkdtemp(prefix="autotune-")  # the search runs every smoke run
    set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": cache_dir})
    reset_schedule_decode_stats()
    try:
        # (a) chained int8, atomic admission: the first request misses and
        # pours the system prompt, the 7 others hit its 32 pages
        kw = dict(CHAINED["int8"], prefix_cache=True)
        traffic = [("add", rid, p, "normal") for rid, p in prompts.items()]
        starts = {rid: SYSTEM_TOKENS if i else 0 for i, rid in enumerate(rids)}
        eager = admission_engine(model, **kw)
        stats = schedule_decode_stats()
        check(stats["decode_chains_accepted"] == 1 and stats["prefill_chains_accepted"] == 1,
              f"admission int8 engine: a chain lost the measured-win gate: {stats}")
        _, eager_streams, eager_delta, _ = admission_pass(eager, traffic, eager._step_eager,
                                                          starts)
        del eager
        off = admission_engine(model, **CHAINED["int8"])
        off.warmup()
        _, off_streams, off_delta, off_log = admission_pass(
            off, traffic, off.step, {rid: 0 for rid in rids})
        del off
        engine = admission_engine(model, **kw)
        report = engine.warmup()
        shared = {}

        def snapshot_shared():
            shared["blocks"] = engine._prefix.match(system)
            shared["bytes"] = _pages_of(engine, shared["blocks"])

        counts, streams, delta, log = admission_pass(
            engine, traffic[:1] + [("call", snapshot_shared)] + traffic[1:], engine.step, starts)
        check(len(shared["blocks"]) == SYSTEM_TOKENS // engine.block_size,
              f"the system prompt is cached in {len(shared['blocks'])} pages")
        differing = sum(int((a != b).sum()) for a, b in
                        zip(shared["bytes"], _pages_of(engine, shared["blocks"])))
        check(differing == 0, f"decoding changed {differing} bytes of the shared pages")
        check(delta["prefix_hits"] == 7 and delta["prefix_hit_tokens"] == 7 * SYSTEM_TOKENS,
              f"int8 prefix engine: {delta['prefix_hits']} hits, "
              f"{delta['prefix_hit_tokens']} tokens")
        check(streams == eager_streams, f"graphed streams differ from the eager body's: "
                                        f"{_stream_diff(streams, eager_streams)}")
        rel = {}
        for rid in rids[1:]:
            got, want = log.logits[rid], off_log.logits[rid]
            check(bool(torch.isfinite(got).all()), f"{rid}: non-finite logits")
            rel[rid] = float((got - want).norm() / want.norm())
            check(int(got.argmax()) == streams[rid][0],
                  f"{rid}: the first token is not the argmax of the hit's logits")
        check(max(rel.values()) <= LOGITS_REL_TOL,
              f"hit first-token logits against the prefix-off engine: relative L2 {rel}")
        paths["serving_admission_int8"] = counts
        emit({"engine": f"{name}, int8 pools, prefill_chunk 128, schedule search, prefix cache",
              "card": card, "requests": len(rids), "system_tokens": SYSTEM_TOKENS,
              "suffixes": list(ADMISSION_SUFFIXES), "new_tokens_each": SERVE_NEW,
              "launches": counts, "counters": delta, **log.report(),
              "hit_vs_miss_prefill_ms": _hit_vs_miss(log, off_log),
              "prefix_off_counters": off_delta,
              "hit_first_token_logits_rel_l2": rel, "shared_pages": len(shared["blocks"]),
              "shared_page_bytes_differing": differing, "streams_equal_eager": True,
              "eager_counters": eager_delta, "decode_tokens_per_s": _decode_rate(delta),
              "decode_tokens_per_s_eager": _decode_rate(eager_delta),
              "decode_tokens_per_s_prefix_off": _decode_rate(off_delta),
              "warmup": report, "pool_bytes": engine.pool_bytes(),
              "decode_decision": _decision(engine.decode_decision),
              "prefill_decision": _decision(engine.prefill_decision)})
        del engine

        # (b) bf16, interleaved prefill: the four LOW requests reserve
        # together (all miss), finish their prefill in the first step and
        # decode; two steps later two HIGH requests find every lane taken,
        # park two LOW ones on the host and hit the system prompt's pages
        low, high = rids[:4], rids[4:6]
        traffic = ([("add", rid, prompts[rid], "low") for rid in low] + [("step",)] * 2
                   + [("add", rid, prompts[rid], "high") for rid in high])
        starts = {rid: SYSTEM_TOKENS if rid in high else 0 for rid in low + high}
        kw = dict(prefix_cache=True, prefill_chunk_blocks=INTERLEAVED_BLOCKS)
        reset_schedule_decode_stats()
        engine = admission_engine(model, **kw)
        stats = schedule_decode_stats()
        check(stats["prefill_chains_found"] == 1 and stats["prefill_chains_disabled"] == 1
              and engine._prefill_chain_cfg is None,
              f"interleaved engine: the prefill chain at chunk {engine.block_size} was not "
              f"counted disabled: {stats}, {_decision(engine.prefill_decision)}")
        report = engine.warmup()
        counts, streams, delta, log = admission_pass(engine, traffic, engine.step, starts)
        check(delta["preemptions"] == 2 and delta["preempt_readmits"] == 2,
              f"interleaved engine: {delta['preemptions']} preemptions, "
              f"{delta['preempt_readmits']} re-admissions")
        paths["serving_admission_bf16"] = counts
        ref = admission_engine(model, **kw)
        ref.warmup()
        _, ref_streams, ref_delta, _ = admission_pass(
            ref, traffic[:4], ref.step, {rid: 0 for rid in low})
        check({rid: streams[rid] for rid in low} == ref_streams,
              f"preempted LOW streams differ from uninterrupted ones: "
              f"{_stream_diff({rid: streams[rid] for rid in low}, ref_streams)}")
        del ref
        atomic = admission_engine(model, prefix_cache=True, prefill_chunk=engine.block_size)
        atomic.warmup()
        _, atomic_streams, atomic_delta, atomic_log = admission_pass(
            atomic, traffic, atomic.step,
            {rid: SYSTEM_TOKENS if i else 0 for i, rid in enumerate(low + high)})
        check(streams == atomic_streams,
              f"interleaved streams differ from atomic admission in one-block chunks: "
              f"{_stream_diff(streams, atomic_streams)}")
        emit({"engine": f"{name}, bf16 pools, prefix cache, prefill_chunk_blocks "
                        f"{INTERLEAVED_BLOCKS}, schedule search", "card": card,
              "requests": {"low": low, "high": high}, "launches": counts, "counters": delta,
              **log.report(), "decode_tokens_per_s": _decode_rate(delta),
              "prefill_chain_decision": _decision(engine.prefill_decision),
              "decode_decision": _decision(engine.decode_decision),
              "low_streams_equal_uninterrupted": True, "streams_equal_atomic": True,
              "uninterrupted_counters": ref_delta, "warmup": report,
              "pool_bytes": engine.pool_bytes()})
        emit({"engine": f"{name}, bf16 pools, prefix cache, atomic, prefill_chunk "
                        f"{engine.block_size}, schedule search", "card": card,
              "counters": atomic_delta, **atomic_log.report(),
              "hit_vs_miss_prefill_ms": {**_hit_vs_miss(atomic_log, log),
                                         **_hit_vs_miss(log, atomic_log)},
              "decode_tokens_per_s": _decode_rate(atomic_delta)})
        del engine, atomic
    finally:
        set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
        shutil.rmtree(cache_dir, ignore_errors=True)
    return paths


SPEC_K = 4  # phase 3c: num_speculative_tokens
SPEC_DRAFT_LAYERS = 2  # phase 3c (b): the early-exit draft's depth


def early_exit_draft(model, layers):
    """A draft of ``model``'s width whose embedding, first ``layers``
    layers, final norm and head are the model's own (built on the meta
    device, then given the model's modules: no weight is copied)."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = dataclasses.replace(model.config, num_hidden_layers=layers)
    draft = LlamaForCausalLM(cfg, device="meta")
    draft.model.embed_tokens = model.model.embed_tokens
    draft.model.layers = torch.nn.ModuleList(list(model.model.layers[:layers]))
    draft.model.norm = model.model.norm
    draft.model.rope_cos, draft.model.rope_sin = model.model.rope_cos, model.model.rope_sin
    draft.lm_head = model.lm_head
    return draft


def spec_expected_counts(engine, admissions, ticks):
    """Every kernel's launches implied by a speculative run: ``admissions``
    atomic admissions, each one whole-suffix forward of the target and one
    of the draft (flash attention in both), then ``ticks`` ticks: K + 1
    draft steps (the final norm and head on the first K only) and one
    verify of K + 1 tokens, 2L + 1 RMSNorms and L SwiGLUs a forward."""
    from paddle_tpu_torch import ops

    t_layers = engine.model.config.num_hidden_layers
    d_layers = engine.draft_model.config.num_hidden_layers
    k = engine.num_speculative
    want = dict.fromkeys(ops.launch_counts(), 0)
    flash = (t_layers + d_layers) * admissions
    want.update({
        "fused_rms_norm": (2 * t_layers + 1 + 2 * d_layers + 1) * admissions
        + ticks * ((k + 1) * 2 * d_layers + k + 2 * t_layers + 1),
        "swiglu": (t_layers + d_layers) * admissions + ticks * ((k + 1) * d_layers + t_layers),
        "flash_attention_fwd": flash, "flash_attention_fwd_sm90": flash})
    return want


def spec_pass(engine, prompts, step, on_admitted=None, adapters=None):
    """Admit every prompt (SERVE_NEW new tokens each, through
    ``adapters[rid]`` where given; ``on_admitted()`` runs after the
    admissions, before any tick), then tick with ``step``
    (the captured ``step`` or the eager body) until idle, every launch
    count set to 0 just before.  Checks the launch counts against what the
    admissions and ticks imply (and the capture's warm-up tick, where the
    tick is captured in this pass) and the serving counters' K + 2
    dispatches a tick.  Returns the counts, the streams, the pass's numbers and its
    AdmissionLog (each admission's first-token logits)."""
    from paddle_tpu_torch import ops, serving

    cfg = engine.model.config
    log = AdmissionLog(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, spec0 = serving.decode_stats(), engine.spec_stats()
    uncaptured = engine._spec_fn is None
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, p in prompts.items():
        check(engine.add_request(rid, p, max_new_tokens=SERVE_NEW,
                                 adapter=(adapters or {}).get(rid)) is not None,
              f"{rid} was queued, not admitted")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if on_admitted is not None:
        on_admitted()
    tick_ms = []
    while engine.has_work():
        t = time.perf_counter()
        step()  # ends in the tick's device-to-host copy
        tick_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    after, spec1 = serving.decode_stats(), engine.spec_stats()
    check(not any(ops.yardstick_counts().values()),
          f"speculative: a Triton yardstick launched: {ops.yardstick_counts()}")
    streams = {rid: engine.result(rid) for rid in prompts}
    for rid, stream in streams.items():
        check(len(stream) == SERVE_NEW, f"{rid}: {len(stream)} tokens, expected {SERVE_NEW}")
        check(all(0 <= t < cfg.vocab_size for t in stream), f"{rid}: token id out of range")
    stats = {k: spec1[k] - spec0[k] for k in spec1}
    ticks = stats["ticks"]
    # a tick captured in this pass ran its body once more, for real: the
    # recording's warm-up (every lane idle, on scratch pages)
    warm = int(uncaptured and engine._spec_fn is not None and engine._spec_fn._graph is not None)
    want = spec_expected_counts(engine, len(prompts), ticks + warm)
    check(counts == want, f"speculative launch counts {counts} != expected {want}")
    dispatches = after["dispatches"] - before["dispatches"]
    check(dispatches == ticks * (engine.num_speculative + 2),
          f"speculative: {dispatches} dispatches for {ticks} ticks")
    decode_tokens = len(prompts) * (SERVE_NEW - 1)
    return counts, streams, {
        "ticks": ticks, "spec_stats": stats,
        "acceptance": stats["accepted"] / stats["proposed"],
        "tokens_per_lane_tick": stats["emitted"] / max(1, ticks * len(prompts)),
        "prefill_s": t1 - t0, "decode_s": t2 - t1,
        "decode_tokens_per_s": decode_tokens / (t2 - t1),
        "ms_per_tick": (t2 - t1) * 1e3 / max(1, ticks),
        # the first tick of a pass that captures also records the graph
        "tick_ms_median": statistics.median(tick_ms[warm:] or tick_ms),
        "tick_ms": tick_ms, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}, log


class SelfDraftTies:
    """While entered, records an engine's eager ticks (``_step_eager``) of a
    self-draft: the K draft steps' logits and the verify's, through the
    model's ``_logits``.  For every rejected proposal, ``gaps`` gets how
    far the verify's own pick trails the draft's pick in the draft's
    logits of that position: the same weights on the same tokens, computed
    as one row and as a row of a K + 1-token chunk, so a rejection must be
    a tie the two bf16 computations break apart; ``rejected`` counts the
    proposals the rejections dropped (a rejection at proposal j drops K -
    j of them), as ``spec_stats`` counts them.  Enter it after the
    admissions (``spec_pass``'s ``on_admitted``): ``AdmissionLog`` takes
    ``_logits`` over during each admission."""

    def __init__(self, engine):
        self.engine, self.gaps, self.rejected = engine, [], 0

    def __enter__(self):
        eng, model, seen = self.engine, self.engine.model, []
        logits, spec, k = model._logits, self.engine._spec_step, self.engine.num_speculative

        def spy(h):
            out = logits(h)
            seen.append(out)
            return out

        def spec_step(eager):
            seen.clear()
            lanes = [s.active for s in eng._slots]
            out = spec(eager)
            # the body's own argmax calls, on the same tensors: bf16 logits
            # tie exactly now and then, and a tie goes to whichever index
            # the reduction meets first
            props = torch.stack([lg[:, -1, :].argmax(-1) for lg in seen[:k]], dim=1)
            preds = seen[k].argmax(-1)
            for i in (i for i, active in enumerate(lanes) if active):
                bad = (props[i] != preds[i, :k]).nonzero()
                if len(bad):
                    j = int(bad[0])
                    lg = seen[j][i, -1].float()
                    self.gaps.append(float(lg.max() - lg[preds[i, j]]))
                    self.rejected += k - j
            return out

        model._logits, eng._spec_step = spy, spec_step
        return self

    def __exit__(self, *exc):
        del self.engine.model._logits, self.engine._spec_step


def check_against_plain(model, prompts, got, want, margin, what):
    """Spec streams against a plain greedy engine's: equal, or the first
    differing token is one the plain engine chose by a top-2 margin below
    ``margin`` (on a forward of the model over the prompt and the plain
    stream up to that token): a tie the two computations may break
    either way, after which the streams may part.  Returns each stream's
    first difference (None when equal)."""
    out = {}
    for rid, p in prompts.items():
        g, w = got[rid], want[rid]
        pos = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if pos is None:
            out[rid] = None
            continue
        with torch.no_grad():
            top2 = model(torch.tensor([p + w[:pos]], device=DEVICE))[0, -1].float().topk(2)
        m = float(top2.values[0] - top2.values[1])
        check(m < margin, f"{what}: {rid} parts from the plain engine at token {pos} "
                          f"({g[pos]} vs {w[pos]}), where the plain margin {m} >= {margin}")
        out[rid] = {"token": pos, "plain_margin": m}
    return out


def _spec_engine(model, draft, **engine_kw):
    from paddle_tpu_torch.serving import GenerationEngine

    return GenerationEngine(model, draft_model=draft, num_speculative_tokens=SPEC_K,
                            **ENGINE_KW, **engine_kw, device=DEVICE)


def _equal_pools(a, b):
    """Elements of the shared blocks (payload and int8 scales) that differ
    between two engines' pools, the draft's included."""
    from paddle_tpu_torch.ops import paged_attention as pa

    n = a._num_blocks
    return sum(int((x[:n] != y[:n]).sum())
               for pa_, pb_ in zip(a._all_pools(), b._all_pools())
               for (_, x), (_, y) in zip(pa.pool_parts(pa_), pa.pool_parts(pb_)))


def serve_spec(card, model, plain):
    """Phase 3c: speculative decoding on phase 3's model, K = SPEC_K, over
    phase 3's prompts and SERVE_NEW new tokens: (a) the model as its own
    draft, (b) a SPEC_DRAFT_LAYERS-layer early-exit draft, each through
    the eager tick and then the captured one (streams, spec_stats and both
    pool sets equal; each pass's launches as its ticks imply; a self-draft
    rejection only at a bf16 tie, ``SelfDraftTies``), the streams against
    phase 3's plain engine (``plain``: its streams and its first-token logit error
    against the plain versions, whose double is the bf16 margin); then
    (c) the early-exit draft with int8 pools and the prefix cache over
    two requests sharing phase 3b's 512-token system prompt: the shared
    pages of both pool sets unchanged by decoding, the streams against a
    plain int8 prefix engine's (margin: twice the hit's first-token logit
    error against a forward of the model).  Returns each run's launches."""
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = model.config
    prompts = serving_prompts(cfg)
    name = f"llama_7b {cfg.dtype} {cfg.num_hidden_layers} layers, speculative K {SPEC_K}"
    bf16_margin = 2 * plain["logits_err"]
    paths = {}
    drafts = {"self": model, "early_exit": early_exit_draft(model, SPEC_DRAFT_LAYERS)}
    for tag, draft in drafts.items():
        eager = _spec_engine(model, draft)
        ties = SelfDraftTies(eager)
        with contextlib.ExitStack() as stack:
            hook = (lambda: stack.enter_context(ties)) if tag == "self" else None
            e_counts, e_streams, e_nums, _ = spec_pass(eager, prompts, eager._step_eager, hook)
        engine = _spec_engine(model, draft)
        counts, streams, nums, _ = spec_pass(engine, prompts, engine.step)
        check(streams == e_streams,
              f"{tag}: graphed streams differ from the eager tick's: "
              f"{_stream_diff(streams, e_streams)}")
        check(nums["spec_stats"] == e_nums["spec_stats"],
              f"{tag}: graphed spec_stats {nums['spec_stats']} differ from the eager tick's "
              f"{e_nums['spec_stats']}")
        differing = _equal_pools(engine, eager)
        check(differing == 0, f"{tag}: {differing} pool elements differ from the eager tick's")
        if tag == "self":
            rejected = nums["spec_stats"]["proposed"] - nums["spec_stats"]["accepted"]
            check(ties.rejected == rejected and all(g < bf16_margin for g in ties.gaps),
                  f"self-draft: {rejected} proposals rejected ({ties.rejected} seen), gaps "
                  f"{ties.gaps}: not all bf16 ties (margin {bf16_margin})")
        parted = check_against_plain(model, prompts, streams, plain["streams"], bf16_margin, tag)
        captured = engine._spec_fn
        paths[f"serving_spec_{tag}"] = counts
        emit({"engine": f"{name}, draft {tag}"
                        + (f" ({SPEC_DRAFT_LAYERS} layers)" if tag != "self" else ""),
              "card": card, "prompt_lengths": [len(p) for p in prompts.values()],
              "new_tokens_each": SERVE_NEW, "launches": counts, **nums, "eager": e_nums,
              "streams_equal_eager": True, "pool_elements_differing_eager": differing,
              "decode_speedup": nums["decode_tokens_per_s"] / e_nums["decode_tokens_per_s"],
              "plain_margin_rule": bf16_margin, "parted_from_plain": parted,
              "self_draft_rejection_gaps": ties.gaps, "capture_s": captured.capture_s,
              "graph_bytes": captured.graph_bytes,
              "launches_per_tick": captured.launches[0], "pool_bytes": engine.pool_bytes()})
        del eager, engine
        gc.collect()

    # (c) int8 pools and the prefix cache: the second request hits the
    # system prompt's 32 pages in both pool sets
    system, adm = admission_prompts(cfg)
    pair = dict(list(adm.items())[:2])
    kw = dict(kv_cache_dtype="int8", prefix_cache=True)
    shared = {}
    engine = _spec_engine(model, drafts["early_exit"], **kw)

    def snapshot_shared():
        from paddle_tpu_torch.ops import paged_attention as pa

        shared["blocks"] = blocks = engine._prefix.match(system)
        shared["bytes"] = [t[blocks].clone() for pool in engine._all_pools()
                           for _, t in pa.pool_parts(pool)]

    counts, streams, nums, log = spec_pass(engine, pair, engine.step, snapshot_shared)
    from paddle_tpu_torch.ops import paged_attention as pa

    after = [t[shared["blocks"]] for pool in engine._all_pools() for _, t in pa.pool_parts(pool)]
    differing = sum(int((a != b).sum()) for a, b in zip(shared["bytes"], after))
    check(len(shared["blocks"]) == SYSTEM_TOKENS // engine.block_size,
          f"the system prompt is cached in {len(shared['blocks'])} pages")
    check(differing == 0, f"decoding changed {differing} bytes of the shared pages "
                          "(target and draft pools)")
    hit = list(pair)[1]
    check(log.prefill[hit]["hit"] and not log.prefill[list(pair)[0]]["hit"],
          f"prefix hits {log.report()['prefill_hit']}")
    with torch.no_grad():
        full = model(torch.tensor([pair[hit]], device=DEVICE))[0, -1].float()
    int8_err = float((log.logits[hit] - full).abs().max())
    ref = GenerationEngine(model, **ENGINE_KW, **kw, device=DEVICE)
    ref.warmup()
    for rid, p in pair.items():
        ref.add_request(rid, p, max_new_tokens=SERVE_NEW)
    while ref.has_work():
        ref.step()
    parted = check_against_plain(model, pair, streams, {rid: ref.result(rid) for rid in pair},
                                 2 * int8_err, "int8 prefix")
    paths["serving_spec_int8_prefix"] = counts
    emit({"engine": f"{name}, draft early_exit ({SPEC_DRAFT_LAYERS} layers), int8 pools, "
                    "prefix cache", "card": card, "system_tokens": SYSTEM_TOKENS,
          "prompt_lengths": [len(p) for p in pair.values()], "new_tokens_each": SERVE_NEW,
          "launches": counts, **nums, **log.report(), "shared_pages": len(shared["blocks"]),
          "shared_page_bytes_differing": differing, "hit_first_token_logits_max_abs_err":
          int8_err, "plain_margin_rule": 2 * int8_err, "parted_from_plain": parted,
          "capture_s": engine._spec_fn.capture_s, "graph_bytes": engine._spec_fn.graph_bytes,
          "pool_bytes": engine.pool_bytes()})
    del engine, ref, drafts
    gc.collect()
    return paths


LORA_RANK = 16            # phases 3d and 3e: the adapters' rank (alpha = rank: scaling 1)
LORA_SLOTS = 4            # the pack's usable slots
LORA_A_STD, LORA_B_STD = 0.02, 0.1  # each adapter moves a projection's output by about
                                    # 0.02 * 0.1 * sqrt(4096 * 16) = 0.5 of its own spread
LORA_ENGINE = dict(adapters={"rank": LORA_RANK, "max_adapters": LORA_SLOTS})
LORA_SHIFT_MIN = 5 * LOGITS_REL_TOL  # an adapter must move the first-token logits by more


def verdicts_of(engine):
    """An engine's resolved chain verdicts (configs and decisions)."""
    return {"_decode_chain_cfg": engine._decode_chain_cfg,
            "_prefill_chain_cfg": engine._prefill_chain_cfg,
            "decode_decision": engine.decode_decision,
            "prefill_decision": engine.prefill_decision}


def adopt_verdicts(engine, verdicts):
    """Give ``engine`` the verdicts a phase-3 chained engine of the same
    geometry reached (its search measured them in this run)."""
    check(isinstance(verdicts["_decode_chain_cfg"], dict)
          and isinstance(verdicts["_prefill_chain_cfg"], dict),
          f"phase 3's verdicts were not kept: {verdicts}")
    for k, v in verdicts.items():
        setattr(engine, k, v)
    return engine


def lora_adapter(model, seed):
    """A seeded adapter state dict of ``model``'s widths: every LLaMA
    target of every layer, A and B drawn on the card in the model's dtype
    (A std LORA_A_STD, B std LORA_B_STD)."""
    from paddle_tpu_torch.nn.lora import LLAMA_TARGETS, _resolve_sublayer

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = model.config.torch_dtype
    out = {}
    for li, layer in enumerate(model.model.layers):
        for t in LLAMA_TARGETS:
            lin = _resolve_sublayer(layer, t)
            out[f"model.layers.{li}.{t}.lora_A"] = (LORA_A_STD * torch.randn(
                lin.in_features, LORA_RANK, generator=g, device=DEVICE)).to(dt)
            out[f"model.layers.{li}.{t}.lora_B"] = (LORA_B_STD * torch.randn(
                LORA_RANK, lin.out_features, generator=g, device=DEVICE)).to(dt)
    return out


def _stacked(model, sd):
    """An adapter state dict as ``{target: (A [L, in, r], B [L, r, out])}``
    on the card (plain_forward's ``adapter``)."""
    from paddle_tpu_torch.nn.lora import LLAMA_TARGETS, parse_adapter_state_dict

    n = model.config.num_hidden_layers
    return {t: (a.to(DEVICE), b.to(DEVICE))
            for t, (a, b) in parse_adapter_state_dict(sd, n, LLAMA_TARGETS, LORA_RANK).items()}


def lora_pass(engine, reqs, step, tag=""):
    """Submit ``reqs`` (rid -> (prompt, adapter)), SERVE_NEW new tokens
    each, and step with ``step`` until idle, every launch count set to 0
    just before.  Checks the launches against what the admissions and
    steps imply (an adapter delta launches no kernel of the table).
    Returns the counts, the streams, the numbers and the engine's
    AdmissionLog (one an engine, over all its passes)."""
    from paddle_tpu_torch import ops, serving

    cfg = engine.model.config
    if not hasattr(engine, "admission_log"):
        engine.admission_log = AdmissionLog(engine)
    log = engine.admission_log
    torch.cuda.synchronize()
    before = serving.decode_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, (p, ad) in reqs.items():
        check(engine.add_request(tag + rid, p, max_new_tokens=SERVE_NEW, adapter=ad) is not None,
              f"{tag}{rid} was queued, not admitted")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = 0
    while engine.has_work():
        step()
        steps += 1
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    delta = {k: serving.decode_stats()[k] - before[k] for k in _COUNTER_KEYS}
    check(not any(ops.yardstick_counts().values()),
          f"lora: a Triton yardstick launched: {ops.yardstick_counts()}")
    streams = {rid: engine.result(tag + rid) for rid in reqs}
    for rid, stream in streams.items():
        check(len(stream) == SERVE_NEW, f"{tag}{rid}: {len(stream)} tokens, expected {SERVE_NEW}")
        check(all(0 <= t < cfg.vocab_size for t in stream), f"{tag}{rid}: token id out of range")
    cuts = [c for p, _ in reqs.values() for c in prefill_cuts(engine, len(p))]
    want = expected_counts(engine, cuts, delta["dispatches"] * engine._effective_chunk())
    check(counts == want, f"lora {tag}launch counts {counts} != expected {want}")
    return counts, streams, {"steps": steps, "prefill_s": t1 - t0, "decode_s": t2 - t1,
                             "ms_per_step": (t2 - t1) * 1e3 / max(1, steps),
                             "decode_tokens_per_s": len(reqs) * (SERVE_NEW - 1) / (t2 - t1),
                             "counters": delta}, log


def serve_lora(card, model, bf16, plain):
    """Phase 3d: multi-tenant LoRA on phase 3's model.  The engine is phase
    3's chained bf16 engine (its verdicts) with an adapter pack of
    LORA_SLOTS slots at rank LORA_RANK; three seeded adapters t0-t2 and a
    base request over phase 3's four prompts, SERVE_NEW tokens each,
    greedy.  (a) eager body against the graphed replays, (b) each request
    alone on the same engine against the mixed batch, (c) the base
    request against phase 3's chained bf16 engine, (d) each adapter
    request's first-token logits against a forward of plain versions with
    the adapter's delta (and each adapter's shift of those logits above
    LORA_SHIFT_MIN), (e) a hot swap between steps (evict t2, register t3)
    records nothing and t3's stream equals a fresh engine's, (f) the
    launches equal phase 3's chained bf16 engine's, (g) a speculative
    adapter engine (phase 3c's early-exit draft, K = SPEC_K) against the
    plain adapter engine (equal, or parting at a bf16 tie: phase 3c's
    rule).  Returns each checked path's launches."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.nn.lora import adapter_prefill_scope
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = model.config
    prompts = serving_prompts(cfg)
    names = ["t0", "t1", "t2", None]  # the longest prompt is the base request
    reqs = {rid: (p, ad) for (rid, p), ad in zip(prompts.items(), names)}
    sds = {f"t{i}": lora_adapter(model, 20 + i) for i in range(4)}

    def engine_of(**kw):
        eng = GenerationEngine(model, **ENGINE_KW, **CHAINED["bf16"], **kw, device=DEVICE)
        return adopt_verdicts(eng, bf16["verdicts"])

    def register(eng, *tags):
        for tag in tags:
            eng.register_adapter(tag, sds[tag])

    serving.reset_lora_stats()
    engine = engine_of(**LORA_ENGINE)
    register(engine, "t0", "t1", "t2")
    # (a) the eager body's pass, then warmup() and the replays
    e_counts, e_streams, e_nums, e_log = lora_pass(engine, reqs, engine._step_eager, "eager-")
    report = engine.warmup()
    D = engine._effective_chunk()
    captured = engine._step_fns[D]
    counts, streams, nums, log = lora_pass(engine, reqs, engine.step)
    check(streams == e_streams, f"lora: graphed streams differ from the eager body's: "
                                f"{_stream_diff(streams, e_streams)}")
    check(counts == e_counts, f"lora: graphed launches {counts} != eager {e_counts}")
    # (f) the same launches as the plain chained engine's for these submissions
    check(counts == bf16["counts"], f"lora launches {counts} != the plain chained engine's "
                                    f"{bf16['counts']}")
    # (c) the base request: phase 3's chained bf16 stream
    base = names.index(None)
    base_rid = list(reqs)[base]
    check(streams[base_rid] == bf16["streams"][base_rid],
          f"lora: the base request's stream differs from the plain chained engine's")
    check(len({tuple(s) for s in streams.values()}) == len(streams),
          "lora: two requests decoded the same stream")
    # (b) each request alone on the same engine (the step's M is max_batch)
    for rid, (p, ad) in reqs.items():
        _, alone, _, _ = lora_pass(engine, {rid: (p, ad)}, engine.step, "alone-")
        check(alone[rid] == streams[rid], f"lora: {rid} alone differs from the mixed batch: "
                                          f"{_stream_diff(alone, {rid: streams[rid]})}")
    # (d) first-token logits against plain versions with the adapter's delta
    rel, shift = {}, {}
    with torch.no_grad():
        for rid, (p, ad) in reqs.items():
            if ad is None:
                continue
            ids = torch.tensor([p], device=DEVICE)
            want = plain_forward(model, ids, (_stacked(model, sds[ad]), 1.0))[0, -1].float()
            base_logits = plain_forward(model, ids)[0, -1].float()
            got = log.logits[rid]
            check(bool(torch.isfinite(got).all()), f"lora {rid}: non-finite logits")
            rel[rid] = float((got - want).norm() / want.norm())
            shift[rid] = float((want - base_logits).norm() / base_logits.norm())
            check(int(got.argmax()) == streams[rid][0],
                  f"lora {rid}: the first token is not the argmax of its prefill logits")
    check(max(rel.values()) <= LOGITS_REL_TOL,
          f"lora first-token logits against plain versions with the delta: {rel}")
    check(min(shift.values()) >= LORA_SHIFT_MIN,
          f"lora: an adapter moves the first-token logits too little: {shift}")
    # (e) a hot swap between steps: t2 idle, evicted; t3 registered in its
    # slot while a base request decodes; nothing is recorded again
    long_p = prompts[base_rid]
    engine.add_request("swap-base", long_p, max_new_tokens=SERVE_NEW)
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.evict_adapter("t2")
    slot = engine.register_adapter("t3", sds["t3"])
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    t3_rid, t3_prompt = list(reqs)[2], list(reqs.values())[2][0]
    engine.add_request("swap-t3", t3_prompt, max_new_tokens=SERVE_NEW, adapter="t3")
    while engine.has_work():
        engine.step()
    check(list(engine._step_fns) == [D] and engine._step_fns[D] is captured,
          f"lora: the swap recorded a step again: {list(engine._step_fns)}")
    fresh = engine_of(**LORA_ENGINE)
    register(fresh, "t3")
    fresh.warmup()
    fresh.add_request("t3", t3_prompt, max_new_tokens=SERVE_NEW, adapter="t3")
    while fresh.has_work():
        fresh.step()
    check(engine.result("swap-t3") == fresh.result("t3"),
          "lora: t3 after the swap differs from a fresh engine's t3")
    check(engine.result("swap-base") == bf16["streams"][base_rid],
          "lora: the base request decoding across the swap changed its stream")
    del fresh
    lora = serving.lora_stats()
    pack_bytes = engine._pack.nbytes
    plain_chained = bf16["result"]
    emit({"engine": f"llama_7b {cfg.dtype} {cfg.num_hidden_layers} layers, bf16 pools, "
                    f"prefill_chunk 128, adapters rank {LORA_RANK} x {LORA_SLOTS} slots",
          "card": card, "requests": {rid: ad for rid, (_, ad) in reqs.items()},
          "new_tokens_each": SERVE_NEW, "decode_chunk": D, "launches": counts,
          "step_ms_graphed": nums["ms_per_step"], "step_ms_eager": e_nums["ms_per_step"],
          "plain_chained_step_ms_graphed": plain_chained["decode_s"] * 1e3
          / plain_chained["steps"],
          "plain_chained_step_ms_eager": plain_chained["eager"]["decode_s"] * 1e3
          / plain_chained["eager"]["steps"],
          "decode_tokens_per_s": nums["decode_tokens_per_s"],
          "decode_tokens_per_s_eager": e_nums["decode_tokens_per_s"],
          "prefill_ms": log.report()["prefill_ms"], "swap_ms": swap_ms, "swap_slot": slot,
          "pack_bytes": pack_bytes, "pool_bytes": engine.pool_bytes(),
          "first_token_logits_rel_l2": rel, "adapter_logit_shift_rel_l2": shift,
          "streams_equal_eager": True, "alone_equal_mixed": True,
          "base_equal_plain_chained": True, "swap_recorded_nothing": True,
          "launches_equal_plain_chained": True, "warmup": report,
          "capture_s": captured.capture_s, "graph_bytes": captured.graph_bytes,
          "lora_stats": lora})
    paths = {"serving_lora": counts, "serving_lora_eager": e_counts}
    del engine
    gc.collect()

    # (g) the speculative adapter engine: the early-exit draft proposes
    # with the base model, the verify goes through each row's adapter
    draft = early_exit_draft(model, SPEC_DRAFT_LAYERS)
    spec = GenerationEngine(model, draft_model=draft, num_speculative_tokens=SPEC_K,
                            **ENGINE_KW, **LORA_ENGINE, device=DEVICE)
    register(spec, "t0", "t1", "t2")
    s_counts, s_streams, s_nums, _ = spec_pass(
        spec, {rid: p for rid, (p, _) in reqs.items()}, spec.step,
        adapters={rid: ad for rid, (_, ad) in reqs.items()})
    margin = 2 * plain["logits_err"]
    parted = {}
    for rid, (p, ad) in reqs.items():
        if ad is None:
            scope = contextlib.nullcontext()
        else:
            scope = adapter_prefill_scope(model.model.layers, spec._pack,
                                          spec.adapter_slots()[ad])
        with scope:
            parted.update(check_against_plain(model, {rid: p}, {rid: s_streams[rid]},
                                              {rid: streams[rid]}, margin, "lora speculative"))
    paths["serving_lora_spec"] = s_counts
    emit({"engine": f"llama_7b {cfg.dtype} {cfg.num_hidden_layers} layers, speculative K "
                    f"{SPEC_K}, draft early_exit ({SPEC_DRAFT_LAYERS} layers), adapters rank "
                    f"{LORA_RANK}", "card": card, "launches": s_counts, **s_nums,
          "plain_margin_rule": margin, "parted_from_plain_adapter_engine": parted,
          "capture_s": spec._spec_fn.capture_s, "graph_bytes": spec._spec_fn.graph_bytes,
          "lora_stats": serving.lora_stats()})
    del spec, draft
    gc.collect()
    return paths


SNAPSHOT_ADAPTERS = ("t0", "t0", "t1", None, "t1", None, "t0", "t1")  # phase 3e, by suffix


def _snapshot_engine(model, int8):
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, **ENGINE_KW, **CHAINED["int8"], prefix_cache=True,
                           **LORA_ENGINE, device=DEVICE)
    return adopt_verdicts(eng, int8["verdicts"])


def _shared_pages(engine):
    """The blocks the prefix tree holds, and their bytes in every pool."""
    blocks = sorted(engine._prefix._by_block)
    return blocks, _pages_of(engine, blocks)


def serve_snapshot(card, model, int8):
    """Phase 3e: snapshot, restore and drain on phase 3's model.  A chained
    int8 engine (phase 3's int8 verdicts) with the prefix cache and the
    adapters serves phase 3b's 8 requests sharing the 512-token system
    prompt (adapters t0, t1 and the base model, SNAPSHOT_ADAPTERS), 4
    lanes: after two steps it is snapshotted into a temporary directory,
    then finishes.  It is deleted; ``restore_engine`` builds a fresh
    engine, which ``warmup()`` captures and which finishes: every stream
    bit for bit the original's, the shared pages' bytes and the slots'
    epochs as at the snapshot.  Then a second engine of the same traffic
    is drained after two steps: ``add_request`` raises, its residents
    finish, and the engine restored from the drain serves the queued
    requests; every stream the original's.  Returns the path's launches
    (every engine of the phase)."""
    from paddle_tpu_torch import ops, serving
    from paddle_tpu_torch.serving import restore_engine, snapshot_stats

    cfg = model.config
    _, prompts = admission_prompts(cfg)
    reqs = {rid: (p, ad) for (rid, p), ad in zip(prompts.items(), SNAPSHOT_ADAPTERS)}
    sds = {f"t{i}": lora_adapter(model, 30 + i) for i in range(2)}

    def start():
        eng = _snapshot_engine(model, int8)
        for tag, sd in sds.items():
            eng.register_adapter(tag, sd)
        eng.warmup()
        for rid, (p, ad) in reqs.items():
            eng.add_request(rid, p, max_new_tokens=SERVE_NEW, adapter=ad)
        eng.step()
        eng.step()
        return eng

    def finish(eng):
        while eng.has_work():
            eng.step()
        torch.cuda.synchronize()

    root = Path(tempfile.mkdtemp(prefix="engine-snapshot-"))
    serving.reset_snapshot_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    try:
        engine = start()
        check(engine.pending_requests() and any(s.active for s in engine._slots),
              "snapshot: nothing in flight or nothing queued at the snapshot")
        blocks, shared = _shared_pages(engine)
        epochs = list(engine._slot_epochs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = engine.snapshot(root / "snap")
        save_ms = (time.perf_counter() - t0) * 1e3
        snap_bytes = snapshot_stats()["bytes"]
        finish(engine)
        want = {rid: engine.result(rid) for rid in reqs}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = restore_engine(model, root / "snap", device=DEVICE)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        adopt_verdicts(restored, int8["verdicts"])
        check(restored._macro_steps == step, f"restored at {restored._macro_steps}, not {step}")
        differing = sum(int((a != b).sum()) for a, b in zip(shared, _pages_of(restored, blocks)))
        check(differing == 0, f"snapshot: {differing} bytes of the shared pages differ")
        check(restored._slot_epochs == epochs and serving.lora_stats()["slots_resident"] == 2,
              f"snapshot: epochs {restored._slot_epochs} != {epochs}")
        restored.warmup()
        finish(restored)
        got = {rid: restored.result(rid) for rid in reqs}
        check(got == want, f"restored streams differ from the original's: "
                           f"{_stream_diff(got, want)}")
        del restored
        gc.collect()

        # drain a busy engine: admissions close, its residents finish, the
        # engine restored from the drain serves its queue
        engine = start()
        queued = engine.pending_requests()
        engine.drain(root / "drain")
        raised = False
        try:
            engine.add_request("late", reqs[queued[0]][0], max_new_tokens=2)
        except RuntimeError:
            raised = True
        check(raised, "drain: add_request did not raise")
        finish(engine)
        residents = {rid: engine.result(rid) for rid in reqs if engine.result(rid) is not None}
        check(set(residents) == set(reqs) - set(queued),
              f"drain: the drained engine served {sorted(residents)}, queued {queued}")
        del engine
        gc.collect()
        target = adopt_verdicts(restore_engine(model, root / "drain", device=DEVICE),
                                int8["verdicts"])
        check(target.pending_requests() == queued, "drain: the queue did not ride the snapshot")
        target.warmup()
        finish(target)
        served = {**residents, **{rid: target.result(rid) for rid in queued}}
        check(served == want, f"drained and restored streams differ from the undrained "
                              f"run's: {_stream_diff(served, want)}")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        stats = snapshot_stats()
        del target
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    emit({"engine": f"llama_7b {cfg.dtype} {cfg.num_hidden_layers} layers, int8 pools, "
                    f"prefill_chunk 128, prefix cache, adapters rank {LORA_RANK}", "card": card,
          "requests": {rid: ad for rid, (_, ad) in reqs.items()}, "snapshot_step": step,
          "snapshot_bytes": snap_bytes, "save_ms": save_ms, "restore_ms": restore_ms,
          "save_gb_per_s": snap_bytes / save_ms / 1e6,
          "restore_gb_per_s": snap_bytes / restore_ms / 1e6,
          "shared_pages": len(blocks), "shared_page_bytes_differing": 0,
          "restored_equal_original": True, "drained_equal_undrained": True,
          "queued_at_drain": queued, "snapshot_stats": stats, "launches": counts,
          "lora_stats": serving.lora_stats()})
    return {"serving_snapshot": counts}


GEN_PROMPTS = 4            # phase 3f: prompts of GEN_PROMPT_LEN tokens (generate takes no padding)
GEN_PROMPT_LEN = 128
GEN_CHUNK = 8              # the paged macro-step's D
GEN_SAMPLED = dict(do_sample=True, temperature=1.5, top_k=50, top_p=0.9, seed=3)
GEN_BEAMS, GEN_BEAM_PROMPTS, GEN_BEAM_NEW = 4, 2, 16
GEN_SWEEP = (17, 25, 41, 65)  # new tokens: 2, 3, 5 and 8 D chunks (1, 2, 4 and 7 replays)


def generate_prompts(cfg):
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (GEN_PROMPTS, GEN_PROMPT_LEN), generator=g)


def generate_counts(layers, forwards, flash_forwards):
    """Every kernel's launches implied by a generate() run of ``forwards``
    model forwards (the prefill and each decode token iteration: 2L + 1
    RMSNorms and L SwiGLUs each), of which ``flash_forwards`` attend
    through flash attention (the prefill, and every naive-cache step)."""
    from paddle_tpu_torch import ops

    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update({"fused_rms_norm": (2 * layers + 1) * forwards, "swiglu": layers * forwards,
                 "flash_attention_fwd": layers * flash_forwards,
                 "flash_attention_fwd_sm90": layers * flash_forwards})
    return want


def generate_pass(run, ids, want, what, vocab=32000, **kw):
    """``run(ids, **kw)`` (generate or its eager twin) with every launch
    count set to 0 just before; checks the counts against ``want`` and
    the tokens' range.  Returns the tokens as lists, the counts and the
    seconds (the card synced at both ends)."""
    from paddle_tpu_torch import ops

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(ids, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts == want, f"generate {what}: launch counts {counts} != expected {want}")
    check(not any(ops.yardstick_counts().values()),
          f"generate {what}: a Triton yardstick launched: {ops.yardstick_counts()}")
    rows = out.tolist()
    check(all(0 <= t < vocab for r in rows for t in r), f"generate {what}: token out of range")
    return rows, counts, seconds


def _rate(rows, seconds):
    new = len(rows[0])
    return {"ms_per_token": seconds * 1e3 / new,
            "tokens_per_s": len(rows) * new / seconds, "seconds": seconds}


def spied_generate(model, run, ids, want, what, **kw):
    """``generate_pass`` that also keeps the logits every step selected
    from (``_last_logits``, f32 copies): for the eager body and the naive
    cache, which run every step in Python."""
    seen, orig = [], model._last_logits

    def spy(h):
        out = orig(h)
        seen.append(out.float().clone())
        return out

    model._last_logits = spy
    try:
        rows, counts, seconds = generate_pass(run, ids, want, what, **kw)
    finally:
        del model._last_logits  # the method again
    return rows, seen, seconds


def check_sampled_against(model, got, got_logits, want, want_logits, margin, what):
    """Sampled streams of the two caches: every token of each run is the
    Gumbel-max of its own run's filtered logits at that step (the spied
    ``_last_logits``), and the streams are equal or part first at a token
    where the two runs' logits, at that step and every step before,
    differ by less than ``margin`` (phase 3c's tie margin).  Top-k and
    top-p cut bf16 logits, which tie in runs of a few tokens, so a
    difference below the margin can move a token across a cut (module
    docstring, phase 3f).  Returns each row's first difference and the
    tokens checked."""
    from paddle_tpu_torch.models.llama import filter_logits
    from paddle_tpu_torch.serving import _request_seed, sampling

    t, k, p = GEN_SAMPLED["temperature"], GEN_SAMPLED["top_k"], GEN_SAMPLED["top_p"]
    vhash = sampling.vocab_hash(model.config.vocab_size, DEVICE)
    keys = torch.tensor([_request_seed(GEN_SAMPLED["seed"], r) for r in range(len(got))],
                        device=DEVICE)
    kept = {}
    for tag, lgs, streams in (("got", got_logits, got), ("want", want_logits, want)):
        check(len(lgs) == len(streams[0]), f"{what}: {len(lgs)} spied steps for "
                                           f"{len(streams[0])} tokens")
        for i, lg in enumerate(lgs):
            u = sampling.uniforms(keys, torch.full_like(keys, i), vhash)
            f = filter_logits(lg, t, k, p)
            drawn = torch.argmax(f + -torch.log(-torch.log(u)), dim=-1).tolist()
            bad = [r for r, row in enumerate(streams) if row[i] != drawn[r]]
            check(not bad, f"{what}: the {tag} run's token {i} of rows {bad} is not the "
                           "Gumbel-max of its own filtered logits")
            kept.setdefault(tag, []).append(torch.isfinite(f).sum(dim=-1).tolist())
    out = []
    for r, (g, w) in enumerate(zip(got, want)):
        pos = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if pos is None:
            out.append(None)
            continue
        diff = max(float((got_logits[i][r] - want_logits[i][r]).abs().max())
                   for i in range(pos + 1))
        check(diff < margin, f"{what}: row {r} parts at token {pos} ({g[pos]} vs {w[pos]}), "
                             f"where the runs' logits differ by {diff} >= {margin}")
        out.append({"token": pos, "logits_max_abs_diff": diff,
                    "kept": {tag: kept[tag][pos][r] for tag in kept}})
    return {"partings": out, "tokens_checked_each_run": len(got) * len(got[0])}


def check_top_k1(k1, greedy, logits):
    """top_k = 1 keeps every token tied at the top (the JAX package's
    ``lg >= kth``), and bf16 logits tie there now and then: the sampled
    stream equals greedy, or parts first at a step whose top two logits
    (greedy's own, ``logits``) are equal and at a token of that value.
    Returns each row's first difference."""
    out = []
    for r, (a, b) in enumerate(zip(k1, greedy)):
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if pos is not None:
            lg = logits[pos][r]
            top = float(lg.max())
            ties = int((lg == top).sum())
            check(ties > 1 and float(lg[a[pos]]) == top,
                  f"generate top_k=1: row {r} parts from greedy at {pos} ({a[pos]} vs "
                  f"{b[pos]}) with {ties} tokens at the top")
            pos = {"token": pos, "tied_at_top": ties}
        out.append(pos)
    return out


def recording_break_even(model, ids, layers):
    """The paged greedy call at D = GEN_CHUNK through the eager body and
    recorded (one recording, replayed by every later D chunk) at each
    length of GEN_SWEEP, in that order; the recorded streams equal the
    eager ones.  Returns the rows, the shortest length at which the
    recorded call was no slower, and the replays needed to pay back the
    recording from the two longest lengths' per-chunk costs."""
    rows = []
    for n in GEN_SWEEP:
        want = generate_counts(layers, n, 1)
        kw = dict(max_new_tokens=n, decode_chunk=GEN_CHUNK)
        eager, _, e_s = generate_pass(model._generate_eager, ids, want, f"eager {n}", **kw)
        got, _, r_s = generate_pass(model.generate, ids, want, f"recorded {n}", **kw)
        check(got == eager, f"generate {n} new tokens: recorded streams differ from eager")
        rec = model._decode_recordings[GEN_CHUNK]
        rows.append({"new_tokens": n, "eager_s": e_s, "recorded_s": r_s,
                     "eager_ms_per_token": e_s * 1e3 / n, "recorded_ms_per_token": r_s * 1e3 / n,
                     "replays": rec["replays"], "recording_s": rec["capture_s"]})
    a, b = rows[-2], rows[-1]
    chunks = (b["new_tokens"] - a["new_tokens"]) / GEN_CHUNK
    eager_chunk_s = (b["eager_s"] - a["eager_s"]) / chunks
    replay_chunk_s = (b["recorded_s"] - a["recorded_s"]) / chunks
    saved = eager_chunk_s - replay_chunk_s
    return {"rows": rows,
            "shortest_no_slower": next((r["new_tokens"] for r in rows
                                        if r["recorded_s"] <= r["eager_s"]), None),
            "eager_chunk_ms": eager_chunk_s * 1e3, "replay_chunk_ms": replay_chunk_s * 1e3,
            "replays_to_pay_back": (b["recording_s"] / saved) if saved > 0 else None}


def serve_generate(card, model, plain):
    """Phase 3f: the model-level ``generate`` on phase 3's model (module
    docstring).  ``plain``: phase 3's first-token logit error against the
    plain versions, whose double is the bf16 tie margin.  Returns each
    mode's launches."""
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = model.config
    layers, new = cfg.num_hidden_layers, SERVE_NEW
    margin = 2 * plain["logits_err"]
    ids = generate_prompts(cfg).to(DEVICE)
    prompts = {f"g{i}": row for i, row in enumerate(ids.tolist())}
    paged_want = generate_counts(layers, new, 1)
    naive_want = generate_counts(layers, new, new)
    modes, paths = {}, {}

    # paged greedy at D = GEN_CHUNK: the eager body, then the recorded chunks
    paged = dict(max_new_tokens=new, decode_chunk=GEN_CHUNK)
    eager, g_logits, e_s = spied_generate(model, model._generate_eager, ids, paged_want,
                                          "paged eager", **paged)
    greedy, counts, g_s = generate_pass(model.generate, ids, paged_want, "paged", **paged)
    check(greedy == eager, f"generate: recorded paged streams differ from the eager body's: "
                           f"{_stream_diff(dict(enumerate(greedy)), dict(enumerate(eager)))}")
    rec = model._decode_recordings
    check(set(rec) == {GEN_CHUNK} and rec[GEN_CHUNK]["replays"] == (new - 1) // GEN_CHUNK - 1,
          f"generate: recordings {rec}")
    paths["generate_paged"] = counts
    rec_s = sum(r["capture_s"] for r in rec.values())
    modes["paged_greedy"] = {**_rate(greedy, g_s), "recordings": rec, "recording_s": rec_s,
                             "ms_per_token_less_recording": (g_s - rec_s) * 1e3 / new,
                             "eager": _rate(eager, e_s), "streams_equal_eager": True,
                             "recording_pays": recording_break_even(model, ids, layers)}

    # naive greedy, then phase 3's default engine over the same prompts:
    # each equal to the paged streams, or parting at a bf16 tie
    naive, counts, n_s = generate_pass(model.generate, ids, naive_want, "naive",
                                       max_new_tokens=new, cache="naive")
    paged_streams = {rid: s for rid, s in zip(prompts, greedy)}
    parted_naive = check_against_plain(model, prompts, dict(zip(prompts, naive)),
                                       paged_streams, margin, "generate naive")
    paths["generate_naive"] = counts
    modes["naive_greedy"] = {**_rate(naive, n_s), "parted_from_paged": parted_naive}
    engine = GenerationEngine(model, **ENGINE_KW, device=DEVICE)
    engine.warmup()
    for rid, p in prompts.items():
        engine.add_request(rid, p, max_new_tokens=new)
    while engine.has_work():
        engine.step()
    parted_engine = check_against_plain(model, prompts, paged_streams,
                                        {rid: engine.result(rid) for rid in prompts}, margin,
                                        "generate paged against the default engine")
    modes["paged_greedy"]["parted_from_default_engine"] = parted_engine
    del engine
    gc.collect()

    # sampled: D = 1 and D = GEN_CHUNK bit for bit; naive against paged
    # (another attention: the flash kernel against the plain paged
    # gather) equal or parting at a drawn tie; top_k = 1 is greedy
    sampled, counts, s_s = generate_pass(model.generate, ids, paged_want, "sampled",
                                         **paged, **GEN_SAMPLED)
    one, _, _ = generate_pass(model.generate, ids, paged_want, "sampled D 1",
                              max_new_tokens=new, decode_chunk=1, **GEN_SAMPLED)
    check(one == sampled, "generate sampled: D 1 and D 8 streams differ")
    s_eager, e_logits, _ = spied_generate(model, model._generate_eager, ids, paged_want,
                                          "sampled eager", **paged, **GEN_SAMPLED)
    check(s_eager == sampled, "generate sampled: recorded and eager streams differ")
    s_naive, n_logits, _ = spied_generate(model, model.generate, ids, naive_want,
                                          "sampled naive", max_new_tokens=new, cache="naive",
                                          **GEN_SAMPLED)
    parted_sampled = check_sampled_against(model, s_naive, n_logits, sampled, e_logits,
                                           margin, "generate sampled naive")
    del e_logits, n_logits
    k1, _, _ = generate_pass(model.generate, ids, paged_want, "top_k 1", **paged,
                             do_sample=True, top_k=1, seed=5)
    top_k1_ties = check_top_k1(k1, greedy, g_logits)
    paths["generate_sampled"] = counts
    modes["paged_sampled"] = {**_rate(sampled, s_s), **GEN_SAMPLED,
                              "d1_equal_d8": True, "top_k1_parted_at_ties": top_k1_ties,
                              "naive_parted_from_paged": parted_sampled,
                              "distinct_from_greedy": sum(a != b for a, b in
                                                          zip(sampled, greedy))}

    # beam search on the naive cache: a B * K frontier of one-row steps
    beam_ids = ids[:GEN_BEAM_PROMPTS]
    beams, counts, b_s = generate_pass(
        model.generate, beam_ids, generate_counts(layers, GEN_BEAM_NEW, GEN_BEAM_NEW),
        "beam search", max_new_tokens=GEN_BEAM_NEW, num_beams=GEN_BEAMS)
    scores = model._beam_scores.float()
    check(bool(torch.isfinite(scores).all()) and scores.shape == (GEN_BEAM_PROMPTS, GEN_BEAMS),
          f"beam scores {scores}")
    paths["generate_beam"] = counts
    modes["beam_search"] = {**_rate(beams, b_s), "num_beams": GEN_BEAMS,
                            "prompts": GEN_BEAM_PROMPTS, "scores": scores.tolist()}

    # speculative: phase 3c's early-exit draft, one prompt, greedy
    from paddle_tpu_torch import ops

    draft = early_exit_draft(model, SPEC_DRAFT_LAYERS)
    d_layers = SPEC_DRAFT_LAYERS
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec = model.generate(ids[:1], max_new_tokens=new, draft_model=draft,
                          num_speculative_tokens=SPEC_K).tolist()
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    counts, st = ops.launch_counts(), dict(model._spec_stats)
    tf, df = st["target_forwards"], st["draft_forwards"]
    want = dict.fromkeys(counts, 0)
    flash = layers * tf + d_layers * df
    want.update({"fused_rms_norm": (2 * layers + 1) * tf + (2 * d_layers + 1) * df,
                 "swiglu": flash, "flash_attention_fwd": flash,
                 "flash_attention_fwd_sm90": flash})
    check(counts == want, f"generate speculative: launch counts {counts} != expected {want}")
    parted_spec = check_against_plain(model, {"g0": prompts["g0"]}, {"g0": spec[0]},
                                      {"g0": naive[0]}, margin, "generate speculative")
    paths["generate_speculative"] = counts
    modes["speculative"] = {**_rate(spec, spec_s), "draft_layers": d_layers, "k": SPEC_K,
                            "spec_stats": st, "parted_from_naive": parted_spec}
    del draft
    emit({"generate": f"llama_7b {cfg.dtype} {layers} layers, LlamaForCausalLM.generate",
          "card": card, "prompts": GEN_PROMPTS, "prompt_len": GEN_PROMPT_LEN,
          "new_tokens_each": new, "decode_chunk": GEN_CHUNK, "tie_margin": margin,
          "modes": modes, "launches": paths})
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


def check_first_step(model, ids, labels, scale=1.0):
    """The first step's loss and gradients through the kernels against a
    backward through a forward built only from the plain versions, from
    the same weights; both backwards from the loss times ``scale`` (a
    loss scaler's, which keeps f16 gradients from underflowing)."""
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
        (loss * scale).backward()
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


def _train_state(step):
    """Copies of every tensor the step reads and writes (parameters, f32
    masters, moments, beta powers, the rate), then the step count."""
    opt = step.optimizer
    return ([p.detach().clone() for p in opt._parameter_list]
            + [t.clone() for t in opt.opt_state_tensors()], opt._step_count)


@torch.no_grad()
def _set_train_state(step, state):
    opt = step.optimizer
    tensors, count = state
    for t, v in zip(list(opt._parameter_list) + opt.opt_state_tensors(), tensors, strict=True):
        t.copy_(v)
    opt._step_count = count


def _state_differing(a, b):
    """Elements that differ between two ``_train_state`` copies, and the
    largest absolute difference."""
    pairs = list(zip(a[0], b[0], strict=True))
    n = sum(int((x != y).sum()) for x, y in pairs)
    err = max(float((x.float() - y.float()).abs().max()) for x, y in pairs)
    return n + (a[1] != b[1]), err


def _train_steps(step, run, ids, labels, n, per_step, what):
    """``n`` steps through ``run`` (the TrainStep, or its eager body), each
    one's launch counts checked against ``per_step``; returns the losses,
    the ms a step (host clock, the card synced at both ends) and the
    launches of all ``n``."""
    from paddle_tpu_torch import ops

    losses, totals = [], dict.fromkeys(per_step, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        ops.reset_launch_counts()
        losses.append(run(ids, labels))
        counts = ops.launch_counts()
        check(counts == per_step, f"{what} step {i}: launch counts {counts} != {per_step}")
        check(not any(ops.yardstick_counts().values()),
              f"{what} step {i}: a Triton yardstick launched: {ops.yardstick_counts()}")
        totals = {k: totals[k] + counts[k] for k in totals}
    torch.cuda.synchronize()
    return [float(x) for x in losses], (time.perf_counter() - t0) * 1e3 / n, totals


def train(card):
    """Phase 4; returns the launches of the graphed and of the eager steps,
    and the graphed step's ms."""
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
    # the eager steps: TrainStep's body, op by op
    warm_losses, _, _ = _train_steps(step, step._eager_step, ids, labels, warmup, per_step,
                                     "eager warm-up")
    losses, eager_ms, eager_totals = _train_steps(step, step._eager_step, ids, labels, timed,
                                                  per_step, "eager")
    losses = warm_losses + losses
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"the training loss did not fall: {losses}")
    eager_peak = torch.cuda.max_memory_allocated() / 1e9

    # warmup(): the step recorded for the batch's signature, no state moved
    saved = _train_state(step)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(step.warmup(ids, labels) is step, "TrainStep.warmup did not return the step")
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    moved, _ = _state_differing(_train_state(step), saved)
    check(moved == 0 and all(p.grad is None for p in model.parameters()),
          f"warmup() changed {moved} state elements or left a grad")
    captured = step._steps[((tuple(ids.shape), ids.dtype), (tuple(labels.shape), labels.dtype))]
    check(captured.step.launches[0] == {k: v for k, v in per_step.items() if v},
          f"the recorded step credits {captured.step.launches[0]} a replay")

    # TIMED graphed steps from the saved state, then TIMED eager steps
    # from the same state: losses and every state tensor bit for bit
    torch.cuda.reset_peak_memory_stats()
    g_losses, graphed_ms, totals = _train_steps(step, step, ids, labels, timed, per_step,
                                                "graphed")
    graphed_peak = torch.cuda.max_memory_allocated() / 1e9
    check(step.captures == 1 and step.optimizer._step_count == saved[1] + timed,
          f"graphed steps: {step.captures} recordings, step count {step.optimizer._step_count}")
    graphed_state = _train_state(step)
    _set_train_state(step, saved)
    e_losses, eager_again_ms, _ = _train_steps(step, step._eager_step, ids, labels, timed,
                                               per_step, "eager (from the saved state)")
    differing, max_err = _state_differing(graphed_state, _train_state(step))
    check(g_losses == e_losses and differing == 0,
          f"graphed steps differ from eager steps from the same state: losses {g_losses} vs "
          f"{e_losses}, {differing} state elements (max abs {max_err})")

    tokens = batch * seq
    flops = (6 * n_params + 12 * layers * cfg.hidden_size * seq) * tokens
    result = {"trainer": f"bench.py flagship {cfg.dtype} {layers} layers, hidden "
                         f"{cfg.hidden_size}, batch {batch} x {seq}", "card": card,
              "parameters": n_params, "first_step": first, "losses": losses,
              "graphed_losses": g_losses, "graphed_equal_eager": True,
              "warmup_steps": warmup, "timed_steps": timed,
              "launches_per_step": per_step, "launches_per_replay": captured.step.launches[0],
              "triton_yardstick_launches": ops.yardstick_counts(), "step_ms": graphed_ms,
              "eager_step_ms": eager_ms, "eager_again_step_ms": eager_again_ms,
              "tokens_per_s": tokens / (graphed_ms / 1e3),
              "eager_tokens_per_s": tokens / (eager_ms / 1e3),
              "warmup_s": warmup_s, "capture_s": captured.step.capture_s,
              "graph_bytes": captured.step.graph_bytes,
              "model_flops_per_step": flops,
              "model_flop_share": flops / (graphed_ms / 1e3) / BF16_TC_FLOPS,
              "eager_model_flop_share": flops / (eager_ms / 1e3) / BF16_TC_FLOPS,
              "peak_memory_gb": graphed_peak, "eager_peak_memory_gb": eager_peak}
    emit(result)
    paths = {"training": totals, "training_eager": eager_totals}
    del step, captured  # phase 4's optimizer state and graph
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(train_lora(card, model, ids, labels, per_step, graphed_ms))
    return paths, graphed_ms


LORA_TRAIN_LR = 1e-3  # phase 4b: AdamW over the adapters


def train_lora(card, model, ids, labels, per_step, full_step_ms):
    """Phase 4b: the LoRA fine-tune on phase 4's model.  ``apply_lora``
    (rank LORA_RANK on every LLaMA projection) freezes the base; TrainStep
    with AdamW over every parameter trains the adapters alone: 3 eager
    steps, ``warmup()``, 5 graphed steps.  Every step's launches are
    phase 4's (the adapters' products launch no kernel of the table), the
    loss falls, every base parameter holds no grad and stays bit for bit,
    and the optimizer holds the adapters' state alone.  Returns the
    graphed and the eager steps' launches."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.lora import apply_lora
    from paddle_tpu_torch.optimizer import AdamW

    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    apply_lora(model, rank=LORA_RANK, generator=torch.Generator(device=DEVICE).manual_seed(7))
    adapters = [p for p in model.parameters() if p.requires_grad]
    step = TrainStep(model, AdamW(learning_rate=LORA_TRAIN_LR, parameters=model.parameters(),
                                  weight_decay=0.01), _loss_fn)
    e_losses, eager_ms, eager_totals = _train_steps(step, step._eager_step, ids, labels, 3,
                                                    per_step, "lora eager")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.warmup(ids, labels)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    g_losses, graphed_ms, totals = _train_steps(step, step, ids, labels, 5, per_step,
                                                "lora graphed")
    losses = e_losses + g_losses
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"lora fine-tune: the loss did not fall: {losses}")
    params = dict(model.named_parameters())
    moved = [n for n, t in base.items() if params[n].grad is not None
             or not torch.equal(params[n], t)]
    check(not moved, f"lora fine-tune: base parameters moved or hold a grad: {moved[:4]}")
    held = {pid for _, pid in step.optimizer._accumulators}
    check(held == {id(p) for p in adapters},
          "lora fine-tune: the optimizer holds state of frozen parameters")
    n_adapter = sum(p.numel() for p in adapters)
    emit({"trainer": f"bench.py flagship, apply_lora rank {LORA_RANK}, AdamW lr "
                     f"{LORA_TRAIN_LR} over the adapters", "card": card,
          "adapter_parameters": n_adapter, "frozen_parameters": len(base),
          "losses": losses, "step_ms": graphed_ms, "eager_step_ms": eager_ms,
          "full_fine_tune_step_ms": full_step_ms, "warmup_s": warmup_s,
          "launches_per_step": per_step, "base_unchanged": True,
          "optimizer_state_tensors": len(step.optimizer.opt_state_tensors()),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"training_lora": totals, "training_lora_eager": eager_totals}


AMP_WARM, AMP_TIMED = 3, 10  # phase 4c: eager steps, then graphed and eager steps from one state
AMP_OVERFLOW_SCALE = 2.0 ** 40


def _amp_loss_fn(dtype):
    from paddle_tpu_torch import amp

    def loss_fn(model, ids, labels):
        with amp.auto_cast(dtype=dtype):
            return model(ids, labels=labels)[0]

    return loss_fn


def _amp_state(step):
    """``_train_state`` with the scaler's scale and counts after it."""
    tensors, count = _train_state(step)
    scaler = [] if step.scaler is None else [t.clone() for t in step.scaler.state_tensors()]
    return tensors + scaler, count


@torch.no_grad()
def _set_amp_state(step, state):
    tensors, count = state
    opt = step.optimizer
    scaler = [] if step.scaler is None else step.scaler.state_tensors()
    for t, v in zip(list(opt._parameter_list) + opt.opt_state_tensors() + scaler, tensors,
                    strict=True):
        t.copy_(v)
    opt._step_count = count


def _amp_steps(step, run, ids, labels, n, per_step, what):
    """``_train_steps`` that also keeps each step's scale and found flag (as
    device copies, read after the last step)."""
    scales = []
    if step.scaler is not None:
        inner = run

        def run(a, b):
            loss = inner(a, b)
            scales.append((step.scaler._scale_t.clone(), step.scaler._found_t.clone()))
            return loss

    losses, ms, totals = _train_steps(step, run, ids, labels, n, per_step, what)
    return losses, ms, totals, [(float(s), bool(f)) for s, f in scales]


def _kernel_dtypes(model):
    """Hooks on layer 0 that record the dtype each kernel ran in: the
    input RMSNorm's input, the flash forward's output (what o_proj reads)
    and SwiGLU's output (what down_proj reads).  Returns the record and the
    hooks' handles."""
    layer, seen = model.model.layers[0], {}

    def hook(name, of_output=False):
        def record(mod, args, out):
            seen.setdefault(name, set()).add((out if of_output else args[0]).dtype)
        return record

    handles = [layer.input_layernorm.register_forward_hook(hook("rms_norm", True)),
               layer.self_attn.o_proj.register_forward_hook(hook("flash_attention_fwd")),
               layer.mlp.down_proj.register_forward_hook(hook("swiglu"))]
    return seen, handles


def train_amp(card, bf16_step_ms):
    """Phase 4c: AMP O1 on phase 4's configuration built in f32 (module
    docstring).  Returns each run's launches."""
    import dataclasses

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = dataclasses.replace(train_config(), dtype="float32")
    batch, seq = 4, 1024
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=torch.Generator(device=DEVICE).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    check(all(p.dtype == torch.float32 for p in model.parameters()), "the AMP model is not f32")
    g = torch.Generator(device=DEVICE).manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device=DEVICE)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device=DEVICE)
    layers = cfg.num_hidden_layers
    per_step = {"fused_rms_norm": 2 * layers + 1, "swiglu": layers, "flash_attention_fwd": layers,
                "flash_attention_fwd_sm90": layers, "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers, "flash_attention_bwd_dq_sm90": layers,
                "flash_attention_bwd_dkv_sm90": layers, "decode_chain_batch": 0,
                "decode_chain_rows": 0, "decode_chain_batch_sm90": 0, "decode_chain_rows_sm90": 0,
                "prefill_chain": 0, "prefill_chain_sm90": 0,
                "fused_layer_norm": 0, "matmul_epilogue": 0, "matmul_epilogue_sm90": 0,
                "vpu_chain": 0, "sched_chain": 0, "sched_chain_ktiled": 0}
    with amp.auto_cast(dtype="bfloat16"):
        first = check_first_step(model, ids, labels)
    # fp16 as the scaler trains it: the loss scaled by its initial scale
    f16_scale = amp.GradScaler(device=DEVICE).get_loss_scaling()
    with amp.auto_cast(dtype="float16"):
        first_f16 = {**check_first_step(model, ids, labels, f16_scale), "loss_scale": f16_scale}
    paths, results = {}, {}
    for tag, dtype in (("bf16", "bfloat16"), ("f16_scaler", "float16")):
        scaler = amp.GradScaler() if tag == "f16_scaler" else None
        step = TrainStep(model, AdamW(learning_rate=1e-4, parameters=model.parameters(),
                                      weight_decay=0.01), _amp_loss_fn(dtype), scaler=scaler)
        seen, hooks = _kernel_dtypes(model)
        warm, _, _, warm_scales = _amp_steps(step, step._eager_step, ids, labels, AMP_WARM,
                                             per_step, f"amp {tag} eager warm-up")
        for h in hooks:
            h.remove()
        want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        # the norm follows its f32 input (fused_rms_norm is in no list);
        # attention and SwiGLU run on the white-listed products' dtype
        check(seen == {"rms_norm": {torch.float32}, "flash_attention_fwd": {want_dt},
                       "swiglu": {want_dt}}, f"amp {tag}: kernels ran in {seen}")
        saved = _amp_state(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.warmup(ids, labels)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        moved, _ = _state_differing(_amp_state(step), saved)
        check(moved == 0 and all(p.grad is None for p in model.parameters()),
              f"amp {tag}: warmup() changed {moved} state elements or left a grad")
        g_losses, graphed_ms, totals, g_scales = _amp_steps(step, step, ids, labels, AMP_TIMED,
                                                            per_step, f"amp {tag} graphed")
        graphed_state = _amp_state(step)
        _set_amp_state(step, saved)
        e_losses, eager_ms, e_totals, e_scales = _amp_steps(
            step, step._eager_step, ids, labels, AMP_TIMED, per_step, f"amp {tag} eager")
        differing, max_err = _state_differing(graphed_state, _amp_state(step))
        check(g_losses == e_losses and g_scales == e_scales and differing == 0,
              f"amp {tag}: graphed steps differ from eager steps from the same state: losses "
              f"{g_losses} vs {e_losses}, scales {g_scales} vs {e_scales}, {differing} state "
              f"elements (max abs {max_err})")
        losses = warm + g_losses
        check(all(math.isfinite(x) for x in losses), f"amp {tag}: non-finite loss {losses}")
        result = {"steps": AMP_WARM + AMP_TIMED, "losses": losses, "eager_losses": e_losses,
                  "graphed_equal_eager": True, "step_ms": graphed_ms, "eager_step_ms": eager_ms,
                  "warmup_s": warmup_s,
                  "kernel_dtypes": {k: str(next(iter(v))) for k, v in seen.items()}}
        if scaler is not None:
            result["scale_and_skip_by_step"] = warm_scales + g_scales
            # (c) a forced overflow: one recorded step at 2**40 is skipped
            before = _amp_state(step)
            scaler.set_init_loss_scaling(AMP_OVERFLOW_SCALE)
            ops_before = step.optimizer._step_count
            step(ids, labels)
            torch.cuda.synchronize()
            after = _amp_state(step)
            unchanged, _ = _state_differing((after[0][:-3], 0), (before[0][:-3], 0))
            check(unchanged == 0 and bool(scaler._found_t)
                  and scaler.get_loss_scaling() == AMP_OVERFLOW_SCALE / 2,
                  f"amp overflow: {unchanged} state elements moved, found "
                  f"{bool(scaler._found_t)}, scale {scaler.get_loss_scaling()}")
            result["overflow"] = {"scale_set": AMP_OVERFLOW_SCALE,
                                  "scale_after": scaler.get_loss_scaling(),
                                  "state_elements_moved": unchanged,
                                  "step_count": [ops_before, step.optimizer._step_count]}
        results[tag] = result
        paths[f"training_amp_{tag}"] = totals
        paths[f"training_amp_{tag}_eager"] = e_totals
        del step, saved, graphed_state
        gc.collect()
        torch.cuda.empty_cache()
    emit({"trainer": f"bench.py flagship built in float32 ({n_params} parameters), AMP O1, "
                     f"batch {batch} x {seq}", "card": card, "first_step_bf16": first,
          "first_step_f16_scaled": first_f16,
          "launches_per_step": per_step, **results, "bf16_model_step_ms": bf16_step_ms,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return paths


# ------------------------------------------------------- phases 4d and 4e: GPT-2

GPT_BATCH, GPT_SEQ = 8, 1024       # phase 4d: one seeded batch of 8 x 1024 tokens
GPT_WARM, GPT_TIMED = 3, 10        # phase 4d: eager steps, then graphed and eager steps
GPT_F32_LOSS_TOL = 1e-4            # first f32 loss, kernels vs plain versions: the general
                                   # (FMA) flash kernels sum in other orders than the plain
GPT_F32_GRAD_TOL = 1e-3            # relative L2 of an f32 gradient through 12 layers, the same
OPT_TIER_STEPS = (2, 3)            # phase 4e: eager steps, then graphed and eager steps


def gpt_config():
    """GPT-2 small (openai-community/gpt2: n_embd 768, n_layer 12, n_head
    12, n_positions 1024; the vocabulary padded to 50304), GPTConfig()'s
    defaults, dropout 0.1."""
    from paddle_tpu_torch.models import GPTConfig

    return GPTConfig()


def gpt_plain_forward(model, ids):
    """GPT's forward built only from plain versions: the flash kernels'
    plain version, and the port's dropouts called in the model's order, so
    from the same RNG state they draw the same masks."""
    from paddle_tpu_torch.nn import functional as tF
    from paddle_tpu_torch.ops import flash_attention_reference
    from paddle_tpu_torch.static.program import apply

    g, p = model.gpt, model.config.dropout
    b, s = ids.shape
    pos = torch.arange(s, dtype=torch.int32, device=ids.device).unsqueeze(0).expand(b, s)
    h = tF.dropout(g.wte(ids) + g.wpe(pos), p, training=model.training)
    for blk in g.h:
        a, x = blk.attn, blk.ln_1(h)
        q, k, v = (lin(x).reshape(b, s, a.num_heads, a.head_dim)
                   for lin in (a.q_proj, a.k_proj, a.v_proj))
        o = tF.dropout(flash_attention_reference(q, k, v, causal=True), p,
                       training=model.training)
        h = h + a.out_proj(o.reshape(b, s, a.embed_dim))
        h = h + tF.dropout(blk.fc_out(tF.gelu(blk.fc_in(blk.ln_2(h)))), p,
                           training=model.training)
    return apply("matmul", torch.matmul, g.ln_f(h), g.wte.weight.t())


def check_gpt_first_step(model, ids, labels, loss_tol, grad_tol):
    """The first step's loss and gradients through the kernels against a
    backward through ``gpt_plain_forward``, each from the same RNG state
    (so the same dropout masks) and the same weights."""
    from paddle_tpu_torch._core import random as trandom
    from paddle_tpu_torch.nn import functional as tF

    names = ["gpt.wte.weight", "gpt.h.0.attn.q_proj.weight", "gpt.h.11.fc_out.weight",
             "gpt.ln_f.weight"]
    params = dict(model.named_parameters())
    rng = trandom.state_tensor(DEVICE)
    start = rng.clone()
    results = []
    for path in ("kernels", "plain"):
        rng.copy_(start)
        model.zero_grad(set_to_none=True)
        if path == "kernels":
            loss = _loss_fn(model, ids, labels)
        else:
            logits = gpt_plain_forward(model, ids)
            loss = tF.cross_entropy(logits[:, :-1].reshape(-1, model.config.vocab_size).float(),
                                    labels[:, 1:].reshape(-1))
        loss.backward()
        results.append((float(loss.detach()), {n: params[n].grad.clone() for n in names}))
    model.zero_grad(set_to_none=True)
    (k_loss, k_grads), (p_loss, p_grads) = results
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    check(loss_rel <= loss_tol, f"GPT first loss {k_loss} vs plain {p_loss}")
    rels = {}
    for n in names:
        check(bool(torch.isfinite(k_grads[n]).all()), f"GPT: non-finite gradient of {n}")
        rels[n] = _rel_l2(k_grads[n], p_grads[n])
        check(rels[n] <= grad_tol, f"GPT first-step gradient of {n}: relative L2 {rels[n]} "
              f"> {grad_tol}")
    return {"loss": k_loss, "plain_loss": p_loss, "loss_rel_diff": loss_rel,
            "grad_rel_l2": rels, "tolerance": {"loss": loss_tol, "grad": grad_tol}}


def _gpt_per_step(layers, sm90):
    """One GPT step's launches: the flash forward and backward once a layer,
    on the sm90 route (bf16 at H 64) or the general one (f32); nothing else."""
    from paddle_tpu_torch import ops

    per = dict.fromkeys(ops.launch_counts(), 0)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        per[name] = layers
        per[f"{name}_sm90"] = layers if sm90 else 0
    return per


def _gpt_state(step):
    """Copies of every tensor the step reads and writes (TrainStep._state:
    parameters, optimizer state, the rate, the RNG state), the step count
    and the scheduler's state."""
    opt = step.optimizer
    return ([t.detach().clone() for t in step._state()], opt._step_count,
            copy.deepcopy(opt._lr_scheduler.state_dict()))


@torch.no_grad()
def _set_gpt_state(step, state):
    tensors, count, sched = state
    for t, v in zip(step._state(), tensors, strict=True):
        t.copy_(v)
    step.optimizer._step_count = count
    step.optimizer._lr_scheduler.set_state_dict(copy.deepcopy(sched))


def _gpt_steps(step, run, ids, labels, n, per_step, what, rates=None):
    """``_train_steps`` with the scheduler stepped on the host after each
    step (``rates`` collects the rate each step read)."""
    sched = step.optimizer._lr_scheduler

    def one(a, b):
        if rates is not None:
            rates.append(sched.get_lr())
        loss = run(a, b)
        sched.step()
        return loss

    return _train_steps(step, one, ids, labels, n, per_step, what)


def _gpt_differing(a, b):
    differing, err = _state_differing((a[0], a[1]), (b[0], b[1]))
    return differing + (a[2] != b[2]), err


def _mask_marks(model):
    """A forward hook on the embedding dropout that keeps each eager
    forward's mask (where its output is 0) as a bool tensor."""
    marks = []
    handle = model.gpt.drop.register_forward_hook(lambda m, a, out: marks.append(out.eq(0)))
    return marks, handle


def dropout_cost(timer, dtype):
    """One dropout at GPT-2's [8, 1024, 768]: the forward (the mask drawn
    and applied) and its backward (the kept gradient divided), device ms
    under chip_smoke's timer."""
    from paddle_tpu_torch.nn import functional as tF

    g = torch.Generator(device=DEVICE).manual_seed(40)
    x = torch.randn(GPT_BATCH, GPT_SEQ, 768, generator=g, device=DEVICE).to(dtype)
    keep = tF.dropout(x, 0.1) != 0
    grad, scale = torch.randn_like(x), torch.full((), 0.9, dtype=dtype, device=DEVICE)
    zero = torch.zeros((), dtype=dtype, device=DEVICE)
    return {"dtype": str(dtype).replace("torch.", ""),
            "forward_ms": timer(lambda: tF.dropout(x, 0.1)),
            "backward_ms": timer(lambda: torch.where(keep, grad / scale, zero))}


def check_mask_devices():
    """(d) A mask drawn on the card equals the CPU's from the same state."""
    from paddle_tpu_torch._core import random as trandom
    from paddle_tpu_torch.nn import functional as tF

    x = torch.ones(GPT_BATCH, GPT_SEQ, 768)
    masks = {}
    for dev in ("cpu", DEVICE):
        state = trandom.state_tensor(dev)
        saved = state.clone()
        state.copy_(torch.tensor([1234, 56789]))
        masks[dev] = tF.dropout(x.to(dev), 0.1).eq(0).cpu()
        state.copy_(saved)
    differing = int((masks["cpu"] != masks[DEVICE]).sum())
    check(differing == 0, f"dropout masks differ between the CPU and the card: {differing}")
    return {"elements": masks["cpu"].numel(), "dropped": int(masks["cpu"].sum()),
            "differing": differing}


def _gpt_run(model, step, ids, labels, per_step, tag):
    """(b)/(c): GPT_WARM eager steps, ``warmup()`` (every state tensor as
    it was, the RNG counter included), GPT_TIMED graphed steps, then
    GPT_TIMED eager steps from a copy of that state: losses, every state
    tensor and the scheduler bit for bit; the eager steps' masks differ
    from step to step."""
    from paddle_tpu_torch._core import random as trandom

    warm, _, _ = _gpt_steps(step, step._eager_step, ids, labels, GPT_WARM, per_step,
                            f"gpt {tag} eager warm-up")
    saved = _gpt_state(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(step.warmup(ids, labels) is step, "TrainStep.warmup did not return the step")
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    moved, _ = _gpt_differing(_gpt_state(step), saved)
    check(moved == 0 and all(p.grad is None for p in model.parameters()),
          f"gpt {tag}: warmup() changed {moved} state elements or left a grad")
    counter0 = int(trandom.state_tensor(DEVICE)[1])
    rates = []
    g_losses, graphed_ms, totals = _gpt_steps(step, step, ids, labels, GPT_TIMED, per_step,
                                              f"gpt {tag} graphed", rates)
    dropouts = (int(trandom.state_tensor(DEVICE)[1]) - counter0) / GPT_TIMED
    graphed_state = _gpt_state(step)
    _set_gpt_state(step, saved)
    marks, hook = _mask_marks(model)
    try:
        e_losses, eager_ms, e_totals = _gpt_steps(step, step._eager_step, ids, labels,
                                                  GPT_TIMED, per_step, f"gpt {tag} eager")
    finally:
        hook.remove()
    differing, max_err = _gpt_differing(graphed_state, _gpt_state(step))
    check(g_losses == e_losses and differing == 0,
          f"gpt {tag}: graphed steps differ from eager steps from the same state: losses "
          f"{g_losses} vs {e_losses}, {differing} state elements (max abs {max_err})")
    same_masks = sum(bool(torch.equal(a, b)) for a, b in zip(marks, marks[1:]))
    check(len(marks) == GPT_TIMED and same_masks == 0,
          f"gpt {tag}: {same_masks} steps drew their predecessor's embedding mask")
    layers = model.config.num_hidden_layers
    check(dropouts == 1 + 2 * layers, f"gpt {tag}: {dropouts} dropouts a step")
    losses = warm + g_losses
    check(all(math.isfinite(x) for x in losses), f"gpt {tag}: non-finite loss {losses}")
    check(len(set(rates)) == len(rates), f"gpt {tag}: the rate did not change each step")
    captured = step._steps[((tuple(ids.shape), ids.dtype), (tuple(labels.shape), labels.dtype))]
    return ({"losses": losses, "eager_losses": e_losses, "graphed_equal_eager": True,
             "rates_read": rates, "dropouts_per_step": dropouts,
             "embedding_masks_distinct": len(marks), "step_ms": graphed_ms,
             "eager_step_ms": eager_ms, "warmup_s": warmup_s,
             "capture_s": captured.step.capture_s, "graph_bytes": captured.step.graph_bytes},
            totals, e_totals)


def train_gpt(card):
    """Phase 4d: GPT-2 small (module docstring).  Returns the launches of
    each run and the model, for phase 4e."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    cfg = gpt_config()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device=DEVICE,
                           generator=torch.Generator(device=DEVICE).manual_seed(21))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 124_475_904 and all(p.dtype == torch.float32 for p in model.parameters()),
          f"GPT-2 small: {n_params} parameters")
    g = torch.Generator(device=DEVICE).manual_seed(22)
    ids = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ), generator=g, device=DEVICE)
    labels = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ), generator=g, device=DEVICE)
    layers, tokens = cfg.num_hidden_layers, GPT_BATCH * GPT_SEQ
    flops = (6 * n_params + 12 * layers * cfg.hidden_size * GPT_SEQ) * tokens
    timer = Timer()
    cost = {"f32": dropout_cost(timer, torch.float32),
            "bf16": dropout_cost(timer, torch.bfloat16)}
    del timer
    masks = check_mask_devices()
    first = {"f32": check_gpt_first_step(model, ids, labels, GPT_F32_LOSS_TOL, GPT_F32_GRAD_TOL)}
    with amp.auto_cast(dtype="bfloat16"):
        first["o1_bf16"] = check_gpt_first_step(model, ids, labels, LOSS_REL_TOL, GRAD_REL_TOL)
    paths, runs = {}, {}
    for tag, loss_fn, sm90, peak, drop in (("f32", _loss_fn, False, F32_FLOPS, cost["f32"]),
                                           ("o1", _amp_loss_fn("bfloat16"), True, BF16_TC_FLOPS,
                                            cost["bf16"])):
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=40), 10, 0.0, 3e-4)
        step = TrainStep(model, AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                                      grad_clip=ClipGradByGlobalNorm(1.0)), loss_fn)
        per_step = _gpt_per_step(layers, sm90)
        run, totals, e_totals = _gpt_run(model, step, ids, labels, per_step, tag)
        # the 25 dropouts' isolated forward and backward against the step
        # (the embeddings' is f32 under O1 too; counted in the dtype of the rest)
        drop_ms = run["dropouts_per_step"] * (drop["forward_ms"] + drop["backward_ms"])
        run.update({"launches_per_step": per_step,
                    "tokens_per_s": tokens / (run["step_ms"] / 1e3),
                    "eager_tokens_per_s": tokens / (run["eager_step_ms"] / 1e3),
                    "model_flop_share": flops / (run["step_ms"] / 1e3) / peak,
                    "eager_model_flop_share": flops / (run["eager_step_ms"] / 1e3) / peak,
                    "peak_flops": peak, "dropout_ms_per_step": drop_ms,
                    "dropout_share_of_step": drop_ms / run["step_ms"]})
        runs[tag] = run
        paths[f"gpt_{tag}"], paths[f"gpt_{tag}_eager"] = totals, e_totals
        del step
        gc.collect()
        torch.cuda.empty_cache()
    emit({"trainer": f"GPT-2 small ({n_params} parameters, f32, dropout {cfg.dropout}), "
                     f"AdamW, LinearWarmup into CosineAnnealingDecay, ClipGradByGlobalNorm(1.0), "
                     f"batch {GPT_BATCH} x {GPT_SEQ}", "card": card, "first_step": first,
          "mask_card_vs_cpu": masks, "dropout_cost": cost, "model_flops_per_step": flops,
          **runs, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return paths, model, ids, labels


def _opt_tier():
    """Phase 4e's optimizers: (name, base rate, make(named params, rate
    scheduler)), some with a regularizer or a clip form."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay

    def no_decay(name):
        return ".ln_" in name or name.endswith(".bias")

    return [
        ("Momentum", 1e-3, lambda ps, s: O.Momentum(s, 0.9, ps, weight_decay=L2Decay(1e-4),
                                                    grad_clip=ClipGradByGlobalNorm(1.0))),
        ("Adagrad", 1e-3, lambda ps, s: O.Adagrad(s, parameters=ps,
                                                  weight_decay=L1Decay(1e-6))),
        ("Adadelta", 1.0, lambda ps, s: O.Adadelta(s, parameters=ps,
                                                   grad_clip=ClipGradByValue(0.1))),
        ("RMSProp", 1e-4, lambda ps, s: O.RMSProp(s, parameters=ps, momentum=0.9, centered=True,
                                                  grad_clip=ClipGradByNorm(1.0))),
        ("Lamb", 1e-3, lambda ps, s: O.Lamb(s, parameters=ps,
                                            exclude_from_weight_decay_fn=no_decay)),
        ("Adamax", 1e-3, lambda ps, s: O.Adamax(s, parameters=ps)),
        ("NAdam", 1e-4, lambda ps, s: O.NAdam(s, parameters=ps)),
        ("RAdam", 1e-4, lambda ps, s: O.RAdam(s, parameters=ps)),
        ("ASGD", 1e-3, lambda ps, s: O.ASGD(s, parameters=ps)),
        ("Rprop", 1e-4, lambda ps, s: O.Rprop(s, parameters=ps)),
    ]


def train_optimizers(card, model, ids, labels):
    """Phase 4e: each of the ten optimizers on phase 4d's model under O1
    bf16, its rate from OneCycleLR (a new rate every step): OPT_TIER_STEPS
    eager steps, ``warmup()``, graphed steps, then eager steps from a copy
    of the state, bit for bit.  The LayerNorms' parameters take
    ``ParamAttr``'s effects (need_clip False, a zero L2Decay of their own).
    Returns the launches of the graphed and of the eager steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer.lr import OneCycleLR
    from paddle_tpu_torch.regularizer import L2Decay

    for name, p in model.named_parameters():
        if ".ln_" in name:
            p.need_clip, p.regularizer = False, L2Decay(0.0)
    warm_n, timed_n = OPT_TIER_STEPS
    per_step = _gpt_per_step(model.config.num_hidden_layers, True)
    totals = dict.fromkeys(per_step, 0)
    e_totals = dict.fromkeys(per_step, 0)
    results = {}
    for name, base, make in _opt_tier():
        sched = OneCycleLR(base, total_steps=warm_n + timed_n, end_learning_rate=base / 100)
        step = TrainStep(model, make(list(model.named_parameters()), sched),
                         _amp_loss_fn("bfloat16"))
        warm, _, _ = _gpt_steps(step, step._eager_step, ids, labels, warm_n, per_step,
                                f"{name} eager warm-up")
        saved = _gpt_state(step)
        step.warmup(ids, labels)
        moved, _ = _gpt_differing(_gpt_state(step), saved)
        check(moved == 0, f"{name}: warmup() changed {moved} state elements")
        rates = []
        g_losses, g_ms, g_counts = _gpt_steps(step, step, ids, labels, timed_n, per_step,
                                              f"{name} graphed", rates)
        graphed_state = _gpt_state(step)
        _set_gpt_state(step, saved)
        e_losses, e_ms, e_counts = _gpt_steps(step, step._eager_step, ids, labels, timed_n,
                                              per_step, f"{name} eager")
        differing, max_err = _gpt_differing(graphed_state, _gpt_state(step))
        check(g_losses == e_losses and differing == 0,
              f"{name}: graphed steps differ from eager steps from the same state: losses "
              f"{g_losses} vs {e_losses}, {differing} state elements (max abs {max_err})")
        check(all(math.isfinite(x) for x in warm + g_losses), f"{name}: loss {warm + g_losses}")
        check(len(set(rates)) == timed_n, f"{name}: replays read the rates {rates}")
        results[name] = {"losses": warm + g_losses, "rates_read_by_replays": rates,
                         "state_tensors": len(saved[0]), "step_ms": g_ms,
                         "eager_step_ms": e_ms}
        totals = {k: totals[k] + g_counts[k] for k in totals}
        e_totals = {k: e_totals[k] + e_counts[k] for k in e_totals}
        del step, saved, graphed_state
        gc.collect()
        torch.cuda.empty_cache()
    emit({"optimizer_tier": "phase 4d's GPT-2 small under O1 bf16, OneCycleLR",
          "card": card, "steps": {"eager": warm_n, "graphed_then_eager": timed_n},
          "graphed_equal_eager": True, **results,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"gpt_optimizers": totals, "gpt_optimizers_eager": e_totals}


RESNET_BATCH = 256             # phase 4f: one of benchmarks/bench_resnet.py's batch sizes
RESNET_CHECK_BATCH = 8         # phase 4f (a): the f32 first step held against the CPU
RESNET_WARM, RESNET_TIMED = 3, 10  # phase 4f (b): eager steps, then graphed and eager steps
RESNET_PARAMS = 25_557_032     # resnet50(): the torchvision / Paddle ResNet-50 count
RESNET_LOSS_TOL = 1e-5         # (a) relative: an f32 mean over 8 rows of 1,000 logits
RESNET_STAT_TOL = 1e-4         # (a) relative L2 of each new running statistic (f32 sums over
                               # up to 8 x 112 x 112 values a channel, in other orders)
RESNET_GRAD_TOL = 5e-2         # (a) relative L2 of each gradient: ResNet-50's f32 gradients
                               # at batch 8 move by up to a few % when the input moves by
                               # one rounding (ReLU kinks flip; the spread is printed beside)


def _resnet_loss_fn(o1):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import CrossEntropyLoss

    ce = CrossEntropyLoss()

    def loss_fn(model, images, labels):
        with amp.auto_cast(enable=o1, dtype="bfloat16"):
            return ce(model(images), labels)

    return loss_fn


def resnet_flops(model, images):
    """The forward's FLOPs from the convolutions' and the head's shapes
    (2 x multiply-adds), counted by forward hooks on one image in eval
    mode (nothing of the running statistics moves), times the batch."""
    from paddle_tpu_torch.nn import Conv2D, Linear

    total = [0]

    def conv(mod, args, out):
        total[0] += 2 * out.numel() * math.prod(mod.weight.shape[1:])

    def fc(mod, args, out):
        total[0] += 2 * out.numel() * mod.weight.shape[0]

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D) else fc)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    model.eval()
    try:
        with torch.no_grad():
            model(images[:1])
    finally:
        model.train()
        for h in hooks:
            h.remove()
    return total[0] * images.shape[0]


def _resnet_grads_stats(model, images, labels):
    """One f32 forward and backward in training mode: the loss, every
    gradient and the new running statistics (the model's grads and
    statistics are put back as they were)."""
    saved = {k: v.clone() for k, v in model.state_dict().items() if "._" in k}
    model.zero_grad(set_to_none=True)
    loss = _resnet_loss_fn(False)(model, images, labels)
    loss.backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    stats = {k: v.detach().double().cpu() for k, v in model.state_dict().items() if "._" in k}
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in saved:
                v.copy_(saved[k])
    return float(loss.detach()), grads, stats


def _worst_rel(a, b):
    return max(float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in b)


def check_resnet_first_step(model, images, labels):
    """(a): the f32 first step's loss, gradients and new running statistics
    on the card against the port's CPU run of the same step from the same
    weights, at RESNET_CHECK_BATCH images; beside them the card's own
    spread when every image moves by one f32 rounding (x (1 + 2^-23))."""
    from paddle_tpu_torch.vision.models import resnet50

    x, y = images[:RESNET_CHECK_BATCH].clone(), labels[:RESNET_CHECK_BATCH].clone()
    card = _resnet_grads_stats(model, x, y)
    nudged = _resnet_grads_stats(model, x * (1 + 2.0 ** -23), y)
    cpu_model = resnet50(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    cpu = _resnet_grads_stats(cpu_model, x.cpu(), y.cpu())
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    grad_rel, stat_rel = _worst_rel(card[1], cpu[1]), _worst_rel(card[2], cpu[2])
    check(loss_rel <= RESNET_LOSS_TOL, f"resnet50 f32 first loss {card[0]} vs CPU {cpu[0]}")
    check(all(bool(torch.isfinite(g).all()) for g in card[1].values()),
          "resnet50: a non-finite gradient on the card")
    check(grad_rel <= RESNET_GRAD_TOL, f"resnet50 f32 gradients: worst relative L2 {grad_rel} "
          f"from the CPU's > {RESNET_GRAD_TOL}")
    check(stat_rel <= RESNET_STAT_TOL, f"resnet50 running statistics: worst relative L2 "
          f"{stat_rel} from the CPU's > {RESNET_STAT_TOL}")
    return {"batch": RESNET_CHECK_BATCH, "loss": card[0], "cpu_loss": cpu[0],
            "loss_rel_diff": loss_rel, "grad_worst_rel_l2": grad_rel,
            "grad_median_rel_l2": statistics.median(
                float((card[1][k] - cpu[1][k]).norm() / cpu[1][k].norm()) for k in cpu[1]),
            "stat_worst_rel_l2": stat_rel,
            "one_rounding_spread": {"grad_worst_rel_l2": _worst_rel(nudged[1], card[1]),
                                    "stat_worst_rel_l2": _worst_rel(nudged[2], card[2])},
            "cpu_s": cpu_s,
            "tolerances": {"loss": RESNET_LOSS_TOL, "grad": RESNET_GRAD_TOL,
                           "stat": RESNET_STAT_TOL}}


def _resnet_state(step):
    """Copies of every tensor the step reads and writes (TrainStep._state:
    parameters, the running statistics, velocities, the rate, the RNG
    state) and the step count."""
    return [t.detach().clone() for t in step._state()], step.optimizer._step_count


@torch.no_grad()
def _set_resnet_state(step, state):
    tensors, count = state
    for t, v in zip(step._state(), tensors, strict=True):
        t.copy_(v)
    step.optimizer._step_count = count


def _busy_share(run, n=2):
    """``n`` calls of ``run`` under torch.profiler: the card's busy time
    (kernels, copies, memsets; overlaps once) over the profiled wall."""
    import profile_torch_serving as prof_tools
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof_tools.device_events(prof)
    busy_ms = prof_tools.busy_us(events) / 1e3 / n
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms, "device_events": len(events) / n}


def train_resnet(card):
    """Phase 4f: ResNet-50 (module docstring).  Returns the launches of the
    graphed and of the eager steps (every kernel's 0)."""
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    torch.cuda.reset_peak_memory_stats()
    model = resnet50(device=DEVICE, generator=torch.Generator(device=DEVICE).manual_seed(31))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == RESNET_PARAMS, f"resnet50: {n_params} parameters")
    g = torch.Generator(device=DEVICE).manual_seed(32)
    images = torch.randn(RESNET_BATCH, 3, 224, 224, generator=g, device=DEVICE)
    labels = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device=DEVICE,
                           dtype=torch.int32)
    flops = 3 * resnet_flops(model, images)  # forward, and the backward's two products
    first = check_resnet_first_step(model, images, labels)
    per_step = dict.fromkeys(ops.launch_counts(), 0)  # no kernel of the port's on this path
    step = TrainStep(model, Momentum(0.1, parameters=model.parameters()), _resnet_loss_fn(True))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # (b) compares bit for bit
    try:
        warm, warm_ms, _ = _train_steps(step, step._eager_step, images, labels, RESNET_WARM,
                                        per_step, "resnet50 eager warm-up")
        saved = _resnet_state(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.warmup(images, labels)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        moved, _ = _state_differing(_resnet_state(step), saved)
        check(moved == 0 and all(p.grad is None for p in model.parameters()),
              f"resnet50: warmup() changed {moved} state elements or left a grad")
        g_losses, graphed_ms, totals = _train_steps(step, step, images, labels, RESNET_TIMED,
                                                    per_step, "resnet50 graphed")
        graphed_state = _resnet_state(step)
        busy = _busy_share(lambda: step(images, labels))
        captured = step._steps[((tuple(images.shape), images.dtype),
                                (tuple(labels.shape), labels.dtype))]
        capture = {"capture_s": captured.step.capture_s,
                   "graph_bytes": captured.step.graph_bytes}
        peak_graphed = torch.cuda.max_memory_allocated() / 1e9
        step._steps.clear()  # the graph's pool back before the eager steps
        del captured
        gc.collect()
        torch.cuda.empty_cache()
        _set_resnet_state(step, saved)
        e_losses, eager_ms, e_totals = _train_steps(step, step._eager_step, images, labels,
                                                    RESNET_TIMED, per_step, "resnet50 eager")
        differing, max_err = _state_differing(graphed_state, _resnet_state(step))
        check(g_losses == e_losses and differing == 0,
              f"resnet50: graphed steps differ from eager steps from the same state: losses "
              f"{g_losses} vs {e_losses}, {differing} state elements (max abs {max_err})")
        eager_busy = _busy_share(lambda: step._eager_step(images, labels))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # the default (non-deterministic) cuDNN algorithms: their eager ms, and
    # whether two eager steps from one state agree bit for bit
    _set_resnet_state(step, graphed_state)
    default_losses, default_ms, _ = _train_steps(step, step._eager_step, images, labels, 2,
                                                 per_step, "resnet50 eager, cuDNN default")
    first_default = _resnet_state(step)
    _set_resnet_state(step, graphed_state)
    again, _, _ = _train_steps(step, step._eager_step, images, labels, 2, per_step,
                               "resnet50 eager, cuDNN default, again")
    default_differing, _ = _state_differing(first_default, _resnet_state(step))
    losses = warm + g_losses
    check(all(math.isfinite(x) for x in losses), f"resnet50: non-finite loss {losses}")
    # (c) the eval forward reads the running statistics and leaves them
    stats = {k: v.clone() for k, v in model.state_dict().items() if "._" in k}
    moved_stats = sum(int((v != 0).any()) for k, v in stats.items() if k.endswith("._mean"))
    model.eval()
    with torch.no_grad(), amp.auto_cast(dtype="bfloat16"):
        logits = model(images)
    model.train()
    check(tuple(logits.shape) == (RESNET_BATCH, 1000) and bool(torch.isfinite(logits).all()),
          f"resnet50 eval logits: shape {tuple(logits.shape)} or not finite")
    check(all(torch.equal(v, model.state_dict()[k]) for k, v in stats.items()),
          "resnet50: the eval forward moved a running statistic")
    check(moved_stats == 53, f"resnet50: {moved_stats} of 53 BatchNorms' means moved")
    emit({"trainer": f"ResNet-50 ({n_params} parameters, f32 weights), Momentum(0.1), "
                     f"CrossEntropyLoss, auto_cast O1 bf16, batch {RESNET_BATCH} x 3 x 224 x 224",
          "card": card, "first_step_f32_vs_cpu": first, "model_flops_per_step": flops,
          "losses": losses, "eager_losses": e_losses, "graphed_equal_eager": True,
          "cudnn_deterministic_for_the_comparison": True,
          "step_ms": graphed_ms, "eager_step_ms": eager_ms, "warm_eager_step_ms": warm_ms,
          "images_per_s": RESNET_BATCH / (graphed_ms / 1e3),
          "eager_images_per_s": RESNET_BATCH / (eager_ms / 1e3),
          "model_flop_share": flops / (graphed_ms / 1e3) / BF16_TC_FLOPS,
          "eager_model_flop_share": flops / (eager_ms / 1e3) / BF16_TC_FLOPS,
          "graphed_profile": busy, "eager_profile": eager_busy,
          "cudnn_default": {"eager_step_ms": default_ms, "losses": default_losses + again,
                            "state_elements_differing_between_two_runs": default_differing},
          "warmup_s": warmup_s, **capture, "eval_logits_abs_max": float(logits.abs().max()),
          "peak_memory_gb_graphed": peak_graphed,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del step, model, images, labels, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"resnet50_o1": totals, "resnet50_o1_eager": e_totals}


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


def check_replay_equals_eager(what, exe, program, ids, logits, got, per_run, held):
    """The replayed run's logits bit for bit the eager run's of the same
    batch (the pruned op list run op by op), whose launches are the
    replay's; ``held`` keeps each replay's fetch beside a copy."""
    from paddle_tpu_torch import ops

    ops.reset_launch_counts()
    (eager,) = exe._run_eager(program, feed={"ids": ids}, fetch_list=[logits])
    counts = ops.launch_counts()
    check(counts == per_run, f"{what}: eager launches {counts} != {per_run}")
    check(torch.equal(got, eager), f"{what}: the replay differs from the eager run: "
                                   f"{max_err(got, eager)}")
    held.append((got, got.clone()))


def check_fetches_held(held, what):
    """No later run wrote into a fetch a caller holds."""
    check(all(torch.equal(a, b) for a, b in held), f"{what}: a later run overwrote a fetch")


def captured_of(exe, program):
    """Seconds and graph memory of the Executor's captured run of
    ``program`` (one feed signature and fetch set in these phases)."""
    (entry,) = [e for key, e in exe._cache.items() if key[0] is program]
    return {"capture_s": entry.step.capture_s, "graph_bytes": entry.step.graph_bytes}


def eager_batch_ms(exe, program, logits, batches, warmup, timed):
    """ms a batch of the eager run (op by op), timed as the replays are."""
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        exe._run_eager(program, feed={"ids": batches[i % len(batches)]}, fetch_list=[logits])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / timed


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
    errs, held = [], []
    with torch.no_grad():
        for b, want_unfused in zip(batches, unfused):
            ops.reset_launch_counts()
            (got,) = exe.run(main, feed={"ids": b}, fetch_list=[logits], return_numpy=False)
            counts = ops.launch_counts()
            check(counts == per_run, f"static BERT: launches {counts} != {per_run}")
            check_replay_equals_eager("static BERT", exe, main, b, logits, got, per_run, held)
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
    check_fetches_held(held, "static BERT")
    eager_ms = eager_batch_ms(exe, main, logits, batches, warmup, timed)
    real = sum(int((batches[i % len(batches)] != 0).sum()) for i in range(warmup,
                                                                        warmup + timed))
    emit({"static_bert": f"bert-base bf16 {layers} layers, batch {BERT_BATCH} x {BERT_SEQ}, "
                         "ragged padding, static.Program + Executor (PallasFusionPass)",
          "card": card, "parameters": n_params, "op_counts_after_pass": dict(types),
          "launches_per_run": {k: v for k, v in per_run.items() if v},
          "logits_rel_l2": errs, "tolerance": BERT_LOGITS_REL_TOL,
          "f32_ratio_limit": BERT_F32_RATIO,
          "warmup_runs": warmup, "timed_runs": timed, "ms_per_batch": batch_ms,
          "eager_ms_per_batch": eager_ms, "replay_bit_for_bit_eager": True,
          **captured_of(exe, main), "sequences_per_s": BERT_BATCH / (batch_ms / 1e3),
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
        errs, held = [], []
        with torch.no_grad():
            for b in batches:
                ops.reset_launch_counts()
                (got,) = exe.run(main, feed={"ids": b}, fetch_list=[logits], return_numpy=False)
                counts = ops.launch_counts()
                check(counts == per_run, f"static codegen BERT: launches {counts} != {per_run}")
                check_replay_equals_eager("static codegen BERT", exe, main, b, logits, got,
                                          per_run, held)
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
        check_fetches_held(held, "static codegen BERT")
        eager_ms = eager_batch_ms(exe, main, logits, batches, warmup, timed)
        emit({"static_codegen_bert": f"bert-base bf16 {layers} layers, batch {BERT_BATCH} x "
                                     f"{BERT_SEQ}, pallas_fusion + generic_elementwise_fusion + "
                                     "FLAGS_schedule_search", "card": card,
              "op_counts_after_passes": {k: v for k, v in types.items()
                                         if k.startswith(("vpu_", "sched_", "add_layer", "matmul_ep",
                                                          "tanh"))},
              "pooler_decision": {"key": pooler_key, **pooler_verdict, "adopted": adopted,
                                  "win": pooler_verdict["meta"].get("win")},
              "first_run_with_search_s": search_s, "launches_per_run":
                  {k: v for k, v in per_run.items() if v}, "logits_rel_l2": errs,
              "ms_per_batch": batch_ms, "eager_ms_per_batch": eager_ms,
              "replay_bit_for_bit_eager": True, **captured_of(exe, main),
              "sequences_per_s": BERT_BATCH / (batch_ms / 1e3),
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
                  "win": entry["meta"].get("win"), "gate": ss.ScheduleSearcher().min_win,
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
    sys.path.append(str(ROOT / "tools"))  # time_torch_vpu_variants: #11's floor and copy
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
    gen, floor_libs = {}, {}
    gen_build = threading.Thread(
        target=lambda: gen.update(_cuda_build.build_generated(list(sources.values()))))

    def build_floors():
        try:
            floor_libs.update(vpu_floor_libraries(vpu))
        except Exception as exc:  # raised again after the join
            floor_libs["error"] = exc

    floor_build = threading.Thread(target=build_floors)
    gen_build.start()  # the generated sources build beside csrc/'s, one nvcc each
    floor_build.start()
    try:
        logs = _cuda_build.build(["flash_attention_fwd", "flash_attention_fwd_sm90",
                                  "flash_attention_bwd", "flash_attention_bwd_sm90",
                                  "decode_chain", "decode_chain_sm90", "prefill_chain_sm90",
                                  "matmul_epilogue", "matmul_epilogue_sm90", "norm_swiglu"])
    finally:
        gen_build.join()
        floor_build.join()
    check(len(gen) == len(set(sources.values())), "a generated source failed to build")
    if "error" in floor_libs:
        raise floor_libs["error"]
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
        vc = check_vpu_chains(timer, vpu, gen, floor_libs)
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
    train_paths, bf16_step_ms = train(card)
    paths.update(train_paths)
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(train_amp(card, bf16_step_ms))
    gc.collect()
    torch.cuda.empty_cache()
    gpt_paths, gpt_model, gpt_ids, gpt_labels = train_gpt(card)
    paths.update(gpt_paths)
    paths.update(train_optimizers(card, gpt_model, gpt_ids, gpt_labels))
    del gpt_model, gpt_ids, gpt_labels
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(train_resnet(card))
    paths["static_bert"], bert = static_bert(card)
    paths["static_codegen"] = static_codegen(card, *bert)
    del bert
    llama_kernels = ("fused_rms_norm", "swiglu", "flash_attention_fwd", "flash_attention_fwd_sm90")
    codegen_kernels = ("vpu_chain", "sched_chain", "sched_chain_ktiled")
    for path, counts in paths.items():
        if path.startswith("resnet50"):
            # vision: convolutions (cuDNN), BatchNorm and pooling are plain torch
            check(not any(counts.values()), f"{path}: launches {counts}")
            continue
        if path.startswith("gpt_"):
            # GPT: the flash kernels alone (LayerNorm and GELU are plain),
            # f32 on the general route, O1 bf16 at H 64 on the sm90 route
            flash = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
            sm90 = 0 if path.startswith("gpt_f32") else 1
            check(all(counts[k] > 0 and counts[f"{k}_sm90"] == sm90 * counts[k] for k in flash)
                  and sum(counts.values()) == sum(counts[k] * (1 + sm90) for k in flash),
                  f"{path}: launches {counts}")
            continue
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
    for path in ("training", "training_amp_bf16", "training_amp_f16_scaler"):
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            # each training step's backward: launched, and every launch on the sm90 route
            check(paths[path][name] > 0 and paths[path][f"{name}_sm90"] == paths[path][name],
                  f"{path}: {name} launches {paths[path][name]}, of them "
                  f"{paths[path][f'{name}_sm90']} on the sm90 route")
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
