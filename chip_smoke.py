#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. Print the card's name and power limit (nvidia-smi) and build the
   kernels from the sources in this checkout: the CUDA C++ flash-attention
   forward with nvcc (one process per source, all started together), the
   two Triton kernels at their first launch.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving slice's shapes, in bf16, and time the kernel, the plain version
   and, where one exists, the one PyTorch call that computes the same
   function (a yardstick only: the port never calls it) with CUDA events,
   L2 flushed before every launch.  One JSON line per kernel and shape.
3. Serve 4 greedy requests (prompts of 17, 128, 250 and 640 tokens, 32 new
   tokens each) through GenerationEngine on LLaMA-7B at full width, bf16,
   all 32 layers, random weights from a seeded generator, after one
   warm-up pass over the same prompts.  Check the
   streams, that every kernel's launch counter grew by exactly what the
   run implies, and that the engine's first-token logits match a forward
   built only from the plain versions.  Print prefill and decode tokens/s.
4. Print the ``kernels`` JSON line, then the result line.

The script needs the card: without CUDA, or run from a directory that
holds nothing else of the repository, it exits with a non-zero code
before printing any result.  It imports nothing of JAX or paddle_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TOL = 2e-2                     # bf16: one rounding of the output (and of P in flash)
LOGITS_REL_TOL = 2e-2          # relative L2 of 32 bf16 layers, kernels vs plain versions
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


def check_rms_norm(timer, F):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.fused_norm import rms_norm_plain

    rows_list, hidden, out = (640, 1024, 4), 4096, []
    g = torch.Generator(device=DEVICE).manual_seed(1)
    for rows in rows_list:
        x = torch.randn(rows, hidden, generator=g, device=DEVICE).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(hidden, generator=g, device=DEVICE)).to(torch.bfloat16)
        got = ops.fused_rms_norm(x, w, epsilon=1e-6)
        want = rms_norm_plain(x, w, 1e-6)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL),
              f"fused_rms_norm [{rows}, {hidden}] disagrees with its plain version: {err}")
        nbytes = 2 * x.numel() * 2 + hidden * 2
        b_ms, b_by = bound_ms(nbytes, 4 * x.numel(), F32_FLOPS)
        out.append({"check": "fused_rms_norm", "shape": [rows, hidden], "max_abs_err": err,
                    "ms": timer(lambda: ops.fused_rms_norm(x, w, epsilon=1e-6)),
                    "plain_ms": timer(lambda: rms_norm_plain(x, w, 1e-6)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": timer(lambda: F.rms_norm(x, (hidden,), w, 1e-6))})
        emit(out[-1])
    return out


def check_swiglu(timer):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.swiglu import swiglu_plain

    out, cols = [], 11008
    g = torch.Generator(device=DEVICE).manual_seed(2)
    for rows in (640, 1024, 4):
        # the main path's layout: both halves of one gate_up projection
        gate_up = torch.randn(rows, 2 * cols, generator=g, device=DEVICE).to(torch.bfloat16)
        x, y = gate_up.chunk(2, dim=-1)
        got = ops.swiglu(gate_up)
        want = swiglu_plain(x, y)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL),
              f"swiglu [{rows}, {cols}] disagrees with its plain version: {err}")
        b_ms, b_by = bound_ms(3 * rows * cols * 2, 5 * rows * cols, F32_FLOPS)
        out.append({"check": "swiglu", "shape": [rows, cols], "max_abs_err": err,
                    "ms": timer(lambda: ops.swiglu(gate_up)),
                    "plain_ms": timer(lambda: swiglu_plain(x, y)),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        emit(out[-1])
    return out


def _allowed_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, i + off + 1)) for i in range(sq))


def check_flash(timer, F):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.flash_attention import _reference_with_lse

    cases = [  # (Sq, Sk, N, Nkv): the slice's prefill shapes (the longest
        (640, 640, 32, 32),   # prompt first), one ragged, one cross-length,
        (128, 128, 32, 32),   # one GQA
        (1000, 1000, 32, 32),
        (128, 640, 32, 32),
        (512, 512, 32, 8),
    ]
    out, h = [], 128
    g = torch.Generator(device=DEVICE).manual_seed(3)
    for sq, sk, n, nkv in cases:
        q = torch.randn(1, sq, n, h, generator=g, device=DEVICE).to(torch.bfloat16)
        k = torch.randn(1, sk, nkv, h, generator=g, device=DEVICE).to(torch.bfloat16)
        v = torch.randn(1, sk, nkv, h, generator=g, device=DEVICE).to(torch.bfloat16)
        got, lse = ops.flash_attention_fwd(q, k, v, causal=True)
        want, want_lse = _reference_with_lse(q, k, v, True, h ** -0.5)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.allclose(got.float(), want.float(), atol=TOL, rtol=TOL),
              f"flash_attention {(sq, sk, n, nkv)} disagrees with its plain version: {err}")
        lse_err = max_err(lse, want_lse)
        check(lse_err <= TOL, f"flash_attention {(sq, sk, n, nkv)}: lse off by {lse_err}")
        # the library yardstick: [B, N, S, H] views, explicit bottom-right
        # mask when Sq != Sk (torch's is_causal is top-left), K/V repeated
        # for GQA outside the timed call
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(n // nkv, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(n // nkv, dim=2).transpose(1, 2)
        if sq == sk:
            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        else:
            mask = torch.ones(sq, sk, dtype=torch.bool, device=DEVICE).tril(sk - sq)

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + n * sq * 4
        b_ms, b_by = bound_ms(nbytes, 4 * n * h * _allowed_pairs(sq, sk, True), BF16_TC_FLOPS)
        out.append({"check": "flash_attention_fwd", "shape": {"q": list(q.shape),
                    "kv": list(k.shape), "causal": True}, "max_abs_err": err,
                    "ms": timer(lambda: ops.flash_attention_fwd(q, k, v, causal=True)),
                    "plain_ms": timer(lambda: ops.flash_attention_reference(q, k, v, causal=True),
                                      iters=3, warmup=1),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": timer(lib)})
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


def build_engine():
    """The phase-3 configuration: the model with seeded random weights,
    the engine, the prompts and the new-token budget."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = model_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=DEVICE,
                             generator=torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, {cfg.dtype}, "
          f"{n_params} parameters, built in {time.perf_counter() - t0:.1f} s", flush=True)
    engine = GenerationEngine(model, max_batch=4, block_size=16, num_blocks=256, decode_chunk=8,
                              device=DEVICE)
    g = torch.Generator().manual_seed(5)
    prompts = {f"r{s}": torch.randint(0, cfg.vocab_size, (s,), generator=g).tolist()
               for s in (17, 128, 250, 640)}
    return model, engine, prompts, 32


def serve(card):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import _model_forward_cached

    model, engine, prompts, new = build_engine()
    cfg = model.config
    lengths = [len(p) for p in prompts.values()]
    # warm-up pass over the same prompts (cuBLAS picks its algorithms per
    # shape at first use); the measured run repeats it
    for rid, p in prompts.items():
        engine.add_request("warm-" + rid, p, max_new_tokens=2)
    while engine.has_work():
        engine.step()

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

    check(all(f is not None for f in firsts.values()), "a request was queued, not admitted")
    for rid in prompts:
        stream = engine.result(rid)
        check(len(stream) == new, f"{rid}: {len(stream)} tokens, expected {new}")
        check(all(0 <= t < cfg.vocab_size for t in stream), f"{rid}: token id out of range")
    n_layers, forwards = cfg.num_hidden_layers, len(lengths) + steps * engine._effective_chunk()
    want = {"flash_attention_fwd": n_layers * len(lengths),  # prefill only
            "fused_rms_norm": (2 * n_layers + 1) * forwards,  # prefill and every decode token
            "swiglu": n_layers * forwards}
    check(counts == want, f"launch counts {counts} != expected {want}")

    # first-token logits of the longest request: the engine's own prefill
    # path (kernels) against a forward of plain versions only
    rid = max(prompts, key=lambda r: len(prompts[r]))
    ids = torch.tensor([prompts[rid]], device=DEVICE)
    with torch.no_grad():
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        empty = [(torch.zeros(1, 0, cfg.num_key_value_heads, head_dim, dtype=cfg.torch_dtype,
                              device=DEVICE),) * 2 for _ in range(n_layers)]
        h, _ = _model_forward_cached(model.model, ids, empty)
        got = model._logits(h[:, -1:, :])[0, -1].float()
        want_logits = plain_forward(model, ids)[0, -1].float()
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    check(int(got.argmax()) == engine.result(rid)[0],
          "the engine's first token is not the argmax of its prefill logits")
    rel = float((got - want_logits).norm() / want_logits.norm())
    check(rel <= LOGITS_REL_TOL, f"first-token logits: relative L2 {rel} > {LOGITS_REL_TOL}")

    prefill_tokens, decode_tokens = sum(lengths), len(lengths) * (new - 1)
    result = {"engine": f"llama_7b {cfg.dtype} {n_layers} layers", "card": card,
              "requests": len(lengths), "prompt_lengths": list(lengths),
              "new_tokens_each": new, "decode_chunk": engine._effective_chunk(),
              "steps": steps, "launches": counts,
              "first_token_logits_rel_l2": rel,
              "first_token_logits_max_abs_err": float((got - want_logits).abs().max()),
              "prefill_s": t1 - t0, "prefill_tokens_per_s": prefill_tokens / (t1 - t0),
              "decode_s": t2 - t1, "decode_tokens_per_s": decode_tokens / (t2 - t1),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    return counts


def summarize(name, route, source, replaces, rows, launches):
    top = rows[0]
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "timed_shape": top["shape"], "tolerance": TOL, "per_shape": rows}


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
    logs = _cuda_build.build(["flash_attention_fwd"])
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log}", file=sys.stderr)
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    timer = Timer()
    with torch.no_grad():
        rms = check_rms_norm(timer, F)
        sw = check_swiglu(timer)
        fl = check_flash(timer, F)
        counts = serve(card)
    kernels = [
        summarize("fused_rms_norm", "triton", "paddle_tpu_torch/ops/fused_norm.py",
                  "paddle_tpu/ops/fused_norm.py:42", rms, counts["fused_rms_norm"]),
        summarize("swiglu", "triton", "paddle_tpu_torch/ops/swiglu.py",
                  "paddle_tpu/ops/swiglu.py:17", sw, counts["swiglu"]),
        summarize("flash_attention_fwd", "cuda", "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                  "paddle_tpu/ops/flash_attention.py:97", fl, counts["flash_attention_fwd"]),
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
