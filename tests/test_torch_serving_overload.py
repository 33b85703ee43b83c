"""The port's admission scheduler against the JAX package's, on the CPU:
interleaved chunked prefill (``prefill_chunk_blocks``), priority classes,
preemption with host-side parking (``FLAGS_preempt_low_priority``) and
``add_request(nonce=)``.

Port against JAX (greedy, f32 tiny LLaMA, the same weights and scripted
traffic): step outputs, streams and the admission counters equal, with
the margin rule of tests/test_torch_prefix_cache.py (each compared greedy
token wins its step by more than 1e-3 on the JAX model, or for int8
pools on the port's own logits).  Port against port, bit for bit
(tolerance 0): interleaved streams against atomic admission with
``prefill_chunk=block_size`` (every chunk is one block-aligned span
through the same cached forward, and the per-block pour writes the bytes
the batched pour writes), and preempted-then-resumed streams against
uninterrupted ones, greedy and sampled (pages park and return verbatim;
the sampler's key is (seed, nonce) and its counter the tokens generated).
"""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import decode_stats as jax_stats

from paddle_tpu_torch import set_flags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import GenerationEngine

from test_torch_prefix_cache import (OwnMargins, _one_thread, assert_margins,  # noqa: F401
                                     drive, models, play, prompt, run_both,
                                     stats_delta)

ADMISSION_KEYS = ("prefill_chunks", "preemptions", "preempt_readmits", "admitted_high",
                  "admitted_normal", "admitted_low", "completed_high", "completed_normal",
                  "completed_low", "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                  "dispatches", "macro_steps", "tokens")
REQS = [("a", prompt(11, 21)), ("b", prompt(12, 9)), ("c", prompt(14, 13))]


def _serve(tm, reqs, new=8, sampled=False, **kw):
    eng = GenerationEngine(tm, device="cpu", **kw)
    drive(eng, [("add", rid, p, new) for rid, p in reqs],
          **({"temperature": 0.8, "seed": 5} if sampled else {}))
    return eng, {rid: eng.result(rid) for rid, _ in reqs}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
def test_interleaved_prefill_equals_atomic_block_chunks(models, kv, prefix, sampled):
    """Interleaved prefill (one-block chunks between decode steps) serves
    streams bit for bit those of atomic admission in one-block chunks,
    across pool kinds, prefix-cache modes and greedy or sampled decoding,
    and it chunked (the 21-token prompt alone is 3 chunks)."""
    _, tm = models
    kw = dict(max_batch=2, block_size=8, num_blocks=32, decode_chunk=2, kv_cache_dtype=kv,
              prefix_cache=prefix, sampled=sampled)
    _, want = _serve(tm, REQS, prefill_chunk=8, **kw)
    c0 = tserving.decode_stats()["prefill_chunks"]
    eng, got = _serve(tm, REQS, prefill_chunk_blocks=1, **kw)
    assert got == want
    assert tserving.decode_stats()["prefill_chunks"] - c0 == 3 + 2 + 2
    assert eng.prefilling_requests() == [] and len(eng._free) + (
        sum(eng._prefix.holds(b) for b in range(32)) if prefix else 0) == 32


@pytest.mark.parametrize("kv,prefix", [("bf16", False), ("bf16", True), ("int8", True)])
def test_interleaved_engine_matches_jax(models, kv, prefix):
    """The interleaved engine against the JAX one: step outputs (which step
    each first token surfaces in), streams and the admission counters
    (chunks, admissions and completions by class, hits) equal; greedy."""
    jm, tm = models
    script = [("add", rid, p, 8) for rid, p in REQS] + [
        ("step",), ("add", "d", REQS[0][1][:16] + [7, 7], 5, {"priority": "high"})]
    with OwnMargins(tm) as own:
        _, teng = run_both(models, script, keys=ADMISSION_KEYS, max_batch=2, block_size=8,
                           num_blocks=32, decode_chunk=2, prefill_chunk_blocks=1,
                           kv_cache_dtype=kv, prefix_cache=prefix)
    if kv == "int8":
        own.check()
    else:
        for op in script:
            if op[0] == "add":
                assert_margins(jm, op[2], teng.result(op[1]))


def test_prefill_interleaves_with_resident_decode(models):
    """A long prompt admitted while a short stream decodes advances one
    block a step (the budget while a lane decodes) instead of stalling it,
    and serves the stream a lone engine serves; step outputs equal the
    JAX engine's."""
    jm, tm = models
    long_p = prompt(3, 30)
    script = [("add", "s", [5, 9, 17], 12), ("step",), ("add", "long", long_p, 4)]
    kw = dict(max_batch=2, block_size=8, num_blocks=32, decode_chunk=2, prefill_chunk_blocks=1)
    run_both(models, script, keys=ADMISSION_KEYS, **kw)
    eng = GenerationEngine(tm, device="cpu", **kw)
    eng.add_request("s", [5, 9, 17], max_new_tokens=12)
    eng.step()
    eng.add_request("long", long_p, max_new_tokens=4)
    eng.step()
    assert "long" in eng.prefilling_requests() and eng.result("long") is None
    assert len(eng.result("s")) >= 2
    drive(eng, [])
    alone, _ = _serve(tm, [("long", long_p)], new=4, max_batch=1, block_size=8, num_blocks=32,
                      decode_chunk=2)
    assert eng.result("long") == alone.result("long")
    assert_margins(jm, long_p, eng.result("long"))


def test_mid_prefill_prefix_hit_on_a_poured_boundary(models):
    """Blocks poured mid-prefill enter the prefix tree at once: a request
    sharing the long prompt's first two pages hits them while that prefill
    is still running; both streams equal a cold engine's and the JAX
    engine's, the hit counted alike."""
    jm, tm = models
    head = prompt(7, 16)
    long_p, short_p = head + prompt(17, 16), head + [3, 44]
    script = [("add", "s", [5, 9], 16), ("step",), ("add", "long", long_p, 6), ("step",),
              ("step",), ("add", "short", short_p, 6)]
    kw = dict(max_batch=3, block_size=8, num_blocks=32, decode_chunk=2, prefill_chunk_blocks=1,
              prefix_cache=True)
    t0 = tserving.decode_stats()
    _, teng = run_both(models, script, keys=ADMISSION_KEYS, **kw)
    assert stats_delta(tserving.decode_stats, t0, ("prefix_hits", "prefix_hit_tokens")) == {
        "prefix_hits": 1, "prefix_hit_tokens": 16}
    eng = GenerationEngine(tm, device="cpu", **kw)
    play(eng, script[:5])
    assert "long" in eng.prefilling_requests() and len(eng._prefix.match(head)) == 2
    for rid, p in (("long", long_p), ("short", short_p)):
        cold, _ = _serve(tm, [(rid, p)], new=6, max_batch=1, block_size=8, num_blocks=32,
                         decode_chunk=2)
        assert teng.result(rid) == cold.result(rid)
        assert_margins(jm, p, teng.result(rid))


def test_priority_admission_order_under_slot_exhaustion(models):
    """With the one lane busy, a HIGH request queued after a LOW one is
    admitted first ((class, submit order), not FIFO); the JAX engine
    admits in the same steps.  An unknown class raises ValueError."""
    _, tm = models
    script = [("add", "n", [5, 9, 17], 4), ("step",), ("add", "lo", [7, 11], 3, {"priority": "low"}),
              ("add", "hi", [3, 40], 3, {"priority": "high"})]
    set_flags({"FLAGS_preempt_low_priority": False})
    import paddle_tpu as paddle

    paddle.set_flags({"FLAGS_preempt_low_priority": False})
    try:
        run_both(models, script, keys=ADMISSION_KEYS, max_batch=1, block_size=8, num_blocks=32,
                 decode_chunk=2)
        eng = GenerationEngine(tm, max_batch=1, block_size=8, num_blocks=32, device="cpu",
                               decode_chunk=2)
        play(eng, script[:4])
        while eng.result("hi") is None:
            eng.step()
        assert eng.result("lo") is None
        drive(eng, [])
        assert len(eng.result("lo")) == 3
    finally:
        set_flags({"FLAGS_preempt_low_priority": True})
        paddle.set_flags({"FLAGS_preempt_low_priority": True})
    with pytest.raises(ValueError, match="priority"):
        eng.add_request("x", [1, 2, 3], priority="urgent")


def _preempt_script(sampled):
    s = {"temperature": 0.7, "seed": 3} if sampled else {}
    return [("add", "lo", [5, 9, 17, 33, 2], 10, dict(s, priority="low")), ("step",), ("step",),
            ("add", "hi", [7, 11, 3, 40], 4, {"priority": "high"})]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_preempted_greedy_stream_resumes_bit_for_bit(models, kv):
    """A LOW request parked mid-decode by a HIGH arrival resumes exactly:
    its stream equals the uninterrupted one (port against port), and the
    whole run, counters included, equals the JAX engine's; the parked
    pages come back verbatim (the lane's pages before parking equal its
    new pages after unparking, payload and int8 scales)."""
    jm, tm = models
    kw = dict(max_batch=1, block_size=8, num_blocks=32, decode_chunk=2, kv_cache_dtype=kv)
    script = _preempt_script(False)
    ref, _ = _serve(tm, [("lo", [5, 9, 17, 33, 2])], new=10, **kw)
    ref_lo = ref.result("lo")
    t0 = tserving.decode_stats()
    with OwnMargins(tm) as own:
        _, teng = run_both(models, script, keys=ADMISSION_KEYS, **kw)
    assert teng.result("lo") == ref_lo
    assert stats_delta(tserving.decode_stats, t0, ("preemptions", "preempt_readmits")) == {
        "preemptions": 1, "preempt_readmits": 1}
    assert tserving.decode_stats()["parked_requests"] == 0
    if kv == "int8":
        own.check()
    else:
        assert_margins(jm, [5, 9, 17, 33, 2], ref_lo)

    eng = GenerationEngine(tm, device="cpu", **kw)
    play(eng, script[:3])
    blocks = list(eng._slots[0].blocks)
    pages = [[t[blocks].clone() for _, t in pa.pool_parts(p)] for p in eng._kpools + eng._vpools]
    eng.add_request("hi", [7, 11, 3, 40], max_new_tokens=4, priority="high")
    eng.step()
    assert eng.parked_requests() == ["lo"]
    rec = eng._parked["lo"]
    assert all(t.device.type == "cpu" for d in rec["pages_k"] + rec["pages_v"] for t in d.values())
    while "lo" in eng.parked_requests():
        eng.step()
    lane = next(s for s in eng._slots if s.rid == "lo")
    # the unparked request's pages hold the parked bytes plus what it
    # decoded since: compare the positions it had stored when parked
    stored = rec["seq_len"]
    for was, pool in zip(pages, eng._kpools + eng._vpools):
        for w, (name, t) in zip(was, pa.pool_parts(pool)):
            now = t[lane.blocks]
            if name == "payload":
                flat_w, flat_n = (x.transpose(1, 2).reshape(len(blocks) * 8, -1)
                                  for x in (w, now))
                full = stored // 8 * 8  # whole pages: their scales cannot have moved
                assert torch.equal(flat_n[:full], flat_w[:full])
            else:
                assert torch.equal(now[:stored // 8], w[:stored // 8])
    drive(eng, [])
    assert eng.result("lo") == ref_lo


def test_preempted_sampled_stream_resumes_bit_for_bit(models):
    """Seeded sampling, the strictest mode: the preempted LOW stream equals
    the uninterrupted one (port against port: the generators differ from
    JAX's)."""
    _, tm = models
    kw = dict(max_batch=1, block_size=8, num_blocks=32, decode_chunk=2)
    ref = GenerationEngine(tm, device="cpu", **kw)
    drive(ref, [_preempt_script(True)[0]])
    eng = GenerationEngine(tm, device="cpu", **kw)
    t0 = tserving.decode_stats()
    drive(eng, _preempt_script(True))
    assert stats_delta(tserving.decode_stats, t0, ("preemptions", "preempt_readmits")) == {
        "preemptions": 1, "preempt_readmits": 1}
    assert eng.result("lo") == ref.result("lo") and len(ref.result("lo")) == 10


def test_preempt_flag_off_disables_parking(models):
    """FLAGS_preempt_low_priority=False: the HIGH arrival waits for the lane
    instead of parking the LOW resident, as in the JAX engine."""
    import paddle_tpu as paddle

    set_flags({"FLAGS_preempt_low_priority": False})
    paddle.set_flags({"FLAGS_preempt_low_priority": False})
    try:
        script = [("add", "lo", [5, 9, 17], 6, {"priority": "low"}), ("step",),
                  ("add", "hi", [7, 11, 3], 4, {"priority": "high"}), ("step",)]
        t0 = tserving.decode_stats()
        _, teng = run_both(models, script, keys=ADMISSION_KEYS, max_batch=1, block_size=8,
                           num_blocks=32, decode_chunk=2)
        assert tserving.decode_stats()["preemptions"] == t0["preemptions"]
        assert len(teng.result("hi")) == 4 and teng.parked_requests() == []
    finally:
        set_flags({"FLAGS_preempt_low_priority": True})
        paddle.set_flags({"FLAGS_preempt_low_priority": True})


def test_explicit_nonce_draws_the_counters_stream(models):
    """``nonce=`` is the sampler's nonce: a request submitted with the nonce
    the engine's counter would have given it draws the same stream, and
    the counter moves past an explicit nonce (the next request without
    one does not collide)."""
    _, tm = models
    kw = dict(max_batch=2, block_size=8, num_blocks=16, device="cpu", decode_chunk=4)
    s = dict(temperature=0.9, seed=4)
    a = GenerationEngine(tm, **kw)
    drive(a, [("add", "x", [5, 9, 17], 8, s), ("add", "y", [7, 1], 8, s)])
    b = GenerationEngine(tm, **kw)
    drive(b, [("add", "y", [7, 1], 8, dict(s, nonce=1)), ("add", "x", [5, 9, 17], 8,
                                                          dict(s, nonce=0))])
    assert b.result("x") == a.result("x") and b.result("y") == a.result("y")
    assert b._req_counter == 2
    b.add_request("z", [5, 9, 17], max_new_tokens=8, **s)  # takes nonce 2
    drive(b, [])
    assert b.result("z") != a.result("x")


def test_prefill_chunk_flag_switches_an_engine(models):
    """FLAGS_prefill_chunk_blocks is read at each use: setting it drops the
    captured steps and turns an existing engine interleaved, with the
    streams of atomic admission in one-block chunks."""
    _, tm = models
    kw = dict(max_batch=2, block_size=8, num_blocks=32, decode_chunk=2)
    _, want = _serve(tm, REQS[:2], prefill_chunk=8, **kw)
    eng = GenerationEngine(tm, device="cpu", prefill_chunk=8, **kw)
    drive(eng, [("add", "warm", [9, 5, 2], 2)])
    assert eng._step_fns
    set_flags({"FLAGS_prefill_chunk_blocks": 1})
    try:
        assert not eng._step_fns and eng._prefill_chunk_blocks() == 1
        c0 = tserving.decode_stats()["prefill_chunks"]
        assert eng.add_request("a", REQS[0][1], max_new_tokens=8) is None
        drive(eng, [("add", "b", REQS[1][1], 8)])
        assert tserving.decode_stats()["prefill_chunks"] - c0 == 3 + 2
        assert {"a": eng.result("a"), "b": eng.result("b")} == want
        pinned = GenerationEngine(tm, device="cpu", prefill_chunk_blocks=0, **kw)
        assert pinned._prefill_chunk_blocks() == 0
    finally:
        set_flags({"FLAGS_prefill_chunk_blocks": 0})
    with pytest.raises(ValueError, match="prefill_chunk_blocks"):
        GenerationEngine(tm, device="cpu", prefill_chunk_blocks=-1, **kw)


def test_requests_finishing_at_admission_surface(models):
    """A request whose first token is its last (max_new_tokens=1) finishes
    at the end of its interleaved prefill; its token surfaces in that
    step's output and its pages go back."""
    _, tm = models
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=16, device="cpu",
                           decode_chunk=2, prefill_chunk_blocks=1)
    assert eng.add_request("one", prompt(21, 12), max_new_tokens=1) is None
    out = eng.step()
    assert out == {"one": eng.result("one")} and len(eng.result("one")) == 1
    assert not eng.has_work() and len(eng._free) == 16
