"""The port's multi-tenant LoRA serving (``GenerationEngine(adapters=)``)
against the JAX package's, on the CPU.

Both engines serve the same weights and the same numpy-seeded adapters
(tests/test_torch_lora.py's ``adapter_sd``, carried by load_jax_adapter),
in tests/test_serving_lora.py's f32 tiny geometry.  Greedy streams, step
outputs and the LoRA and prefix counters must equal the JAX engine's; as
in tests/test_torch_prefix_cache.py, token equality across the frameworks
is meaningful only where no greedy step's top-2 logits are closer than
their f32 disagreement, so every port run compared with the JAX engine's
records its own logits and checks each step's top-2 margin exceeds MARGIN
(1e-3, ``OwnMargins``).  Sampled streams and the chained engines (a head
dim 64 model the chain kernels take, schedule-search verdicts through
``measure_override``) are checked port against port, bit for bit.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import decode_stats as jax_stats
from paddle_tpu.serving import lora_stats as jax_lora_stats

from paddle_tpu_torch import set_flags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import load_jax_adapter
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import lora as tlora
from paddle_tpu_torch.ops import autotune as at
from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.static import schedule_search as ss

from test_torch_lora import adapter_sd, models
from test_torch_prefix_cache import OwnMargins, stats_delta
from _torch_threads import _one_thread  # noqa: F401

PROMPTS = {"a0": [5, 9, 17, 33, 2], "a1": [7, 11, 3, 20], "a2": [15, 4, 40, 8, 22, 1],
           "base": [5, 9, 17, 33, 2]}
REQ_ADAPTERS = {"a0": "t0", "a1": "t1", "a2": "t2", "base": None}
SYS = list(range(1, 25))  # three full blocks at block_size 8
LORA_KEYS = ("swaps", "evictions", "gather_dispatches", "cache_epochs", "ship_ns_drops")
PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens")


@pytest.fixture(scope="module")
def tiny():
    return models()


SDS = {f"t{i}": adapter_sd(10 + i) for i in range(4)}


def register(eng, names, jax_side=False):
    for name in names:
        eng.register_adapter(name, SDS[name] if jax_side else load_jax_adapter(SDS[name]),
                             alpha=8)


def drain(eng, step=None):
    """Step until idle; the streams each rid emitted through step()."""
    out = {}
    while eng.has_work():
        for rid, toks in (step or eng.step)().items():
            out.setdefault(rid, []).extend(toks if isinstance(toks, list) else [toks])
    return out


def serve(eng, reqs, adapters=REQ_ADAPTERS, names=("t0", "t1", "t2"), jax_side=False, **kw):
    register(eng, names, jax_side)
    firsts = {rid: eng.add_request(rid, p, max_new_tokens=6, adapter=adapters[rid], **kw)
              for rid, p in reqs.items()}
    emitted = drain(eng)
    return firsts, emitted, {rid: eng.result(rid) for rid in reqs}


def both(tiny, reqs=PROMPTS, **kw):
    """The same registrations and submissions on the JAX and the port
    engine (margins checked on the port's own logits): add_request returns,
    step outputs, results, LoRA and prefix counter deltas all equal.
    Returns the port engine and its results."""
    jm, tm = tiny
    j0, jl0 = jax_stats(), jax_lora_stats()
    want = serve(JaxEngine(jm, **kw), reqs, jax_side=True)
    jd = (stats_delta(jax_stats, j0, PREFIX_KEYS), stats_delta(jax_lora_stats, jl0, LORA_KEYS))
    t0, tl0 = tserving.decode_stats(), tserving.lora_stats()
    eng = GenerationEngine(tm, device="cpu", **kw)
    with OwnMargins(tm) as margins:
        got = serve(eng, reqs)
    margins.check()
    assert got == want
    assert (stats_delta(tserving.decode_stats, t0, PREFIX_KEYS),
            stats_delta(tserving.lora_stats, tl0, LORA_KEYS)) == jd
    return eng, got[2]


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_mixed_batch_matches_jax_and_serial_runs(tiny, decode_chunk):
    """Three adapters and a base row in one macro-step: the JAX engine's
    streams, and each request's serial run on a one-lane engine."""
    kw = dict(block_size=8, decode_chunk=decode_chunk, adapters={"rank": 4, "max_adapters": 3})
    _, mixed = both(tiny, max_batch=4, num_blocks=32, **kw)
    assert len({tuple(v) for v in mixed.values()}) >= 3  # the tenants decode differently
    for rid, p in PROMPTS.items():
        eng = GenerationEngine(tiny[1], max_batch=1, num_blocks=16, device="cpu", **kw)
        assert serve(eng, {rid: p})[2][rid] == mixed[rid], rid


def test_sampled_mixed_streams_equal_serial_runs(tiny):
    """Seeded sampling across a mixed-adapter batch, port against port:
    each stream equals its serial run with the submit-order nonce pinned."""
    kw = dict(block_size=8, adapters={"rank": 4, "max_adapters": 3}, device="cpu")
    mixed = serve(GenerationEngine(tiny[1], max_batch=4, num_blocks=32, **kw), PROMPTS,
                  temperature=0.9, seed=5)[2]
    for nonce, (rid, p) in enumerate(PROMPTS.items()):
        eng = GenerationEngine(tiny[1], max_batch=1, num_blocks=16, **kw)
        register(eng, ("t0", "t1", "t2"))
        eng.add_request(rid, p, max_new_tokens=6, adapter=REQ_ADAPTERS[rid], temperature=0.9,
                        seed=5, nonce=nonce)
        drain(eng)
        assert eng.result(rid) == mixed[rid], rid


def test_slot0_requests_equal_a_lora_free_engine(tiny):
    jm, tm = tiny
    plain = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=16, device="cpu")
    plain.add_request("b", PROMPTS["base"], max_new_tokens=8)
    drain(plain)
    jplain = JaxEngine(jm, max_batch=2, block_size=8, num_blocks=16)
    jplain.add_request("b", PROMPTS["base"], max_new_tokens=8)
    drain(jplain)
    assert plain.result("b") == jplain.result("b")
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           adapters={"rank": 4, "max_adapters": 2})
    register(eng, ("t0",))
    eng.add_request("b", PROMPTS["base"], max_new_tokens=8)
    eng.add_request("l", PROMPTS["a1"], max_new_tokens=8, adapter="t0")
    drain(eng)
    assert eng.result("b") == plain.result("b")
    assert eng.result("l") != plain.result("b")


def test_interleaved_admission_through_adapters_matches_jax_and_atomic(tiny):
    """Interleaved prefill (one-block chunks through the adapter hooks, the
    prefix tree namespaced) against the JAX engine, and bit for bit
    against atomic admission in one-block chunks."""
    reqs = {"a0": SYS + [3], "a1": SYS + [4, 5], "base": SYS + [6]}
    ads = {"a0": "t0", "a1": "t1", "base": None}
    kw = dict(max_batch=2, block_size=8, num_blocks=48, decode_chunk=4, prefix_cache=True,
              adapters={"rank": 4, "max_adapters": 2})
    jm, tm = tiny
    want = serve(JaxEngine(jm, prefill_chunk_blocks=1, **kw), reqs, ads, ("t0", "t1"), True)
    eng = GenerationEngine(tm, prefill_chunk_blocks=1, device="cpu", **kw)
    with OwnMargins(tm) as margins:
        got = serve(eng, reqs, ads, ("t0", "t1"))
    margins.check()
    assert got == want
    atomic = serve(GenerationEngine(tm, prefill_chunk=8, device="cpu", **kw), reqs, ads,
                   ("t0", "t1"))
    assert atomic[2] == got[2]


def test_hot_swap_keeps_captured_steps_and_strands_the_subtree(tiny):
    """A swap between steps writes the pack in place: the engine's step
    object is the same before and after, the swapped tenant's stream
    equals a fresh engine's, and exactly the swapped slot's prefix subtree
    is dropped (the JAX engine's counts)."""
    jm, tm = tiny
    kw = dict(max_batch=2, block_size=8, num_blocks=32, decode_chunk=4, prefix_cache=True,
              adapters={"rank": 4, "max_adapters": 1})

    def script(eng, jax_side):
        conv = (lambda s: s) if jax_side else load_jax_adapter
        eng.register_adapter("a", conv(SDS["t0"]), alpha=8)
        for rid in ("r1", "r2"):
            eng.add_request(rid, SYS, max_new_tokens=4, adapter="a")
            drain(eng)
        steps = dict(getattr(eng, "_step_fns", {}))
        pack = [t.data_ptr() for _, t in eng._pack.parts()] if not jax_side else None
        cached, free0 = len(eng._prefix), len(eng._free)
        eng.register_adapter("b", conv(SDS["t1"]), alpha=8)  # evicts the idle "a"
        eng.add_request("r3", SYS, max_new_tokens=4, adapter="b")
        drain(eng)
        eng.add_request("r4", SYS, max_new_tokens=4, adapter="b")
        drain(eng)
        return steps, pack, cached, free0, {r: eng.result(r) for r in ("r1", "r2", "r3", "r4")}

    j0 = jax_stats()
    jeng = JaxEngine(jm, **kw)
    *_, jres = script(jeng, True)
    jd = stats_delta(jax_stats, j0, PREFIX_KEYS)
    t0 = tserving.decode_stats()
    eng = GenerationEngine(tm, device="cpu", **kw)
    with OwnMargins(tm) as margins:
        steps, pack, cached, free0, res = script(eng, False)
    margins.check()
    assert res == jres and stats_delta(tserving.decode_stats, t0, PREFIX_KEYS) == jd
    assert res["r2"] == res["r1"] and res["r4"] == res["r3"] != res["r1"]
    assert jd == {"prefix_hits": 2, "prefix_misses": 2, "prefix_hit_tokens": 32}
    # the same captured step objects, the pack at the same addresses
    assert steps and all(eng._step_fns[d] is f for d, f in steps.items())
    assert [t.data_ptr() for _, t in eng._pack.parts()] == pack
    assert len(eng._prefix) == cached and len(eng._free) >= free0 - 3
    fresh = GenerationEngine(tm, device="cpu", **kw)
    fresh.register_adapter("b", load_jax_adapter(SDS["t1"]), alpha=8)
    fresh.add_request("r3", SYS, max_new_tokens=4, adapter="b")
    drain(fresh)
    assert fresh.result("r3") == res["r3"]


def test_adapter_namespaces_never_cross_match(tiny):
    """The same prompt under adapter A, adapter B and the base slot: three
    misses, then each repeat hits its own namespace only (as the JAX
    engine counts)."""
    jm, tm = tiny
    kw = dict(max_batch=2, block_size=8, num_blocks=64, prefix_cache=True,
              adapters={"rank": 4, "max_adapters": 2})

    def script(eng, jax_side):
        register(eng, ("t0", "t1"), jax_side)
        for i, ad in enumerate([None, "t0", "t1"] * 2):
            eng.add_request(f"m{i}", SYS, max_new_tokens=3, adapter=ad)
            drain(eng)
        return [eng.result(f"m{i}") for i in range(6)]

    j0 = jax_stats()
    want = script(JaxEngine(jm, **kw), True)
    jd = stats_delta(jax_stats, j0, PREFIX_KEYS)
    t0 = tserving.decode_stats()
    got = script(GenerationEngine(tm, device="cpu", **kw), False)
    assert got == want and stats_delta(tserving.decode_stats, t0, PREFIX_KEYS) == jd
    assert jd["prefix_misses"] == 3 and jd["prefix_hits"] == 3
    assert got[3:] == got[:3] and len({tuple(s) for s in got[:3]}) >= 2


def test_slot_exhaustion_queues_then_matches_immediate_admission(tiny):
    """With every slot pinned by a request in flight, registration defers
    the install and the request queues; its sampled stream equals an
    immediate admission's, and step() surfaces its first token."""
    tm = tiny[1]

    def run(max_adapters):
        eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu",
                               adapters={"rank": 4, "max_adapters": max_adapters})
        eng.register_adapter("a", load_jax_adapter(SDS["t0"]), alpha=8)
        first_long = eng.add_request("long", PROMPTS["a0"], max_new_tokens=10, adapter="a",
                                     temperature=0.5, seed=11)
        slot_b = eng.register_adapter("b", load_jax_adapter(SDS["t1"]), alpha=8)
        first_x = eng.add_request("x", PROMPTS["a0"], max_new_tokens=6, adapter="b",
                                  temperature=0.8, seed=3)
        assert first_long is not None
        return eng, slot_b, first_x, drain(eng)

    ref, slot_imm, first_imm, _ = run(2)
    assert slot_imm is not None and first_imm is not None
    eng, slot_q, first_q, streams = run(1)
    assert slot_q is None and first_q is None
    assert eng.result("x") == ref.result("x") and eng.result("long") == ref.result("long")
    assert streams["x"] == eng.result("x")


def test_evict_adapter_contract(tiny):
    eng = GenerationEngine(tiny[1], max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           adapters={"rank": 4, "max_adapters": 2})
    register(eng, ("t0",))
    assert eng.adapter_slots() == {"t0": 1}
    eng.add_request("r", PROMPTS["a0"], max_new_tokens=8, adapter="t0")
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.evict_adapter("t0")  # an active request pins the slot
    drain(eng)
    before = tserving.lora_stats()
    eng.evict_adapter("t0")
    assert eng.adapter_slots() == {}
    assert tserving.lora_stats()["evictions"] == before["evictions"] + 1
    assert all(float(t[:, 1].abs().max()) == 0 for a in eng._pack.ab.values() for t in a)
    with pytest.raises(KeyError):
        eng.evict_adapter("t0")
    with pytest.raises(KeyError, match="not registered"):
        eng.add_request("r2", PROMPTS["a0"], max_new_tokens=4, adapter="t0")


def test_reregistering_a_resident_adapter_writes_it_in_place(tiny):
    tm = tiny[1]
    kw = dict(max_batch=2, block_size=8, num_blocks=32, device="cpu",
              adapters={"rank": 4, "max_adapters": 2})
    ref = GenerationEngine(tm, **kw)
    ref.register_adapter("t", load_jax_adapter(SDS["t1"]), alpha=8)
    ref.add_request("x", PROMPTS["a0"], max_new_tokens=6, adapter="t")
    drain(ref)
    eng = GenerationEngine(tm, prefix_cache=True, **kw)
    slot = eng.register_adapter("t", load_jax_adapter(SDS["t0"]), alpha=8)
    eng.add_request("r1", PROMPTS["a0"], max_new_tokens=10, adapter="t")
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.register_adapter("t", load_jax_adapter(SDS["t1"]), alpha=8)
    drain(eng)
    epoch = eng._slot_epochs[slot]
    assert eng.register_adapter("t", load_jax_adapter(SDS["t1"]), alpha=8) == slot
    assert eng._slot_epochs[slot] == epoch + 1
    eng.add_request("r2", PROMPTS["a0"], max_new_tokens=6, adapter="t")
    drain(eng)
    assert eng.result("r2") == ref.result("x") != eng.result("r1")[:6]


def test_adapterless_engine_and_bad_combos_are_loud(tiny):
    tm = tiny[1]
    eng = GenerationEngine(tm, max_batch=1, block_size=8, num_blocks=16, device="cpu")
    with pytest.raises(RuntimeError, match="without adapters="):
        eng.register_adapter("t", {})
    with pytest.raises(RuntimeError, match="without adapters="):
        eng.add_request("r", [1, 2], max_new_tokens=2, adapter="t")
    with pytest.raises(TypeError, match="adapters"):
        GenerationEngine(tm, max_batch=1, block_size=8, num_blocks=16, device="cpu",
                         adapters="rank4")
    pack = tlora.AdapterPack(tm, rank=2, max_adapters=1)
    assert GenerationEngine(tm, max_batch=1, block_size=8, num_blocks=16, device="cpu",
                            adapters=pack)._pack is pack
    with pytest.raises(NotImplementedError, match="A.6"):
        GenerationEngine(tm, mesh=object(), device="cpu")


def test_speculative_adapter_engine_matches_plain_adapter_engine(tiny):
    """The draft proposes with the base model, the verify goes through
    each row's adapter: the streams are the plain adapter engine's, the
    JAX speculative adapter engine's too, and a swap between ticks keeps
    the captured tick."""
    jm, tm = tiny
    reqs = {"a0": PROMPTS["a0"], "a1": PROMPTS["a1"], "base": PROMPTS["base"]}
    kw = dict(max_batch=3, block_size=8, num_blocks=32, adapters={"rank": 4, "max_adapters": 2})
    plain = serve(GenerationEngine(tm, device="cpu", **kw), reqs, names=("t0", "t1"))[2]
    assert len({tuple(v) for v in plain.values()}) == 3
    spec_kw = dict(draft_model=tm, num_speculative_tokens=3, **kw)
    j0 = jax_lora_stats()
    want = serve(JaxEngine(jm, **dict(spec_kw, draft_model=jm)), reqs, names=("t0", "t1"),
                 jax_side=True)
    jd = stats_delta(jax_lora_stats, j0, LORA_KEYS)
    t0 = tserving.lora_stats()
    eng = GenerationEngine(tm, device="cpu", **spec_kw)
    got = serve(eng, reqs, names=("t0", "t1"))
    assert got == want and got[2] == plain
    assert stats_delta(tserving.lora_stats, t0, LORA_KEYS) == jd
    tick = eng._spec_fn
    eng.evict_adapter("t1")
    eng.register_adapter("t2", load_jax_adapter(SDS["t2"]), alpha=8)
    eng.add_request("x", PROMPTS["a2"], max_new_tokens=6, adapter="t2")
    drain(eng)
    assert eng._spec_fn is tick
    ref = GenerationEngine(tm, device="cpu", **kw)
    ref.register_adapter("t2", load_jax_adapter(SDS["t2"]), alpha=8)
    ref.add_request("x", PROMPTS["a2"], max_new_tokens=6, adapter="t2")
    drain(ref)
    assert eng.result("x") == ref.result("x")


def _ship(eng, prompt, n):
    """The first ``n`` prompt blocks' pages of a served prompt, per layer."""
    blocks = eng._prefix.match(prompt)[:n]
    return ([pa.pool_get_blocks(p, blocks) for p in eng._kpools],
            [pa.pool_get_blocks(p, blocks) for p in eng._vpools])


def test_adopt_pages_in_a_namespace_and_stale_epochs_dropped(tiny):
    """Pages a tenant's prefill poured land in that tenant's namespace on
    another adapter engine: its admission hits them, the base slot and
    another tenant miss, and a stale epoch is dropped and counted, as on
    the JAX engine."""
    jm, tm = tiny
    kw = dict(max_batch=2, block_size=8, num_blocks=48, prefix_cache=True,
              adapters={"rank": 4, "max_adapters": 2})

    def script(make, conv, get_pages):
        sender = make()
        sender.register_adapter("t0", conv(SDS["t0"]), alpha=8)
        sender.add_request("s", SYS + [7], max_new_tokens=2, adapter="t0")
        drain(sender)
        k, v = get_pages(sender)
        ns = (sender.adapter_slots()["t0"], sender._slot_epochs[1])
        recv = make()
        recv.register_adapter("t0", conv(SDS["t0"]), alpha=8)
        recv.register_adapter("t1", conv(SDS["t1"]), alpha=8)
        got = [recv.adopt_pages(SYS, k, v, ns=ns), recv.adopt_pages(SYS, k, v, ns=(1, 0))]
        for rid, ad in (("hit", "t0"), ("base", None), ("other", "t1")):
            recv.add_request(rid, SYS + [7], max_new_tokens=4, adapter=ad)
            drain(recv)
        return got, {r: recv.result(r) for r in ("hit", "base", "other")}

    j0, jl0 = jax_stats(), jax_lora_stats()

    def jship(e):
        from paddle_tpu.ops import paged_attention as jpa

        blocks = e._prefix.match(SYS, ns=(1, e._slot_epochs[1]))[:3]
        return ([jpa.pool_get_blocks(p, blocks) for p in e._kpools],
                [{n: np.asarray(a) for n, a in jpa.pool_get_blocks(p, blocks).items()}
                 for p in e._vpools])

    want = script(lambda: JaxEngine(jm, **kw), lambda s: s, jship)
    jd = (stats_delta(jax_stats, j0, PREFIX_KEYS), stats_delta(jax_lora_stats, jl0, LORA_KEYS))

    def tship(e):
        blocks = e._prefix.match(SYS, ns=(1, e._slot_epochs[1]))[:3]
        return ([pa.pool_get_blocks(p, blocks) for p in e._kpools],
                [pa.pool_get_blocks(p, blocks) for p in e._vpools])

    t0, tl0 = tserving.decode_stats(), tserving.lora_stats()
    got = script(lambda: GenerationEngine(tm, device="cpu", **kw), load_jax_adapter, tship)
    assert got == want
    assert (stats_delta(tserving.decode_stats, t0, PREFIX_KEYS),
            stats_delta(tserving.lora_stats, tl0, LORA_KEYS)) == jd
    # the sender's epoch of slot 1 is 1 (its first install): (1, 1) lands,
    # (1, 0) is stale on the receiver, whose slot 1 is at epoch 1 too
    assert got[0] == [3, 0] and jd[1]["ship_ns_drops"] == 1
    assert jd[0]["prefix_hits"] == 1 and jd[0]["prefix_misses"] == 3
    base = GenerationEngine(tm, device="cpu", **dict(kw, adapters=None))
    with pytest.raises(ValueError, match="without adapters="):
        base.adopt_pages(SYS, *_ship(base, SYS, 0), ns=(1, 1))


def test_lora_stats_and_reset_keeps_the_gauges(tiny):
    eng = GenerationEngine(tiny[1], max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           adapters={"rank": 4, "max_adapters": 3})
    tserving.reset_lora_stats()
    register(eng, ("t0",))
    eng.add_request("r", PROMPTS["a0"], max_new_tokens=4, adapter="t0")
    drain(eng)
    st = tserving.lora_stats(reset=True)
    assert st["slots_total"] == 3 and st["slots_resident"] == 1
    assert st["swaps"] == 1 and st["cache_epochs"] == 1 and st["gather_dispatches"] >= 1
    after = tserving.lora_stats()
    assert after["swaps"] == 0 and after["gather_dispatches"] == 0
    assert after["slots_resident"] == 1 and after["slots_total"] == 3


# ------------------------------------------------------------ chained engines

@pytest.fixture(scope="module")
def tiny64():
    """A port-only model whose attention the chain kernels take (head dim
    64; tests/test_torch_quant_serving.py's), with seeded adapters of its
    widths."""
    cfg = dict(vocab_size=128, hidden_size=128, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256,
               dtype="float32")
    g = torch.Generator().manual_seed(43)
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu", generator=g)
    sds = {}
    for i in range(3):
        rng = np.random.default_rng(70 + i)
        sd = {}
        for li, layer in enumerate(tm.model.layers):
            for t in tlora.LLAMA_TARGETS:
                lin = tlora._resolve_sublayer(layer, t)
                sd[f"model.layers.{li}.{t}.lora_A"] = torch.from_numpy(
                    rng.standard_normal((lin.in_features, 4)).astype(np.float32) * 0.05)
                sd[f"model.layers.{li}.{t}.lora_B"] = torch.from_numpy(
                    rng.standard_normal((4, lin.out_features)).astype(np.float32) * 0.2)
        sds[f"t{i}"] = sd
    return tm, sds


@pytest.fixture()
def search(tmp_path):
    set_flags({"FLAGS_autotune_cache_dir": str(tmp_path)})
    at._CACHES.clear()
    tserving.reset_schedule_decode_stats()
    yield
    set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
    at._CACHES.clear()
    tserving.reset_schedule_decode_stats()


def _win(fn, args, *, label, config):
    return 0.4 if config is not None else 1.0


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_chained_adapter_engine_equals_unchained_and_serial(tiny64, search, monkeypatch,
                                                            decode_chunk):
    """With the decode chain accepted the projections get their deltas
    before the chain: the mixed streams equal the unchained engine's and
    each request's serial run on the chained engine."""
    tm, sds = tiny64
    long = [int(t) for t in np.random.default_rng(9).integers(1, 128, 150)]
    reqs = {"a0": long, "a1": PROMPTS["a1"], "a2": PROMPTS["a2"], "base": PROMPTS["base"]}
    kw = dict(block_size=8, decode_chunk=decode_chunk, kv_cache_dtype="int8", prefill_chunk=64,
              adapters={"rank": 4, "max_adapters": 3}, device="cpu")

    def run(max_batch, subset):
        eng = GenerationEngine(tm, max_batch=max_batch, num_blocks=96, **kw)
        for name, sd in sds.items():
            eng.register_adapter(name, sd, alpha=8)
        for rid in subset:
            eng.add_request(rid, reqs[rid], max_new_tokens=6, adapter=REQ_ADAPTERS[rid])
        drain(eng)
        return eng, {rid: eng.result(rid) for rid in subset}

    _, unchained = run(4, reqs)
    calls = {"n": 0}
    fused = dc.fused_decode_step

    def counted(*a, **k):
        calls["n"] += 1
        return fused(*a, **k)

    monkeypatch.setattr(dc, "fused_decode_step", counted)
    set_flags({"FLAGS_schedule_search": True})
    with ss.measure_override(_win):
        eng, chained = run(4, reqs)
        assert eng._decode_chain_cfg is not None and calls["n"] > 0
        assert chained == unchained
        assert len({tuple(v) for v in chained.values()}) == 4
        for rid in reqs:
            assert run(1, [rid])[1][rid] == chained[rid], rid
