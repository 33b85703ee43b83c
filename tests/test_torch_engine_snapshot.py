"""The port's live-engine snapshots (``serving/snapshot.py``,
``GenerationEngine.snapshot`` / ``drain`` / ``maybe_snapshot``, the
preemption handler, ``restore_engine``), on the CPU.

A snapshot taken mid-flight and restored into a fresh engine must finish
every stream as the uninterrupted engine does, bit for bit (greedy and
seeded-sampled, port against port), and greedy streams must equal the JAX
package's uninterrupted engine on the same weights and adapters
(tests/test_torch_lora.py's f32 tiny geometry; the port's own top-2
margins checked above MARGIN, ``OwnMargins``, except in the speculative
round trip, whose verify logits the spy does not see).  Pool bytes, int8 scales
and adapter packs are compared exactly.  The on-disk format is the
port's own, so nothing is loaded across the packages.
"""

import os
import signal

import numpy as np
import pytest
import torch

from paddle_tpu.serving import GenerationEngine as JaxEngine

from paddle_tpu_torch import set_flags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import load_jax_adapter
from paddle_tpu_torch.distributed.checkpoint import manager as ckpt
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import (EngineSnapshot, GenerationEngine, restore_engine,
                                      snapshot as tsnap)

from test_torch_lora import adapter_sd, models
from test_torch_prefix_cache import OwnMargins

P1, P2 = [5, 9, 17, 33, 2], [7, 11, 3]
KW = dict(max_batch=2, block_size=8, num_blocks=16, decode_chunk=2)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    return models()


def drain(eng):
    out = {}
    while eng.has_work():
        for rid, toks in eng.step().items():
            out.setdefault(rid, []).extend(toks if isinstance(toks, list) else [toks])
    return out


def submit(eng, sampled=True):
    eng.add_request("g", P1, max_new_tokens=8)
    if sampled:
        eng.add_request("s", P2, max_new_tokens=6, temperature=5.0, seed=3)
    else:
        eng.add_request("s", P2, max_new_tokens=6)


def results(eng, rids=("g", "s")):
    return {rid: eng.result(rid) for rid in rids}


def _pool_leaves(eng):
    return [t for pools in (eng._kpools, eng._vpools) for p in pools
            for _, t in pa.pool_parts(p)]


def _jax_greedy(jm, **kw):
    """The JAX engine's uninterrupted greedy streams of ``submit``."""
    eng = JaxEngine(jm, **kw)
    submit(eng, sampled=False)
    drain(eng)
    return results(eng)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mid_flight_snapshot_resumes_bit_exact(tiny, tmp_path, kv):
    """After one macro-step: the restored engine's pools (int8 payload and
    scales) equal the source's bit for bit, and both engines finish every
    stream as an uninterrupted one; the greedy streams equal the JAX
    engine's."""
    jm, tm = tiny
    kw = dict(KW, kv_cache_dtype=kv, device="cpu")
    for sampled in (True, False):
        ref = GenerationEngine(tm, **kw)
        submit(ref, sampled)
        with OwnMargins(tm) as margins:
            drain(ref)
        if not sampled:
            margins.check()
            assert results(ref) == _jax_greedy(jm, **dict(KW, kv_cache_dtype=kv))
        eng = GenerationEngine(tm, **kw)
        submit(eng, sampled)
        eng.step()
        d = tmp_path / f"s{sampled}"
        step = eng.snapshot(str(d))
        assert EngineSnapshot(str(d)).latest_step() == step == eng._macro_steps
        tsnap.reset_snapshot_stats()
        eng2 = restore_engine(tm, str(d), device="cpu")
        assert eng2._kv_dtype == kv and tsnap.snapshot_stats()["restores"] == 1
        for a, b in zip(_pool_leaves(eng2), _pool_leaves(eng)):
            assert torch.equal(a, b)
        drain(eng2)
        drain(eng)
        assert results(eng2) == results(eng) == results(ref)


def test_pending_queue_and_nonce_counter_survive(tiny, tmp_path):
    tm = tiny[1]

    def run(snap=None):
        eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=2, decode_chunk=2,
                               device="cpu")
        p = list(range(1, 9))
        eng.add_request("a", p, max_new_tokens=7)
        assert eng.add_request("b", p, max_new_tokens=7, temperature=4.0, seed=1) is None
        eng.step()
        if snap is not None:
            eng.snapshot(snap)
            eng = restore_engine(tm, snap, device="cpu")
            assert eng.pending_requests() == ["b"]
        drain(eng)
        eng.add_request("c", P2, max_new_tokens=5, temperature=4.0, seed=1)
        drain(eng)
        return {r: eng.result(r) for r in "abc"}

    ref = run()
    assert run(str(tmp_path)) == ref
    assert ref["b"] != ref["c"]  # same seed, other nonces


def test_prefix_tree_survives_restore(tiny, tmp_path):
    tm = tiny[1]
    shared = [int(t) for t in np.random.default_rng(0).integers(0, 128, 16)]

    def run(snap=None):
        eng = GenerationEngine(tm, prefix_cache=True, device="cpu", **KW)
        eng.add_request("w", shared + [3], max_new_tokens=4)
        drain(eng)
        if snap is not None:
            tree = tsnap._radix_state(eng._prefix)
            eng.snapshot(snap)
            eng = restore_engine(tm, snap, device="cpu")
            assert tsnap._radix_state(eng._prefix) == tree  # keys, blocks, LRU marks
        before = tserving.decode_stats()
        eng.add_request("x", shared + [9, 4], max_new_tokens=5)
        drain(eng)
        st = tserving.decode_stats()
        return eng.result("x"), st["prefix_hits"] - before["prefix_hits"]

    assert run(str(tmp_path)) == run() == (run()[0], 1)


def test_adapter_slots_epochs_and_pack_survive(tiny, tmp_path):
    """The registry, the slots' names, epochs and LRU clock and the pack's
    bytes restore; mixed-tenant streams finish as the uninterrupted
    engine's and the JAX engine's; a later re-registration moves the
    restored epoch on."""
    jm, tm = tiny
    kw = dict(max_batch=3, block_size=8, num_blocks=24, decode_chunk=2, prefix_cache=True,
              adapters={"rank": 4, "max_adapters": 3})

    def build(engine, conv):
        eng = engine(**kw)
        eng.register_adapter("t0", conv(adapter_sd(7)), alpha=8)
        eng.register_adapter("t1", conv(adapter_sd(13)), alpha=8)
        eng.add_request("a", P1, max_new_tokens=7, adapter="t0")
        eng.add_request("b", P1, max_new_tokens=7, adapter="t1")
        eng.add_request("c", P2, max_new_tokens=5)
        return eng

    jref = build(lambda **k: JaxEngine(jm, **k), lambda s: s)
    drain(jref)
    ref = build(lambda **k: GenerationEngine(tm, device="cpu", **k), load_jax_adapter)
    with OwnMargins(tm) as margins:
        drain(ref)
    margins.check()
    assert {r: ref.result(r) for r in "abc"} == {r: jref.result(r) for r in "abc"}
    eng = build(lambda **k: GenerationEngine(tm, device="cpu", **k), load_jax_adapter)
    eng.step()
    eng.snapshot(str(tmp_path))
    eng2 = restore_engine(tm, str(tmp_path), device="cpu")
    assert eng2.adapter_slots() == eng.adapter_slots()
    assert eng2._slot_epochs == eng._slot_epochs and eng2._slot_refs == eng._slot_refs
    assert (eng2._slot_used, eng2._slot_clock) == (eng._slot_used, eng._slot_clock)
    for (_, a), (_, b) in zip(eng2._pack.parts(), eng._pack.parts()):
        assert torch.equal(a, b)
    assert tserving.lora_stats()["slots_resident"] == 2
    drain(eng2)
    assert {r: eng2.result(r) for r in "abc"} == {r: ref.result(r) for r in "abc"}
    before = list(eng2._slot_epochs)
    slot = eng2.register_adapter("t0", load_jax_adapter(adapter_sd(99)), alpha=8)
    assert eng2._slot_epochs[slot] == before[slot] + 1


def test_speculative_engine_round_trip(tiny, tmp_path):
    jm, tm = tiny

    def build(make):
        eng = make()
        eng.add_request("a", P1, max_new_tokens=9)
        eng.add_request("b", P2, max_new_tokens=6)
        return eng

    kw = dict(max_batch=2, block_size=8, num_blocks=32, num_speculative_tokens=3)
    jref = build(lambda: JaxEngine(jm, draft_model=jm, **kw))
    drain(jref)
    ref = build(lambda: GenerationEngine(tm, draft_model=tm, device="cpu", **kw))
    drain(ref)
    assert results(ref, "ab") == results(jref, "ab")
    eng = build(lambda: GenerationEngine(tm, draft_model=tm, device="cpu", **kw))
    eng.step()
    eng.snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="draft_model"):
        restore_engine(tm, str(tmp_path), device="cpu")
    eng2 = restore_engine(tm, str(tmp_path), draft_model=tm, device="cpu")
    assert eng2._spec_stats == eng._spec_stats
    assert [s.d_seq_len for s in eng2._slots] == [s.d_seq_len for s in eng._slots]
    drain(eng2)
    assert results(eng2, "ab") == results(ref, "ab")


def test_restore_under_a_changed_decode_chunk(tiny, tmp_path):
    tm = tiny[1]
    ref = GenerationEngine(tm, **dict(KW, decode_chunk=1), device="cpu")
    submit(ref)
    drain(ref)
    set_flags({"FLAGS_decode_chunk": 4})
    try:
        eng = GenerationEngine(tm, **dict(KW, decode_chunk=None), device="cpu")
        submit(eng)
        eng.step()
        eng.snapshot(str(tmp_path))
        set_flags({"FLAGS_decode_chunk": 2})
        eng2 = restore_engine(tm, str(tmp_path), device="cpu")
        assert all(len(v) <= 2 for v in eng2.step().values())  # the new D is live
        assert eng2._step_fns
        set_flags({"FLAGS_decode_chunk": 3})
        assert not eng2._step_fns  # a flag change drops the restored engine's steps
        drain(eng2)
    finally:
        set_flags({"FLAGS_decode_chunk": 8})
    assert results(eng2) == results(ref)


def test_restore_into_an_engine_that_captured_first(tiny, tmp_path):
    """The restored bytes land in the pools and the pack the engine
    already holds (and a captured step reads): no tensor is rebound."""
    tm = tiny[1]
    kw = dict(KW, adapters={"rank": 4, "max_adapters": 2}, device="cpu")
    ref = GenerationEngine(tm, **kw)
    ref.register_adapter("t", load_jax_adapter(adapter_sd(5)), alpha=8)
    ref.add_request("g", P1, max_new_tokens=8, adapter="t")
    drain(ref)
    eng = GenerationEngine(tm, **kw)
    eng.register_adapter("t", load_jax_adapter(adapter_sd(5)), alpha=8)
    eng.add_request("g", P1, max_new_tokens=8, adapter="t")
    eng.step()
    eng.snapshot(str(tmp_path))
    target = GenerationEngine(tm, **kw)
    target.warmup()
    captured = dict(target._step_fns)
    addrs = [t.data_ptr() for t in _pool_leaves(target)]
    pack = [t.data_ptr() for _, t in target._pack.parts()]
    path, extras = EngineSnapshot(str(tmp_path))._resolve(None)
    tsnap._load_state(target, path, extras)
    assert [t.data_ptr() for t in _pool_leaves(target)] == addrs
    assert [t.data_ptr() for _, t in target._pack.parts()] == pack
    drain(target)
    assert target._step_fns == captured
    assert target.result("g") == ref.result("g")


def test_drain_closes_admissions_and_hands_off(tiny, tmp_path):
    """drain(): the drained engine refuses requests and finishes only its
    residents (the queued request rode the snapshot), the automatic path
    writes nothing more, and the restored engine serves residents and
    queue to the uninterrupted streams."""
    tm = tiny[1]
    kw = dict(max_batch=1, block_size=8, num_blocks=4, decode_chunk=2, device="cpu")
    p = list(range(1, 9))
    ref = GenerationEngine(tm, **kw)
    ref.add_request("a", p, max_new_tokens=7)
    assert ref.add_request("b", p, max_new_tokens=6) is None
    drain(ref)
    set_flags({"FLAGS_engine_snapshot_dir": str(tmp_path), "FLAGS_engine_snapshot_interval": 1})
    try:
        eng = GenerationEngine(tm, **kw)
        eng.add_request("a", p, max_new_tokens=7)
        assert eng.add_request("b", p, max_new_tokens=6) is None
        drains = tsnap.snapshot_stats()["drains"]
        step = eng.drain(str(tmp_path))
        assert tsnap.snapshot_stats()["drains"] == drains + 1
        with pytest.raises(RuntimeError, match="draining"):
            eng.add_request("late", P2, max_new_tokens=3)
        drain(eng)
        assert eng.result("a") == ref.result("a") and eng.result("b") is None
        assert not eng.has_work()
        assert EngineSnapshot(str(tmp_path)).latest_step() == step
    finally:
        set_flags({"FLAGS_engine_snapshot_dir": "", "FLAGS_engine_snapshot_interval": 0})
    eng2 = EngineSnapshot(str(tmp_path)).restore(tm, step=step, device="cpu")
    assert eng2.pending_requests() == ["b"]
    drain(eng2)
    assert results(eng2, "ab") == results(ref, "ab")
    eng2.add_request("late", P2, max_new_tokens=3)
    drain(eng2)


def test_drain_demotes_prefilling_and_parked_requests(tiny, tmp_path):
    """A PREFILLING lane and a parked (preempted) request ride the drain
    snapshot as queued submissions; the restore target serves them to the
    streams of an undrained engine."""
    tm = tiny[1]
    kw = dict(max_batch=2, block_size=8, num_blocks=32, decode_chunk=2, prefill_chunk_blocks=1,
              device="cpu")
    long = list(range(1, 30))

    def start():
        eng = GenerationEngine(tm, **kw)
        eng.add_request("low", P1, max_new_tokens=12, priority="low")
        eng.add_request("low2", P2, max_new_tokens=12, priority="low")
        eng.step()
        eng.add_request("hi", long, max_new_tokens=4, priority="high")
        eng.step()  # "hi" preempts a LOW lane and starts its prefill
        return eng

    ref = start()
    drain(ref)
    eng = start()
    assert eng.parked_requests() and eng.prefilling_requests()
    eng.drain(str(tmp_path))
    assert not eng.parked_requests() and not eng.prefilling_requests()
    drain(eng)
    eng2 = restore_engine(tm, str(tmp_path), device="cpu")
    drain(eng2)
    assert results(eng2, ("low", "low2", "hi")) == results(ref, ("low", "low2", "hi"))


def test_drain_empty_engine_and_double_drain(tiny, tmp_path):
    tm = tiny[1]
    eng = GenerationEngine(tm, device="cpu", **KW)
    step = eng.drain(str(tmp_path))
    store = EngineSnapshot(str(tmp_path))
    assert store.latest_step() == step
    committed = store.all_steps()
    saves = tsnap.snapshot_stats()["saves"]
    assert eng.drain(str(tmp_path)) == step
    assert store.all_steps() == committed and tsnap.snapshot_stats()["saves"] == saves
    with pytest.raises(ValueError, match="already drained"):
        eng.drain(str(tmp_path / "elsewhere"))
    with pytest.raises(RuntimeError, match="draining"):
        eng.add_request("late", P2, max_new_tokens=3)
    assert not eng.has_work() and eng.step() == {}
    eng2 = store.restore(tm, step=step, device="cpu")
    assert eng2.pending_requests() == []
    eng2.add_request("fresh", P1, max_new_tokens=3)
    drain(eng2)
    assert isinstance(eng2.result("fresh"), list)
    with pytest.raises(ValueError, match="snapshot directory"):
        GenerationEngine(tm, device="cpu", **KW).drain()


def test_sigterm_preemption_snapshots_at_a_boundary(tiny, tmp_path):
    tm = tiny[1]
    ref = GenerationEngine(tm, device="cpu", **KW)
    submit(ref)
    drain(ref)
    eng = GenerationEngine(tm, device="cpu", **KW)
    submit(eng)
    eng.step()
    original = signal.getsignal(signal.SIGTERM)
    set_flags({"FLAGS_engine_snapshot_dir": str(tmp_path)})
    eng.install_preemption_handler()
    eng.install_preemption_handler()  # a second install keeps the original disposition
    try:
        os.kill(os.getpid(), signal.SIGTERM)  # the handler only sets the flag
        assert eng.preemption_requested and not eng.preemption_saved
        assert EngineSnapshot(str(tmp_path)).latest_step() is None
        eng.step()  # the boundary: the snapshot commits here
        assert eng.preemption_saved
        assert EngineSnapshot(str(tmp_path)).latest_step() is not None
    finally:
        eng.uninstall_preemption_handler()
        set_flags({"FLAGS_engine_snapshot_dir": ""})
    assert signal.getsignal(signal.SIGTERM) is original
    eng2 = restore_engine(tm, str(tmp_path), device="cpu")
    drain(eng2)
    assert results(eng2) == results(ref)


def test_preemption_on_an_idle_engine(tiny, tmp_path):
    tm = tiny[1]
    eng = GenerationEngine(tm, device="cpu", **KW)
    eng.add_request("g", P1, max_new_tokens=4)
    drain(eng)
    set_flags({"FLAGS_engine_snapshot_dir": str(tmp_path)})
    eng.install_preemption_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert eng.step() == {}  # the idle boundary commits
        assert eng.preemption_saved
    finally:
        eng.uninstall_preemption_handler()
        set_flags({"FLAGS_engine_snapshot_dir": ""})
    assert restore_engine(tm, str(tmp_path), device="cpu").result("g") == eng.result("g")


def test_periodic_interval_snapshots(tiny, tmp_path):
    tm = tiny[1]
    eng = GenerationEngine(tm, device="cpu", **dict(KW, decode_chunk=1))
    eng.add_request("g", P1, max_new_tokens=8)
    set_flags({"FLAGS_engine_snapshot_dir": str(tmp_path), "FLAGS_engine_snapshot_interval": 2})
    try:
        for _ in range(5):
            eng.step()
    finally:
        set_flags({"FLAGS_engine_snapshot_dir": "", "FLAGS_engine_snapshot_interval": 0})
    steps = EngineSnapshot(str(tmp_path)).all_steps()
    assert steps == [2, 4]  # every second boundary, the newest two kept


def test_corrupt_snapshot_skipped_and_counted(tiny, tmp_path):
    tm = tiny[1]
    eng = GenerationEngine(tm, device="cpu", **KW)
    submit(eng)
    eng.step()
    store = EngineSnapshot(str(tmp_path), max_to_keep=3)
    s1 = store.save(eng)
    eng.step()
    s2 = store.save(eng)
    assert store.latest_step() == s2 > s1
    with open(os.path.join(str(tmp_path), f"step_{s2:08d}", "extras.pkl"), "r+b") as f:
        f.truncate(16)
    tsnap.reset_snapshot_stats()
    store = EngineSnapshot(str(tmp_path), max_to_keep=3)  # a fresh store verifies again
    assert store.latest_step() == s1
    assert tsnap.snapshot_stats()["corrupt_skipped"] == 1
    assert EngineSnapshot(str(tmp_path)).latest_step() == s1
    assert tsnap.snapshot_stats()["corrupt_skipped"] == 1  # counted once
    with pytest.raises(RuntimeError, match="corrupt"):
        store.restore(tm, step=s2, device="cpu")
    eng2 = restore_engine(tm, str(tmp_path), device="cpu")
    assert eng2._macro_steps == s1
    drain(eng2)
    assert isinstance(eng2.result("g"), list)


def test_geometry_mismatch_and_unported_options_are_loud(tiny, tmp_path):
    tm = tiny[1]
    eng = GenerationEngine(tm, device="cpu", **KW)
    eng.add_request("g", P1, max_new_tokens=4)
    eng.snapshot(str(tmp_path))
    other = models(hidden_size=64, intermediate_size=128)[1]
    with pytest.raises(ValueError, match="hidden_size"):
        restore_engine(other, str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        restore_engine(tm, str(tmp_path), mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="no valid engine snapshot"):
        restore_engine(tm, str(tmp_path / "none"), device="cpu")
    assert EngineSnapshot(str(tmp_path)).config()["num_blocks"] == KW["num_blocks"]


def test_snapshot_stats_and_commit_protocol(tiny, tmp_path):
    tm = tiny[1]
    eng = GenerationEngine(tm, device="cpu", **KW)
    submit(eng)
    eng.step()
    tsnap.reset_snapshot_stats()
    step = eng.snapshot(str(tmp_path))
    restore_engine(tm, str(tmp_path), device="cpu")
    st = tserving.snapshot_stats()
    assert st["saves"] == 1 and st["restores"] == 1
    assert st["bytes"] > 0 and st["snapshot_seconds"] > 0
    assert st["corrupt_skipped"] == 0 and st["drains"] == 0
    assert tserving.snapshot_stats(reset=True)["saves"] == 1
    assert tserving.snapshot_stats()["saves"] == 0
    final = tmp_path / f"step_{step:08d}"
    assert sorted(os.listdir(final)) == ["MANIFEST.json", "extras.pkl", "pools.pt"]
    assert ckpt._verify_manifest(str(final), str(final / "MANIFEST.json"))
    # a dead process's temp directory is swept; a live one's is kept
    dead = tmp_path / "_tmp_step_00000009.999999999"
    mine = tmp_path / f"_tmp_step_00000009.{os.getpid()}"
    dead.mkdir()
    mine.mkdir()
    assert ckpt.sweep_stale_tmp(str(tmp_path)) == 1
    assert mine.exists() and not dead.exists()
    with pytest.raises(ValueError, match="step-tagged"):
        ckpt.commit_dir(str(tmp_path), "latest", lambda tmp: 0)
