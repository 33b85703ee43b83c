"""The port's radix prefix cache against the JAX package's, on the CPU.

The tree (``RadixPrefixCache``) is pure host Python in both packages: the
same operations must give the same answers, exactly.  The engines serve
the same weights (carried by load_jax_state_dict) and the same scripted
traffic, greedy, f32 tiny LLaMA; their streams, step outputs and prefix
counters must be equal.  As in tests/test_torch_serving.py, token
equality is meaningful only where no greedy step's top-2 logits are
closer than the two frameworks' f32 disagreement (about 1e-5): every
stream compared with the JAX engine's is checked to win each step by more
than MARGIN (1e-3) on the JAX model's full forward, and int8 streams on
the port's own int8 logits (``test_int8_engine_margins_on_its_own_logits``'s
rule).  Page bytes are compared exactly (tolerance 0) within the port:
shared pages are never written, and adopted pages land verbatim.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import RadixPrefixCache as JaxRadix
from paddle_tpu.serving import decode_stats as jax_stats

from paddle_tpu_torch import set_flags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import GenerationEngine, RadixPrefixCache

from test_torch_serving import CFG, MARGIN

PAD_LEN = 64
PREFIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_evictions")


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: the engines' ops are tiny, and a thread pool
    only spins beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """test_torch_serving's tiny GQA LLaMA with a rope table of 128."""
    cfg = dict(CFG, max_position_embeddings=128)
    paddle.seed(41)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


_COMPILED = {}


def _compiled(jm):
    """The JAX model's forward compiled whole, once a model."""
    if id(jm) not in _COMPILED:
        _COMPILED[id(jm)] = (jm, paddle.jit.to_static(jm.forward))
    return _COMPILED[id(jm)][1]


def assert_margins(jm, prompt, stream):
    """Every greedy token of ``stream`` won its step by more than MARGIN on
    the JAX model (one forward over prompt + stream, padded at the end)."""
    seq = list(prompt) + list(stream[:-1])
    ids = np.zeros((1, PAD_LEN), np.int32)
    ids[0, :len(seq)] = seq
    logits = np.asarray(_compiled(jm)(paddle.to_tensor(ids))._value)[0, len(prompt) - 1:len(seq)]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert np.argmax(logits, -1).tolist() == list(stream)
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


class OwnMargins:
    """Records the port engines' greedy logits through the model's
    ``_logits`` while it is entered: each prefill's last position, and in
    each decode step the rows of the lanes still emitting at that token
    iteration (from the lane states ``_fill_inputs`` staged; no EOS).
    ``check()`` asserts every recorded row's top-2 margin exceeds MARGIN."""

    def __init__(self, tm):
        self.tm, self.rows = tm, []
        self.live, self.it, self.d = None, 0, 0

    def __enter__(self):
        logits, fill = self.tm._logits, GenerationEngine._fill_inputs

        def fill_spy(eng, idle=False):
            fill(eng, idle)
            if not idle:
                self.live = [s.max_len - 1 - s.seq_len if s.active else 0 for s in eng._slots]
                self.it, self.d = 0, eng._effective_chunk()

        def spy(h):
            out = logits(h)
            lg = out[:, -1].float()
            if self.live is not None and self.it < self.d:
                self.rows += [lg[i] for i, left in enumerate(self.live) if left > self.it]
                self.it += 1
            else:
                self.rows.append(lg[0])
            return out

        self._fill = fill
        GenerationEngine._fill_inputs = fill_spy
        self.tm._logits = spy
        return self

    def __exit__(self, *exc):
        GenerationEngine._fill_inputs = self._fill
        del self.tm._logits

    def check(self):
        assert self.rows
        top2 = torch.topk(torch.stack(self.rows), 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def play(eng, script, **kw):
    """Run ``script``: ("add", rid, prompt, n[, extra kwargs]) or ("step",).
    Returns every add_request return and step output."""
    log = []
    for op in script:
        if op[0] == "add":
            extra = op[4] if len(op) > 4 else {}
            log.append(eng.add_request(op[1], op[2], max_new_tokens=op[3], **kw, **extra))
        else:
            log.append(eng.step())
    return log


def drive(eng, script, **kw):
    """``play`` the script, then step until idle; returns the whole log."""
    log = play(eng, script, **kw)
    while eng.has_work():
        log.append(eng.step())
    return log


def stats_delta(fn, before, keys):
    now = fn()
    return {k: now[k] - before[k] for k in keys}


def run_both(models, script, keys=PREFIX_KEYS, **kw):
    """The same script on the JAX and the port engine: logs equal, every
    stream equal, each package's counters moved alike.  Returns both
    engines."""
    jm, tm = models
    j0, t0 = jax_stats(), tserving.decode_stats()
    jeng = JaxEngine(jm, **kw)
    jlog = drive(jeng, script)
    teng = GenerationEngine(tm, device="cpu", **kw)
    tlog = drive(teng, script)
    assert tlog == jlog
    assert stats_delta(tserving.decode_stats, t0, keys) == stats_delta(jax_stats, j0, keys)
    for op in script:
        if op[0] == "add":
            assert teng.result(op[1]) == jeng.result(op[1])
    return jeng, teng


def prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 128, n)]


# ---------------------------------------------------------- the radix tree


def test_radix_tree_operations_match_jax():
    """A seeded random run of insert / match (capped and not) / evict /
    holds / drop_subtree on both trees, with refcounts changing between
    operations: every answer equal, exactly."""
    rng = np.random.default_rng(0)
    jt, tt = JaxRadix(block_size=4), RadixPrefixCache(block_size=4)
    vocab = [1, 2, 3]  # a small alphabet: prefixes collide and forks happen
    seqs = [[int(t) for t in rng.choice(vocab, int(rng.integers(4, 20)))] for _ in range(12)]
    ref = {b: 0 for b in range(400)}
    next_block = 0
    for step in range(300):
        op = rng.integers(0, 5)
        seq = seqs[int(rng.integers(len(seqs)))]
        ns = None if rng.random() < 0.7 else (int(rng.integers(0, 2)), 0)
        if op == 0:
            n = len(seq) // 4
            blocks = list(range(next_block, next_block + n))
            next_block += n
            assert tt.insert(seq, blocks, ns=ns) == jt.insert(seq, blocks, ns=ns)
        elif op == 1:
            cap = None if rng.random() < 0.5 else (len(seq) - 1) // 4
            assert tt.match(seq, max_blocks=cap, ns=ns) == jt.match(seq, max_blocks=cap, ns=ns)
        elif op == 2:
            for b in rng.integers(0, max(1, next_block), 3):
                ref[int(b)] = int(rng.integers(0, 2))
            n = int(rng.integers(1, 6))
            assert tt.evict(n, ref) == jt.evict(n, ref)
        elif op == 3:
            b = int(rng.integers(0, max(1, next_block)))
            assert tt.holds(b) == jt.holds(b) and len(tt) == len(jt)
        elif step % 25 == 0:
            dropped = (int(rng.integers(0, 2)), 0)
            assert tt.drop_subtree(dropped, ref) == jt.drop_subtree(dropped, ref)
    assert len(tt) == len(jt) > 0


def test_radix_tree_match_insert_and_eviction_order():
    """The JAX package's own tree cases, on the port's tree: page
    granularity, the admission cap, forks, first writer wins, refcounted
    and interior nodes untouchable, LRU order."""
    t = RadixPrefixCache(block_size=4)
    toks = list(range(12))
    assert t.insert(toks, [10, 11, 12]) == [10, 11, 12]
    assert t.match(toks) == [10, 11, 12] and t.match(toks[:8]) == [10, 11]
    assert t.match(toks[:7]) == [10] and t.match([9] + toks[1:]) == []
    assert t.match(toks, max_blocks=1) == [10]
    fork = toks[:8] + [99, 98, 97, 96]
    assert t.insert(fork, [10, 11, 20]) == [20] and t.match(fork) == [10, 11, 20]
    assert t.insert(toks[:4], [33]) == [] and t.match(toks[:4]) == [10]
    t = RadixPrefixCache(block_size=2)
    ref = {b: 0 for b in range(100)}
    t.insert([1, 2, 3, 4], [5, 6])
    t.insert([7, 8], [9])
    ref[5] = 1
    assert set(t.evict(10, ref)) == {6, 9} and t.evict(10, ref) == []
    ref[5] = 0
    assert t.evict(10, ref) == [5] and len(t) == 0
    t.insert([1, 2], [70])
    t.insert([3, 4], [71])
    t.match([1, 2])
    assert t.evict(1, ref) == [71]


# ----------------------------------------------------------- engine parity

SHARED = prompt(0, 16)  # two pages at block_size 8


@pytest.mark.parametrize("kv,chunk", [("bf16", None), ("bf16", 5), ("int8", None)])
def test_prefix_cache_streams_and_counters_match_jax(models, kv, chunk):
    """Requests sharing a 16-token prefix (2 pages), with the prefix cache:
    the port's streams, step outputs and prefix counters equal the JAX
    engine's (f32 pools: margins on the JAX model; int8 pools: margins on
    the port's own logits), and equal the port's prefix-off streams; the
    later requests hit the 2 shared pages."""
    jm, tm = models
    script = [("add", "a", SHARED + [3, 7, 11], 6), ("add", "b", SHARED + [9, 1], 6),
              ("step",), ("add", "c", SHARED[:8] + [4, 4, 4, 4, 4], 5)]
    kw = dict(max_batch=2, block_size=8, num_blocks=32, decode_chunk=2, prefill_chunk=chunk,
              kv_cache_dtype=kv)
    t0 = tserving.decode_stats()
    with OwnMargins(tm) as own:
        _, teng = run_both(models, script, prefix_cache=True, **kw)
    hits = stats_delta(tserving.decode_stats, t0, PREFIX_KEYS)
    assert hits == {"prefix_hits": 2, "prefix_misses": 1, "prefix_hit_tokens": 16 + 8,
                    "prefix_evictions": 0}
    off = GenerationEngine(tm, device="cpu", **kw)
    drive(off, script)
    for rid, p in (("a", script[0][2]), ("b", script[1][2]), ("c", script[3][2])):
        assert teng.result(rid) == off.result(rid)
        if kv == "bf16":
            assert_margins(jm, p, teng.result(rid))
    if kv == "int8":
        own.check()


def test_hits_share_pages_and_refcounts(models):
    """The second admission references the first's cached pages (both
    lanes' tables point at them, refcount 2) and takes fewer fresh blocks;
    drained, the pages stay cached with refcount 0, off the free list."""
    _, tm = models
    shared = prompt(1, 24)
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           prefix_cache=True)
    eng.add_request("a", shared + [3], max_new_tokens=4)
    free_after_a = len(eng._free)
    eng.add_request("b", shared + [9], max_new_tokens=4)
    assert free_after_a - len(eng._free) == (32 - free_after_a) - 3
    block = eng._slots[0].blocks[0]
    assert eng._slots[1].blocks[0] == block and eng._ref[block] == 2
    while eng.has_work():
        eng.step()
    assert eng._ref[block] == 0 and eng._prefix.holds(block) and block not in eng._free


def test_pool_pressure_evicts_lru_then_queues_like_jax(models):
    """Admission under pressure evicts refcount-zero cached pages, least
    recently used first, in the same number as the JAX engine; when live
    requests pin every block the newcomer queues and is admitted later.
    Streams, step outputs and counters equal the JAX engine's."""
    jm, tm = models
    pa_, pb, pc = prompt(2, 16), prompt(3, 16), prompt(4, 16)
    script = [("add", "a", pa_, 4), ("step",), ("step",), ("add", "b", pb, 4), ("step",),
              ("step",), ("add", "c", pc, 4)]
    jeng, teng = run_both(models, script, max_batch=2, block_size=8, num_blocks=6,
                          prefix_cache=True, decode_chunk=4)
    assert len(teng._prefix.match(pb)) == len(jeng._prefix.match(pb)) == 2
    assert len(teng._prefix.match(pa_)) == len(jeng._prefix.match(pa_)) < 2
    for rid, p in (("a", pa_), ("b", pb), ("c", pc)):
        assert_margins(jm, p, teng.result(rid))
    r1, r2, r3 = prompt(5, 8), prompt(6, 8), prompt(7, 8)
    script = [("add", "x", r1, 4), ("add", "y", r2, 4), ("add", "z", r3, 4)]
    jeng, teng = run_both(models, script, max_batch=3, block_size=8, num_blocks=4,
                          prefix_cache=True, decode_chunk=4)
    eng = GenerationEngine(tm, max_batch=3, block_size=8, num_blocks=4, device="cpu",
                           prefix_cache=True)
    assert eng.add_request("x", r1, max_new_tokens=4) is not None
    assert eng.add_request("y", r2, max_new_tokens=4) is not None
    assert eng.add_request("z", r3, max_new_tokens=4) is None
    assert eng.pending_requests() == ["z"]
    drive(eng, [])
    assert eng.result("z") == teng.result("z") and len(eng.result("z")) == 4


@pytest.mark.parametrize("prefix", [False, True])
def test_queued_request_matches_immediate_admission(models, prefix):
    """A request queued for want of pages serves the stream an immediately
    admitted one serves, greedy and sampled (the nonce is reserved at
    submit; port against port for the sampled stream, the greedy one
    against JAX too)."""
    jm, tm = models
    p1, p2 = prompt(3, 8), prompt(4, 8)

    def run(num_blocks):
        eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=num_blocks,
                               device="cpu", prefix_cache=prefix)
        first = [eng.add_request("a", p1, max_new_tokens=6),
                 eng.add_request("b", p2, max_new_tokens=6, temperature=2.0, seed=9)]
        drive(eng, [])
        return first, eng.result("a"), eng.result("b")

    roomy, tight = run(16), run(2)
    assert tight[0][1] is None and roomy[0][1] is not None
    assert tight[1:] == roomy[1:]
    jeng = JaxEngine(jm, max_batch=2, block_size=8, num_blocks=2, prefix_cache=prefix)
    drive(jeng, [("add", "a", p1, 6)])
    assert jeng.result("a") == tight[1]
    assert_margins(jm, p1, tight[1])


# ----------------------------------------------------------- page moves


def _pages(pool, blocks):
    return [t.clone() for _, t in pa.pool_parts(pool)] if blocks is None else \
        [t[blocks].clone() for _, t in pa.pool_parts(pool)]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_adopted_pages_are_hit_with_the_donors_stream(models, kv):
    """A donor engine's cached pages (``pool_get_blocks``), adopted by a
    second engine, land verbatim and are hit by its next admission of the
    prompt, whose stream equals the donor's; a second adoption adopts
    nothing new.  Pages of another kind or geometry raise ValueError; an
    engine without the prefix cache raises RuntimeError."""
    _, tm = models
    p = prompt(8, 21)  # 2 full pages and a tail
    kw = dict(max_batch=2, block_size=8, num_blocks=16, device="cpu", kv_cache_dtype=kv,
              decode_chunk=4)
    donor = GenerationEngine(tm, prefix_cache=True, **kw)
    # the donor's own hit: the stream an adopter's hit must serve (an int8
    # hit attends the dequantized pages, a miss the raw values)
    drive(donor, [("add", "d0", p, 6), ("step",), ("step",), ("add", "d", p, 6)])
    cached = donor._prefix.match(p)
    assert len(cached) == 2
    kb = [pa.pool_get_blocks(pool, cached) for pool in donor._kpools]
    vb = [pa.pool_get_blocks(pool, cached) for pool in donor._vpools]
    eng = GenerationEngine(tm, prefix_cache=True, **kw)
    assert eng.adopt_pages(p, kb, vb) == 2 and eng.adopt_pages(p, kb, vb) == 0
    got = eng._prefix.match(p)
    for li in range(len(kb)):
        for pool, pages in ((eng._kpools[li], kb[li]), (eng._vpools[li], vb[li])):
            for (name, t) in pa.pool_parts(pool):
                assert torch.equal(t[got], pages[name])
    assert all(eng._ref[b] == 0 for b in got)
    t0 = tserving.decode_stats()
    drive(eng, [("add", "d", p, 6)])
    assert stats_delta(tserving.decode_stats, t0, ("prefix_hits", "prefix_hit_tokens")) == {
        "prefix_hits": 1, "prefix_hit_tokens": 16}
    assert eng.result("d") == donor.result("d")

    other = GenerationEngine(tm, prefix_cache=True,
                             **dict(kw, kv_cache_dtype="int8" if kv == "bf16" else "bf16"))
    with pytest.raises(ValueError, match="kind"):
        other.adopt_pages(p, kb, vb)
    short = [{k: t[:, :, :4] if k == "payload" else t for k, t in pages.items()}
             for pages in kb]
    with pytest.raises(ValueError, match="geometry"):
        eng.adopt_pages(p, short, short)
    with pytest.raises(ValueError, match="layers"):
        eng.adopt_pages(p, kb[:1], vb[:1])
    with pytest.raises(RuntimeError, match="prefix cache"):
        GenerationEngine(tm, **kw).adopt_pages(p, kb, vb)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_shared_pages_unchanged_across_a_d8_step(models, kv):
    """Two lanes reference the same cached pages; a D = 8 step in which one
    lane finishes mid-chunk (its later writes go to its scratch page)
    leaves the shared pages' bytes (payload and int8 scales) exactly as
    they were: decode writes land in each request's private tail."""
    _, tm = models
    shared = prompt(9, 16)
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           prefix_cache=True, kv_cache_dtype=kv, decode_chunk=8)
    eng.add_request("long", shared + [5, 6, 7], max_new_tokens=12)
    eng.add_request("short", shared + [9], max_new_tokens=3)  # finishes 2 tokens into the step
    blocks = eng._prefix.match(shared)
    assert len(blocks) == 2 and all(eng._ref[b] == 2 for b in blocks)
    before = [_pages(p, blocks) for p in eng._kpools + eng._vpools]
    eng.step()
    assert len(eng.result("short")) == 3 and "long" in [s.rid for s in eng._slots]
    after = [_pages(p, blocks) for p in eng._kpools + eng._vpools]
    for b, a in zip(before, after):
        for x, y in zip(b, a):
            assert torch.equal(x, y)


def test_flags_drive_the_prefix_cache_and_drop_captured_steps(models):
    """FLAGS_prefix_cache is the constructor's default; a change of it (or
    of FLAGS_prefill_chunk_blocks, FLAGS_preempt_low_priority) drops live
    engines' captured steps."""
    _, tm = models
    kw = dict(max_batch=1, block_size=8, num_blocks=8, device="cpu", decode_chunk=2)
    try:
        set_flags({"FLAGS_prefix_cache": True})
        assert GenerationEngine(tm, **kw)._prefix is not None
    finally:
        set_flags({"FLAGS_prefix_cache": False})
    eng = GenerationEngine(tm, **kw)
    assert eng._prefix is None
    eng.add_request("r", [5, 9, 2], max_new_tokens=20)
    for name, on, off in (("FLAGS_prefix_cache", True, False),
                          ("FLAGS_prefill_chunk_blocks", 1, 0),
                          ("FLAGS_preempt_low_priority", False, True)):
        eng.step()
        assert eng._step_fns
        set_flags({name: on})
        try:
            assert not eng._step_fns
        finally:
            set_flags({name: off})
    drive(eng, [])
    assert len(eng.result("r")) == 20


def test_decode_stats_keys_and_gauge_match_jax(models):
    """The port's decode_stats has the JAX package's keys (the derived two
    included); a reset zeroes the counters and keeps the parked gauge;
    pool bytes are the engine's, per device the same on one card."""
    jm, tm = models
    JaxEngine(jm, max_batch=2, block_size=8, num_blocks=16)
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=16, device="cpu")
    got, want = tserving.decode_stats(), jax_stats()
    assert set(got) == set(want)
    assert got["pool_bytes"] == got["pool_bytes_per_device"] == eng.pool_bytes() \
        == want["pool_bytes"]
    assert got["mesh_shape"] == want["mesh_shape"] == ""
    tserving._DECODE_STATS["parked_requests"] = 3
    try:
        drive(eng, [("add", "a", [5, 9, 17], 6)])
        st = tserving.decode_stats(reset=True)
        assert st["tokens"] >= 5 and st["tokens_per_sec"] > 0
        after = tserving.decode_stats()
        assert after["parked_requests"] == 3 and after["tokens"] == 0
        assert after["tokens_per_sec"] == after["pool_bytes_per_resident"] == 0.0
    finally:
        tserving._DECODE_STATS["parked_requests"] = 0
