"""The port's speculative decoding (``GenerationEngine(draft_model=)``)
against the JAX package's, greedy, on the CPU.

The engines serve the same weights (carried by load_jax_state_dict) and
the same scripted traffic.  Drafts: a separate 1-layer random model (the
JAX package's own test draft, which is never right), an early-exit draft
(the target's embedding, first layer, final norm and head), a perturbed
copy of the target (its weights plus seeded noise of a tenth of each
tensor's spread: right about half the time) and the target itself.  Step
outputs, streams, spec_stats and the serving counters must equal the JAX
engine's.  As in tests/test_torch_prefix_cache.py, token equality is
meaningful only where no greedy step's top-2 logits are closer than the
two frameworks' f32 disagreement (about 1e-5): f32 streams are checked to
win each step by more than MARGIN (1e-3) on the JAX model's full forward,
int8 streams on the port's own verify logits (``SpecMargins``).  Page
bytes are compared exactly within the port: shared pages are never
written.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import decode_stats as jax_stats

from paddle_tpu_torch import set_flags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import GenerationEngine

from test_torch_prefix_cache import assert_margins, drive, play, prompt, stats_delta
from test_torch_serving import CFG, MARGIN

K = 3
COUNTER_KEYS = ("dispatches", "tokens", "macro_steps", "prefix_hits", "prefix_misses",
                "prefix_hit_tokens")
DRAFT_CFG = dict(CFG, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                 num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_of(jm, cfg):
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return tm


@pytest.fixture(scope="module")
def models():
    """test_torch_prefix_cache's target and the drafts, each as a (JAX,
    port) pair: {"target", "separate", "early_exit", "perturbed"}."""
    cfg = dict(CFG, max_position_embeddings=128)
    exit_cfg = dict(cfg, num_hidden_layers=1)
    paddle.seed(41)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    jm.eval()
    paddle.seed(77)
    jd = jllama.LlamaForCausalLM(jllama.llama_tiny(**DRAFT_CFG))
    jd.eval()
    je = jllama.LlamaForCausalLM(jllama.llama_tiny(**exit_cfg))
    je.eval()
    jp = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    jp.eval()
    target = jm.state_dict()
    for k, v in je.state_dict().items():
        v.set_value(target[k]._value)
    rng = np.random.default_rng(1)
    for k, v in jp.state_dict().items():
        a = np.asarray(target[k]._value)
        v.set_value((a + 0.1 * a.std() * rng.standard_normal(a.shape)).astype(np.float32))
    return {name: (j, _port_of(j, c)) for name, j, c in
            (("target", jm, cfg), ("separate", jd, DRAFT_CFG), ("early_exit", je, exit_cfg),
             ("perturbed", jp, cfg))}


def _drafts(models, draft):
    """The (JAX, port) draft pair of a draft kind: "self" is the target."""
    return models["target" if draft == "self" else draft]


class SpecMargins:
    """Records the port target's greedy logits while entered: each
    admission prefill's last position, and in each tick the verify rows of
    the tokens a lane emitted.  ``check()`` asserts every recorded row's
    top-2 margin exceeds MARGIN."""

    def __init__(self, tm):
        self.tm, self.rows, self.verify = tm, [], None

    def __enter__(self):
        logits, spec = self.tm._logits, GenerationEngine._spec_step

        def spy(h):
            out = logits(h)
            if h.shape[0] == 1:          # an admission prefill's last position
                self.rows.append(out[0, -1].float())
            elif h.shape[1] == K + 1:    # the verify
                self.verify = out.float()
            return out

        def spec_spy(eng, eager):
            lanes = [s.rid if s.active else None for s in eng._slots]
            out = spec(eng, eager)
            for i, rid in enumerate(lanes):
                if rid is not None:
                    self.rows += list(self.verify[i, :len(out[rid])])
            return out

        self._spec = spec
        GenerationEngine._spec_step = spec_spy
        self.tm._logits = spy
        return self

    def __exit__(self, *exc):
        GenerationEngine._spec_step = self._spec
        del self.tm._logits

    def check(self):
        assert self.rows
        top2 = torch.topk(torch.stack(self.rows), 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def run_both(models, draft, script, **kw):
    """The same script on the JAX and the port spec engine: logs, streams,
    spec_stats and the counters equal.  Returns both engines."""
    (jm, tm), (jd, td) = models["target"], _drafts(models, draft)
    kw = dict(dict(max_batch=2, block_size=8, num_blocks=32, num_speculative_tokens=K), **kw)
    j0, t0 = jax_stats(), tserving.decode_stats()
    jeng = JaxEngine(jm, draft_model=jd, **kw)
    jlog = drive(jeng, script)
    jdelta = stats_delta(jax_stats, j0, COUNTER_KEYS)
    t1 = tserving.decode_stats()
    teng = GenerationEngine(tm, draft_model=td, device="cpu", **kw)
    tlog = drive(teng, script)
    assert tlog == jlog
    assert stats_delta(tserving.decode_stats, t1, COUNTER_KEYS) == jdelta
    assert teng.spec_stats() == jeng.spec_stats()
    for op in script:
        if op[0] == "add":
            assert teng.result(op[1]) == jeng.result(op[1])
    del t0
    return jeng, teng


def plain_streams(tm, script, **kw):
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu", **kw)
    drive(eng, script)
    return {op[1]: eng.result(op[1]) for op in script if op[0] == "add"}


P1, P2 = [5, 9, 17, 33, 2], [7, 11, 3]
JOIN = [("add", "a", P1, 9), ("step",), ("add", "b", P2, 6)]


# ------------------------------------------------------------ the layer


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_chunk_layer_matches_jax(models, kv):
    """One decoder layer on a T-token chunk against the paged pools, the
    same layer weights and inputs: hidden states within 1e-5 of the JAX
    layer, the written pages equal (f32: 1e-6 relative and absolute, the
    projections' last bit; int8: the same bytes, and scales within 1e-6
    relative); a chain config with chunk=True raises."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu._core.tensor import Tensor
    from paddle_tpu.ops import paged_attention as jpa

    jm, tm = models["target"]
    rng = np.random.default_rng(0)
    b, t, bs, nb = 2, K + 1, 8, 8
    h = rng.standard_normal((b, t, 32)).astype(np.float32)
    tables = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    lens = np.asarray([11, 7], np.int32)   # chunks at 7..10 (two pages) and 3..6
    kv_init = rng.standard_normal((nb, 2, bs, 8)).astype(np.float32)
    if kv == "int8":
        jk, jv = jpa.alloc_paged_cache(nb, 2, bs, 8, jnp.int8)
        tk, tv = pa.alloc_paged_cache(nb, 2, bs, 8, "int8")
        blocks = list(range(nb))
        jk = jpa.paged_pour_blocks(jk, jnp.asarray(kv_init), jnp.asarray(blocks))
        jv = jpa.paged_pour_blocks(jv, jnp.asarray(kv_init[::-1].copy()), jnp.asarray(blocks))
        pa.paged_pour_blocks(tk, torch.from_numpy(kv_init), blocks)
        pa.paged_pour_blocks(tv, torch.from_numpy(kv_init[::-1].copy()), blocks)
    else:
        jk, jv = jnp.asarray(kv_init), jnp.asarray(kv_init[::-1].copy())
        tk, tv = torch.from_numpy(kv_init.copy()), torch.from_numpy(kv_init[::-1].copy())
    jl, tl = jm.model.layers[0], tm.model.layers[0]

    def jax_layer(hv, k, v, tb, ln):
        out, k, v = jllama._decode_layer_paged_chunk(
            jl, Tensor(hv), jm.model.rope_cos._value, jm.model.rope_sin._value, k, v, tb, ln)
        return out._value, k, v

    # f32: the JAX layer compiled whole (one XLA program) rather than op by
    # op; int8 stays eager, since its bytes are compared bit for bit and a
    # jitted quantisation may round a scale's division differently (ROADMAP §C)
    with paddle.no_grad():
        jh, jk, jv = (jax_layer if kv == "int8" else jax.jit(jax_layer))(
            jnp.asarray(h), jk, jv, jnp.asarray(tables), jnp.asarray(lens))
    with torch.no_grad():
        th, tk2, tv2 = tllama._decode_layer_paged_chunk(
            tl, torch.from_numpy(h), tm.model.rope_cos, tm.model.rope_sin, tk, tv,
            torch.from_numpy(tables).long(), torch.from_numpy(lens).long())
    assert tk2 is tk and tv2 is tv
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    for tpool, jpool in ((tk, jk), (tv, jv)):
        if kv == "int8":
            assert np.array_equal(tpool.data.numpy(), np.asarray(jpool.data))
            np.testing.assert_allclose(tpool.scale.numpy(), np.asarray(jpool.scale), rtol=1e-6)
        else:
            np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="single-token"):
        tllama._decode_layers_paged(tm.model.layers, torch.from_numpy(h), tm.model.rope_cos,
                                    tm.model.rope_sin, [tk], [tv],
                                    torch.from_numpy(tables).long(),
                                    torch.from_numpy(lens).long(),
                                    chain_cfg={"layout": "batch"}, chunk=True)


# ---------------------------------------------------------- engine parity


@pytest.mark.parametrize("draft", ["separate", "early_exit", "perturbed"])
def test_spec_engine_matches_jax_and_the_plain_engine(models, draft):
    """A request joining mid-flight: the spec engine's step outputs, streams,
    acceptance counters and serving counters equal the JAX spec engine's,
    and its streams equal the plain engine's (greedy acceptance keeps only
    tokens the target decodes), each token winning its step by MARGIN."""
    jm, tm = models["target"]
    _, teng = run_both(models, draft, JOIN)
    assert {r: teng.result(r) for r in "ab"} == plain_streams(tm, JOIN)
    assert_margins(jm, P1, teng.result("a"))
    assert_margins(jm, P2, teng.result("b"))
    st = teng.spec_stats()
    if draft == "perturbed":
        assert 0 < st["accepted"] < st["proposed"]  # some proposals taken, some not


def test_self_draft_accepts_every_proposal(models):
    """The target as its own draft: every proposal is accepted, the stream
    is the plain engine's, and 11 post-prefill tokens take at most
    ceil(11 / (K + 1)) + 1 ticks."""
    jm, tm = models["target"]
    script = [("add", "r", P1, 12)]
    _, teng = run_both(models, "self", script)
    assert teng.result("r") == plain_streams(tm, script)["r"]
    st = teng.spec_stats()
    assert st["accepted"] == st["proposed"] > 0
    assert st["ticks"] <= -(-11 // (K + 1)) + 1
    assert_margins(jm, P1, teng.result("r"))


def test_zero_slack_geometry_writes_only_owned_pages(models):
    """Prompt 5 + 11 new tokens is exactly two pages of 8: the verify's K + 1
    overshoot lands in the headroom page the request owns (3 blocks, not
    2), never in a page it does not own; the stream is the JAX engine's
    and the plain engine's."""
    jm, tm = models["target"]
    script = [("add", "r", P1, 11)]
    _, teng = run_both(models, "self", script)
    assert teng.result("r") == plain_streams(tm, script)["r"]
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           draft_model=tm, num_speculative_tokens=K)
    eng.add_request("r", P1, max_new_tokens=11)
    owned = eng._slots[0].blocks
    assert len(owned) == 3  # -(-(16 + K + 1) // 8)
    others = [b for b in range(eng._num_blocks) if b not in owned]
    before = [t[others].clone() for p in eng._all_pools() for _, t in pa.pool_parts(p)]
    drive(eng, [])
    after = [t[others].clone() for p in eng._all_pools() for _, t in pa.pool_parts(p)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert eng.result("r") == teng.result("r")
    assert_margins(jm, P1, teng.result("r"))


def test_int8_pools_match_jax_on_the_ports_own_margins(models):
    """int8 target and draft pools (the draft's of its own geometry): the
    streams equal the JAX int8 spec engine's, every emitted token winning
    its verify row by MARGIN on the port's own logits."""
    _, tm = models["target"]
    with SpecMargins(tm) as own:
        _, teng = run_both(models, "perturbed", JOIN, kv_cache_dtype="int8")
    own.check()
    assert all(isinstance(p, pa.QuantPool) for p in teng._all_pools())
    assert teng._d_kpools[0].data.shape[1:] == (2, 8, 8)
    st = teng.spec_stats()
    assert 0 < st["accepted"] < st["proposed"]


def test_prefix_hit_leaves_both_pool_sets_shared_pages_unchanged(models):
    """Requests sharing a 16-token prefix (2 pages) on a spec engine with the
    prefix cache: the later ones hit the pages, whose bytes in the target's
    and the draft's pools are unchanged by decoding; streams and counters
    equal the JAX engine's and the prefix-off port engine's."""
    jm, tm = models["target"]
    shared = prompt(0, 16)
    script = [("add", "a", shared + [3, 7, 11], 6), ("add", "b", shared + [9, 1], 6),
              ("step",), ("add", "c", shared[:8] + [4, 4, 4, 4, 4], 5)]
    h0 = tserving.decode_stats()["prefix_hits"]
    _, teng = run_both(models, "perturbed", script, prefix_cache=True)
    assert tserving.decode_stats()["prefix_hits"] - h0 == 2
    off = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           draft_model=models["perturbed"][1], num_speculative_tokens=K)
    drive(off, script)
    for rid, p in (("a", script[0][2]), ("b", script[1][2]), ("c", script[3][2])):
        assert teng.result(rid) == off.result(rid)
        assert_margins(jm, p, teng.result(rid))

    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=32, device="cpu",
                           draft_model=models["perturbed"][1], num_speculative_tokens=K,
                           prefix_cache=True)
    play(eng, script[:2])
    blocks = eng._prefix.match(shared)
    assert len(blocks) == 2 and all(eng._ref[b] == 2 for b in blocks)
    before = [t[blocks].clone() for p in eng._all_pools() for _, t in pa.pool_parts(p)]
    assert any(t.any() for t in before[-2 * len(eng._d_kpools):])  # the draft's pages too
    drive(eng, script[2:])
    after = [t[blocks].clone() for p in eng._all_pools() for _, t in pa.pool_parts(p)]
    assert all(torch.equal(x, y) for x, y in zip(before, after))


# ------------------------------------------------------------- refusals


def test_refusals_and_counters_match_jax(models):
    """A sampled request raises before anything is allocated;
    num_speculative_tokens < 1 and a draft of another vocabulary raise;
    adopt_pages raises RuntimeError; spec engines admit atomically, never
    preempt and warm no macro-step; spec_stats has the JAX keys (None on a
    plain engine); a tick counts K + 2 dispatches."""
    (jm, tm), (jd, td) = models["target"], models["separate"]
    kw = dict(max_batch=2, block_size=8, num_blocks=32, num_speculative_tokens=K)
    jeng = JaxEngine(jm, draft_model=jd, **kw)
    eng = GenerationEngine(tm, draft_model=td, device="cpu", prefix_cache=True,
                           prefill_chunk_blocks=2, **kw)
    free = list(eng._free)
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="greedy-only"):
            e.add_request("s", P1, max_new_tokens=4, temperature=0.7)
    assert eng._free == free and not eng.has_work()
    with pytest.raises(ValueError, match=">= 1"):
        GenerationEngine(tm, draft_model=td, device="cpu", max_batch=2, block_size=8,
                         num_blocks=32, num_speculative_tokens=0)
    other = tllama.LlamaForCausalLM(tllama.llama_tiny(**dict(DRAFT_CFG, vocab_size=64)),
                                    device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        GenerationEngine(tm, draft_model=other, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="speculative"):
        eng.adopt_pages([1] * 8, [], [])
    assert eng._prefill_chunk_blocks() == 0 and eng._preempt_one() is False
    assert eng.warmup()["chunks"] == [] and eng._step_fns == {} and eng._spec_fn is None
    assert set(eng.spec_stats()) == set(jeng.spec_stats()) == {
        "ticks", "proposed", "accepted", "emitted"}
    assert GenerationEngine(tm, max_batch=1, block_size=8, num_blocks=8,
                            device="cpu").spec_stats() is None
    t0 = tserving.decode_stats()
    assert eng.add_request("a", P1, max_new_tokens=9) is not None  # atomic: admitted now
    out = eng.step()
    assert isinstance(out["a"], list) and 1 <= len(out["a"]) <= K + 1
    assert stats_delta(tserving.decode_stats, t0, ("dispatches", "macro_steps")) == {
        "dispatches": K + 2, "macro_steps": 1}
    assert eng._spec_fn is not None
    set_flags({"FLAGS_decode_chunk": 4})  # a flag change drops the captured tick
    try:
        assert eng._spec_fn is None
    finally:
        set_flags({"FLAGS_decode_chunk": 8})
    drive(eng, [])
    assert eng.result("a") == plain_streams(tm, [("add", "a", P1, 9)])["a"]
    assert eng.decode_decision is None  # spec engines never resolve a decode chain
