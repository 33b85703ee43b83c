"""The port's compiled steps on the CPU: the engine's captured macro-step
and ``warmup()``, the counter-based sampler inside the step, the
Executor's captured runs and the launch-credit rule of
``_core/graphs.py``.

On the CPU a captured step keeps its body and runs it eagerly (the card
records it as a CUDA graph; ``tests/test_torch_cuda.py`` holds the graph
against the eager body there).  ``warmup()`` is held to the JAX engine's
contract (``tests/test_cluster_warm.py``), greedy streams to the JAX
engine on the same weights (f32, tiny LLaMA; both run the same
arithmetic on the CPU, deterministically), the Executor's fetches to
the JAX Executor at two feed shapes (f32, 2e-5: sums in other orders).
Sampled streams are checked port against port: the two packages'
generators differ.
"""

import weakref

import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import GenerationEngine as JaxEngine

from paddle_tpu_torch import ops
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch._core import graphs
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.serving import GenerationEngine, sampling
from _torch_threads import _one_thread  # noqa: F401

F32_TOL = 2e-5
CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           dtype="float32")
ENGINE = dict(max_batch=2, block_size=8, num_blocks=16)


@pytest.fixture(scope="module")
def models():
    paddle.seed(43)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**CFG))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**CFG), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def _engine(tm, **kw):
    return GenerationEngine(tm, device="cpu", **{**ENGINE, **kw})


def _serve(eng, reqs):
    """Submit ``reqs`` — (rid, prompt, kwargs) — then step until idle;
    returns the streams and every step's output."""
    for rid, prompt, kw in reqs:
        eng.add_request(rid, prompt, **kw)
    log = []
    while eng.has_work():
        log.append(eng.step())
    return {rid: eng.result(rid) for rid, _, _ in reqs}, log


REQS = [("a", [5, 9, 17, 33, 2, 8, 7], dict(max_new_tokens=9)),
        ("b", [7, 11, 3], dict(max_new_tokens=6, temperature=0.8, seed=3))]


# ------------------------------------------------------------------ warmup


def test_warmup_reports_and_step_dispatches_the_warmed_entry(models):
    eng = _engine(models[1], decode_chunk=4)
    assert eng._step_fns == {}
    rep = eng.warmup()
    assert rep["chunks"] == [4] and rep["seconds"] > 0
    warmed = eng._step_fns[4]
    streams, _ = _serve(eng, REQS)
    assert all(streams.values())
    # identity: serving dispatched the warmed step, it did not rebuild one
    assert eng._step_fns[4] is warmed and set(eng._step_fns) == {4}


def test_warmup_extra_chunks_and_validation(models):
    eng = _engine(models[1])
    rep = eng.warmup(chunks=[2, 1, 2], prefill=False)
    assert rep["chunks"] == [1, 2] and set(eng._step_fns) == {1, 2}
    with pytest.raises(ValueError):
        eng.warmup(chunks=[0])
    assert set(eng._step_fns) == {1, 2}
    assert eng.warmup(chunks=[1], adopt=False)["chunks"] == [1]


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_warmed_greedy_streams_equal_lazy_and_jax(models, decode_chunk):
    """Two greedy requests, one stopping at an EOS inside a chunk: the
    warmed engine, a lazily built one and the JAX engine agree step by
    step."""
    jm, tm = models
    probe, _ = _serve(_engine(tm), [("e", [5, 9], dict(max_new_tokens=6))])
    # the first token new to the stream after two: "e" stops mid-chunk at D 4
    stop = next(k for k in range(2, 6) if probe["e"][k] not in probe["e"][:k])
    eos = probe["e"][stop]
    reqs = [("e", [5, 9], dict(max_new_tokens=6)), ("f", [7, 1, 4], dict(max_new_tokens=7))]
    kw = dict(decode_chunk=decode_chunk, eos_token_id=eos)
    warm_eng = _engine(tm, **kw)
    warm_eng.warmup()
    warm, warm_log = _serve(warm_eng, reqs)
    lazy, lazy_log = _serve(_engine(tm, **kw), reqs)
    jax, jax_log = _serve(JaxEngine(jm, **ENGINE, **kw), reqs)
    assert warm == lazy == jax and warm_log == lazy_log == jax_log
    assert warm["e"] == probe["e"][:stop + 1] and len(warm["f"]) > stop + 1


def test_warmup_leaves_the_shared_pool_alone(models):
    """The card's warm-up call runs the body with every lane idle: on an
    engine with live requests it writes scratch pages only.  Then the
    engine serves on as one that never warmed."""
    tm = models[1]
    eng, ref = _engine(tm, decode_chunk=2), _engine(tm, decode_chunk=2)
    for e in (eng, ref):
        for rid, prompt, kw in REQS:
            e.add_request(rid, prompt, **kw)
        e.step()
    shared = slice(0, eng._num_blocks)
    pools = eng._kpools + eng._vpools
    before = [p.clone() for p in pools]
    eng._fill_inputs(idle=True)
    eng._decode_body(3)()  # what the card's capture runs first
    eng.warmup(chunks=[1, 2, 3])
    for b, p in zip(before, pools):
        assert torch.equal(p[shared], b[shared])
    assert any(not torch.equal(p[eng._num_blocks:], b[eng._num_blocks:])
               for b, p in zip(before, pools))  # the body did run, on the scratch pages
    got = _serve(eng, [])
    want = _serve(ref, [])
    assert got == want
    assert {rid: eng.result(rid) for rid, _, _ in REQS} == {
        rid: ref.result(rid) for rid, _, _ in REQS}


# ----------------------------------------------------------------- sampler


def _sampled_stream(tm, before, decode_chunk, seed=3, max_batch=2):
    """The stream of a sampled request submitted second (its nonce is 1),
    after ``before``: a greedy request that holds lane 0 ("g"), or one
    that finishes at admission and frees it ("x")."""
    first = {"g": ("g", [7, 11], dict(max_new_tokens=5)),
             "x": ("x", [7, 11], dict(max_new_tokens=1))}[before]
    s = ("s", [5, 9, 17], dict(max_new_tokens=9, temperature=0.9, seed=seed))
    eng = _engine(tm, decode_chunk=decode_chunk, max_batch=max_batch)
    streams, _ = _serve(eng, [first, s])
    return streams["s"]


def test_sampled_stream_depends_only_on_seed_and_counter(models):
    """Same seed and nonce: the same stream in lane 1 at D 1, in lane 0 at
    D 4, and queued behind a request that holds the only lane."""
    tm = models[1]
    first = _sampled_stream(tm, "g", 1)
    assert len(first) == 9
    assert _sampled_stream(tm, "x", 4) == first
    assert _sampled_stream(tm, "g", 4, max_batch=1) == first
    assert _sampled_stream(tm, "g", 4, seed=4) != first


def test_sampler_frequencies_match_the_softmax():
    """20,000 counters of one key over a fixed 16-token row at T 0.7, in
    one call: the token frequencies match softmax(logits / T)."""
    n, t = 20000, 0.7
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal(16).astype(np.float32))
    got = sampling.sample(logits.expand(n, 16), torch.full((n,), t),
                          torch.full((n,), 0x1234_5678_9ABC, dtype=torch.int64),
                          torch.arange(n), sampling.vocab_hash(16, "cpu"))
    counts = np.bincount(got.numpy(), minlength=16)
    want = n * torch.softmax(logits.double() / t, -1).numpy()
    assert stats.chisquare(counts, want).pvalue > 1e-3


def test_sampler_uniforms_and_greedy_rows():
    """Uniforms lie strictly inside (0, 1) at the extremes of the key and
    counter ranges, differ between counters and keys, and greedy rows take
    the argmax in the same call."""
    vh = sampling.vocab_hash(64, "cpu")
    keys = torch.tensor([0, 2 ** 63 - 1, 5, 5], dtype=torch.int64)
    counters = torch.tensor([0, 2 ** 32 - 1, 0, 1], dtype=torch.int64)
    u = sampling.uniforms(keys, counters, vh)
    assert u.dtype == torch.float32 and bool(((u > 0) & (u < 1)).all())
    assert len({tuple(r) for r in u.tolist()}) == 4
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(2))
    got = sampling.sample(logits, torch.tensor([0.0, 1.0, 0.0, 2.0]), keys, counters, vh)
    assert got[0] == logits[0].argmax() and got[2] == logits[2].argmax()


# ---------------------------------------------------------------- executor


def _linear_gelu_programs():
    """``gelu(x @ W + b)`` over ``x [-1, 8]`` in both packages, same weights."""
    paddle.seed(11)
    jlin = jnn.Linear(8, 16)
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        jout = jF.gelu(jlin(jstatic.data("x", [-1, 8], "float32")))
    tlin = Linear(8, 16, device="cpu")
    load_jax_state_dict(tlin, {k: np.asarray(v._value) for k, v in jlin.state_dict().items()})
    tprog = tstatic.Program()
    with tstatic.program_guard(tprog):
        tout = tF.gelu(tlin(tstatic.data("x", [-1, 8], "float32")))
    return (jprog, jout), (tprog, tout)


def test_executor_key_holds_the_feed_signature():
    """One program at two feed shapes: the JAX Executor's fetches at both,
    one cache entry per signature, the caller's fetches never overwritten
    by a later run."""
    (jprog, jout), (tprog, tout) = _linear_gelu_programs()
    rng = np.random.default_rng(12)
    exe = tstatic.Executor("cpu")
    feeds = [rng.standard_normal((rows, 8)).astype(np.float32) for rows in (3, 5)]
    wants = [jstatic.Executor().run(jprog, feed={"x": xv}, fetch_list=[jout])[0]
             for xv in feeds]
    held = []
    for xv, want in zip(feeds + feeds[:1], wants + wants[:1]):
        (got,) = exe.run(tprog, feed={"x": xv}, fetch_list=[tout])
        (got_t,) = exe.run(tprog, feed={"x": xv}, fetch_list=[tout], return_numpy=False)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        held.append((got, got_t, got_t.clone()))
    assert "matmul_epilogue" in [op.type for op in tprog.global_block().ops]
    assert len(exe._cache) == 2
    for got, got_t, copy in held:
        assert torch.equal(got_t, copy) and np.array_equal(got, copy.numpy())
    assert held[0][1].data_ptr() != held[2][1].data_ptr()
    ones = {"x": np.ones((3, 8), np.float32)}
    (eager,) = exe._run_eager(tprog, feed=ones, fetch_list=[tout])
    (replayed,) = exe.run(tprog, feed=ones, fetch_list=[tout], return_numpy=False)
    assert torch.equal(eager, replayed) and len(exe._cache) == 2


def test_executor_writes_state_in_place_and_spares_the_parameter():
    """A program that writes state: each run reads the state the last one
    wrote (in the scope's tensor, in place), the parameter it came from
    stays as it was."""
    w = torch.nn.Parameter(torch.ones(4))
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [4], "float32")
        new_w = w + x
    prog.add_write(prog.param_vars[id(w)], new_w)
    scope = tstatic.Scope()
    exe = tstatic.Executor("cpu")
    outs = [exe.run(prog, feed={"x": np.full(4, 2.0, np.float32)}, fetch_list=[new_w],
                    scope=scope)[0] for _ in range(3)]
    held = scope.find_var(prog.param_vars[id(w)]._vid)
    assert [o[0] for o in outs] == [3.0, 5.0, 7.0]
    assert torch.equal(held, torch.full((4,), 7.0)) and torch.equal(w.detach(), torch.ones(4))
    assert held is scope.find_var(prog.param_vars[id(w)]._vid)


def test_program_function_drops_values_after_their_last_read():
    """A run keeps only live values (what a captured run's memory pool then
    holds): an intermediate is gone once its last reader ran, before the
    run ends; fetched values stay."""
    refs, seen = [], []

    def double(t):
        out = t * 2
        refs.append(weakref.ref(out))
        return out

    def probe(t):
        seen.append(refs[-1]() is None)  # is the doubled value freed by now?
        return t - 1

    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [4], "float32")
        y = prog.record("double", double, [x], {})
        z = prog.record("probe", probe, [y + 1], {})
    for fetch, freed in (([z._vid], True), ([y._vid, z._vid], False)):
        refs.clear()
        seen.clear()
        fetches, _ = prog.as_function(fetch)[0]([torch.ones(4)], [])
        assert seen == [freed] and torch.equal(fetches[-1], torch.full((4,), 2.0))


# --------------------------------------------------------- launch credit


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _counted_body(calls):
    def body():
        calls.append(1)
        ops.count_launch("swiglu")
        ops.count_launch("fused_rms_norm")
        ops.count_launch("fused_rms_norm")
        ops.count_yardstick("swiglu_triton")
        return "out"
    return body


def test_replays_credit_the_warm_up_launches(monkeypatch):
    """The bookkeeping of ``graphs.capture`` with a stub for the CUDA
    graph: the warm-up counts, the recording counts nothing, every replay
    credits the warm-up's launches."""
    stub, calls = _StubGraph(), []
    monkeypatch.setattr(graphs, "_warm", lambda fn, device: fn())
    monkeypatch.setattr(graphs, "_record", lambda fn, device: (stub, fn(), 0))
    ops.reset_launch_counts()
    try:
        cap = graphs.capture(_counted_body(calls), "cuda")
        assert len(calls) == 2 and cap.warm_outputs == "out"
        one = {"swiglu": 1, "fused_rms_norm": 2}
        assert {k: v for k, v in ops.launch_counts().items() if v} == one
        for n in (1, 2, 3):
            assert cap.replay() == "out"
            assert {k: v for k, v in ops.launch_counts().items() if v} == {
                k: v * (n + 1) for k, v in one.items()}
            assert ops.yardstick_counts()["swiglu_triton"] == n + 1
        assert stub.replays == 3 and len(calls) == 2
    finally:
        ops.reset_launch_counts()


def test_a_recording_that_launches_other_kernels_raises(monkeypatch):
    calls = []
    body = _counted_body(calls)

    def record(fn, device):
        fn()
        ops.count_launch("swiglu")  # one launch the warm-up did not make
        return _StubGraph(), None, 0

    monkeypatch.setattr(graphs, "_warm", lambda fn, device: fn())
    monkeypatch.setattr(graphs, "_record", record)
    ops.reset_launch_counts()
    try:
        with pytest.raises(RuntimeError, match="other kernels"):
            graphs.capture(body, "cuda")
        assert ops.launch_counts()["swiglu"] == 1  # the recording's counts undone
    finally:
        ops.reset_launch_counts()


def test_cpu_capture_keeps_the_body():
    calls = []
    cap = graphs.capture(_counted_body(calls), "cpu")
    assert calls == [] and cap.warm_outputs is None
    assert cap.replay() == "out" and cap.replay() == "out" and len(calls) == 2
