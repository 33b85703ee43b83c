"""The port's int8 and chunked-prefill GenerationEngines against the JAX
package's, and the port's chained engine against its unchained one,
greedy, f32, on the CPU.

Both packages serve the same weights (carried by load_jax_state_dict) and
the same scripted traffic; their streams and step outputs must be equal,
as in tests/test_torch_serving.py, whose model and margin check this file
reuses (with a longer rope table).  For int8 pools the margins are
checked on the port's own int8 decode logits.  The pools after the run
are held close, not equal: their K/V come out of two frameworks' f32
projections (the ops' bit-equality is tests/test_torch_decode_chain.py's).

The chained engine (FLAGS_schedule_search, decisions through
``measure_override``) runs ``fused_decode_step`` and
``fused_prefill_attention``, whose plain versions on the CPU are the
unchained ops, so its streams equal the unchained engine's bit for bit;
the tests check which verdicts it reached and where it ran them.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import GenerationEngine as JaxEngine

from paddle_tpu_torch import set_flags
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import autotune as at
from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.static import schedule_search as ss

from test_torch_decode_chain import _arrays
from test_torch_serving import CFG, MARGIN, _drive

CHUNK = 64  # the prefill chain tiles chunks of 64 or 128 query rows
LONG = [int(t) for t in np.random.default_rng(9).integers(1, 128, 150)]  # 2 chunks and a tail
PAD_LEN = 192


@pytest.fixture(scope="module")
def tiny():
    """test_torch_serving's model, with a rope table long enough for LONG."""
    cfg = dict(CFG, max_position_embeddings=256)
    paddle.seed(41)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def _assert_margins(jm, prompt, stream):
    """Every greedy token of ``stream`` won its step by more than MARGIN on
    the JAX model's full-precision forward (test_torch_serving's check at
    a longer pad)."""
    seq = list(prompt) + list(stream[:-1])
    ids = np.zeros((1, PAD_LEN), np.int32)
    ids[0, :len(seq)] = seq
    logits = np.asarray(jm(paddle.to_tensor(ids))._value)[0, len(prompt) - 1:len(seq)]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert np.argmax(logits, -1).tolist() == list(stream)
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


def _assert_pools_close(jpool, tpool):
    """The engines' pools after a run.  Their K/V come from two frameworks'
    projections and rope (f32, about 1e-7 apart), so they are close, not
    equal: f32 pools within 2e-5; int8 scales within 1e-5 relative and
    payloads within one quantization step."""
    a, b = _arrays(jpool), _arrays(tpool)
    if len(a) == 1:
        np.testing.assert_allclose(b[0], a[0], atol=2e-5, rtol=2e-5)
        return
    np.testing.assert_allclose(b[1], a[1], rtol=1e-5, atol=0)
    assert np.abs(a[0].astype(np.int32) - b[0].astype(np.int32)).max() <= 1


def _engines(models_, **kw):
    jm, tm = models_
    return JaxEngine(jm, **kw), GenerationEngine(tm, device="cpu", **kw)


@pytest.mark.parametrize("kw,script", [
    (dict(kv_cache_dtype="int8"),
     [("add", "a", [5, 9, 17, 33, 2], 9), ("step",), ("add", "b", [7, 11, 3], 6)]),
    (dict(prefill_chunk=CHUNK), [("add", "p", LONG, 8), ("add", "s", [4, 8, 15], 5)]),
    (dict(kv_cache_dtype="int8", prefill_chunk=CHUNK),
     [("add", "p", LONG, 8), ("step",), ("add", "s", [4, 8, 15], 5)]),
])
def test_engine_matches_jax(tiny, kw, script):
    jeng, teng = _engines(tiny, max_batch=2, block_size=8, num_blocks=64, decode_chunk=4, **kw)
    jlog, tlog = _drive(jeng, script), _drive(teng, script)
    assert tlog == jlog
    prompts = {op[1]: op[2] for op in script if op[0] == "add"}
    for rid, prompt in prompts.items():
        assert teng.result(rid) == jeng.result(rid)
        if kw.get("kv_cache_dtype") != "int8":
            _assert_margins(tiny[0], prompt, jeng.result(rid))
    for jp, tp in zip(jeng._kpools + jeng._vpools, teng._kpools + teng._vpools):
        _assert_pools_close(jp, tp)


def test_int8_engine_margins_on_its_own_logits(tiny):
    """The int8 streams compared above are not won by a hair: every greedy
    step of the port's int8 engine wins by more than 1e-3 on its own
    logits."""
    _, tm = tiny
    eng = GenerationEngine(tm, max_batch=1, block_size=8, num_blocks=16, device="cpu",
                           kv_cache_dtype="int8", decode_chunk=1)
    eng.add_request("a", [5, 9, 17, 33, 2], max_new_tokens=9)
    seen = []
    logits = tm._logits

    def spy(h):
        out = logits(h)
        seen.append(out[:, -1].float())
        return out

    tm._logits = spy
    try:
        while eng.has_work():
            eng.step()
    finally:
        del tm._logits
    for lg in seen:
        top2 = torch.topk(lg[0], 2).values
        assert float(top2[0] - top2[1]) > MARGIN


def test_int8_pools_hold_half_the_bytes(tiny):
    _, tm = tiny
    kw = dict(max_batch=2, block_size=8, num_blocks=16, device="cpu")
    full = GenerationEngine(tm, **kw).pool_bytes()
    int8 = GenerationEngine(tm, kv_cache_dtype="int8", **kw).pool_bytes()
    # f32 model: 4 bytes an element against 1, plus one f32 scale a page;
    # 16 pool blocks and 2 scratch pages, 2 layers, Nkv 2, head_dim 8
    blocks, layers, nkv, bs, h = 16 + 2, 2, 2, 8, 8
    assert full == 2 * layers * blocks * nkv * bs * h * 4
    assert int8 == 2 * layers * blocks * nkv * (bs * h + 4)


# ------------------------------------------------------- the chained engine


@pytest.fixture()
def search(tmp_path):
    set_flags({"FLAGS_autotune_cache_dir": str(tmp_path)})
    at._CACHES.clear()
    ss.reset_schedule_search_stats()
    tserving.reset_schedule_decode_stats()
    yield tmp_path
    set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
    at._CACHES.clear()
    ss.reset_schedule_search_stats()
    tserving.reset_schedule_decode_stats()


def _win(fn, args, *, label, config):
    return 0.4 if config is not None else 1.0


def _lose(fn, args, *, label, config):
    return 4.0 if config is not None else 1.0


def _serve(tm, **kw):
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=64, device="cpu",
                           decode_chunk=4, **kw)
    eng.add_request("p", LONG, max_new_tokens=8)
    eng.add_request("s", [4, 8, 15], max_new_tokens=6)
    while eng.has_work():
        eng.step()
    return eng, {"p": eng.result("p"), "s": eng.result("s")}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_chained_engine_matches_unchained(tiny, search, monkeypatch, kv):
    _, tm = tiny
    _, want = _serve(tm, kv_cache_dtype=kv, prefill_chunk=CHUNK)
    calls = {"decode": 0, "prefill": 0}
    decode, prefill = dc.fused_decode_step, dc.fused_prefill_attention

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return wrapped

    monkeypatch.setattr(dc, "fused_decode_step", count("decode", decode))
    monkeypatch.setattr(dc, "fused_prefill_attention", count("prefill", prefill))
    set_flags({"FLAGS_schedule_search": True})
    with ss.measure_override(_win):
        eng, got = _serve(tm, kv_cache_dtype=kv, prefill_chunk=CHUNK)
    assert got == want
    stats = tserving.schedule_decode_stats()
    assert stats["decode_chains_found"] == 1 and stats["decode_chains_accepted"] == 1
    assert stats["prefill_chains_found"] == 1 and stats["prefill_chains_accepted"] == 1
    assert eng.decode_decision.status == "accepted" and eng.decode_decision.win == 2.5
    assert eng._prefill_chain_cfg == {"block_q": 64}
    # 150 tokens in chunks of 64: two 64-token chunks run the prefill chain
    # (the 22-token tail keeps flash attention), in each of the 2 layers;
    # every decode token of every layer runs the decode chain
    assert calls["prefill"] == 2 * 2
    # 7 decode tokens of "p" take two macro-steps of D = 4 token iterations
    assert calls["decode"] == 2 * 2 * 4


def test_losing_verdicts_keep_the_plain_ops(tiny, search, monkeypatch):
    _, tm = tiny
    _, want = _serve(tm, kv_cache_dtype="int8", prefill_chunk=CHUNK)

    def refuse(*a, **k):
        raise AssertionError("a disabled chain ran")

    monkeypatch.setattr(dc, "fused_decode_step", refuse)
    monkeypatch.setattr(dc, "fused_prefill_attention", refuse)
    set_flags({"FLAGS_schedule_search": True})
    with ss.measure_override(_lose):
        eng, got = _serve(tm, kv_cache_dtype="int8", prefill_chunk=CHUNK)
    assert got == want
    stats = tserving.schedule_decode_stats()
    assert stats["decode_chains_disabled"] == 1 and stats["prefill_chains_disabled"] == 1
    assert eng._decode_chain_cfg is None and eng._prefill_chain_cfg is None


def test_cold_reload_serves_with_zero_measurements(tiny, search):
    _, tm = tiny
    set_flags({"FLAGS_schedule_search": True})
    with ss.measure_override(_win):
        _, want = _serve(tm, kv_cache_dtype="int8", prefill_chunk=CHUNK)
    at._CACHES.clear()
    tserving.reset_schedule_decode_stats()
    ss.reset_schedule_search_stats()
    calls = []

    def counting(fn, args, *, label, config):
        calls.append(config)
        return 1.0

    with ss.measure_override(counting):
        eng, got = _serve(tm, kv_cache_dtype="int8", prefill_chunk=CHUNK)
    assert calls == [] and got == want
    assert eng.decode_decision.status == "cache" and eng.prefill_decision.status == "cache"
    assert ss.schedule_search_stats()["cache_hits"] == 2


def test_flag_change_rearms_engine_verdicts(tiny, search):
    _, tm = tiny
    set_flags({"FLAGS_schedule_search": True})
    with ss.measure_override(_win):
        eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=16, device="cpu",
                               decode_chunk=2, kv_cache_dtype="int8")
        eng.add_request("a", [5, 9, 17], max_new_tokens=6)
        eng.step()
        assert eng._decode_chain_cfg == {"layout": "batch"}
        set_flags({"FLAGS_schedule_search": False})
        assert eng._decode_chain_cfg is tserving._CHAIN_UNSET
        while eng.has_work():
            eng.step()
        assert eng._decode_chain_cfg is None
    assert len(eng.result("a")) == 6
