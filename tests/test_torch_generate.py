"""The port's model-level ``LlamaForCausalLM.generate`` against the JAX
package's, on the CPU, in f32.

Each pair of models holds the same weights (the JAX model built from a
seed, carried into the port by ``load_jax_state_dict``): a narrowed
``llama_tiny`` (hidden 32, 2 layers) with 4 heads, and its GQA twin with 2
KV heads.  Greedy, beam and speculative tokens must equal the JAX
package's.  Token equality is meaningful where no step's top-2 logits are
closer than the two frameworks' f32 disagreement (about 1e-5): every
greedy stream held against the JAX package here is first checked to win
each step by more than MARGIN on the port's own logits.  Sampled tokens
come from another generator than JAX's threefry, so they are checked
port against port: bit-identical across ``decode_chunk`` and between the
naive and paged caches for one seed.  The top-k / top-p filter is held
against the JAX package's own jnp expressions on the same logits, within
1e-6 (f32 softmax and cumsum summed in other orders).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu._core.tensor import Tensor
from paddle_tpu.models import llama as jllama

from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import llama as tllama

MARGIN = 1e-3
FILTER_TOL = 1e-6
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
           dtype="float32")
SAMPLED = dict(do_sample=True, temperature=1.5, top_k=20, top_p=0.9, seed=3)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _compiled_reference_forward(monkeypatch):
    """The JAX package's cached forward (``generate``'s prefill and every
    naive-cache, beam and speculative step) compiled whole, one XLA
    program a shape, rather than op by op: the same hidden states within
    ~1e-6, far inside the MARGIN that every compared greedy step wins by,
    in a fraction of the time.  Made anew for each test, so no trace
    outlives the state it was made under."""
    plain, compiled = jllama._model_forward_cached, {}

    def forward(model, input_ids, caches, position_offset=0):
        fn = compiled.get(id(model))
        if fn is None:
            def pure(ids, cache_values, offset):
                h, new = plain(model, Tensor(ids),
                               [(Tensor(k), Tensor(v)) for k, v in cache_values], offset)
                return h._value, [(k._value, v._value) for k, v in new]

            fn = compiled[id(model)] = jax.jit(pure, static_argnums=2)
        h, new = fn(input_ids._value, [(k._value, v._value) for k, v in caches],
                    int(position_offset))
        return Tensor(h), [(Tensor(k), Tensor(v)) for k, v in new]

    monkeypatch.setattr(jllama, "_model_forward_cached", forward)


def _pair(seed, **over):
    cfg = dict(CFG, **over)
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {"mha": _pair(11), "gqa": _pair(12, num_key_value_heads=2)}


def _ids(rows=2, seed=0, s=5):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (rows, s)).astype(np.int32)


def _jgen(jm, ids, **kw):
    with paddle.no_grad():
        return np.asarray(jm.generate(paddle.to_tensor(ids), **kw)._value).astype(np.int64)


def _tgen(tm, ids, **kw):
    return tm.generate(torch.from_numpy(ids), **kw).numpy()


def _assert_margins(tm, ids, stream):
    """Every greedy step of ``stream`` wins by more than MARGIN on the
    port's own logits (a forward over the prompt and the stream so far)."""
    full = torch.from_numpy(np.concatenate([ids, stream], axis=1).astype(np.int64))
    with torch.no_grad():
        lg = tm(full)[:, ids.shape[1] - 1:-1].float()
    top2 = lg.topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    assert gap > MARGIN, f"a greedy step is a near-tie ({gap}): tokens cannot be compared"


@pytest.mark.parametrize("heads", ["mha", "gqa"])
def test_greedy_naive_and_paged_match_reference(pairs, heads):
    """The JAX package's test_paged_matches_naive_decode, held across the
    two packages: naive and paged greedy tokens, each equal to JAX's (6
    new tokens after a 5-token prompt: the paged cache crosses into its
    second 8-slot block)."""
    jm, tm = pairs[heads]
    ids = _ids()
    want = _jgen(jm, ids, max_new_tokens=6, cache="naive")
    np.testing.assert_array_equal(_jgen(jm, ids, max_new_tokens=6, block_size=8), want)
    _assert_margins(tm, ids, want)
    naive = _tgen(tm, ids, max_new_tokens=6, cache="naive")
    paged = _tgen(tm, ids, max_new_tokens=6, block_size=8)
    assert naive.shape == (2, 6) and naive.dtype == np.int64
    np.testing.assert_array_equal(naive, want)
    np.testing.assert_array_equal(paged, want)


@pytest.mark.parametrize("chunk", [1, 4, 8])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_decode_chunks_bit_identical(pairs, chunk, mode):
    """decode_chunk 1, 4 and 8 with 10 new tokens (9 after the prefill's:
    a tail chunk of 1 at D 4 and 8): the port's streams equal its naive
    decode bit for bit; greedy ones also equal the JAX package's paged
    decode at the same D.  A chunk size the call runs more than once is
    recorded once (D 1 and 4); a single D chunk (D 8) and the tail run
    through the eager body, which gives the same stream."""
    jm, tm = pairs["mha"]
    ids = _ids(seed=1)
    kw = SAMPLED if mode == "sampled" else {}
    got = _tgen(tm, ids, max_new_tokens=10, block_size=4, decode_chunk=chunk, **kw)
    full = 9 // chunk
    want = {chunk: {"replays": full}} if full > 1 else {}  # the CPU runs every chunk as a replay
    assert {d: {"replays": r["replays"]} for d, r in tm._decode_recordings.items()} == want
    np.testing.assert_array_equal(got, _tgen(tm, ids, max_new_tokens=10, cache="naive", **kw))
    eager = tm._generate_eager(torch.from_numpy(ids), max_new_tokens=10, block_size=4,
                               decode_chunk=chunk, **kw).numpy()
    np.testing.assert_array_equal(eager, got)
    if mode == "greedy":
        want = _jgen(jm, ids, max_new_tokens=10, block_size=4, decode_chunk=chunk)
        _assert_margins(tm, ids, want)
        np.testing.assert_array_equal(got, want)


def test_decode_chunk_flag_and_checks(pairs):
    """decode_chunk=None reads FLAGS_decode_chunk (0 clamps to 1); an
    explicit value below 1 raises before the prefill."""
    from paddle_tpu_torch import get_flags, set_flags

    _, tm = pairs["mha"]
    ids = _ids()
    prev = get_flags(["FLAGS_decode_chunk"])["FLAGS_decode_chunk"]
    try:
        set_flags({"FLAGS_decode_chunk": 0})
        got = _tgen(tm, ids, max_new_tokens=5)
        assert set(tm._decode_recordings) == {1}
        set_flags({"FLAGS_decode_chunk": 2})
        np.testing.assert_array_equal(_tgen(tm, ids, max_new_tokens=5), got)
        assert set(tm._decode_recordings) == {2}
    finally:
        set_flags({"FLAGS_decode_chunk": prev})


def test_sampling_surface(pairs):
    """The JAX package's test_generate_sampling_surface, port against port:
    deterministic per seed, naive equal to paged per seed, varying across
    seeds, top_p sampling through decode_strategy, greedy leaving torch's
    RNG untouched, seed=None drawing one key from the generator given."""
    _, tm = pairs["mha"]
    ids = _ids(rows=1)
    s1 = _tgen(tm, ids, max_new_tokens=6, cache="naive", do_sample=True, temperature=1.5, seed=3)
    s2 = _tgen(tm, ids, max_new_tokens=6, cache="naive", do_sample=True, temperature=1.5, seed=3)
    np.testing.assert_array_equal(s1, s2)
    p1 = _tgen(tm, ids, max_new_tokens=6, block_size=8, do_sample=True, temperature=1.5, seed=3)
    np.testing.assert_array_equal(p1, s1)
    outs = {tuple(_tgen(tm, ids, max_new_tokens=6, cache="naive", do_sample=True,
                        temperature=2.0, seed=s).ravel()) for s in range(6)}
    assert len(outs) > 1
    n1 = _tgen(tm, ids, max_new_tokens=6, cache="naive", do_sample=True, top_p=0.8, seed=9)
    n2 = _tgen(tm, ids, max_new_tokens=6, cache="naive", decode_strategy="sampling",
               top_p=0.8, seed=9)
    np.testing.assert_array_equal(n1, n2)
    # rows of one call draw from their own keys
    two = _tgen(tm, np.repeat(ids, 2, axis=0), max_new_tokens=6, cache="naive",
                do_sample=True, temperature=2.0, seed=5)
    assert (two[0] != two[1]).any()

    torch.manual_seed(123)
    r1 = torch.randn(3)
    torch.manual_seed(123)
    _tgen(tm, ids, max_new_tokens=2, cache="naive")  # greedy
    np.testing.assert_array_equal(torch.randn(3).numpy(), r1.numpy())
    torch.manual_seed(123)
    _tgen(tm, ids, max_new_tokens=2, cache="naive", decode_strategy="greedy_search")
    np.testing.assert_array_equal(torch.randn(3).numpy(), r1.numpy())

    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    a = _tgen(tm, ids, max_new_tokens=6, do_sample=True, temperature=2.0, generator=g1)
    b = _tgen(tm, ids, max_new_tokens=6, do_sample=True, temperature=2.0, generator=g2)
    np.testing.assert_array_equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert not torch.equal(g1.get_state(), torch.Generator().manual_seed(4).get_state())


def test_one_token_filters_equal_reference_greedy(pairs):
    """top_k=1, and a top_p small enough to keep one token, sample the
    argmax whatever the seed: both equal the JAX package's greedy."""
    jm, tm = pairs["gqa"]
    ids = _ids(seed=2)
    want = _jgen(jm, ids, max_new_tokens=6, cache="naive")
    _assert_margins(tm, ids, want)
    for cache in ("naive", "paged"):
        for kw in (dict(top_k=1, seed=7), dict(top_p=1e-6, seed=8)):
            np.testing.assert_array_equal(
                _tgen(tm, ids, max_new_tokens=6, cache=cache, block_size=4, do_sample=True,
                      temperature=1.3, **kw), want)


def _reference_filter(logits2d, temperature, top_k, top_p):
    """The JAX package's ``generate._select`` filter
    (paddle_tpu/models/llama.py:928-938), written out: it is a closure
    there.  Returns the filtered f32 logits."""
    lg = logits2d.astype(jnp.float32) / jnp.float32(max(temperature, 1e-6))
    if top_k and top_k > 0:
        kth = jax.lax.top_k(lg, min(int(top_k), lg.shape[-1]))[0][:, -1:]
        lg = jnp.where(lg < kth, -jnp.inf, lg)
    if top_p < 1.0:
        sort = jnp.sort(lg, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sort, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        keep = cum - probs < jnp.float32(top_p)
        cutoff = jnp.min(jnp.where(keep, sort, jnp.inf), axis=-1, keepdims=True)
        lg = jnp.where(lg < cutoff, -jnp.inf, lg)
    return lg


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.5, 0, 0.9), (1.0, 10, 0.5), (2.0, 64, 0.95),
    (1.0, 100, 1.0), (0.0, 3, 0.3)])
def test_filter_matches_reference_expressions(temperature, top_k, top_p):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 64)).astype(np.float32) * 3
    logits[1, :8] = logits[1, 8]  # ties at the k-th value stay in
    want = np.asarray(_reference_filter(jnp.asarray(logits), temperature, top_k, top_p))
    got = tllama.filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)],
                               rtol=FILTER_TOL, atol=0)


@pytest.mark.parametrize("beams", [1, 3, 6])
def test_beam_search_matches_reference(pairs, beams):
    """num_beams 1, 3 and 6 over B 2: the JAX package's tokens; K = 1 is
    greedy.  The winning beam's teacher-forced log-probability is never
    below greedy's (the JAX package's test_beam_search_decode)."""
    jm, tm = pairs["mha"]
    ids = _ids(seed=3)
    want = _jgen(jm, ids, max_new_tokens=5, decode_strategy="beam_search", num_beams=beams)
    got = _tgen(tm, ids, max_new_tokens=5, decode_strategy="beam_search", num_beams=beams)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    greedy = _tgen(tm, ids, max_new_tokens=5, cache="naive")
    if beams == 1:
        np.testing.assert_array_equal(got, greedy)
        return
    assert tm._beam_scores.shape == (2, beams)

    def logprob(stream):
        full = torch.from_numpy(np.concatenate([ids, stream], axis=1).astype(np.int64))
        with torch.no_grad():
            lp = torch.log_softmax(tm(full)[:, ids.shape[1] - 1:-1].float(), dim=-1)
        return lp.gather(-1, torch.from_numpy(stream)[..., None])[..., 0].sum(-1)

    assert bool((logprob(got) >= logprob(greedy) - 1e-4).all())


def test_beam_length_penalty_warns_and_divides(pairs):
    _, tm = pairs["mha"]
    ids = _ids(seed=3)
    plain = _tgen(tm, ids, max_new_tokens=4, num_beams=3)
    scores = tm._beam_scores.clone()
    with pytest.warns(UserWarning, match="length_penalty"):
        got = _tgen(tm, ids, max_new_tokens=4, num_beams=3, length_penalty=1.0)
    np.testing.assert_array_equal(got, plain)
    torch.testing.assert_close(tm._beam_scores, scores / 4.0, rtol=0, atol=0)


@pytest.mark.parametrize("draft", ["self", "cross"])
def test_speculative_matches_reference(pairs, draft):
    """Self-draft and a cross-model draft (the GQA model of the same
    vocabulary), K 3, 4 tokens from a 5-token prompt: the self-draft's one
    tick accepts every proposal, the cross draft is rejected at each of
    its 4 ticks.  Tokens and _spec_stats equal the JAX package's, and the
    tokens equal the port's naive greedy.  The reference's cost is one
    XLA compile per op and cache length, so the streams are kept short."""
    jm, tm = pairs["mha"]
    jd, td = (jm, tm) if draft == "self" else pairs["gqa"]
    new = 4
    ids = _ids(rows=1, seed=4, s=5)
    want = _jgen(jm, ids, max_new_tokens=new, draft_model=jd, num_speculative_tokens=3)
    _assert_margins(tm, ids, want)
    got = _tgen(tm, ids, max_new_tokens=new, draft_model=td, num_speculative_tokens=3)
    np.testing.assert_array_equal(got, want)
    assert tm._spec_stats == jm._spec_stats
    np.testing.assert_array_equal(got, _tgen(tm, ids, max_new_tokens=new, cache="naive"))
    if draft == "self":
        assert tm._spec_stats["accepted"] == tm._spec_stats["proposed"] > 0
    else:
        assert tm._spec_stats["accepted"] < tm._spec_stats["proposed"]


def _errors():
    """Calls that raise ValueError in both packages, by name:
    (positional ids rows, keyword arguments); "vocab" uses a draft with
    another vocabulary."""
    return {
        "decode_strategy": (1, dict(decode_strategy="diverse_sibling")),
        "beams_sampling": (1, dict(num_beams=2, do_sample=True)),
        "beams_strategy_sampling": (1, dict(num_beams=2, decode_strategy="sampling")),
        "beams_draft": (1, dict(num_beams=2, draft_model="target")),
        "draft_sampling": (1, dict(draft_model="target", do_sample=True)),
        "draft_batch": (2, dict(draft_model="target")),
        "top_p_zero": (1, dict(do_sample=True, top_p=0.0)),
        "top_p_above_one": (1, dict(do_sample=True, top_p=1.5)),
        "decode_chunk": (1, dict(decode_chunk=0)),
        "cache": (1, dict(cache="dense")),
        "vocab": (1, dict(draft_model="other_vocab")),
    }


@pytest.mark.parametrize("case", sorted(_errors()))
def test_value_errors_match_reference(pairs, case):
    """Every ValueError of the JAX package's generate, with its text (the
    fragments tests/test_serving_decode.py and tests/test_speculative.py
    match among them)."""
    jm, tm = pairs["mha"]
    rows, kw = _errors()[case]
    ids = _ids(rows=rows)
    msgs = []
    for model, gen in ((jm, _jgen), (tm, _tgen)):
        kw_m = dict(kw)
        if kw_m.get("draft_model") == "target":
            kw_m["draft_model"] = model
        elif kw_m.get("draft_model") == "other_vocab":
            kw_m["draft_model"] = (_pair(13, vocab_size=32)[0] if model is jm else
                                   tllama.LlamaForCausalLM(tllama.llama_tiny(
                                       **dict(CFG, vocab_size=32)), device="cpu"))
        with pytest.raises(ValueError) as err, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gen(model, ids, max_new_tokens=3, **kw_m)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    fragments = {"decode_strategy": "decode_strategy", "top_p_zero": "top_p",
                 "draft_sampling": "greedy-only", "draft_batch": "batch size 1"}
    if case in fragments:
        assert fragments[case] in msgs[1]
