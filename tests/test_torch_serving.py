"""The port's GenerationEngine against the JAX package's, greedy, f32, CPU.

Both engines serve the same weights (carried by load_jax_state_dict) and
the same scripted traffic; their streams and step outputs must be equal.
Token equality is meaningful only where no step's top-2 logits are
closer than the two frameworks' f32 disagreement (about 1e-5 here), so
the fixture checks on the JAX model that every greedy step's top-2 margin
exceeds MARGIN.  Sampled streams are checked port against port only: the
two packages' random generators differ.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import GenerationEngine as JaxEngine

from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.serving import GenerationEngine, restore_engine

MARGIN = 1e-3
PAD_LEN = 32
CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
           dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: the engines' token-by-token ops are tiny, and a
    thread pool only spins beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**CFG))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**CFG), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


_COMPILED = {}


def _compiled(jm):
    """The JAX model's forward compiled whole (``paddle.jit.to_static``),
    once a model: the same logits as its eager forward (within 1e-6),
    without compiling op by op on every new pad."""
    if id(jm) not in _COMPILED:
        _COMPILED[id(jm)] = (jm, paddle.jit.to_static(jm.forward))
    return _COMPILED[id(jm)][1]


def _assert_margins(jm, prompt, stream):
    """Every greedy token of `stream` won its step by more than MARGIN on
    the JAX model (one full forward over prompt + stream, padded at the
    end to one fixed length: the causal model's earlier logits do not see
    the pad, and one shape compiles once)."""
    seq = list(prompt) + list(stream[:-1])
    ids = np.zeros((1, PAD_LEN), np.int32)
    ids[0, :len(seq)] = seq
    logits = np.asarray(_compiled(jm)(paddle.to_tensor(ids))._value)[0, len(prompt) - 1:len(seq)]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert np.argmax(logits, -1).tolist() == list(stream)
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


def _drive(eng, script):
    """Run `script` — ("add", rid, prompt, n) or ("step",) — then step
    until idle.  Returns every add_request return and step output."""
    log = []
    for op in script:
        if op[0] == "add":
            log.append(eng.add_request(op[1], op[2], max_new_tokens=op[3]))
        else:
            log.append(eng.step())
    while eng.has_work():
        log.append(eng.step())
    return log


def _both(models, script, rids, **kw):
    jm, tm = models
    jeng = JaxEngine(jm, **kw)
    teng = GenerationEngine(tm, device="cpu", **kw)
    jlog, tlog = _drive(jeng, script), _drive(teng, script)
    assert tlog == jlog
    prompts = {op[1]: op[2] for op in script if op[0] == "add"}
    for rid in rids:
        assert teng.result(rid) == jeng.result(rid)
        if kw.get("eos_token_id") is None:
            _assert_margins(jm, prompts[rid], jeng.result(rid))
    return teng


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_single_request_matches_jax(models, decode_chunk):
    script = [("add", "r", [5, 9, 17, 33, 2], 9)]
    _both(models, script, ["r"], max_batch=2, block_size=8, num_blocks=16,
          decode_chunk=decode_chunk)


def test_requests_join_mid_flight(models):
    script = [("add", "a", [5, 9, 17, 33, 2], 8), ("step",), ("step",),
              ("add", "b", [7, 11, 3], 6)]
    _both(models, script, ["a", "b"], max_batch=2, block_size=8, num_blocks=16,
          decode_chunk=2)


def test_pool_exhaustion_queues_then_admits(models):
    p = list(range(1, 9))
    script = [("add", "a", p, 7), ("add", "b", p, 7), ("add", "c", [3, 4], 5)]
    teng = _both(models, script, ["a", "b", "c"], max_batch=2, block_size=8, num_blocks=2,
                 decode_chunk=4)
    assert teng.pending_requests() == [] and sorted(teng._free) == [0, 1]
    with pytest.raises(RuntimeError, match="table width"):
        teng.add_request("w", list(range(40)), max_new_tokens=40)


def test_eos_stops_early(models):
    _, tm = models
    probe = GenerationEngine(tm, max_batch=1, block_size=8, num_blocks=8, device="cpu")
    probe.add_request("p", [5, 9], max_new_tokens=6)
    while probe.has_work():
        probe.step()
    eos = probe.result("p")[2]
    script = [("add", "e", [5, 9], 6), ("add", "f", [7, 1, 4], 6)]
    teng = _both(models, script, ["e", "f"], max_batch=2, block_size=8, num_blocks=8,
                 decode_chunk=4, eos_token_id=eos)
    assert teng.result("e")[-1] == eos and len(teng.result("e")) == 3


def _sampled(tm, decode_chunk, seed):
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=16, device="cpu",
                           decode_chunk=decode_chunk)
    eng.add_request("s", [5, 9, 17], max_new_tokens=10, temperature=0.9, seed=seed)
    eng.add_request("g", [7, 11], max_new_tokens=10)
    while eng.has_work():
        eng.step()
    return eng.result("s"), eng.result("g")


def test_sampled_streams_deterministic_port_against_port(models):
    _, tm = models
    s1, g1 = _sampled(tm, 1, seed=3)
    s4, g4 = _sampled(tm, 4, seed=3)
    assert s1 == s4 and g1 == g4 and len(s1) == 10
    s_other, _ = _sampled(tm, 4, seed=4)
    assert s_other != s1


def test_unported_options_raise(models, tmp_path):
    _, tm = models
    kw = dict(max_batch=1, block_size=8, num_blocks=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GenerationEngine(tm, **kw, mesh=object())
    # adapters and snapshots are ported: an engine without adapters= refuses
    # an adapter, and only a tensor-parallel restore is left unported
    eng = GenerationEngine(tm, **kw)
    with pytest.raises(RuntimeError, match="without adapters="):
        eng.add_request("x", [1, 2], adapter="a")
    eng.snapshot(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        restore_engine(tm, str(tmp_path), mesh=object(), device="cpu")
    # adapter namespaces need adapters=
    with pytest.raises(ValueError, match="namespace"):
        GenerationEngine(tm, **kw, prefix_cache=True).adopt_pages([1] * 8, [], [], ns=(1, 0))
    with pytest.raises(ValueError, match="lies on"):
        GenerationEngine(tm, device="meta", **{k: v for k, v in kw.items() if k != "device"})


def test_finished_lanes_write_only_their_scratch_page(models):
    """A lane that stops mid-chunk keeps decoding on the device until the
    chunk ends; those writes must land on its scratch page, never on the
    request's pool pages."""
    _, tm = models
    eng = GenerationEngine(tm, max_batch=2, block_size=8, num_blocks=16, device="cpu",
                           decode_chunk=4)
    eng.add_request("short", [5, 9, 17], max_new_tokens=2)  # stops after 1 decode token
    eng.add_request("long", [7, 11], max_new_tokens=9)
    blocks = list(next(s for s in eng._slots if s.rid == "short").blocks)
    pools = eng._kpools + eng._vpools
    before = [p[blocks].clone() for p in pools]
    eng.step()
    assert len(eng.result("short")) == 2
    for b, p in zip(before, pools):
        changed = (p[blocks] != b).any(dim=3).any(dim=1)  # [n_blocks, block_size]
        # only the one decoded token's K/V, at position 3 of the first page
        assert changed.nonzero().tolist() == [[0, 3]]
