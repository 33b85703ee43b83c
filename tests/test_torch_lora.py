"""The port's LoRA layer (``paddle_tpu_torch/nn/lora.py``) against the JAX
package's, on the CPU.

Both sides get the same numpy arrays made from a seed (base weights
carried by load_jax_state_dict, adapters by load_jax_adapter), in
tests/test_serving_lora.py's f32 tiny geometry (vocab 128, hidden 32, 2
layers).  Tolerances: forward outputs and logits 2e-5 relative (f32, the
same operations summed in other orders); the merged weight 1e-6; the
5-step fine-tune loss curve 1e-3 relative (Adam's first steps, as in
tests/test_torch_train.py).  Pack contents and the frozen base are
compared exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import lora as jlora

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_adapter, load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import lora as tlora

TOL = 2e-5
CURVE_REL = 1e-3
RANK = 4
KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
          dtype="float32")
# in and out features of each pack target at KW's widths
DIMS = {"self_attn.q_proj": (32, 32), "self_attn.k_proj": (32, 32),
        "self_attn.v_proj": (32, 32), "self_attn.o_proj": (32, 32),
        "mlp.gate_up_proj": (32, 128), "mlp.down_proj": (64, 32)}


def models(seed=41, **kw):
    """The JAX tiny LLaMA and the port's, with the same weights."""
    paddle.seed(seed)
    cfg = dict(KW, **kw)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def adapter_sd(seed, rank=RANK, b_scale=0.2, layers=2, targets=tuple(DIMS)):
    """A numpy adapter state dict (the JAX ``lora_state_dict`` keys): A
    from a normal of std 0.05, B of std ``b_scale``, large enough to move
    greedy tokens (a zero B is the base model)."""
    g = np.random.default_rng(seed)
    out = {}
    for li in range(layers):
        for t in targets:
            i, o = DIMS[t]
            out[f"model.layers.{li}.{t}.lora_A"] = (g.standard_normal((i, rank))
                                                     * 0.05).astype(np.float32)
            out[f"model.layers.{li}.{t}.lora_B"] = (g.standard_normal((rank, o))
                                                     * b_scale).astype(np.float32)
    return out


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


# ------------------------------------------------------------- LoRALinear

def _lora_pair(seed=0, b=True):
    """A JAX and a port LoRALinear(16 -> 24, rank 4, alpha 8) with the same
    weight, bias and adapter (B zero unless ``b``)."""
    g = np.random.default_rng(seed)
    w = g.standard_normal((16, 24)).astype(np.float32)
    bias = g.standard_normal(24).astype(np.float32)
    a = g.standard_normal((16, RANK)).astype(np.float32)
    bb = (g.standard_normal((RANK, 24)) if b else np.zeros((RANK, 24))).astype(np.float32)
    jl = jlora.LoRALinear(16, 24, RANK, alpha=8)
    tl = tlora.LoRALinear(16, 24, RANK, alpha=8, device="cpu")
    for name, v in (("weight", w), ("bias", bias), ("lora_A", a), ("lora_B", bb)):
        getattr(jl, name).set_value(v)
        with torch.no_grad():
            getattr(tl, name).copy_(torch.from_numpy(v))
    return jl, tl


def test_lora_linear_starts_at_the_base_layer():
    g = torch.Generator().manual_seed(0)
    base = tnn.Linear(16, 24, device="cpu", generator=g)
    m = tlora.LoRALinear.from_linear(base, RANK, generator=g)
    assert m.weight is base.weight and m.bias is base.bias  # adopted, not copied
    assert float(m.lora_B.detach().abs().max()) == 0.0 and float(m.lora_A.detach().std()) > 0
    x = torch.randn(3, 5, 16, generator=g)
    assert torch.equal(m(x), base(x))
    assert m.scaling == 1.0 and tlora.LoRALinear(4, 4, 2, alpha=6, device="cpu").scaling == 3.0
    assert set(m.state_dict()) == {"weight", "bias", "lora_A", "lora_B"}


def test_lora_linear_forward_and_merge_match_jax():
    jl, tl = _lora_pair()
    x = np.random.default_rng(1).standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(jl(paddle.to_tensor(x))._value)
    _close(tl(torch.from_numpy(x)), want)
    w0 = tl.weight.detach().clone()
    jl.merge()
    tl.merge()
    tl.merge()  # idempotent
    assert tl.merged
    _close(tl.weight, np.asarray(jl.weight._value), 1e-6)
    _close(tl(torch.from_numpy(x)), want)  # merged: the same function, no adapter term
    tl.unmerge()
    assert not tl.merged
    torch.testing.assert_close(tl.weight, w0, rtol=1e-6, atol=1e-6)


def test_lora_linear_refuses_a_bad_rank():
    for bad in (0, -2):
        with pytest.raises(ValueError, match="rank must be >= 1"):
            tlora.LoRALinear(4, 4, bad, device="cpu")
        with pytest.raises(ValueError, match="rank must be >= 1"):
            jlora.LoRALinear(4, 4, bad)


# ------------------------------------------------------------- apply_lora

def test_apply_lora_keys_and_freezing_match_jax():
    jm, tm = models()
    jbase, tbase = set(jm.state_dict()), set(tm.state_dict())
    jlora.apply_lora(jm, rank=RANK, alpha=8)
    tlora.apply_lora(tm, rank=RANK, alpha=8)
    assert set(tm.state_dict()) == set(jm.state_dict())
    added = set(tm.state_dict()) - tbase
    assert added == set(jm.state_dict()) - jbase
    assert len(added) == 2 * 6 * KW["num_hidden_layers"]
    assert set(tlora.lora_state_dict(tm)) == set(jlora.lora_state_dict(jm)) == added
    trainable = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert trainable == added
    assert {n for n, p in jm.named_parameters() if not p.stop_gradient} == added
    # the base Parameter objects survive the surgery
    q = tm.model.layers[0].self_attn.q_proj
    assert isinstance(q, tlora.LoRALinear) and q.weight.requires_grad is False
    # with the JAX adapter's values the two models give the same logits
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    ids = np.random.default_rng(2).integers(0, 128, (2, 9)).astype(np.int32)
    # the reference's forward compiled whole (one XLA program, the same
    # logits within 1e-6) rather than op by op
    _close(tm(torch.from_numpy(ids).long()),
           np.asarray(paddle.jit.to_static(jm)(paddle.to_tensor(ids))._value))
    with pytest.raises(ValueError, match="no Linear layer"):
        tlora.apply_lora(tm, rank=RANK, targets=("nothing",))
    with pytest.raises(ValueError, match="no LoRA parameters"):
        tlora.lora_state_dict(models()[1])


# ------------------------------------------------------ the adapter state dict

def test_parse_matches_jax_and_refuses_alike():
    sd = adapter_sd(3, targets=("self_attn.q_proj", "mlp.down_proj"))
    del sd["model.layers.1.mlp.down_proj.lora_A"], sd["model.layers.1.mlp.down_proj.lora_B"]
    targets = tuple(DIMS)
    jarr = jlora.parse_adapter_state_dict(sd, 2, targets, RANK)
    tarr = tlora.parse_adapter_state_dict(load_jax_adapter(sd), 2, targets, RANK)
    assert set(tarr) == set(jarr) == {"self_attn.q_proj", "mlp.down_proj"}
    for t in tarr:
        for got, want in zip(tarr[t], jarr[t]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tarr["mlp.down_proj"][0][1].abs().max()) == 0.0  # an omitted layer is zeros
    bad = {
        "lopsided": ({k: v for k, v in sd.items()
                      if k != "model.layers.0.self_attn.q_proj.lora_B"}, "lopsided"),
        "rank": (adapter_sd(4, rank=2), "rank"),
        "target": ({"model.layers.0.self_attn.rotary.lora_A": np.zeros((32, RANK))},
                   "does not cover"),
        "layer": ({"model.layers.5.self_attn.q_proj.lora_A": np.zeros((32, RANK)),
                   "model.layers.5.self_attn.q_proj.lora_B": np.zeros((RANK, 32))}, "layer 5"),
        "no layer": ({"head.lora_A": np.zeros((32, RANK))}, "decoder layer"),
        "empty": ({"model.norm.weight": np.zeros(32)}, "no lora_A"),
    }
    for case, (state, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            jlora.parse_adapter_state_dict(state, 2, targets, RANK)
        with pytest.raises(ValueError, match=match):
            tlora.parse_adapter_state_dict(state, 2, targets, RANK)


# ----------------------------------------------------------------- the pack

def test_pack_geometry_and_in_place_slot_writes():
    jm, tm = models()
    jp = jlora.AdapterPack(jm, rank=RANK, alpha=8, max_adapters=2)
    tp = tlora.AdapterPack(tm, rank=RANK, alpha=8, max_adapters=2)
    assert tp.num_slots == jp.num_slots == 3 and tp.targets == jlora.LLAMA_TARGETS
    for t, (A, B) in tp.ab.items():
        assert tuple(A.shape) == tuple(jp.ab[t][0].shape)
        assert tuple(B.shape) == tuple(jp.ab[t][1].shape)
    assert tp.nbytes == jp.nbytes
    addr = {name: t.data_ptr() for name, t in tp.parts()}
    arrays = tlora.parse_adapter_state_dict(load_jax_adapter(adapter_sd(5)), 2, tp.targets, RANK)
    jarrays = jlora.parse_adapter_state_dict(adapter_sd(5), 2, jp.targets, RANK)
    tp.set_slot(2, arrays, alpha=6)
    jp.set_slot(2, jarrays, alpha=6)
    for (name, got), (_, want) in zip(tp.parts(), jp.parts()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert float(tp.scaling[2]) == 1.5 and float(tp.scaling[1]) == 0.0
    assert {name: t.data_ptr() for name, t in tp.parts()} == addr  # written in place
    tp.clear_slot(2)
    assert all(float(t.abs().max()) == 0.0 for _, t in tp.parts())
    with pytest.raises(IndexError, match="slot 0"):
        tp.set_slot(0, arrays)
    with pytest.raises(IndexError):
        tp.clear_slot(3)
    with pytest.raises(NotImplementedError, match="A.6"):
        tp.place_over_mesh(None)


def test_set_slot_validates_every_target_before_writing():
    _, tm = models()
    tp = tlora.AdapterPack(tm, rank=RANK, max_adapters=1)
    good = tlora.parse_adapter_state_dict(load_jax_adapter(adapter_sd(6)), 2, tp.targets, RANK)
    tp.set_slot(1, good)
    before = [t.clone() for _, t in tp.parts()]
    broken = dict(good)
    a, b = good["mlp.down_proj"]  # the last target: a write-as-you-go loop would be half done
    broken["mlp.down_proj"] = (a[:, :-1], b)
    with pytest.raises(ValueError, match="pack slot expects"):
        tp.set_slot(1, broken, alpha=1)
    for got, want in zip((t for _, t in tp.parts()), before):
        assert torch.equal(got, want)


def test_lora_delta_and_prefill_scope_match_jax():
    jm, tm = models()
    jp = jlora.AdapterPack(jm, rank=RANK, alpha=8, max_adapters=2)
    tp = tlora.AdapterPack(tm, rank=RANK, alpha=8, max_adapters=2)
    for slot, seed in ((1, 7), (2, 8)):
        jp.set_slot(slot, jlora.parse_adapter_state_dict(adapter_sd(seed), 2, jp.targets, RANK))
        tp.set_slot(slot, tlora.parse_adapter_state_dict(load_jax_adapter(adapter_sd(seed)), 2,
                                                         tp.targets, RANK))
    g = np.random.default_rng(9)
    x = g.standard_normal((3, 2, 32)).astype(np.float32)
    slots = np.array([2, 0, 1])
    A, B = (t[1] for t in (tp.ab["self_attn.q_proj"][0], tp.ab["self_attn.q_proj"][1]))
    jA, jB = (t[1] for t in jp.ab["self_attn.q_proj"])
    got = tlora.lora_delta(torch.from_numpy(x), A, B, torch.from_numpy(slots),
                           tp.scaling[torch.from_numpy(slots)])
    want = jlora.lora_delta(x, jA, jB, slots.astype(np.int32), jp.scaling[slots])
    _close(got, want)
    assert float(got[1].abs().max()) == 0.0  # slot 0: an exact zero
    # the prefill hooks: the adapted forward of slot 2, and none left after
    ids = g.integers(0, 128, (1, 7)).astype(np.int32)
    with jlora.adapter_prefill_scope(jm.model.layers, jp, 2):
        want = np.asarray(paddle.jit.to_static(jm)(paddle.to_tensor(ids))._value)
    plain = tm(torch.from_numpy(ids).long())
    with tlora.adapter_prefill_scope(tm.model.layers, tp, 2):
        got = tm(torch.from_numpy(ids).long())
    _close(got, want)
    assert torch.equal(tm(torch.from_numpy(ids).long()), plain)
    with tlora.adapter_prefill_scope(tm.model.layers, tp, 0):
        assert torch.equal(tm(torch.from_numpy(ids).long()), plain)
    with pytest.raises(NotImplementedError, match="A.3.4"):
        with tlora.adapter_prefill_scope(object(), tp, 1):
            pass


# ------------------------------------------------------------ the fine-tune

def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    return ids, rng.integers(0, 128, (2, 16)).astype(np.int64)


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]


def test_frozen_base_fine_tune_through_train_step_matches_jax():
    """apply_lora, then TrainStep with AdamW over every parameter: only the
    adapters train.  The loss curve matches the JAX package's, the frozen
    base gets no grad and stays bit for bit, and the optimizer holds the
    adapters' state alone."""
    jm, tm = models(seed=12)
    jlora.apply_lora(jm, rank=RANK, alpha=8)
    tlora.apply_lora(tm, rank=RANK, alpha=8)
    # nonzero B on both sides, so the first step's gradient reaches A too
    for name, p in jm.named_parameters():
        if name.endswith("lora_B"):
            p.set_value(np.random.default_rng(len(name)).standard_normal(p.shape)
                        .astype(np.float32) * 0.1)
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    base = {n: p.detach().clone() for n, p in tm.named_parameters() if not p.requires_grad}
    ids, labels = _batch(3)
    jo = jopt.AdamW(1e-2, parameters=jm.parameters(), weight_decay=0.01)
    to = topt.AdamW(1e-2, parameters=tm.parameters(), weight_decay=0.01)
    jstep, tstep = JTrainStep(jm, jo, _loss_fn), TrainStep(tm, to, _loss_fn)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))._value)
          for _ in range(5)]
    tl = [float(tstep(torch.from_numpy(ids).long(), torch.from_numpy(labels)))
          for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=CURVE_REL)
    assert tl[-1] < tl[0]
    for n, p in tm.named_parameters():
        if n in base:
            assert p.grad is None and torch.equal(p, base[n]), n
    adapters = [p for n, p in tm.named_parameters() if p.requires_grad]
    state = to.opt_state_tensors()
    # moment1, moment2, beta1_pow, beta2_pow an adapter parameter, and the rate
    assert len(state) == 4 * len(adapters) + 1
    assert {pid for (_, pid) in to._accumulators} == {id(p) for p in adapters}
    for n, p in jm.named_parameters():
        if n.endswith(("lora_A", "lora_B")):
            _close(dict(tm.named_parameters())[n], np.asarray(p._value), CURVE_REL)
