"""The port's GPT (``models/gpt.py``) against the JAX package's, on the CPU.

Both sides get the same numpy inputs; weights are carried by
``convert.load_jax_state_dict``.  The JAX package runs with
``FLAGS_use_pallas`` on, so its attention is the Pallas flash kernel (in
interpret mode) that the port's flash kernels replace.  The models are
``gpt_tiny`` cut to hidden 64, 2 layers, 32 tokens, dropout 0 (the
reference's masks come from another generator).  Tolerances, with their
reasons:

- f32 logits and loss: 2e-5 relative (the same f32 operations summed in
  other orders);
- f32 gradients: relative L2 1e-4 (two layers of f32 matmuls and the
  flash backward, summed in other orders);
- the 5-step loss curve: 1e-3 relative (AdamW's sign-like first steps
  turn last-bit gradient differences into whole learning-rate steps);
- O1 bf16: loss 1e-4 relative, gradients 2e-2 relative L2 (one rounding
  of each bf16 product and of the flash backward's P and dS).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu._core import autograd as jautograd
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.lora import apply_lora as japply_lora

import paddle_tpu_torch
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn.lora import apply_lora
from _torch_threads import _one_thread  # noqa: F401


F32_REL = 2e-5
GRAD_REL_L2 = 1e-4
CURVE_REL = 1e-3
O1_LOSS_REL = 1e-4
O1_GRAD_REL_L2 = 2e-2
CFG = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=128, max_position_embeddings=32)


@pytest.fixture
def pallas_on():
    prev = paddle.get_flags(["FLAGS_use_pallas"])["FLAGS_use_pallas"]
    paddle.set_flags({"FLAGS_use_pallas": "true"})
    yield
    paddle.set_flags({"FLAGS_use_pallas": prev})


def _arrays(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _pair(seed=0, **kw):
    paddle.seed(seed)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**{**CFG, **kw}))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**{**CFG, **kw}), device="cpu")
    load_jax_state_dict(tm, _arrays(jm))
    return jm, tm


def _ids(seed=0, b=2, s=32):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (b, s)).astype(np.int32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_grads(tm, jgrads, tol):
    """Every gradient within ``tol`` relative L2 of the reference's, but the
    key projection's bias: softmax ignores a shift of all of a query's
    scores, so that gradient is 0 up to rounding on both sides, and both
    must be below ``tol`` times the query bias's."""
    tnamed = {n: p.grad.float().numpy() for n, p in tm.named_parameters()}
    assert set(tnamed) == set(jgrads)
    for name, got in tnamed.items():
        if name.endswith("k_proj.bias"):
            scale = np.linalg.norm(jgrads[name.replace("k_proj", "q_proj")])
            assert max(np.linalg.norm(got), np.linalg.norm(jgrads[name])) <= tol * scale, name
        else:
            assert _rel_l2(got, jgrads[name]) <= tol, name


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]


def test_state_dict_keys_equal_reference():
    jm, tm = _pair()
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "gpt.h.1.attn.q_proj.weight" in tm.state_dict()
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(v.shape)) for v in _arrays(jm).values())


def test_logits_loss_and_grads_match_reference(pallas_on):
    """The reference forward compiled whole (``paddle.jit.to_static``),
    differentiated by its tape: the same loss and gradients as op by op,
    in a fraction of the time."""
    jm, tm = _pair()
    ids = _ids()
    jloss, jlogits = paddle.jit.to_static(jm)(paddle.to_tensor(ids),
                                               labels=paddle.to_tensor(ids))
    jloss.backward()
    tloss, tlogits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    tloss.backward()
    assert tlogits.shape == (2, 32, CFG["vocab_size"]) and tloss.dtype == torch.float32
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits._value),
                               rtol=F32_REL, atol=F32_REL)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss._value), rtol=F32_REL)
    _check_grads(tm, {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()},
                 GRAD_REL_L2)


def test_sequence_too_long_and_layer_stack_refusals():
    _, tm = _pair()
    with pytest.raises(ValueError, match="exceeds max_position_embeddings 32 "
                                         r"\(jax would silently clamp"):
        tm(torch.zeros(1, 33, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.3.4"):
        tgpt.GPTForCausalLM(tgpt.gpt_tiny(**CFG, fuse_layer_stack=True), device="cpu")
    paddle_tpu_torch.set_flags({"FLAGS_scan_layers": True})
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.3.4"):
            tgpt.GPTForCausalLM(tgpt.gpt_tiny(**CFG), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.3.4"):
            tllama.LlamaForCausalLM(tllama.llama_tiny(dtype="float32"), device="cpu")
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_scan_layers": False})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tgpt.GPTForCausalLM(tgpt.gpt_tiny(**CFG))


def test_positions_are_arange_expanded():
    """Two rows of the same ids give the same logits (positions depend on
    the column only), and a shifted row differs from the unshifted one."""
    _, tm = _pair()
    ids = torch.from_numpy(_ids(1, 1, 16)).expand(2, 16).contiguous()
    with torch.no_grad():
        logits = tm(ids)
        shifted = tm(torch.roll(ids, 1, dims=1))
    assert torch.equal(logits[0], logits[1])
    assert not torch.allclose(logits[:, 1:], shifted[:, 1:])


def test_train_step_loss_curve_matches_reference(pallas_on):
    """Five TrainStep + AdamW steps against the reference's TrainStep (the
    fast counterpart of the reference's BERT training test), one block:
    the reference's cost is compiling the step, which grows with depth."""
    jm, tm = _pair(1, num_hidden_layers=1)
    ids, labels = _ids(2), _ids(3)
    jo = jopt.AdamW(1e-3, parameters=jm.parameters(), weight_decay=0.01)
    to = topt.AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.01)
    jstep, tstep = JTrainStep(jm, jo, _loss_fn), TrainStep(tm, to, _loss_fn)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))._value)
          for _ in range(5)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(labels))) for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=CURVE_REL)
    assert tl[-1] < tl[0]


def test_o1_op_names_loss_and_grads_match_reference(pallas_on, monkeypatch):
    """Under auto_cast O1 bf16: the ops either AMP list acts on come in the
    same numbers in both hooks (the tied head's ``matmul``, the linears,
    the layer norms, the loss), and the first loss and every gradient
    match the reference's."""
    jm, tm = _pair(4)
    ids = _ids(5)
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jautograd._maybe_amp_cast, tamp.cast_args

    def j_rec(name, args):
        seen["jax"].append(name)
        return j_orig(name, args)

    def t_rec(name, args):
        seen["port"].append(name)
        return t_orig(name, args)

    monkeypatch.setattr(jautograd, "_maybe_amp_cast", j_rec)
    monkeypatch.setattr(tamp, "cast_args", t_rec)
    # the reference compiled whole under the same auto_cast: its hook sees
    # each op once as it is traced
    with jamp.auto_cast(True, dtype="bfloat16"):
        jloss, _ = paddle.jit.to_static(jm)(paddle.to_tensor(ids),
                                            labels=paddle.to_tensor(ids))
    jloss.backward()
    with tamp.auto_cast(True, dtype="bfloat16"):
        tloss, tlogits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    tloss.backward()
    acted = tamp.WHITE_LIST | tamp.BLACK_LIST

    def count(names):
        return sorted((n, names.count(n)) for n in set(names) if n in acted)

    assert set(seen["port"]) <= set(seen["jax"])
    assert count(seen["port"]) == count(seen["jax"])
    assert seen["port"].count("matmul") == 1 and seen["port"].count("layer_norm") == 5
    assert tlogits.dtype == torch.bfloat16
    jl = float(jloss._value)
    assert abs(float(tloss.detach()) - jl) <= O1_LOSS_REL * abs(jl)
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    _check_grads(tm, {n: np.asarray(p.grad._value, np.float32)
                      for n, p in jm.named_parameters()}, O1_GRAD_REL_L2)


def test_apply_lora_over_gpt_matches_reference():
    """apply_lora covers GPT's projection names (q/k/v, out_proj, fc_in,
    fc_out), as the reference's test_apply_lora_gpt_finetunes_frozen_base:
    the adapter keys equal the reference's, the adapters alone train, and
    the loss falls over eight TrainStep steps while every base parameter
    stays as it was."""
    jm, tm = _pair(3, num_hidden_layers=1)
    japply_lora(jm, rank=4, alpha=8)
    apply_lora(tm, rank=4, alpha=8)
    assert list(tm.state_dict()) == list(jm.state_dict())
    trainable = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert trainable and all(n.endswith(("lora_A", "lora_B")) for n in trainable)
    assert len(trainable) == 6 * 2  # one block: q, k, v, out_proj, fc_in, fc_out
    base = {n: p.detach().clone() for n, p in tm.named_parameters() if not p.requires_grad}
    ids, labels = _ids(6, 2, 8), _ids(7, 2, 8)
    step = TrainStep(tm, topt.AdamW(3e-2, parameters=tm.parameters()), _loss_fn)
    tl = [float(step(torch.from_numpy(ids), torch.from_numpy(labels))) for _ in range(8)]
    assert tl[-1] < tl[0]
    assert all(torch.equal(p, base[n]) for n, p in tm.named_parameters() if n in base)
