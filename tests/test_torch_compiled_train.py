"""The port's TrainStep per batch signature, lower/warmup and the rate
tensor, on the CPU, against the JAX package's compiled TrainStep.

On the CPU the port runs each signature's step eagerly at every call (a
CUDA graph is recorded only on the card; ``tests/test_torch_cuda.py``
holds the replays against the eager step there), so these tests cover the
logic around it: the signature table, the state key that triggers a new
recording, the rolled-back warm-up and the rate read on the device.
Tolerances, with their reasons:

- port against JAX, f32: losses and final parameters within 2e-5
  absolute (the same operations in other orders, over 5 steps of a tiny
  model; measured 3e-6);
- within the port: bit for bit (the same operations on the same inputs).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from _torch_threads import _one_thread  # noqa: F401

TOL = 2e-5
CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]


def _batch(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (b, s)).astype(np.int64)
    labels = rng.integers(0, CFG["vocab_size"], (b, s)).astype(np.int64)
    labels[0, :2] = -100
    return torch.from_numpy(ids), torch.from_numpy(labels)


def _model(dtype="float32", seed=0):
    g = torch.Generator().manual_seed(seed)
    return tllama.LlamaForCausalLM(tllama.llama_tiny(dtype=dtype, **CFG), device="cpu",
                                   generator=g)


def _adamw(model, **kw):
    return topt.AdamW(topt.lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2),
                      parameters=model.named_parameters(), weight_decay=0.1,
                      grad_clip=ClipGradByGlobalNorm(0.5), **kw)


def _state(step):
    """Copies of every tensor a step reads or writes, the grads, the step
    count and the rate."""
    opt = step.optimizer
    out = {f"p{i}": p.detach().clone() for i, p in enumerate(opt._parameter_list)}
    out.update({f"g{i}": (None if p.grad is None else p.grad.clone())
                for i, p in enumerate(opt._parameter_list)})
    out.update({k: v.clone() for k, v in opt.state_dict().items() if torch.is_tensor(v)})
    out["lr"] = opt._lr_t.clone()
    out["count"] = opt._step_count
    return out


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


# --------------------------------------------------------------- against JAX

@pytest.mark.parametrize("kind", ["adamw_warmup_clip", "sgd_set_lr"])
def test_train_step_matches_jax_over_five_steps(kind):
    """The same numpy weights and batch through the JAX TrainStep (one
    jitted program after the first call) and the port's: AdamW under a
    LinearWarmup scheduler stepped between steps with global-norm
    clipping, or SGD with set_lr between steps.  Losses and final
    parameters within TOL; the port counts every step it ran."""
    paddle.seed(3)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(dtype="float32", **CFG))
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(dtype="float32", **CFG), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    if kind == "adamw_warmup_clip":
        js = jopt.lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2)
        ts = topt.lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2)
        jo = jopt.AdamW(js, parameters=jm.parameters(), weight_decay=0.1, grad_clip=JClip(0.5))
        to = topt.AdamW(ts, parameters=tm.parameters(), weight_decay=0.1,
                        grad_clip=ClipGradByGlobalNorm(0.5))
    else:
        jo = jopt.SGD(0.5, parameters=jm.parameters())
        to = topt.SGD(0.5, parameters=tm.parameters())
    jstep, tstep = JTrainStep(jm, jo, _loss_fn), TrainStep(tm, to, _loss_fn)
    ids, labels = _batch(0)
    jl, tl = [], []
    for i in range(5):
        jl.append(float(jstep(paddle.to_tensor(ids.numpy()),
                              paddle.to_tensor(labels.numpy()))._value))
        tl.append(float(tstep(ids, labels)))
        if kind == "adamw_warmup_clip":
            js.step()
            ts.step()
        else:
            jo.set_lr(0.5 - 0.1 * i)
            to.set_lr(0.5 - 0.1 * i)
            assert float(to._lr_t) == float(np.float32(to.get_lr()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=TOL)
    assert tl[-1] < tl[0]
    tnamed = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(tnamed[name].detach().numpy(), np.asarray(p._value),
                                   rtol=0, atol=TOL, err_msg=name)
    assert list(tstep._steps) == [((tuple(ids.shape), ids.dtype),
                                   (tuple(labels.shape), labels.dtype))]
    assert tstep.captures == 1
    # the JAX counter moves in Python at trace time, once per compile
    # (ROADMAP.md C); the port's counts the steps run
    assert to.state_dict()["step_count"] == 5
    assert all(p.grad is None for p in tm.parameters())


# ---------------------------------------------------------------- the rate

def test_rate_lives_in_a_device_tensor_the_updates_read():
    """set_lr and the scheduler write the optimizer's 0-d f32 rate tensor in
    place (its address never changes); opt_state_tensors ends with it; an
    SGD update reads it in the gradient's dtype, as JAX's lr.astype."""
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    opt = topt.SGD(0.3, parameters=[p])
    t = opt._lr_t
    assert t.dtype == torch.float32 and t.dim() == 0 and float(t) == np.float32(0.3)
    opt.set_lr(0.7)
    assert opt._lr_t is t and float(t) == np.float32(0.7)
    assert opt.opt_state_tensors()[-1] is t
    p.grad = torch.full((3,), 0.5, dtype=torch.bfloat16)
    opt.step()
    lr_bf16 = torch.tensor(0.7, dtype=torch.float32).to(torch.bfloat16)
    want = (torch.ones(3) - (lr_bf16 * torch.full((3,), 0.5, dtype=torch.bfloat16)).float())
    assert torch.equal(opt.state_dict()["master_weight_0"], want)
    sched = topt.lr.LinearWarmup(1e-2, 3, 1e-3, 1e-2)
    opt = topt.Adam(sched, parameters=[torch.nn.Parameter(torch.ones(2))])
    t = opt._lr_t
    sched.step()
    opt._sync_lr()
    assert opt._lr_t is t and float(t) == np.float32(sched.get_lr())


def test_journaled_step_creates_accumulators_and_rolls_back():
    """The rolled-back step on zero grads creates every accumulator at its
    fresh init (moments 0, beta powers 1, masters the parameters' f32
    values) and leaves the parameters, their grads, the existing
    accumulators and the step count as they were."""
    model = _model("bfloat16")
    opt = _adamw(model)
    params = list(model.parameters())
    params[0].grad = torch.ones_like(params[0])
    before = [p.detach().clone() for p in params]
    opt._journaled_step(params)
    state = opt.state_dict()
    assert len(state) == 5 * len(params) + 2 and state["step_count"] == 0
    for i, p in enumerate(params):
        assert torch.equal(p, before[i])
        assert torch.equal(state[f"master_weight_{i}"], p.detach().float())
        assert not state[f"moment1_{i}"].any() and not state[f"moment2_{i}"].any()
        assert float(state[f"beta1_pow_{i}"]) == float(state[f"beta2_pow_{i}"]) == 1.0
    assert torch.equal(params[0].grad, torch.ones_like(params[0]))
    assert all(p.grad is None for p in params[1:])


# ------------------------------------------------------- lower and warmup

@pytest.mark.parametrize("stepped", [False, True])
def test_warmup_leaves_all_state_bit_identical(stepped):
    """warmup() on a fresh step (the accumulators created at their init)
    or after a step: every parameter, master, moment, beta power, the
    rate, the step count and every .grad are as they were, bit for bit."""
    model = _model("bfloat16")
    step = TrainStep(model, _adamw(model), _loss_fn)
    ids, labels = _batch(1)
    if stepped:
        step(ids, labels)
        step.optimizer._lr_scheduler.step()
    params = list(model.parameters())
    params[1].grad = torch.full_like(params[1], 0.25)
    if not stepped:
        step.optimizer._journaled_step(params)  # so the state below lists them
    before = _state(step)
    assert step.warmup(ids, labels) is step
    _assert_same(_state(step), before)
    assert len(step._steps) == 1 and step.captures == 1 + stepped


def test_first_step_after_warmup_equals_a_fresh_eager_step():
    """A warmed-up step's first call equals a fresh TrainStep's first call,
    loss and every state tensor bit for bit."""
    ids, labels = _batch(2)
    runs = []
    for warm in (True, False):
        model = _model("bfloat16", seed=4)
        step = TrainStep(model, _adamw(model), _loss_fn)
        if warm:
            step.warmup(ids, labels)
        loss = step(ids, labels)
        runs.append((loss, _state(step)))
    assert torch.equal(runs[0][0], runs[1][0])
    _assert_same(runs[0][1], runs[1][1])


def test_lower_of_meta_tensors_compiles_and_stores_nothing():
    """lower() takes meta tensors (the signature only); compile() records
    the step for that signature on zeros and returns it; nothing is stored
    in the step's table and no state advances."""
    model = _model()
    step = TrainStep(model, _adamw(model), _loss_fn)
    ids = torch.empty((2, 8), dtype=torch.int64, device="meta")
    lowered = step.lower(ids, ids)
    assert lowered.signature == (((2, 8), torch.int64),) * 2
    before = _state(step)
    compiled = lowered.compile()
    assert [tuple(t.shape) for t in compiled.inputs] == [(2, 8), (2, 8)]
    assert all(t.device.type == "cpu" and not t.any() for t in compiled.inputs)
    assert step._steps == {} and step.captures == 0
    _assert_same(_state(step), before)


def test_each_batch_signature_gets_its_own_step():
    """A second batch shape (and a second dtype) records a step of its own;
    going back to the first reuses it."""
    model = _model()
    step = TrainStep(model, _adamw(model), _loss_fn)
    a, b = _batch(3, 2, 16), _batch(4, 1, 24)
    step(*a)
    step(*b)
    step(a[0].int(), a[1])
    step(*a)
    assert step.captures == 3 and len(step._steps) == 3
    assert (((1, 24), torch.int64), ((1, 24), torch.int64)) in step._steps


def test_a_rebound_state_tensor_records_the_step_again():
    """An accumulator rebound to a new tensor, or a parameter given new
    storage, makes the next call record the step again (a replay would read
    the old addresses); the losses stay the eager step's."""
    ids, labels = _batch(5)
    model, twin = _model(seed=6), _model(seed=6)
    step = TrainStep(model, _adamw(model), _loss_fn)
    ref = TrainStep(twin, _adamw(twin), _loss_fn)
    for _ in range(2):
        assert torch.equal(step(ids, labels), ref(ids, labels))
    assert step.captures == 1
    opt = step.optimizer
    key = next(iter(opt._accumulators))
    opt._accumulators[key] = opt._accumulators[key].clone()
    assert torch.equal(step(ids, labels), ref(ids, labels))
    assert step.captures == 2
    p = next(model.parameters())
    p.data = p.data.clone()
    assert torch.equal(step(ids, labels), ref(ids, labels))
    assert step.captures == 3
    assert torch.equal(step(ids, labels), ref(ids, labels))
    assert step.captures == 3


def test_state_dict_round_trips_between_steps():
    """Two steps, then the model's and the optimizer's state into a fresh
    model, optimizer and TrainStep (set_state_dict creates the
    accumulators from the saved values): both go on bit for bit."""
    ids, labels = _batch(7)
    model = _model("bfloat16", seed=8)
    step = TrainStep(model, _adamw(model), _loss_fn)
    for _ in range(2):
        step(ids, labels)
        step.optimizer._lr_scheduler.step()
    state = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in step.optimizer.state_dict().items()}
    other = _model("bfloat16", seed=9)
    other.load_state_dict(model.state_dict())
    opt2 = _adamw(other)
    opt2.set_state_dict(state)
    step2 = TrainStep(other, opt2, _loss_fn)
    assert opt2.get_lr() == step.optimizer.get_lr()
    for _ in range(2):
        assert torch.equal(step(ids, labels), step2(ids, labels))
        step.optimizer._lr_scheduler.step()
        opt2._lr_scheduler.step()
    _assert_same(_state(step), _state(step2))
