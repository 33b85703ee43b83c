"""The port's training path against the JAX package's, on the CPU.

Both sides get the same numpy inputs made from a seed; models share their
weights through ``paddle_tpu_torch.convert.load_jax_state_dict``.
Tolerances, with their reasons:

- f32 losses, optimizer states and clipped grads: 1e-6 relative (the same
  operations, summed in other orders);
- bf16 parameters after an update: one bf16 ulp, 2**-8 relative (the f32
  masters agree to 1e-6, and a cast may round either way at a tie);
- first-step gradients of the whole model: relative L2 1e-4 (two layers
  of f32 matmuls and the flash backward, summed in other orders);
- the 5-step loss curve: relative 1e-3 (Adam's sign-like first steps turn
  last-bit gradient differences into whole learning-rate steps on the
  elements whose gradient is near 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
import paddle_tpu.optimizer as jopt
from paddle_tpu._core.tensor import Parameter, Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.nn.clip import clip_grad_norm_ as jclip_grad_norm_

import paddle_tpu_torch
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, clip_grad_norm_
from paddle_tpu_torch.nn import functional as tF

F32_TOL = 1e-6
BF16_ULP = 2.0 ** -8
GRAD_REL_L2 = 1e-4
CURVE_REL = 1e-3
VOCAB = 1024


def _jnp(a):
    return jnp.asarray(a)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------- cross entropy

def _ce_inputs(seed=0, rows=12, classes=10):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((rows, classes)).astype(np.float32)
    labels = rng.integers(0, classes, rows).astype(np.int64)
    labels[[1, 5, 6]] = -100
    weight = rng.uniform(0.5, 2.0, classes).astype(np.float32)
    return logits, labels, weight


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("extra", ["plain", "weight", "label_smoothing"])
def test_cross_entropy_matches_jax(reduction, extra):
    logits, labels, weight = _ce_inputs()
    kw = {"weight": weight} if extra == "weight" else {}
    smooth = 0.1 if extra == "label_smoothing" else 0.0
    want = jF.cross_entropy(Tensor(_jnp(logits)), Tensor(_jnp(labels)),
                            weight=Tensor(_jnp(weight)) if kw else None,
                            reduction=reduction, label_smoothing=smooth)
    tl = torch.from_numpy(logits).requires_grad_()
    got = tF.cross_entropy(tl, torch.from_numpy(labels),
                           weight=torch.from_numpy(weight) if kw else None,
                           reduction=reduction, label_smoothing=smooth)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._value),
                               rtol=F32_TOL, atol=F32_TOL)
    got.sum().backward()
    assert not tl.grad[[1, 5, 6]].any()  # ignored rows get no gradient


def test_cross_entropy_all_ignored_and_soft_labels():
    logits, labels, _ = _ce_inputs()
    got = tF.cross_entropy(torch.from_numpy(logits), torch.full((12,), -100))
    assert float(got) == 0.0  # mean over max(count, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(logits), soft_label=True)


# ---------------------------------------------------------------- optimizers

def _param_arrays(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "norm": (5,)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        cast = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
        params = {n: cast(a) for n, a in params.items()}
        grads = [{n: cast(a) for n, a in g.items()} for g in grads]
    return params, grads


def _run_both(make_j, make_t, dtype, seed=1):
    params, grads = _param_arrays(seed, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jps, tps = [], []
    for name, a in params.items():
        jps.append(Parameter(jnp.asarray(a, jdt), name=name))
        tps.append(torch.nn.Parameter(torch.from_numpy(a.copy()).to(tdt)))
    # the port names its parameters by (name, param) pairs
    jo, to = make_j(jps), make_t(list(zip(params, tps)))
    for g in grads:
        for jp, tp, name in zip(jps, tps, params):
            jp.grad = Tensor(jnp.asarray(g[name], jdt))
            tp.grad = torch.from_numpy(g[name].copy()).to(tdt)
        jo.step()
        jo.clear_grad()
        to.step()
        to.clear_grad()
    return jps, tps, jo, to


def _no_decay_on_norm(name):
    return name != "norm"


OPTIMIZERS = {
    "adamw": (lambda ps: jopt.AdamW(0.05, parameters=ps, weight_decay=0.1,
                                    apply_decay_param_fun=_no_decay_on_norm),
              lambda ps: topt.AdamW(0.05, parameters=ps, weight_decay=0.1,
                                    apply_decay_param_fun=_no_decay_on_norm)),
    "adam_l2": (lambda ps: jopt.Adam(0.05, parameters=ps, weight_decay=0.1),
                lambda ps: topt.Adam(0.05, parameters=ps, weight_decay=0.1)),
    "sgd": (lambda ps: jopt.SGD(0.05, parameters=ps),
            lambda ps: topt.SGD(0.05, parameters=ps)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_jax(kind, dtype):
    jps, tps, jo, to = _run_both(*OPTIMIZERS[kind], dtype)
    for jp, tp in zip(jps, tps):
        want = np.asarray(jp._value.astype(jnp.float32))
        tol = BF16_ULP if dtype == "bfloat16" else F32_TOL
        np.testing.assert_allclose(tp.detach().float().numpy(), want, rtol=tol, atol=tol)
    jstate, tstate = jo.state_dict(), to.state_dict()
    assert list(tstate) == list(jstate)
    for key, jt in jstate.items():
        if key == "LR_Scheduler":  # JAX keeps the rate as an f32 scalar
            assert tstate[key] == pytest.approx(jt, rel=F32_TOL)
            continue
        if key == "step_count":
            assert tstate[key] == jt == 3
            continue
        # moments, beta powers and the f32 masters of bf16 parameters
        np.testing.assert_allclose(tstate[key].float().numpy(), np.asarray(jt._value),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=key)
    if dtype == "bfloat16" and kind != "sgd":
        assert "master_weight_0" in tstate and tstate["master_weight_0"].dtype == torch.float32


def test_adamw_decay_switch_and_lr_ratio():
    """apply_decay_param_fun keeps the decay off the named parameter;
    lr_ratio scales one parameter's step."""
    w = torch.nn.Parameter(torch.ones(3))
    u = torch.nn.Parameter(torch.ones(3))
    opt = topt.AdamW(0.1, parameters=[("norm", w), u], weight_decay=0.5,
                     apply_decay_param_fun=_no_decay_on_norm,
                     lr_ratio=lambda p: 0.5 if p is u else 1.0)
    w.grad, u.grad = torch.zeros(3), torch.zeros(3)
    opt.step()
    torch.testing.assert_close(w.detach(), torch.ones(3))  # no grad, no decay
    torch.testing.assert_close(u.detach(), torch.full((3,), 1 - 0.05 * 0.5))


def test_lr_schedulers_match_jax():
    pairs = [
        (jopt.lr.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01),
         topt.lr.CosineAnnealingDecay(0.1, T_max=7, eta_min=0.01)),
        (jopt.lr.LinearWarmup(jopt.lr.CosineAnnealingDecay(0.1, T_max=6), 4, 0.0, 0.1),
         topt.lr.LinearWarmup(topt.lr.CosineAnnealingDecay(0.1, T_max=6), 4, 0.0, 0.1)),
        (jopt.lr.LinearWarmup(0.05, 3, 0.01, 0.1), topt.lr.LinearWarmup(0.05, 3, 0.01, 0.1)),
    ]
    for js, ts in pairs:
        got, want = [], []
        for _ in range(10):
            got.append(ts.get_lr())
            want.append(js.get_lr())
            ts.step()
            js.step()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        assert ts.state_dict() == js.state_dict()
    # an optimizer reads its scheduler at each step
    p = torch.nn.Parameter(torch.zeros(2))
    sched = topt.lr.LinearWarmup(0.5, 2, 0.0, 0.5)
    opt = topt.SGD(sched, parameters=[p])
    assert opt.get_lr() == 0.0
    sched.step()
    assert opt.get_lr() == 0.25
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)


def test_clip_grad_by_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) * 3 for s in ((4, 3), (5,), (2, 2))]
    jps = [Parameter(jnp.zeros(g.shape)) for g in grads]
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    jps[2].need_clip = False
    tps[2].need_clip = False
    want = JClip(1.5)([(p, Tensor(_jnp(g))) for p, g in zip(jps, grads)])
    got = ClipGradByGlobalNorm(1.5)([(p, torch.from_numpy(g)) for p, g in zip(tps, grads)])
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._value), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(got[2][1].numpy(), grads[2])  # need_clip=False untouched
    # as an optimizer's grad_clip
    opt = topt.SGD(1.0, parameters=tps, grad_clip=ClipGradByGlobalNorm(1.5))
    for p, g in zip(tps, grads):
        p.grad = torch.from_numpy(g.copy())
    opt.step()
    np.testing.assert_allclose(-tps[0].detach().numpy(), np.asarray(want[0][1]._value),
                               rtol=F32_TOL, atol=F32_TOL)
    # clip_grad_norm_ returns the norm before clipping and scales in place
    for p, jp, g in zip(tps, jps, grads):
        p.grad = torch.from_numpy(g.copy())
        jp.grad = Tensor(_jnp(g))
    total = clip_grad_norm_(tps, 2.0)
    jtotal = jclip_grad_norm_(jps, 2.0)
    np.testing.assert_allclose(float(total), float(jtotal._value), rtol=F32_TOL)
    for p, jp in zip(tps, jps):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp.grad._value),
                                   rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------ the whole model

def _models(seed=11, **cfg):
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(dtype="float32", **cfg))
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(dtype="float32", **cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, b, s):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (b, s)).astype(np.int64)
    labels[0, :3] = -100
    return ids, labels


def _loss_fn(m, ids, labels):
    return m(ids, labels=labels)[0]


def test_first_step_gradients_match_jax():
    jm, tm = _models()
    ids, labels = _batch(0, 2, 32)
    jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    jloss.backward()
    tloss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tloss.backward()
    assert logits.shape == (2, 32, VOCAB)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss._value), rtol=F32_TOL)
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    tnamed = dict(tm.named_parameters())
    assert set(tnamed) == set(jgrads)
    for name, p in tnamed.items():
        assert _rel_l2(p.grad.numpy(), jgrads[name]) <= GRAD_REL_L2, name


def _curves(steps, ids, labels, **cfg):
    jm, tm = _models(**cfg)
    jo = jopt.AdamW(1e-3, parameters=jm.parameters(), weight_decay=0.01)
    to = topt.AdamW(1e-3, parameters=tm.parameters(), weight_decay=0.01)
    jstep, tstep = JTrainStep(jm, jo, _loss_fn), TrainStep(tm, to, _loss_fn)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))._value)
          for _ in range(steps)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(labels))) for _ in range(steps)]
    return jm, tm, jo, to, jl, tl


def test_train_step_loss_curve_matches_jax():
    ids, labels = _batch(1, 2, 32)
    _, tm, jo, to, jl, tl = _curves(5, ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=CURVE_REL)
    assert tl[-1] < tl[0]
    assert all(p.grad is None for p in tm.parameters())  # cleared after each step
    assert list(to.state_dict()) == list(jo.state_dict())
    assert to.state_dict()["step_count"] == 5


def test_train_step_with_pallas_kernels_matches_jax():
    """FLAGS_use_pallas on: the JAX step runs its Pallas forward and flash
    backward kernels in interpret mode inside the whole model (128 tokens,
    one full flash block)."""
    ids, labels = _batch(2, 1, 128)
    prev = paddle.get_flags(["FLAGS_use_pallas"])["FLAGS_use_pallas"]
    paddle.set_flags({"FLAGS_use_pallas": "true"})
    try:
        jm, tm, _, _, jl, tl = _curves(1, ids, labels, num_hidden_layers=1)
        jafter = float(jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))[0]._value)
    finally:
        paddle.set_flags({"FLAGS_use_pallas": prev})
    with torch.no_grad():
        tafter = float(tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))[0])
    np.testing.assert_allclose(tl, jl, rtol=F32_TOL)
    np.testing.assert_allclose(tafter, jafter, rtol=CURVE_REL)


def test_optimizer_state_dict_round_trip():
    """A bf16 model's AdamW state (f32 masters, moments, beta powers, the
    scheduler) reloads into a fresh optimizer and continues identically."""
    g = torch.Generator().manual_seed(0)
    cfg = tllama.llama_tiny(num_hidden_layers=1, dtype="bfloat16")
    models = [tllama.LlamaForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
              for _ in range(2)]
    ids = torch.randint(0, VOCAB, (1, 16), generator=g)
    opts = [topt.AdamW(topt.lr.CosineAnnealingDecay(1e-3, T_max=10), parameters=m.parameters())
            for m in models]
    steps = [TrainStep(m, o, _loss_fn) for m, o in zip(models, opts)]
    steps[0](ids, ids)
    opts[0]._lr_scheduler.step()
    state = opts[0].state_dict()
    n = len(list(models[0].parameters()))
    assert [k for k in state if k.endswith("_0")] == [
        "master_weight_0", "moment1_0", "moment2_0", "beta1_pow_0", "beta2_pow_0"]
    assert len(state) == 5 * n + 2 and state["step_count"] == 1
    models[1].load_state_dict(models[0].state_dict())
    opts[1].set_state_dict(state)
    assert opts[1].get_lr() == opts[0].get_lr()
    a, b = steps[0](ids, ids), steps[1](ids, ids)
    assert float(a) == float(b)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(p, q)


def test_unported_options_raise_naming_the_roadmap():
    _, tm = _models(num_hidden_layers=1)
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainStep(tm, opt, _loss_fn, scaler=object())
    step = TrainStep(tm, opt, _loss_fn)
    for method in (step.lower, step.warmup):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            method()
    p = torch.nn.Parameter(torch.zeros(4, 2))
    p.grad = torch.zeros(4, 2).to_sparse()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.SGD(0.1, parameters=[p]).step()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.Adam(0.1, parameters=[p], weight_decay=object())


def test_device_helpers_on_the_cpu():
    paddle_tpu_torch.device.synchronize("cpu")
