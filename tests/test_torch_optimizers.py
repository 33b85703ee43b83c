"""The optimizer tier's remainder against the JAX package, on the CPU: the
ten optimizers, the regularizers and ``ParamAttr``, the LR schedulers,
the clip classes and soft-label cross entropy.

Both sides get the same numpy weights and gradients.  Tolerances, with
their reasons:

- f32 parameters and optimizer state after 6 eager steps: 1e-5 relative
  and absolute (the same f32 operations; Lamb's norms and RAdam's
  rectification summed or raised in another order);
- bf16 parameters: one bf16 ulp, 2**-8 relative (their f32 masters agree
  as above, and a cast may round either way at a tie); state kept in
  bf16 (Momentum's velocity of a bf16 gradient): one bf16 ulp;
- schedulers: 1e-12 relative (the same Python float arithmetic);
- clipped gradients and losses: 1e-6 relative (f32, other summation
  orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu.nn.functional as jF
import paddle_tpu.optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu._core.tensor import Parameter, Tensor
from paddle_tpu.nn import Linear as JLinear
from paddle_tpu.nn import ParamAttr as JParamAttr
from paddle_tpu.nn import clip as jclip

import paddle_tpu_torch
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn import Linear, ParamAttr
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import functional as tF

F32_TOL = 1e-5
BF16_ULP = 2.0 ** -8
SCHED_REL = 1e-12
CLIP_TOL = 1e-6
STEPS = 6  # past RAdam's rho_t > 4 boundary (rectified from t = 5 at beta2 0.999)


def _arrays(seed, dtype, steps=STEPS):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "norm": (5,)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(steps)]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        cast = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
        params = {n: cast(a) for n, a in params.items()}
        grads = [{n: cast(a) for n, a in g.items()} for g in grads]
    return params, grads


def _params(params, dtype, jattrs=None):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jps = [Parameter(jnp.asarray(a, jdt), name=n) for n, a in params.items()]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(tdt)) for a in params.values()]
    for (jp, tp), attrs in zip(zip(jps, tps), jattrs or [{}] * len(jps)):
        for k, (jv, tv) in attrs.items():
            setattr(jp, k, jv)
            setattr(tp, k, tv)
    return jps, tps, jdt, tdt


def _run(make_j, make_t, dtype, seed=1, steps=STEPS, attrs=None):
    """Both optimizers over the same weights and gradients, eager."""
    params, grads = _arrays(seed, dtype, steps)
    jps, tps, jdt, tdt = _params(params, dtype, attrs)
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


def _check(jps, tps, jo, to, dtype):
    tol = BF16_ULP if dtype == "bfloat16" else F32_TOL
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   np.asarray(jp._value.astype(jnp.float32)), rtol=tol, atol=tol)
    jstate, tstate = jo.state_dict(), to.state_dict()
    assert set(jstate) <= set(tstate)
    for key, jt in jstate.items():
        if key in ("LR_Scheduler", "step_count"):
            continue
        want = np.asarray(jt._value.astype(jnp.float32))
        stol = BF16_ULP if tstate[key].dtype == torch.bfloat16 else F32_TOL
        np.testing.assert_allclose(tstate[key].float().numpy(), want, rtol=stol, atol=stol,
                                   err_msg=key)
    assert tstate["step_count"] == jstate["step_count"]


def _exclude_norm_j(p):
    return p.name == "norm"


def _exclude_norm_t(name):
    return name == "norm"


OPTIMIZERS = {
    "momentum": (lambda ps: jopt.Momentum(0.05, momentum=0.9, parameters=ps),
                 lambda ps: topt.Momentum(0.05, momentum=0.9, parameters=ps)),
    "momentum_nesterov_l2": (
        lambda ps: jopt.Momentum(0.05, parameters=ps, use_nesterov=True, weight_decay=0.01),
        lambda ps: topt.Momentum(0.05, parameters=ps, use_nesterov=True, weight_decay=0.01)),
    "adagrad": (lambda ps: jopt.Adagrad(0.1, parameters=ps, initial_accumulator_value=0.1),
                lambda ps: topt.Adagrad(0.1, parameters=ps, initial_accumulator_value=0.1)),
    "adadelta": (lambda ps: jopt.Adadelta(1.0, parameters=ps),
                 lambda ps: topt.Adadelta(1.0, parameters=ps)),
    "rmsprop": (lambda ps: jopt.RMSProp(0.01, parameters=ps),
                lambda ps: topt.RMSProp(0.01, parameters=ps)),
    "rmsprop_centered_momentum": (
        lambda ps: jopt.RMSProp(0.01, parameters=ps, momentum=0.9, centered=True),
        lambda ps: topt.RMSProp(0.01, parameters=ps, momentum=0.9, centered=True)),
    "lamb": (lambda ps: jopt.Lamb(0.02, parameters=ps,
                                  exclude_from_weight_decay_fn=_exclude_norm_j),
             lambda ps: topt.Lamb(0.02, parameters=ps,
                                  exclude_from_weight_decay_fn=_exclude_norm_t)),
    "adamax": (lambda ps: jopt.Adamax(0.02, parameters=ps),
               lambda ps: topt.Adamax(0.02, parameters=ps)),
    "nadam": (lambda ps: jopt.NAdam(0.02, parameters=ps),
              lambda ps: topt.NAdam(0.02, parameters=ps)),
    "radam": (lambda ps: jopt.RAdam(0.02, parameters=ps),
              lambda ps: topt.RAdam(0.02, parameters=ps)),
    "asgd": (lambda ps: jopt.ASGD(0.05, parameters=ps),
             lambda ps: topt.ASGD(0.05, parameters=ps)),
    "rprop": (lambda ps: jopt.Rprop(0.01, parameters=ps),
              lambda ps: topt.Rprop(0.01, parameters=ps)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizer_six_steps_match_reference(kind, dtype):
    _check(*_run(*OPTIMIZERS[kind], dtype), dtype)


def test_radam_counts_its_steps_on_the_device():
    """RAdam's step is an int64 accumulator per parameter (no host read).
    Its first 4 steps take the plain branch (rho_t <= 4 at beta2 0.999),
    steps 5-8 the rectified one: both the reference's."""
    jps, tps, jo, to = _run(*OPTIMIZERS["radam"], "float32", steps=4)
    assert int(to.state_dict()["step_0"]) == 4
    _check(jps, tps, jo, to, "float32")
    for _ in range(4):
        for jp, tp in zip(jps, tps):
            g = np.full(tuple(tp.shape), 0.5, np.float32)
            jp.grad, tp.grad = Tensor(jnp.asarray(g)), torch.from_numpy(g)
        jo.step()
        to.step()
    assert int(to.state_dict()["step_1"]) == 8
    _check(jps, tps, jo, to, "float32")


# ---------------------------------------------------------- regularizers

REGULARIZED = {
    "sgd_l1": (lambda ps: jopt.SGD(0.1, parameters=ps, weight_decay=jreg.L1Decay(0.05)),
               lambda ps: topt.SGD(0.1, parameters=ps, weight_decay=treg.L1Decay(0.05)), None),
    "momentum_l2_object": (
        lambda ps: jopt.Momentum(0.1, parameters=ps, weight_decay=jreg.L2Decay(0.05)),
        lambda ps: topt.Momentum(0.1, parameters=ps, weight_decay=treg.L2Decay(0.05)), None),
    # the parameter's own L1 before the optimizer's L2; the other takes L2
    "per_param_precedence": (
        lambda ps: jopt.SGD(0.1, parameters=ps, weight_decay=0.5),
        lambda ps: topt.SGD(0.1, parameters=ps, weight_decay=0.5),
        [{"regularizer": (jreg.L1Decay(0.2), treg.L1Decay(0.2))}, {}]),
    # a zero coefficient turns the optimizer's term off for that parameter
    "zero_coeff_disables": (
        lambda ps: jopt.Adagrad(0.1, parameters=ps, weight_decay=0.5),
        lambda ps: topt.Adagrad(0.1, parameters=ps, weight_decay=0.5),
        [{"regularizer": (jreg.L2Decay(0.0), treg.L2Decay(0.0))}, {}]),
    # AdamW skips the optimizer-level term but keeps a parameter's own
    "adamw_skips_optimizer_term": (
        lambda ps: jopt.AdamW(0.05, parameters=ps, weight_decay=jreg.L2Decay(0.1)),
        lambda ps: topt.AdamW(0.05, parameters=ps, weight_decay=treg.L2Decay(0.1)),
        [{}, {"regularizer": (jreg.L1Decay(0.3), treg.L1Decay(0.3))}]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(REGULARIZED))
def test_regularizers_match_reference(kind, dtype):
    make_j, make_t, attrs = REGULARIZED[kind]
    _check(*_run(make_j, make_t, dtype, steps=4, attrs=attrs), dtype)


def test_regularizer_resolution_and_refusals():
    p = torch.nn.Parameter(torch.ones(3))
    p.regularizer = treg.L2Decay(0.0)
    opt = topt.SGD(1.0, parameters=[p], weight_decay=0.5)
    p.grad = torch.zeros(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))  # disabled: no decay at all
    with pytest.raises(TypeError):
        topt.AdamW(0.1, parameters=[p], weight_decay=treg.L1Decay(0.1))
    with pytest.raises(TypeError):
        topt.SGD(0.1, parameters=[p], weight_decay=object())
    assert repr(treg.L1Decay(0.5)) == "L1Decay(coeff=0.5)"


def test_param_attr_sets_regularizer_need_clip_and_trainable():
    """ParamAttr on a Linear as on the reference's: the weight's L1 and
    no-clip, a frozen bias; four SGD steps with L2 decay and global-norm
    clipping then match the reference's."""
    def attrs(pa, reg):
        return (pa(regularizer=reg.L1Decay(0.1), need_clip=False, learning_rate=0.5),
                pa(trainable=False))

    jl = JLinear(4, 3, *attrs(JParamAttr, jreg))
    tl = Linear(4, 3, *attrs(ParamAttr, treg), device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight._value)))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias._value)))
    assert isinstance(tl.weight.regularizer, treg.L1Decay) and tl.weight.need_clip is False
    assert not tl.bias.requires_grad
    assert jl.bias.stop_gradient
    jo = jopt.SGD(0.1, parameters=jl.parameters(), weight_decay=0.2,
                  grad_clip=jclip.ClipGradByGlobalNorm(0.5))
    to = topt.SGD(0.1, parameters=tl.parameters(), weight_decay=0.2,
                  grad_clip=tclip.ClipGradByGlobalNorm(0.5))
    rng = np.random.default_rng(0)
    for _ in range(4):
        g = rng.standard_normal((4, 3)).astype(np.float32) * 3
        jl.weight.grad, tl.weight.grad = Tensor(jnp.asarray(g)), torch.from_numpy(g)
        jo.step()
        to.step()
    np.testing.assert_allclose(tl.weight.detach().numpy(), np.asarray(jl.weight._value),
                               rtol=F32_TOL, atol=F32_TOL)
    assert paddle_tpu_torch.ParamAttr is ParamAttr
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.7"):
        Linear(4, 3, weight_attr=ParamAttr(initializer=object()), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.7"):
        Linear(4, 3, weight_attr=object(), device="cpu")
    named = Linear(4, 3, weight_attr="fc_w", bias_attr=False, device="cpu")
    assert named.bias is None and named.weight.requires_grad
    # weight_attr=False on a layer that always builds its weight keeps the defaults
    kept = Linear(4, 3, weight_attr=False, device="cpu").weight
    assert kept.requires_grad and kept.regularizer is None and kept.need_clip


# ------------------------------------------------------------ schedulers

def _sched_pairs():
    def both(name, *args, **kw):
        return getattr(jopt.lr, name)(*args, **kw), getattr(topt.lr, name)(*args, **kw)

    return [
        both("NoamDecay", 64, 10, 2.0),
        both("ExponentialDecay", 0.1, 0.9),
        both("NaturalExpDecay", 0.1, 0.2),
        both("InverseTimeDecay", 0.1, 0.3),
        both("PolynomialDecay", 0.1, 12, 0.001, 2.0),
        both("PolynomialDecay", 0.1, 7, cycle=True),
        both("PiecewiseDecay", [5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
        both("CosineAnnealingWarmRestarts", 0.1, 4, T_mult=2, eta_min=0.001),
        both("StepDecay", 0.1, 6, gamma=0.5),
        both("MultiStepDecay", 0.1, [3, 10, 25], gamma=0.3),
        both("LambdaDecay", 0.1, lambda e: 0.95 ** e),
        both("MultiplicativeDecay", 0.1, lambda e: 0.9),
        both("OneCycleLR", 0.1, 30),
        both("OneCycleLR", 0.1, 25, anneal_strategy="linear", phase_pct=0.4),
        both("CyclicLR", 0.01, 0.1, 4, step_size_down=6),
        both("CyclicLR", 0.01, 0.1, 5, mode="triangular2"),
        both("CyclicLR", 0.01, 0.1, 3, mode="exp_range", exp_gamma=0.97),
        both("LinearLR", 0.1, 12, start_factor=0.25),
        both("ConstantLR", 0.1, factor=0.5, total_steps=7),
    ]


def test_lr_schedulers_match_reference():
    for js, ts in _sched_pairs():
        got, want = [], []
        for _ in range(36):
            got.append(ts.get_lr())
            want.append(js.get_lr())
            ts.step()
            js.step()
        np.testing.assert_allclose(got, want, rtol=SCHED_REL, atol=0, err_msg=type(ts).__name__)
        assert ts.state_dict().keys() == js.state_dict().keys()
        assert len(set(got)) > 1, type(ts).__name__


def test_reduce_on_plateau_fed_a_metric_sequence():
    metrics = [1.0, 0.9, 0.9, 0.91, 0.95, 0.9, 0.89999, 1.2, 0.5, 0.5, 0.6, 0.7, 0.8, 0.55,
               0.5, 0.49, 0.6, 0.7, 0.8, 0.9, 1.0, 0.3, 0.31, 0.32, 0.33, 0.34, 0.35, 0.36,
               0.37, 0.38]
    for kw in ({"patience": 2}, {"patience": 1, "cooldown": 2, "factor": 0.5},
               {"mode": "max", "patience": 1, "threshold_mode": "abs", "min_lr": 0.02}):
        js = jopt.lr.ReduceOnPlateau(0.1, **kw)
        ts = topt.lr.ReduceOnPlateau(0.1, **kw)
        got, want = [], []
        for m in metrics:
            ts.step(m)
            js.step(m)
            got.append(ts.get_lr())
            want.append(js.get_lr())
        assert got == want and len(set(got)) > 1, kw
        assert ts.state_dict() == js.state_dict()
    # the optimizer reads the plateau's rate at each step
    p = torch.nn.Parameter(torch.zeros(2))
    sched = topt.lr.ReduceOnPlateau(0.2, patience=0)
    opt = topt.SGD(sched, parameters=[p])
    sched.step(torch.tensor(1.0))  # a tensor metric is read with .item()
    sched.step(torch.tensor(2.0))
    p.grad = torch.ones(2)
    opt.step()
    assert opt.get_lr() == pytest.approx(0.02) and float(opt._lr_t) == pytest.approx(0.02)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.3.3"):
        topt.LBFGS(parameters=[p])


# ----------------------------------------------------------------- clips

def test_clip_classes_match_reference_and_honour_need_clip():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) * 3 for s in ((4, 3), (5,), (2, 2))]
    jps = [Parameter(jnp.zeros(g.shape)) for g in grads]
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    jps[1].need_clip = tps[1].need_clip = False
    for jc, tc in ((jclip.ClipGradByValue(1.0), tclip.ClipGradByValue(1.0)),
                   (jclip.ClipGradByValue(0.5, min=-2.0), tclip.ClipGradByValue(0.5, min=-2.0)),
                   (jclip.ClipGradByNorm(1.5), tclip.ClipGradByNorm(1.5)),
                   (jclip.ClipGradByNorm(100.0), tclip.ClipGradByNorm(100.0)),
                   (jclip.ClipGradByGlobalNorm(2.0), tclip.ClipGradByGlobalNorm(2.0))):
        want = jc([(p, Tensor(jnp.asarray(g))) for p, g in zip(jps, grads)])
        got = tc([(p, torch.from_numpy(g)) for p, g in zip(tps, grads)])
        for (_, w), (_, g) in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w._value), rtol=CLIP_TOL,
                                       atol=CLIP_TOL)
        np.testing.assert_array_equal(got[1][1].numpy(), grads[1])  # need_clip=False
    bf = tclip.ClipGradByNorm(1.0)([(tps[0], torch.from_numpy(grads[0]).bfloat16())])
    assert bf[0][1].dtype == torch.bfloat16
    # clip_grad_value_ clamps .grad in place
    for jp, tp, g in zip(jps, tps, grads):
        jp.grad, tp.grad = Tensor(jnp.asarray(g)), torch.from_numpy(g.copy())
    jclip.clip_grad_value_(jps, 0.7)
    tclip.clip_grad_value_(tps, 0.7)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(jp.grad._value))


# --------------------------------------------------------- soft labels

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_soft_label_cross_entropy_matches_reference(reduction, smoothing):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 3, 10)).astype(np.float32)
    soft = rng.dirichlet(np.ones(10), (6, 3)).astype(np.float32)
    want = jF.cross_entropy(Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(soft)),
                            soft_label=True, reduction=reduction, label_smoothing=smoothing)
    tl = torch.from_numpy(logits).requires_grad_()
    got = tF.cross_entropy(tl, torch.from_numpy(soft), soft_label=True, reduction=reduction,
                           label_smoothing=smoothing)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._value), rtol=CLIP_TOL,
                               atol=CLIP_TOL)
    got.sum().backward()  # d/dlogits = softmax * sum(soft) - soft, per row
    assert torch.isfinite(tl.grad).all()
    # a label of the input's shape is soft without the flag
    np.testing.assert_allclose(
        tF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                         reduction=reduction).numpy(),
        np.asarray(jF.cross_entropy(Tensor(jnp.asarray(logits)), Tensor(jnp.asarray(soft)),
                                    reduction=reduction)._value), rtol=CLIP_TOL, atol=CLIP_TOL)


@pytest.mark.parametrize("soft_label", [False, True])
def test_softmax_with_cross_entropy_matches_reference(soft_label):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((8, 7)).astype(np.float32)
    if soft_label:
        label = rng.dirichlet(np.ones(7), 8).astype(np.float32)
    else:
        label = rng.integers(0, 7, (8, 1)).astype(np.int64)
        label[[2, 5]] = -100
    jl, jsm = jF.softmax_with_cross_entropy(Tensor(jnp.asarray(logits)),
                                            Tensor(jnp.asarray(label)), soft_label=soft_label,
                                            return_softmax=True)
    tl, tsm = tF.softmax_with_cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                                            soft_label=soft_label, return_softmax=True)
    assert tl.shape == (8, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._value), rtol=CLIP_TOL, atol=CLIP_TOL)
    np.testing.assert_allclose(tsm.numpy(), np.asarray(jsm._value), rtol=CLIP_TOL,
                               atol=CLIP_TOL)
    one = tF.softmax_with_cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                                        soft_label=soft_label)
    assert torch.equal(one, tl)


# ----------------------------------------------------- the scaler's skip

@pytest.mark.parametrize("kind", ["momentum", "adagrad", "adadelta", "rmsprop_centered_momentum",
                                  "lamb", "adamax", "nadam", "radam", "asgd", "rprop"])
def test_scaler_skip_leaves_every_state_tensor(kind):
    """Two finite steps through a GradScaler create and move every
    accumulator of a bf16 and an f32 parameter; an inf step then leaves
    each parameter, master and accumulator bit for bit (every write a
    select, ``Optimizer._put``)."""
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(6, 5).bfloat16())
    b = torch.nn.Parameter(torch.randn(5))
    opt = OPTIMIZERS[kind][1]([("w", w), ("norm", b)])
    scaler = tamp.GradScaler(init_loss_scaling=8.0, device="cpu")
    x = torch.randn(3, 6)

    def loss_of(xx):
        return ((xx @ w.float() + b) ** 2).mean()

    for xx in (x, x * 2):
        scaler.scale(loss_of(xx)).backward()
        scaler.step(opt)
        opt.clear_grad()
    state = [t.clone() for t in [w, b] + opt.opt_state_tensors()]
    assert len(state) > 3
    scaler.scale(loss_of(torch.full_like(x, float("inf")))).backward()
    scaler.step(opt)
    opt.clear_grad()
    for a, t in zip(state, [w, b] + opt.opt_state_tensors(), strict=True):
        assert torch.equal(a, t)
    assert scaler.get_loss_scaling() == 4.0
