"""The port's ResNet family (``vision.models``) against the JAX package's,
on the CPU, and the running statistics inside the port's ``TrainStep``.

The reference models are built under a global initializer that returns
zeros from numpy (the JAX package's KaimingUniform compiles a draw for
each convolution shape, ~0.6 s each on a CPU); the weights both sides start
from are the port's own seeded initialisation, set into the reference
and carried back into the port by ``convert.load_jax_state_dict``.  The
initial arrays serve the module; each test builds its own reference.

The training case runs at [2, 3, 64, 64]: at 32 x 32 the last stage's
BatchNorms normalise 2 values a channel (1 x 1 maps, batch 2), where a
rounding of either input moves the output by ~1e-2, so no f32 tolerance
could hold there.  At 64 x 64 they see 8.  Tolerances, with their
reasons:

- f32: 2e-5 relative L2 for the losses, every parameter, velocity and
  running statistic after 3 steps, and the eval logits (f32 convolutions
  and reductions summed in other orders); 2e-5 of the largest magnitude
  for the block and the keys' tests;
- O1 bf16: 2e-2 of max(|loss|, 1) for the losses; the rest within twice
  the reference's own spread between its O1 and f32 runs (the training
  test's docstring says why).
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu._core import autograd as jautograd
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision import models as jmodels

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.vision import models as tmodels
from _torch_threads import _one_thread  # noqa: F401


F32_REL = 2e-5
O1_REL = 2e-2
BATCH = (2, 3, 64, 64)
LR = 0.01
FACTORIES = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
             "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
             "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2"]


class _Zeros(jinit.Initializer):
    def _init_value(self, shape, dtype):
        return np.zeros(shape, dtype)


@contextlib.contextmanager
def _zero_init():
    jinit.set_global_initializer(_Zeros(), _Zeros())
    try:
        yield
    finally:
        jinit.set_global_initializer(None, None)


def _numpy_state(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def init18():
    """The arrays every case starts from: the port's resnet18(num_classes=10)
    KaimingUniform initialisation from seed 0."""
    g = torch.Generator().manual_seed(0)
    return {k: v.numpy().copy() for k, v in
            tmodels.resnet18(num_classes=10, device="cpu", generator=g).state_dict().items()}


def _pair(init):
    """A reference resnet18 of the test's own (a test may cast it, or
    compile it with ``paddle.jit.to_static``, which converts its forward in
    place) set to ``init``, and a port model loaded from the reference's
    state dict by ``convert.load_jax_state_dict``."""
    with _zero_init():
        jm = jmodels.resnet18(num_classes=10)
    missing, unexpected = jm.set_state_dict({k: paddle.to_tensor(v) for k, v in init.items()})
    assert not missing and not unexpected
    tm = tmodels.resnet18(num_classes=10, device="cpu")
    load_jax_state_dict(tm, _numpy_state(jm))
    return jm, tm


def _batch():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(BATCH).astype(np.float32),
            rng.integers(0, 10, (BATCH[0],)).astype(np.int32))


def _within(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-3), (what, err)


@pytest.mark.parametrize("factory", FACTORIES)
def test_factory_state_dict_keys_match_reference(factory):
    """Every factory's state-dict keys and shapes equal the JAX model's,
    buffers included (102 entries for resnet18); the port's is built on
    the meta device (no memory, no draws)."""
    with _zero_init():
        ref = {k: tuple(v.shape) for k, v in getattr(jmodels, factory)().state_dict().items()}
    port = {k: tuple(v.shape) for k, v in
            getattr(tmodels, factory)(device="meta").state_dict().items()}
    assert port == ref
    if factory == "resnet18":
        assert len(port) == 102 and "layer2.0.downsample.0.weight" in port
        assert "bn1._mean" in port and not any("num_batches" in k for k in port)


def test_pretrained_raises_and_features_only():
    """``pretrained=True`` raises in both packages; ``num_classes=0``
    without the pool returns the last stage's features."""
    for mod in (jmodels, tmodels):
        with pytest.raises(NotImplementedError, match="pretrained"):
            mod.resnet50(pretrained=True)
    m = tmodels.resnet18(num_classes=0, with_pool=False, device="cpu")
    assert not hasattr(m, "fc") and not hasattr(m, "avgpool")
    assert m(torch.zeros(1, 3, 64, 64)).shape == (1, 512, 2, 2)


def _train(model, steps, amp, ce, optimizer, o1, wrap, compiled=lambda m: m):
    """3 TrainStep steps of ``model`` (reference or port) from its current
    state; returns the losses and numpy copies of the state dict, the
    velocities and the eval logits.  ``compiled`` wraps the eval forward:
    the reference's is compiled whole by ``paddle.jit.to_static`` (which
    converts the model's forward in place, so the model is the test's
    own)."""
    opt = optimizer(LR, parameters=model.parameters())

    def fn(m, x, y):
        with amp.auto_cast(o1):
            return ce(m(x), y)

    step = steps(model, opt, fn)
    x, y = _batch()
    losses = [float(step(wrap(x), wrap(y))) for _ in range(3)]
    model.eval()
    with amp.auto_cast(o1):
        logits = compiled(model)(wrap(x))
    model.train()
    return {"losses": losses, "state": _as_numpy(model.state_dict()),
            "velocities": [_np(t) for t in opt.opt_state_tensors()[:-1]],
            "logits": _np(logits), "logits_dtype": str(getattr(logits, "_value", logits).dtype)}


def _np(t):
    if hasattr(t, "_value"):
        return np.asarray(t._value).astype(np.float64)
    return t.detach().double().numpy()


def _as_numpy(sd):
    return {k: _np(v) for k, v in sd.items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(run, init, kind):
    """One vector of a run's parameters' moves from ``init``, its running
    statistics or its velocities."""
    if kind == "velocities":
        return np.concatenate([v.ravel() for v in run["velocities"]])
    keys = [k for k in sorted(run["state"]) if ("._" in k) == (kind == "statistics")]
    return np.concatenate([(run["state"][k] - (init[k] if kind == "moves" else 0)).ravel()
                           for k in keys])


@pytest.mark.parametrize("o1", [False, True], ids=["f32", "o1_bf16"])
def test_resnet18_train_step_matches_reference(init18, o1):
    """resnet18(num_classes=10), 3 steps of TrainStep with Momentum(0.01)
    and CrossEntropyLoss on int32 labels, against the JAX package's
    compiled TrainStep from the same state, then the eval logits (from the
    running statistics).

    f32: the losses (2e-5 of max(|loss|, 1)), then every parameter,
    running statistic and velocity, and the logits, each within 2e-5
    relative L2.

    O1 bf16: at this size the bf16 rounding of each convolution's output,
    normalised by its BatchNorm over few values, moves the gradients
    30-60 % in either package (the reference's own O1 first-step
    gradients lie 45 % from its f32 ones, median over the parameters), so
    no per-tensor tolerance can hold.  Held instead: each loss within 2e-2
    of max(|loss|, 1), the logits in bf16, and the port's parameter moves,
    running statistics, velocities and logits within twice the distance
    of the reference's O1 run from an f32 run (two O1 runs round
    independently, each about that far from f32).  The f32 run is the
    port's, which the f32 case holds to the reference's within 2e-5.
    """
    init = {k: v.astype(np.float64) for k, v in init18.items()}
    jce, tce = paddle.nn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    jm, tm = _pair(init18)
    ref = _train(jm, JTrainStep, jamp, jce, paddle.optimizer.Momentum, o1, paddle.to_tensor,
                 paddle.jit.to_static)
    port = _train(tm, TrainStep, tamp, tce, topt.Momentum, o1, torch.from_numpy)
    if not o1:
        for a, b in zip(port["losses"], ref["losses"]):
            # a loss near 0 is -log of a probability near 1: its rounding is absolute
            assert abs(a - b) <= F32_REL * max(abs(b), 1.0), (port["losses"], ref["losses"])
        assert sorted(port["state"]) == sorted(ref["state"])
        for name in port["state"]:
            assert _rel_l2(port["state"][name], ref["state"][name]) <= F32_REL, name
        assert len(port["velocities"]) == len(ref["velocities"]) == 62  # one a parameter
        for i, (a, b) in enumerate(zip(port["velocities"], ref["velocities"])):
            assert _rel_l2(a, b) <= F32_REL, i
        assert _rel_l2(port["logits"], ref["logits"]) <= F32_REL
        return
    tm32 = tmodels.resnet18(num_classes=10, device="cpu")
    load_jax_state_dict(tm32, init18)
    f32 = _train(tm32, TrainStep, tamp, tce, topt.Momentum, False, torch.from_numpy)
    for a, b in zip(port["losses"], ref["losses"]):
        assert abs(a - b) <= O1_REL * max(abs(b), 1.0), (port["losses"], ref["losses"])
    assert port["logits_dtype"] == "torch.bfloat16" and ref["logits_dtype"] == "bfloat16"
    assert np.isfinite(port["logits"]).all()
    for kind in ("moves", "statistics", "velocities"):
        got, want, anchor = (_flat(r, init, kind) for r in (port, ref, f32))
        assert _rel_l2(got, want) <= 2 * _rel_l2(anchor, want), kind
    assert _rel_l2(port["logits"], ref["logits"]) <= 2 * _rel_l2(f32["logits"], ref["logits"])


def test_hook_sees_the_reference_op_names(init18, monkeypatch):
    """The names both AMP hooks see on a resnet18 forward with its loss
    under O1: every name the port's hook sees is one the reference's saw,
    and the names either list acts on come in the same numbers (20
    ``conv`` and one ``linear`` white-listed, 20 ``batch_norm`` and the
    ``cross_entropy`` black-listed); ``pool`` and ``adaptive_pool`` follow
    their inputs."""
    jm, tm = _pair(init18)
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jautograd._maybe_amp_cast, tamp.cast_args
    monkeypatch.setattr(jautograd, "_maybe_amp_cast",
                        lambda n, a: seen["jax"].append(n) or j_orig(n, a))
    monkeypatch.setattr(tamp, "cast_args", lambda n, a: seen["port"].append(n) or t_orig(n, a))
    x, y = _batch()
    with jamp.auto_cast(True):
        paddle.jit.to_static(lambda v, t: paddle.nn.functional.cross_entropy(jm(v), t))(
            paddle.to_tensor(x), paddle.to_tensor(y))
    with tamp.auto_cast(True):
        loss = tnn.functional.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    assert loss.dtype == torch.float32
    assert set(seen["port"]) <= set(seen["jax"])
    acted = tamp.WHITE_LIST | tamp.BLACK_LIST

    def count(names):
        return sorted((n, names.count(n)) for n in set(names) if n in acted)

    assert count(seen["port"]) == count(seen["jax"]) == [
        ("batch_norm", 20), ("conv", 20), ("cross_entropy", 1), ("linear", 1)]
    assert {"pool", "adaptive_pool", "relu"} <= set(seen["port"])


def test_decorate_o2_casts_parameters_not_running_statistics(init18):
    """``decorate(level="O2")`` casts every BatchNorm weight and bias to
    bf16 and leaves ``_mean`` / ``_variance`` in f32, as the JAX
    package's does; under auto_cast a bf16 input is normalised in f32 and
    stays f32 (``batch_norm`` is black-listed)."""
    jm, tm = _pair(init18)
    jamp.decorate(jm, level="O2")
    tamp.decorate(tm, level="O2")
    jdt = {k: str(v._value.dtype) for k, v in jm.state_dict().items()}
    tdt = {k: str(v.dtype).replace("torch.", "") for k, v in tm.state_dict().items()}
    assert tdt == jdt
    assert tdt["bn1.weight"] == "bfloat16" and tdt["bn1._mean"] == "float32"
    with tamp.auto_cast(True, level="O2"):
        out = tm.bn1(torch.ones(2, 64, 4, 4, dtype=torch.bfloat16))
    assert out.dtype == torch.float32  # black-listed: computed and returned in f32


def test_resnext_bottleneck_block_matches_reference():
    """A resnext50_32x4d-style bottleneck (groups 32, base_width 4: width
    128) with a strided downsample, in training: forward, the input
    gradient and every parameter gradient against the JAX block's, within
    2e-5 of each one's largest magnitude."""
    from paddle_tpu.vision.models import resnet as jresnet
    from paddle_tpu_torch.vision.models import resnet as tresnet

    def down(nn, **kw):
        return nn.Sequential(nn.Conv2D(64, 256, 1, stride=2, bias_attr=False, **kw),
                             nn.BatchNorm2D(256, **({"device": "cpu"} if kw else {})))

    with _zero_init():
        jb = jresnet.BottleneckBlock(64, 64, 2, down(paddle.nn), groups=32, base_width=4)
    g = torch.Generator().manual_seed(1)
    tb = tresnet.BottleneckBlock(64, 64, 2, down(tnn, device="cpu", generator=g), groups=32,
                                 base_width=4, device="cpu", generator=g)
    assert tb.conv2.weight.shape == (128, 4, 3, 3)
    init = {k: v.numpy().copy() for k, v in tb.state_dict().items()}
    jb.set_state_dict({k: paddle.to_tensor(v) for k, v in init.items()})
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 8, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 256, 4, 4)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    # the reference block compiled whole (one XLA program) rather than op by op
    jout, tout = paddle.jit.to_static(jb)(jx), tb(tx)
    (jout * paddle.to_tensor(cot)).sum().backward()
    (tout * torch.from_numpy(cot)).sum().backward()
    _within(tout.detach().numpy(), np.asarray(jout._value), F32_REL, "forward")
    _within(tx.grad.numpy(), np.asarray(jx.grad._value), F32_REL, "input gradient")
    jp = dict(jb.named_parameters())
    for name, p in tb.named_parameters():
        _within(p.grad.numpy(), np.asarray(jp[name].grad._value), F32_REL, name)


def _small_bn_model():
    g = torch.Generator().manual_seed(3)
    return tnn.Sequential(tnn.Conv2D(3, 8, 3, padding=1, device="cpu", generator=g),
                          tnn.BatchNorm2D(8, device="cpu"), tnn.ReLU(),
                          tnn.AdaptiveAvgPool2D(1), tnn.Conv2D(8, 4, 1, device="cpu",
                                                                generator=g))


def _step(model):
    ce = tnn.CrossEntropyLoss()
    return TrainStep(model, topt.Momentum(0.1, parameters=model.parameters()),
                     lambda m, x, y: ce(m(x).flatten(1), y))


def test_train_step_state_holds_running_statistics():
    """``TrainStep._state()`` holds the BatchNorm buffers (the state
    dict's, not a non-persistent cache); a step writes them in place;
    ``warmup()`` leaves every state tensor, running statistics included,
    bit for bit; rebinding a buffer makes the step record again; the
    steps equal eager steps from the same state."""
    model = _small_bn_model()
    bn = model[1]
    bn.register_buffer("cache", torch.ones(2), persistent=False)
    step = _step(model)
    state_ids = {id(t) for t in step._state()}
    assert id(bn._mean) in state_ids and id(bn._variance) in state_ids
    assert id(bn.cache) not in state_ids
    g = torch.Generator().manual_seed(4)
    x, y = torch.randn(4, 3, 6, 6, generator=g), torch.randint(0, 4, (4,), generator=g)
    ptrs = (bn._mean.data_ptr(), bn._variance.data_ptr())
    step(x, y)  # creates the velocities
    before = [t.clone() for t in step._state()]
    step.warmup(x, y)
    assert all(torch.equal(a, b) for a, b in zip(before, step._state()))
    twin = _small_bn_model()
    twin.load_state_dict(model.state_dict())
    twin_step = _step(twin)
    twin_step(x, y)  # the same first step: its velocities
    for t, v in zip(twin_step.optimizer.opt_state_tensors(), step.optimizer.opt_state_tensors()):
        t.copy_(v)
    twin.load_state_dict(model.state_dict())
    for _ in range(2):
        assert torch.equal(step(x, y), twin_step._eager_step(x, y))
    assert (bn._mean.data_ptr(), bn._variance.data_ptr()) == ptrs
    assert not torch.equal(bn._mean, before[len(list(model.parameters()))])
    for a, b in zip(model.state_dict().values(), twin.state_dict().values()):
        assert torch.equal(a, b)
    captures = step.captures
    step(x, y)
    assert step.captures == captures  # same signature, same state: no new recording
    bn._mean = bn._mean.clone()  # rebound: a new address
    step(x, y)
    assert step.captures == captures + 1
