"""The port's convolution, pooling and batch-norm functionals and its
containers against the JAX package's, on the CPU.

Each case feeds the same seeded numpy input (and weight) to both
functionals, then a seeded cotangent through both backwards, and
compares the output and every input gradient.  Tolerance: 2e-5 of the
reference's largest magnitude (f32 sums in other orders), and the same
for the running statistics after a training call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu._core.tensor import Tensor

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.nn import functional as TF

REL = 2e-5


def _close(got, want, what):
    """Within REL of the reference's largest finite magnitude; values
    that are not finite (a ceil-mode window wholly in the -inf padding)
    equal."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    assert np.array_equal(got[~finite], want[~finite]), what
    if finite.any():
        err = float(np.abs(got[finite] - want[finite]).max())
        assert err <= REL * max(float(np.abs(want[finite]).max()), 1.0), (what, err)


def _run_both(jfn, tfn, arrays, stats=(), seed=1):
    """``jfn`` and ``tfn`` on the same arrays (then on fresh copies of
    ``stats``, the running statistics, which they may write); returns,
    reference first, the outputs, the gradients of ``sum(out * g)`` for a
    seeded ``g``, and the statistics after the call.  The reference's
    forward and backward are one jitted ``jax.vjp`` (one compile a case
    rather than one an op)."""
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    tstats = [torch.tensor(a) for a in stats]
    tout = tfn(*tin, *tstats)
    g = np.random.default_rng(seed).standard_normal(tuple(tout.shape)).astype(np.float32)
    (tout * torch.from_numpy(g)).sum().backward()

    def f(*vals):
        held = [Tensor(jnp.asarray(a)) for a in stats]
        out = jfn(*[Tensor(v) for v in vals], *held)
        return out._value, [t._value for t in held]

    @jax.jit
    def fwd_bwd(*vals):
        out, vjp, after = jax.vjp(f, *vals, has_aux=True)
        return out, vjp(jnp.asarray(g)), after

    jout, jgrads, jstats = fwd_bwd(*arrays)
    return ((np.asarray(jout), [np.asarray(t) for t in jgrads], [np.asarray(t) for t in jstats]),
            (tout.detach().numpy(), [t.grad.numpy() for t in tin],
             [t.numpy() for t in tstats]))


def _check(jfn, tfn, arrays, what, stats=()):
    (jo, jg, js), (to, tg, ts) = _run_both(jfn, tfn, arrays, stats)
    _close(to, jo, f"{what} forward")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, f"{what} gradient {i}")
    for i, (a, b) in enumerate(zip(ts, js)):
        _close(a, b, f"{what} running statistic {i}")
    return ts


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- convolution

CONV_CASES = {
    # name: (nd, x shape, w shape, kwargs)
    "int_pad": (2, (2, 4, 9, 9), (6, 4, 3, 3), dict(padding=1)),
    "per_dim_pad": (2, (2, 4, 9, 8), (6, 4, 3, 2), dict(padding=[2, 1], stride=2)),
    "pair_pad": (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[(1, 2), (0, 1)])),
    "flat_2n_pad": (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[0, 2, 1, 0], stride=2)),
    "same_stride2": (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding="SAME", stride=2)),
    "same_even_kernel": (2, (2, 4, 9, 8), (6, 4, 4, 2), dict(padding="same")),
    "valid": (2, (2, 4, 9, 8), (6, 4, 3, 3), dict(padding="VALID", stride=(2, 1))),
    "groups_dilation_bias": (2, (2, 8, 10, 10), (8, 2, 3, 3),
                             dict(padding=2, dilation=2, groups=4, bias=True)),
    "nhwc_same": (2, (2, 9, 8, 4), (6, 4, 3, 3),
                  dict(padding="SAME", stride=2, data_format="NHWC", bias=True)),
    "conv1d_nlc": (1, (2, 11, 4), (6, 4, 3), dict(padding=[1, 2], data_format="NLC")),
    "conv1d_groups": (1, (2, 6, 11), (6, 3, 3), dict(padding=1, groups=2, stride=2)),
    "conv3d": (3, (1, 2, 5, 6, 5), (3, 2, 3, 3, 2), dict(padding=[1, 0, 1], stride=(1, 2, 1))),
    "conv3d_ndhwc_same": (3, (1, 5, 6, 5, 2), (3, 2, 3, 3, 3),
                          dict(padding="SAME", stride=2, data_format="NDHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_reference(case):
    """Forward and the input, weight (and bias) gradients of every padding
    form: int, per dimension, (lo, hi) pairs, the flat 2n list
    (asymmetric: an explicit pad first), SAME at stride 2 and with an even
    kernel (XLA's split), VALID; groups, dilation, channel-last layouts."""
    nd, xs, ws, kw = CONV_CASES[case]
    kw = dict(kw)
    arrays = [_rand(*xs), _rand(*ws, seed=1)]
    if kw.pop("bias", False):
        arrays.append(_rand(ws[0], seed=2))
    name = f"conv{nd}d"
    _check(lambda *a: getattr(JF, name)(*a, **kw), lambda *a: getattr(TF, name)(*a, **kw),
           arrays, case)


def test_conv_records_one_op_and_casts_under_o1():
    """A convolution is one ``conv`` op: the O1 hook casts it to bf16,
    and a static capture records it with its padding."""
    from paddle_tpu_torch import amp as tamp

    x, w = torch.from_numpy(_rand(2, 4, 8, 8)), torch.from_numpy(_rand(6, 4, 3, 3, seed=1))
    with tamp.auto_cast(True):
        out = TF.conv2d(x, w, padding="SAME", stride=2)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 6, 4, 4)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        v = tstatic.data("x", [2, 4, 8, 8], "float32")
        y = TF.conv2d(v, w, padding=[0, 1, 1, 0])
    (op,) = main.global_block().ops
    assert op.type == "conv" and op.kwargs["pads"] == [(0, 1), (1, 0)]
    (got,) = tstatic.Executor("cpu").run(main, feed={"x": x}, fetch_list=[y])
    torch.testing.assert_close(torch.as_tensor(got), TF.conv2d(x, w, padding=[0, 1, 1, 0]),
                               rtol=0, atol=0)


# ----------------------------------------------------------------- pooling

POOL_CASES = {
    # name: (function, x shape, positional, kwargs)
    "max2d_resnet_stem": ("max_pool2d", (2, 3, 9, 9), (3, 2, 1), {}),
    "max2d_ceil": ("max_pool2d", (2, 3, 8, 9), (3, 2, 0), dict(ceil_mode=True)),
    "max2d_ceil_pad": ("max_pool2d", (2, 3, 8, 7), (2, 2, 1), dict(ceil_mode=True)),
    "max2d_flat_pad": ("max_pool2d", (2, 3, 8, 7), (3, 2, [0, 2, 1, 1]), {}),
    "max2d_same_nhwc": ("max_pool2d", (2, 8, 7, 3), (3, 2, "SAME"), dict(data_format="NHWC")),
    "max1d": ("max_pool1d", (2, 3, 11), (3, 2, 1), dict(ceil_mode=True)),
    "max3d": ("max_pool3d", (1, 2, 5, 6, 5), (2, 2, 0), dict(ceil_mode=True)),
    "avg2d_inclusive": ("avg_pool2d", (2, 3, 9, 9), (3, 2, 1), dict(exclusive=False)),
    "avg2d_exclusive": ("avg_pool2d", (2, 3, 9, 9), (3, 2, 1), dict(exclusive=True)),
    "avg2d_ceil_inclusive": ("avg_pool2d", (2, 3, 8, 7), (3, 2, 1),
                             dict(ceil_mode=True, exclusive=False)),
    "avg2d_ceil_exclusive": ("avg_pool2d", (2, 3, 8, 7), (3, 2, [1, 0, 0, 1]),
                             dict(ceil_mode=True)),
    "avg2d_same": ("avg_pool2d", (2, 3, 8, 7), (3, 2, "SAME"), dict(exclusive=False)),
    "avg2d_nhwc": ("avg_pool2d", (2, 8, 7, 3), (2, 2, 1), dict(data_format="NHWC")),
    "avg1d": ("avg_pool1d", (2, 3, 11), (3, 2, 1), dict(exclusive=False)),
    "avg3d": ("avg_pool3d", (1, 2, 5, 6, 5), (3, 2, 1), {}),
    "adaptive_avg2d_uneven": ("adaptive_avg_pool2d", (2, 3, 7, 10), ((3, 4),), {}),
    "adaptive_avg2d_one": ("adaptive_avg_pool2d", (2, 3, 7, 5), (1,), {}),
    "adaptive_avg2d_nhwc": ("adaptive_avg_pool2d", (2, 7, 5, 3), (3,), dict(data_format="NHWC")),
    "adaptive_avg1d": ("adaptive_avg_pool1d", (2, 3, 11), (4,), {}),
    "adaptive_avg3d": ("adaptive_avg_pool3d", (1, 2, 5, 7, 4), ((2, 3, 4),), {}),
    "adaptive_max2d_uneven": ("adaptive_max_pool2d", (2, 3, 7, 10), ((3, 4),), {}),
    "adaptive_max1d": ("adaptive_max_pool1d", (2, 3, 11), (4,), {}),
    "adaptive_max3d": ("adaptive_max_pool3d", (1, 2, 5, 7, 4), ((2, 3, 3),), {}),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_reference(case):
    """Forward and input gradient: max pools with -inf padding and
    ceil_mode's extra window, average pools inclusive and exclusive
    (ceil_mode's overhang counted as the JAX package counts it), SAME,
    channel-last; adaptive pools at sizes that do not divide."""
    fn, xs, pos, kw = POOL_CASES[case]
    _check(lambda x: getattr(JF, fn)(x, *pos, **kw), lambda x: getattr(TF, fn)(x, *pos, **kw),
           [_rand(*xs)], case)


def test_pool_ties_after_relu_and_refusals():
    """After a ReLU, windows of zeros tie: the forward agrees and the
    gradient through the ReLU is 0 there in both packages; a tie between
    positive values sends the whole gradient to the window's first
    maximum, as XLA's select-and-scatter does.  Masks, and the divisor
    the JAX package ignores, raise."""
    x = _rand(2, 3, 9, 9)
    x[:, :, 2:6, 2:6] = -1.0  # whole windows at 0 after the ReLU
    x[:, :, 7, 7] = x[:, :, 7, 8] = 5.0  # a positive tie inside one window
    _check(lambda v: JF.max_pool2d(JF.relu(v), 3, 2, 1),
           lambda v: TF.max_pool2d(TF.relu(v), 3, 2, 1), [x], "max pool after relu")
    t = torch.from_numpy(x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TF.max_pool2d(t, 2, return_mask=True)
    with pytest.raises(NotImplementedError, match="ignores"):
        TF.avg_pool2d(t, 2, divisor_override=3)


# -------------------------------------------------------------- batch norm

BN_CASES = {
    # name: (x shape, data_format, training, use_global_stats, affine)
    "train_nchw": ((4, 3, 5, 6), "NCHW", True, None, True),
    "train_nhwc": ((4, 5, 6, 3), "NHWC", True, None, True),
    "train_ncl_no_affine": ((4, 3, 7), "NCL", True, None, False),
    "train_nc": ((6, 3), "NCL", True, None, True),
    "train_ndhwc": ((2, 3, 4, 2, 3), "NDHWC", True, None, True),
    "eval_nchw": ((4, 3, 5, 6), "NCHW", False, None, True),
    "eval_nhwc": ((4, 5, 6, 3), "NHWC", False, None, True),
    "global_stats_in_training": ((4, 3, 5, 6), "NCHW", True, True, True),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_reference(case):
    """Forward, the input, weight and bias gradients, and the running
    statistics after the call (biased batch variance, momentum 0.9
    weighing the running value), in training, eval and with
    ``use_global_stats``, channel-first and channel-last."""
    xs, fmt, training, ugs, affine = BN_CASES[case]
    c = xs[-1] if fmt[-1] == "C" and len(xs) > 2 else xs[1]
    rng = np.random.default_rng(3)
    rm = rng.standard_normal(c).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, c).astype(np.float32)

    def call(F):
        def fn(x, *rest):
            w, b = rest[:2] if affine else (None, None)
            return F.batch_norm(x, *rest[-2:], w, b, training=training, momentum=0.9,
                                epsilon=1e-5, data_format=fmt, use_global_stats=ugs)
        return fn

    arrays = [_rand(*xs) * 3 + 1]
    if affine:
        arrays += [_rand(c, seed=4), _rand(c, seed=5)]
    mean, _ = _check(call(JF), call(TF), arrays, case, stats=(rm, rv))
    assert (not np.array_equal(mean, rm)) == (training and not ugs)


def test_batch_norm_writes_in_place_and_refuses_static_training():
    """The running statistics are written in place (same storage, never
    rebound); in a static capture eval mode records one ``batch_norm`` op
    and training mode raises naming A.5.2.  Under O1 the op is black-listed:
    a bf16 input normalises in f32."""
    from paddle_tpu_torch import amp as tamp

    bn = tnn.BatchNorm2D(3, device="cpu")
    ptrs = (bn._mean.data_ptr(), bn._variance.data_ptr())
    x = torch.from_numpy(_rand(4, 3, 5, 5))
    bn(x)
    assert (bn._mean.data_ptr(), bn._variance.data_ptr()) == ptrs
    assert not torch.equal(bn._mean, torch.zeros(3))
    with tamp.auto_cast(True):
        assert bn(x.bfloat16()).dtype == torch.float32
    bn.eval()
    main = tstatic.Program()
    with tstatic.program_guard(main):
        y = bn(tstatic.data("x", [4, 3, 5, 5], "float32"))
    assert [op.type for op in main.global_block().ops] == ["batch_norm"]
    (got,) = tstatic.Executor("cpu").run(main, feed={"x": x}, fetch_list=[y])
    torch.testing.assert_close(torch.as_tensor(got), bn(x), rtol=0, atol=0)
    bn.train()
    with pytest.raises(NotImplementedError, match="A.5.2"):
        with tstatic.program_guard(tstatic.Program()):
            bn(tstatic.data("x", [4, 3, 5, 5], "float32"))


# -------------------------------------------------------------- containers

def test_sequential_keys_slicing_and_containers():
    """``Sequential`` names its children as the JAX package does (from
    layers, ``(name, layer)`` tuples or an OrderedDict) and a slice is a
    ``Sequential`` renumbered from 0; LayerList, LayerDict and
    ParameterList keep the JAX package's keys."""
    from collections import OrderedDict

    ref = jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4), jnn.ReLU())
    port = tnn.Sequential(tnn.Conv2D(3, 4, 3, device="cpu"), tnn.BatchNorm2D(4, device="cpu"),
                          tnn.ReLU())
    assert list(port.state_dict()) == ["0.weight", "0.bias", "1.weight", "1.bias", "1._mean",
                                       "1._variance"]
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    sliced = port[1:]
    assert isinstance(sliced, tnn.Sequential) and len(sliced) == 2
    assert sorted(sliced.state_dict()) == sorted(ref[1:].state_dict())
    assert port[-1] is list(port)[-1]
    named = tnn.Sequential(("stem", tnn.ReLU()), ("head", tnn.Tanh()))
    assert list(dict(named.named_children())) == ["stem", "head"]
    od = tnn.Sequential(OrderedDict([("a", tnn.ReLU()), ("b", tnn.Silu())]))
    assert list(dict(od.named_children())) == ["a", "b"]
    x = torch.from_numpy(_rand(2, 3, 6, 6))
    torch.testing.assert_close(port(x), port[2](port[1](port[0](x))), rtol=0, atol=0)
    ll = tnn.LayerList([tnn.ReLU(), tnn.Tanh()]).append(tnn.GELU())
    ll.insert(0, tnn.Silu())
    assert [type(m).__name__ for m in ll] == ["Silu", "ReLU", "Tanh", "GELU"]
    assert isinstance(ll[-1], tnn.GELU) and len(ll[1:]) == 3
    ld = tnn.LayerDict({"relu": tnn.ReLU()})
    ld["tanh"] = tnn.Tanh()
    assert list(ld.keys()) == ["relu", "tanh"] and "tanh" in ld
    assert isinstance(ld.pop("relu"), tnn.ReLU) and len(ld) == 1
    pl = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert list(dict(pl.named_parameters())) == ["0", "1"] and pl[-1].shape == (3,)
