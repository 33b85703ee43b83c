"""Dropout in training (``nn/functional/common.py``, the layers, attention
dropout, ``_core/random.py``) against the JAX package, on the CPU.

The masks come from another generator than JAX's threefry, so the
reference is held by statistics and arithmetic, not by masks:

- the keep fraction: within 5 standard deviations (sqrt(p (1 - p) / n))
  of 1 - p over 2^20 elements, on both sides;
- kept values: bit for bit ``x / (1 - p)`` as the reference divides them,
  in f32 and bf16; dropped values exactly 0;
- eval mode, p = 0 and ``downscale_in_infer``: bit for bit the reference;
- alpha dropout: every element bit for bit the reference's formula for
  its mask, and the mean and variance within 5 standard errors of what
  that formula gives a standard normal input (the variance within 1 %:
  its standard error over 2^20 samples is about 0.2 %).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu._core.tensor import Tensor

import paddle_tpu_torch
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch._core import random as trandom
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import sampling

N = 1 << 20
SIGMAS = 5.0
VAR_REL = 1e-2


def _x(n=N, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _within(frac, p, n):
    return abs(frac - (1 - p)) <= SIGMAS * math.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_fraction_and_kept_values_match_reference(p):
    x = _x()
    paddle.seed(1)
    want = np.asarray(jF.dropout(Tensor(jnp.asarray(x)), p, training=True)._value)
    paddle_tpu_torch.seed(1)
    got = tF.dropout(torch.from_numpy(x), p, training=True).numpy()
    kept = got != 0
    assert _within(kept.mean(), p, N) and _within((want != 0).mean(), p, N)
    scaled = np.asarray(jnp.asarray(x) / (1.0 - p))  # the reference's division
    np.testing.assert_array_equal(got[kept], scaled[kept])
    assert not got[~kept].any()


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_bf16_kept_values_divide_in_bf16(p):
    x = torch.from_numpy(_x(4096)).bfloat16()
    got = tF.dropout(x, p)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16) / (1.0 - p), np.float32)
    kept = (got != 0).numpy()
    np.testing.assert_array_equal(got.float().numpy()[kept], want[kept])
    jx = Tensor(jnp.asarray(x.float().numpy(), jnp.bfloat16))
    want = jF.dropout(jx, p, training=False, mode="downscale_in_infer")._value
    got = tF.dropout(x, p, training=False, mode="downscale_in_infer")
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_eval_p0_and_downscale_in_infer_match_reference():
    x = _x(512)
    jx, tx = Tensor(jnp.asarray(x)), torch.from_numpy(x)
    for p in (0.0, 0.3):
        for mode in ("upscale_in_train", "downscale_in_infer"):
            want = np.asarray(jF.dropout(jx, p, training=False, mode=mode)._value)
            got = tF.dropout(tx, p, training=False, mode=mode)
            np.testing.assert_array_equal(got.numpy(), want)
    assert tF.dropout(tx, 0.0, training=True) is tx
    got = tF.dropout(tx, 0.3, training=True, mode="downscale_in_infer").numpy()
    kept = got != 0
    np.testing.assert_array_equal(got[kept], x[kept])  # unscaled in training
    with pytest.raises(ValueError):
        tF.dropout(tx, 1.5)


def test_axis_broadcasts_the_mask():
    x = torch.ones(16, 32, 8)
    for axis in (1, [0, 2]):
        y = tF.dropout(x, 0.5, axis=axis)
        axes = [axis] if isinstance(axis, int) else axis
        reduce = tuple(i for i in range(3) if i not in axes)
        # one draw per index of the axes: constant along the others
        assert torch.equal(y.amax(dim=reduce), y.amin(dim=reduce))
        assert 0 < (y != 0).float().mean() < 1


def test_dropout2d_and_3d_drop_whole_channels():
    for fn, shape, fmt, ch in ((tF.dropout2d, (4, 16, 5, 6), "NCHW", 1),
                               (tF.dropout2d, (4, 5, 6, 16), "NHWC", 3),
                               (tF.dropout3d, (4, 16, 3, 5, 6), "NCDHW", 1),
                               (tF.dropout3d, (4, 3, 5, 6, 16), "NDHWC", 4)):
        y = fn(torch.ones(shape), 0.5, data_format=fmt)
        per_channel = y.movedim(ch, 1).reshape(shape[0], shape[ch], -1)
        assert torch.equal(per_channel.amax(-1), per_channel.amin(-1))
        assert set(per_channel.amax(-1).unique().tolist()) == {0.0, 2.0}
    layer = tnn.Dropout2D(0.5).eval()
    x = torch.ones(2, 3, 4, 4)
    assert layer(x) is x
    assert set(tnn.Dropout3D(0.5)(torch.ones(2, 8, 2, 2, 2)).unique().tolist()) == {0.0, 2.0}


def test_alpha_dropout_follows_the_reference_formula():
    p = 0.5
    x = _x()
    paddle.seed(2)
    want = np.asarray(jF.alpha_dropout(Tensor(jnp.asarray(x)), p, training=True)._value)
    got = tF.alpha_dropout(torch.from_numpy(x), p).numpy()
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * p * alpha_p
    a, b, alpha_p = np.float32(a), np.float32(b), np.float32(alpha_p)  # f32, as both compute
    dropped_value = a * alpha_p + b
    dropped = got == dropped_value
    assert _within(1 - dropped.mean(), p, N) and _within(1 - (want == dropped_value).mean(),
                                                         p, N)
    np.testing.assert_array_equal(got[~dropped], (a * x + b)[~dropped])
    # the formula's moments for a standard normal input
    mean = float(a * p * alpha_p + b)
    var = float(a * a * ((1 - p) + p * (1 - p) * alpha_p ** 2))
    for out in (got, want):
        assert abs(out.mean() - mean) <= SIGMAS * math.sqrt(var / N)
        assert abs(out.var() - var) <= VAR_REL * var
    layer = tnn.AlphaDropout(p)
    assert layer.eval()(torch.from_numpy(x[:8])).numpy().tolist() == x[:8].tolist()
    assert tF.feature_alpha_dropout(torch.from_numpy(x[:8]), p, training=False) is not None


def test_seed_replays_the_stream_and_calls_differ():
    x = torch.ones(4096)
    paddle_tpu_torch.seed(7)
    a, b = tF.dropout(x, 0.5), tF.dropout(x, 0.5)
    assert not torch.equal(a, b)
    paddle_tpu_torch.seed(7)
    assert torch.equal(tF.dropout(x, 0.5), a)
    state = paddle_tpu_torch.get_rng_state()
    c = tF.dropout(x, 0.5)
    paddle_tpu_torch.set_rng_state(state)
    assert torch.equal(tF.dropout(x, 0.5), c)
    paddle_tpu_torch.set_rng_state((7, 1))
    assert torch.equal(tF.dropout(x, 0.5), b)
    assert int(trandom.state_tensor("cpu")[1]) == 2


def test_gradient_is_the_mask_over_keep():
    p = 0.25
    x = torch.from_numpy(_x(2048)).requires_grad_()
    g = torch.from_numpy(_x(2048, seed=1))
    y = tF.dropout(x, p)
    y.backward(g)
    kept = y.detach() != 0
    torch.testing.assert_close(x.grad, torch.where(kept, g / (1 - p), 0.0), rtol=0, atol=0)


def test_uniforms_are_the_sampler_hash():
    """Dropout and the sampler share one hash (``_core/random.py``): the
    sampler's uniforms are the formula it had on its own."""
    m32 = 0xFFFFFFFF

    def mix(v):
        v = v ^ (v >> 16)
        v = (v * 0x7FEB352D) & m32
        v = v ^ (v >> 15)
        v = (v * 0x5BD1E995) & m32
        return v ^ (v >> 16)

    keys = torch.tensor([3, 2 ** 40 + 5], dtype=torch.int64)
    counters = torch.tensor([0, 9], dtype=torch.int64)
    vh = mix(torch.arange(50, dtype=torch.int64) ^ 0x85EBCA6B)
    row = mix(mix(mix((keys & m32) ^ 0x9E3779B9) ^ (keys >> 32)) ^ counters)
    want = ((mix(row[:, None] ^ vh[None, :]) >> 8) | 1).float() * 2.0 ** -24
    assert torch.equal(sampling.uniforms(keys, counters, sampling.vocab_hash(50, "cpu")), want)
    paddle_tpu_torch.set_rng_state((3, 0))
    assert torch.equal(trandom.uniform_like((50,), "cpu"), want[0])


def test_attention_dropout_is_dropout_of_the_output():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 4, 8, generator=g) for _ in range(3))
    state = paddle_tpu_torch.get_rng_state()
    got = tF.scaled_dot_product_attention(q, k, v, dropout_p=0.3, is_causal=True)
    paddle_tpu_torch.set_rng_state(state)
    plain = tF.scaled_dot_product_attention(q, k, v, is_causal=True)
    want = tF.dropout(plain, 0.3)
    assert torch.equal(got, want)
    paddle_tpu_torch.set_rng_state(state)
    out, lse = tF.flash_attention(q, k, v, dropout=0.3, causal=True)
    assert lse is None and torch.equal(out, want)
    assert torch.equal(tF.scaled_dot_product_attention(q, k, v, dropout_p=0.3,
                                                       is_causal=True, training=False), plain)


def test_dropout_in_static_capture_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5.2"), \
            tstatic.program_guard(tstatic.Program()):
        tF.dropout(tstatic.data("x", [4, 8], "float32"), 0.5, training=True)
    with tstatic.program_guard(tstatic.Program()):  # eval records no dropout
        tF.dropout(tstatic.data("x", [4, 8], "float32"), 0.5, training=False)


def _gpt_step(seed):
    g = torch.Generator().manual_seed(0)
    model = tgpt.GPTForCausalLM(tgpt.gpt_tiny(hidden_size=32, intermediate_size=64,
                                              vocab_size=128, max_position_embeddings=16,
                                              dropout=0.1), device="cpu", generator=g)
    step = TrainStep(model, AdamW(1e-3, parameters=model.parameters()),
                     lambda m, i, l: m(i, labels=l)[0])
    ids = torch.randint(0, 128, (2, 16), generator=g)
    paddle_tpu_torch.seed(seed)
    return model, step, ids


def test_gpt_dropout_warmup_keeps_the_rng_state_and_seed_replays():
    model, step, ids = _gpt_step(11)
    rng = trandom.state_tensor("cpu")
    assert any(t is rng for t in step._state())
    before = rng.clone()
    step.warmup(ids, ids)
    assert torch.equal(rng, before)
    losses = [float(step(ids, ids)) for _ in range(3)]
    # 5 dropouts a forward (the embeddings', and 2 in each of 2 blocks)
    assert int(rng[1]) - int(before[1]) == 3 * (1 + 2 * 2) and len(set(losses)) == 3
    # the same seed and weights: the same masks, the same losses
    _, again, ids2 = _gpt_step(11)
    assert torch.equal(ids, ids2)
    assert [float(again(ids, ids)) for _ in range(3)] == losses
    model.eval()
    with torch.no_grad():
        a, b = model(ids), model(ids)
    assert torch.equal(a, b)
