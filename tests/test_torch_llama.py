"""The port's LLaMA against the JAX package's, on the CPU, in f32.

Both models hold the same weights: the JAX model is built from a seed
and its ``state_dict`` is carried into the port by
``paddle_tpu_torch.convert.load_jax_state_dict``.  Tolerance: f32 logits
agree within 1e-4 absolute (two layers of matmuls summed in different
orders; logits are of order 1).
"""

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
from paddle_tpu_torch.ops import paged_attention as tpa

TOL = 1e-4


def _jax_arrays(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(11)
    cfg = dict(num_hidden_layers=2, dtype="float32")
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    jm.eval()
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, _jax_arrays(jm))
    return jm, tm


def _ids(seed, b, s, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _logits_pair(jm, tm, ids):
    """The port's logits and the JAX model's, its forward compiled whole
    (``paddle.jit.to_static``, under the flags set now) rather than op by
    op: the same logits within 1e-6."""
    want = np.asarray(paddle.jit.to_static(jm.forward)(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    return got, want


def test_logits_match_jax_default_flags(pair):
    jm, tm = pair
    got, want = _logits_pair(jm, tm, _ids(0, 2, 19))
    assert got.shape == want.shape == (2, 19, 1024)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_logits_match_jax_pallas_kernels(pair):
    """JAX with FLAGS_use_pallas on runs its three Pallas kernels in
    interpret mode (128 tokens: one full flash block)."""
    jm, tm = pair
    ids = _ids(1, 1, 128)
    prev = paddle.get_flags(["FLAGS_use_pallas"])["FLAGS_use_pallas"]
    paddle.set_flags({"FLAGS_use_pallas": "true"})
    try:
        got, want = _logits_pair(jm, tm, ids)
    finally:
        paddle.set_flags({"FLAGS_use_pallas": prev})
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_decode_layers_paged_step_matches_jax(pair):
    jm, tm = pair
    cfg = tm.config
    rng = np.random.default_rng(2)
    nkv, hd, bs = cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads, 4
    pools = [(rng.standard_normal((6, nkv, bs, hd)).astype(np.float32),
              rng.standard_normal((6, nkv, bs, hd)).astype(np.float32))
             for _ in range(cfg.num_hidden_layers)]
    tables = np.array([[1, 4], [3, 0]], np.int32)
    lens = np.array([6, 3], np.int32)
    h = rng.standard_normal((2, 1, cfg.hidden_size)).astype(np.float32)

    # the JAX step compiled whole (one XLA program) rather than op by op
    jh, jk, jv = jax.jit(lambda hv, kp, vp, tb, ln: jllama._decode_layers_paged(
        jm.model.layers, Tensor(hv), jm.model.rope_cos._value, jm.model.rope_sin._value,
        kp, vp, tb, ln))(jnp.asarray(h), [jnp.asarray(k) for k, _ in pools],
                         [jnp.asarray(v) for _, v in pools], jnp.asarray(tables),
                         jnp.asarray(lens))
    with torch.no_grad():
        th, tk, tv = tllama._decode_layers_paged(
            tm.model.layers, torch.from_numpy(h), tm.model.rope_cos, tm.model.rope_sin,
            [torch.from_numpy(k.copy()) for k, _ in pools],
            [torch.from_numpy(v.copy()) for _, v in pools],
            torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh._value), atol=TOL, rtol=TOL)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_cached_prefill_then_cached_token_match_full_forward(pair):
    """Prefill through naive caches, then one cached token, equals the
    plain full forward over the same tokens (port against itself) and the
    JAX cached path."""
    jm, tm = pair
    ids = _ids(3, 1, 9)
    cfg = tm.config
    nkv, hd = cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads
    empty = [(torch.zeros(1, 0, nkv, hd),) * 2 for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        h, caches = tllama._model_forward_cached(tm.model, torch.from_numpy(ids[:, :8]), empty)
        h2, _ = tllama._model_forward_cached(tm.model, torch.from_numpy(ids[:, 8:]), caches, 8)
        full = tm(torch.from_numpy(ids))
        step = tm._logits(h2)
    np.testing.assert_allclose(step.numpy(), full[:, 8:].numpy(), atol=TOL, rtol=TOL)
    jempty = jllama._empty_caches(jm.config, 1)
    # the JAX cached forward compiled whole (one XLA program) rather than op by op
    jh = jax.jit(lambda v: jllama._model_forward_cached(jm.model, Tensor(v), jempty)[0]._value)(
        jnp.asarray(ids[:, :8]))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_load_jax_state_dict_bf16_and_key_checks():
    paddle.seed(12)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(num_hidden_layers=1, dtype="bfloat16"))
    arrays = _jax_arrays(jm)
    assert arrays["lm_head.weight"].dtype.name == "bfloat16"
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(num_hidden_layers=1), device="cpu")
    load_jax_state_dict(tm, arrays)
    got = tm.state_dict()["model.layers.0.mlp.gate_up_proj.weight"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        arrays["model.layers.0.mlp.gate_up_proj.weight"].astype(np.float32))
    # rope tables are recomputed in f32 and are not part of the state dict
    assert tm.model.rope_cos.dtype == torch.float32 and "model.rope_cos" not in tm.state_dict()
    with pytest.raises(KeyError, match="missing"):
        load_jax_state_dict(tm, {k: v for k, v in arrays.items() if k != "model.norm.weight"})
    with pytest.raises(KeyError, match="unknown"):
        load_jax_state_dict(tm, {**arrays, "model.extra": np.zeros(1)})


def test_rope_and_paged_rope_agree():
    """Prefill rope (apply_rotary_pos_emb) and decode rope
    (rope_rotate_by_position) share the pair convention."""
    cos, sin = tllama._rope_tables(16, 32, 10000.0)
    x = torch.randn(1, 5, 2, 16)
    q, _ = tllama.apply_rotary_pos_emb(x, x, cos, sin, position_offset=3)
    per_pos = torch.stack([tpa.rope_rotate_by_position(x[:, i], cos, sin, torch.tensor([3 + i]))
                           for i in range(5)], dim=1)
    torch.testing.assert_close(q, per_pos, atol=1e-6, rtol=1e-6)
    jc, js = jllama._rope_tables(16, 32, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), atol=1e-6)
