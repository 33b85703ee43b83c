"""The port's kernel modules against the JAX package, on the CPU.

On the CPU the port's wrappers take their plain versions; the JAX ops run
their Pallas kernels in interpret mode (``pallas_call(interpret=True)``,
as the JAX package's own tests run them).  Both sides get the same numpy
inputs made from a seed.  Tolerances: f32 2e-5 (the two sides sum in
different orders), bf16 2e-2 (one bf16 rounding step of the output).
Gradients come from ``jax.vjp`` on the JAX side (its flash backward runs
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in interpret mode) and from
torch autograd through the port's ``autograd.Function``s; f32 gradients
are held at 1e-4 (sums of up to 128 products in other orders).
The kernels themselves only run on the card (``chip_smoke.py``); the
wrappers' routing to them is checked by ``test_cuda_*`` cases that skip
without a card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as jops
from paddle_tpu.ops import paged_attention as jpa

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import paged_attention as tpa

# the module, not the function of the same name that paddle_tpu.ops exports
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
jsdpa = importlib.import_module("paddle_tpu.nn.functional.attention")

F32_TOL = 2e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4


def _rand(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _bf16_pair(a):
    """The same bf16 values for both frameworks."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [4, 24])
def test_fused_rms_norm_matches_pallas(dtype, rows):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, (rows, 256)), _rand(rng, (256,))
    if dtype == "float32":
        jx, tx, jw, tw = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(w), torch.from_numpy(w)
        tol = F32_TOL
    else:
        (jx, tx), (jw, tw) = _bf16_pair(x), _bf16_pair(w)
        tol = BF16_TOL
    want = np.asarray(jops.fused_rms_norm(jx, jw, epsilon=1e-6).astype(jnp.float32))
    got = tops.fused_rms_norm(tx, tw, epsilon=1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("mask_kind", ["bool", "additive"])
def test_masked_sdpa_matches_jax_reference(mask_kind):
    """With a mask, scaled_dot_product_attention takes the plain masked
    path; causal stays bottom-right aligned for Sq != Sk."""
    q, k, v = _qkv(10, 2, 5, 9, 2, 2, 16)
    rng = np.random.default_rng(11)
    if mask_kind == "bool":
        mask = rng.random((2, 1, 5, 9)) > 0.3
        mask[..., 0] = True  # every row keeps a key
    else:
        mask = rng.standard_normal((2, 1, 5, 9)).astype(np.float32)
    want = jsdpa.sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                mask=jnp.asarray(mask), is_causal=True)
    got = tF.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                          attn_mask=torch.from_numpy(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [False, True])
def test_swiglu_matches_pallas(dtype, split):
    rng = np.random.default_rng(2)
    x, y = _rand(rng, (16, 384)), _rand(rng, (16, 384))
    if dtype == "float32":
        jx, tx, jy, ty = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(y), torch.from_numpy(y)
        tol = F32_TOL
    else:
        (jx, tx), (jy, ty) = _bf16_pair(x), _bf16_pair(y)
        tol = BF16_TOL
    want = np.asarray(jops.swiglu(jx, jy).astype(jnp.float32))
    if split:  # y=None splits one [rows, 2 * cols] input in half
        got = tops.swiglu(torch.cat([tx, ty], dim=-1))
    else:
        got = tops.swiglu(tx, ty)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def _qkv(seed, b, sq, sk, n, nkv, h):
    rng = np.random.default_rng(seed)
    return _rand(rng, (b, sq, n, h)), _rand(rng, (b, sk, nkv, h)), _rand(rng, (b, sk, nkv, h))


def _check_flash(q, k, v, causal, want):
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tops.flash_attention_fwd(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    return lse


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_pallas(causal):
    # 256 keys: two 128-key blocks, so the kernel's online softmax carries
    q, k, v = _qkv(3, 1, 256, 256, 2, 2, 64)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    lse = _check_flash(q, k, v, causal, want)
    # the lse the JAX forward kernel writes (lane 0 of its 128-lane copy)
    _, want_lse = jfa._fwd(*(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)),
                           1.0 / np.sqrt(64), causal, 128, 128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=F32_TOL, rtol=F32_TOL)


def test_flash_attention_cross_length_bottom_right():
    q, k, v = _qkv(4, 1, 128, 256, 2, 2, 64)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    _check_flash(q, k, v, True, want)


def test_flash_attention_gqa():
    q, k, v = _qkv(5, 2, 128, 128, 4, 2, 64)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    _check_flash(q, k, v, True, want)


@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 100)])
def test_flash_attention_ragged_against_reference(sq, sk):
    q, k, v = _qkv(6, 1, sq, sk, 2, 1, 64)
    want = jfa.flash_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=True)
    _check_flash(q, k, v, True, want)
    got = tops.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def _grads(fn, arrays, cot, dtype=torch.float32):
    """Gradients of ``sum(fn(*inputs) * cot)`` through torch autograd."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    (fn(*ts).float() * torch.from_numpy(cot)).sum().backward()
    return [t.grad for t in ts]


def _jax_grads(fn, arrays, cot, dtype=jnp.float32):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in arrays))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(cot, out.dtype))]


FLASH_BWD_CASES = [  # (Sq, Sk, N, Nkv, causal): JAX blocks are min(128, S)
    (64, 64, 2, 2, True), (128, 128, 2, 2, False), (128, 128, 4, 2, True),
    (64, 128, 2, 2, True)]


@pytest.mark.parametrize("sq,sk,n,nkv,causal", FLASH_BWD_CASES)
def test_flash_backward_matches_pallas_vjp(sq, sk, n, nkv, causal):
    """The port's backward (the plain version and the autograd Function)
    against jax.vjp through the Pallas backward kernels: causal and not,
    GQA (4 q heads on 2 kv heads), bottom-right causal with Sq < Sk."""
    q, k, v = _qkv(12, 2, sq, sk, n, nkv, 64)
    do = _rand(np.random.default_rng(13), q.shape)
    want = _jax_grads(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal),
                      (q, k, v), do)
    got_fn = _grads(lambda a, b, c: tops.flash_attention(a, b, c, causal=causal), (q, k, v), do)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = tops.flash_attention_fwd(tq, tk, tv, causal=causal)
    got_ref = tops.flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do), causal=causal)
    for name, w, a, b in zip(("dq", "dk", "dv"), want, got_fn, got_ref):
        assert a.shape == b.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(b.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 100)])
def test_flash_backward_ragged_against_autograd(sq, sk):
    """Ragged lengths (JAX falls back to its reference there): the port's
    backward against torch autograd through the plain forward."""
    q, k, v = _qkv(14, 1, sq, sk, 4, 2, 64)
    do = _rand(np.random.default_rng(15), q.shape)
    want = _grads(lambda a, b, c: tops.flash_attention_reference(a, b, c, causal=True),
                  (q, k, v), do)
    got = _grads(lambda a, b, c: tops.flash_attention(a, b, c, causal=True), (q, k, v), do)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gradients_match_jax(dtype):
    rng = np.random.default_rng(16)
    x, w = _rand(rng, (3, 8, 256)), 1 + 0.1 * _rand(rng, (256,))
    cot = _rand(rng, x.shape)
    tdt, jdt, tol = ((torch.float32, jnp.float32, GRAD_TOL) if dtype == "float32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    want = _jax_grads(lambda a, b: jops.fused_rms_norm(a, b, epsilon=1e-6), (x, w), cot, jdt)
    got = _grads(lambda a, b: tops.fused_rms_norm(a, b, epsilon=1e-6), (x, w), cot, tdt)
    for name, a, b in zip(("dx", "dw"), got, want):
        assert a.dtype == tdt, name
        # dw sums 24 rows: its bf16 rounding is relative to its size
        np.testing.assert_allclose(a.float().numpy(), b, atol=tol * max(1, np.abs(b).max()),
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [False, True])
def test_swiglu_gradients_match_jax(dtype, split):
    """Including the split form: the gradient reaches one [rows, 2 * cols]
    input through the halves' views."""
    rng = np.random.default_rng(17)
    x, y = _rand(rng, (2, 8, 384)), _rand(rng, (2, 8, 384))
    cot = _rand(rng, x.shape)
    tdt, jdt, tol = ((torch.float32, jnp.float32, GRAD_TOL) if dtype == "float32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    if split:
        xy = np.concatenate([x, y], axis=-1)
        (want,) = _jax_grads(lambda a: jops.swiglu(a), (xy,), cot, jdt)
        (got,) = _grads(lambda a: tops.swiglu(a), (xy,), cot, tdt)
        pairs = [("dxy", got, want)]
    else:
        want = _jax_grads(jops.swiglu, (x, y), cot, jdt)
        got = _grads(tops.swiglu, (x, y), cot, tdt)
        pairs = list(zip(("dx", "dy"), got, want))
    for name, a, b in pairs:
        assert a.dtype == tdt, name
        np.testing.assert_allclose(a.float().numpy(), b, atol=tol, rtol=tol, err_msg=name)


def test_cpu_tensors_take_the_plain_versions():
    tops.reset_launch_counts()
    x = torch.randn(4, 64)
    tops.fused_rms_norm(x, torch.ones(64))
    tops.swiglu(x, x)
    tops.flash_attention(torch.randn(1, 8, 2, 64), torch.randn(1, 8, 2, 64),
                         torch.randn(1, 8, 2, 64), causal=True)
    tops.fused_layer_norm(x, torch.ones(64), torch.zeros(64), residual=x)
    tops.matmul_bias_act(x, torch.randn(64, 32), torch.randn(32), "gelu")
    assert tops.launch_counts() == {"fused_rms_norm": 0, "swiglu": 0, "flash_attention_fwd": 0,
                                    "flash_attention_fwd_sm90": 0,
                                    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                                    "flash_attention_bwd_dq_sm90": 0,
                                    "flash_attention_bwd_dkv_sm90": 0,
                                    "decode_chain_batch": 0, "decode_chain_rows": 0,
                                    "decode_chain_batch_sm90": 0, "decode_chain_rows_sm90": 0,
                                    "prefill_chain": 0, "prefill_chain_sm90": 0,
                                    "fused_layer_norm": 0, "matmul_epilogue": 0,
                                    "matmul_epilogue_sm90": 0, "vpu_chain": 0, "sched_chain": 0,
                                    "sched_chain_ktiled": 0}
    with pytest.raises(ValueError, match="devices"):
        tops.use_kernel(x, torch.empty(1, device="meta"))


# ------------------------------------------------------------ paged attention

def _pools(rng, nb=6, nkv=2, bs=4, h=8):
    return _rand(rng, (nb, nkv, bs, h)), _rand(rng, (nb, nkv, bs, h))


def test_paged_write_gather_and_decode_attention():
    rng = np.random.default_rng(7)
    kc, vc = _pools(rng)
    tables = np.array([[0, 2], [5, 1]], np.int32)
    pos = np.array([5, 2], np.int32)
    newk, newv = _rand(rng, (2, 2, 8)), _rand(rng, (2, 2, 8))
    q = _rand(rng, (2, 4, 8))  # GQA: 4 q heads over 2 kv heads
    lens = pos + 1

    jk = jpa.paged_write(jnp.asarray(kc), jnp.asarray(newk), jnp.asarray(tables), jnp.asarray(pos))
    jv = jpa.paged_write(jnp.asarray(vc), jnp.asarray(newv), jnp.asarray(tables), jnp.asarray(pos))
    tk = tpa.paged_write(torch.from_numpy(kc.copy()), torch.from_numpy(newk),
                         torch.from_numpy(tables), torch.from_numpy(pos))
    tv = tpa.paged_write(torch.from_numpy(vc.copy()), torch.from_numpy(newv),
                         torch.from_numpy(tables), torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpa.paged_gather(tk, torch.from_numpy(tables)).numpy(),
                                  np.asarray(jpa.paged_gather(jk, jnp.asarray(tables))))
    want = jpa.paged_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                                      jnp.asarray(lens))
    got = tpa.paged_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_paged_write_chunk_and_chunk_attention():
    rng = np.random.default_rng(8)
    kc, vc = _pools(rng)
    tables = np.array([[3, 0], [4, 2]], np.int32)
    lens = np.array([7, 4], np.int32)
    pos = lens[:, None] - 3 + np.arange(3, dtype=np.int32)[None, :]
    newk, newv = _rand(rng, (2, 3, 2, 8)), _rand(rng, (2, 3, 2, 8))
    q = _rand(rng, (2, 3, 2, 8))
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    jk = jpa.paged_write_chunk(jnp.asarray(kc), jnp.asarray(newk), jt, jnp.asarray(pos))
    jv = jpa.paged_write_chunk(jnp.asarray(vc), jnp.asarray(newv), jt, jnp.asarray(pos))
    tt, tl_ = torch.from_numpy(tables), torch.from_numpy(lens)
    tk = tpa.paged_write_chunk(torch.from_numpy(kc.copy()), torch.from_numpy(newk), tt,
                               torch.from_numpy(pos))
    tv = tpa.paged_write_chunk(torch.from_numpy(vc.copy()), torch.from_numpy(newv), tt,
                               torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    want = jpa.paged_chunk_attention(jnp.asarray(q), jk, jv, jt, jl)
    got = tpa.paged_chunk_attention(torch.from_numpy(q), tk, tv, tt, tl_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    keys = tpa.paged_gather(tk, tt)
    vals = tpa.paged_gather(tv, tt)
    got2 = tpa.gathered_attention(torch.from_numpy(q), keys, vals, tl_)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_pour_alloc_and_rope_rotation():
    rng = np.random.default_rng(9)
    jk, _ = jpa.alloc_paged_cache(5, 2, 4, 8, jnp.float32)
    tk, _ = tpa.alloc_paged_cache(5, 2, 4, 8, torch.float32)
    assert tuple(tk.shape) == jk.shape and not tk.any()
    kv = _rand(rng, (2, 2, 4, 8))
    jk = jpa.paged_pour_blocks(jk, jnp.asarray(kv), [3, 1])
    tpa.paged_pour_blocks(tk, torch.from_numpy(kv), [3, 1])
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))

    cos, sin = _rand(rng, (16, 4)), _rand(rng, (16, 4))
    t = _rand(rng, (2, 3, 2, 8))
    pos = np.array([[1, 2, 3], [9, 10, 11]], np.int32)
    want = jpa.rope_rotate_chunk(jnp.asarray(t), jnp.asarray(cos), jnp.asarray(sin),
                                 jnp.asarray(pos))
    got = tpa.rope_rotate_chunk(torch.from_numpy(t), torch.from_numpy(cos),
                                torch.from_numpy(sin), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    want1 = jpa.rope_rotate_by_position(jnp.asarray(t[:, 0]), jnp.asarray(cos),
                                        jnp.asarray(sin), jnp.asarray(pos[:, 0]))
    got1 = tpa.rope_rotate_by_position(torch.from_numpy(t[:, 0]), torch.from_numpy(cos),
                                       torch.from_numpy(sin), torch.from_numpy(pos[:, 0]))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=F32_TOL, rtol=F32_TOL)
    # int8 allocates QuantPools of the JAX package's shapes and dtypes (the
    # int8 arithmetic is tests/test_torch_decode_chain.py's)
    jq, _ = jpa.alloc_paged_cache(5, 2, 4, 8, jnp.int8)
    tq, _ = tpa.alloc_paged_cache(5, 2, 4, 8, "int8")
    assert isinstance(tq, tpa.QuantPool)
    assert tq.data.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert (tuple(tq.data.shape), tuple(tq.scale.shape)) == (jq.data.shape, jq.scale.shape)
