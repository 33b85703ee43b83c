"""The flash-attention routes of the port and every dtype and head dim the
reference takes, on the CPU.

``ops.flash_attention``'s forward picks its kernel on the card from
dtype, head dim and layout alone (``_fwd_route``): the TMA/wgmma kernel
for bf16 and f16 at head_dim 64 or 128 in a layout TMA can read, the
general kernel for the rest.  The backward picks its pair by the same
rule (``_bwd_route``), and takes the TMA/wgmma pair only when q, k, v,
dO and O all take it.  The routes are pure functions, so they are tested
here for every class; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The port's forward and backward (their plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, in the dtypes
and head dims the card now takes through the general route: f32 at
head_dim 32 and 96 (f32 tolerances: 2e-5 forward, 1e-4 for gradients,
sums in other orders) and f16 at head_dim 64 (bf16's tolerance, 2e-2:
one 16-bit rounding of the output, and JAX rounds P to f16 in its
kernels).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch.ops as tops
from _torch_threads import _one_thread  # noqa: F401


jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")

F32_TOL = 2e-5
GRAD_TOL = 1e-4
HALF_TOL = 2e-2

S, N = 128, 4


def _strides(layout, h):
    """[B, S, N, H] strides (elements) of a tensor of batch 2 in a layout."""
    if layout == "narrow":  # a view of an H + 4 wide tensor: rows not 16-byte multiples
        w = h + 4
        return (S * N * w, N * w, w, 1)
    if layout == "hmajor":  # a [B, S, H, N] tensor transposed: non-unit stride on H
        return (S * h * N, h * N, 1, N)
    return (S * N * h, N * h, h, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("h", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("layout", ["contiguous", "narrow", "hmajor", "misaligned"])
def test_fwd_route_every_dtype_head_dim_and_layout(dtype, h, layout):
    strides = _strides("contiguous" if layout == "misaligned" else layout, h)
    ptr = 0x7F0000000002 if layout == "misaligned" else 0x7F0000000000
    want = ("sm90" if dtype in (torch.bfloat16, torch.float16) and h in (64, 128)
            and layout == "contiguous" else "general")
    assert fa._fwd_route(dtype, h, strides, ptr) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("h", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("layout", ["contiguous", "narrow", "hmajor", "misaligned"])
def test_bwd_route_every_dtype_head_dim_and_layout(dtype, h, layout):
    """The backward's kernels follow the forward's rule: the TMA/wgmma pair
    for bf16 and f16 at head_dim 64 or 128 in a layout TMA can read."""
    strides = _strides("contiguous" if layout == "misaligned" else layout, h)
    ptr = 0x7F0000000002 if layout == "misaligned" else 0x7F0000000000
    want = ("sm90" if dtype in (torch.bfloat16, torch.float16) and h in (64, 128)
            and layout == "contiguous" else "general")
    assert fa._bwd_route(dtype, h, strides, ptr) == want
    assert fa._bwd_route(dtype, h, strides, ptr) == fa._fwd_route(dtype, h, strides, ptr)


@pytest.mark.parametrize("odd", ["none", "q", "k", "v", "dO", "out"])
def test_bwd_route_needs_all_five_tensors(odd):
    """One tensor of q, k, v, dO and O that TMA cannot read (here transposed
    to a non-unit H stride) sends the whole backward to the general route."""
    def tensor(name):
        if name == odd:
            return torch.zeros(2, S, 128, N, dtype=torch.bfloat16).transpose(2, 3)
        return torch.zeros(2, S, N, 128, dtype=torch.bfloat16)

    tensors = [tensor(name) for name in ("q", "k", "v", "dO", "out")]
    assert fa._bwd_route_of(*tensors) == ("sm90" if odd == "none" else "general")


def test_fwd_route_needs_positive_strides():
    """A broadcast (stride 0) dim is not a layout TMA reads."""
    assert fa._fwd_route(torch.bfloat16, 128, (0, 4096, 128, 1), 0) == "general"
    assert fa._fwd_route(torch.bfloat16, 128, (524288, 4096, 128, 1), 0) == "sm90"


def test_head_dim_limit_and_dtypes_raise_before_any_launch():
    """Only H > 256 and dtypes that are not bf16, f16 or f32 are refused;
    the checks run before a kernel is reached, so the CPU sees them."""
    fa._check_head_dim(256)
    with pytest.raises(ValueError, match="head_dim 257 is past the kernels' limit of 256"):
        fa._check_head_dim(257)
    x = torch.zeros(1, 4, 2, 32)
    fa._check_kernel_inputs(("q", x), ("k", x), ("v", x))
    with pytest.raises(TypeError, match="bf16, f16 or f32"):
        fa._check_kernel_inputs(("q", x.double()))
    with pytest.raises(TypeError, match="one dtype"):
        fa._check_kernel_inputs(("q", x), ("k", x.half()))


def _qkv(seed, sq, sk, n, nkv, h):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((2, sq, n, h), (2, sk, nkv, h), (2, sk, nkv, h)))


CASES = [  # (dtype, H, Sq, Sk, N, Nkv, causal): JAX blocks are min(128, S)
    ("float32", 32, 128, 128, 4, 4, True), ("float32", 32, 128, 256, 4, 2, True),
    ("float32", 96, 128, 128, 2, 2, False), ("float32", 96, 256, 256, 4, 2, True),
    ("float16", 64, 128, 128, 4, 4, True), ("float16", 64, 128, 256, 4, 2, False),
]


def _to(a, dtype):
    """The same values for both frameworks in ``dtype``."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), getattr(jnp, dtype)), t


@pytest.mark.parametrize("dtype,h,sq,sk,n,nkv,causal", CASES)
def test_flash_forward_matches_pallas_every_dtype(dtype, h, sq, sk, n, nkv, causal):
    (jq, tq), (jk, tk), (jv, tv) = (_to(a, dtype) for a in _qkv(30, sq, sk, n, nkv, h))
    want = jfa.flash_attention(jq, jk, jv, causal=causal)
    out, lse = tops.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else HALF_TOL
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    bq = min(128, sq)
    _, want_lse = jfa._fwd(*(jnp.swapaxes(a, 1, 2) for a in (jq, jk, jv)), 1.0 / np.sqrt(h),
                           causal, bq, min(128, sk))
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,h,sq,sk,n,nkv,causal", CASES)
def test_flash_backward_matches_pallas_vjp_every_dtype(dtype, h, sq, sk, n, nkv, causal):
    """Through the autograd Function (plain forward and backward on the
    CPU) against jax.vjp through the Pallas backward kernels."""
    arrays = _qkv(31, sq, sk, n, nkv, h)
    do = np.random.default_rng(32).standard_normal(arrays[0].shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    arrays = [torch.from_numpy(a).to(tdt).float().numpy() for a in arrays]
    do = torch.from_numpy(do).to(tdt).float().numpy()
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal),
                       *(jnp.asarray(a, jdt) for a in arrays))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, out.dtype))]
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    tops.flash_attention(*ts, causal=causal).backward(torch.from_numpy(do).to(tdt))
    tol = GRAD_TOL if dtype == "float32" else HALF_TOL
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        assert t.grad.dtype == tdt, name
        # a 16-bit gradient sums up to 256 rounded products: its rounding
        # is relative to its size
        atol = tol * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(t.grad.float().numpy(), w, atol=atol, rtol=tol, err_msg=name)


NO_KEY_TOL = 2e-5  # f32: the sums run in other orders


@pytest.mark.parametrize("sq,sk,oracle", [
    (300, 130, "flash_attention"),            # ragged: the public entry takes the reference
    (256, 128, "flash_attention_reference"),  # block multiples: the plain reference itself
])
def test_rows_that_see_no_key_take_the_reference_gradient(sq, sk, oracle):
    """Causal with Sq > Sk: rows i < Sq - Sk see no key, and the forward
    gives each the mean of V.  The port's autograd gradients (plain on the
    CPU) equal jax.grad through the JAX package's plain reference on every
    row: dQ 0 on those rows, nothing from them in dK, dO / Sk from each of
    them in every key's dV (GQA 2:1)."""
    rng = np.random.default_rng(40)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, sq, 2, 64), (1, sk, 1, 64), (1, sk, 1, 64), (1, sq, 2, 64))]
    *qkv, do = arrays
    fn = getattr(jfa, oracle)
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, causal=True), *(jnp.asarray(a) for a in qkv))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    ts = [torch.from_numpy(a).requires_grad_() for a in qkv]
    got_out = tops.flash_attention(*ts, causal=True)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), atol=NO_KEY_TOL,
                               rtol=NO_KEY_TOL)
    got_out.backward(torch.from_numpy(do))
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=NO_KEY_TOL, rtol=NO_KEY_TOL,
                                   err_msg=name)
    assert not ts[0].grad[:, :sq - sk].any()
