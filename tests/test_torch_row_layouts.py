"""The row kernels' wrappers take what the JAX package's ops take, on the
CPU: a residual of another dtype or of a broadcast shape (the reference
adds it first, promoting and broadcasting, and norms the sum), rows whose
stride is not their width, SwiGLU halves with a column stride, and SwiGLU
operands of two dtypes (the reference computes in f32 and writes x's
dtype).  On the card the same wrappers lay such inputs out for the
kernels (``tests/test_torch_cuda.py`` holds the kernels to their plain
versions there); here they take the plain versions.  Both sides get the
same values; tolerances as tests/test_torch_ops.py: f32 2e-5, bf16 2e-2
(one rounding of the output), the residual sum bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as jops

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.nn import functional as tF

F32_TOL = 2e-5
BF16_TOL = 2e-2
ROWS, HIDDEN = 6, 256


def _pair(a, dtype):
    """The same values for both frameworks in ``dtype`` ("float32" or
    "bfloat16")."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return jnp.asarray(t.float().numpy(), getattr(jnp, dtype)), t


def _close(got, want, dtype):
    tol = F32_TOL if got.dtype == torch.float32 and str(want.dtype) == "float32" else BF16_TOL
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=tol, rtol=tol)


def _both_norms(kind, jx, tx, jw, tw, jb, tb, jr, tr):
    if kind == "rms":
        want = jops.fused_rms_norm(jx, jw, epsilon=1e-6, residual=jr)
        got = tops.fused_rms_norm(tx, tw, epsilon=1e-6, residual=tr)
    else:
        want = jops.fused_layer_norm(jx, jw, jb, epsilon=1e-5, residual=jr)
        got = tops.fused_layer_norm(tx, tw, tb, epsilon=1e-5, residual=tr)
    return got, want


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("xdt,rdt,rshape", [
    ("bfloat16", "float32", (ROWS, HIDDEN)),    # a residual of another dtype
    ("float32", "bfloat16", (ROWS, HIDDEN)),
    ("bfloat16", "bfloat16", (HIDDEN,)),        # a broadcast residual
    ("float32", "float32", (1, HIDDEN)),
    ("bfloat16", "float32", (HIDDEN,)),         # both
])
def test_norm_residual_the_kernels_cannot_add_matches_jax(kind, xdt, rdt, rshape):
    rng = np.random.default_rng(len(rshape) + 3 * (xdt == rdt))
    jx, tx = _pair(rng.standard_normal((ROWS, HIDDEN)).astype(np.float32), xdt)
    jr, tr = _pair(rng.standard_normal(rshape).astype(np.float32), rdt)
    jw, tw = _pair((1 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32), "float32")
    jb, tb = _pair((0.1 * rng.standard_normal(HIDDEN)).astype(np.float32), "float32")
    (got, gsum), (want, wsum) = _both_norms(kind, jx, tx, jw, tw, jb, tb, jr, tr)
    np.testing.assert_array_equal(gsum.float().numpy(), np.asarray(wsum.astype(jnp.float32)))
    assert gsum.dtype == torch.promote_types(tx.dtype, tr.dtype)
    _close(got, want, xdt)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_norm_strided_rows_match_jax(kind, dtype, residual):
    """Rows of a wider buffer (row stride 2 x hidden) and a transposed
    residual: the wrappers hand the kernels dense rows."""
    rng = np.random.default_rng(7)
    wide = rng.standard_normal((ROWS, 2 * HIDDEN)).astype(np.float32)
    jwide, twide = _pair(wide, dtype)
    jx, tx = jwide[:, :HIDDEN], twide[:, :HIDDEN]
    assert tx.stride(0) == 2 * HIDDEN
    jr = tr = None
    if residual:
        jr, tr = _pair(rng.standard_normal((HIDDEN, ROWS)).astype(np.float32), dtype)
        jr, tr = jr.T, tr.t()
    jw, tw = _pair((1 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32), dtype)
    jb, tb = _pair((0.1 * rng.standard_normal(HIDDEN)).astype(np.float32), dtype)
    got, want = _both_norms(kind, jx, tx, jw, tw, jb, tb, jr, tr)
    if residual:
        np.testing.assert_array_equal(got[1].float().numpy(),
                                      np.asarray(want[1].astype(jnp.float32)))
        got, want = got[0], want[0]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_strided_columns_match_jax(dtype):
    """Halves read every fourth column of a buffer (column stride 4), and a
    transposed pair: the wrapper hands the kernel unit column strides."""
    rng = np.random.default_rng(8)
    jbuf, tbuf = _pair(rng.standard_normal((ROWS, 4 * HIDDEN)).astype(np.float32), dtype)
    jx, tx = jbuf[:, 0::4], tbuf[:, 0::4]
    jy, ty = jbuf[:, 1::4], tbuf[:, 1::4]
    assert tx.stride(1) == 4
    _close(tops.swiglu(tx, ty), jops.swiglu(jx, jy), dtype)
    jt, tt = _pair(rng.standard_normal((HIDDEN, ROWS)).astype(np.float32), dtype)
    _close(tops.swiglu(tt.t(), tt.t() * 0.5), jops.swiglu(jt.T, jt.T * 0.5), dtype)


@pytest.mark.parametrize("xdt,ydt", [("bfloat16", "float32"), ("float32", "bfloat16")])
def test_swiglu_two_dtypes_match_jax(xdt, ydt):
    """silu(x) * y in f32 over both, written in x's dtype, as the JAX
    package's kernel writes it; the gradients in each operand's dtype."""
    rng = np.random.default_rng(9)
    jx, tx = _pair(rng.standard_normal((ROWS, HIDDEN)).astype(np.float32), xdt)
    jy, ty = _pair(rng.standard_normal((ROWS, HIDDEN)).astype(np.float32), ydt)
    tx.requires_grad_()
    ty.requires_grad_()
    got = tops.swiglu(tx, ty)
    _close(got, jops.swiglu(jx, jy), xdt)
    got.float().sum().backward()
    assert tx.grad.dtype == tx.dtype and ty.grad.dtype == ty.dtype


def test_captured_norm_of_a_mixed_dtype_add_matches_jax():
    """``layer_norm(a + r)`` with a bf16 and r f32, captured as a Program:
    the add-norm pattern fuses it into add_layer_norm, whose fetch equals
    the JAX package's fused op on the same values (the sum promoted to
    f32)."""
    rng = np.random.default_rng(10)
    av = rng.standard_normal((4, 64)).astype(np.float32)
    rv = rng.standard_normal((4, 64)).astype(np.float32)
    wv = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bv = (0.1 * rng.standard_normal(64)).astype(np.float32)
    ja, ta = _pair(av, "bfloat16")
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        a = tstatic.data("a", [4, 64], "bfloat16")
        r = tstatic.data("r", [4, 64], "float32")
        out = tF.layer_norm(a + r, 64, torch.from_numpy(wv), torch.from_numpy(bv), 1e-5)
    (got,) = tstatic.Executor("cpu").run(prog, feed={"a": ta, "r": torch.from_numpy(rv)},
                                         fetch_list=[out], return_numpy=False)
    assert "add_layer_norm" in [op.type for op in prog.global_block().ops]
    want, _ = jops.fused_layer_norm(ja, jnp.asarray(wv), jnp.asarray(bv), epsilon=1e-5,
                                    residual=jnp.asarray(rv))
    _close(got, want, "float32")
