"""The port's hand-written kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA card
and skip without one.  They import no JAX, so they also run where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are bf16's: 2e-2 (one bf16 rounding of the output; the flash
kernel also rounds P to bf16 before the P V product).  The backward
kernels round P and dS to bf16 before their products and each gradient
once at the end; they are held at 2e-2 absolute and relative too.  The
serving chains (``ops.decode_chain``) write the pools bit-exactly as their
plain versions do (count of differing elements 0) and hold the attention
output at 2e-2 for bf16 outputs and int8 pools, 2e-5 for f32.  f16 flash
and matmul cases take bf16's 2e-2 (f16 rounds more finely); the f32 flash
kernels (FMA) are held at 1e-4 against the plain f32 einsums, which sum in
another order.  The RMSNorm and SwiGLU kernels of ``csrc/norm_swiglu.cu``
take bf16's 2e-2 in bf16 and f16 and 1e-5 in f32 (the sum of squares in
another order; SwiGLU's sigmoid through the fast exponential), against
the plain versions and the Triton yardsticks alike; the residual sum is
bit-exact.  On a card, run the TMA kernels' single-tile witnesses
first (``-k witness``).
"""

import importlib

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops.fused_norm import rms_norm_plain
from paddle_tpu_torch.ops.swiglu import swiglu_plain

TOL = 2e-2
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, device):
    return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 4, 37])
def test_rms_norm_kernel(cuda, rows):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, w = _randn(g, rows, 4096, device=cuda), _randn(g, 4096, device=cuda)
    before = ops.launch_counts()["fused_rms_norm"]
    got = ops.fused_rms_norm(x, w)
    assert ops.launch_counts()["fused_rms_norm"] == before + 1
    torch.testing.assert_close(got.float(), rms_norm_plain(x, w, 1e-6).float(),
                               atol=TOL, rtol=TOL)


def test_swiglu_kernel_reads_split_halves(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    gate_up = _randn(g, 3, 5, 2 * 688, device=cuda)
    got = ops.swiglu(gate_up)
    x, y = gate_up.chunk(2, dim=-1)
    torch.testing.assert_close(got.float(), swiglu_plain(x, y).float(),
                               atol=TOL, rtol=TOL)


DTYPE_TOL = {torch.bfloat16: TOL, torch.float16: TOL, torch.float32: 1e-5}
NORM_ROWS = [0, 1, 4, 37, 128, 4096]


def _rand_dtype(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


def _norm_case(cuda, rows, hidden, dtype, residual):
    fused_norm = importlib.import_module("paddle_tpu_torch.ops.fused_norm")
    g = torch.Generator(device=cuda).manual_seed(rows * 7 + hidden)
    x = _rand_dtype(g, rows, hidden, dtype=dtype, device=cuda)
    r = _rand_dtype(g, rows, hidden, dtype=dtype, device=cuda) if residual else None
    w = (1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)).to(dtype)
    ops.reset_launch_counts()
    got = ops.fused_rms_norm(x, w, epsilon=1e-6, residual=r)
    launched = ops.launch_counts()["fused_rms_norm"]
    yard, yard_s = fused_norm._rms_norm_triton(x, r, w, 1e-6)
    torch.cuda.synchronize()
    assert launched == (1 if rows else 0)
    assert ops.launch_counts()["fused_rms_norm"] == launched  # the yardstick ticks it not
    assert ops.yardstick_counts()["fused_rms_norm_triton"] == (1 if rows else 0)
    out, s = got if residual else (got, None)
    want_s = x + r if residual else None
    want = rms_norm_plain(want_s if residual else x, w, 1e-6)
    tol = DTYPE_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out.float(), yard.float(), atol=tol, rtol=tol)
    if residual:
        assert torch.equal(s, want_s) and torch.equal(yard_s, want_s)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("hidden", [4096, 2048, 4095])
@pytest.mark.parametrize("rows", NORM_ROWS)
def test_rms_norm_cuda_kernel(cuda, rows, hidden, dtype, residual):
    """csrc/norm_swiglu.cu's RMSNorm against its plain version and the
    Triton yardstick on the same inputs; 4095 takes the element loads."""
    _norm_case(cuda, rows, hidden, dtype, residual)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("rows,hidden", [(1, 100), (37, 100), (4096, 100), (3, 65536),
                                         (1000, 20000)])
def test_rms_norm_cuda_kernel_small_and_long_rows(cuda, rows, hidden, residual):
    """f16 at hidden 100 (200-byte rows: element loads), and rows longer
    than a block's lanes hold (read twice: the sum of squares first, then
    the scaled output), 1,000 of them more than stay resident."""
    _norm_case(cuda, rows, hidden, torch.float16, residual)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("hidden", [4096, 2048, 4095])
@pytest.mark.parametrize("dtype,wdtype", [
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float16)])
def test_rms_norm_cuda_weight_of_another_dtype(cuda, dtype, wdtype, hidden, residual):
    """A weight whose dtype differs from x's (bf16 rows, f32 weight: 32
    bytes of weight a 16-byte chunk of x; f32 rows, bf16 weight: 8) is
    read in its own dtype, as the plain version and the Triton yardstick
    read it; 4095 takes the element loads."""
    fused_norm = importlib.import_module("paddle_tpu_torch.ops.fused_norm")
    g = torch.Generator(device=cuda).manual_seed(hidden + 5)
    x = _rand_dtype(g, 37, hidden, dtype=dtype, device=cuda)
    r = _rand_dtype(g, 37, hidden, dtype=dtype, device=cuda) if residual else None
    w = (1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)).to(wdtype)
    ops.reset_launch_counts()
    got = ops.fused_rms_norm(x, w, epsilon=1e-6, residual=r)
    assert ops.launch_counts()["fused_rms_norm"] == 1
    yard, _ = fused_norm._rms_norm_triton(x, r, w, 1e-6)
    out = got[0] if residual else got
    want = rms_norm_plain(x + r if residual else x, w, 1e-6)
    tol = DTYPE_TOL[dtype]
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out.float(), yard.float(), atol=tol, rtol=tol)
    if residual:
        assert torch.equal(got[1], x + r)


SWIGLU_COLS = [11008, 5632, 688, 689]


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("cols", SWIGLU_COLS)
@pytest.mark.parametrize("rows", [0, 1, 4, 37, 128, 640])
def test_swiglu_cuda_kernel(cuda, rows, cols, dtype, split):
    """csrc/norm_swiglu.cu's SwiGLU on the gate/up halves of one projection
    (read in place through their row strides) and on two tensors, against
    the plain version and the Triton yardstick; 689 columns take the
    element loads."""
    swiglu_mod = importlib.import_module("paddle_tpu_torch.ops.swiglu")
    g = torch.Generator(device=cuda).manual_seed(rows + cols)
    if split:
        gate_up = _rand_dtype(g, rows, 2 * cols, dtype=dtype, device=cuda)
        x, y = gate_up.chunk(2, dim=-1)
    else:
        x = _rand_dtype(g, rows, cols, dtype=dtype, device=cuda)
        y = _rand_dtype(g, rows, cols, dtype=dtype, device=cuda)
    ops.reset_launch_counts()
    got = ops.swiglu(gate_up) if split else ops.swiglu(x, y)
    launched = ops.launch_counts()["swiglu"]
    yard = swiglu_mod._swiglu_triton(x, y)
    torch.cuda.synchronize()
    assert launched == (1 if rows else 0) and ops.launch_counts()["swiglu"] == launched
    assert ops.yardstick_counts()["swiglu_triton"] == (1 if rows else 0)
    tol = DTYPE_TOL[dtype]
    want = swiglu_plain(x, y)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), yard.float(), atol=tol, rtol=tol)


def test_swiglu_cuda_kernel_many_row_groups(cuda):
    """More row groups than the grid's 65,535: the blocks walk the rest."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x, y = _randn(g, 300000, 16, device=cuda), _randn(g, 300000, 16, device=cuda)
    got = ops.swiglu(x, y)
    torch.testing.assert_close(got.float(), swiglu_plain(x, y).float(), atol=TOL, rtol=TOL)


def test_norm_swiglu_kernels_refuse_what_they_do_not_take(cuda):
    for dtype in (torch.float64, torch.int32):
        x = torch.ones(4, 64, device=cuda, dtype=dtype)
        with pytest.raises(TypeError, match="unsupported dtype"):
            ops.fused_rms_norm(x, torch.ones(64, device=cuda, dtype=dtype))
        with pytest.raises(TypeError, match="unsupported dtypes"):
            ops.swiglu(x, x)
    x = torch.ones(4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="unsupported weight dtype"):
        ops.fused_rms_norm(x, torch.ones(64, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError, match="unsupported dtypes"):
        ops.swiglu(x.double(), x.double())


@pytest.mark.parametrize("sq,sk,n,nkv,h,causal", [
    (128, 128, 4, 4, 128, True), (100, 100, 4, 2, 128, True), (37, 200, 2, 2, 64, True),
    (70, 70, 2, 1, 64, False)])
def test_flash_kernel(cuda, sq, sk, n, nkv, h, causal):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(g, 2, sq, n, h, device=cuda)
    k, v = _randn(g, 2, sk, nkv, h, device=cuda), _randn(g, 2, sk, nkv, h, device=cuda)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ops.flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    assert lse.shape == (2, n, sq) and torch.isfinite(lse).all()


def _flash_against_plain(q, k, v, causal, tol):
    """Run the forward, hold out and lse against the plain version; return
    the launch counts it added."""
    from paddle_tpu_torch.ops.flash_attention import _reference_with_lse

    before = ops.launch_counts()
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    after = ops.launch_counts()
    torch.cuda.synchronize()
    want, want_lse = _reference_with_lse(q, k, v, causal, q.shape[-1] ** -0.5)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    return {key: after[key] - before[key] for key in after}


def test_flash_fwd_sm90_single_tile_witness(cuda):
    """The smallest witness of a layout fault in the TMA/wgmma kernel: one
    block, one 128 x 128 tile, H 64, non-causal.  Run it first on a card."""
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = (_randn(g, 1, 128, 1, 64, device=cuda) for _ in range(3))
    added = _flash_against_plain(q, k, v, False, TOL)
    assert added["flash_attention_fwd_sm90"] == 1 and added["flash_attention_fwd"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,sk,n,nkv,h,causal", [
    (1, 128, 128, 1, 1, 128, False), (2, 256, 256, 4, 4, 128, True),
    (1, 300, 300, 4, 2, 64, True), (2, 100, 357, 4, 4, 128, True),
    (1, 640, 640, 8, 8, 128, True), (1, 200, 1000, 4, 1, 64, False),
    (2, 1000, 1000, 2, 2, 64, False), (1, 37, 37, 2, 2, 128, True)])
def test_flash_fwd_sm90(cuda, dtype, b, sq, sk, n, nkv, h, causal):
    """The TMA/wgmma kernel: causal and not, ragged Sq and Sk, Sq < Sk
    (bottom-right), GQA, bf16 and f16 (one 16-bit rounding of P and of the
    output: 2e-2), H 64 and 128."""
    g = torch.Generator(device=cuda).manual_seed(21)
    q = torch.randn(b, sq, n, h, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, sk, nkv, h, generator=g, device=cuda).to(dtype) for _ in range(2))
    added = _flash_against_plain(q, k, v, causal, TOL)
    assert added["flash_attention_fwd_sm90"] == 1 and added["flash_attention_fwd"] == 1


F32_TOL = 1e-4  # f32 FMA kernels against the plain f32 einsums: other summation orders


def _make(gen, shape, dtype, layout, device):
    """A [B, S, N, H] tensor in one of three layouts: contiguous; "narrow",
    a view whose row strides are not 16-byte multiples (H + 4 wide); "hmajor",
    a view with a non-unit stride on H."""
    b, s, n, h = shape
    if layout == "narrow":
        return torch.randn(b, s, n, h + 4, generator=gen, device=device).to(dtype)[..., :h]
    if layout == "hmajor":
        return torch.randn(b, s, h, n, generator=gen, device=device).to(dtype).transpose(2, 3)
    return torch.randn(b, s, n, h, generator=gen, device=device).to(dtype)


GENERAL_FWD_CASES = [  # (dtype, H, layout, B, Sq, Sk, N, Nkv, causal)
    (torch.float32, 32, "contiguous", 2, 100, 100, 4, 4, True),
    (torch.float32, 64, "contiguous", 1, 128, 300, 4, 2, True),
    (torch.float32, 96, "contiguous", 1, 77, 77, 2, 2, False),
    (torch.float32, 128, "narrow", 1, 130, 130, 2, 1, True),
    (torch.float32, 256, "contiguous", 1, 70, 70, 2, 2, True),
    (torch.bfloat16, 32, "contiguous", 2, 100, 100, 4, 4, True),
    (torch.bfloat16, 96, "contiguous", 1, 200, 200, 4, 2, True),
    (torch.bfloat16, 256, "contiguous", 1, 130, 130, 2, 2, False),
    (torch.bfloat16, 64, "narrow", 1, 100, 150, 4, 4, True),
    (torch.bfloat16, 128, "hmajor", 1, 64, 64, 2, 2, True),
    (torch.float16, 32, "contiguous", 1, 90, 90, 2, 2, True),
    (torch.float16, 96, "narrow", 1, 128, 128, 2, 1, False),
    (torch.float16, 256, "contiguous", 2, 100, 100, 2, 2, True),
    (torch.bfloat16, 40, "contiguous", 1, 50, 50, 2, 2, True),
]


@pytest.mark.parametrize("dtype,h,layout,b,sq,sk,n,nkv,causal", GENERAL_FWD_CASES)
def test_flash_fwd_general_route(cuda, dtype, h, layout, b, sq, sk, n, nkv, causal):
    """What the TMA kernel does not take runs the general kernel: f32 (FMA),
    head dims other than 64 and 128 (zero-padded inside), row strides that
    are not 16-byte multiples and a non-unit H stride (element loads, no
    copy).  bf16/f16 within 2e-2, f32 within F32_TOL."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(22)
    q = _make(g, (b, sq, n, h), dtype, layout, cuda)
    k, v = (_make(g, (b, sk, nkv, h), dtype, layout, cuda) for _ in range(2))
    assert fa._fwd_route(q.dtype, h, q.stride(), q.data_ptr()) == "general"
    added = _flash_against_plain(q, k, v, causal, F32_TOL if dtype == torch.float32 else TOL)
    assert added["flash_attention_fwd"] == 1 and added["flash_attention_fwd_sm90"] == 0


GENERAL_BWD_CASES = [  # (dtype, H, layout, Sq, Sk, N, Nkv, causal)
    (torch.float32, 32, "contiguous", 100, 100, 4, 2, True),
    (torch.float32, 64, "narrow", 64, 128, 2, 2, True),
    (torch.float32, 96, "contiguous", 77, 77, 2, 2, False),
    (torch.float32, 128, "contiguous", 130, 130, 2, 1, True),
    (torch.float32, 256, "contiguous", 70, 70, 2, 2, True),
    (torch.float16, 32, "contiguous", 100, 100, 4, 2, True),
    (torch.float16, 64, "contiguous", 256, 256, 4, 4, True),
    (torch.float16, 96, "narrow", 128, 128, 2, 2, False),
    (torch.float16, 128, "contiguous", 100, 200, 4, 2, True),
    (torch.float16, 256, "contiguous", 130, 130, 2, 2, True),
    (torch.bfloat16, 32, "contiguous", 90, 90, 2, 2, True),
    (torch.bfloat16, 96, "contiguous", 200, 200, 4, 2, True),
    (torch.bfloat16, 256, "contiguous", 128, 256, 2, 1, True),
    (torch.bfloat16, 128, "hmajor", 64, 64, 2, 2, False),
]


@pytest.mark.parametrize("dtype,h,layout,sq,sk,n,nkv,causal", GENERAL_BWD_CASES)
def test_flash_backward_every_dtype_and_head_dim(cuda, dtype, h, layout, sq, sk, n, nkv, causal):
    """The two backward kernels in f32 (FMA), f16 and bf16 (mma.sync), at
    H 32 to 256 (above 128 the dK/dV key tile halves and two warps split H),
    against the plain backward: 16-bit within 2e-2, f32 within F32_TOL.
    The contiguous f16 cases at H 64 and 128 take the TMA/wgmma pair."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q = _make(g, (2, sq, n, h), dtype, layout, cuda)
    k, v = (_make(g, (2, sk, nkv, h), dtype, layout, cuda) for _ in range(2))
    do = _make(g, (2, sq, n, h), dtype, layout, cuda)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    before = ops.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    after = ops.launch_counts()
    torch.cuda.synchronize()
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    want = ops.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
    tol = F32_TOL if dtype == torch.float32 else TOL
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)


def test_llama_tiny_f32_forward_and_backward_on_the_card(cuda):
    """llama_tiny in f32 (head_dim 64): the card's forward and backward go
    through the general flash kernels and match the CPU's plain run of the
    same weights within F32_TOL relative L2."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    model = LlamaForCausalLM(llama_tiny(dtype="float32"), device="cpu",
                             generator=torch.Generator().manual_seed(24))
    ids = torch.randint(0, 1024, (2, 48), generator=torch.Generator().manual_seed(25))
    results = []
    for device in ("cpu", cuda):
        m = model.to(device)
        m.zero_grad(set_to_none=True)
        ops.reset_launch_counts()
        loss, logits = m(ids.to(device), labels=ids.to(device))
        loss.backward()
        results.append((ops.launch_counts(), logits.detach().cpu(),
                        m.lm_head.weight.grad.detach().cpu()))
    (cpu_counts, cpu_logits, cpu_grad), (counts, logits, grad) = results
    assert cpu_counts["flash_attention_fwd"] == 0
    assert counts["flash_attention_fwd"] == 2 and counts["flash_attention_fwd_sm90"] == 0
    assert counts["flash_attention_bwd_dq"] == 2 and counts["flash_attention_bwd_dkv"] == 2
    for got, want in ((logits, cpu_logits), (grad, cpu_grad)):
        assert float((got - want).norm() / want.norm()) <= F32_TOL


@pytest.mark.parametrize("sq,sk,n,nkv,h,causal", [
    (256, 256, 4, 4, 128, True), (100, 100, 4, 2, 128, True), (37, 200, 2, 2, 64, True),
    (70, 70, 2, 1, 64, False)])
def test_flash_backward_kernels(cuda, sq, sk, n, nkv, h, causal):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(g, 2, sq, n, h, device=cuda)
    k, v = _randn(g, 2, sk, nkv, h, device=cuda), _randn(g, 2, sk, nkv, h, device=cuda)
    do = _randn(g, 2, sq, n, h, device=cuda)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    before = ops.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    after = ops.launch_counts()
    torch.cuda.synchronize()
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    want = ops.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, name
        torch.testing.assert_close(a.float(), b.float(), atol=TOL, rtol=TOL, msg=name)


def _bwd_against_plain(q, k, v, do, causal, tol):
    """Run the backward, hold dq, dk, dv against the plain version; return
    the launch counts it added."""
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    before = ops.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    after = ops.launch_counts()
    torch.cuda.synchronize()
    want = ops.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)
    return {key: after[key] - before[key] for key in after}


def _sm90_stats(out, do, lse):
    """What the sm90 dQ kernel writes for the dK/dV kernel, in torch: f32
    [B, N, 2, Sq rounded up to 64] rows of lse * log2(e) (+inf past Sq)
    and delta (0 past Sq)."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    b, sq, n, _ = out.shape
    pad = -(-sq // fa.STAT_PAD) * fa.STAT_PAD
    stats = torch.zeros(b, n, 2, pad, device=out.device)
    stats[:, :, 0, :] = float("inf")
    stats[:, :, 0, :sq] = lse * 1.4426950408889634
    stats[:, :, 1, :sq] = fa._delta(out, do)
    return stats


def test_flash_bwd_dq_sm90_single_tile_witness(cuda):
    """The smallest witness of a layout fault in the TMA/wgmma dQ kernel:
    one block, one 128 x 128 tile, H 64, non-causal; its dQ and the rows of
    lse and delta it writes for the dK/dV kernel.  Run it first on a card."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(26)
    q, k, v, do = (_randn(g, 1, 128, 1, 64, device=cuda) for _ in range(4))
    out, lse = ops.flash_attention_fwd(q, k, v)
    dq, stats = fa._bwd_dq_sm90(q, k, v, out, do, lse, False, 64 ** -0.5)
    torch.cuda.synchronize()
    want = ops.flash_attention_bwd_reference(q, k, v, out, lse, do)
    torch.testing.assert_close(dq.float(), want[0].float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(stats, _sm90_stats(out, do, lse), atol=1e-4, rtol=1e-5)


def test_flash_bwd_dkv_sm90_single_tile_witness(cuda):
    """The same for the TMA/wgmma dK/dV kernel, fed the stats rows computed
    with torch: one block of 128 keys, two 64-row q tiles, H 64."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(27)
    q, k, v, do = (_randn(g, 1, 128, 1, 64, device=cuda) for _ in range(4))
    out, lse = ops.flash_attention_fwd(q, k, v)
    dk, dv = fa._bwd_dkv_sm90(q, k, v, do, _sm90_stats(out, do, lse), False, 64 ** -0.5)
    torch.cuda.synchronize()
    want = ops.flash_attention_bwd_reference(q, k, v, out, lse, do)
    torch.testing.assert_close(dk.float(), want[1].float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(dv.float(), want[2].float(), atol=TOL, rtol=TOL)


SM90_BWD_CASES = [  # (dtype, B, Sq, Sk, N, Nkv, H, causal): chip_smoke.py's grid, small
    (torch.bfloat16, 2, 256, 256, 4, 4, 128, True),
    (torch.bfloat16, 2, 256, 256, 4, 4, 128, False),
    (torch.bfloat16, 1, 256, 256, 8, 2, 128, True),
    (torch.bfloat16, 1, 200, 200, 4, 4, 128, True),
    (torch.bfloat16, 1, 100, 357, 4, 4, 128, True),
    (torch.bfloat16, 2, 37, 37, 2, 2, 64, False),
    (torch.float16, 2, 256, 256, 4, 4, 128, True),
    (torch.float16, 1, 190, 190, 4, 2, 64, True),
    (torch.float16, 1, 128, 640, 4, 4, 64, False),
]


@pytest.mark.parametrize("dtype,b,sq,sk,n,nkv,h,causal", SM90_BWD_CASES)
def test_flash_bwd_sm90(cuda, dtype, b, sq, sk, n, nkv, h, causal):
    """The TMA/wgmma backward pair: causal and not, GQA (the dK/dV kernel
    sums the group), ragged Sq and Sk, Sq < Sk, bf16 and f16, H 64 and
    128, within 2e-2; both launches count under the route-less and the
    _sm90 names."""
    g = torch.Generator(device=cuda).manual_seed(28)
    q = torch.randn(b, sq, n, h, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, sk, nkv, h, generator=g, device=cuda).to(dtype) for _ in range(2))
    do = torch.randn(b, sq, n, h, generator=g, device=cuda).to(dtype)
    added = _bwd_against_plain(q, k, v, do, causal, TOL)
    assert added["flash_attention_bwd_dq"] == added["flash_attention_bwd_dq_sm90"] == 1
    assert added["flash_attention_bwd_dkv"] == added["flash_attention_bwd_dkv_sm90"] == 1


def test_flash_bwd_sm90_rows_that_see_no_key(cuda):
    """Causal with Sq > Sk: the first Sq - Sk rows see no key (the forward
    gives each the mean of V).  Both routes, the sm90 pair and the general
    pair, equal the plain version on every row: dQ 0 on those rows, nothing
    from them in dK, dO / Sk from each of them in every key's dV (the
    gradient jax.grad of the JAX package's plain reference gives;
    tests/test_torch_flash_routes.py holds the plain version to it).  Also
    in f32 on the general route (1e-4)."""
    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(30)
    for dtype, tol in ((torch.bfloat16, TOL), (torch.float32, 1e-4)):
        q, do = (torch.randn(1, 300, 2, 64, generator=g, device=cuda).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(1, 130, 1, 64, generator=g, device=cuda).to(dtype)
                for _ in range(2))
        out, lse = ops.flash_attention_fwd(q, k, v, causal=True)
        scale = 64 ** -0.5
        routes = {}
        if dtype == torch.bfloat16:
            dq, stats = fa._bwd_dq_sm90(q, k, v, out, do, lse, True, scale)
            routes["sm90"] = (dq, *fa._bwd_dkv_sm90(q, k, v, do, stats, True, scale))
        delta = fa._delta(out, do)
        routes["general"] = (fa._bwd_dq_cuda(q, k, v, do, lse, delta, True, scale),
                             *fa._bwd_dkv_cuda(q, k, v, do, lse, delta, True, scale))
        torch.cuda.synchronize()
        want = ops.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)
        assert not want[0][:, :170].any()
        for route, got in routes.items():
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                           msg=f"{route} {name} {dtype}")
            assert not got[0][:, :170].any(), route


def test_flash_bwd_general_route_when_one_tensor_is_not_tma_readable(cuda):
    """dO with a non-unit H stride sends the whole backward to the general
    kernels: the route-less counters grow, the _sm90 ones do not."""
    g = torch.Generator(device=cuda).manual_seed(29)
    q, k, v = (_randn(g, 1, 128, 2, 128, device=cuda) for _ in range(3))
    do = _make(g, (1, 128, 2, 128), torch.bfloat16, "hmajor", cuda)
    added = _bwd_against_plain(q, k, v, do, True, TOL)
    assert added["flash_attention_bwd_dq"] == added["flash_attention_bwd_dkv"] == 1
    assert added["flash_attention_bwd_dq_sm90"] == added["flash_attention_bwd_dkv_sm90"] == 0


def test_backward_reaches_every_parameter(cuda):
    """A loss from the card's logits gives every parameter of a 2-layer
    bf16 model a finite gradient through all three kernels' Functions."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    g = torch.Generator(device=cuda).manual_seed(4)
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=2), device=cuda, generator=g)
    ids = torch.randint(0, 1024, (2, 64), device=cuda, generator=g)
    labels = torch.randint(0, 1024, (2, 64), device=cuda, generator=g)
    ops.reset_launch_counts()
    loss, logits = model(ids, labels=labels)
    loss.backward()
    counts = ops.launch_counts()
    assert counts == {"fused_rms_norm": 5, "swiglu": 2, "flash_attention_fwd": 2,
                      "flash_attention_fwd_sm90": 2, "flash_attention_bwd_dq": 2,
                      "flash_attention_bwd_dkv": 2, "flash_attention_bwd_dq_sm90": 2,
                      "flash_attention_bwd_dkv_sm90": 2, "decode_chain_batch": 0,
                      "decode_chain_rows": 0, "decode_chain_batch_sm90": 0,
                      "decode_chain_rows_sm90": 0, "prefill_chain": 0, "prefill_chain_sm90": 0,
                      "fused_layer_norm": 0, "matmul_epilogue": 0, "matmul_epilogue_sm90": 0,
                      "vpu_chain": 0, "sched_chain": 0, "sched_chain_ktiled": 0}
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.float().abs().sum() > 0, name


def test_kernels_refuse_what_they_do_not_take(cuda):
    """Every float dtype and head_dim up to 256 run a flash kernel; only
    head_dim past 256 and dtypes that are not bf16, f16 or f32 raise (and
    the backward's tensors must share one dtype)."""
    q = torch.zeros(1, 8, 2, 264, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 264 is past the kernels' limit of 256"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="bf16, f16 or f32"):
        ops.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="bf16, f16 or f32"):
        ops.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention_bwd(q, q, q, q, lse, q.float())


def test_time_step_ms_on_the_card(cuda):
    from paddle_tpu_torch.device import synchronize, time_step_ms

    x = torch.ones(1 << 20, device=cuda)
    calls = []
    ms = time_step_ms(lambda: calls.append(x.mul_(1.0)), inner=3, samples=2)
    synchronize()
    assert ms > 0 and len(calls) == 6


# ------------------------------------------------------------ serving chains


def _chain_args(device, b, n, nkv, h, bs, w, lens, kv, dtype, seed=5):
    """Pools with every row owning disjoint random pages, plus the decode
    step's q, k_new, v_new, tables and lens."""
    from paddle_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=device).manual_seed(seed)
    nb = b * w + b
    kc, vc = pa.alloc_paged_cache(nb, nkv, bs, h, "int8" if kv == "int8" else dtype, device)
    ids = torch.arange(b * w, device=device).reshape(b, w)
    for pool in (kc, vc):
        pa.paged_pour_blocks(pool, torch.randn(b * w, nkv, bs, h, generator=g, device=device),
                             ids.reshape(-1))

    def rnd(*shape):
        return (3 * torch.randn(*shape, generator=g, device=device)).to(dtype)

    return (kc, vc, rnd(b, n, h), rnd(b, nkv, h), rnd(b, nkv, h), ids,
            torch.tensor(lens, device=device))


def _pools_equal(a, b):
    from paddle_tpu_torch.ops import paged_attention as pa

    if isinstance(a, pa.QuantPool):
        return int((a.data != b.data).sum() + (a.scale != b.scale).sum())
    return int((a != b).sum())


@pytest.mark.parametrize("kv,dtype", [("bf16", torch.bfloat16), ("int8", torch.bfloat16),
                                      ("bf16", torch.float32), ("int8", torch.float32)])
@pytest.mark.parametrize("layout", ["batch", "rows2", "rows4", "rows8"])
@pytest.mark.parametrize("n,nkv,h,bs,lens", [
    (4, 4, 128, 16, [18, 160, 290, 680]),
    (8, 2, 64, 8, [1, 9, 16, 33]),     # fresh block (bs*k + 1) and a block's last slot
    (32, 8, 128, 16, [17, 32, 49, 64]),
    (32, 32, 128, 16, [18, 160, 290, 680]),   # the 7B serving geometry
    (32, 8, 128, 16, [18, 160, 290, 680]),    # GQA 32:8
    (32, 4, 128, 16, [18, 160, 290, 680]),    # GQA 32:4 (8 query heads a kv head)
    (32, 32, 128, 16, [17, 32, 161, 256]),    # ragged: fresh pages and pages' last slots
    (16, 16, 64, 16, [1, 100, 33, 640]),      # H 64, lens 1
    (8, 8, 128, 16, [1024, 1024, 1024, 1024])])  # a full 64-page table
def test_decode_chain_kernels(cuda, kv, dtype, layout, n, nkv, h, bs, lens):
    """Both routes (bf16: decode_chain_sm90.cu, and decode_chain.cu's kernel
    on the same inputs; f32: decode_chain.cu) and both layouts: pools
    bit-exact against the plain version, outputs within 2e-2 (f32 2e-5);
    the sm90 counter equals the route-less one."""
    from paddle_tpu_torch.ops import decode_chain as dc

    if layout != "batch" and kv != "int8":
        pytest.skip("the rows layout is for int8 pools only")
    pages = max(-(-x // bs) for x in lens)
    w = pages if lens == [1024] * 4 else pages + 1
    args = _chain_args(cuda, len(lens), n, nkv, h, bs, w, lens, kv, dtype)
    ref_args = (args[0].clone(), args[1].clone()) + args[2:]
    general_args = (args[0].clone(), args[1].clone()) + args[2:]
    splits = 1 if layout == "batch" else int(layout[4:])
    fn = dc.DecodeChainSpec(len(lens), n, nkv, h, bs, w, len(lens) * (w + 1), kv=kv,
                            dtype=dtype, device=cuda).build(
        {"layout": "batch"} if layout == "batch" else {"layout": "rows", "splits": splits})
    name = "decode_chain_batch" if layout == "batch" else "decode_chain_rows"
    sm90 = dtype == torch.bfloat16
    assert dc._decode_route(dtype, args[0].data.dtype if kv == "int8" else dtype, h,
                            n // nkv) == ("sm90" if sm90 else "general")
    before = ops.launch_counts()
    o, kc, vc = fn(*args)
    after = ops.launch_counts()
    assert after[name] == before[name] + 1
    assert after[f"{name}_sm90"] == before[f"{name}_sm90"] + int(sm90)
    r_o, r_kc, r_vc = dc.decode_chain_plain(*ref_args)
    g_o = dc._decode_general(*general_args, splits)
    torch.cuda.synchronize()
    assert _pools_equal(kc, r_kc) == 0 and _pools_equal(vc, r_vc) == 0
    assert _pools_equal(general_args[0], r_kc) == 0 and _pools_equal(general_args[1], r_vc) == 0
    tol = dc._tolerance(dtype, kv)
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), r_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(g_o.float(), r_o.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("lens,w", [([5], 1), ([100], 8)])
def test_decode_chain_sm90_witness(cuda, kv, lens, w):
    """The smallest witnesses of a fault in the sm90 decode kernel: one row,
    one kv head, H 64: a single page in a single block (no cluster), then
    7 pages dealt over a cluster of 8 blocks (one run empty), merged
    through distributed shared memory.  Run them first on a card."""
    from paddle_tpu_torch.ops import decode_chain as dc

    args = _chain_args(cuda, 1, 1, 1, 64, 16, w, lens, kv, torch.bfloat16)
    ref_args = (args[0].clone(), args[1].clone()) + args[2:]
    assert dc.decode_cluster(1, 1, w, dc.sm_count(cuda)) == w
    before = ops.launch_counts()["decode_chain_batch_sm90"]
    o, kc, vc = dc.decode_chain_batch(*args)
    assert ops.launch_counts()["decode_chain_batch_sm90"] == before + 1
    r_o, r_kc, r_vc = dc.decode_chain_plain(*ref_args)
    torch.cuda.synchronize()
    assert _pools_equal(kc, r_kc) == 0 and _pools_equal(vc, r_vc) == 0
    tol = dc._tolerance(torch.bfloat16, kv)
    torch.testing.assert_close(o.float(), r_o.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_decode_chain_sm90_every_cluster(cuda, cluster):
    """Every cluster size the batch layout may take, on the ragged 7B case."""
    from paddle_tpu_torch.ops import decode_chain as dc

    lens = [17, 32, 161, 256]
    args = _chain_args(cuda, 4, 32, 32, 128, 16, 17, lens, "bf16", torch.bfloat16)
    ref_args = (args[0].clone(), args[1].clone()) + args[2:]
    o = dc._decode_sm90(*args, 1, cluster=cluster)
    r_o, r_kc, r_vc = dc.decode_chain_plain(*ref_args)
    torch.cuda.synchronize()
    assert _pools_equal(args[0], r_kc) == 0 and _pools_equal(args[1], r_vc) == 0
    torch.testing.assert_close(o.float(), r_o.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype,h", [(torch.bfloat16, 128), (torch.float32, 64),
                                     (torch.float32, 128)])
@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("t", [128, 256, 640])
def test_prefill_chain_kernel(cuda, dtype, h, block_q, t):
    from paddle_tpu_torch.ops import decode_chain as dc

    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(1, 128, 4, h, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, t, 4, h, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, t, 4, h, generator=g, device=cuda).to(dtype)
    before = ops.launch_counts()["prefill_chain"]
    got = dc.prefill_chain(q, k, v, block_q=block_q)
    assert ops.launch_counts()["prefill_chain"] == before + 1
    torch.cuda.synchronize()
    tol = dc._tolerance(dtype)
    torch.testing.assert_close(got.float(), dc.prefill_chain_plain(q, k, v).float(),
                               atol=tol, rtol=tol)


def test_prefill_chain_sm90_single_tile_witness(cuda):
    """The smallest witness of a layout fault in the TMA/wgmma prefill
    kernel: one block, one 128-key tile, one split, H 64.  Run it first on
    a card."""
    from paddle_tpu_torch.ops import decode_chain as dc

    g = torch.Generator(device=cuda).manual_seed(31)
    q, k, v = (_randn(g, 1, 128, 1, 64, device=cuda) for _ in range(3))
    before = ops.launch_counts()
    got = dc.prefill_chain(q, k, v, block_q=128)
    after = ops.launch_counts()
    assert after["prefill_chain_sm90"] - before["prefill_chain_sm90"] == 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), dc.prefill_chain_plain(q, k, v).float(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("t,h,n", [(128, 128, 32), (256, 128, 32), (640, 128, 32),
                                   (200, 128, 4), (331, 64, 8), (640, 64, 32),
                                   (1024, 128, 4), (1100, 64, 8), (2048, 128, 32)])
def test_prefill_chain_sm90(cuda, block_q, t, h, n):
    """bf16 takes the TMA/wgmma kernel: a 128-token chunk against T 128,
    256 and 640 (one key split), T not a multiple of 64, H 64, and T 1024,
    1100 and 2048 (two to four splits and the combine launch; at T 1100 a
    split that holds no visible key of some rows); within 2e-2 of the
    plain version, and against decode_chain.cu's bf16 kernel on the same
    inputs; one launch under both counters."""
    from paddle_tpu_torch.ops import decode_chain as dc

    g = torch.Generator(device=cuda).manual_seed(32)
    q = _randn(g, 1, 128, n, h, device=cuda)
    k, v = (_randn(g, 1, t, n, h, device=cuda) for _ in range(2))
    before = ops.launch_counts()
    got = dc.prefill_chain(q, k, v, block_q=block_q)
    after = ops.launch_counts()
    assert after["prefill_chain"] - before["prefill_chain"] == 1
    assert after["prefill_chain_sm90"] - before["prefill_chain_sm90"] == 1
    general = dc._prefill_general(q, k, v, block_q)
    torch.cuda.synchronize()
    want = dc.prefill_chain_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(got.float(), general.float(), atol=TOL, rtol=TOL)


def test_chains_refuse_what_they_do_not_take(cuda):
    from paddle_tpu_torch.ops import decode_chain as dc

    args = _chain_args(cuda, 2, 4, 4, 128, 16, 2, [3, 5], "bf16", torch.bfloat16)
    with pytest.raises(ValueError, match="int8"):
        dc.decode_chain_rows(*args, splits=2)
    args = _chain_args(cuda, 2, 4, 4, 96, 16, 2, [3, 5], "bf16", torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        dc.decode_chain_batch(*args)
    q = torch.zeros(1, 64, 2, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_q"):
        dc.prefill_chain(q, q, q, block_q=32)


def test_chained_decode_step_matches_unfused(cuda):
    """One step of every layer through the decode chain against the same
    step unfused, on copies of the same int8 pools."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.models.llama import _decode_layers_paged

    g = torch.Generator(device=cuda).manual_seed(7)
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=2, num_key_value_heads=2),
                             device=cuda, generator=g)
    mm = model.model
    b, w, bs = 3, 4, 16
    kc, vc, _, _, _, tables, lens = _chain_args(cuda, b, 4, 2, 64, bs, w, [7, 17, 40], "int8",
                                                torch.bfloat16)
    pools = [(kc.clone(), vc.clone()) for _ in range(2)]
    h = mm.embed_tokens(torch.tensor([[3], [9], [27]], device=cuda))
    outs = []
    with torch.no_grad():
        for cfg in (None, {"layout": "batch"}):
            kp = [p[0].clone() for p in pools]
            vp = [p[1].clone() for p in pools]
            hh, kp, vp = _decode_layers_paged(mm.layers, h, mm.rope_cos, mm.rope_sin, kp, vp,
                                              tables, lens, cfg)
            outs.append((model._logits(mm.norm(hh)).float(), kp, vp))
    (ref, rk, rv), (got, gk, gv) = outs
    assert all(_pools_equal(a, b) == 0 for a, b in zip(rk + rv, gk + gv))
    assert float((got - ref).norm() / ref.norm()) <= TOL


def test_cost_model_times_the_device(cuda):
    """The searcher's measurement on the card: device time of a call,
    positive, and larger for a call that does 8x the work."""
    from paddle_tpu_torch.cost_model import OpCostModel

    cm = OpCostModel(cuda)
    x = torch.ones(1 << 22, device=cuda)
    small = cm.measure("add", lambda a: a + 1, x)
    big = cm.measure("add8", lambda a: [a + 1 for _ in range(8)], x)
    assert 0 < small < big


@pytest.mark.parametrize("rows,hidden,dtype,residual", [
    (4096, 768, torch.bfloat16, True), (4096, 768, torch.bfloat16, False),
    (37, 1000, torch.bfloat16, True), (64, 768, torch.float32, True),
    (5, 1000, torch.float32, False)])
def test_layer_norm_kernel(cuda, rows, hidden, dtype, residual):
    """f32 statistics, one rounding of the output: 2e-2 in bf16; in f32 the
    kernel and the plain version differ only in summation order (2e-5).
    The written sum x + r is rounded once in both, so it is bit-equal."""
    from paddle_tpu_torch.ops.fused_norm import layer_norm_plain

    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(rows, hidden, generator=g, device=cuda).to(dtype)
    r = torch.randn(rows, hidden, generator=g, device=cuda).to(dtype) if residual else None
    w = (1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)).to(dtype)
    b = (0.1 * torch.randn(hidden, generator=g, device=cuda)).to(dtype)
    before = ops.launch_counts()["fused_layer_norm"]
    got = ops.fused_layer_norm(x, w, b, epsilon=1e-12, residual=r)
    assert ops.launch_counts()["fused_layer_norm"] == before + 1
    tol = TOL if dtype == torch.bfloat16 else 2e-5
    if residual:
        got, s = got
        assert torch.equal(s, x + r)
        x = x + r
    torch.testing.assert_close(got.float(), layer_norm_plain(x, w, b, 1e-12).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("m,k,n,dtype", [
    (4096, 768, 3072, torch.bfloat16), (100, 72, 130, torch.bfloat16),
    (33, 77, 40, torch.bfloat16), (100, 72, 130, torch.float32)])
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "gelu_tanh", "silu"])
@pytest.mark.parametrize("bias", [True, False])
def test_matmul_epilogue_kernel(cuda, m, k, n, dtype, act, bias):
    """bf16: one rounding of the output after an f32 sum (2e-2); f32: the
    FMA kernel and the plain product differ in summation order (1e-4 over
    K up to 768).  Odd M, K and N run the kernel too (predicated edges;
    K 77 and N 130 take the element loads)."""
    from paddle_tpu_torch.ops.matmul_epilogue import matmul_bias_act_plain

    g = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(m, k, generator=g, device=cuda) / k ** 0.5).to(dtype)
    w = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    bvec = (0.5 * torch.randn(n, generator=g, device=cuda)).to(dtype) if bias else None
    before = ops.launch_counts()["matmul_epilogue"]
    got = ops.matmul_bias_act(x, w, bvec, act)
    assert ops.launch_counts()["matmul_epilogue"] == before + 1
    tol = TOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), matmul_bias_act_plain(x, w, bvec, act).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("m,k,n", [(4096, 768, 3072), (100, 72, 130), (33, 77, 40)])
@pytest.mark.parametrize("act", ["none", "gelu", "silu"])
def test_matmul_epilogue_kernel_f16(cuda, m, k, n, act):
    """The f16 instantiation (mma.sync .f16, f32 accumulate): one f16
    rounding of the output after an f32 sum, held at 2e-2."""
    from paddle_tpu_torch.ops.matmul_epilogue import matmul_bias_act_plain

    g = torch.Generator(device=cuda).manual_seed(13)
    x = (torch.randn(m, k, generator=g, device=cuda) / k ** 0.5).half()
    w = torch.randn(k, n, generator=g, device=cuda).half()
    bvec = (0.5 * torch.randn(n, generator=g, device=cuda)).half()
    before = ops.launch_counts()["matmul_epilogue"]
    got = ops.matmul_bias_act(x, w, bvec, act)
    assert ops.launch_counts()["matmul_epilogue"] == before + 1 and got.dtype == torch.float16
    torch.testing.assert_close(got.float(), matmul_bias_act_plain(x, w, bvec, act).float(),
                               atol=TOL, rtol=TOL)


def test_matmul_epilogue_sm90_single_tile_witness(cuda):
    """The smallest witness of a layout fault in the TMA/wgmma epilogue: one
    128 x 256 tile, one 64-deep K tile, no activation.  Run it first on a
    card."""
    from paddle_tpu_torch.ops.matmul_epilogue import matmul_bias_act_plain

    g = torch.Generator(device=cuda).manual_seed(33)
    x = (torch.randn(128, 64, generator=g, device=cuda) / 8).to(torch.bfloat16)
    w = torch.randn(64, 256, generator=g, device=cuda).to(torch.bfloat16)
    before = ops.launch_counts()["matmul_epilogue_sm90"]
    got = ops.matmul_bias_act(x, w)
    assert ops.launch_counts()["matmul_epilogue_sm90"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), matmul_bias_act_plain(x, w, None, "none").float(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("m,k,n", [(4096, 768, 3072), (100, 768, 3072), (300, 72, 520)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "gelu_tanh", "silu"])
@pytest.mark.parametrize("bias", [True, False])
def test_matmul_epilogue_sm90(cuda, m, k, n, dtype, act, bias):
    """bf16 and f16 whose rows TMA reads take the TMA/wgmma kernel:
    BERT-base's FFN product, ragged M (100), K not a multiple of 64 (72)
    with N not a multiple of 256 (520); every activation, with and without
    bias; within 2e-2 of the plain version (one 16-bit rounding of the
    output after an f32 sum) and of the general kernel on the same inputs;
    one launch under both counters."""
    me = importlib.import_module("paddle_tpu_torch.ops.matmul_epilogue")
    g = torch.Generator(device=cuda).manual_seed(34)
    x = (torch.randn(m, k, generator=g, device=cuda) / k ** 0.5).to(dtype)
    w = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    bvec = (0.5 * torch.randn(n, generator=g, device=cuda)).to(dtype) if bias else None
    before = ops.launch_counts()
    got = ops.matmul_bias_act(x, w, bvec, act)
    after = ops.launch_counts()
    assert after["matmul_epilogue"] - before["matmul_epilogue"] == 1
    assert after["matmul_epilogue_sm90"] - before["matmul_epilogue_sm90"] == 1
    general = me._launch("general", x, w, bvec, act)
    torch.cuda.synchronize()
    want = me.matmul_bias_act_plain(x, w, bvec, act)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(got.float(), general.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("m,k,n,dtype", [(100, 72, 130, torch.bfloat16),
                                         (100, 72, 130, torch.float32),
                                         (4096, 768, 3072, torch.float32)])
def test_matmul_epilogue_general_route(cuda, m, k, n, dtype):
    """Rows TMA cannot read (N 130 in bf16: 260-byte rows) and f32 take the
    general kernel: the _sm90 counter stays."""
    from paddle_tpu_torch.ops.matmul_epilogue import matmul_bias_act_plain

    g = torch.Generator(device=cuda).manual_seed(35)
    x = (torch.randn(m, k, generator=g, device=cuda) / k ** 0.5).to(dtype)
    w = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    bvec = (0.5 * torch.randn(n, generator=g, device=cuda)).to(dtype)
    before = ops.launch_counts()
    got = ops.matmul_bias_act(x, w, bvec, "gelu")
    after = ops.launch_counts()
    assert after["matmul_epilogue"] - before["matmul_epilogue"] == 1
    assert after["matmul_epilogue_sm90"] == before["matmul_epilogue_sm90"]
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), matmul_bias_act_plain(x, w, bvec, "gelu").float(),
                               atol=tol, rtol=tol)


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    """The matmul epilogue takes bf16, f16 and f32; other dtypes raise."""
    x = torch.zeros(8, 64, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="bf16, f16 or f32"):
        ops.matmul_bias_act(x, x.t().contiguous())
    x = torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="against weight"):
        ops.matmul_bias_act(x, torch.zeros(32, 8, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unit column stride"):
        ops.matmul_bias_act(x, torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16).t())
    w = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="weight/bias"):
        ops.fused_layer_norm(x, w[:32], w[:32], residual=x)


def test_static_bert_runs_the_new_kernels(cuda):
    """bert_tiny in bf16 captured as a Program: the Executor's pass puts 5
    add + LayerNorms and 2 linear + GELUs on the kernels, one launch each a
    run; the logits stay within bf16's tolerance of the eager forward."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import BertForSequenceClassification, bert_tiny

    g = torch.Generator(device=cuda).manual_seed(12)
    model = BertForSequenceClassification(bert_tiny(), device=cuda, generator=g)
    model = model.to(torch.bfloat16).eval()
    ids = torch.randint(1, 1024, (4, 64), generator=g, device=cuda, dtype=torch.int32)
    ids[1, 40:] = 0
    main = static.Program()
    with static.program_guard(main):
        logits = model(static.data("ids", [4, 64], "int32"))
    exe = static.Executor()
    ops.reset_launch_counts()
    (got,) = exe.run(main, feed={"ids": ids}, fetch_list=[logits], return_numpy=False)
    counts = ops.launch_counts()
    assert counts["fused_layer_norm"] == 5 and counts["matmul_epilogue"] == 2, counts
    assert counts["matmul_epilogue_sm90"] == 2, counts  # the linear + GELUs take TMA/wgmma
    with torch.no_grad():
        want = model(ids)
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= TOL


# ------------------------------------------------- the generated kernels

def _capture(build, *feeds):
    """A Program over ``static.data`` feeds [(name, shape, dtype)], its
    output, and the plain replay of the unfused copy."""
    from paddle_tpu_torch import static

    main = static.Program()
    with static.program_guard(main):
        out = build(*[static.data(n, list(s), d) for n, s, d in feeds])
    return main, out


def _codegen_tol(dtype):
    return {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(dtype, 1e-5)


def _mask_chain(ids):
    """BERT's additive mask chain: bool -> int32 -> f32 -> 1 - m -> * -1e4."""
    m = (ids != 0).to(torch.int32)
    return (1 - m.float()) * -1e4


def _jax_test_chain(a, b):
    return torch.sqrt(torch.exp(torch.tanh(a * b + a) * 0.5) + 1.0) * b


@pytest.mark.parametrize("shape,dtype", [((64, 3072), torch.bfloat16), ((37, 129), torch.float32),
                                         ((4096, 3072), torch.bfloat16)])
@pytest.mark.parametrize("launch", [None, (128, 4), (512, 8)])
def test_vpu_chain_kernel(cuda, vpu_built, shape, dtype, launch):
    """#11: the JAX package's test chain, one launch; f32 bit-equal in
    most elements and within 1e-5 relative (the kernel evaluates each op
    as torch's CUDA kernel does; transcendental library calls may differ
    in the last bit), bf16 within one bf16 step."""
    from paddle_tpu_torch.static.passes import apply_pass

    dt = str(dtype).split(".")[-1]
    main, out = _capture(_jax_test_chain, ("a", shape, dt), ("b", shape, dt))
    assert apply_pass(main, "generic_elementwise_fusion", fetch_vids=[out._vid]) == 1
    (op,) = main.global_block().ops
    assert op.type == "vpu_chain_8"
    g = torch.Generator(device=cuda).manual_seed(21)
    a = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    b = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    before = ops.launch_counts()["vpu_chain"]
    got = op.fn(a, b, launch=launch)
    assert ops.launch_counts()["vpu_chain"] == before + 1
    want = op.fn.replay(a, b)
    tol = _codegen_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * 1e-2)


def test_vpu_chain_bert_mask_bool_input(cuda, vpu_built):
    from paddle_tpu_torch.static.passes import apply_pass

    main, out = _capture(_mask_chain, ("ids", (32, 128), "int32"))
    assert apply_pass(main, "generic_elementwise_fusion", fetch_vids=[out._vid]) == 1
    op = main.global_block().ops[-1]
    assert op.type == "vpu_chain_4"
    g = torch.Generator(device=cuda).manual_seed(22)
    ids = torch.randint(0, 3, (32, 128), generator=g, device=cuda, dtype=torch.int32)
    m = ids != 0
    got = op.fn(m)
    assert got.dtype == torch.float32 and torch.equal(got, op.fn.replay(m))


def _mixed_chain(i, h):
    """int64 arithmetic, a cast to f16, f16 math: 2-, 8-byte vectors."""
    return torch.exp((i * 3 + 1).to(torch.float16) * 0.01 + h) - h


@pytest.mark.parametrize("shape", [(8, 1000), (3, 7)])
def test_vpu_chain_kernel_mixed_dtypes(cuda, vpu_built, shape):
    from paddle_tpu_torch.static.passes import apply_pass

    main, out = _capture(_mixed_chain, ("i", shape, "int64"), ("h", shape, "float16"))
    assert apply_pass(main, "generic_elementwise_fusion", fetch_vids=[out._vid]) == 1
    op = main.global_block().ops[-1]
    g = torch.Generator(device=cuda).manual_seed(23)
    i = torch.randint(-50, 50, shape, generator=g, device=cuda)
    h = torch.randn(*shape, generator=g, device=cuda).to(torch.float16)
    got, want = op.fn(i, h), op.fn.replay(i, h)
    assert got.dtype == torch.float16
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -10, atol=1e-3)


# The redesigned #11 (csrc/codegen/vpu_chain.cuh: a persistent grid whose
# threads hold their next run in registers; launch = (threads, elements a
# run)) on every storage dtype, misaligned views, tails, 2 GB inputs, a
# wide constant and every launch config.  Shapes [n, 1] share one source
# for every n.

def _int_chain(x):
    return torch.clip(torch.relu(x * 3 + 1) - 2, -50, 100)


def _f32_chain(x):
    return torch.relu(x * 2.0 + 1.0)


def _wide_chain(bias):
    return lambda a: torch.tanh(a * 2.0 + bias) * 3.0


_VPU_INTS = [torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8]
_VPU_FLOATS = [torch.float16, torch.bfloat16, torch.float32]


def _vpu_op(build, *feeds):
    from paddle_tpu_torch.static.passes import apply_pass

    main, out = _capture(build, *feeds)
    assert apply_pass(main, "generic_elementwise_fusion", fetch_vids=[out._vid]) == 1
    return main.global_block().ops[-1]


def _vpu_ops():
    """Every chain the #11 tests launch, by the shapes that set its source."""
    ops_ = [_vpu_op(_jax_test_chain, ("a", (n, 1), d), ("b", (n, 1), d))
            for d, n in [(torch.bfloat16, 1), (torch.float16, 1), (torch.float32, 1)]]
    ops_ += [_vpu_op(_jax_test_chain, ("a", s, d), ("b", s, d))
             for s, d in [((64, 3072), "bfloat16"), ((37, 129), "float32"),
                          ((4096, 3072), "bfloat16")]]
    ops_ += [_vpu_op(_int_chain, ("x", (1, 1), d)) for d in _VPU_INTS]
    ops_ += [_vpu_op(_mask_chain, ("ids", s, "int32")) for s in [(1, 1), (32, 128)]]
    ops_ += [_vpu_op(_mixed_chain, ("i", s, "int64"), ("h", s, "float16"))
             for s in [(8, 1000), (3, 7)]]
    ops_ += [_vpu_op(_f32_chain, ("x", (1, 1), "float32"))]
    ops_ += [_vpu_op(_wide_chain(torch.zeros(c)), ("a", (2, c), "bfloat16")) for c in (3072, 3)]
    return ops_


@pytest.fixture(scope="module")
def vpu_built():
    """Every #11 source the tests launch, built together (one nvcc each)."""
    from paddle_tpu_torch.ops import _cuda_build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")

    _cuda_build.build_generated([op.fn.source for op in _vpu_ops()])


def _vpu_close(got, want):
    if want.dtype in _VPU_FLOATS:
        tol = _codegen_tol(want.dtype)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * 1e-2)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bool] + _VPU_INTS + _VPU_FLOATS)
@pytest.mark.parametrize("launch", [None, (256, 4), (512, 8)])
def test_vpu_chain_every_storage_dtype(cuda, vpu_built, dtype, launch):
    """#11 on each storage dtype the translator takes, n 2,053 (a tail):
    the integers exact (their wraps are torch's), the mask chain bit-exact,
    floats at the codegen tolerance."""
    n = 2053
    g = torch.Generator(device=cuda).manual_seed(41)
    if dtype == torch.bool:
        op = _vpu_op(_mask_chain, ("ids", (n, 1), "int32"))
        xs = [torch.rand(n, 1, generator=g, device=cuda) > 0.5]
    elif dtype in _VPU_INTS:
        op = _vpu_op(_int_chain, ("x", (n, 1), dtype))
        lo = 0 if dtype == torch.uint8 else -100
        xs = [torch.randint(lo, 100, (n, 1), generator=g, device=cuda).to(dtype)]
    else:
        op = _vpu_op(_jax_test_chain, ("a", (n, 1), dtype), ("b", (n, 1), dtype))
        xs = [torch.randn(n, 1, generator=g, device=cuda).to(dtype) for _ in range(2)]
    before = ops.launch_counts()["vpu_chain"]
    got = op.fn(*xs, launch=launch)
    assert ops.launch_counts()["vpu_chain"] == before + 1
    _vpu_close(got, op.fn.replay(*xs))


@pytest.mark.parametrize("offsets", [(1, 2), (3, 0), (2, 3)])
@pytest.mark.parametrize("launch", [(128, 8), (256, 8), (128, 4)])
def test_vpu_chain_misaligned_views(cuda, vpu_built, offsets, launch):
    """Inputs that are views 1-3 elements into a longer buffer (no pointer
    16-byte aligned: predicated element loads inside the same kernel):
    bit for bit the output on aligned copies, and the replay's values."""
    n = 256 * 8 * 5 + 77
    op = _vpu_op(_jax_test_chain, ("a", (n, 1), "bfloat16"), ("b", (n, 1), "bfloat16"))
    g = torch.Generator(device=cuda).manual_seed(42)
    views = []
    for off in offsets:
        base = torch.randn(n + 3, generator=g, device=cuda).to(torch.bfloat16)
        views.append(base[off:off + n].view(n, 1))
    got = op.fn(*views, launch=launch)
    aligned = op.fn(*[v.clone() for v in views], launch=(128, 8))
    assert torch.equal(got, aligned)
    _vpu_close(got, op.fn.replay(*views))


_BLOCK_RUNS = 128 * 8  # elements a block of the default config covers an iteration


@pytest.mark.parametrize("n", [1, 100, _BLOCK_RUNS * 132 * 16]
                         + [_BLOCK_RUNS * 7 + t for t in range(1, 8)])
@pytest.mark.parametrize("launch", [(128, 8), (256, 8)])
def test_vpu_chain_sizes_and_tails(cuda, vpu_built, n, launch):
    """n 1, n below one block's runs, a whole number of them over every SM,
    and a tail of every length within a 16-byte run: every config bit for
    bit alike, within one bf16 step of the replay."""
    op = _vpu_op(_jax_test_chain, ("a", (n, 1), "bfloat16"), ("b", (n, 1), "bfloat16"))
    g = torch.Generator(device=cuda).manual_seed(43)
    a, b = (torch.randn(n, 1, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    got = op.fn(a, b, launch=launch)
    assert torch.equal(got, op.fn(a, b, launch=(128, 4)))
    _vpu_close(got, op.fn.replay(a, b))


@pytest.mark.parametrize("launch", [None, (512, 8)])
def test_vpu_chain_offsets_past_2gb(cuda, vpu_built, launch):
    """An f32 input of 560,000,000 elements (2.24 GB: byte offsets pass
    2^31), exact against the replay (a product by 2, an add, a relu)."""
    n = 560_000_000
    op = _vpu_op(_f32_chain, ("x", (n, 1), "float32"))
    x = torch.empty(n, 1, device=cuda).uniform_(-4, 4)
    got = op.fn(x, launch=launch)
    want = op.fn.replay(x)
    assert torch.equal(got, want)
    del got, want, x
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", [(37, 3072), (1001, 3)])
@pytest.mark.parametrize("launch", [None, (128, 4), (256, 8), (512, 4)])
def test_vpu_chain_wide_constant(cuda, vpu_built, shape, launch):
    """A captured f32 constant of the last dim's width (one more pointer,
    read by a wrapping column counter): within one bf16 step of the replay."""
    g = torch.Generator(device=cuda).manual_seed(44)
    bias = torch.randn(shape[-1], generator=g, device=cuda)
    op = _vpu_op(_wide_chain(bias), ("a", shape, "bfloat16"))
    a = torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)
    _vpu_close(op.fn(a, launch=launch), op.fn.replay(a))


def _vpu_launches():
    from paddle_tpu_torch.static.rewrite import VPU_LAUNCHES

    return list(VPU_LAUNCHES)


@pytest.mark.parametrize("launch", _vpu_launches())
def test_vpu_chain_every_launch_config(cuda, vpu_built, launch):
    """Every config chip_smoke.py holds and times, at the smoke shape
    [4096, 3072] bf16: bit for bit alike, one launch each."""
    op = _vpu_op(_jax_test_chain, ("a", (4096, 3072), "bfloat16"),
                 ("b", (4096, 3072), "bfloat16"))
    g = torch.Generator(device=cuda).manual_seed(45)
    a, b = (torch.randn(4096, 3072, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    before = ops.launch_counts()["vpu_chain"]
    got = op.fn(a, b, launch=launch)
    assert ops.launch_counts()["vpu_chain"] == before + 1
    assert torch.equal(got, op.fn(a, b))
    _vpu_close(got, op.fn.replay(a, b))


def test_vpu_chain_refuses_other_configs(cuda, vpu_built):
    op = _vpu_op(_jax_test_chain, ("a", (64, 3072), "bfloat16"), ("b", (64, 3072), "bfloat16"))
    a = torch.ones(64, 3072, device=cuda, dtype=torch.bfloat16)
    for launch in [(48, 8), (256, 6), (1056, 8), (256, 8, 0)]:
        with pytest.raises(ValueError):
            op.fn(a, a, launch=launch)


def _sched_spec(build, *feeds, device):
    from paddle_tpu_torch.static import schedule_search as ss
    from paddle_tpu_torch.static.rewrite import ProgramGraph

    main, out = _capture(build, *feeds)
    graph = ProgramGraph(main, (out._vid,))
    (spec,) = [s for s in (ss.match_subgraph(op, graph, device=device)
                           for op in main.global_block().ops) if s]
    return spec


def _softmax_dag(x):
    m = torch.amax(x, dim=-1, keepdim=True)
    t = torch.exp(x - m)
    return t / torch.sum(t, dim=-1, keepdim=True)


def _matmul_mean(x, w, b):
    import torch.nn.functional as F

    return torch.mean(F.relu(torch.matmul(x, w) + b), dim=-1, keepdim=True)


def _linear_tanh(x, w, b):
    from paddle_tpu_torch.nn import functional as F

    return F.tanh(F.linear(x, w, b))


def _relu_linear(x, w, b):
    import torch.nn.functional as F

    return F.relu(torch.matmul(x, w) + b)


def _log_softmax_tail(x):
    import torch.nn.functional as F

    return F.log_softmax(x * 0.5, dim=-1) - torch.logsumexp(x, dim=-1, keepdim=True)


_SCHED_CASES = {
    "softmax_f32": (_softmax_dag, [("x", (8, 128, 512), "float32")]),
    "softmax_bf16": (_softmax_dag, [("x", (4, 12, 128, 128), "bfloat16")]),
    "log_softmax_lse": (_log_softmax_tail, [("x", (33, 300), "float32")]),
    "matmul_mean_f32": (_matmul_mean, [("x", (100, 72), "float32"), ("w", (72, 130), "float32"),
                                       ("b", (130,), "float32")]),
    "matmul_mean_bf16": (_matmul_mean, [("x", (256, 512), "bfloat16"),
                                        ("w", (512, 512), "bfloat16"), ("b", (512,), "bfloat16")]),
    "pooler_bf16": (_linear_tanh, [("x", (32, 768), "bfloat16"), ("w", (768, 768), "bfloat16"),
                                   ("b", (768,), "bfloat16")]),
    "relu_linear_f32": (_relu_linear, [("x", (96, 512), "float32"), ("w", (512, 200), "float32"),
                                       ("b", (200,), "float32")]),
}


# chip_smoke.py's five cases at their shapes (bench_schedule_search.py's
# programs, BERT-base's pooler and attention logits)
_SMOKE_CASES = {
    "smoke_softmax_f32": (_softmax_dag, [("x", (8, 128, 512), "float32")]),
    "smoke_pooler_bf16": (_linear_tanh, [("x", (32, 768), "bfloat16"),
                                         ("w", (768, 768), "bfloat16"), ("b", (768,), "bfloat16")]),
    "smoke_softmax_bf16": (_softmax_dag, [("x", (32, 12, 128, 128), "bfloat16")]),
    "smoke_matmul_mean_f32": (_matmul_mean, [("x", (1024, 512), "float32"),
                                             ("w", (512, 512), "float32"),
                                             ("b", (512,), "float32")]),
    "smoke_ktiled_f32": (_relu_linear, [("x", (1024, 2048), "float32"),
                                        ("w", (2048, 1024), "float32"),
                                        ("b", (1024,), "float32")]),
}
# M, N and K off every tile; K = 600 split 2 to 8 ways in slices that do
# not divide it (f32 N 130 takes the scalar copies, the others 16 bytes)
_RAGGED_CASES = {
    "ragged_relu_linear_f32": (_relu_linear, [("x", (100, 600), "float32"),
                                              ("w", (600, 130), "float32"),
                                              ("b", (130,), "float32")]),
    "ragged_matmul_mean_f32": (_matmul_mean, [("x", (100, 600), "float32"),
                                              ("w", (600, 132), "float32"),
                                              ("b", (132,), "float32")]),
    "ragged_pooler_bf16": (_linear_tanh, [("x", (50, 600), "bfloat16"),
                                          ("w", (600, 200), "bfloat16"),
                                          ("b", (200,), "bfloat16")]),
    "ragged_matmul_mean_bf16": (_matmul_mean, [("x", (70, 600), "bfloat16"),
                                               ("w", (600, 96), "bfloat16"),
                                               ("b", (96,), "bfloat16")]),
}


@pytest.fixture(scope="module")
def sched_specs():
    """Every subgraph spec of this file, its generated source built with
    the others (one nvcc each, all together) before the first test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from paddle_tpu_torch.ops import _cuda_build

    cases = {**_SCHED_CASES, **_SMOKE_CASES, **_RAGGED_CASES}
    specs = {name: _sched_spec(build, *feeds, device=torch.device("cuda"))
             for name, (build, feeds) in cases.items()}
    _cuda_build.build_generated([sp.source() for sp in specs.values()])
    return specs


def _check_config(spec, cfg, args, want, case):
    from paddle_tpu_torch.static import schedule_search as ss

    fn = spec.build(cfg)
    split = bool(cfg.get("block_k")) and cfg["block_k"] < spec.k_dims[0]
    name = "sched_chain_ktiled" if split else "sched_chain"
    before = ops.launch_counts()
    got = fn(*args)
    after = ops.launch_counts()
    assert after[name] == before[name] + 1, (case, cfg)  # one launch: no combine launch
    assert sum(after.values()) == sum(before.values()) + 1, (case, cfg)
    rtol, atol = ss.parity_tolerance(spec.out_dtype, want)
    err = float((got.float() - want.float()).abs().max())
    assert got.shape == want.shape and torch.allclose(
        got.float(), want.float(), rtol=rtol, atol=atol), (case, cfg, err, atol)


@pytest.mark.parametrize("case", sorted(_SCHED_CASES) + sorted(_SMOKE_CASES))
def test_sched_chain_every_config(cuda, sched_specs, case):
    """#12 and #13: every enumerated config of each subgraph (the split-K
    ones, merged inside a cluster, too) against the replay on the same
    inputs, within the parity gate's tolerance; each call one launch,
    counted on its own kernel."""
    spec = sched_specs[case]
    args = spec.synthetic_args()
    want = spec.reference()(*args)
    configs = spec.enumerate_configs()
    assert configs
    for cfg in configs:
        _check_config(spec, cfg, args, want, case)


@pytest.mark.parametrize("case", sorted(_RAGGED_CASES))
def test_sched_chain_ragged_every_split(cuda, sched_specs, case):
    """Every tile of the space at M, N and K off the tile, whole and split
    2 to 8 ways in slices (multiples of 16) that leave a short last one,
    against the replay at the parity gate's tolerance."""
    from paddle_tpu_torch.static import schedule_search as ss

    spec = sched_specs[case]
    args = spec.synthetic_args()
    want = spec.reference()(*args)
    K = spec.k_dims[0]
    tiles = {(c["block_rows"], c["block_cols"]) for c in spec.enumerate_configs()}
    assert tiles
    for br, bc in sorted(tiles):
        base = {"block_rows": br, "block_cols": bc, "grid_order": "rows_first"}
        _check_config(spec, base, args, want, case)
        for gk in range(2, ss._MAX_SPLITS + 1):
            bk = -(-(-(-K // gk)) // 16) * 16
            assert -(-K // bk) == gk and K % bk
            _check_config(spec, dict(base, block_k=bk), args, want, case)


def test_sched_chain_executor_searches_on_the_card(cuda, tmp_path):
    """FLAGS_schedule_search through the Executor with a fresh verdict
    cache: the search measures on the card, a substitution (if the gate
    adopts one) matches the unfused program, and a second capture is
    served from the cache with no fresh search."""
    from paddle_tpu_torch import set_flags, static
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.static import schedule_search as ss

    build, feeds = _SCHED_CASES["softmax_f32"]
    set_flags({"FLAGS_autotune_cache_dir": str(tmp_path), "FLAGS_schedule_search": True})
    at._CACHES.clear()
    ss.reset_schedule_search_stats()
    try:
        x = torch.randn(8, 128, 512, device=cuda)
        main, out = _capture(build, *feeds)
        (got,) = static.Executor().run(main, feed={"x": x}, fetch_list=[out], return_numpy=False)
        stats = ss.schedule_search_stats()
        assert stats["subgraphs_found"] == 1 and stats["measured"] >= 1, stats
        torch.testing.assert_close(got, _softmax_dag(x), rtol=1e-5, atol=1e-7)
        main2, out2 = _capture(build, *feeds)
        static.Executor().run(main2, feed={"x": x}, fetch_list=[out2], return_numpy=False)
        stats2 = ss.schedule_search_stats()
        assert stats2["subgraphs_found"] == 1, stats2
        assert stats2["cache_hits"] + stats2["disabled_hits"] == 1, stats2
    finally:
        set_flags({"FLAGS_autotune_cache_dir": "", "FLAGS_schedule_search": False})
        at._CACHES.clear()


# ------------------------------------------ layouts the reference takes


def _row_case(cuda, case):
    """(x, residual) of a layout the kernels cannot take as they lie."""
    g = torch.Generator(device=cuda).manual_seed(41)
    bf = torch.bfloat16
    if case == "residual_f32":
        return _rand_dtype(g, 37, 512, dtype=bf, device=cuda), torch.randn(
            37, 512, generator=g, device=cuda)
    if case == "residual_broadcast":
        return (_rand_dtype(g, 37, 512, dtype=bf, device=cuda),
                _rand_dtype(g, 512, dtype=bf, device=cuda))
    if case == "strided_rows":
        wide = _rand_dtype(g, 37, 1024, dtype=bf, device=cuda)
        return wide[:, :512], _rand_dtype(g, 512, 37, dtype=bf, device=cuda).t()
    # a row above the Triton kernels' one block: the RMSNorm reads it in passes,
    # the LayerNorm takes its wide kernel
    return (_rand_dtype(g, 3, 70000, dtype=bf, device=cuda),
            _rand_dtype(g, 3, 70000, dtype=bf, device=cuda))


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("case", ["residual_f32", "residual_broadcast", "strided_rows", "wide"])
def test_norm_kernels_take_what_the_reference_takes(cuda, kind, case):
    """A residual of another dtype or shape (added first, promoting and
    broadcasting, then the kernel on the sum), strided rows and residuals
    (made dense), hidden 70,000: the kernel runs (one launch) and matches
    the plain version of the same sum."""
    from paddle_tpu_torch.ops.fused_norm import layer_norm_plain

    x, r = _row_case(cuda, case)
    hidden = x.shape[-1]
    g = torch.Generator(device=cuda).manual_seed(42)
    w = (1 + 0.1 * torch.randn(hidden, generator=g, device=cuda)).to(torch.bfloat16)
    b = (0.1 * torch.randn(hidden, generator=g, device=cuda)).to(torch.bfloat16)
    name = "fused_rms_norm" if kind == "rms" else "fused_layer_norm"
    before = ops.launch_counts()[name]
    if kind == "rms":
        out, s = ops.fused_rms_norm(x, w, residual=r)
        want = rms_norm_plain(x + r, w, 1e-6)
    else:
        out, s = ops.fused_layer_norm(x, w, b, residual=r)
        want = layer_norm_plain(x + r, w, b, 1e-5)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    assert torch.equal(s, x + r) and out.dtype == want.dtype and out.shape == want.shape
    tol = DTYPE_TOL[want.dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["strided_columns", "transposed", "x_bf16_y_f32",
                                  "x_f32_y_bf16"])
def test_swiglu_kernel_takes_what_the_reference_takes(cuda, case):
    """Halves with a column stride (made dense), and operands of two dtypes
    (both promoted for the kernel, the result in x's dtype as the
    reference writes it): one launch, within the plain version's
    tolerance."""
    g = torch.Generator(device=cuda).manual_seed(43)
    bf = torch.bfloat16
    if case == "strided_columns":
        buf = _rand_dtype(g, 37, 4 * 688, dtype=bf, device=cuda)
        x, y = buf[:, 0::4], buf[:, 1::4]
    elif case == "transposed":
        x = _rand_dtype(g, 688, 37, dtype=bf, device=cuda).t()
        y = _rand_dtype(g, 688, 37, dtype=bf, device=cuda).t()
    else:
        xd, yd = (bf, torch.float32) if case == "x_bf16_y_f32" else (torch.float32, bf)
        x = _rand_dtype(g, 37, 688, dtype=xd, device=cuda)
        y = _rand_dtype(g, 37, 688, dtype=yd, device=cuda)
    before = ops.launch_counts()["swiglu"]
    got = ops.swiglu(x, y)
    torch.cuda.synchronize()
    assert ops.launch_counts()["swiglu"] == before + 1 and got.dtype == x.dtype
    torch.testing.assert_close(got.float(), swiglu_plain(x, y).float(), atol=TOL, rtol=TOL)


def test_f16_engine_with_the_search_serves_the_unsearched_stream(cuda, tmp_path):
    """An f16 llama_tiny (head_dim 64) with FLAGS_schedule_search on: no
    chain kernel takes f16, so the search refuses both chains before
    building them and the engine serves the same greedy tokens as with the
    search off."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.ops import autotune as at
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.static import schedule_search as ss

    g = torch.Generator(device=cuda).manual_seed(44)
    model = LlamaForCausalLM(llama_tiny(dtype="float16"), device=cuda, generator=g)
    prompts = {"a": [int(t) for t in torch.randint(1, 1000, (150,), generator=g,
                                                    device=cuda)], "b": [5, 9, 17, 33]}

    def serve():
        eng = GenerationEngine(model, max_batch=2, block_size=16, num_blocks=64, device=cuda,
                               decode_chunk=4, prefill_chunk=64)
        for rid, p in prompts.items():
            eng.add_request(rid, p, max_new_tokens=8)
        while eng.has_work():
            eng.step()
        return eng, {rid: eng.result(rid) for rid in prompts}

    _, want = serve()
    set_flags({"FLAGS_autotune_cache_dir": str(tmp_path), "FLAGS_schedule_search": True})
    at._CACHES.clear()
    ss.reset_schedule_search_stats()
    try:
        eng, got = serve()
        stats = ss.schedule_search_stats()
    finally:
        set_flags({"FLAGS_autotune_cache_dir": "", "FLAGS_schedule_search": False})
        at._CACHES.clear()
    assert got == want
    assert eng.decode_decision.status == eng.prefill_decision.status == "disabled"
    assert stats["refused"] >= 2 and stats["measured"] == 0, stats


# ------------------------------------------------------------- compiled steps
# The captured steps (_core/graphs.py) replay the same kernels on the same
# addresses as the eager body, so tokens, pools and logits are held bit for
# bit.  Every recording runs under torch.cuda.set_sync_debug_mode("error"),
# so a hidden host sync names itself.

# (pools, decode-chain config): the default engine (plain paged attention),
# the bf16 and int8 chains in the batch layout (cluster launches), and the
# int8 split layout, whose combine launch starts by programmatic dependent
# launch
GRAPH_ENGINES = {"default": ("bf16", None), "bf16_batch": ("bf16", {"layout": "batch"}),
                 "int8_batch": ("int8", {"layout": "batch"}),
                 "int8_rows": ("int8", {"layout": "rows", "splits": 2})}


def _graph_engine(model, cuda, kind, chunk):
    from paddle_tpu_torch.serving import GenerationEngine

    kv, chain = GRAPH_ENGINES[kind]
    eng = GenerationEngine(model, max_batch=4, block_size=16, num_blocks=64, device=cuda,
                           decode_chunk=chunk, kv_cache_dtype=kv)
    eng._decode_chain_cfg, eng._prefill_chain_cfg = chain, None  # no search: the config given
    return eng


def _serve_graph_engine(eng, step):
    """Three greedy requests and a sampled one (mixed lanes in one step);
    the streams and the launches of the decode steps."""
    g = torch.Generator().manual_seed(45)
    for i, n in enumerate((5, 17, 40)):
        eng.add_request(f"g{i}", torch.randint(1, 1000, (n,), generator=g).tolist(),
                        max_new_tokens=19)
    eng.add_request("s", [5, 9, 17, 33], max_new_tokens=19, temperature=0.8, seed=7)
    ops.reset_launch_counts()
    while eng.has_work():
        step()
    torch.cuda.synchronize()
    return {rid: eng.result(rid) for rid in ("g0", "g1", "g2", "s")}, ops.launch_counts()


@pytest.fixture(scope="module")
def tiny_bf16_llama():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    g = torch.Generator(device="cuda").manual_seed(46)
    return LlamaForCausalLM(llama_tiny(dtype="bfloat16"), device="cuda", generator=g)


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("kind", list(GRAPH_ENGINES))
def test_graphed_decode_equals_the_eager_body(cuda, tiny_bf16_llama, kind, chunk):
    """warmup() captures the D-token step; served by replays, the streams,
    the shared pool and the launch counts equal the eager body's, and a
    step's launches are its captured step's credit."""
    eager_eng = _graph_engine(tiny_bf16_llama, cuda, kind, chunk)
    want, want_counts = _serve_graph_engine(eager_eng, eager_eng._step_eager)
    eng = _graph_engine(tiny_bf16_llama, cuda, kind, chunk)
    rep = eng.warmup()
    assert rep["chunks"] == [chunk]
    captured = eng._step_fns[chunk]
    assert captured._graph is not None and captured.graph_bytes >= 0
    got, counts = _serve_graph_engine(eng, eng.step)
    assert got == want and counts == want_counts
    assert eng._step_fns[chunk] is captured
    shared = slice(0, eng._num_blocks)
    for a, b in zip(eng._kpools + eng._vpools, eager_eng._kpools + eager_eng._vpools):
        pa_ = (a.data, a.scale) if hasattr(a, "scale") else (a,)
        pb_ = (b.data, b.scale) if hasattr(b, "scale") else (b,)
        for x, y in zip(pa_, pb_):
            assert torch.equal(x[shared], y[shared])
    chain = GRAPH_ENGINES[kind][1]
    if chain:
        name = "decode_chain_batch" if chain["layout"] == "batch" else "decode_chain_rows"
        assert counts[name] == counts[f"{name}_sm90"] > 0
    eng._fill_inputs()  # every request finished: every lane idle, on its scratch page
    ops.reset_launch_counts()
    for _ in range(3):
        captured.replay()
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        k: 3 * v for k, v in captured.launches[0].items()}


def test_sampler_uniforms_bit_for_bit_the_cpus(cuda):
    from paddle_tpu_torch.serving import sampling

    keys = torch.tensor([0, 7, 2 ** 63 - 1, 123456789012345], dtype=torch.int64)
    counters = torch.tensor([0, 1, 2 ** 32 - 1, 77], dtype=torch.int64)
    want = sampling.uniforms(keys, counters, sampling.vocab_hash(32000, "cpu"))
    got = sampling.uniforms(keys.to(cuda), counters.to(cuda), sampling.vocab_hash(32000, cuda))
    assert torch.equal(got.cpu(), want)


def _tiny_bert_program(cuda, codegen):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import BertForSequenceClassification, bert_tiny
    from paddle_tpu_torch.static.passes import apply_pass

    g = torch.Generator(device=cuda).manual_seed(47)
    model = BertForSequenceClassification(bert_tiny(), num_classes=2, device=cuda,
                                          generator=g).to(torch.bfloat16).eval()
    prog = static.Program()
    with static.program_guard(prog):
        logits = model(static.data("ids", [8, 64], "int32"))
    if codegen:
        apply_pass(prog, "generic_elementwise_fusion", fetch_vids=[logits._vid])
    batches = []
    for _ in range(3):
        ids = torch.randint(1, 1000, (8, 64), generator=g, device=cuda, dtype=torch.int32)
        lengths = torch.randint(8, 65, (8,), generator=g, device=cuda)
        pos = torch.arange(64, device=cuda)
        batches.append(torch.where(pos[None] < lengths[:, None], ids, torch.zeros_like(ids)))
    return prog, logits, batches


@pytest.mark.parametrize("codegen", [False, True])
def test_static_replay_equals_the_eager_run(cuda, tmp_path, codegen):
    """A 2-layer bf16 BERT through the Executor: every replay's logits bit
    for bit the eager run's, the fetches of earlier runs untouched by
    later ones, the launches of a replay those of its eager run."""
    from paddle_tpu_torch import set_flags, static
    from paddle_tpu_torch.ops import autotune as at

    prog, logits, batches = _tiny_bert_program(cuda, codegen)
    if codegen:
        set_flags({"FLAGS_autotune_cache_dir": str(tmp_path), "FLAGS_schedule_search": True})
        at._CACHES.clear()
    try:
        exe = static.Executor()
        exe.run(prog, feed={"ids": batches[0]}, fetch_list=[logits], return_numpy=False)
        held = []
        for b in batches + batches:
            ops.reset_launch_counts()
            (want,) = exe._run_eager(prog, feed={"ids": b}, fetch_list=[logits])
            eager_counts = ops.launch_counts()
            ops.reset_launch_counts()
            (got,) = exe.run(prog, feed={"ids": b}, fetch_list=[logits], return_numpy=False)
            torch.cuda.synchronize()
            assert ops.launch_counts() == eager_counts
            assert torch.equal(got, want)
            held.append((got, want))
        for got, want in held:
            assert torch.equal(got, want)
        assert len(exe._cache) == 1
        assert eager_counts["fused_layer_norm"] > 0 and eager_counts["matmul_epilogue"] > 0
        if codegen:
            assert eager_counts["vpu_chain"] == 1
    finally:
        if codegen:
            set_flags({"FLAGS_autotune_cache_dir": "", "FLAGS_schedule_search": False})
            at._CACHES.clear()


# ------------------------------------------------------- serving admission
# The prefix cache, parking and adoption write the pools between replays,
# in place: a captured step reads the bytes they wrote.  Page bytes are
# compared exactly (count of differing elements 0), streams token for
# token.

_SHARED = [int(t) for t in torch.randint(1, 1000, (48,), generator=torch.Generator().manual_seed(48))]


def _prefix_engine(model, cuda, kv, **kw):
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, max_batch=4, block_size=16, num_blocks=64, device=cuda,
                           decode_chunk=8, kv_cache_dtype=kv, prefix_cache=True, **kw)
    eng._decode_chain_cfg, eng._prefill_chain_cfg = GRAPH_ENGINES[
        "int8_batch" if kv == "int8" else "default"][1], None
    return eng


def _page_bytes(eng, blocks):
    from paddle_tpu_torch.ops import paged_attention as pa

    return [t[blocks].clone() for pool in eng._kpools + eng._vpools
            for _, t in pa.pool_parts(pool)]


def _equal_pages(a, b):
    return sum(int((x != y).sum()) for x, y in zip(a, b, strict=True)) == 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefix_engine_replays_equal_the_eager_body(cuda, tiny_bf16_llama, kv):
    """Four requests sharing a 48-token prefix (3 pages): the graphed
    engine's streams and launches equal the eager body's, three admissions
    hit the shared pages, and decoding (lanes finishing mid-chunk at D = 8)
    leaves the shared pages' bytes as they were."""
    from paddle_tpu_torch import serving

    def serve(eng, step):
        eng.add_request("r0", _SHARED + [7, 8, 9], max_new_tokens=11)
        blocks = eng._prefix.match(_SHARED)
        before = _page_bytes(eng, blocks)
        for i, extra in enumerate(([10, 11], [12], [13, 14, 15, 16, 17]), 1):
            eng.add_request(f"r{i}", _SHARED + extra, max_new_tokens=5 + 3 * i)
        ops.reset_launch_counts()
        while eng.has_work():
            step()
        torch.cuda.synchronize()
        assert len(blocks) == 3 and _equal_pages(before, _page_bytes(eng, blocks))
        return {f"r{i}": eng.result(f"r{i}") for i in range(4)}, ops.launch_counts()

    eager = _prefix_engine(tiny_bf16_llama, cuda, kv)
    want, want_counts = serve(eager, eager._step_eager)
    eng = _prefix_engine(tiny_bf16_llama, cuda, kv)
    eng.warmup()
    h0 = serving.decode_stats()["prefix_hits"]
    got, counts = serve(eng, eng.step)
    assert got == want and counts == want_counts
    assert serving.decode_stats()["prefix_hits"] - h0 == 3


def test_park_unpark_round_trip_is_bit_exact(cuda, tiny_bf16_llama):
    """A parked request's pages come back into fresh blocks byte for byte
    (payload and int8 scales), and its graphed stream goes on as if never
    parked; so does a LOW request a HIGH arrival preempts."""
    for kv in ("bf16", "int8"):
        ref = _prefix_engine(tiny_bf16_llama, cuda, kv)
        ref.warmup()
        ref.add_request("lo", _SHARED + [3], max_new_tokens=20)
        while ref.has_work():
            ref.step()

        eng = _prefix_engine(tiny_bf16_llama, cuda, kv)
        eng.warmup()
        eng.add_request("lo", _SHARED + [3], max_new_tokens=20, priority="low")
        eng.step()
        slot = next(s for s in eng._slots if s.rid == "lo")
        pages = _page_bytes(eng, list(slot.blocks))
        eng._park_request(slot)
        eng.add_request("filler", [5, 6, 7], max_new_tokens=2)  # takes blocks first
        assert eng._try_unpark("lo")
        slot = next(s for s in eng._slots if s.rid == "lo")
        assert _equal_pages(pages, _page_bytes(eng, list(slot.blocks)))
        while eng.has_work():
            eng.step()
        assert eng.result("lo") == ref.result("lo")

        eng = _prefix_engine(tiny_bf16_llama, cuda, kv)
        eng.warmup()
        for i in range(4):  # every lane LOW: the HIGH arrival parks lo0 (lane 0)
            eng.add_request(f"lo{i}", _SHARED + [3 + i], max_new_tokens=20, priority="low")
        eng.step()
        eng.add_request("hi", [9, 8, 7, 6], max_new_tokens=4, priority="high")
        eng.step()
        assert eng.parked_requests() == ["lo0"]
        while eng.has_work():
            eng.step()
        assert eng.result("lo0") == ref.result("lo")


def test_adopted_pages_are_read_through_the_captured_step(cuda, tiny_bf16_llama):
    """Pages a donor engine cached, adopted by an engine whose decode step
    was captured before the adoption, are hit by its next admission, and
    the replayed stream equals the donor's own hit stream."""
    from paddle_tpu_torch.ops import paged_attention as pa

    for kv in ("bf16", "int8"):
        donor = _prefix_engine(tiny_bf16_llama, cuda, kv)
        donor.warmup()
        for rid in ("miss", "hit"):
            donor.add_request(rid, _SHARED + [3, 4], max_new_tokens=12)
            while donor.has_work():
                donor.step()
        cached = donor._prefix.match(_SHARED)
        kb = [pa.pool_get_blocks(p, cached) for p in donor._kpools]
        vb = [pa.pool_get_blocks(p, cached) for p in donor._vpools]
        eng = _prefix_engine(tiny_bf16_llama, cuda, kv)
        eng.warmup()
        captured = dict(eng._step_fns)
        assert eng.adopt_pages(_SHARED, kb, vb) == 3
        eng.add_request("hit", _SHARED + [3, 4], max_new_tokens=12)
        while eng.has_work():
            eng.step()
        assert eng._step_fns == captured
        assert eng.result("hit") == donor.result("hit")


def _tiny_trainer(cuda, seed):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr

    model = LlamaForCausalLM(llama_tiny(dtype="bfloat16"), device=cuda,
                             generator=torch.Generator(device=cuda).manual_seed(seed))
    opt = AdamW(lr.LinearWarmup(1e-3, 3, 1e-4, 1e-3), parameters=model.parameters(),
                weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0))
    return TrainStep(model, opt, lambda m, i, l: m(i, labels=l)[0])


def _train_state(step):
    opt = step.optimizer
    out = [p.detach().clone() for p in opt._parameter_list]
    out += [t.clone() for t in opt.opt_state_tensors()]
    return out, [p.grad for p in opt._parameter_list], opt._step_count


def test_graphed_train_step_equals_the_eager_step(cuda):
    """A tiny bf16 LLaMA under AdamW with a warm-up schedule and clipping:
    warmup() leaves every state tensor, the grads and the step count bit
    for bit; then five graphed steps (replays from the first) equal five
    eager steps from the same weights, losses and every state tensor bit
    for bit, and each replay credits the eager step's launches."""
    g = torch.Generator(device=cuda).manual_seed(3)
    ids = torch.randint(0, 1024, (2, 128), generator=g, device=cuda)
    graphed, eager = _tiny_trainer(cuda, 7), _tiny_trainer(cuda, 7)
    # the accumulators created first, so the state lists line up
    graphed.optimizer._journaled_step(list(graphed.model.parameters()))
    before = _train_state(graphed)
    assert graphed.warmup(ids, ids) is graphed
    after = _train_state(graphed)
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert before[1:] == after[1:]
    captured = next(iter(graphed._steps.values())).step
    assert captured._graph is not None and captured.graph_bytes > 0
    losses = {"graphed": [], "eager": []}
    for i in range(5):
        for mode, step in (("graphed", graphed), ("eager", eager)):
            ops.reset_launch_counts()
            run = step if mode == "graphed" else step._eager_step
            losses[mode].append(run(ids, ids))
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            if mode == "graphed":
                assert counts == captured.launches[0]
            else:
                eager_counts = counts
            step.optimizer._lr_scheduler.step()
        assert eager_counts == captured.launches[0]
    assert graphed.captures == 1 and graphed.optimizer._step_count == 5
    assert all(p.grad is None for p in graphed.model.parameters())
    assert [float(x) for x in losses["graphed"]] == [float(x) for x in losses["eager"]]
    got, want = _train_state(graphed)[0], _train_state(eager)[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    p = next(graphed.model.parameters())
    p.grad = torch.zeros_like(p)
    with pytest.raises(RuntimeError, match="clear_grad"):
        graphed(ids, ids)


def _early_exit(model, layers):
    """A draft of ``model``'s width whose embedding, first ``layers`` layers,
    final norm and head are the model's own."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = dataclasses.replace(model.config, num_hidden_layers=layers)
    draft = LlamaForCausalLM(cfg, device="meta")
    draft.model.embed_tokens = model.model.embed_tokens
    draft.model.layers = torch.nn.ModuleList(list(model.model.layers[:layers]))
    draft.model.norm = model.model.norm
    draft.model.rope_cos, draft.model.rope_sin = model.model.rope_cos, model.model.rope_sin
    draft.lm_head = model.lm_head
    return draft


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("draft", ["self", "early_exit"])
def test_spec_tick_replays_equal_the_eager_body(cuda, tiny_bf16_llama, kv, draft):
    """A speculative engine (K = 4) serving three greedy requests: through
    the captured tick (``step()``) the streams, spec_stats and both pool
    sets equal the eager body's (``_step_eager``), the launch counts too
    but for the capture's warm-up tick, and each replay credits its tick's
    launches."""
    from paddle_tpu_torch.serving import GenerationEngine

    d = tiny_bf16_llama if draft == "self" else _early_exit(tiny_bf16_llama, 1)

    def serve(step_name):
        eng = GenerationEngine(tiny_bf16_llama, draft_model=d, num_speculative_tokens=4,
                               max_batch=4, block_size=16, num_blocks=64, device=cuda,
                               kv_cache_dtype=kv)
        g = torch.Generator().manual_seed(49)
        for i, n in enumerate((5, 17, 40)):
            eng.add_request(f"s{i}", torch.randint(1, 1000, (n,), generator=g).tolist(),
                            max_new_tokens=21)
        ops.reset_launch_counts()
        while eng.has_work():
            getattr(eng, step_name)()
        torch.cuda.synchronize()
        return eng, ops.launch_counts()

    eager, want_counts = serve("_step_eager")
    eng, counts = serve("step")
    assert eng._spec_fn is not None and eng._spec_fn._graph is not None
    assert {f"s{i}": eng.result(f"s{i}") for i in range(3)} == {
        f"s{i}": eager.result(f"s{i}") for i in range(3)}
    assert eng.spec_stats() == eager.spec_stats()
    if draft == "self":
        assert eng.spec_stats()["accepted"] == eng.spec_stats()["proposed"]
    # the graphed pass also ran the capture's warm-up tick (idle lanes)
    assert counts == {k: v + eng._spec_fn.launches[0].get(k, 0) for k, v in want_counts.items()}
    shared = slice(0, eng._num_blocks)
    for a, b in zip(eng._all_pools(), eager._all_pools()):
        pa_ = (a.data, a.scale) if hasattr(a, "scale") else (a,)
        pb_ = (b.data, b.scale) if hasattr(b, "scale") else (b,)
        for x, y in zip(pa_, pb_):
            assert torch.equal(x[shared], y[shared])
    eng._fill_spec_inputs(idle=True)
    ops.reset_launch_counts()
    for _ in range(2):
        eng._spec_fn.replay()
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        k: 2 * v for k, v in eng._spec_fn.launches[0].items()}


def _adapter(model, seed, rank=4, b_scale=0.5):
    """A seeded adapter state dict of ``model``'s widths (host tensors; A
    std 0.05, B std ``b_scale``)."""
    from paddle_tpu_torch.nn.lora import LLAMA_TARGETS, _resolve_sublayer

    g = torch.Generator().manual_seed(seed)
    out = {}
    for li, layer in enumerate(model.model.layers):
        for t in LLAMA_TARGETS:
            lin = _resolve_sublayer(layer, t)
            out[f"model.layers.{li}.{t}.lora_A"] = 0.05 * torch.randn(lin.in_features, rank,
                                                                      generator=g)
            out[f"model.layers.{li}.{t}.lora_B"] = b_scale * torch.randn(rank, lin.out_features,
                                                                         generator=g)
    return out


def _adapter_engine(model, cuda, **kw):
    from paddle_tpu_torch.serving import GenerationEngine

    return GenerationEngine(model, max_batch=4, block_size=16, num_blocks=64, device=cuda,
                            decode_chunk=8, adapters={"rank": 4, "max_adapters": 2}, **kw)


def _serve_tenant(eng, step, name, prompt):
    eng.add_request(name, prompt, max_new_tokens=17, adapter=name)
    while eng.has_work():
        step()
    torch.cuda.synchronize()
    return eng.result(name)


def test_pack_swap_under_a_captured_step(cuda, tiny_bf16_llama):
    """A hot swap between replays writes the pack in place: the captured
    step is the same object, it is not recorded again, and the swapped
    tenant's stream equals a fresh engine's eager body."""
    eng = _adapter_engine(tiny_bf16_llama, cuda)
    eng.warmup()
    captured = eng._step_fns[8]
    addrs = [t.data_ptr() for _, t in eng._pack.parts()]
    eng.register_adapter("t0", _adapter(tiny_bf16_llama, 1), alpha=8)
    first = _serve_tenant(eng, eng.step, "t0", [5, 9, 17, 33, 2])
    eng.evict_adapter("t0")
    eng.register_adapter("t1", _adapter(tiny_bf16_llama, 2), alpha=8)
    got = _serve_tenant(eng, eng.step, "t1", [5, 9, 17, 33, 2])
    assert eng._step_fns[8] is captured and list(eng._step_fns) == [8]
    assert [t.data_ptr() for _, t in eng._pack.parts()] == addrs
    fresh = _adapter_engine(tiny_bf16_llama, cuda)
    fresh.register_adapter("t1", _adapter(tiny_bf16_llama, 2), alpha=8)
    assert got == _serve_tenant(fresh, fresh._step_eager, "t1", [5, 9, 17, 33, 2])
    assert got != first


def test_restore_into_an_engine_that_captured_first(cuda, tiny_bf16_llama, tmp_path):
    """An int8 adapter engine snapshotted mid-flight; the bytes are loaded
    into an engine that recorded its step before: its replays finish every
    stream as the uninterrupted engine does, and no pool or pack tensor
    was rebound."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import EngineSnapshot
    from paddle_tpu_torch.serving import snapshot as snap

    def start():
        eng = _adapter_engine(tiny_bf16_llama, cuda, kv_cache_dtype="int8", prefix_cache=True)
        eng.register_adapter("t0", _adapter(tiny_bf16_llama, 3), alpha=8)
        g = torch.Generator().manual_seed(50)
        for i, (n, ad) in enumerate(((5, "t0"), (17, None), (40, "t0"))):
            eng.add_request(f"r{i}", torch.randint(1, 1000, (n,), generator=g).tolist(),
                            max_new_tokens=25, adapter=ad)
        return eng

    ref = start()
    while ref.has_work():
        ref.step()
    src = start()
    src.step()
    src.snapshot(str(tmp_path))
    target = _adapter_engine(tiny_bf16_llama, cuda, kv_cache_dtype="int8", prefix_cache=True)
    target.warmup()
    captured = target._step_fns[8]
    leaves = [t for p in target._kpools + target._vpools for _, t in pa.pool_parts(p)]
    addrs = [t.data_ptr() for t in leaves] + [t.data_ptr() for _, t in target._pack.parts()]
    snap._load_state(target, *EngineSnapshot(str(tmp_path))._resolve(None))
    while target.has_work():
        target.step()
    torch.cuda.synchronize()
    assert target._step_fns[8] is captured
    assert [t.data_ptr() for t in leaves] + [t.data_ptr() for _, t in target._pack.parts()] \
        == addrs
    assert {f"r{i}": target.result(f"r{i}") for i in range(3)} == {
        f"r{i}": ref.result(f"r{i}") for i in range(3)}


def test_graphed_lora_train_step_leaves_the_base_unchanged(cuda):
    """apply_lora on a tiny bf16 LLaMA, TrainStep with AdamW over every
    parameter: two calls (the first records the step), warmup(), three
    replays; the loss falls,
    the frozen base holds no grad and stays bit for bit, the optimizer
    holds only the adapters' state, and the replays equal an eager twin's
    steps."""
    from paddle_tpu_torch.nn.lora import apply_lora

    g = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.randint(0, 1024, (2, 128), generator=g, device=cuda)

    def trainer():
        step = _tiny_trainer(cuda, 9)
        apply_lora(step.model, rank=8, generator=torch.Generator(device=cuda).manual_seed(5))
        step.optimizer = type(step.optimizer)(1e-3, parameters=step.model.parameters())
        return step

    graphed, eager = trainer(), trainer()
    base = {n: p.detach().clone() for n, p in graphed.model.named_parameters()
            if not p.requires_grad}
    losses = [float(graphed(ids, ids)) for _ in range(2)]
    losses_eager = [float(eager._eager_step(ids, ids)) for _ in range(2)]
    graphed.warmup(ids, ids)
    losses += [float(graphed(ids, ids)) for _ in range(3)]
    losses_eager += [float(eager._eager_step(ids, ids)) for _ in range(3)]
    torch.cuda.synchronize()
    assert losses == losses_eager and losses[-1] < losses[0]
    assert graphed.captures == 2  # the first call's recording, then warmup()'s
    for n, p in graphed.model.named_parameters():
        if n in base:
            assert p.grad is None and torch.equal(p, base[n]), n
    adapters = {id(p) for p in graphed.model.parameters() if p.requires_grad}
    assert {pid for _, pid in graphed.optimizer._accumulators} == adapters


# ---------------------------------------------------- generate() and AMP (A.2.3, A.3.1)

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,nkv", [(128, 8), (64, 2)])
@pytest.mark.parametrize("sk", [17, 64, 129, 700])
@pytest.mark.parametrize("sq,causal", [(1, False), (5, True)])
def test_flash_fwd_sm90_decode_shapes(cuda, sq, causal, sk, h, nkv, dtype):
    """The forward at the shapes generate() gives it: one query row
    against a naive cache (non-causal), and a speculative verify's K + 1
    = 5 rows, bottom-right causal; most of a 64-row tile is padding.  Both
    on the TMA/wgmma route, against the plain version within 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(60)
    q = torch.randn(4, sq, 8, h, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(4, sk, nkv, h, generator=g, device=cuda).to(dtype) for _ in range(2))
    added = _flash_against_plain(q, k, v, causal, TOL)
    assert added["flash_attention_fwd_sm90"] == 1 and added["flash_attention_fwd"] == 1


def _amp_trainer(cuda, seed, scaler):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(llama_tiny(dtype="float32"), device=cuda,
                             generator=torch.Generator(device=cuda).manual_seed(seed))
    dtype = "float16" if scaler else "bfloat16"

    def loss_fn(m, ids, labels):
        with amp.auto_cast(dtype=dtype):
            return m(ids, labels=labels)[0]

    opt = AdamW(1e-3, parameters=model.parameters())
    return TrainStep(model, opt, loss_fn,
                     scaler=amp.GradScaler(init_loss_scaling=2.0 ** 16, incr_every_n_steps=2)
                     if scaler else None)


@pytest.mark.parametrize("scaler", [False, True], ids=["bf16", "f16_scaler"])
def test_amp_train_step_graphed_equals_eager(cuda, scaler):
    """An f32 llama_tiny under auto_cast O1 (bf16; f16 with a GradScaler):
    every flash forward and backward launch on the sm90 route in the AMP
    dtype; three graphed steps (the first records) equal three eager
    steps from the same weights, losses, every state tensor and the
    scaler's scale and counts bit for bit; then a forced overflow
    (set_init_loss_scaling(2**40)) replays a skipped step: the state
    unchanged, the scale halved."""
    g = torch.Generator(device=cuda).manual_seed(61)
    ids = torch.randint(0, 1024, (2, 128), generator=g, device=cuda)
    graphed, eager = _amp_trainer(cuda, 8, scaler), _amp_trainer(cuda, 8, scaler)
    losses = {"graphed": [], "eager": []}
    for _ in range(3):
        for mode, step in (("graphed", graphed), ("eager", eager)):
            ops.reset_launch_counts()
            run = step if mode == "graphed" else step._eager_step
            losses[mode].append(float(run(ids, ids)))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"):
                assert counts[name] == counts[f"{name}_sm90"] == 2, (mode, counts)
    assert losses["graphed"] == losses["eager"] and graphed.captures == 1
    got, want = _train_state(graphed)[0], _train_state(eager)[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if not scaler:
        return
    assert [float(t) for t in graphed.scaler.state_tensors()] == [
        float(t) for t in eager.scaler.state_tensors()]
    graphed.scaler.set_init_loss_scaling(2.0 ** 40)
    before = _train_state(graphed)[0]
    graphed(ids, ids)
    torch.cuda.synchronize()
    assert bool(graphed.scaler._found_t) and graphed.scaler.get_loss_scaling() == 2.0 ** 39
    assert all(torch.equal(a, b) for a, b in zip(before, _train_state(graphed)[0]))


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_recorded_chunks_equal_the_eager_body(cuda, tiny_bf16_llama, sampled):
    """generate(cache="paged") at D 4 over 10 new tokens: the recorded
    4-token chunk (recorded at the first, replayed at the second; the
    1-token tail runs once, unrecorded) gives the eager body's stream; sampled streams are bit-identical across D 1 and 4.  (The
    naive cache attends through the flash kernel, the paged one through
    the plain gather, so on the card their streams may part where bf16
    logits tie: chip_smoke.py phase 3f holds them by its tie rules.)"""
    m = tiny_bf16_llama
    g = torch.Generator(device=cuda).manual_seed(62)
    ids = torch.randint(0, 1024, (3, 40), generator=g, device=cuda)
    kw = dict(do_sample=True, temperature=1.5, top_k=50, top_p=0.9, seed=3) if sampled else {}
    got = m.generate(ids, max_new_tokens=10, decode_chunk=4, **kw)
    rec = m._decode_recordings
    assert set(rec) == {4} and rec[4]["replays"] == 1
    assert rec[4]["capture_s"] > 0
    eager = m._generate_eager(ids, max_new_tokens=10, decode_chunk=4, **kw)
    assert torch.equal(got, eager)
    if sampled:
        assert torch.equal(m.generate(ids, max_new_tokens=10, decode_chunk=1, **kw), got)


# ------------------------------------------------ GPT with dropout, the optimizer tier

def _gpt_trainer(cuda, make_opt, amp_dtype=None):
    """GPT-2 width (hidden 768, 12 heads, head_dim 64), 2 layers, dropout
    0.1, built in f32; ``amp_dtype`` runs the loss under auto_cast O1."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=4096, num_hidden_layers=2, max_position_embeddings=256)
    model = GPTForCausalLM(cfg, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(71))

    def loss_fn(m, ids, labels):
        if amp_dtype is None:
            return m(ids, labels=labels)[0]
        with amp.auto_cast(dtype=amp_dtype):
            return m(ids, labels=labels)[0]

    return TrainStep(model, make_opt(list(model.named_parameters())), loss_fn)


def _recorded_against_eager(step, ids, n):
    """``n`` graphed steps after ``warmup()``, then ``n`` eager steps from a
    copy of the state (RNG state included): (losses, losses, states)."""
    step.warmup(ids, ids)
    saved = [t.detach().clone() for t in step._state()]
    count = step.optimizer._step_count
    graphed = [float(step(ids, ids)) for _ in range(n)]
    after = [t.detach().clone() for t in step._state()]
    with torch.no_grad():
        for t, v in zip(step._state(), saved):
            t.copy_(v)
    step.optimizer._step_count = count
    eager = [float(step._eager_step(ids, ids)) for _ in range(n)]
    return graphed, eager, after, [t.detach().clone() for t in step._state()]


@pytest.mark.parametrize("amp_dtype", [None, "bfloat16"])
def test_gpt_dropout_train_step_graphed_equals_eager(cuda, amp_dtype):
    """GPT at GPT-2 width with dropout 0.1: three graphed steps equal three
    eager steps from the same state bit for bit (the RNG counter among
    the state: 5 dropouts a step), the losses differ step to step, and
    every flash launch takes the route of its dtype (f32 general, O1 bf16
    sm90 at head_dim 64)."""
    from paddle_tpu_torch._core import random as trandom
    from paddle_tpu_torch.optimizer import AdamW

    step = _gpt_trainer(cuda, lambda ps: AdamW(1e-3, parameters=ps), amp_dtype)
    ids = torch.randint(0, 4096, (2, 256), generator=torch.Generator(device=cuda).manual_seed(72),
                        device=cuda)
    ops.reset_launch_counts()
    step._eager_step(ids, ids)
    counts = ops.launch_counts()
    sm90 = 2 if amp_dtype else 0
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert counts[name] == 2 and counts[f"{name}_sm90"] == sm90, counts
    before = int(trandom.state_tensor(cuda)[1])
    graphed, eager, a, b = _recorded_against_eager(step, ids, 3)
    assert graphed == eager and len(set(graphed)) == 3
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(trandom.state_tensor(cuda)[1]) - before == 3 * 5


def test_dropout_masks_on_the_card_equal_the_cpu(cuda):
    """The counter hash gives the CPU's bits on the card: dropout, alpha
    dropout and the sampler's uniforms from one state."""
    from paddle_tpu_torch._core import random as trandom
    from paddle_tpu_torch.nn import functional as tF

    x = torch.randn(8, 1024, 768, generator=torch.Generator().manual_seed(73))
    out = {}
    for dev in ("cpu", cuda):
        trandom.state_tensor(dev).copy_(torch.tensor([99, 7]))
        out[str(dev)] = [tF.dropout(x.to(dev), 0.1).cpu(), tF.alpha_dropout(x.to(dev), 0.3).cpu(),
                         tF.dropout(x.to(dev).bfloat16(), 0.5).cpu()]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a.eq(0), b.eq(0)) and torch.equal(a, b)


def _tier(name):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import ClipGradByNorm, ClipGradByValue
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay

    sched = O.lr.OneCycleLR(1e-3, total_steps=8, end_learning_rate=1e-5)
    return {
        "Momentum": lambda ps: O.Momentum(sched, 0.9, ps, weight_decay=L2Decay(1e-4)),
        "Adagrad": lambda ps: O.Adagrad(sched, parameters=ps, weight_decay=L1Decay(1e-6)),
        "Adadelta": lambda ps: O.Adadelta(sched, parameters=ps, grad_clip=ClipGradByValue(0.1)),
        "RMSProp": lambda ps: O.RMSProp(sched, parameters=ps, centered=True, momentum=0.9,
                                        grad_clip=ClipGradByNorm(1.0)),
        "Lamb": lambda ps: O.Lamb(sched, parameters=ps,
                                  exclude_from_weight_decay_fn=lambda n: n.endswith("bias")),
        "Adamax": lambda ps: O.Adamax(sched, parameters=ps),
        "NAdam": lambda ps: O.NAdam(sched, parameters=ps),
        "RAdam": lambda ps: O.RAdam(sched, parameters=ps),
        "ASGD": lambda ps: O.ASGD(sched, parameters=ps),
        "Rprop": lambda ps: O.Rprop(sched, parameters=ps),
    }[name]


@pytest.mark.parametrize("name", ["Momentum", "Adagrad", "Adadelta", "RMSProp", "Lamb",
                                  "Adamax", "NAdam", "RAdam", "ASGD", "Rprop"])
def test_gpt_optimizer_tier_recorded_equals_eager(cuda, name):
    """Each of the ten optimizers on the GPT-2-width model under O1 bf16,
    its rate from OneCycleLR stepped between steps: two eager steps, then
    three graphed steps equal three eager steps from the same state bit
    for bit, each reading its step's rate (RAdam past its rho_t > 4
    boundary at t = 5), every loss finite."""
    step = _gpt_trainer(cuda, _tier(name), "bfloat16")
    sched = step.optimizer._lr_scheduler
    ids = torch.randint(0, 4096, (2, 256), generator=torch.Generator(device=cuda).manual_seed(74),
                        device=cuda)
    for _ in range(2):
        step._eager_step(ids, ids)
        sched.step()
    step.warmup(ids, ids)
    saved = [t.detach().clone() for t in step._state()]
    count, sched_state = step.optimizer._step_count, sched.state_dict()
    graphed = []
    for _ in range(3):
        graphed.append(float(step(ids, ids)))
        sched.step()
    after = [t.detach().clone() for t in step._state()]
    with torch.no_grad():
        for t, v in zip(step._state(), saved):
            t.copy_(v)
    step.optimizer._step_count = count
    sched.set_state_dict(sched_state)
    eager = []
    for _ in range(3):
        eager.append(float(step._eager_step(ids, ids)))
        sched.step()
    assert graphed == eager and all(torch.isfinite(torch.tensor(graphed)))
    assert all(torch.equal(x, y) for x, y in zip(after, step._state()))


def _resnet_trainer(cuda, o1):
    """resnet18(num_classes=10) on the card with Momentum(0.1) and
    CrossEntropyLoss, f32 or under auto_cast O1 bf16."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    model = resnet18(num_classes=10, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(80))
    ce = CrossEntropyLoss()

    def loss_fn(m, x, y):
        with amp.auto_cast(enable=o1, dtype="bfloat16"):
            return ce(m(x), y)

    g = torch.Generator(device=cuda).manual_seed(81)
    x = torch.randn(16, 3, 64, 64, generator=g, device=cuda)
    y = torch.randint(0, 10, (16,), generator=g, device=cuda, dtype=torch.int32)
    return TrainStep(model, Momentum(0.1, parameters=model.parameters()), loss_fn), x, y


@pytest.mark.parametrize("o1", [False, True], ids=["f32", "o1_bf16"])
def test_resnet_train_step_graphed_equals_eager_with_running_statistics(cuda, o1):
    """resnet18 with cudnn.deterministic: one eager step, ``warmup()``
    (every state tensor, the running statistics among them, bit for bit
    as it was), then three graphed steps equal three eager steps from the
    same state bit for bit, running statistics included, which the
    replays write in place at their fixed addresses."""
    step, x, y = _resnet_trainer(cuda, o1)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        step._eager_step(x, y)
        bn = step.model.bn1
        ptrs = (bn._mean.data_ptr(), bn._variance.data_ptr())
        assert any(t is bn._mean for t in step._state())
        saved = [t.detach().clone() for t in step._state()]
        count = step.optimizer._step_count
        step.warmup(x, y)
        assert all(torch.equal(a, b) for a, b in zip(saved, step._state()))
        graphed = [float(step(x, y)) for _ in range(3)]
        after = [t.detach().clone() for t in step._state()]
        assert (bn._mean.data_ptr(), bn._variance.data_ptr()) == ptrs
        first = len(step._params())  # the buffers follow the parameters in the state
        stats = range(first, first + len(step._buffers()))
        assert len(stats) == 2 * 20  # a mean and a variance for each of the 20 BatchNorms
        assert all(not torch.equal(after[i], saved[i]) for i in stats)
        with torch.no_grad():
            for t, v in zip(step._state(), saved):
                t.copy_(v)
        step.optimizer._step_count = count
        eager = [float(step._eager_step(x, y)) for _ in range(3)]
    finally:
        torch.backends.cudnn.deterministic = was
    assert graphed == eager and all(torch.isfinite(torch.tensor(graphed)))
    assert all(torch.equal(a, b) for a, b in zip(after, step._state()))


def test_resnet_rebound_buffer_records_again(cuda):
    """A running statistic rebound between calls (a new tensor, a new
    address) makes the step record again rather than replay stale
    addresses, and the new buffer is the one the replays write."""
    step, x, y = _resnet_trainer(cuda, True)
    step(x, y)
    step(x, y)
    captures = step.captures
    bn = step.model.layer1[0].bn1
    bn._mean = bn._mean.clone()
    before = bn._mean.clone()
    step(x, y)
    assert step.captures == captures + 1
    step(x, y)  # a replay of the new recording
    assert step.captures == captures + 1 and not torch.equal(bn._mean, before)
