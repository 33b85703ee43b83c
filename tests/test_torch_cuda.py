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
another order.  On a card, run the TMA kernels' single-tile witnesses
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
    with pytest.raises(ValueError, match="residual"):
        ops.fused_layer_norm(x, w, w, residual=x.float())


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
def test_vpu_chain_kernel(cuda, shape, dtype, launch):
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


def test_vpu_chain_bert_mask_bool_input(cuda):
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
def test_vpu_chain_kernel_mixed_dtypes(cuda, shape):
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


@pytest.mark.parametrize("case", sorted(_SCHED_CASES))
def test_sched_chain_every_config(cuda, case):
    """#12 and #13: every enumerated config of each subgraph (the split-K
    ones too) against the replay on the same inputs, within the parity
    gate's tolerance; each launch counted on its own kernel."""
    from paddle_tpu_torch.static import schedule_search as ss

    build, feeds = _SCHED_CASES[case]
    spec = _sched_spec(build, *feeds, device=cuda)
    args = spec.synthetic_args()
    want = spec.reference()(*args)
    configs = spec.enumerate_configs()
    assert configs
    rtol, atol = ss.parity_tolerance(spec.out_dtype, want)
    for cfg in configs:
        fn = spec.build(cfg)
        split = bool(cfg.get("block_k")) and cfg["block_k"] < spec.k_dims[0]
        name = "sched_chain_ktiled" if split else "sched_chain"
        before = ops.launch_counts()[name]
        got = fn(*args)
        assert ops.launch_counts()[name] == before + 1, (case, cfg)
        err = float((got.float() - want.float()).abs().max())
        assert got.shape == want.shape and torch.allclose(
            got.float(), want.float(), rtol=rtol, atol=atol), (case, cfg, err, atol)


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
