"""The port's hand-written kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA card
and skip without one.  They import no JAX, so they also run where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are bf16's: 2e-2 (one bf16 rounding of the output; the flash
kernel also rounds P to bf16 before the P V product).
"""

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


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="bf16"):
        ops.flash_attention(q.float(), q.float(), q.float())
