"""The port's hand-written kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need an NVIDIA card
and skip without one.  They import no JAX, so they also run where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are bf16's: 2e-2 (one bf16 rounding of the output; the flash
kernel also rounds P to bf16 before the P V product).  The backward
kernels round P and dS to bf16 before their products and each gradient
once at the end; they are held at 2e-2 absolute and relative too.
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
                      "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2}
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.float().abs().sum() > 0, name


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="bf16"):
        ops.flash_attention(q.float(), q.float(), q.float())
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        ops.flash_attention_bwd(q, q, q, q, lse, q.float())


def test_time_step_ms_on_the_card(cuda):
    from paddle_tpu_torch.device import synchronize, time_step_ms

    x = torch.ones(1 << 20, device=cuda)
    calls = []
    ms = time_step_ms(lambda: calls.append(x.mul_(1.0)), inner=3, samples=2)
    synchronize()
    assert ms > 0 and len(calls) == 6
