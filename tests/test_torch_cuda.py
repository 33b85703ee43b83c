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
output at 2e-2 for bf16 outputs and int8 pools, 2e-5 for f32.
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
                      "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2,
                      "decode_chain_batch": 0, "decode_chain_rows": 0, "prefill_chain": 0,
                      "fused_layer_norm": 0, "matmul_epilogue": 0}
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
@pytest.mark.parametrize("layout", ["batch", "rows2", "rows4"])
@pytest.mark.parametrize("n,nkv,h,bs,lens", [
    (4, 4, 128, 16, [18, 160, 290, 680]),
    (8, 2, 64, 8, [1, 9, 16, 33]),     # fresh block (bs*k + 1) and a block's last slot
    (32, 8, 128, 16, [17, 32, 49, 64])])
def test_decode_chain_kernels(cuda, kv, dtype, layout, n, nkv, h, bs, lens):
    from paddle_tpu_torch.ops import decode_chain as dc

    if layout != "batch" and kv != "int8":
        pytest.skip("the rows layout is for int8 pools only")
    w = max(-(-x // bs) for x in lens) + 1
    args = _chain_args(cuda, len(lens), n, nkv, h, bs, w, lens, kv, dtype)
    ref_args = (args[0].clone(), args[1].clone()) + args[2:]
    fn = dc.DecodeChainSpec(len(lens), n, nkv, h, bs, w, len(lens) * (w + 1), kv=kv,
                            dtype=dtype, device=cuda).build(
        {"layout": "batch"} if layout == "batch" else {"layout": "rows",
                                                       "splits": int(layout[4:])})
    name = "decode_chain_batch" if layout == "batch" else "decode_chain_rows"
    before = ops.launch_counts()[name]
    o, kc, vc = fn(*args)
    assert ops.launch_counts()[name] == before + 1
    r_o, r_kc, r_vc = dc.decode_chain_plain(*ref_args)
    torch.cuda.synchronize()
    assert _pools_equal(kc, r_kc) == 0 and _pools_equal(vc, r_vc) == 0
    tol = dc._tolerance(dtype, kv)
    assert o.dtype == dtype
    torch.testing.assert_close(o.float(), r_o.float(), atol=tol, rtol=tol)


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


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
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
    with torch.no_grad():
        want = model(ids)
    assert float((got.float() - want.float()).norm() / want.float().norm()) <= TOL
