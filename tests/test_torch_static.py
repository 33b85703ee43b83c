"""The port's static Program tier and its two new kernel modules against
the JAX package, on the CPU.

- ``ops.fused_layer_norm`` / ``ops.fused_rms_norm`` (with and without
  ``residual=``) and ``ops.matmul_bias_act`` (five activations, with and
  without bias): the port's plain versions against the JAX functions,
  whose Pallas kernels run in interpret mode;
- ``PallasFusionPass`` on the vanilla attention + RMSNorm + SwiGLU capture
  of the JAX package's own fusion test: the same three substitutions, and
  the fused program's fetches against JAX's Executor on the same feeds;
- the pass's negative cases (fetched intermediate, ``transpose_y``,
  quantized linear, silu feeding a multiply, unrecoverable epsilon);
- capture, Executor and pass-registry rules of the port itself.

Tolerances: f32 2e-5 (sums in other orders); bf16 2e-2 (one bf16
rounding of the output); the flash substitution 1e-4 (its online softmax
sums exponentials block by block, the vanilla program row by row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
import paddle_tpu.ops as jops
from paddle_tpu import static as jstatic
from paddle_tpu.static.rewrite import PallasFusionPass as JaxPallasFusionPass

import paddle_tpu_torch.ops as tops
from paddle_tpu_torch import set_flags
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.static.rewrite import PallasFusionPass
from _torch_threads import _one_thread  # noqa: F401


F32_TOL = 2e-5
BF16_TOL = 2e-2
FLASH_TOL = 1e-4


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pair(a, dtype):
    """The same values for both frameworks (bf16 rounded once by torch)."""
    if dtype == "float32":
        return jnp.asarray(a), torch.from_numpy(a)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _optypes(prog):
    return [op.type for op in prog.global_block().ops]


# ----------------------------------------------------------------- kernels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("hidden", [256, 200])
def test_fused_layer_norm_matches_pallas(dtype, residual, hidden):
    rng = np.random.default_rng(1)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (
        _rand(rng, (24, hidden)), 1 + _rand(rng, (hidden,), 0.1), _rand(rng, (hidden,), 0.1)))
    kw = {}
    if residual:
        (jr, tr) = _pair(_rand(rng, (24, hidden)), dtype)
        kw = {"residual": (jr, tr)}
    want = jops.fused_layer_norm(jx, jw, jb, epsilon=1e-5,
                                 **({"residual": kw["residual"][0]} if residual else {}))
    got = tops.fused_layer_norm(tx, tw, tb, epsilon=1e-5,
                                **({"residual": kw["residual"][1]} if residual else {}))
    if residual:
        (want, want_s), (got, got_s) = want, got
        np.testing.assert_array_equal(got_s.float().numpy(), _np(want_s))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rms_norm_residual_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    (jx, tx), (jr, tr), (jw, tw) = (_pair(a, dtype) for a in (
        _rand(rng, (3, 8, 256)), _rand(rng, (3, 8, 256)), 1 + _rand(rng, (256,), 0.1)))
    want, want_s = jops.fused_rms_norm(jx, jw, epsilon=1e-6, residual=jr)
    got, got_s = tops.fused_rms_norm(tx, tw, epsilon=1e-6, residual=tr)
    np.testing.assert_array_equal(got_s.float().numpy(), _np(want_s))
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


def test_fused_norm_residual_gradients():
    """The residual form's gradient reaches x, the residual, weight and
    bias: the same as autograd through the unfused add + norm."""
    rng = np.random.default_rng(3)
    x, r, w, b = (torch.from_numpy(a).requires_grad_() for a in (
        _rand(rng, (6, 64)), _rand(rng, (6, 64)), 1 + _rand(rng, (64,), 0.1),
        _rand(rng, (64,), 0.1)))
    cot, cot_s = torch.from_numpy(_rand(rng, (6, 64))), torch.from_numpy(_rand(rng, (6, 64)))
    out, s = tops.fused_layer_norm(x, w, b, residual=r, epsilon=1e-5)
    got = torch.autograd.grad((out * cot).sum() + (s * cot_s).sum(), (x, r, w, b))
    s2 = x + r
    out2 = tF.layer_norm(s2, 64, w, b, 1e-5)
    want = torch.autograd.grad((out2 * cot).sum() + (s2 * cot_s).sum(), (x, r, w, b))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "gelu_tanh", "silu"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_bias_act_matches_pallas(activation, bias, dtype):
    """[16, 128] x [128, 256]: shapes the JAX kernel tiles, so its Pallas
    kernel (not its XLA fallback) runs in interpret mode."""
    rng = np.random.default_rng(4)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (
        _rand(rng, (2, 8, 128), 128 ** -0.5), _rand(rng, (128, 256)), _rand(rng, (256,), 0.5)))
    want = jops.matmul_bias_act(jx, jw, jb if bias else None, activation)
    got = tops.matmul_bias_act(tx, tw, tb if bias else None, activation)
    assert got.shape == (2, 8, 256) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)


def test_matmul_bias_act_gradients_match_jax():
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, (16, 128), 0.1), _rand(rng, (128, 256), 0.1), _rand(rng, (256,), 0.1)
    cot = _rand(rng, (16, 256))
    _, vjp = jax.vjp(lambda *a: jops.matmul_bias_act(*a, "gelu"), *map(jnp.asarray, (x, w, b)))
    want = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    got = torch.autograd.grad(tops.matmul_bias_act(*ts, "gelu"), ts, torch.from_numpy(cot))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ fusion pass


def _capture_vanilla_jax(B, N, S, D, H, F_):
    prog = jstatic.Program()
    with jstatic.program_guard(prog):
        q, k, v = (jstatic.data(n, [B, N, S, D], "float32") for n in "qkv")
        x = jstatic.data("x", [B, S, H], "float32")
        w = jstatic.data("w", [H], "float32")
        g = jstatic.data("g", [B, S, F_], "float32")
        u = jstatic.data("u", [B, S, F_], "float32")
        scores = paddle.matmul(q, k, transpose_y=True) / (D ** 0.5)
        attn = paddle.matmul(jF.softmax(scores, axis=-1), v)
        var = (x * x).mean(axis=-1, keepdim=True)
        normed = x * paddle.rsqrt(var + 1e-6) * w
        sw = jF.silu(g) * u
    return prog, (attn, normed, sw)


def _capture_vanilla_torch(B, N, S, D, H, F_):
    """The same program written with torch ops on the port's Variables."""
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        q, k, v = (tstatic.data(n, [B, N, S, D], "float32") for n in "qkv")
        x = tstatic.data("x", [B, S, H], "float32")
        w = tstatic.data("w", [H], "float32")
        g = tstatic.data("g", [B, S, F_], "float32")
        u = tstatic.data("u", [B, S, F_], "float32")
        scores = torch.matmul(q, k.transpose(-1, -2)) / (D ** 0.5)
        attn = torch.softmax(scores, dim=-1) @ v
        var = (x * x).mean(-1, keepdim=True)
        normed = x * torch.rsqrt(var + 1e-6) * w
        sw = torch.nn.functional.silu(g) * u
    return prog, (attn, normed, sw)


VANILLA = dict(B=2, N=4, S=128, D=16, H=32, F_=64)


def _vanilla_feed(seed=0):
    rng = np.random.default_rng(seed)
    B, N, S, D, H, F_ = VANILLA.values()
    shapes = {"q": (B, N, S, D), "k": (B, N, S, D), "v": (B, N, S, D), "x": (B, S, H),
              "w": (H,), "g": (B, S, F_), "u": (B, S, F_)}
    return {n: _rand(rng, s) for n, s in shapes.items()}


def test_fusion_pass_substitutes_the_three_vanilla_patterns():
    jprog, jouts = _capture_vanilla_jax(**VANILLA)
    tprog, touts = _capture_vanilla_torch(**VANILLA)
    n_jax = JaxPallasFusionPass([o._vid for o in jouts]).apply(jprog)
    n_port = PallasFusionPass([o._vid for o in touts]).apply(tprog)
    assert n_port == n_jax == 3
    for t in ("flash_attention", "fused_rms_norm", "swiglu"):
        assert t in _optypes(tprog) and t in _optypes(jprog)
    producer = next(op for op in tprog.global_block().ops if touts[0]._vid in op.out_vids)
    assert producer.type == "flash_attention"


def test_fused_vanilla_program_matches_jax_executor():
    """Both Executors run their default pipelines (the pass is on) on the
    same feeds; the port's unfused program (flag off) agrees too."""
    feed = _vanilla_feed()
    jprog, jouts = _capture_vanilla_jax(**VANILLA)
    want = jstatic.Executor().run(jprog, feed=feed, fetch_list=list(jouts))
    tprog, touts = _capture_vanilla_torch(**VANILLA)
    got = tstatic.Executor("cpu").run(tprog, feed=feed, fetch_list=list(touts))
    assert {"flash_attention", "fused_rms_norm", "swiglu"} <= set(_optypes(tprog))
    set_flags({"FLAGS_use_pallas_fusion": False})
    try:
        uprog, uouts = _capture_vanilla_torch(**VANILLA)
        plain = tstatic.Executor("cpu").run(uprog, feed=feed, fetch_list=list(uouts))
        assert "flash_attention" not in _optypes(uprog)
    finally:
        set_flags({"FLAGS_use_pallas_fusion": True})
    for i, tol in enumerate((FLASH_TOL, F32_TOL, F32_TOL)):
        np.testing.assert_allclose(got[i], want[i], atol=tol, rtol=tol)
        np.testing.assert_allclose(got[i], plain[i], atol=tol, rtol=tol)


def test_causal_mask_const_fuses_with_the_causal_flag():
    S, D = 128, 16
    mask = torch.triu(torch.full((S, S), -1e9), diagonal=1)
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        q, k, v = (tstatic.data(n, [1, 2, S, D], "float32") for n in "qkv")
        out = torch.softmax(q @ k.transpose(-1, -2) * 0.25 + mask, dim=-1) @ v
    feed = _vanilla_feed(1)
    feed = {n: feed[n][:1, :2] for n in "qkv"}
    (got,) = tstatic.Executor("cpu").run(prog, feed=feed, fetch_list=[out])
    fl = [op for op in prog.global_block().ops if op.type == "flash_attention"]
    assert len(fl) == 1
    q, k, v = (torch.from_numpy(feed[n]) for n in "qkv")
    want = torch.softmax(q @ k.transpose(-1, -2) * 0.25 + mask, dim=-1) @ v
    np.testing.assert_allclose(got, want.numpy(), atol=FLASH_TOL, rtol=FLASH_TOL)


def test_fetched_intermediate_blocks_fusion():
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        q, k, v = (tstatic.data(n, [2, 4, 128, 16], "float32") for n in "qkv")
        probs = torch.softmax(q @ k.transpose(-1, -2) / 4.0, dim=-1)
        out = probs @ v
    assert PallasFusionPass([out._vid, probs._vid]).apply(prog) == 0
    assert "flash_attention" not in _optypes(prog)


def _gelu_linear_program(lin, fetch_pre=False):
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [8, 64], "float32")
        pre = lin(x)
        out = tF.gelu(pre)
    return prog, pre, out


def test_matmul_epilogue_fires_and_matches():
    lin = Linear(64, 128, device="cpu", generator=torch.Generator().manual_seed(0))
    torch.nn.init.normal_(lin.bias, generator=torch.Generator().manual_seed(1))
    xv = _rand(np.random.default_rng(6), (8, 64))
    set_flags({"FLAGS_use_pallas_fusion": False})
    try:
        prog, _, out = _gelu_linear_program(lin)
        (ref,) = tstatic.Executor("cpu").run(prog, feed={"x": xv}, fetch_list=[out])
    finally:
        set_flags({"FLAGS_use_pallas_fusion": True})
    assert PallasFusionPass([out._vid]).apply(prog) == 1
    assert _optypes(prog) == ["linear", "matmul_epilogue"]  # the orphan is pruned at run
    (got,) = tstatic.Executor("cpu").run(prog, feed={"x": xv}, fetch_list=[out])
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


def test_matmul_epilogue_reads_the_tanh_gelu():
    lin = Linear(64, 128, device="cpu")
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        out = tF.gelu(lin(tstatic.data("x", [8, 64], "float32")), approximate=True)
    PallasFusionPass([out._vid]).apply(prog)
    op = prog.global_block().ops[-1]
    assert op.type == "matmul_epilogue" and op.kwargs["activation"] == "gelu_tanh"


def test_matmul_epilogue_negative_cases():
    lin = Linear(64, 64, device="cpu")
    # the pre-activation is fetched: no fusion
    prog, pre, out = _gelu_linear_program(lin)
    assert PallasFusionPass([out._vid, pre._vid]).apply(prog) == 0
    # transpose_y: x @ w.T has no kernel contract (the square weight passes
    # the shape check)
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [8, 64], "float32")
        mm = prog.record("matmul", lambda a, b, transpose_y=False: a @ (b.t() if transpose_y
                                                                         else b),
                         [x, lin.weight], {"transpose_y": True})
        out = tF.gelu(mm)
    assert PallasFusionPass([out._vid]).apply(prog) == 0
    # a weight-only-quantized linear (the quant pass's wq:: namespace)
    prog, _, out = _gelu_linear_program(lin)
    prog.global_block().ops[0].type = "wq::linear"
    assert PallasFusionPass([out._vid]).apply(prog) == 0
    assert "matmul_epilogue" not in _optypes(prog)


def test_silu_feeding_a_multiply_stands_down_for_swiglu():
    gate, up = Linear(32, 64, device="cpu"), Linear(32, 64, device="cpu")
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [4, 32], "float32")
        out = tF.silu(gate(x)) * up(x)
    PallasFusionPass([out._vid]).apply(prog)
    assert "swiglu" in _optypes(prog) and "matmul_epilogue" not in _optypes(prog)


def test_add_norm_patterns_fuse_the_residual_stream():
    """norm(a + b) with the sum used again: the fused op emits both."""
    rng = np.random.default_rng(7)
    w, b = torch.from_numpy(1 + _rand(rng, (32,), 0.1)), torch.from_numpy(_rand(rng, (32,)))
    av, bv = _rand(rng, (4, 32)), _rand(rng, (4, 32))

    def run(body):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            out = body(tstatic.data("a", [4, 32], "float32"), tstatic.data("b", [4, 32],
                                                                           "float32"))
        return prog, tstatic.Executor("cpu").run(prog, feed={"a": av, "b": bv},
                                                 fetch_list=[out])[0]

    def rms_body(a, bb):
        h = a + bb
        return tF.rms_norm(h, w, 1e-5) * 2.0 + h

    def ln_body(a, bb):
        h = a + bb
        return tF.layer_norm(h, 32, w, b, 1e-5) * 2.0 + h

    for body, fused in ((rms_body, "add_rms_norm"), (ln_body, "add_layer_norm")):
        set_flags({"FLAGS_use_pallas_fusion": False})
        try:
            _, ref = run(body)
        finally:
            set_flags({"FLAGS_use_pallas_fusion": True})
        prog, got = run(body)
        assert fused in _optypes(prog)
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


def test_add_norm_needs_a_recoverable_epsilon():
    w = torch.ones(32)
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        h = tstatic.data("a", [4, 32], "float32") + tstatic.data("b", [4, 32], "float32")
        out = prog.record("rms_norm", lambda x, ww: tF.rms_norm(x, ww, 1e-6), [h, w], {})
    assert PallasFusionPass([out._vid]).apply(prog) == 0


def test_add_norm_matches_jax_program():
    """The JAX package's add_layer_norm test program, captured in both
    packages from the same weights: both fuse, the fetches agree."""
    rng = np.random.default_rng(4)
    wv, bv_ = _rand(rng, (32,)), _rand(rng, (32,))
    av, bv = _rand(rng, (4, 32)), _rand(rng, (4, 32))
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        a, b = jstatic.data("a", [4, 32], "float32"), jstatic.data("b", [4, 32], "float32")
        jout = jF.layer_norm(a + b, 32, weight=paddle.to_tensor(wv),
                             bias=paddle.to_tensor(bv_), epsilon=1e-5)
    (want,) = jstatic.Executor().run(jprog, feed={"a": av, "b": bv}, fetch_list=[jout])
    tprog = tstatic.Program()
    with tstatic.program_guard(tprog):
        a, b = tstatic.data("a", [4, 32], "float32"), tstatic.data("b", [4, 32], "float32")
        tout = tF.layer_norm(a + b, 32, torch.from_numpy(wv), torch.from_numpy(bv_), 1e-5)
    (got,) = tstatic.Executor("cpu").run(tprog, feed={"a": av, "b": bv}, fetch_list=[tout])
    assert "add_layer_norm" in _optypes(tprog) and "add_layer_norm" in _optypes(jprog)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


# --------------------------------------------------- capture and executor


def test_capture_records_ops_state_and_consts():
    lin = Linear(8, 4, device="cpu")
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [2, 8], "float32")
        b, s = x.shape  # a static fact: no op
        assert (b, s) == (2, 8) and x.dtype == torch.float32
        pos = torch.arange(8)  # no Variable: runs, and becomes a const below
        y = lin(x + pos)
        z = torch.cumsum(y, dim=0)  # not in the table: recorded under its torch name
        with pytest.raises(NotImplementedError, match="in-place"):
            y.add_(1)
    types = _optypes(prog)
    assert types == ["add", "linear", "torch.cumsum"]
    assert len(prog.param_inits) == 2  # weight and bias became state vars
    assert prog.global_block().ops[0].arg_spec[1][0] == "const"
    (got,) = tstatic.Executor("cpu").run(prog, feed={"x": np.ones((2, 8), np.float32)},
                                         fetch_list=[z])
    with torch.no_grad():
        want = torch.cumsum(lin(torch.ones(2, 8) + torch.arange(8)), dim=0)
    np.testing.assert_allclose(got, want.numpy(), atol=F32_TOL)


def test_program_clone_as_function_and_dead_code_elimination():
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [3], "float32")
        y = x * 2.0
        dead = x + 1.0
        torch.rand_like(x)  # unfetched, but a random op: never eliminated
    clone = prog.clone()
    run, _, _ = prog.as_function([y._vid])
    (got,), _ = run([torch.ones(3)], [])
    assert torch.equal(got, torch.full((3,), 2.0))
    assert tstatic.passes.dead_code_elimination(clone, [y]) == 1
    assert _optypes(clone) == ["multiply", "torch.rand_like"]
    assert len(prog.global_block().ops) == 3
    assert dead.name in prog.global_block().vars


def test_executor_rules():
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [2, 3], "bfloat16")
        y = x * 2.0
    exe = tstatic.Executor("cpu")
    xv = torch.randn(2, 3).to(torch.bfloat16)
    # bf16 fetches come back as exact float32 numpy arrays (numpy has no bf16)
    (as_np,) = exe.run(prog, feed={"x": xv}, fetch_list=[y])
    (as_t,) = exe.run(prog, feed={"x": xv}, fetch_list=[y], return_numpy=False)
    assert as_np.dtype == np.float32 and as_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np, as_t.float().numpy())
    with pytest.raises(ValueError, match="nothing is moved"):
        exe.run(prog, feed={"x": torch.empty(2, 3, device="meta")}, fetch_list=[y])
    with pytest.raises(KeyError, match="missing feed"):
        exe.run(prog, feed={}, fetch_list=[y])
    # verify mode (static/verify.py): the program is verified before it runs
    from paddle_tpu_torch.static.verify import verify_stats

    set_flags({"FLAGS_verify_programs": True})
    try:
        before = verify_stats()["programs_verified"]
        (verified,) = tstatic.Executor("cpu").run(prog, feed={"x": xv}, fetch_list=[y])
    finally:
        set_flags({"FLAGS_verify_programs": False})
    assert verify_stats()["programs_verified"] > before
    np.testing.assert_array_equal(verified, as_np)
    # the schedule-search stage runs on the Executor's device (here the
    # program has no subgraph to search, so nothing changes)
    set_flags({"FLAGS_schedule_search": True})
    try:
        (searched,) = exe.run(prog, feed={"x": xv}, fetch_list=[y], return_numpy=False)
    finally:
        set_flags({"FLAGS_schedule_search": False})
    assert torch.equal(searched, as_t) and _optypes(prog) == ["multiply"]


def test_parameters_on_another_device_raise():
    lin = Linear(3, 2, device="meta")
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        y = lin(tstatic.data("x", [2, 3], "float32"))
    with pytest.raises(ValueError, match="parameter"):
        tstatic.Executor("cpu").run(prog, feed={"x": np.ones((2, 3), np.float32)},
                                    fetch_list=[y])


def test_unported_passes_raise_naming_the_roadmap():
    prog = tstatic.Program()
    for name in ("weight_only_quant", "auto_parallel_fp16"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tstatic.passes.apply_pass(prog, name)
    assert tstatic.passes.apply_pass(prog, "pallas_fusion") == 0
    # the codegen passes are ported (tests/test_torch_codegen.py)
    assert tstatic.passes.apply_pass(prog, "generic_elementwise_fusion") == 0
    assert tstatic.passes.apply_pass(prog, "schedule_search", device="cpu") == 0


def test_captured_llama_fuses_the_residual_rms_norms():
    """The port's own LLaMA captured as a Program: its RMSNorm layers record
    as fused_rms_norm, every residual add ends fused into the next norm (2
    a layer; the first norm has no add before it): the post-attention
    norm takes its residual in the model itself (fused_rms_norm with
    ``residual=``), and AddNormPattern fuses the input norms' and the final
    norm's; the fetches equal the eager forward's (the same plain versions
    run)."""
    import collections

    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

    g = torch.Generator().manual_seed(0)
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=2, dtype="float32"), device="cpu",
                             generator=g)
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        logits = model(tstatic.data("ids", [2, 16], "int64"))
    ids = torch.randint(0, 1024, (2, 16), generator=g)
    (got,) = tstatic.Executor("cpu").run(prog, feed={"ids": ids}, fetch_list=[logits],
                                         return_numpy=False)
    counts = collections.Counter(_optypes(prog))
    with_residual = [len(op.arg_spec) == 3 for op in prog.global_block().ops
                     if op.type == "fused_rms_norm"]
    assert counts["add_rms_norm"] == 2 and with_residual.count(True) == 2, counts
    assert with_residual.count(False) == 1, with_residual
    assert counts["swiglu"] == 2 and counts["scaled_dot_product_attention"] == 2, counts
    with torch.no_grad():
        want = model(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL, rtol=F32_TOL)
