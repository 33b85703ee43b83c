"""The codegen translator and GenericElementwiseFusionPass against the JAX
package, on the CPU.

- Every entry of the translator's table (``static/codegen.py``): the port
  captures one op, the generated ``__host__ __device__`` chain text is
  built for the CPU with the host C++ compiler (``tests/codegen_host.py``)
  and run on numpy inputs, and held against the JAX package's op on the
  same inputs: f32 within 1e-6 (relative and absolute: XLA's CPU
  transcendental functions and the C library's differ in the last bits),
  bf16 within one bf16 step of the value (against JAX's f32 result
  rounded once).  The reductions and rowwise
  ops run through the row form of the schedule-search body.  These skip
  only where no host compiler exists.
- The JAX package's generic-fusion tests (tests/test_pallas_fusion.py
  :424-477) in the port: the same op types, fetches within rtol 1e-5,
  atol 1e-6.
- BERT's attention-mask chain (a bool input, int32 and f32 casts): one
  ``vpu_chain_4`` in both packages, bit-equal values.
- Which of the JAX whitelists' op types the port's capture records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu import static as jstatic
from paddle_tpu.static.passes import apply_pass as japply
from paddle_tpu.static.rewrite import _ELEMENTWISE as JAX_ELEMENTWISE
from paddle_tpu.static.schedule_search import _REDUCE_OPS as JAX_REDUCE
from paddle_tpu.static.schedule_search import _ROWWISE_OPS as JAX_ROWWISE

import codegen_host
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.static import codegen
from paddle_tpu_torch.static import schedule_search as tss
from paddle_tpu_torch.static.passes import apply_pass as tapply
from paddle_tpu_torch.static.rewrite import ElementwiseChainKernel, ProgramGraph
from _torch_threads import _one_thread  # noqa: F401


F32_TOL = 1e-6
FUSION_RTOL, FUSION_ATOL = 1e-5, 1e-6


@pytest.fixture
def host():
    if codegen_host.compiler() is None:
        pytest.skip("no host C++ compiler to build the generated chain text")


def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
            "int32": torch.int32, "bool": torch.bool}[name]


def _capture_port(fn, feeds):
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        out = fn(*[tstatic.data(f"x{i}", list(a.shape), dt) for i, (a, dt) in enumerate(feeds)])
    return prog, out


def _capture_jax(fn, feeds):
    prog = jstatic.Program()
    with jstatic.program_guard(prog):
        out = fn(*[jstatic.data(f"x{i}", list(a.shape), dt) for i, (a, dt) in enumerate(feeds)])
    return prog, out


def _port_tensor(a, dt):
    return torch.from_numpy(a).to(_torch_dtype(dt))


def _jax_value(a, dt):
    if dt in ("bfloat16", "float16"):  # the values torch rounds to, exactly
        return jnp.asarray(torch.from_numpy(a).to(_torch_dtype(dt)).float().numpy(), dt)
    return jnp.asarray(a, dt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_step(v, bits=8):
    """The spacing of numbers with ``bits`` significant bits at |v| (bf16 8,
    f16 11)."""
    a = np.maximum(np.abs(v.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - (bits - 1))


def assert_within_bf16_step(got, want, bits=8):
    """One bf16 (f16: bits=11) step of the value, or F32_TOL absolute (the
    port's gelu cancels to 0 in f32 where JAX's erfc form keeps 1e-9)."""
    got, want = _f32(got), _f32(want)
    step = np.maximum(bf16_step(np.maximum(np.abs(got), np.abs(want)), bits), F32_TOL)
    bad = np.abs(got.astype(np.float64) - want) > step
    assert not bad.any(), (got[bad][:5], want[bad][:5])


# ------------------------------------------------------- the op table

def _rng_inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "pos":
        return (rng.uniform(0.1, 4.0, shape)).astype(np.float32)
    if kind == "unit":
        return (rng.uniform(0.9, 1.1, shape)).astype(np.float32)
    if kind == "halves":
        return (rng.integers(-8, 8, shape) / 2.0 + rng.choice([0.0, 0.3], shape)).astype(
            np.float32)
    if kind == "nan":
        a = rng.standard_normal(shape).astype(np.float32)
        a[::3, ::7] = np.nan
        return a
    return (2.0 * rng.standard_normal(shape)).astype(np.float32)


# name -> (port op, JAX op, inputs: [(kind, dtype)], dtypes to run)
ELEMENTWISE_CASES = {
    "add": (lambda a, b: torch.add(a, b, alpha=2), lambda a, b: a + 2 * b, ["n", "n"]),
    "subtract": (lambda a, b: a - b, lambda a, b: a - b, ["n", "n"]),
    "multiply": (lambda a: a * 0.3, lambda a: a * 0.3, ["n"]),
    "divide": (lambda a, b: a / b, lambda a, b: a / b, ["n", "pos"]),
    "maximum": (torch.maximum, paddle.maximum, ["n", "n"]),
    "minimum": (torch.minimum, paddle.minimum, ["n", "n"]),
    "pow": (lambda a: torch.pow(a, 2.5), lambda a: paddle.pow(a, 2.5), ["pos"]),
    "exp": (torch.exp, paddle.exp, ["n"]),
    "log": (torch.log, paddle.log, ["pos"]),
    "tanh": (torch.tanh, paddle.tanh, ["n"]),
    "sigmoid": (torch.sigmoid, jF.sigmoid, ["n"]),
    "relu": (F.relu, jF.relu, ["n"]),
    "gelu": (tF.gelu, jF.gelu, ["n"]),
    "silu": (tF.silu, jF.silu, ["n"]),
    "abs": (torch.abs, paddle.abs, ["n"]),
    "neg": (torch.neg, paddle.neg, ["n"]),
    "sqrt": (torch.sqrt, paddle.sqrt, ["pos"]),
    "rsqrt": (torch.rsqrt, paddle.rsqrt, ["pos"]),
    "square": (torch.square, paddle.square, ["n"]),
    "floor": (torch.floor, paddle.floor, ["halves"]),
    "ceil": (torch.ceil, paddle.ceil, ["halves"]),
    "round": (torch.round, paddle.round, ["halves"]),
    "clip": (lambda a: torch.clamp(a, -1.0, 0.5), lambda a: paddle.clip(a, -1.0, 0.5), ["n"]),
    "cast": (lambda a: a.to(torch.int32), lambda a: paddle.cast(a, "int32"), ["n"]),
    "leaky_relu": (lambda a: F.leaky_relu(a, 0.2), lambda a: jF.leaky_relu(a, 0.2), ["n"]),
    "elu": (lambda a: F.elu(a, 0.7), lambda a: jF.elu(a, 0.7), ["n"]),
    "hardtanh": (lambda a: F.hardtanh(a, -0.5, 2.0), lambda a: jF.hardtanh(a, -0.5, 2.0), ["n"]),
    "softplus": (lambda a: F.softplus(a, 2.0, 3.0), lambda a: jF.softplus(a, 2.0, 3.0), ["n"]),
    "mish": (F.mish, jF.mish, ["n"]),
    "hardswish": (F.hardswish, jF.hardswish, ["n"]),
    "hardsigmoid": (F.hardsigmoid, jF.hardsigmoid, ["n"]),
    "erf": (torch.erf, paddle.erf, ["n"]),
    "sin": (torch.sin, paddle.sin, ["n"]),
    "cos": (torch.cos, paddle.cos, ["n"]),
}
BF16_CASES = ["add", "multiply", "exp", "tanh", "gelu", "silu", "sqrt", "round", "clip", "mish"]
F16_CASES = ["multiply", "exp", "tanh", "cast"]

REDUCE_CASES = {
    "sum": (lambda a: torch.sum(a, -1, keepdim=True),
            lambda a: paddle.sum(a, axis=-1, keepdim=True), "n"),
    "nansum": (lambda a: torch.nansum(a, -1, keepdim=True),
               lambda a: paddle.nansum(a, axis=-1, keepdim=True), "nan"),
    "mean": (lambda a: torch.mean(a, -1, keepdim=True),
             lambda a: paddle.mean(a, axis=-1, keepdim=True), "n"),
    "nanmean": (lambda a: torch.nanmean(a, -1, keepdim=True),
                lambda a: paddle.nanmean(a, axis=-1, keepdim=True), "nan"),
    "prod": (lambda a: torch.prod(a, -1, keepdim=True),
             lambda a: paddle.prod(a, axis=-1, keepdim=True), "unit"),
    "max": (lambda a: torch.max(a, -1, keepdim=True).values,
            lambda a: paddle.max(a, axis=-1, keepdim=True), "n"),
    "min": (lambda a: a.min(dim=-1, keepdim=True).values,
            lambda a: paddle.min(a, axis=-1, keepdim=True), "n"),
    "amax": (lambda a: torch.amax(a, -1, keepdim=True),
             lambda a: paddle.amax(a, axis=-1, keepdim=True), "n"),
    "amin": (lambda a: torch.amin(a, -1, keepdim=True),
             lambda a: paddle.amin(a, axis=-1, keepdim=True), "n"),
    "logsumexp": (lambda a: torch.logsumexp(a, -1), lambda a: paddle.logsumexp(a, axis=-1), "n"),
    "softmax": (lambda a: torch.softmax(a, -1), lambda a: jF.softmax(a, axis=-1), "n"),
    "log_softmax": (lambda a: F.log_softmax(a, dim=-1), lambda a: jF.log_softmax(a, axis=-1),
                    "n"),
}


def _jax_reference(jax_fn, arrays, dtype):
    """The JAX op on the inputs; for bf16 and f16, on the f32 values of the
    inputs, rounded once (the port rounds each op's f32 result once, where
    JAX's 16-bit ops may round inside a composite)."""
    half = dtype in ("bfloat16", "float16")
    vals = [paddle.to_tensor(_jax_value(a, dtype).astype(jnp.float32) if half
                             else _jax_value(a, dtype)) for a in arrays]
    out = jax_fn(*vals)._value
    if half and jnp.issubdtype(out.dtype, jnp.floating):
        out = out.astype(dtype)
    return out


def _one_op_kernel(prog, out):
    graph = ProgramGraph(prog, (out._vid,))
    (op,) = prog.global_block().ops
    return ElementwiseChainKernel([op], [s[1] for s in op.arg_spec if s[0] == "var"],
                                  out._vid, graph)


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in sorted(ELEMENTWISE_CASES)]
                         + [(n, "bfloat16") for n in BF16_CASES]
                         + [(n, "float16") for n in F16_CASES])
def test_table_entry_matches_jax(host, name, dtype):
    port_fn, jax_fn, kinds = ELEMENTWISE_CASES[name]
    arrays = [_rng_inputs(k, (6, 40), i) for i, k in enumerate(kinds)]
    feeds = [(a, dtype) for a in arrays]
    prog, out = _capture_port(port_fn, feeds)
    (op,) = prog.global_block().ops
    assert op.type == name
    jprog, _ = _capture_jax(jax_fn, feeds)
    assert [o.type.rsplit("::", 1)[-1] for o in jprog.global_block().ops][-1] == name
    kernel = _one_op_kernel(prog, out)
    got = codegen_host.run_elementwise(kernel, [_port_tensor(a, dtype) for a in arrays])
    want = _jax_reference(jax_fn, arrays, dtype)
    assert got.dtype == kernel.dtype
    if dtype == "float32" or not got.dtype.is_floating_point:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL, atol=F32_TOL)
    else:
        assert_within_bf16_step(got, want, 8 if dtype == "bfloat16" else 11)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(REDUCE_CASES))
def test_reduce_entry_matches_jax(host, name, dtype):
    port_fn, jax_fn, kind = REDUCE_CASES[name]
    a = _rng_inputs(kind, (6, 40), 7)
    prog, out = _capture_port(port_fn, [(a, dtype)])
    assert prog.global_block().ops[-1].type == name
    graph = ProgramGraph(prog, (out._vid,))
    spec = tss.match_subgraph(prog.global_block().ops[-1], graph, min_ops=1)
    assert spec is not None and spec.kind == "reduce"
    got = codegen_host.run_subgraph(spec, [_port_tensor(a, dtype)])
    want = _jax_reference(jax_fn, [a], dtype)
    assert tuple(got.shape) == tuple(want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=F32_TOL)
    else:
        assert_within_bf16_step(got, want)


def test_constants_are_exact_f32_literals():
    assert codegen.f32_literal(0.1) == "pt_u2f(0x3dcccccdu)"
    assert codegen.f32_literal(-1e4) == "pt_u2f(0xc61c4000u)"
    assert codegen.f32_literal(float("inf")) == "pt_u2f(0x7f800000u)"


def test_unreadable_attributes_stay_unfused():
    """An op whose attribute the translator cannot read is counted and
    left out of the chain; nothing is guessed."""
    a = np.ones((4, 32), np.float32)

    def body(x):
        y = torch.div(torch.exp(x) + 1.0, 3.0, rounding_mode="floor")
        return torch.tanh(y * 2.0) + 1.0

    prog, out = _capture_port(body, [(a, "float32")])
    codegen.reset_codegen_stats()
    tapply(prog, "generic_elementwise_fusion", fetch_vids=[out._vid])
    types = [op.type for op in prog.global_block().ops]
    assert "divide" in types and "vpu_chain_3" in types, types
    assert codegen.codegen_stats()["ineligible"] >= 1


# -------------------------------------------- GenericElementwiseFusionPass

def _jax_test_chain(pkg):
    def body(a, b):
        t = pkg.tanh(a * b + a)
        u = pkg.exp(t * 0.5)
        return pkg.sqrt(u + 1.0) * b
    return body


def test_generic_elementwise_chain_fusion():
    """tests/test_pallas_fusion.py's chain: ONE generated op in both
    packages, the same op types, values within rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(0)
    av = rng.standard_normal((8, 128)).astype(np.float32)
    bv = rng.standard_normal((8, 128)).astype(np.float32)
    feeds = [(av, "float32"), (bv, "float32")]
    jprog, jout = _capture_jax(_jax_test_chain(paddle), feeds)
    tprog, tout = _capture_port(_jax_test_chain(torch), feeds)
    (ref,) = jstatic.Executor().run(jprog, feed={"x0": av, "x1": bv}, fetch_list=[jout])
    jn = japply(jprog, "generic_elementwise_fusion", fetch_vids=[jout._vid])
    tn = tapply(tprog, "generic_elementwise_fusion", fetch_vids=[tout._vid])
    jtypes = [op.type for op in jprog.global_block().ops]
    ttypes = [op.type for op in tprog.global_block().ops]
    assert jn == tn == 1 and ttypes == jtypes == ["vpu_chain_8"], (jtypes, ttypes)
    (got,) = tstatic.Executor("cpu").run(tprog, feed={"x0": av, "x1": bv}, fetch_list=[tout])
    np.testing.assert_allclose(got, ref, rtol=FUSION_RTOL, atol=FUSION_ATOL)


def test_generic_elementwise_chain_host_kernel_matches_jax(host):
    rng = np.random.default_rng(0)
    av = rng.standard_normal((8, 128)).astype(np.float32)
    bv = rng.standard_normal((8, 128)).astype(np.float32)
    feeds = [(av, "float32"), (bv, "float32")]
    jprog, jout = _capture_jax(_jax_test_chain(paddle), feeds)
    (ref,) = jstatic.Executor().run(jprog, feed={"x0": av, "x1": bv}, fetch_list=[jout])
    tprog, tout = _capture_port(_jax_test_chain(torch), feeds)
    tapply(tprog, "generic_elementwise_fusion", fetch_vids=[tout._vid])
    kernel = tprog.global_block().ops[-1].fn
    got = codegen_host.run_elementwise(kernel, [torch.from_numpy(av), torch.from_numpy(bv)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=FUSION_RTOL, atol=FUSION_ATOL)


def test_generic_fusion_respects_fetch_and_multi_use():
    """Fetched or multiply-consumed intermediates stay materialized."""
    av = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)

    def run(static, pkg, apply):
        prog = static.Program()
        with static.program_guard(prog):
            a = static.data("a", [4, 32], "float32")
            t = pkg.tanh(a * 2.0)
            u = pkg.exp(t + 1.0)
            v = pkg.sqrt(u * u + 1.0)
        exe = static.Executor() if static is jstatic else static.Executor("cpu")
        ref = exe.run(prog, feed={"a": av}, fetch_list=[t, v])
        apply(prog, "generic_elementwise_fusion", fetch_vids=[t._vid, v._vid])
        got = exe.run(prog, feed={"a": av}, fetch_list=[t, v])
        return [op.type for op in prog.global_block().ops], ref, got

    jtypes, jref, _ = run(jstatic, paddle, japply)
    ttypes, tref, tgot = run(tstatic, torch, tapply)
    assert ttypes == jtypes, (jtypes, ttypes)
    np.testing.assert_allclose(tgot[0], jref[0], rtol=1e-6)
    np.testing.assert_allclose(tgot[1], jref[1], rtol=FUSION_RTOL, atol=FUSION_ATOL)


def _jax_mask(ids):
    m = (ids != 0).astype("int32")
    return (1 - m.astype("float32")) * -1e4


def _port_mask(ids):
    m = (ids != 0).to(torch.int32)
    return (1 - m.float()) * -1e4


def test_bert_mask_chain_bool_input(host):
    """BertModel.forward's mask: cast(bool->int32) -> cast(->f32) ->
    subtract(1, .) -> multiply(., -1e4): one vpu_chain_4 whose input is
    the bool, in both packages, and the same values (exact: casts and
    one exact multiply)."""
    ids = np.random.default_rng(2).integers(0, 3, (32, 128)).astype(np.int32)
    feeds = [(ids, "int32")]
    jprog, jout = _capture_jax(_jax_mask, feeds)
    tprog, tout = _capture_port(_port_mask, feeds)
    (want,) = jstatic.Executor().run(jprog, feed={"x0": ids}, fetch_list=[jout])
    japply(jprog, "generic_elementwise_fusion", fetch_vids=[jout._vid])
    tapply(tprog, "generic_elementwise_fusion", fetch_vids=[tout._vid])
    jtypes = [op.type for op in jprog.global_block().ops]
    ttypes = [op.type for op in tprog.global_block().ops]
    assert ttypes == jtypes == ["not_equal", "vpu_chain_4"], (jtypes, ttypes)
    kernel = tprog.global_block().ops[-1].fn
    assert [i.dtype for i in kernel.chain.inputs] == [torch.bool]
    (got,) = tstatic.Executor("cpu").run(tprog, feed={"x0": ids}, fetch_list=[tout])
    np.testing.assert_array_equal(got, want)
    host_out = codegen_host.run_elementwise(kernel, [torch.from_numpy(ids != 0)])
    np.testing.assert_array_equal(host_out.numpy(), want)


# ---------------------------------------------- what the capture records

JAX_ONLY = {"amp_cast", "fake_quant", "scale"}


def test_capture_records_every_whitelisted_type_torch_can_express():
    """The port's capture table names every op type of the JAX package's
    three whitelists except the JAX-only ones, and each case above records
    under that name."""
    from paddle_tpu_torch.static.program import _torch_ops

    table, reflected = _torch_ops()
    names = {v[0] for v in table.values()} | {v[0] for v in reflected.values()}
    names |= {"max", "min"}  # recorded by torch.max / torch.min with a dim
    wanted = JAX_ELEMENTWISE | JAX_REDUCE | JAX_ROWWISE
    assert wanted - names == JAX_ONLY, sorted(wanted - names)
    assert set(ELEMENTWISE_CASES) | set(REDUCE_CASES) == wanted - JAX_ONLY


def test_max_with_dim_records_values_and_indices_on_demand():
    a = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    prog, out = _capture_port(lambda x: torch.max(x, 1).values, [(a, "float32")])
    assert [op.type for op in prog.global_block().ops] == ["max"]
    prog2 = tstatic.Program()
    with tstatic.program_guard(prog2):
        v, i = torch.max(tstatic.data("x", [4, 8], "float32"), dim=1)
    assert [op.type for op in prog2.global_block().ops] == ["max", "argmax"]
    got_v, got_i = tstatic.Executor("cpu").run(prog2, feed={"x": a}, fetch_list=[v, i])
    np.testing.assert_array_equal(got_v, a.max(1))
    np.testing.assert_array_equal(got_i, a.argmax(1))


def test_wide_constant_chain_matches_jax(host):
    """A constant broadcast along the last dim (a bias captured as a
    tensor) is one more pointer argument of the generated kernel: the
    same chain in both packages, values within rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(4)
    av = rng.standard_normal((6, 40)).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)

    def body(pkg):
        c = paddle.to_tensor(bias) if pkg is paddle else torch.from_numpy(bias)
        return lambda a: pkg.tanh(a * 2.0 + c) * 3.0

    feeds = [(av, "float32")]
    jprog, jout = _capture_jax(body(paddle), feeds)
    tprog, tout = _capture_port(body(torch), feeds)
    (want,) = jstatic.Executor().run(jprog, feed={"x0": av}, fetch_list=[jout])
    japply(jprog, "generic_elementwise_fusion", fetch_vids=[jout._vid])
    tapply(tprog, "generic_elementwise_fusion", fetch_vids=[tout._vid])
    assert [op.type for op in tprog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops] == ["vpu_chain_4"]
    kernel = tprog.global_block().ops[-1].fn
    assert len(kernel.chain.wide_values) == 1
    got = codegen_host.run_elementwise(kernel, [torch.from_numpy(av)])
    np.testing.assert_allclose(got.numpy(), want, rtol=FUSION_RTOL, atol=FUSION_ATOL)
