"""How the elementwise-chain kernel (#11, csrc/codegen/vpu_chain.cuh) deals
its elements, on the CPU.

The kernel's dealing is PT_HD code: the run of (block, lane) at each
iteration of the persistent grid, the run buffer it fills, and which runs
and inputs go the 16-byte or the predicated element way.  The generated
source's host harness (``pt_host_vpu``, built with the host C++ compiler
by tests/codegen_host.py) walks that same code:

- with hypothesis over n (one element to a few grid strides plus a tail),
  each input's misalignment (0-15 bytes in steps of its element size), the
  block count, the run length and the block width: every element is
  covered exactly once, the ragged tail and every misaligned input go the
  element way, the rest the 16-byte way;
- the chain's values through that walk, with misaligned inputs, a tail of
  every length and several blocks and iterations, equal the default
  walk's bit for bit and the replay of the recorded ops within the codegen
  tests' tolerance; integer chains (an int64 operand against an int
  literal included) exactly.

These skip only where no host compiler exists.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import codegen_host
from paddle_tpu_torch import static
from paddle_tpu_torch.static.passes import apply_pass

VEC, ELEM = 0, 1  # vpu_chain.cuh's PtVpuPath
FUSION_RTOL, FUSION_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def host():
    if codegen_host.compiler() is None:
        pytest.skip("no host C++ compiler to build the generated chain text")


def _kernel(build, feeds):
    main = static.Program()
    with static.program_guard(main):
        out = build(*[static.data(n, list(s), d) for n, s, d in feeds])
    assert apply_pass(main, "generic_elementwise_fusion", fetch_vids=[out._vid]) == 1
    return main.global_block().ops[-1].fn


def _mixed(i, h, m):
    """int64, f16 and bool inputs: 8-, 2- and 1-byte elements."""
    return torch.exp((i * 3 + 1).to(torch.float16) * 0.01 + h) - m.to(torch.float16)


def _jax_chain(a, b):
    return torch.sqrt(torch.exp(torch.tanh(a * b + a) * 0.5) + 1.0) * b


_CHAINS = {}


def _chain(name, n=1):
    """The kernels of the tests, shape [n, 1] (one source for every n)."""
    if (name, n) not in _CHAINS:
        if name == "mixed":
            k = _kernel(_mixed, [("i", (n, 1), "int64"), ("h", (n, 1), "float16"),
                                 ("m", (n, 1), "bool")])
        else:
            k = _kernel(_jax_chain, [("a", (n, 1), "bfloat16"), ("b", (n, 1), "bfloat16")])
        _CHAINS[name, n] = k
    return _CHAINS[name, n]


@settings(max_examples=200, deadline=None, database=None)
@given(data=st.data(), elems=st.sampled_from([4, 8]), threads=st.sampled_from([32, 64, 96]),
       blocks=st.integers(1, 5), strides=st.integers(0, 4))
def test_every_element_dealt_once(host, data, elems, threads, blocks, strides):
    """n is ``strides`` grid strides of blocks * threads * elems elements
    plus a tail (0 to a stride less one; n >= 1)."""
    stride = blocks * threads * elems
    n = strides * stride + data.draw(st.integers(1 if strides == 0 else 0, stride - 1),
                                     label="tail")
    kernel = _chain("mixed")
    sizes = [t.dtype.itemsize for t in kernel.chain.inputs]
    offsets = [data.draw(st.integers(0, 15 // s), label=f"offset {k}") for k, s in
               enumerate(sizes)]
    aligned = [off * s % 16 == 0 for off, s in zip(offsets, sizes)]
    vec = sum(1 << k for k, ok in enumerate(aligned) if ok)
    cover, paths = codegen_host.vpu_cover(kernel, n, threads, elems, blocks, vec)
    np.testing.assert_array_equal(cover, np.ones(n, np.int32))
    tail = (np.arange(n) // elems + 1) * elems > n
    for k, ok in enumerate(aligned):
        want = np.where(tail | (not ok), ELEM, VEC)
        np.testing.assert_array_equal(paths[:, k], want, err_msg=f"input {k}")


@pytest.mark.parametrize("n", [1, 7, 8, 9, 64 * 8 * 2, 64 * 8 * 2 + 3, 1000])
@pytest.mark.parametrize("launch,blocks", [((64, 8), 3), ((32, 4), 1), ((64, 8), 2),
                                           ((32, 4), 4)])
def test_walk_values_match_default_and_replay(host, n, launch, blocks):
    """The mixed chain through the walk, every input offset by 1-3
    elements (none 16-byte aligned): bit for bit the default walk on
    aligned inputs, and the replay within rtol 1e-5, atol 1e-6 (an f16
    result rounds each op as the replay does)."""
    kernel = _chain("mixed", n)
    g = torch.Generator().manual_seed(n)
    i = torch.randint(-50, 50, (n, 1), generator=g)
    h = torch.randn(n, 1, generator=g).to(torch.float16)
    m = torch.rand(n, 1, generator=g) > 0.5
    ref = codegen_host.run_elementwise(kernel, [i, h, m], launch=(64, 8), blocks=1)
    got = codegen_host.run_elementwise(kernel, [i, h, m], launch=launch, blocks=blocks, vec=0,
                                       offsets=[1, 3, 2])
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(torch.int16).numpy())
    torch.testing.assert_close(got.float(), kernel.replay(i, h, m).float(), rtol=FUSION_RTOL,
                               atol=FUSION_ATOL)


@pytest.mark.parametrize("n", [5, 8 * 96 * 3 + 5])
@pytest.mark.parametrize("blocks", [1, 2, 7])
def test_walk_bf16_blocks_and_iterations(host, n, blocks):
    """The JAX package's test chain in bf16 over 1, 2 and 7 blocks (one to
    several iterations a thread): bit for bit the same output, within one
    bf16 step of the replay."""
    kernel = _chain("jax", n)
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn(n, 1, generator=g).to(torch.bfloat16) for _ in range(2))
    ref = codegen_host.run_elementwise(kernel, [a, b], launch=(32, 8), blocks=1)
    got = codegen_host.run_elementwise(kernel, [a, b], launch=(96, 8), blocks=blocks)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(torch.int16).numpy())
    torch.testing.assert_close(got.float(), kernel.replay(a, b).float(), rtol=2.0 ** -7,
                               atol=2.0 ** -14)


def test_wide_constant_column_wraps(host):
    """A wide constant read as a column counter that wraps (no division
    in the loop): columns 0..cols-1 in turn across runs, blocks and
    iterations, at a width that is not a multiple of the run."""
    bias = torch.arange(13, dtype=torch.float32)
    kernel = _kernel(lambda a: torch.tanh(a * 2.0 + bias) * 3.0, [("a", (11, 13), "float32")])
    a = torch.randn(11, 13, generator=torch.Generator().manual_seed(5))
    want = kernel.replay(a)
    for launch, blocks in [((32, 4), 2), ((32, 8), 3), ((64, 4), 1)]:
        got = codegen_host.run_elementwise(kernel, [a], launch=launch, blocks=blocks)
        torch.testing.assert_close(got, want, rtol=FUSION_RTOL, atol=FUSION_ATOL)


def test_host_walk_refuses_configs_the_kernel_refuses(host):
    kernel = _chain("jax", 16)
    for launch in [(48, 8), (256, 6), (0, 8), (1056, 8)]:
        with pytest.raises(ValueError):
            codegen_host.vpu_cover(kernel, 16, *launch, 1, 3)


def _int_chain(x):
    return torch.clip(torch.relu(x * 3 + 1) - 2, -50, 100)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32, torch.int64,
                                   torch.uint8])
def test_integer_chains_build_and_wrap(host, dtype):
    """relu and clip of every integer storage dtype (an int64 operand
    against an int literal included), exact against the replay: the
    products wrap as torch's do."""
    kernel = _kernel(_int_chain, [("x", (300, 1), dtype)])
    assert [op.type for op in kernel.ops] == ["multiply", "add", "relu", "subtract", "clip"]
    lo = 0 if dtype == torch.uint8 else -100
    x = torch.randint(lo, 100, (300, 1), generator=torch.Generator().manual_seed(6)).to(dtype)
    for launch, blocks in [((32, 8), 2), ((32, 4), 1)]:
        got = codegen_host.run_elementwise(kernel, [x], launch=launch, blocks=blocks)
        assert torch.equal(got, kernel.replay(x))
