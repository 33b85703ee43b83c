"""Fused SwiGLU ``silu(x) * y``: a CUDA C++ kernel for Hopper beside its
plain version.

Replaces the TPU kernel ``paddle_tpu/ops/swiglu.py:_swiglu_kernel``
(launched by ``_swiglu_apply``): ``x * sigmoid(x) * y`` in f32, one cast
back to the input dtype.

What bounds it on the card: bytes.  Two inputs are read once and one
output written once (6 bytes per bf16 element) for about 5 operations
per element.  Design (``csrc/norm_swiglu.cu``, whose header says more): a
2-D grid of 16-byte column chunks by rows, from ``swiglu_grid``; a thread
loads 16 bytes of each input and stores 16 bytes, with no integer
division per element.  The inputs may be column halves of one ``[rows, 2 * cols]``
projection (the LLaMA gate/up split): the kernel reads them in place
through their row strides instead of copying them out.  Rows, strides or
pointers that are not 16-byte multiples take the same chunks element by
element.  The Triton kernel it replaced stays below as a yardstick only
(``_swiglu_triton``: the timing scripts call it, it ticks no main-path
counter).

The gradient (``_SwiGLUFn``) is plain PyTorch on both devices, the
formula of the JAX package's ``_swiglu_bwd``, which is plain jnp there
too.  It reaches a ``gate_up`` input through the halves' views.
"""

from __future__ import annotations

import functools

import torch

from paddle_tpu_torch.static.program import apply

from . import count_launch, count_yardstick, use_kernel
from ._norm_swiglu import DTYPES, lib, vec_ok

__all__ = ["swiglu", "swiglu_plain", "swiglu_bwd", "swiglu_grid"]

tl = None  # triton.language, bound at the first launch
_KERNEL = None
_BLOCK = 2048

SWIGLU_THREADS = 128  # threads a block at most (the kernel's __launch_bounds__)
GRID_Y_MAX = 65535


def swiglu_grid(rows: int, cols: int, elem_bytes: int, strides=(), ptrs=()) -> dict:
    """The launch shape of ``csrc/norm_swiglu.cu``'s SwiGLU over ``[rows,
    cols]`` of ``elem_bytes``-byte elements.

    A row is ``chunks = ceil(cols / elems)`` 16-byte chunks (``elems`` = 8
    bf16/f16 or 4 f32 elements); a thread owns one chunk of one row.
    ``threads`` (a block's chunks) is 128, or 64 where that leaves fewer
    lanes idle at the row's end.  ``grid`` is (column blocks, rows), the
    rows capped at 65,535 (the blocks then walk the rest).  ``vec``:
    16-byte accesses, taken only when ``cols`` and every row stride in
    ``strides`` are whole numbers of chunks and every pointer in ``ptrs``
    is 16-byte aligned."""
    geo = dict(_swiglu_shape(rows, cols, elem_bytes))
    geo["vec"] = vec_ok(cols, elem_bytes, ptrs, strides if rows > 1 else ())
    return geo


@functools.lru_cache(maxsize=4096)
def _swiglu_shape(rows, cols, elem_bytes):
    elems = 16 // elem_bytes
    chunks = -(-cols // elems)
    threads = SWIGLU_THREADS
    if -(-chunks // 64) * 64 < -(-chunks // threads) * threads:
        threads = 64
    return {"elems": elems, "chunks": chunks, "threads": threads,
            "grid": (-(-chunks // threads), min(rows, GRID_Y_MAX))}


def _swiglu_kernel(x_ptr, y_ptr, o_ptr, n, cols, x_row_stride, y_row_stride,
                   BLOCK: tl.constexpr):
    idx = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = idx < n
    row = idx // cols
    col = idx % cols
    x = tl.load(x_ptr + row * x_row_stride + col, mask=mask, other=0.0).to(tl.float32)
    y = tl.load(y_ptr + row * y_row_stride + col, mask=mask, other=0.0).to(tl.float32)
    out = x * tl.sigmoid(x) * y
    tl.store(o_ptr + idx, out.to(o_ptr.dtype.element_ty), mask=mask)


def _kernel():
    """JIT the Triton kernel on first use (no triton import at module
    import: the CPU tests import this module without triton)."""
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language

        tl = triton.language
        # the annotation is a string under `from __future__ import
        # annotations`; hand Triton the constexpr class itself
        _swiglu_kernel.__annotations__["BLOCK"] = tl.constexpr
        _KERNEL = triton.jit(_swiglu_kernel)
    return _KERNEL


def swiglu_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 inside, one cast."""
    from paddle_tpu_torch.nn.functional.activation import silu

    return (silu(x.float()) * y.float()).to(x.dtype)


def _check(x2d: torch.Tensor, y2d: torch.Tensor):
    """Raise on what the kernels do not take."""
    if x2d.dtype != y2d.dtype or x2d.dtype not in DTYPES:
        raise TypeError(f"swiglu: unsupported dtypes {x2d.dtype}, {y2d.dtype}")
    if y2d.shape != x2d.shape:
        raise ValueError(f"swiglu: shapes differ: {tuple(x2d.shape)} vs {tuple(y2d.shape)}")
    if x2d.stride(1) != 1 or y2d.stride(1) != 1:
        raise ValueError("swiglu: the kernel takes rows with unit column stride")


def _swiglu_triton(x2d: torch.Tensor, y2d: torch.Tensor) -> torch.Tensor:
    """The Triton SwiGLU that ``csrc/norm_swiglu.cu`` replaced, kept as a
    yardstick: the timing scripts run it beside the kernel on the same
    inputs.  Counts under the ``swiglu_triton`` yardstick, never under
    ``swiglu``."""
    _check(x2d, y2d)
    rows, cols = x2d.shape
    out = torch.empty((rows, cols), dtype=x2d.dtype, device=x2d.device)
    n = rows * cols
    if n == 0:
        return out
    grid = (-(-n // _BLOCK),)
    _kernel()[grid](x2d, y2d, out, n, cols, x2d.stride(0), y2d.stride(0),
                    BLOCK=_BLOCK, num_warps=8)
    count_yardstick("swiglu_triton")
    return out


def _swiglu_cuda(x2d: torch.Tensor, y2d: torch.Tensor) -> torch.Tensor:
    _check(x2d, y2d)
    rows, cols = x2d.shape
    out = torch.empty((rows, cols), dtype=x2d.dtype, device=x2d.device)
    if rows == 0 or cols == 0:
        return out
    # a one-row view may carry any row stride: the kernel never uses it
    xs, ys = (x2d.stride(0), y2d.stride(0)) if rows > 1 else (cols, cols)
    geo = _swiglu_shape(rows, cols, x2d.element_size())
    vec = vec_ok(cols, x2d.element_size(), (x2d.data_ptr(), y2d.data_ptr(), out.data_ptr()),
                  (xs, ys))
    with torch.cuda.device(x2d.device):
        err = lib().paddle_swiglu(
            x2d.data_ptr(), y2d.data_ptr(), out.data_ptr(), rows, cols, xs, ys,
            DTYPES[x2d.dtype], geo["threads"], *geo["grid"], int(vec),
            torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swiglu: launch failed with CUDA error {err}")
    count_launch("swiglu")
    return out


def swiglu_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """``(dx, dy)`` of ``silu(x) * y`` in f32, each cast to its input's
    dtype (JAX's ``_swiglu_bwd``)."""
    xf, yf, gf = x.float(), y.float(), g.float()
    sig = torch.sigmoid(xf)
    dsilu = sig * (1.0 + xf * (1.0 - sig))
    return (gf * yf * dsilu).to(x.dtype), (gf * (xf * sig)).to(y.dtype)


class _SwiGLUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, y2d):
        ctx.save_for_backward(x2d, y2d)
        if use_kernel(x2d, y2d):
            return _swiglu_cuda(x2d, y2d)
        return swiglu_plain(x2d, y2d)

    @staticmethod
    def backward(ctx, g):
        return swiglu_bwd(*ctx.saved_tensors, g)


def _swiglu(x, y=None):
    if y is None:
        x, y = x.chunk(2, dim=-1)
    shape = x.shape
    return _SwiGLUFn.apply(x.reshape(-1, shape[-1]), y.reshape(-1, shape[-1])).reshape(shape)


def swiglu(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """``silu(x) * y``; with ``y=None``, x is split in half on the last
    axis (the contract of paddle_tpu.ops.swiglu).  Differentiable in both;
    one op while a static Program is captured."""
    return apply("swiglu", _swiglu, *((x,) if y is None else (x, y)))
