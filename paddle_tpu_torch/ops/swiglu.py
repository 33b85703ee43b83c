"""Fused SwiGLU ``silu(x) * y``: a Triton kernel for Hopper beside its
plain version.

Replaces the TPU kernel ``paddle_tpu/ops/swiglu.py:_swiglu_kernel``
(launched by ``_swiglu_apply``): ``x * sigmoid(x) * y`` in f32, one cast
back to the input dtype.

What bounds it on the card: bytes.  Two inputs are read once and one
output written once (6 bytes per bf16 element) for about 5 operations
per element.  Design: one flat, masked 1-D grid over ``rows * cols``;
each program handles a contiguous block of elements, so neighbouring
threads touch neighbouring addresses and Triton issues 16-byte accesses.
The inputs may be column halves of one ``[rows, 2 * cols]`` projection
(the LLaMA gate/up split): the kernel reads them in place through their
row strides instead of copying them out.  Triton rather than CUDA C++: a
pure elementwise pass needs no tensor cores, shared-memory staging or
asynchronous copies, and Triton needs no nvcc build.

The gradient (``_SwiGLUFn``) is plain PyTorch on both devices, the
formula of the JAX package's ``_swiglu_bwd``, which is plain jnp there
too.  It reaches a ``gate_up`` input through the halves' views.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.static.program import apply

from . import count_launch, use_kernel

__all__ = ["swiglu", "swiglu_plain", "swiglu_bwd"]

tl = None  # triton.language, bound at the first launch
_KERNEL = None
_BLOCK = 2048


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


def _swiglu_cuda(x2d: torch.Tensor, y2d: torch.Tensor) -> torch.Tensor:
    rows, cols = x2d.shape
    if x2d.dtype != y2d.dtype or x2d.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"swiglu: unsupported dtypes {x2d.dtype}, {y2d.dtype}")
    if y2d.shape != x2d.shape:
        raise ValueError(f"swiglu: shapes differ: {tuple(x2d.shape)} vs {tuple(y2d.shape)}")
    if x2d.stride(1) != 1 or y2d.stride(1) != 1:
        raise ValueError("swiglu: the kernel takes rows with unit column stride")
    out = torch.empty((rows, cols), dtype=x2d.dtype, device=x2d.device)
    n = rows * cols
    if n == 0:
        return out
    grid = (-(-n // _BLOCK),)
    _kernel()[grid](x2d, y2d, out, n, cols, x2d.stride(0), y2d.stride(0),
                    BLOCK=_BLOCK, num_warps=8)
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
