"""Fused RMSNorm: a Triton kernel for Hopper beside its plain version.

Replaces the TPU kernel ``paddle_tpu/ops/fused_norm.py:_rms_kernel``
(launched by ``_pallas_rows``): ``x * rsqrt(mean(x^2) + eps) * w`` over the
last axis, statistics in f32, the weight cast to f32, one cast back to the
input dtype at the end.

What bounds it on the card: bytes.  Each row is read once and written
once (4096 bf16 values at LLaMA-7B width, 16 KB of traffic per row) for
about 3 operations per element, far below the H100's ~295 operations per
byte.  Design: one program per row holds the whole row in registers, so
the row is read from device memory once; masked block loads let Triton
issue coalesced 16-byte accesses; the reduction and the scale happen in
registers before the single store.  Triton rather than CUDA C++: one row
reduction and an elementwise scale need no tensor cores, shared-memory
staging or asynchronous copies, and Triton needs no nvcc build.

The gradient (``_RMSNormFn``) is plain PyTorch on both devices, the
formula of the JAX package's ``_rms_bwd``, which is plain jnp there too.
"""

from __future__ import annotations

import torch

from . import count_launch, use_kernel

__all__ = ["fused_rms_norm", "rms_norm_plain", "rms_norm_bwd"]

tl = None  # triton.language, bound at the first launch
_KERNEL = None


def _rms_norm_kernel(x_ptr, w_ptr, o_ptr, hidden, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < hidden
    x = tl.load(x_ptr + row * hidden + cols, mask=mask, other=0.0).to(tl.float32)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / hidden
    inv = 1.0 / tl.sqrt(var + eps)
    y = x * inv * w
    tl.store(o_ptr + row * hidden + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


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
        _rms_norm_kernel.__annotations__["BLOCK"] = tl.constexpr
        _KERNEL = triton.jit(_rms_norm_kernel)
    return _KERNEL


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 inside, one cast."""
    from paddle_tpu_torch.nn.functional.norm import rms_norm

    return rms_norm(x, weight, eps)


def _rms_norm_cuda(x2d: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    rows, hidden = x2d.shape
    if x2d.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"fused_rms_norm: unsupported dtype {x2d.dtype}")
    if weight.shape != (hidden,):
        raise ValueError(f"fused_rms_norm: weight shape {tuple(weight.shape)} != ({hidden},)")
    if not (x2d.is_contiguous() and weight.is_contiguous()):
        raise ValueError("fused_rms_norm: the kernel takes contiguous rows and weight")
    if hidden > 65536:
        raise ValueError(f"fused_rms_norm: hidden {hidden} exceeds one program's row")
    out = torch.empty_like(x2d)
    if rows == 0:
        return out
    block = 1 << (hidden - 1).bit_length()
    _kernel()[(rows,)](x2d, weight, out, hidden, float(eps), BLOCK=block,
                       num_warps=min(16, max(1, block // 256)))
    count_launch("fused_rms_norm")
    return out


def rms_norm_bwd(x2d: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, eps: float):
    """``(dx, dw)`` of RMSNorm over rows: f32 inside, dx in x's dtype, dw
    summed over the rows in the weight's dtype (JAX's ``_rms_bwd``)."""
    xf = x2d.float()
    gf = g.float() * weight.float()
    inv = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    # d/dx [x * inv]: inv * g - x * (x.g) * inv^3 / H
    dot = (gf * xf).sum(dim=-1, keepdim=True)
    dx = (gf * inv - xf * dot * inv.pow(3) / x2d.shape[-1]).to(x2d.dtype)
    dw = (g.float() * (xf * inv)).sum(dim=0).to(weight.dtype)
    return dx, dw


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, eps):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        if use_kernel(x2d, weight):
            return _rms_norm_cuda(x2d, weight, eps)
        return rms_norm_plain(x2d, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x2d, weight, g, ctx.eps)
        return dx, dw, None


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (paddle_tpu.ops.fused_rms_norm without
    its residual option, which no caller of the port uses yet),
    differentiable in x and weight."""
    shape = x.shape
    return _RMSNormFn.apply(x.reshape(-1, shape[-1]), weight, float(epsilon)).reshape(shape)
