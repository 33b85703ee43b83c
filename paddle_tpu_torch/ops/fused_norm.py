"""Fused RMSNorm and LayerNorm: Triton kernels for Hopper beside their
plain versions.

Replace the TPU kernels ``paddle_tpu/ops/fused_norm.py:_rms_kernel`` (:42)
and ``_ln_kernel`` (:49), both launched by ``_pallas_rows``: over the last
axis, RMSNorm computes ``x * rsqrt(mean(x^2) + eps) * w`` and LayerNorm
``(x - mean) * rsqrt(var + eps) * w + b``, statistics in f32, the weight
and bias cast to f32, one cast back to the input dtype at the end.  With
``residual=`` both first form ``s = x + residual`` (rounded to the input
dtype, as the JAX wrapper's add) and return ``(norm(s), s)``: the kernel
reads x and the residual once and writes both outputs, where the JAX
package adds in a separate XLA op before its kernel.

What bounds them on the card: bytes.  Each row is read once and written
once (LLaMA-7B's 4096 or BERT's 768 bf16 values) for a handful of
operations per element, far below the H100's ~295 operations per byte.
Design: one program per row holds the whole row in registers, so the row
is read from device memory once; masked block loads let Triton issue
coalesced 16-byte accesses; the reductions and the scale happen in
registers before the single store.  Triton rather than CUDA C++: a row
reduction and an elementwise scale need no tensor cores, shared-memory
staging or asynchronous copies, and Triton needs no nvcc build.

The gradients (``_RMSNormFn``, ``_LayerNormFn``) are plain PyTorch on both
devices, the formulas of the JAX package's ``_rms_bwd`` and ``_ln_bwd``,
which are plain jnp there too.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.static.program import apply

from . import count_launch, use_kernel

__all__ = ["fused_rms_norm", "rms_norm_plain", "rms_norm_bwd",
           "fused_layer_norm", "layer_norm_plain", "layer_norm_bwd"]

tl = None  # triton.language, bound at the first launch
_KERNELS: dict = {}


def _rms_norm_kernel(x_ptr, r_ptr, w_ptr, o_ptr, s_ptr, hidden, eps,
                     HAS_RES: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < hidden
    x = tl.load(x_ptr + row * hidden + cols, mask=mask, other=0.0)
    if HAS_RES:
        r = tl.load(r_ptr + row * hidden + cols, mask=mask, other=0.0)
        x = (x.to(tl.float32) + r.to(tl.float32)).to(s_ptr.dtype.element_ty)
        tl.store(s_ptr + row * hidden + cols, x, mask=mask)
    x = x.to(tl.float32)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / hidden
    inv = 1.0 / tl.sqrt(var + eps)
    y = x * inv * w
    tl.store(o_ptr + row * hidden + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


def _layer_norm_kernel(x_ptr, r_ptr, w_ptr, b_ptr, o_ptr, s_ptr, hidden, eps,
                       HAS_RES: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < hidden
    x = tl.load(x_ptr + row * hidden + cols, mask=mask, other=0.0)
    if HAS_RES:
        r = tl.load(r_ptr + row * hidden + cols, mask=mask, other=0.0)
        x = (x.to(tl.float32) + r.to(tl.float32)).to(s_ptr.dtype.element_ty)
        tl.store(s_ptr + row * hidden + cols, x, mask=mask)
    x = x.to(tl.float32)
    mean = tl.sum(x, axis=0) / hidden
    xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / hidden
    inv = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = xc * inv * w + b
    tl.store(o_ptr + row * hidden + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


def _kernel(fn):
    """JIT a Triton kernel on first use (no triton import at module
    import: the CPU tests import this module without triton)."""
    global tl
    kernel = _KERNELS.get(fn.__name__)
    if kernel is None:
        import triton
        import triton.language

        tl = triton.language
        # the annotations are strings under `from __future__ import
        # annotations`; hand Triton the constexpr class itself
        for name in ("HAS_RES", "BLOCK"):
            fn.__annotations__[name] = tl.constexpr
        kernel = _KERNELS[fn.__name__] = triton.jit(fn)
    return kernel


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 inside, one cast."""
    from paddle_tpu_torch.nn.functional.norm import rms_norm

    return rms_norm(x, weight, eps)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 statistics, weight and
    bias in f32, one cast."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * inv * weight.float() + bias.float()).to(x.dtype)


def _rows_cuda(name, kernel, x2d, r2d, params, eps):
    """Launch a row kernel over ``[rows, hidden]``; returns ``(out, sum)``
    with ``sum`` the written ``x + residual`` (None without a residual)."""
    rows, hidden = x2d.shape
    if x2d.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{name}: unsupported dtype {x2d.dtype}")
    tensors = [x2d] + ([r2d] if r2d is not None else []) + list(params)
    if r2d is not None and (r2d.shape != x2d.shape or r2d.dtype != x2d.dtype):
        raise ValueError(f"{name}: residual {tuple(r2d.shape)} {r2d.dtype} does not match "
                         f"x {tuple(x2d.shape)} {x2d.dtype}")
    if any(p.shape != (hidden,) for p in params):
        raise ValueError(f"{name}: weight/bias shapes {[tuple(p.shape) for p in params]} "
                         f"!= ({hidden},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous rows, weight and bias")
    if hidden > 65536:
        raise ValueError(f"{name}: hidden {hidden} exceeds one program's row")
    out = torch.empty_like(x2d)
    s = torch.empty_like(x2d) if r2d is not None else None
    if rows == 0:
        return out, s
    block = 1 << (hidden - 1).bit_length()
    ptrs = [x2d, r2d if r2d is not None else x2d, *params, out, s if s is not None else out]
    _kernel(kernel)[(rows,)](*ptrs, hidden, float(eps), HAS_RES=r2d is not None,
                             BLOCK=block, num_warps=min(16, max(1, block // 256)))
    count_launch(name)
    return out, s


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


def layer_norm_bwd(x2d: torch.Tensor, weight: torch.Tensor, g: torch.Tensor, eps: float):
    """``(dx, dw, db)`` of LayerNorm over rows, f32 inside (JAX's ``_ln_bwd``)."""
    xf = x2d.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    gf = g.float()
    gw = gf * weight.float()
    dx = inv * (gw - gw.mean(dim=-1, keepdim=True)
                - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    return (dx.to(x2d.dtype), (gf * xhat).sum(dim=0).to(weight.dtype),
            gf.sum(dim=0).to(weight.dtype))


class _RMSNormFn(torch.autograd.Function):
    """Returns ``out``, or ``(out, x + residual)`` with a residual."""

    @staticmethod
    def forward(ctx, x2d, r2d, weight, eps):
        if use_kernel(*(t for t in (x2d, r2d, weight) if t is not None)):
            out, s = _rows_cuda("fused_rms_norm", _rms_norm_kernel, x2d, r2d, (weight,), eps)
        else:
            s = x2d + r2d if r2d is not None else None
            out = rms_norm_plain(x2d if s is None else s, weight, eps)
        ctx.save_for_backward(x2d if s is None else s, weight)
        ctx.eps, ctx.has_res = eps, r2d is not None
        return (out, s) if ctx.has_res else out

    @staticmethod
    def backward(ctx, g, *gs):
        s, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(s, weight, g, ctx.eps)
        if ctx.has_res:
            dx = dx + gs[0]
            return dx, dx, dw, None
        return dx, None, dw, None


class _LayerNormFn(torch.autograd.Function):
    """Returns ``out``, or ``(out, x + residual)`` with a residual."""

    @staticmethod
    def forward(ctx, x2d, r2d, weight, bias, eps):
        if use_kernel(*(t for t in (x2d, r2d, weight, bias) if t is not None)):
            out, s = _rows_cuda("fused_layer_norm", _layer_norm_kernel, x2d, r2d,
                                (weight, bias), eps)
        else:
            s = x2d + r2d if r2d is not None else None
            out = layer_norm_plain(x2d if s is None else s, weight, bias, eps)
        ctx.save_for_backward(x2d if s is None else s, weight)
        ctx.eps, ctx.has_res = eps, r2d is not None
        return (out, s) if ctx.has_res else out

    @staticmethod
    def backward(ctx, g, *gs):
        s, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(s, weight, g, ctx.eps)
        if ctx.has_res:
            dx = dx + gs[0]
            return dx, dx, dw, db, None
        return dx, None, dw, db, None


def _rows(x, residual):
    shape = x.shape
    r2d = residual.reshape(-1, shape[-1]) if residual is not None else None
    return shape, x.reshape(-1, shape[-1]), r2d


def _fused_rms_norm(x, weight, residual=None, *, epsilon):
    shape, x2d, r2d = _rows(x, residual)
    out = _RMSNormFn.apply(x2d, r2d, weight, epsilon)
    if residual is not None:
        return out[0].reshape(shape), out[1].reshape(shape)
    return out.reshape(shape)


def _fused_layer_norm(x, weight, bias, residual=None, *, epsilon):
    shape, x2d, r2d = _rows(x, residual)
    if bias is None:
        bias = torch.zeros(shape[-1], dtype=x.dtype, device=x.device)
    out = _LayerNormFn.apply(x2d, r2d, weight, bias, epsilon)
    if residual is not None:
        return out[0].reshape(shape), out[1].reshape(shape)
    return out.reshape(shape)


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, *, epsilon: float = 1e-6,
                   residual: torch.Tensor | None = None):
    """RMSNorm over the last axis, differentiable in x, weight and residual.
    Returns ``out``, or ``(out, x + residual)`` when ``residual`` is given
    (paddle_tpu.ops.fused_rms_norm's contract)."""
    args = (x, weight) if residual is None else (x, weight, residual)
    return apply("fused_rms_norm", _fused_rms_norm, *args, epsilon=float(epsilon))


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, *,
                     epsilon: float = 1e-5, residual: torch.Tensor | None = None):
    """LayerNorm over the last axis (zero bias when ``bias`` is None),
    differentiable in x, weight, bias and residual.  Returns ``out``, or
    ``(out, x + residual)`` when ``residual`` is given
    (paddle_tpu.ops.fused_layer_norm's contract)."""
    args = (x, weight, bias) if residual is None else (x, weight, bias, residual)
    return apply("fused_layer_norm", _fused_layer_norm, *args, epsilon=float(epsilon))
