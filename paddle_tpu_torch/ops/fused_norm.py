"""Fused RMSNorm and LayerNorm: kernels for Hopper beside their plain
versions.

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

RMSNorm runs ``csrc/norm_swiglu.cu`` (CUDA C++): 16-byte accesses, a row
spread over 1 to 8 warps whose lanes issue every load of the row and of
the weight (in its own dtype) before its reduction (warp shuffles, one
shared-memory exchange across warps), a block a row group, and a launch
shape from ``rms_geometry`` that widens a row over more warps while few
rows leave SMs idle.  The source's header says more.  The Triton RMSNorm
it replaced stays below as a yardstick only (``_rms_norm_triton``: the
timing scripts call it, it ticks no main-path counter).  LayerNorm is Triton: one program per row
holds the whole row in registers, masked block loads give coalesced
16-byte accesses, the reductions and the scale happen in registers before
the single store.

The gradients (``_RMSNormFn``, ``_LayerNormFn``) are plain PyTorch on both
devices, the formulas of the JAX package's ``_rms_bwd`` and ``_ln_bwd``,
which are plain jnp there too.
"""

from __future__ import annotations

import functools

import torch

from paddle_tpu_torch.static.program import apply

from . import count_launch, count_yardstick, sm_count, use_kernel
from ._norm_swiglu import DTYPES, lib, vec_ok

__all__ = ["fused_rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_geometry",
           "fused_layer_norm", "layer_norm_plain", "layer_norm_bwd"]

tl = None  # triton.language, bound at the first launch
_KERNELS: dict = {}
_MAX_HIDDEN = 65536  # the Triton kernels' one-block row; the LayerNorm's longer rows take
_WIDE_BLOCK = 4096   # _layer_norm_wide_kernel, in passes of this many columns

# csrc/norm_swiglu.cu's RMSNorm: a lane holds at most RMS_MAX_NV 16-byte
# chunks of each input; a row spreads over more warps (8 at most: the
# kernel's 256-thread block) while the rows give fewer than RMS_FILL_WARPS
# warps an SM; rows share a block until it has RMS_MIN_THREADS threads.
RMS_MAX_NV = 4
RMS_FILL_WARPS = 4
RMS_MIN_THREADS = 64


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def rms_geometry(rows: int, hidden: int, elem_bytes: int, sms: int = 132, ptrs=()) -> dict:
    """The launch shape of ``csrc/norm_swiglu.cu``'s RMSNorm over
    ``[rows, hidden]`` of ``elem_bytes``-byte elements on ``sms`` SMs.

    A row is ``chunks = ceil(hidden / elems)`` 16-byte chunks (``elems`` =
    8 bf16/f16 or 4 f32 elements).  ``warps_per_row`` is the fewest warps
    (1, 2, 4 or 8) whose lanes hold the row in at most RMS_MAX_NV chunks
    each, widened while ``rows`` would give fewer than RMS_FILL_WARPS warps
    an SM and every lane keeps a chunk; ``nv`` is the chunks a lane holds
    (1, 2 or 4); a row longer than 8 warps' 4 chunks a lane is ``tiled``
    (read twice).  A block holds ``rows_per_block`` rows, enough for
    RMS_MIN_THREADS threads, fewer while that leaves SMs without a block;
    ``grid`` is a block a row group (the card deals them to the SMs).
    ``vec``: 16-byte accesses, taken only when ``hidden`` is a whole
    number of chunks and every pointer in ``ptrs`` is 16-byte aligned
    (else the same chunks move element by element)."""
    geo = dict(_rms_shape(rows, hidden, elem_bytes, sms))
    geo["vec"] = vec_ok(hidden, elem_bytes, ptrs)
    return geo


@functools.lru_cache(maxsize=4096)
def _rms_shape(rows, hidden, elem_bytes, sms):
    elems = 16 // elem_bytes
    chunks = -(-hidden // elems)
    w = 1
    while w < 8 and chunks > 32 * w * RMS_MAX_NV:
        w *= 2
    while w < 8 and rows * w < RMS_FILL_WARPS * sms and chunks >= 64 * w:
        w *= 2
    nv = min(RMS_MAX_NV, _pow2_at_least(-(-chunks // (32 * w))))
    r = max(1, RMS_MIN_THREADS // (32 * w))
    while r > 1 and -(-rows // r) < sms:
        r //= 2
    return {"elems": elems, "chunks": chunks, "nv": nv, "warps_per_row": w, "rows_per_block": r,
            "threads": 32 * w * r, "grid": -(-rows // r), "tiled": chunks > 32 * w * nv}


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


def _layer_norm_wide_kernel(x_ptr, r_ptr, w_ptr, b_ptr, o_ptr, s_ptr, hidden, eps,
                            HAS_RES: tl.constexpr, BLOCK: tl.constexpr):
    """``_layer_norm_kernel`` for a row longer than one block holds, in
    three passes of BLOCK columns: the sum, the centred sum of squares, the
    output.  Each pass recomputes ``x + residual`` (the same rounded value;
    the first pass stores it)."""
    base = tl.program_id(0).to(tl.int64) * hidden
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for off in range(0, hidden, BLOCK):
        cols = off + tl.arange(0, BLOCK)
        mask = cols < hidden
        x = tl.load(x_ptr + base + cols, mask=mask, other=0.0)
        if HAS_RES:
            r = tl.load(r_ptr + base + cols, mask=mask, other=0.0)
            x = (x.to(tl.float32) + r.to(tl.float32)).to(s_ptr.dtype.element_ty)
            tl.store(s_ptr + base + cols, x, mask=mask)
        acc += x.to(tl.float32)
    mean = tl.sum(acc, axis=0) / hidden
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for off in range(0, hidden, BLOCK):
        cols = off + tl.arange(0, BLOCK)
        mask = cols < hidden
        x = tl.load(x_ptr + base + cols, mask=mask, other=0.0)
        if HAS_RES:
            r = tl.load(r_ptr + base + cols, mask=mask, other=0.0)
            x = (x.to(tl.float32) + r.to(tl.float32)).to(s_ptr.dtype.element_ty)
        xc = tl.where(mask, x.to(tl.float32) - mean, 0.0)
        acc += xc * xc
    inv = 1.0 / tl.sqrt(tl.sum(acc, axis=0) / hidden + eps)
    for off in range(0, hidden, BLOCK):
        cols = off + tl.arange(0, BLOCK)
        mask = cols < hidden
        x = tl.load(x_ptr + base + cols, mask=mask, other=0.0)
        if HAS_RES:
            r = tl.load(r_ptr + base + cols, mask=mask, other=0.0)
            x = (x.to(tl.float32) + r.to(tl.float32)).to(s_ptr.dtype.element_ty)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = (x.to(tl.float32) - mean) * inv * w + b
        tl.store(o_ptr + base + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


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


def _check_rows(name, x2d, r2d, params, max_hidden=None):
    """Raise on what the row kernels do not take (the wrappers hand them
    contiguous rows of one dtype; ``max_hidden``: a kernel that holds a row
    in one block)."""
    hidden = x2d.shape[1]
    if x2d.dtype not in DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x2d.dtype}")
    if r2d is not None and (r2d.shape != x2d.shape or r2d.dtype != x2d.dtype):
        raise ValueError(f"{name}: residual {tuple(r2d.shape)} {r2d.dtype} does not match "
                         f"x {tuple(x2d.shape)} {x2d.dtype}")
    if any(p.shape != (hidden,) for p in params):
        raise ValueError(f"{name}: weight/bias shapes {[tuple(p.shape) for p in params]} "
                         f"!= ({hidden},)")
    tensors = [x2d] + ([r2d] if r2d is not None else []) + list(params)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous rows, weight and bias")
    if max_hidden is not None and hidden > max_hidden:
        raise ValueError(f"{name}: hidden {hidden} exceeds the kernel's {max_hidden}")


def _rows_cuda(name, kernel, x2d, r2d, params, eps, wide=None):
    """Launch a Triton row kernel over ``[rows, hidden]`` (none without
    rows); returns ``(out, sum)`` with ``sum`` the written ``x + residual``
    (None without a residual).  A row above ``_MAX_HIDDEN`` takes ``wide``
    (the row in passes of ``_WIDE_BLOCK`` columns); without one it is
    refused."""
    rows, hidden = x2d.shape
    _check_rows(name, x2d, r2d, params, None if wide is not None else _MAX_HIDDEN)
    out = torch.empty_like(x2d)
    s = torch.empty_like(x2d) if r2d is not None else None
    if rows == 0:
        return out, s
    ptrs = [x2d, r2d if r2d is not None else x2d, *params, out, s if s is not None else out]
    if hidden > _MAX_HIDDEN:
        _kernel(wide)[(rows,)](*ptrs, hidden, float(eps), HAS_RES=r2d is not None,
                               BLOCK=_WIDE_BLOCK, num_warps=8)
        return out, s
    block = 1 << (hidden - 1).bit_length()
    _kernel(kernel)[(rows,)](*ptrs, hidden, float(eps), HAS_RES=r2d is not None,
                             BLOCK=block, num_warps=min(16, max(1, block // 256)))
    return out, s


def _rms_norm_triton(x2d, r2d, weight, eps):
    """The Triton RMSNorm that ``csrc/norm_swiglu.cu`` replaced, kept as a
    yardstick: the timing scripts run it beside the kernel on the same
    inputs.  Counts under the ``fused_rms_norm_triton`` yardstick, never
    under ``fused_rms_norm``."""
    out, s = _rows_cuda("fused_rms_norm", _rms_norm_kernel, x2d, r2d, (weight,), eps)
    if x2d.shape[0]:
        count_yardstick("fused_rms_norm_triton")
    return out, s


def _rms_cuda(x2d, r2d, weight, eps):
    """``csrc/norm_swiglu.cu``'s RMSNorm over ``[rows, hidden]``, the weight
    in its own dtype; returns ``(out, sum)`` with ``sum`` the written
    ``x + residual`` (None without a residual)."""
    rows, hidden = x2d.shape
    _check_rows("fused_rms_norm", x2d, r2d, (weight,))  # any hidden: a long row in passes
    if weight.dtype not in DTYPES:
        raise TypeError(f"fused_rms_norm: unsupported weight dtype {weight.dtype}")
    out = torch.empty_like(x2d)
    s = torch.empty_like(x2d) if r2d is not None else None
    if rows == 0:
        return out, s
    tensors = [x2d, weight, out] + ([r2d, s] if r2d is not None else [])
    vec = vec_ok(hidden, x2d.element_size(), [t.data_ptr() for t in tensors])
    geo = _rms_shape(rows, hidden, x2d.element_size(), sm_count(x2d.device))
    with torch.cuda.device(x2d.device):
        err = lib().paddle_rms_norm(
            x2d.data_ptr(), r2d.data_ptr() if r2d is not None else None, weight.data_ptr(),
            out.data_ptr(), s.data_ptr() if s is not None else None, rows, hidden, float(eps),
            DTYPES[x2d.dtype], DTYPES[weight.dtype], geo["nv"],
            geo["warps_per_row"].bit_length() - 1, geo["rows_per_block"], int(geo["tiled"]),
            int(vec), torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_rms_norm: launch failed with CUDA error {err}")
    count_launch("fused_rms_norm")
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
            out, s = _rms_cuda(*_dense(x2d, r2d, weight), eps)
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
            x_, r_, w_, b_ = _dense(x2d, r2d, weight, bias)
            out, s = _rows_cuda("fused_layer_norm", _layer_norm_kernel, x_, r_, (w_, b_), eps,
                                wide=_layer_norm_wide_kernel)
            if x2d.shape[0]:
                count_launch("fused_layer_norm")
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


def _dense(*tensors):
    """The kernels' layout: each tensor contiguous (rows of a row stride
    other than hidden are copied), None kept."""
    return tuple(None if t is None else t.contiguous() for t in tensors)


def _residual_apart(x, residual):
    """A residual the kernels cannot add in place: another dtype or shape.
    The reference adds it first (``x + residual``, promoting and
    broadcasting); so do the wrappers, in torch, and norm the sum."""
    return residual is not None and (residual.dtype != x.dtype or residual.shape != x.shape)


def _rows(x, residual):
    shape = x.shape
    r2d = residual.reshape(-1, shape[-1]) if residual is not None else None
    return shape, x.reshape(-1, shape[-1]), r2d


def _fused_rms_norm(x, weight, residual=None, *, epsilon):
    if _residual_apart(x, residual):
        s = x + residual
        return _fused_rms_norm(s, weight, epsilon=epsilon), s
    shape, x2d, r2d = _rows(x, residual)
    out = _RMSNormFn.apply(x2d, r2d, weight, epsilon)
    if residual is not None:
        return out[0].reshape(shape), out[1].reshape(shape)
    return out.reshape(shape)


def _fused_layer_norm(x, weight, bias, residual=None, *, epsilon):
    if _residual_apart(x, residual):
        s = x + residual
        return _fused_layer_norm(s, weight, bias, epsilon=epsilon), s
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
