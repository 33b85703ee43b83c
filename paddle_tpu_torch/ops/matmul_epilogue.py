"""The matmul epilogue: ``act(x @ W + b)`` as CUDA C++ kernels for Hopper
beside their plain version, joined by a ``torch.autograd.Function``.

Counterpart of paddle_tpu/ops/matmul_epilogue.py.  Two kernels replace
the TPU kernel ``_kernel``: ``csrc/matmul_epilogue_sm90.cu`` (TMA loads
into an mbarrier ring, wgmma m64n256k16, a producer and two consumer
warpgroups) for bf16 and f16 whose rows TMA can read, and
``csrc/matmul_epilogue.cu`` (mma.sync for bf16 and f16, FMA for f32, any
row pitch) for the rest.  ``_route`` picks between them from dtype, shape
and layout alone, before any launch; every launch counts under
``matmul_epilogue``, the TMA kernel's also under ``matmul_epilogue_sm90``.
Each source's header says what bounds it and how it is designed.  Both
accumulate in f32 and run the bias and the activation on the accumulator
before their one store.  Unlike the JAX wrapper, which falls back to
plain XLA for shapes its grid cannot tile, every shape runs a kernel on
the card (edge tiles are zero-filled or predicated inside them).  The
gradient is plain PyTorch on both devices: it replays the plain version
under autograd, as JAX's ``_mm_bwd`` replays plain jnp.
"""

from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch.static.program import apply

from . import count_launch, use_kernel

__all__ = ["matmul_bias_act", "matmul_bias_act_plain", "ACTIVATIONS"]

_SQRT_HALF = 1.0 / math.sqrt(2.0)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
# activation -> (code of csrc/matmul_act.cuh, f32 formula of the kernels)
ACTIVATIONS = {
    "none": (0, lambda v: v),
    "relu": (1, lambda v: torch.clamp_min(v, 0.0)),
    "gelu": (2, lambda v: 0.5 * v * (1.0 + torch.erf(v * _SQRT_HALF))),
    "gelu_tanh": (3, lambda v: 0.5 * v * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (v + 0.044715 * v * v * v)))),
    "silu": (4, lambda v: v / (1.0 + torch.exp(-v))),
}
_FNS: dict = {}
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # the kernel's dtype codes
# the C entry point of each route: x, w, bias, out, M, N, K, the three row
# pitches, act, then the dtype code (general) or 1 for f16 (sm90), stream
_ENTRIES = {"sm90": ("matmul_epilogue_sm90", "paddle_matmul_epilogue_sm90"),
            "general": ("matmul_epilogue", "paddle_matmul_epilogue")}


def matmul_bias_act_plain(x2d: torch.Tensor, weight: torch.Tensor, bias, activation: str):
    """The kernel's arithmetic in plain PyTorch: f32 product and epilogue,
    one cast to x's dtype."""
    r = x2d.float() @ weight.float()
    if bias is not None:
        r = r + bias.float()
    return ACTIVATIONS[activation][1](r).to(x2d.dtype)


def _fn(route):
    fn = _FNS.get(route)
    if fn is None:
        from ._cuda_build import load

        lib, name = _ENTRIES[route]
        fn = getattr(load(lib), name)
        fn.argtypes = [_PTR] * 4 + [_INT] * 3 + [_LL] * 3 + [_INT] * 2 + [_PTR]
        fn.restype = ctypes.c_int
        _FNS[route] = fn
    return fn


def _row_pitch(t, cols):
    """A 2-d tensor's row pitch in elements (one row: any pitch that holds it)."""
    return max(t.stride(0), cols)


def _route(dtype, m, k, n, x_strides, w_strides, x_ptr, w_ptr) -> str:
    """Which kernel takes ``x [m, k] @ w [k, n]``: ``"sm90"``
    (``csrc/matmul_epilogue_sm90.cu``, TMA and wgmma) for bf16 or f16 when
    x and w have unit column stride, row pitches that are positive
    multiples of 16 bytes and 16-byte aligned bases, k > 0 and n a multiple
    of 8 (the output's rows, allocated here, then meet the same rule); else
    ``"general"`` (``csrc/matmul_epilogue.cu``: f32, any pitch)."""
    if dtype not in (torch.bfloat16, torch.float16) or k <= 0 or n % 8:
        return "general"
    if x_strides[1] != 1 or w_strides[1] != 1:
        return "general"
    lda, ldb = max(x_strides[0], k), max(w_strides[0], n)
    if lda % 8 or ldb % 8 or x_ptr % 16 or w_ptr % 16:
        return "general"
    return "sm90"


def _matmul_cuda(x2d, weight, bias, activation):
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"matmul_bias_act: the kernel takes bf16, f16 or f32, got {x2d.dtype}")
    if weight.dtype != x2d.dtype or (bias is not None and bias.dtype != x2d.dtype):
        raise TypeError("matmul_bias_act: x, weight and bias must share one dtype")
    m, k = x2d.shape
    if weight.dim() != 2 or weight.shape[0] != k:
        raise ValueError(f"matmul_bias_act: x {tuple(x2d.shape)} against weight "
                         f"{tuple(weight.shape)}")
    n = weight.shape[1]
    if bias is not None and (bias.shape != (n,) or not bias.is_contiguous()):
        raise ValueError(f"matmul_bias_act: bias {tuple(bias.shape)} is not a contiguous ({n},)")
    if x2d.stride(1) != 1 or weight.stride(1) != 1:
        raise ValueError("matmul_bias_act: x and weight need unit column stride")
    return _launch(_route(x2d.dtype, m, k, n, x2d.stride(), weight.stride(), x2d.data_ptr(),
                          weight.data_ptr()), x2d, weight, bias, activation)


def _launch(route, x2d, weight, bias, activation):
    """Run ``route``'s kernel on checked inputs (the timing scripts also
    run the general kernel on inputs the sm90 route takes)."""
    (m, k), n = x2d.shape, weight.shape[1]
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    if m == 0 or n == 0:
        return out
    dtype_arg = int(x2d.dtype == torch.float16) if route == "sm90" else _DTYPES[x2d.dtype]
    with torch.cuda.device(x2d.device):
        err = _fn(route)(x2d.data_ptr(), weight.data_ptr(),
                         bias.data_ptr() if bias is not None else None, out.data_ptr(),
                         m, n, k, _row_pitch(x2d, k), _row_pitch(weight, n), n,
                         ACTIVATIONS[activation][0], dtype_arg,
                         torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_bias_act: {route} launch failed with CUDA error {err}")
    if route == "sm90":
        count_launch("matmul_epilogue_sm90")
    count_launch("matmul_epilogue")
    return out


class _MatmulEpilogueFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, bias, activation):
        ctx.save_for_backward(x2d, weight, bias)
        ctx.activation = activation
        if use_kernel(*(t for t in (x2d, weight, bias) if t is not None)):
            return _matmul_cuda(x2d, weight, bias, activation)
        return matmul_bias_act_plain(x2d, weight, bias, activation)

    @staticmethod
    def backward(ctx, g):
        x2d, weight, bias = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (x2d, weight, bias) if t is not None]
        with torch.enable_grad():
            out = matmul_bias_act_plain(inputs[0], inputs[1],
                                        inputs[2] if bias is not None else None,
                                        ctx.activation)
            grads = torch.autograd.grad(out, inputs, g)
        return grads[0], grads[1], (grads[2] if bias is not None else None), None


def _matmul_bias_act(x, weight, bias=None, *, activation):
    shape = x.shape
    out = _MatmulEpilogueFn.apply(x.reshape(-1, shape[-1]), weight, bias, activation)
    return out.reshape(*shape[:-1], weight.shape[1])


def matmul_bias_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                    activation: str = "none") -> torch.Tensor:
    """``act(x @ weight + bias)`` with the epilogue fused into the matmul.

    x: ``[..., K]``; weight: ``[K, N]``; bias: ``[N]`` or None; activation:
    none | relu | gelu | gelu_tanh | silu.  Differentiable in x, weight and
    bias."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; have {sorted(ACTIVATIONS)}")
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply("matmul_epilogue", _matmul_bias_act, *args, activation=activation)
