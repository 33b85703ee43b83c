"""The matmul epilogue: ``act(x @ W + b)`` as one CUDA C++ kernel for
Hopper beside its plain version, joined by a ``torch.autograd.Function``.

Counterpart of paddle_tpu/ops/matmul_epilogue.py; the kernel
(``csrc/matmul_epilogue.cu``, whose header says what bounds it and how it
is designed) replaces the TPU kernel ``_kernel``.  It accumulates in f32
and runs the bias and the activation on the accumulator before its one
store.  Unlike the JAX wrapper, which falls back to plain XLA for shapes
its grid cannot tile, every shape runs the kernel on the card (edge tiles
are predicated inside it).  The gradient is plain PyTorch on both devices:
it replays the plain version under autograd, as JAX's ``_mm_bwd`` replays
plain jnp.
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
# activation -> (code of csrc/matmul_epilogue.cu, f32 formula of the kernel)
ACTIVATIONS = {
    "none": (0, lambda v: v),
    "relu": (1, lambda v: torch.clamp_min(v, 0.0)),
    "gelu": (2, lambda v: 0.5 * v * (1.0 + torch.erf(v * _SQRT_HALF))),
    "gelu_tanh": (3, lambda v: 0.5 * v * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (v + 0.044715 * v * v * v)))),
    "silu": (4, lambda v: v / (1.0 + torch.exp(-v))),
}
_FN = None
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # the kernel's dtype codes


def matmul_bias_act_plain(x2d: torch.Tensor, weight: torch.Tensor, bias, activation: str):
    """The kernel's arithmetic in plain PyTorch: f32 product and epilogue,
    one cast to x's dtype."""
    r = x2d.float() @ weight.float()
    if bias is not None:
        r = r + bias.float()
    return ACTIVATIONS[activation][1](r).to(x2d.dtype)


def _fn():
    global _FN
    if _FN is None:
        from ._cuda_build import load

        fn = load("matmul_epilogue").paddle_matmul_epilogue
        fn.argtypes = [_PTR] * 4 + [_INT] * 3 + [_LL] * 3 + [_INT] * 2 + [_PTR]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(x2d.device):
        err = _fn()(x2d.data_ptr(), weight.data_ptr(),
                    bias.data_ptr() if bias is not None else None, out.data_ptr(),
                    m, n, k, max(x2d.stride(0), k), max(weight.stride(0), n), n,
                    ACTIVATIONS[activation][0], _DTYPES[x2d.dtype],
                    torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_bias_act: launch failed with CUDA error {err}")
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
