"""Norm functionals (counterpart of paddle_tpu/nn/functional/norm.py).

Plain arithmetic with f32 statistics and one cast back; each records as
one op (with its epsilon, which the AddNorm pattern reads) while a static
Program is captured."""

from __future__ import annotations

import torch

from paddle_tpu_torch.static.program import apply

__all__ = ["rms_norm", "layer_norm"]


def _rms_norm(x, weight=None, *, epsilon):
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with the kernel's arithmetic: f32
    statistics, the weight cast to f32, one cast back to x's dtype."""
    args = (x,) if weight is None else (x, weight)
    return apply("rms_norm", _rms_norm, *args, epsilon=float(epsilon))


def _layer_norm(x, *params, nd, has_weight, has_bias, epsilon):
    axes = tuple(range(x.dim() - nd, x.dim()))
    xf = x.float()
    xc = xf - xf.mean(dim=axes, keepdim=True)
    out = xc * torch.rsqrt((xc * xc).mean(dim=axes, keepdim=True) + epsilon)
    it = iter(params)
    if has_weight:
        out = out * next(it).float()
    if has_bias:
        out = out + next(it).float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, normalized_shape, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, epsilon: float = 1e-05) -> torch.Tensor:
    """LayerNorm over the trailing ``normalized_shape`` axes: f32 mean and
    variance, weight and bias in f32, one cast back to x's dtype."""
    ns = normalized_shape if isinstance(normalized_shape, (list, tuple)) else [normalized_shape]
    params = [t for t in (weight, bias) if t is not None]
    return apply("layer_norm", _layer_norm, x, *params, nd=len(ns),
                 has_weight=weight is not None, has_bias=bias is not None,
                 epsilon=float(epsilon))
