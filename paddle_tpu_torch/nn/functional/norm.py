"""Norm functionals (counterpart of paddle_tpu/nn/functional/norm.py).

Plain arithmetic with f32 statistics and one cast back; each records as
one op (with its epsilon, which the AddNorm pattern reads) while a static
Program is captured.  ``batch_norm`` in training writes the running
statistics in place, so a step recorded as a CUDA graph writes them at
every replay; it refuses a static capture (ROADMAP.md A.5.2), as
dropout does."""

from __future__ import annotations

import torch

from paddle_tpu_torch.static.program import apply

from .common import _refuse_in_capture

__all__ = ["rms_norm", "layer_norm", "batch_norm"]


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


def _batch_norm(x, mean, var, *params, ch_axis, batch_stats, has_weight, has_bias, epsilon):
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    dt = torch.promote_types(x.dtype, torch.float32)  # f32 at least
    xf = x.to(dt)
    if batch_stats:
        axes = tuple(d for d in range(x.dim()) if d != ch_axis)
        mean = xf.mean(dim=axes)
        xc = xf - mean.reshape(shape)
        var = (xc * xc).mean(dim=axes)  # biased, as jnp.var
    else:
        xc = xf - mean.to(dt).reshape(shape)
    out = xc * torch.rsqrt(var.to(dt).reshape(shape) + epsilon)
    it = iter(params)
    if has_weight:
        out = out * next(it).to(dt).reshape(shape)
    if has_bias:
        out = out + next(it).to(dt).reshape(shape)
    out = out.to(x.dtype)
    return (out, mean, var) if batch_stats else out


def _channel_axis(x, data_format):
    channel_last = data_format in ("NLC", "NHWC", "NDHWC") or (
        data_format[-1] == "C" and len(data_format) > 2)
    return x.dim() - 1 if channel_last else (1 if x.dim() > 1 else 0)


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
               weight=None, bias=None, training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None) -> torch.Tensor:
    """Batch norm over every axis but the channel's, with the JAX package's
    arithmetic: statistics in f32 (f64 for f64 inputs), the biased variance, ``(x - mean) *
    rsqrt(var + eps) * w + b``, one cast back to x's dtype.  In training
    (and not ``use_global_stats``) the statistics are the batch's, and the
    running ones become ``running * momentum + batch * (1 - momentum)``,
    written in place (``copy_``, never rebound); otherwise the running
    statistics normalise."""
    batch_stats = bool(training) and not use_global_stats
    params = [t for t in (weight, bias) if t is not None]
    kw = dict(ch_axis=_channel_axis(x, data_format), batch_stats=batch_stats,
              has_weight=weight is not None, has_bias=bias is not None,
              epsilon=float(epsilon))
    if not batch_stats:
        return apply("batch_norm", _batch_norm, x, running_mean, running_var, *params, **kw)
    _refuse_in_capture("batch_norm", "the running statistics are state the program writes")
    out, mean, var = apply("batch_norm", _batch_norm, x, running_mean, running_var, *params,
                           **kw)
    with torch.no_grad():
        for running, batch in ((running_mean, mean), (running_var, var)):
            running.copy_(running * momentum + batch * (1.0 - momentum))
    return out
