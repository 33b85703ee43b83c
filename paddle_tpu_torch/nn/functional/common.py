"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
``linear``, ``embedding`` and the dropouts.  Each records as one op while
a static Program is captured, but a dropout in training refuses capture
(static training is ROADMAP.md A.5.2)."""

from __future__ import annotations

import torch

from paddle_tpu_torch._core import random as rng
from paddle_tpu_torch.static.program import apply, in_static_capture

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "feature_alpha_dropout"]


def _linear(x, weight, bias=None):
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None):
    """``x @ W + b`` with ``W: [in, out]`` (Paddle's layout); one ``linear``
    op ``(x, w[, b])``, which the matmul-epilogue pattern anchors on."""
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply("linear", _linear, *args)


def _embedding(ids, weight, *, padding_idx):
    out = weight[ids.long()]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx).unsqueeze(-1),
                          torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out


def embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None, sparse=False):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` read as zero."""
    if sparse:
        raise NotImplementedError(
            "sparse embedding updates are not ported yet (ROADMAP.md A.3.5)")
    return apply("embedding", _embedding, x, weight, padding_idx=padding_idx)


def _scalar(value, v):
    """``value`` as a 0-d tensor of ``v``'s dtype: the JAX package's Python
    scalars are weakly typed, so they round to the operand's dtype first
    (a bf16 tensor is divided by bf16(1 - p), not by 1 - p)."""
    return torch.full((), value, dtype=v.dtype, device=v.device)


def _dropout_infer(x, *, keep):
    return x * _scalar(keep, x)


def _refuse_in_capture(name, why="the JAX package bakes one key into the captured program"):
    if in_static_capture():
        raise NotImplementedError(
            f"{name} in training while a static Program is captured is not ported yet "
            f"(ROADMAP.md A.5.2, static training): {why}")


def _check_p(p):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability {p} is not in [0, 1]")


def _mask_shape(v, axis):
    """The mask's shape: ``v``'s, or 1 on every axis not in ``axis``."""
    if axis is None:
        return tuple(v.shape)
    axes = [a % v.dim() for a in (axis if isinstance(axis, (list, tuple)) else [axis])]
    return tuple(s if i in axes else 1 for i, s in enumerate(v.shape))


def _dropout(v, *, p, axis, mode):
    keep = rng.uniform_like(_mask_shape(v, axis), v.device) < 1.0 - p
    # kept values divided in v's dtype, as the JAX package writes it; the
    # backward of where keeps only the bool mask alive
    kept = v / _scalar(1.0 - p, v) if mode == "upscale_in_train" else v
    return torch.where(keep, kept, _scalar(0.0, v))


def dropout(x: torch.Tensor, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Zero each element with probability ``p`` (``axis``: one draw for each
    index along those axes, broadcast over the rest).  ``upscale_in_train``
    divides the kept values by ``1 - p``; ``downscale_in_infer`` keeps them
    and scales by ``1 - p`` in eval.  Identity in eval or at p == 0.  The
    keep mask is ``u < 1 - p`` of uniforms drawn from the device RNG state
    (``_core/random.py``), which the call advances in place."""
    _check_p(p)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply("dropout_infer", _dropout_infer, x, keep=1.0 - p)
        return x
    _refuse_in_capture("dropout")
    return apply("dropout", _dropout, x, p=float(p), axis=axis, mode=mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Drop whole channels of ``[N, C, H, W]`` (``NHWC``: channel last)."""
    return dropout(x, p, axis=[0, 1 if data_format == "NCHW" else 3], training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    """Drop whole channels of ``[N, C, D, H, W]`` (``NDHWC``: channel last)."""
    return dropout(x, p, axis=[0, 1 if data_format == "NCDHW" else 4], training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_dropout(v, *, p):
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = rng.uniform_like(v.shape, v.device) < 1.0 - p
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * p * alpha_p
    return _scalar(a, v) * torch.where(keep, v, _scalar(alpha_p, v)) + _scalar(b, v)


def alpha_dropout(x: torch.Tensor, p=0.5, training=True):
    """SELU-preserving dropout: dropped values become ``-alpha * scale``,
    then ``a * v + b`` keeps zero mean and unit variance."""
    _check_p(p)
    if not training or p == 0.0:
        return x
    _refuse_in_capture("alpha_dropout")
    return apply("alpha_dropout", _alpha_dropout, x, p=float(p))


def feature_alpha_dropout(x, p=0.5, training=True):
    return alpha_dropout(x, p, training)
