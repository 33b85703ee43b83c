"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
``linear``, ``embedding`` and the dropouts.  Each records as one op while
a static Program is captured.  A dropout in training records its draw
from the program's RNG state var (``Program.rng_state``) and hands the
advanced state back as a program write, so each run of the program draws
fresh masks, the same bits as the eager dropout from the same state (the
JAX package bakes one key into the program instead; ROADMAP.md §C)."""

from __future__ import annotations

import torch

from paddle_tpu_torch._core import random as rng
from paddle_tpu_torch.static.program import apply, current_main_program, in_static_capture

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


def _refuse_in_capture(name, why):
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


def _drop(v, u, p, mode):
    keep = u < 1.0 - p
    # kept values divided in v's dtype, as the JAX package writes it; the
    # backward of where keeps only the bool mask alive
    kept = v / _scalar(1.0 - p, v) if mode == "upscale_in_train" else v
    return torch.where(keep, kept, _scalar(0.0, v))


def _dropout(v, *, p, axis, mode):
    return _drop(v, rng.uniform_like(_mask_shape(v, axis), v.device), p, mode)


def _dropout_from(v, state, *, p, axis, mode):
    """``_dropout`` drawing from a given RNG state: (out, advanced state)."""
    u, new_state = rng.uniform_from(state, _mask_shape(v, axis))
    return _drop(v, u, p, mode), new_state


def _random_op(type_, eager, from_state, x, **kwargs):
    """A random op: eagerly ``eager`` draws from the device state;
    captured, ``from_state`` reads the program's RNG state var and the
    state it returns becomes the program's write."""
    if in_static_capture():
        prog = current_main_program()
        out, new_state = apply(type_, from_state, x, prog.rng_state(), **kwargs)
        prog.advance_rng(new_state)
        return out
    return apply(type_, eager, x, **kwargs)


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
    return _random_op("dropout", _dropout, _dropout_from, x, p=float(p), axis=axis, mode=mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Drop whole channels of ``[N, C, H, W]`` (``NHWC``: channel last)."""
    return dropout(x, p, axis=[0, 1 if data_format == "NCHW" else 3], training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    """Drop whole channels of ``[N, C, D, H, W]`` (``NDHWC``: channel last)."""
    return dropout(x, p, axis=[0, 1 if data_format == "NCDHW" else 4], training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_drop(v, u, p):
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = u < 1.0 - p
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * p * alpha_p
    return _scalar(a, v) * torch.where(keep, v, _scalar(alpha_p, v)) + _scalar(b, v)


def _alpha_dropout(v, *, p):
    return _alpha_drop(v, rng.uniform_like(v.shape, v.device), p)


def _alpha_dropout_from(v, state, *, p):
    u, new_state = rng.uniform_from(state, v.shape)
    return _alpha_drop(v, u, p), new_state



def alpha_dropout(x: torch.Tensor, p=0.5, training=True):
    """SELU-preserving dropout: dropped values become ``-alpha * scale``,
    then ``a * v + b`` keeps zero mean and unit variance."""
    _check_p(p)
    if not training or p == 0.0:
        return x
    return _random_op("alpha_dropout", _alpha_dropout, _alpha_dropout_from, x, p=float(p))


def feature_alpha_dropout(x, p=0.5, training=True):
    return alpha_dropout(x, p, training)
