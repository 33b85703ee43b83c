"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py).

The JAX package convolves with ``lax.conv_general_dilated``, outside any
Pallas kernel, so here a convolution is ``torch.nn.functional.conv{1,2,3}d``
(cuDNN on the card).  Each call is one ``conv`` op through
``static.program.apply``, which AMP's white list casts to the low dtype
and a captured Program records.

Every padding form of the JAX package is taken: an int, one value a
spatial dimension, ``(lo, hi)`` pairs, a flat ``2n`` list of ``lo, hi``
pairs, and the strings ``"SAME"`` and ``"VALID"``.  ``"SAME"`` is XLA's,
asymmetric where the total is odd (the extra row at the end) and at any
stride.  Symmetric padding goes to torch's convolution; asymmetric
padding is an explicit zero ``F.pad`` first.  Channel-last layouts
(``NLC``, ``NHWC``, ``NDHWC``) are permuted to channel-first and back.
The bias is added after the convolution, in its output's dtype, as the
JAX package adds it.  ``conv_transpose`` is not ported yet (ROADMAP.md
A.4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.static.program import apply

__all__ = ["conv1d", "conv2d", "conv3d"]

_CONVS = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(i) for i in v)
    return tuple(int(v) for _ in range(n))


def _padding(padding, n):
    """The JAX package's padding spec: ``"SAME"`` / ``"VALID"``, or one
    ``(lo, hi)`` pair a spatial dimension."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        if isinstance(padding[0], (list, tuple)):
            return [tuple(int(q) for q in p) for p in padding]
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1])) for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def same_pads(sizes, kernel, strides, dilations):
    """XLA's ``SAME``: ``ceil(size / stride)`` outputs, the padding split
    with the odd row at the end."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilations):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_arg(pads):
    """``F.pad``'s argument for one ``(lo, hi)`` pair a spatial dimension:
    the last dimension first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _conv(x, weight, *bias, strides, pads, dilations, groups, channel_last):
    nd = weight.dim() - 2
    if channel_last:
        x = x.movedim(-1, 1)
    if isinstance(pads, str):  # VALID
        padding = 0
    elif all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        x = TF.pad(x, pad_arg(pads))
        padding = 0
    out = _CONVS[nd](x, weight, None, strides, padding, dilations, groups)
    if bias:
        shape = [1] * out.dim()
        shape[1] = bias[0].shape[0]
        out = out + bias[0].reshape(shape)
    return out.movedim(1, -1) if channel_last else out


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd, data_format):
    strides = _tuple(stride, nd)
    dilations = _tuple(dilation, nd)
    channel_last = data_format[-1] == "C"
    pads = _padding(padding, nd)
    if pads == "SAME":
        sizes = x.shape[1:1 + nd] if channel_last else x.shape[2:2 + nd]
        pads = same_pads(sizes, weight.shape[2:], strides, dilations)
    elif isinstance(pads, str) and pads != "VALID":
        raise ValueError(f"bad padding {padding}")
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply("conv", _conv, *args, strides=strides, pads=pads, dilations=dilations,
                 groups=int(groups), channel_last=channel_last)


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCL", name=None):
    """1-D convolution; ``weight`` is ``[out, in / groups, k]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1, data_format)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCHW", name=None):
    """2-D convolution; ``weight`` is ``[out, in / groups, kh, kw]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2, data_format)


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCDHW", name=None):
    """3-D convolution; ``weight`` is ``[out, in / groups, kd, kh, kw]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3, data_format)
