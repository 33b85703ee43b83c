"""Conv1D, Conv2D and Conv3D (counterpart of paddle_tpu/nn/layer/conv.py).

The weight is ``[out, in / groups, *kernel]``, torch's layout too, so a
JAX state dict copies across with no transpose.  Its default initializer
is the JAX package's KaimingUniform over ``fan_in = in / groups *
prod(kernel)`` (bound ``sqrt(6 / fan_in)``), drawn from the caller's
``generator``; the bias starts at zero and ``bias_attr=False`` leaves it
out.  ``Conv*DTranspose`` is not ported yet (ROADMAP.md A.4).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

from .layers import set_param_attr

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


def _ntuple(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class _ConvNd(nn.Module):
    _nd = 2
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", *, device=None, dtype=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: the JAX package pads with zeros only")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, self._nd)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        shape = [out_channels, in_channels // groups] + self._kernel_size
        self.weight = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty((out_channels,), device=device, dtype=dtype))
                     if bias_attr is not False else None)
        self.reset_parameters(generator)
        set_param_attr(self.weight, weight_attr)
        if self.bias is not None:
            set_param_attr(self.bias, bias_attr)

    def reset_parameters(self, generator=None):
        """KaimingUniform over fan_in (ReLU's gain) and a zero bias."""
        fan_in = self._in_channels // self._groups * math.prod(self._kernel_size)
        limit = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride, self._padding, self._dilation,
                        self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size={self._kernel_size}, "
                f"stride={self._stride}, padding={self._padding}")


class Conv1D(_ConvNd):
    _nd = 1
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCL", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, **kw)


class Conv2D(_ConvNd):
    pass


class Conv3D(_ConvNd):
    _nd = 3
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCDHW", **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, **kw)
