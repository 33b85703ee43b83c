"""Pooling layers (counterpart of paddle_tpu/nn/layer/pooling.py), each
over its functional in ``nn/functional/pooling.py``.  ``LPPool*`` and
``MaxUnPool*`` are not ported yet (ROADMAP.md A.4)."""

from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D"]


class _Pool(nn.Module):
    _fn = None
    _format = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, name=None,
                 data_format=None, **kw):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format or self._format
        self._kw = kw  # return_mask (max), exclusive and divisor_override (avg)

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride, self.padding,
                              ceil_mode=self.ceil_mode, data_format=self.data_format, **self._kw)

    def extra_repr(self):
        return f"kernel_size={self.kernel_size}, stride={self.stride}, padding={self.padding}"


class MaxPool1D(_Pool):
    _fn, _format = F.max_pool1d, "NCL"


class MaxPool2D(_Pool):
    _fn = F.max_pool2d


class MaxPool3D(_Pool):
    _fn, _format = F.max_pool3d, "NCDHW"


class AvgPool1D(_Pool):
    _fn, _format = F.avg_pool1d, "NCL"


class AvgPool2D(_Pool):
    _fn = F.avg_pool2d


class AvgPool3D(_Pool):
    _fn, _format = F.avg_pool3d, "NCDHW"


class _AdaptivePool(nn.Module):
    _fn = None

    def __init__(self, output_size, return_mask=False, name=None, **kw):
        super().__init__()
        self.output_size = output_size
        self._kw = dict(kw, return_mask=True) if return_mask else kw

    def forward(self, x):
        return type(self)._fn(x, self.output_size, **self._kw)

    def extra_repr(self):
        return f"output_size={self.output_size}"


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = F.adaptive_avg_pool1d


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = F.adaptive_avg_pool2d


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = F.adaptive_avg_pool3d


class AdaptiveMaxPool1D(_AdaptivePool):
    _fn = F.adaptive_max_pool1d


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = F.adaptive_max_pool2d


class AdaptiveMaxPool3D(_AdaptivePool):
    _fn = F.adaptive_max_pool3d
