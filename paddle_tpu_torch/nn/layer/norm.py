"""RMSNorm, LayerNorm and BatchNorm (counterpart of paddle_tpu/nn/layer/norm.py).

BatchNorm keeps the JAX package's buffers, f32 ``_mean`` (zeros) and
``_variance`` (ones), with no ``num_batches_tracked``: ``torch.nn.BatchNorm2d``
is no stand-in (its momentum weighs the batch, its running variance is
unbiased, and it adds that buffer).  ``SyncBatchNorm`` waits for
ROADMAP.md A.6."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import functional as F

from .layers import set_param_attr

__all__ = ["RMSNorm", "LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D"]


class RMSNorm(nn.Module):
    """LLaMA-family RMS norm through ``ops.fused_rms_norm``: the kernel on
    the card, its plain version on the CPU."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones((hidden_size,), device=device, dtype=dtype))

    def forward(self, x):
        return ops.fused_rms_norm(x, self.weight, epsilon=self._epsilon)

    def add_norm(self, x, residual):
        """``(norm(x + residual), x + residual)`` in one ``fused_rms_norm``
        launch: the sum is rounded to the dtype before the norm, as a
        separate add rounds it, so the result equals add-then-norm bit for
        bit."""
        return ops.fused_rms_norm(x, self.weight, epsilon=self._epsilon, residual=residual)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes, weight ones
    and bias zeros at first.  Eager it is plain arithmetic
    (``nn.functional.layer_norm``), as in the JAX package; a static
    Program's AddNorm pattern puts it on the fused kernel."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None, bias_attr=None, *,
                 device=None, dtype=None):
        super().__init__()
        self._normalized_shape = ([normalized_shape] if isinstance(normalized_shape, int)
                                  else list(normalized_shape))
        self._epsilon = epsilon
        shape = tuple(self._normalized_shape)
        self.weight = (nn.Parameter(torch.ones(shape, device=device, dtype=dtype))
                       if weight_attr is not False else None)
        self.bias = (nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))
                     if bias_attr is not False else None)
        for param, attr in ((self.weight, weight_attr), (self.bias, bias_attr)):
            if param is not None:
                set_param_attr(param, attr)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class _BatchNormBase(nn.Module):
    """Batch norm over the channel axis of ``data_format`` (``nn.functional
    .batch_norm``): the weight starts at ones, the bias at zeros, the
    running statistics update in place in training."""

    _format = "NCHW"

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format=None, use_global_stats=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format or self._format
        self._use_global_stats = use_global_stats
        self.weight = (nn.Parameter(torch.ones((num_features,), device=device, dtype=dtype))
                       if weight_attr is not False else None)
        self.bias = (nn.Parameter(torch.zeros((num_features,), device=device, dtype=dtype))
                     if bias_attr is not False else None)
        for param, attr in ((self.weight, weight_attr), (self.bias, bias_attr)):
            if param is not None:
                set_param_attr(param, attr)
        self.register_buffer("_mean", torch.zeros((num_features,), device=device,
                                                  dtype=torch.float32))
        self.register_buffer("_variance", torch.ones((num_features,), device=device,
                                                     dtype=torch.float32))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    _format = "NCL"


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    _format = "NCDHW"
