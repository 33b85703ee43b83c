"""RMSNorm and LayerNorm (counterpart of paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import functional as F

__all__ = ["RMSNorm", "LayerNorm"]


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

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"
