"""RMSNorm (counterpart of paddle_tpu/nn/layer/norm.py)."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch import ops

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    """LLaMA-family RMS norm through ``ops.fused_rms_norm``: the kernel on
    the card, its plain version on the CPU."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones((hidden_size,), device=device, dtype=dtype))

    def forward(self, x):
        return ops.fused_rms_norm(x, self.weight, epsilon=self._epsilon)
