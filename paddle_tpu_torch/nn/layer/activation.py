"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py):
those whose functionals the port has.  The rest are ROADMAP.md A.7."""

from __future__ import annotations

from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["ReLU", "GELU", "Silu", "Tanh"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Silu(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


class Tanh(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)
