"""Activations (counterpart of paddle_tpu/nn/functional/activation.py).

Each computes in f32 and casts back once, and records as one op while a
static Program is captured (``static.program.apply``)."""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.static.program import apply

__all__ = ["silu", "gelu", "relu", "tanh"]

_SQRT_HALF = 1.0 / math.sqrt(2.0)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _silu(x):
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def _gelu(x, approximate=False):
    v = x.float()
    if approximate:
        out = 0.5 * v * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (v + 0.044715 * v * v * v)))
    else:
        out = 0.5 * v * (1.0 + torch.erf(v * _SQRT_HALF))
    return out.to(x.dtype)


def _relu(x):
    return torch.clamp_min(x, 0)


def _tanh(x):
    return torch.tanh(x.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, computed in f32 and cast back once."""
    return apply("silu", _silu, x)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU: exact (erf) by default, the tanh form with ``approximate=True``
    (Paddle's bool; recorded on the op, where the epilogue pattern reads it)."""
    return apply("gelu", _gelu, x, approximate=bool(approximate))


def relu(x: torch.Tensor) -> torch.Tensor:
    return apply("relu", _relu, x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return apply("tanh", _tanh, x)
