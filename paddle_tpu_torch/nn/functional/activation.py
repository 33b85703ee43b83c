"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""

from __future__ import annotations

import torch

__all__ = ["silu"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, computed in f32 and cast back once."""
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)
