"""Norm functionals (counterpart of paddle_tpu/nn/functional/norm.py)."""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with the kernel's arithmetic: f32
    statistics, the weight cast to f32, one cast back to x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)
