"""Common functionals (counterpart of paddle_tpu/nn/functional/common.py):
``linear``, ``embedding`` and ``dropout``.  Each records as one op while a
static Program is captured."""

from __future__ import annotations

import torch

from paddle_tpu_torch.static.program import apply

__all__ = ["linear", "embedding", "dropout"]


def _linear(x, weight, bias=None):
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None):
    """``x @ W + b`` with ``W: [in, out]`` (Paddle's layout); one ``linear``
    op ``(x, w[, b])``, which the matmul-epilogue pattern anchors on."""
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply("linear", _linear, *args)


def _embedding(ids, weight, *, padding_idx):
    out = weight[ids.long()]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx).unsqueeze(-1),
                          torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out


def embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None, sparse=False):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` read as zero."""
    if sparse:
        raise NotImplementedError(
            "sparse embedding updates are not ported yet (ROADMAP.md queue A item 2.7)")
    return apply("embedding", _embedding, x, weight, padding_idx=padding_idx)


def _dropout_infer(x, *, keep):
    return x * keep


def dropout(x: torch.Tensor, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Identity in eval mode or at p == 0 (``downscale_in_infer`` scales by
    ``1 - p`` in eval).  Training with p > 0 is not ported."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply("dropout_infer", _dropout_infer, x, keep=1.0 - p)
        return x
    raise NotImplementedError(
        "dropout in training (p > 0) is not ported yet (ROADMAP.md queue A item 2.3)")
