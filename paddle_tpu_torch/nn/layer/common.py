"""Linear, Embedding and Dropout (counterpart of paddle_tpu/nn/layer/common.py).

``Linear`` keeps Paddle's weight layout ``[in_features, out_features]``,
so a JAX state dict copies across with no transpose.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


def _xavier_normal_(w: torch.Tensor, fan_in: int, fan_out: int, generator=None):
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


def _check_attr(name, attr):
    if attr is not None and attr is not False:
        raise NotImplementedError(
            f"{name}: ParamAttr objects are not ported yet (ROADMAP.md queue A item 2.6); "
            "pass None or False")


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W: [in_features, out_features]``.  The bias
    is on by default, as in Paddle; ``bias_attr=False`` leaves it out (the
    LLaMA projections have none)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        _check_attr("Linear", weight_attr)
        _check_attr("Linear", bias_attr)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty((in_features, out_features),
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.empty((out_features,), device=device, dtype=dtype))
                     if bias_attr is not False else None)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Xavier-normal weight and zero bias, the JAX package's defaults."""
        _xavier_normal_(self.weight, self.in_features, self.out_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Embedding(nn.Module):
    """Token lookup table ``[num_embeddings, embedding_dim]``; the row at
    ``padding_idx`` starts at zero and always reads as zero."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True) is not ported yet (ROADMAP.md queue A item 2.7)")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = (None if padding_idx is None else
                            padding_idx if padding_idx >= 0 else num_embeddings + padding_idx)
        self.weight = nn.Parameter(torch.empty((num_embeddings, embedding_dim),
                                               device=device, dtype=dtype))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        _xavier_normal_(self.weight, self.num_embeddings, self.embedding_dim, generator)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx].zero_()

    def forward(self, ids):
        return F.embedding(ids, self.weight, padding_idx=self.padding_idx)


class Dropout(nn.Module):
    """Dropout; the identity in eval mode.  Training with p > 0 raises (not
    ported yet)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}, mode={self.mode}"
