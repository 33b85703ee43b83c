"""Linear and Embedding (counterpart of paddle_tpu/nn/layer/common.py).

``Linear`` keeps Paddle's weight layout ``[in_features, out_features]``,
so a JAX state dict copies across with no transpose.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Linear", "Embedding"]


def _xavier_normal_(w: torch.Tensor, fan_in: int, fan_out: int, generator=None):
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)


class Linear(nn.Module):
    """``y = x @ W`` with ``W: [in_features, out_features]`` (no bias: the
    LLaMA projections have none)."""

    def __init__(self, in_features, out_features, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty((in_features, out_features),
                                               device=device, dtype=dtype))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Xavier-normal weight, the JAX package's default."""
        _xavier_normal_(self.weight, self.in_features, self.out_features, generator)

    def forward(self, x):
        return torch.matmul(x, self.weight)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    """Token lookup table ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty((num_embeddings, embedding_dim),
                                               device=device, dtype=dtype))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        _xavier_normal_(self.weight, self.num_embeddings, self.embedding_dim, generator)

    def forward(self, ids):
        return self.weight[ids.long()]
