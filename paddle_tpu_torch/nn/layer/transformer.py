"""Transformer encoder layers (counterpart of
paddle_tpu/nn/layer/transformer.py:25-125).

``MultiHeadAttention`` computes through ``scaled_dot_product_attention``
in Paddle's ``[batch, seq, heads, head_dim]`` layout: with a mask that is
the plain masked path (the JAX package runs XLA there, no Pallas kernel),
without one the flash kernel.  The decoder layers are not ported yet.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F

from .common import Dropout, Linear
from .layers import copy_param_attrs
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        if need_weights:
            raise NotImplementedError("MultiHeadAttention(need_weights=True) is not ported")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)

    def _shape(self, t):
        b, s, _ = t.shape
        return t.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None,
                is_causal=False):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             dropout_p=self.dropout, is_causal=is_causal,
                                             training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out


class TransformerEncoderLayer(nn.Module):
    """Post-LN (``normalize_before=False``, BERT's) or pre-LN encoder layer:
    self-attention and a two-linear feed-forward, each in a residual."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.normalize_before = normalize_before
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(act_dropout if act_dropout is not None else dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` deep copies of ``encoder_layer`` (so every layer
    starts from the same weights, as in the JAX package), then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        copies = [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)]
        for layer in copies:
            copy_param_attrs(encoder_layer, layer)
        self.layers = nn.ModuleList([encoder_layer] + copies)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
