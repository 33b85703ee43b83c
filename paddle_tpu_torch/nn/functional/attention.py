"""Attention functionals (counterpart of paddle_tpu/nn/functional/attention.py)."""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.static.program import apply

from .common import dropout

__all__ = ["scaled_dot_product_attention", "flash_attention"]


def _masked_attention(q, k, v, attn_mask, is_causal, scale):
    """The plain masked path in ``[B, S, N, H]``: f32 scores and softmax.
    A bool mask marks allowed positions; any other mask is added to the
    scores.  Causal is bottom-right aligned when Sq != Sk."""
    qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
    group = qt.shape[1] // kt.shape[1]
    if group > 1:
        kt = kt.repeat_interleave(group, dim=1)
        vt = vt.repeat_interleave(group, dim=1)
    logits = torch.einsum("bnqh,bnkh->bnqk", qt, kt) * scale
    if is_causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        tri = torch.ones((qlen, klen), dtype=torch.bool, device=q.device).tril(klen - qlen)
        logits = logits.masked_fill(~tri, -1e30)
    if attn_mask.dtype == torch.bool:
        logits = logits.masked_fill(~attn_mask, -1e30)
    else:
        logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bnkh->bnqh", probs, vt)
    return out.transpose(1, 2).to(q.dtype)


def _sdpa(query, key, value, attn_mask=None, *, is_causal):
    scale = 1.0 / math.sqrt(query.shape[-1])
    if attn_mask is None:
        from paddle_tpu_torch import ops

        return ops.flash_attention(query, key, value, causal=is_causal, scale=scale)
    return _masked_attention(query, key, value, attn_mask, is_causal, scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True):
    """Inputs are ``[batch, seq, heads, head_dim]`` (Paddle's layout).

    With no mask this is ``ops.flash_attention``: the hand-written kernel
    on the card, its plain version on the CPU.  With a mask it takes the
    plain masked path.  One op while a static Program is captured.
    ``dropout_p`` in training drops elements of the attention's OUTPUT
    (``dropout`` after the op), as the JAX package does, not of the
    probabilities: the flash kernels take no mask."""
    args = (query, key, value) if attn_mask is None else (query, key, value, attn_mask)
    out = apply("scaled_dot_product_attention", _sdpa, *args, is_causal=bool(is_causal))
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=training)
    return out


def flash_attention(query, key, value, dropout=0.0, causal=False, return_softmax=False,
                    fixed_seed_offset=None, rng_name="", training=True):
    """``paddle.nn.functional.flash_attention``: ``(out, None)``, the softmax
    lse's place left empty, as in the JAX package."""
    out = scaled_dot_product_attention(query, key, value, None, dropout, causal, training)
    return out, None
