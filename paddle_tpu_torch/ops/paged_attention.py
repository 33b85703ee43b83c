"""Paged-KV (block) attention for serving, in plain PyTorch.

Counterpart of paddle_tpu/ops/paged_attention.py, which is plain jnp (no
Pallas kernel): the KV cache is one ``[num_blocks, Nkv, block_size, H]``
pool per K and V; each sequence owns a block table mapping its logical
positions onto pool blocks.  Only bf16/f32 pools are ported; the int8
``QuantPool`` is ROADMAP queue A item 3.

The JAX functions are pure and return new pools.  Here the writes update
the pool in place (no second pool-sized buffer per write) and return the
same tensor, so callers read the same as in the JAX package.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "alloc_paged_cache",
    "paged_write",
    "paged_write_chunk",
    "paged_pour_blocks",
    "paged_gather",
    "gathered_attention",
    "paged_decode_attention",
    "paged_chunk_attention",
    "rope_rotate_chunk",
    "rope_rotate_by_position",
]


def alloc_paged_cache(num_blocks, num_kv_heads, block_size, head_dim,
                      dtype=torch.bfloat16, device=None):
    """One K and one V pool: ``[num_blocks, Nkv, block_size, H]``."""
    if dtype in ("int8", torch.int8):
        raise NotImplementedError(
            "int8 paged pools are not ported yet (ROADMAP.md queue A item 3)")
    shape = (num_blocks, num_kv_heads, block_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def paged_write_chunk(cache, new, block_tables, positions):
    """Write T tokens per sequence into their pages, in place.

    cache ``[num_blocks, Nkv, bs, H]``; new ``[B, T, Nkv, H]``; block_tables
    ``[B, max_blocks]``; positions ``[B, T]`` (token index within each
    sequence).  Returns the updated cache."""
    bs = cache.shape[2]
    positions = positions.long()
    block_idx = torch.gather(block_tables.long(), 1, positions // bs)  # [B, T]
    slot = positions % bs
    # advanced indices on dims 0 and 2 put the broadcast [B, T] in front:
    # the indexed view is [B, T, Nkv, H], the shape of `new`
    cache[block_idx, :, slot, :] = new.to(cache.dtype)
    return cache


def paged_write(cache, new, block_tables, positions):
    """Write one token per sequence: new ``[B, Nkv, H]``, positions ``[B]``."""
    return paged_write_chunk(cache, new[:, None], block_tables, positions[:, None])


def paged_gather(cache, block_tables):
    """Each sequence's logical cache view: ``[B, Nkv, max_blocks * bs, H]``."""
    pages = cache[block_tables.long()]  # [B, mb, Nkv, bs, H]
    b, mb, nkv, bs, h = pages.shape
    return pages.transpose(1, 2).reshape(b, nkv, mb * bs, h)


def gathered_attention(q, keys, vals, seq_lens, *, scale=None):
    """Masked-softmax attention over gathered views: q ``[B, T, N, H]``;
    keys/vals ``[B, Nkv, S, H]``; seq_lens ``[B]`` including all T chunk
    tokens.  Chunk token j sits at position seq_lens - T + j and attends
    keys at or before it.  f32 inside, cast to q's dtype."""
    b, t, n, h = q.shape
    nkv = keys.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(h)
    if n != nkv:
        keys = keys.repeat_interleave(n // nkv, dim=1)
        vals = vals.repeat_interleave(n // nkv, dim=1)
    logits = torch.einsum("btnh,bnsh->bnts", q.float(), keys.float()) * scale
    span = torch.arange(logits.shape[-1], device=q.device)
    qpos = (seq_lens.long()[:, None] - t
            + torch.arange(t, device=q.device)[None, :])  # [B, T]
    allowed = span[None, None, None, :] <= qpos[:, None, :, None]
    logits = logits.masked_fill(~allowed, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnts,bnsh->btnh", probs, vals.float())
    return out.to(q.dtype)


def paged_chunk_attention(q, key_cache, value_cache, block_tables, seq_lens, *, scale=None):
    """Multi-token attention over the paged cache: q ``[B, T, N, H]``;
    returns ``[B, T, N, H]``."""
    keys = paged_gather(key_cache, block_tables)
    vals = paged_gather(value_cache, block_tables)
    return gathered_attention(q, keys, vals, seq_lens, scale=scale)


def paged_decode_attention(q, key_cache, value_cache, block_tables, seq_lens, *, scale=None):
    """Single-token decode attention: q ``[B, N, H]``; returns ``[B, N, H]``."""
    return paged_chunk_attention(q[:, None], key_cache, value_cache, block_tables,
                                 seq_lens, scale=scale)[:, 0]


def paged_pour_blocks(cache, kv, block_ids):
    """Pour whole blocks ``kv [n, Nkv, bs, H]`` into the pool at
    ``block_ids``, in place."""
    idx = torch.as_tensor(block_ids, dtype=torch.long, device=cache.device)
    cache[idx] = kv.to(cache.dtype)
    return cache


def rope_rotate_chunk(t, cos, sin, positions):
    """Interleaved-pair rotation of ``t [B, T, N, H]`` at ``positions
    [B, T]`` from ``cos``/``sin`` tables ``[max_len, H/2]``; f32 inside."""
    b, tt, n, h = t.shape
    positions = positions.long()
    c = cos[positions][:, :, None, :]  # [B, T, 1, H/2]
    s = sin[positions][:, :, None, :]
    t2 = t.float().reshape(b, tt, n, h // 2, 2)
    r1 = t2[..., 0] * c - t2[..., 1] * s
    r2 = t2[..., 1] * c + t2[..., 0] * s
    return torch.stack([r1, r2], -1).reshape(b, tt, n, h).to(t.dtype)


def rope_rotate_by_position(t, cos, sin, positions):
    """The T = 1 case: ``t [B, N, H]``, ``positions [B]``."""
    return rope_rotate_chunk(t[:, None], cos, sin, positions[:, None])[:, 0]
