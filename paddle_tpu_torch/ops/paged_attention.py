"""Paged-KV (block) attention for serving, in plain PyTorch.

Counterpart of paddle_tpu/ops/paged_attention.py, which is plain jnp (no
Pallas kernel): the KV cache is one ``[num_blocks, Nkv, block_size, H]``
pool per K and V; each sequence owns a block table mapping its logical
positions onto pool blocks.  A pool holds the model's dtype, or is a
``QuantPool``: int8 payload plus one f32 scale per (block, kv head),
running-max on decode writes, set fresh by a pour.

The JAX functions are pure and return new pools.  Here the writes update
the pool in place (no second pool-sized buffer per write) and return the
same pool, so callers read the same as in the JAX package.  The int8
arithmetic is the JAX package's step for step (f32 division, round half
to even, clip to +-127), so both packages write the same bytes.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "QuantPool",
    "alloc_paged_cache",
    "paged_write",
    "paged_write_chunk",
    "paged_pour_blocks",
    "paged_gather",
    "gathered_attention",
    "paged_decode_attention",
    "paged_chunk_attention",
    "pool_nbytes",
    "rope_rotate_chunk",
    "rope_rotate_by_position",
]


_QMAX = 127.0  # symmetric int8 range; -128 is never produced
_EPS = 1e-12


class QuantPool:
    """Int8-quantized paged pool: ``data`` int8 ``[num_blocks, Nkv, bs, H]``
    plus per-block-per-head ``scale`` f32 ``[num_blocks, Nkv]``.

    A stored element decodes as ``data * scale``.  Scales are running
    maxima per (block, head): a decode write whose amax exceeds the block's
    scale grows it and rescales the block's resident payload against it,
    so every resident token stays decodable with the one scale.  Both
    tensors are updated in place."""

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    @property
    def device(self):
        return self.data.device

    def clone(self):
        return QuantPool(self.data.clone(), self.scale.clone())


def _payload(cache):
    """The pool's payload tensor (a QuantPool's int8 data)."""
    return cache.data if isinstance(cache, QuantPool) else cache


def pool_nbytes(cache):
    """Resident bytes of a paged pool (payload plus scales for a QuantPool)."""
    if isinstance(cache, QuantPool):
        return (cache.data.numel() * cache.data.element_size()
                + cache.scale.numel() * cache.scale.element_size())
    return cache.numel() * cache.element_size()


def alloc_paged_cache(num_blocks, num_kv_heads, block_size, head_dim,
                      dtype=torch.bfloat16, device=None):
    """One K and one V pool: ``[num_blocks, Nkv, block_size, H]``.

    dtype ``"int8"`` (or ``torch.int8``) allocates a pair of QuantPools."""
    shape = (num_blocks, num_kv_heads, block_size, head_dim)
    if dtype in ("int8", torch.int8):
        return tuple(QuantPool(torch.zeros(shape, dtype=torch.int8, device=device),
                               torch.zeros(shape[:2], dtype=torch.float32, device=device))
                     for _ in range(2))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _amax_scale(af, dims):
    """The amax of ``af`` over ``dims`` over 127, divided by a tensor on
    ``af``'s device: torch's CUDA division by a Python scalar multiplies by
    its reciprocal, which is not the IEEE quotient the kernels and the JAX
    package compute."""
    return af.abs().amax(dim=dims) / af.new_tensor(_QMAX)


def _quantize(af, safe):
    """``clip(round(af / safe), -127, 127)`` as int8: f32 division and
    round half to even, the arithmetic of the JAX package and the kernels."""
    return torch.clamp(torch.round(af / safe), -_QMAX, _QMAX).to(torch.int8)


def paged_write_chunk(cache, new, block_tables, positions):
    """Write T tokens per sequence into their pages, in place.

    cache ``[num_blocks, Nkv, bs, H]``; new ``[B, T, Nkv, H]``; block_tables
    ``[B, max_blocks]``; positions ``[B, T]`` (token index within each
    sequence).  Returns the updated cache."""
    if isinstance(cache, QuantPool):
        return _quant_write_chunk(cache, new, block_tables, positions)
    bs = cache.shape[2]
    positions = positions.long()
    block_idx = torch.gather(block_tables.long(), 1, positions // bs)  # [B, T]
    slot = positions % bs
    # advanced indices on dims 0 and 2 put the broadcast [B, T] in front:
    # the indexed view is [B, T, Nkv, H], the shape of `new`
    cache[block_idx, :, slot, :] = new.to(cache.dtype)
    return cache


def _quant_write_chunk(pool, new, block_tables, positions):
    """paged_write_chunk into a QuantPool, in place: the tokens' per-head
    amax grows each touched block's scale (scatter-max); blocks whose
    scale grew get their resident payload rescaled against it (every
    gather below precedes the writes); the tokens then quantize against
    the final scales into their slots."""
    bs = pool.data.shape[2]
    positions = positions.long()
    block_idx = torch.gather(block_tables.long(), 1, positions // bs)  # [B, T]
    slot = positions % bs
    af = new.float()                                                # [B, T, Nkv, H]
    tok_scale = _amax_scale(af, -1)                                 # [B, T, Nkv]
    old_scale = pool.scale[block_idx]                               # [B, T, Nkv]
    old_blocks = pool.data[block_idx].float()                       # [B, T, Nkv, bs, H]
    nkv = tok_scale.shape[-1]
    pool.scale.scatter_reduce_(0, block_idx.reshape(-1, 1).expand(-1, nkv),
                               tok_scale.reshape(-1, nkv), "amax")
    new_scale = pool.scale[block_idx]                               # final per block
    safe = torch.clamp_min(new_scale, _EPS)
    ratio = torch.where(new_scale > old_scale, old_scale / safe, torch.ones_like(safe))
    pool.data[block_idx] = torch.clamp(torch.round(old_blocks * ratio[..., None, None]),
                                       -_QMAX, _QMAX).to(torch.int8)
    pool.data[block_idx, :, slot, :] = _quantize(af, safe[..., None])
    return pool


def paged_write(cache, new, block_tables, positions):
    """Write one token per sequence: new ``[B, Nkv, H]``, positions ``[B]``."""
    return paged_write_chunk(cache, new[:, None], block_tables, positions[:, None])


def paged_gather(cache, block_tables):
    """Each sequence's logical cache view: ``[B, Nkv, max_blocks * bs, H]``.
    A QuantPool dequantizes as it gathers (f32 out)."""
    tables = block_tables.long()
    if isinstance(cache, QuantPool):
        pages = cache.data[tables].float() * cache.scale[tables][..., None, None]
    else:
        pages = cache[tables]  # [B, mb, Nkv, bs, H]
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
    ``block_ids``, in place.  A QuantPool gets fresh per-block-per-head
    scales over the poured content (set, not running-max: a recycled
    block's stale scale dies here)."""
    idx = torch.as_tensor(block_ids, dtype=torch.long, device=cache.device)
    if isinstance(cache, QuantPool):
        af = kv.float()
        s = _amax_scale(af, (2, 3))                                # [n, Nkv]
        cache.data[idx] = _quantize(af, torch.clamp_min(s, _EPS)[:, :, None, None])
        cache.scale[idx] = s
        return cache
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
