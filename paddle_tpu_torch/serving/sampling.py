"""Counter-based token sampling on the device.

Counterpart of the JAX engine's per-slot sampling
(paddle_tpu/serving/__init__.py: ``fold_in(PRNGKey(seed), nonce)`` at
admission, then ``fold_in(key, steps)`` and ``categorical`` inside the
macro-step).  A request's key is a 63-bit integer
(``serving._request_seed(seed, nonce)``) and its counter the number of
tokens it has generated, so its stream depends on nothing else: not on the
decode chunk D, the lane it lands in, or whether it was queued.

The uniform of vocab entry v at (key, counter) is an integer hash of the
three, the one dropout draws from (``_core/random.py``), written in int64
torch ops on 32-bit values: every product is a
value below 2^32 times a constant below 2^31, under 2^63, masked back to
32 bits, so no op depends on how int64 overflow behaves, and the CPU and
the card give the same bits.  The top 24 bits, made odd, over 2^24 give a
float32 uniform strictly inside (0, 1), exactly on both devices.  A token
is ``argmax(logits / T + Gumbel(u))``; rows with T == 0 take
``argmax(logits)`` from the same call, so one captured step serves a batch
that mixes greedy and sampled lanes.  The streams differ from JAX's
(another generator): sampled tokens are checked port against port.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch._core.random import index_hash, key_of, mix32, to_uniform

__all__ = ["sample", "uniforms", "vocab_hash"]


def vocab_hash(vocab_size: int, device) -> torch.Tensor:
    """The per-entry half of the hash, ``[V]`` int64: made once per engine."""
    return index_hash(vocab_size, device)


def uniforms(keys, counters, vhash):
    """``[B, V]`` float32 uniforms in (0, 1) of keys ``[B]`` (int64, below
    2^63) at counters ``[B]`` (int64, below 2^32)."""
    return to_uniform(mix32(key_of(keys, counters)[:, None] ^ vhash[None, :]))


def sample(logits, temps, keys, counters, vhash):
    """Next tokens ``[B]`` (int64) from logits ``[B, V]``: Gumbel-max over
    ``logits / T`` where ``temps [B] > 0``, argmax where it is 0."""
    greedy = torch.argmax(logits, dim=-1)
    u = uniforms(keys, counters, vhash)
    gumbel = -torch.log(-torch.log(u))
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    sampled = torch.argmax(logits.float() / safe_t[:, None] + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy)
