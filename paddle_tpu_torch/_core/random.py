"""Global RNG state on the device (counterpart of paddle_tpu/_core/random.py).

The JAX package keeps a host seed and call counter and folds the counter
into ``jax.random.key(seed)`` at each random op; its compiled training
step takes one key a step and restarts the counter inside ``key_scope``.
A CUDA graph cannot read a host counter: a recorded step would replay
the masks it was recorded with.  So the state lives on the device here:

- one int64 tensor ``[seed, counter]`` per device (``state_tensor``),
  made at first use from the host seed, never rebound afterwards;
- each random op reads it, forms its key on the device and advances the
  counter in place by one, so a recorded step draws fresh bits at every
  replay, the same bits the eager step draws from the same state;
- ``seed(s)`` writes ``[s, 0]`` into every device's state in place.

The bits are a counter-based hash of (seed, counter, element index) in
int64 torch ops on 32-bit values (``mix32``; ``serving/sampling.py``
draws its tokens from the same hash): every product is a value below 2^32
times a constant below 2^31, so no op depends on how int64 overflow
behaves, and the CPU and the card give the same bits.  The streams differ
from JAX's threefry: tests compare statistics, not masks, with the JAX
package.
"""

from __future__ import annotations

import torch

__all__ = ["seed", "get_rng_state", "set_rng_state", "state_tensor", "uniform_like",
           "uniform_from", "mix32"]

_M32 = 0xFFFFFFFF
_MUL_A = 0x7FEB352D  # multipliers below 2^31: a product of a 32-bit value stays under 2^63
_MUL_B = 0x5BD1E995
SALT_KEY = 0x9E3779B9
SALT_INDEX = 0x85EBCA6B

_SEED_MASK = (1 << 63) - 1  # seeds are kept non-negative: the hash shifts them right

_seed = 0
_states: dict = {}  # torch.device -> int64 [seed, counter] on that device
_hashes: dict = {}  # torch.device -> the index hashes made there, the last the longest


def mix32(x):
    """A 32-bit avalanche (xor-shift, multiply, xor-shift, multiply,
    xor-shift) of int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL_A) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL_B) & _M32
    return x ^ (x >> 16)


def key_of(keys, counters):
    """The per-draw half of the hash: keys (int64, below 2^63) at counters
    (int64, below 2^32), elementwise."""
    keys, counters = keys.long(), counters.long() & _M32
    return mix32(mix32(mix32((keys & _M32) ^ SALT_KEY) ^ (keys >> 32)) ^ counters)


def index_hash(n: int, device) -> torch.Tensor:
    """The per-element half of the hash, ``[n]`` int64."""
    if n >= 2 ** 32:
        raise ValueError(f"{n} elements: the counter hash indexes below 2^32")
    return mix32(torch.arange(n, dtype=torch.int64, device=device) ^ SALT_INDEX)


def _prefix_hash(n: int, device) -> torch.Tensor:
    """``index_hash(n, device)`` as a prefix of the longest hash made on the
    device so far (the hash of an index does not depend on n).  A longer
    request makes one of at least twice the length; the shorter ones stay
    referenced, since a recorded step may read them, so the kept hashes take
    under twice the longest's bytes."""
    made = _hashes.setdefault(device, [])
    if not made or made[-1].numel() < n:
        grown = 2 * made[-1].numel() if made else 0
        made.append(index_hash(max(n, min(grown, 2 ** 32 - 1)), device))
    return made[-1][:n]


def to_uniform(bits):
    """The top 24 bits of 32-bit hashes, made odd, over 2^24: float32
    uniforms strictly inside (0, 1), exactly on both devices."""
    return ((bits >> 8) | 1).to(torch.float32) * (2.0 ** -24)


def _resolved(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def state_tensor(device) -> torch.Tensor:
    """The device's ``[seed, counter]`` (int64), made at first use."""
    device = _resolved(device)
    state = _states.get(device)
    if state is None:
        state = _states[device] = torch.tensor([_seed, 0], dtype=torch.int64, device=device)
    return state


def _uniforms(state, shape):
    n = 1
    for s in shape:
        n *= int(s)
    row = key_of(state[0:1], state[1:2])
    return to_uniform(mix32(row ^ _prefix_hash(n, state.device))).reshape(tuple(shape))


def uniform_like(shape, device) -> torch.Tensor:
    """float32 uniforms in (0, 1) of ``shape`` from the device's state,
    whose counter advances by one, in place (no host read)."""
    state = state_tensor(device)
    out = _uniforms(state, shape)  # read before the advance below
    state[1:2].add_(1)
    return out


def uniform_from(state, shape):
    """``uniform_like`` as a function of a given ``[seed, counter]``: the
    same uniforms, and the advanced state as a new tensor (a random op
    inside a static Program, whose state is a program write)."""
    new = state.clone()
    new[1:2].add_(1)
    return _uniforms(state, shape), new


def seed(s: int):
    """``paddle.seed``: every device's state becomes ``[s, 0]``, in place."""
    global _seed
    _seed = int(s) & _SEED_MASK
    for state in _states.values():
        state.copy_(torch.tensor([_seed, 0], dtype=torch.int64))


def get_rng_state() -> dict:
    """``{device: [seed, counter]}``: copies of every device's state.  The
    CPU's and the current CUDA device's are made here at first use, so a
    ``set_rng_state`` of the result replays a stream that had not begun."""
    state_tensor("cpu")
    if torch.cuda.is_available():
        state_tensor("cuda")
    return {dev: state.clone() for dev, state in _states.items()}


def set_rng_state(state):
    """Write states back in place: a ``get_rng_state()`` dict, or a
    ``(seed, counter)`` pair for every device (and the seed of states made
    later)."""
    global _seed
    if isinstance(state, dict):
        for dev, value in state.items():
            state_tensor(dev).copy_(value)
        return
    s, c = int(state[0]) & _SEED_MASK, int(state[1])
    _seed = s
    for t in _states.values():
        t.copy_(torch.tensor([s, c], dtype=torch.int64))
