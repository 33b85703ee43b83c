"""One request's state off and back onto the engine: preemption parking
(counterpart of ``park_request_state`` / ``unpark_request_state`` in
paddle_tpu/serving/snapshot.py).

A parked request's pool pages go to the host verbatim (the pool's own
leaves: int8 payload plus f32 scales, or the model-dtype payload), and
come back verbatim into fresh blocks, so park then unpark is bit-exact by
construction.  The sampler's key derives from the request's (seed, nonce)
and its counter is ``len(generated)``, so a resumed stream goes on token
for token.  Whole-engine snapshots (``EngineSnapshot``, ``snapshot()``,
``drain()``) are not ported (ROADMAP.md A.2).
"""

from __future__ import annotations

from paddle_tpu_torch.ops import paged_attention as pa

__all__ = ["park_request_state", "unpark_request_state"]


def park_request_state(eng, slot):
    """The restorable state of the request in ``slot``: its host fields and
    its pool pages (``pool_get_blocks`` dicts a layer, copied to host
    memory).  The caller releases the slot."""

    def host(blocks):
        return {name: t.cpu() for name, t in blocks.items()}

    return {
        "req": slot.req, "seq_len": slot.seq_len, "max_len": slot.max_len,
        "n_blocks": len(slot.blocks), "last_token": slot.last_token,
        "generated": list(slot.generated), "temperature": slot.temperature,
        "key": slot.key, "priority": slot.priority,
        "pages_k": [host(pa.pool_get_blocks(p, slot.blocks)) for p in eng._kpools],
        "pages_v": [host(pa.pool_get_blocks(p, slot.blocks)) for p in eng._vpools],
    }


def unpark_request_state(eng, slot, rec):
    """Re-admit a parked request into ``slot``: fresh pool blocks, its
    pages placed verbatim and in place (``pool_set_blocks``: a captured
    step reads the pools at fixed addresses), its fields restored.
    Returns False, with nothing changed, when the pool cannot supply the
    blocks now."""
    from paddle_tpu_torch.serving import _PoolExhausted

    try:
        blocks = eng._alloc(rec["n_blocks"])
    except _PoolExhausted:
        return False
    for li in range(eng._n_layers):
        pa.pool_set_blocks(eng._kpools[li], blocks, rec["pages_k"][li])
        pa.pool_set_blocks(eng._vpools[li], blocks, rec["pages_v"][li])
    slot.rid = rec["req"]["rid"]
    slot.active = True
    slot.prefill = None
    slot.seq_len = rec["seq_len"]
    slot.max_len = rec["max_len"]
    slot.blocks = blocks
    slot.last_token = rec["last_token"]
    slot.generated = list(rec["generated"])
    slot.temperature = rec["temperature"]
    slot.key = rec["key"]
    slot.priority = rec["priority"]
    slot.req = rec["req"]
    return True
