"""Live-engine snapshots and request parking (counterpart of
paddle_tpu/serving/snapshot.py).

``EngineSnapshot(dir)`` captures a live ``GenerationEngine`` between
macro-steps: every pool leaf (bf16 payloads; int8 payloads and f32
scales), the allocator's free list and refcounts, the radix prefix tree
(namespaces, epochs, LRU order), the adapter tier (the registry, the
slots' names, epochs and LRU clock), the requests in flight (emitted
tokens, sampler keys, block lists), the pending queue and the nonce
counter.  A restored engine continues every greedy and seeded-sampled
stream bit for bit.

The on-disk format is the port's own (the JAX package writes its sharded
checkpoint store; no cross-loading): a step directory holds ``pools.pt``
(``torch.save`` of the pool leaves as host tensors), ``extras.pkl`` (the
pickled host state) and the manifest, committed through the checkpoint
manager's atomic protocol (``distributed/checkpoint/manager.py``: temp
directory, fsynced payload, sha256 manifest, one rename).  A torn or
corrupt step is skipped (and counted) when the newest valid one is
resolved.

Restore builds a fresh engine of the recorded geometry, then copies every
pool leaf into that engine's own pools (``copy_``): the JAX package rebinds
the engine's pool arrays, but here a captured step reads the pools at
fixed addresses, so the restored bytes must land in them.  The adapter
registry is installed into the same slots through ``set_slot`` (in place).
Tensor-parallel restores (``mesh=``) are ROADMAP.md A.6.

``park_request_state`` / ``unpark_request_state`` are the one-request
face, preemption parking: a parked request's pool pages go to the host
verbatim and come back verbatim into fresh blocks, so park then unpark is
bit-exact by construction.  The sampler's key derives from the request's
(seed, nonce) and its counter is ``len(generated)``, so a resumed stream
goes on token for token.
"""

from __future__ import annotations

import os
import pickle
import shutil
import time
from collections import deque

import torch

from paddle_tpu_torch.distributed.checkpoint import manager as _ckpt
from paddle_tpu_torch.ops import paged_attention as pa

__all__ = ["EngineSnapshot", "restore_engine", "snapshot_stats", "reset_snapshot_stats",
           "park_request_state", "unpark_request_state"]

_UNSET = object()
_POOLS = "pools.pt"
_EXTRAS = "extras.pkl"
_DIST_ITEM = "ROADMAP.md A.6 (distributed)"

# Snapshot counters (the JAX package's keys): snapshots saved and
# restored, bytes committed, seconds in save() (device-to-host copies and
# the commit), torn or corrupt step directories skipped while resolving the
# newest valid one, and drains.
_SNAPSHOT_STATS = {
    "saves": 0,
    "restores": 0,
    "bytes": 0,
    "snapshot_seconds": 0.0,
    "corrupt_skipped": 0,
    "drains": 0,
}


def snapshot_stats(reset: bool = False) -> dict:
    """The snapshot counters (zeros when no snapshot ran)."""
    out = dict(_SNAPSHOT_STATS)
    if reset:
        reset_snapshot_stats()
    return out


def reset_snapshot_stats():
    for k, v in _SNAPSHOT_STATS.items():
        _SNAPSHOT_STATS[k] = 0.0 if isinstance(v, float) else 0


# Torn directories already counted in corrupt_skipped, process-wide: each
# engine.snapshot() / restore_engine() builds its own EngineSnapshot, and a
# torn directory kept for inspection must not count again at every resolve.
_SKIP_COUNTED: set = set()


# ------------------------------------------------------------- radix tree
def _radix_state(tree):
    """A RadixPrefixCache as a node list in depth-first order (a parent
    before its children): each node's parent index, key (a chunk tuple, or
    ``((slot, epoch), chunk)`` at an adapter namespace's first level),
    pool block and LRU mark."""
    if tree is None:
        return None
    nodes = []
    stack = [(tree._root, -1)]
    while stack:
        node, pidx = stack.pop()
        if node is tree._root:
            idx = -1
        else:
            nodes.append((pidx, node.chunk, node.block, node.last_used))
            idx = len(nodes) - 1
        for child in node.children.values():
            stack.append((child, idx))
    return {"block_size": tree.block_size, "clock": tree._clock, "nodes": nodes}


def _radix_from_state(state):
    from paddle_tpu_torch.serving import RadixPrefixCache, _RadixNode

    tree = RadixPrefixCache(state["block_size"])
    tree._clock = state["clock"]
    built = []
    for pidx, key, block, last_used in state["nodes"]:
        parent = tree._root if pidx < 0 else built[pidx]
        node = _RadixNode(key, block, parent)
        node.last_used = last_used
        parent.children[key] = node
        tree._by_block[block] = node
        built.append(node)
    return tree


# ------------------------------------------------------------- host state
def _model_record(cfg):
    return {"num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads,
            "hidden_size": cfg.hidden_size, "vocab_size": cfg.vocab_size,
            "dtype": cfg.dtype}


def _check_model(model, saved, who):
    got = _model_record(model.config)
    if got != saved:
        diff = {k: (saved[k], got.get(k)) for k in saved if got.get(k) != saved[k]}
        raise ValueError(f"{who} does not match the snapshot's geometry (saved, got): {diff}; "
                         "the pools hold K/V of the model the snapshot was taken from, and "
                         "a restore needs that model (weights are not in the snapshot)")


def _capture_host_state(eng):
    """Everything but the pools, as picklable host values, at a boundary.
    PREFILLING lanes and parked requests ride as queued submissions (the
    restored engine replays them from (seed, nonce)); a PREFILLING lane's
    blocks are released in the captured allocator as ``_unref`` would
    (pages the prefix tree holds stay cached)."""
    pack = eng._pack
    cfg = {
        "format": 1,
        "max_batch": eng.max_batch, "block_size": eng.block_size,
        "num_blocks": eng._num_blocks, "eos_token_id": eng.eos_token_id,
        "kv_cache_dtype": eng._kv_dtype, "prefill_chunk": eng.prefill_chunk,
        "prefill_chunk_blocks": eng.prefill_chunk_blocks,
        "decode_chunk": eng._decode_chunk,  # the constructor's value; None = the flag
        "prefix_cache": eng._prefix is not None,
        "has_draft": eng.draft_model is not None,
        "num_speculative": eng.num_speculative,
        "model": _model_record(eng.model.config),
        "draft": (_model_record(eng.draft_model.config)
                  if eng.draft_model is not None else None),
        "adapters": (None if pack is None else {
            "rank": pack.rank, "alpha": pack.alpha, "max_adapters": pack.num_slots - 1,
            "targets": tuple(pack.targets)}),
    }
    free, ref = list(eng._free), list(eng._ref)
    pending = [dict(req) for req in eng._pending]
    slots = []
    for s in eng._slots:
        if s.prefill is not None:
            st = s.prefill
            for b in st.fresh + st.matched:
                ref[b] -= 1
                if ref[b] <= 0 and (eng._prefix is None or not eng._prefix.holds(b)):
                    free.append(b)
            pending.append(dict(st.req))
            slots.append(None)
            continue
        slots.append({"rid": s.rid, "active": s.active, "seq_len": s.seq_len,
                      "d_seq_len": s.d_seq_len, "max_len": s.max_len,
                      "blocks": list(s.blocks), "last_token": s.last_token,
                      "generated": list(s.generated), "temperature": s.temperature,
                      "key": s.key, "priority": s.priority, "req": s.req,
                      "adapter_slot": s.adapter_slot})
    for rec in eng._parked.values():
        pending.append(dict(rec["req"]))
    adapters = None
    if pack is not None:
        adapters = {"registry": {name: ({t: (a.clone(), b.clone()) for t, (a, b) in arr.items()},
                                        alpha)
                                 for name, (arr, alpha) in eng._adapter_registry.items()},
                    "slot_names": list(eng._slot_names),
                    "slot_epochs": list(eng._slot_epochs),
                    "slot_used": list(eng._slot_used), "slot_clock": eng._slot_clock}
    return {"config": cfg, "alloc": {"free": free, "ref": ref}, "slots": slots,
            "results": {rid: list(v) for rid, v in eng._results.items()},
            "pending": pending, "req_counter": eng._req_counter,
            "macro_steps": eng._macro_steps, "radix": _radix_state(eng._prefix),
            "pack": adapters,
            "spec_stats": dict(eng._spec_stats) if eng.draft_model is not None else None}


def _pool_sets(eng):
    """``(name prefix, pool list)`` of every pool set of the engine."""
    sets = [("pool.k", eng._kpools), ("pool.v", eng._vpools)]
    if eng.draft_model is not None:
        sets += [("pool.dk", eng._d_kpools), ("pool.dv", eng._d_vpools)]
    return sets


def _pools_to_host(eng):
    """Every pool leaf as a host tensor (pinned staging on the card, one
    sync for all of them)."""
    pinned = eng.device.type == "cuda"
    out = {}
    for prefix, pools in _pool_sets(eng):
        for li, pool in enumerate(pools):
            for name, t in pa.pool_state_dict(f"{prefix}{li}", pool).items():
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
                host.copy_(t, non_blocking=pinned)
                out[name] = host
    if pinned:
        torch.cuda.synchronize(eng.device)
    return out


def _load_state(eng, path, extras):
    """Copy the snapshot at ``path`` (its unpickled ``extras``) into the
    engine ``eng`` of the recorded geometry: every pool leaf in place,
    then the host state and the adapter tier.  The engine may have
    captured its steps already: they read the pools and the pack where the
    bytes land."""
    from paddle_tpu_torch.serving import _LORA_STATS, _Slot

    tensors = torch.load(os.path.join(path, _POOLS), map_location="cpu", weights_only=True)

    def fetch(name, leaf):
        if tuple(tensors[name].shape) != tuple(leaf.shape):
            raise ValueError(f"snapshot leaf {name} has shape {tuple(tensors[name].shape)}, "
                             f"the engine's {tuple(leaf.shape)}")
        return leaf.copy_(tensors[name])

    with torch.no_grad():
        for prefix, pools in _pool_sets(eng):
            for li, pool in enumerate(pools):
                pa.pool_from_state(pool, fetch, f"{prefix}{li}")

    eng._free = list(extras["alloc"]["free"])
    eng._ref = list(extras["alloc"]["ref"])
    eng._pending = deque(extras["pending"])
    eng._parked = {}
    eng._req_counter = extras["req_counter"]
    eng._macro_steps = extras["macro_steps"]
    eng._slots = [_Slot() for _ in range(eng.max_batch)]
    for sd, slot in zip(extras["slots"], eng._slots):
        if sd is None:  # a PREFILLING lane: its request rides the queue
            continue
        for k, v in sd.items():
            setattr(slot, k, list(v) if isinstance(v, list) else v)
    # the submit order resumes past every captured request (FIFO within a
    # class for later submissions)
    eng._submit_seq = 1 + max([r.get("seq", -1) for r in extras["pending"]]
                              + [sd["req"]["seq"] for sd in extras["slots"]
                                 if sd is not None and sd["req"] is not None] + [-1])
    eng._results = {rid: list(v) for rid, v in extras["results"].items()}
    for slot in eng._slots:
        if slot.active:
            eng._results[slot.rid] = slot.generated  # a live stream aliases its lane's list
    if extras["radix"] is not None and eng._prefix is not None:
        eng._prefix = _radix_from_state(extras["radix"])

    pk = extras["pack"]
    if pk is not None:
        # the registry installed into the same slots, in place; the epochs
        # restored, so a later swap strands exactly the right subtree
        eng._adapter_registry = dict(pk["registry"])
        eng._slot_names = list(pk["slot_names"])
        eng._slot_used = list(pk["slot_used"])
        eng._slot_clock = pk["slot_clock"]
        for s, name in enumerate(eng._slot_names):
            if s and name is not None:
                eng._pack.set_slot(s, *eng._adapter_registry[name])
            elif s:
                eng._pack.clear_slot(s)
        eng._slot_epochs = list(pk["slot_epochs"])
        refs = [0] * eng._pack.num_slots
        for slot in eng._slots:
            if slot.active:
                refs[slot.adapter_slot] += 1
        eng._slot_refs = refs
        _LORA_STATS["slots_total"] = eng._pack.num_slots - 1
        _LORA_STATS["slots_resident"] = eng._resident_count()
    if eng.draft_model is not None and extras["spec_stats"] is not None:
        eng._spec_stats = dict(extras["spec_stats"])


class EngineSnapshot:
    """A store of step-tagged engine snapshots under ``dir``: atomic
    commits, retention of the newest ``max_to_keep`` valid steps, torn
    steps skipped when resolving, stale temp directories swept.

        store = EngineSnapshot("snaps")
        store.save(engine)                 # a step-tagged atomic commit
        eng = store.restore(model)         # the newest valid step, a fresh engine
    """

    def __init__(self, dir, max_to_keep=2):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1 (or None for unlimited)")
        self.dir = str(dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)
        self._valid_cache: dict = {}  # step dir -> (manifest mtime, valid)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{int(step):08d}")

    def all_steps(self) -> list:
        """Committed step numbers, ascending (validity not checked)."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(int(m.group(1)) for m in map(_ckpt._STEP_RE.match, names)
                      if m and os.path.isdir(os.path.join(self.dir, m.group(0))))

    def _valid(self, path: str) -> bool:
        """The manifest check, cached by the manifest's mtime: retention
        and restore do not hash every kept snapshot again."""
        mpath = os.path.join(path, _ckpt._MANIFEST)
        try:
            mtime = os.stat(mpath).st_mtime_ns
        except OSError:
            return False
        cached = self._valid_cache.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1]
        ok = _ckpt._verify_manifest(path, mpath)
        self._valid_cache[path] = (mtime, ok)
        return ok

    def latest_step(self):
        """The newest step whose snapshot passes its manifest, or None;
        torn or corrupt ones are skipped and counted once each in
        ``snapshot_stats()["corrupt_skipped"]``."""
        for step in reversed(self.all_steps()):
            path = self._step_dir(step)
            if self._valid(path):
                return step
            if path not in _SKIP_COUNTED:
                _SKIP_COUNTED.add(path)
                _SNAPSHOT_STATS["corrupt_skipped"] += 1
        return None

    def save(self, engine, step=None) -> int:
        """Commit a snapshot of ``engine`` (call between ``step()``s;
        default step tag: its macro-step count).  Returns the step."""
        t0 = time.perf_counter()
        pools = _pools_to_host(engine)
        extras_blob = pickle.dumps(_capture_host_state(engine), protocol=4)
        step = int(step if step is not None else engine._macro_steps)

        def writer(tmp):
            return (_ckpt.write_fsynced(os.path.join(tmp, _POOLS),
                                        lambda f: torch.save(pools, f))
                    + _ckpt.write_fsynced(os.path.join(tmp, _EXTRAS),
                                          lambda f: f.write(extras_blob)))

        final, written = _ckpt.commit_dir(self.dir, f"step_{step:08d}", writer,
                                          manifest_extra={"step": step,
                                                          "kind": "engine_snapshot"})
        # every byte was hashed for the manifest just now
        self._valid_cache[final] = (
            os.stat(os.path.join(final, _ckpt._MANIFEST)).st_mtime_ns, True)
        _SNAPSHOT_STATS["saves"] += 1
        _SNAPSHOT_STATS["bytes"] += written
        _SNAPSHOT_STATS["snapshot_seconds"] += time.perf_counter() - t0
        self._gc()
        return step

    def _gc(self):
        """Keep the newest ``max_to_keep`` valid steps and a torn step
        newer than all of them (for inspection; restores skip it); delete
        the rest and sweep the temp directories of dead processes."""
        steps = self.all_steps()
        valid = [s for s in steps if self._valid(self._step_dir(s))]
        keep = set(valid if self.max_to_keep is None else valid[-self.max_to_keep:])
        newest_valid = valid[-1] if valid else None
        for s in steps:
            if s in keep or (s not in valid and (newest_valid is None or s > newest_valid)):
                continue
            path = self._step_dir(s)
            shutil.rmtree(path, ignore_errors=True)
            self._valid_cache.pop(path, None)
            _SKIP_COUNTED.discard(path)
        _ckpt.sweep_stale_tmp(self.dir)

    def _resolve(self, step):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise RuntimeError(f"no valid engine snapshot under {self.dir!r}")
        path = self._step_dir(step)
        if not self._valid(path):
            raise RuntimeError(f"engine snapshot {path} is missing or corrupt")
        with open(os.path.join(path, _EXTRAS), "rb") as f:
            return path, pickle.load(f)

    def config(self, step=None) -> dict:
        """The recorded engine geometry of ``step`` (default: the newest
        valid), without loading the pools."""
        return dict(self._resolve(step)[1]["config"])

    def restore(self, model, step=None, *, mesh=None, draft_model=None,
                decode_chunk=_UNSET, device=None):
        """A live engine rebuilt from snapshot ``step`` (default: the newest
        valid).  ``model`` (and ``draft_model`` for a speculative snapshot)
        must be the model the snapshot was taken from: a geometry mismatch
        raises ``ValueError``.  ``decode_chunk`` defaults to the saved
        constructor value (streams are the same for every D).  The engine
        is open for admissions, also after a ``drain()``."""
        if mesh is not None:
            raise NotImplementedError(f"restoring onto a tensor-parallel mesh (mesh=) is not "
                                      f"ported yet ({_DIST_ITEM})")
        path, extras = self._resolve(step)
        cfg = extras["config"]
        _check_model(model, cfg["model"], "model")
        if cfg["has_draft"] and draft_model is None:
            raise ValueError("the snapshot was taken from a speculative engine; pass the same "
                             "draft_model=")
        if not cfg["has_draft"] and draft_model is not None:
            raise ValueError("the snapshot's engine had no draft model; drop draft_model=")
        if cfg["has_draft"]:
            _check_model(draft_model, cfg["draft"], "draft model")

        from paddle_tpu_torch.serving import GenerationEngine

        eng = GenerationEngine(
            model, max_batch=cfg["max_batch"], block_size=cfg["block_size"],
            num_blocks=cfg["num_blocks"], eos_token_id=cfg["eos_token_id"],
            prefill_chunk=cfg["prefill_chunk"], draft_model=draft_model,
            num_speculative_tokens=cfg["num_speculative"],
            decode_chunk=cfg["decode_chunk"] if decode_chunk is _UNSET else decode_chunk,
            prefix_cache=cfg["prefix_cache"], kv_cache_dtype=cfg["kv_cache_dtype"],
            adapters=dict(cfg["adapters"]) if cfg["adapters"] else None,
            prefill_chunk_blocks=cfg["prefill_chunk_blocks"], device=device)
        _load_state(eng, path, extras)
        _SNAPSHOT_STATS["restores"] += 1
        return eng


def restore_engine(model, dir, step=None, *, mesh=None, draft_model=None,
                   decode_chunk=_UNSET, device=None):
    """``EngineSnapshot(dir).restore(model, ...)``: the newest valid
    snapshot under ``dir`` (or ``step``) as a live engine."""
    return EngineSnapshot(dir).restore(model, step=step, mesh=mesh, draft_model=draft_model,
                                       decode_chunk=decode_chunk, device=device)


# ------------------------------------------------------------- parking
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
    slot.d_seq_len = 0
    slot.adapter_slot = 0  # only base-model lanes park
    return True
