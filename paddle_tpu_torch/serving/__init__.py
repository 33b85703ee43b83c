"""Continuous-batching generation over a shared paged-KV pool
(counterpart of paddle_tpu/serving/__init__.py ``GenerationEngine``).

Ported: the block allocator with per-block refcounts and one scratch page
per batch lane; admission (a pending queue retried at macro-step
boundaries under pool pressure) through the cached forward, whole or in
``prefill_chunk``-token chunks, and the pour into pool pages; bf16 or int8
pools (``kv_cache_dtype``); the macro-step decode of D tokens per
``step()`` with finished lanes masked onto their scratch pages, EOS and
``max_len`` stops, per-request temperature sampling inside the step
(``serving/sampling.py``), ``warmup()``; the schedule searcher's serving
chains (with ``FLAGS_schedule_search`` the engine resolves once, at first
use, a decode-chain and a prefill-chain verdict for its geometry and runs
the accepted kernels; a flag change re-arms both and drops the captured
steps).  And the admission half of the serving features (ROADMAP.md A.2):
- the radix prefix cache (``prefix_cache`` / ``FLAGS_prefix_cache``,
  ``RadixPrefixCache``): admission references the longest cached prompt
  prefix's pages, prefills only the suffix against the gathered prefix
  (int8 pages dequantized), and inserts the prompt's full blocks;
  refcount-zero cached pages are evicted LRU under pool pressure;
- interleaved chunked prefill (``prefill_chunk_blocks`` /
  ``FLAGS_prefill_chunk_blocks``): admission reserves a lane and pages,
  and each ``step()`` forwards a budget of one-block chunks before the
  decode step, pouring each block as it completes;
- priority classes (``add_request(priority=)``) admitted in (class,
  submit order), and preemption of a LOW resident when a higher class is
  blocked (``FLAGS_preempt_low_priority``): its pages park on the host
  (``serving/snapshot.py``) and its stream resumes bit-identically;
- ``add_request(nonce=)``, ``adopt_pages`` (base engines, ``ns=None``),
  ``warmup(adopt=True)``'s page round trip, and the serving counters
  (``decode_stats`` / ``reset_decode_stats``);
- speculative decoding (``draft_model=``, ``num_speculative_tokens=`` K):
  the draft keeps pools of its own geometry indexed by the target's block
  ids (so the draft may be the target itself), prefills and pours the
  same suffix at admission, and each ``step()`` is one tick: K + 1 draft
  steps, one verify of the ``[B, K + 1]`` chunk by the target, then
  per-lane greedy acceptance (``spec_stats``).  Spec lanes are greedy
  only; as in the JAX package, spec engines admit atomically, never
  preempt, refuse ``adopt_pages`` and run no decode chain.
And the second half (ROADMAP.md A.2.1-A.2.2):
- multi-tenant LoRA (``adapters=``, ``nn/lora.py``'s ``AdapterPack``):
  ``register_adapter`` installs an adapter into a pack slot (LRU over idle
  slots), ``add_request(adapter=)`` serves a request through it (the
  prefill through forward hooks, the decode step and the speculative
  verify through each row's gathered delta; the draft proposes base-model
  tokens), the prefix tree is namespaced by ``(slot, epoch)``, and
  ``evict_adapter`` / re-registration bump the slot's epoch, which drops
  its cached subtree; ``lora_stats``;
- fault tolerance (``serving/snapshot.py``): ``snapshot(dir)``,
  ``maybe_snapshot`` (at every boundary when ``FLAGS_engine_snapshot_dir``
  is set), the SIGTERM preemption handler, and ``drain(dir)``, which
  demotes PREFILLING and parked requests to the queue, snapshots and
  closes admissions; ``restore_engine`` builds an engine from a snapshot.

In JAX the D-token macro-step is one ``lax.scan`` inside a jitted program,
compiled once per D.  Here its body reads fixed device buffers (tokens,
tables, lens, max_lens, done, temperatures, keys and counters, adapter
slots, filled by one copy from a pinned host area at every ``step()``),
the pools, the adapter pack and the weights, and is recorded once per D
as a CUDA graph (``_core/graphs.py``) that every ``step()`` replays, with
one device-to-host copy of the ``[B, D]`` tokens.  On the CPU the same
body runs eagerly.  Admission, prefill chunks, pours, parking, adoption,
adapter installs and snapshot restores run eagerly between replays, as in
the JAX package, and write the pools and the pack in place, so the next
replay reads their bytes: a hot swap records nothing again.  A
speculative tick is recorded the same way, once an engine at its first
tick: the draft loop (each draft argmax feeding the next draft step on
the device, lens grown in-graph from one base), then the verify, with one
device-to-host copy of the proposals and the predictions, where the JAX
package compiles the draft step and the verify as two programs and reads
each back.  Tensor-parallel serving (``mesh=``) is not ported yet and
raises ``NotImplementedError`` naming ROADMAP.md A.6.
"""

from __future__ import annotations

import contextlib
import heapq
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from paddle_tpu_torch._core import flags as _flags
from paddle_tpu_torch._core import graphs
from paddle_tpu_torch._core.device import resolve_device
from paddle_tpu_torch.models.llama import (_decode_layers_paged, _model_forward_cached,
                                           prefill_chain_scope)
from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.ops import paged_attention as pa

from . import sampling

__all__ = ["GenerationEngine", "RadixPrefixCache", "decode_stats", "reset_decode_stats",
           "schedule_decode_stats", "reset_schedule_decode_stats", "lora_stats",
           "reset_lora_stats", "EngineSnapshot", "restore_engine", "snapshot_stats",
           "reset_snapshot_stats"]

_DIST_ITEM = "ROADMAP.md A.6 (distributed)"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


# Process-wide serving counters (the JAX package's keys): one dispatch = one
# decode macro-step run; tokens counts emitted decode tokens; step_seconds
# and sync_seconds the host time of the decode step and of its one
# device-to-host read.  Prefix cache: admissions that reused at least one
# cached page / found none, prompt tokens whose prefill was avoided, LRU
# evictions.  Capacity: the latest engine's pool bytes and the peak of
# resident requests.  Admission: interleaved prefill chunks, preemptions
# and their re-admissions, the parked-request gauge (a reset leaves it),
# and admissions and completions by priority class.
_DECODE_STATS = {
    "dispatches": 0,
    "tokens": 0,
    "sync_seconds": 0.0,
    "step_seconds": 0.0,
    "macro_steps": 0,
    "last_chunk": 0,
    "prefix_hits": 0,
    "prefix_misses": 0,
    "prefix_hit_tokens": 0,
    "prefix_evictions": 0,
    "pool_bytes": 0,
    "resident_peak": 0,
    "pool_bytes_per_device": 0,  # one card: the pool bytes
    "mesh_shape": "",            # no mesh (ROADMAP.md A.6)
    "prefill_chunks": 0,
    "preemptions": 0,
    "preempt_readmits": 0,
    "parked_requests": 0,
    "admitted_high": 0,
    "admitted_normal": 0,
    "admitted_low": 0,
    "completed_high": 0,
    "completed_normal": 0,
    "completed_low": 0,
}


def decode_stats(reset: bool = False) -> dict:
    """The serving counters, plus the derived ``tokens_per_sec`` (tokens over
    step seconds) and ``pool_bytes_per_resident`` (pool bytes over the
    resident peak)."""
    out = dict(_DECODE_STATS)
    out["tokens_per_sec"] = out["tokens"] / out["step_seconds"] if out["step_seconds"] else 0.0
    out["pool_bytes_per_resident"] = (out["pool_bytes"] / out["resident_peak"]
                                      if out["resident_peak"] else 0.0)
    if reset:
        reset_decode_stats()
    return out


def reset_decode_stats():
    for k, v in _DECODE_STATS.items():
        if k == "parked_requests":
            continue  # a gauge of live engine state, not traffic
        _DECODE_STATS[k] = "" if isinstance(v, str) else 0.0 if isinstance(v, float) else 0


# Multi-tenant LoRA counters (the JAX package's keys): slots_resident and
# slots_total are gauges of the latest adapter engine's pack (a reset
# leaves them); swaps = installs into a slot (re-registrations and LRU
# re-installs included); evictions = slots vacated (explicit or LRU);
# gather_dispatches = decode steps and verifies that gathered per-row
# adapter rows; cache_epochs = slot epoch bumps (each drops that slot's
# prefix subtree); ship_ns_drops = adopted pages dropped for a stale
# (slot, epoch) namespace.
_LORA_STATS = {
    "slots_resident": 0,
    "slots_total": 0,
    "swaps": 0,
    "evictions": 0,
    "gather_dispatches": 0,
    "cache_epochs": 0,
    "ship_ns_drops": 0,
}


def lora_stats(reset: bool = False) -> dict:
    """The multi-tenant LoRA counters (zeros when no adapter engine ran)."""
    out = dict(_LORA_STATS)
    if reset:
        reset_lora_stats()
    return out


def reset_lora_stats():
    for k in _LORA_STATS:
        if k not in ("slots_resident", "slots_total"):  # gauges of live engine state
            _LORA_STATS[k] = 0


# Serving-chain counters of the schedule search: found = engines that
# consulted the searcher for their decode (or chunked-prefill) geometry;
# accepted = engines that adopted a kernel config; disabled = engines that
# kept the plain ops (a measured loss, a cached loss, a geometry with no
# candidate, or a cached config that failed its parity re-check).
_SCHED_DECODE_STATS = {
    "decode_chains_found": 0,
    "decode_chains_accepted": 0,
    "decode_chains_disabled": 0,
    "prefill_chains_found": 0,
    "prefill_chains_accepted": 0,
    "prefill_chains_disabled": 0,
}


def schedule_decode_stats() -> dict:
    return dict(_SCHED_DECODE_STATS)


def reset_schedule_decode_stats():
    for k in _SCHED_DECODE_STATS:
        _SCHED_DECODE_STATS[k] = 0


# Live engines: a flag change re-arms their chain verdicts, which are then
# resolved again at the next use (the flags decide whether, and which,
# chain an engine may run), and drops their captured steps, which hold the
# verdict they were recorded with.
_ENGINES: "weakref.WeakSet[GenerationEngine]" = weakref.WeakSet()
_CHAIN_UNSET = object()


@_flags.on_change
def _rearm_chain_verdicts(_changed):
    for eng in list(_ENGINES):
        eng._step_fns.clear()
        eng._spec_fn = None
        eng._decode_chain_cfg = _CHAIN_UNSET
        eng._prefill_chain_cfg = _CHAIN_UNSET


# Priority classes: admission runs in (class, submit order); the prefill
# scheduler weights chunk grants by class.  pressure = weight * (1 +
# boundaries waited); a prefill whose pressure reaches _PRESSURE_ESCALATE
# doubles the step's chunk budget (HIGH after 3 waited boundaries, NORMAL
# after 7, LOW after 15).
_PRIORITY = {"high": 0, "normal": 1, "low": 2}
_PRI_NAMES = {v: k for k, v in _PRIORITY.items()}
_PRI_WEIGHT = {0: 4, 1: 2, 2: 1}
_PRESSURE_ESCALATE = 16


@dataclass
class _PrefillState:
    """A PREFILLING lane (interleaved chunked prefill): its lane and pages
    were reserved at admission, and its prompt advances one pool block a
    granted chunk.  The chunk spans are block-aligned offsets of the
    prompt, never of the schedule, so the stream equals atomic admission
    with ``prefill_chunk=block_size``."""
    req: dict                 # the submission
    caches: list              # per-layer naive K/V, grown chunk by chunk
    matched: list             # shared prefix-cache pages (referenced)
    fresh: list               # pages owned by this request
    off: int = 0              # prompt tokens forwarded so far
    poured: int = 0           # full blocks in the pool so far
    since: int = 0            # the macro-step boundary the prefill began at
    h: object = None          # the last chunk's hidden states


@dataclass
class _Slot:
    rid: object = None
    active: bool = False
    seq_len: int = 0          # tokens stored in the pool (incl. prompt)
    d_seq_len: int = 0        # tokens the draft pools cover (speculative)
    max_len: int = 0          # seq_len limit for this request
    blocks: list = field(default_factory=list)
    last_token: int = 0
    generated: list = field(default_factory=list)
    temperature: float = 0.0  # 0 = greedy
    key: int = 0              # the sampler's key, _request_seed(seed, nonce)
    priority: int = 1         # _PRIORITY class (2 = LOW = preemptible)
    req: object = None        # the submission (preemption keeps it)
    prefill: object = None    # _PrefillState while PREFILLING, else None
    adapter_slot: int = 0     # the request's adapter pack slot (0 = the base model)


class _PoolExhausted(RuntimeError):
    """Too few free (or reclaimable) pool blocks right now: admission backs
    out and the request waits for the next macro-step boundary."""


class _RadixNode:
    __slots__ = ("chunk", "block", "children", "parent", "last_used")

    def __init__(self, chunk=None, block=-1, parent=None):
        self.chunk = chunk          # the key: a tuple of block_size token ids
        self.block = block          # the pool block holding this chunk's K/V
        self.children = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    """A radix tree over token-id prefixes at page granularity (pure host
    Python, the JAX package's tree).

    Each node maps one full block's token chunk to the pool block holding
    its K/V in every layer's pool.  ``match`` walks a prompt chunk by chunk
    and returns the longest cached run of blocks; ``insert`` adopts full
    prompt blocks that a prefill wrote.  The tree pins nothing: refcounts
    live in the engine's allocator, a cached block with refcount zero is
    reclaimable, and ``evict`` frees such blocks leaf-first in LRU order
    (an interior node only once its children are gone).  Partial tail
    blocks are never inserted: shared pages are immutable, a request's
    mutable tail is its own page.

    ``ns`` namespaces the first level (root children key as ``(ns,
    chunk)``), for adapter-aware engines; ``drop_subtree`` drops one
    namespace.  This package's engine passes ``ns=None``."""

    def __init__(self, block_size):
        self.block_size = int(block_size)
        self._root = _RadixNode()
        self._by_block: dict[int, _RadixNode] = {}
        self._clock = 0

    def __len__(self):
        return len(self._by_block)

    def holds(self, block) -> bool:
        """Does a tree node own this pool block?"""
        return block in self._by_block

    def _tick(self):
        self._clock += 1
        return self._clock

    @staticmethod
    def _key(node_is_root, ns, chunk):
        return (ns, chunk) if (ns is not None and node_is_root) else chunk

    def match(self, tokens, max_blocks=None, ns=None):
        """The pool blocks of the longest cached full-block prefix of
        ``tokens``, each LRU-touched.  ``max_blocks`` caps the walk
        (admission caps at (len - 1) // block_size, so at least one token
        prefills and gives the first logits)."""
        bs = self.block_size
        limit = len(tokens) // bs
        if max_blocks is not None:
            limit = min(limit, max_blocks)
        t = self._tick()
        node, out = self._root, []
        for bi in range(limit):
            chunk = tuple(tokens[bi * bs:(bi + 1) * bs])
            child = node.children.get(self._key(node is self._root, ns, chunk))
            if child is None:
                break
            child.last_used = t
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens, blocks, ns=None):
        """Adopt ``blocks[i]`` as the cached page of the i-th full chunk of
        ``tokens``.  Existing nodes keep their block (first writer wins:
        a duplicate page stays private to its request); returns the
        blocks newly adopted."""
        bs = self.block_size
        t = self._tick()
        node, adopted = self._root, []
        for bi in range(min(len(blocks), len(tokens) // bs)):
            chunk = tuple(tokens[bi * bs:(bi + 1) * bs])
            key = self._key(node is self._root, ns, chunk)
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key, blocks[bi], node)
                node.children[key] = child
                self._by_block[blocks[bi]] = child
                adopted.append(blocks[bi])
            child.last_used = t
            node = child
        return adopted

    def drop_subtree(self, ns, refcount):
        """Drop namespace ``ns``'s whole subtree.  Returns its refcount-zero
        blocks (reclaimable now: the caller frees them); referenced ones
        stop being cached and recycle when their requests drop them."""
        freed = []
        for key in [k for k in self._root.children
                    if isinstance(k, tuple) and len(k) == 2 and k[0] == ns]:
            stack = [self._root.children.pop(key)]
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                del self._by_block[nd.block]
                if refcount[nd.block] == 0:
                    freed.append(nd.block)
        return freed

    def evict(self, n, refcount):
        """Free up to ``n`` reclaimable blocks: refcount-zero leaves, least
        recently used first; a parent joins the heap when its last child
        goes.  Returns the freed blocks (the caller frees them)."""
        heap = [(nd.last_used, nd.block) for nd in self._by_block.values()
                if not nd.children and refcount[nd.block] == 0]
        heapq.heapify(heap)
        freed = []
        while heap and len(freed) < n:
            _, block = heapq.heappop(heap)
            victim = self._by_block[block]
            parent = victim.parent
            del parent.children[victim.chunk]
            del self._by_block[victim.block]
            freed.append(victim.block)
            if parent is not self._root and not parent.children \
                    and refcount[parent.block] == 0:
                heapq.heappush(heap, (parent.last_used, parent.block))
        return freed


# the step's input row of a lane, one int64 each: the last token, the W
# block-table entries, then these columns (_SLOT: the adapter pack slot)
_LEN, _MAX_LEN, _DONE, _KEY, _COUNTER, _TEMP, _SLOT = range(7)
# a speculative tick's row: the last token, the W table entries, then the
# target's and the draft's pool coverage and the adapter pack slot
_SEQ, _DSEQ, _SPEC_SLOT = range(3)


def _check_in_place(written, pools):
    if any(a is not b for a, b in zip(written, pools)):
        raise RuntimeError("a pool write returned a new pool: a captured step must write "
                           "the pools in place")


def _request_seed(seed: int, nonce: int) -> int:
    """A 63-bit sampler key from the request's (seed, nonce)."""
    state = np.random.SeedSequence([seed & (2**63 - 1), nonce]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def _tokens(req):
    """The request's prompt as a list of ints (kept across retries)."""
    return req.setdefault("toks", [int(t) for t in req["prompt"][0]])


class GenerationEngine:
    """Greedy or temperature-sampled continuous-batching decode.

    Usage:
        eng = GenerationEngine(model, max_batch=4, block_size=16, num_blocks=64)
        eng.add_request("a", prompt_ids_a, max_new_tokens=8)
        while eng.has_work():
            for rid, toks in eng.step().items(): ...
        eng.result("a")  # -> list of generated token ids

    ``step()`` advances D = decode_chunk tokens (None -> FLAGS_decode_chunk,
    default 8) and returns ``{rid: [tokens...]}``; at D == 1 it returns
    ``{rid: token}``.  On the card each D's step is captured as a CUDA
    graph at its first use, or ahead of traffic by ``warmup()``.  With a
    ``draft_model`` each ``step()`` is one speculative tick of K =
    ``num_speculative_tokens`` proposals (default 4), which emits 1 to K +
    1 tokens a lane, always as a list; its graph is captured at the first
    tick.
    ``prefix_cache`` (None -> FLAGS_prefix_cache) turns on the radix
    prefix cache; ``prefill_chunk_blocks`` (None -> the flag, read at each
    use) > 0 interleaves prefill with decode, that many one-block chunks a
    step.  ``adapters``: an int rank, an ``AdapterPack`` config dict
    (``rank``, ``alpha``, ``max_adapters``, ``targets``) or an
    ``AdapterPack`` serves multi-tenant LoRA.  ``device=None`` means the
    CUDA card and raises without one; the model must lie on the engine's
    device.
    """

    def __init__(self, model, max_batch=4, block_size=16, num_blocks=128,
                 eos_token_id=None, mesh=None, prefill_chunk=None,
                 draft_model=None, num_speculative_tokens=4, decode_chunk=None,
                 prefix_cache=None, kv_cache_dtype=None, adapters=None,
                 prefill_chunk_blocks=None, device=None):
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh=)", _DIST_ITEM)
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError("prefill_chunk must be a positive token count")
        if prefill_chunk_blocks is not None and int(prefill_chunk_blocks) < 0:
            raise ValueError("prefill_chunk_blocks must be >= 0 (0 = atomic prefill)")
        kv_dt = kv_cache_dtype if kv_cache_dtype is not None else _flags.flag(
            "FLAGS_kv_cache_dtype")
        if kv_dt not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {kv_dt!r}")
        if decode_chunk is not None and int(decode_chunk) < 1:
            raise ValueError("decode_chunk must be >= 1")

        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lies on {model.device}, the engine runs on "
                             f"{self.device}")
        cfg = model.config
        self.model = model
        self.block_size = int(block_size)
        self.max_batch = int(max_batch)
        self.eos_token_id = eos_token_id
        self._n_layers = cfg.num_hidden_layers
        self._nkv = cfg.num_key_value_heads
        self._head_dim = cfg.hidden_size // cfg.num_attention_heads
        self._decode_chunk = None if decode_chunk is None else int(decode_chunk)
        self.prefill_chunk = None if prefill_chunk is None else int(prefill_chunk)
        self.prefill_chunk_blocks = (None if prefill_chunk_blocks is None
                                     else int(prefill_chunk_blocks))
        self._kv_dtype = kv_dt  # resolved once: the pools are allocated now

        # pool pages [num_blocks, Nkv, bs, H] per layer, plus one scratch
        # page per lane (masked lanes write there, never the shared pool);
        # int8 pools are QuantPools (payload plus per-page scales)
        self._num_blocks = int(num_blocks)
        total = self._num_blocks + self.max_batch
        self._kpools, self._vpools = self._alloc_pools(cfg, total)
        # the speculative tier: the draft's own pools, of its geometry,
        # indexed by the same block ids as the target's
        self.draft_model = draft_model
        self.num_speculative = int(num_speculative_tokens)
        self._spec_fn = None  # the captured tick (graphs.Captured), built at the first tick
        if draft_model is not None:
            if self.num_speculative < 1:
                raise ValueError("num_speculative_tokens must be >= 1")
            dcfg = draft_model.config
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if draft_model.device != self.device:
                raise ValueError(f"the draft model lies on {draft_model.device}, the engine "
                                 f"runs on {self.device}")
            self._d_kpools, self._d_vpools = self._alloc_pools(dcfg, total)
            self._spec_stats = {"ticks": 0, "proposed": 0, "accepted": 0, "emitted": 0}
        self._free = list(range(self._num_blocks))
        self._ref = [0] * total  # requests referencing each block
        pc = prefix_cache if prefix_cache is not None else _flags.flag("FLAGS_prefix_cache")
        self._prefix = RadixPrefixCache(self.block_size) if pc else None
        self._pending: deque = deque()
        self._parked: dict = {}   # rid -> parked record (preempted LOW requests)
        self._submit_seq = 0      # admission order within a class
        self._macro_steps = 0     # macro-step boundaries passed (snapshot step tags)
        # fault tolerance (serving/snapshot.py)
        self._last_auto_snapshot = 0  # the boundary of the last periodic snapshot
        self._snapshot_store = None   # one EngineSnapshot for the last directory
        self._draining = False        # drain(): admissions closed
        self._drain_step = None       # the committed handoff step
        self._drain_dir = None        # and its directory
        self._preempt_requested = False
        self._preempt_saved = False
        self._prev_handlers: dict = {}
        self._scratch = [self._num_blocks + i for i in range(self.max_batch)]
        self._slots = [_Slot() for _ in range(self.max_batch)]
        self._results: dict = {}
        self._max_blocks_per_seq = max(2, self._num_blocks // max(1, self.max_batch))
        self._scratch_tables = torch.tensor(
            np.tile(np.asarray(self._scratch, np.int64)[:, None],
                    (1, self._max_blocks_per_seq)), device=self.device)
        self._req_counter = 0
        # the macro-step's inputs: one int64 row a lane (_LEN ...), staged
        # on the host (pinned on the card) and copied to the device buffer
        # the captured steps read; temperatures travel as float32 bits
        cols = 1 + self._max_blocks_per_seq + (7 if draft_model is None else 3)
        self._stage = torch.zeros((self.max_batch, cols), dtype=torch.int64,
                                  pin_memory=self.device.type == "cuda")
        self._inputs = torch.zeros_like(self._stage, device=self.device)
        self._vocab_hash = sampling.vocab_hash(cfg.vocab_size, self.device)
        self._step_fns: dict = {}  # D -> graphs.Captured
        # the schedule searcher's verdicts (Decisions) and the configs the
        # engine runs, resolved at first use
        self.decode_decision = self.prefill_decision = None
        self._decode_chain_cfg = _CHAIN_UNSET
        self._prefill_chain_cfg = _CHAIN_UNSET
        # the multi-tenant LoRA tier: the slot-stacked pack, written in
        # place by installs (the captured steps read it at fixed addresses)
        self._pack = None
        if adapters is not None:
            self._init_pack(model, adapters)
        _ENGINES.add(self)
        _DECODE_STATS["pool_bytes"] = self.pool_bytes()
        _DECODE_STATS["pool_bytes_per_device"] = sum(pa.pool_device_nbytes(p)
                                                      for p in self._all_pools())
        _DECODE_STATS["mesh_shape"] = ""

    def _init_pack(self, model, adapters):
        from paddle_tpu_torch.nn.lora import AdapterPack

        if isinstance(adapters, AdapterPack):
            pack = adapters
        elif isinstance(adapters, int) and not isinstance(adapters, bool):
            pack = AdapterPack(model, rank=adapters)
        elif isinstance(adapters, dict):
            pack = AdapterPack(model, **adapters)
        else:
            raise TypeError("adapters must be an int rank, a config dict, or an "
                            f"nn.AdapterPack; got {type(adapters).__name__}")
        if pack.device != self.device:
            raise ValueError(f"the adapter pack lies on {pack.device}, the engine runs on "
                             f"{self.device}")
        self._pack = pack
        S = pack.num_slots
        self._adapter_registry: dict = {}  # name -> (host arrays, alpha)
        self._slot_names = [None] * S      # slot -> installed adapter name
        self._slot_epochs = [0] * S        # bumped at every content change
        self._slot_refs = [0] * S          # requests in flight on each slot
        self._slot_used = [0] * S          # LRU clock marks
        self._slot_clock = 0
        _LORA_STATS["slots_total"] = S - 1
        _LORA_STATS["slots_resident"] = 0

    def _alloc_pools(self, cfg, total):
        """Per-layer K and V pools of ``cfg``'s geometry: ``total`` pages
        of ``[Nkv, bs, H]``, int8 QuantPools when the engine's pools are
        int8, else the model's dtype."""
        nkv, hd = cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads
        pools = [pa.alloc_paged_cache(total, nkv, self.block_size, hd,
                                      "int8" if self._kv_dtype == "int8" else cfg.torch_dtype,
                                      self.device)
                 for _ in range(cfg.num_hidden_layers)]
        return [k for k, _ in pools], [v for _, v in pools]

    def _all_pools(self):
        pools = self._kpools + self._vpools
        if self.draft_model is not None:
            pools = pools + self._d_kpools + self._d_vpools
        return pools

    def pool_bytes(self) -> int:
        """Resident bytes of every layer's K and V pools, the draft's too
        (scratch pages and int8 scales included)."""
        return sum(pa.pool_nbytes(p) for p in self._all_pools())

    # ------------------------------------------------------------ requests
    def has_work(self):
        """Active or PREFILLING lanes, queued or parked requests.  A
        draining engine's queue is not its work: it rode the drain
        snapshot and belongs to the restore target."""
        return (any(s.active or s.prefill is not None for s in self._slots)
                or ((bool(self._pending) or bool(self._parked)) and not self._draining))

    def pending_requests(self):
        """Request ids queued for admission; they retry at the next
        macro-step boundary."""
        return [req["rid"] for req in self._pending]

    def parked_requests(self):
        """Request ids preempted to the host (their pages parked there);
        they re-admit, bit-identically, at a later boundary."""
        return list(self._parked)

    def prefilling_requests(self):
        """Request ids whose interleaved prefill is in progress."""
        return [s.rid for s in self._slots if s.prefill is not None]

    def result(self, rid):
        return self._results.get(rid)

    # ---------------------------------------------------- adapter registry
    def _require_pack(self):
        if self._pack is None:
            raise RuntimeError("this engine was built without adapters=; pass "
                               "GenerationEngine(adapters=rank_or_config) to serve "
                               "multi-tenant LoRA")
        return self._pack

    def _ns(self, ad_slot):
        """The prefix tree namespace of an adapter slot: ``(slot, epoch)``
        on adapter engines, None otherwise."""
        return None if self._pack is None else (ad_slot, self._slot_epochs[ad_slot])

    def _adapter_scope(self, ad_slot):
        """The adapter prefill hooks of ``ad_slot`` (none for slot 0 or
        without a pack)."""
        if self._pack is None or not ad_slot:
            return contextlib.nullcontext()
        from paddle_tpu_torch.nn.lora import adapter_prefill_scope

        return adapter_prefill_scope(self.model.model.layers, self._pack, ad_slot)

    def _slot_of(self, name):
        return next((s for s, n in enumerate(self._slot_names) if n == name), None)

    def _touch_slot(self, slot):
        self._slot_clock += 1
        self._slot_used[slot] = self._slot_clock

    def _bump_epoch(self, slot):
        """Make ``slot``'s prefix subtree unreachable (its old ``(slot,
        epoch)`` namespace is dropped, its refcount-zero pages freed now)."""
        if self._prefix is not None:
            self._free.extend(self._prefix.drop_subtree((slot, self._slot_epochs[slot]),
                                                        self._ref))
        self._slot_epochs[slot] += 1
        _LORA_STATS["cache_epochs"] += 1

    def _resident_count(self):
        return sum(1 for n in self._slot_names[1:] if n is not None)

    def register_adapter(self, name, state_dict, alpha=None):
        """Register a LoRA adapter (an adapter-only state dict, as
        ``nn.lora_state_dict`` gives it, torch tensors or arrays) and
        install it into a free or LRU-reclaimable pack slot.  Returns the
        slot, or None when every slot serves requests in flight: the
        adapter stays registered and installs when one of its requests is
        admitted (requests queue on slot exhaustion, never raise).  An
        install writes the pack in place, so the captured steps serve it
        at their next replay.  ``alpha`` defaults to the pack's.
        Re-registering a resident name writes the new weights into its
        slot and bumps its epoch; it raises while the adapter has active
        requests."""
        pack = self._require_pack()
        from paddle_tpu_torch.nn.lora import parse_adapter_state_dict

        arrays = parse_adapter_state_dict(state_dict, pack.num_layers, pack.targets, pack.rank)
        slot = self._slot_of(name)
        if slot is not None:
            if self._slot_refs[slot] > 0:
                raise RuntimeError(f"adapter {name!r} has in-flight requests; re-registering "
                                   "would change their weights mid-stream; drain them first")
            self._adapter_registry[name] = (arrays, alpha)
            self._bump_epoch(slot)
            pack.set_slot(slot, arrays, alpha)
            self._touch_slot(slot)
            _LORA_STATS["swaps"] += 1
            return slot
        self._adapter_registry[name] = (arrays, alpha)
        return self._try_install(name)

    def _try_install(self, name):
        """Make ``name`` resident: its slot, a free one, or the least
        recently used idle one (never a slot with requests in flight).
        Returns the slot, or None when every slot is busy."""
        slot = self._slot_of(name)
        if slot is not None:
            self._touch_slot(slot)
            return slot
        arrays, alpha = self._adapter_registry[name]
        S = self._pack.num_slots
        free = next((s for s in range(1, S) if self._slot_names[s] is None), None)
        if free is None:
            idle = [s for s in range(1, S) if self._slot_refs[s] == 0]
            if not idle:
                return None
            free = min(idle, key=lambda s: self._slot_used[s])
            self._slot_names[free] = None
            _LORA_STATS["evictions"] += 1
        # the install writes every target (omitted ones zero); the epoch
        # bump first strands the old contents' cached subtree
        self._bump_epoch(free)
        self._pack.set_slot(free, arrays, alpha)
        self._slot_names[free] = name
        self._touch_slot(free)
        _LORA_STATS["swaps"] += 1
        _LORA_STATS["slots_resident"] = self._resident_count()
        return free

    def evict_adapter(self, name):
        """Unregister ``name`` and zero its slot (its prefix subtree
        dropped).  Raises while the adapter has requests active or queued;
        an unregistered name raises ``KeyError``."""
        self._require_pack()
        if name not in self._adapter_registry:
            raise KeyError(f"adapter {name!r} is not registered")
        slot = self._slot_of(name)
        in_flight = slot is not None and self._slot_refs[slot] > 0
        if in_flight or any(r.get("adapter") == name for r in self._pending):
            raise RuntimeError(f"adapter {name!r} has in-flight requests "
                               f"({'active' if in_flight else 'queued'}); drain them before "
                               "evicting")
        del self._adapter_registry[name]
        if slot is not None:
            self._slot_names[slot] = None
            self._bump_epoch(slot)
            self._pack.clear_slot(slot)
            _LORA_STATS["evictions"] += 1
            _LORA_STATS["slots_resident"] = self._resident_count()

    def adapter_slots(self):
        """``{adapter name: slot}`` of the resident adapters."""
        self._require_pack()
        return {n: s for s, n in enumerate(self._slot_names) if n is not None}

    # ----------------------------------------------------------- allocator
    def _alloc(self, n):
        """n free blocks, refcount 1 each.  Under pressure refcount-zero
        cached pages are evicted LRU first; a real shortfall raises
        _PoolExhausted (admission backs out and waits)."""
        if len(self._free) < n and self._prefix is not None:
            freed = self._prefix.evict(n - len(self._free), self._ref)
            self._free.extend(freed)
            _DECODE_STATS["prefix_evictions"] += len(freed)
        if len(self._free) < n:
            raise _PoolExhausted(f"paged pool exhausted: need {n} blocks, "
                                 f"{len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def _unref(self, blocks):
        """Drop one reference a block; a block left with none goes back to
        the free list unless the prefix tree caches it (then it stays
        resident and reclaimable)."""
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] <= 0 and (self._prefix is None or not self._prefix.holds(b)):
                self._free.append(b)

    def _free_fresh(self, fresh):
        """Back out blocks taken by ``_alloc`` that nothing else holds."""
        for b in fresh:
            self._ref[b] = 0
            self._free.append(b)

    def _release(self, slot):
        self._unref(slot.blocks)
        if self._pack is not None:
            self._slot_refs[slot.adapter_slot] -= 1
        slot.adapter_slot = 0
        slot.blocks = []
        slot.active = False
        slot.rid = None
        slot.req = None
        slot.prefill = None

    def add_request(self, rid, prompt_ids, max_new_tokens=16, temperature=None, seed=0,
                    adapter=None, nonce=None, priority="normal"):
        """Prefill the prompt, pour its K/V into pool pages, occupy a lane.

        With the prefix cache on, the longest cached full-block prefix of
        the prompt is matched first: those pages are referenced, and only
        the suffix runs through the model.  Returns the first generated
        token, or None when the request was queued (no free lane or pool
        pages now, or older requests of its class or a higher one still
        waiting); a queued request is admitted at a later ``step()`` and
        its first token surfaces in that step's output.  With interleaved
        prefill (``prefill_chunk_blocks`` > 0) it always queues and returns
        None.  A request that can never fit the per-sequence block table
        raises.

        temperature None/0 decodes greedily; > 0 samples with the
        counter-based sampler (``serving/sampling.py``) keyed by ``(seed,
        nonce)``.  The nonce is reserved at submit time (``nonce=None``
        takes the engine's counter; an explicit nonce moves the counter
        past it), so a queued, preempted or re-dispatched request draws the
        stream it would have drawn at once.  ``priority``: "high",
        "normal" or "low"; LOW requests may be preempted
        (``FLAGS_preempt_low_priority``).  ``adapter``: the name of a
        registered adapter (``register_adapter``), None for the base
        model; when no pack slot can take it now the request queues, and
        an unregistered name raises ``KeyError``.  A draining engine
        raises ``RuntimeError``."""
        if self._draining:
            raise RuntimeError("engine is draining (drain(): snapshot taken, admissions "
                               "closed); submit to the restored engine instead")
        if self.draft_model is not None and float(temperature or 0.0) > 0.0:
            # before any allocation: a refused request holds nothing
            raise ValueError("speculative decoding slots are greedy-only (sampled "
                             "acceptance needs rejection sampling); drop temperature")
        prompt = np.asarray(prompt_ids, np.int64).reshape(1, -1)
        max_len = prompt.shape[1] + int(max_new_tokens)
        # a verify writes up to K + 1 positions past a lane's length before
        # acceptance rolls it back: they must land in pages the request owns
        headroom = 0 if self.draft_model is None else self.num_speculative + 1
        n_blocks = -(-(max_len + headroom) // self.block_size)
        if n_blocks > self._max_blocks_per_seq:
            raise RuntimeError(f"request needs {n_blocks} blocks > per-seq table width "
                               f"{self._max_blocks_per_seq}")
        if adapter is not None:
            self._require_pack()
            if adapter not in self._adapter_registry:
                raise KeyError(f"adapter {adapter!r} is not registered on this engine; call "
                               "register_adapter first")
        if priority not in _PRIORITY:
            raise ValueError(f"priority must be one of {sorted(_PRIORITY)}, got {priority!r}")
        if nonce is None:
            nonce = self._req_counter
            self._req_counter += 1
        else:
            nonce = int(nonce)
            self._req_counter = max(self._req_counter, nonce + 1)
        req = {"rid": rid, "prompt": prompt, "max_len": max_len, "n_blocks": n_blocks,
               "temperature": float(temperature or 0.0), "seed": int(seed), "nonce": nonce,
               "adapter": adapter, "pri": _PRIORITY[priority], "seq": self._submit_seq}
        self._submit_seq += 1
        if self._prefill_chunk_blocks() > 0:
            # interleaved: admission happens at boundaries only
            self._pending.append(req)
            return None
        if self._pending or not self._try_admit(req):
            self._pending.append(req)
            return None
        return self._results[rid][0]

    def _prefill_chunk_blocks(self) -> int:
        """The interleaved prefill budget in blocks a step (0 = atomic).
        Speculative engines always admit atomically: admission pours the
        draft pools too, and an interleaved prefill would leave the draft's
        coverage behind mid-prompt."""
        if self.draft_model is not None:
            return 0
        if self.prefill_chunk_blocks is not None:
            return self.prefill_chunk_blocks
        return max(0, int(_flags.flag("FLAGS_prefill_chunk_blocks")))

    def _admit_pending(self):
        """Retry queued and parked requests at a macro-step boundary, in
        (class, submit order), the two kinds in one ordering.  When the head
        request is above LOW and cannot be admitted, a LOW resident may be
        preempted (``_preempt_one``) to make room.  Returns the ids admitted
        atomically (their first token is ready); interleaved reservations
        surface when their prefill finishes, and re-admitted parked
        requests delivered their first token long ago."""
        admitted = []
        interleaved = self._prefill_chunk_blocks() > 0
        while True:
            cands = [((rec["req"]["pri"], rec["req"]["seq"]), None, rid)
                     for rid, rec in self._parked.items()]
            cands += [((req["pri"], req["seq"]), req, req["rid"]) for req in self._pending]
            if not cands:
                break
            key, req, rid = min(cands, key=lambda c: c[0])
            if req is None:
                ok = self._try_unpark(rid)
            elif interleaved:
                ok = self._begin_prefill(req)
            else:
                ok = self._try_admit(req)
                if ok:
                    admitted.append(rid)
            if ok:
                if req is not None:
                    self._drop_pending(req)
                continue
            if key[0] < _PRIORITY["low"] and self._preempt_one():
                continue
            if not any(s.active or s.prefill is not None for s in self._slots):
                raise RuntimeError(f"queued request {rid!r} cannot be admitted with an idle "
                                   "engine (pool too small?)")
            break
        return admitted

    def _drop_pending(self, req):
        # by identity: a request holds a numpy prompt, which == cannot compare
        for i, r in enumerate(self._pending):
            if r is req:
                del self._pending[i]
                return

    def _free_slot(self):
        return next((s for s in self._slots if not s.active and s.prefill is None), None)

    def _install_for(self, req):
        """The pack slot of the request's adapter, installed now if it
        must be (0 for the base model); None when no slot is free."""
        if self._pack is None or req.get("adapter") is None:
            return 0
        return self._try_install(req["adapter"])

    def _reserve(self, req, ns):
        """Match the prompt in the prefix cache under namespace ``ns``
        (referencing the matched pages) and take fresh blocks for the
        rest.  Returns (matched, fresh), or None with nothing held when the
        pool is short."""
        matched = []
        if self._prefix is not None:
            s0 = req["prompt"].shape[1]
            matched = self._prefix.match(_tokens(req), max_blocks=(s0 - 1) // self.block_size,
                                         ns=ns)
            for b in matched:
                self._ref[b] += 1
        try:
            fresh = self._alloc(req["n_blocks"] - len(matched))
        except _PoolExhausted:
            self._unref(matched)
            return None
        return matched, fresh

    @torch.no_grad()
    def _try_admit(self, req):
        """One atomic admission: prefix match, allocate, prefill the suffix
        (whole or in ``prefill_chunk`` chunks), pour it, occupy a lane.
        Returns False, with nothing held, when no lane or too few pool
        pages are free; an error backs out the same way and re-raises."""
        slot = self._free_slot()
        if slot is None:
            return False
        # the adapter holds a pack slot before the prefill: its deltas
        # feed the K/V the prefill pours
        ad_slot = self._install_for(req)
        if ad_slot is None:
            return False
        got = self._reserve(req, self._ns(ad_slot))
        if got is None:
            return False
        matched, fresh = got
        blocks = matched + fresh
        m_len = len(matched) * self.block_size
        mm = self.model.model
        prompt = req["prompt"]
        s0 = prompt.shape[1]
        try:
            caches = self._prefix_or_empty(matched, m_len)
            ids = torch.as_tensor(prompt, device=self.device)
            # an adapter request prefills through its adapter (forward
            # hooks on the pack's targets), so the poured K/V is what the
            # adapted model caches
            with self._adapter_scope(ad_slot):
                if self.prefill_chunk is None or s0 - m_len <= self.prefill_chunk:
                    h, caches = _model_forward_cached(mm, ids[:, m_len:], caches, m_len)
                else:
                    # fixed-size chunks through the cached forward
                    # (bottom-right causal against the cache so far) cap
                    # the activations of a long prompt; an accepted
                    # prefill-chain config runs each chunk it tiles as its
                    # kernel
                    with prefill_chain_scope(self._resolve_prefill_chain()):
                        for off in range(m_len, s0, self.prefill_chunk):
                            h, caches = _model_forward_cached(
                                mm, ids[:, off:off + self.prefill_chunk], caches, off)
                logits_last = self.model._logits(h[:, -1:, :])[0, -1, :]
            # the suffix's K/V into this request's own pages: the matched
            # pages are shared and never written
            self._pour(caches, blocks, s0, start_tok=m_len)
            if self.draft_model is not None:
                # the draft prefills the same suffix whole, into its pools,
                # with the base model (a cached page holds both pool sets:
                # every admission that inserted it poured both)
                d_caches = self._prefix_or_empty(matched, m_len, draft=True)
                _, d_caches = _model_forward_cached(self.draft_model.model, ids[:, m_len:],
                                                    d_caches, m_len)
                self._pour(d_caches, blocks, s0, start_tok=m_len, draft=True)
                slot.d_seq_len = s0
        except BaseException:
            self._free_fresh(fresh)
            self._unref(matched)
            raise
        slot.blocks = blocks
        self._hold_adapter(slot, ad_slot)
        self._commit(slot, req, logits_last, len(matched))
        return True

    def _hold_adapter(self, slot, ad_slot):
        """The lane serves through ``ad_slot``: an in-flight reference pins
        the pack slot (LRU installs and ``evict_adapter`` refuse it)."""
        slot.adapter_slot = ad_slot
        if self._pack is not None:
            self._slot_refs[ad_slot] += 1
            self._touch_slot(ad_slot)

    def _commit(self, slot, req, logits_last, n_matched):
        """The lane becomes active: its first token (argmax, or sampled at
        counter 0), the prompt's full blocks into the prefix tree, the
        counters; a request that stops at its first token finishes."""
        s0 = req["prompt"].shape[1]
        slot.rid = req["rid"]
        slot.active = True
        slot.prefill = None
        slot.seq_len = s0
        slot.max_len = req["max_len"]
        slot.priority = req["pri"]
        slot.req = req
        slot.temperature = req["temperature"]
        slot.key = _request_seed(req["seed"], req["nonce"])
        if slot.temperature > 0.0:
            dev = self.device
            first = int(sampling.sample(
                logits_last[None], torch.tensor([slot.temperature], device=dev),
                torch.tensor([slot.key], device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev), self._vocab_hash)[0])
        else:
            first = int(torch.argmax(logits_last))
        slot.last_token = first
        slot.generated = [first]
        self._results[slot.rid] = slot.generated
        if self._prefix is not None:
            # full prompt blocks become shared pages; the partial tail block
            # stays private (copy on write)
            self._prefix.insert(_tokens(req), slot.blocks[:s0 // self.block_size],
                                ns=self._ns(slot.adapter_slot))
            if n_matched:
                _DECODE_STATS["prefix_hits"] += 1
                _DECODE_STATS["prefix_hit_tokens"] += n_matched * self.block_size
            else:
                _DECODE_STATS["prefix_misses"] += 1
        _DECODE_STATS["resident_peak"] = max(_DECODE_STATS["resident_peak"],
                                             sum(1 for s in self._slots if s.active))
        _DECODE_STATS["admitted_" + _PRI_NAMES[slot.priority]] += 1
        if self.eos_token_id is not None and first == self.eos_token_id:
            self._finish(slot)
        elif slot.seq_len + 1 >= slot.max_len:
            self._finish(slot)

    # ------------------------------------------- interleaved prefill (PREFILLING)
    def _begin_prefill(self, req):
        """Interleaved admission, the reservation: a lane, the prefix
        match and fresh blocks now; the prompt then advances one block a
        granted chunk (``_advance_prefills``).  The lane is PREFILLING:
        inactive to the decode step, which parks it on its scratch page.
        Returns False, with nothing held, on a shortage."""
        slot = self._free_slot()
        if slot is None:
            return False
        ad_slot = self._install_for(req)
        if ad_slot is None:
            return False
        got = self._reserve(req, self._ns(ad_slot))
        if got is None:
            return False
        matched, fresh = got
        m_len = len(matched) * self.block_size
        try:
            caches = self._prefix_or_empty(matched, m_len)
        except BaseException:
            self._free_fresh(fresh)
            self._unref(matched)
            raise
        slot.rid = req["rid"]
        slot.blocks = matched + fresh
        slot.priority = req["pri"]
        slot.req = req
        self._hold_adapter(slot, ad_slot)
        slot.prefill = _PrefillState(req=req, caches=caches, matched=list(matched),
                                     fresh=list(fresh), off=m_len, poured=len(matched),
                                     since=self._macro_steps)
        return True

    def _pressure(self, slot) -> int:
        """A PREFILLING lane's pressure: its class weight times the
        boundaries it has waited (macro-steps, never wall time, so the
        schedule reproduces)."""
        return _PRI_WEIGHT[slot.priority] * (1 + self._macro_steps - slot.prefill.since)

    def _prefill_budget(self) -> int:
        """This boundary's chunk grants: N = prefill_chunk_blocks while
        requests decode, 2N once the most pressed prefill reaches
        _PRESSURE_ESCALATE, unbounded (-1) when nothing decodes."""
        n = self._prefill_chunk_blocks()
        if not any(s.active for s in self._slots):
            return -1
        peak = max(self._pressure(s) for s in self._slots if s.prefill is not None)
        return 2 * n if peak >= _PRESSURE_ESCALATE else n

    def _advance_prefills(self):
        """Run this boundary's chunk budget, each grant to the most pressed
        PREFILLING lane (ranked again per grant).  Returns the ids whose
        prefill finished: their first token surfaces in this step."""
        finished = []
        if not any(s.prefill is not None for s in self._slots):
            return finished
        budget = self._prefill_budget()
        while budget != 0:
            work = [s for s in self._slots if s.prefill is not None]
            if not work:
                break
            slot = max(work, key=self._pressure)
            rid = slot.rid
            if self._prefill_chunk_step(slot):
                finished.append(rid)
            budget -= 1
        return finished

    @torch.no_grad()
    def _prefill_chunk_step(self, slot):
        """One granted chunk: forward the prompt's next block-sized span
        through the cached forward, pour each block it completed, and put
        the poured full blocks into the prefix tree (a later admission can
        hit them while this prefill is still running).  Returns True when
        the prompt is done and the lane active."""
        st = slot.prefill
        prompt = st.req["prompt"]
        s0 = prompt.shape[1]
        bs = self.block_size
        try:
            with prefill_chain_scope(self._resolve_prefill_chain()), \
                    self._adapter_scope(slot.adapter_slot):
                ids = torch.as_tensor(prompt[:, st.off:st.off + bs], device=self.device)
                st.h, st.caches = _model_forward_cached(self.model.model, ids, st.caches,
                                                        st.off)
                st.off += ids.shape[1]
            _DECODE_STATS["prefill_chunks"] += 1
            while st.poured < st.off // bs:
                self._pour_block(slot, st.poured)
                st.poured += 1
            if self._prefix is not None and st.poured > len(st.matched):
                self._prefix.insert(_tokens(st.req)[:st.poured * bs], slot.blocks[:st.poured],
                                    ns=self._ns(slot.adapter_slot))
            if st.off < s0:
                return False
            self._finish_prefill(slot)
            return True
        except BaseException:
            # the request is forfeit; poured pages the tree holds stay cached
            self._cancel_prefill(slot)
            raise

    def _pour_block(self, slot, j):
        """Pour prompt block j (tokens [j*bs, (j+1)*bs)) from the lane's
        naive caches into its j-th page, in place."""
        bs = self.block_size
        lo, b = j * bs, slot.blocks[j]
        for li, (k, v) in enumerate(slot.prefill.caches):
            pa.paged_pour_block(self._kpools[li], k[0, lo:lo + bs].transpose(0, 1), b)
            pa.paged_pour_block(self._vpools[li], v[0, lo:lo + bs].transpose(0, 1), b)

    def _finish_prefill(self, slot):
        """The last chunk landed: pour the rest from the first unpoured
        block (the partial tail and the zero-padded decode pages, the
        atomic pour's coverage), and commit the lane from the last chunk's
        logits."""
        st = slot.prefill
        logits_last = self.model._logits(st.h[:, -1:, :])[0, -1, :]
        self._pour(st.caches, slot.blocks, st.req["prompt"].shape[1],
                   start_tok=st.poured * self.block_size)
        self._commit(slot, st.req, logits_last, len(st.matched))

    def _cancel_prefill(self, slot, requeue=False):
        """Back a PREFILLING lane out: its references dropped (pages the
        tree took stay cached), the lane cleared; with ``requeue`` the
        submission goes back to the queue (prefill is deterministic, so a
        demotion costs work, never a different stream)."""
        st = slot.prefill
        self._unref(st.fresh)
        self._unref(st.matched)
        if self._pack is not None:
            self._slot_refs[slot.adapter_slot] -= 1
        slot.adapter_slot = 0
        slot.blocks = []
        slot.rid = None
        slot.req = None
        slot.prefill = None
        if requeue:
            self._pending.append(st.req)

    # ------------------------------------------- preemption (parking lot)
    def _preempt_one(self):
        """Preempt one LOW-priority request for a blocked higher class: an
        active one parks (least progress first, then lane order); else a
        PREFILLING one goes back to the queue.  Returns True when one
        was."""
        if not _flags.flag("FLAGS_preempt_low_priority"):
            return False
        if self.draft_model is not None:
            return False  # parking ships the target's pages only
        # a parked record carries no adapter: only base-model lanes park
        victims = [s for s in self._slots if s.active and s.priority >= _PRIORITY["low"]
                   and s.adapter_slot == 0 and s.req is not None]
        if victims:
            self._park_request(min(victims,
                                   key=lambda s: (len(s.generated), self._slots.index(s))))
            return True
        pf = [s for s in self._slots if s.prefill is not None and s.priority >= _PRIORITY["low"]]
        if pf:
            self._cancel_prefill(pf[0], requeue=True)
            _DECODE_STATS["preemptions"] += 1
            return True
        return False

    def _park_request(self, slot):
        """Park an active request: its state and its pages (verbatim, to
        the host) into the parking lot; its blocks free now."""
        from .snapshot import park_request_state

        self._parked[slot.rid] = park_request_state(self, slot)
        self._release(slot)
        _DECODE_STATS["preemptions"] += 1
        _DECODE_STATS["parked_requests"] = len(self._parked)

    def _try_unpark(self, rid):
        """Re-admit a parked request into a free lane and fresh blocks, its
        pages placed verbatim; the stream goes on where it stopped.
        Returns False, leaving it parked, on a shortage."""
        from .snapshot import unpark_request_state

        slot = self._free_slot()
        if slot is None or not unpark_request_state(self, slot, self._parked[rid]):
            return False
        del self._parked[rid]
        self._hold_adapter(slot, 0)
        self._results[rid] = slot.generated  # a live stream aliases its lane's list
        _DECODE_STATS["preempt_readmits"] += 1
        _DECODE_STATS["parked_requests"] = len(self._parked)
        _DECODE_STATS["resident_peak"] = max(_DECODE_STATS["resident_peak"],
                                             sum(1 for s in self._slots if s.active))
        return True

    # ----------------------------------------------------------- page moves
    def _pool_set(self, draft):
        """``(kpools, vpools, model config)`` of the target or the draft."""
        if draft:
            return self._d_kpools, self._d_vpools, self.draft_model.config
        return self._kpools, self._vpools, self.model.config

    def _prefix_or_empty(self, matched, m_len, draft=False):
        """The naive caches a suffix prefill starts from: the matched
        prefix gathered from the target's (or the draft's) pools (``[1, L,
        Nkv, H]`` a layer, in the model's dtype; int8 pages dequantized),
        or empty ones."""
        kpools, vpools, cfg = self._pool_set(draft)
        dt = cfg.torch_dtype
        if not m_len:
            nkv, hd = cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads
            return [(torch.zeros((1, 0, nkv, hd), dtype=dt, device=self.device),) * 2
                    for _ in range(cfg.num_hidden_layers)]
        tables = torch.as_tensor([matched], dtype=torch.long, device=self.device)
        return [tuple(pa.paged_gather(pool, tables)[:, :, :m_len].transpose(1, 2).to(dt)
                      for pool in (kc, vc))
                for kc, vc in zip(kpools, vpools)]

    def _pour(self, caches, blocks, s0, start_tok=0, draft=False):
        """Scatter the naive caches ``[1, S, Nkv, H]`` into the request's
        pages of the target's (or the draft's) pools from the block-aligned
        ``start_tok`` on (the pages before it are matched or already
        poured); the tail of the last page is zero-padded."""
        kpools, vpools, _ = self._pool_set(draft)
        bs = self.block_size
        tgt = blocks[start_tok // bs:]
        n_t = len(tgt)
        pad = start_tok + n_t * bs - s0
        idx = torch.as_tensor(tgt, dtype=torch.long, device=self.device)
        for li, (k, v) in enumerate(caches):
            for pool, kv in ((kpools[li], k), (vpools[li], v)):
                kv = kv.transpose(1, 2)[:, :, start_tok:]  # [1, Nkv, S', H]
                if pad:
                    kv = torch.nn.functional.pad(kv, (0, 0, 0, pad))
                kv = kv.reshape(kv.shape[1], n_t, bs, kv.shape[-1]).transpose(0, 1)
                pa.paged_pour_blocks(pool, kv, idx)

    def _finish(self, slot):
        _DECODE_STATS["completed_" + _PRI_NAMES[slot.priority]] += 1
        self._results[slot.rid] = list(slot.generated)
        self._release(slot)

    def adopt_pages(self, prompt_ids, k_blocks, v_blocks, ns=None):
        """Adopt pages prefilled elsewhere as cached prefix pages: per layer
        a ``pool_get_blocks`` dict for K and one for V, covering the
        prompt's first full blocks.  The pages land verbatim, in place, in
        fresh blocks, and the prompt's full-block chunks enter the prefix
        tree with refcount zero (resident, reclaimable, matched by the next
        ``add_request`` of this prompt).  Chunks the tree already holds
        keep their pages.  Best effort: under pool pressure, or with the
        prefix already cached, fewer (maybe no) blocks are adopted;
        returns how many.  Needs the prefix cache (RuntimeError); a page
        kind or geometry other than the pool's raises ValueError.

        ``ns`` is the sender's ``(slot, epoch)`` adapter namespace, pinned
        when the pages were shipped: on an adapter engine they land in that
        namespace (``ns=None`` is slot 0's, the base model's).  A stale
        epoch (the slot was re-registered or evicted since) drops the
        pages, counts ``lora_stats()["ship_ns_drops"]`` and returns 0; a
        namespace on an engine without adapters raises ValueError."""
        if self._prefix is None:
            raise RuntimeError("adopt_pages needs the prefix cache: adopted pages are "
                               "delivered as cached prefixes (prefix_cache=True)")
        if self.draft_model is not None:
            raise RuntimeError("adopt_pages on a speculative engine is not supported: "
                               "shipped pages cover the target pools only, and a "
                               "draft-pool-less prefix would desynchronize d_seq_len")
        if self._pack is None:
            if ns is not None:
                raise ValueError(f"adopt_pages got adapter namespace ns={tuple(ns)} but this "
                                 "engine was built without adapters=: adapter-poured K/V "
                                 "must never enter a base engine's prefix cache")
        else:
            slot, epoch = ((0, self._slot_epochs[0]) if ns is None
                           else (int(ns[0]), int(ns[1])))
            if not 0 <= slot < self._pack.num_slots:
                raise ValueError(f"adopt_pages namespace slot {slot} out of range "
                                 f"[0, {self._pack.num_slots}) for this engine's pack")
            if epoch != self._slot_epochs[slot]:
                # K/V of weights this engine no longer serves: never cached
                _LORA_STATS["ship_ns_drops"] += 1
                return 0
            ns = (slot, epoch)
        if len(k_blocks) != self._n_layers or len(v_blocks) != self._n_layers:
            raise ValueError(f"adopted pages cover {len(k_blocks)}/{len(v_blocks)} layers; "
                             f"this engine has {self._n_layers}")
        bs = self.block_size
        want_leaves = {name for name, _ in pa.pool_parts(self._kpools[0])}
        for li in range(self._n_layers):
            for leaves in (k_blocks[li], v_blocks[li]):
                if set(leaves) != want_leaves:
                    raise ValueError(f"adopted page leaves {sorted(leaves)} != pool kind "
                                     f"{sorted(want_leaves)} (layer {li}; kv_cache_dtype "
                                     "mismatch between sender and this engine?)")
                got = tuple(leaves["payload"].shape[1:])
                if got != (self._nkv, bs, self._head_dim):
                    raise ValueError(f"adopted page geometry {got} != pool "
                                     f"{(self._nkv, bs, self._head_dim)} (layer {li})")
        n_wire = int(k_blocks[0]["payload"].shape[0])
        toks = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        n = min(n_wire, len(toks) // bs)
        matched = self._prefix.match(toks[:n * bs], ns=ns)
        start = len(matched)
        if start >= n:
            return 0
        try:
            fresh = self._alloc(n - start)
        except _PoolExhausted:
            return 0
        for b in fresh:
            self._ref[b] = 0  # cached, unreferenced: reclaimable
        for li in range(self._n_layers):
            for pool, pages in ((self._kpools[li], k_blocks[li]),
                                (self._vpools[li], v_blocks[li])):
                pa.pool_set_blocks(pool, fresh, {k: t[start:n] for k, t in pages.items()})
        self._prefix.insert(toks[:n * bs], matched + fresh, ns=ns)
        return len(fresh)

    # ---------------------------------------------------- fault tolerance
    def snapshot(self, dir, step=None) -> int:
        """Commit a restorable snapshot of this engine under ``dir``
        (``serving/snapshot.py``: the pools, the allocator, the prefix
        tree, the requests, the adapter tier) through the atomic commit
        protocol.  Call between ``step()``s.  Returns the committed step
        tag (default: the macro-step count)."""
        from .snapshot import EngineSnapshot

        store = self._snapshot_store
        if store is None or store.dir != str(dir):
            # one store per engine and directory: its validity cache keeps
            # the retention sweep from hashing every kept snapshot again
            store = self._snapshot_store = EngineSnapshot(dir)
        return store.save(self, step=step)

    def install_preemption_handler(self, signals=None):
        """SIGTERM-style preemption: the handler only sets a flag (a signal
        handler is no place for device syncs or disk writes); the next
        ``maybe_snapshot()`` at a macro-step boundary writes the final
        snapshot, and ``preemption_saved`` then says so.  The original
        disposition is kept for ``uninstall_preemption_handler``."""
        import signal as _signal

        if signals is None:
            signals = (_signal.SIGTERM,)

        def _handler(signum, frame):
            self._preempt_requested = True

        for sig in signals:
            prev = _signal.signal(sig, _handler)
            # a second install keeps the original, not this engine's handler
            self._prev_handlers.setdefault(sig, prev)

    def uninstall_preemption_handler(self):
        import signal as _signal

        for sig, prev in self._prev_handlers.items():
            _signal.signal(sig, prev)
        self._prev_handlers.clear()

    @property
    def preemption_requested(self) -> bool:
        return self._preempt_requested

    @property
    def preemption_saved(self) -> bool:
        """True once a preemption-triggered snapshot was committed."""
        return self._preempt_saved

    def maybe_snapshot(self, dir=None, step=None):
        """Snapshot when one is due: a pending preemption, or
        ``FLAGS_engine_snapshot_interval`` boundaries since the last
        periodic one.  ``step()`` calls it at the end of every macro-step
        (a no-op while ``FLAGS_engine_snapshot_dir`` is empty and ``dir``
        is None).  A draining engine never snapshots again.  Returns the
        committed step tag, or None."""
        if self._draining:
            return None
        d = dir if dir is not None else _flags.flag("FLAGS_engine_snapshot_dir")
        if not d:
            return None
        due = self._preempt_requested and not self._preempt_saved
        if not due:
            # boundaries since the last periodic save, not a modulo: idle
            # boundaries call in without moving the count
            interval = int(_flags.flag("FLAGS_engine_snapshot_interval"))
            due = (interval > 0 and self._macro_steps > 0
                   and self._macro_steps - self._last_auto_snapshot >= interval)
        if not due:
            return None
        st = self.snapshot(d, step=step)
        self._last_auto_snapshot = self._macro_steps
        if self._preempt_requested:
            self._preempt_saved = True
        return st

    def drain(self, dir=None, step=None) -> int:
        """Migration or scale-down: PREFILLING lanes and parked requests go
        back to the queue, a final snapshot is committed (``dir`` or
        ``FLAGS_engine_snapshot_dir``), and admissions close
        (``add_request`` raises, the queue is the restore target's, and
        ``maybe_snapshot`` is disarmed).  The resident requests may go on
        stepping to their end.  Returns the snapshot's step.  A second
        drain returns the same step for the same directory and raises
        ``ValueError`` for another."""
        if self._draining and self._drain_step is not None:
            if dir is not None and str(dir) != self._drain_dir:
                raise ValueError(f"engine already drained to {self._drain_dir!r} (step "
                                 f"{self._drain_step}); a re-drain to {dir!r} cannot capture "
                                 "the handoff state again; restore from the first directory")
            return self._drain_step
        d = dir if dir is not None else _flags.flag("FLAGS_engine_snapshot_dir")
        if not d:
            raise ValueError("drain() needs a snapshot directory: pass dir= or set "
                             "FLAGS_engine_snapshot_dir")
        # PREFILLING lanes and parked requests ride the snapshot as queued
        # submissions; the restore target replays them from (seed, nonce)
        for s in self._slots:
            if s.prefill is not None:
                self._cancel_prefill(s, requeue=True)
        for rid in list(self._parked):
            self._pending.append(self._parked.pop(rid)["req"])
        _DECODE_STATS["parked_requests"] = len(self._parked)
        self._draining = True
        self._drain_dir = str(d)
        st = self._drain_step = self.snapshot(d, step=step)
        from .snapshot import _SNAPSHOT_STATS

        _SNAPSHOT_STATS["drains"] += 1
        return st

    # -------------------------------------------------------------- decode
    def _effective_chunk(self) -> int:
        if self._decode_chunk is not None:
            return self._decode_chunk
        return max(1, int(_flags.flag("FLAGS_decode_chunk")))

    def _resolve_decode_chain(self):
        """The engine's decode-chain verdict, resolved once (and again after
        a flag change): with FLAGS_schedule_search and
        FLAGS_schedule_search_decode on, the searcher serves this geometry's
        cached verdict or searches it (parity against the plain twin, then
        the measured-win gate); an accepted config makes every decode layer
        run as one kernel launch, anything else keeps the plain ops."""
        if self._decode_chain_cfg is not _CHAIN_UNSET:
            return self._decode_chain_cfg
        cfg = None
        if _flags.flag("FLAGS_schedule_search") and _flags.flag("FLAGS_schedule_search_decode"):
            _SCHED_DECODE_STATS["decode_chains_found"] += 1
            spec = dc.DecodeChainSpec(
                batch=self.max_batch, num_heads=self.model.config.num_attention_heads,
                num_kv_heads=self._nkv, head_dim=self._head_dim, block_size=self.block_size,
                max_blocks=self._max_blocks_per_seq,
                num_blocks=self._num_blocks + self.max_batch, kv=self._kv_dtype,
                dtype=self.model.config.dtype, device=self.device)
            self.decode_decision = dc.ensure_decision(spec)
            if self.decode_decision.accepted:
                cfg = dict(self.decode_decision.config)
                _SCHED_DECODE_STATS["decode_chains_accepted"] += 1
            else:
                _SCHED_DECODE_STATS["decode_chains_disabled"] += 1
        self._decode_chain_cfg = cfg
        return cfg

    def _resolve_prefill_chain(self):
        """The chunked-prefill twin of ``_resolve_decode_chain``: engines
        that prefill in chunks search the canonical mid-prompt geometry, a
        chunk against twice as many cached positions; the chunk is
        ``prefill_chunk``, or one block for interleaved engines (every
        granted chunk is one block).  An accepted config runs every chunk
        it tiles as the prefill-chain kernel."""
        if self._prefill_chain_cfg is not _CHAIN_UNSET:
            return self._prefill_chain_cfg
        cfg = None
        eff = self.block_size if self._prefill_chunk_blocks() > 0 else self.prefill_chunk
        if (eff is not None and eff >= 2 and _flags.flag("FLAGS_schedule_search")
                and _flags.flag("FLAGS_schedule_search_decode")):
            _SCHED_DECODE_STATS["prefill_chains_found"] += 1
            spec = dc.PrefillChainSpec(seq=eff, kv_len=2 * eff,
                                       num_heads=self.model.config.num_attention_heads,
                                       head_dim=self._head_dim,
                                       dtype=self.model.config.dtype, device=self.device)
            self.prefill_decision = dc.ensure_decision(spec)
            if self.prefill_decision.accepted:
                cfg = dict(self.prefill_decision.config)
                _SCHED_DECODE_STATS["prefill_chains_accepted"] += 1
            else:
                _SCHED_DECODE_STATS["prefill_chains_disabled"] += 1
        self._prefill_chain_cfg = cfg
        return cfg

    def _decode_body(self, chunk):
        """The macro-step body: ``chunk`` decode tokens for every lane,
        all on the device, from the input buffer alone (``_fill_inputs``).
        Lanes that stop (EOS, or no room left within max_len) flip
        ``done``; from then on their writes land on their scratch page
        with lens 1, their counters freeze, and their tokens are dropped
        on the host.  On an adapter engine every layer adds each row's
        gathered adapter delta (the pack read in place, the rows' scaling
        gathered on the device).  The decode-chain verdict is resolved
        here, outside the body: a captured step holds it.  Returns the
        body, which returns ``[B, chunk]`` token ids."""
        model = self.model
        mm = model.model
        eos = self.eos_token_id
        chain_cfg = self._resolve_decode_chain()
        w, inp = self._max_blocks_per_seq, self._inputs
        c = 1 + w  # the first column after the tables
        pack = self._pack

        @torch.no_grad()
        def body():
            tokens, tables = inp[:, :1], inp[:, 1:c]
            lens, max_lens = inp[:, c + _LEN], inp[:, c + _MAX_LEN]
            done, keys = inp[:, c + _DONE] != 0, inp[:, c + _KEY]
            counters = inp[:, c + _COUNTER]
            temps = inp[:, c + _TEMP].to(torch.int32).view(torch.float32)
            lora = {}
            if pack is not None:
                slots = inp[:, c + _SLOT]
                lora = {"adapters": pack.ab, "slots": slots,
                        "scaling": pack.scaling.index_select(0, slots)}
            out = []
            for _ in range(chunk):
                tables_eff = torch.where(done[:, None], self._scratch_tables, tables)
                lens_eff = torch.where(done, torch.ones_like(lens), lens)
                h = mm.embed_tokens(tokens)
                h, kp, vp = _decode_layers_paged(
                    mm.layers, h, mm.rope_cos, mm.rope_sin, self._kpools, self._vpools,
                    tables_eff, lens_eff, chain_cfg, **lora)
                _check_in_place(kp + vp, self._kpools + self._vpools)
                lg = model._logits(mm.norm(h))[:, -1, :]
                nxt = sampling.sample(lg, temps, keys, counters, self._vocab_hash)
                fin = (nxt == eos) if eos is not None else torch.zeros_like(done)
                new_done = done | fin | (lens + 1 >= max_lens)
                lens = torch.where(done, lens, lens + 1)
                counters = torch.where(done, counters, counters + 1)
                done = new_done
                tokens = nxt[:, None]
                out.append(nxt)
            return torch.stack(out, dim=1)

        return body

    def _fill_inputs(self, idle=False):
        """Stage every lane's step inputs and copy them to the device
        buffer.  Inactive lanes (PREFILLING ones too; every lane when
        ``idle``) park on their scratch page with lens 1 and done set."""
        w, c = self._max_blocks_per_seq, 1 + self._max_blocks_per_seq
        st = self._stage.numpy()
        st[:] = 0
        st[:, c + _LEN] = 1
        st[:, c + _DONE] = 1
        for i, s in enumerate(self._slots):
            if s.active and not idle:
                st[i, 0] = s.last_token
                st[i, 1:c] = list(s.blocks) + [s.blocks[-1]] * (w - len(s.blocks))
                st[i, c + _LEN] = s.seq_len + 1  # includes the token being decoded
                st[i, c + _MAX_LEN] = s.max_len
                st[i, c + _DONE] = 0
                st[i, c + _KEY] = s.key
                st[i, c + _COUNTER] = len(s.generated)  # this request's token counter
                st[i, c + _TEMP] = int(np.float32(s.temperature).view(np.int32))
                st[i, c + _SLOT] = s.adapter_slot
            else:
                st[i, 1:c] = self._scratch[i]  # park masked lanes off-pool
        # the idle fill is rare: a blocking copy, so the next fill cannot
        # overwrite the staging area under it
        self._inputs.copy_(self._stage, non_blocking=not idle)

    def _build_step(self, chunk):
        """Warm up and capture the D = ``chunk`` macro-step (on the CPU:
        keep its body).  The card's warm-up runs with every lane idle, so
        it writes only scratch pages and leaves the shared pool as it was;
        a later fill of the inputs is what a replay decodes."""
        self._fill_inputs(idle=True)
        return graphs.capture(self._decode_body(chunk), self.device)

    def warmup(self, chunks=None, *, prefill=True, adopt=True):
        """Build and capture this engine's hot steps before traffic (the
        JAX engine's ``warmup``, which compiles them).  ``chunks`` lists
        the decode widths D to capture (default: the effective chunk); each
        lands in the ``_step_fns`` table ``step()`` consults.  The one
        D-token step is also the tail step: lanes that finish mid-chunk
        park on their scratch pages.  ``prefill=True`` also runs the
        admission prefill of a single-block prompt over empty caches,
        which builds the prefill's kernels, cuBLAS's handles and the
        Triton JIT (longer prompts still meet new shapes lazily).
        ``adopt=True``, with the prefix cache on, round-trips the first
        scratch page of layer 0 through ``pool_get_blocks`` /
        ``pool_set_blocks``, the page moves of adoption and parking
        (scratch contents are garbage by design).  A speculative engine,
        as the JAX one, warms neither the macro-step (it runs ticks, which
        it captures at the first) nor the adoption round trip (it adopts
        nothing).  Returns ``{"chunks": [warmed widths], "seconds":
        wall}``, capture and instantiation included."""
        t0 = time.perf_counter()
        spec = self.draft_model is not None
        todo = [] if spec else sorted({int(c) for c in (
            chunks if chunks is not None else [self._effective_chunk()])})
        if any(d < 1 for d in todo):
            raise ValueError("decode chunk widths must be >= 1")
        for d in todo:
            if d not in self._step_fns:
                self._step_fns[d] = self._build_step(d)
        if prefill:
            cfg = self.model.config
            caches = [(torch.zeros((1, 0, self._nkv, self._head_dim), dtype=cfg.torch_dtype,
                                   device=self.device),) * 2 for _ in range(self._n_layers)]
            dummy = torch.zeros((1, self.block_size), dtype=torch.int64, device=self.device)
            with torch.no_grad():
                h, _ = _model_forward_cached(self.model.model, dummy, caches, 0)
                self.model._logits(h[:, -1:, :])
        if adopt and self._prefix is not None and not spec:
            idx = [self._scratch[0]]
            for pool in (self._kpools[0], self._vpools[0]):
                pa.pool_set_blocks(pool, idx, pa.pool_get_blocks(pool, idx))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"chunks": todo, "seconds": time.perf_counter() - t0}

    def step(self):
        """One macro-step boundary and decode step: queued and parked
        requests are admitted (in class order, preempting LOW ones where
        a higher class is blocked), interleaved prefills advance by this
        step's chunk budget, then D = decode_chunk tokens advance for every
        active lane (a speculative engine: one tick, 1 to K + 1 tokens a
        lane).  Requests are admitted and retired only here.  Returns
        ``{rid: [tok, ...]}`` (``{rid: tok}`` at D == 1 on a plain
        engine; a speculative engine always emits lists); a request
        admitted from the queue in this step (or whose interleaved prefill
        finished in it) always maps to a list led by its prefill-produced
        first token."""
        return self._macro_step(eager=False)

    def _step_eager(self):
        """``step()`` through the eager body in place of the captured
        step: the yardstick the timing tools and the card checks compare
        the graph with, not a serving option."""
        return self._macro_step(eager=True)

    def _macro_step(self, eager):
        if not self.has_work():
            # an idle engine is at a boundary too: a pending preemption
            # commits its snapshot here
            self.maybe_snapshot()
            return {}
        # a draining engine admits nothing: its queue rode the drain
        # snapshot and is the restore target's to serve
        admitted = [] if self._draining else self._admit_pending()
        admitted.extend(self._advance_prefills())
        if not any(s.active for s in self._slots):
            # admitted requests may have finished at admission
            self._macro_steps += 1
            self.maybe_snapshot()
            return {rid: list(self._results[rid]) for rid in admitted}
        t_start = time.perf_counter()
        if self._pack is not None:
            _LORA_STATS["gather_dispatches"] += 1
        if self.draft_model is not None:
            out = self._spec_step(eager)
            _DECODE_STATS["tokens"] += sum(len(v) for v in out.values())
            _DECODE_STATS["macro_steps"] += 1
            _DECODE_STATS["step_seconds"] += time.perf_counter() - t_start
            # after the counters: prefill first tokens are not decode tokens
            self._merge_admitted(out, admitted)
            self._macro_steps += 1
            self.maybe_snapshot()
            return out
        D = self._effective_chunk()
        if eager:
            run = self._decode_body(D)
        else:
            step_fn = self._step_fns.get(D)
            if step_fn is None:
                step_fn = self._step_fns[D] = self._build_step(D)
            run = step_fn.replay
        self._fill_inputs()
        dev = run()
        t_sync = time.perf_counter()
        nxt = dev.cpu().numpy()  # [B, D]: the one device sync per step
        _DECODE_STATS["sync_seconds"] += time.perf_counter() - t_sync
        _DECODE_STATS["dispatches"] += 1
        _DECODE_STATS["macro_steps"] += 1
        _DECODE_STATS["last_chunk"] = D

        out = {}
        for i, s in enumerate(self._slots):
            if not s.active:
                continue
            rid = s.rid  # _finish() clears the slot's rid
            emitted = []
            for j in range(D):
                tok = int(nxt[i, j])
                s.seq_len += 1
                s.last_token = tok
                s.generated.append(tok)
                emitted.append(tok)
                if (self.eos_token_id is not None and tok == self.eos_token_id) or (
                        s.seq_len + 1 >= s.max_len):
                    self._finish(s)
                    break
            out[rid] = emitted if D > 1 else emitted[0]
            _DECODE_STATS["tokens"] += len(emitted)
        _DECODE_STATS["step_seconds"] += time.perf_counter() - t_start
        self._merge_admitted(out, admitted)
        self._macro_steps += 1
        self.maybe_snapshot()  # a boundary: a no-op without a snapshot directory
        return out

    def _merge_admitted(self, out, admitted):
        """Lead each newly admitted request's entry with its prefill first
        token (always a list, even at D == 1)."""
        for rid in admitted:
            first = self._results[rid][0]
            got = out.get(rid)
            if got is None:
                out[rid] = [first]
            elif isinstance(got, list):
                out[rid] = [first] + got
            else:
                out[rid] = [first, got]

    # ---------------------------------------------------------- speculative
    def spec_stats(self):
        """Speculative acceptance counters (None on plain engines): ticks,
        proposed, accepted, emitted.  accepted / proposed is the mean
        acceptance; emitted / ticks the tokens a lane gains a tick."""
        return None if self.draft_model is None else dict(self._spec_stats)

    def _spec_body(self):
        """The speculative tick's body, from the input buffer alone
        (``_fill_spec_inputs``): K + 1 draft steps, each draft argmax
        feeding the next step on the device (step j at lens ``d_seq_len +
        1 + j``; the last step only writes the last proposal's K/V, so the
        draft pools always cover their own proposals), then the target's
        verify of the chunk ``[last token, K proposals]`` at lens
        ``seq_len + K + 1``.  Inactive lanes ride their scratch pages with
        lengths from 0.  On an adapter engine the draft proposes with the
        base model and the verify goes through each row's adapter, so
        acceptance keeps only tokens the adapted model decodes.  Returns
        ``[B, 2K + 1]``: the K proposals, then the target's K + 1 greedy
        predictions."""
        K = self.num_speculative
        draft, dm = self.draft_model, self.draft_model.model
        model, mm = self.model, self.model.model
        inp, c = self._inputs, 1 + self._max_blocks_per_seq
        pack = self._pack

        @torch.no_grad()
        def body():
            last, tables = inp[:, :1], inp[:, 1:c]
            seq0, d0 = inp[:, c + _SEQ], inp[:, c + _DSEQ]
            tok, props = last, []
            for j in range(K + 1):
                h = dm.embed_tokens(tok)
                h, kp, vp = _decode_layers_paged(dm.layers, h, dm.rope_cos, dm.rope_sin,
                                                 self._d_kpools, self._d_vpools, tables,
                                                 d0 + 1 + j)
                _check_in_place(kp + vp, self._d_kpools + self._d_vpools)
                if j < K:
                    nxt = torch.argmax(draft._logits(dm.norm(h))[:, -1, :], dim=-1)
                    props.append(nxt)
                    tok = nxt[:, None]
            proposals = torch.stack(props, dim=1)
            lora = {}
            if pack is not None:
                slots = inp[:, c + _SPEC_SLOT]
                lora = {"adapters": pack.ab, "slots": slots,
                        "scaling": pack.scaling.index_select(0, slots)}
            h = mm.embed_tokens(torch.cat([last, proposals], dim=1))
            h, kp, vp = _decode_layers_paged(mm.layers, h, mm.rope_cos, mm.rope_sin,
                                             self._kpools, self._vpools, tables,
                                             seq0 + K + 1, chunk=True, **lora)
            _check_in_place(kp + vp, self._kpools + self._vpools)
            preds = torch.argmax(model._logits(mm.norm(h)), dim=-1)
            return torch.cat([proposals, preds], dim=1)

        return body

    def _fill_spec_inputs(self, idle=False):
        """Stage every lane's tick inputs and copy them to the device buffer:
        inactive lanes (every lane when ``idle``) get their scratch page and
        zeros."""
        w, c = self._max_blocks_per_seq, 1 + self._max_blocks_per_seq
        st = self._stage.numpy()
        st[:] = 0
        for i, s in enumerate(self._slots):
            if s.active and not idle:
                st[i, 0] = s.last_token
                st[i, 1:c] = list(s.blocks) + [s.blocks[-1]] * (w - len(s.blocks))
                st[i, c + _SEQ] = s.seq_len
                st[i, c + _DSEQ] = s.d_seq_len
                st[i, c + _SPEC_SLOT] = s.adapter_slot
            else:
                st[i, 1:c] = self._scratch[i]
        self._inputs.copy_(self._stage, non_blocking=not idle)

    def _build_spec(self):
        """Warm up and capture the tick (on the CPU: keep its body); the
        card's warm-up runs every lane idle, on scratch pages only."""
        self._fill_spec_inputs(idle=True)
        return graphs.capture(self._spec_body(), self.device)

    def _spec_step(self, eager):
        """One speculative tick: the recorded body (``_spec_body``; built at
        the first tick), one device-to-host copy of proposals and
        predictions, then per-lane greedy acceptance: the longest run of
        proposals the target predicted too, then the target's own token
        after it, cut at EOS or ``max_len``.  Rejected positions in both
        pool sets die by lens bookkeeping (pages are positional).  The
        counters count as the JAX engine's: K + 1 draft dispatches and one
        verify a tick."""
        K = self.num_speculative
        if eager:
            run = self._spec_body()
        else:
            if self._spec_fn is None:
                self._spec_fn = self._build_spec()
            run = self._spec_fn.replay
        self._fill_spec_inputs()
        dev = run()
        t_sync = time.perf_counter()
        res = dev.cpu().numpy()  # [B, 2K + 1]: the one device sync a tick
        _DECODE_STATS["sync_seconds"] += time.perf_counter() - t_sync
        _DECODE_STATS["dispatches"] += K + 2
        proposals, preds = res[:, :K], res[:, K:]
        self._spec_stats["ticks"] += 1
        out = {}
        for i, sl in enumerate(self._slots):
            if not sl.active:
                continue
            accepted = 0
            while accepted < K and preds[i, accepted] == proposals[i, accepted]:
                accepted += 1
            self._spec_stats["proposed"] += K
            self._spec_stats["accepted"] += accepted
            new_toks = [int(t) for t in proposals[i, :accepted]] + [int(preds[i, accepted])]
            base_seq = sl.seq_len
            emitted, finish = [], False
            for t in new_toks:
                emitted.append(t)
                sl.generated.append(t)
                if (self.eos_token_id is not None and t == self.eos_token_id) or (
                        base_seq + 1 + len(emitted) >= sl.max_len):
                    finish = True
                    break
            # the pools hold prompt + generated[:-1]; so does the draft's
            sl.seq_len = sl.d_seq_len = base_seq + len(emitted)
            sl.last_token = emitted[-1]
            out[sl.rid] = emitted
            self._spec_stats["emitted"] += len(emitted)
            if finish:
                self._finish(sl)
        return out


from .snapshot import (EngineSnapshot, reset_snapshot_stats, restore_engine,  # noqa: E402
                       snapshot_stats)
