"""Continuous-batching generation over a shared paged-KV pool
(counterpart of paddle_tpu/serving/__init__.py ``GenerationEngine``).

Ported: the block allocator with one scratch page per batch lane, request
admission with a FIFO pending queue under pool pressure, prefill through
the cached forward (whole, or in ``prefill_chunk``-token chunks) and the
pour into pool pages, bf16 or int8 pools (``kv_cache_dtype``), the
macro-step decode of D tokens per ``step()`` with finished lanes masked
onto their scratch pages, EOS and ``max_len`` stops, per-request
temperature sampling inside the step (``serving/sampling.py``),
``warmup()``, and the schedule searcher's serving chains: with
``FLAGS_schedule_search`` the engine resolves once, at first use, a
decode-chain and a prefill-chain verdict for its geometry
(``_resolve_decode_chain`` / ``_resolve_prefill_chain``) and runs the
accepted kernels; a flag change re-arms both and drops the captured steps.

In JAX the D-token macro-step is one ``lax.scan`` inside a jitted program,
compiled once per D.  Here its body reads fixed device buffers (tokens,
tables, lens, max_lens, done, temperatures, keys and counters, filled by
one copy from a pinned host area at every ``step()``), the pools and the
weights, and is recorded once per D as a CUDA graph (``_core/graphs.py``)
that every ``step()`` replays, with one device-to-host copy of the
``[B, D]`` tokens.  On the CPU the same body runs eagerly.  The admission
prefill stays eager, as in the JAX package (its length varies by prompt).
Options of the JAX engine that this package does not port yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

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

__all__ = ["GenerationEngine", "schedule_decode_stats", "reset_schedule_decode_stats"]

_SERVING_ITEM = "ROADMAP.md A.2 (serving features)"
_DIST_ITEM = "ROADMAP.md A.6 (distributed)"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


# Serving-chain counters of the schedule search: found = engines that
# consulted the searcher for their decode (or chunked-prefill) geometry;
# accepted = engines that adopted a kernel config; disabled = engines that
# kept the plain ops (a measured loss, a cached loss, or a cached config
# that failed its parity re-check).
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
        eng._decode_chain_cfg = _CHAIN_UNSET
        eng._prefill_chain_cfg = _CHAIN_UNSET


@dataclass
class _Slot:
    rid: object = None
    active: bool = False
    seq_len: int = 0          # tokens stored in the pool (incl. prompt)
    max_len: int = 0          # seq_len limit for this request
    blocks: list = field(default_factory=list)
    last_token: int = 0
    generated: list = field(default_factory=list)
    temperature: float = 0.0  # 0 = greedy
    key: int = 0              # the sampler's key, _request_seed(seed, nonce)


# the step's input row of a lane, one int64 each: the last token, the W
# block-table entries, then these columns
_LEN, _MAX_LEN, _DONE, _KEY, _COUNTER, _TEMP = range(6)


def _request_seed(seed: int, nonce: int) -> int:
    """A 63-bit sampler key from the request's (seed, nonce)."""
    state = np.random.SeedSequence([seed & (2**63 - 1), nonce]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


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
    graph at its first use, or ahead of traffic by ``warmup()``.
    ``device=None`` means the CUDA card and raises without one; the model
    must lie on the engine's device.
    """

    def __init__(self, model, max_batch=4, block_size=16, num_blocks=128,
                 eos_token_id=None, mesh=None, prefill_chunk=None,
                 draft_model=None, decode_chunk=None,
                 prefix_cache=None, kv_cache_dtype=None, adapters=None,
                 prefill_chunk_blocks=None, device=None):
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh=)", _DIST_ITEM)
        if draft_model is not None:
            raise _not_ported("speculative decoding (draft_model=)", _SERVING_ITEM)
        if adapters is not None:
            raise _not_ported("multi-tenant LoRA serving (adapters=)", _SERVING_ITEM)
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError("prefill_chunk must be a positive token count")
        pcb = (prefill_chunk_blocks if prefill_chunk_blocks is not None
               else _flags.flag("FLAGS_prefill_chunk_blocks"))
        if int(pcb) < 0:
            raise ValueError("prefill_chunk_blocks must be >= 0 (0 = atomic prefill)")
        if int(pcb) > 0:
            raise _not_ported("interleaved chunked prefill (prefill_chunk_blocks > 0)",
                              _SERVING_ITEM)
        pc = prefix_cache if prefix_cache is not None else _flags.flag("FLAGS_prefix_cache")
        if pc:
            raise _not_ported("the radix prefix cache (prefix_cache=True)", _SERVING_ITEM)
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
        self._kv_dtype = kv_dt  # resolved once: the pools are allocated now

        # pool pages [num_blocks, Nkv, bs, H] per layer, plus one scratch
        # page per lane (masked lanes write there, never the shared pool);
        # int8 pools are QuantPools (payload plus per-page scales)
        self._num_blocks = int(num_blocks)
        total = self._num_blocks + self.max_batch
        pools = [pa.alloc_paged_cache(total, self._nkv, self.block_size, self._head_dim,
                                      "int8" if kv_dt == "int8" else cfg.torch_dtype,
                                      self.device)
                 for _ in range(self._n_layers)]
        self._kpools = [k for k, _ in pools]
        self._vpools = [v for _, v in pools]
        self._free = list(range(self._num_blocks))
        self._pending: deque = deque()
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
        self._stage = torch.zeros((self.max_batch, 1 + self._max_blocks_per_seq + 6),
                                  dtype=torch.int64, pin_memory=self.device.type == "cuda")
        self._inputs = torch.zeros_like(self._stage, device=self.device)
        self._vocab_hash = sampling.vocab_hash(cfg.vocab_size, self.device)
        self._step_fns: dict = {}  # D -> graphs.Captured
        # the schedule searcher's verdicts (Decisions) and the configs the
        # engine runs, resolved at first use
        self.decode_decision = self.prefill_decision = None
        self._decode_chain_cfg = _CHAIN_UNSET
        self._prefill_chain_cfg = _CHAIN_UNSET
        _ENGINES.add(self)

    def pool_bytes(self) -> int:
        """Resident bytes of every layer's K and V pools (scratch pages and
        int8 scales included)."""
        return sum(pa.pool_nbytes(p) for p in self._kpools + self._vpools)

    # ------------------------------------------------------------ requests
    def has_work(self):
        return any(s.active for s in self._slots) or bool(self._pending)

    def pending_requests(self):
        """Request ids queued for admission (pool pressure); they retry at
        the next macro-step boundary."""
        return [req["rid"] for req in self._pending]

    def result(self, rid):
        return self._results.get(rid)

    def snapshot(self, *args, **kwargs):
        raise _not_ported("engine snapshots", _SERVING_ITEM)

    def drain(self, *args, **kwargs):
        raise _not_ported("engine drain", _SERVING_ITEM)

    def _alloc(self, n):
        """n free pool blocks, or None when fewer are free.  Each block has
        one owner (no prefix sharing yet), so no refcounts."""
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def _release(self, slot):
        self._free.extend(slot.blocks)
        slot.blocks = []
        slot.active = False
        slot.rid = None

    def add_request(self, rid, prompt_ids, max_new_tokens=16, temperature=None, seed=0,
                    adapter=None, priority="normal"):
        """Prefill the prompt, pour its K/V into pool pages, occupy a lane.

        Returns the first generated token, or None when the request was
        queued (no free lane or pool pages right now, or older requests
        still waiting); a queued request is admitted at a later ``step()``
        and its first token surfaces in that step's output.  A request
        that can never fit the per-sequence block table raises.

        temperature None/0 decodes greedily; > 0 samples with the
        counter-based sampler (``serving/sampling.py``) keyed by ``(seed,
        nonce)``, where the nonce is reserved at submit time, so a queued
        request draws the same stream an immediately admitted one
        would."""
        if adapter is not None:
            raise _not_ported("LoRA adapters (adapter=)", _SERVING_ITEM)
        if priority != "normal":
            raise _not_ported("priority classes and preemption", _SERVING_ITEM)
        prompt = np.asarray(prompt_ids, np.int64).reshape(1, -1)
        max_len = prompt.shape[1] + int(max_new_tokens)
        n_blocks = -(-max_len // self.block_size)
        if n_blocks > self._max_blocks_per_seq:
            raise RuntimeError(f"request needs {n_blocks} blocks > per-seq table width "
                               f"{self._max_blocks_per_seq}")
        nonce = self._req_counter
        self._req_counter += 1
        req = {"rid": rid, "prompt": prompt, "max_len": max_len, "n_blocks": n_blocks,
               "temperature": float(temperature or 0.0), "seed": int(seed), "nonce": nonce}
        if self._pending or not self._try_admit(req):
            self._pending.append(req)
            return None
        return self._results[rid][0]

    def _admit_pending(self):
        """Retry queued admissions in submit order at a macro-step
        boundary; returns the admitted request ids."""
        admitted = []
        while self._pending:
            req = self._pending[0]
            if self._try_admit(req):
                self._pending.popleft()
                admitted.append(req["rid"])
                continue
            if not any(s.active for s in self._slots):
                raise RuntimeError(f"queued request {req['rid']!r} cannot be admitted "
                                   "with an idle engine (pool too small?)")
            break
        return admitted

    @torch.no_grad()
    def _try_admit(self, req):
        """One admission attempt: allocate, prefill, pour, occupy a lane.
        Returns False, with nothing allocated, when no lane or too few
        pool pages are free."""
        slot = next((s for s in self._slots if not s.active), None)
        if slot is None:
            return False
        blocks = self._alloc(req["n_blocks"])
        if blocks is None:
            return False
        model = self.model
        prompt = req["prompt"]
        s0 = prompt.shape[1]
        try:
            caches = [(torch.zeros((1, 0, self._nkv, self._head_dim),
                                   dtype=model.config.torch_dtype, device=self.device),) * 2
                      for _ in range(self._n_layers)]
            ids = torch.as_tensor(prompt, device=self.device)
            if self.prefill_chunk is None or s0 <= self.prefill_chunk:
                h, caches = _model_forward_cached(model.model, ids, caches, 0)
            else:
                # fixed-size chunks through the cached forward (bottom-right
                # causal against the cache so far) cap the activations of a
                # long prompt; an accepted prefill-chain config runs each
                # divisible chunk's attention core as its kernel
                with prefill_chain_scope(self._resolve_prefill_chain()):
                    for off in range(0, s0, self.prefill_chunk):
                        h, caches = _model_forward_cached(
                            model.model, ids[:, off:off + self.prefill_chunk], caches, off)
            logits_last = model._logits(h[:, -1:, :])[0, -1, :]
            self._pour(caches, blocks, s0)
        except BaseException:
            self._free.extend(blocks)
            raise

        slot.rid = req["rid"]
        slot.active = True
        slot.seq_len = s0
        slot.max_len = req["max_len"]
        slot.blocks = blocks
        slot.temperature = req["temperature"]
        slot.key = _request_seed(req["seed"], req["nonce"])
        if slot.temperature > 0.0:
            # counter 0: this request's first generated token
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
        if self.eos_token_id is not None and first == self.eos_token_id:
            self._finish(slot)
        elif slot.seq_len + 1 >= slot.max_len:
            self._finish(slot)
        return True

    def _pour(self, caches, blocks, s0):
        """Scatter the naive prefill caches ``[1, S, Nkv, H]`` into the
        request's pool pages (the tail of the last page zero-padded)."""
        bs = self.block_size
        n_t = len(blocks)
        pad = n_t * bs - s0
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for li, (k, v) in enumerate(caches):
            for pool, kv in ((self._kpools[li], k), (self._vpools[li], v)):
                kv = kv.transpose(1, 2)  # [1, Nkv, S, H]
                if pad:
                    kv = torch.nn.functional.pad(kv, (0, 0, 0, pad))
                kv = kv.reshape(self._nkv, n_t, bs, self._head_dim).transpose(0, 1)
                pa.paged_pour_blocks(pool, kv, idx)

    def _finish(self, slot):
        self._results[slot.rid] = list(slot.generated)
        self._release(slot)

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
        with a ``prefill_chunk`` search the canonical mid-prompt geometry,
        a chunk of ``prefill_chunk`` tokens against twice as many cached
        positions; an accepted config runs every chunk it tiles as the
        prefill-chain kernel."""
        if self._prefill_chain_cfg is not _CHAIN_UNSET:
            return self._prefill_chain_cfg
        cfg = None
        eff = self.prefill_chunk
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
        on the host.  The decode-chain verdict is resolved here, outside
        the body: a captured step holds it.  Returns the body, which
        returns ``[B, chunk]`` token ids."""
        model = self.model
        mm = model.model
        eos = self.eos_token_id
        chain_cfg = self._resolve_decode_chain()
        w, inp = self._max_blocks_per_seq, self._inputs
        c = 1 + w  # the first column after the tables

        @torch.no_grad()
        def body():
            tokens, tables = inp[:, :1], inp[:, 1:c]
            lens, max_lens = inp[:, c + _LEN], inp[:, c + _MAX_LEN]
            done, keys = inp[:, c + _DONE] != 0, inp[:, c + _KEY]
            counters = inp[:, c + _COUNTER]
            temps = inp[:, c + _TEMP].to(torch.int32).view(torch.float32)
            out = []
            for _ in range(chunk):
                tables_eff = torch.where(done[:, None], self._scratch_tables, tables)
                lens_eff = torch.where(done, torch.ones_like(lens), lens)
                h = mm.embed_tokens(tokens)
                h, kp, vp = _decode_layers_paged(
                    mm.layers, h, mm.rope_cos, mm.rope_sin, self._kpools, self._vpools,
                    tables_eff, lens_eff, chain_cfg)
                if any(a is not b for a, b in zip(kp + vp, self._kpools + self._vpools)):
                    raise RuntimeError("a pool write returned a new pool: a captured step "
                                       "must write the pools in place")
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
        buffer.  Inactive lanes (every lane when ``idle``) park on their
        scratch page with lens 1 and done set."""
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
        ``adopt`` is accepted and does nothing: it warms the prefix
        cache's page adoption, which the port does not have yet.  Returns
        ``{"chunks": [warmed widths], "seconds": wall}``, capture and
        instantiation included."""
        t0 = time.perf_counter()
        todo = sorted({int(c) for c in (
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"chunks": todo, "seconds": time.perf_counter() - t0}

    def step(self):
        """One macro-step for every live request: D = decode_chunk tokens
        advance; requests are admitted and retired only here.  Returns
        ``{rid: [tok, ...]}`` (``{rid: tok}`` at D == 1); a request admitted
        from the pending queue in this step always maps to a list led by
        its prefill-produced first token."""
        return self._macro_step(eager=False)

    def _step_eager(self):
        """``step()`` through the eager body in place of the captured
        step: the yardstick the timing tools and the card checks compare
        the graph with, not a serving option."""
        return self._macro_step(eager=True)

    def _macro_step(self, eager):
        if not self.has_work():
            return {}
        admitted = self._admit_pending()
        if not any(s.active for s in self._slots):
            # admitted requests may have finished at admission
            return {rid: list(self._results[rid]) for rid in admitted}
        D = self._effective_chunk()
        if eager:
            run = self._decode_body(D)
        else:
            step_fn = self._step_fns.get(D)
            if step_fn is None:
                step_fn = self._step_fns[D] = self._build_step(D)
            run = step_fn.replay
        self._fill_inputs()
        nxt = run().cpu().numpy()  # [B, D]: the one device sync per step

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
        for rid in admitted:
            first = self._results[rid][0]
            got = out.get(rid)
            if got is None:
                out[rid] = [first]
            elif isinstance(got, list):
                out[rid] = [first] + got
            else:
                out[rid] = [first, got]
        return out
