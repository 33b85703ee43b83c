"""The serving chains as searchable kernels: the decode chain (paged write
of the new token's K and V, then attention over the pools) and the
chunked-prefill attention core.

Counterpart of paddle_tpu/ops/decode_chain.py.  ``DecodeChainSpec`` and
``PrefillChainSpec`` describe one engine geometry each and implement the
searcher protocol of ``static/schedule_search.py`` (enumerate -> roofline
-> shared memory -> parity -> measure -> measured-win gate), so verdicts
persist per device kind under the ``schedule/decode_*`` and
``schedule/prefill`` autotune namespaces and the engine adopts an accepted
config with no re-measurement (``serving._resolve_decode_chain``).

The kernels, CUDA C++ in ``csrc/decode_chain.cu`` and
``csrc/prefill_chain_sm90.cu``:

- ``decode_chain_batch`` (replaces ``_build_batch``): one launch per layer
  writes every row's token into its page (bf16, f32 or int8 pools) and
  attends over the row's live positions, one block per (row, kv head);
- ``decode_chain_rows`` (replaces ``_build_rows``, int8 pools only): the
  same function with each (row, kv head) span split over ``splits``
  blocks and the partial softmax sums merged by a second launch;
- ``prefill_chain`` (replaces ``_build_prefill``): a ``[1, S, N, H]``
  query chunk against ``[1, T, N, H]`` keys, bottom-right causal.  Two
  routes, picked by ``_prefill_route`` before any launch: bf16 takes
  ``prefill_chain_sm90.cu`` (TMA and wgmma, a block per (``block_q``
  query rows, head, key split); ``prefill_splits`` splits the key range
  where the unsplit grid leaves most of the card idle and the keys are
  long enough to pay for the combine launch that merges the partials); f32
  takes ``decode_chain.cu``'s FMA kernel, a block per (``block_q`` query
  rows, head).  Every launch counts under ``prefill_chain``, the TMA
  kernel's also under ``prefill_chain_sm90``.

Beside each, the plain version (a CPU tensor takes it): the unfused ops
``models/llama._decode_layer_paged`` runs (``paged_write`` twice, then
``paged_decode_attention``), and the plain masked attention.  These are
also the twins the searcher holds candidates against.  The candidate
space is the card's own: the TPU's ``gather: take|loop`` DMA knob means
nothing here and is not carried over.

The parity contract: the pools equal the twin's bit for bit, for both
pool kinds (a bf16 write is a copy, an int8 write is deterministic
integer math: f32 division, round half to even); the attention output is
held within a tolerance, 2e-2 for bf16 outputs and for int8 pools, 2e-5
for f32, because nothing here is bit-exact against a torch einsum: the
kernels sum in another order.  The JAX package's twin is bit-exact by
replaying its ops inside the Pallas call; that is not a property a CUDA
kernel can have.

Mesh-sharded chains (``mesh=``) are ROADMAP.md queue A item 6.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import count_launch, use_kernel
from . import paged_attention as pa

__all__ = ["DecodeChainSpec", "PrefillChainSpec", "spec_from_arrays", "ensure_decision",
           "fused_decode_step", "fused_prefill_attention", "decode_chain_batch",
           "decode_chain_rows", "decode_chain_plain", "prefill_chain", "prefill_chain_plain"]

_MESH_ITEM = "ROADMAP.md queue A item 6 (distributed)"
_MAX_GROUP = 8                 # query heads per kv head the decode kernel takes
_TILE = 32                     # positions per shared-memory tile of the kernels
_LAUNCH_S = 1e-7               # tie-breaker per launch in the roofline ranking
_ROWS_SPLITS = (2, 4, 8)
_PREFILL_BLOCK_Q = (64, 128)
_PREFILL_KEYS = 128            # keys a K/V tile of the sm90 prefill kernel
_MIN_SPLIT_TILES = 4           # K/V tiles a key split holds at the least (prefill_splits)
H100_SMS = 132                 # the card the port targets: its SM count where no card is present
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "paddle_decode_chain": [_PTR] * 13 + [_INT] * 9 + [ctypes.c_float, _PTR],
    "paddle_prefill_chain": [_PTR] * 4 + [_INT] * 4 + [_LL] * 8 + [_INT] * 2
    + [ctypes.c_float, _PTR],
    "paddle_prefill_chain_sm90": [_PTR] * 6 + [_INT] * 4 + [_LL] * 8 + [_INT] * 2
    + [ctypes.c_float, _PTR],
}
_LIBS = {"paddle_prefill_chain_sm90": "prefill_chain_sm90"}  # the rest: decode_chain
_FNS: dict = {}


def _tolerance(dtype, kv="bf16"):
    """Attention-output tolerance of the parity gate and the tests."""
    return 2e-5 if dtype == torch.float32 and kv != "int8" else 2e-2


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(dtype)]


# ------------------------------------------------------------------ kernels


def _launch(name, *args):
    """Call a C entry point of ``csrc/decode_chain.cu`` (or of the source
    ``_LIBS`` names) on the current stream (the library is built at first
    use); raise on a refused launch."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn = _FNS.get(name)
    if fn is None:
        from ._cuda_build import load

        fn = getattr(load(_LIBS.get(name, "decode_chain")), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*vals, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_chain: {name} launch failed with CUDA error {err}")


def decode_chain_plain(kc, vc, q, kn, vn, tables, lens):
    """The unfused twin, exactly ``models/llama._decode_layer_paged``'s
    sequence: write K, write V, attend.  Returns ``(o, kc, vc)``."""
    pos = lens - 1
    kc = pa.paged_write(kc, kn, tables, pos)
    vc = pa.paged_write(vc, vn, tables, pos)
    return pa.paged_decode_attention(q, kc, vc, tables, lens), kc, vc


def _decode_cuda(kc, vc, q, kn, vn, tables, lens, splits):
    int8 = isinstance(kc, pa.QuantPool)
    if int8 != isinstance(vc, pa.QuantPool):
        raise TypeError("decode_chain: the K and V pools must be of one kind")
    kd, vd = (kc.data, vc.data) if int8 else (kc, vc)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode_chain: the kernel takes bf16 or f32 q, got {q.dtype}")
    if kn.dtype != q.dtype or vn.dtype != q.dtype:
        raise TypeError("decode_chain: q, k_new and v_new must share one dtype")
    if not int8 and (kd.dtype != q.dtype or vd.dtype != q.dtype):
        raise TypeError(f"decode_chain: pools of {kd.dtype} with q of {q.dtype}")
    b, n, h = q.shape
    nb, nkv, bs, h2 = kd.shape
    if (h2 != h or vd.shape != kd.shape or kn.shape != (b, nkv, h) or vn.shape != kn.shape
            or tables.dim() != 2 or tables.shape[0] != b or lens.shape != (b,)):
        raise ValueError(f"decode_chain: shapes q {tuple(q.shape)}, k_new {tuple(kn.shape)}, "
                         f"pool {tuple(kd.shape)}, tables {tuple(tables.shape)}, "
                         f"lens {tuple(lens.shape)} do not match")
    if h not in (64, 128):
        raise ValueError(f"decode_chain: head_dim {h} is not 64 or 128")
    if n % nkv or n // nkv > _MAX_GROUP:
        raise ValueError(f"decode_chain: {n} q heads over {nkv} kv heads (at most "
                         f"{_MAX_GROUP} a group)")
    if not all(t.is_contiguous() for t in (kd, vd, q, kn, vn)):
        raise ValueError("decode_chain: pools, q, k_new and v_new must be contiguous")
    tables = tables.to(torch.int64).contiguous()
    lens = lens.to(torch.int64).contiguous()
    o = torch.empty_like(q)
    if splits > 1:
        ws_m = torch.empty((b, n, splits), dtype=torch.float32, device=q.device)
        ws_l = torch.empty_like(ws_m)
        ws_acc = torch.empty((b, n, splits, h), dtype=torch.float32, device=q.device)
    else:
        ws_m = ws_l = ws_acc = None
    _launch("paddle_decode_chain", kd, vd, kc.scale if int8 else None,
            vc.scale if int8 else None, q, kn, vn, tables, lens, o, ws_m, ws_l, ws_acc,
            b, n, nkv, h, bs, tables.shape[1], splits, int(q.dtype == torch.float32),
            int(int8), 1.0 / math.sqrt(h))
    return o


def decode_chain_batch(kc, vc, q, kn, vn, tables, lens):
    """One decode token's write-then-attend for the whole batch.

    kc/vc: pools ``[NB, Nkv, bs, H]`` (bf16, f32, or QuantPools), updated
    in place; q ``[B, N, H]``; kn/vn ``[B, Nkv, H]``; tables ``[B, W]``;
    lens ``[B]`` including this token.  Returns ``(o [B, N, H], kc, vc)``.
    A CUDA tensor launches the kernel (one launch), a CPU tensor takes the
    plain version."""
    if not use_kernel(q, kn, vn, tables, lens, pa._payload(kc), pa._payload(vc)):
        return decode_chain_plain(kc, vc, q, kn, vn, tables, lens)
    o = _decode_cuda(kc, vc, q, kn, vn, tables, lens, 1)
    count_launch("decode_chain_batch")
    return o, kc, vc


def decode_chain_rows(kc, vc, q, kn, vn, tables, lens, *, splits):
    """``decode_chain_batch``'s function on int8 pools with each (row, kv
    head) span split over ``splits`` blocks (the split kernel and the
    combine launch count as one call of this kernel)."""
    if not isinstance(kc, pa.QuantPool):
        raise ValueError("decode_chain_rows takes int8 pools only")
    if int(splits) < 2:
        raise ValueError(f"decode_chain_rows: splits {splits} < 2")
    if not use_kernel(q, kn, vn, tables, lens, kc.data, vc.data):
        return decode_chain_plain(kc, vc, q, kn, vn, tables, lens)
    o = _decode_cuda(kc, vc, q, kn, vn, tables, lens, int(splits))
    count_launch("decode_chain_rows")
    return o, kc, vc


def prefill_chain_plain(q, k, v):
    """The plain masked attention, bottom-right causal, f32 inside."""
    from .flash_attention import flash_attention_reference

    return flash_attention_reference(q, k, v, causal=True)


def _prefill_layout(t):
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _prefill_route(dtype) -> str:
    """Which kernel takes a prefill chain (inputs in the layout every route
    needs, ``_prefill_layout``: TMA's): ``"sm90"``
    (``csrc/prefill_chain_sm90.cu``) for bf16, ``"general"``
    (``decode_chain.cu``'s FMA kernel) for f32."""
    return "sm90" if dtype == torch.bfloat16 else "general"


def sm_count(device) -> int:
    """The SM count of a CUDA device; the H100's where there is no card
    (the search's cost model on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def prefill_splits(s, t, n, block_q, sms) -> int:
    """How many blocks split the key range of one (query tile, head) in the
    sm90 prefill kernel.  One split writes O itself; more add f32 partials
    and the combine launch, which on the H100 cost about what three to
    four 128-key tiles of a block do (PERF.md §6).  So the key range is
    split only where the unsplit grid leaves at least three quarters of
    the SMs idle, into as many splits as fill the card (one block an SM),
    each holding at least ``_MIN_SPLIT_TILES`` tiles, none empty (the tiles
    are dealt in equal runs).  The chained engines' 128-token chunks
    against T <= 896 keep one split."""
    blocks = -(-s // block_q) * n
    tiles = -(-t // _PREFILL_KEYS)
    if 4 * blocks > sms:
        return 1
    splits = max(1, min(sms // blocks, tiles // _MIN_SPLIT_TILES))
    per = -(-tiles // splits)
    return -(-tiles // per)


def _check_prefill(q, k, v):
    _, s, n, h = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"prefill_chain: the kernel takes bf16 or f32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if h not in (64, 128):
        raise ValueError(f"prefill_chain: head_dim {h} is not 64 or 128")
    if not all(_prefill_layout(t) for t in (q, k, v)):
        raise ValueError("prefill_chain: inputs need unit stride on H, strides that are "
                         "multiples of 8 elements and a 16-byte aligned base")


def _prefill_sm90(q, k, v, block_q):
    _, s, n, h = q.shape
    t = k.shape[1]
    splits = prefill_splits(s, t, n, block_q, sm_count(q.device))
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    ws_o = ws_lse = None
    if splits > 1:
        ws_o = torch.empty((splits, s, n, h), dtype=torch.float32, device=q.device)
        ws_lse = torch.empty((splits, n, s), dtype=torch.float32, device=q.device)
    _launch("paddle_prefill_chain_sm90", q, k, v, o, ws_o, ws_lse, s, t, n, h,
            *q.stride()[1:3], *k.stride()[1:3], *v.stride()[1:3], *o.stride()[1:3],
            int(block_q), splits, 1.0 / math.sqrt(h))
    count_launch("prefill_chain_sm90")
    count_launch("prefill_chain")
    return o


def _prefill_general(q, k, v, block_q):
    """``decode_chain.cu``'s kernels: f32 on FMA; bf16 on mma.sync (the
    route bf16 took before the sm90 kernel, kept to time against it)."""
    _, s, n, h = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("paddle_prefill_chain", q, k, v, o, s, k.shape[1], n, h,
            *q.stride()[1:3], *k.stride()[1:3], *v.stride()[1:3], *o.stride()[1:3],
            int(block_q), int(q.dtype == torch.float32), 1.0 / math.sqrt(h))
    count_launch("prefill_chain")
    return o


def prefill_chain(q, k, v, *, block_q):
    """A query chunk q ``[1, S, N, H]`` against k/v ``[1, T, N, H]`` (K/V
    already repeated over the GQA group), key j visible to query i iff
    ``j <= i + T - S``.  Returns ``[1, S, N, H]`` in q's dtype."""
    if q.dim() != 4 or q.shape[0] != 1 or k.shape != v.shape or k.shape[0] != 1 \
            or k.shape[2:] != q.shape[2:] or k.shape[1] < q.shape[1]:
        raise ValueError(f"prefill_chain: q {tuple(q.shape)} against k/v {tuple(k.shape)}")
    if int(block_q) not in _PREFILL_BLOCK_Q:
        raise ValueError(f"prefill_chain: block_q {block_q} is not one of {_PREFILL_BLOCK_Q}")
    if not use_kernel(q, k, v):
        return prefill_chain_plain(q, k, v)
    _check_prefill(q, k, v)
    if _prefill_route(q.dtype) == "sm90":
        return _prefill_sm90(q, k, v, int(block_q))
    return _prefill_general(q, k, v, int(block_q))


# ------------------------------------------------------------------- specs


@dataclass
class DecodeChainSpec:
    """One engine geometry's decode chain, ready to schedule.

    kv: 'bf16' (pools in ``dtype``) or 'int8' (QuantPools).  num_blocks
    counts the whole pool with the scratch pages; max_blocks is the
    per-sequence table width.  ``device`` is where the searcher builds its
    synthetic arguments."""

    batch: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    block_size: int
    max_blocks: int
    num_blocks: int
    kv: str = "bf16"
    dtype: object = torch.bfloat16
    device: object = "cpu"
    mesh: object = None

    def __post_init__(self):
        if self.kv not in ("bf16", "int8"):
            raise ValueError(f"kv must be 'bf16' or 'int8', got {self.kv!r}")
        if self.mesh is not None:
            raise NotImplementedError(f"mesh-sharded decode chains are not ported yet "
                                      f"({_MESH_ITEM})")
        self.dtype = _as_dtype(self.dtype)
        self.device = torch.device(self.device)

    @property
    def seq(self) -> int:
        return self.max_blocks * self.block_size

    def kernel_name(self) -> str:
        return f"schedule/decode_{self.kv}"

    def key(self) -> dict:
        return {"b": self.batch, "n": self.num_heads, "nkv": self.num_kv_heads,
                "h": self.head_dim, "bs": self.block_size, "w": self.max_blocks,
                "nb": self.num_blocks, "dtype": str(self.dtype).removeprefix("torch.")}

    def label(self) -> str:
        from .autotune import _key_str

        return f"{self.kernel_name()}|{_key_str(self.key())}"

    def config_label(self, config) -> str:
        if config.get("layout") == "rows":
            return f"#rows{config.get('splits')}"
        return "#batch"

    def enumerate_configs(self):
        """``batch`` for both pool kinds; ``rows`` with 2, 4 or 8 splits of
        each span for int8 pools (more blocks for the card's 132 SMs when
        the batch is small or the model uses GQA)."""
        out = [{"layout": "batch"}]
        if self.kv == "int8":
            out += [{"layout": "rows", "splits": s} for s in _ROWS_SPLITS]
        return out

    # ------------------------------------------------------------ cost model
    def synthetic_lens(self) -> np.ndarray:
        """Lengths of the synthetic rows, spread over the table span."""
        s = self.seq
        return np.clip(np.linspace(2, s, self.batch).astype(np.int64), 2, s)

    def traffic_bytes(self, config) -> int:
        """Device-memory bytes of one call at the synthetic lengths: each
        live K/V position read once at the pool's itemsize (plus a scale a
        page for int8), the written token (int8: the touched page
        rewritten with its scale), q, k_new, v_new, tables, lens and the
        output once, and for ``rows`` the partials written and read back."""
        it = self.dtype.itemsize
        b, n, nkv, h, bs = (self.batch, self.num_heads, self.num_kv_heads, self.head_dim,
                            self.block_size)
        lens = self.synthetic_lens()
        live, pages = int(lens.sum()), int((-(-lens // bs)).sum())
        if self.kv == "int8":
            reads = 2 * (live * nkv * h + pages * nkv * 4)
            writes = 2 * (b * nkv * bs * h + b * nkv * 4)
        else:
            reads = 2 * live * nkv * h * it
            writes = 2 * b * nkv * h * it
        traffic = reads + writes + (2 * b * n * h + 2 * b * nkv * h) * it
        traffic += b * self.max_blocks * 8 + b * 8
        if config.get("layout") == "rows":
            traffic += 2 * b * n * int(config["splits"]) * (h + 2) * 4
        return int(traffic)

    def flops(self) -> float:
        live = float(self.synthetic_lens().sum())
        return 4.0 * self.num_heads * self.head_dim * live + 5.0 * self.num_heads * live

    def roofline_ms(self, config, cost_model=None) -> float:
        if cost_model is None:
            from paddle_tpu_torch.cost_model import OpCostModel

            cost_model = OpCostModel(self.device)
        launches = 2 if config.get("layout") == "rows" else 1
        return (cost_model.flops_time(self.flops(), self.traffic_bytes(config))
                + launches * _LAUNCH_S) * 1e3

    def smem_bytes(self, config) -> int:
        """Shared memory of one block of the decode kernel (the JAX spec's
        ``vmem_bytes``): q of the group, the K and V tiles, the scores and
        the running statistics, all f32."""
        h = self.head_dim
        return 4 * (_MAX_GROUP * h + _TILE * (h + 1) + _TILE * h + _MAX_GROUP * _TILE
                    + 3 * _MAX_GROUP)

    # -------------------------------------------------------------- numerics
    def reference(self):
        return decode_chain_plain

    def synthetic_args(self):
        """Deterministic engine-shaped arguments on ``device``: every row
        owns disjoint pool blocks (the allocator invariant the kernels rely
        on) poured with random content, lengths spread over the table."""
        b, n, nkv, h = self.batch, self.num_heads, self.num_kv_heads, self.head_dim
        bs, w, dev = self.block_size, self.max_blocks, self.device
        if self.num_blocks < b * w:
            raise ValueError(f"{self.num_blocks} pool blocks < {b} rows x {w} pages")
        g = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        kc, vc = pa.alloc_paged_cache(self.num_blocks, nkv, bs, h,
                                      "int8" if self.kv == "int8" else self.dtype, dev)
        ids = torch.arange(b * w, device=dev).reshape(b, w)
        pa.paged_pour_blocks(kc, randn(b * w, nkv, bs, h), ids.reshape(-1))
        pa.paged_pour_blocks(vc, randn(b * w, nkv, bs, h), ids.reshape(-1))
        lens = torch.as_tensor(self.synthetic_lens(), device=dev)
        return (kc, vc, randn(b, n, h, dtype=self.dtype), randn(b, nkv, h, dtype=self.dtype),
                randn(b, nkv, h, dtype=self.dtype), ids, lens)

    def parity_ok(self, fn, args, reference_out) -> bool:
        """Pools bit-exact against the twin's for both pool kinds; the
        attention output within the tolerance of its dtype (2e-2 on int8
        pools).  Errors of the kernel propagate."""
        o, kc, vc = fn(*args)
        r_o, r_kc, r_vc = reference_out
        for got, want in ((kc, r_kc), (vc, r_vc)):
            if isinstance(want, pa.QuantPool):
                if not (torch.equal(got.data, want.data) and torch.equal(got.scale, want.scale)):
                    return False
            elif not torch.equal(got, want):
                return False
        tol = _tolerance(self.dtype, self.kv)
        return (o.shape == r_o.shape and o.dtype == r_o.dtype
                and bool(torch.allclose(o.float(), r_o.float(), atol=tol, rtol=tol)))

    def build(self, config):
        """The candidate's callable ``(kc, vc, q, kn, vn, tables, lens) ->
        (o, kc, vc)``; ValueError for a config this geometry refuses."""
        layout = config.get("layout", "batch")
        if layout == "batch":
            return decode_chain_batch
        if layout != "rows":
            raise ValueError(f"unknown decode-chain layout {layout!r}")
        if self.kv != "int8":
            raise ValueError("the split 'rows' layout is for int8 pools only")
        splits = int(config.get("splits", 0))
        if splits not in _ROWS_SPLITS:
            raise ValueError(f"rows splits {splits} not in {_ROWS_SPLITS}")
        return functools.partial(decode_chain_rows, splits=splits)


@dataclass
class PrefillChainSpec:
    """One chunked-prefill attention call: a query chunk of ``seq`` tokens
    against ``kv_len`` cached-plus-chunk positions, bottom-right aligned,
    heads post-GQA-repeat (the geometry ``LlamaAttention.forward`` hands
    its attention core)."""

    seq: int
    kv_len: int
    num_heads: int
    head_dim: int
    dtype: object = torch.bfloat16
    device: object = "cpu"

    def __post_init__(self):
        self.dtype = _as_dtype(self.dtype)
        self.device = torch.device(self.device)

    def kernel_name(self) -> str:
        return "schedule/prefill"

    def key(self) -> dict:
        return {"s": self.seq, "t": self.kv_len, "n": self.num_heads, "h": self.head_dim,
                "dtype": str(self.dtype).removeprefix("torch.")}

    def label(self) -> str:
        from .autotune import _key_str

        return f"{self.kernel_name()}|{_key_str(self.key())}"

    def config_label(self, config) -> str:
        return f"#q{config.get('block_q')}"

    def enumerate_configs(self):
        """``block_q`` (query rows a block): 64, plus 128 where the chunk
        is a multiple of it."""
        return [{"block_q": bq} for bq in _PREFILL_BLOCK_Q
                if self.seq >= 2 and self.seq % bq == 0]

    def pairs(self) -> int:
        """Visible (query, key) pairs under the bottom-right mask."""
        s, t = self.seq, self.kv_len
        return s * t - s * (s - 1) // 2

    def flops(self) -> float:
        return (4.0 * self.head_dim + 5.0) * self.num_heads * self.pairs()

    def splits(self, config) -> int:
        """The key splits of the bf16 (sm90) kernel on ``device`` (1 for f32)."""
        if self.dtype != torch.bfloat16:
            return 1
        return prefill_splits(self.seq, self.kv_len, self.num_heads, int(config["block_q"]),
                              sm_count(self.device))

    def traffic_bytes(self, config) -> int:
        """Device-memory bytes of the kernel that runs: q and the output
        once; K/V once per query tile up to the tile's last visible key
        (bf16: whole 128-key tiles, each read once across the splits, TMA
        reading nothing past T; f32: rows), and with more than one split the
        f32 partials and their lse written and read back once."""
        it = self.dtype.itemsize
        s, t, n, h = self.seq, self.kv_len, self.num_heads, self.head_dim
        bq = int(config["block_q"])
        if self.dtype == torch.bfloat16:
            kv_rows = sum(min(t, ((i0 + bq - 1 + t - s) // _PREFILL_KEYS + 1) * _PREFILL_KEYS)
                          for i0 in range(0, s, bq))
        else:
            kv_rows = sum(min(t, i0 + bq + t - s) for i0 in range(0, s, bq))
        traffic = (2 * s + 2 * kv_rows) * n * h * it
        splits = self.splits(config)
        if splits > 1:
            traffic += 2 * splits * s * n * (h + 1) * 4
        return int(traffic)

    def roofline_ms(self, config, cost_model=None) -> float:
        if cost_model is None:
            from paddle_tpu_torch.cost_model import OpCostModel

            cost_model = OpCostModel(self.device)
        launches = 2 if self.splits(config) > 1 else 1
        return (cost_model.flops_time(self.flops(), self.traffic_bytes(config))
                + launches * _LAUNCH_S) * 1e3

    def smem_bytes(self, config) -> int:
        """Shared memory of one block: the bf16 (sm90) kernel's Q tile and
        two stages of 128-key K and V tiles, its 7 mbarriers and the 1 KB
        of alignment slack; the f32 kernel's q tile, K/V tiles and
        scores."""
        h, bq = self.head_dim, int(config["block_q"])
        if self.dtype == torch.bfloat16:
            return bq * h * 2 + 2 * 2 * _PREFILL_KEYS * h * 2 + 8 * 7 + 1024
        return 4 * (bq * h + _TILE * (h + 1) + _TILE * h + bq * _TILE + 3 * bq)

    def reference(self):
        return prefill_chain_plain

    def synthetic_args(self):
        g = torch.Generator(device=self.device).manual_seed(0)
        s, t, n, h = self.seq, self.kv_len, self.num_heads, self.head_dim
        return tuple(torch.randn(shape, generator=g, device=self.device).to(self.dtype)
                     for shape in ((1, s, n, h), (1, t, n, h), (1, t, n, h)))

    def parity_ok(self, fn, args, reference_out) -> bool:
        got = fn(*args)
        tol = _tolerance(self.dtype)
        return (got.shape == reference_out.shape and got.dtype == reference_out.dtype
                and bool(torch.allclose(got.float(), reference_out.float(), atol=tol,
                                        rtol=tol)))

    def build(self, config):
        bq = int(config.get("block_q", 0))
        if bq not in _PREFILL_BLOCK_Q or self.seq % bq:
            raise ValueError(f"block_q {bq} does not tile a chunk of {self.seq}")
        return functools.partial(prefill_chain, block_q=bq)


# ----------------------------------------------------------- engine plumbing


def spec_from_arrays(kc, q, tables, mesh=None):
    """The spec of the chain about to run, from the live pool, query and
    table shapes."""
    quant = isinstance(kc, pa.QuantPool)
    nb, nkv, bs, h = (kc.data if quant else kc).shape
    b, n, _ = q.shape
    return DecodeChainSpec(batch=int(b), num_heads=int(n), num_kv_heads=int(nkv),
                           head_dim=int(h), block_size=int(bs),
                           max_blocks=int(tables.shape[1]), num_blocks=int(nb),
                           kv="int8" if quant else "bf16", dtype=q.dtype,
                           device=q.device, mesh=mesh)


def ensure_decision(spec, searcher=None):
    """Search or serve one geometry: a cached verdict is final (no
    re-measurement); a fresh geometry runs the whole search and persists.
    A config served from the cache passes the parity gate once more here:
    the cache file is trusted about speed, never about numerics."""
    from paddle_tpu_torch.static.schedule_search import Decision, ScheduleSearcher

    decision = (searcher or ScheduleSearcher()).search(spec)
    if decision.status == "cache":
        try:
            fn = spec.build(decision.config)
        except ValueError:
            return Decision("disabled")
        ref_out = spec.reference()(*spec.synthetic_args())
        if not spec.parity_ok(fn, spec.synthetic_args(), ref_out):
            return Decision("disabled")
    return decision


def fused_decode_step(kc, vc, q, kn, vn, tables, lens, *, config):
    """The decode step's fused seam: the accepted config's kernel in place
    of ``_decode_layer_paged``'s write, write, attend.  Returns
    ``(o, kc, vc)``."""
    return spec_from_arrays(kc, q, tables).build(config)(kc, vc, q, kn, vn, tables, lens)


def fused_prefill_attention(q, k, v, *, block_q):
    """The prefill branch's fused seam (``LlamaAttention.forward`` under
    ``models.llama.prefill_chain_scope``): the accepted config's kernel in
    place of the attention core, for a ``[1, S, N, H]`` chunk against
    ``[1, T, N, H]`` post-repeat K/V.  Callers check ``S % block_q == 0``."""
    _, s, n, h = q.shape
    spec = PrefillChainSpec(seq=int(s), kv_len=int(k.shape[1]), num_heads=int(n),
                            head_dim=int(h), dtype=q.dtype, device=q.device)
    return spec.build({"block_q": int(block_q)})(q, k, v)
