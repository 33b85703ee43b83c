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

The kernels, CUDA C++ in ``csrc/decode_chain_sm90.cu``,
``csrc/decode_chain.cu`` and ``csrc/prefill_chain_sm90.cu``:

- ``decode_chain_batch`` (replaces ``_build_batch``): one launch per layer
  writes every row's token into its page (bf16, f32 or int8 pools) and
  attends over the row's live positions;
- ``decode_chain_rows`` (replaces ``_build_rows``, int8 pools only): the
  same function with each (row, kv head) span split over ``splits``
  blocks and the partial softmax sums merged by a second launch.

  Both have two routes, picked by ``_decode_route`` before any launch:
  bf16 q (bf16 or int8 pools) takes ``decode_chain_sm90.cu`` (bulk page
  copies into an mbarrier ring; ``batch`` deals each (row, kv head)'s
  live pages over a cluster of ``decode_cluster(B, Nkv, W, SMs)`` blocks
  merged through distributed shared memory, ``rows`` over ``splits``
  blocks merged by the combine launch); f32 takes ``decode_chain.cu``'s
  kernel, a block per (row, kv head, split).  Every launch counts under
  its name, the sm90 kernel's also under the name with ``_sm90``;
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

Mesh-sharded chains (``mesh=``) are ROADMAP.md A.6.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import count_launch, sm_count, use_kernel
from . import paged_attention as pa

__all__ = ["DecodeChainSpec", "PrefillChainSpec", "spec_from_arrays", "ensure_decision",
           "decode_refusal", "prefill_refusal",
           "fused_decode_step", "fused_prefill_attention", "decode_chain_batch",
           "decode_chain_rows", "decode_chain_plain", "decode_cluster", "merge_partials",
           "page_runs", "prefill_chain", "prefill_chain_plain"]

_MESH_ITEM = "ROADMAP.md A.6 (distributed)"
_MAX_GROUP = 8                 # query heads per kv head the decode kernel takes
_TILE = 32                     # positions per shared-memory tile of decode_chain.cu
_CLUSTERS = (1, 2, 4, 8)       # portable cluster sizes of the sm90 decode chain
_CLUSTER_FILL = 3              # blocks an SM the cluster rule aims for (decode_cluster)
_RING_BYTES = 32 * 1024        # K and V pages in flight a block (decode_chain_sm90.cu)
_MAX_STAGES = 8
_CONSUMER_WARPS = 4
_MAX_SMEM = 227 * 1024
_LAUNCH_S = 1e-7               # tie-breaker per launch in the roofline ranking
_ROWS_SPLITS = (2, 4, 8)
_PREFILL_BLOCK_Q = (64, 128)
_PREFILL_KEYS = 128            # keys a K/V tile of the sm90 prefill kernel
_MIN_SPLIT_TILES = 4           # K/V tiles a key split holds at the least (prefill_splits)
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "paddle_decode_chain": [_PTR] * 13 + [_INT] * 9 + [ctypes.c_float, _PTR],
    "paddle_decode_chain_sm90": [_PTR] * 13 + [_INT] * 8 + [ctypes.c_float, _PTR],
    "paddle_prefill_chain": [_PTR] * 4 + [_INT] * 4 + [_LL] * 8 + [_INT] * 2
    + [ctypes.c_float, _PTR],
    "paddle_prefill_chain_sm90": [_PTR] * 6 + [_INT] * 4 + [_LL] * 8 + [_INT] * 2
    + [ctypes.c_float, _PTR],
}
_LIBS = {"paddle_prefill_chain_sm90": "prefill_chain_sm90",  # the rest: decode_chain
         "paddle_decode_chain_sm90": "decode_chain_sm90"}
_FNS: dict = {}


def _tolerance(dtype, kv="bf16"):
    """Attention-output tolerance of the parity gate and the tests."""
    return 2e-5 if dtype == torch.float32 and kv != "int8" else 2e-2


def _as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name (a model config's "float16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype).removeprefix("torch."), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"decode_chain: {dtype!r} is not a dtype")
    return out


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


def _decode_route(q_dtype, pool_dtype, h, group) -> str:
    """Which kernel takes a decode chain, before any launch: ``"sm90"``
    (``csrc/decode_chain_sm90.cu``) for bf16 q with bf16 or int8 pools,
    ``"general"`` (``decode_chain.cu``) for f32 q with f32 or int8 pools,
    both at H 64 or 128 and at most ``_MAX_GROUP`` query heads a kv head.
    Raises for what no kernel takes."""
    if pool_dtype not in (q_dtype, torch.int8):
        raise TypeError(f"decode_chain: pools of {pool_dtype} with q of {q_dtype}")
    if h not in (64, 128):
        raise ValueError(f"decode_chain: head_dim {h} is not 64 or 128")
    if group > _MAX_GROUP:
        raise ValueError(f"decode_chain: {group} q heads a kv head (at most {_MAX_GROUP})")
    if q_dtype == torch.bfloat16:
        return "sm90"
    if q_dtype == torch.float32:
        return "general"
    raise TypeError(f"decode_chain: the kernels take bf16 or f32 q, got {q_dtype}")


def decode_refusal(q_dtype, pool_dtype, h, group):
    """Why no decode-chain kernel takes this geometry, or None when one
    does: ``_decode_route``'s own rule, asked before anything is built
    (``DecodeChainSpec.build`` refuses with it, so the searcher counts the
    spec ``refused`` and never launches it)."""
    try:
        _decode_route(q_dtype, pool_dtype, h, group)
    except (TypeError, ValueError) as err:
        return str(err)
    return None


def decode_cluster(b, nkv, w, sms) -> int:
    """The blocks (one cluster) that share each (row, kv head) in the sm90
    ``batch`` layout: the live pages are dealt among them in equal runs, so
    the longest row is no longer walked by one block alone.  Doubled from 1
    while the grid holds fewer than ``_CLUSTER_FILL`` blocks an SM (room to
    spread a long row) and while a full table of ``w`` pages still gives
    every block a page (no block idles for want of pages), up to 8 (the
    portable cluster size).  The lengths are on the card, so the rule reads
    only shapes."""
    c = 1
    while c < _CLUSTERS[-1] and b * nkv * c < _CLUSTER_FILL * sms and 2 * c <= w:
        c *= 2
    return c


def page_runs(lens, bs, parts):
    """The pages each of ``parts`` blocks takes of a row of ``lens``
    positions: equal page-aligned runs ``[r * per, (r + 1) * per)`` of the
    ``ceil(lens / bs)`` live pages, ``per = ceil(pages / parts)``, empty
    where the pages run out (the kernels' index arithmetic)."""
    pages = -(-lens // bs) if lens > 0 else 0
    per = -(-pages // parts)
    return [range(min(pages, r * per), min(pages, r * per + per)) for r in range(parts)]


def merge_partials(m, l, acc):
    """The sm90 decode kernel's merge of partial softmax sums, in f32: m
    ``[..., P]`` the running maxima in log2 units (-inf for a run that saw
    no key), l ``[..., P]`` the sums of 2^(s - m), acc ``[..., P, H]`` the
    unnormalised outputs.  Weighs each part by 2^(m - max) (0 for an empty
    one) and returns ``sum(acc) / sum(l)`` (0 where no part saw a key).
    The kernel merges its warps' parts, then its cluster's blocks (or the
    combine launch its splits), each level by this rule."""
    mx = m.amax(-1, keepdim=True)
    mx = torch.where(mx == float("-inf"), torch.zeros_like(mx), mx)
    f = torch.exp2(m - mx)
    ls = (f * l).sum(-1)
    ls = torch.where(ls == 0, torch.ones_like(ls), ls)
    return (f.unsqueeze(-1) * acc).sum(-2) / ls.unsqueeze(-1)


def _ring_stages(page_bytes, run_pages) -> int:
    """``decode_chain_sm90.cu``'s ring: 32 KB of K and V pages, 1 to 8
    stages, no more than a run can fill."""
    return max(1, min(_RING_BYTES // (2 * page_bytes), _MAX_STAGES, run_pages))


def _sm90_smem(page_bytes, w, parts, cluster, group, h) -> int:
    """Shared memory of one sm90 decode block (``parts`` blocks a (row, kv
    head), one cluster when ``cluster``): the ring and its mbarriers, the
    f32 partials (m, l and H accumulators for each of the group's rows,
    rounded up to 1, 2, 4 or 8) of each consumer warp and, in a cluster,
    of each of its blocks (gathered in rank 0), and the write's two new
    scales."""
    stages = _ring_stages(page_bytes, -(-w // parts))
    slots = parts if cluster and parts > 1 else 0
    gt = next(g for g in (1, 2, 4, 8) if g >= group)
    return (stages * 2 * page_bytes + 2 * stages * 8
            + ((_CONSUMER_WARPS + slots) * gt * (h + 2) + 2) * 4)


def _decode_checks(kc, vc, q, kn, vn, tables, lens):
    """Shapes, dtypes and layouts every route needs; returns the route,
    the pools' payloads and int64 tables and lens."""
    int8 = isinstance(kc, pa.QuantPool)
    if int8 != isinstance(vc, pa.QuantPool):
        raise TypeError("decode_chain: the K and V pools must be of one kind")
    kd, vd = (kc.data, vc.data) if int8 else (kc, vc)
    if kn.dtype != q.dtype or vn.dtype != q.dtype:
        raise TypeError("decode_chain: q, k_new and v_new must share one dtype")
    if kd.dtype != vd.dtype:
        raise TypeError(f"decode_chain: K pool of {kd.dtype}, V pool of {vd.dtype}")
    b, n, h = q.shape
    nb, nkv, bs, h2 = kd.shape
    if (h2 != h or vd.shape != kd.shape or kn.shape != (b, nkv, h) or vn.shape != kn.shape
            or tables.dim() != 2 or tables.shape[0] != b or lens.shape != (b,) or n % nkv):
        raise ValueError(f"decode_chain: shapes q {tuple(q.shape)}, k_new {tuple(kn.shape)}, "
                         f"pool {tuple(kd.shape)}, tables {tuple(tables.shape)}, "
                         f"lens {tuple(lens.shape)} do not match")
    route = _decode_route(q.dtype, kd.dtype, h, n // nkv)
    if not all(t.is_contiguous() for t in (kd, vd, q, kn, vn)):
        raise ValueError("decode_chain: pools, q, k_new and v_new must be contiguous")
    return route, kd, vd, tables.to(torch.int64).contiguous(), lens.to(torch.int64).contiguous()


def _workspace(q, splits):
    b, n, h = q.shape
    if splits == 1:
        return None, None, None
    ws_m = torch.empty((b, n, splits), dtype=torch.float32, device=q.device)
    return ws_m, torch.empty_like(ws_m), torch.empty((b, n, splits, h), dtype=torch.float32,
                                                     device=q.device)


def _count(splits, sm90):
    name = "decode_chain_batch" if splits == 1 else "decode_chain_rows"
    count_launch(name)
    if sm90:
        count_launch(f"{name}_sm90")


def _decode_general(kc, vc, q, kn, vn, tables, lens, splits, checked=None):
    """``decode_chain.cu``'s kernel: the route of f32 models; its bf16 and
    int8 paths stay to time against the sm90 kernel."""
    _, kd, vd, tables, lens = checked or _decode_checks(kc, vc, q, kn, vn, tables, lens)
    int8 = isinstance(kc, pa.QuantPool)
    b, n, h = q.shape
    o = torch.empty_like(q)
    _launch("paddle_decode_chain", kd, vd, kc.scale if int8 else None,
            vc.scale if int8 else None, q, kn, vn, tables, lens, o, *_workspace(q, splits),
            b, n, kd.shape[1], h, kd.shape[2], tables.shape[1], splits,
            int(q.dtype == torch.float32), int(int8), 1.0 / math.sqrt(h))
    _count(splits, False)
    return o


def _decode_sm90(kc, vc, q, kn, vn, tables, lens, splits, cluster=None, checked=None):
    """``decode_chain_sm90.cu``: ``splits == 1`` is the ``batch`` layout
    in clusters of ``cluster`` blocks (``decode_cluster``'s choice unless
    given), ``splits > 1`` the ``rows`` layout and its combine launch."""
    route, kd, vd, tables, lens = checked or _decode_checks(kc, vc, q, kn, vn, tables, lens)
    if route != "sm90":
        raise TypeError(f"decode_chain: the sm90 kernel takes bf16 q, got {q.dtype}")
    int8 = isinstance(kc, pa.QuantPool)
    b, n, h = q.shape
    nkv, bs, w = kd.shape[1], kd.shape[2], tables.shape[1]
    if splits == 1:
        parts = decode_cluster(b, nkv, w, sm_count(q.device)) if cluster is None else cluster
        if parts not in _CLUSTERS:
            raise ValueError(f"decode_chain: cluster {parts} is not one of {_CLUSTERS}")
    else:
        parts = splits
    page_bytes = bs * h * kd.element_size()
    if (page_bytes % 16 or _sm90_smem(page_bytes, w, parts, splits == 1, n // nkv, h) > _MAX_SMEM
            or kd.data_ptr() % 16 or vd.data_ptr() % 16):
        raise ValueError(f"decode_chain: pages of {bs} x {h} do not fit the sm90 kernel's "
                         "ring (16-byte multiples, one stage of K and V in shared memory)")
    o = torch.empty_like(q)
    _launch("paddle_decode_chain_sm90", kd, vd, kc.scale if int8 else None,
            vc.scale if int8 else None, q, kn, vn, tables, lens, o, *_workspace(q, splits),
            b, n, nkv, h, bs, w, parts, int(int8), 1.0 / math.sqrt(h))
    _count(splits, True)
    return o


def _decode_cuda(kc, vc, q, kn, vn, tables, lens, splits):
    checked = _decode_checks(kc, vc, q, kn, vn, tables, lens)
    launch = _decode_sm90 if checked[0] == "sm90" else _decode_general
    return launch(kc, vc, q, kn, vn, tables, lens, splits, checked=checked)


def decode_chain_batch(kc, vc, q, kn, vn, tables, lens):
    """One decode token's write-then-attend for the whole batch.

    kc/vc: pools ``[NB, Nkv, bs, H]`` (bf16, f32, or QuantPools), updated
    in place; q ``[B, N, H]``; kn/vn ``[B, Nkv, H]``; tables ``[B, W]``;
    lens ``[B]`` including this token.  Returns ``(o [B, N, H], kc, vc)``.
    A CUDA tensor launches the kernel of its route (one launch), a CPU
    tensor takes the plain version."""
    if not use_kernel(q, kn, vn, tables, lens, pa._payload(kc), pa._payload(vc)):
        return decode_chain_plain(kc, vc, q, kn, vn, tables, lens)
    return _decode_cuda(kc, vc, q, kn, vn, tables, lens, 1), kc, vc


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
    return _decode_cuda(kc, vc, q, kn, vn, tables, lens, int(splits)), kc, vc


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


def _prefill_geometry(dtype, h):
    """The dtypes and head dims a prefill-chain kernel takes (bf16 or f32,
    H 64 or 128): raises for the rest.  The launch (``_check_prefill``)
    and ``PrefillChainSpec.build`` (``prefill_refusal``) both ask it."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prefill_chain: the kernel takes bf16 or f32, got {dtype}")
    if h not in (64, 128):
        raise ValueError(f"prefill_chain: head_dim {h} is not 64 or 128")


def prefill_refusal(dtype, h):
    """Why no prefill-chain kernel takes this geometry, or None."""
    try:
        _prefill_geometry(dtype, h)
    except (TypeError, ValueError) as err:
        return str(err)
    return None


def _check_prefill(q, k, v):
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"prefill_chain: the kernel takes one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    _prefill_geometry(q.dtype, q.shape[-1])
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

    def sm90(self) -> bool:
        """Whether the chain runs ``decode_chain_sm90.cu`` (bf16 models;
        f32 ones take ``decode_chain.cu``): ``_decode_route``'s rule."""
        return self.dtype == torch.bfloat16

    def parts(self, config) -> int:
        """Blocks a (row, kv head) of the sm90 kernel: the cluster of
        ``batch`` (``decode_cluster`` on ``device``) or the ``rows``
        splits."""
        if config.get("layout") == "rows":
            return int(config["splits"])
        return decode_cluster(self.batch, self.num_kv_heads, self.max_blocks,
                              sm_count(self.device))

    def traffic_bytes(self, config) -> int:
        """Device-memory bytes of one call at the synthetic lengths: each
        live K/V position read once at the pool's itemsize (the sm90
        kernel copies whole pages: the dead tail of a row's last page too),
        plus a scale a page for int8, the written token (int8: the touched
        page rewritten with its scale), q, k_new, v_new, tables, lens and
        the output once, and for ``rows`` the partials written and read
        back (``batch``'s cluster merges in shared memory: nothing more)."""
        it = self.dtype.itemsize
        b, n, nkv, h, bs = (self.batch, self.num_heads, self.num_kv_heads, self.head_dim,
                            self.block_size)
        lens = self.synthetic_lens()
        live, pages = int(lens.sum()), int((-(-lens // bs)).sum())
        if self.sm90():
            live = pages * bs
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
        """Shared memory of one block of the kernel that runs (the JAX
        spec's ``vmem_bytes``).  sm90: the ring of K and V pages and its
        mbarriers, the f32 partials of the warps and, in ``batch``'s
        cluster, of its blocks (``_sm90_smem``).  ``decode_chain.cu``:
        q of the group, the K and V tiles, the scores and the running
        statistics, all f32."""
        h = self.head_dim
        if self.sm90():
            page = self.block_size * h * (1 if self.kv == "int8" else 2)
            return _sm90_smem(page, self.max_blocks, self.parts(config),
                              config.get("layout") != "rows",
                              self.num_heads // self.num_kv_heads, h)
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
        (o, kc, vc)``; ValueError for a config this geometry refuses, and
        for a geometry (dtype, head dim, group) no kernel of the card takes
        (``decode_refusal``), before anything is built."""
        why = decode_refusal(self.dtype, torch.int8 if self.kv == "int8" else self.dtype,
                             self.head_dim, self.num_heads // self.num_kv_heads)
        if why is not None:
            raise ValueError(why)
        return _decode_fn(self.kv, config)


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
        """``prefill_chain`` at ``block_q``; ValueError for a block that
        does not tile the chunk, and for a dtype or head dim no kernel of
        the card takes (``prefill_refusal``), before anything is built."""
        why = prefill_refusal(self.dtype, self.head_dim)
        if why is not None:
            raise ValueError(why)
        bq = int(config.get("block_q", 0))
        if bq not in _PREFILL_BLOCK_Q or self.seq % bq:
            raise ValueError(f"block_q {bq} does not tile a chunk of {self.seq}")
        return functools.partial(prefill_chain, block_q=bq)


def _decode_fn(kv, config):
    """The decode chain of a config's layout; ValueError for a layout the
    pools refuse."""
    layout = config.get("layout", "batch")
    if layout == "batch":
        return decode_chain_batch
    if layout != "rows":
        raise ValueError(f"unknown decode-chain layout {layout!r}")
    if kv != "int8":
        raise ValueError("the split 'rows' layout is for int8 pools only")
    splits = int(config.get("splits", 0))
    if splits not in _ROWS_SPLITS:
        raise ValueError(f"rows splits {splits} not in {_ROWS_SPLITS}")
    return functools.partial(decode_chain_rows, splits=splits)


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
    ``(o, kc, vc)``.  A geometry no kernel takes raises at the launch (the
    search refused it: ``DecodeChainSpec.build``)."""
    kv = "int8" if isinstance(kc, pa.QuantPool) else "bf16"
    return _decode_fn(kv, config)(kc, vc, q, kn, vn, tables, lens)


def fused_prefill_attention(q, k, v, *, block_q):
    """The prefill branch's fused seam (``LlamaAttention.forward`` under
    ``models.llama.prefill_chain_scope``): the accepted config's kernel in
    place of the attention core, for a ``[1, S, N, H]`` chunk against
    ``[1, T, N, H]`` post-repeat K/V.  Callers check ``S % block_q == 0``."""
    return prefill_chain(q, k, v, block_q=int(block_q))
