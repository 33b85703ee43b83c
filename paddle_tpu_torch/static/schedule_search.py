"""The schedule searcher, its measured-win gate, and the Program-subgraph
search of the static tier (counterpart of
paddle_tpu/static/schedule_search.py).

A spec describes one geometry of a searchable kernel (the serving chains
of ``ops.decode_chain``, and ``SubgraphSpec``: a discovered reduction- or
matmul-rooted subgraph of a static Program) and implements the protocol:
``key``, ``kernel_name``, ``label``/``config_label``, ``enumerate_configs``,
``roofline_ms``, ``smem_bytes``, ``reference`` (the plain twin),
``synthetic_args``, ``parity_ok``, ``build``.  ``ScheduleSearcher.search``
drives it: enumerate -> roofline prune -> shared-memory prune -> parity
against the twin -> measure -> measured-win gate -> persist in the
per-device autotune cache.  A cached verdict is served with no
measurement.

One deliberate difference from the JAX searcher, which skips a candidate
on any exception: here only a candidate the spec refuses for its geometry
(``build`` raising ``ValueError``) is skipped.  A CUDA build or launch
error propagates, so a broken kernel is never mistaken for a slow one.
And a ``SubgraphSpec``'s parity is a real check against the replay of the
recorded ops (the JAX spec leaves it to ``verify.py``, not ported).

Program subgraphs (``match_subgraph``, ported from the JAX discovery):
anchored at the downstream end, a DAG of single-consumer links whose ops
are elementwise (``rewrite._ELEMENTWISE``), last-axis reductions
(``_REDUCE_OPS``; the baked axis is probed on meta tensors, the square-dims
trap), rowwise (``_ROWWISE_OPS``) or one matmul origin; side-effect ops
are never crossed, and an op the translator (``static/codegen.py``)
cannot read exactly is not fusible.  The schedule space is the H100's
(``enumerate_candidates``): ``block_rows`` x ``block_cols`` is a block's
tile (reduce kind: rows a block, one warp each; matmul kind: the output
tile), ``grid_order`` the raster of the 2-D grid, ``block_k`` the split-K
slice.  ``build_kernel`` returns the generated kernel at a config
(``csrc/codegen/sched_chain.cuh``, ``sched_chain_ktiled.cuh``; every
config of a subgraph in one translation unit); on CPU tensors it runs the
replay (``build_reference``), which is also the gate's twin.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .codegen import REDUCE as _REDUCE_OPS
from .codegen import ROWWISE as _ROWWISE_OPS

__all__ = ["ExtInput", "SubgraphSpec", "match_subgraph", "enumerate_candidates",
           "candidate_smem_bytes", "candidate_roofline_ms", "build_kernel", "build_reference",
           "Decision", "ScheduleSearcher", "measure_override", "schedule_search_stats",
           "reset_schedule_search_stats"]

_COUNTERS = {
    "subgraphs_found": 0,   # fresh searches (cache service counted apart)
    "candidates": 0,        # configs enumerated across all searches
    "pruned_roofline": 0,   # dropped by the roofline ranking
    "pruned_smem": 0,       # dropped by the shared-memory budget
    "refused": 0,           # configs whose build refused the geometry
    "pruned_parity": 0,     # failed the parity gate against the twin (never timed)
    "measured": 0,          # candidates timed on the card
    "accepted": 0,          # geometries whose best config beat the twin
    "disabled": 0,          # geometries recorded as losing (or with no candidate)
    "cache_hits": 0,        # accepted configs served from the cache
    "disabled_hits": 0,     # disabled geometries skipped through the cache
}


def schedule_search_stats() -> dict:
    return dict(_COUNTERS)


def reset_schedule_search_stats():
    for k in _COUNTERS:
        _COUNTERS[k] = 0


_MEASURE_OVERRIDE = None


@contextlib.contextmanager
def measure_override(fn):
    """Route every measurement through ``fn(run, args, *, label, config)``
    -> ms; ``config`` is None for the plain twin.  The CPU tests decide
    through this."""
    global _MEASURE_OVERRIDE
    prev, _MEASURE_OVERRIDE = _MEASURE_OVERRIDE, fn
    try:
        yield
    finally:
        _MEASURE_OVERRIDE = prev


@dataclass
class Decision:
    """Outcome of one search."""

    status: str             # accepted | disabled | cache | cache_disabled
    config: dict | None = None
    kernel_ms: float = 0.0
    plain_ms: float = 0.0
    win: float = 0.0

    @property
    def accepted(self) -> bool:
        return self.status in ("accepted", "cache")


class ScheduleSearcher:
    """Enumerate -> roofline prune -> shared-memory prune -> parity ->
    measure -> gate -> persist."""

    def __init__(self, cost_model=None, budget=None, min_win=None, roofline_margin=1.5,
                 iters=10, warmup=2):
        from paddle_tpu_torch._core import flags

        if cost_model is None:
            from paddle_tpu_torch.cost_model import OpCostModel

            cost_model = OpCostModel()
        self.cost_model = cost_model
        self.budget = (int(flags.flag("FLAGS_schedule_search_budget"))
                       if budget is None else int(budget))
        self.min_win = (float(flags.flag("FLAGS_schedule_search_min_win"))
                        if min_win is None else float(min_win))
        self.roofline_margin = float(roofline_margin)
        self.iters = int(iters)
        self.warmup = int(warmup)

    def _measure_ms(self, label, fn, args, config):
        if _MEASURE_OVERRIDE is not None:
            return float(_MEASURE_OVERRIDE(fn, args, label=label, config=config))
        return self.cost_model.measure(label, fn, *args, iters=self.iters,
                                       warmup=self.warmup) * 1e3

    @staticmethod
    def _persist(spec, config, ms, meta):
        from paddle_tpu_torch._core import flags
        from paddle_tpu_torch.ops import autotune as at

        if flags.flag("FLAGS_use_autotune_cache"):
            at.record(spec.kernel_name(), spec.key(), config, ms, meta=meta)

    def search(self, spec) -> Decision:
        """Drive ``spec`` through the protocol.  Every candidate's numerics
        are held against the plain twin before it may be timed: one that
        fails parity is never accepted, however fast.  The specs' kernels
        update their inputs in place, so each parity run gets fresh
        ``synthetic_args()`` (the same values every call)."""
        from paddle_tpu_torch.ops import autotune as at

        cached = at.lookup(spec.kernel_name(), spec.key())
        if cached is not None:
            if cached.get("disabled"):
                _COUNTERS["disabled_hits"] += 1
                return Decision("cache_disabled")
            _COUNTERS["cache_hits"] += 1
            return Decision("cache", cached)

        _COUNTERS["subgraphs_found"] += 1
        candidates = spec.enumerate_configs()
        _COUNTERS["candidates"] += len(candidates)
        if not candidates:
            _COUNTERS["disabled"] += 1
            return Decision("disabled")
        ranked = [(spec.roofline_ms(c, self.cost_model), c) for c in candidates]
        best_roof = min(r for r, _ in ranked)
        kept = [(r, c) for r, c in ranked if r <= best_roof * self.roofline_margin]
        _COUNTERS["pruned_roofline"] += len(ranked) - len(kept)
        fit = [(r, c) for r, c in kept if at.validate_tile(spec.smem_bytes(c)) is None]
        _COUNTERS["pruned_smem"] += len(kept) - len(fit)
        fit.sort(key=lambda rc: rc[0])

        ref_fn = spec.reference()
        ref_out = None
        args = spec.synthetic_args()
        best_cfg, best_ms = None, float("inf")
        budget_left = max(1, self.budget)
        for _, cfg in fit:
            if budget_left <= 0:
                break
            try:
                fn = spec.build(cfg)
            except ValueError:
                _COUNTERS["refused"] += 1
                continue
            if ref_out is None:
                ref_out = ref_fn(*spec.synthetic_args())
            if not spec.parity_ok(fn, spec.synthetic_args(), ref_out):
                _COUNTERS["pruned_parity"] += 1
                continue
            ms = self._measure_ms(spec.label() + spec.config_label(cfg), fn, args, cfg)
            _COUNTERS["measured"] += 1
            budget_left -= 1
            if ms < best_ms:
                best_cfg, best_ms = dict(cfg), float(ms)

        if best_cfg is None:
            # nothing passed: not a measured loss, so nothing is persisted
            # and a later version gets to retry
            _COUNTERS["disabled"] += 1
            return Decision("disabled")

        plain_ms = float(self._measure_ms(f"{spec.label()}#plain", ref_fn, args, None))
        win = plain_ms / best_ms if best_ms > 0 else 0.0
        meta = {"win": round(win, 4), "plain_ms": round(plain_ms, 6)}
        if win >= self.min_win:
            self._persist(spec, best_cfg, best_ms, meta)
            _COUNTERS["accepted"] += 1
            return Decision("accepted", best_cfg, best_ms, plain_ms, win)
        self._persist(spec, {"disabled": True}, best_ms, meta)
        _COUNTERS["disabled"] += 1
        return Decision("disabled", None, best_ms, plain_ms, win)


# ---------------------------------------------------------------------------
# Program subgraphs: discovery

# the reduce and rowwise whitelists are the translator's (codegen.REDUCE,
# codegen.ROWWISE): a rowwise op is shape-preserving but last-axis-coupled,
# fusible as a row op whose reduced axis is never tiled
_MATMUL_OPS = {"matmul", "linear"}


def _base_type(type_: str) -> str:
    return type_.rsplit("::", 1)[-1]


@dataclass
class ExtInput:
    """One external input of a discovered subgraph.

    role: 'row'    -- leading dims match the row shape; 2-D view (rows, cols)
          'xrow'   -- a matmul's activation input (its last dim is the
                      contraction dim, so it is never col-tiled)
          'bcast'  -- all-leading-1 broadcast (a bias); view (1, cols)
          'weight' -- a matmul's 2-D weight
    """

    vid: int
    shape: tuple
    dtype: torch.dtype
    cols: int
    role: str


@dataclass
class SubgraphSpec:
    """A discovered reduction-/matmul-rooted subgraph, ready to schedule."""

    kind: str               # 'matmul' | 'reduce'
    root: object            # downstream-end Operator (keeps its out vid)
    ops: list               # chain Operators in execution order
    kinds: list             # 'elem' | 'reduce' | 'rowwise' | 'matmul', per op
    ext: list               # ExtInput per external input, in first-use order
    out_vid: int
    out_shape: tuple
    out_cols: int           # last dim of the kernel's 2-D output (cols or 1)
    out_dtype: torch.dtype
    rows: int
    cols: int
    k_dims: tuple           # matmul inner dims
    has_reduce: bool
    col_tilable: bool       # no reduce / rowwise: the output may be col-tiled
    k_tilable: bool = False  # single matmul whose x and w feed nothing else
    row_shape: tuple = ()
    op_dtypes: list = field(default_factory=list)
    op_shapes: list = field(default_factory=list)
    device: torch.device = torch.device("cpu")
    sig: str = ""

    def __post_init__(self):
        if not self.sig:
            parts = [",".join(_base_type(op.type) for op in self.ops),
                     ";".join(f"{e.role}{e.cols}" for e in self.ext), repr(self.out_shape)]
            self.sig = hashlib.sha1("|".join(parts).encode()).hexdigest()[:10]
        self._sources = {}
        self._enumerated = None

    def kernel_name(self) -> str:
        return f"schedule/{self.kind}"

    def key(self) -> dict:
        return {"rows": self.rows, "cols": self.cols,
                "k": "x".join(str(k) for k in self.k_dims) or "0", "sig": self.sig,
                "dtype": str(self.out_dtype).split(".")[-1]}

    def label(self) -> str:
        from paddle_tpu_torch.ops.autotune import _key_str

        return f"{self.kernel_name()}|{_key_str(self.key())}"

    def config_label(self, config) -> str:
        lbl = f"#{config['block_rows']}x{config['block_cols']}@{config['grid_order']}"
        bk = config.get("block_k")
        if bk and self.k_dims and bk < self.k_dims[0]:
            lbl += f"k{bk}"
        return lbl

    # ---- the searcher protocol
    def enumerate_configs(self):
        return enumerate_candidates(self)

    def roofline_ms(self, config, cost_model=None):
        return candidate_roofline_ms(self, config, cost_model)

    def smem_bytes(self, config):
        return candidate_smem_bytes(self, config)

    def build(self, config):
        return build_kernel(self, config)

    def reference(self):
        return build_reference(self)

    def synthetic_args(self):
        """Standard-normal external inputs (numpy seed 0, as the JAX spec's)
        on the spec's device, in each input's dtype."""
        rng = np.random.default_rng(0)
        return tuple(torch.from_numpy(rng.standard_normal(e.shape).astype(np.float32))
                     .to(device=self.device, dtype=e.dtype) for e in self.ext)

    def parity_ok(self, fn, args, reference_out) -> bool:
        """The candidate's output against the replay's within the output
        dtype's tolerance (``parity_tolerance``); a kernel's error
        propagates."""
        got = fn(*args)
        if got.shape != reference_out.shape or got.dtype != reference_out.dtype:
            return False
        rtol, atol = parity_tolerance(self.out_dtype, reference_out)
        return bool(torch.allclose(got.float(), reference_out.float(), rtol=rtol, atol=atol,
                                   equal_nan=True))

    def source(self, tiles=()):
        """The generated source with every tile of the enumeration (and
        ``tiles``) instantiated, memoised."""
        from . import codegen

        if self._enumerated is None:
            self._enumerated = set(_tiles(self, enumerate_candidates(self)))
        want = tuple(sorted(self._enumerated | set(tiles)))
        if want not in self._sources:
            self._sources[want] = codegen.subgraph_source(_subgraph_chain(self), want,
                                                          ktiled=self.k_tilable)
        return self._sources[want]


def parity_tolerance(dtype, reference_out):
    """(rtol, atol) of a generated kernel against the replay: one bf16
    (f16) step relative, f32 1e-5 relative; the absolute term, a tenth of
    that at the output's largest magnitude, covers values that cancel to
    near zero (a product summed in another order: over K 512 the f32 sums
    differ by ~2e-5 at outputs of ~90)."""
    rel = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(dtype, 1e-5)
    finite = reference_out.float()[torch.isfinite(reference_out.float())]
    scale = float(finite.abs().max()) if finite.numel() else 0.0
    return rel, rel * 0.1 * scale + 1e-30


def _entry_shape(graph, entry):
    if entry[0] == "var":
        return graph.shape(entry[1])
    v = entry[1]
    return tuple(v.shape) if isinstance(v, torch.Tensor) else tuple(np.shape(v))


def _wide_const(value, cols):
    shape = tuple(value.shape) if isinstance(value, torch.Tensor) else np.shape(value)
    size = int(np.prod(shape)) if len(shape) else 1
    return size > 1 and len(shape) >= 1 and shape[-1] == cols


def _reduces_last_axis(op, row_shape, keepdim_only):
    """True iff the op's bound reduction axis is the last one, probed on a
    meta tensor with all-distinct dims (on square dims an axis=1 reduction's
    output shape equals a last-axis one's)."""
    from .program import suspend_capture

    probe = tuple(range(2, 2 + len(row_shape) - 1)) + (2 + len(row_shape),)
    try:
        with suspend_capture():
            out = op.fn(torch.empty(probe, device="meta"))
    except Exception:  # a reduction that cannot take the probe is not fusible
        return False
    flat = pytree.tree_leaves(out)
    if len(flat) != 1:
        return False
    shape = tuple(flat[0].shape)
    if shape == probe[:-1] + (1,):
        return True
    return not keepdim_only and shape == probe[:-1]


def _classify(op, graph, row_shape, root=None):
    """-> 'elem' | 'rowwise' | 'reduce' | 'matmul' | None (not fusible)."""
    from . import codegen
    from .passes import _SIDE_EFFECT
    from .rewrite import _ELEMENTWISE

    b = _base_type(op.type)
    if b in _SIDE_EFFECT:
        return None  # random ops are never crossed
    if not op.out_vids or len(op.out_vids) != 1:
        return None
    o = graph.shape(op.out_vids[0])
    if o is None:
        return None
    reduced = row_shape[:-1] + (1,)
    cols = row_shape[-1]
    if b in _MATMUL_OPS:
        if op.kwargs.get("transpose_x") or op.kwargs.get("transpose_y"):
            return None
        if o != row_shape or len(op.arg_spec) not in (2, 3):
            return None
        x_e, w_e = op.arg_spec[0], op.arg_spec[1]
        if x_e[0] != "var" or w_e[0] != "var":
            return None  # a captured constant weight: the kernels read weights as inputs
        xs = graph.shape(x_e[1])
        if xs is None or len(xs) < 2 or xs[:-1] != row_shape[:-1]:
            return None
        ws = _entry_shape(graph, w_e)
        if not ws or len(ws) != 2 or ws != (xs[-1], cols):
            return None
        if len(op.arg_spec) == 3 and _entry_shape(graph, op.arg_spec[2]) != (cols,):
            return None
        kind = "matmul"
    elif b in _REDUCE_OPS:
        ins = [s for s in op.arg_spec if s[0] == "var"]
        if len(ins) != 1 or len(op.arg_spec) != 1:
            return None
        if graph.shape(ins[0][1]) != row_shape:
            return None
        if o != reduced and not (op is root and o == row_shape[:-1]):
            return None  # non-keepdim only at the root (reshaped at the end)
        if not _reduces_last_axis(op, row_shape, keepdim_only=(o == reduced)):
            return None
        kind = "reduce"
    elif b in _ROWWISE_OPS:
        ax = op.kwargs.get("axis", -1)
        if ax not in (-1, len(row_shape) - 1):
            return None
        ins = [s for s in op.arg_spec if s[0] == "var"]
        if len(ins) != 1 or graph.shape(ins[0][1]) != row_shape or o != row_shape:
            return None
        kind = "rowwise"
    elif b in _ELEMENTWISE:
        if o not in (row_shape, reduced):
            return None
        oc = o[-1]
        for s in op.arg_spec:
            if s[0] == "var":
                vs = graph.shape(s[1])
                if vs is None:
                    return None
                bcast = (len(vs) >= 1 and all(d == 1 for d in vs[:-1]) and vs[-1] in (1, oc))
                if vs not in (row_shape, reduced) and not bcast:
                    return None
            elif not codegen.const_ok(s[1], cols):
                return None
        kind = "elem"
    else:
        return None
    if kind != "matmul" and not codegen.check_op(op, graph, cols):
        return None  # the translator cannot read it exactly (counted there)
    return kind


def _extends(consumer, graph, row_shape):
    """Would ``consumer`` continue this chain?  Discovery anchors at the
    downstream end only."""
    from .rewrite import _ELEMENTWISE

    b = _base_type(consumer.type)
    if not consumer.out_vids or len(consumer.out_vids) != 1:
        return False
    o = graph.shape(consumer.out_vids[0])
    if b in _ELEMENTWISE or b in _ROWWISE_OPS:
        return o == row_shape
    if b in _REDUCE_OPS:
        return o in (row_shape[:-1] + (1,), row_shape[:-1])
    return False


def match_subgraph(root, graph, min_ops=2, device="cpu"):
    """Anchor at ``root`` (downstream end) and collect the maximal fusible
    reduction-/matmul-rooted subgraph feeding it; None when ``root`` is not
    a viable anchor (the JAX package's rules).  Interior links require
    every consumer of a value inside the chain; fetched interior values are
    refused by the pass's structural rollback."""
    from .rewrite import _ELEMENTWISE

    base = _base_type(root.type)
    if not root.out_vids or len(root.out_vids) != 1:
        return None
    out_shape = graph.shape(root.out_vids[0])
    if out_shape is None:
        return None
    if base in _REDUCE_OPS:
        ins = [s for s in root.arg_spec if s[0] == "var"]
        if len(ins) != 1:
            return None
        row_shape = graph.shape(ins[0][1])
        if row_shape is None or len(row_shape) < 2:
            return None
        if out_shape not in (row_shape[:-1], row_shape[:-1] + (1,)):
            return None
    elif base in _ELEMENTWISE or base in _ROWWISE_OPS:
        row_shape = out_shape
        if len(row_shape) < 2 or row_shape[-1] < 2:
            return None
    else:
        return None

    root_kind = _classify(root, graph, row_shape, root=root)
    if root_kind is None:
        return None
    cons = graph.consumers.get(root.out_vids[0], [])
    if cons and all(_extends(c, graph, row_shape) for c in cons):
        return None  # some later op is the true root

    chain = {id(root): root}
    kinds = {id(root): root_kind}
    changed = True
    while changed:
        changed = False
        for op in list(chain.values()):
            if kinds[id(op)] == "matmul":
                continue  # a matmul is an origin: its x stays external
            for s in op.arg_spec:
                if s[0] != "var":
                    continue
                prod = graph.producer.get(s[1])
                if prod is None or id(prod) in chain:
                    continue
                if not all(id(c) in chain for c in graph.consumers.get(s[1], [])):
                    continue
                k = _classify(prod, graph, row_shape, root=root)
                if k is None:
                    continue
                chain[id(prod)] = prod
                kinds[id(prod)] = k
                changed = True

    ordered = [op for op in graph.block.ops if id(op) in chain]
    if len(ordered) < min_ops:
        return None
    n_mm = sum(1 for op in ordered if kinds[id(op)] == "matmul")
    n_red = sum(1 for op in ordered if kinds[id(op)] == "reduce")
    n_row = sum(1 for op in ordered if kinds[id(op)] == "rowwise")
    if n_mm + n_red + n_row == 0:
        return None  # a plain elementwise chain: GenericElementwiseFusionPass's job
    if n_mm and len(ordered) == n_mm:
        return None  # a bare matmul
    if n_mm > 1:
        return None  # the kernels run one product (the JAX kernel replays any number)
    rows = int(np.prod(row_shape[:-1]))
    cols = int(row_shape[-1])
    out_dtype = graph.dtype(root.out_vids[0])
    if out_dtype is None or not out_dtype.is_floating_point:
        return None

    produced = {vid for op in ordered for vid in op.out_vids}
    mm_slots = {}
    for op in ordered:
        if kinds[id(op)] == "matmul":
            specs = op.arg_spec
            mm_slots[specs[0][1]] = "xrow"
            mm_slots[specs[1][1]] = "weight"
            if len(specs) == 3 and specs[2][0] == "var":
                mm_slots[specs[2][1]] = "bcast"
    reduced_shape = row_shape[:-1] + (1,)
    ext, seen, k_dims = [], set(), []
    for op in ordered:
        if kinds[id(op)] == "matmul":
            k_dims.append(int(graph.shape(op.arg_spec[0][1])[-1]))
        for s in op.arg_spec:
            if s[0] != "var" or s[1] in produced or s[1] in seen:
                continue
            vid = s[1]
            vs, dt = graph.shape(vid), graph.dtype(vid)
            if vs is None or dt is None or not dt.is_floating_point:
                return None
            role = mm_slots.get(vid)
            if role is None:
                if vs in (row_shape, reduced_shape):
                    role = "row"
                elif all(d == 1 for d in vs[:-1]):
                    role = "bcast"
                else:
                    return None
            ext.append(ExtInput(vid, vs, dt, int(vs[-1]), role))
            seen.add(vid)
    if not ext:
        return None

    wide_consts = any(s[0] == "const" and _wide_const(s[1], cols)
                      for op in ordered for s in op.arg_spec)
    xrow_vids = {e.vid for e in ext if mm_slots.get(e.vid) == "xrow"}
    xrow_in_elem = any(s[0] == "var" and s[1] in xrow_vids
                       for op in ordered if kinds[id(op)] != "matmul" for s in op.arg_spec)
    col_tilable = (n_mm > 0 and n_red == 0 and n_row == 0 and not wide_consts
                   and not xrow_in_elem
                   and all(e.role != "weight" or e.cols == cols for e in ext))
    mm_vids = xrow_vids | {e.vid for e in ext if mm_slots.get(e.vid) == "weight"}
    mm_ext_in_elem = any(s[0] == "var" and s[1] in mm_vids
                         for op in ordered if kinds[id(op)] != "matmul" for s in op.arg_spec)
    k_tilable = n_mm == 1 and not mm_ext_in_elem and any(e.role == "weight" for e in ext)
    return SubgraphSpec(
        kind="matmul" if n_mm else "reduce", root=root, ops=ordered,
        kinds=[kinds[id(op)] for op in ordered], ext=ext, out_vid=root.out_vids[0],
        out_shape=tuple(out_shape), out_cols=cols if out_shape == row_shape else 1,
        out_dtype=out_dtype, rows=rows, cols=cols, k_dims=tuple(k_dims),
        has_reduce=n_red > 0 or n_row > 0, col_tilable=col_tilable, k_tilable=k_tilable,
        row_shape=tuple(row_shape), op_dtypes=[graph.dtype(op.out_vids[0]) for op in ordered],
        op_shapes=[graph.shape(op.out_vids[0]) for op in ordered],
        device=torch.device(device))


# ---------------------------------------------------------------------------
# the card's schedule space

_MM_BM = {torch.bfloat16: (16, 32, 64, 128), torch.float32: (16, 32, 64)}
_MM_BN = (64, 128, 256)
_SPLIT_K = (128, 256, 512, 1024)
_ROW_WARPS = (1, 2, 4, 8, 16)
_MAX_ROW_COLS = 2048     # a warp holds a row: cols / 32 values a lane for each row value
_SMS = 132               # H100 SXM
_K_STEP_S = 1.5e-7       # one 32-deep step of a block's K loop (a 128 x 128 bf16 tile at
                         # the SM's share of the mma peak): the serial part of a block
_ROW_STEP_S = 2e-8       # one column-group of a row's warp
_LAUNCH_S = 2e-6         # the split's combine launch


def _mm_dtype(spec):
    return next(e.dtype for e in spec.ext if e.role == "xrow")


def _bn_quantum(spec, bm):
    """The tile width's granule: whole 16-column blocks a warp (bf16), a
    16 x 16 thread grid (f32)."""
    if _mm_dtype(spec) == torch.float32:
        return 16
    return 16 * (8 // (2 if bm >= 32 else 1))


def _tile(spec, config):
    """(BM, BN): the block's output tile; a whole-row config pads the row
    to the tile's granule."""
    bm = int(config["block_rows"])
    bc = int(config["block_cols"])
    q = _bn_quantum(spec, bm)
    return bm, -(-bc // q) * q


def _tile_fits(spec, bm, bn):
    """The accumulator a thread holds stays within 128 floats (bf16) or
    64 (f32), so a tile never spills by design."""
    if _mm_dtype(spec) == torch.float32:
        return bm % 16 == 0 and bn % 16 == 0 and (bm // 16) * (bn // 16) <= 64
    wm_ = 2 if bm >= 32 else 1
    return (bm // wm_) % 16 == 0 and (bn // (8 // wm_)) % 16 == 0 and \
        (bm // wm_ // 16) * (bn // (8 // wm_) // 8) * 4 <= 128


def _tiles(spec, configs):
    if spec.kind != "matmul":
        return []
    return [_tile(spec, c) for c in configs]


def enumerate_candidates(spec: SubgraphSpec):
    """Candidate configs on the H100.

    - reduce kind: ``block_rows`` rows (warps) a block, 1-16; the row stays
      whole (``block_cols`` = cols);
    - matmul kind: ``block_rows`` x ``block_cols`` output tiles (rows
      16-128 bf16 / 16-64 f32; cols 64, 128, 256 below cols, and cols
      itself), whole rows only when the chain reduces or has a rowwise op;
      ``grid_order`` both rasters when the grid is 2-D and unsplit;
      ``block_k`` the split-K slices 128-1024 that divide K (and K), for
      K-tilable chains.
    """
    rows, cols = spec.rows, spec.cols
    if spec.kind == "reduce":
        return [{"block_rows": w, "block_cols": cols, "grid_order": "rows_first"}
                for w in _ROW_WARPS if w == 1 or w <= rows]
    bms = [b for b in _MM_BM.get(_mm_dtype(spec), (16, 32, 64)) if b == 16 or b < 2 * rows]
    bcs = ([b for b in _MM_BN if b < cols] if spec.col_tilable else []) + [cols]
    K = spec.k_dims[0] if spec.k_dims else 0
    bks = ([b for b in _SPLIT_K if b < K and K % b == 0] + [K]) if spec.k_tilable and K else [None]
    out, tiles = [], set()
    for br in bms:
        for bc in bcs:
            bm, bn = _tile(spec, {"block_rows": br, "block_cols": bc})
            if not _tile_fits(spec, bm, bn) or (bm, bn) in tiles:
                continue  # a tile of its granule's width is one kernel, enumerated once
            tiles.add((bm, bn))
            gm, gn = -(-rows // bm), -(-cols // bc)
            for bk in bks:
                split = bk is not None and bk < K
                orders = ["rows_first"]
                if not split and gn > 1 and gm > 1:
                    orders.append("cols_first")
                for od in orders:
                    cfg = {"block_rows": br, "block_cols": bc, "grid_order": od}
                    if bk is not None:
                        cfg["block_k"] = bk
                    out.append(cfg)
    return out


def _k_split(spec, config):
    """(block_k, grid_k); (K, 1) when the config keeps K whole."""
    K = spec.k_dims[0] if spec.k_dims else 0
    bk = int(config.get("block_k") or 0)
    if spec.k_tilable and K and bk and bk < K:
        return bk, -(-K // bk)
    return K, 1


def candidate_smem_bytes(spec: SubgraphSpec, config: dict) -> int:
    """Shared memory a block of the candidate takes: none for the reduce
    kind (a row lives in registers); the matmul kind's staged operand tiles
    or its f32 accumulator tile, whichever is larger (and the split's
    combine launch, eight rows of sums, for a reducing chain)."""
    if spec.kind == "reduce":
        return 0
    bm, bn = _tile(spec, config)
    if _mm_dtype(spec) == torch.float32:
        stage = (16 * (bm + 4) + 16 * (bn + 4)) * 4
    else:
        stage = (bm * 40 + 32 * (bn + 8)) * 2
    smem = max(stage, bm * (bn + 4) * 4)
    if _k_split(spec, config)[1] > 1 and spec.has_reduce:
        smem = max(smem, 8 * spec.cols * 4)
    return smem


def candidate_roofline_ms(spec: SubgraphSpec, config: dict, cost_model=None) -> float:
    """Roofline estimate (``cost_model.flops_time``) with the JAX package's
    traffic model: an operand indexed by the column block is re-fetched
    once per row block under ``rows_first``, one indexed by the row block
    once per column block under ``cols_first``; a split re-streams x per
    column block and w per row block and writes and reads its f32
    partials.  A latency term adds what the blocks do in sequence: waves
    of blocks (a matmul block an SM, a reduce warp of 64 an SM) times each
    block's serial steps (its K loop, or its row's column groups), and the
    split's combine launch; it breaks ties between configs of equal
    traffic and lets a split-K config rank ahead where few output tiles
    would leave SMs idle."""
    if cost_model is None:
        from paddle_tpu_torch.cost_model import OpCostModel

        cost_model = OpCostModel(spec.device)
    rows, cols = spec.rows, spec.cols
    if spec.kind == "reduce":
        bm, bn = int(config["block_rows"]), cols
    else:
        bm, bn = int(config["block_rows"]), int(config["block_cols"])
    gm, gn = -(-rows // bm), -(-cols // bn)
    bk, gk = _k_split(spec, config)
    order = config.get("grid_order", "rows_first")
    tiled = gn > 1
    flops = sum(2.0 * rows * k * cols for k in spec.k_dims)
    flops += (len(spec.ops) - len(spec.k_dims)) * rows * cols
    traffic = float(np.prod(spec.out_shape)) * spec.out_dtype.itemsize
    if gk > 1:
        traffic += 2.0 * gk * rows * cols * 4
    for e in spec.ext:
        sz = float(np.prod(e.shape)) * e.dtype.itemsize
        if gk > 1 and e.role == "xrow":
            traffic += sz * gn
        elif gk > 1 and e.role == "weight":
            traffic += sz * gm
        elif tiled and e.cols == cols and e.role in ("bcast", "weight"):
            traffic += sz * (gm if order == "rows_first" else 1)
        elif e.role == "xrow" or (e.role == "row" and not (tiled and e.cols == cols)):
            traffic += sz * (gn if order == "cols_first" else 1)
        else:
            traffic += sz
    if spec.kind == "reduce":
        waves = math.ceil(gm / (_SMS * max(1, 64 // bm)))
        latency = waves * math.ceil(cols / 32) * _ROW_STEP_S
    else:
        waves = math.ceil(gm * gn * gk / _SMS)
        latency = waves * math.ceil(bk / 32) * _K_STEP_S + (_LAUNCH_S if gk > 1 else 0.0)
    return (cost_model.flops_time(flops, traffic) + latency) * 1e3


# ---------------------------------------------------------------------------
# codegen

def build_reference(spec: SubgraphSpec):
    """The replay of the recorded op fns on the external inputs: the
    subgraph's one definition, the gate's twin and the kernels' plain
    version."""
    from .program import replay

    ext_vids = [e.vid for e in spec.ext]
    return lambda *vals: replay(spec.ops, ext_vids, vals, spec.out_vid)


def _subgraph_chain(spec):
    """The codegen description of a spec (static/codegen.py)."""
    from . import codegen

    row_shape = tuple(spec.row_shape)
    reduced = row_shape[:-1] + (1,)
    inputs, vid_index = [], {}
    used_elem = {s[1] for op, kind in zip(spec.ops, spec.kinds) if kind != "matmul"
                 for s in op.arg_spec if s[0] == "var"}
    for k, e in enumerate(spec.ext):
        vid_index[e.vid] = k
        shape = tuple(e.shape)
        if e.role in ("xrow", "weight") and e.vid not in used_elem:
            access = "none"
        elif shape == row_shape:
            access = "row"
        elif shape == reduced:
            access = "red"
        elif all(d == 1 for d in shape[:-1]) and shape[-1] in (1, spec.cols):
            access = "bcast" if shape[-1] == spec.cols else "one"
        else:
            raise ValueError(f"input of shape {shape} in a {row_shape} chain")
        inputs.append(codegen.CInput(e.dtype, access))
    chain = codegen.Chain(inputs=inputs, ops=[], cols=spec.cols, out_cols=spec.out_cols,
                          row_mode=spec.has_reduce or spec.out_cols != spec.cols)
    val_index = {}
    for i, (op, kind) in enumerate(zip(spec.ops, spec.kinds)):
        args = codegen.op_entries(op, vid_index, val_index, chain)
        cls = "row" if tuple(spec.op_shapes[i]) == row_shape else "red"
        if kind == "matmul":
            chain.mm, chain.x_in, chain.w_in = i, args[0][1], args[1][1]
        chain.ops.append(codegen.COp(_base_type(op.type), dict(op.kwargs), args,
                                     spec.op_dtypes[i], cls, kind))
        val_index[op.out_vids[0]] = i
    return chain


def build_kernel(spec: SubgraphSpec, config: dict):
    """The generated kernel of ``spec`` at ``config``: a callable over the
    original-shaped external inputs.  On CUDA tensors it launches the
    kernel (the library, every config of the subgraph, is compiled at the
    first launch); on CPU tensors it runs the replay.  ValueError for a
    config this geometry refuses."""
    return _SubgraphKernel(spec, dict(config))


class _SubgraphKernel:
    def __init__(self, spec, config):
        self.spec, self.config = spec, config
        if spec.kind == "reduce":
            if spec.cols > _MAX_ROW_COLS:
                raise ValueError(f"a row of {spec.cols} > {_MAX_ROW_COLS} columns")
            self.warps = int(config["block_rows"])
            if not 1 <= self.warps <= 32:
                raise ValueError(f"block_rows {self.warps}: 1-32 warps a block")
        else:
            x_dtype = _mm_dtype(spec)
            w_dtype = next(e.dtype for e in spec.ext if e.role == "weight")
            if x_dtype != w_dtype or x_dtype not in (torch.bfloat16, torch.float32):
                raise ValueError(f"the product takes bf16 or f32 operands of one dtype, "
                                 f"got {x_dtype} and {w_dtype}")
            self.bm, self.bn = _tile(spec, config)
            if not _tile_fits(spec, self.bm, self.bn):
                raise ValueError(f"tile {self.bm} x {self.bn}")
            if (spec.has_reduce or spec.out_cols != spec.cols) and self.bn < spec.cols:
                raise ValueError("a reducing chain needs tiles that own whole rows")
            self.bk, self.gk = _k_split(spec, config)
        self.chain = _subgraph_chain(spec)
        self.reference = build_reference(spec)
        self._wide = {}
        self._fn = None  # the loaded entry point, resolved at the first launch

    def __call__(self, *vals):
        from paddle_tpu_torch.ops import use_kernel

        if not use_kernel(*vals):
            return self.reference(*vals)
        return self._launch(vals)

    def _launch(self, vals):
        from paddle_tpu_torch.ops import _cuda_build, count_launch

        from . import codegen

        spec = self.spec
        dev = vals[0].device
        if self._fn is None:  # built and typed once: a launch costs no hashing
            if spec.kind == "reduce":
                name, kind = "pt_rows", "rows"
            else:
                name, kind = (f"pt_mmk_{self.bm}_{self.bn}", "mmk") if self.gk > 1 else \
                    (f"pt_mm_{self.bm}_{self.bn}", "mm")
            tiles = [(self.bm, self.bn)] if spec.kind == "matmul" else []
            self._fn = codegen.entry_point(_cuda_build.load_generated(spec.source(tiles)),
                                           name, kind)
        fn = self._fn
        ptrs, lds, keep = [], [], []
        for e, v in zip(spec.ext, vals):
            if v.dtype != e.dtype or tuple(v.shape) != tuple(e.shape):
                raise TypeError(f"subgraph input {tuple(v.shape)} {v.dtype}, expected "
                                f"{tuple(e.shape)} {e.dtype}")
            if e.role in ("row", "xrow"):
                t = v.reshape(spec.rows, e.cols)
            elif e.role == "weight":
                t = v
            else:
                t = v.reshape(1, -1)
            if t.stride(-1) != 1 or (t.dim() == 2 and t.shape[0] > 1 and t.stride(0) < t.shape[1]):
                t = t.contiguous()
            keep.append(t)
            ptrs.append(t.data_ptr())
            lds.append(t.stride(0) if t.shape[0] > 1 else t.shape[1])
        if dev not in self._wide:
            self._wide[dev] = [w.to(device=dev, dtype=torch.float32).contiguous().reshape(-1)
                               for w in self.chain.wide_values]
        for w in self._wide[dev]:
            ptrs.append(w.data_ptr())
            lds.append(0)
        out = torch.empty((spec.rows, spec.out_cols), dtype=spec.out_dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = None
        if spec.kind == "reduce":
            a = codegen.args_block(ptrs, lds, out.data_ptr())
            with torch.cuda.device(dev):
                err = fn(ctypes.byref(a), spec.rows, self.warps, stream)
            counter = "sched_chain"
        else:
            xi = next(i for i, e in enumerate(spec.ext) if e.role == "xrow")
            wi = next(i for i, e in enumerate(spec.ext) if e.role == "weight")
            x, w = keep[xi], keep[wi]
            K, N = x.shape[1], w.shape[1]
            vec = int(x.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
                      and lds[xi] % 8 == 0 and lds[wi] % 8 == 0
                      and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
            if self.gk > 1:
                ws = torch.empty(self.gk * spec.rows * N, dtype=torch.float32, device=dev)
                a = codegen.args_block(ptrs, lds, out.data_ptr(), ws.data_ptr())
                with torch.cuda.device(dev):
                    err = fn(ctypes.byref(a), spec.rows, N, K, self.bk, vec, stream)
                counter = "sched_chain_ktiled"
            else:
                a = codegen.args_block(ptrs, lds, out.data_ptr())
                cols_first = int(self.config.get("grid_order") == "cols_first")
                with torch.cuda.device(dev):
                    err = fn(ctypes.byref(a), spec.rows, N, K, cols_first, vec, stream)
                counter = "sched_chain"
        if err != 0:
            raise RuntimeError(f"{counter} {spec.label()}{spec.config_label(self.config)}: "
                               f"launch failed with CUDA error {err}")
        count_launch(counter)
        return out.reshape(spec.out_shape)
