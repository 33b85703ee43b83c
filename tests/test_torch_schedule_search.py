"""The Program-subgraph schedule search (ScheduleSearchPass) against the
JAX package, on the CPU.

The discovery and decision tests of tests/test_schedule_search.py, each
run on the same program in both packages: the same subgraphs (kind, ops,
input roles, tiling flags) and the same substitutions under the same
injected measurements (``measure_override``, as the JAX tests inject
theirs); on the CPU the substituted op runs the replay, so fetches equal
the unfused program's.  The schedule space is the H100's, so candidate
lists are checked for the port's own rules.  The generated code of every
K-split candidate is built for the CPU (tests/codegen_host.py) and held
against the replay: f32 within 1e-5 relative, plus 1e-6 of the largest
magnitude (products summed in other orders).  Static bert_tiny with all
three passes: the same op counts as JAX and logits within 1e-4.
"""

import collections
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu import static as jstatic
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import autotune as jat
from paddle_tpu.static import schedule_search as jss
from paddle_tpu.static.passes import apply_pass as japply
from paddle_tpu.static.rewrite import PallasFusionPass as JPallasFusionPass
from paddle_tpu.static.rewrite import ProgramGraph as JProgramGraph
from paddle_tpu.static.rewrite import ScheduleSearchPass as JScheduleSearchPass

import codegen_host
from paddle_tpu_torch import set_flags
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import autotune as tat
from paddle_tpu_torch.static import schedule_search as tss
from paddle_tpu_torch.static.passes import apply_pass as tapply
from paddle_tpu_torch.static.rewrite import PallasFusionPass, ProgramGraph, ScheduleSearchPass

TOL = 1e-4


@pytest.fixture()
def caches(tmp_path):
    """Fresh verdict caches for both packages (apart: both name the CPU
    'cpu') and zeroed search counters."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    paddle.set_flags({"FLAGS_autotune_cache_dir": str(tmp_path / "jax")})
    set_flags({"FLAGS_autotune_cache_dir": str(tmp_path / "port")})
    jat._CACHES.clear()
    tat._CACHES.clear()
    jss.reset_schedule_search_stats()
    tss.reset_schedule_search_stats()
    yield tmp_path
    paddle.set_flags({"FLAGS_autotune_cache_dir": ""})
    set_flags({"FLAGS_autotune_cache_dir": ""})
    jat._CACHES.clear()
    tat._CACHES.clear()


def _win(fn, args, *, label, config):
    """Every candidate beats the twin; larger row blocks slightly
    preferred (the JAX tests' measurement)."""
    if config is None:
        return 1.0
    return 0.5 - 1e-4 * config["block_rows"]


def _lose(fn, args, *, label, config):
    return 1.0 if config is None else 5.0


def _optypes(prog):
    return [op.type for op in prog.global_block().ops]


# ------------------------------------------------------ the two programs

def _jfeed(prog, name, shape, dtype="float32"):
    return prog.add_feed(prog.new_var(jax.ShapeDtypeStruct(shape, getattr(jax.numpy, dtype)),
                                      name))


def _programs(body, feeds, dtype="float32"):
    """``body(pkg, F, *feeds)`` captured in both packages, every feed in
    ``dtype``: [(prog, out)]."""
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        jout = body(paddle, jF, *[_jfeed(jprog, n, s, dtype) for n, s in feeds])
    tprog = tstatic.Program()
    with tstatic.program_guard(tprog):
        tout = body(torch, F, *[tstatic.data(n, list(s), dtype) for n, s in feeds])
    return (jprog, jout), (tprog, tout)


def _matmul_chain(pkg, f, x, w, b):
    """matmul -> bias add -> relu -> mean (no named pattern takes it)."""
    h = pkg.matmul(x, w) + b
    h = f.relu(h)
    return pkg.mean(h, **_axis(pkg, -1))


def _axis(pkg, a):
    return {"axis": a, "keepdim": True} if pkg is paddle else {"dim": a, "keepdim": True}


def _pmax(pkg, x):
    if pkg is paddle:
        return pkg.max(x, axis=-1, keepdim=True)
    return torch.max(x, -1, keepdim=True).values


def _softmax_chain(pkg, f, x):
    """The decomposed softmax: exp feeds both the sum and the divide."""
    t = pkg.exp(x - _pmax(pkg, x))
    return t / pkg.sum(t, **_axis(pkg, -1))


def _epilogue_chain(pkg, f, x, w, b):
    return f.relu(pkg.matmul(x, w) + b)


MATMUL_FEEDS = [("x", (32, 16)), ("w", (16, 64)), ("b", (64,))]
SOFTMAX_FEEDS = [("x", (4, 8, 32))]


def _specs(graph_cls, ss, prog, out, **kw):
    graph = graph_cls(prog, (out._vid,))
    return [s for s in (ss.match_subgraph(op, graph, **kw) for op in prog.global_block().ops)
            if s]


def _facts(spec):
    return (spec.kind, [o.type for o in spec.ops], sorted(e.role for e in spec.ext),
            tuple(spec.out_shape), spec.rows, spec.cols, spec.has_reduce, spec.col_tilable,
            spec.k_tilable)


def _same_spec(jprog, jout, tprog, tout):
    (js,) = _specs(JProgramGraph, jss, jprog, jout)
    (ts,) = _specs(ProgramGraph, tss, tprog, tout)
    assert _facts(ts) == _facts(js)
    return js, ts


def _feed_values(feeds, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32) for n, s in feeds}


def _search(pass_cls, prog, out, measure, budget, module, **kw):
    with module.measure_override(measure):
        p = pass_cls([out._vid], searcher=module.ScheduleSearcher(budget=budget), **kw)
        return p.apply(prog), p


# ---------------------------------------------------------------- discovery

def test_discovery_matmul_rooted_chain_missed_by_named_patterns(caches):
    (jprog, jout), (tprog, tout) = _programs(_matmul_chain, MATMUL_FEEDS)
    assert PallasFusionPass([tout._vid]).apply(tprog.clone()) == 0
    _, spec = _same_spec(jprog, jout, tprog, tout)
    assert spec.kind == "matmul" and len(spec.ops) == 4
    assert spec.has_reduce and not spec.col_tilable
    assert sorted(e.role for e in spec.ext) == ["bcast", "weight", "xrow"]
    assert spec.out_shape == (32, 1) and spec.rows == 32 and spec.cols == 64


def test_discovery_softmax_dag(caches):
    (jprog, jout), (tprog, tout) = _programs(_softmax_chain, SOFTMAX_FEEDS)
    _, spec = _same_spec(jprog, jout, tprog, tout)
    assert spec.kind == "reduce" and len(spec.ops) == 5  # max, sub, exp, sum, div
    assert spec.rows == 32 and spec.cols == 32
    assert len(spec.ext) == 1 and spec.ext[0].role == "row"


def test_discovery_refuses_side_effect_and_collective(caches):
    """A random op interrupts the chain; a recorded collective is never
    crossed either.  The port's random op is torch's dropout in training."""
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [16, 32], "float32")
        h = F.dropout(torch.exp(x), p=0.5, training=True)
        out = torch.sum(h * h, -1, keepdim=True)
    graph = ProgramGraph(prog, (out._vid,))
    found = [s for s in (tss.match_subgraph(op, graph) for op in prog.global_block().ops) if s]
    assert found
    for spec in found:
        assert all("dropout" not in o.type and o.type != "exp" for o in spec.ops)

    prog2 = tstatic.Program()
    with tstatic.program_guard(prog2):
        x = tstatic.data("x2", [16, 32], "float32")
        red = prog2.record("all_reduce", lambda v: v, (torch.tanh(x),), {})
        out2 = torch.sum(red * red, -1, keepdim=True)
    graph2 = ProgramGraph(prog2, (out2._vid,))
    for op in prog2.global_block().ops:
        spec = tss.match_subgraph(op, graph2)
        if spec is not None:
            assert all(o.type not in ("all_reduce", "tanh") for o in spec.ops)


def _square_k(pkg, f, x, w):
    return f.relu(pkg.matmul(x, w) + 1.0)


def test_square_k_matmul_chain_fuses_with_untiled_cols(caches):
    """K == N: the activation keeps the xrow role (never col-sliced)."""
    feeds = [("x", (64, 512)), ("w", (512, 512))]
    (jprog, jout), (tprog, tout) = _programs(_square_k, feeds)
    _same_spec(jprog, jout, tprog, tout)
    vals = _feed_values(feeds)
    (ref,) = tstatic.Executor("cpu").run(tprog, feed=vals, fetch_list=[tout])
    jn, _ = _search(JScheduleSearchPass, jprog, jout, _win, 2, jss)
    tn, _ = _search(ScheduleSearchPass, tprog, tout, _win, 2, tss, device="cpu")
    assert tn == jn == 1, tss.schedule_search_stats()
    assert tss.schedule_search_stats()["disabled"] == 0
    assert _optypes(tprog) == _optypes(jprog) == ["sched_chain_3"]
    (got,) = tstatic.Executor("cpu").run(tprog, feed=vals, fetch_list=[tout])
    np.testing.assert_array_equal(got, ref)


def test_non_last_axis_reduction_on_square_dims_never_fuses(caches):
    """On square dims an axis=1 reduction's shape equals a last-axis one's;
    the probe of the bound axis refuses it, the keepdim last-axis twin
    fuses, in both packages."""
    def axis1(pkg, f, x):
        return pkg.sum(pkg.exp(x), **({"axis": 1} if pkg is paddle else {"dim": 1}))

    def last(pkg, f, x):
        return pkg.sum(pkg.exp(x), **_axis(pkg, -1))

    feeds = [("x", (2, 16, 16))]
    (jprog, jout), (tprog, tout) = _programs(axis1, feeds)
    assert _specs(ProgramGraph, tss, tprog, tout) == []
    assert _specs(JProgramGraph, jss, jprog, jout) == []
    tn, _ = _search(ScheduleSearchPass, tprog, tout, _win, 2, tss, device="cpu")
    assert tn == 0
    (jprog2, jout2), (tprog2, tout2) = _programs(last, feeds)
    jn, _ = _search(JScheduleSearchPass, jprog2, jout2, _win, 2, jss)
    tn2, _ = _search(ScheduleSearchPass, tprog2, tout2, _win, 2, tss, device="cpu")
    assert tn2 == jn == 1


def test_fetch_frontier_interior_vid_refused_via_rollback(caches):
    (jprog, jout), (tprog, tout) = _programs(_softmax_chain, SOFTMAX_FEEDS)
    for prog, out, cls, ss, kw in ((jprog, jout, JScheduleSearchPass, jss, {}),
                                   (tprog, tout, ScheduleSearchPass, tss, {"device": "cpu"})):
        exp_op = next(op for op in prog.global_block().ops if op.type == "exp")
        with ss.measure_override(_win):
            p = cls([out._vid, exp_op.out_vids[0]], searcher=ss.ScheduleSearcher(budget=2), **kw)
            assert p.apply(prog) == 0
        assert p.refused >= 1
        assert "sched_chain_5" not in _optypes(prog)


# ------------------------------------------------- candidates and pruning

def test_candidate_space_and_pruning_order(caches):
    # K 256: the f32 space's one whole-row tile at 32 columns (128 x 64),
    # with K whole and split 2 and 4 ways
    feeds = [("x", (64, 256)), ("w", (256, 32)), ("b", (32,))]
    _, (tprog, tout) = _programs(_matmul_chain, feeds)
    (spec,) = _specs(ProgramGraph, tss, tprog, tout)
    cands = tss.enumerate_candidates(spec)
    assert len(cands) >= 3
    # a reduce tail: tiles own whole rows
    assert all(c["block_cols"] == spec.cols for c in cands)
    assert tat.validate_tile(tss.candidate_smem_bytes(spec, cands[0])) is None
    assert tat.validate_tile(64 << 20) is not None
    measured = []

    def counting(fn, args, *, label, config):
        if config is not None:
            measured.append(config)
        return _win(fn, args, label=label, config=config)

    with tss.measure_override(counting):
        decision = tss.ScheduleSearcher(budget=2).search(spec)
    assert decision.accepted and len(measured) <= 2
    stats = tss.schedule_search_stats()
    assert stats["measured"] == len(measured) and stats["candidates"] == len(cands)


def test_dimension_order_changes_roofline_traffic(caches):
    # 256 rows: the f32 tiles (at least 32 rows at these widths) leave a
    # 2-D grid, where both rasters are offered
    feeds = [("x", (256, 16)), ("w", (16, 256)), ("b", (256,))]
    (jprog, jout), (tprog, tout) = _programs(_epilogue_chain, feeds)
    _, spec = _same_spec(jprog, jout, tprog, tout)
    assert spec.col_tilable
    cands = tss.enumerate_candidates(spec)
    assert {c["grid_order"] for c in cands} == {"rows_first", "cols_first"}
    cfg = {"block_rows": 16, "block_cols": 128, "block_k": 16}
    a = tss.candidate_roofline_ms(spec, dict(cfg, grid_order="rows_first"))
    b = tss.candidate_roofline_ms(spec, dict(cfg, grid_order="cols_first"))
    assert a != b


# -------------------------------------------- gate, cache and substitution

def _persisted(path, kernel):
    raw = json.load(open(os.path.join(str(path), tat.device_kind_slug("cpu") + ".json")))
    return raw[kernel]


def test_accepted_schedule_substitutes_and_matches_numerics(caches):
    (jprog, jout), (tprog, tout) = _programs(_matmul_chain, MATMUL_FEEDS)
    vals = _feed_values(MATMUL_FEEDS)
    (ref,) = tstatic.Executor("cpu").run(tprog, feed=vals, fetch_list=[tout])
    jn, _ = _search(JScheduleSearchPass, jprog, jout, _win, 3, jss)
    tn, _ = _search(ScheduleSearchPass, tprog, tout, _win, 3, tss, device="cpu")
    assert tn == jn == 1
    assert _optypes(tprog) == _optypes(jprog) == ["sched_chain_4"]
    (op,) = tprog.global_block().ops
    assert op.kwargs["kind"] == "matmul" and "block_rows" in op.kwargs["schedule"]
    (got,) = tstatic.Executor("cpu").run(tprog, feed=vals, fetch_list=[tout])
    np.testing.assert_array_equal(got, ref)
    stats = tss.schedule_search_stats()
    assert stats["subgraphs_found"] == 1 and stats["accepted"] == 1
    (entry,) = _persisted(caches / "port", "schedule/matmul").values()
    assert entry["meta"]["win"] > 1.0 and "block_rows" in entry["config"]


def test_losing_schedule_disabled_persisted_never_refired(caches):
    (jprog, jout), (tprog, tout) = _programs(_softmax_chain, SOFTMAX_FEEDS)
    calls = []

    def measure(fn, args, *, label, config):
        calls.append(config)
        return _lose(fn, args, label=label, config=config)

    jn, _ = _search(JScheduleSearchPass, jprog, jout, _lose, 2, jss)
    tn, _ = _search(ScheduleSearchPass, tprog, tout, measure, 2, tss, device="cpu")
    assert tn == jn == 0 and calls
    assert "sched_chain_5" not in _optypes(tprog)
    stats = tss.schedule_search_stats()
    assert stats["disabled"] == 1 and stats["accepted"] == 0
    (entry,) = _persisted(caches / "port", "schedule/reduce").values()
    assert entry["config"] == {"disabled": True} and entry["meta"]["win"] < 1.0
    # a cold reload: the disabled verdict stops the search before any measurement
    tat._CACHES.clear()
    calls.clear()
    _, (tprog2, tout2) = _programs(_softmax_chain, SOFTMAX_FEEDS)
    tn2, _ = _search(ScheduleSearchPass, tprog2, tout2, measure, 2, tss, device="cpu")
    assert tn2 == 0 and calls == []
    assert tss.schedule_search_stats()["disabled_hits"] >= 1


def test_accepted_schedule_served_from_cache_without_remeasure(caches):
    _, (tprog, tout) = _programs(_matmul_chain, MATMUL_FEEDS)
    _search(ScheduleSearchPass, tprog, tout, _win, 2, tss, device="cpu")
    tat._CACHES.clear()
    calls = []

    def measure(fn, args, *, label, config):
        calls.append(config)
        return 1.0

    found = tss.schedule_search_stats()["subgraphs_found"]
    _, (tprog2, tout2) = _programs(_matmul_chain, MATMUL_FEEDS)
    n, _ = _search(ScheduleSearchPass, tprog2, tout2, measure, 2, tss, device="cpu")
    assert n == 1 and calls == []
    stats = tss.schedule_search_stats()
    assert stats["cache_hits"] >= 1 and stats["subgraphs_found"] == found


# ----------------------------------------------------------- K-tiling

@pytest.mark.parametrize("m,k,n", [(32, 256, 64), (32, 256, 256), (256, 256, 64)])
def test_ktiled_candidates_generated_code_matches_replay(caches, m, k, n):
    """Every split of the contraction that the space offers (64 and 128:
    at most 8 slices, and the whole K) runs the generated epilogue on its
    f32 sum of partials as the cluster merge takes it (each rank's rows,
    the slices in k order), for every tile's row block, on the CPU, within
    the parity tolerance of the replay; on the two square-dim aliasing
    twins too."""
    if codegen_host.compiler() is None:
        pytest.skip("no host C++ compiler to build the generated chain text")
    feeds = [("x", (m, k)), ("w", (k, n)), ("b", (n,))]
    (jprog, jout), (tprog, tout) = _programs(_epilogue_chain, feeds)
    _, spec = _same_spec(jprog, jout, tprog, tout)
    assert spec.k_tilable
    cands = tss.enumerate_candidates(spec)
    splits = sorted({c["block_k"] for c in cands})
    assert splits == [64, 128, k] and all(c["grid_order"] == "rows_first"
                                          for c in cands if c["block_k"] < k)
    args = spec.synthetic_args()
    want = spec.reference()(*args)
    rtol, atol = tss.parity_tolerance(spec.out_dtype, want)
    for c in cands:
        got = codegen_host.run_subgraph(spec, args, block_k=c["block_k"],
                                        block_rows=c["block_rows"])
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_ktiled_reduce_tail_chain_generated_code(caches):
    if codegen_host.compiler() is None:
        pytest.skip("no host C++ compiler to build the generated chain text")
    feeds = [("x", (32, 256)), ("w", (256, 64)), ("b", (64,))]
    _, (tprog, tout) = _programs(_matmul_chain, feeds)
    (spec,) = _specs(ProgramGraph, tss, tprog, tout)
    assert spec.k_tilable and spec.has_reduce and not spec.col_tilable
    args = spec.synthetic_args()
    want = spec.reference()(*args)
    rtol, atol = tss.parity_tolerance(spec.out_dtype, want)
    for bk in (64, 128, 256):
        torch.testing.assert_close(codegen_host.run_subgraph(spec, args, block_k=bk), want,
                                   rtol=rtol, atol=atol)


def test_ktiled_roofline_costs_restreaming(caches):
    """At one tile a split models more traffic (x re-streamed per column
    block, w per row block; its partials stay in the cluster's shared
    memory, so none are written), and its ranking charges the merge."""
    feeds = [("x", (64, 512)), ("w", (512, 256)), ("b", (256,))]
    _, (tprog, tout) = _programs(_epilogue_chain, feeds)
    (spec,) = _specs(ProgramGraph, tss, tprog, tout)
    base = {"block_rows": 32, "block_cols": 128, "grid_order": "rows_first"}
    split, whole = dict(base, block_k=128), dict(base, block_k=512)
    assert tss.candidate_traffic_bytes(spec, split) > tss.candidate_traffic_bytes(spec, whole)
    # gm = gn = 2: both read w once per row block; the split reads x once
    # per column block, the whole K once
    assert (tss.candidate_traffic_bytes(spec, split) - tss.candidate_traffic_bytes(spec, whole)
            == (2 - 1) * 64 * 512 * 4)


# ------------------------------------------------- the H100 space itself

def _port_spec(body, feeds, dtype="float32"):
    """A port-only capture's one subgraph spec."""
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        out = body(torch, F, *[tstatic.data(n, list(s), dtype) for n, s in feeds])
    (spec,) = _specs(ProgramGraph, tss, prog, out)
    return spec


def _pooler(pkg, f, x, w, b):
    """BERT's pooler as the port's functionals record it (x @ w + b)."""
    from paddle_tpu_torch.nn import functional as PF

    return PF.tanh(PF.linear(x, w, b))


SPACE_CASES = {  # chip_smoke.py's matmul shapes and small ragged ones, f32 and bf16
    "matmul_mean_f32": (_matmul_chain, [("x", (1024, 512)), ("w", (512, 512)), ("b", (512,))],
                        "float32"),
    "ktiled_f32": (_epilogue_chain, [("x", (1024, 2048)), ("w", (2048, 1024)),
                                     ("b", (1024,))], "float32"),
    "pooler_bf16": (_pooler, [("x", (32, 768)), ("w", (768, 768)), ("b", (768,))], "bfloat16"),
    "ragged_f32": (_matmul_chain, [("x", (100, 600)), ("w", (600, 130)), ("b", (130,))],
                   "float32"),
    "wide_row_bf16": (_matmul_chain, [("x", (70, 256)), ("w", (256, 2000)), ("b", (2000,))],
                      "bfloat16"),
    "wide_row_f32": (_matmul_chain, [("x", (70, 256)), ("w", (256, 2000)), ("b", (2000,))],
                     "float32"),
}


@pytest.mark.parametrize("case", sorted(SPACE_CASES))
def test_every_candidate_of_the_space_fits_the_card(case):
    """Each config's tile is one the kernels instantiate (f32: 4 x 8, 8 x 8
    or 8 x 16 outputs a thread over 256 threads; bf16: at most 128 f32
    accumulators a thread), its shared memory is within a block's 227 KB,
    a split runs at most 8 blocks a cluster in slices of a multiple of 16,
    and ``build`` takes it."""
    body, feeds, dtype = SPACE_CASES[case]
    spec = _port_spec(body, feeds, dtype)
    cands = tss.enumerate_candidates(spec)
    assert cands
    for c in cands:
        bm, bn = tss._tile(spec, c)
        assert tss._tile_fits(spec, bm, bn), c
        if dtype == "float32":
            assert bm * bn // 256 in (32, 64, 128) and bm <= 128, c
        else:
            wm = 2 if bm >= 32 else 1
            assert (bm // wm // 16) * (bn // (8 // wm) // 8) * 4 <= 128, c
        assert tss.candidate_smem_bytes(spec, c) <= 232448, c
        bk, gk = tss._k_split(spec, c)
        assert gk <= 8 and (gk == 1 or bk % 16 == 0), c
        if spec.has_reduce:
            assert bn >= spec.cols, c  # a reducing chain's tile owns whole rows
        tss.build_kernel(spec, c)


class _H100:
    """The card's roofline (the cost model's H100 peaks), whatever device
    the test runs on."""

    def flops_time(self, flops, nbytes=0):
        return max(flops / 989e12, nbytes / 3350e9)


def test_ranking_puts_a_split_of_the_pooler_first():
    """BERT-base's pooler (32 x 768 x 768 bf16): whole K, the 6 output
    tiles of its best width leave the card idle through 24 k-steps, so the
    ranking puts a split config (one cluster launch) first, as the static
    codegen path adopts it."""
    body, feeds, dtype = SPACE_CASES["pooler_bf16"]
    spec = _port_spec(body, feeds, dtype)
    ranked = sorted(tss.enumerate_candidates(spec),
                    key=lambda c: tss.candidate_roofline_ms(spec, c, _H100()))
    assert tss._k_split(spec, ranked[0])[1] > 1, ranked[0]


@pytest.fixture(scope="module")
def merge_cases():
    """Per (dtype, chain): the spec of x [48, 600] @ w [600, 64] + b, relu
    (elementwise) or relu then the row mean (reducing), captured in both
    packages; its synthetic inputs, the replay, and the JAX package's
    ``build_kernel`` at its first config (run as the JAX package's tests
    run it on the CPU)."""
    from paddle_tpu.static import schedule_search as jss2

    out = {}
    for dtype in ("float32", "bfloat16"):
        for name, body in (("elementwise", _epilogue_chain), ("reducing", _matmul_chain)):
            feeds = [("x", (48, 600)), ("w", (600, 64)), ("b", (64,))]
            (jprog, jout), (tprog, tout) = _programs(body, feeds, dtype)
            js, ts = _same_spec(jprog, jout, tprog, tout)
            args = ts.synthetic_args()
            jvals = [jax.numpy.asarray(a.float().numpy(), getattr(jax.numpy, dtype))
                     for a in args]
            jref = np.asarray(jss2.build_kernel(js, jss2.enumerate_candidates(js)[0])(*jvals)
                              .astype(jax.numpy.float32))
            out[dtype, name] = (ts, args, ts.reference()(*args), jref)
    return out


@pytest.mark.parametrize("gk", range(2, 9))
@pytest.mark.parametrize("chain", ["elementwise", "reducing"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_build_follows_the_cluster_merge(merge_cases, dtype, chain, gk):
    """The generated chain text built for the CPU with K 600 split into
    ``gk`` slices of a multiple of 16 (the last one short), at every row
    block of the space (rows dealt to the cluster's ranks, BM not always a
    multiple of gk), summing each rank's rows of the partials in k order:
    within the parity tolerance (f32 1e-5, bf16 one step, relative) of the
    replay of the captured ops and of the JAX package's kernel."""
    if codegen_host.compiler() is None:
        pytest.skip("no host C++ compiler to build the generated chain text")
    spec, args, want, jref = merge_cases[dtype, chain]
    K = spec.k_dims[0]
    bk = -(-(-(-K // gk)) // 16) * 16
    assert -(-K // bk) == gk and K % bk
    rtol, atol = tss.parity_tolerance(spec.out_dtype, want)
    rows = sorted({tss._tile(spec, c)[0] for c in tss.enumerate_candidates(spec)})
    for bm in rows + [spec.rows]:
        got = codegen_host.run_subgraph(spec, args, block_k=bk, block_rows=bm)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got.float().numpy(), jref, rtol=rtol,
                                   atol=rtol * 0.1 * float(np.abs(jref).max()) + 2 * atol)


def test_ktile_never_offered_when_mm_operand_feeds_elem(caches):
    def body(pkg, f, x, w):
        return f.relu(pkg.matmul(x, w) + x)

    feeds = [("x", (32, 256)), ("w", (256, 256))]
    (jprog, jout), (tprog, tout) = _programs(body, feeds)
    _, spec = _same_spec(jprog, jout, tprog, tout)
    assert not spec.k_tilable and not spec.col_tilable
    assert all(c.get("block_k") is None for c in tss.enumerate_candidates(spec))


# ----------------------------------------------------------------- end to end

def test_executor_flag_end_to_end(caches):
    """FLAGS_schedule_search through Executor.run: discovered, searched,
    substituted, and the fetch equal to the unfused program's."""
    vals = _feed_values(MATMUL_FEEDS)
    _, (tprog, tout) = _programs(_matmul_chain, MATMUL_FEEDS)
    _, (plain, pout) = _programs(_matmul_chain, MATMUL_FEEDS)
    (ref,) = tstatic.Executor("cpu").run(plain, feed=vals, fetch_list=[pout])
    set_flags({"FLAGS_schedule_search": True})
    try:
        with tss.measure_override(_win):
            (got,) = tstatic.Executor("cpu").run(tprog, feed=vals, fetch_list=[tout])
    finally:
        set_flags({"FLAGS_schedule_search": False})
    assert _optypes(tprog) == ["sched_chain_4"]
    np.testing.assert_array_equal(got, ref)


def test_static_bert_tiny_with_the_three_passes_matches_jax(caches):
    """bert_tiny captured in both packages; PallasFusionPass, then
    generic_elementwise_fusion, then the Executor with schedule search
    (every candidate winning): the same op counts (the mask chain as one
    vpu_chain_4, the pooler as one sched_chain_2) and logits within 1e-4."""
    paddle.seed(3)
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(), num_classes=2)
    jm.eval()
    tm = tbert.BertForSequenceClassification(tbert.bert_tiny(), num_classes=2, device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    tm.eval()
    ids = np.random.default_rng(0).integers(1, 100, (2, 16)).astype(np.int32)
    ids[1, 9:] = 0
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        jout = jm(jstatic.data("ids", [2, 16], "int32"))
    tprog = tstatic.Program()
    with tstatic.program_guard(tprog):
        tout = tm(tstatic.data("ids", [2, 16], "int32"))
    JPallasFusionPass([jout._vid]).apply(jprog)
    PallasFusionPass([tout._vid]).apply(tprog)
    assert japply(jprog, "generic_elementwise_fusion", fetch_vids=[jout._vid]) == 1
    assert tapply(tprog, "generic_elementwise_fusion", fetch_vids=[tout._vid]) == 1
    paddle.set_flags({"FLAGS_schedule_search": True})
    set_flags({"FLAGS_schedule_search": True})
    try:
        with jss.measure_override(_win):
            (want,) = jstatic.Executor().run(jprog, feed={"ids": ids}, fetch_list=[jout])
        with tss.measure_override(_win):
            (got,) = tstatic.Executor("cpu").run(tprog, feed={"ids": ids}, fetch_list=[tout])
    finally:
        paddle.set_flags({"FLAGS_schedule_search": False})
        set_flags({"FLAGS_schedule_search": False})
    jc = collections.Counter(_optypes(jprog))
    tc = collections.Counter(_optypes(tprog))
    for t in ("vpu_chain_4", "sched_chain_2", "add_layer_norm", "matmul_epilogue",
              "scaled_dot_product_attention"):
        assert tc[t] == jc[t] >= 1, (t, jc, tc)
    assert tc["tanh"] == jc["tanh"] == 0
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
