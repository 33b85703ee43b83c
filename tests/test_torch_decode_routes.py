"""The decode chains' routes and the rules the sm90 decode kernel
implements, on the CPU.

The decode chains have two kernels on the card: ``csrc/decode_chain_sm90.cu``
(bf16 q with bf16 or int8 pools; bulk page copies into an mbarrier ring,
each (row, kv head)'s live pages dealt over a cluster of blocks) and
``decode_chain.cu``'s kernel (f32).  The route is a pure function of the
dtypes, the head dim and the group, picked before any launch, so it is
tested here for every class; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

What the kernel computes from its indices is tested through its Python
twins: ``decode_cluster`` (the blocks a (row, kv head)), ``page_runs`` (the
pages each block takes) and ``merge_partials`` (how the warps', the
cluster's blocks' and the splits' partial softmax sums are merged), the
last in f32 on plain partials against ``decode_chain_plain`` and against
the JAX package's ``_build_batch`` kernel in interpret mode (2e-5: sums in
other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import decode_chain as jdc
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.ops import paged_attention as tpa

F32_TOL = 2e-5
H100_SMS = 132


# ------------------------------------------------------------------ routes


@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_bf16_takes_the_sm90_kernel(pool, h, group):
    assert dc._decode_route(torch.bfloat16, pool, h, group) == "sm90"


@pytest.mark.parametrize("pool", [torch.float32, torch.int8])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_f32_takes_the_general_kernel(pool, h, group):
    assert dc._decode_route(torch.float32, pool, h, group) == "general"


@pytest.mark.parametrize("q,pool,h,group,err,match", [
    (torch.float16, torch.float16, 128, 1, TypeError, "bf16 or f32"),
    (torch.float16, torch.int8, 64, 4, TypeError, "bf16 or f32"),
    (torch.bfloat16, torch.float32, 128, 1, TypeError, "pools of"),
    (torch.float32, torch.bfloat16, 128, 1, TypeError, "pools of"),
    (torch.bfloat16, torch.bfloat16, 32, 1, ValueError, "head_dim"),
    (torch.bfloat16, torch.int8, 256, 1, ValueError, "head_dim"),
    (torch.float32, torch.float32, 256, 1, ValueError, "head_dim"),
    (torch.bfloat16, torch.bfloat16, 128, 16, ValueError, "at most 8"),
    (torch.float32, torch.int8, 64, 9, ValueError, "at most 8")])
def test_what_no_kernel_takes_is_refused(q, pool, h, group, err, match):
    with pytest.raises(err, match=match):
        dc._decode_route(q, pool, h, group)


# ------------------------------------------------------------ cluster rule


@pytest.mark.parametrize("b,nkv,w,want", [
    (4, 32, 64, 4),    # 7B: 128 (row, kv head) pairs on 132 SMs; 512 blocks
    (4, 8, 64, 8),     # GQA 32:8: 32 pairs; 256 blocks
    (4, 32, 17, 4),    # the ragged case's table
    (1, 32, 64, 8),    # B = 1
    (1, 1, 1, 1),      # one page: one block
    (1, 1, 2, 2),      # a two-page table: no block without a page
    (1, 1, 5, 4),
    (8, 32, 64, 2),    # 256 pairs: two blocks each
    (16, 32, 64, 1)])  # 512 pairs fill the card alone
def test_decode_cluster_fills_the_card(b, nkv, w, want):
    c = dc.decode_cluster(b, nkv, w, H100_SMS)
    assert c == want and c in (1, 2, 4, 8)
    assert c <= max(1, w)  # a full table gives every block a page
    # doubling stops once the grid holds 3 blocks an SM
    assert c == 1 or b * nkv * (c // 2) < 3 * H100_SMS


def test_full_table_gives_every_block_a_run():
    """At a full 64-page table every block of the 7B cluster holds 16
    pages, of the GQA cluster 8."""
    for nkv, c, per in ((32, 4, 16), (8, 8, 8)):
        assert dc.decode_cluster(4, nkv, 64, H100_SMS) == c
        assert [len(r) for r in dc.page_runs(64 * 16, 16, c)] == [per] * c


# --------------------------------------------------------------- page runs


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 2, 5, 43])
@pytest.mark.parametrize("kind", ["one", "fresh page", "last slot"])
def test_page_runs_deal_every_live_page_once(bs, parts, k, kind):
    """The kernel's dealing: every live page in exactly one run, runs whole
    pages in order, exactly one run holding pos = lens - 1 (the run whose
    block writes the token), and positions covered exactly once."""
    lens = {"one": 1, "fresh page": bs * k + 1, "last slot": bs * k}[kind]
    runs = dc.page_runs(lens, bs, parts)
    assert len(runs) == parts
    pages = -(-lens // bs)
    dealt = [p for r in runs for p in r]
    assert dealt == list(range(pages))  # each live page once, in order
    per = -(-pages // parts)
    for i, r in enumerate(runs):
        assert r.step == 1 and (len(r) == 0 or r.start == i * per)
        assert len(r) <= per
    pos = lens - 1
    holders = [i for i, r in enumerate(runs) if pos // bs in r]
    assert len(holders) == 1
    assert runs[holders[0]][-1] == pos // bs  # the token's page is its run's last
    positions = [t for r in runs for p in r for t in range(p * bs, min(lens, (p + 1) * bs))]
    assert positions == list(range(lens))


def test_empty_runs_where_pages_run_out():
    runs = dc.page_runs(18, 16, 8)  # 2 pages over 8 blocks
    assert [len(r) for r in runs] == [1, 1, 0, 0, 0, 0, 0, 0]
    assert [len(r) for r in dc.page_runs(0, 16, 4)] == [0, 0, 0, 0]


# ------------------------------------------------------------- the merge


def _partial(q, keys, vals, scale):
    """One part's (m in log2 units, l, unnormalised acc) of q [G, H]
    against keys/vals [T, H], f32; T = 0 gives (-inf, 0, 0)."""
    g, h = q.shape
    if keys.shape[0] == 0:
        return (torch.full((g,), float("-inf")), torch.zeros(g), torch.zeros(g, h))
    s2 = (q @ keys.T) * scale * math.log2(math.e)
    m = s2.amax(-1)
    p = torch.exp2(s2 - m[:, None])
    return m, p.sum(-1), p @ vals


def _two_level(q, keys, vals, scale, lens, bs, parts, warps=4):
    """The kernel's two merges on plain partials: each run's keys dealt
    over ``warps`` warps key by key, the warps merged into the block's
    partial, the blocks merged into the output."""
    blocks = []
    for run in dc.page_runs(lens, bs, parts):
        idx = [t for p in run for t in range(p * bs, min(lens, (p + 1) * bs))]
        parts_w = [_partial(q, keys[idx[w::warps]], vals[idx[w::warps]], scale)
                   for w in range(warps)]
        m, l, acc = (torch.stack(x, -1) for x in zip(*parts_w))
        acc = acc.transpose(-1, -2)  # [G, warps, H]
        bm = m.amax(-1)
        bms = torch.where(bm == float("-inf"), torch.zeros_like(bm), bm)
        f = torch.exp2(m - bms[:, None])
        blocks.append((bm, (f * l).sum(-1), (f[..., None] * acc).sum(-2)))
    m, l, acc = (torch.stack(x, -1) for x in zip(*blocks))
    return dc.merge_partials(m, l, acc.transpose(-1, -2))


def _inputs(kv, b=3, n=4, nkv=2, h=16, bs=4, w=4, seed=0):
    """The same pools and decode-step inputs in both packages (f32 model;
    'bf16' names full-precision pools), lengths 1, bs + 1 (a fresh page)
    and w * bs (a full table)."""
    rng = np.random.default_rng(seed)
    nb = b * w + b
    jpools = jpa.alloc_paged_cache(nb, nkv, bs, h, jnp.int8 if kv == "int8" else jnp.float32)
    tpools = tpa.alloc_paged_cache(nb, nkv, bs, h, "int8" if kv == "int8" else torch.float32,
                                   "cpu")
    jout = []
    for jp, tp in zip(jpools, tpools):
        vals = rng.standard_normal((b * w, nkv, bs, h)).astype(np.float32)
        jout.append(jpa.paged_pour_blocks(jp, jnp.asarray(vals), list(range(b * w))))
        tpa.paged_pour_blocks(tp, torch.from_numpy(vals), list(range(b * w)))
    q = rng.standard_normal((b, n, h)).astype(np.float32)
    kn = (2 * rng.standard_normal((b, nkv, h))).astype(np.float32)
    vn = (2 * rng.standard_normal((b, nkv, h))).astype(np.float32)
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    lens = np.array([1, bs + 1, w * bs][:b], np.int32)
    spec = jdc.DecodeChainSpec(batch=b, num_heads=n, num_kv_heads=nkv, head_dim=h,
                               block_size=bs, max_blocks=w, num_blocks=nb, kv=kv,
                               dtype=np.float32)
    return spec, tuple(jout), tpools, (q, kn, vn, tables, lens)


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_merged_partials_match_plain_and_jax_kernel(kv, parts):
    """Run the kernel's dealing and merges on plain f32 partials over the
    pools the write leaves (empty runs and warps at m = -inf, l = 0):
    within 2e-5 of decode_chain_plain and of the JAX ``_build_batch``
    kernel (interpret mode, as test_fused_decode_step_matches_jax_kernel_
    and_twin runs it)."""
    spec, (jk, jv), (tk, tv), (q, kn, vn, tables, lens) = _inputs(kv)
    jargs = tuple(map(jnp.asarray, (q, kn, vn, tables, lens)))
    j_o = jax.jit(spec.build({"layout": "batch", "gather": "take"}))(jk, jv, *jargs)[0]
    targs = tuple(map(torch.from_numpy, (q, kn, vn, tables, lens)))
    want, kc, vc = dc.decode_chain_plain(tk, tv, *targs)
    keys, vals = tpa.paged_gather(kc, targs[3]), tpa.paged_gather(vc, targs[3])
    b, n, h = q.shape
    nkv, bs = keys.shape[1], spec.block_size
    group, scale = n // nkv, 1.0 / math.sqrt(h)
    got = torch.empty(b, n, h)
    for i in range(b):
        for kvh in range(nkv):
            rows = slice(kvh * group, (kvh + 1) * group)
            got[i, rows] = _two_level(targs[0][i, rows].float(), keys[i, kvh].float(),
                                      vals[i, kvh].float(), scale, int(lens[i]), bs, parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_o), atol=F32_TOL, rtol=F32_TOL)


def test_merge_of_only_empty_parts_is_zero():
    m = torch.full((2, 4), float("-inf"))
    out = dc.merge_partials(m, torch.zeros(2, 4), torch.zeros(2, 4, 8))
    assert torch.equal(out, torch.zeros(2, 8))


# ----------------------------------------------------- the spec's model


def _spec(kv, n=4, nkv=2, dtype=torch.bfloat16):
    return dc.DecodeChainSpec(batch=2, num_heads=n, num_kv_heads=nkv, head_dim=64,
                              block_size=4, max_blocks=2, num_blocks=6, kv=kv, dtype=dtype)


def test_sm90_traffic_and_smem_hand_computed():
    """bf16 models run decode_chain_sm90.cu, which copies whole pages.
    B 2, N 4, Nkv 2, H 64, bs 4, W 2: synthetic lens [2, 8], 3 pages, 12
    positions copied (10 live).

      bf16 pools: reads 2*12*2*64*2 = 6144, writes 2*2*2*64*2 = 1024
      int8 pools: reads 2*(12*2*64 + 3*2*4) = 3120,
                  writes 2*(2*2*4*64 + 2*2*4) = 2080
      both:       q and o 2*2*4*64*2 = 2048, k_new and v_new 2*2*2*64*2 =
                  1024, tables 2*2*8 = 32, lens 16
      batch: the cluster merges in shared memory, nothing more; rows, 2
                  splits: partials 2*2*4*2*(64+2)*4 = 8448 more.
    Shared memory: decode_cluster(2, 2, 2, 132) = 2 blocks, runs of 1
    page, so one stage and 2 mbarriers: bf16 2*512 + 16 = 1040, int8
    2*256 + 16 = 528; G 2, 2*66 floats a partial: 4 warps' and, in the
    cluster, 2 blocks', and 2 scales: batch (6*132 + 2)*4 = 3176, rows
    (4*132 + 2)*4 = 2120."""
    fixed = 2048 + 1024 + 32 + 16
    assert list(_spec("bf16").synthetic_lens()) == [2, 8]
    assert _spec("bf16").sm90() and not _spec("bf16", dtype=torch.float32).sm90()
    assert _spec("bf16").traffic_bytes({"layout": "batch"}) == 6144 + 1024 + fixed
    assert _spec("int8").traffic_bytes({"layout": "batch"}) == 3120 + 2080 + fixed
    assert _spec("int8").traffic_bytes({"layout": "rows", "splits": 2}) == \
        3120 + 2080 + fixed + 8448
    assert _spec("bf16").parts({"layout": "batch"}) == 2
    assert _spec("bf16").smem_bytes({"layout": "batch"}) == 1040 + 3176
    assert _spec("int8").smem_bytes({"layout": "rows", "splits": 2}) == 528 + 2120


def test_sm90_smem_at_the_serving_geometries():
    """7B (G 1) and GQA 32:8 (G 4) at bs 16, H 128, W 64: clusters of 4
    (runs of 16 pages) and 8 (runs of 8), int8 rows of 8 splits (runs of 8);
    4 stages of 8 KB bf16 K and V pages, 8 of 4 KB int8; 130 floats a
    partial row."""
    def spec(nkv, kv):
        return dc.DecodeChainSpec(batch=4, num_heads=32, num_kv_heads=nkv, head_dim=128,
                                  block_size=16, max_blocks=64, num_blocks=260, kv=kv)
    assert dc._ring_stages(4096, 8) == 4 and dc._ring_stages(2048, 8) == 8
    assert spec(32, "bf16").smem_bytes({"layout": "batch"}) == 32768 + 64 + (8 * 130 + 2) * 4
    assert spec(32, "int8").smem_bytes({"layout": "rows", "splits": 8}) == \
        32768 + 128 + (4 * 130 + 2) * 4
    assert spec(8, "bf16").smem_bytes({"layout": "batch"}) == \
        32768 + 64 + (12 * 4 * 130 + 2) * 4
    for nkv in (32, 8):
        for kv in ("bf16", "int8"):
            for cfg in spec(nkv, kv).enumerate_configs():
                assert spec(nkv, kv).smem_bytes(cfg) < 227 * 1024
