"""The port's serving chains (ops/decode_chain.py, the int8 pools of
ops/paged_attention.py, the schedule searcher) against the JAX package,
on the CPU.

On the CPU the port's chain wrappers take their plain versions; the JAX
chains run their Pallas kernels (``_build_batch``, ``_build_prefill``) in
interpret mode, as the JAX package's own tests run them.  Both sides get
the same numpy inputs made from a seed.  Attention outputs are held at
2e-5 (f32: the two sides sum in different orders).

The int8 pools are bit-equal to the JAX package's eager ops: both
quantize with IEEE f32 division and round half to even.  Under ``jax.jit``
XLA rewrites the division by the constant 127 into a multiplication by
its reciprocal, which differs by one ulp for a few percent of inputs, so
against jitted JAX code (the interpret-mode kernel, the jitted engine) a
scale may differ by one ulp and a payload element by one quantization
step; those tests count the differing elements and hold each within one
step.  The port keeps the IEEE quotient because its CUDA kernels compute
it too.  The searcher's decisions are made deterministic with
``measure_override``, as in tests/test_decode_chain.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import decode_chain as jdc
from paddle_tpu.ops import paged_attention as jpa

from paddle_tpu_torch import set_flags
from paddle_tpu_torch.ops import autotune as at
from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.static import schedule_search as ss

F32_TOL = 2e-5


def _arrays(pool):
    """A pool's arrays as numpy: payload, and scales for an int8 pool."""
    if isinstance(pool, (jpa.QuantPool, tpa.QuantPool)):
        return [np.asarray(pool.data), np.asarray(pool.scale)]
    return [np.asarray(pool)]


def _assert_pools_equal(jpool, tpool, steps=0):
    """Pools equal element for element, or with ``steps=1`` within one
    step: one int8 quantization step of the payload, one ulp of an f32
    scale.  Returns the count of elements that differ."""
    n = 0
    for a, b in zip(_arrays(jpool), _arrays(tpool), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        diff = a != b
        n += int(diff.sum())
        if steps == 0:
            assert not diff.any()
        elif a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= steps
        else:  # finite, non-negative f32 scales: neighbours differ by one in their bits
            assert np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64)).max() <= steps
    return n


def _both_pools(rng, kv, nb, nkv, bs, h, fill):
    """The same K and V pools in both packages, the ``fill`` blocks poured
    with random content (fresh scales for int8)."""
    jpools = jpa.alloc_paged_cache(nb, nkv, bs, h, jnp.int8 if kv == "int8" else jnp.float32)
    tpools = tpa.alloc_paged_cache(nb, nkv, bs, h, "int8" if kv == "int8" else torch.float32,
                                   "cpu")
    jout = []
    for jp, tp in zip(jpools, tpools):
        vals = rng.standard_normal((len(fill), nkv, bs, h)).astype(np.float32)
        jout.append(jpa.paged_pour_blocks(jp, jnp.asarray(vals), list(fill)))
        tpa.paged_pour_blocks(tp, torch.from_numpy(vals), list(fill))
    return tuple(jout), tpools


# ---------------------------------------------------------------- int8 pools


@pytest.mark.parametrize("nkv,bs,h", [(2, 4, 16), (4, 16, 64), (2, 8, 32)])
def test_int8_pour_write_gather_bit_equal(nkv, bs, h):
    """Pour (fresh scales), a run of decode writes (scale growth with the
    rescale of a touched block, writes that do not grow it, a fresh
    block's first slot, a block's last slot) and the dequantizing gather:
    every byte and scale equal to the JAX package's."""
    rng = np.random.default_rng(nkv * 100 + bs)
    b, w = 3, 3
    nb = b * w + 2
    (jk, _), (tk, _) = _both_pools(rng, "int8", nb, nkv, bs, h, range(b * w))
    _assert_pools_equal(jk, tk)
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    pos = np.array([bs - 1, bs, 2 * bs - 2], np.int32)  # last slot, fresh block, mid
    for step in range(2 * bs):
        new = (rng.standard_normal((b, nkv, h)) * (0.5 + step % 5)).astype(np.float32)
        jk = jpa.paged_write(jk, jnp.asarray(new), jnp.asarray(tables), jnp.asarray(pos))
        tpa.paged_write(tk, torch.from_numpy(new), torch.from_numpy(tables),
                        torch.from_numpy(pos))
        _assert_pools_equal(jk, tk)
        pos = np.minimum(pos + 1, w * bs - 1)
    want = np.asarray(jpa.paged_gather(jk, jnp.asarray(tables)))
    got = tpa.paged_gather(tk, torch.from_numpy(tables)).numpy()
    assert np.array_equal(want, got)
    assert tpa.pool_nbytes(tk) == jk.nbytes == nb * nkv * bs * h + nb * nkv * 4


def test_int8_chunk_write_bit_equal():
    """A multi-token chunk write, two rows of it landing in one block."""
    rng = np.random.default_rng(3)
    (jk, _), (tk, _) = _both_pools(rng, "int8", 8, 2, 4, 8, range(4))
    tables = np.array([[0, 1], [2, 3]], np.int32)
    pos = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    new = (3 * rng.standard_normal((2, 3, 2, 8))).astype(np.float32)
    jk = jpa.paged_write_chunk(jk, jnp.asarray(new), jnp.asarray(tables), jnp.asarray(pos))
    tpa.paged_write_chunk(tk, torch.from_numpy(new), torch.from_numpy(tables),
                          torch.from_numpy(pos))
    _assert_pools_equal(jk, tk)


# ------------------------------------------------------------- decode chain


def _chain_inputs(kv, b=3, n=4, nkv=2, h=16, bs=4, w=4, seed=0):
    rng = np.random.default_rng(seed)
    nb = b * w + b
    jpools, tpools = _both_pools(rng, kv, nb, nkv, bs, h, range(b * w))
    q = rng.standard_normal((b, n, h)).astype(np.float32)
    kn = (2 * rng.standard_normal((b, nkv, h))).astype(np.float32)
    vn = (2 * rng.standard_normal((b, nkv, h))).astype(np.float32)
    tables = np.arange(b * w, dtype=np.int32).reshape(b, w)
    lens = np.array([1, bs + 1, w * bs][:b], np.int32)  # fresh block, full table
    spec = jdc.DecodeChainSpec(batch=b, num_heads=n, num_kv_heads=nkv, head_dim=h,
                               block_size=bs, max_blocks=w, num_blocks=nb, kv=kv,
                               dtype=np.float32)
    return spec, jpools, tpools, (q, kn, vn, tables, lens)


@pytest.mark.parametrize("nkv", [2, 4])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_fused_decode_step_matches_jax_kernel_and_twin(kv, nkv):
    """The port's fused_decode_step (its plain version on the CPU) against
    the JAX ``_build_batch`` kernel in interpret mode and against the JAX
    unfused ops: pools bit-equal, attention within 2e-5 (f32 model; 'bf16'
    here names full-precision pools in the model's dtype)."""
    spec, (jk, jv), (tk, tv), (q, kn, vn, tables, lens) = _chain_inputs(kv, nkv=nkv)
    jargs = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tables),
             jnp.asarray(lens))
    fused = jax.jit(spec.build({"layout": "batch", "gather": "take"}))
    j_o, j_k, j_v = fused(jk, jv, *jargs)
    r_o, r_k, r_v = spec.reference()(jk, jv, *jargs)  # eager: IEEE division
    t_o, t_k, t_v = dc.fused_decode_step(
        tk, tv, torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(tables), torch.from_numpy(lens), config={"layout": "batch"})
    _assert_pools_equal(r_k, t_k)
    _assert_pools_equal(r_v, t_v)
    # the jitted kernel: within one step, and the f32 pools exactly
    steps = 1 if kv == "int8" else 0
    differing = _assert_pools_equal(j_k, t_k, steps) + _assert_pools_equal(j_v, t_v, steps)
    assert differing <= 2 * 3 * nkv + 2 * 3 * nkv * 4 * 16  # scales and touched pages at most
    for want in (j_o, r_o):
        np.testing.assert_allclose(t_o.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_rows_layout_plain_version_matches_jax_twin():
    """decode_chain_rows' plain version (the CPU path of kernel #8) against
    the JAX unfused ops; the JAX ``rows`` kernel is not the reference (it
    fails its own parity test on this tree)."""
    spec, (jk, jv), (tk, tv), (q, kn, vn, tables, lens) = _chain_inputs("int8", seed=1)
    r_o, r_k, r_v = spec.reference()(jk, jv, *map(jnp.asarray, (q, kn, vn, tables, lens)))
    t_o, t_k, t_v = dc.decode_chain_rows(tk, tv, *map(torch.from_numpy,
                                                      (q, kn, vn, tables, lens)), splits=4)
    _assert_pools_equal(r_k, t_k)
    _assert_pools_equal(r_v, t_v)
    np.testing.assert_allclose(t_o.numpy(), np.asarray(r_o), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("s,t", [(64, 64), (64, 192), (128, 256)])
def test_fused_prefill_attention_matches_jax_kernel(s, t):
    rng = np.random.default_rng(s + t)
    n, h = 4, 16
    q = rng.standard_normal((1, s, n, h)).astype(np.float32)
    k = rng.standard_normal((1, t, n, h)).astype(np.float32)
    v = rng.standard_normal((1, t, n, h)).astype(np.float32)
    spec = jdc.PrefillChainSpec(seq=s, kv_len=t, num_heads=n, head_dim=h, dtype=np.float32)
    want = np.asarray(jax.jit(spec.build({"block_q": s, "stage": "take"}))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for bq in (64, 128):
        if s % bq:
            continue
        got = dc.fused_prefill_attention(*map(torch.from_numpy, (q, k, v)), block_q=bq)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


# ----------------------------------------------------------------- searcher


@pytest.fixture()
def tmp_cache(tmp_path):
    """A fresh autotune cache under a tmp dir, zeroed counters."""
    from paddle_tpu_torch import serving

    set_flags({"FLAGS_autotune_cache_dir": str(tmp_path)})
    at._CACHES.clear()
    ss.reset_schedule_search_stats()
    serving.reset_schedule_decode_stats()
    yield tmp_path
    set_flags({"FLAGS_autotune_cache_dir": "", "FLAGS_schedule_search": False})
    at._CACHES.clear()
    ss.reset_schedule_search_stats()
    serving.reset_schedule_decode_stats()


def _spec(kv="bf16", **kw):
    """A small geometry a card kernel takes (head_dim 64, group 2)."""
    base = dict(batch=2, num_heads=4, num_kv_heads=2, head_dim=64, block_size=4, max_blocks=2,
                num_blocks=8, kv=kv, dtype=torch.float32)
    base.update(kw)
    return dc.DecodeChainSpec(**base)


def _win(fn, args, *, label, config):
    return 0.4 if config is not None else 1.0


def _lose(fn, args, *, label, config):
    return 4.0 if config is not None else 1.0


def _counting(calls):
    def measure(fn, args, *, label, config):
        calls.append(config)
        return 1.0

    return measure


def test_candidate_space_by_kv_kind():
    assert _spec("bf16").enumerate_configs() == [{"layout": "batch"}]
    int8 = _spec("int8").enumerate_configs()
    assert int8 == [{"layout": "batch"}] + [{"layout": "rows", "splits": s} for s in (2, 4, 8)]
    with pytest.raises(ValueError, match="int8"):
        _spec("bf16").build({"layout": "rows", "splits": 2})
    with pytest.raises(ValueError):
        _spec("int8").build({"layout": "rows", "splits": 3})
    pf = dc.PrefillChainSpec(seq=128, kv_len=256, num_heads=4, head_dim=16)
    assert pf.enumerate_configs() == [{"block_q": 64}, {"block_q": 128}]
    assert dc.PrefillChainSpec(seq=64, kv_len=64, num_heads=4,
                               head_dim=16).enumerate_configs() == [{"block_q": 64}]
    assert dc.PrefillChainSpec(seq=100, kv_len=200, num_heads=4,
                               head_dim=16).enumerate_configs() == []
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _spec(mesh=object())


def test_traffic_bytes_hand_computed():
    """B 2, N 4, Nkv 2, H 8, bs 4, W 2, f32: synthetic lens [2, 8], 10 live
    positions in 3 pages.

      f32 pools:  reads 2*10*2*8*4 = 1280, writes 2*2*2*8*4 = 256
      int8 pools: reads 2*(10*2*8 + 3*2*4) = 368,
                  writes 2*(2*2*4*8 + 2*2*4) = 288 (touched pages and scales)
      both:       q and o 2*2*4*8*4 = 512, k_new and v_new 2*2*2*8*4 = 256,
                  tables 2*2*8 = 32, lens 16
      rows, 2 splits: partials 2*2*4*2*(8+2)*4 = 1280 more."""
    fixed = 512 + 256 + 32 + 16
    assert list(_spec(head_dim=8).synthetic_lens()) == [2, 8]
    assert _spec("bf16", head_dim=8).traffic_bytes({"layout": "batch"}) == 1280 + 256 + fixed
    assert _spec("int8", head_dim=8).traffic_bytes({"layout": "batch"}) == 368 + 288 + fixed
    assert _spec("int8", head_dim=8).traffic_bytes({"layout": "rows", "splits": 2}) == \
        368 + 288 + fixed + 1280


def test_prefill_traffic_and_smem_hand_computed():
    """The prefill chain's accounting describes the kernel that runs.
    bf16 (the sm90 kernel, 132 SMs where there is no card), S 128, N 32,
    H 128: a row is 32 x 128 x 2 = 8192 bytes.

      T 640, block_q 128: one q tile reads K/V up to key 639: 5 tiles, 640
                   rows; (2*128 + 2*640) * 8192 = 12,582,912; one split
      T 640, block_q 64: two q tiles, each up to key 575 / 639: 5 tiles
                   each; (2*128 + 2*1280) * 8192 = 23,068,672
      T 2048, block_q 128: 16 tiles, 2048 rows; (2*128 + 2*2048) * 8192 =
                   35,651,584; 4 splits: partials 2*4*128*32*(128+1)*4 =
                   16,908,288 more
      shared memory, block_q 128: Q 32,768 + 2 stages of K and V 131,072
                   + 7 barriers 56 + 1,024 slack = 164,920
    f32 (the FMA kernel, unchanged), S 128, T 200, N 4, H 16, block_q 64:
    rows 136 + 200 = 336; (256 + 672) * 4 * 16 * 4 = 237,568."""
    spec = dc.PrefillChainSpec(seq=128, kv_len=640, num_heads=32, head_dim=128)
    assert spec.traffic_bytes({"block_q": 128}) == 12_582_912
    assert spec.traffic_bytes({"block_q": 64}) == 23_068_672
    assert spec.smem_bytes({"block_q": 128}) == 164_920
    long = dc.PrefillChainSpec(seq=128, kv_len=2048, num_heads=32, head_dim=128)
    assert long.traffic_bytes({"block_q": 128}) == 35_651_584 + 16_908_288
    f32 = dc.PrefillChainSpec(seq=128, kv_len=200, num_heads=4, head_dim=16,
                              dtype=torch.float32)
    assert f32.traffic_bytes({"block_q": 64}) == 237_568


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_all_candidates_pass_parity_against_twin(kv):
    spec = _spec(kv)
    ref = spec.reference()(*spec.synthetic_args())
    for cfg in spec.enumerate_configs():
        assert spec.parity_ok(spec.build(cfg), spec.synthetic_args(), ref), cfg


def test_parity_gate_blocks_wrong_candidates(tmp_cache):
    """A fast candidate with wrong numerics is never measured."""

    class LyingSpec(dc.DecodeChainSpec):
        def build(self, config):
            inner = dc.DecodeChainSpec.build(self, config)

            def wrong(*args):
                o, kc, vc = inner(*args)
                return o + 1e-3, kc, vc

            return wrong

    calls = []
    with ss.measure_override(_counting(calls)):
        decision = ss.ScheduleSearcher(budget=3).search(LyingSpec(**_spec().__dict__))
    assert calls == [] and not decision.accepted
    assert ss.schedule_search_stats()["pruned_parity"] == 1


def test_refused_candidates_skip_and_other_errors_propagate(tmp_cache):
    """Only a ValueError from ``build`` (a geometry the spec refuses) skips
    a candidate; any other error stops the search."""

    class RefusingSpec(dc.DecodeChainSpec):
        def build(self, config):
            if config.get("layout") == "batch":
                raise ValueError("refused")
            return dc.DecodeChainSpec.build(self, config)

    with ss.measure_override(_win):
        d = ss.ScheduleSearcher(roofline_margin=1e9).search(
            RefusingSpec(**_spec("int8").__dict__))
    assert d.accepted and d.config["layout"] == "rows"
    assert ss.schedule_search_stats()["refused"] == 1

    class BrokenSpec(dc.DecodeChainSpec):
        def build(self, config):
            raise RuntimeError("CUDA error 700")

    with ss.measure_override(_win), pytest.raises(RuntimeError, match="700"):
        ss.ScheduleSearcher().search(BrokenSpec(**_spec("bf16", batch=3).__dict__))


@pytest.mark.parametrize("kw", [dict(dtype=torch.float16), dict(head_dim=32),
                                dict(kv="int8", dtype=torch.float16),
                                dict(num_heads=32, num_kv_heads=2),
                                dict(dtype="float16")])  # a model config's dtype name
def test_geometry_no_card_kernel_takes_is_refused_and_disabled(tmp_cache, kw):
    """An f16 model, head_dim 32 or a group of 16: no route of the card
    takes it, so ``build`` refuses every candidate before anything is
    built (``refused``), nothing is measured, and the verdict is
    ``disabled``, as the JAX package's parity gate prunes a candidate that
    raises."""
    calls = []
    with ss.measure_override(_counting(calls)):
        d = dc.ensure_decision(_spec(**kw))
    stats = ss.schedule_search_stats()
    assert d.status == "disabled" and calls == []
    assert stats["refused"] >= 1 and stats["disabled"] == 1
    # every candidate the rankings kept was refused: none built, none timed
    assert (stats["refused"] + stats["pruned_roofline"] + stats["pruned_smem"]
            == stats["candidates"] == len(_spec(**kw).enumerate_configs()))
    assert stats["measured"] == 0 and stats["pruned_parity"] == 0


def _prefill_refused(dtype, h):
    try:
        dc._check_prefill(*[torch.zeros(1, 64, 2, h, dtype=dtype)] * 3)
    except (TypeError, ValueError) as err:
        return str(err)
    return None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("h", [32, 64, 128, 256])
@pytest.mark.parametrize("group", [1, 8, 16])
def test_refusal_is_the_launch_rule(dtype, h, group):
    """``decode_refusal`` and ``prefill_refusal`` (what ``build`` asks)
    refuse exactly what the launches' checks refuse, with their words."""
    for pool in (dtype, torch.int8):
        try:
            dc._decode_route(dtype, pool, h, group)
            launch = None
        except (TypeError, ValueError) as err:
            launch = str(err)
        assert dc.decode_refusal(dtype, pool, h, group) == launch
    assert dc.prefill_refusal(dtype, h) == _prefill_refused(dtype, h)
    spec = dc.PrefillChainSpec(seq=64, kv_len=128, num_heads=2, head_dim=h, dtype=dtype)
    if _prefill_refused(dtype, h) is None:
        assert spec.build({"block_q": 64}).keywords == {"block_q": 64}
    else:
        with pytest.raises(ValueError, match=r"bf16 or f32|head_dim"):
            spec.build({"block_q": 64})


def test_search_persists_and_cold_reload_never_remeasures(tmp_cache):
    with ss.measure_override(_win):
        d1 = dc.ensure_decision(_spec("bf16"))
    with ss.measure_override(_lose):
        d2 = dc.ensure_decision(_spec("int8"))
    assert d1.status == "accepted" and d1.win == pytest.approx(2.5)
    assert d2.status == "disabled" and d2.win == pytest.approx(0.25)
    raw = json.load(open(os.path.join(str(tmp_cache), at.device_kind_slug() + ".json")))
    (entry,) = raw["schedule/decode_bf16"].values()
    assert entry["config"] == {"layout": "batch"} and entry["meta"]["win"] > 1.0
    (dentry,) = raw["schedule/decode_int8"].values()
    assert dentry["config"] == {"disabled": True}

    at._CACHES.clear()
    calls = []
    with ss.measure_override(_counting(calls)):
        d3 = dc.ensure_decision(_spec("bf16"))
        d4 = dc.ensure_decision(_spec("int8"))
    assert calls == []
    assert d3.status == "cache" and d3.config == entry["config"]
    assert d4.status == "cache_disabled"
    stats = ss.schedule_search_stats()
    assert stats["cache_hits"] == 1 and stats["disabled_hits"] == 1


def test_cached_config_is_parity_checked_again(tmp_cache):
    """A cache file is trusted about speed, never numerics: a cached config
    whose kernel now disagrees with the twin is disabled."""
    with ss.measure_override(_win):
        assert dc.ensure_decision(_spec()).accepted

    class NowWrong(dc.DecodeChainSpec):
        def build(self, config):
            inner = dc.DecodeChainSpec.build(self, config)
            return lambda *a: (lambda o, k, v: (o * 2, k, v))(*inner(*a))

    at._CACHES.clear()
    assert dc.ensure_decision(NowWrong(**_spec().__dict__)).status == "disabled"


def test_autotune_cache_never_writes_the_package(tmp_path, monkeypatch):
    """With no cache dir flag, verdicts go under ~/.cache, never into the
    package directory."""
    monkeypatch.setenv("HOME", str(tmp_path))
    set_flags({"FLAGS_autotune_cache_dir": ""})
    at._CACHES.clear()
    try:
        path = at.record("schedule/x", {"a": 1}, {"b": 2}, 1.0).path
    finally:
        at._CACHES.clear()
    assert path == os.path.join(str(tmp_path), ".cache", "paddle_tpu_torch", "autotune",
                                at.device_kind_slug() + ".json")
    assert at.validate_tile(232448) is None and at.validate_tile(232449) is not None


def test_cost_model_measures_only_on_the_card():
    """No time is taken on the CPU: measure raises there (the CPU tests
    decide through measure_override); the roofline needs no card."""
    from paddle_tpu_torch.cost_model import OpCostModel

    cm = OpCostModel("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cm.measure("x", lambda a: a + 1, torch.ones(4))
    assert cm.flops_time(1e9, 0) == pytest.approx(1e9 / 0.5e12)
    assert cm.flops_time(0, 5e9) == pytest.approx(0.1)
