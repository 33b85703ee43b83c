"""The routes of the matmul epilogue and the prefill chain, and the rule the
sm90 prefill kernel implements, on the CPU.

Both ops have two kernels on the card: a TMA/wgmma kernel
(``csrc/matmul_epilogue_sm90.cu``, ``csrc/prefill_chain_sm90.cu``) for the
layouts TMA reads, and a general one (``csrc/matmul_epilogue.cu``,
``decode_chain.cu``) for the rest.  The route is a pure function of dtype,
shape and layout, picked before any launch, so it is tested here for every
class; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The sm90 prefill kernel splits each (query tile, head)'s key range over
``prefill_splits`` blocks and merges their partials by their logsumexps;
that merge is checked here in f32 on plain partials against
``prefill_chain_plain`` (2e-5: sums in other orders).
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import decode_chain as dc
from paddle_tpu_torch.ops import matmul_epilogue as me

F32_TOL = 2e-5
BASE = 0x7F0000000000  # a 16-byte aligned address


def _strides(layout, rows, cols):
    """(row, column) strides in elements of a [rows, cols] operand."""
    return {"contiguous": (cols, 1),
            "padded": (cols + 8, 1),       # a view of a wider tensor: 16-byte rows still
            "narrow": (cols + 4, 1),       # rows not a multiple of 16 bytes
            "transposed": (1, rows)}[layout]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("layout", ["contiguous", "padded", "narrow", "transposed",
                                    "misaligned"])
@pytest.mark.parametrize("operand", ["x", "w"])
def test_epilogue_route_every_dtype_stride_and_alignment(dtype, layout, operand):
    """BERT-base's FFN product: the sm90 kernel for bf16 and f16 when x and
    w both have unit column stride, 16-byte row pitches and aligned bases;
    one operand that breaks it sends the call to the general kernel."""
    m, k, n = 4096, 768, 3072
    xs, ws = _strides("contiguous", m, k), _strides("contiguous", k, n)
    xp = wp = BASE
    odd = _strides("contiguous" if layout == "misaligned" else layout,
                   *((m, k) if operand == "x" else (k, n)))
    if operand == "x":
        xs, xp = odd, BASE + (2 if layout == "misaligned" else 0)
    else:
        ws, wp = odd, BASE + (2 if layout == "misaligned" else 0)
    sm90 = dtype in (torch.bfloat16, torch.float16) and layout in ("contiguous", "padded")
    assert me._route(dtype, m, k, n, xs, ws, xp, wp) == ("sm90" if sm90 else "general")


@pytest.mark.parametrize("m,k,n,want", [
    (4096, 768, 3072, "sm90"),   # the main path
    (100, 768, 3072, "sm90"),    # ragged M: TMA zero-fills, stores predicated
    (4096, 72, 3072, "sm90"),    # K not a multiple of 64: 144-byte rows
    (1, 768, 3072, "sm90"),      # one row: its pitch is any that holds it
    (100, 72, 130, "general"),   # N 130: 260-byte rows
    (33, 77, 40, "general"),     # K 77: 154-byte rows of x
    (64, 0, 64, "general"),      # no K: nothing for TMA to read
])
def test_epilogue_route_by_shape(m, k, n, want):
    xs = (k if m > 1 else 7, 1)
    assert me._route(torch.bfloat16, m, k, n, xs, (n, 1), BASE, BASE) == want


def test_epilogue_cpu_tensors_take_the_plain_version():
    """A CPU tensor takes the plain version, whatever its route."""
    from paddle_tpu_torch import ops

    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 32, generator=g).to(torch.bfloat16)
    got = ops.matmul_bias_act(x, w, None, "gelu")
    torch.testing.assert_close(got, me.matmul_bias_act_plain(x, w, None, "gelu"))
    assert ops.launch_counts()["matmul_epilogue"] == 0
    assert ops.launch_counts()["matmul_epilogue_sm90"] == 0


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "sm90"), (torch.float32, "general")])
def test_prefill_route_by_dtype(dtype, want):
    assert dc._prefill_route(dtype) == want


@pytest.mark.parametrize("layout", ["narrow", "hmajor", "misaligned"])
def test_prefill_layouts_tma_cannot_read_are_refused(layout):
    """Every route needs TMA's layout (the prefill chain always has): a
    row stride that is not 16 bytes, a non-unit H stride or a base that is
    not 16-byte aligned is refused before any launch."""
    q = torch.zeros(1, 128, 4, 128, dtype=torch.bfloat16)
    if layout == "narrow":
        q = torch.zeros(1, 128, 4, 132, dtype=torch.bfloat16)[..., :128]
    elif layout == "hmajor":
        q = torch.zeros(1, 128, 128, 4, dtype=torch.bfloat16).transpose(2, 3)
    else:
        q = torch.zeros(1 * 128 * 4 * 128 + 1, dtype=torch.bfloat16)[1:].view(1, 128, 4, 128)
    k = torch.zeros(1, 256, 4, 128, dtype=torch.bfloat16)
    assert dc._prefill_layout(k) and not dc._prefill_layout(q)
    with pytest.raises(ValueError, match="unit stride on H"):
        dc._check_prefill(q, k, k)


@pytest.mark.parametrize("s,t,n,block_q,want", [
    (128, 640, 32, 128, 1),    # the chained engines' longest chunk: 5 tiles, one split
    (128, 896, 32, 64, 1),     # 7 tiles: two splits would hold fewer than 4 each
    (128, 1024, 32, 128, 2),   # 8 tiles: two splits of 4
    (128, 2048, 32, 128, 4),   # 32 blocks a split: 4 fill 128 of 132 SMs
    (128, 2048, 32, 64, 1),    # 64 blocks: half the card busy unsplit, which is kept
    (128, 4096, 4, 64, 8),     # 8 blocks a split: 32 tiles dealt 4 each
    (128, 1100, 4, 64, 2),     # T not a multiple of 128: 9 tiles dealt 5, 4
    (128, 4096, 132, 64, 1),   # the grid is full without splits
])
def test_prefill_splits_fill_the_card(s, t, n, block_q, want):
    splits = dc.prefill_splits(s, t, n, block_q, 132)
    assert splits == want
    blocks = -(-s // block_q) * n
    tiles = -(-t // 128)
    per = -(-tiles // splits)
    assert blocks * splits <= max(132, blocks)  # no more than one wave
    assert (splits - 1) * per < tiles           # no split left empty
    assert splits == 1 or tiles // splits >= 4  # and none shorter than 4 tiles
    assert splits == 1 or 4 * blocks <= 132     # only a grid three quarters idle splits


def test_one_split_gives_no_combine_launch():
    """The search's roofline counts the combine launch only where there is
    more than one split; at the chained engines' lengths there is one."""
    one = dc.PrefillChainSpec(seq=128, kv_len=640, num_heads=32, head_dim=128)
    four = dc.PrefillChainSpec(seq=128, kv_len=2048, num_heads=32, head_dim=128)
    assert one.splits({"block_q": 128}) == 1 and four.splits({"block_q": 128}) == 4
    assert dc.PrefillChainSpec(seq=128, kv_len=2048, num_heads=32, head_dim=128,
                               dtype=torch.float32).splits({"block_q": 128}) == 1

    class Flat:
        @staticmethod
        def flops_time(flops, nbytes):
            return 0.0

    assert one.roofline_ms({"block_q": 128}, Flat()) == pytest.approx(dc._LAUNCH_S * 1e3)
    assert four.roofline_ms({"block_q": 128}, Flat()) == pytest.approx(2 * dc._LAUNCH_S * 1e3)


def _split_partials(q, k, v, splits):
    """The sm90 kernel's rule in plain f32: each split's partial O (divided
    by its own row sum) and lse (log2 units, -inf where the split holds no
    visible key of the row) over its run of 128-key tiles."""
    _, s, n, h = q.shape
    t = k.shape[1]
    tiles = -(-t // 128)
    per = -(-tiles // splits)
    logits = torch.einsum("bqnh,bknh->bnqk", q, k) / math.sqrt(h) * math.log2(math.e)
    allowed = torch.ones(s, t, dtype=torch.bool).tril(t - s)
    parts = []
    for sp in range(splits):
        keys = torch.zeros(t, dtype=torch.bool)
        keys[sp * per * 128:(sp + 1) * per * 128] = True
        x = logits.masked_fill(~(allowed & keys), -math.inf)
        lse = torch.logsumexp(x * math.log(2), dim=-1) / math.log(2)  # [1, N, S]
        p = torch.exp2(x - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
        parts.append((torch.einsum("bnqk,bknh->bqnh", p, v), lse))
    return parts


def _combine(parts):
    """prefill_combine: weight each partial by 2^(lse_i - max lse)."""
    lses = torch.stack([lse for _, lse in parts])            # [splits, 1, N, S]
    w = torch.exp2(lses - lses.max(dim=0).values)
    w = torch.where(torch.isinf(lses), 0.0, w)
    o = sum(wi.permute(0, 2, 1)[..., None] * oi for wi, (oi, _) in zip(w, parts))
    return o / w.sum(dim=0).permute(0, 2, 1)[..., None]


@pytest.mark.parametrize("s,t,splits", [(128, 640, 3), (128, 256, 2), (128, 200, 2),
                                          (64, 320, 3), (128, 1100, 2)])
def test_lse_weighted_combine_of_split_partials_equals_plain(s, t, splits):
    """The merge the kernel implements, in f32 on plain partials: equal to
    the plain masked attention, including splits that hold no visible key
    of some rows (T 200: rows 0-55 see nothing of the second tile)."""
    rng = np.random.default_rng(s + t)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((1, s, 4, 64), (1, t, 4, 64), (1, t, 4, 64)))
    parts = _split_partials(q, k, v, splits)
    if t == 200:
        assert torch.isinf(parts[1][1][..., :56]).all()
    torch.testing.assert_close(_combine(parts), dc.prefill_chain_plain(q, k, v),
                               atol=F32_TOL, rtol=F32_TOL)
