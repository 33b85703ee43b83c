"""The launch rules of ``csrc/norm_swiglu.cu`` and the folded residual
norm of the port's LLaMA, on the CPU.

``rms_geometry`` and ``swiglu_grid`` decide every launch of the RMSNorm and
SwiGLU kernels before it happens; the kernels compute their offsets from
them.  Here a numpy replay of the kernels' index arithmetic checks that
every element of every row is owned by exactly one lane, that the RMSNorm
rule spreads few rows over enough warps and blocks to reach every SM, and
that the rules take 16-byte accesses only where the row length, the
strides and the pointers allow them.

The LLaMA decoder layer computes its post-attention norm as
``fused_rms_norm(attn_out, w, residual=residual)``; the plain version rounds
the sum to the dtype before the norm, as the separate add did, so the
folded layer equals add-then-norm bit for bit (tolerance 0), forward and
gradients, in bf16 and f32.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.fused_norm import rms_geometry
from paddle_tpu_torch.ops.swiglu import swiglu_grid
from _torch_threads import _one_thread  # noqa: F401


SMS = 132

# (rows, hidden): the main paths' (decode, chained prefill chunk, prefill,
# training), a 4095 tail, BERT's and tiny widths, a streamed 64K row
RMS_CASES = [(4, 4096), (128, 4096), (640, 4096), (1024, 4096), (4096, 2048), (37, 4095),
             (1, 100), (0, 4096), (4096, 8192), (3, 65536), (2048, 768), (13, 256),
             (9000, 128)]


def _rms_lanes(g):
    """The chunk indices lane ``lr`` of a row owns, over its tiles:
    ``t * nv * lanes + j * lanes + lr`` (csrc/norm_swiglu.cu rms_norm_kernel)."""
    lanes = 32 * g["warps_per_row"]
    tiles = -(-g["chunks"] // (lanes * g["nv"])) if g["tiled"] else 1
    t, j, lr = np.meshgrid(np.arange(tiles), np.arange(g["nv"]), np.arange(lanes),
                           indexing="ij")
    return (t * lanes * g["nv"] + j * lanes + lr).ravel()


def _rms_rows(g, rows):
    """The rows the grid's blocks visit: block b, row-in-block k gives
    ``b * rpb + k`` while below ``rows``."""
    rpb = g["rows_per_block"]
    b, k = np.meshgrid(np.arange(g["grid"]), np.arange(rpb), indexing="ij")
    r = (b * rpb + k).ravel()
    return r[r < rows]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("rows,hidden", RMS_CASES)
def test_rms_geometry_covers_every_row_and_chunk_once(rows, hidden, elem_bytes):
    g = rms_geometry(rows, hidden, elem_bytes, SMS)
    assert g["elems"] == 16 // elem_bytes and g["chunks"] == -(-hidden // g["elems"])
    assert g["warps_per_row"] in (1, 2, 4, 8) and g["nv"] in (1, 2, 4)
    assert g["threads"] == 32 * g["warps_per_row"] * g["rows_per_block"] <= 256
    lanes = _rms_lanes(g)
    owned = np.sort(lanes[lanes < g["chunks"]])
    np.testing.assert_array_equal(owned, np.arange(g["chunks"]))  # each chunk once
    assert lanes.max() < g["chunks"] + 32 * g["warps_per_row"] * g["nv"]  # no idle tile
    assert g["tiled"] == (g["chunks"] > 32 * g["warps_per_row"] * g["nv"])
    assert not g["tiled"] or (g["nv"] == 4 and g["warps_per_row"] == 8)
    np.testing.assert_array_equal(np.sort(_rms_rows(g, rows)), np.arange(rows))
    assert g["grid"] == -(-rows // g["rows_per_block"])  # a block a row group, none idle


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("rows,hidden", RMS_CASES)
def test_rms_geometry_spreads_few_rows_over_the_sms(rows, hidden, elem_bytes, sms):
    """A row takes the fewest warps whose lanes hold it in 4 chunks each,
    widened (up to 8 warps) while the rows give fewer than 4 warps an SM
    and every lane keeps a chunk; rows share a block (up to 64 threads)
    only while that still leaves a block for every SM."""
    g = rms_geometry(rows, hidden, elem_bytes, sms)
    w, chunks, rpb = g["warps_per_row"], g["chunks"], g["rows_per_block"]
    fewest = next((k for k in (1, 2, 4, 8) if chunks <= 32 * k * 4), 8)
    assert w >= fewest
    if w > fewest:  # each widening was asked for by the rows and kept a chunk a lane
        assert rows * (w // 2) < 4 * sms and chunks >= 64 * (w // 2)
    assert w == 8 or rows * w >= 4 * sms or chunks < 64 * w
    assert rpb == 1 or (rpb * 32 * w <= 64 and g["grid"] >= sms)
    if rows <= sms:  # a chained prefill chunk or a decode step: a block a row
        assert rpb == 1 and g["grid"] == rows


def test_rms_geometry_at_the_main_path_shapes():
    """Prefill's 640 rows (and 1,024): one 4-warp block a row, 4 chunks a
    lane; a 128-row chunk on 128 SMs, 8 warps a row of 2 chunks a lane
    (1,024 warps); decode's 4 rows each over 8 warps; training's 4,096
    rows of 2,048 in 64-thread blocks, a block a row."""
    for rows in (640, 1024):
        g = rms_geometry(rows, 4096, 2, SMS)
        assert g["grid"] == rows and not g["tiled"], g
        assert (g["nv"], g["warps_per_row"], g["threads"]) == (4, 4, 128), g
    g = rms_geometry(128, 4096, 2, SMS)
    assert g["grid"] == 128 and g["warps_per_row"] == 8 and g["nv"] == 2, g
    g = rms_geometry(4, 4096, 2, SMS)
    assert g["grid"] == 4 and g["warps_per_row"] == 8, g
    g = rms_geometry(4096, 2048, 2, SMS)
    assert (g["threads"], g["nv"], g["grid"]) == (64, 4, 4096), g


@pytest.mark.parametrize("hidden,elem_bytes,ptrs,want", [
    (4096, 2, (0, 8192, 1 << 20), True),
    (4095, 2, (0, 8192, 1 << 20), False),   # rows of 8,190 bytes: not 16-byte multiples
    (100, 2, (0, 256), False),              # 200 bytes a row
    (100, 4, (0, 256), True),               # 400 bytes a row
    (4096, 2, (0, 8), False),               # an unaligned pointer
    (4096, 4, (16, 32), True),
])
def test_rms_geometry_vector_width_only_where_rows_allow(hidden, elem_bytes, ptrs, want):
    assert rms_geometry(7, hidden, elem_bytes, SMS, ptrs=ptrs)["vec"] is want


SWIGLU_CASES = [(4, 11008), (128, 11008), (640, 11008), (1024, 11008), (4096, 5632),
                (15, 688), (3, 689), (1, 1), (200000, 8), (70000, 24)]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("rows,cols", SWIGLU_CASES)
def test_swiglu_grid_covers_every_element_once(rows, cols, elem_bytes):
    g = swiglu_grid(rows, cols, elem_bytes)
    gx, gy = g["grid"]
    assert g["threads"] in (64, 128) and 1 <= gy <= 65535
    # a thread owns chunk column bx * threads + tx while its first element is in the row
    cols_owned = np.arange(gx * g["threads"])
    cols_owned = cols_owned[cols_owned * g["elems"] < cols]
    np.testing.assert_array_equal(cols_owned, np.arange(g["chunks"]))
    assert gx == -(-g["chunks"] // g["threads"])
    # rows by + k * gy (grid stride past 65,535)
    r = (np.arange(0, rows, gy)[:, None] + np.arange(gy)[None, :]).ravel()
    np.testing.assert_array_equal(np.sort(r[r < rows]), np.arange(rows))


def test_swiglu_grid_at_the_main_path_shapes():
    """11,008 columns (1,376 chunks): 128-thread blocks, 11 a row; 5,632
    columns (704 chunks): 64-thread blocks, which leave no lane idle at
    the row's end; one row a thread."""
    for rows in (4, 128, 640, 1024):
        assert swiglu_grid(rows, 11008, 2)["grid"] == (11, rows)
        assert swiglu_grid(rows, 11008, 2)["threads"] == 128
    g = swiglu_grid(4096, 5632, 2)
    assert g["threads"] == 64 and g["grid"] == (11, 4096), g


@pytest.mark.parametrize("rows,cols,elem_bytes,strides,ptrs,want", [
    (640, 11008, 2, (22016, 22016), (0, 22016, 512), True),   # the gate/up halves
    (640, 11008, 2, (11008, 11008), (0, 4096, 512), True),    # two tensors
    (4, 689, 2, (1378, 1378), (0, 1378, 512), False),         # an odd width
    (4, 688, 2, (692, 688), (0, 1376, 512), False),           # a stride of 1,384 bytes
    (4, 688, 2, (688, 688), (0, 8, 512), False),              # an unaligned pointer
    (1, 688, 2, (), (0, 1376, 512), True),                    # one row: no stride to check
    (4, 12, 4, (24, 24), (0, 48, 512), True),                 # f32: 4 to a chunk
    (4, 10, 4, (20, 20), (0, 40, 512), False),
])
def test_swiglu_grid_vector_width_only_where_rows_allow(rows, cols, elem_bytes, strides, ptrs,
                                                        want):
    assert swiglu_grid(rows, cols, elem_bytes, strides, ptrs)["vec"] is want


def test_yardsticks_count_apart_and_reset():
    """The Triton yardsticks count under yardstick_counts(), never under
    launch_counts(); the CPU paths tick neither; reset clears both."""
    ops.reset_launch_counts()
    x = torch.randn(4, 64)
    ops.fused_rms_norm(x, torch.ones(64), residual=x)
    ops.swiglu(x, x)
    assert ops.yardstick_counts() == {"fused_rms_norm_triton": 0, "swiglu_triton": 0}
    assert not any(ops.launch_counts().values())
    ops.count_yardstick("swiglu_triton")
    assert ops.yardstick_counts()["swiglu_triton"] == 1 and not any(ops.launch_counts().values())
    ops.reset_launch_counts()
    assert ops.yardstick_counts() == {"fused_rms_norm_triton": 0, "swiglu_triton": 0}


# ------------------------------------------------------- the residual fold

def _layer(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    cfg = tllama.llama_tiny(num_hidden_layers=1, dtype=dtype)
    layer = tllama.LlamaDecoderLayer(cfg, device="cpu", generator=g)
    with torch.no_grad():  # norm weights away from 1, so the weight's gradient is tested
        for norm in (layer.input_layernorm, layer.post_attention_layernorm):
            norm.weight.copy_(1 + 0.1 * torch.randn(norm.weight.shape, generator=g))
    model = tllama.LlamaModel(cfg, device="cpu", generator=g)
    return layer, model.rope_cos, model.rope_sin


def _add_then_norm(layer, hidden, cos, sin):
    """The decoder layer as it was before the fold: a separate add, then
    the post-attention norm."""
    residual = hidden
    h = layer.self_attn(layer.input_layernorm(hidden), cos, sin, None)
    h = residual + h
    return h + layer.mlp(layer.post_attention_layernorm(h))


def _run(fn, layer, hidden, cot):
    layer.zero_grad()
    x = hidden.clone().requires_grad_()
    out = fn(x)
    (out.float() * cot).sum().backward()
    grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
    return out.detach(), x.grad, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_decoder_layer_equals_add_then_norm_bit_for_bit(dtype):
    layer, cos, sin = _layer(dtype)
    g = torch.Generator().manual_seed(1)
    hidden = torch.randn(2, 12, 256, generator=g).to(layer.input_layernorm.weight.dtype)
    cot = torch.randn(2, 12, 256, generator=g)
    got = _run(lambda x: layer(x, cos, sin), layer, hidden, cot)
    want = _run(lambda x: _add_then_norm(layer, x, cos, sin), layer, hidden, cot)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2].keys() == want[2].keys()
    for name in got[2]:
        assert torch.equal(got[2][name], want[2][name]), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_paged_decode_layer_equals_add_then_norm_bit_for_bit(dtype):
    layer, cos, sin = _layer(dtype, seed=3)
    tdt = layer.input_layernorm.weight.dtype
    attn = layer.self_attn
    nkv, hd, bs = attn.num_kv_heads, attn.head_dim, 4
    g = torch.Generator().manual_seed(4)
    kc = torch.randn(6, nkv, bs, hd, generator=g).to(tdt)
    vc = torch.randn(6, nkv, bs, hd, generator=g).to(tdt)
    tables = torch.tensor([[1, 4], [3, 0]], dtype=torch.int32)
    lens = torch.tensor([6, 3], dtype=torch.int32)
    h = torch.randn(2, 1, 256, generator=g).to(tdt)

    def add_then_norm(h, kc, vc):
        x = layer.input_layernorm(h)
        n = attn.num_heads
        q = tpa.rope_rotate_by_position(attn.q_proj(x).reshape(2, n, hd), cos, sin, lens - 1)
        k = tpa.rope_rotate_by_position(attn.k_proj(x).reshape(2, nkv, hd), cos, sin, lens - 1)
        kc = tpa.paged_write(kc, k, tables, lens - 1)
        vc = tpa.paged_write(vc, attn.v_proj(x).reshape(2, nkv, hd), tables, lens - 1)
        o = tpa.paged_decode_attention(q, kc, vc, tables, lens)
        h = h + attn.o_proj(o.reshape(2, 1, n * hd))
        return h + layer.mlp(layer.post_attention_layernorm(h)), kc, vc

    with torch.no_grad():
        got = tllama._decode_layer_paged(layer, h, cos, sin, kc.clone(), vc.clone(), tables,
                                         lens)
        want = add_then_norm(h, kc.clone(), vc.clone())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_folded_layer_records_one_norm_for_the_add():
    """The folded layer records the post-attention add and norm as one
    fused_rms_norm with its residual (one launch on the card), and one
    add fewer than add-then-norm; its input norm stays as it was."""
    import collections

    from paddle_tpu_torch import static as tstatic

    layer, cos, sin = _layer("float32")
    counts = []
    for fn in (lambda x: layer(x, cos, sin), lambda x: _add_then_norm(layer, x, cos, sin)):
        prog = tstatic.Program()
        with tstatic.program_guard(prog):
            fn(tstatic.data("h", [2, 12, 256], "float32"))
        ops_ = prog.global_block().ops
        counts.append(collections.Counter(op.type for op in ops_))
        counts[-1]["with_residual"] = sum(len(op.arg_spec) == 3 for op in ops_
                                          if op.type == "fused_rms_norm")
    folded, unfolded = counts
    assert folded["fused_rms_norm"] == unfolded["fused_rms_norm"] == 2
    assert folded["with_residual"] == 1 and unfolded["with_residual"] == 0
    assert folded["add"] == unfolded["add"] - 1
