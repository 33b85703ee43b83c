"""Pattern rewriting over captured Programs (counterpart of
paddle_tpu/static/rewrite.py's pattern rewriter and ``PallasFusionPass``).

The JAX package substitutes hand-written Pallas kernels for subgraphs XLA
cannot re-derive; here the same five patterns substitute the port's
hand-written kernels for the H100 (``ops``): flash attention, RMSNorm,
SwiGLU, the matmul epilogue (bias + activation on the accumulator) and the
residual add fused into LayerNorm/RMSNorm.  The matching rules are the JAX
package's: single use of every interior value, no fused interior fetch
(a rewrite that breaks def-before-use or the fetch frontier is rolled
back), ``transpose_y`` blocks the epilogue, silu feeding a multiply
stands down for SwiGLU, weight-only-quantized (``wq::``) linears are
skipped, the epsilon must be recoverable, and AddNorm replaces the add at
its own position.  Replaced final ops keep their output vids, so
consumers and fetches are untouched.

The codegen passes (the JAX package's CINN roles) follow:
``GenericElementwiseFusionPass`` (maximal same-shape elementwise chains
of at least three ops, one generated kernel each, op type
``vpu_chain_{n}``; not gated, as in JAX) and ``ScheduleSearchPass``
(discovered reduction-/matmul-rooted subgraphs, searched and gated by
``static/schedule_search.py``, op type ``sched_chain_{n}``).  Their kernels
are generated CUDA C++ (``static/codegen.py``).

Not ported: the fp16 program rewrite's ``fp16::`` low-precision variants
(the rewrite itself belongs to ROADMAP A.6).
"""

from __future__ import annotations

import ctypes
from collections import defaultdict

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .program import Operator, replay

__all__ = [
    "ProgramGraph",
    "RewritePattern",
    "PatternRewritePass",
    "PallasFusionPass",
    "FlashAttentionPattern",
    "RMSNormPattern",
    "SwiGLUPattern",
    "MatmulEpiloguePattern",
    "AddNormPattern",
    "GenericElementwiseFusionPass",
    "ScheduleSearchPattern",
    "ScheduleSearchPass",
]


def _base_type(type_: str) -> str:
    """Strip pass-inserted namespaces ("wq::matmul" -> "matmul")."""
    return type_.rsplit("::", 1)[-1]


def _as_array(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def _const_scalar(spec):
    """('const', v) -> python float if v is a scalar, else None."""
    if spec[0] != "const":
        return None
    try:
        arr = _as_array(spec[1])
    except (TypeError, ValueError):
        return None
    if arr.size == 1 and arr.dtype.kind in "biuf":
        return float(arr.reshape(()))
    return None


def _is_causal_mask_const(spec, S):
    """('const', v) holding an additive causal mask over an [.., S, S]
    score matrix: 0 on/below the diagonal, <= -1e9 (or -inf) above.
    Leading broadcast dims of size 1 are allowed."""
    if spec[0] != "const":
        return False
    try:
        arr = _as_array(spec[1]).astype(np.float32)
    except (TypeError, ValueError):
        return False
    if arr.ndim < 2 or arr.shape[-1] != S or arr.shape[-2] != S:
        return False
    if any(d != 1 for d in arr.shape[:-2]):
        return False
    m = arr.reshape(S, S)
    lower = np.tril(np.ones((S, S), bool))
    if not np.all(m[lower] == 0):
        return False
    upper = m[~lower]
    return bool(np.all(np.isneginf(upper) | (upper <= -1e9)))


class ProgramGraph:
    """Def-use view of a Program's global block."""

    def __init__(self, program, fetch_vids=()):
        self.program = program
        self.block = program.global_block()
        self.producer = {}
        self.consumers = defaultdict(list)
        for op in self.block.ops:
            for vid in op.out_vids:
                self.producer[vid] = op
            for vid in op.input_vids():
                self.consumers[vid].append(op)
        # vids visible outside the op list: fetches and state writes
        self.external = set(fetch_vids)
        self.external.update(program.writes.keys())
        self.external.update(program.writes.values())

    def single_use(self, vid) -> bool:
        return len(self.consumers[vid]) == 1 and vid not in self.external

    def shape(self, vid):
        var = self.program._var_by_vid.get(vid)
        return tuple(var.shape) if var is not None else None

    def dtype(self, vid):
        var = self.program._var_by_vid.get(vid)
        return var.dtype if var is not None else None

    def def_op(self, vid, type_=None):
        op = self.producer.get(vid)
        if op is None:
            return None
        if type_ is not None and _base_type(op.type) != type_:
            return None
        return op

    def replace_op(self, old_op, new_op):
        """Swap old_op for new_op at the same position (same out vids)."""
        idx = self.block.ops.index(old_op)
        self.block.ops[idx] = new_op
        self.program.version += 1


def _structure_ok(program, fetch_vids) -> bool:
    """The verifier's structural tier and its live-producer check
    (``static/verify.py``), uncounted: every input, write source and
    fetch defined before it is read, and one live producer of each vid."""
    from .verify import ProgramVerifier

    v = ProgramVerifier(check_registry=False, check_kwargs=False, abstract_eval=False)
    return not (v._check_structure(program, fetch_vids)
                or v._check_live_producers(program, fetch_vids))


class RewritePattern:
    """One source->result rule anchored at a root op type."""

    name = "base"
    root_type = None

    def match_and_rewrite(self, op, graph: ProgramGraph) -> bool:
        raise NotImplementedError


class PatternRewritePass:
    """Greedy rewriter: apply patterns to a fixpoint (bounded).  A rewrite
    that leaves the program structurally invalid for the fetch frontier
    is rolled back and counted in ``refused``.  Under
    ``FLAGS_verify_programs`` the whole pass runs between two full
    verifications."""

    name = "pattern_rewrite"

    def __init__(self, patterns, fetch_vids=(), max_iterations=8):
        self._patterns = list(patterns)
        self._fetch_vids = tuple(fetch_vids)
        self._max_iterations = max_iterations
        self.refused = 0

    def apply(self, program) -> int:
        from paddle_tpu_torch._core import flags

        from .verify import _COUNTERS, verify_program

        verify = flags.flag("FLAGS_verify_programs")
        if verify:
            verify_program(program, self._fetch_vids)
        total = 0
        refused_sites: set = set()
        for _ in range(self._max_iterations):
            graph = ProgramGraph(program, self._fetch_vids)
            changed = 0
            for op in list(graph.block.ops):
                for pat in self._patterns:
                    if pat.root_type is not None and _base_type(op.type) != pat.root_type:
                        continue
                    if op not in graph.block.ops:  # Operators compare by identity
                        break  # already replaced this round
                    if (id(pat), id(op)) in refused_sites:
                        continue
                    ops_before = list(graph.block.ops)
                    version_before = program.version
                    if pat.match_and_rewrite(op, graph):
                        if not _structure_ok(program, self._fetch_vids):
                            graph.block.ops[:] = ops_before
                            program.version = version_before
                            refused_sites.add((id(pat), id(op)))
                            self.refused += 1
                            _COUNTERS["rewrites_refused"] += 1
                            graph = ProgramGraph(program, self._fetch_vids)
                            continue
                        changed += 1
                        graph = ProgramGraph(program, self._fetch_vids)
                        break
            total += changed
            if not changed:
                break
            refused_sites.clear()
        if verify:
            verify_program(program, self._fetch_vids)
        return total


def _make_op(type_, fn, var_vids, template_op, kwargs=None):
    """New Operator producing template_op's outputs from var inputs.
    kwargs are metadata for later passes (the fn has them bound)."""
    return Operator(type=type_, fn=fn, arg_spec=[("var", vid) for vid in var_vids],
                    kwargs=dict(kwargs or {}), out_vids=list(template_op.out_vids),
                    out_tree=template_op.out_tree)


def _var_args(op):
    return len(op.arg_spec) > 0 and all(s[0] == "var" for s in op.arg_spec)


class FlashAttentionPattern(RewritePattern):
    """matmul(q, kᵀ) [→ scale] [→ + causal mask] → softmax → matmul(·, v)
    ⇒ ``ops.flash_attention`` (online softmax, O(S) memory).

    Anchored at the second matmul.  4-D [B, N, S, D] layouts only; an
    additive const mask fuses only when it is the causal triangle; unique
    consumers for every interior value; S != D so the kᵀ layout is
    unambiguous."""

    name = "flash_attention_fuse"
    root_type = "matmul"

    def match_and_rewrite(self, op, graph):
        if len(op.arg_spec) != 2 or not _var_args(op):
            return False
        if op.kwargs.get("transpose_x") or op.kwargs.get("transpose_y"):
            return False
        probs_vid, v_vid = op.arg_spec[0][1], op.arg_spec[1][1]
        out_shape = graph.shape(op.out_vids[0]) if op.out_vids else None
        v_shape, p_shape = graph.shape(v_vid), graph.shape(probs_vid)
        if not (out_shape and v_shape and p_shape):
            return False
        if len(out_shape) != 4 or len(v_shape) != 4 or len(p_shape) != 4:
            return False
        B, N, S, D = out_shape
        if p_shape != (B, N, S, S) or v_shape != (B, N, S, D) or S == D:
            return False

        sm = graph.def_op(probs_vid, "softmax")
        if sm is None or not graph.single_use(probs_vid):
            return False
        if len(sm.arg_spec) != 1 or sm.arg_spec[0][0] != "var":
            return False
        if sm.kwargs.get("axis", -1) not in (-1, 3):
            return False

        scale, causal = None, False
        cur_vid = sm.arg_spec[0][1]
        if not graph.single_use(cur_vid):
            return False
        cur = graph.def_op(cur_vid)
        for _ in range(2):  # at most one scale + one mask-add, any order
            if cur is None:
                return False
            var_ins = [s for s in cur.arg_spec if s[0] == "var"]
            consts = [s for s in cur.arg_spec if s[0] == "const"]
            base = _base_type(cur.type)
            if (base in ("divide", "multiply") and len(var_ins) == 1 and len(consts) == 1
                    and _const_scalar(consts[0]) is not None and scale is None):
                c = _const_scalar(consts[0])
                scale = (1.0 / c) if base == "divide" else c
            elif (base == "add" and len(var_ins) == 1 and len(consts) == 1 and not causal
                  and _is_causal_mask_const(consts[0], S)):
                causal = True
            else:
                break
            cur_vid = var_ins[0][1]
            if not graph.single_use(cur_vid):
                return False
            cur = graph.def_op(cur_vid)
        qk = cur
        if qk is None or _base_type(qk.type) != "matmul":
            return False
        if len(qk.arg_spec) != 2 or not _var_args(qk) or qk.kwargs.get("transpose_x"):
            return False
        q_vid, k_vid = qk.arg_spec[0][1], qk.arg_spec[1][1]
        if graph.shape(q_vid) != (B, N, S, D):
            return False
        k_shape = graph.shape(k_vid)
        if k_shape == (B, N, S, D):
            k_transposed = True  # matmul(q, k, transpose_y=True)
        elif k_shape == (B, N, D, S):
            k_transposed = False
        else:
            return False
        if bool(qk.kwargs.get("transpose_y")) != k_transposed:
            return False
        scale = 1.0 if scale is None else scale

        def fused(q, k, v, causal=causal, scale=scale, k_transposed=k_transposed):
            from paddle_tpu_torch import ops

            if not k_transposed:
                k = k.transpose(-1, -2)
            # [B, N, S, D] -> the kernel's [B, S, N, D], as strided views
            o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    causal=causal, scale=scale)
            return o.transpose(1, 2)

        graph.replace_op(op, _make_op("flash_attention", fused, [q_vid, k_vid, v_vid], op))
        return True


class RMSNormPattern(RewritePattern):
    """x·rsqrt(mean(x²)+ε)·w ⇒ ``ops.fused_rms_norm``.  Anchored at the
    final weight multiply; accepts square(x), multiply(x, x) or pow(x, 2)."""

    name = "rms_norm_fuse"
    root_type = "multiply"

    def _match_square_mean(self, vid, graph, x_vid):
        mean = graph.def_op(vid, "mean")
        if mean is None or not graph.single_use(vid):
            return False
        if len(mean.arg_spec) != 1 or mean.arg_spec[0][0] != "var":
            return False
        sq_vid = mean.arg_spec[0][1]
        if not graph.single_use(sq_vid):
            return False
        sq = graph.def_op(sq_vid)
        if sq is None:
            return False
        base = _base_type(sq.type)
        if base == "square":
            return sq.arg_spec[0] == ("var", x_vid)
        vids = [s[1] for s in sq.arg_spec if s[0] == "var"]
        if base == "multiply":
            return vids == [x_vid, x_vid]
        if base == "pow":
            c = next((_const_scalar(s) for s in sq.arg_spec if s[0] == "const"), None)
            return vids == [x_vid] and c == 2.0
        return False

    def match_and_rewrite(self, op, graph):
        if len(op.arg_spec) != 2 or not _var_args(op):
            return False
        normed_vid, w_vid = op.arg_spec[0][1], op.arg_spec[1][1]
        w_shape = graph.shape(w_vid)
        out_shape = graph.shape(op.out_vids[0]) if op.out_vids else None
        if not w_shape or not out_shape or len(w_shape) != 1 or w_shape[0] != out_shape[-1]:
            return False
        if not graph.single_use(normed_vid):
            return False
        mul = graph.def_op(normed_vid, "multiply")
        if mul is None or len(mul.arg_spec) != 2 or not _var_args(mul):
            return False
        x_vid, r_vid = mul.arg_spec[0][1], mul.arg_spec[1][1]
        if graph.shape(x_vid) != out_shape:
            x_vid, r_vid = r_vid, x_vid
        if graph.shape(x_vid) != out_shape or not graph.single_use(r_vid):
            return False
        rs = graph.def_op(r_vid, "rsqrt")
        if rs is None or len(rs.arg_spec) != 1 or rs.arg_spec[0][0] != "var":
            return False
        add_vid = rs.arg_spec[0][1]
        if not graph.single_use(add_vid):
            return False
        add = graph.def_op(add_vid, "add")
        if add is None:
            return False
        eps = next((_const_scalar(s) for s in add.arg_spec if s[0] == "const"), None)
        var_ins = [s[1] for s in add.arg_spec if s[0] == "var"]
        if eps is None or len(var_ins) != 1:
            return False
        if not self._match_square_mean(var_ins[0], graph, x_vid):
            return False
        # the mean reduces the last axis with keepdim
        if graph.shape(var_ins[0]) != out_shape[:-1] + (1,):
            return False

        def fused(x, w, eps=eps):
            from paddle_tpu_torch import ops

            return ops.fused_rms_norm(x, w, epsilon=eps)

        graph.replace_op(op, _make_op("fused_rms_norm", fused, [x_vid, w_vid], op,
                                      kwargs={"epsilon": eps}))
        return True


class SwiGLUPattern(RewritePattern):
    """silu(g)·u ⇒ ``ops.swiglu``."""

    name = "swiglu_fuse"
    root_type = "multiply"

    def match_and_rewrite(self, op, graph):
        if len(op.arg_spec) != 2 or not _var_args(op):
            return False
        a_vid, b_vid = op.arg_spec[0][1], op.arg_spec[1][1]
        for gate_vid, up_vid in ((a_vid, b_vid), (b_vid, a_vid)):
            silu = graph.def_op(gate_vid, "silu")
            if silu is None or not graph.single_use(gate_vid):
                continue
            if len(silu.arg_spec) != 1 or silu.arg_spec[0][0] != "var":
                continue
            g_vid = silu.arg_spec[0][1]
            if graph.shape(g_vid) != graph.shape(up_vid):
                continue

            def fused(g, u):
                from paddle_tpu_torch import ops

                return ops.swiglu(g, u)

            graph.replace_op(op, _make_op("swiglu", fused, [g_vid, up_vid], op))
            return True
        return False


def _entry_shape(graph, entry):
    if entry[0] == "var":
        return graph.shape(entry[1])
    v = entry[1]
    return tuple(v.shape) if isinstance(v, torch.Tensor) else tuple(np.shape(v))


def _entry_dtype(graph, entry):
    if entry[0] == "var":
        return graph.dtype(entry[1])
    v = entry[1]
    return v.dtype if isinstance(v, torch.Tensor) else None


def _mixed(entries):
    """(var_vids, rebuild): rebuild(var_vals) -> the full positional values
    with const entries (weights captured as concrete tensors) bound in."""
    var_vids = [e[1] for e in entries if e[0] == "var"]

    def rebuild(var_vals):
        it = iter(var_vals)
        return [next(it) if e[0] == "var" else e[1] for e in entries]

    return var_vids, rebuild


class MatmulEpiloguePattern(RewritePattern):
    """act(linear(x, w[, b])) ⇒ ``ops.matmul_bias_act`` (the epilogue runs
    on the f32 accumulator; the pre-activation never goes to memory).

    Anchored at the activation (gelu/silu/relu) whose single input is the
    single-use output of a linear/matmul op."""

    name = "matmul_epilogue_fuse"
    root_type = None  # three root types; filtered in match
    _ROOTS = {"gelu", "silu", "relu"}

    def match_and_rewrite(self, op, graph):
        base = _base_type(op.type)
        if base not in self._ROOTS:
            return False
        if len(op.arg_spec) != 1 or op.arg_spec[0][0] != "var":
            return False
        if base == "silu" and op.out_vids:
            # silu feeding a multiply is SwiGLUPattern's subgraph: stand down
            cons = graph.consumers.get(op.out_vids[0], [])
            if any(_base_type(c.type) == "multiply" for c in cons):
                return False
        pre_vid = op.arg_spec[0][1]
        if not graph.single_use(pre_vid):
            return False
        mm = graph.def_op(pre_vid)
        if mm is None or _base_type(mm.type) not in ("linear", "matmul"):
            return False
        if mm.type.startswith("wq::"):
            # weight-only-quantized op: int8 weight + scale appended; fusing
            # would add the scale as a bias
            return False
        if mm.kwargs.get("transpose_x") or mm.kwargs.get("transpose_y"):
            # x @ w.T has no kernel contract, and a square weight would
            # pass the shape check below
            return False
        if len(mm.arg_spec) not in (2, 3):
            return False
        x_entry, w_entry = mm.arg_spec[0], mm.arg_spec[1]
        b_entry = mm.arg_spec[2] if len(mm.arg_spec) == 3 else None
        if x_entry[0] != "var":
            return False
        w_shape, x_shape = _entry_shape(graph, w_entry), graph.shape(x_entry[1])
        if not w_shape or not x_shape or len(w_shape) != 2 or x_shape[-1] != w_shape[0]:
            return False
        # the weight must be a float tensor (an int8 weight means a
        # dequantizing contract this kernel lacks)
        w_dtype = _entry_dtype(graph, w_entry)
        if w_dtype is None or not w_dtype.is_floating_point:
            return False
        if b_entry is not None and _entry_shape(graph, b_entry) != (w_shape[1],):
            return False
        act = base
        if base == "gelu" and op.kwargs.get("approximate"):
            act = "gelu_tanh"

        entries = [x_entry, w_entry] + ([b_entry] if b_entry is not None else [])
        var_vids, rebuild = _mixed(entries)
        has_bias = b_entry is not None

        def fused(*var_vals, act=act, has_bias=has_bias, rebuild=rebuild):
            from paddle_tpu_torch import ops

            full = rebuild(var_vals)
            return ops.matmul_bias_act(full[0], full[1], full[2] if has_bias else None, act)

        graph.replace_op(op, _make_op("matmul_epilogue", fused, var_vids, op,
                                      kwargs={"activation": act}))
        return True


class AddNormPattern(RewritePattern):
    """norm(x + residual) ⇒ the fused residual-add norm (``residual=`` of
    ``ops.fused_layer_norm`` / ``ops.fused_rms_norm``).

    Anchors on fused_rms_norm (made by RMSNormPattern in the same pass),
    rms_norm or layer_norm whose input comes from an add of two same-shape
    tensors.  The fused op emits both the sum and the normed output and
    replaces the ADD at its own position, so every consumer of the sum
    still reads a defined value."""

    name = "add_norm_fuse"
    root_type = None
    _ROOTS = {"fused_rms_norm", "rms_norm", "layer_norm"}

    def match_and_rewrite(self, op, graph):
        base = _base_type(op.type)
        if base not in self._ROOTS or not op.arg_spec or op.arg_spec[0][0] != "var":
            return False
        if base == "layer_norm":
            if len(op.arg_spec) != 3 or op.kwargs.get("nd", 1) != 1:  # x, weight, bias
                return False  # over the last axis, with weight and bias
            w_entry, b_entry = op.arg_spec[1], op.arg_spec[2]
        else:
            if len(op.arg_spec) != 2:  # x, weight
                return False
            w_entry, b_entry = op.arg_spec[1], None
        x_vid = op.arg_spec[0][1]
        add = graph.def_op(x_vid, "add")
        if add is None or len(add.arg_spec) != 2 or not _var_args(add):
            return False
        a_vid, r_vid = add.arg_spec[0][1], add.arg_spec[1][1]
        if graph.shape(a_vid) != graph.shape(r_vid):
            return False
        eps = op.kwargs.get("epsilon", op.kwargs.get("eps"))
        if eps is None:
            return False  # the recorded epsilon cannot be recovered: no fusion

        # the fused op replaces the ADD at its position: every other var
        # input (norm weight/bias) must already be defined there
        block = graph.block
        add_idx = block.ops.index(add)

        def defined_before(entry):
            if entry is None or entry[0] != "var":
                return True
            prod = graph.producer.get(entry[1])
            return prod is None or block.ops.index(prod) < add_idx

        if not (defined_before(w_entry) and defined_before(b_entry)):
            return False

        entries = [("var", a_vid), ("var", r_vid), w_entry] + (
            [b_entry] if b_entry is not None else [])
        var_vids, rebuild = _mixed(entries)
        is_ln = base == "layer_norm"

        def fused(*var_vals, eps=eps, is_ln=is_ln, rebuild=rebuild):
            from paddle_tpu_torch import ops

            full = rebuild(var_vals)
            if is_ln:
                out, s = ops.fused_layer_norm(full[0], full[2], full[3], residual=full[1],
                                              epsilon=eps)
            else:
                out, s = ops.fused_rms_norm(full[0], full[2], residual=full[1], epsilon=eps)
            return s, out

        new_op = Operator("add_" + ("layer_norm" if is_ln else "rms_norm"), fused,
                          [("var", v) for v in var_vids], {"epsilon": eps},
                          [add.out_vids[0], op.out_vids[0]], pytree.tree_structure((0, 0)))
        block.ops[add_idx] = new_op
        block.ops.remove(op)
        graph.program.version += 1
        return True


class PallasFusionPass(PatternRewritePass):
    """The default substitution pipeline: the five patterns onto the
    port's kernels (the JAX package's name, kept so flags and passes read
    the same)."""

    name = "pallas_fusion"

    def __init__(self, fetch_vids=()):
        super().__init__([FlashAttentionPattern(), RMSNormPattern(), SwiGLUPattern(),
                          MatmulEpiloguePattern(), AddNormPattern()], fetch_vids=fetch_vids)


# ---------------------------------------------------------------------------
# generic elementwise-chain fusion (the CINN auto-discovery role)

# the JAX package's whitelist; amp_cast, fake_quant and scale are JAX op
# types the port's capture never records
_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "pow",
    "exp", "log", "tanh", "sigmoid", "relu", "gelu", "silu", "abs", "neg",
    "sqrt", "rsqrt", "square", "floor", "ceil", "round", "clip", "cast",
    "scale", "leaky_relu", "elu", "hardtanh", "softplus", "mish",
    "hardswish", "hardsigmoid", "erf", "sin", "cos", "amp_cast",
    "fake_quant",
}


class GenericElementwiseFusionPass:
    """Discover maximal chains of same-shape elementwise ops and generate
    ONE kernel per chain (``csrc/codegen/vpu_chain.cuh``), so an N-op
    chain makes one pass over the data instead of N.

    The JAX package's rules: a chain is a tree of single-use whitelisted
    producers, every participating var has the output's shape, the root is
    the downstream end (its output feeds no further fusible op alone), at
    least ``min_chain`` ops, op type ``vpu_chain_{n}``.  One more rule: an
    op the translator cannot read exactly (``codegen.check_op``) is not
    eligible."""

    name = "generic_elementwise_fusion"

    def __init__(self, fetch_vids=(), min_chain=3):
        self._fetch_vids = tuple(fetch_vids)
        self._min_chain = int(min_chain)

    def _eligible(self, op, graph, shape):
        from . import codegen

        if _base_type(op.type) not in _ELEMENTWISE:
            return False
        if not op.out_vids or len(op.out_vids) != 1:
            return False
        if graph.shape(op.out_vids[0]) != shape:
            return False
        for s in op.arg_spec:
            if s[0] == "var" and graph.shape(s[1]) != shape:
                return False
        return codegen.check_op(op, graph, shape[-1])

    def _collect_chain(self, root, graph):
        """The fusible upstream tree of ``root``, in execution order."""
        shape = graph.shape(root.out_vids[0])
        chain = {id(root): root}
        frontier = [root]
        while frontier:
            op = frontier.pop()
            for s in op.arg_spec:
                if s[0] != "var":
                    continue
                prod = graph.def_op(s[1])
                if (prod is None or id(prod) in chain or not graph.single_use(s[1])
                        or not self._eligible(prod, graph, shape)):
                    continue
                chain[id(prod)] = prod
                frontier.append(prod)
        return [op for op in graph.block.ops if id(op) in chain]

    def apply(self, program) -> int:
        n = 0
        while True:
            graph = ProgramGraph(program, self._fetch_vids)
            block = graph.block
            done = False
            for root in reversed(list(block.ops)):
                shape = graph.shape(root.out_vids[0]) if root.out_vids else None
                if shape is None or len(shape) < 1:
                    continue
                if not self._eligible(root, graph, shape):
                    continue
                # the root is the downstream end: its output does not feed
                # one further fusible op alone
                out_vid = root.out_vids[0]
                cons = graph.consumers.get(out_vid, [])
                if (len(cons) == 1 and graph.single_use(out_vid)
                        and self._eligible(cons[0], graph, shape)):
                    continue
                ordered = self._collect_chain(root, graph)
                if len(ordered) < self._min_chain:
                    continue
                in_chain = {vid for op in ordered for vid in op.out_vids}
                ext_vids = []
                for op in ordered:
                    for s in op.arg_spec:
                        if s[0] == "var" and s[1] not in in_chain and s[1] not in ext_vids:
                            ext_vids.append(s[1])
                fused = ElementwiseChainKernel(ordered, ext_vids, out_vid, graph)
                block.ops[block.ops.index(root)] = _make_op(
                    f"vpu_chain_{len(ordered)}", fused, ext_vids, root)
                for op in ordered:
                    if op is not root and op in block.ops:
                        block.ops.remove(op)
                program.version += 1
                n += 1
                done = True
                break
            if not done:
                return n


# (threads a block, elements a run), the default of each dtype class first:
# what chip_smoke.py holds and times
VPU_LAUNCHES = ((128, 8), (128, 4), (256, 8), (256, 4), (512, 8), (512, 4))


class ElementwiseChainKernel:
    """The generated kernel of one elementwise chain (queue B #11), called
    on the chain's external inputs: on CUDA tensors one launch of
    ``csrc/codegen/vpu_chain.cuh``'s persistent kernel with the chain in
    registers (the library is compiled at the first launch); on CPU
    tensors the replay of the recorded ops, its plain version.

    The launch config (threads a block, elements a run) comes from the
    autotune cache's ``vpu_chain`` entry for (rows, cols, n_ops, dtype), as
    the JAX pass reads its block shape, else ``default_launch``.  The grid is the SM count times the blocks an
    SM holds (the occupancy API), or fewer when the runs are fewer; the
    argument block is built once for each set of data pointers."""

    def __init__(self, ordered, ext_vids, out_vid, graph):
        from . import codegen

        self.ops = list(ordered)
        self.ext_vids = list(ext_vids)
        self.out_vid = out_vid
        self.shape = tuple(graph.shape(out_vid))
        self.dtype = graph.dtype(out_vid)
        chain = codegen.Chain(inputs=[codegen.CInput(graph.dtype(v), "flat") for v in ext_vids],
                              ops=[], cols=self.shape[-1], out_cols=self.shape[-1])
        vid_index = {v: k for k, v in enumerate(ext_vids)}
        val_index = {}
        for i, op in enumerate(self.ops):
            args = codegen.op_entries(op, vid_index, val_index, chain)
            chain.ops.append(codegen.COp(_base_type(op.type), dict(op.kwargs), args,
                                         graph.dtype(op.out_vids[0])))
            val_index[op.out_vids[0]] = i
        self.chain = chain
        self.source = codegen.elementwise_source(chain)
        self._wide = {}
        self._fn = self._grid_fn = self._count = self._stream = None
        self._grids = {}     # (device index, launch) -> the persistent grid's blocks
        self._prepared = {}  # (launch, pointers) -> (argument block, its ref, blocks, vec)
        self._launch_shape = None

    def replay(self, *vals):
        return replay(self.ops, self.ext_vids, vals, self.out_vid)

    def launch_key(self):
        numel = int(np.prod(self.shape))
        return {"rows": numel // max(1, self.shape[-1]), "cols": self.shape[-1],
                "n_ops": len(self.ops), "dtype": str(self.dtype).split(".")[-1]}

    def default_launch(self):
        """128 threads, runs of 8 elements when no input or output is wider
        than 16 bits (16-byte loads), else 4: the measured best at
        chip_smoke.py's cases (PERF.md §6)."""
        widest = max([t.itemsize for t in [self.dtype] + [i.dtype for i in self.chain.inputs]])
        return 128, (8 if widest <= 2 else 4)

    def launches(self):
        """Every config of VPU_LAUNCHES, the default first."""
        default = self.default_launch()
        return [default] + [l for l in VPU_LAUNCHES if l != default]

    def __call__(self, *vals, launch=None):
        from paddle_tpu_torch import ops

        if not ops.use_kernel(*vals):
            return self.replay(*vals)
        return self._launch(vals, launch)

    def _bind(self, lib):
        """Launch through ``lib``, a library built from ``self.source``."""
        from paddle_tpu_torch import ops

        from . import codegen

        self._fn = codegen.entry_point(lib, "pt_vpu_launch", "vpu")
        self._grid_fn = codegen.entry_point(lib, "pt_vpu_grid", "vpu_grid")
        self._count = ops.count_launch
        self._stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
        self._grids.clear()
        self._prepared.clear()

    def _default(self):
        from paddle_tpu_torch.ops import autotune as at

        tuned = at.lookup("vpu_chain", self.launch_key())
        self._launch_shape = ((int(tuned["threads"]), int(tuned["elems"])) if tuned
                              else self.default_launch())
        return self._launch_shape

    def _prepare(self, dev, launch, ptrs, out_ptr, n):
        from . import codegen

        threads, elems = launch
        grid = self._grids.get((dev.index, launch))
        if grid is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            with torch.cuda.device(dev):
                grid = self._grid_fn(threads, elems, sms)
            if grid <= 0:
                raise ValueError(f"vpu_chain: launch {launch} is not one the kernel takes")
            self._grids[dev.index, launch] = grid
        if out_ptr % 16:
            raise RuntimeError("vpu_chain: the output is not 16-byte aligned")
        runs = -(-n // elems)
        blocks = min(grid, -(-runs // threads))
        vec = sum(1 << k for k, p in enumerate(ptrs) if p % 16 == 0)
        a = codegen.args_block(list(ptrs), [0] * len(ptrs), out_ptr)
        if len(self._prepared) >= 64:
            self._prepared.clear()
        prep = self._prepared[launch, ptrs, out_ptr] = (a, ctypes.byref(a), blocks, vec)
        return prep

    def _launch(self, vals, launch):
        if self._fn is None:  # bound once: a launch costs no hashing or lookups
            from paddle_tpu_torch.ops import _cuda_build

            self._bind(_cuda_build.load_generated(self.source))
        if launch is None:
            launch = self._launch_shape or self._default()
        elif len(launch) != 2:
            raise ValueError(f"vpu_chain: launch {launch} is not (threads, elems)")
        dev = vals[0].device
        ins = []
        for v, inp in zip(vals, self.chain.inputs):
            if v.dtype != inp.dtype or v.shape != self.shape:
                raise TypeError(f"vpu_chain input {tuple(v.shape)} {v.dtype}, expected "
                                f"{self.shape} {inp.dtype}")
            ins.append(v if v.is_contiguous() else v.contiguous())
        wide = self._wide.get(dev)
        if wide is None:
            wide = self._wide[dev] = [w.to(device=dev, dtype=torch.float32).contiguous()
                                      .reshape(-1) for w in self.chain.wide_values]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        n = out.numel()
        if n == 0:
            return out
        ptrs = tuple(t.data_ptr() for t in ins) + tuple(w.data_ptr() for w in wide)
        out_ptr = out.data_ptr()
        launch = tuple(launch)
        prep = self._prepared.get((launch, ptrs, out_ptr))
        if prep is None:
            prep = self._prepare(dev, launch, ptrs, out_ptr, n)
        _, ref, blocks, vec = prep
        threads, elems = launch
        if dev.index == torch.cuda.current_device():
            err = self._fn(ref, n, threads, elems, blocks, vec, self._stream(dev.index))
        else:
            with torch.cuda.device(dev):
                err = self._fn(ref, n, threads, elems, blocks, vec, self._stream(dev.index))
        if err != 0:
            raise RuntimeError(f"vpu_chain: launch failed with CUDA error {err}")
        self._count("vpu_chain")
        return out


# ---------------------------------------------------------------------------
# schedule-searched fusion


class ScheduleSearchPattern(RewritePattern):
    """Discover a reduction-/matmul-rooted subgraph anchored at ``op`` (the
    downstream end), hand it to the ScheduleSearcher, and substitute ONE
    generated kernel when the searched config beat the plain twin.  A
    site is searched once per pattern (``_seen``); side-effect ops are
    never crossed; fetched interior values are refused by the pass's
    structural rollback."""

    name = "schedule_search"
    root_type = None

    def __init__(self, searcher=None, device="cpu"):
        self._searcher = searcher
        self._device = device
        self._seen: set = set()

    def match_and_rewrite(self, op, graph):
        from . import schedule_search as ss

        spec = ss.match_subgraph(op, graph, device=self._device)
        if spec is None:
            return False
        tag = (spec.sig, id(spec.root))
        if tag in self._seen:
            return False  # searched already (disabled or rolled back)
        self._seen.add(tag)
        if self._searcher is None:
            self._searcher = ss.ScheduleSearcher()
        decision = self._searcher.search(spec)
        if not decision.accepted:
            return False
        try:
            fused = ss.build_kernel(spec, decision.config)
        except ValueError:
            return False  # a cached config this geometry no longer takes
        new_op = _make_op(f"sched_chain_{len(spec.ops)}", fused, [e.vid for e in spec.ext],
                          spec.root, kwargs={"kind": spec.kind,
                                             "schedule": dict(decision.config)})
        graph.replace_op(spec.root, new_op)
        for o in spec.ops:
            if o is not spec.root and o in graph.block.ops:
                graph.block.ops.remove(o)
        return True


class ScheduleSearchPass(PatternRewritePass):
    """Schedule-searched substitution over discovered subgraphs; the
    Executor runs it after PallasFusionPass under FLAGS_schedule_search,
    so the named patterns keep their kernels and their fused ops break
    chains here.  ``device`` is where candidates are built, checked and
    timed (None: the CUDA card).  On the card the libraries of every
    discovered subgraph are compiled together before the search."""

    name = "schedule_search"

    def __init__(self, fetch_vids=(), searcher=None, device=None):
        from paddle_tpu_torch._core.device import resolve_device

        self._device = resolve_device(device)
        super().__init__([ScheduleSearchPattern(searcher, self._device)], fetch_vids=fetch_vids)

    def apply(self, program) -> int:
        if self._device.type == "cuda":
            self._prebuild(program)
        return super().apply(program)

    def _prebuild(self, program):
        from paddle_tpu_torch.ops import _cuda_build
        from paddle_tpu_torch.ops import autotune as at

        from . import schedule_search as ss

        graph = ProgramGraph(program, self._fetch_vids)
        sources = []
        for op in graph.block.ops:
            spec = ss.match_subgraph(op, graph, device=self._device)
            if spec is None:
                continue
            cached = at.lookup(spec.kernel_name(), spec.key())
            if cached is not None and cached.get("disabled"):
                continue
            sources.append(spec.source(ss._tiles(spec, [cached]) if cached else ()))
        if sources:
            _cuda_build.build_generated(sources)
