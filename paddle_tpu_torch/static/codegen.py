"""The translator of the static tier's codegen passes: recorded ops to CUDA
C++ (no counterpart in the JAX package, whose kernels replay each op's
``fn`` inside the Pallas call; a CUDA kernel cannot replay a torch
callable, so each op type is translated here).

- ``_TABLE`` maps an op type to a C++ expression over its operands in the
  op's compute domain (``f``: float, ``i``: integer, ``b``: bool).  Each
  entry reads its attributes from the op's ``kwargs`` and its operands from
  its ``arg_spec``; an op whose attribute, operand or dtype it cannot read
  raises ``Ineligible``, and the passes leave that op unfused and count it
  (``codegen_stats()["ineligible"]``).  Nothing is guessed.
- Scalar constants become exact literals (the f32 bit pattern, which is
  the value torch computes with: a python scalar meets a tensor in the
  op's f32 math type); a constant that broadcasts along the last dim (rank
  <= 2, leading dims 1) is an extra pointer argument, read as f32.
- Every op's result is rounded to its Variable's dtype (``pt_rbf16``,
  ``pt_rf16``, an integer wrap), so the generated code computes what the
  op-by-op replay computes; the formulas follow torch's CUDA kernels (and
  the port's functionals for silu and gelu), ``round`` is half to even
  (``rintf``).

The same module writes the sources: the chain's body (``PtBody``: ``Raw``,
``load`` and ``finish`` for a run of E elements, ``row<LANES>`` for one
row, ``elem`` for one matmul output), the ``extern "C"`` launchers of every
candidate config, and a host harness under ``PT_HOST`` that the CPU tests
build with a host C++ compiler.  The kernels are the templates in
``csrc/codegen/`` (``vpu_chain.cuh`` #11, ``sched_chain.cuh`` #12,
``sched_chain_ktiled.cuh`` #13); ``ops/_cuda_build.build_generated``
compiles a source, every config of a subgraph in one translation unit.
"""

from __future__ import annotations

import ctypes
import math
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Ineligible", "codegen_stats", "reset_codegen_stats", "check_op", "Chain",
           "elementwise_source", "subgraph_source", "PtArgs", "args_block", "entry_point"]

_STATS = {"ineligible": 0}


def codegen_stats() -> dict:
    return dict(_STATS)


def reset_codegen_stats():
    for k in _STATS:
        _STATS[k] = 0


class Ineligible(ValueError):
    """An op the translator cannot read exactly: it stays unfused."""


# ------------------------------------------------------------------ dtypes

_STORAGE = {torch.bool: "bool", torch.uint8: "uint8_t", torch.int8: "int8_t",
            torch.int16: "int16_t", torch.int32: "int32_t", torch.int64: "int64_t",
            torch.float32: "float", torch.bfloat16: "pt_bf16", torch.float16: "pt_f16"}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def storage(dtype) -> str:
    if dtype not in _STORAGE:
        raise Ineligible(f"dtype {dtype} has no generated storage type")
    return _STORAGE[dtype]


def compute_type(dtype) -> str:
    storage(dtype)
    if dtype in _FLOATS:
        return "float"
    if dtype == torch.bool:
        return "bool"
    return "long long" if dtype == torch.int64 else "int"


def domain(dtype) -> str:
    storage(dtype)
    if dtype in _FLOATS:
        return "f"
    return "b" if dtype == torch.bool else "i"


def round_to(expr: str, dtype) -> str:
    """``expr`` (in the dtype's domain) rounded or wrapped to the dtype."""
    if dtype == torch.bfloat16:
        return f"pt_rbf16({expr})"
    if dtype == torch.float16:
        return f"pt_rf16({expr})"
    if dtype == torch.float32:
        return expr
    if dtype in (torch.int8, torch.uint8, torch.int16):
        return f"(int)({storage(dtype)})({expr})"
    return f"({compute_type(dtype)})({expr})"


def f32_literal(value: float) -> str:
    bits = struct.unpack("<I", struct.pack("<f", float(np.float32(value))))[0]
    return f"pt_u2f(0x{bits:08x}u)"


def literal(value, dom: str, dtype) -> str:
    if dom == "f":
        return f32_literal(value)
    if dom == "b":
        return "true" if value else "false"
    if float(value) != int(value):
        raise Ineligible(f"constant {value!r} in an integer op")
    return f"{int(value)}LL" if dtype == torch.int64 else f"{int(value)}"


def _scalar(v):
    """A python number from a const entry's value (a size-1 tensor or
    array too), or None."""
    if isinstance(v, bool | int | float):
        return v
    if isinstance(v, torch.Tensor) and v.numel() == 1 and v.device.type != "meta":
        return v.item()
    if isinstance(v, np.ndarray | np.generic) and np.size(v) == 1:
        return np.asarray(v).reshape(()).item()
    return None


def _number(kwargs, name, default=None):
    v = kwargs.get(name, default)
    if isinstance(v, bool) or not isinstance(v, int | float):
        raise Ineligible(f"attribute {name}={v!r} is not a number")
    return v


# --------------------------------------------------------------- operands

@dataclass
class Operand:
    """An operand's expression in the op's domain; ``const`` holds a
    scalar constant's python value."""

    expr: str
    const: object = None


def _conv(expr, src_dtype, dom):
    """An expression of ``src_dtype`` converted to domain ``dom``."""
    sd = domain(src_dtype)
    if sd == dom:
        return expr
    if dom == "f":
        return f"(float)({expr})"
    if dom == "b":
        return f"(({expr}) != 0)"
    return f"(long long)({expr})" if sd == "f" else f"(int)({expr})"


# ---------------------------------------------------------- the op table

def _unary(fmt, doms=("f",)):
    def emit(a, kw, dom):
        return fmt.format(a[0].expr)
    return 1, doms, emit


def _addsub(sym):
    def emit(a, kw, dom):
        alpha = _number(kw, "alpha", 1)
        if alpha == 1:
            return f"({a[0].expr} {sym} {a[1].expr})"
        return f"({a[0].expr} {sym} {literal(alpha, dom, None)} * {a[1].expr})"
    return 2, ("f", "i"), emit


def _divide(a, kw, dom):
    if kw.get("rounding_mode") is not None:
        raise Ineligible(f"divide(rounding_mode={kw['rounding_mode']!r})")
    return f"({a[0].expr} / {a[1].expr})"


def _minmax(fname, iname):
    def emit(a, kw, dom):
        return f"{fname if dom == 'f' else iname}({a[0].expr}, {a[1].expr})"
    return 2, ("f", "i"), emit


def _pow(a, kw, dom):
    x, e = a[0].expr, a[1]
    special = {2: f"({x} * {x})", 3: f"({x} * {x} * {x})", 0.5: f"sqrtf({x})",
               -0.5: f"pt_rsqrt({x})", -1: f"(1.f / {x})", -2: f"(1.f / ({x} * {x}))"}
    if e.const is not None and not isinstance(e.const, bool) and e.const in special:
        return special[e.const]  # torch's pow_tensor_scalar shortcuts
    return f"powf({x}, {e.expr})"


def _relu(a, kw, dom):
    return f"pt_relu({a[0].expr})" if dom == "f" else f"pt_imax({a[0].expr}, 0)"


def _abs(a, kw, dom):
    x = a[0].expr
    return f"fabsf({x})" if dom == "f" else f"({x} < 0 ? -{x} : {x})"


def _bound(v, default, dom):
    if v is None:
        return default
    if isinstance(v, bool) or not isinstance(v, int | float):
        raise Ineligible(f"clip bound {v!r} is not a number")
    return literal(v, dom, None)


def _clip(a, kw, dom, lo="min", hi="max", lo_default=None, hi_default=None):
    if dom == "f":
        lo_e = _bound(kw.get(lo, lo_default), f32_literal(-math.inf), dom)
        hi_e = _bound(kw.get(hi, hi_default), f32_literal(math.inf), dom)
        return f"pt_clamp({a[0].expr}, {lo_e}, {hi_e})"
    x = a[0].expr
    if kw.get(lo) is not None:
        x = f"pt_imax({x}, {_bound(kw[lo], None, dom)})"
    if kw.get(hi) is not None:
        x = f"pt_imin({x}, {_bound(kw[hi], None, dom)})"
    return x


def _int_bound(v, dtype):
    """An integer clip bound as torch's clamp takes it: converted to the
    tensor's dtype (a negative bound of a uint8 tensor wraps), refused
    where torch raises (a value the dtype cannot hold)."""
    if isinstance(v, bool) or not isinstance(v, int | float) or float(v) != int(v):
        raise Ineligible(f"clip bound {v!r} of an integer op")
    info, v = torch.iinfo(dtype), int(v)
    if not (-info.max if dtype == torch.uint8 else info.min) <= v <= info.max:
        raise Ineligible(f"clip bound {v} does not fit {dtype}")
    return int(torch.tensor(v, dtype=torch.int64).to(dtype))


def _round(a, kw, dom):
    if kw.get("decimals", 0) != 0:
        raise Ineligible(f"round(decimals={kw['decimals']!r})")
    return f"rintf({a[0].expr})"  # half to even, as torch.round


def _gelu(a, kw, dom):
    return f"pt_gelu_tanh({a[0].expr})" if kw.get("approximate") else f"pt_gelu({a[0].expr})"


def _leaky_relu(a, kw, dom):
    return f"pt_leaky_relu({a[0].expr}, {f32_literal(_number(kw, 'negative_slope', 0.01))})"


def _elu(a, kw, dom):
    return f"pt_elu({a[0].expr}, {f32_literal(_number(kw, 'alpha', 1.0))})"


def _softplus(a, kw, dom):
    return (f"pt_softplus({a[0].expr}, {f32_literal(_number(kw, 'beta', 1.0))}, "
            f"{f32_literal(_number(kw, 'threshold', 20.0))})")


# op type -> (arity, domains it computes in, emit(operands, kwargs, domain))
_TABLE = {
    "add": _addsub("+"),
    "subtract": _addsub("-"),
    "multiply": (2, ("f", "i"), lambda a, kw, d: f"({a[0].expr} * {a[1].expr})"),
    "divide": (2, ("f",), _divide),
    "maximum": _minmax("pt_maximum", "pt_imax"),
    "minimum": _minmax("pt_minimum", "pt_imin"),
    "pow": (2, ("f",), _pow),
    "exp": _unary("expf({})"),
    "log": _unary("logf({})"),
    "tanh": _unary("tanhf({})"),
    "sigmoid": _unary("pt_sigmoid({})"),
    "relu": (1, ("f", "i"), _relu),
    "gelu": (1, ("f",), _gelu),
    "silu": _unary("pt_silu({})"),
    "abs": (1, ("f", "i"), _abs),
    "neg": _unary("(-{})", ("f", "i")),
    "sqrt": _unary("sqrtf({})"),
    "rsqrt": _unary("pt_rsqrt({})"),
    "square": (1, ("f", "i"), lambda a, kw, d: f"({a[0].expr} * {a[0].expr})"),
    "floor": _unary("floorf({})"),
    "ceil": _unary("ceilf({})"),
    "round": (1, ("f",), _round),
    "clip": (1, ("f", "i"), _clip),
    "cast": (1, ("f", "i", "b"), lambda a, kw, d: a[0].expr),
    "leaky_relu": (1, ("f",), _leaky_relu),
    "elu": (1, ("f",), _elu),
    "hardtanh": (1, ("f",), lambda a, kw, d: _clip(a, kw, d, "min_val", "max_val", -1.0, 1.0)),
    "softplus": (1, ("f",), _softplus),
    "mish": _unary("pt_mish({})"),
    "hardswish": _unary("pt_hardswish({})"),
    "hardsigmoid": _unary("pt_hardsigmoid({})"),
    "erf": _unary("erff({})"),
    "sin": _unary("sinf({})"),
    "cos": _unary("cosf({})"),
}
# reductions over the last axis and the rowwise ops (the schedule-search
# kind's whitelists, static/schedule_search.py)
REDUCE = {"sum", "nansum", "mean", "nanmean", "prod", "max", "min", "amax", "amin", "logsumexp"}
ROWWISE = {"softmax", "log_softmax"}


def _base(type_):
    return type_.rsplit("::", 1)[-1]


def emit_elementwise(type_, kwargs, operands, out_dtype, rounded=True):
    """The rounded C++ expression of one elementwise op (``rounded``
    False: before its rounding to ``out_dtype``).  ``operands``:
    (expr, dtype) per entry, dtype None with ``const`` for a scalar
    constant.  Raises Ineligible."""
    entry = _TABLE.get(type_)
    if entry is None:
        raise Ineligible(f"op {type_!r} has no translation")
    arity, doms, emit = entry
    if len(operands) != arity:
        raise Ineligible(f"op {type_!r} with {len(operands)} operands (the table has {arity})")
    dom = domain(out_dtype)
    if dom not in doms:
        raise Ineligible(f"op {type_!r} computing in {out_dtype}")
    if type_ == "clip" and dom == "i":
        kwargs = {k: _int_bound(v, out_dtype) if k in ("min", "max") and v is not None else v
                  for k, v in kwargs.items()}
    args = []
    for expr, dtype, const in operands:
        if dtype is None:
            args.append(Operand(literal(const, dom, out_dtype), const))
        else:
            args.append(Operand(_conv(expr, dtype, dom)))
    expr = emit(args, kwargs, dom)
    return round_to(expr, out_dtype) if rounded else expr


# ------------------------------------------------------------- the chain

@dataclass
class CInput:
    """An external input: its dtype and how a kernel indexes it: ``flat``
    (the elementwise kernel's flattened elements), ``row`` ([rows, cols]
    at row * ld + c), ``red`` ([rows, 1] at row * ld), ``bcast`` ([cols]
    at c), ``one`` (index 0), ``none`` (read by the matmul only)."""

    dtype: torch.dtype
    access: str


@dataclass
class COp:
    """One op of a chain: ``args`` entries are ('in', k), ('val', i),
    ('const', scalar) or ('wide', w); ``cls`` is 'row' or 'red' (the
    values of a row, or one value a row)."""

    type: str
    kwargs: dict
    args: list
    dtype: torch.dtype
    cls: str = "row"
    kind: str = "elem"


@dataclass
class Chain:
    inputs: list
    ops: list
    cols: int
    out_cols: int
    mm: int | None = None          # index of the matmul op
    x_in: int | None = None        # the matmul's x and w inputs
    w_in: int | None = None
    row_mode: bool = False
    wide_values: list = field(default_factory=list)


def const_ok(value, cols) -> bool:
    """A const the kernels can read: a scalar, or a rank <= 2 broadcast
    along the last dim (leading dims 1, last dim 1 or cols)."""
    if _scalar(value) is not None:
        return True
    shape = tuple(value.shape) if isinstance(value, torch.Tensor) else np.shape(value)
    if isinstance(value, torch.Tensor) and value.device.type == "meta":
        return False
    if len(shape) == 0 or len(shape) > 2:
        return False
    return all(d == 1 for d in shape[:-1]) and shape[-1] in (1, cols)


def op_entries(op, vid_index, val_index, chain: Chain):
    """The COp args of ``op`` (its arg_spec mapped onto chain inputs,
    earlier values and constants); wide constants are appended to
    ``chain.wide_values``."""
    args = []
    for s in op.arg_spec:
        if s[0] == "var":
            if s[1] in val_index:
                args.append(("val", val_index[s[1]]))
            else:
                args.append(("in", vid_index[s[1]]))
            continue
        v = s[1]
        sc = _scalar(v)
        if sc is not None:
            args.append(("const", sc))
            continue
        if not const_ok(v, chain.cols):
            raise Ineligible(f"op {op.type}: a constant of shape {tuple(np.shape(v))}")
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if not t.dtype.is_floating_point:
            raise Ineligible(f"op {op.type}: a wide integer constant")
        args.append(("wide", len(chain.wide_values)))
        chain.wide_values.append(t)
    return args


def check_op(op, graph, cols=None) -> bool:
    """True when the translator reads ``op`` exactly (its attributes,
    operands and dtypes); else counts it as ineligible."""
    try:
        _check(op, graph, cols)
        return True
    except Ineligible:
        _STATS["ineligible"] += 1
        return False


def _check(op, graph, cols):
    base = _base(op.type)
    out_dtype = graph.dtype(op.out_vids[0]) if len(op.out_vids) == 1 else None
    if out_dtype is None:
        raise Ineligible(f"op {op.type}: not one output")
    storage(out_dtype)
    if base in REDUCE or base in ROWWISE:
        ins = [graph.dtype(s[1]) for s in op.arg_spec if s[0] == "var"]
        if len(op.arg_spec) != 1 or len(ins) != 1 or ins[0] not in _FLOATS:
            raise Ineligible(f"op {op.type}: not one float input")
        if out_dtype not in _FLOATS:
            raise Ineligible(f"op {op.type} returning {out_dtype}")
        return
    operands = []
    for s in op.arg_spec:
        if s[0] == "var":
            operands.append(("x", graph.dtype(s[1]), None))
            storage(graph.dtype(s[1]))
            continue
        sc = _scalar(s[1])
        if sc is None:
            shape = s[1].shape if isinstance(s[1], torch.Tensor) else np.shape(s[1])
            if cols is None:
                cols = shape[-1] if len(shape) else 1
            if not const_ok(s[1], cols):
                raise Ineligible(f"op {op.type}: a constant of shape {tuple(shape)}")
            if domain(out_dtype) != "f":
                raise Ineligible(f"op {op.type}: a wide constant in an integer op")
            operands.append(("w", torch.float32, None))
        else:
            operands.append(("", None, sc))
    emit_elementwise(base, op.kwargs, operands, out_dtype)


# ---------------------------------------------------------- source text

_HEADER = '#include "pt_codegen.cuh"\n'


def _ops_scalar(chain: Chain, load, acc_expr):
    """Straight-line code of every op at one element; ``load(k)`` is input
    k's expression.  Returns (lines, name of the last value)."""
    lines = []
    for i, op in enumerate(chain.ops):
        t = compute_type(op.dtype)
        if op.kind == "matmul":
            lines.append(f"  const {t} v{i} = {_matmul_value(chain, op, acc_expr, load)};")
            continue
        ops = [_operand_scalar(chain, e, load) for e in op.args]
        lines.append(f"  const {t} v{i} = {emit_elementwise(op.type, op.kwargs, ops, op.dtype)};")
    return lines, f"v{len(chain.ops) - 1}"


def _operand_scalar(chain, e, load):
    kind, k = e
    if kind == "in":
        return (load(k), chain.inputs[k].dtype, None)
    if kind == "val":
        return (f"v{k}", chain.ops[k].dtype, None)
    if kind == "wide":
        return (f"pt_ld<float>(a.in[{len(chain.inputs) + k}], col)", torch.float32, None)
    return ("", None, k)


def _matmul_value(chain, op, acc, load, row_mode=False):
    """The matmul op's value from the f32 accumulator: rounded to the
    product's dtype, then (a linear with a bias) the bias added and the
    sum rounded, as the port's ``linear`` computes ``x @ w + b``."""
    x_dtype = chain.inputs[chain.x_in].dtype
    v = round_to(acc, x_dtype)
    if len(op.args) == 3:
        if row_mode:
            b = _operand_row(chain, op.args[2])
        else:
            b = _operand_scalar(chain, op.args[2], load)
        v = emit_elementwise("add", {}, [(v, x_dtype, None), b], op.dtype)
    return v


def _row_expr(chain, e):
    kind, k = e
    if kind == "in":
        inp = chain.inputs[k]
        return (f"x{k}[j]" if inp.access in ("row", "bcast") else f"x{k}"), inp.dtype
    if kind == "val":
        op = chain.ops[k]
        return (f"v{k}[j]" if op.cls == "row" else f"v{k}"), op.dtype
    return f"pt_ld<float>(a.in[{len(chain.inputs) + k}], c)", torch.float32


def _operand_row(chain, e):
    if e[0] == "const":
        return ("", None, e[1])
    expr, dtype = _row_expr(chain, e)
    return (expr, dtype, None)


_RED = {  # identity, combine(t, s), lanes helper, finish
    "sum": ("0.f", "t + s", "sum", "t"),
    "nansum": ("0.f", "pt_isnan(s) ? t : t + s", "sum", "t"),
    "prod": ("1.f", "t * s", "prod", "t"),
    "max": ("pt_u2f(0xff800000u)", "pt_maximum(t, s)", "max", "t"),
    "amax": ("pt_u2f(0xff800000u)", "pt_maximum(t, s)", "max", "t"),
    "min": ("pt_u2f(0x7f800000u)", "pt_minimum(t, s)", "min", "t"),
    "amin": ("pt_u2f(0x7f800000u)", "pt_minimum(t, s)", "min", "t"),
}


def _ops_row(chain: Chain):
    """Every op over one row spread across LANES lanes (lane owns columns
    lane + j * LANES, j < PER)."""
    lines = []
    loop = "#pragma unroll\n    for (int j = 0; j < PER; ++j) {\n      const int c = lane + j * LANES;\n      (void)c;\n"
    for i, op in enumerate(chain.ops):
        t = compute_type(op.dtype)
        if op.kind == "matmul":
            v = _matmul_value(chain, op, "(c < kCols ? acc[c] : 0.f)", None, row_mode=True)
            lines.append(f"    {t} v{i}[PER];\n    {loop}      v{i}[j] = {v};\n    }}")
        elif op.kind == "elem":
            ops = [_operand_row(chain, e) for e in op.args]
            expr = emit_elementwise(op.type, op.kwargs, ops, op.dtype)
            if op.cls == "row":
                lines.append(f"    {t} v{i}[PER];\n    {loop}      v{i}[j] = {expr};\n    }}")
            else:
                lines.append(f"    const {t} v{i} = {expr};")
        elif op.kind == "reduce":
            lines.append(_reduce_lines(chain, i, op, loop))
        else:
            lines.append(_rowwise_lines(chain, i, op, loop))
    return lines


def _reduce_lines(chain, i, op, loop):
    src, _ = _row_expr(chain, op.args[0])
    r = lambda e: round_to(e, op.dtype)  # noqa: E731
    base = _base(op.type)
    valid = "if (c < kCols) "
    if base in _RED:
        ident, comb, lanes, fin = _RED[base]
        return (f"    float v{i};\n    {{\n      float t = {ident};\n    {loop}"
                f"      const float s = {src};\n      {valid}t = {comb};\n    }}\n"
                f"      t = pt_lanes_{lanes}<LANES>(t);\n      v{i} = {r(fin)};\n    }}")
    if base == "mean":  # torch: the sum times the float factor 1 / cols
        return (f"    float v{i};\n    {{\n      float t = 0.f;\n    {loop}"
                f"      {valid}t = t + {src};\n    }}\n      t = pt_lanes_sum<LANES>(t);\n"
                f"      v{i} = {r('t * ' + f32_literal(1.0 / chain.cols))};\n    }}")
    if base == "nanmean":
        return (f"    float v{i};\n    {{\n      float t = 0.f, n = 0.f;\n    {loop}"
                f"      const float s = {src};\n      {valid}{{ if (!pt_isnan(s)) {{ t = t + s; "
                f"n = n + 1.f; }} }}\n    }}\n      t = pt_lanes_sum<LANES>(t);\n"
                f"      n = pt_lanes_sum<LANES>(n);\n      v{i} = {r('t / n')};\n    }}")
    # logsumexp: max (an infinite max counts as 0), then log(sum(exp(x - max))) + max,
    # each step rounded to the dtype as torch's composite runs it
    return (f"    float v{i};\n    {{\n      float m = pt_u2f(0xff800000u);\n    {loop}"
            f"      {valid}m = pt_maximum(m, {src});\n    }}\n      m = pt_lanes_max<LANES>(m);\n"
            f"      if (fabsf(m) == pt_u2f(0x7f800000u)) m = 0.f;\n      float t = 0.f;\n    {loop}"
            f"      {valid}t = t + {r('expf(' + r(src + ' - m') + ')')};\n    }}\n"
            f"      t = pt_lanes_sum<LANES>(t);\n"
            f"      v{i} = {r(r('logf(' + r('t') + ')') + ' + m')};\n    }}")


def _rowwise_lines(chain, i, op, loop):
    """softmax / log_softmax over the row in f32, one rounding."""
    src, _ = _row_expr(chain, op.args[0])
    t = compute_type(op.dtype)
    valid = "if (c < kCols) "
    head = (f"    {t} v{i}[PER];\n    {{\n      float m = pt_u2f(0xff800000u);\n    {loop}"
            f"      {valid}m = pt_maximum(m, {src});\n    }}\n      m = pt_lanes_max<LANES>(m);\n"
            f"      float t = 0.f;\n    {loop}      {valid}t = t + expf({src} - m);\n    }}\n"
            f"      t = pt_lanes_sum<LANES>(t);\n")
    if _base(op.type) == "softmax":
        body = round_to(f"expf({src} - m) / t", op.dtype)
    else:
        body = round_to(f"{src} - m - logf(t)", op.dtype)
    return head + f"    {loop}      v{i}[j] = {body};\n    }}\n    }}"


def _row_loads(chain):
    lines = []
    for k, inp in enumerate(chain.inputs):
        if not _used_outside_matmul(chain, k):
            continue
        s, t = storage(inp.dtype), compute_type(inp.dtype)
        if inp.access in ("row", "bcast"):
            idx = "row * a.ld[{k}] + c".format(k=k) if inp.access == "row" else "c"
            lines.append(f"    {t} x{k}[PER];\n#pragma unroll\n    for (int j = 0; j < PER; ++j) "
                         f"{{\n      const int c = lane + j * LANES;\n      x{k}[j] = c < kCols ? "
                         f"pt_ld<{s}>(a.in[{k}], {idx}) : {t}();\n    }}")
        else:
            idx = f"row * a.ld[{k}]" if inp.access == "red" else "0"
            lines.append(f"    const {t} x{k} = pt_ld<{s}>(a.in[{k}], {idx});")
    return lines


def _used_outside_matmul(chain, k):
    for i, op in enumerate(chain.ops):
        args = op.args[2:] if op.kind == "matmul" else op.args
        if ("in", k) in args:
            return True
    return False


_PACKED_ROUND = {torch.bfloat16: "pt_rbf16_run", torch.float16: "pt_rf16_run"}


def _vpu_members(chain: Chain) -> str:
    """The elementwise kernel's members (csrc/codegen/vpu_chain.cuh): a
    run's raw words of every input and the wide constants' values,
    ``load`` (input k through the kernel's source ``s``: 16-byte or
    element loads), ``finish`` (unpack, every op over the run with bf16 /
    f16 results rounded two at a time, the output packed and stored)."""
    n_in, last = len(chain.inputs), len(chain.ops) - 1
    out = [f"  static constexpr int kIns = {n_in};\n"
           f"  static constexpr int kWide = {len(chain.wide_values)};\n"
           "  template <int E>\n  struct Raw {\n"]
    out += [f"    PtRaw<{storage(inp.dtype)}, E> x{k};\n" for k, inp in enumerate(chain.inputs)]
    out += [f"    float w{m}[E];\n" for m in range(len(chain.wide_values))]
    out.append("  };\n  template <int E>\n  static PT_HD void load(Raw<E>& r, const PtGlobalSrc& "
               "s, long long run, bool whole, int col) {\n    (void)col;\n")
    out += [f"    s.get(r.x{k}, {k}, run, whole);\n" for k in range(n_in)]
    out += [f"    pt_wide_load<E>(r.w{m}, s.a.in[{n_in + m}], col, kCols, (s.vec >> {n_in + m}) "
            "& 1u);\n" for m in range(len(chain.wide_values))]
    out.append("  }\n  template <int E>\n  static PT_HD void finish(const Raw<E>& r, void* out, "
               "long long run, long long n) {\n")
    for k, inp in enumerate(chain.inputs):
        out.append(f"    {compute_type(inp.dtype)} x{k}[E];\n    pt_unpack(r.x{k}, x{k});\n")

    def operand(e):
        kind, k = e
        if kind == "in":
            return (f"x{k}[j]", chain.inputs[k].dtype, None)
        if kind == "val":
            return (f"v{k}[j]", chain.ops[k].dtype, None)
        if kind == "wide":
            return (f"r.w{k}[j]", torch.float32, None)
        return ("", None, k)

    for i, op in enumerate(chain.ops):
        packed = _PACKED_ROUND.get(op.dtype)
        expr = emit_elementwise(op.type, op.kwargs, [operand(e) for e in op.args], op.dtype,
                                rounded=packed is None)
        out.append(f"    {compute_type(op.dtype)} v{i}[E];\n#pragma unroll\n"
                   f"    for (int j = 0; j < E; ++j) v{i}[j] = {expr};\n")
        if packed and i < last:  # the last op's rounding is the output's packing
            out.append(f"    {packed}(v{i});\n")
    out_s = storage(chain.ops[last].dtype)
    out.append(f"    PtRaw<{out_s}, E> o;\n    pt_pack(o, v{last});\n    pt_raw_store(o, "
               f"static_cast<{out_s}*>(out) + run * E, n - run * E);\n  }}\n")
    return "".join(out)


def _body_struct(chain: Chain, vpu: bool) -> str:
    """``struct PtBody`` for a chain: Raw/load/finish (vpu) or row/elem."""
    last = chain.ops[-1]
    out_s = storage(last.dtype)
    parts = [f"struct PtBody {{\n  static constexpr int kCols = {chain.cols};\n"
             f"  static constexpr int kOutCols = {chain.out_cols};\n"
             f"  static constexpr bool kRowMode = {'true' if chain.row_mode else 'false'};\n"
             f"  static constexpr int kX = {chain.x_in if chain.x_in is not None else 0};\n"
             f"  static constexpr int kW = {chain.w_in if chain.w_in is not None else 0};\n"]
    if vpu:
        parts.append(_vpu_members(chain))
    if not vpu and chain.row_mode:
        parts.append("  static PT_HD void elem(const PtArgs&, long long, int, float) {}\n")
    if not vpu and not chain.row_mode:
        def load(k):
            inp = chain.inputs[k]
            idx = {"row": f"row * a.ld[{k}] + col", "red": f"row * a.ld[{k}]", "bcast": "col",
                   "one": "0"}[inp.access]
            return f"pt_ld<{storage(inp.dtype)}>(a.in[{k}], {idx})"
        lines, res = _ops_scalar(chain, load, "acc")
        parts.append("  static PT_HD void elem(const PtArgs& a, long long row, int col, float acc) {\n"
                     + "\n".join(lines) +
                     f"\n  pt_st<{out_s}>(a.out, row * kOutCols + col, {res});\n  }}\n")
    if not vpu:
        lines = _row_loads(chain) + _ops_row(chain)
        n = len(chain.ops) - 1
        if last.cls == "row":
            store = (f"#pragma unroll\n    for (int j = 0; j < PER; ++j) {{\n      const int c = lane"
                     f" + j * LANES;\n      if (c < kOutCols) pt_st<{out_s}>(a.out, row * kOutCols"
                     f" + c, v{n}[j]);\n    }}")
        else:
            store = f"    if (lane == 0) pt_st<{out_s}>(a.out, row, v{n});"
        parts.append("  template <int LANES>\n  static PT_HD void row(const PtArgs& a, long long row,"
                     " int lane, const float* acc) {\n    constexpr int PER = (kCols + LANES - 1) /"
                     " LANES;\n    (void)acc;\n" + "\n".join(lines) + "\n" + store + "\n  }\n")
    parts.append("};\n")
    return "".join(parts)


def elementwise_source(chain: Chain) -> str:
    """The generated source of one elementwise chain (#11): its body, the
    persistent grid's size and the launcher (runs of 4 or 8 elements), the
    host harness."""
    return (_HEADER + '#include "vpu_chain.cuh"\n\n' + _body_struct(chain, vpu=True) + """
#ifdef __CUDACC__
extern "C" int pt_vpu_grid(int threads, int elems, int sms) {
  return pt_vpu_grid_for<PtBody>(threads, elems, sms);
}
extern "C" int pt_vpu_launch(const PtArgs* a, long long n, int threads, int elems, int blocks,
                             unsigned vec, void* s) {
  return pt_vpu_launch_for<PtBody>(a, n, threads, elems, blocks, vec, s);
}
#endif
#ifdef PT_HOST
extern "C" int pt_host_vpu(const PtArgs* a, long long n, int threads, int elems, int blocks,
                           unsigned vec, int* cover, int* paths) {
  return pt_vpu_host<PtBody>(*a, n, threads, elems, blocks, vec, cover, paths);
}
#endif
""")


def subgraph_source(chain: Chain, tiles=(), ktiled=False) -> str:
    """The generated source of one schedule-search subgraph (#12, #13):
    its body, the launcher of the reduce kind or one launcher for each
    matmul tile (BM, BN) (and its split-K form), the host harness."""
    out = [_HEADER, '#include "sched_chain_ktiled.cuh"\n\n', _body_struct(chain, vpu=False),
           "\n#ifdef __CUDACC__\n"]
    if chain.mm is None:
        out.append('extern "C" int pt_rows(const PtArgs* a, long long rows, int warps, void* s) {\n'
                   "  return pt_sched_rows_launch<PtBody>(a, rows, warps, s);\n}\n")
    else:
        f32 = "true" if chain.inputs[chain.x_in].dtype == torch.float32 else "false"
        for bm, bn in tiles:
            out.append(f'extern "C" int pt_mm_{bm}_{bn}(const PtArgs* a, int M, int N, int K, '
                       f"int cols_first, int vec, void* s) {{\n  return pt_sched_mm_launch"
                       f"<PtBody, {bm}, {bn}, {f32}>(a, M, N, K, cols_first, vec, s);\n}}\n")
            if ktiled:
                out.append(f'extern "C" int pt_mmk_{bm}_{bn}(const PtArgs* a, int M, int N, '
                           f"int K, int bk, int vec, void* s) {{\n  return pt_sched_mm_ktiled_"
                           f"launch<PtBody, {bm}, {bn}, {f32}>(a, M, N, K, bk, vec, s);\n}}\n")
    out.append("#endif\n#ifdef PT_HOST\n#include <vector>\n")
    if chain.mm is None:
        out.append('extern "C" void pt_host_rows(const PtArgs* a, long long rows) {\n'
                   "  for (long long r = 0; r < rows; ++r) PtBody::row<1>(*a, r, 0, nullptr);\n}\n")
    else:
        xs = storage(chain.inputs[chain.x_in].dtype)
        ws = storage(chain.inputs[chain.w_in].dtype)
        # the product in f32 as the card's split-K runs it: for each block
        # of bm rows, each K slice of bk summed apart (one fmaf a k, in
        # order), then rank q of the gk slices' cluster sums rows
        # [q * per, (q + 1) * per) of every slice's partial in k order and
        # runs the epilogue on them (bk = 0: the whole K; bm = 0: all rows)
        out.append(
            'extern "C" void pt_host_mm(const PtArgs* a, int M, int N, int K, int bk, int bm) {\n'
            "  if (bk <= 0 || bk > K) bk = K > 0 ? K : 1;\n  if (bm <= 0) bm = M;\n"
            "  const int gk = K > 0 ? (K + bk - 1) / bk : 1;\n  const int per = (bm + gk - 1) / gk;\n"
            "  std::vector<float> part((size_t)gk * bm * N), acc(N);\n"
            "  for (int m0 = 0; m0 < M; m0 += bm) {\n"
            "    for (int q = 0; q < gk; ++q)\n      for (int r = 0; r < bm; ++r)\n"
            "        for (int c = 0; c < N; ++c) {\n          float p = 0.f;\n"
            "          for (int k = q * bk; m0 + r < M && k < K && k < (q + 1) * bk; ++k)\n"
            f"            p = fmaf(pt_ld<{xs}>(a->in[PtBody::kX], (long long)(m0 + r) * a->ld[PtBody::kX] + k),\n"
            f"                     pt_ld<{ws}>(a->in[PtBody::kW], (long long)k * a->ld[PtBody::kW] + c), p);\n"
            "          part[((size_t)q * bm + r) * N + c] = p;\n        }\n"
            "    for (int rank = 0; rank < gk; ++rank)\n"
            "      for (int r = rank * per; r < bm && r < (rank + 1) * per && m0 + r < M; ++r) {\n"
            "        for (int c = 0; c < N; ++c) {\n          float s = part[(size_t)r * N + c];\n"
            "          for (int q = 1; q < gk; ++q) s = s + part[((size_t)q * bm + r) * N + c];\n"
            "          acc[c] = s;\n        }\n"
            "        if constexpr (PtBody::kRowMode) PtBody::row<1>(*a, m0 + r, 0, acc.data());\n"
            "        else for (int c = 0; c < N; ++c) PtBody::elem(*a, m0 + r, c, acc[c]);\n"
            "      }\n  }\n}\n")
    out.append("#endif\n")
    return "".join(out)


# ------------------------------------------------------------- launching

class PtArgs(ctypes.Structure):
    """The ``PtArgs`` block of csrc/codegen/pt_codegen.cuh."""

    _fields_ = [("inp", ctypes.c_void_p * 24), ("ld", ctypes.c_longlong * 24),
                ("out", ctypes.c_void_p)]


MAX_ARGS = 24


def args_block(ptrs, lds, out) -> PtArgs:
    if len(ptrs) > MAX_ARGS:
        raise ValueError(f"{len(ptrs)} kernel arguments > {MAX_ARGS}")
    a = PtArgs()
    for i, (p, ld) in enumerate(zip(ptrs, lds)):
        a.inp[i] = p
        a.ld[i] = ld
    a.out = out
    return a


_SIGNATURES = {
    "vpu": [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_uint,
                                                                       ctypes.c_void_p],
    "vpu_grid": [ctypes.c_int] * 3,
    "rows": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "mm": [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "mmk": [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def entry_point(lib, name, kind):
    """The C entry point ``name`` of a loaded generated library, typed by
    its ``kind`` (vpu, vpu_grid, rows, mm, mmk)."""
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[kind]
    fn.restype = ctypes.c_int
    return fn
