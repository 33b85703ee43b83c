"""Static graph IR: Program / Block / Variable / Operator.

Counterpart of paddle_tpu/static/program.py.  An op is (torch callable,
where each input comes from, static attributes); shape inference runs the
callable on meta tensors, the counterpart of ``jax.eval_shape``.

Capture.  Inside ``program_guard`` a ``torch.overrides.TorchFunctionMode``
is active, the counterpart of the JAX package's ``_core.autograd.apply``
funnel.  Every torch call that touches a ``Variable`` or an
``nn.Parameter`` appends an ``Operator`` instead of running:

- the port's own functionals (``nn.functional.linear``, ``layer_norm``,
  ``gelu``, ``scaled_dot_product_attention`` ...) and op wrappers
  (``ops.fused_rms_norm`` ...) record themselves as ONE op through
  ``apply`` under the JAX package's op type name, and run with capture
  suspended inside;
- a torch call found in ``_torch_ops()``'s table records under the JAX package's
  name (``Tensor.add`` -> ``add``, ``torch.softmax`` -> ``softmax`` with
  its axis in ``kwargs``), reflected operators in mathematical order
  (``1 - v`` is ``subtract(1, v)``); the attributes the codegen passes
  read (reduction axis and keepdim, ``alpha``, clip bounds, activation
  slopes) go into ``kwargs`` too, and ``torch.max(x, dim)`` records its
  values only, as the JAX package's single-output ``max``;
- any other torch call records under its torch name (``torch.<name>`` or
  ``Tensor.<name>``), so no call is run on meta tensors and dropped.

A call whose result holds no tensor (``v.shape``, ``v.dim()``) answers
from the meta tensor and records nothing.  An ``nn.Parameter`` becomes a
state var (its tensor is the init value); any other concrete tensor, such
as position ids from ``torch.arange``, becomes a const.  In-place ops on a
Variable raise.  Build (and cast) a model before entering the guard: a
call on its parameters inside the guard is recorded.
"""

from __future__ import annotations

import contextlib
import itertools
import operator
import threading
import warnings
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

__all__ = [
    "Variable",
    "Operator",
    "Block",
    "Program",
    "program_guard",
    "default_main_program",
    "in_static_capture",
    "current_main_program",
    "suspend_capture",
    "apply",
]

_vid_counter = itertools.count()


class Variable(torch.Tensor):
    """Symbolic tensor in a Program: a meta tensor (shape and dtype, no
    data) with the program's var id.  It answers ``.shape``, ``.dtype``
    and every torch call; inside ``program_guard`` the calls are recorded."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, shape, dtype, name="", program=None):
        v = torch.Tensor._make_subclass(cls, torch.empty(tuple(shape), dtype=dtype,
                                                         device="meta"))
        v._vid = next(_vid_counter)
        v._name = name or f"var_{v._vid}"
        v._program = program
        return v

    def __init__(self, *args, **kwargs):
        pass  # __new__ does the work

    @property
    def name(self):
        return self._name

    def numpy(self):
        raise RuntimeError(f"Variable '{self._name}' has no value inside a static Program; "
                           "fetch it through Executor.run")

    def __repr__(self):
        return f"Variable(name={self._name}, shape={list(self.shape)}, dtype={self.dtype})"

    __str__ = __repr__


@dataclass(eq=False)
class Operator:
    """One recorded op: ``fn`` + where its inputs come from.

    arg_spec entries: ('var', vid) for Variable inputs, ('const', value)
    for captured concrete values and python operands; ``fn`` takes the var
    values in order (consts and kwargs are bound in it).  ``kwargs`` are
    the op's static attributes, which the rewrite patterns read."""

    type: str
    fn: Any
    arg_spec: list
    kwargs: dict
    out_vids: list
    out_tree: Any

    def input_vids(self):
        return [s[1] for s in self.arg_spec if s[0] == "var"]


class Block:
    def __init__(self, program, idx=0):
        self.program = program
        self.idx = idx
        self.ops: list[Operator] = []
        self.vars: dict[str, Variable] = {}

    def var(self, name):
        return self.vars[name]


def _to_meta(x):
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return torch.empty_like(x, device="meta")
    return x


def _has_tensor(tree):
    return any(isinstance(leaf, torch.Tensor) for leaf in pytree.tree_leaves(tree))


class Program:
    """A captured computation: feed vars -> ops -> any var fetchable.

    ``param_inits`` maps a state var's vid to its init value (the
    ``nn.Parameter`` itself); ``writes`` maps vid -> vid (state updates
    applied to the scope after each run)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.feed_vars: list[Variable] = []
        self.param_vars: dict[int, Variable] = {}  # id(Parameter) -> Variable
        self.param_inits: dict[int, Any] = {}  # vid -> init value
        self.writes: dict[int, int] = {}  # target vid -> source vid
        self.version = 0
        self._var_by_vid: dict[int, Variable] = {}

    # ------------------------------------------------------------- structure
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[-1]

    # -------------------------------------------------------------- capture
    def _register_var(self, var: Variable):
        var._program = self
        self.global_block().vars[var.name] = var
        self._var_by_vid[var._vid] = var
        self.version += 1
        return var

    def new_var(self, shape, dtype, name=""):
        return self._register_var(Variable(shape, dtype, name=name, program=self))

    def add_feed(self, var: Variable):
        self.feed_vars.append(var)
        return var

    def var_for_parameter(self, p: nn.Parameter) -> Variable:
        key = id(p)
        if key not in self.param_vars:
            v = self.new_var(p.shape, p.dtype, name=f"param_{len(self.param_vars)}")
            self.param_vars[key] = v
            self.param_inits[v._vid] = p
        return self.param_vars[key]

    def _entry(self, a):
        if isinstance(a, Variable):
            if a._program is not self:
                raise ValueError(f"{a!r} belongs to another Program")
            return ("var", a._vid)
        if isinstance(a, nn.Parameter):
            return ("var", self.var_for_parameter(a)._vid)
        return ("const", a)

    def record(self, type_, fn, args, kwargs):
        """Append an Operator computing ``fn(*args, **kwargs)``; returns its
        output Variable(s).  ``args`` are the op's positional inputs."""
        arg_spec = [self._entry(a) for a in args]
        kwargs = dict(kwargs)
        metas = [self._var_by_vid[s[1]] if s[0] == "var" else _to_meta(s[1])
                 for s in arg_spec]
        with suspend_capture():
            out_meta = fn(*metas, **kwargs)
        flat, tree = pytree.tree_flatten(out_meta)
        if not all(isinstance(o, torch.Tensor) for o in flat):
            raise TypeError(f"op {type_!r}: every output must be a tensor")
        outs = [self.new_var(o.shape, o.dtype) for o in flat]

        def g(*var_vals, _spec=arg_spec, _fn=fn, _kwargs=kwargs):
            it = iter(var_vals)
            return _fn(*[next(it) if s[0] == "var" else s[1] for s in _spec], **_kwargs)

        op = Operator(type_, g, arg_spec, kwargs, [o._vid for o in outs], tree)
        self.current_block().ops.append(op)
        self.version += 1
        return pytree.tree_unflatten(outs, tree)

    def add_write(self, target: Variable, source: Variable):
        self.writes[target._vid] = source._vid
        self.version += 1

    # ------------------------------------------------------------ execution
    def as_function(self, fetch_vids, feed_vids=None, state_vids=None, ops=None):
        """Build ``fn(feed_vals, state_vals) -> (fetches, new_state)``.

        ``ops`` overrides the executed op list."""
        feed_vids = feed_vids if feed_vids is not None else [v._vid for v in self.feed_vars]
        state_vids = state_vids if state_vids is not None else list(self.param_inits)
        ops = list(self.global_block().ops) if ops is None else list(ops)
        writes = dict(self.writes)

        def run(feed_vals, state_vals):
            env = dict(zip(feed_vids, feed_vals))
            env.update(zip(state_vids, state_vals))
            with suspend_capture():  # the ops run, even inside a program_guard
                for op in ops:
                    out = op.fn(*[env[s[1]] for s in op.arg_spec if s[0] == "var"])
                    env.update(zip(op.out_vids, pytree.tree_leaves(out)))
            fetches = [env[vid] for vid in fetch_vids]
            new_state = [env.get(writes.get(vid, -1), env[vid]) for vid in state_vids]
            return fetches, new_state

        return run, feed_vids, state_vids

    # --------------------------------------------------------------- extras
    def clone(self, for_test=False):
        p = Program.__new__(Program)
        p.blocks = [Block(p, 0)]
        p.blocks[0].ops = list(self.global_block().ops)
        p.blocks[0].vars = dict(self.global_block().vars)
        p.feed_vars = list(self.feed_vars)
        p.param_vars = dict(self.param_vars)
        p.param_inits = dict(self.param_inits)
        p.writes = {} if for_test else dict(self.writes)
        p.version = self.version
        p._var_by_vid = dict(self._var_by_vid)
        return p

    def to_string(self):
        lines = [f"Program(version={self.version})"]
        lines += [f"  feed {v!r}" for v in self.feed_vars]
        for op in self.global_block().ops:
            ins = ", ".join(str(s[1]) if s[0] == "var" else "<const>" for s in op.arg_spec)
            lines.append(f"  {op.type}({ins}) -> {op.out_vids}")
        lines += [f"  write var{t} <- var{s}" for t, s in self.writes.items()]
        return "\n".join(lines)

    __str__ = to_string


def replay(ops, in_vids, vals, out_vid):
    """The value of ``out_vid`` after running the recorded ``ops`` on
    ``vals`` (the values of ``in_vids``): the plain version of every
    fused op the codegen passes make, and the schedule search's twin."""
    env = dict(zip(in_vids, vals))
    with suspend_capture():
        for op in ops:
            out = op.fn(*[env[s[1]] for s in op.arg_spec if s[0] == "var"])
            env.update(zip(op.out_vids, pytree.tree_leaves(out)))
    return env[out_vid]


# ------------------------------------------------------------------ context

class _StaticState(threading.local):
    def __init__(self):
        self.main_program = None
        self.suspended = 0
        self.default_main = Program()


_st = _StaticState()


@contextlib.contextmanager
def suspend_capture():
    """Run eagerly while a program_guard is active (a recorded op's body,
    the Executor)."""
    _st.suspended += 1
    try:
        yield
    finally:
        _st.suspended -= 1


def in_static_capture():
    return _st.main_program is not None and not _st.suspended


def current_main_program():
    return _st.main_program


def default_main_program():
    return _st.default_main


def _captured(args):
    return any(isinstance(a, (Variable, nn.Parameter)) for a in pytree.tree_leaves(args))


def apply(type_, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, or, while a Program is being captured and
    an input is a Variable or an nn.Parameter, one recorded op of type
    ``type_`` (the counterpart of the JAX package's ``_core.autograd.apply``).
    ``kwargs`` are static attributes: recorded on the op and bound in it."""
    if in_static_capture() and _captured(args):
        return _st.main_program.record(type_, fn, args, kwargs)
    return fn(*args, **kwargs)


# ---------------------------------------------------- the torch call table

def _attrs(*params, rename=None, keyword_only=False):
    """attrs(args, kwargs) reading the named parameters after the input
    (positional unless ``keyword_only``, or keyword) with their defaults;
    ``rename`` maps torch's parameter names onto the JAX package's."""
    rename = rename or {}

    def read(args, kwargs):
        out = {}
        for i, (name, default) in enumerate(params):
            if not keyword_only and len(args) > i + 1:
                v = args[i + 1]
            else:
                v = kwargs.get(name, default)
            out[rename.get(name, name)] = v
        return out

    return read


def _softmax_attrs(args, kwargs):
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    if dim is None:  # F.softmax's implicit dim, the one torch will use
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dim = torch.nn.functional._get_softmax_dim("softmax", args[0].dim(), 3)
    return {"axis": dim}


_reduce_attrs = _attrs(("dim", None), ("keepdim", False), rename={"dim": "axis"})


def _gelu_attrs(args, kwargs):
    return {"approximate": kwargs.get("approximate", "none") == "tanh"}


def _minmax_call(func, args, kwargs):
    """torch.max / torch.min: ``(x, other)`` is elementwise maximum/minimum;
    ``(x, dim)`` a reduction whose values alone are recorded (the JAX op
    has one output); ``(x)`` a full reduction."""
    other = args[1] if len(args) > 1 else kwargs.get("other", kwargs.get("dim"))
    name = "max" if func in (torch.max, torch.Tensor.max) else "min"
    if isinstance(other, torch.Tensor):
        return ("maximum" if name == "max" else "minimum"), func, {}
    if other is None:
        return name, func, {"axis": None, "keepdim": False}

    def values(*a, _func=func, **kw):
        return _func(*a, **kw).values

    return name, values, _reduce_attrs(args, kwargs)


class _ValuesIndices:
    """What a captured ``torch.max(x, dim)`` returns: ``.values`` (the one
    recorded ``max`` op) and ``.indices``, recorded as an ``argmax`` op only
    when read (``v, i = ...`` reads it), so a program that uses the values
    alone holds the JAX package's single-output op and nothing else."""

    def __init__(self, values, record_indices):
        self.values = values
        self._record_indices = record_indices
        self._indices = None

    @property
    def indices(self):
        if self._indices is None:
            self._indices = self._record_indices()
        return self._indices

    def __iter__(self):
        return iter((self.values, self.indices))

    def __getitem__(self, i):
        return (self.values, self.indices)[i]

    def __len__(self):
        return 2


def _record_minmax_dim(func, args, kwargs):
    type_, _, attrs = _minmax_call(func, args, kwargs)
    dim, keep = attrs["axis"], bool(attrs["keepdim"])
    prog = _st.main_program
    values = prog.record(type_, lambda x, _f=func: _f(x, dim, keep).values, [args[0]], {})
    prog.global_block().ops[-1].kwargs = dict(attrs)
    arg = torch.argmax if type_ == "max" else torch.argmin
    return _ValuesIndices(values, lambda: prog.record(
        "arg" + type_, lambda x, _f=arg: _f(x, dim, keep), [args[0]], {}))


# JAX op types whose python-number operands are recorded as const inputs
# (the rewrite patterns read scales and epsilons from them)
_ARITH = {"add", "subtract", "multiply", "divide", "pow", "maximum", "minimum",
          "not_equal", "equal", "less_than", "less_equal", "greater_than", "greater_equal"}
_TABLE = None


def _torch_ops():
    """torch callable -> (JAX op type, attrs(args, kwargs) or None), and the
    reflected operators -> (JAX op type, callable in mathematical order)."""
    global _TABLE
    if _TABLE is None:
        T, F = torch.Tensor, torch.nn.functional
        names = {
            "add": (torch.add, T.add, T.__add__, T.__radd__),
            "subtract": (torch.sub, T.sub, T.__sub__),
            "multiply": (torch.mul, T.mul, T.__mul__, T.__rmul__),
            "divide": (torch.div, T.div, T.__truediv__),
            "pow": (torch.pow, T.pow, T.__pow__),
            "maximum": (torch.maximum, T.maximum),
            "minimum": (torch.minimum, T.minimum),
            "not_equal": (torch.ne, T.ne, T.__ne__),
            "equal": (torch.eq, T.eq, T.__eq__),
            "less_than": (torch.lt, T.lt, T.__lt__),
            "less_equal": (torch.le, T.le, T.__le__),
            "greater_than": (torch.gt, T.gt, T.__gt__),
            "greater_equal": (torch.ge, T.ge, T.__ge__),
            "neg": (torch.neg, T.neg, T.__neg__),
            "matmul": (torch.matmul, T.matmul, T.__matmul__),
            "softmax": (torch.softmax, T.softmax, F.softmax),
            "mean": (torch.mean, T.mean),
            "rsqrt": (torch.rsqrt, T.rsqrt),
            "sqrt": (torch.sqrt, T.sqrt),
            "exp": (torch.exp, T.exp),
            "log": (torch.log, T.log),
            "abs": (torch.abs, T.abs, T.__abs__),
            "erf": (torch.erf, T.erf),
            "sin": (torch.sin, T.sin),
            "cos": (torch.cos, T.cos),
            "floor": (torch.floor, T.floor),
            "ceil": (torch.ceil, T.ceil),
            "round": (torch.round, T.round),
            "clip": (torch.clamp, T.clamp, torch.clip, T.clip),
            "tanh": (torch.tanh, T.tanh, F.tanh),
            "sigmoid": (torch.sigmoid, T.sigmoid, F.sigmoid),
            "square": (torch.square, T.square),
            "relu": (torch.relu, T.relu, F.relu),
            "silu": (F.silu,),
            "gelu": (F.gelu,),
            "leaky_relu": (F.leaky_relu,),
            "elu": (F.elu,),
            "hardtanh": (F.hardtanh,),
            "softplus": (F.softplus,),
            "mish": (F.mish,),
            "hardswish": (F.hardswish,),
            "hardsigmoid": (F.hardsigmoid,),
            "sum": (torch.sum, T.sum),
            "nansum": (torch.nansum, T.nansum),
            "nanmean": (torch.nanmean, T.nanmean),
            "prod": (torch.prod, T.prod),
            "amax": (torch.amax, T.amax),
            "amin": (torch.amin, T.amin),
            "logsumexp": (torch.logsumexp, T.logsumexp),
            "log_softmax": (torch.log_softmax, T.log_softmax, F.log_softmax),
            "reshape": (torch.reshape, T.reshape, T.view),
            "unsqueeze": (torch.unsqueeze, T.unsqueeze),
            "expand": (T.expand,),
            "transpose": (torch.transpose, T.transpose),
            "cast": (T.to, T.float, T.int, T.long, T.bfloat16, T.half, T.type),
            "getitem": (T.__getitem__,),
        }
        attrs = {"softmax": _softmax_attrs, "log_softmax": _softmax_attrs, "gelu": _gelu_attrs,
                 "add": _attrs(("alpha", 1), keyword_only=True),
                 "subtract": _attrs(("alpha", 1), keyword_only=True),
                 "divide": _attrs(("rounding_mode", None), keyword_only=True),
                 "round": _attrs(("decimals", 0), keyword_only=True),
                 "clip": _attrs(("min", None), ("max", None)),
                 "leaky_relu": _attrs(("negative_slope", 0.01)),
                 "elu": _attrs(("alpha", 1.0)),
                 "hardtanh": _attrs(("min_val", -1.0), ("max_val", 1.0)),
                 "softplus": _attrs(("beta", 1.0), ("threshold", 20.0)),
                 "prod": _reduce_attrs, "logsumexp": _reduce_attrs}
        for name in ("mean", "sum", "nansum", "nanmean", "amax", "amin"):
            attrs[name] = _reduce_attrs
        table = {}
        for name, fns in names.items():
            for f in fns:
                table[f] = (name, attrs.get(name))
        # t.__rsub__(c) is c - t: recorded as subtract(c, t)
        reflected = {T.__rsub__: ("subtract", operator.sub),
                     T.__rdiv__: ("divide", operator.truediv),
                     T.__rtruediv__: ("divide", operator.truediv),
                     T.__rpow__: ("pow", operator.pow),
                     T.__rmatmul__: ("matmul", operator.matmul)}
        _TABLE = (table, reflected)
    return _TABLE


def _torch_name(func):
    qual = getattr(func, "__qualname__", "") or ""
    name = getattr(func, "__name__", None) or repr(func)
    if qual.startswith(("TensorBase.", "Tensor.")):
        return "Tensor." + name
    return "torch." + name


def _record_torch_call(func, args, kwargs):
    prog = _st.main_program
    table, reflected = _torch_ops()
    if func in reflected:
        type_, fn = reflected[func]
        return prog.record(type_, fn, [args[1], args[0]], {})
    if func in (torch.max, torch.Tensor.max, torch.min, torch.Tensor.min):
        type_, func, attr_vals = _minmax_call(func, args, kwargs)
        if type_ in ("max", "min") and attr_vals["axis"] is not None:
            return _record_minmax_dim(torch.max if type_ == "max" else torch.min, args, kwargs)
        attrs = lambda a, k, _v=attr_vals: _v  # noqa: E731
    else:
        type_, attrs = table.get(func, (None, None))
    if type_ is None:
        type_ = _torch_name(func)
    # the op's inputs: every tensor leaf of the call, and the python
    # operands of an arithmetic op (so `x / 4.0` records divide(x, 4.0));
    # an arithmetic op's positional args are leaves, the first of the call
    leaves, spec = pytree.tree_flatten((args, kwargs))
    top = set(range(len(args))) if type_ in _ARITH else set()
    slots = [i for i, leaf in enumerate(leaves)
             if isinstance(leaf, torch.Tensor)
             or (i in top and isinstance(leaf, (int, float, bool)))]

    def fn(*inputs, _leaves=leaves, _slots=slots, _spec=spec, _func=func):
        full = list(_leaves)
        for i, v in zip(_slots, inputs):
            full[i] = v
        a, kw = pytree.tree_unflatten(full, _spec)
        return _func(*a, **kw)

    op_inputs = [leaves[i] for i in slots]
    out = prog.record(type_, fn, op_inputs, {})
    if attrs is not None:  # metadata for the patterns; fn has them bound
        op = prog.global_block().ops[-1]
        op.kwargs = {**op.kwargs, **attrs(args, kwargs)}
    return out


class _CaptureMode(TorchFunctionMode):
    """Records torch calls on Variables and Parameters while a Program is
    being captured (see the module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not in_static_capture() or not _captured((args, kwargs)):
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        inplace = (name.endswith("_") and not name.startswith("__")) or name in (
            "__setitem__", "__iadd__", "__isub__", "__imul__", "__itruediv__")
        variables = [a for a in pytree.tree_leaves((args, kwargs)) if isinstance(a, Variable)]
        if inplace:
            if variables:
                raise NotImplementedError(
                    f"in-place {name} on a Variable is not captured; write it out of place")
            return func(*args, **kwargs)  # e.g. initialising a parameter
        # a call on parameters alone probes them as they are (p.device is
        # their device); one on a Variable probes on meta tensors
        probe_args, probe_kwargs = (pytree.tree_map(_to_meta, (args, kwargs)) if variables
                                    else (args, kwargs))
        with suspend_capture():
            probe = func(*probe_args, **probe_kwargs)
        if not _has_tensor(probe):
            return probe  # .shape, .dtype, .dim(): static facts, no op
        return _record_torch_call(func, args, kwargs)


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Capture the torch calls of the block into ``main_program``.  The
    startup program is accepted for Paddle's signature; state lives in
    ``param_inits``."""
    prev = _st.main_program
    _st.main_program = main_program
    try:
        with _CaptureMode():
            yield
    finally:
        _st.main_program = prev
