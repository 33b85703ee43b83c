"""The op-type registry (counterpart of paddle_tpu/framework/op_registry.py).

Every ``Operator.type`` a captured Program can hold resolves here:

- the names the port's functionals and op wrappers pass to
  ``static.program.apply`` (scanned from the package's source once, as the
  JAX package scans its own), and the JAX names of ``_torch_ops()``'s
  table (``add``, ``softmax``, ``cast`` ...) with ``max`` / ``min`` /
  ``argmax`` / ``argmin``;
- the fallbacks a torch call outside the table records under,
  ``torch.<name>`` and ``Tensor.<name>``, when torch has that name;
- the types the IR machinery and the passes emit: autodiff's ``grad`` and
  its aliases, ``optimizer_update``, the ``PallasFusionPass`` kernels, and
  the generated ``vpu_chain_<n>`` / ``sched_chain_<n>``.

Pass namespaces (``wq::matmul``) are stripped first (``base_op_type``).

The registry also binds a recorded op back to its callable from data
(``describe`` / ``build``): an op recorded through ``apply`` names its
function by import path inside this package (``module:qualname``), a
recorded torch call names the torch callable (``torch.add``,
``Tensor.__getitem__``, ``F.softmax``, ``operator.sub``) and keeps its
baked arguments as plain values.  ``static/io.py`` writes programs in
these terms and reads them back with no pickled callable.  A name binds
only through two closed tables: the functions the package's ``apply``
calls record, and the torch callables of the capture table with a fixed
list of fallbacks; no other name an artifact holds reaches a callable.  Ops a pass or
autodiff builds (fused kernels, ``grad``) carry closures, not a recorded
callable: they cannot be described, and saving one raises naming it.
"""

from __future__ import annotations

import importlib
import operator
import pathlib
import re
import types

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "base_op_type",
    "known_op_types",
    "register_op_type",
    "resolve_op_type",
    "side_effect_op_types",
    "callable_name",
    "resolve_callable",
    "describe",
    "build",
    "encode_value",
    "decode_value",
    "NotDescribable",
]

# emitted by the IR machinery itself
_STRUCTURAL_OP_TYPES = {"grad", "share_loss", "share_state", "optimizer_update"}

# emitted by PallasFusionPass (static/rewrite.py)
_PASS_OP_TYPES = {"flash_attention", "fused_rms_norm", "fused_layer_norm", "swiglu",
                  "matmul_epilogue", "add_rms_norm", "add_layer_norm"}

# the JAX names the capture table does not list itself
_TABLE_EXTRA = {"max", "min", "argmax", "argmin", "maximum", "minimum"}

_EXTRA_OP_TYPES: set[str] = set()
_known: frozenset | None = None


def base_op_type(type_: str) -> str:
    """Strip pass-inserted namespaces ("wq::fp16::matmul" -> "matmul")."""
    return type_.rsplit("::", 1)[-1]


def register_op_type(name: str):
    """Declare an extension op type as resolvable."""
    global _known
    _EXTRA_OP_TYPES.add(str(name))
    _known = None
    return name


_APPLY_CALL = re.compile(r"""\b(apply|_random_op)\(\s*['"]([A-Za-z0-9_]+)['"]\s*,\s*"""
                         r"""([A-Za-z_][\w.]*)(?:\s*,\s*([A-Za-z_][\w.]*))?""")
_scanned: tuple | None = None


def _scan_applies():
    """Every op type the package passes to ``apply`` (or ``_random_op``)
    as a literal, and the (module, name) of the callable each such call
    records: the package's source, read once."""
    global _scanned
    if _scanned is None:
        import paddle_tpu_torch

        root = pathlib.Path(paddle_tpu_torch.__file__).parent
        names, callables = set(), set()
        for path in root.rglob("*.py"):
            module = ".".join((_PACKAGE,) + path.relative_to(root).with_suffix("").parts)
            module = module.removesuffix(".__init__")
            for kind, type_, fn, second in _APPLY_CALL.findall(path.read_text()):
                names.add(type_)
                for ident in (fn, second) if kind == "_random_op" else (fn,):
                    if ident and "." not in ident:
                        callables.add((module, ident))
        _scanned = (frozenset(names), frozenset(callables))
    return _scanned


def known_op_types() -> frozenset:
    global _known
    if _known is None:
        from paddle_tpu_torch.static.program import _torch_ops

        table, reflected = _torch_ops()
        names = {t for t, _ in table.values()} | {t for t, _ in reflected.values()}
        _known = frozenset(names | _TABLE_EXTRA | _scan_applies()[0] | _STRUCTURAL_OP_TYPES
                           | _PASS_OP_TYPES | _EXTRA_OP_TYPES)
    return _known


def resolve_op_type(type_: str) -> bool:
    """True when a recorded ``Operator.type`` resolves to a known op."""
    base = base_op_type(type_)
    if base in known_op_types():
        return True
    for prefix in ("vpu_chain_", "sched_chain_"):
        if base.startswith(prefix) and base[len(prefix):].isdigit():
            return True
    label, _, name = base.partition(".")
    if label == "Tensor":
        return hasattr(torch.Tensor, name)
    if label == "torch" and name:
        return any(hasattr(ns, name) for k, ns in _namespaces().items()
                   if k not in ("Tensor", "operator"))
    return False


# ops whose effect is more than their outputs (the random stream they
# advance): dead-code elimination keeps them
_SIDE_EFFECT = frozenset({
    "dropout", "alpha_dropout", "torch.rand_like", "torch.randn_like", "torch.randint_like",
    "torch.bernoulli", "Tensor.bernoulli", "torch.multinomial", "Tensor.multinomial",
    "torch.normal", "torch.dropout"})


def side_effect_op_types() -> frozenset:
    """Base op types dead-code elimination must never remove."""
    return _SIDE_EFFECT


# ------------------------------------------------------------ the binding
#
# A loaded artifact names its ops' callables; a name binds only through two
# closed tables built here from the package's own code, never by following
# the name itself, so an artifact cannot reach any other function.

_PACKAGE = "paddle_tpu_torch"

# torch calls outside the capture table that a saved program may hold (the
# port's models record the first few: position ids, attention masks, tied
# heads); pure functions of their inputs, or draws from torch's generator
_FALLBACK_CALLS = (
    "Tensor.t", "torch.t", "Tensor.expand_as", "Tensor.view_as", "Tensor.reshape_as",
    "Tensor.type_as", "Tensor.contiguous", "Tensor.repeat", "torch.zeros_like",
    "torch.ones_like", "torch.full_like", "torch.stack", "torch.cat", "torch.concat",
    "torch.einsum", "F.pad", "F.one_hot", "F.normalize", "F.logsigmoid", "F.dropout",
    "torch.rand_like", "torch.randn_like",
    *(f"{ns}.{name}" for name in (
        "cumsum", "permute", "flatten", "squeeze", "chunk", "split", "narrow", "select",
        "masked_fill", "where", "gather", "index_select", "tril", "triu", "bmm", "mm",
        "outer", "var", "std", "argsort", "sort", "topk", "repeat_interleave", "flip", "roll",
        "clone", "detach", "sign", "any", "all", "isnan", "isfinite", "logical_not",
        "logical_and", "logical_or") for ns in ("Tensor", "torch")),
)
_bindings: tuple | None = None


def _namespaces():
    F = torch.nn.functional
    return {"Tensor": torch.Tensor, "torch": torch, "F": F, "linalg": torch.linalg,
            "special": torch.special, "fft": torch.fft, "operator": operator}


def _short_name(fn) -> str | None:
    """``<namespace>.<name>`` of a torch (or ``operator``) callable."""
    short = getattr(fn, "__name__", None)
    if short:
        for label, ns in _namespaces().items():
            if getattr(ns, short, None) is fn:
                return f"{label}.{short}"
    return None


def _binding_tables():
    """(name -> package function, name -> torch callable): the functions
    the package's ``apply`` calls record, under ``module:qualname``, and the
    capture table's torch callables, the reflected operators', ``max`` /
    ``min`` / ``argmax`` / ``argmin`` and ``_FALLBACK_CALLS``."""
    global _bindings
    if _bindings is None:
        from paddle_tpu_torch.static.program import _torch_ops

        package = {}
        for module, ident in _scan_applies()[1]:
            fn = getattr(importlib.import_module(module), ident, None)
            if isinstance(fn, types.FunctionType) and fn.__module__.split(".")[0] == _PACKAGE:
                package[f"{fn.__module__}:{fn.__qualname__}"] = fn
        table, reflected = _torch_ops()
        fns = [*table, *(fn for _, fn in reflected.values()),
               torch.max, torch.min, torch.Tensor.max, torch.Tensor.min, torch.argmax,
               torch.argmin]
        torch_calls = {}
        for fn in fns:
            name = _short_name(fn)
            if name is not None:
                torch_calls.setdefault(name, fn)
        for name in _FALLBACK_CALLS:
            label, _, short = name.partition(".")
            fn = getattr(_namespaces()[label], short, None)
            if fn is not None and _short_name(fn) == name:
                torch_calls[name] = fn
        _bindings = (package, torch_calls)
    return _bindings


def callable_name(fn) -> str | None:
    """The name ``resolve_callable`` binds back to ``fn``: ``module:qualname``
    for a function the package records an op over, ``<namespace>.<name>``
    for a torch (or ``operator``) callable of the binding table; None
    when there is none."""
    package, torch_calls = _binding_tables()
    module = getattr(fn, "__module__", None) or ""
    name = f"{module}:{getattr(fn, '__qualname__', '')}"
    if package.get(name) is fn:
        return name
    name = _short_name(fn)
    return name if name is not None and torch_calls.get(name) is fn else None


def resolve_callable(name: str):
    """The callable ``callable_name`` named; raises ``ValueError`` for any
    other name."""
    package, torch_calls = _binding_tables()
    fn = (package if ":" in str(name) else torch_calls).get(name)
    if fn is None:
        raise ValueError(f"{name!r} names no op callable of the registry (a function the "
                         f"package records an op over, or a torch call of its table)")
    return fn


def encode_value(v):
    """A baked argument as JSON-able data (``decode_value`` reads it)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, list):
        return [encode_value(x) for x in v]
    if isinstance(v, torch.Size):
        return {"size": list(v)}
    if isinstance(v, tuple):
        return {"tuple": [encode_value(x) for x in v]}
    if isinstance(v, dict) and all(isinstance(k, str) for k in v):
        return {"dict": {k: encode_value(x) for k, x in v.items()}}
    if isinstance(v, slice):
        return {"slice": [encode_value(v.start), encode_value(v.stop), encode_value(v.step)]}
    if v is Ellipsis:
        return {"ellipsis": True}
    if isinstance(v, torch.dtype):
        return {"dtype": str(v).removeprefix("torch.")}
    if isinstance(v, torch.device):
        return {"device": True}
    if isinstance(v, torch.memory_format):
        return {"memory_format": str(v).removeprefix("torch.")}
    raise TypeError(f"a baked argument of type {type(v).__name__} cannot be written as data")


def decode_value(v, device):
    """``encode_value``'s inverse; a device becomes ``device``."""
    if isinstance(v, list):
        return [decode_value(x, device) for x in v]
    if not isinstance(v, dict):
        return v
    (kind, val), = v.items()
    if kind == "tuple":
        return tuple(decode_value(x, device) for x in val)
    if kind == "dict":
        return {k: decode_value(x, device) for k, x in val.items()}
    if kind == "size":
        return torch.Size(val)
    if kind == "slice":
        return slice(*(decode_value(x, device) for x in val))
    if kind == "ellipsis":
        return Ellipsis
    if kind == "dtype":
        dtype = getattr(torch, val)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"{val!r} is not a torch dtype")
        return dtype
    if kind == "device":
        return torch.device(device)
    if kind == "memory_format":
        fmt = getattr(torch, val)
        if not isinstance(fmt, torch.memory_format):
            raise ValueError(f"{val!r} is not a torch memory format")
        return fmt
    raise ValueError(f"unknown encoded value {kind!r}")


class NotDescribable(ValueError):
    """An op the registry cannot name (saving it raises this)."""


def describe(op) -> dict:
    """The op's callable as data: ``{"call": name}`` for an op recorded over
    a function, or the torch call with its baked leaves."""
    from paddle_tpu_torch.static.program import TorchCall

    if not resolve_op_type(op.type):
        raise NotDescribable(f"op type {op.type!r} does not resolve in the op registry")
    impl = op.impl
    if impl is None:
        raise NotDescribable(
            f"op {op.type!r} has no recorded callable (a pass or autodiff built it); save "
            "the program before the passes that make it: the Predictor's Executor runs "
            "the fusion pass itself")
    if isinstance(impl, TorchCall):
        name = callable_name(impl.func)
        if name is None:
            raise NotDescribable(f"op {op.type!r}: torch callable {impl.func!r} has no name "
                                 "in the registry")
        try:
            leaves = [encode_value(x) for x in impl.leaves]
        except TypeError as e:
            raise NotDescribable(f"op {op.type!r}: {e}") from None
        return {"torch_call": name, "leaves": leaves, "slots": impl.slots,
                "spec": pytree.treespec_dumps(impl.spec), "attr": impl.attr}
    name = callable_name(impl)
    if name is None:
        raise NotDescribable(f"op {op.type!r}: its callable {impl!r} is not a module-level "
                             "function of the package or a torch callable")
    return {"call": name}


def build(desc: dict, device):
    """The callable ``describe`` described (``impl`` of a rebuilt op)."""
    from paddle_tpu_torch.static.program import TorchCall

    if "torch_call" in desc:
        spec = pytree.treespec_loads(desc["spec"])
        leaves = [decode_value(x, device) for x in desc["leaves"]]
        return TorchCall(resolve_callable(desc["torch_call"]), leaves, spec, desc["slots"],
                         desc.get("attr"))
    return resolve_callable(desc["call"])
