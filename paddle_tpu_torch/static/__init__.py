"""paddle_tpu_torch.static — the static Program tier (counterpart of
paddle_tpu/static/): capture a model into a ``Program`` under
``program_guard``, run it with ``Executor`` (which applies
``PallasFusionPass`` first, as the JAX Executor does), the codegen passes
(``rewrite``, ``codegen``) and the schedule searcher
(``schedule_search``); train through a Program (``append_backward``,
``gradients``, ``Optimizer.minimize``, dropout drawing from the program's
RNG state); verify programs (``verify``); and export and load them
(``save_inference_model``, ``load_inference_model``, ``save`` / ``load``
of a program's state, ``InputSpec`` for ``jit.save``).

Not ported yet (ROADMAP.md A.5): control flow, the lint tiers, the
startup program and the remaining program passes.
"""

from __future__ import annotations

import torch

from . import passes, rewrite, verify  # noqa: F401
from .autodiff import append_backward, gradients  # noqa: F401
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .io import (deserialize_program, load, load_inference_model, save,  # noqa: F401
                 save_inference_model, serialize_program)
from .program import (  # noqa: F401
    Block,
    Operator,
    Program,
    Variable,
    apply,
    current_main_program,
    default_main_program,
    in_static_capture,
    program_guard,
    suspend_capture,
)

__all__ = [
    "Program",
    "Variable",
    "Operator",
    "Block",
    "program_guard",
    "default_main_program",
    "current_main_program",
    "in_static_capture",
    "suspend_capture",
    "data",
    "Executor",
    "Scope",
    "global_scope",
    "scope_guard",
    "InputSpec",
    "append_backward",
    "gradients",
    "save",
    "load",
    "save_inference_model",
    "load_inference_model",
    "serialize_program",
    "deserialize_program",
]

_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
           "float64": torch.float64, "int64": torch.int64, "int32": torch.int32,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; have {sorted(_DTYPES)}")
    return _DTYPES[str(dtype)]


def data(name, shape, dtype="float32", lod_level=0):
    """Feed placeholder (paddle.static.data).  -1 or None dims are captured
    as 1 for shape inference and kept in ``dynamic_dims``; a run takes the
    feed's actual shape."""
    prog = current_main_program() or default_main_program()
    dyn = tuple(i for i, d in enumerate(shape) if d is None or d < 0)
    shape = [1 if (d is None or d < 0) else int(d) for d in shape]
    v = prog.add_feed(prog.new_var(shape, _as_dtype(dtype), name=name))
    v.dynamic_dims = dyn
    return v


class InputSpec:
    """paddle.static.InputSpec: a feed's shape (``None`` for a dynamic
    batch), dtype and name, for ``jit.save``."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"
