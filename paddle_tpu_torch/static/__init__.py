"""paddle_tpu_torch.static — the static Program tier (counterpart of
paddle_tpu/static/): capture a model into a ``Program`` under
``program_guard``, run it with ``Executor`` (which applies
``PallasFusionPass`` first, as the JAX Executor does), and the schedule
searcher's protocol (``schedule_search``).

Not ported yet (ROADMAP.md queue A item 5): ``verify.py``, ``io``
(``save_inference_model`` ...), ``autodiff`` (``append_backward``),
control flow, the lint tiers, the startup program, and the codegen passes.
"""

from __future__ import annotations

import torch

from . import passes, rewrite  # noqa: F401
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
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
    as 1 for shape inference; a run takes the feed's actual shape."""
    prog = current_main_program() or default_main_program()
    shape = [1 if (d is None or d < 0) else int(d) for d in shape]
    return prog.add_feed(prog.new_var(shape, _as_dtype(dtype), name=name))
