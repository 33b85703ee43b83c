"""``csrc/norm_swiglu.cu``'s library, shared by ``fused_norm`` (RMSNorm)
and ``swiglu``: its loader, the dtype codes of its C interface and the
rule for its 16-byte accesses."""

from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}  # the kernels' dtype codes

_LIB = None


def lib():
    """The library (RMSNorm, SwiGLU and an empty kernel for the launch
    floor), built and typed at the first use."""
    global _LIB
    if _LIB is None:
        from ._cuda_build import load

        loaded = load("norm_swiglu")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        loaded.paddle_rms_norm.argtypes = ([ptr] * 5 + [i64, i32, ctypes.c_float] + [i32] * 7
                                           + [ptr])
        loaded.paddle_rms_norm.restype = i32
        loaded.paddle_swiglu.argtypes = [ptr] * 3 + [i64, i32, i64, i64] + [i32] * 5 + [ptr]
        loaded.paddle_swiglu.restype = i32
        loaded.paddle_empty_kernel.argtypes, loaded.paddle_empty_kernel.restype = [ptr], i32
        _LIB = loaded
    return _LIB


def vec_ok(cols, elem_bytes, ptrs, strides=()) -> bool:
    """16-byte accesses: whole chunks a row (``cols`` and every row stride
    a multiple of ``16 // elem_bytes`` elements) and 16-byte aligned
    pointers."""
    elems = 16 // elem_bytes
    return (cols % elems == 0 and all(s % elems == 0 for s in strides)
            and all(p % 16 == 0 for p in ptrs))
