"""Build a generated codegen source for the CPU with the host C++
compiler and run it on numpy arrays (the tests' harness).

``static/codegen.py`` writes every chain as ``__host__ __device__`` text
over the portable helpers of ``csrc/codegen/pt_codegen.cuh``, plus host
entry points under ``PT_HOST``; this module compiles that text with g++
(``-ffp-contract=off``, as the card's build runs ``--fmad=false``) and
fills the ``PtArgs`` block from numpy arrays.  bf16 arrays travel as
their uint16 bit patterns."""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from paddle_tpu_torch.static import codegen

CSRC = Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
_LIBS: dict = {}
_DIR = Path(tempfile.mkdtemp(prefix="pt_codegen_host_"))


def compiler():
    return shutil.which("g++") or shutil.which("c++")


def load(source: str) -> ctypes.CDLL:
    key = hashlib.sha256(source.encode()).hexdigest()[:16]
    if key not in _LIBS:
        src = _DIR / f"{key}.cc"
        lib = _DIR / f"lib{key}.so"
        src.write_text(source)
        cmd = [compiler(), "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
               "-shared", "-DPT_HOST", "-I", str(CSRC / "codegen"), "-I", str(CSRC),
               "-o", str(lib), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stderr}\n{source}")
        _LIBS[key] = ctypes.CDLL(str(lib))
    return _LIBS[key]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous numpy array with the tensor's bytes (bf16 as uint16)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def empty(shape, dtype):
    return to_numpy(torch.empty(shape, dtype=dtype))


def args(arrays, lds, out, ws=None):
    return codegen.args_block([a.ctypes.data for a in arrays], lds, out.ctypes.data,
                              None if ws is None else ws.ctypes.data)


def run_elementwise(kernel, tensors):
    """An ElementwiseChainKernel's generated code on the CPU."""
    lib = load(kernel.source)
    ins = [to_numpy(t) for t in tensors] + [to_numpy(w.float().reshape(-1))
                                             for w in kernel.chain.wide_values]
    out = empty(kernel.shape, kernel.dtype)
    fn = lib.pt_host_vpu
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    fn(ctypes.byref(args(ins, [0] * len(ins), out)), out.size)
    return from_numpy(out, kernel.dtype)


def run_subgraph(spec, tensors, block_k=0):
    """A SubgraphSpec's generated code on the CPU (the product, if any, in
    f32 with its K slices of ``block_k`` summed in k order)."""
    from paddle_tpu_torch.static import schedule_search as ss

    chain = ss._subgraph_chain(spec)
    lib = load(codegen.subgraph_source(chain))
    arrays, lds = [], []
    for e, t in zip(spec.ext, tensors):
        if e.role in ("row", "xrow"):
            t = t.reshape(spec.rows, e.cols)
        elif e.role != "weight":
            t = t.reshape(1, -1)
        arrays.append(to_numpy(t))
        lds.append(t.shape[1] if t.dim() == 2 else 0)
    arrays += [to_numpy(w.float().reshape(-1)) for w in chain.wide_values]
    lds += [0] * len(chain.wide_values)
    out = empty((spec.rows, spec.out_cols), spec.out_dtype)
    a = args(arrays, lds, out)
    if spec.kind == "reduce":
        fn = lib.pt_host_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        fn(ctypes.byref(a), spec.rows)
    else:
        x = next(t for e, t in zip(spec.ext, tensors) if e.role == "xrow")
        w = next(t for e, t in zip(spec.ext, tensors) if e.role == "weight")
        fn = lib.pt_host_mm
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
        fn(ctypes.byref(a), spec.rows, w.shape[1], x.shape[-1], block_k)
    return from_numpy(out, spec.out_dtype).reshape(spec.out_shape)
