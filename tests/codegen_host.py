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


def args(arrays, lds, out):
    return codegen.args_block([a.ctypes.data for a in arrays], lds, out.ctypes.data)


def _vpu_entry(lib):
    fn = lib.pt_host_vpu
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_elementwise(kernel, tensors, launch=None, blocks=3, vec=None, offsets=None):
    """An ElementwiseChainKernel's generated code on the CPU, walked as the
    card's kernel deals it: ``launch`` (threads, elements a run; default
    the kernel's), ``blocks`` blocks, ``vec`` the inputs' and wide
    constants' 16-byte-alignment bits (default: every bit set) and
    ``offsets`` each input read that many elements into a longer array
    (the card's misaligned views)."""
    lib = load(kernel.source)
    threads, elems = launch or kernel.default_launch()
    ins = []
    for i, t in enumerate(tensors):
        off = offsets[i] if offsets else 0
        a = to_numpy(t).reshape(-1)
        padded = np.zeros(a.size + off, dtype=a.dtype)
        padded[off:] = a
        ins.append((padded, off))
    wides = [to_numpy(w.float().reshape(-1)) for w in kernel.chain.wide_values]
    ptrs = [a.ctypes.data + off * a.itemsize for a, off in ins] + [w.ctypes.data for w in wides]
    out = empty(kernel.shape, kernel.dtype)
    a = codegen.args_block(ptrs, [0] * len(ptrs), out.ctypes.data)
    mask = (1 << len(ptrs)) - 1 if vec is None else vec
    err = _vpu_entry(lib)(ctypes.byref(a), out.size, threads, elems, blocks, mask, None, None)
    if err:
        raise ValueError(f"the host walk refused {(threads, elems)} x {blocks} blocks")
    return from_numpy(out, kernel.dtype)


def vpu_cover(kernel, n, threads, elems, blocks, vec):
    """How the card's kernel deals n elements: each element's count of
    runs that cover it, and its path per input (vpu_chain.cuh's
    PT_VPU_VEC 0, PT_VPU_ELEM 1), from the host walk."""
    lib = load(kernel.source)
    k = len(kernel.chain.inputs)
    cover = np.zeros(n, dtype=np.int32)
    paths = np.full(n * k, -1, dtype=np.int32)
    a = codegen.args_block([0] * (k + len(kernel.chain.wide_values)), [0] * k, 0)
    err = _vpu_entry(lib)(ctypes.byref(a), n, threads, elems, blocks, vec, cover.ctypes.data,
                          paths.ctypes.data)
    if err:
        raise ValueError(f"the host walk refused {(threads, elems)} x {blocks} blocks")
    return cover, paths.reshape(n, k)


def run_subgraph(spec, tensors, block_k=0, block_rows=0):
    """A SubgraphSpec's generated code on the CPU.  The product, if any, is
    taken in f32 as the card's cluster split-K takes it: each K slice of
    ``block_k`` summed apart, then, in each block of ``block_rows`` rows,
    the rows dealt among the slices' ranks, each summing its rows'
    partials in k order before the epilogue (0: the whole K, all rows)."""
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
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
        fn(ctypes.byref(a), spec.rows, w.shape[1], x.shape[-1], block_k, block_rows)
    return from_numpy(out, spec.out_dtype).reshape(spec.out_shape)
