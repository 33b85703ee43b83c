"""Build the CUDA C++ kernels under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled by
nvcc for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the root
of the checkout (the hash is of the source and of the shared headers
``csrc/*.cuh``, so an edited source never loads a stale library) and
loaded with ctypes.  Nothing here runs at import time.  There is no
``--use_fast_math``: the int8 KV writes of ``decode_chain.cu`` rely on
IEEE division to write the same bytes as the plain version.

Generated sources (the codegen passes, ``static/codegen.py``) take
``build_generated``: the text is compiled against the templates of
``csrc/codegen/`` into ``build/kernels/codegen/lib<hash>.so``, the hash of
the text, of every header it can include (``csrc/codegen/*.cuh``,
``csrc/*.cuh``) and of the flags.  One nvcc process per source (a
subgraph's every candidate config is one translation unit), all sources
of one call compiled together.  They also build with ``--fmad=false``: a
generated chain rounds each recorded op on its own, as the op-by-op
replay does (the kernels' products call ``fmaf`` and ``mma`` explicitly).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

GEN_DIR = BUILD_DIR / "codegen"
GEN_FLAGS = NVCC_FLAGS + ["--fmad=false", "-I", str(CSRC / "codegen"), "-I", str(CSRC)]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, str]:
    """Compile every named source that has no library yet, one nvcc
    process per source, all started together.  Returns each compiler's
    output (registers, shared memory, spills from ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def generated_path(source: str) -> Path:
    h = hashlib.sha256(source.encode())
    for header in sorted(CSRC.glob("codegen/*.cuh")) + sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(GEN_FLAGS[:-4]).encode())
    return GEN_DIR / f"lib{h.hexdigest()[:16]}.so"


def build_generated(sources) -> dict[str, dict]:
    """Compile every generated source that has no library yet, one nvcc
    process each, all started together.  Returns, per library path, the
    compiler's output and its wall seconds (0 for a library already
    built)."""
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for src in dict.fromkeys(sources):
        lib = generated_path(src)
        if lib.exists() or str(lib) in procs:
            out[str(lib)] = {"log": "", "seconds": 0.0}
            continue
        cu = lib.with_suffix(".cu")
        cu.write_text(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *GEN_FLAGS, "-o", str(tmp), str(cu)]
        procs[str(lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, lib,
                           time.perf_counter())
    failed = []
    for key, (proc, tmp, lib, t0) in procs.items():
        log = proc.communicate()[0]
        out[key] = {"log": log, "seconds": time.perf_counter() - t0}
        if proc.returncode != 0:
            failed.append(f"{lib.with_suffix('.cu')}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for generated source " + "\n".join(failed))
    return out


def load_generated(source: str) -> ctypes.CDLL:
    """The loaded library of a generated source, built first if needed."""
    path = str(generated_path(source))
    lib = _LIBS.get(path)
    if lib is None:
        build_generated([source])
        lib = _LIBS[path] = ctypes.CDLL(path)
    return lib
