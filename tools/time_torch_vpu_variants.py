#!/usr/bin/env python3
"""Time the generated elementwise-chain kernel (#11, csrc/codegen/
vpu_chain.cuh) of one checkout on the card, beside its floors and design
variants.

    python3 tools/time_torch_vpu_variants.py [ROOT] [TAG] [ROUNDS]

ROOT is the root of a checkout of this repository (default: this one), so
that an older tree's kernel can be timed by the same tool (unpack it with
``git archive`` into a directory that .gitignore lists).  At
chip_smoke.py's three elementwise cases (BERT's mask chain, bool [32, 128]
to f32; the JAX package's test chain, bf16 [4096, 3072]; the wide-bias
chain ``tanh(a * 2 + c) * 3``, bf16 [4096, 3072] with c an f32 [3072]
constant) it times, under chip_smoke.py's timer (CUDA events around each
call, the L2 flushed before it, the launch enqueued behind a spin):

- every variant of the checkout's header at every launch config that
  variant takes: ``kept`` (the header as it is) and ``floor`` (the
  arithmetic floor: every load of an input replaced by values made in
  registers from the element's index, bf16 and f32 values in
  [-2, -0.125] and [0.125, 2], and the output store kept behind a
  condition on the computed value that the compiler cannot drop and that
  never holds), and for the header of the persistent kernel ``stcs`` (the
  output stored with the evict-first hint ``st.global.cs``),
  ``single_cvt`` (each bf16 result rounded by its own conversion, the
  packed one undone), ``full_grid`` (the kept kernel launched with a
  block for every ``threads`` runs, one run a thread, instead of the
  persistent grid) and ``depth2`` / ``depth3`` / ``depth4`` (2, 3 or 4
  runs a thread in registers at every run length, instead of 3 for runs
  of 4 elements and 2 for runs of 8);
- ``copy``: one torch op that moves the same bytes (``copy_fn``), the
  memory floor;
- ``empty``: an empty kernel (csrc/norm_swiglu.cu's
  ``paddle_empty_kernel``), the launch floor.

Each variant's output is first held against the replay of the recorded
ops (the mask chain bit-exact, bf16 within one bf16 step).  ROUNDS
(default 3) rounds time every entry in turns, the order reversed every
other round; one JSON line per (case, entry) gives the median, least and
most microseconds.  Each variant's library is disassembled
(``cuobjdump -sass``): the SASS instructions of each kernel by class
(MUFU, FP32, conversion, integer/address, branch, memory, other), counted
statically and divided by the elements the kernel's code covers (a run
of E elements, times the runs its unrolled loop holds), with
registers and spills from ``-Xptxas -v``.  Prints the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them.  Builds into ROOT's
build/kernels/vpu_variants/ (one nvcc per source and variant, all
started together).  Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# ------------------------------------------------------------------ cases


def mask_chain(ids):
    m = (ids != 0).to(torch.int32)
    return (1 - m.float()) * -1e4


def jax_test_chain(a, b):
    return torch.sqrt(torch.exp(torch.tanh(a * b + a) * 0.5) + 1.0) * b


def wide_bias_chain(bias):
    return lambda a: torch.tanh(a * 2.0 + bias) * 3.0


def cases():
    """name -> (chain, feeds, inputs on the card); inputs from seeded
    generators, the wide constant from a CPU generator (it is captured)."""
    g = torch.Generator(device="cuda").manual_seed(31)
    ids = torch.randint(0, 3, (32, 128), generator=g, device="cuda", dtype=torch.int32)
    ab = [torch.randn(4096, 3072, generator=g, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    bias = torch.randn(3072, generator=torch.Generator().manual_seed(7)).to("cuda")
    a = torch.randn(4096, 3072, generator=g, device="cuda").to(torch.bfloat16)
    return {
        "bert_mask": (mask_chain, [("ids", (32, 128), "int32")], [ids != 0]),
        "jax_chain_bf16": (jax_test_chain, [("a", (4096, 3072), "bfloat16"),
                                            ("b", (4096, 3072), "bfloat16")], ab),
        "wide_bias_bf16": (wide_bias_chain(bias), [("a", (4096, 3072), "bfloat16")], [a]),
    }


def capture(build, feeds):
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static.passes import apply_pass

    main = static.Program()
    with static.program_guard(main):
        out = build(*[static.data(n, list(s), d) for n, s, d in feeds])
    if apply_pass(main, "generic_elementwise_fusion", fetch_vids=[out._vid]) != 1:
        raise AssertionError("the elementwise chain was not fused")
    return main.global_block().ops[-1].fn


# --------------------------------------------------------------- variants

# The values an input's word takes in the arithmetic floor: its index
# hashed, masked to a storage type's moderate values.
_FLOOR_HELPERS = r"""
// the floor's store condition: a signalling-NaN word the chains never
// write (their NaNs are the conversions' canonical ones)
constexpr uint32_t kNever = 0x7fbfffffu;
template <class S> struct PtFloorBits {
  static constexpr uint32_t kOr = 0u, kAnd = 0x0f0f0f0fu;
};
template <> struct PtFloorBits<pt_bf16> {
  static constexpr uint32_t kOr = 0x3e003e00u, kAnd = 0x81ff81ffu;
};
template <> struct PtFloorBits<pt_f16> {
  static constexpr uint32_t kOr = 0x30003000u, kAnd = 0x8fff8fffu;
};
template <> struct PtFloorBits<float> {
  static constexpr uint32_t kOr = 0x3e000000u, kAnd = 0x81ffffffu;
};
template <> struct PtFloorBits<bool> { static constexpr uint32_t kOr = 0u, kAnd = 0x01010101u; };
template <class S> PT_HD uint32_t pt_floor_word(uint32_t h) {
  return PtFloorBits<S>::kOr | (h & PtFloorBits<S>::kAnd);
}
template <class S> PT_HD uint4 pt_floor_u4(long long i, int k) {
  const uint32_t h = (uint32_t)(i * 4 + k) * 2654435761u;
  return make_uint4(pt_floor_word<S>(h), pt_floor_word<S>(h * 3u), pt_floor_word<S>(h * 5u),
                    pt_floor_word<S>(h * 7u));
}
"""

# The one-run-a-thread header that the persistent kernel replaced: marker
# ``pt_load_run``.
_V11_INCLUDE = '#include "pt_codegen.cuh"\n'
_V11_NEVER = "*reinterpret_cast<const uint32_t*>(tmp) == kNever"
_V11_FLOOR = [
    (_V11_INCLUDE, _V11_INCLUDE + _FLOOR_HELPERS),
    ("        reinterpret_cast<uint4*>(tmp)[i] = reinterpret_cast<const uint4*>(p)[i];",
     "        reinterpret_cast<uint4*>(tmp)[i] = pt_floor_u4<S>(base, i);"),
    ("      *reinterpret_cast<uint2*>(tmp) = *reinterpret_cast<const uint2*>(p);",
     "      { const uint4 f = pt_floor_u4<S>(base, 0); *reinterpret_cast<uint2*>(tmp) = "
     "make_uint2(f.x, f.y); }"),
    ("      *reinterpret_cast<uint32_t*>(tmp) = *reinterpret_cast<const uint32_t*>(p);",
     "      *reinterpret_cast<uint32_t*>(tmp) = pt_floor_u4<S>(base, 0).x;"),
    ("        reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(tmp)[i];",
     "        if (" + _V11_NEVER + ")\n"
     "          reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(tmp)[i];"),
    ("      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(tmp);",
     "      if (" + _V11_NEVER + ")\n"
     "        *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(tmp);"),
    ("      *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(tmp);",
     "      if (" + _V11_NEVER + ")\n"
     "        *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(tmp);"),
]
V11_VARIANTS = {"kept": [], "floor": _V11_FLOOR}

# The persistent kernel's header: marker ``PT_VPU_DEPTH``.
_RAW_FLOOR = r"""
template <class S, int E> PT_HD void pt_raw_floor(PtRaw<S, E>& r, long long run, int k) {
#pragma unroll
  for (int i = 0; i < PtRaw<S, E>::kWords; ++i)
    r.w[i] = pt_floor_word<S>((uint32_t)(run * 64 + k * 16 + i) * 2654435761u);
}
"""
_PTUINT = "template <int B>\nstruct PtUint;\n"
_V12_FLOOR = [
    (_PTUINT, _FLOOR_HELPERS + _RAW_FLOOR + _PTUINT),
    ("      pt_raw_vec(r, p);\n    else", "      pt_raw_floor(r, run, k);\n    else"),
    ("        static_cast<uint4*>(p)[i] =\n",
     "        if (r.w[0] == kNever) static_cast<uint4*>(p)[i] =\n"),
    ("      *static_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);",
     "      if (r.w[0] == kNever) *static_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);"),
    ("      *static_cast<uint32_t*>(p) = r.w[0];",
     "      if (r.w[0] == kNever) *static_cast<uint32_t*>(p) = r.w[0];"),
]
_V12_STCS = [
    ("""        static_cast<uint4*>(p)[i] =
            make_uint4(r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]);""",
     """        __stcs(static_cast<uint4*>(p) + i,
               make_uint4(r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]));"""),
]
_V12_SINGLE_CVT = [  # each bf16 result rounded by its own conversion (the packed one undone)
    ("""    const __nv_bfloat162 h = __floats2bfloat162_rn(v[e], v[e + 1]);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    v[e] = __uint_as_float(u << 16);
    v[e + 1] = __uint_as_float(u & 0xffff0000u);""",
     """    v[e] = pt_rbf16(v[e]);
    v[e + 1] = pt_rbf16(v[e + 1]);"""),
]
_DEPTH = "#define PT_VPU_DEPTH(E) ((E) == 4 ? 3 : 2)"
_ALL = lambda launch, default: True  # noqa: E731
_DEFAULT = lambda launch, default: launch == default  # noqa: E731
_NOT_512 = lambda launch, default: launch[0] != 512  # noqa: E731
_KEPT_DEPTH = lambda elems: 3 if elems == 4 else 2  # noqa: E731
# variant -> (substitutions, the launch configs it is timed at, the runs
# the kernel's code holds at a run length: the SASS counts are divided by
# them and the run)
V12_VARIANTS = {
    "kept": ([], _ALL, _KEPT_DEPTH),
    "floor": (_V12_FLOOR, _ALL, _KEPT_DEPTH),
    "stcs": (_V12_STCS, _DEFAULT, _KEPT_DEPTH),
    "single_cvt": (_V12_SINGLE_CVT, _DEFAULT, _KEPT_DEPTH),
    "full_grid": ([], _NOT_512, _KEPT_DEPTH),
    **{f"depth{k}": ([(_DEPTH, f"#define PT_VPU_DEPTH(E) {k}")], _NOT_512,
                     lambda elems, k=k: k) for k in (2, 3, 4)},
}


def header_variants(text):
    """variant -> (substitutions, launch filter, runs in the kernel's code)
    of the checkout's vpu_chain.cuh, by its generation."""
    if "pt_load_run" in text:
        return {k: (v, _ALL, lambda elems: 1) for k, v in V11_VARIANTS.items()}
    if "PT_VPU_DEPTH" in text:
        return V12_VARIANTS
    raise AssertionError("vpu_chain.cuh of an unknown generation")


def variant_dir(build_dir, csrc, name, subs):
    base = build_dir / "vpu_variants" / name
    shutil.rmtree(base, ignore_errors=True)
    (base / "codegen").mkdir(parents=True)
    (base / "lib").mkdir()
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, base / h.name)
    for h in (csrc / "codegen").glob("*.cuh"):
        text = h.read_text()
        if h.name == "vpu_chain.cuh":
            for old, new in subs:
                if old not in text:
                    raise AssertionError(f"variant {name}: {old!r} is not in the header")
                text = text.replace(old, new)
        (base / "codegen" / h.name).write_text(text)
    return base


def start_variant(name, sources):
    """Start one nvcc for each generated source ({key: text}) against the
    variant ``name`` of the imported checkout's vpu_chain.cuh, with the
    generated sources' flags: {key: (library path, process)}."""
    from paddle_tpu_torch.ops import _cuda_build

    header = (_cuda_build.CSRC / "codegen" / "vpu_chain.cuh").read_text()
    subs = header_variants(header)[name][0]
    base = variant_dir(_cuda_build.BUILD_DIR, _cuda_build.CSRC, name, subs)
    flags = _cuda_build.GEN_FLAGS[:-4] + ["-I", str(base / "codegen"), "-I", str(base)]
    procs = {}
    for key, text in sources.items():
        cu = base / "lib" / f"{key}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        procs[key] = (lib, subprocess.Popen([_cuda_build._nvcc(), *flags, "-o", str(lib),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    return procs


def finish_variant(name, procs):
    """{key: (library path, nvcc output)} once every nvcc has ended."""
    out = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}, {key}:\n{log}")
        out[key] = (lib, log)
    return out


def build_variant(name, sources):
    return finish_variant(name, start_variant(name, sources))


# ------------------------------------------------------------------- SASS

_CLASSES = {
    "MUFU": "mufu",
    **dict.fromkeys(("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
                     "FSWZADD", "HADD2", "HMUL2", "HFMA2"), "fp32"),
    **dict.fromkeys(("F2F", "F2FP", "I2F", "F2I", "FRND", "I2FP", "F2IP"), "conversion"),
    **dict.fromkeys(("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP",
                     "SEL", "PRMT", "IABS", "IMNMX", "FLO", "POPC", "BMSK", "SGXT", "IDP",
                     "UIADD3", "UIMAD", "ULOP3", "USHF", "ULEA", "UISETP", "USEL", "UPRMT",
                     "UMOV", "UFLO", "UPOPC", "USGXT", "UBMSK"), "integer"),
    **dict.fromkeys(("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "WARPSYNC", "BREAK", "JMP",
                     "BRX", "JMX", "YIELD", "BPT"), "branch"),
    **dict.fromkeys(("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ULDC", "LDL", "STL",
                     "ATOM", "ATOMS", "RED", "LDSM", "UBLKCP", "SYNCS", "UTMALDG", "LDGSTS",
                     "LDGDEPBAR"), "memory"),
}


def sass_classes(lib_path):
    """kernel name -> instruction counts by class (static: each
    instruction of the kernel's code once)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            op = m.group(1)
            if op == "NOP":
                continue
            cls = _CLASSES.get(op, "other")
            kernels[name][cls] = kernels[name].get(cls, 0) + 1
    return kernels


def ptxas(log):
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\w+)'[\s\S]*?Used (\d+) registers", log)}
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log))
    return {"registers": regs, "spill_bytes": spills}


# ---------------------------------------------------------------- running


def launches_of(kernel):
    """The launch configs this checkout's kernel takes, the default first."""
    if hasattr(kernel, "launches"):
        return kernel.launches()
    default = tuple(kernel.default_launch())  # the older kernel: (threads, elements a thread)
    return [default] + [l for l in [(128, 4), (256, 4), (256, 8), (512, 8)] if l != default]


def use_library(kernel, lib, full_grid=False):
    """Point ``kernel`` at the variant library ``lib``; ``full_grid``: a
    block for every ``threads`` runs (one run a thread) instead of the
    persistent grid."""
    from paddle_tpu_torch.static import codegen

    if hasattr(kernel, "_bind"):
        kernel._bind(lib)
        if full_grid:
            for launch in kernel.launches():
                kernel._grids[torch.cuda.current_device(), tuple(launch)] = 1 << 30
        return
    kernel._fns = {e: codegen.entry_point(lib, f"pt_vpu_{e}", "vpu") for e in (4, 8)}


def copy_fn(inputs, out):
    """One torch op that moves the chain's bytes (each input read once, the
    output written once): ``torch.add`` of two inputs of the output's
    dtype, ``copy_`` of one, else a copy between two byte buffers of half
    the bytes each (a copy that converts dtypes runs well below the
    card's bandwidth)."""
    if all(t.dtype == out.dtype for t in inputs) and len(inputs) <= 2:
        if len(inputs) == 1:
            return lambda: out.copy_(inputs[0])
        return lambda: torch.add(inputs[0], inputs[1], out=out)
    half = (sum(t.numel() * t.element_size() for t in inputs)
            + out.numel() * out.element_size()) // 2
    src = torch.empty(half, dtype=torch.uint8, device=out.device)
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def timer(flush):
    def time_us(fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for s, e in zip(starts, ends):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters * 1e3

    return time_us


def main() -> int:
    args = sys.argv[1:]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1]).resolve()
    tag = args[1] if len(args) > 1 else str(root)
    rounds = int(args[2]) if len(args) > 2 else 3
    if not torch.cuda.is_available():
        print("time_torch_vpu_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from paddle_tpu_torch.ops import _cuda_build
    from paddle_tpu_torch.ops._norm_swiglu import lib as norm_lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tag": tag, "card": card, "root": str(root)}), flush=True)
    variants = header_variants((_cuda_build.CSRC / "codegen" / "vpu_chain.cuh").read_text())
    case_defs = cases()
    kernels = {name: capture(build, feeds) for name, (build, feeds, _) in case_defs.items()}
    sources = {case: k.source for case, k in kernels.items()}
    started = {vname: start_variant(vname, sources) for vname in variants}
    libs = {}
    for vname, procs in started.items():
        for case, (lib, log) in finish_variant(vname, procs).items():
            libs[vname, case] = lib
            sass, per_element = sass_classes(lib), {}
            for kname, counts in sass.items():
                m = re.search(r"Li(\d+)E", kname)
                run = int(m.group(1)) if m else 1
                elems = run * variants[vname][2](run)
                per_element[kname] = {c: round(v / elems, 2) for c, v in counts.items()}
                per_element[kname]["total"] = round(sum(counts.values()) / elems, 2)
            print(json.dumps({"tag": tag, "card": card, "variant": vname, "case": case,
                              **ptxas(log), "sass": sass, "sass_per_element": per_element}),
                  flush=True)
    empty_fn = norm_lib().paddle_empty_kernel
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    time_us = timer(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    with torch.no_grad():
        for case, (_, _, inputs) in case_defs.items():
            kernel = kernels[case]
            want = kernel.replay(*inputs)
            runs = {}
            launches = launches_of(kernel)
            for vname, (_, takes, _) in variants.items():
                use_library(kernel, ctypes.CDLL(str(libs[vname, case])), vname == "full_grid")
                for launch in [l for l in launches if takes(l, launches[0])]:
                    got = kernel(*inputs, launch=launch)
                    torch.cuda.synchronize()
                    if vname != "floor":
                        err = float((got.float() - want.float()).abs().max())
                        ok = torch.equal(got, want) if case == "bert_mask" else torch.allclose(
                            got.float(), want.float(), rtol=2.0 ** -7, atol=2.0 ** -14)
                        if not ok:
                            raise AssertionError(f"{case} {vname} {launch}: {err}")
                    lib = ctypes.CDLL(str(libs[vname, case]))
                    runs[vname, launch] = (lib, launch)
            out = torch.empty_like(want)
            entries = {f"{v} {'x'.join(map(str, l))}": (v, l) for v, l in runs}
            order = list(entries) + ["copy", "empty"]
            times = {k: [] for k in order}
            for r in range(rounds):
                for key in (order if r % 2 == 0 else order[::-1]):
                    if key == "copy":
                        fn = copy_fn(inputs, out)
                    elif key == "empty":
                        fn = lambda: empty_fn(stream())  # noqa: E731
                    else:
                        vname, launch = entries[key]
                        use_library(kernel, runs[vname, launch][0], vname == "full_grid")
                        fn = lambda launch=launch: kernel(*inputs, launch=launch)  # noqa: E731
                    times[key].append(time_us(fn))
            nbytes = sum(t.numel() * t.element_size() for t in inputs) + \
                want.numel() * want.element_size()
            for key in order:
                t = times[key]
                print(json.dumps({"tag": tag, "card": card, "case": case, "entry": key,
                                  "median_us": statistics.median(t), "min_us": min(t),
                                  "max_us": max(t), "rounds": rounds,
                                  "bytes_bound_us": nbytes / 3.35e12 * 1e6}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
