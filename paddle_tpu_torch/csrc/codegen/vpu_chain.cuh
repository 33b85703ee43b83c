// The elementwise chain kernel for Hopper (queue B #11): every op of a
// discovered same-shape elementwise chain in registers, one pass over the
// data.  static/codegen.py writes the chain's body (``PtBody``: ``Raw<E>``,
// one run of E consecutive elements of every input as they lie in memory;
// ``load``, which fills it; ``finish``, which unpacks it, evaluates every op
// over the run and stores the output) into a generated source that includes
// this header; the kernel below places the runs.
//
// Replaces the TPU kernel paddle_tpu/static/rewrite.py:
// GenericElementwiseFusionPass._build_kernel (:804), which replays the
// recorded op fns over (rows_block, cols_block) VMEM tiles.  Here the
// flattened elements are dealt in runs of E; the data is contiguous, so
// there is nothing to tile.
//
// What bounds it on this card: bytes for a short chain; for a chain of
// exact transcendental functions (libdevice tanhf / expf / sqrtf, no fast
// math, every op rounded to its dtype as torch's op-by-op run rounds it)
// the instructions come close, and before the packed conversions below
// the conversion pipe set the pace.  Design:
// - a persistent grid (the SM count times the blocks an SM holds, from the
//   occupancy API) whose threads walk the runs at the grid's stride, each
//   holding PT_VPU_DEPTH(E) runs in registers so that the loads of the
//   next are in flight while it evaluates this one (the loop unrolled so
//   that the run buffers take turns without copies);
// - 16-byte loads and stores; 16-bit values unpacked from the words by
//   shifts, a chain's bf16 / f16 results rounded two at a time by one
//   packed conversion, the output packed by the same conversion that
//   rounds its last op;
// - a wide constant's column kept as a counter that wraps (no division in
//   the loop);
// - an input whose pointer is not 16-byte aligned, and the ragged tail
//   run, are read by predicated element loads into zeroed words.
// The formulas are pt_codegen.cuh's, so the output is bit for bit the
// output of the one-run-a-thread kernel this replaced.
//
// The dealing (which block, iteration, buffer and lane own each run, and
// which runs and inputs go the vector or the element way) is the PT_HD
// code below; the host harness (``pt_vpu_host``, tests/codegen_host.py)
// walks the same dealing and runs the same load and finish code.

#pragma once

#include "pt_codegen.cuh"

#ifdef PT_HOST
#include <vector>
#endif

// Run buffers a thread holds for runs of E elements: a run of 4 carries
// half the bytes of a run of 8, so a thread holds one more of them to keep
// its loads in flight (3 and 2 measured best at both run lengths' cases).
#define PT_VPU_DEPTH(E) ((E) == 4 ? 3 : 2)

// ------------------------------------------------------------- the dealing

// How a run's input is read: 16-byte vectors, or by predicated element
// loads (the ragged tail run, an input whose pointer is not 16-byte
// aligned).
enum PtVpuPath { PT_VPU_VEC = 0, PT_VPU_ELEM = 1 };

// n elements in runs of ``elems``; ``blocks`` blocks of ``threads`` threads
// walk them at the grid's stride: the run of (block, lane) at iteration
// ``it`` is (it * blocks + block) * threads + lane, held in run buffer
// it % PT_VPU_DEPTH(elems).
struct PtVpuDeal {
  long long n;
  int elems, threads, blocks;

  PT_HD long long runs() const { return (n + elems - 1) / elems; }
  PT_HD long long run(int block, int lane, long long it) const {
    return (it * blocks + block) * threads + lane;
  }
  PT_HD bool whole(long long run) const { return (run + 1) * elems <= n; }
};

// An input's path in a run; ``aligned``: its pointer is 16-byte aligned.
PT_HD int pt_vpu_path(bool whole, bool aligned) {
  return whole && aligned ? PT_VPU_VEC : PT_VPU_ELEM;
}

// A wide constant's column at the start of a thread's run, advanced by the
// thread's stride with one add and a wrap.
struct PtCol {
  int c, step, cols;

  PT_HD static PtCol start(long long first, long long stride, int cols) {
    return PtCol{(int)(first % cols), (int)(stride % cols), cols};
  }
  PT_HD void advance() { c = c + step >= cols ? c + step - cols : c + step; }
};

// --------------------------------------------------------- a run's words

// E consecutive elements of storage type S as they lie in memory, in
// 32-bit words (E * sizeof(S) is a multiple of 4).
template <class S, int E>
struct PtRaw {
  static constexpr int kBytes = E * (int)sizeof(S);
  static constexpr int kWords = kBytes / 4;
  static_assert(kBytes % 4 == 0, "a run is whole words");
  uint32_t w[kWords];
};

template <int B>
struct PtUint;
template <>
struct PtUint<1> {
  using T = uint8_t;
};
template <>
struct PtUint<2> {
  using T = uint16_t;
};
template <>
struct PtUint<4> {
  using T = uint32_t;
};
template <>
struct PtUint<8> {
  using T = unsigned long long;
};

// Element e's bits into the (zeroed) words, and out of them.
template <class S, int E>
PT_HD void pt_raw_set(PtRaw<S, E>& r, int e, unsigned long long bits) {
  constexpr int B = (int)sizeof(S);
  if constexpr (B == 8) {
    r.w[2 * e] = (uint32_t)bits;
    r.w[2 * e + 1] = (uint32_t)(bits >> 32);
  } else {
    r.w[e * B / 4] |= (uint32_t)bits << (8 * ((e * B) % 4));
  }
}

template <class S, int E>
PT_HD unsigned long long pt_raw_bits(const PtRaw<S, E>& r, int e) {
  constexpr int B = (int)sizeof(S);
  if constexpr (B == 8) {
    return (unsigned long long)r.w[2 * e] | ((unsigned long long)r.w[2 * e + 1] << 32);
  } else if constexpr (B == 4) {
    return r.w[e];
  } else {
    return (r.w[e * B / 4] >> (8 * ((e * B) % 4))) & ((1u << (8 * B)) - 1u);
  }
}

// Copy a run's kBytes from ``p`` (aligned to 16 bytes or to kBytes): global
// memory through the read-only path on the card.
template <class S, int E>
PT_HD void pt_raw_vec(PtRaw<S, E>& r, const void* p) {
  constexpr int kBytes = PtRaw<S, E>::kBytes;
#ifdef __CUDA_ARCH__
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 v = __ldg(static_cast<const uint4*>(p) + i);
      r.w[4 * i] = v.x;
      r.w[4 * i + 1] = v.y;
      r.w[4 * i + 2] = v.z;
      r.w[4 * i + 3] = v.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
    r.w[0] = __ldg(static_cast<const unsigned*>(p));
  }
#else
  memcpy(r.w, p, kBytes);
#endif
}

// The elements below ``avail`` one at a time into zeroed words (a
// predicated load each, the rest stay 0).
template <class S, int E>
PT_HD void pt_raw_elems(PtRaw<S, E>& r, const void* p, long long avail) {
  using U = typename PtUint<sizeof(S)>::T;
  const U* q = static_cast<const U*>(p);
#pragma unroll
  for (int i = 0; i < PtRaw<S, E>::kWords; ++i) r.w[i] = 0u;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < avail) pt_raw_set(r, e, (unsigned long long)q[e]);
  }
}

// A run of the output: 16-byte stores when whole, else element stores of
// the elements below ``avail``.
template <class S, int E>
PT_HD void pt_raw_store(const PtRaw<S, E>& r, void* p, long long avail) {
  constexpr int kBytes = PtRaw<S, E>::kBytes;
  if (avail >= E) {
#ifdef __CUDA_ARCH__
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        static_cast<uint4*>(p)[i] =
            make_uint4(r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]);
    } else if constexpr (kBytes == 8) {
      *static_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
    } else {
      *static_cast<uint32_t*>(p) = r.w[0];
    }
#else
    memcpy(p, r.w, kBytes);
#endif
    return;
  }
  using U = typename PtUint<sizeof(S)>::T;
  U* q = static_cast<U*>(p);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < avail) q[e] = (U)pt_raw_bits(r, e);
  }
}

// --------------------------------------- unpacking and packing a run

template <int E>
PT_HD void pt_unpack(const PtRaw<float, E>& r, float (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = pt_u2f(r.w[e]);
}
template <int E>
PT_HD void pt_unpack(const PtRaw<pt_bf16, E>& r, float (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    x[e] = pt_u2f(r.w[e / 2] << 16);
    x[e + 1] = pt_u2f(r.w[e / 2] & 0xffff0000u);
  }
}
template <int E>
PT_HD void pt_unpack(const PtRaw<pt_f16, E>& r, float (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
#ifdef __CUDA_ARCH__
    const uint32_t u = r.w[e / 2];
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u));
    x[e] = f.x;
    x[e + 1] = f.y;
#else
    x[e] = pt_f16_float((uint16_t)(r.w[e / 2] & 0xffffu));
    x[e + 1] = pt_f16_float((uint16_t)(r.w[e / 2] >> 16));
#endif
  }
}
template <int E>
PT_HD void pt_unpack(const PtRaw<bool, E>& r, bool (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = pt_raw_bits(r, e) != 0u;
}
template <int E>
PT_HD void pt_unpack(const PtRaw<int8_t, E>& r, int (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = (int)(int8_t)(uint8_t)pt_raw_bits(r, e);
}
template <int E>
PT_HD void pt_unpack(const PtRaw<uint8_t, E>& r, int (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = (int)pt_raw_bits(r, e);
}
template <int E>
PT_HD void pt_unpack(const PtRaw<int16_t, E>& r, int (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = (int)(int16_t)(uint16_t)pt_raw_bits(r, e);
}
template <int E>
PT_HD void pt_unpack(const PtRaw<int32_t, E>& r, int (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = (int)r.w[e];
}
template <int E>
PT_HD void pt_unpack(const PtRaw<int64_t, E>& r, long long (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = (long long)pt_raw_bits(r, e);
}

// The output run from the last op's values.  bf16 and f16 take the last
// op unrounded: the packed conversion is its rounding.
template <int E>
PT_HD void pt_pack(PtRaw<float, E>& o, const float (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) o.w[e] = pt_f2u(v[e]);
}
template <int E>
PT_HD void pt_pack(PtRaw<pt_bf16, E>& o, const float (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
#ifdef __CUDA_ARCH__
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[e], v[e + 1]);
    o.w[e / 2] = *reinterpret_cast<const uint32_t*>(&h);
#else
    o.w[e / 2] = (uint32_t)pt_bf16_bits(v[e]) | ((uint32_t)pt_bf16_bits(v[e + 1]) << 16);
#endif
  }
}
template <int E>
PT_HD void pt_pack(PtRaw<pt_f16, E>& o, const float (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
#ifdef __CUDA_ARCH__
    const __half2 h = __floats2half2_rn(v[e], v[e + 1]);
    o.w[e / 2] = *reinterpret_cast<const uint32_t*>(&h);
#else
    o.w[e / 2] = (uint32_t)pt_f16_bits(v[e]) | ((uint32_t)pt_f16_bits(v[e + 1]) << 16);
#endif
  }
}
template <class S, int E, class T>
PT_HD void pt_pack(PtRaw<S, E>& o, const T (&v)[E]) {  // bool and the integers
#pragma unroll
  for (int i = 0; i < PtRaw<S, E>::kWords; ++i) o.w[i] = 0u;
#pragma unroll
  for (int e = 0; e < E; ++e)
    pt_raw_set(o, e, (unsigned long long)(typename PtUint<sizeof(S)>::T)(S)v[e]);
}

// A run of an op's f32 results rounded to bf16 / f16 and widened back, two
// by one packed conversion (cvt.rn.bf16x2.f32 / .f16x2: each half rounds as
// the single conversion does).
template <int E>
PT_HD void pt_rbf16_run(float (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
#ifdef __CUDA_ARCH__
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[e], v[e + 1]);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    v[e] = __uint_as_float(u << 16);
    v[e + 1] = __uint_as_float(u & 0xffff0000u);
#else
    v[e] = pt_rbf16(v[e]);
    v[e + 1] = pt_rbf16(v[e + 1]);
#endif
  }
}
template <int E>
PT_HD void pt_rf16_run(float (&v)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 2) {
#ifdef __CUDA_ARCH__
    const float2 f = __half22float2(__floats2half2_rn(v[e], v[e + 1]));
    v[e] = f.x;
    v[e + 1] = f.y;
#else
    v[e] = pt_rf16(v[e]);
    v[e + 1] = pt_rf16(v[e + 1]);
#endif
  }
}

// A wide constant's E values from column ``col`` on (f32, ``cols`` of
// them): 16-byte loads when the run does not wrap, else one value at a
// time with the column wrapping.
template <int E>
PT_HD void pt_wide_load(float (&w)[E], const void* p, int col, int cols, bool aligned) {
  const float* f = static_cast<const float*>(p);
#ifdef __CUDA_ARCH__
  if (aligned && (col & 3) == 0 && col + E <= cols) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(f + col) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    return;
  }
#endif
  (void)aligned;
  int c = col;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    w[e] = f[c];
    c = c + 1 == cols ? 0 : c + 1;
  }
}

// ------------------------------------------------------ where runs come from

// Device memory: input k's run by its path.  ``vec`` bit k: input k's
// pointer is 16-byte aligned (bits kIns + w: the wide constants').
struct PtGlobalSrc {
  const PtArgs& a;
  unsigned vec;
  long long n;

  template <class S, int E>
  PT_HD void get(PtRaw<S, E>& r, int k, long long run, bool whole) const {
    const S* p = static_cast<const S*>(a.in[k]) + run * E;
    if (pt_vpu_path(whole, (vec >> k) & 1u) == PT_VPU_VEC)
      pt_raw_vec(r, p);
    else
      pt_raw_elems(r, p, n - run * E);
  }
};

// A launch config the kernel takes: runs of 4 or 8 elements, whole warps,
// at most 1,024 threads.
PT_HD bool pt_vpu_config_ok(int threads, int elems) {
  return (elems == 4 || elems == 8) && threads >= 32 && threads % 32 == 0 && threads <= 1024;
}

#ifdef __CUDACC__

// Each thread walks its runs at the grid's stride with D = PT_VPU_DEPTH(E)
// run buffers, D - 1 of them loading while it evaluates one (the
// loop unrolled so that buffer j is a register set, refilled with the run
// D strides ahead once evaluated).
template <class Chain, int E>
__global__ void __launch_bounds__(1024) pt_vpu_chain_kernel(const __grid_constant__ PtArgs a,
                                                            long long n, unsigned vec) {
  using Raw = typename Chain::template Raw<E>;
  constexpr int D = PT_VPU_DEPTH(E);
  const PtVpuDeal d{n, E, (int)blockDim.x, (int)gridDim.x};
  const unsigned runs = (unsigned)d.runs();
  const unsigned stride = (unsigned)d.blocks * (unsigned)d.threads;
  unsigned r = (unsigned)d.run(blockIdx.x, threadIdx.x, 0);
  if (r >= runs) return;
  const PtGlobalSrc src{a, vec, n};
  PtCol ahead{0, 0, 1};  // the column of the run loaded last
  if constexpr (Chain::kWide > 0)
    ahead = PtCol::start((long long)r * E, (long long)stride * E, Chain::kCols);
  Raw buf[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const unsigned q = r + j * stride;
    if (j > 0) ahead.advance();
    if (q < runs) Chain::template load<E>(buf[j], src, q, d.whole(q), ahead.c);
  }
  for (;;) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (r >= runs) return;
      Chain::template finish<E>(buf[j], a.out, r, n);
      const unsigned q = r + D * stride;
      ahead.advance();
      if (q < runs) Chain::template load<E>(buf[j], src, q, d.whole(q), ahead.c);
      r += stride;
    }
  }
}

// Blocks of ``threads`` threads one SM holds, times ``sms``: the
// persistent grid.  0 for a config the kernel does not take.
template <class Chain>
int pt_vpu_grid_for(int threads, int elems, int sms) {
  if (!pt_vpu_config_ok(threads, elems)) return 0;
  int per_sm = 0;
  const cudaError_t err =
      elems == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, pt_vpu_chain_kernel<Chain, 4>, threads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, pt_vpu_chain_kernel<Chain, 8>, threads, 0);
  return err == cudaSuccess ? per_sm * sms : 0;
}

// n elements in runs of ``elems``, ``blocks`` blocks (pt_vpu_grid_for's
// persistent grid, or fewer when the runs are fewer); vec: which pointers
// are 16-byte aligned (the output's must be).  Returns cudaGetLastError().
template <class Chain>
int pt_vpu_launch_for(const PtArgs* a, long long n, int threads, int elems, int blocks,
                      unsigned vec, void* stream) {
  if (n <= 0) return 0;
  if (!pt_vpu_config_ok(threads, elems) || blocks <= 0) return (int)cudaErrorInvalidValue;
  // run indices are 32-bit: every run and the buffers' grid strides past the last
  const long long runs = (n + elems - 1) / elems;
  if (runs + (long long)PT_VPU_DEPTH(elems) * blocks * threads >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (elems == 4)
    pt_vpu_chain_kernel<Chain, 4><<<blocks, threads, 0, s>>>(*a, n, vec);
  else
    pt_vpu_chain_kernel<Chain, 8><<<blocks, threads, 0, s>>>(*a, n, vec);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

#ifdef PT_HOST

// The kernel's walk on the host: every (block, iteration, lane) of the
// dealing, each run loaded and finished by the chain's code, a wide
// constant's column advanced as the kernel advances it.  ``cover`` (n
// ints), when given, counts the runs' elements instead of running the
// chain, and ``paths`` (n * kIns ints) records each element's path per
// input.
template <class Chain, int E>
void pt_vpu_host_walk(const PtArgs& a, long long n, int threads, int blocks, unsigned vec,
                      int* cover, int* paths) {
  using Raw = typename Chain::template Raw<E>;
  const PtVpuDeal d{n, E, threads, blocks};
  const PtGlobalSrc src{a, vec, n};
  std::vector<PtCol> cols(threads);
  for (int b = 0; b < blocks; ++b) {
    for (int t = 0; t < threads; ++t)
      cols[t] = PtCol::start(d.run(b, t, 0) * E, (long long)blocks * threads * E, Chain::kCols);
    for (long long it = 0; d.run(b, 0, it) < d.runs(); ++it) {
      for (int t = 0; t < threads; ++t) {
        const long long r = d.run(b, t, it);
        if (r < d.runs() && cover) {
          for (long long i = r * E; i < r * E + E && i < n; ++i) {
            ++cover[i];
            for (int k = 0; k < Chain::kIns; ++k)
              paths[i * Chain::kIns + k] = pt_vpu_path(d.whole(r), (vec >> k) & 1u);
          }
        } else if (r < d.runs()) {
          Raw x;
          Chain::template load<E>(x, src, r, d.whole(r), cols[t].c);
          Chain::template finish<E>(x, a.out, r, n);
        }
        cols[t].advance();
      }
    }
  }
}

template <class Chain>
int pt_vpu_host(const PtArgs& a, long long n, int threads, int elems, int blocks, unsigned vec,
                int* cover, int* paths) {
  if (!pt_vpu_config_ok(threads, elems) || blocks <= 0) return 1;
  if (n <= 0) return 0;
  if (elems == 4)
    pt_vpu_host_walk<Chain, 4>(a, n, threads, blocks, vec, cover, paths);
  else
    pt_vpu_host_walk<Chain, 8>(a, n, threads, blocks, vec, cover, paths);
  return 0;
}

#endif  // PT_HOST
