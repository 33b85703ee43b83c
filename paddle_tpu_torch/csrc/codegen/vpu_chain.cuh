// The elementwise chain kernel for Hopper (queue B #11): every op of a
// discovered same-shape elementwise chain in registers, one pass over the
// data.  static/codegen.py writes the chain (``Chain::eval``, one element)
// and the per-thread body (``Chain::thread<E>``: load E consecutive
// elements of every input, evaluate, store) into a generated source that
// includes this header; the kernel below only places the threads.
//
// Replaces the TPU kernel paddle_tpu/static/rewrite.py:
// GenericElementwiseFusionPass._build_kernel (:804), which replays the
// recorded op fns over (rows_block, cols_block) VMEM tiles.  Here a 1-D
// grid walks the flattened elements, E of them a thread: the data is
// contiguous, so there is nothing to tile.
//
// What bounds it on this card: bytes.  An N-op chain reads each input and
// writes the output once (N torch kernels would make N round trips); its
// arithmetic is a few operations an element.  Design: E consecutive
// elements a thread, loaded and stored as 16-byte (or 8- or 4-byte)
// vectors when every pointer is 16-byte aligned and the run is whole, by
// element at the tail; no shared memory.

#pragma once

#include "pt_codegen.cuh"

// E consecutive elements of a storage-typed array from ``base``, converted
// to the compute type; a vector load when ``vec`` and the run is whole.
template <int E, class S, class T>
PT_HD void pt_load_run(T (&dst)[E], const void* src, long long base, long long n, bool vec) {
  const S* p = static_cast<const S*>(src) + base;
#ifdef __CUDA_ARCH__
  constexpr int kBytes = E * (int)sizeof(S);
  if (vec && base + E <= n && (kBytes % 16 == 0 || kBytes == 8 || kBytes == 4)) {
    alignas(16) S tmp[E];
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(tmp)[i] = reinterpret_cast<const uint4*>(p)[i];
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(tmp) = *reinterpret_cast<const uint2*>(p);
    } else {
      *reinterpret_cast<uint32_t*>(tmp) = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = pt_get(tmp[e]);
    return;
  }
#endif
  (void)vec;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = base + e < n ? pt_get(p[e]) : T();
}

template <int E, class S, class T>
PT_HD void pt_store_run(void* dst, const T (&src)[E], long long base, long long n, bool vec) {
  S* p = static_cast<S*>(dst) + base;
#ifdef __CUDA_ARCH__
  constexpr int kBytes = E * (int)sizeof(S);
  if (vec && base + E <= n && (kBytes % 16 == 0 || kBytes == 8 || kBytes == 4)) {
    alignas(16) S tmp[E];
#pragma unroll
    for (int e = 0; e < E; ++e) tmp[e] = pt_put<S>(src[e]);
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(tmp)[i];
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(tmp);
    } else {
      *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(tmp);
    }
    return;
  }
#endif
  (void)vec;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (base + e < n) p[e] = pt_put<S>(src[e]);
}

#ifdef __CUDACC__

template <class Chain, int E>
__global__ void __launch_bounds__(1024) pt_vpu_chain_kernel(PtArgs a, long long n, int vec) {
  const long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * E;
  if (base < n) Chain::template thread<E>(a, base, n, vec != 0);
}

// n elements, ``threads`` a block, E a thread; vec: every pointer is
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
template <class Chain, int E>
int pt_vpu_chain_launch(const PtArgs* a, long long n, int threads, int vec, void* stream) {
  if (n <= 0) return 0;
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)threads * E;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  pt_vpu_chain_kernel<Chain, E><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(*a, n,
                                                                                       vec);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
