// The K-tiled subgraph kernel for Hopper (queue B #13): a single-matmul
// chain of sched_chain.cuh with its contraction split into block_k slices.
//
// Replaces the TPU kernel paddle_tpu/static/schedule_search.py:
// _build_kernel_ktiled (:773), which carries an f32 VMEM accumulator over
// a sequential K grid axis and runs the epilogue on the last K step.  The
// H100's blocks run in no order, so the split is a split-K: grid
// (gm, gn, gk), each block writes its slice's f32 partial product to a
// workspace [gk, M, N] (sched_chain.cuh's kernel with SPLIT); a second
// launch sums the partials in k order (deterministic, no atomics) and runs
// the generated epilogue once on the sum, which adds a linear's bias, as
// the TPU kernel's _epilogue_body does.  The same shape as
// decode_chain_rows with its combine launch.
//
// What it is for: parallelism where the output has few tiles (the BERT
// pooler's 32 x 768 x 768 product is 6 tiles of 128 x 128 on 132 SMs).
// What bounds it: operations, plus the workspace's 2 x gk x M x N x 4
// bytes of traffic, which the roofline ranking charges.

#pragma once

#include "sched_chain.cuh"

#ifdef __CUDACC__

namespace pt_sched {

// out element i of [M, N] from the sum of the gk partials, by element.
template <class Body>
__global__ void __launch_bounds__(kThreads) pt_combine_elem_kernel(PtArgs a, int M, int N,
                                                                   int gk) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < gk; ++k) s += a.ws[k * mn + i];
  Body::elem(a, (int)(i / N), (int)(i % N), s);
}

// The same by row (a warp a row, the row's sums in shared memory), for
// chains with a reduction or a rowwise op.
template <class Body>
__global__ void __launch_bounds__(kThreads) pt_combine_rows_kernel(PtArgs a, int M, int N,
                                                                   int gk) {
  extern __shared__ float sums[];  // [kThreads / 32][N]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= M) return;
  float* b = sums + (long long)warp * N;
  const long long mn = (long long)M * N;
  for (int c = lane; c < N; c += 32) {
    float s = 0.f;
    for (int k = 0; k < gk; ++k) s += a.ws[k * mn + (long long)row * N + c];
    b[c] = s;
  }
  __syncwarp();
  Body::template row<32>(a, row, lane, b);
}

}  // namespace pt_sched

// The matmul kind split over K in slices of bk (a.ws: gk x M x N floats).
template <class Body, int BM, int BN, bool F32>
int pt_sched_mm_ktiled_launch(const PtArgs* a, int M, int N, int K, int bk, int vec,
                              void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || bk <= 0 || a->ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int gk = (K + bk - 1) / bk;
  int err = pt_sched::launch_mm<Body, BM, BN, F32, true>(a, M, N, K, bk, gk, 0, vec, s);
  if (err != 0) return err;
  if constexpr (Body::kRowMode) {
    const int smem = pt_sched::kThreads / 32 * N * 4;
    auto kernel = pt_sched::pt_combine_rows_kernel<Body>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(M + pt_sched::kThreads / 32 - 1) / (pt_sched::kThreads / 32), pt_sched::kThreads,
             smem, s>>>(*a, M, N, gk);
  } else {
    const long long blocks = ((long long)M * N + pt_sched::kThreads - 1) / pt_sched::kThreads;
    pt_sched::pt_combine_elem_kernel<Body><<<(unsigned)blocks, pt_sched::kThreads, 0, s>>>(
        *a, M, N, gk);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
