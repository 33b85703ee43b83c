// The K-tiled subgraph kernel for Hopper (queue B #13): a single-matmul
// chain of sched_chain.cuh with its contraction split into block_k slices.
//
// Replaces the TPU kernel paddle_tpu/static/schedule_search.py:
// _build_kernel_ktiled (:773), which carries an f32 VMEM accumulator over
// a sequential K grid axis and runs the epilogue on the last K step.  The
// H100's blocks run in no order, so the split is a split-K merged inside a
// thread-block cluster, in one launch: grid (gk, gm, gn) in clusters of
// (gk, 1, 1); each block of a cluster computes its slice's f32 partial
// tile into its own shared memory, then rank r sums a 1 / gk share of the
// tile's rows from every rank's shared memory through distributed shared
// memory, in k order (deterministic, no atomics, no workspace), and runs
// the generated epilogue on those rows (Body::elem, or Body::row for a
// reducing chain, whose tile owns whole rows), which adds a linear's bias
// once, as the TPU kernel's _epilogue_body does (sched_chain.cuh:
// cluster_merge).
//
// What it is for: parallelism where the output has few tiles (the BERT
// pooler's 32 x 768 x 768 product is 6 tiles of 32 x 128 on 132 SMs).
// What bounds it: operations; x is re-read for each column block and w for
// each row block.  gk is at most 8, the portable cluster size.

#pragma once

#include "sched_chain.cuh"

#ifdef __CUDACC__

// The matmul kind split over K in slices of bk (gk = ceil(K / bk) <= 8
// blocks a cluster).
template <class Body, int BM, int BN, bool F32>
int pt_sched_mm_ktiled_launch(const PtArgs* a, int M, int N, int K, int bk, int vec,
                              void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || bk <= 0) return (int)cudaErrorInvalidValue;
  const int gk = (K + bk - 1) / bk;
  if (gk > 8) return (int)cudaErrorInvalidValue;
  return pt_sched::launch_mm<Body, BM, BN, F32, true>(a, M, N, K, bk, gk, 0, vec,
                                                      (cudaStream_t)stream);
}

#endif  // __CUDACC__
