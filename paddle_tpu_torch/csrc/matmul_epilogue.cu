// The matmul epilogue for Hopper (sm_90a): out = act(x @ w + bias) with an
// f32 accumulator; the bias and the activation run on the accumulator in
// registers before the single store, so the [M, N] pre-activation never
// goes to device memory.
//
// Replaces the TPU kernel paddle_tpu/ops/matmul_epilogue.py:_kernel (:40),
// which accumulates in a VMEM scratch over a sequential K grid axis and
// applies the epilogue on the last K step.  Here one block owns a 128 x 128
// output tile and loops over K itself (blocks run in parallel, in no order,
// so nothing carries over between them), and the epilogue follows the loop.
//
// What bounds it on this card: operations.  The BERT-base FFN product
// [4096, 768] x [768, 3072] does 19.3 GFLOP on 11 MB of operands, about
// 1,800 operations per byte against the H100's ~295: tensor cores.  Design:
// bf16 and f16 operands on the tensor cores with mma.sync m16n8k16 (.bf16
// or .f16 in, f32 accumulate, the helpers of mma_tiles.cuh), eight warps of 64 x 32 outputs
// each; a 32-deep K tile of x and w staged in padded shared memory
// (conflict-free fragment reads; w's fragments come transposed through
// ldmatrix.trans), the next K tile loaded into registers while the current
// one is multiplied.  Every M, K and N runs the kernel: edge tiles are
// predicated and zero-filled, and shapes whose rows are not 16-byte
// aligned take element loads instead of 16-byte ones.  f32 operands run on
// plain FMA (a 64 x 64 tile, 4 x 4 outputs a thread), as prefill_chain does.
// This is the general route: bf16 and f16 whose rows TMA can read take
// matmul_epilogue_sm90.cu (TMA + wgmma); ops/matmul_epilogue.py:_route
// picks before any launch, and this kernel takes the rest (f32, rows that
// are not 16-byte multiples, unaligned bases).
//
// The activations are matmul_act.cuh's, shared with the sm90 kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "matmul_act.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace paddle_epilogue;
using paddle_tiles::ld32;
using paddle_tiles::mma_16816;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---------------------------------------------------------------------------
// bf16 and f16 on the tensor cores (F16 picks the type).

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int kLdA = kBK + 8;    // x tile pitch (80 bytes: conflict-free fragment reads)
constexpr int kLdB = kBN + 8;    // w tile pitch (272 bytes: conflict-free ldmatrix)
constexpr int kChunksA = kBM * kBK / 8 / kThreads;  // 16-byte chunks a thread loads
constexpr int kChunksB = kBK * kBN / 8 / kThreads;

// One 8-element row chunk at (row, col) of a [rows, cols] matrix with row
// pitch ld, zero past the edges.  VEC: cols and ld are multiples of 8 and
// the base is 16-byte aligned, so an in-bounds chunk is one 16-byte load.
template <bool VEC>
__device__ __forceinline__ uint4 load_chunk(const uint16_t* __restrict__ src, int64_t ld,
                                            int row, int col, int rows, int cols) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return val;
  const uint16_t* p = src + (int64_t)row * ld + col;
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    uint16_t e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = col + i < cols ? p[i] : (uint16_t)0;
    val.x = e[0] | ((uint32_t)e[1] << 16);
    val.y = e[2] | ((uint32_t)e[3] << 16);
    val.z = e[4] | ((uint32_t)e[5] << 16);
    val.w = e[6] | ((uint32_t)e[7] << 16);
    return val;
  }
}

template <bool F16, bool VEC>
__global__ void __launch_bounds__(kThreads)
matmul_epilogue_16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                     const uint16_t* __restrict__ bias, uint16_t* __restrict__ out, int M,
                     int N, int K, int64_t lda, int64_t ldb, int64_t ldo, int act) {
  __shared__ __align__(16) uint16_t sA[kBM * kLdA];
  __shared__ __align__(16) uint16_t sB[kBK * kLdB];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;  // the warp's rows in the tile
  const int wn = (warp & 3) * 32;   // the warp's columns in the tile

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  uint4 ra[kChunksA], rb[kChunksB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kChunksA; ++i) {
      const int c = threadIdx.x + i * kThreads;
      ra[i] = load_chunk<VEC>(x, lda, m0 + c / (kBK / 8), k0 + (c % (kBK / 8)) * 8, M, K);
    }
#pragma unroll
    for (int i = 0; i < kChunksB; ++i) {
      const int c = threadIdx.x + i * kThreads;
      rb[i] = load_chunk<VEC>(w, ldb, k0 + c / (kBN / 8), n0 + (c % (kBN / 8)) * 8, K, N);
    }
  };

  const int k_tiles = (K + kBK - 1) / kBK;
  if (k_tiles > 0) fetch(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
#pragma unroll
    for (int i = 0; i < kChunksA; ++i) {
      const int c = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(&sA[(c / (kBK / 8)) * kLdA + (c % (kBK / 8)) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kChunksB; ++i) {
      const int c = threadIdx.x + i * kThreads;
      *reinterpret_cast<uint4*>(&sB[(c / (kBN / 8)) * kLdB + (c % (kBN / 8)) * 8]) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < k_tiles) fetch((kt + 1) * kBK);  // in flight during the products

#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint16_t* a = &sA[(wm + mt * 16 + g) * kLdA + ks * 16 + t * 2];
        af[mt][0] = ld32(a);
        af[mt][1] = ld32(a + 8 * kLdA);
        af[mt][2] = ld32(a + 8);
        af[mt][3] = ld32(a + 8 * kLdA + 8);
      }
      uint32_t bf[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, &sB[krow * kLdB + wn + p * 16 + (lane >> 4) * 8]);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_16816<F16>(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();  // the next tile overwrites sA / sB
  }

  // the epilogue on the accumulator: bias, activation, one rounding, one store
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn + nt * 8 + t * 2 + j;
      if (col >= N) continue;
      const float b = bias != nullptr ? paddle_tiles::to_float<F16>(bias[col]) : 0.f;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mt * 16 + g + h * 8;
          if (row >= M) continue;
          const float v = activate(acc[mt][nt][h * 2 + j] + b, act);
          out[(int64_t)row * ldo + col] = paddle_tiles::round16<F16>(v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on plain FMA.

constexpr int kFT = 64;   // output tile edge
constexpr int kFK = 16;   // K tile depth

__global__ void __launch_bounds__(256)
matmul_epilogue_f32(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int M, int N,
                    int K, int64_t lda, int64_t ldb, int64_t ldo, int act) {
  __shared__ float sA[kFK][kFT + 4];  // x tile, transposed: [k][m]
  __shared__ float sB[kFK][kFT + 4];  // w tile: [k][n]
  const int m0 = blockIdx.x * kFT;
  const int n0 = blockIdx.y * kFT;
  const int tx = threadIdx.x % 16;  // 4 columns each
  const int ty = threadIdx.x / 16;  // 4 rows each
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int i = threadIdx.x; i < kFT * kFK; i += 256) {
      const int r = i / kFK, kk = i % kFK;
      const int row = m0 + r, k = k0 + kk;
      sA[kk][r] = row < M && k < K ? x[(int64_t)row * lda + k] : 0.f;
      const int kb = i / kFT, c = i % kFT;
      const int kr = k0 + kb, col = n0 + c;
      sB[kb][c] = kr < K && col < N ? w[(int64_t)kr * ldb + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sA[kk][ty * 4 + i];
        b[i] = sB[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      const float b = bias != nullptr ? bias[col] : 0.f;
      out[(int64_t)row * ldo + col] = activate(acc[i][j] + b, act);
    }
  }
}

}  // namespace

// out [M, N] = act(x [M, K] @ w [K, N] + bias [N]) on `stream`; row pitches
// in elements, unit column strides; bias may be null; act 0 none, 1 relu,
// 2 gelu, 3 gelu_tanh, 4 silu; dtype of the operands, bias and output: 0
// bf16, 1 f16, 2 f32.
// Returns cudaGetLastError() after the launch (0 when accepted), or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int paddle_matmul_epilogue(const void* x, const void* w, const void* bias, void* out,
                                      int M, int N, int K, long long lda, long long ldb,
                                      long long ldo, int act, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < kNone || act > kSilu || lda < K || ldb < N ||
      ldo < N || dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    const dim3 grid((M + kFT - 1) / kFT, (N + kFT - 1) / kFT);
    matmul_epilogue_f32<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), M, N, K, lda, ldb, ldo, act);
    return (int)cudaGetLastError();
  }
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  const bool vec = K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* wb = static_cast<const uint16_t*>(w);
  const auto* bb = static_cast<const uint16_t*>(bias);
  auto* ob = static_cast<uint16_t*>(out);
  if (dtype == 1) {
    if (vec) {
      matmul_epilogue_16<true, true><<<grid, kThreads, 0, s>>>(xb, wb, bb, ob, M, N, K, lda, ldb,
                                                               ldo, act);
    } else {
      matmul_epilogue_16<true, false><<<grid, kThreads, 0, s>>>(xb, wb, bb, ob, M, N, K, lda,
                                                                ldb, ldo, act);
    }
  } else if (vec) {
    matmul_epilogue_16<false, true><<<grid, kThreads, 0, s>>>(xb, wb, bb, ob, M, N, K, lda, ldb,
                                                              ldo, act);
  } else {
    matmul_epilogue_16<false, false><<<grid, kThreads, 0, s>>>(xb, wb, bb, ob, M, N, K, lda, ldb,
                                                               ldo, act);
  }
  return (int)cudaGetLastError();
}
