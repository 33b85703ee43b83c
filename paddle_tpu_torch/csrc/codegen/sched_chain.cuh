// The schedule-searched subgraph kernels for Hopper (queue B #12): a
// reduction- or matmul-rooted subgraph of a static Program at a searched
// tiling, one pass over the data.  static/codegen.py writes the subgraph's
// body into a generated source that includes this header: ``Body::row``
// (one row: the row's values spread over LANES lanes, reductions and the
// rowwise ops by warp shuffles) and, for matmul chains without a
// reduction, ``Body::elem`` (one output element).  Every candidate config
// of a subgraph is instantiated in that one translation unit.
//
// Replaces the TPU kernel paddle_tpu/static/schedule_search.py:
// build_kernel (:883), which replays the recorded op fns over
// (block_rows, block_cols) VMEM blocks.  The config keys keep their names
// with Hopper meanings:
// - reduce kind: one warp a row, block_rows rows (warps) a block; a row
//   stays in registers (cols / 32 values a lane for each row value);
// - matmul kind: block_rows x block_cols is the block's output tile, the
//   product on the tensor cores (bf16: mma.sync m16n8k16, f32 accumulate,
//   as csrc/matmul_epilogue.cu) or on FMA (f32), then the accumulator
//   goes through shared memory to the generated epilogue; a chain with a
//   reduction or a rowwise op gets tiles that own whole rows; grid_order
//   is the raster of the 2-D grid (which index varies fastest).
//
// What bounds it: the reduce kind by bytes (each input read once, the
// output written once); the matmul kind by operations at the repo's
// shapes.  Edges are predicated everywhere, so every shape runs.  The
// split-K form (block_k) is sched_chain_ktiled.cuh.

#pragma once

#include "pt_codegen.cuh"

#ifdef __CUDACC__

#include "../mma_tiles.cuh"

namespace pt_sched {

using paddle_tiles::ld32;
using paddle_tiles::mma_bf16_16816;

constexpr int kThreads = 256;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 8 bf16 values at (row, col) of a [rows, cols] matrix of pitch ld, zero
// past the edges; vec: cols and ld are multiples of 8 and the base is
// 16-byte aligned, so an in-bounds chunk is one 16-byte load.
__device__ __forceinline__ uint4 load_chunk(const uint16_t* __restrict__ src, long long ld,
                                            int row, int col, int rows, int cols, bool vec) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows || col >= cols) return val;
  const uint16_t* p = src + (long long)row * ld + col;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint16_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = col + i < cols ? p[i] : (uint16_t)0;
  val.x = e[0] | ((uint32_t)e[1] << 16);
  val.y = e[2] | ((uint32_t)e[3] << 16);
  val.z = e[4] | ((uint32_t)e[5] << 16);
  val.w = e[6] | ((uint32_t)e[7] << 16);
  return val;
}

// ------------------------------------------------------------ bf16 product

template <int BM, int BN>
struct Bf16Tile {
  static constexpr int kBK = 32;
  static constexpr int kWarpsM = BM >= 32 ? 2 : 1;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;
  static constexpr int kWN = BN / kWarpsN;
  static constexpr int kMT = kWM / 16;
  static constexpr int kNT = kWN / 8;
  static_assert(kWM % 16 == 0 && kWN % 16 == 0, "a warp's tile is whole 16 x 16 blocks");
  static constexpr int kLdA = kBK + 8;  // pitches: conflict-free fragment reads
  static constexpr int kLdB = BN + 8;
  static constexpr int kChunksA = BM * kBK / 8;
  static constexpr int kChunksB = kBK * BN / 8;
  static constexpr int kRegA = (kChunksA + kThreads - 1) / kThreads;
  static constexpr int kRegB = (kChunksB + kThreads - 1) / kThreads;
  static constexpr int kPitch = BN + 4;  // the f32 accumulator tile
  static constexpr int kStage = (BM * kLdA + kBK * kLdB) * 2;
  static constexpr int kSmem = kStage > BM * kPitch * 4 ? kStage : BM * kPitch * 4;
};

// x [M, K] @ w [K, N] over k in [k0, k1) for the tile at (m0, n0); the f32
// product lands in shared memory as a [BM, kPitch] tile.
template <int BM, int BN>
__device__ __forceinline__ void bf16_product(const uint16_t* __restrict__ x, long long lda,
                                             const uint16_t* __restrict__ w, long long ldb,
                                             int M, int N, int m0, int n0, int k0, int k1,
                                             bool vec, unsigned char* smem) {
  using T = Bf16Tile<BM, BN>;
  uint16_t* sA = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sB = sA + BM * T::kLdA;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / T::kWarpsN) * T::kWM;
  const int wn = (warp % T::kWarpsN) * T::kWN;

  float acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  uint4 ra[T::kRegA], rb[T::kRegB];
  auto fetch = [&](int kk) {
#pragma unroll
    for (int i = 0; i < T::kRegA; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < T::kChunksA)
        ra[i] = load_chunk(x, lda, m0 + c / (T::kBK / 8), kk + (c % (T::kBK / 8)) * 8, M, k1, vec);
    }
#pragma unroll
    for (int i = 0; i < T::kRegB; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < T::kChunksB)
        rb[i] = load_chunk(w, ldb, kk + c / (BN / 8), n0 + (c % (BN / 8)) * 8, k1, N, vec);
    }
  };

  const int k_tiles = k1 > k0 ? (k1 - k0 + T::kBK - 1) / T::kBK : 0;
  if (k_tiles > 0) fetch(k0);
  for (int kt = 0; kt < k_tiles; ++kt) {
#pragma unroll
    for (int i = 0; i < T::kRegA; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < T::kChunksA)
        *reinterpret_cast<uint4*>(&sA[(c / (T::kBK / 8)) * T::kLdA + (c % (T::kBK / 8)) * 8]) =
            ra[i];
    }
#pragma unroll
    for (int i = 0; i < T::kRegB; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < T::kChunksB)
        *reinterpret_cast<uint4*>(&sB[(c / (BN / 8)) * T::kLdB + (c % (BN / 8)) * 8]) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < k_tiles) fetch(k0 + (kt + 1) * T::kBK);  // in flight during the products

#pragma unroll
    for (int ks = 0; ks < T::kBK / 16; ++ks) {
      uint32_t af[T::kMT][4];
#pragma unroll
      for (int mt = 0; mt < T::kMT; ++mt) {
        const uint16_t* p = &sA[(wm + mt * 16 + g) * T::kLdA + ks * 16 + t * 2];
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * T::kLdA);
        af[mt][2] = ld32(p + 8);
        af[mt][3] = ld32(p + 8 * T::kLdA + 8);
      }
#pragma unroll
      for (int p = 0; p < T::kNT / 2; ++p) {
        uint32_t r[4];
        const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(r, &sB[krow * T::kLdB + wn + p * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < T::kMT; ++mt) {
          mma_bf16_16816(acc[mt][2 * p], af[mt], r[0], r[1]);
          mma_bf16_16816(acc[mt][2 * p + 1], af[mt], r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sA / sB
  }

  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < T::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(wm + mt * 16 + g + (e >> 1) * 8) * T::kPitch + wn + nt * 8 + t * 2 + (e & 1)] =
            acc[mt][nt][e];
  __syncthreads();
}

// ------------------------------------------------------------- f32 product

template <int BM, int BN>
struct F32Tile {
  static constexpr int kFK = 16;
  static constexpr int kTM = BM / 16;  // a 16 x 16 thread grid, kTM x kTN outputs a thread
  static constexpr int kTN = BN / 16;
  static_assert(BM % 16 == 0 && BN % 16 == 0, "whole 16 x 16 thread grids");
  static constexpr int kLdA = BM + 4;
  static constexpr int kLdB = BN + 4;
  static constexpr int kPitch = BN + 4;
  static constexpr int kStage = (kFK * kLdA + kFK * kLdB) * 4;
  static constexpr int kSmem = kStage > BM * kPitch * 4 ? kStage : BM * kPitch * 4;
};

template <int BM, int BN>
__device__ __forceinline__ void f32_product(const float* __restrict__ x, long long lda,
                                            const float* __restrict__ w, long long ldb, int M,
                                            int N, int m0, int n0, int k0, int k1,
                                            unsigned char* smem) {
  using T = F32Tile<BM, BN>;
  float* sA = reinterpret_cast<float*>(smem);  // [kFK][kLdA]: x transposed
  float* sB = sA + T::kFK * T::kLdA;           // [kFK][kLdB]
  const int tx = threadIdx.x % 16;             // columns tx + 16 j
  const int ty = threadIdx.x / 16;             // rows ty + 16 i
  float acc[T::kTM][T::kTN];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.f;
  for (int kb = k0; kb < k1; kb += T::kFK) {
    for (int i = threadIdx.x; i < BM * T::kFK; i += kThreads) {
      const int r = i / T::kFK, kk = i % T::kFK;
      sA[kk * T::kLdA + r] =
          m0 + r < M && kb + kk < k1 ? x[(long long)(m0 + r) * lda + kb + kk] : 0.f;
    }
    for (int i = threadIdx.x; i < T::kFK * BN; i += kThreads) {
      const int kk = i / BN, c = i % BN;
      sB[kk * T::kLdB + c] =
          kb + kk < k1 && n0 + c < N ? w[(long long)(kb + kk) * ldb + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T::kFK; ++kk) {
      float av[T::kTM], bv[T::kTN];
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) av[i] = sA[kk * T::kLdA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) bv[j] = sB[kk * T::kLdB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < T::kTM; ++i)
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) tile[(ty + 16 * i) * T::kPitch + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

template <int BM, int BN, bool F32>
struct Tile {
  using type = Bf16Tile<BM, BN>;
};
template <int BM, int BN>
struct Tile<BM, BN, true> {
  using type = F32Tile<BM, BN>;
};

// The generated epilogue over a [BM, pitch] f32 product tile: by row (a
// warp a row; the tile owns whole rows) or by element.
template <class Body, int BM, int BN, int P>
__device__ __forceinline__ void tile_epilogue(const PtArgs& a, const float* tile, int M, int N,
                                              int m0, int n0) {
  if constexpr (Body::kRowMode) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < BM; r += kThreads / 32)
      if (m0 + r < M) Body::template row<32>(a, m0 + r, lane, tile + r * P);
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (m0 + r < M && n0 + c < N) Body::elem(a, m0 + r, n0 + c, tile[r * P + c]);
    }
  }
}

// One tile of the product over k in [k_len * blockIdx.z, ...), then the
// epilogue (SPLIT false) or the raw f32 partial into a.ws[blockIdx.z]
// (SPLIT true, summed by sched_chain_ktiled.cuh's combine launch).
template <class Body, int BM, int BN, bool F32, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
pt_sched_mm_kernel(PtArgs a, int M, int N, int K, int k_len, int cols_first, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = typename Tile<BM, BN, F32>::type;
  const int bm = cols_first ? blockIdx.y : blockIdx.x;
  const int bn = cols_first ? blockIdx.x : blockIdx.y;
  const int m0 = bm * BM, n0 = bn * BN;
  const int k0 = blockIdx.z * k_len;
  const int k1 = min(K, k0 + k_len);
  const int xi = Body::kX, wi = Body::kW;
  if constexpr (F32) {
    f32_product<BM, BN>(static_cast<const float*>(a.in[xi]), a.ld[xi],
                        static_cast<const float*>(a.in[wi]), a.ld[wi], M, N, m0, n0, k0, k1, smem);
  } else {
    bf16_product<BM, BN>(static_cast<const uint16_t*>(a.in[xi]), a.ld[xi],
                         static_cast<const uint16_t*>(a.in[wi]), a.ld[wi], M, N, m0, n0, k0, k1,
                         vec != 0, smem);
  }
  const float* tile = reinterpret_cast<const float*>(smem);
  if constexpr (SPLIT) {
    float* ws = a.ws + (long long)blockIdx.z * M * N;
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (m0 + r < M && n0 + c < N) ws[(long long)(m0 + r) * N + n0 + c] = tile[r * T::kPitch + c];
    }
  } else {
    tile_epilogue<Body, BM, BN, T::kPitch>(a, tile, M, N, m0, n0);
  }
}

template <class Body, int BM, int BN, bool F32, bool SPLIT>
int launch_mm(const PtArgs* a, int M, int N, int K, int k_len, int gk, int cols_first, int vec,
              cudaStream_t s) {
  using T = typename Tile<BM, BN, F32>::type;
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  const dim3 grid(cols_first ? gn : gm, cols_first ? gm : gn, gk);
  auto kernel = pt_sched_mm_kernel<Body, BM, BN, F32, SPLIT>;
  if (T::kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, T::kSmem, s>>>(*a, M, N, K, k_len, cols_first, vec);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- the reduce kind

template <class Body>
__global__ void __launch_bounds__(1024) pt_sched_rows_kernel(PtArgs a, long long rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row < rows) Body::template row<32>(a, row, threadIdx.x & 31, nullptr);
}

}  // namespace pt_sched

// rows of the subgraph, ``warps`` rows (one warp each) a block.
template <class Body>
int pt_sched_rows_launch(const PtArgs* a, long long rows, int warps, void* stream) {
  if (rows <= 0) return 0;
  if (warps <= 0 || warps > 32) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  pt_sched::pt_sched_rows_kernel<Body>
      <<<(unsigned)blocks, warps * 32, 0, (cudaStream_t)stream>>>(*a, rows);
  return (int)cudaGetLastError();
}

// The matmul kind, whole K: x [M, K] @ w [K, N] and the epilogue in one
// launch.  vec: K, N and both row pitches are multiples of 8 and x, w
// 16-byte aligned (bf16 only).
template <class Body, int BM, int BN, bool F32>
int pt_sched_mm_launch(const PtArgs* a, int M, int N, int K, int cols_first, int vec,
                       void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  return pt_sched::launch_mm<Body, BM, BN, F32, false>(a, M, N, K, K > 0 ? K : 1, 1, cols_first,
                                                       vec, (cudaStream_t)stream);
}

#endif  // __CUDACC__
