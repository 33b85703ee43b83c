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
//   as csrc/matmul_epilogue.cu) or on the FMA pipes (f32: a register-
//   blocked product, 8 x 8 or 4 x 8 outputs a thread, fed by 16-byte
//   shared loads from two stages kept full by cp.async and a register
//   prefetch; no TF32), then the accumulator goes through shared memory
//   to the generated epilogue; a chain with a reduction or a rowwise op
//   gets tiles that own whole rows; grid_order is the raster of the 2-D
//   grid (which index varies fastest).
//
// What bounds it: the reduce kind by bytes (each input read once, the
// output written once); the matmul kind by operations at the repo's
// shapes (f32: the 67 TFLOP/s of the FMA pipes, which a thread's 64 FMAs
// a k for 4 shared loads can approach).  Edges are predicated everywhere,
// so every shape runs.  The split-K form (block_k, merged inside a
// cluster) is sched_chain_ktiled.cuh.

#pragma once

#include "pt_codegen.cuh"

#ifdef __CUDACC__

#include "../hopper_tiles.cuh"
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

// ------------------------------------------------------- the copy ring
//
// The bf16 product streams its operand tiles through a ring of stages in
// shared memory filled by cp.async: up to three k-steps are in flight
// while the tensor cores run on the oldest, one barrier a k-step (the f32
// product keeps two stages, below).  A copy past an edge reads nothing and
// writes zeros (src-size 0).

constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxStages = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages that leave room for two blocks an SM: between 2 and kMaxStages.
constexpr int ring_stages(int stage_bytes) {
  return kMaxSmem / 2 / stage_bytes < 2            ? 2
         : kMaxSmem / 2 / stage_bytes > kMaxStages ? kMaxStages
                                                   : kMaxSmem / 2 / stage_bytes;
}

// The ring over k-steps [0, k_tiles): load(stage, kt) issues step kt's
// copies into a stage, math(stage) runs on a whole one.  Every thread
// commits a group each step (empty past the end), so wait_group<S - 2>
// means "step kt has landed" for the thread's own copies, and the barrier
// after it for everyone's; the same barrier frees the stage of step kt - 1
// for step kt + S - 1.
template <int S, class Load, class Math>
__device__ __forceinline__ void run_ring(int k_tiles, Load load, Math math) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int next = kt + S - 1;
    if (next < k_tiles) load(next % S, next);
    cp_async_commit();
    math(kt % S);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's memory may be reused
}

// ------------------------------------------------------------ bf16 product

template <int BM, int BN>
struct Bf16Tile {
  static constexpr int kBK = BN > 1024 ? 16 : 32;  // two stages of a wide row's tiles fit
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
  static constexpr int kStageElems = BM * kLdA + kBK * kLdB;
  static constexpr int kStages = ring_stages(kStageElems * 2);
  static constexpr int kPitch = BN + 4;  // the f32 accumulator tile
  static constexpr int kStage = kStages * kStageElems * 2;
  static constexpr int kSmem = kStage > BM * kPitch * 4 ? kStage : BM * kPitch * 4;
};

// x [M, K] @ w [K, N] over k in [k0, k1) for the tile at (m0, n0); the f32
// product lands in shared memory as a [BM, kPitch] tile.  vec: 16-byte
// copies (cp.async); else each chunk is loaded and stored by the thread.
template <int BM, int BN>
__device__ __forceinline__ void bf16_product(const uint16_t* __restrict__ x, long long lda,
                                             const uint16_t* __restrict__ w, long long ldb,
                                             int M, int N, int m0, int n0, int k0, int k1,
                                             bool vec, unsigned char* smem) {
  using T = Bf16Tile<BM, BN>;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
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

  auto chunk = [&](uint16_t* dst, const uint16_t* src, long long ld, int row, int col, int rows,
                   int cols) {
    if (vec) {
      const bool in = row < rows && col < cols;
      cp_async16(dst, in ? src + (long long)row * ld + col : src, in ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst) = load_chunk(src, ld, row, col, rows, cols, false);
    }
  };
  auto load = [&](int stage, int kt) {
    uint16_t* sA = ring + stage * T::kStageElems;
    uint16_t* sB = sA + BM * T::kLdA;
    const int kk = k0 + kt * T::kBK;
    for (int c = threadIdx.x; c < T::kChunksA; c += kThreads)
      chunk(&sA[(c / (T::kBK / 8)) * T::kLdA + (c % (T::kBK / 8)) * 8], x, lda,
            m0 + c / (T::kBK / 8), kk + (c % (T::kBK / 8)) * 8, M, k1);
    for (int c = threadIdx.x; c < T::kChunksB; c += kThreads)
      chunk(&sB[(c / (BN / 8)) * T::kLdB + (c % (BN / 8)) * 8], w, ldb, kk + c / (BN / 8),
            n0 + (c % (BN / 8)) * 8, k1, N);
  };
  auto math = [&](int stage) {
    const uint16_t* sA = ring + stage * T::kStageElems;
    const uint16_t* sB = sA + BM * T::kLdA;
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
  };
  run_ring<T::kStages>(k1 > k0 ? (k1 - k0 + T::kBK - 1) / T::kBK : 0, load, math);

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
//
// A register-blocked product on the FMA pipes.  Each thread holds kTM x 8
// outputs (8 x 8 for tiles of 16,384 outputs, 4 x 8 for 8,192): rows
// g * kThM * 4 + ty * 4 + e (g < kTM / 4, e < 4) and columns g * kThN * 4 +
// tx * 4 + e (g < 2), so that a thread's column of A and row of B are read
// with 16-byte shared loads (LDS.128): kTM / 4 + 2 loads a k for kTM * 8
// FMAs.  x's tile lies in shared memory k-major ([kBK][BM + 4]): the next
// k-step's x comes into registers by 16-byte loads while the FMAs run on
// this one and is stored transposed after them; w's tile ([kBK][BN]) comes
// by 16-byte cp.async into the other of two stages; one barrier a k-step.
// Every address and edge predicate is worked out once, before the loop
// (SASS of the first version spent ~380 instructions a k-step on them, a
// quarter of the issue slots); only a last, partial k-step checks K.  Each
// output's sum runs over k in order, one fmaf a k, so a slice's partial
// equals a sequential fused sum (the host harness's).

template <int BM, int BN>
struct F32Tile {
  static constexpr int kOut = BM * BN / kThreads;  // outputs a thread
  static_assert(kOut == 32 || kOut == 64, "4 x 8 or 8 x 8 outputs a thread");
  static constexpr int kTM = kOut / 8;
  static constexpr int kTN = 8;
  static constexpr int kThN = BN / kTN;  // threads along N and along M
  static constexpr int kThM = BM / kTM;
  static_assert(kThN * kThM == kThreads && BM % kTM == 0, "a whole thread grid");
  // k-step depth: 32 (half the barriers a FMA) unless two stages of w
  // would crowd the 8 x 8 tiles at 512 columns (16) or any tile from
  // 1,024 (8); measured by tools/time_torch_sched_variants.py
  static constexpr int kBK = BN >= 1024 ? 8 : BN >= 512 && kOut == 64 ? 16 : 32;
  static constexpr int kLdA = BM + 4;  // sA[k][m]
  static constexpr int kLdB = BN;      // sB[k][n]
  static constexpr int kStageFloats = kBK * kLdA + kBK * kLdB;
  static constexpr int kChunksA = BM * kBK / 4;  // 16-byte chunks of a k-step's tiles
  static constexpr int kChunksB = kBK * BN / 4;
  static constexpr int kRegA = (kChunksA + kThreads - 1) / kThreads;
  static constexpr int kRegB = (kChunksB + kThreads - 1) / kThreads;
  static constexpr int kPitch = BN + 4;  // the f32 product tile
  static constexpr int kStages = 2;  // more measured no faster (the w copies are not the wait)
  static constexpr int kStage = kStages * kStageFloats * 4;
  static constexpr int kSmem = kStage > BM * kPitch * 4 ? kStage : BM * kPitch * 4;
};

// x [M, K] @ w [K, N] over k in [k0, k1) for the tile at (m0, n0); the f32
// product lands in shared memory as a [BM, kPitch] tile.  VEC: K, N, both
// row pitches and k0 are multiples of 4 floats and x, w 16-byte aligned;
// else each element moves on its own.
template <int BM, int BN, bool VEC>
__device__ __forceinline__ void f32_product(const float* __restrict__ x, long long lda,
                                            const float* __restrict__ w, long long ldb, int M,
                                            int N, int m0, int n0, int k0, int k1,
                                            unsigned char* smem) {
  using T = F32Tile<BM, BN>;
  float* ring = reinterpret_cast<float*>(smem);
  const int tx = threadIdx.x % T::kThN, ty = threadIdx.x / T::kThN;
  float acc[T::kTM][T::kTN];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.f;

  // x: chunk i of a thread is row ar[i] (-1 past M), k offset 4 * (c % (kBK / 4))
  const float* pa[T::kRegA];
  int sa[T::kRegA], ka[T::kRegA];  // its offset in a stage's sA (k-major); its k offset
  bool oka[T::kRegA];
#pragma unroll
  for (int i = 0; i < T::kRegA; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (T::kBK / 4);
    ka[i] = (c % (T::kBK / 4)) * 4;
    oka[i] = c < T::kChunksA && m0 + r < M;
    pa[i] = x + (long long)(oka[i] ? m0 + r : 0) * lda + k0 + ka[i];
    sa[i] = ka[i] * T::kLdA + r;
  }
  // w: chunk i of a thread is k row c / (BN / 4), columns n0 + 4 * (c % (BN / 4))
  const float* pb[T::kRegB];
  int sb[T::kRegB], kb_[T::kRegB], nb[T::kRegB];  // its offset in a stage; its k; live floats
#pragma unroll
  for (int i = 0; i < T::kRegB; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int gn = n0 + (c % (BN / 4)) * 4;
    const int live = c < T::kChunksB ? N - gn : 0;
    kb_[i] = c / (BN / 4);
    nb[i] = live <= 0 ? 0 : live < 4 ? live : 4;
    pb[i] = w + (long long)(k0 + kb_[i]) * ldb + (nb[i] ? gn : 0);
    sb[i] = T::kBK * T::kLdA + kb_[i] * T::kLdB + (c % (BN / 4)) * 4;
  }

  float4 ra[T::kRegA];
  auto fetch_a = [&](int kb) {  // x into registers
    const bool full = kb + T::kBK <= k1;
#pragma unroll
    for (int i = 0; i < T::kRegA; ++i) {
      const float* p = pa[i] + (kb - k0);
      const int gk = kb + ka[i];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (oka[i] && (full || gk < k1)) {
        if (VEC) {
          v = *reinterpret_cast<const float4*>(p);
        } else {
          v.x = p[0];
          if (full || gk + 1 < k1) v.y = p[1];
          if (full || gk + 2 < k1) v.z = p[2];
          if (full || gk + 3 < k1) v.w = p[3];
        }
      }
      ra[i] = v;
    }
  };
  auto fetch_b = [&](float* stage, int kb) {  // w by cp.async
    const bool full = kb + T::kBK <= k1;
#pragma unroll
    for (int i = 0; i < T::kRegB; ++i) {
      if (threadIdx.x + i * kThreads >= T::kChunksB) continue;
      const bool in = full || kb + kb_[i] < k1;
      const float* p = pb[i] + (long long)(kb - k0) * ldb;
      if (VEC) {
        cp_async16(stage + sb[i], in && nb[i] ? p : w, in ? 4 * nb[i] : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = in && e < nb[i];
          cp_async4(stage + sb[i] + e, ok ? p + e : w, ok ? 4 : 0);
        }
      }
    }
  };
  auto store = [&](float* stage) {  // x's registers into sA, transposed
#pragma unroll
    for (int i = 0; i < T::kRegA; ++i) {
      if (threadIdx.x + i * kThreads >= T::kChunksA) continue;
      float* p = stage + sa[i];
      p[0] = ra[i].x;
      p[T::kLdA] = ra[i].y;
      p[2 * T::kLdA] = ra[i].z;
      p[3 * T::kLdA] = ra[i].w;
    }
  };
  auto math = [&](const float* sA) {
    const float* sB = sA + T::kBK * T::kLdA;
#pragma unroll
    for (int kk = 0; kk < T::kBK; ++kk) {
      float av[T::kTM], bv[T::kTN];
#pragma unroll
      for (int g = 0; g < T::kTM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sA[kk * T::kLdA + g * T::kThM * 4 + ty * 4]);
        av[4 * g] = v.x;
        av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z;
        av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&sB[kk * T::kLdB + g * T::kThN * 4 + tx * 4]);
        bv[4 * g] = v.x;
        bv[4 * g + 1] = v.y;
        bv[4 * g + 2] = v.z;
        bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T::kTM; ++i)
#pragma unroll
        for (int j = 0; j < T::kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };

  // a ring of kStages: w's k-steps kt + 1 .. kt + kStages - 1 in flight by
  // cp.async (one commit group a step, empty past the end) and x's step
  // kt + 1 in registers while the FMAs run on step kt
  constexpr int S = T::kStages;
  auto slot = [&](int kt) { return ring + (kt % S) * T::kStageFloats; };
  const int k_tiles = k1 > k0 ? (k1 - k0 + T::kBK - 1) / T::kBK : 0;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < k_tiles) fetch_b(slot(st), k0 + st * T::kBK);
    cp_async_commit();
  }
  if (k_tiles > 0) {
    fetch_a(k0);
    store(slot(0));
  }
  cp_async_wait<S - 2>();
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const bool more = kt + 1 < k_tiles;
    if (more) fetch_a(k0 + (kt + 1) * T::kBK);
    if (kt + S - 1 < k_tiles) fetch_b(slot(kt + S - 1), k0 + (kt + S - 1) * T::kBK);
    cp_async_commit();
    math(slot(kt));
    if (more) store(slot(kt + 1));
    cp_async_wait<S - 2>();
    __syncthreads();  // step kt + 1 is whole; step kt's slot may be refilled
  }
  cp_async_wait<0>();

  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int r = (i / 4) * T::kThM * 4 + ty * 4 + (i % 4);
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(&tile[r * T::kPitch + g * T::kThN * 4 + tx * 4]) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
  }
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

// The generated epilogue over rows [r0, r1) of a [BM, pitch] f32 product
// tile: by row (a warp a row; the tile owns whole rows) or by element.
template <class Body, int BM, int BN, int P>
__device__ __forceinline__ void tile_epilogue(const PtArgs& a, const float* tile, int M, int N,
                                              int m0, int n0, int r0, int r1) {
  if constexpr (Body::kRowMode) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = r0 + warp; r < r1; r += kThreads / 32)
      if (m0 + r < M) Body::template row<32>(a, m0 + r, lane, tile + r * P);
  } else {
    for (int i = threadIdx.x; i < (r1 - r0) * BN; i += kThreads) {
      const int r = r0 + i / BN, c = i % BN;
      if (m0 + r < M && n0 + c < N) Body::elem(a, m0 + r, n0 + c, tile[r * P + c]);
    }
  }
}

// The split-K merge inside a cluster of gk blocks along K (one launch, no
// workspace): every block holds its slice's f32 partial tile in its own
// shared memory; after a cluster barrier, rank q sums rows [r0, r1) (a
// 1 / gk share of the tile) of every rank's partial, read through
// distributed shared memory, in rank (k) order, and keeps the sums in its
// own tile, where no other block reads; a second cluster barrier keeps
// every block alive until the others have read it.  Every thread of every
// block reaches both barriers.
template <int BM, int BN, int P>
__device__ __forceinline__ void cluster_merge(float* tile, int gk, int M, int N, int m0, int n0,
                                              int r0, int r1) {
  paddle_hopper::cluster_sync();  // every partial tile is whole
  const int live = N - n0 < BN ? N - n0 : BN;
  const int cols4 = (live + 3) / 4;
  const int rows = (M - m0 < r1 ? M - m0 : r1) - r0;
  for (int i = threadIdx.x; i < rows * cols4; i += kThreads) {
    float* p = tile + (r0 + i / cols4) * P + (i % cols4) * 4;
    float4 s = paddle_hopper::ld_dsmem_f32x4(p, 0);
    for (int q = 1; q < gk; ++q) {
      const float4 v = paddle_hopper::ld_dsmem_f32x4(p, (uint32_t)q);
      s.x = s.x + v.x;
      s.y = s.y + v.y;
      s.z = s.z + v.z;
      s.w = s.w + v.w;
    }
    *reinterpret_cast<float4*>(p) = s;
  }
  paddle_hopper::cluster_sync();  // the reads are done; the sums are the block's
}

// One tile of the product, then the epilogue.  SPLIT false: grid (gm, gn)
// in the raster cols_first picks, the whole K.  SPLIT true: grid (gk, gm,
// gn) in clusters of (gk, 1, 1), block x the k slice [k_len * x, ...), the
// slices merged by cluster_merge, each rank running the epilogue on its
// share of the rows.
template <class Body, int BM, int BN, bool F32, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
pt_sched_mm_kernel(PtArgs a, int M, int N, int K, int k_len, int cols_first, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = typename Tile<BM, BN, F32>::type;
  int bm, bn, kz;
  if constexpr (SPLIT) {
    kz = blockIdx.x;
    bm = blockIdx.y;
    bn = blockIdx.z;
  } else {
    kz = 0;
    bm = cols_first ? blockIdx.y : blockIdx.x;
    bn = cols_first ? blockIdx.x : blockIdx.y;
  }
  const int m0 = bm * BM, n0 = bn * BN;
  const int k0 = kz * k_len;
  const int k1 = min(K, k0 + k_len);
  const int xi = Body::kX, wi = Body::kW;
  if constexpr (F32) {
    const float* x = static_cast<const float*>(a.in[xi]);
    const float* w = static_cast<const float*>(a.in[wi]);
    if (vec)
      f32_product<BM, BN, true>(x, a.ld[xi], w, a.ld[wi], M, N, m0, n0, k0, k1, smem);
    else
      f32_product<BM, BN, false>(x, a.ld[xi], w, a.ld[wi], M, N, m0, n0, k0, k1, smem);
  } else {
    bf16_product<BM, BN>(static_cast<const uint16_t*>(a.in[xi]), a.ld[xi],
                         static_cast<const uint16_t*>(a.in[wi]), a.ld[wi], M, N, m0, n0, k0, k1,
                         vec != 0, smem);
  }
  float* tile = reinterpret_cast<float*>(smem);
  int r0 = 0, r1 = BM;
  if constexpr (SPLIT) {
    const int gk = gridDim.x;
    const int per = (BM + gk - 1) / gk;
    r0 = kz * per < BM ? kz * per : BM;
    r1 = r0 + per < BM ? r0 + per : BM;
    cluster_merge<BM, BN, T::kPitch>(tile, gk, M, N, m0, n0, r0, r1);
  }
  tile_epilogue<Body, BM, BN, T::kPitch>(a, tile, M, N, m0, n0, r0, r1);
}

template <class Body, int BM, int BN, bool F32, bool SPLIT>
int launch_mm(const PtArgs* a, int M, int N, int K, int k_len, int gk, int cols_first, int vec,
              cudaStream_t s) {
  using T = typename Tile<BM, BN, F32>::type;
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  auto kernel = pt_sched_mm_kernel<Body, BM, BN, F32, SPLIT>;
  if (T::kSmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  if constexpr (!SPLIT) {
    const dim3 grid(cols_first ? gn : gm, cols_first ? gm : gn, 1);
    kernel<<<grid, kThreads, T::kSmem, s>>>(*a, M, N, K, k_len, cols_first, vec);
    return (int)cudaGetLastError();
  } else {
    if (gm > 65535 || gn > 65535) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(gk, gm, gn);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = T::kSmem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = gk;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *a, M, N, K, k_len, 0, vec);
    if (err == cudaSuccess) err = cudaGetLastError();
    return (int)err;
  }
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
// launch.  vec: K, N and both row pitches are multiples of 8 (bf16) or 4
// (f32) elements and x, w 16-byte aligned.
template <class Body, int BM, int BN, bool F32>
int pt_sched_mm_launch(const PtArgs* a, int M, int N, int K, int cols_first, int vec,
                       void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  return pt_sched::launch_mm<Body, BM, BN, F32, false>(a, M, N, K, K > 0 ? K : 1, 1, cols_first,
                                                       vec, (cudaStream_t)stream);
}

#endif  // __CUDACC__
