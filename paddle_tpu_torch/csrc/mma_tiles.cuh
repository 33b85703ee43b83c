// Tile helpers shared by the kernels written for Hopper
// (flash_attention_fwd.cu, flash_attention_fwd_sm90.cu,
// flash_attention_bwd.cu, decode_chain.cu, matmul_epilogue.cu): the bf16
// and f16 tensor-core products of one warp (mma.sync m16n8k16, f32
// accumulate), fragment packing, and the copies of a strided row block
// into a padded shared tile.  Header only; each source that includes it is
// built into its own library (ops/_cuda_build.py hashes this file too).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace paddle_tiles {

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16_16816(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The product of 16-bit operands: f16 when F16, else bf16.
template <bool F16>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (F16) {
    mma_f16_16816(d, a, b0, b1);
  } else {
    mma_bf16_16816(d, a, b0, b1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to the 16-bit type (f16 when F16, else bf16), lo in
// the low half.
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// One float rounded to the 16-bit type, as its bits.
template <bool F16>
__device__ __forceinline__ uint16_t round16(float x) {
  return F16 ? __half_as_ushort(__float2half_rn(x)) : __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <bool F16>
__device__ __forceinline__ float to_float(uint16_t bits) {
  return F16 ? __half2float(__ushort_as_half(bits)) : __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + ROWS) of a [rows, H] strided bf16 matrix into a
// shared tile of pitch H + 8 (conflict-free fragment reads), THREADS
// threads taking 16-byte chunks; rows at or past `rows` are zero-filled.
template <int H, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src, int64_t stride,
                                          int row0, int rows) {
  constexpr int kLd = H + 8;
  constexpr int kChunks = H / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + col) = val;
  }
}

// Eight 16-bit elements (row, col .. col + 7) of a [rows, h] strided
// matrix by element loads, zeros past the edges.  Out of line: the layouts
// that need it are rare, and inlined it would sit in every hot loop.
__device__ __noinline__ uint4 load_chunk_elements(const uint16_t* src, int64_t s_row,
                                                  int64_t s_h, int row, int rows, int col,
                                                  int h) {
  uint16_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    e[j] = row < rows && col + j < h ? src[(int64_t)row * s_row + (int64_t)(col + j) * s_h]
                                     : (uint16_t)0;
  }
  return make_uint4(e[0] | ((uint32_t)e[1] << 16), e[2] | ((uint32_t)e[3] << 16),
                    e[4] | ((uint32_t)e[5] << 16), e[6] | ((uint32_t)e[7] << 16));
}

// Copy rows [row0, row0 + ROWS) of a [rows, h] strided 16-bit matrix
// (row stride s_row, column stride s_h, in elements) into columns
// [0, COLS) of a shared tile of pitch LD; rows at or past `rows` and
// columns at or past h (h <= COLS) are zero-filled, so a product over
// all COLS columns equals one over h.  vec: s_h == 1, h and s_row
// multiples of 8 and a 16-byte aligned base, so a chunk is one 16-byte
// load; else element loads.
template <int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_rows_strided(uint16_t* dst, const uint16_t* src,
                                                  int64_t s_row, int64_t s_h, int row0,
                                                  int rows, int h, bool vec) {
  constexpr int kChunks = COLS / 8;
  constexpr int kPer = ROWS * kChunks / THREADS;  // 16-byte chunks a thread copies
  constexpr int kBatch = kPer < 8 ? kPer : 8;     // in flight at once (registers)
  static_assert(ROWS * kChunks % THREADS == 0 && kPer % kBatch == 0,
                "the tile is not a whole number of batches of chunks");
  // a batch's loads are all issued before its first store (the branch on
  // vec stays outside the unrolled loops), so their latencies overlap
#pragma unroll
  for (int i0 = 0; i0 < kPer; i0 += kBatch) {
    uint4 val[kBatch];
    if (vec) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = threadIdx.x + (i0 + i) * THREADS;
        const int r = c / kChunks;
        const int col = (c % kChunks) * 8;
        val[i] = row0 + r < rows && col < h
                     ? *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * s_row + col)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int c = threadIdx.x + (i0 + i) * THREADS;
        val[i] = load_chunk_elements(src, s_row, s_h, row0 + c / kChunks, rows,
                                     (c % kChunks) * 8, h);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = threadIdx.x + (i0 + i) * THREADS;
      *reinterpret_cast<uint4*>(dst + (c / kChunks) * LD + (c % kChunks) * 8) = val[i];
    }
  }
}

// The f32 counterpart: columns [0, HM) of a tile of pitch LD, element
// loads (coalesced along H when s_h == 1), zeros past `rows` and past h.
template <int ROWS, int HM, int LD, int THREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int64_t s_row,
                                              int64_t s_h, int row0, int rows, int h) {
  for (int c = threadIdx.x; c < ROWS * HM; c += THREADS) {
    const int r = c / HM;
    const int d = c % HM;
    dst[r * LD + d] =
        row0 + r < rows && d < h ? src[(int64_t)(row0 + r) * s_row + (int64_t)d * s_h] : 0.f;
  }
}

}  // namespace paddle_tiles
