// Tile helpers shared by the attention kernels written for Hopper
// (flash_attention_fwd.cu, flash_attention_bwd.cu, decode_chain.cu):
// the bf16 tensor-core product of one warp (mma.sync m16n8k16, f32
// accumulate), fragment packing, and the copy of a strided row block into
// a padded shared tile.  Header only; each source that includes it is
// built into its own library (ops/_cuda_build.py hashes this file too).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

}  // namespace paddle_tiles
