// Flash-attention forward for Hopper (sm_90a), the general route: every
// float dtype the reference takes (bf16, f16, f32), head_dim up to 256,
// any strides.  f32 accumulation.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _fwd): blockwise online-softmax attention that writes O and
// the per-row logsumexp, causal bottom-right aligned when Sq != Sk, KV
// tiles past the diagonal skipped, mask value -0.7 * FLT_MAX, GQA by
// reading kv-head n / group.  bf16 and f16 at head_dim 64 or 128 in a
// layout TMA can read take flash_attention_fwd_sm90.cu instead (TMA,
// wgmma, warp-specialised); ops/flash_attention.py:_fwd_route picks the
// route from dtype, H and layout alone, before any launch.  This kernel
// takes the rest: f32, the other head dims, other strides.
//
// What bounds it on the card: operations at prefill lengths (4 H flops per
// visible (q, k) pair against 2 H bytes per q or k row).  What the design
// does about it:
//   * bf16 and f16: the products run on the tensor cores (mma.sync
//     m16n8k16, .bf16 or .f16 in, f32 accumulate); one block (4 warps) per
//     (64-row q tile, head, batch), each warp owning 16 q rows with the
//     running max/sum and the output accumulator in registers for the
//     whole KV loop; the S = QK^T accumulator is fed straight back as the
//     A operand of P V, so neither S nor P touches shared or device
//     memory.  Q and K/V tiles are staged in shared memory with a padded
//     row pitch (conflict-free fragment reads).  The instantiation is the
//     smallest of 32, 64, 128 and 256 columns that holds H, and the tiles
//     are zero-filled past H (zero columns add nothing to QK^T; padded
//     output columns are never stored), so every loop bound is a
//     constant: no per-column guard in the products.  Above 128 the key
//     tile halves to 32 rows, which keeps the 128 accumulator registers a
//     thread of H = 256 clear of spills;
//   * f32: plain FMA (no tensor-core f32 product), as prefill_chain and
//     matmul_epilogue.cu's f32 paths: a block of 128 threads per 32 q
//     rows, 4 threads a row, each scoring 8 of a 32-key tile and owning
//     every fourth output column; P is passed between the 4 threads of a
//     row by shuffles.
//   * Strides that are not 16-byte multiples (or a non-unit H stride) are
//     read with element loads instead of 16-byte ones: the wrapper never
//     copies.
// KV tiles past the causal diagonal are never loaded.  Ragged lengths are
// masked in the kernel: keys at or past Sk get probability 0 and rows at
// or past Sq are not stored.  O is written through its strides (unit
// stride on H), lse as f32 [B, N, Sq].
// Not yet done: cp.async double buffering here (the sm90 route has TMA).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

using paddle_tiles::ld32;
using paddle_tiles::mma_16816;
using paddle_tiles::pack2;
using paddle_tiles::round16;

struct Strides {
  int64_t q[4], k[4], v[4], o[3];  // [B, S, N, H] strides in elements; o has unit H stride
};

// ---------------------------------------------------------------------------
// bf16 and f16 on mma.sync.

template <int HM>
struct Tile16 {
  static constexpr int kBQ = 64;
  static constexpr int kBK = HM <= 128 ? 64 : 32;
  static constexpr int kLd = HM + 8;  // padded pitch: conflict-free fragment reads
  static constexpr int kBytes = (kBQ + 2 * kBK) * kLd * 2;
};

template <bool F16, int HM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int N, int group, int h, int vec,
                     Strides st, float scale, int causal) {
  using T = Tile16<HM>;
  constexpr int kBQ = T::kBQ;
  constexpr int kBK = T::kBK;
  constexpr int kLd = T::kLd;
  constexpr int kNTiles = kBK / 8;

  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* sQ = smem16;
  uint16_t* sK = sQ + kBQ * kLd;
  uint16_t* sV = sK + kBK * kLd;

  const int qt = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread within the group
  const int q0 = qt * kBQ;
  const int q_off = Sk - Sq;  // bottom-right causal alignment

  const uint16_t* qb = q + b * st.q[0] + n * st.q[2];
  const uint16_t* kb = k + b * st.k[0] + kvh * st.k[2];
  const uint16_t* vb = v + b * st.v[0] + kvh * st.v[2];

  paddle_tiles::load_rows_strided<kBQ, HM, kLd, kThreads>(sQ, qb, st.q[1], st.q[3], q0, Sq, h,
                                                          vec);

  // This thread's two rows: fragment elements 0,1 lie on row g, 2,3 on g+8.
  const int r0 = warp * 16 + g;
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float acc[HM / 8][4];
#pragma unroll
  for (int dt = 0; dt < HM / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  int n_kv = (Sk + kBK - 1) / kBK;
  if (causal) {
    // only KV tiles that start at or before the tile's last aligned q row
    const int last = q0 + kBQ - 1 + q_off;
    n_kv = min(n_kv, last < 0 ? 0 : last / kBK + 1);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    paddle_tiles::load_rows_strided<kBK, HM, kLd, kThreads>(sK, kb, st.k[1], st.k[3], k0, Sk, h,
                                                            vec);
    paddle_tiles::load_rows_strided<kBK, HM, kLd, kThreads>(sV, vb, st.v[1], st.v[3], k0, Sk, h,
                                                            vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows against the tile's keys.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    // two k-steps at a time above H = 64: unrolled whole, the K fragment
    // loads hoisted ahead of their products spill
#pragma unroll(HM > 64 ? 2 : HM / 16)
    for (int ks = 0; ks < HM / 16; ++ks) {
      const uint16_t* a = &sQ[r0 * kLd + ks * 16 + t * 2];
      const uint32_t qf[4] = {ld32(a), ld32(a + 8 * kLd), ld32(a + 8), ld32(a + 8 * kLd + 8)};
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const uint16_t* krow = &sK[(nt * 8 + g) * kLd + ks * 16 + t * 2];
        mma_16816<F16>(s[nt], qf, ld32(krow), ld32(krow + 8));
      }
    }

    // Scale and mask; keys past Sk are not keys at all (probability 0).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kj = k0 + nt * 8 + t * 2 + (e & 1);
        float val = s[nt][e] * scale;
        if (kj >= Sk) {
          val = -INFINITY;
        } else if (causal && kj > qi[r] + q_off) {
          val = kMaskValue;
        }
        s[nt][e] = val;
        mx[r] = fmaxf(mx[r], val);
      }
    }
    // The four threads of a group share a row: reduce the max across them.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < HM / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V: the S accumulator of n-tiles 2kk and 2kk+1 is exactly the
    // A fragment of k-step kk, rounded to 16 bits.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack2<F16>(s[2 * kk][0], s[2 * kk][1]),
                             pack2<F16>(s[2 * kk][2], s[2 * kk][3]),
                             pack2<F16>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2<F16>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + t * 2;
#pragma unroll
      for (int dt = 0; dt < HM / 8; ++dt) {
        const int col = dt * 8 + g;
        const uint32_t b0 = (uint32_t)sV[key * kLd + col] |
                            ((uint32_t)sV[(key + 1) * kLd + col] << 16);
        const uint32_t b1 = (uint32_t)sV[(key + 8) * kLd + col] |
                            ((uint32_t)sV[(key + 9) * kLd + col] << 16);
        mma_16816<F16>(acc[dt], a, b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

  uint16_t* ob = o + b * st.o[0] + n * st.o[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    if (qi[r] >= Sq) continue;
    const float inv = 1.f / l_safe;
    uint16_t* orow = ob + qi[r] * st.o[1];
#pragma unroll
    for (int dt = 0; dt < HM / 8; ++dt) {
      const int col = dt * 8 + t * 2;
      if (col < h) orow[col] = round16<F16>(acc[dt][2 * r] * inv);
      if (col + 1 < h) orow[col + 1] = round16<F16>(acc[dt][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((int64_t)b * N + n) * Sq + qi[r]] = m[r] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on plain FMA.

template <int HM>
struct TileF32 {
  static constexpr int kBQ = 32;
  static constexpr int kBK = 32;
  static constexpr int kLd = HM + 1;  // odd pitch: the 8 rows a warp reads hit 8 banks
  static constexpr int kBytes = (kBQ + 2 * kBK) * kLd * 4;
};

template <int HM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Sk, int N, int group, int h, Strides st, float scale,
                     int causal) {
  using T = TileF32<HM>;
  constexpr int kBQ = T::kBQ;
  constexpr int kBK = T::kBK;
  constexpr int kLd = T::kLd;
  constexpr int kCols = HM / 4;  // output columns a thread owns: c, c + 4, ...

  extern __shared__ float smem32[];
  float* sQ = smem32;
  float* sK = sQ + kBQ * kLd;
  float* sV = sK + kBK * kLd;

  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / group;
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;  // this thread's q row in the tile
  const int c = threadIdx.x & 3;   // keys c + 4 jj, columns c + 4 i
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + r;
  const int q_off = Sk - Sq;

  const float* kb = k + b * st.k[0] + kvh * st.k[2];
  const float* vb = v + b * st.v[0] + kvh * st.v[2];
  paddle_tiles::load_rows_f32<kBQ, HM, kLd, kThreads>(sQ, q + b * st.q[0] + n * st.q[2],
                                                      st.q[1], st.q[3], q0, Sq, h);

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = kMaskValue;
  float l = 0.f;  // this thread's share of the row sum

  int n_kv = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + kBQ - 1 + q_off;
    n_kv = min(n_kv, last < 0 ? 0 : last / kBK + 1);
  }
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    paddle_tiles::load_rows_f32<kBK, HM, kLd, kThreads>(sK, kb, st.k[1], st.k[3], k0, Sk, h);
    paddle_tiles::load_rows_f32<kBK, HM, kLd, kThreads>(sV, vb, st.v[1], st.v[3], k0, Sk, h);
    __syncthreads();

    float s[kBK / 4];
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) s[jj] = 0.f;
    for (int d = 0; d < h; ++d) {
      const float qv = sQ[r * kLd + d];
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) s[jj] = fmaf(qv, sK[(c + 4 * jj) * kLd + d], s[jj]);
    }
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      const int kj = k0 + c + 4 * jj;
      float val = s[jj] * scale;
      if (kj >= Sk) {
        val = -INFINITY;
      } else if (causal && kj > qi + q_off) {
        val = kMaskValue;
      }
      s[jj] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kBK / 4; ++jj) {
      s[jj] = expf(s[jj] - m);
      l += s[jj];
    }
    // O += P V: key kk's probability lives with thread kk % 4 of the row.
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = __shfl_sync(0xffffffffu, s[kk >> 2], (lane & ~3) | (kk & 3));
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(p, sV[kk * kLd + c + 4 * i], acc[i]);
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (qi >= Sq) return;
  const float l_safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / l_safe;
  float* orow = o + b * st.o[0] + n * st.o[2] + (int64_t)qi * st.o[1];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (c + 4 * i < h) orow[c + 4 * i] = acc[i] * inv;
  }
  if (c == 0) lse[((int64_t)b * N + n) * Sq + qi] = m + logf(l_safe);
}

// ---------------------------------------------------------------------------
// Launch helpers: dynamic shared memory, raised above 48 KB once per
// instantiation.

template <typename Kernel>
int raise_smem(Kernel kernel, int bytes, bool& raised) {
  if (raised || bytes <= 48 * 1024) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  raised = err == cudaSuccess;
  return (int)err;
}

template <bool F16, int HM>
int launch_mma(int B, int Sq, int Sk, int N, int group, int h, bool vec, const void* q,
               const void* k, const void* v, void* o, void* lse, const Strides& st, float scale,
               int causal, cudaStream_t s) {
  static bool raised = false;
  const int err = raise_smem(flash_fwd_mma_kernel<F16, HM>, Tile16<HM>::kBytes, raised);
  if (err) return err;
  const dim3 grid((Sq + Tile16<HM>::kBQ - 1) / Tile16<HM>::kBQ, N, B);
  flash_fwd_mma_kernel<F16, HM><<<grid, kThreads, Tile16<HM>::kBytes, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), static_cast<float*>(lse), Sq,
      Sk, N, group, h, vec, st, scale, causal);
  return (int)cudaGetLastError();
}

template <int HM>
int launch_f32(int B, int Sq, int Sk, int N, int group, int h, const void* q, const void* k,
               const void* v, void* o, void* lse, const Strides& st, float scale, int causal,
               cudaStream_t s) {
  static bool raised = false;
  const int err = raise_smem(flash_fwd_f32_kernel<HM>, TileF32<HM>::kBytes, raised);
  if (err) return err;
  const dim3 grid((Sq + TileF32<HM>::kBQ - 1) / TileF32<HM>::kBQ, N, B);
  flash_fwd_f32_kernel<HM><<<grid, kThreads, TileF32<HM>::kBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), Sq, Sk, N, group, h, st, scale, causal);
  return (int)cudaGetLastError();
}

// 16-byte loads: unit H stride, h and every row stride a multiple of 8
// 16-bit elements, 16-byte aligned bases.
bool vec_ok(const void* p, const int64_t (&s)[4], int h) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[3] == 1 && h % 8 == 0 && s[0] % 8 == 0 &&
         s[1] % 8 == 0 && s[2] % 8 == 0;
}

// The instantiation for H: the smallest of 32, 64, 128 and 256 that holds it.
template <bool F16>
int dispatch_mma(int B, int Sq, int Sk, int N, int group, int h, bool vec, const void* q,
                 const void* k, const void* v, void* o, void* lse, const Strides& st,
                 float scale, int causal, cudaStream_t s) {
  if (h <= 32) {
    return launch_mma<F16, 32>(B, Sq, Sk, N, group, h, vec, q, k, v, o, lse, st, scale, causal,
                               s);
  }
  if (h <= 64) {
    return launch_mma<F16, 64>(B, Sq, Sk, N, group, h, vec, q, k, v, o, lse, st, scale, causal,
                               s);
  }
  if (h <= 128) {
    return launch_mma<F16, 128>(B, Sq, Sk, N, group, h, vec, q, k, v, o, lse, st, scale, causal,
                                s);
  }
  return launch_mma<F16, 256>(B, Sq, Sk, N, group, h, vec, q, k, v, o, lse, st, scale, causal,
                              s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 when
// it was accepted), or cudaErrorInvalidValue for shapes the kernels do not
// take.  All pointers are device pointers; q, k, v strides are [B, S, N, H]
// in elements, o's [B, S, N] (unit H stride); dtype 0 bf16, 1 f16, 2 f32
// (o has the inputs' dtype, lse is f32 [B, N, Sq]); 1 <= H <= 256.
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq, int Sk,
    int N, int Nkv, int H, long long q_sb, long long q_ss, long long q_sn, long long q_sh,
    long long k_sb, long long k_ss, long long k_sn, long long k_sh, long long v_sb,
    long long v_ss, long long v_sn, long long v_sh, long long o_sb, long long o_ss,
    long long o_sn, int dtype, float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Nkv <= 0 || N % Nkv != 0 || H < 1 || H > 256 ||
      dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st = {{q_sb, q_ss, q_sn, q_sh}, {k_sb, k_ss, k_sn, k_sh},
                      {v_sb, v_ss, v_sn, v_sh}, {o_sb, o_ss, o_sn}};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int group = N / Nkv;
  if (dtype == 2) {
    if (H <= 32) {
      return launch_f32<32>(B, Sq, Sk, N, group, H, q, k, v, o, lse, st, scale, causal, s);
    }
    if (H <= 64) {
      return launch_f32<64>(B, Sq, Sk, N, group, H, q, k, v, o, lse, st, scale, causal, s);
    }
    if (H <= 128) {
      return launch_f32<128>(B, Sq, Sk, N, group, H, q, k, v, o, lse, st, scale, causal, s);
    }
    return launch_f32<256>(B, Sq, Sk, N, group, H, q, k, v, o, lse, st, scale, causal, s);
  }
  const bool vec = vec_ok(q, st.q, H) && vec_ok(k, st.k, H) && vec_ok(v, st.v, H);
  return dtype == 1 ? dispatch_mma<true>(B, Sq, Sk, N, group, H, vec, q, k, v, o, lse, st, scale,
                                         causal, s)
                    : dispatch_mma<false>(B, Sq, Sk, N, group, H, vec, q, k, v, o, lse, st, scale,
                                          causal, s);
}
