// Flash-attention backward for Hopper (sm_90a): every float dtype the
// reference takes (bf16, f16, f32), head_dim up to 256, any strides; f32
// accumulation.
//
// Replaces the two TPU kernels paddle_tpu/ops/flash_attention.py
// _bwd_dq_kernel and _bwd_dkv_kernel (launched by _bwd).  Both recompute
// the probabilities from the forward's logsumexp instead of storing them:
//   P  = exp(scale * Q K^T - lse)          (masked pairs: 0)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale,         delta = rowsum(O * dO), f32
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO.
// delta comes in as f32 [B, N, Sq], computed by the wrapper.
//
// What bounds them on the card: operations.  Per causal (q, k) pair the two
// kernels do 5 products of 2*H flops each (QK^T and dO V^T in both kernels,
// then dQ, dK, dV) against a few bytes per q or k row, so at training
// lengths (S = 1024, H = 128) the work is some 300 operations per byte.
// What the design does about it:
//   * bf16 and f16: every product runs on the tensor cores (mma.sync
//     m16n8k16, .bf16 or .f16 in, f32 accumulate) and P and dS never touch
//     device memory;
//   * dQ kernel: one block (4 warps) per (64-row q tile, q head, batch);
//     Q and dO are staged in shared memory once and, up to H = 128, held
//     as mma A fragments in registers for the whole K/V loop (above, read
//     back from shared memory each tile: the 128 dQ accumulator registers
//     a thread of H = 256 leave no room for them, and the key tile halves
//     to 32 rows); each warp keeps its dQ rows in f32 registers; dS of 16
//     keys at a time is fed back as the A operand of dS K straight from
//     the accumulator;
//   * dK/dV kernel: one block (4 warps) per (64-row k tile, kv head,
//     batch); it computes the transposed scores S^T = K Q^T so that P^T and
//     dS^T come out of the accumulator already in the A-operand layout of
//     P^T dO and dS^T Q (no shared-memory transpose).  K and V stay in
//     shared memory for the block (their fragments are re-read, which
//     keeps the 2 x H / 2 f32 accumulator registers a thread within
//     budget); Q, dO, lse and delta of one q tile at a time are staged
//     beside them.  Above H = 128 the key tile halves to 32 rows and the
//     two warps that share 16 keys each accumulate half of H's columns
//     (both compute the same S^T and dP^T), so a thread holds 2 x 64
//     accumulators instead of spilling 2 x 128.  It loops over the q tiles
//     from the causal start and over the N / Nkv q heads of its GQA group,
//     so dK and dV are summed over the group in registers: no atomics and
//     no [B, N, Sk, H] intermediate;
//   * f32: plain FMA, as the f32 forward: 128 threads per 32-row tile, 4
//     threads a row, each scoring 8 of the other side's 32 rows and owning
//     every fourth output column, P and dS passed between a row's 4
//     threads by shuffles.
// The instantiation is the smallest of 32, 64, 128 and 256 columns that
// holds H; shared tiles are zero-filled past H (zero columns add nothing;
// padded columns are never stored), so every loop bound is a constant and
// the products carry no per-column guard.
// Strides that are not 16-byte multiples are read with element loads.
// Not yet done (a later PR's work): TMA double buffering and wgmma, on the
// pieces of flash_attention_fwd_sm90.cu.
//
// Semantics kept from the forward kernels: causal is bottom-right aligned
// (query row i sees keys j <= i + Sk - Sq), keys at or past Sk and rows at
// or past Sq contribute nothing, rows past Sq and keys past Sk are not
// stored, GQA reads kv head n / group.  A causal row that sees no key at
// all (only possible when Sq > Sk, rows i < Sq - Sk) takes the forward's
// true derivative, as jax.grad of the JAX package's plain reference gives
// it: the forward gave it the mean of V (every score is the mask value),
// so it adds dO / Sk to every key's dV and nothing to dQ or dK.  The dK/dV
// kernels leave such rows out of their q-tile loops (P = 0 there, as
// before) and, only when Sq > Sk, add their column sums of dO over Sk to
// every key's dV after the loops (f32, through shared memory): the loops
// of every other shape run as they did.
// Gradients are written with unit stride on H through their other strides.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;

using paddle_tiles::ld32;
using paddle_tiles::mma_16816;
using paddle_tiles::pack2;
using paddle_tiles::round16;

struct Strides {
  int64_t q[4], k[4], v[4], d[4];  // [B, S, N, H] strides in elements (d: dO)
  int64_t g1[3], g2[3];            // gradients' [B, S, N] strides (unit H stride)
};

// Two 16-bit values of one column from consecutive rows: the B fragment of
// a product whose contraction runs over the tile's rows.
__device__ __forceinline__ uint32_t col_pair(const uint16_t* tile, int ld, int row, int col) {
  return (uint32_t)tile[row * ld + col] | ((uint32_t)tile[(row + 1) * ld + col] << 16);
}

// The A fragment (16 rows x 16 of the head dim, k-step ks) of rows
// [r0, r0 + 16) of a padded shared tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile, int r0, int ks,
                                       int g, int t) {
  const uint16_t* p = tile + (r0 + g) * LD + ks * 16 + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// Store n-tiles [dt0, dt0 + DT) of a warp's 16 f32 accumulator rows,
// rounded to 16 bits; rows at or past `rows` and columns at or past h are
// skipped.
template <bool F16, int DT>
__device__ __forceinline__ void store_rows(uint16_t* base, int64_t stride,
                                           const float (&acc)[DT][4], int dt0,
                                           const int (&row)[2], int rows, int h, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    uint16_t* dst = base + (int64_t)row[r] * stride;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = (dt0 + dt) * 8 + t * 2;
      if (col < h) dst[col] = round16<F16>(acc[dt][2 * r]);
      if (col + 1 < h) dst[col + 1] = round16<F16>(acc[dt][2 * r + 1]);
    }
  }
}

// colsum[d] = scale * (the sum of dO[i, n, d] over the rows i < rows and the
// q heads n of [n0, n0 + group)), f32, for d < h; one thread a column.  The
// dK/dV kernels' share of the rows that see no key (the padded columns past
// h read whatever colsum holds there and are never stored).
template <bool F16, typename T>
__device__ void no_key_colsum(float* colsum, const T* dout, const int64_t (&sd)[4], int n0,
                              int group, int rows, int h, float scale) {
  for (int d = threadIdx.x; d < h; d += blockDim.x) {
    float acc = 0.f;
    for (int gi = 0; gi < group; ++gi) {
      const T* p = dout + (n0 + gi) * sd[2] + d * sd[3];
      for (int i = 0; i < rows; ++i) {
        if constexpr (sizeof(T) == 2) {
          acc += paddle_tiles::to_float<F16>(p[i * sd[1]]);
        } else {
          acc += p[i * sd[1]];
        }
      }
    }
    colsum[d] = acc * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16 on mma.sync.

template <int HM>
struct DqTile {
  static constexpr int kBQ = 64;
  static constexpr int kBK = HM <= 128 ? 64 : 32;
  static constexpr int kLd = HM + 8;
  static constexpr bool kRegs = HM <= 128;  // Q and dO fragments held in registers
  static constexpr int kBytes = 2 * (kBQ + kBK) * kLd * 2;
};

template <bool F16, int HM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int Sq, int Sk, int N, int group, int h, int vec,
                    Strides st, float scale, int causal) {
  using T = DqTile<HM>;
  constexpr int kBQ = T::kBQ;
  constexpr int kBK = T::kBK;
  constexpr int kLd = T::kLd;
  constexpr int kSteps = HM / 16;  // k-steps of the products over the head dim

  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* sQ = smem16;
  uint16_t* sD = sQ + kBQ * kLd;
  uint16_t* sK = sD + kBQ * kLd;
  uint16_t* sV = sK + kBK * kLd;

  const int qt = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kBQ;
  const int q_off = Sk - Sq;

  const uint16_t* kb = k + b * st.k[0] + kvh * st.k[2];
  const uint16_t* vb = v + b * st.v[0] + kvh * st.v[2];

  paddle_tiles::load_rows_strided<kBQ, HM, kLd, kThreads>(sQ, q + b * st.q[0] + n * st.q[2],
                                                          st.q[1], st.q[3], q0, Sq, h, vec);
  paddle_tiles::load_rows_strided<kBQ, HM, kLd, kThreads>(sD, dout + b * st.d[0] + n * st.d[2],
                                                          st.d[1], st.d[3], q0, Sq, h, vec);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qf[T::kRegs ? kSteps : 1][4], df[T::kRegs ? kSteps : 1][4];
  if constexpr (T::kRegs) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      load_a<kLd>(qf[ks], sQ, r0, ks, g, t);
      load_a<kLd>(df[ks], sD, r0, ks, g, t);
    }
  }

  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t idx = ((int64_t)b * N + n) * Sq + qi[r];
    row_lse[r] = qi[r] < Sq ? lse[idx] : 0.f;
    row_delta[r] = qi[r] < Sq ? delta[idx] : 0.f;
  }

  float acc[HM / 8][4];
#pragma unroll
  for (int dt = 0; dt < HM / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  int n_kv = (Sk + kBK - 1) / kBK;
  if (causal) {
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

    // 16 keys at a time: S and dP for n-tiles 2c and 2c+1, then dS as the
    // A fragment of k-step c of dQ += dS K.
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
      }
#pragma unroll(T::kRegs ? kSteps : 4)
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t aq[4], ad[4];
        if constexpr (T::kRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aq[e] = qf[ks][e];
            ad[e] = df[ks][e];
          }
        } else {
          load_a<kLd>(aq, sQ, r0, ks, g, t);
          load_a<kLd>(ad, sD, r0, ks, g, t);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int row = ((2 * c + jj) * 8 + g) * kLd + ks * 16 + t * 2;
          mma_16816<F16>(s[jj], aq, ld32(&sK[row]), ld32(&sK[row + 8]));
          mma_16816<F16>(dp[jj], ad, ld32(&sV[row]), ld32(&sV[row + 8]));
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kj = k0 + (2 * c + jj) * 8 + t * 2 + (e & 1);
          const bool ok = qi[r] < Sq && kj < Sk && !(causal && kj > qi[r] + q_off);
          const float p = ok ? expf(s[jj][e] * scale - row_lse[r]) : 0.f;
          s[jj][e] = p * (dp[jj][e] - row_delta[r]) * scale;
        }
      }
      const uint32_t a[4] = {pack2<F16>(s[0][0], s[0][1]), pack2<F16>(s[0][2], s[0][3]),
                             pack2<F16>(s[1][0], s[1][1]), pack2<F16>(s[1][2], s[1][3])};
      const int key = c * 16 + t * 2;
#pragma unroll
      for (int dt = 0; dt < HM / 8; ++dt) {
        const int col = dt * 8 + g;
        mma_16816<F16>(acc[dt], a, col_pair(sK, kLd, key, col), col_pair(sK, kLd, key + 8, col));
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

  store_rows<F16, HM / 8>(dq + b * st.g1[0] + n * st.g1[2], st.g1[1], acc, 0, qi, Sq, h, t);
}

template <int HM>
struct DkvTile {
  static constexpr int kSplit = HM <= 128 ? 1 : 2;  // warps sharing 16 keys, each half of H
  static constexpr int kBK = 64 / kSplit;
  static constexpr int kBQ = 64;
  static constexpr int kLd = HM + 8;
  static constexpr int kDT = HM / 8 / kSplit;       // n-tiles of H a warp accumulates
  static constexpr int kBytes = (2 * kBK + 2 * kBQ) * kLd * 2 + 2 * kBQ * 4;
};

template <bool F16, int HM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int Sq, int Sk, int N,
                     int group, int h, int vec, Strides st, float scale, int causal) {
  using T = DkvTile<HM>;
  constexpr int kBK = T::kBK;
  constexpr int kBQ = T::kBQ;
  constexpr int kLd = T::kLd;
  constexpr int kSteps = HM / 16;
  constexpr int kDT = T::kDT;

  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* sK = smem16;
  uint16_t* sV = sK + kBK * kLd;
  uint16_t* sQ = sV + kBK * kLd;
  uint16_t* sD = sQ + kBQ * kLd;
  float* sLse = reinterpret_cast<float*>(sD + kBQ * kLd);
  float* sDelta = sLse + kBQ;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kBK;
  const int q_off = Sk - Sq;
  const int r0 = (warp / T::kSplit) * 16;      // this warp's 16 keys
  const int dt0 = (warp % T::kSplit) * kDT;    // and its first n-tile of H
  const int kj[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's two keys

  paddle_tiles::load_rows_strided<kBK, HM, kLd, kThreads>(sK, k + b * st.k[0] + kvh * st.k[2],
                                                          st.k[1], st.k[3], k0, Sk, h, vec);
  paddle_tiles::load_rows_strided<kBK, HM, kLd, kThreads>(sV, v + b * st.v[0] + kvh * st.v[2],
                                                          st.v[1], st.v[3], k0, Sk, h, vec);

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[dt][e] = 0.f;
      dv_acc[dt][e] = 0.f;
    }
  }

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  int start = 0;
  if (causal) {
    // q tiles whose last aligned row precedes this k tile see none of it
    const int first = k0 - q_off;
    start = first <= 0 ? 0 : first / kBQ;
  }

  for (int gi = 0; gi < group; ++gi) {
    const int n = kvh * group + gi;
    const uint16_t* qb = q + b * st.q[0] + n * st.q[2];
    const uint16_t* db = dout + b * st.d[0] + n * st.d[2];
    const float* lse_row = lse + ((int64_t)b * N + n) * Sq;
    const float* delta_row = delta + ((int64_t)b * N + n) * Sq;
    for (int qt = start; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's readers are done
      paddle_tiles::load_rows_strided<kBQ, HM, kLd, kThreads>(sQ, qb, st.q[1], st.q[3], q0, Sq,
                                                              h, vec);
      paddle_tiles::load_rows_strided<kBQ, HM, kLd, kThreads>(sD, db, st.d[1], st.d[3], q0, Sq,
                                                              h, vec);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        sLse[i] = in ? lse_row[q0 + i] : 0.f;
        sDelta[i] = in ? delta_row[q0 + i] : 0.f;
      }
      __syncthreads();

      // 16 q rows at a time: S^T and dP^T for n-tiles 2c and 2c+1, then
      // P^T and dS^T as the A fragments of k-step c of dV += P^T dO and
      // dK += dS^T Q.
#pragma unroll
      for (int c = 0; c < kBQ / 16; ++c) {
        float st_[2][4], dpt[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st_[jj][e] = dpt[jj][e] = 0.f;
        }
#pragma unroll(T::kSplit == 1 ? kSteps : 4)
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t ak[4], av[4];
          load_a<kLd>(ak, sK, r0, ks, g, t);
          load_a<kLd>(av, sV, r0, ks, g, t);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int row = ((2 * c + jj) * 8 + g) * kLd + ks * 16 + t * 2;
            mma_16816<F16>(st_[jj], ak, ld32(&sQ[row]), ld32(&sQ[row + 8]));
            mma_16816<F16>(dpt[jj], av, ld32(&sD[row]), ld32(&sD[row + 8]));
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kj[e >> 1];
            const int col = (2 * c + jj) * 8 + t * 2 + (e & 1);
            const int qi = q0 + col;
            const bool ok = key < Sk && qi < Sq && !(causal && key > qi + q_off);
            const float p = ok ? expf(st_[jj][e] * scale - sLse[col]) : 0.f;
            st_[jj][e] = p;
            dpt[jj][e] = p * (dpt[jj][e] - sDelta[col]) * scale;
          }
        }
        const uint32_t ap[4] = {pack2<F16>(st_[0][0], st_[0][1]), pack2<F16>(st_[0][2], st_[0][3]),
                                pack2<F16>(st_[1][0], st_[1][1]), pack2<F16>(st_[1][2], st_[1][3])};
        const uint32_t ads[4] = {
            pack2<F16>(dpt[0][0], dpt[0][1]), pack2<F16>(dpt[0][2], dpt[0][3]),
            pack2<F16>(dpt[1][0], dpt[1][1]), pack2<F16>(dpt[1][2], dpt[1][3])};
        const int qk = c * 16 + t * 2;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const int col = (dt0 + dt) * 8 + g;
          mma_16816<F16>(dv_acc[dt], ap, col_pair(sD, kLd, qk, col),
                         col_pair(sD, kLd, qk + 8, col));
          mma_16816<F16>(dk_acc[dt], ads, col_pair(sQ, kLd, qk, col),
                         col_pair(sQ, kLd, qk + 8, col));
        }
      }
    }
  }

  if (causal && q_off < 0) {
    // rows i < Sq - Sk see no key: dV += (sum of their dO over the group) / Sk
    float* colsum = reinterpret_cast<float*>(sQ);
    __syncthreads();  // the loops are done with sQ
    no_key_colsum<F16>(colsum, dout + b * st.d[0], st.d, kvh * group, group, min(-q_off, Sq), h,
                       1.f / Sk);
    __syncthreads();
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = (dt0 + dt) * 8 + t * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dv_acc[dt][2 * r] += colsum[col];
        dv_acc[dt][2 * r + 1] += colsum[col + 1];
      }
    }
  }
  store_rows<F16, kDT>(dk + b * st.g1[0] + kvh * st.g1[2], st.g1[1], dk_acc, dt0, kj, Sk, h, t);
  store_rows<F16, kDT>(dv + b * st.g2[0] + kvh * st.g2[2], st.g2[1], dv_acc, dt0, kj, Sk, h, t);
}

// ---------------------------------------------------------------------------
// f32 on plain FMA.

template <int HM>
struct TileF32 {
  static constexpr int kRows = 32;    // q rows (dQ) or keys (dK/dV) a block
  static constexpr int kLd = HM + 1;  // odd pitch: the 8 rows a warp reads hit 8 banks
  static constexpr int kBytes = 4 * 32 * kLd * 4 + 2 * 32 * 4;
};

template <int HM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int N, int group, int h,
                        Strides st, float scale, int causal) {
  constexpr int kB = TileF32<HM>::kRows;
  constexpr int kLd = TileF32<HM>::kLd;
  constexpr int kCols = HM / 4;
  extern __shared__ float smem32[];
  float* sQ = smem32;
  float* sD = sQ + kB * kLd;
  float* sK = sD + kB * kLd;
  float* sV = sK + kB * kLd;

  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / group;
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int q0 = blockIdx.x * kB;
  const int qi = q0 + r;
  const int q_off = Sk - Sq;
  paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sQ, q + b * st.q[0] + n * st.q[2], st.q[1],
                                                     st.q[3], q0, Sq, h);
  paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sD, dout + b * st.d[0] + n * st.d[2],
                                                     st.d[1], st.d[3], q0, Sq, h);
  const int64_t idx = ((int64_t)b * N + n) * Sq + qi;
  const float row_lse = qi < Sq ? lse[idx] : 0.f;
  const float row_delta = qi < Sq ? delta[idx] : 0.f;
  const float* kb = k + b * st.k[0] + kvh * st.k[2];
  const float* vb = v + b * st.v[0] + kvh * st.v[2];

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  int n_kv = (Sk + kB - 1) / kB;
  if (causal) {
    const int last = q0 + kB - 1 + q_off;
    n_kv = min(n_kv, last < 0 ? 0 : last / kB + 1);
  }
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kB;
    __syncthreads();
    paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sK, kb, st.k[1], st.k[3], k0, Sk, h);
    paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sV, vb, st.v[1], st.v[3], k0, Sk, h);
    __syncthreads();
    float s[kB / 4], dp[kB / 4];
#pragma unroll
    for (int jj = 0; jj < kB / 4; ++jj) s[jj] = dp[jj] = 0.f;
    for (int d = 0; d < h; ++d) {
      const float qv = sQ[r * kLd + d];
      const float dv = sD[r * kLd + d];
#pragma unroll
      for (int jj = 0; jj < kB / 4; ++jj) {
        s[jj] = fmaf(qv, sK[(c + 4 * jj) * kLd + d], s[jj]);
        dp[jj] = fmaf(dv, sV[(c + 4 * jj) * kLd + d], dp[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kB / 4; ++jj) {
      const int kj = k0 + c + 4 * jj;
      const bool ok = qi < Sq && kj < Sk && !(causal && kj > qi + q_off);
      const float p = ok ? expf(s[jj] * scale - row_lse) : 0.f;
      s[jj] = p * (dp[jj] - row_delta) * scale;
    }
    // dQ += dS K: key kk's dS lives with thread kk % 4 of the row.
#pragma unroll
    for (int kk = 0; kk < kB; ++kk) {
      const float ds = __shfl_sync(0xffffffffu, s[kk >> 2], (lane & ~3) | (kk & 3));
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(ds, sK[kk * kLd + c + 4 * i], acc[i]);
    }
  }
  if (qi >= Sq) return;
  float* row = dq + b * st.g1[0] + n * st.g1[2] + (int64_t)qi * st.g1[1];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (c + 4 * i < h) row[c + 4 * i] = acc[i];
  }
}

template <int HM>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int N,
                         int group, int h, Strides st, float scale, int causal) {
  constexpr int kB = TileF32<HM>::kRows;
  constexpr int kLd = TileF32<HM>::kLd;
  constexpr int kCols = HM / 4;
  extern __shared__ float smem32[];
  float* sK = smem32;
  float* sV = sK + kB * kLd;
  float* sQ = sV + kB * kLd;
  float* sD = sQ + kB * kLd;
  float* sLse = sD + kB * kLd;
  float* sDelta = sLse + kB;

  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 2;  // this thread's key in the tile
  const int c = threadIdx.x & 3;
  const int k0 = blockIdx.x * kB;
  const int kj = k0 + r;
  const int q_off = Sk - Sq;
  paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sK, k + b * st.k[0] + kvh * st.k[2],
                                                     st.k[1], st.k[3], k0, Sk, h);
  paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sV, v + b * st.v[0] + kvh * st.v[2],
                                                     st.v[1], st.v[3], k0, Sk, h);
  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int n_qt = (Sq + kB - 1) / kB;
  int start = 0;
  if (causal) {
    const int first = k0 - q_off;
    start = first <= 0 ? 0 : first / kB;
  }
  for (int gi = 0; gi < group; ++gi) {
    const int n = kvh * group + gi;
    const float* lse_row = lse + ((int64_t)b * N + n) * Sq;
    const float* delta_row = delta + ((int64_t)b * N + n) * Sq;
    for (int qt = start; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();
      paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sQ, q + b * st.q[0] + n * st.q[2],
                                                         st.q[1], st.q[3], q0, Sq, h);
      paddle_tiles::load_rows_f32<kB, HM, kLd, kThreads>(sD, dout + b * st.d[0] + n * st.d[2],
                                                         st.d[1], st.d[3], q0, Sq, h);
      for (int i = threadIdx.x; i < kB; i += kThreads) {
        const bool in = q0 + i < Sq;
        sLse[i] = in ? lse_row[q0 + i] : 0.f;
        sDelta[i] = in ? delta_row[q0 + i] : 0.f;
      }
      __syncthreads();
      float p[kB / 4], ds[kB / 4];
#pragma unroll
      for (int jj = 0; jj < kB / 4; ++jj) p[jj] = ds[jj] = 0.f;
      for (int d = 0; d < h; ++d) {
        const float kv = sK[r * kLd + d];
        const float vv = sV[r * kLd + d];
#pragma unroll
        for (int jj = 0; jj < kB / 4; ++jj) {
          p[jj] = fmaf(kv, sQ[(c + 4 * jj) * kLd + d], p[jj]);
          ds[jj] = fmaf(vv, sD[(c + 4 * jj) * kLd + d], ds[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kB / 4; ++jj) {
        const int row = c + 4 * jj;
        const int qi = q0 + row;
        const bool ok = kj < Sk && qi < Sq && !(causal && kj > qi + q_off);
        const float pr = ok ? expf(p[jj] * scale - sLse[row]) : 0.f;
        p[jj] = pr;
        ds[jj] = pr * (ds[jj] - sDelta[row]) * scale;
      }
      // dV += P^T dO and dK += dS^T Q: q row qq's values live with thread
      // qq % 4 of the key.
#pragma unroll
      for (int qq = 0; qq < kB; ++qq) {
        const int src = (lane & ~3) | (qq & 3);
        const float pv = __shfl_sync(0xffffffffu, p[qq >> 2], src);
        const float dsv = __shfl_sync(0xffffffffu, ds[qq >> 2], src);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          dv_acc[i] = fmaf(pv, sD[qq * kLd + c + 4 * i], dv_acc[i]);
          dk_acc[i] = fmaf(dsv, sQ[qq * kLd + c + 4 * i], dk_acc[i]);
        }
      }
    }
  }
  if (causal && q_off < 0) {
    // rows i < Sq - Sk see no key: dV += (sum of their dO over the group) / Sk
    float* colsum = sQ;
    __syncthreads();  // the loops are done with sQ
    no_key_colsum<false>(colsum, dout + b * st.d[0], st.d, kvh * group, group, min(-q_off, Sq), h,
                         1.f / Sk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      if (c + 4 * i < h) dv_acc[i] += colsum[c + 4 * i];
    }
  }
  if (kj >= Sk) return;
  float* krow = dk + b * st.g1[0] + kvh * st.g1[2] + (int64_t)kj * st.g1[1];
  float* vrow = dv + b * st.g2[0] + kvh * st.g2[2] + (int64_t)kj * st.g2[1];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    if (c + 4 * i < h) {
      krow[c + 4 * i] = dk_acc[i];
      vrow[c + 4 * i] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch helpers.

template <typename Kernel>
int raise_smem(Kernel kernel, int bytes, bool& raised) {
  if (raised || bytes <= 48 * 1024) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  raised = err == cudaSuccess;
  return (int)err;
}

bool shapes_ok(int B, int Sq, int Sk, int N, int Nkv, int H, int dtype) {
  return B > 0 && Sq > 0 && Sk > 0 && Nkv > 0 && N % Nkv == 0 && H >= 1 && H <= 256 &&
         dtype >= 0 && dtype <= 2;
}

// 16-byte loads: unit H stride, h and every row stride a multiple of 8
// 16-bit elements, 16-byte aligned bases.
bool vec_ok(const void* p, const int64_t (&s)[4], int h) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[3] == 1 && h % 8 == 0 && s[0] % 8 == 0 &&
         s[1] % 8 == 0 && s[2] % 8 == 0;
}

struct Args {
  const void *q, *k, *v, *d;
  const float *lse, *delta;
  void *g1, *g2;  // dQ, or dK and dV
  int Sq, Sk, N, group, h;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <bool F16, int HM>
int launch_dq_mma(const Args& a, int B, bool vec) {
  using T = DqTile<HM>;
  static bool raised = false;
  const int err = raise_smem(flash_bwd_dq_kernel<F16, HM>, T::kBytes, raised);
  if (err) return err;
  const dim3 grid((a.Sq + T::kBQ - 1) / T::kBQ, a.N, B);
  flash_bwd_dq_kernel<F16, HM><<<grid, kThreads, T::kBytes, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.d), a.lse, a.delta,
      static_cast<uint16_t*>(a.g1), a.Sq, a.Sk, a.N, a.group, a.h, vec, a.st, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <bool F16, int HM>
int launch_dkv_mma(const Args& a, int B, int Nkv, bool vec) {
  using T = DkvTile<HM>;
  static bool raised = false;
  const int err = raise_smem(flash_bwd_dkv_kernel<F16, HM>, T::kBytes, raised);
  if (err) return err;
  const dim3 grid((a.Sk + T::kBK - 1) / T::kBK, Nkv, B);
  flash_bwd_dkv_kernel<F16, HM><<<grid, kThreads, T::kBytes, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.d), a.lse, a.delta,
      static_cast<uint16_t*>(a.g1), static_cast<uint16_t*>(a.g2), a.Sq, a.Sk, a.N, a.group, a.h,
      vec, a.st, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int HM>
int launch_dq_f32(const Args& a, int B) {
  static bool raised = false;
  const int bytes = TileF32<HM>::kBytes;
  const int err = raise_smem(flash_bwd_dq_f32_kernel<HM>, bytes, raised);
  if (err) return err;
  const dim3 grid((a.Sq + 31) / 32, a.N, B);
  flash_bwd_dq_f32_kernel<HM><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.d), a.lse, a.delta,
      static_cast<float*>(a.g1), a.Sq, a.Sk, a.N, a.group, a.h, a.st, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int HM>
int launch_dkv_f32(const Args& a, int B, int Nkv) {
  static bool raised = false;
  const int bytes = TileF32<HM>::kBytes;
  const int err = raise_smem(flash_bwd_dkv_f32_kernel<HM>, bytes, raised);
  if (err) return err;
  const dim3 grid((a.Sk + 31) / 32, Nkv, B);
  flash_bwd_dkv_f32_kernel<HM><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.d), a.lse, a.delta,
      static_cast<float*>(a.g1), static_cast<float*>(a.g2), a.Sq, a.Sk, a.N, a.group, a.h, a.st,
      a.scale, a.causal);
  return (int)cudaGetLastError();
}

// The instantiation for dtype and H: the smallest of 32, 64, 128 and 256
// that holds H.
template <int HM>
int dq_for(const Args& a, int B, int dtype, bool vec) {
  if (dtype == 2) return launch_dq_f32<HM>(a, B);
  return dtype == 1 ? launch_dq_mma<true, HM>(a, B, vec) : launch_dq_mma<false, HM>(a, B, vec);
}

template <int HM>
int dkv_for(const Args& a, int B, int Nkv, int dtype, bool vec) {
  if (dtype == 2) return launch_dkv_f32<HM>(a, B, Nkv);
  return dtype == 1 ? launch_dkv_mma<true, HM>(a, B, Nkv, vec)
                    : launch_dkv_mma<false, HM>(a, B, Nkv, vec);
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() after its launch (0
// when it was accepted), or cudaErrorInvalidValue for shapes the kernels
// do not take.  All pointers are device pointers; q, k, v, dO strides are
// [B, S, N, H] in elements, the gradients' [B, S, N] (unit H stride); lse
// and delta are contiguous f32 [B, N, Sq]; dtype 0 bf16, 1 f16, 2 f32 (one
// dtype for every tensor but lse and delta); 1 <= H <= 256.

extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int Sq, int Sk, int N, int Nkv, int H,
    long long q_sb, long long q_ss, long long q_sn, long long q_sh,
    long long k_sb, long long k_ss, long long k_sn, long long k_sh,
    long long v_sb, long long v_ss, long long v_sn, long long v_sh,
    long long do_sb, long long do_ss, long long do_sn, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sn, int dtype, float scale, int causal,
    void* stream) {
  if (!shapes_ok(B, Sq, Sk, N, Nkv, H, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = {q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, Sq, Sk, N, N / Nkv, H,
                  {{q_sb, q_ss, q_sn, q_sh}, {k_sb, k_ss, k_sn, k_sh}, {v_sb, v_ss, v_sn, v_sh},
                   {do_sb, do_ss, do_sn, do_sh}, {dq_sb, dq_ss, dq_sn}, {0, 0, 0}},
                  scale, causal, reinterpret_cast<cudaStream_t>(stream)};
  const bool vec = vec_ok(q, a.st.q, H) && vec_ok(k, a.st.k, H) && vec_ok(v, a.st.v, H) &&
                   vec_ok(dout, a.st.d, H);
  if (H <= 32) return dq_for<32>(a, B, dtype, vec);
  if (H <= 64) return dq_for<64>(a, B, dtype, vec);
  if (H <= 128) return dq_for<128>(a, B, dtype, vec);
  return dq_for<256>(a, B, dtype, vec);
}

extern "C" int paddle_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int N, int Nkv, int H,
    long long q_sb, long long q_ss, long long q_sn, long long q_sh,
    long long k_sb, long long k_ss, long long k_sn, long long k_sh,
    long long v_sb, long long v_ss, long long v_sn, long long v_sh,
    long long do_sb, long long do_ss, long long do_sn, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sn,
    long long dv_sb, long long dv_ss, long long dv_sn, int dtype, float scale, int causal,
    void* stream) {
  if (!shapes_ok(B, Sq, Sk, N, Nkv, H, dtype)) return (int)cudaErrorInvalidValue;
  const Args a = {q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dk, dv, Sq, Sk, N, N / Nkv, H,
                  {{q_sb, q_ss, q_sn, q_sh}, {k_sb, k_ss, k_sn, k_sh}, {v_sb, v_ss, v_sn, v_sh},
                   {do_sb, do_ss, do_sn, do_sh}, {dk_sb, dk_ss, dk_sn}, {dv_sb, dv_ss, dv_sn}},
                  scale, causal, reinterpret_cast<cudaStream_t>(stream)};
  const bool vec = vec_ok(q, a.st.q, H) && vec_ok(k, a.st.k, H) && vec_ok(v, a.st.v, H) &&
                   vec_ok(dout, a.st.d, H);
  if (H <= 32) return dkv_for<32>(a, B, Nkv, dtype, vec);
  if (H <= 64) return dkv_for<64>(a, B, Nkv, dtype, vec);
  if (H <= 128) return dkv_for<128>(a, B, Nkv, dtype, vec);
  return dkv_for<256>(a, B, Nkv, dtype, vec);
}
