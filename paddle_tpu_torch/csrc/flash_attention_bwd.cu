// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulation.
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
// then dQ, dK, dV) against a few bf16 bytes per q or k row, so at training
// lengths (S = 1024, H = 128) the work is some 300 operations per byte.
// What the design does about it:
//   * every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate) and P and dS never touch device memory;
//   * dQ kernel: one block (4 warps) per (64-row q tile, q head, batch);
//     each warp holds its 16 rows of Q and dO as mma A fragments in
//     registers, walks the K/V tiles up to the causal limit, and keeps its
//     dQ rows in f32 registers; dS of 16 keys at a time is fed back as the
//     A operand of dS K straight from the accumulator;
//   * dK/dV kernel: one block (4 warps) per (64-row k tile, kv head, batch);
//     it computes the transposed scores S^T = K Q^T so that P^T and dS^T
//     come out of the accumulator already in the A-operand layout of
//     P^T dO and dS^T Q (no shared-memory transpose).  K and V stay in
//     shared memory for the block (their fragments are re-read, which
//     keeps the 2 x 64 f32 accumulator registers a thread within budget);
//     Q, dO, lse and delta of one q tile at a time are staged beside them
//     (70 KB of dynamic shared memory at H = 128).  It loops over the q
//     tiles from the causal start and over the N / Nkv q heads of its GQA
//     group, so dK and dV are summed over the group in registers: no
//     atomics and no [B, N, Sk, H] intermediate.
// Not yet done (a later PR's work): cp.async/TMA double buffering, wgmma.
//
// Semantics kept from the forward kernel: causal is bottom-right aligned
// (query row i sees keys j <= i + Sk - Sq), keys at or past Sk and rows at
// or past Sq contribute nothing, rows past Sq and keys past Sk are not
// stored, GQA reads kv head n / group.  A causal row that sees no key at
// all (only possible when Sq > Sk) gets a zero gradient.  Inputs are read
// through their strides in the public [B, S, N, H] layout (unit stride on
// H, every other stride a multiple of 8 elements, 16-byte aligned base).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

using paddle_tiles::ld32;
using paddle_tiles::mma_bf16_16816;
using paddle_tiles::pack_bf16;

// Two bf16 values of one column from consecutive rows: the B fragment of a
// product whose contraction runs over the tile's rows.
__device__ __forceinline__ uint32_t col_pair(const uint16_t* tile, int ld, int row, int col) {
  return (uint32_t)tile[row * ld + col] | ((uint32_t)tile[(row + 1) * ld + col] << 16);
}

// The A fragment (16 rows x 16 of the head dim, k-step ks) of rows
// [r0, r0 + 16) of a padded shared tile, r0 = warp * 16.
template <int H>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile, int r0, int ks,
                                       int g, int t) {
  constexpr int kLd = H + 8;
  const uint16_t* p = tile + (r0 + g) * kLd + ks * 16 + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * kLd);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * kLd + 8);
}

// Copy rows [row0, row0 + 64) of a [rows, H] strided bf16 matrix into a
// padded shared tile; rows at or past `rows` are zero-filled.
template <int H>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src, int64_t stride,
                                          int row0, int rows) {
  paddle_tiles::load_rows<H, kBlockK, kThreads>(dst, src, stride, row0, rows);
}

// Store a warp's 16 x H f32 accumulator rows as bf16; rows at or past
// `rows` are skipped.
template <int H>
__device__ __forceinline__ void store_rows(uint16_t* base, int64_t stride, const float (&acc)[H / 8][4],
                                           const int (&row)[2], int rows, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    uint16_t* dst = base + (int64_t)row[r] * stride;
#pragma unroll
    for (int dt = 0; dt < H / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dst + dt * 8 + t * 2) =
          pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int Sq, int Sk, int N, int group,
                    int64_t q_sb, int64_t q_ss, int64_t q_sn,
                    int64_t k_sb, int64_t k_ss, int64_t k_sn,
                    int64_t v_sb, int64_t v_ss, int64_t v_sn,
                    int64_t do_sb, int64_t do_ss, int64_t do_sn,
                    int64_t dq_sb, int64_t dq_ss, int64_t dq_sn,
                    float scale, int causal) {
  constexpr int kLd = H + 8;
  constexpr int kSteps = H / 16;  // k-steps of the products over the head dim
  constexpr int kDTiles = H / 8;  // n-tiles of dS K over the head dim

  __shared__ __align__(16) uint16_t sK[kBlockK * kLd];
  __shared__ __align__(16) uint16_t sV[kBlockK * kLd];

  const int qt = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kBlockQ;
  const int q_off = Sk - Sq;

  const uint16_t* kb = k + b * k_sb + kvh * k_sn;
  const uint16_t* vb = v + b * v_sb + kvh * v_sn;

  // Stage Q through sK and dO through sV, then hold this warp's 16 rows of
  // each as A fragments for the whole K/V loop.
  load_tile<H>(sK, q + b * q_sb + n * q_sn, q_ss, q0, Sq);
  load_tile<H>(sV, dout + b * do_sb + n * do_sn, do_ss, q0, Sq);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qf[kSteps][4], df[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    load_a<H>(qf[ks], sK, r0, ks, g, t);
    load_a<H>(df[ks], sV, r0, ks, g, t);
  }
  __syncthreads();

  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t idx = ((int64_t)b * N + n) * Sq + qi[r];
    row_lse[r] = qi[r] < Sq ? lse[idx] : 0.f;
    row_delta[r] = qi[r] < Sq ? delta[idx] : 0.f;
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  int n_kv = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last = q0 + kBlockQ - 1 + q_off;
    n_kv = min(n_kv, last < 0 ? 0 : last / kBlockK + 1);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    load_tile<H>(sK, kb, k_ss, k0, Sk);
    load_tile<H>(sV, vb, v_ss, k0, Sk);
    __syncthreads();

    // 16 keys at a time: S and dP for n-tiles 2c and 2c+1, then dS as the
    // A fragment of k-step c of dQ += dS K.
#pragma unroll
    for (int c = 0; c < kBlockK / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
        const uint16_t* krow = &sK[((2 * c + jj) * 8 + g) * kLd + t * 2];
        const uint16_t* vrow = &sV[((2 * c + jj) * 8 + g) * kLd + t * 2];
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          mma_bf16_16816(s[jj], qf[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
          mma_bf16_16816(dp[jj], df[ks], ld32(vrow + ks * 16), ld32(vrow + ks * 16 + 8));
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
      const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      const int key = c * 16 + t * 2;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int col = dt * 8 + g;
        mma_bf16_16816(acc[dt], a, col_pair(sK, kLd, key, col), col_pair(sK, kLd, key + 8, col));
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

  store_rows<H>(dq + b * dq_sb + n * dq_sn, dq_ss, acc, qi, Sq, t);
}

template <int H>
constexpr int dkv_smem_bytes() {
  return 4 * kBlockK * (H + 8) * 2 + 2 * kBlockQ * 4;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                     int Sq, int Sk, int N, int group,
                     int64_t q_sb, int64_t q_ss, int64_t q_sn,
                     int64_t k_sb, int64_t k_ss, int64_t k_sn,
                     int64_t v_sb, int64_t v_ss, int64_t v_sn,
                     int64_t do_sb, int64_t do_ss, int64_t do_sn,
                     int64_t dk_sb, int64_t dk_ss, int64_t dk_sn,
                     int64_t dv_sb, int64_t dv_ss, int64_t dv_sn,
                     float scale, int causal) {
  constexpr int kLd = H + 8;
  constexpr int kSteps = H / 16;
  constexpr int kDTiles = H / 8;

  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sK = smem;
  uint16_t* sV = sK + kBlockK * kLd;
  uint16_t* sQ = sV + kBlockK * kLd;
  uint16_t* sD = sQ + kBlockQ * kLd;
  float* sLse = reinterpret_cast<float*>(sD + kBlockQ * kLd);
  float* sDelta = sLse + kBlockQ;

  const int kt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kBlockK;
  const int q_off = Sk - Sq;
  const int r0 = warp * 16;
  const int kj[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's two keys

  load_tile<H>(sK, k + b * k_sb + kvh * k_sn, k_ss, k0, Sk);
  load_tile<H>(sV, v + b * v_sb + kvh * v_sn, v_ss, k0, Sk);

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[dt][e] = 0.f;
      dv_acc[dt][e] = 0.f;
    }
  }

  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  int start = 0;
  if (causal) {
    // q tiles whose last aligned row precedes this k tile see none of it
    const int first = k0 - q_off;
    start = first <= 0 ? 0 : first / kBlockQ;
  }

  for (int gi = 0; gi < group; ++gi) {
    const int n = kvh * group + gi;
    const uint16_t* qb = q + b * q_sb + n * q_sn;
    const uint16_t* db = dout + b * do_sb + n * do_sn;
    const float* lse_row = lse + ((int64_t)b * N + n) * Sq;
    const float* delta_row = delta + ((int64_t)b * N + n) * Sq;
    for (int qt = start; qt < n_qt; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<H>(sQ, qb, q_ss, q0, Sq);
      load_tile<H>(sD, db, do_ss, q0, Sq);
      for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        sLse[i] = in ? lse_row[q0 + i] : 0.f;
        sDelta[i] = in ? delta_row[q0 + i] : 0.f;
      }
      __syncthreads();

      // 16 q rows at a time: S^T and dP^T for n-tiles 2c and 2c+1, then
      // P^T and dS^T as the A fragments of k-step c of dV += P^T dO and
      // dK += dS^T Q.
#pragma unroll
      for (int c = 0; c < kBlockQ / 16; ++c) {
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[jj][e] = 0.f;
            dpt[jj][e] = 0.f;
          }
        }
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t ak[4], av[4];
          load_a<H>(ak, sK, r0, ks, g, t);
          load_a<H>(av, sV, r0, ks, g, t);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int row = ((2 * c + jj) * 8 + g) * kLd + ks * 16 + t * 2;
            mma_bf16_16816(st[jj], ak, ld32(&sQ[row]), ld32(&sQ[row + 8]));
            mma_bf16_16816(dpt[jj], av, ld32(&sD[row]), ld32(&sD[row + 8]));
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
            const float p = ok ? expf(st[jj][e] * scale - sLse[col]) : 0.f;
            st[jj][e] = p;
            dpt[jj][e] = p * (dpt[jj][e] - sDelta[col]) * scale;
          }
        }
        const uint32_t ap[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                                pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
        const uint32_t ads[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                                 pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
        const int qk = c * 16 + t * 2;
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          const int col = dt * 8 + g;
          mma_bf16_16816(dv_acc[dt], ap, col_pair(sD, kLd, qk, col), col_pair(sD, kLd, qk + 8, col));
          mma_bf16_16816(dk_acc[dt], ads, col_pair(sQ, kLd, qk, col), col_pair(sQ, kLd, qk + 8, col));
        }
      }
    }
  }

  store_rows<H>(dk + b * dk_sb + kvh * dk_sn, dk_ss, dk_acc, kj, Sk, t);
  store_rows<H>(dv + b * dv_sb + kvh * dv_sn, dv_ss, dv_acc, kj, Sk, t);
}

bool shapes_ok(int B, int Sq, int Sk, int N, int Nkv) {
  return B > 0 && Sq > 0 && Sk > 0 && Nkv > 0 && N % Nkv == 0;
}

template <int H>
int launch_dkv(const dim3& grid, cudaStream_t s, const uint16_t* q, const uint16_t* k,
               const uint16_t* v, const uint16_t* d, const float* lse, const float* delta,
               uint16_t* dk, uint16_t* dv, int Sq, int Sk, int N, int group,
               const long long* st, float scale, int causal) {
  constexpr int smem = dkv_smem_bytes<H>();
  // above 48 KB of dynamic shared memory only after opting in, per device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<H><<<grid, kThreads, smem, s>>>(
      q, k, v, d, lse, delta, dk, dv, Sq, Sk, N, group, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
      st[16], st[17], scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() after its launch (0
// when it was accepted), or cudaErrorInvalidValue for shapes the kernel
// does not take.  All pointers are device pointers; strides are in
// elements; lse and delta are contiguous f32 [B, N, Sq].

extern "C" int paddle_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int Sq, int Sk, int N, int Nkv, int H,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn,
    long long dq_sb, long long dq_ss, long long dq_sn,
    float scale, int causal, void* stream) {
  if (!shapes_ok(B, Sq, Sk, N, Nkv)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, N, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  const uint16_t* vp = static_cast<const uint16_t*>(v);
  const uint16_t* dp = static_cast<const uint16_t*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* ep = static_cast<const float*>(delta);
  uint16_t* op = static_cast<uint16_t*>(dq);
  const int group = N / Nkv;
  if (H == 128) {
    flash_bwd_dq_kernel<128><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, dp, lp, ep, op, Sq, Sk, N, group, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
        v_sb, v_ss, v_sn, do_sb, do_ss, do_sn, dq_sb, dq_ss, dq_sn, scale, causal);
  } else if (H == 64) {
    flash_bwd_dq_kernel<64><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, dp, lp, ep, op, Sq, Sk, N, group, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
        v_sb, v_ss, v_sn, do_sb, do_ss, do_sn, dq_sb, dq_ss, dq_sn, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int paddle_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int N, int Nkv, int H,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn,
    long long dk_sb, long long dk_ss, long long dk_sn,
    long long dv_sb, long long dv_ss, long long dv_sn,
    float scale, int causal, void* stream) {
  if (!shapes_ok(B, Sq, Sk, N, Nkv)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sk + kBlockK - 1) / kBlockK, Nkv, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long st[18] = {q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn,
                            do_sb, do_ss, do_sn, dk_sb, dk_ss, dk_sn, dv_sb, dv_ss, dv_sn};
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  const uint16_t* vp = static_cast<const uint16_t*>(v);
  const uint16_t* dp = static_cast<const uint16_t*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* ep = static_cast<const float*>(delta);
  uint16_t* kout = static_cast<uint16_t*>(dk);
  uint16_t* vout = static_cast<uint16_t*>(dv);
  const int group = N / Nkv;
  if (H == 128) {
    return launch_dkv<128>(grid, s, qp, kp, vp, dp, lp, ep, kout, vout, Sq, Sk, N, group, st,
                           scale, causal);
  }
  if (H == 64) {
    return launch_dkv<64>(grid, s, qp, kp, vp, dp, lp, ep, kout, vout, Sq, Sk, N, group, st,
                          scale, causal);
  }
  return (int)cudaErrorInvalidValue;
}
