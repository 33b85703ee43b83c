// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _fwd): blockwise online-softmax attention that writes O and
// the per-row logsumexp, causal bottom-right aligned when Sq != Sk, KV
// tiles past the diagonal skipped, mask value -0.7 * FLT_MAX, GQA by
// reading kv-head n / group.
//
// What bounds it on the card: at prefill lengths (S of several hundred to
// thousands, head_dim 128) operations.  Each (q, k) pair costs 4*H flops
// against 2*H bf16 bytes per q or k row, so the work outgrows the bytes
// linearly in S and crosses the H100's ~295 operations per byte near
// S = 300 for a causal head.  What the design does about it:
//   * the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate) instead of FMA units;
//   * one thread block (4 warps) per (64-row q tile, head, batch); each
//     warp owns 16 q rows, keeps its Q fragments, the running max/sum and
//     the output accumulator in registers for the whole KV loop, and
//     feeds the S = QK^T accumulator straight back as the A operand of
//     P V, so neither S nor P ever touches shared or device memory;
//   * K/V tiles of 64 rows are staged in shared memory (2 x 17 KB at
//     H = 128) with a padded row pitch that makes the fragment reads free
//     of bank conflicts, and are read from device memory once per q tile;
//   * KV tiles past the causal diagonal are never loaded.
// Not yet done (a later PR's work): TMA/cp.async double buffering and
// wgmma, which the full tensor-core rate needs.
//
// Ragged lengths are masked in the kernel: keys at or past Sk get
// probability 0 and rows at or past Sq are not stored, so no caller pads.
// Inputs are read through their strides in the public [B, S, N, H] layout
// (unit stride on H, every other stride a multiple of 8 elements, 16-byte
// aligned base); O is written through its strides, lse as f32 [B, N, Sq].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

using paddle_tiles::ld32;
using paddle_tiles::mma_bf16_16816;
using paddle_tiles::pack_bf16;

// Copy rows [row0, row0 + 64) of a [rows, H] strided bf16 matrix into a
// padded shared tile; rows at or past `rows` are zero-filled.
template <int H>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src, int64_t stride,
                                          int row0, int rows) {
  paddle_tiles::load_rows<H, kBlockK, kThreads>(dst, src, stride, row0, rows);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int N, int group,
                 int64_t q_sb, int64_t q_ss, int64_t q_sn,
                 int64_t k_sb, int64_t k_ss, int64_t k_sn,
                 int64_t v_sb, int64_t v_ss, int64_t v_sn,
                 int64_t o_sb, int64_t o_ss, int64_t o_sn,
                 float scale, int causal) {
  constexpr int kLd = H + 8;       // padded pitch: conflict-free fragment reads
  constexpr int kSteps = H / 16;   // k-steps of QK^T over the head dim
  constexpr int kDTiles = H / 8;   // n-tiles of PV over the head dim
  constexpr int kNTiles = kBlockK / 8;

  __shared__ __align__(16) uint16_t sK[kBlockK * kLd];
  __shared__ __align__(16) uint16_t sV[kBlockK * kLd];

  const int qt = blockIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread within the group
  const int q0 = qt * kBlockQ;
  const int q_off = Sk - Sq;  // bottom-right causal alignment

  const uint16_t* qb = q + b * q_sb + n * q_sn;
  const uint16_t* kb = k + b * k_sb + kvh * k_sn;
  const uint16_t* vb = v + b * v_sb + kvh * v_sn;

  // Stage the Q tile through sK, then hold this warp's 16 rows as mma A
  // fragments in registers for the whole KV loop.
  load_tile<H>(sK, qb, q_ss, q0, Sq);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    qf[ks][0] = ld32(&sK[r0 * kLd + ks * 16 + t * 2]);
    qf[ks][1] = ld32(&sK[(r0 + 8) * kLd + ks * 16 + t * 2]);
    qf[ks][2] = ld32(&sK[r0 * kLd + ks * 16 + 8 + t * 2]);
    qf[ks][3] = ld32(&sK[(r0 + 8) * kLd + ks * 16 + 8 + t * 2]);
  }
  __syncthreads();

  // This thread's two rows: fragment elements 0,1 lie on row g, 2,3 on g+8.
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  int n_kv = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    // only KV tiles that start at or before the tile's last aligned q row
    const int last = q0 + kBlockQ - 1 + q_off;
    n_kv = min(n_kv, last < 0 ? 0 : last / kBlockK + 1);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    load_tile<H>(sK, kb, k_ss, k0, Sk);
    load_tile<H>(sV, vb, v_ss, k0, Sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows against the tile's 64 keys.
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint16_t* krow = &sK[(nt * 8 + g) * kLd + t * 2];
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        mma_bf16_16816(s[nt], qf[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
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
    // A fragment of k-step kk, rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + t * 2;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int col = dt * 8 + g;
        const uint32_t b0 = (uint32_t)sV[key * kLd + col] |
                            ((uint32_t)sV[(key + 1) * kLd + col] << 16);
        const uint32_t b1 = (uint32_t)sV[(key + 8) * kLd + col] |
                            ((uint32_t)sV[(key + 9) * kLd + col] << 16);
        mma_bf16_16816(acc[dt], a, b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

  uint16_t* ob = o + b * o_sb + n * o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    if (qi[r] >= Sq) continue;
    const float inv = 1.f / l_safe;
    uint16_t* orow = ob + qi[r] * o_ss;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((int64_t)b * N + n) * Sq + qi[r]] = m[r] + logf(l_safe);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 when
// it was accepted), or cudaErrorInvalidValue for shapes the kernel does not
// take.  All pointers are device pointers; strides are in elements.
extern "C" int paddle_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int Sq, int Sk, int N, int Nkv, int H,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn,
    float scale, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Nkv <= 0 || N % Nkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, N, B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  const uint16_t* vp = static_cast<const uint16_t*>(v);
  uint16_t* op = static_cast<uint16_t*>(o);
  float* lp = static_cast<float*>(lse);
  const int group = N / Nkv;
  if (H == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, op, lp, Sq, Sk, N, group, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
        v_sb, v_ss, v_sn, o_sb, o_ss, o_sn, scale, causal);
  } else if (H == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(
        qp, kp, vp, op, lp, Sq, Sk, N, group, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn,
        v_sb, v_ss, v_sn, o_sb, o_ss, o_sn, scale, causal);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
