// The serving chains for Hopper (sm_90a): the decode chain (write the new
// token's K and V into the paged pools, then attend over the pools) and
// the chunked-prefill attention core.
//
// Replaces the TPU kernels of paddle_tpu/ops/decode_chain.py:
//   decode_chain_batch  <- _build_batch (:504, kernel body :529)
//   decode_chain_rows   <- _build_rows  (:574, kernel body :605)
//   prefill_chain       <- _build_prefill (:917, kernel body :936)
//
// What bounds them on this card: the decode chain reads every live K/V
// position of every row once (2 x H bytes per position and kv head in
// bf16, H in int8 plus a scale per page) and does 4 x H flops per
// position and query head, about one flop per byte: bytes, far below the
// H100's ~295 operations per byte.  The TPU kernels keep the whole pool in
// VMEM and gather the whole table width, masking the dead tail; here each
// block reads only the pages of its row's live positions [0, lens), straight
// from device memory, dequantizes int8 pages by their scale as they land in
// shared memory, and shares every K/V page load across the N / Nkv query
// heads of its GQA group.  The prefill chain at chunk 128 against a cache
// of a few hundred positions is near the balance point; it runs on the
// tensor cores (mma.sync, bf16 in, f32 accumulate) like
// flash_attention_fwd.cu, with an f32 path on plain FMA for f32 models.
// Not yet done (a later PR's work): cp.async/TMA double buffering and
// wgmma.
//
// The pool write is race-free only because of the serving allocator's
// invariant (the same one _build_rows relies on, decode_chain.py:574-580):
// every batch row owns the pages its table names, and every masked lane
// writes its own scratch page with lens = 1.  So the blocks of different
// rows never touch one page, and the blocks of one row touch different kv
// heads of it.  Within a block the write happens before a barrier and the
// attention reads the pool after it.  The pool pointers are not declared
// const __restrict__, so their loads stay coherent with the block's own
// stores.
//
// Bit-exact int8 writes.  An int8 write replays
// paddle_tpu_torch/ops/paged_attention.py:_quant_write_chunk in the same
// order: the token's amax over 127 (IEEE division); new_s = max(old_s, tok);
// safe = max(new_s, 1e-12); rescale the touched [bs, H] page by old_s / safe
// if and only if new_s > old_s; quantize the token as rint(x / safe) clipped
// to +-127.  This file is built without --use_fast_math and never
// multiplies by a reciprocal, so the pools equal the plain version's bit
// for bit.  The attention output is held within a tolerance: the sums run
// in another order than torch's einsum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using paddle_tiles::ld32;
using paddle_tiles::mma_bf16_16816;
using paddle_tiles::pack_bf16;

constexpr int kTK = 32;            // key positions per shared tile (one per lane)
constexpr int kThreads = 128;      // decode chain block
constexpr int kMaxGroup = 8;       // query heads per kv head the decode chain takes
constexpr float kQMax = 127.f;
constexpr float kEps = 1e-12f;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float& d, float x) { d = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16& d, float x) { d = __float2bfloat16(x); }

// Eight consecutive elements as f32 (16-byte aligned for bf16, 8 for int8).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = (float)c[i];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// One tile of online-softmax attention of R query rows against kTK keys,
// all f32 in shared memory: sQ [R][H], sK [kTK][H + 1] (padded: the lanes
// of a warp read one column of 32 rows), sV [kTK][H], sS [R][kTK] scores
// then probabilities, sM / sL / sA the running max, sum and this tile's
// rescale per row.  `valid(r, k)` says whether key k of the tile is
// visible to row r.  NT threads; each owns MAXE (row, column) elements of
// the output accumulator `acc`.

template <int H, int NT, class Valid>
__device__ __forceinline__ void tile_scores(const float* sQ, const float* sK, float* sS, int R,
                                            float scale, Valid valid) {
  for (int idx = threadIdx.x; idx < R * kTK; idx += NT) {
    const int r = idx / kTK, k = idx % kTK;
    float s = -INFINITY;
    if (valid(r, k)) {
      const float* qr = sQ + r * H;
      const float* kr = sK + k * (H + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < H; ++d) dot = fmaf(qr[d], kr[d], dot);
      s = dot * scale;
    }
    sS[idx] = s;
  }
}

template <int NT>
__device__ __forceinline__ void tile_softmax(float* sS, float* sM, float* sL, float* sA, int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NT / 32) {
    const float s = sS[r * kTK + lane];
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, warp_max(s));
    // a row that has seen no visible key yet keeps m = -inf, p = 0
    const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
    const float p = s == -INFINITY ? 0.f : expf(s - m_new);
    const float sum = warp_sum(p);
    sS[r * kTK + lane] = p;
    if (lane == 0) {
      sM[r] = m_new;
      sL[r] = sL[r] * alpha + sum;
      sA[r] = alpha;
    }
  }
}

template <int H, int NT, int MAXE>
__device__ __forceinline__ void tile_accumulate(float (&acc)[MAXE], const float* sS,
                                                const float* sV, const float* sA, int R) {
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int idx = threadIdx.x + e * NT;
    if (idx < R * H) {
      const int r = idx / H, d = idx % H;
      const float* p = sS + r * kTK;
      float a = acc[e] * sA[r];
#pragma unroll 8
      for (int k = 0; k < kTK; ++k) a = fmaf(p[k], sV[k * H + d], a);
      acc[e] = a;
    }
  }
}

// ---------------------------------------------------------------------------
// The decode chain.  Grid (Nkv, B, splits); block kThreads.  Block (kvh, b,
// sp) owns kv head kvh of row b and the page-aligned span sp of its live
// positions [0, lens[b]).  With splits == 1 (decode_chain_batch) the span is
// the whole row and the block writes o; with splits > 1
// (decode_chain_rows) it writes its f32 partial (m, l, unnormalized acc)
// and combine_partials finishes the row.  The block whose span holds the
// row's last position writes the new token first; spans are whole pages,
// so no other block reads the page that write touches.


__device__ __forceinline__ int8_t quantize(float x) {
  return (int8_t)fminf(fmaxf(rintf(x), -kQMax), kQMax);
}

// A pool in the model's dtype: one warp copies the token into its slot.
template <class IO>
__device__ __forceinline__ void write_token(IO* page, float* /*scale*/, const IO* tok, int slot,
                                            int /*bs*/, int H) {
  for (int d = threadIdx.x & 31; d < H; d += 32) page[slot * H + d] = tok[d];
}

// An int8 pool: one warp replays _quant_write_chunk for one token of one kv
// head.  `page` is the touched [bs, H] page, `scale` its f32 scale.
template <class IO>
__device__ __forceinline__ void write_token(int8_t* page, float* scale, const IO* tok, int slot,
                                            int bs, int H) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int d = lane; d < H; d += 32) amax = fmaxf(amax, fabsf(to_float(tok[d])));
  amax = warp_max(amax);
  const float old_s = *scale;
  const float new_s = fmaxf(old_s, amax / kQMax);
  const float safe = fmaxf(new_s, kEps);
  if (new_s > old_s) {
    const float ratio = old_s / safe;
    for (int i = lane; i < bs * H; i += 32) page[i] = quantize((float)page[i] * ratio);
  }
  __syncwarp();
  for (int d = lane; d < H; d += 32) page[slot * H + d] = quantize(to_float(tok[d]) / safe);
  if (lane == 0) *scale = new_s;
}

// Positions [t0, min(t0 + kTK, p1)) of one row's kv head into sK / sV as
// f32, int8 pages dequantized by their scale; positions past p1 are zeros.
template <int H, class PT>
__device__ __forceinline__ void load_paged_tile(float* sK, float* sV, const PT* kpool,
                                                const PT* vpool, const float* kscale,
                                                const float* vscale, const int64_t* trow,
                                                int Nkv, int kvh, int bs, int t0, int p1) {
  constexpr int kChunks = H / 8;
  for (int c = threadIdx.x; c < kTK * kChunks; c += kThreads) {
    const int key = c / kChunks, d = (c % kChunks) * 8, p = t0 + key;
    float kx[8], vx[8];
    if (p < p1) {
      const int64_t blk = trow[p / bs] * Nkv + kvh;
      const int64_t off = (blk * bs + p % bs) * H + d;
      load8(kpool + off, kx);
      load8(vpool + off, vx);
      if (kscale != nullptr) {
        const float ks = kscale[blk], vs = vscale[blk];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          kx[i] *= ks;
          vx[i] *= vs;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kx[i] = vx[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sK[key * (H + 1) + d + i] = kx[i];
      sV[key * H + d + i] = vx[i];
    }
  }
}

struct DecodeArgs {
  void* kpool;
  void* vpool;
  float* kscale;  // null unless the pools are int8
  float* vscale;
  const void* q;   // [B, N, H]
  const void* kn;  // [B, Nkv, H]
  const void* vn;
  const int64_t* tables;  // [B, W]
  const int64_t* lens;    // [B], including this token
  void* o;                // [B, N, H]
  float* ws_m;            // [B, N, splits]      (splits > 1)
  float* ws_l;            // [B, N, splits]
  float* ws_acc;          // [B, N, splits, H]
  int N, Nkv, bs, W, splits;
  float scale;
};

template <class IO, class PT, int H>
__global__ void __launch_bounds__(kThreads) decode_chain_kernel(DecodeArgs a) {
  constexpr int MAXE = kMaxGroup * H / kThreads;
  __shared__ float sQ[kMaxGroup * H];
  __shared__ float sK[kTK * (H + 1)];
  __shared__ float sV[kTK * H];
  __shared__ float sS[kMaxGroup * kTK];
  __shared__ float sM[kMaxGroup], sL[kMaxGroup], sA[kMaxGroup];

  PT* kpool = static_cast<PT*>(a.kpool);
  PT* vpool = static_cast<PT*>(a.vpool);
  const IO* q = static_cast<const IO*>(a.q);
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = a.N / a.Nkv;
  const int L = (int)a.lens[b];
  const int64_t* trow = a.tables + (int64_t)b * a.W;
  const int per = ((L + a.bs - 1) / a.bs + a.splits - 1) / a.splits;  // pages a span
  const int p0 = min(L, sp * per * a.bs);
  const int p1 = min(L, (sp + 1) * per * a.bs);
  const int pos = L - 1;

  // 1. write the new token (warp 0: K, warp 1: V) -- only the block whose
  //    span holds it, the only block that reads the page it touches
  const int warp = threadIdx.x >> 5;
  if (p0 <= pos && pos < p1 && warp < 2) {
    const int64_t blk = trow[pos / a.bs] * a.Nkv + kvh;
    float* sc = warp == 0 ? a.kscale : a.vscale;
    const IO* tok = static_cast<const IO*>(warp == 0 ? a.kn : a.vn) +
                    ((int64_t)b * a.Nkv + kvh) * H;
    write_token<IO>((warp == 0 ? kpool : vpool) + blk * a.bs * H,
                    sc == nullptr ? nullptr : sc + blk, tok, pos % a.bs, a.bs, H);
  }
  for (int i = threadIdx.x; i < G * H; i += kThreads) {
    sQ[i] = to_float(q[((int64_t)b * a.N + kvh * G) * H + i]);
  }
  if (threadIdx.x < G) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }
  __syncthreads();

  // 2. attend over the span, one tile of kTK positions at a time
  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;
  for (int t0 = p0; t0 < p1; t0 += kTK) {
    load_paged_tile<H>(sK, sV, kpool, vpool, a.kscale, a.vscale, trow, a.Nkv, kvh, a.bs, t0, p1);
    __syncthreads();
    tile_scores<H, kThreads>(sQ, sK, sS, G, a.scale,
                             [&](int, int k) { return t0 + k < p1; });
    __syncthreads();
    tile_softmax<kThreads>(sS, sM, sL, sA, G);
    __syncthreads();
    tile_accumulate<H, kThreads, MAXE>(acc, sS, sV, sA, G);
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    if (idx >= G * H) continue;
    const int g = idx / H, d = idx % H;
    const int64_t row = (int64_t)b * a.N + kvh * G + g;
    if (a.splits == 1) {
      const float l = sL[g];
      from_float(static_cast<IO*>(a.o)[row * H + d], acc[e] / (l == 0.f ? 1.f : l));
    } else {
      const int64_t part = row * a.splits + sp;
      a.ws_acc[part * H + d] = acc[e];
      if (d == 0) {
        a.ws_m[part] = sM[g];
        a.ws_l[part] = sL[g];
      }
    }
  }
}

// decode_chain_rows' second step: merge the splits' partials of one (row,
// query head).  Grid (N, B); block H.  Empty spans carry m = -inf, l = 0.
template <class IO>
__global__ void combine_partials(DecodeArgs a, int H) {
  const int n = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int64_t row = (int64_t)b * a.N + n;
  const int64_t base = row * a.splits;
  float m = -INFINITY;
  for (int s = 0; s < a.splits; ++s) m = fmaxf(m, a.ws_m[base + s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float ms = a.ws_m[base + s];
    const float w = ms == -INFINITY ? 0.f : expf(ms - m);
    l += w * a.ws_l[base + s];
    acc += w * a.ws_acc[(base + s) * H + d];
  }
  from_float(static_cast<IO*>(a.o)[row * H + d], acc / (l == 0.f ? 1.f : l));
}

template <class IO, class PT, int H>
int launch_decode(const DecodeArgs& a, int B, cudaStream_t s) {
  decode_chain_kernel<IO, PT, H><<<dim3(a.Nkv, B, a.splits), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  combine_partials<IO><<<dim3(a.N, B), H, 0, s>>>(a, H);
  return (int)cudaGetLastError();
}

template <class IO, int H>
int launch_decode_pool(const DecodeArgs& a, int B, int pool_int8, cudaStream_t s) {
  return pool_int8 ? launch_decode<IO, int8_t, H>(a, B, s) : launch_decode<IO, IO, H>(a, B, s);
}

// ---------------------------------------------------------------------------
// The prefill chain: q [S, N, H] of a chunk against k/v [T, N, H] (batch 1,
// K/V already repeated over the GQA group), bottom-right causal: key j is
// visible to query i iff j <= i + T - S.  Grid (S / BQ, N).

// bf16: one warp per 16 query rows on the tensor cores, as
// flash_attention_fwd.cu; the Q tile is staged through the K/V tiles.
template <int H, int BQ>
__global__ void __launch_bounds__(BQ * 2)
prefill_chain_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int S, int T,
                   int64_t q_ss, int64_t q_sn, int64_t k_ss, int64_t k_sn, int64_t v_ss,
                   int64_t v_sn, int64_t o_ss, int64_t o_sn, float scale) {
  constexpr int kNT = BQ * 2;
  constexpr int kBK = 64;
  constexpr int kLd = H + 8;
  constexpr int kSteps = H / 16;
  constexpr int kDTiles = H / 8;
  constexpr int kNTiles = kBK / 8;
  static_assert(BQ <= 2 * kBK, "the Q tile is staged through the K and V tiles");
  __shared__ __align__(16) uint16_t sKV[2 * kBK * kLd];
  uint16_t* sK = sKV;
  uint16_t* sV = sKV + kBK * kLd;

  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int q_off = T - S;
  const uint16_t* qb = q + n * q_sn;
  const uint16_t* kb = k + n * k_sn;
  const uint16_t* vb = v + n * v_sn;

  paddle_tiles::load_rows<H, BQ, kNT>(sKV, qb, q_ss, q0, S);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    qf[ks][0] = ld32(&sKV[r0 * kLd + ks * 16 + t * 2]);
    qf[ks][1] = ld32(&sKV[(r0 + 8) * kLd + ks * 16 + t * 2]);
    qf[ks][2] = ld32(&sKV[r0 * kLd + ks * 16 + 8 + t * 2]);
    qf[ks][3] = ld32(&sKV[(r0 + 8) * kLd + ks * 16 + 8 + t * 2]);
  }
  __syncthreads();

  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};

  // only K/V tiles that start at or before the tile's last aligned row
  const int last = q0 + BQ - 1 + q_off;
  const int n_kv = min((T + kBK - 1) / kBK, last < 0 ? 0 : last / kBK + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    paddle_tiles::load_rows<H, kBK, kNT>(sK, kb, k_ss, k0, T);
    paddle_tiles::load_rows<H, kBK, kNT>(sV, vb, v_ss, k0, T);
    __syncthreads();

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
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kj = k0 + nt * 8 + t * 2 + (e & 1);
        float val = s[nt][e] * scale;
        if (kj >= T) {
          val = -INFINITY;
        } else if (kj > qi[r] + q_off) {
          val = kMaskValue;
        }
        s[nt][e] = val;
        mx[r] = fmaxf(mx[r], val);
      }
    }
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
    // O += P V: the S accumulator of n-tiles 2kk, 2kk+1 is the A fragment
    // of k-step kk, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
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
        mma_bf16_16816(acc[dt], af, b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites sK / sV
  }

  uint16_t* ob = o + n * o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qi[r] >= S) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    uint16_t* orow = ob + qi[r] * o_ss;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
  }
}

// f32: plain FMA over shared tiles (the decode chain's tile routines with
// BQ query rows), 256 threads, dynamic shared memory.
constexpr int kF32Threads = 256;

template <int H, int BQ>
constexpr int prefill_f32_smem() {
  return (BQ * H + kTK * (H + 1) + kTK * H + BQ * kTK + 3 * BQ) * 4;
}

template <int H, int BQ>
__global__ void __launch_bounds__(kF32Threads)
prefill_chain_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int T,
                  int64_t q_ss, int64_t q_sn, int64_t k_ss, int64_t k_sn, int64_t v_ss,
                  int64_t v_sn, int64_t o_ss, int64_t o_sn, float scale) {
  constexpr int NT = kF32Threads;
  constexpr int MAXE = BQ * H / NT;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // [BQ][H]
  float* sK = sQ + BQ * H;           // [kTK][H + 1]
  float* sV = sK + kTK * (H + 1);    // [kTK][H]
  float* sS = sV + kTK * H;          // [BQ][kTK]
  float* sM = sS + BQ * kTK;
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int n = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int q_off = T - S;
  for (int i = threadIdx.x; i < BQ * H; i += NT) {
    const int r = i / H, d = i % H;
    sQ[i] = q0 + r < S ? q[(int64_t)(q0 + r) * q_ss + n * q_sn + d] : 0.f;
  }
  for (int r = threadIdx.x; r < BQ; r += NT) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;
  const int last = q0 + BQ - 1 + q_off;
  const int n_kv = min((T + kTK - 1) / kTK, last < 0 ? 0 : last / kTK + 1);
  __syncthreads();
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTK;
    for (int i = threadIdx.x; i < kTK * H; i += NT) {
      const int kk = i / H, d = i % H, row = k0 + kk;
      sK[kk * (H + 1) + d] = row < T ? k[(int64_t)row * k_ss + n * k_sn + d] : 0.f;
      sV[kk * H + d] = row < T ? v[(int64_t)row * v_ss + n * v_sn + d] : 0.f;
    }
    __syncthreads();
    tile_scores<H, NT>(sQ, sK, sS, BQ, scale, [&](int r, int kk) {
      const int key = k0 + kk;
      return key < T && key <= q0 + r + q_off;
    });
    __syncthreads();
    tile_softmax<NT>(sS, sM, sL, sA, BQ);
    __syncthreads();
    tile_accumulate<H, NT, MAXE>(acc, sS, sV, sA, BQ);
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int idx = threadIdx.x + e * NT;
    const int r = idx / H, d = idx % H;
    if (q0 + r >= S) continue;
    const float l = sL[r];
    o[(int64_t)(q0 + r) * o_ss + n * o_sn + d] = acc[e] / (l == 0.f ? 1.f : l);
  }
}

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T;
  int64_t q_ss, q_sn, k_ss, k_sn, v_ss, v_sn, o_ss, o_sn;
  float scale;
};

template <int H, int BQ>
int launch_prefill(const PrefillArgs& a, int N, int io_f32, cudaStream_t s) {
  const dim3 grid((a.S + BQ - 1) / BQ, N);
  if (io_f32) {
    constexpr int smem = prefill_f32_smem<H, BQ>();
    cudaError_t err = cudaFuncSetAttribute(prefill_chain_f32<H, BQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    prefill_chain_f32<H, BQ><<<grid, kF32Threads, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.S, a.T, a.q_ss, a.q_sn,
        a.k_ss, a.k_sn, a.v_ss, a.v_sn, a.o_ss, a.o_sn, a.scale);
  } else {
    prefill_chain_bf16<H, BQ><<<grid, BQ * 2, 0, s>>>(
        static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
        static_cast<const uint16_t*>(a.v), static_cast<uint16_t*>(a.o), a.S, a.T, a.q_ss,
        a.q_sn, a.k_ss, a.k_sn, a.v_ss, a.v_sn, a.o_ss, a.o_sn, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int H>
int launch_prefill_bq(const PrefillArgs& a, int N, int block_q, int io_f32, cudaStream_t s) {
  if (block_q == 64) return launch_prefill<H, 64>(a, N, io_f32, s);
  if (block_q == 128) return launch_prefill<H, 128>(a, N, io_f32, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The decode chain on `stream`: splits == 1 is decode_chain_batch (one
// launch), splits > 1 decode_chain_rows (the split kernel, then the
// combine).  Pools are updated in place.  Returns cudaGetLastError() after
// the launches (0 when accepted), or cudaErrorInvalidValue for shapes the
// kernels do not take.  io_f32: q/k_new/v_new/o (and a non-int8 pool) are
// f32, else bf16; pool_int8: int8 pools with f32 scales [NB, Nkv].
extern "C" int paddle_decode_chain(void* kpool, void* vpool, void* kscale, void* vscale,
                                   const void* q, const void* kn, const void* vn,
                                   const void* tables, const void* lens, void* o, void* ws_m,
                                   void* ws_l, void* ws_acc, int B, int N, int Nkv, int H,
                                   int bs, int W, int splits, int io_f32, int pool_int8,
                                   float scale, void* stream) {
  if (B <= 0 || Nkv <= 0 || N % Nkv != 0 || N / Nkv > kMaxGroup || bs <= 0 || W <= 0 ||
      splits < 1 || (pool_int8 && (kscale == nullptr || vscale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeArgs a{kpool, vpool, static_cast<float*>(kscale), static_cast<float*>(vscale), q, kn,
               vn, static_cast<const int64_t*>(tables), static_cast<const int64_t*>(lens), o,
               static_cast<float*>(ws_m), static_cast<float*>(ws_l),
               static_cast<float*>(ws_acc), N, Nkv, bs, W, splits, scale};
  if (!pool_int8) a.kscale = a.vscale = nullptr;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (H == 128) {
    return io_f32 ? launch_decode_pool<float, 128>(a, B, pool_int8, s)
                  : launch_decode_pool<__nv_bfloat16, 128>(a, B, pool_int8, s);
  }
  if (H == 64) {
    return io_f32 ? launch_decode_pool<float, 64>(a, B, pool_int8, s)
                  : launch_decode_pool<__nv_bfloat16, 64>(a, B, pool_int8, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The prefill chain on `stream` (batch 1; strides in elements of the
// [1, S, N, H] / [1, T, N, H] layouts).  Same return convention.
extern "C" int paddle_prefill_chain(const void* q, const void* k, const void* v, void* o,
                                    int S, int T, int N, int H, long long q_ss, long long q_sn,
                                    long long k_ss, long long k_sn, long long v_ss,
                                    long long v_sn, long long o_ss, long long o_sn,
                                    int block_q, int io_f32, float scale, void* stream) {
  if (S <= 0 || T < S || N <= 0) return (int)cudaErrorInvalidValue;
  PrefillArgs a{q, k, v, o, S, T, q_ss, q_sn, k_ss, k_sn, v_ss, v_sn, o_ss, o_sn, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (H == 128) return launch_prefill_bq<128>(a, N, block_q, io_f32, s);
  if (H == 64) return launch_prefill_bq<64>(a, N, block_q, io_f32, s);
  return (int)cudaErrorInvalidValue;
}
