// Flash-attention backward designed for Hopper (sm_90a): TMA loads into an
// mbarrier ring, wgmma for every product, one producer and two consumer
// warpgroups in each of two kernels.  bf16 or f16 in, f32 accumulation,
// head_dim 64 or 128.
//
// Replaces the TPU kernels paddle_tpu/ops/flash_attention.py:_bwd_dq_kernel
// and _bwd_dkv_kernel (launched by _bwd) on the layouts TMA can read: unit
// stride on H, every other stride a multiple of 16 bytes, a 16-byte aligned
// base, for q, k, v, dO and O alike.  Everything else (f32, other head
// dims, other strides) takes the general kernels of flash_attention_bwd.cu;
// ops/flash_attention.py:_bwd_route picks the route before any launch.
// Both kernels recompute the probabilities from the forward's logsumexp:
//   P  = exp(scale * Q K^T - lse)          (masked pairs: 0)
//   dP = dO V^T
//   dS = P * (dP - delta),                 delta = rowsum(O * dO), f32
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO.
// Semantics are the general kernels': causal bottom-right aligned when
// Sq != Sk; a causal row that sees no key (Sq > Sk, rows i < Sq - Sk) adds
// dO / Sk to every key's dV and nothing to dQ or dK (the forward gave it
// the mean of V; jax.grad of the JAX package's plain reference gives the
// same), and only the q tiles that hold such rows pay for it; rows past Sq
// and keys past Sk are neither counted nor stored, GQA reads kv head
// n / group, gradients are written with unit stride on H through their
// other strides.
//
// What bounds it on the card: operations.  The dQ kernel does 3 products
// of 2 H flops per visible (q, k) pair (S, dP, dS K), the dK/dV kernel 4
// (S^T, dP^T, P^T dO, dS^T Q): 7 in all, 60 GFLOP causal at the training
// shape [4, 1024, 16, 128], against a few bytes a row.  What the design
// does about it:
//   * every product runs on wgmma, both operands of S and dP (S^T and
//     dP^T) read from shared memory through descriptors (SS), the second
//     product's A operand (dS, or P^T and dS^T) taken from registers (RS):
//     the accumulator layout of m64nN is the A-fragment layout of m64k16,
//     so they are converted pairwise to 16 bits in place, and the B
//     operand (K, or dO and Q) is read MN-major through the transpose bit;
//   * dQ kernel: a block owns 128 q rows of one head; consumer warpgroups
//     0 and 1 take 64 rows each and warpgroup 2 produces: its one elected
//     thread loads Q and dO once and streams 128-key K and V tiles through
//     a ring of two stages (a full mbarrier counting bytes and an empty one
//     counting the 8 consumer warps), so the next tile's loads overlap this
//     tile's products.  S, dP and dQ hold 64 + 64 + 64 f32 a thread;
//   * delta is folded into the dQ kernel: before the K/V loop each
//     consumer reads the O and dO rows of its q rows with 16-byte loads and
//     sums O * dO in f32; it writes delta and lse * log2(e) as f32
//     [B, N, 2, Sq rounded up to 64] (rows past Sq: +inf and 0, so they
//     weigh 0), which the dK/dV kernel, launched after it on the same
//     stream, reads by one bulk copy a tile;
//   * dK/dV kernel: a block owns 128 keys of one kv head, the two consumer
//     warpgroups 64 keys each; K and V are loaded once and the producer
//     streams tiles of 64 q rows (Q, dO and their lse and delta) through a
//     ring of three stages from the causal start over every q head of the
//     GQA group, so dK and dV are summed over the group in registers (no
//     atomics, no [B, N, Sk, H] intermediate; but a block per 128 keys of
//     a kv head, so GQA launches group times fewer blocks).  dK and dV
//     hold 64 + 64 f32 a thread, S^T and dP^T 32 + 32 (m64n64k16, both
//     operands K-major);
//   * probabilities in the log2 domain: scale * log2(e) folded into one FMA
//     before ex2.approx, scale itself applied once to dQ and dK at the end;
//   * tiles every row and key of a warpgroup sees whole skip the mask
//     compares; only the causal diagonal and the ragged edges pay for them;
//   * causal: the heaviest tiles launch first (the last q tiles for dQ,
//     the first key tiles for dK/dV) across all heads; otherwise a head's
//     tiles stay adjacent in launch order, so that what they share is
//     re-read from L2.
// Shared memory at H = 128: dQ 32 KB of Q, 32 KB of dO and two stages of
// 32 KB K + 32 KB V (192 KB); dK/dV 32 KB of K, 32 KB of V and three
// stages of 16 KB Q + 16 KB dO + 512 bytes of lse and delta (162 KB).
// Tensor maps are encoded on the host at every launch (hopper_tiles.cuh:
// encode).
//
// Traps (the forward's, flash_attention_fwd_sm90.cu, and one more):
//   * TMA zero-fills rows past Sq and keys past Sk, and a zero row scores
//     0, not -inf: the masked tiles keep explicit compares;
//   * the setmaxnreg totals stay below the SM's 65,536 registers (40 x 128
//     + 232 x 256 = 64,512);
//   * a warpgroup that sees nothing of a tile still waits for the tile's
//     full barrier before it releases the stage: a warp arriving on the
//     empty barrier of tile t + stages before the phase of tile t completed
//     would count toward that phase (dK/dV with GQA skips a tile at the
//     start of every q head, so skips come as many tiles apart as a head
//     has).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace paddle_hopper;
using paddle_tiles::pack2;
using paddle_tiles::to_float;

constexpr int kThreads = 384;    // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int kRowBytes = 128;   // a swizzled row: 64 16-bit columns
constexpr int kConsumerWarps = 8;
constexpr int kDqStages = 2;     // K/V ring depth (dQ)
constexpr int kKvStages = 3;     // Q/dO ring depth (dK/dV; 2 stages: 2.5 % slower)
constexpr int kQRows = 128;      // dQ kernel: q rows a block
constexpr int kKeys = 128;       // dQ kernel: keys a K/V tile; dK/dV kernel: keys a block
constexpr int kTileQ = 64;       // dK/dV kernel: q rows a tile
constexpr int kStatPad = 64;     // the stats rows are padded to this
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int H>
struct DqLayout {
  static constexpr int kQSub = kQRows * kRowBytes;  // a 64-column sub-tile of Q or dO
  static constexpr int kKSub = kKeys * kRowBytes;   // of a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kQSub * (H / 64);
  static constexpr int kK = 2 * kDO;
  static constexpr int kV = kK + kDqStages * kKSub * (H / 64);
  static constexpr int kBar = kV + kDqStages * kKSub * (H / 64);
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kDqStages) + 1024;  // + alignment slack
};

template <int H>
struct DkvLayout {
  static constexpr int kKSub = kKeys * kRowBytes;   // a 64-column sub-tile of K or V
  static constexpr int kQSub = kTileQ * kRowBytes;  // of a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kKSub * (H / 64);
  static constexpr int kQ = 2 * kV;
  static constexpr int kDO = kQ + kKvStages * kQSub * (H / 64);
  static constexpr int kStat = kDO + kKvStages * kQSub * (H / 64);  // lse2[64], delta[64] a stage
  static constexpr int kBar = kStat + kKvStages * 2 * kTileQ * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kKvStages) + 1024;
};

// sum(a * b) of eight 16-bit values each, in f32.
template <bool F16>
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint16_t* x = reinterpret_cast<const uint16_t*>(&a);
  const uint16_t* y = reinterpret_cast<const uint16_t*>(&b);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) s = fmaf(to_float<F16>(x[e]), to_float<F16>(y[e]), s);
  return s;
}

// Store a thread's two rows of an m64nH accumulator, times `mul`, rounded
// to 16 bits: elements 4 jn + 2 r + {0, 1} are row r, columns 8 jn + 2 tq.
template <bool F16, int H>
__device__ __forceinline__ void store_rows(uint16_t* base, int64_t row_stride,
                                           const float (&acc)[H / 2], const int (&row)[2],
                                           int rows, int tq, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    uint16_t* dst = base + (int64_t)row[r] * row_stride;
#pragma unroll
    for (int jn = 0; jn < H / 8; ++jn) {
      *reinterpret_cast<uint32_t*>(dst + jn * 8 + tq * 2) =
          pack2<F16>(acc[4 * jn + 2 * r] * mul, acc[4 * jn + 2 * r + 1] * mul);
    }
  }
}

// ------------------------------------------------------------------ dQ

template <bool F16, int H>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const uint16_t* __restrict__ o, const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse, uint16_t* __restrict__ dq,
                         float* __restrict__ stats, int Sq, int Sk, int N, int group, int n_qt,
                         int sq_pad, int64_t o_sb, int64_t o_ss, int64_t o_sn, int64_t do_sb,
                         int64_t do_ss, int64_t do_sn, int64_t dq_sb, int64_t dq_ss,
                         int64_t dq_sn, float scale, int causal) {
  using L = DqLayout<H>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* kv_full = bars + 1;
  uint64_t* empty = kv_full + kDqStages;

  // Causal: (head x batch, q tile), the heaviest (last) q tiles of every
  // head first; otherwise (q tile, head, batch).
  const int qt = n_qt - 1 - (int)(causal ? blockIdx.y : blockIdx.x);
  const int n = causal ? blockIdx.x % N : blockIdx.y;
  const int b = causal ? blockIdx.x / N : blockIdx.z;
  const int kvh = n / group;
  const int q0 = qt * kQRows;
  const int q_off = Sk - Sq;  // bottom-right causal alignment
  int n_kv = (Sk + kKeys - 1) / kKeys;
  if (causal) {
    const int last = q0 + kQRows - 1 + q_off;
    n_kv = min(n_kv, last < 0 ? 0 : last / kKeys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128 && n_kv > 0) {
      mbar_expect_tx(q_full, 2 * kQRows * H * 2);
#pragma unroll
      for (int c = 0; c < H / 64; ++c) {
        tma_load_4d(smem + L::kQ + c * L::kQSub, &tm_q, q_full, c * 64, n, q0, b);
        tma_load_4d(smem + L::kDO + c * L::kQSub, &tm_do, q_full, c * 64, n, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kDqStages;
        mbar_wait(&empty[s], ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&kv_full[s], 2 * kKeys * H * 2);
#pragma unroll
        for (int c = 0; c < H / 64; ++c) {
          const int off = s * L::kKSub * (H / 64) + c * L::kKSub;
          tma_load_4d(smem + L::kK + off, &tm_k, &kv_full[s], c * 64, kvh, j * kKeys, b);
          tma_load_4d(smem + L::kV + off, &tm_v, &kv_full[s], c * 64, kvh, j * kKeys, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;   // accumulator row group
    const int tq = lane % 4;  // thread within the row group
    const int qw0 = q0 + wg * 64;
    // This thread's two rows: accumulator elements 4j + {0, 1} lie on row
    // g of the warp's 16, 4j + {2, 3} on row g + 8; column 8j + 2 tq (+1).
    const int qi[2] = {qw0 + warp * 16 + g, qw0 + warp * 16 + g + 8};
    const float sl2 = scale * kLog2e;

    // delta = rowsum(O * dO) over the row's 4 threads (8 columns in every
    // 32 each), and lse in log2 units; both written for the dK/dV kernel.
    float lse2[2], delta[2];
    float* st = stats + ((int64_t)b * N + n) * 2 * sq_pad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
      if (qi[r] < Sq) {
        const uint16_t* orow = o + b * o_sb + (int64_t)qi[r] * o_ss + n * o_sn;
        const uint16_t* drow = dout + b * do_sb + (int64_t)qi[r] * do_ss + n * do_sn;
#pragma unroll
        for (int c = 0; c < H / 32; ++c) {
          const int col = c * 32 + tq * 8;
          sum += dot8<F16>(*reinterpret_cast<const uint4*>(orow + col),
                           *reinterpret_cast<const uint4*>(drow + col));
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      delta[r] = sum;
      lse2[r] = qi[r] < Sq ? lse[((int64_t)b * N + n) * Sq + qi[r]] * kLog2e : INFINITY;
      if (tq == 0 && qi[r] < sq_pad) {
        st[qi[r]] = lse2[r];
        st[sq_pad + qi[r]] = delta[r];
      }
    }

    // Tiles [0, n_free) every row of this warpgroup sees whole; tiles
    // [n_free, n_need) are masked; tiles past n_need it sees nothing of.
    int n_need = n_kv;
    int n_free = min(n_kv, Sk / kKeys);
    if (causal) {
      const int last = qw0 + 63 + q_off;
      n_need = min(n_kv, last < 0 ? 0 : last / kKeys + 1);
      const int first = qw0 + q_off + 1;  // keys below it are seen by every row
      n_free = min(n_free, first <= 0 ? 0 : first / kKeys);
    }

    float acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
    const uint8_t* sq = smem + L::kQ + wg * 64 * kRowBytes;
    const uint8_t* sdo = smem + L::kDO + wg * 64 * kRowBytes;
    if (n_kv > 0) mbar_wait(q_full, 0);

    auto tile = [&](int j, auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      const int s = j % kDqStages;
      const uint8_t* sk = smem + L::kK + s * L::kKSub * (H / 64);
      const uint8_t* sv = smem + L::kV + s * L::kKSub * (H / 64);

      // S = Q K^T and dP = dO V^T: 64 rows x 128 keys each, H / 16 k-steps
      // of 32 bytes along the swizzled rows, sub-tile by sub-tile.
      float sc[64], dp[64];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const int qo = (ks / 4) * L::kQSub + (ks % 4) * 32;
        const int ko = (ks / 4) * L::kKSub + (ks % 4) * 32;
        wgmma_ss<F16, kKeys>(sc, sw128_desc(sq + qo, 16, 1024), sw128_desc(sk + ko, 16, 1024),
                             ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const int qo = (ks / 4) * L::kQSub + (ks % 4) * 32;
        const int ko = (ks / 4) * L::kKSub + (ks % 4) * 32;
        wgmma_ss<F16, kKeys>(dp, sw128_desc(sdo + qo, 16, 1024), sw128_desc(sv + ko, 16, 1024),
                             ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - delta), rounded to 16 bits: accumulator elements
      // 8kk..8kk+7 are the A fragment of k-step kk of dS K.
      uint32_t af[kKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        float d[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kk + e;
          const int r = (i >> 1) & 1;
          float p;
          if constexpr (kMasked) {
            const int key = j * kKeys + (i >> 2) * 8 + tq * 2 + (i & 1);
            const bool ok = key < Sk && !(causal && key > qi[r] + q_off);
            p = ok ? ex2_approx(fmaf(sc[i], sl2, -lse2[r])) : 0.f;
          } else {
            p = ex2_approx(fmaf(sc[i], sl2, -lse2[r]));
          }
          d[e] = p * (dp[i] - delta[r]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) af[kk][e] = pack2<F16>(d[2 * e], d[2 * e + 1]);
      }

      // dQ += dS K: K MN-major, k-step kk is 16 key rows (2 KB) down the tile.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs<F16, H>(acc, af[kk], sw128_desc(sk + kk * 16 * kRowBytes, L::kKSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    };

    for (int j = 0; j < n_kv; ++j) {
      mbar_wait(&kv_full[j % kDqStages], (j / kDqStages) & 1);
      if (j < n_free) {
        tile(j, std::false_type{});
      } else if (j < n_need) {
        tile(j, std::true_type{});
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kDqStages]);  // this warp is done with the stage
    }

    store_rows<F16, H>(dq + b * dq_sb + n * dq_sn, dq_ss, acc, qi, Sq, tq, scale);
  }
}

// ---------------------------------------------------------------- dK/dV

template <bool F16, int H>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ stats, uint16_t* __restrict__ dk,
                          uint16_t* __restrict__ dv, int Sq, int Sk, int N, int Nkv, int group,
                          int sq_pad, int64_t dk_sb, int64_t dk_ss, int64_t dk_sn, int64_t dv_sb,
                          int64_t dv_ss, int64_t dv_sn, float scale, int causal) {
  using L = DkvLayout<H>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kKvStages;

  // Causal: (kv head x batch, key tile), the heaviest (first) key tiles of
  // every head first; otherwise (key tile, kv head, batch).
  const int kt = causal ? blockIdx.y : blockIdx.x;
  const int kvh = causal ? blockIdx.x % Nkv : blockIdx.y;
  const int b = causal ? blockIdx.x / Nkv : blockIdx.z;
  const int k0 = kt * kKeys;
  const int q_off = Sk - Sq;
  const int n_qt = (Sq + kTileQ - 1) / kTileQ;
  int start = 0;
  if (causal) {
    // q tiles whose last aligned row precedes this block's first key see none of it
    const int first = k0 - q_off;
    start = first <= 0 ? 0 : min(first / kTileQ, n_qt);
  }
  // q tiles that hold rows seeing no key (i < -q_off, only when Sq > Sk):
  // every key block visits them for dV's dO / Sk, before the causal start;
  // the producer and the consumers walk the same tiles
  const int n_nokey = causal && q_off < 0 ? min((-q_off + kTileQ - 1) / kTileQ, n_qt) : 0;
  auto next_qt = [&](int qt) { return qt + 1 < n_nokey ? qt + 1 : max(qt + 1, start); };
  const int first_qt = n_nokey > 0 ? 0 : start;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(kv_full, 2 * kKeys * H * 2);
#pragma unroll
      for (int c = 0; c < H / 64; ++c) {
        tma_load_4d(smem + L::kK + c * L::kKSub, &tm_k, kv_full, c * 64, kvh, k0, b);
        tma_load_4d(smem + L::kV + c * L::kKSub, &tm_v, kv_full, c * 64, kvh, k0, b);
      }
      int t = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int n = kvh * group + gi;
        const float* st = stats + ((int64_t)b * N + n) * 2 * sq_pad;
        for (int qt = first_qt; qt < n_qt; qt = next_qt(qt), ++t) {
          const int s = t % kKvStages;
          const int q0 = qt * kTileQ;
          mbar_wait(&empty[s], ((t / kKvStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * kTileQ * H * 2 + 2 * kTileQ * 4);
#pragma unroll
          for (int c = 0; c < H / 64; ++c) {
            const int off = s * L::kQSub * (H / 64) + c * L::kQSub;
            tma_load_4d(smem + L::kQ + off, &tm_q, &full[s], c * 64, n, q0, b);
            tma_load_4d(smem + L::kDO + off, &tm_do, &full[s], c * 64, n, q0, b);
          }
          uint8_t* sst = smem + L::kStat + s * 2 * kTileQ * 4;
          bulk_load(sst, st + q0, kTileQ * 4, &full[s]);
          bulk_load(sst + kTileQ * 4, st + sq_pad + q0, kTileQ * 4, &full[s]);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int kw0 = k0 + wg * 64;
    // This thread's two keys (the rows of S^T): accumulator elements
    // 4j + {0, 1} on key g of the warp's 16, 4j + {2, 3} on key g + 8;
    // q row 8j + 2 tq (+1) of the tile.
    const int kj[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};
    const float sl2 = scale * kLog2e;
    const uint8_t* sk = smem + L::kK + wg * 64 * kRowBytes;
    const uint8_t* sv = smem + L::kV + wg * 64 * kRowBytes;

    float dk_acc[H / 2], dv_acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    mbar_wait(kv_full, 0);

    const float inv_sk = 1.f / Sk;

    // kNoKey: the tile holds rows that see no key (P = 1 / Sk, dS = 0);
    // only masked tiles can, and only when Sq > Sk.
    auto tile = [&](int s, int q0, auto masked, auto nokey) {
      constexpr bool kMasked = decltype(masked)::value;
      constexpr bool kNoKey = decltype(nokey)::value;
      const uint8_t* sq = smem + L::kQ + s * L::kQSub * (H / 64);
      const uint8_t* sdo = smem + L::kDO + s * L::kQSub * (H / 64);
      const float* s_lse = reinterpret_cast<const float*>(smem + L::kStat + s * 2 * kTileQ * 4);
      const float* s_delta = s_lse + kTileQ;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const int ko = (ks / 4) * L::kKSub + (ks % 4) * 32;
        const int qo = (ks / 4) * L::kQSub + (ks % 4) * 32;
        wgmma_ss<F16, kTileQ>(sc, sw128_desc(sk + ko, 16, 1024), sw128_desc(sq + qo, 16, 1024),
                              ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const int ko = (ks / 4) * L::kKSub + (ks % 4) * 32;
        const int qo = (ks / 4) * L::kQSub + (ks % 4) * 32;
        wgmma_ss<F16, kTileQ>(dp, sw128_desc(sv + ko, 16, 1024), sw128_desc(sdo + qo, 16, 1024),
                              ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T = P^T (dP^T - delta), lse and delta by column (q row),
      // rounded to 16 bits as the A fragments of dV += P^T dO, dK += dS^T Q.
      uint32_t pf[kTileQ / 16][4], df[kTileQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileQ / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // columns 16 kk + 8 h + 2 tq (+1)
          const int col = 16 * kk + 8 * h + 2 * tq;
          const float2 l2 = *reinterpret_cast<const float2*>(s_lse + col);
          const float2 de = *reinterpret_cast<const float2*>(s_delta + col);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 8 * kk + 4 * h + 2 * r;
            float p0, p1;
            if constexpr (kMasked) {
              const int qr = q0 + col;
              const bool ok0 = kj[r] < Sk && qr < Sq && !(causal && kj[r] > qr + q_off);
              const bool ok1 = kj[r] < Sk && qr + 1 < Sq && !(causal && kj[r] > qr + 1 + q_off);
              p0 = ok0 ? ex2_approx(fmaf(sc[i], sl2, -l2.x)) : 0.f;
              p1 = ok1 ? ex2_approx(fmaf(sc[i + 1], sl2, -l2.y)) : 0.f;
            } else {
              p0 = ex2_approx(fmaf(sc[i], sl2, -l2.x));
              p1 = ex2_approx(fmaf(sc[i + 1], sl2, -l2.y));
            }
            df[kk][2 * h + r] = pack2<F16>(p0 * (dp[i] - de.x), p1 * (dp[i + 1] - de.y));
            if constexpr (kNoKey) {  // dS stays 0 there: p0, p1 were 0
              const int qr = q0 + col;
              if (kj[r] < Sk && qr < -q_off && qr < Sq) p0 = inv_sk;
              if (kj[r] < Sk && qr + 1 < -q_off && qr + 1 < Sq) p1 = inv_sk;
            }
            pf[kk][2 * h + r] = pack2<F16>(p0, p1);
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q MN-major, k-step kk is 16 q
      // rows (2 KB) down the tile.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileQ / 16; ++kk) {
        wgmma_rs<F16, H>(dv_acc, pf[kk], sw128_desc(sdo + kk * 16 * kRowBytes, L::kQSub, 1024));
        wgmma_rs<F16, H>(dk_acc, df[kk], sw128_desc(sq + kk * 16 * kRowBytes, L::kQSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    };

    int t = 0;
    for (int gi = 0; gi < group; ++gi) {
      for (int qt = first_qt; qt < n_qt; qt = next_qt(qt), ++t) {
        const int s = t % kKvStages;
        const int q0 = qt * kTileQ;
        mbar_wait(&full[s], (t / kKvStages) & 1);
        const bool whole = kw0 + 63 < Sk && q0 + kTileQ <= Sq &&
                           (!causal || kw0 + 63 <= q0 + q_off);
        const bool seen = kw0 < Sk && (!causal || kw0 <= q0 + kTileQ - 1 + q_off);
        if (qt < n_nokey) {
          if (kw0 < Sk) tile(s, q0, std::true_type{}, std::true_type{});
        } else if (whole) {
          tile(s, q0, std::false_type{}, std::false_type{});
        } else if (seen) {
          tile(s, q0, std::true_type{}, std::false_type{});
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }

    store_rows<F16, H>(dk + b * dk_sb + kvh * dk_sn, dk_ss, dk_acc, kj, Sk, tq, scale);
    store_rows<F16, H>(dv + b * dv_sb + kvh * dv_sn, dv_ss, dv_acc, kj, Sk, tq, 1.f);
  }
}

// Raise a kernel's dynamic shared memory limit once (above 48 KB only
// after opting in).
template <typename Kernel>
int raise_smem(Kernel kernel, int bytes, bool& raised) {
  if (raised) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  raised = true;
  return 0;
}

int stat_rows(int Sq) { return (Sq + kStatPad - 1) / kStatPad * kStatPad; }

struct Maps {
  CUtensorMap q, dout, k, v;
};

template <bool F16, int H>
int launch_dq(const Maps& m, const void* o, const void* dout, const void* lse, void* dq,
              void* stats, int B, int Sq, int Sk, int N, int group, const long long (&st)[9],
              float scale, int causal, cudaStream_t stream) {
  constexpr int smem = DqLayout<H>::kBytes;
  static bool raised = false;
  if (const int err = raise_smem(flash_bwd_dq_sm90_kernel<F16, H>, smem, raised)) return err;
  const int n_qt = (Sq + kQRows - 1) / kQRows;
  if (n_qt > 65535 || (long long)N * B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid = causal ? dim3(N * B, n_qt) : dim3(n_qt, N, B);
  flash_bwd_dq_sm90_kernel<F16, H><<<grid, kThreads, smem, stream>>>(
      m.q, m.dout, m.k, m.v, static_cast<const uint16_t*>(o),
      static_cast<const uint16_t*>(dout), static_cast<const float*>(lse),
      static_cast<uint16_t*>(dq), static_cast<float*>(stats), Sq, Sk, N, group, n_qt,
      stat_rows(Sq), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return (int)cudaGetLastError();
}

template <bool F16, int H>
int launch_dkv(const Maps& m, const void* stats, void* dk, void* dv, int B, int Sq, int Sk,
               int N, int Nkv, const long long (&st)[6], float scale, int causal,
               cudaStream_t stream) {
  constexpr int smem = DkvLayout<H>::kBytes;
  static bool raised = false;
  if (const int err = raise_smem(flash_bwd_dkv_sm90_kernel<F16, H>, smem, raised)) return err;
  const int n_kt = (Sk + kKeys - 1) / kKeys;
  if (n_kt > 65535 || (long long)Nkv * B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid = causal ? dim3(Nkv * B, n_kt) : dim3(n_kt, Nkv, B);
  flash_bwd_dkv_sm90_kernel<F16, H><<<grid, kThreads, smem, stream>>>(
      m.q, m.dout, m.k, m.v, static_cast<const float*>(stats), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), Sq, Sk, N, Nkv, N / Nkv, stat_rows(Sq), st[0], st[1], st[2],
      st[3], st[4], st[5], scale, causal);
  return (int)cudaGetLastError();
}

// The four maps: q and dO in boxes of q_rows rows, k and v of k_rows.
bool encode_all(Maps* m, const void* q, const void* k, const void* v, const void* dout, int f16,
                int B, int Sq, int Sk, int N, int Nkv, int H, const long long (&s)[12],
                int q_rows, int k_rows) {
  return encode(&m->q, q, f16, B, Sq, N, H, s[0], s[1], s[2], q_rows) &&
         encode(&m->k, k, f16, B, Sk, Nkv, H, s[3], s[4], s[5], k_rows) &&
         encode(&m->v, v, f16, B, Sk, Nkv, H, s[6], s[7], s[8], k_rows) &&
         encode(&m->dout, dout, f16, B, Sq, N, H, s[9], s[10], s[11], q_rows);
}

bool shapes_ok(int B, int Sq, int Sk, int N, int Nkv, int H) {
  return B > 0 && Sq > 0 && Sk > 0 && Nkv > 0 && N % Nkv == 0 && (H == 64 || H == 128);
}

bool inputs_ok(const void* q, const void* k, const void* v, const void* dout,
               const long long (&s)[12]) {
  return layout_ok(q, s[0], s[1], s[2]) && layout_ok(k, s[3], s[4], s[5]) &&
         layout_ok(v, s[6], s[7], s[8]) && layout_ok(dout, s[9], s[10], s[11]);
}

bool out_ok(long long sb, long long ss, long long sn) {
  return sb % 2 == 0 && ss % 2 == 0 && sn % 2 == 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 when
// it was accepted), cudaErrorInvalidValue for shapes or layouts the kernel
// does not take, or cudaErrorNotSupported when a tensor map cannot be
// encoded.  q, k, v, o, dout are bf16 (f16 != 0: f16) [B, S, N, H] with
// unit stride on H, strides in elements; lse is f32 [B, N, Sq]; dq has
// q's dtype; stats (written) is f32 [B, N, 2, Sq rounded up to 64]: lse *
// log2(e) and delta = rowsum(O * dO) by row, what the dK/dV kernel reads.
extern "C" int paddle_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* stats, int B, int Sq, int Sk, int N, int Nkv, int H,
    long long q_sb, long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn, long long o_sb,
    long long o_ss, long long o_sn, long long do_sb, long long do_ss, long long do_sn,
    long long dq_sb, long long dq_ss, long long dq_sn, int f16, float scale, int causal,
    void* stream) {
  const long long s[12] = {q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn,
                           do_sb, do_ss, do_sn};
  if (!shapes_ok(B, Sq, Sk, N, Nkv, H) || !inputs_ok(q, k, v, dout, s) ||
      !layout_ok(o, o_sb, o_ss, o_sn) || !out_ok(dq_sb, dq_ss, dq_sn)) {
    return (int)cudaErrorInvalidValue;
  }
  Maps m;
  if (!encode_all(&m, q, k, v, dout, f16, B, Sq, Sk, N, Nkv, H, s, kQRows, kKeys)) {
    return (int)cudaErrorNotSupported;
  }
  const long long st[9] = {o_sb, o_ss, o_sn, do_sb, do_ss, do_sn, dq_sb, dq_ss, dq_sn};
  cudaStream_t c = reinterpret_cast<cudaStream_t>(stream);
  const int group = N / Nkv;
  if (f16) {
    return H == 128 ? launch_dq<true, 128>(m, o, dout, lse, dq, stats, B, Sq, Sk, N, group, st,
                                           scale, causal, c)
                    : launch_dq<true, 64>(m, o, dout, lse, dq, stats, B, Sq, Sk, N, group, st,
                                          scale, causal, c);
  }
  return H == 128 ? launch_dq<false, 128>(m, o, dout, lse, dq, stats, B, Sq, Sk, N, group, st,
                                          scale, causal, c)
                  : launch_dq<false, 64>(m, o, dout, lse, dq, stats, B, Sq, Sk, N, group, st,
                                         scale, causal, c);
}

// As above; stats is what paddle_flash_attention_bwd_dq_sm90 wrote for the
// same inputs; dk and dv have k's dtype and shape [B, Sk, Nkv, H].
extern "C" int paddle_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout, const void* stats, void* dk,
    void* dv, int B, int Sq, int Sk, int N, int Nkv, int H, long long q_sb, long long q_ss,
    long long q_sn, long long k_sb, long long k_ss, long long k_sn, long long v_sb,
    long long v_ss, long long v_sn, long long do_sb, long long do_ss, long long do_sn,
    long long dk_sb, long long dk_ss, long long dk_sn, long long dv_sb, long long dv_ss,
    long long dv_sn, int f16, float scale, int causal, void* stream) {
  const long long s[12] = {q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn,
                           do_sb, do_ss, do_sn};
  if (!shapes_ok(B, Sq, Sk, N, Nkv, H) || !inputs_ok(q, k, v, dout, s) ||
      !out_ok(dk_sb, dk_ss, dk_sn) || !out_ok(dv_sb, dv_ss, dv_sn)) {
    return (int)cudaErrorInvalidValue;
  }
  Maps m;
  if (!encode_all(&m, q, k, v, dout, f16, B, Sq, Sk, N, Nkv, H, s, kTileQ, kKeys)) {
    return (int)cudaErrorNotSupported;
  }
  const long long st[6] = {dk_sb, dk_ss, dk_sn, dv_sb, dv_ss, dv_sn};
  cudaStream_t c = reinterpret_cast<cudaStream_t>(stream);
  if (f16) {
    return H == 128 ? launch_dkv<true, 128>(m, stats, dk, dv, B, Sq, Sk, N, Nkv, st, scale,
                                            causal, c)
                    : launch_dkv<true, 64>(m, stats, dk, dv, B, Sq, Sk, N, Nkv, st, scale,
                                           causal, c);
  }
  return H == 128 ? launch_dkv<false, 128>(m, stats, dk, dv, B, Sq, Sk, N, Nkv, st, scale, causal,
                                           c)
                  : launch_dkv<false, 64>(m, stats, dk, dv, B, Sq, Sk, N, Nkv, st, scale,
                                          causal, c);
}
