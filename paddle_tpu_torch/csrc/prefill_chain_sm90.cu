// The chunked-prefill attention core designed for Hopper (sm_90a): a query
// chunk q [1, S, N, H] against k/v [1, T, N, H] (batch 1, K/V already
// repeated over the GQA group), bottom-right causal (key j is visible to
// query i iff j <= i + T - S, T >= S), bf16 in, f32 accumulation, head_dim
// 64 or 128.  TMA loads into an mbarrier ring, wgmma for both products,
// one producer warpgroup and block_q / 64 consumer warpgroups, the key
// range split across blocks.
//
// Replaces the TPU kernel paddle_tpu/ops/decode_chain.py:_build_prefill
// (:917, kernel body :936) for bf16 on the layouts TMA can read (unit
// stride on H, every other stride a multiple of 16 bytes, a 16-byte
// aligned base: the layouts the prefill chain has always required).  f32
// keeps decode_chain.cu's FMA kernel (prefill_chain_f32);
// ops/decode_chain.py:_prefill_route picks the route before any launch.
//
// What bounds it on the card: bytes at a 128-token chunk.  Each head reads
// its T rows of K and V once (2 x 2 H bytes a key) and does 4 H flops a
// visible (q, k) pair, so the work is some 60-100 operations a byte, below
// the H100's ~295.  The general kernel (decode_chain.cu prefill_chain_bf16)
// ran 32 or 64 blocks on 132 SMs, each walking up to ten 64-key tiles in
// series on mma.sync with synchronous loads.  What this design does about
// it:
//   * the key range [0, T) can be split across `splits` blocks
//     (gridDim.y), so that (query tiles x heads x splits) blocks fill the
//     card; the wrapper derives `splits` from S, T, N, block_q and the SM
//     count (ops/decode_chain.py:prefill_splits).  Each split writes its
//     partial O (f32, already divided by its own row sum) and its row
//     logsumexp (log2 units, -inf where the split holds no visible key of
//     the row); a second launch (prefill_combine) weights the partials by
//     2^(lse_i - max lse) and writes O.  With one split the block writes O
//     itself and there is no second launch.  Measured on the H100, the
//     partials and the combine cost a block about what three to four
//     128-key tiles do, so the rule splits only a grid that leaves three
//     quarters of the card idle and keeps at least four tiles a split: the
//     chained engines' 128-token chunks (T <= 640) run unsplit;
//   * both products on wgmma, as flash_attention_fwd_sm90.cu: S = Q K^T
//     m64n128k16 with both operands read from shared memory, O += P V
//     m64nHk16 with P in registers and V read MN-major; softmax in the log2
//     domain (scale * log2(e) folded into one FMA before ex2.approx);
//   * a block owns one head's block_q query rows (one consumer warpgroup a
//     64 rows); the producer's one elected thread loads the Q tile once
//     and streams the split's 128-key K and V tiles through a ring of two
//     stages (full and empty mbarriers), so the next tile's loads overlap
//     this tile's products; setmaxnreg moves registers from the producer
//     (40) to the consumers (232);
//   * the bottom-right mask is applied only on tiles that straddle it (and
//     on the ragged last tile): tiles every row of a warpgroup sees whole
//     skip the compares, tiles it sees nothing of are released unread.
// Masked scores are -inf here, not the forward's finite mask value: a split
// may hold no visible key of a row, and such a row must weigh 0 in the
// combine (every row sees key 0 overall, since T >= S, so O is the plain
// version's).  Shared memory at H = 128, block_q = 128: 32 KB of Q and two
// stages of 32 KB K + 32 KB V (160 KB, dynamic).
//
// Traps (the forward's; hopper_tiles.cuh has the descriptor layouts):
//   * a row whose max is still -inf takes 0 as the max it subtracts, so
//     2^(-inf - -inf) never makes a NaN;
//   * a warpgroup that sees nothing of a tile still waits for the tile's
//     full barrier before it releases the stage;
//   * the setmaxnreg totals stay below the SM's 65,536 registers.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace paddle_hopper;
using paddle_tiles::pack2;

constexpr int kBN = 128;         // keys a K/V tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kRowBytes = 128;   // a swizzled row: 64 16-bit columns
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int H, int BQ>
struct Layout {
  static constexpr int kQSub = BQ * kRowBytes;     // a 64-column sub-tile of Q
  static constexpr int kKSub = kBN * kRowBytes;    // of a K or V tile
  static constexpr int kTile = kKSub * (H / 64);
  static constexpr int kQ = 0;
  static constexpr int kK = kQSub * (H / 64);
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

// Launch bounds of the larger block for both: ptxas then sizes the entry
// registers (168) for 384 threads, below what setmaxnreg raises the
// consumers to, also when block_q = 64 launches 256.
template <int H, int BQ>
__global__ void __launch_bounds__(384, 1)
prefill_chain_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, uint16_t* __restrict__ o,
                          float* __restrict__ ws_o, float* __restrict__ ws_lse, int S, int T,
                          int N, int64_t o_ss, int64_t o_sn, float scale) {
  using L = Layout<H, BQ>;
  constexpr int kConsumers = BQ / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  // Grid (q tile, split, head), the heaviest (last) q tiles first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int n = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_off = T - S;  // bottom-right alignment
  const int n_tiles = (T + kBN - 1) / kBN;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = split * per;
  // only tiles that start at or before the block's last aligned q row
  const int last = q0 + BQ - 1 + q_off;
  const int t_end = min(min(n_tiles, t_begin + per), last / kBN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128 && t_begin < t_end) {
      mbar_expect_tx(q_full, BQ * H * 2);
#pragma unroll
      for (int c = 0; c < H / 64; ++c) {
        tma_load_4d(smem + L::kQ + c * L::kQSub, &tm_q, q_full, c * 64, n, q0, 0);
      }
      for (int j = t_begin; j < t_end; ++j) {
        const int i = j - t_begin;
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], kBN * H * 2);
#pragma unroll
        for (int c = 0; c < H / 64; ++c) {
          tma_load_4d(smem + L::kK + s * L::kTile + c * L::kKSub, &tm_k, &k_full[s], c * 64, n,
                      j * kBN, 0);
        }
        mbar_expect_tx(&v_full[s], kBN * H * 2);
#pragma unroll
        for (int c = 0; c < H / 64; ++c) {
          tma_load_4d(smem + L::kV + s * L::kTile + c * L::kKSub, &tm_v, &v_full[s], c * 64, n,
                      j * kBN, 0);
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

    // Tiles below n_free every row of this warpgroup sees whole; tiles
    // [n_free, n_need) are masked; tiles past n_need it sees nothing of.
    const int n_need = min(t_end, (qw0 + 63 + q_off) / kBN + 1);
    const int n_free = min(T / kBN, (qw0 + q_off + 1) / kBN);

    float acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the row sums
    const uint8_t* sq = smem + L::kQ + wg * 64 * kRowBytes;
    if (t_begin < t_end) mbar_wait(q_full, 0);

    auto tile = [&](int j, int s, uint32_t parity, auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      const uint8_t* sk = smem + L::kK + s * L::kTile;
      const uint8_t* sv = smem + L::kV + s * L::kTile;

      // S = Q K^T: 64 rows x 128 keys, H / 16 k-steps of 32 bytes each
      // along the swizzled rows, sub-tile by sub-tile.
      float sc[64];
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const int qo = (ks / 4) * L::kQSub + (ks % 4) * 32;
        const int ko = (ks / 4) * L::kKSub + (ks % 4) * 32;
        wgmma_ss<false, kBN>(sc, sw128_desc(sq + qo, 16, 1024), sw128_desc(sk + ko, 16, 1024),
                             ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      float mx[2] = {m[0], m[1]};
      if constexpr (kMasked) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          const int key = j * kBN + (i >> 2) * 8 + tq * 2 + (i & 1);
          const float x = key >= T || key > qi[r] + q_off ? -INFINITY : sc[i] * sl2;
          sc[i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      } else {
        float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 64; ++i) raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], sc[i]);
        mx[0] = fmaxf(mx[0], raw[0] * sl2);
        mx[1] = fmaxf(mx[1], raw[1] * sl2);
      }
      float alpha[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row that has seen no key yet
        alpha[r] = ex2_approx(m[r] - base[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int i = 0; i < H / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }

      // P, rounded to bf16: accumulator elements 8kk..8kk+7 are the A
      // fragment of k-step kk of P V.
      uint32_t pf[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kk + e;
          const int r = (i >> 1) & 1;
          p[e] = ex2_approx(kMasked ? sc[i] - base[r] : fmaf(sc[i], sl2, -base[r]));
          l[r] += p[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) pf[kk][e] = pack2<false>(p[2 * e], p[2 * e + 1]);
      }

      // O += P V: V MN-major, k-step kk is 16 key rows (2 KB) down the tile.
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs<false, H>(acc, pf[kk], sw128_desc(sv + kk * 16 * kRowBytes, L::kKSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    };

    for (int j = t_begin; j < t_end; ++j) {
      const int i = j - t_begin;
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      if (j < n_free) {
        tile(j, s, parity, std::false_type{});
      } else if (j < n_need) {
        tile(j, s, parity, std::true_type{});
      } else {
        mbar_wait(&k_full[s], parity);  // released only after its loads landed
        mbar_wait(&v_full[s], parity);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (qi[r] >= S) continue;
      const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
      if (splits == 1) {
        uint16_t* orow = o + (int64_t)qi[r] * o_ss + n * o_sn;
#pragma unroll
        for (int jn = 0; jn < H / 8; ++jn) {
          *reinterpret_cast<uint32_t*>(orow + jn * 8 + tq * 2) =
              pack2<false>(acc[4 * jn + 2 * r] * inv, acc[4 * jn + 2 * r + 1] * inv);
        }
        continue;
      }
      float* prow = ws_o + (((int64_t)split * S + qi[r]) * N + n) * H;
#pragma unroll
      for (int jn = 0; jn < H / 8; ++jn) {
        *reinterpret_cast<float2*>(prow + jn * 8 + tq * 2) =
            make_float2(acc[4 * jn + 2 * r] * inv, acc[4 * jn + 2 * r + 1] * inv);
      }
      if (tq == 0) {
        ws_lse[((int64_t)split * N + n) * S + qi[r]] =
            l[r] == 0.f ? -INFINITY : m[r] + __log2f(l[r]);
      }
    }
  }
}

// The second launch when splits > 1: O of one (query row, head) from the
// splits' partials, each weighted by 2^(lse_i - max lse) (an empty split,
// lse -inf, weighs 0).  Grid S x N, one thread a column.
__global__ void prefill_combine(const float* __restrict__ ws_o, const float* __restrict__ ws_lse,
                                uint16_t* __restrict__ o, int S, int N, int H, int splits,
                                int64_t o_ss, int64_t o_sn) {
  const int i = blockIdx.x / N, n = blockIdx.x % N, d = threadIdx.x;
  float mx = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, ws_lse[((int64_t)sp * N + n) * S + i]);
  float wsum = 0.f, acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float lse = ws_lse[((int64_t)sp * N + n) * S + i];
    const float w = lse == -INFINITY ? 0.f : exp2f(lse - mx);
    wsum += w;
    acc += w * ws_o[(((int64_t)sp * S + i) * N + n) * H + d];
  }
  o[(int64_t)i * o_ss + n * o_sn + d] =
      paddle_tiles::round16<false>(wsum == 0.f ? 0.f : acc / wsum);
}

template <int H, int BQ>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
           void* ws_o, void* ws_lse, int S, int T, int N, int splits, long long o_ss,
           long long o_sn, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<H, BQ>::kBytes;
  static bool raised = false;  // above 48 KB only after opting in
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_chain_sm90_kernel<H, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const int n_qt = (S + BQ - 1) / BQ;
  if (splits > 65535 || N > 65535) return (int)cudaErrorInvalidValue;
  prefill_chain_sm90_kernel<H, BQ><<<dim3(n_qt, splits, N), (BQ / 64 + 1) * 128, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), static_cast<float*>(ws_o),
      static_cast<float*>(ws_lse), S, T, N, o_ss, o_sn, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  prefill_combine<<<S * N, H, 0, stream>>>(static_cast<const float*>(ws_o),
                                           static_cast<const float*>(ws_lse),
                                           static_cast<uint16_t*>(o), S, N, H, splits, o_ss, o_sn);
  return (int)cudaGetLastError();
}

template <int H>
int launch_bq(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
              void* ws_o, void* ws_lse, int S, int T, int N, int splits, long long o_ss,
              long long o_sn, int block_q, float scale, cudaStream_t s) {
  if (block_q == 128) {
    return launch<H, 128>(mq, mk, mv, o, ws_o, ws_lse, S, T, N, splits, o_ss, o_sn, scale, s);
  }
  return launch<H, 64>(mq, mk, mv, o, ws_o, ws_lse, S, T, N, splits, o_ss, o_sn, scale, s);
}

}  // namespace

// The prefill chain on `stream`: q [1, S, N, H], k/v [1, T, N, H] bf16 with
// unit stride on H (strides in elements, the other strides multiples of 8
// elements, 16-byte aligned bases), o bf16 [1, S, N, H] written through
// its strides.  splits > 1 needs ws_o f32 [splits, S, N, H] and ws_lse f32
// [splits, N, S] (contiguous) and adds the combine launch.  Returns
// cudaGetLastError() after the launches (0 when accepted),
// cudaErrorInvalidValue for shapes or layouts the kernel does not take, or
// cudaErrorNotSupported when a tensor map cannot be encoded.
extern "C" int paddle_prefill_chain_sm90(const void* q, const void* k, const void* v, void* o,
                                         void* ws_o, void* ws_lse, int S, int T, int N, int H,
                                         long long q_ss, long long q_sn, long long k_ss,
                                         long long k_sn, long long v_ss, long long v_sn,
                                         long long o_ss, long long o_sn, int block_q,
                                         int splits, float scale, void* stream) {
  const long long q_sb = q_ss * S, k_sb = k_ss * T, v_sb = v_ss * T;  // batch 1: any positive
  if (S <= 0 || T < S || N <= 0 || (H != 64 && H != 128) ||
      (block_q != 64 && block_q != 128) || splits < 1 ||
      (splits > 1 && (ws_o == nullptr || ws_lse == nullptr)) ||
      !layout_ok(q, q_sb, q_ss, q_sn) || !layout_ok(k, k_sb, k_ss, k_sn) ||
      !layout_ok(v, v_sb, v_ss, v_sn) || o_ss % 2 != 0 || o_sn % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, false, 1, S, N, H, q_sb, q_ss, q_sn, block_q) ||
      !encode(&mk, k, false, 1, T, N, H, k_sb, k_ss, k_sn, kBN) ||
      !encode(&mv, v, false, 1, T, N, H, v_sb, v_ss, v_sn, kBN)) {
    return (int)cudaErrorNotSupported;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return H == 128 ? launch_bq<128>(mq, mk, mv, o, ws_o, ws_lse, S, T, N, splits, o_ss, o_sn,
                                   block_q, scale, s)
                  : launch_bq<64>(mq, mk, mv, o, ws_o, ws_lse, S, T, N, splits, o_ss, o_sn,
                                  block_q, scale, s);
}
