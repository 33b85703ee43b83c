// Flash-attention forward designed for Hopper (sm_90a): TMA loads into an
// mbarrier ring, wgmma for both products, one producer and two consumer
// warpgroups.  bf16 or f16 in, f32 accumulation, head_dim 64 or 128.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py:_fwd_kernel
// (launched by _fwd) on the layouts TMA can read: unit stride on H, every
// other stride a multiple of 16 bytes, a 16-byte aligned base.  Everything
// else (f32, other head dims, other strides) takes the general kernel of
// flash_attention_fwd.cu; ops/flash_attention.py:_fwd_route picks the
// route from dtype, H and layout before any launch.  Semantics are the
// general kernel's: causal bottom-right aligned when Sq != Sk, mask value
// -0.7 * FLT_MAX, keys at or past Sk at probability 0, a zero row sum
// divided by 1, GQA reading kv head n / group, ragged Sq and Sk masked in
// the kernel; O is written through its strides, lse = m + log(l) as f32
// [B, N, Sq] in natural-log units (what the backward reads).
//
// What bounds it on the card: operations at prefill and training lengths
// (4 H flops per visible (q, k) pair against 2 H bytes per q or k row;
// the H100's ~295 operations per byte are crossed near S = 300 for a
// causal head).  What the design does about it:
//   * both products run on wgmma, the only instruction that reaches the
//     full tensor-core rate: S = Q K^T as m64n128k16 with both operands
//     read from shared memory through descriptors (H / 16 k-steps), then
//     O += P V as m64nHk16 with P in registers (the S accumulator's layout
//     is the A-fragment layout, so P is converted pairwise to 16 bits in
//     place, no shuffle) and V read from shared memory MN-major (the
//     instruction's transpose bit, legal for 16-bit types);
//   * a block owns 128 q rows of one head; warpgroups 0 and 1 consume 64
//     rows each, warpgroup 2 produces: its one elected thread issues TMA
//     loads of the Q tile once and of 128-key K and V tiles into a ring of
//     two stages, each with a full mbarrier (bytes arrived) and an empty
//     mbarrier (8 consumer warps done), so the next tile's load overlaps
//     this tile's products; setmaxnreg moves registers from the producer
//     (40) to the consumers (232);
//   * softmax in registers in the log2 domain: scale * log2(e) folded into
//     one FMA before ex2.approx (the special-function unit), the row max
//     and sum reduced over the 4 threads of a row with shuffles, O
//     rescaled by the running max's change;
//   * the KV loop is split into tiles every row of the warpgroup sees whole
//     and the masked rest (the causal diagonal, the ragged last tile):
//     only the latter pay for compares; tiles a warpgroup sees nothing of
//     are released unread;
//   * causal: the grid is (head x batch, q tile) with the heaviest q tiles
//     of every head launched first (longest work first shortens the tail:
//     23.0 against 29.8 us at the serving prefill, PERF.md); non-causal
//     tiles weigh the same, and a head's q tiles stay adjacent in launch
//     order so that its K/V, read from device memory once, are re-read
//     from L2.  Either way the K/V of all heads (10 MB serving, 32 MB
//     training) fit the 50 MB L2.
// Shared memory at H = 128: 32 KB of Q and two stages of 32 KB K + 32 KB V
// (160 KB, dynamic, raised once per instantiation with
// cudaFuncSetAttribute).  The tensor maps are encoded on the host at every
// launch over the strided [B, S, N, H] view (dims H, N, S, B; boxes of 64
// columns x 128 rows) and passed as __grid_constant__ parameters;
// cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.  TMA zero-fills rows past Sq and Sk; keys past
// Sk still take -inf in the masked tiles, since a zero key scores 0.
//
// Where the traps are (hopper_tiles.cuh has the descriptor layouts):
//   * 128-byte swizzle limits a box's inner extent to 64 16-bit columns,
//     so an H = 128 tile is two swizzled 64-column sub-tiles: Q K^T's
//     k-steps 4..7 start in the second sub-tile, and P V's MN-major V
//     descriptor steps across them by its leading byte offset (LBO = the
//     sub-tile's bytes);
//   * wgmma.fence before each group, since the accumulators and P's
//     registers were just written by ordinary instructions;
//   * mbarrier phase parity: stage s of tile j waits parity (j / 2) & 1,
//     the producer the opposite parity on the empty barrier, so its first
//     pass over the ring does not wait;
//   * setmaxnreg needs every warp of the warpgroup and one if/else that
//     never reconverges: the roles split once after the barrier set-up;
//     and the block's total after it must stay below the SM's 65,536
//     registers: 128 x 32 + 256 x 240 = 65,536 left the consumers waiting
//     forever (40 and 232 give 64,512).
// Tried and not kept (PERF.md has the times): ordering the two warpgroups'
// products by named barriers (FlashAttention-3's ping-pong), issuing S of
// the next tile before the softmax of this one (its intra-warpgroup
// pipeline) and a three-stage ring each left the kernel as fast or
// slower; a persistent grid dealing tiles round-robin gained 2.5 % at the
// training shape and lost 15 % at the serving prefill (a dynamic tile
// scheduler is what would pay).  Not yet done: a TMA store of O.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

#include "hopper_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace paddle_hopper;
using paddle_tiles::pack2;

constexpr int kBM = 128;         // q rows a block: two consumer warpgroups of 64
constexpr int kBN = 128;         // keys a K/V tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads = 384;    // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int kRowBytes = 128;   // a swizzled row: 64 16-bit columns
constexpr int kConsumerWarps = 8;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int H>
struct Layout {
  static constexpr int kSub = kBM * kRowBytes;     // a 64-column sub-tile of 128 rows
  static constexpr int kTile = kSub * (H / 64);    // a 128-row tile (kBM == kBN)
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

template <bool F16, int H>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, uint16_t* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int N, int group, int n_qt,
                      int64_t o_sb, int64_t o_ss, int64_t o_sn, float scale, int causal) {
  using L = Layout<H>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  // Causal: the grid is (head x batch, q tile) and the q tiles run
  // heaviest first across all heads (longest work first shortens the
  // tail); otherwise (q tile, head, batch), a head's tiles adjacent.
  const int qt = n_qt - 1 - (int)(causal ? blockIdx.y : blockIdx.x);
  const int n = causal ? blockIdx.x % N : blockIdx.y;
  const int b = causal ? blockIdx.x / N : blockIdx.z;
  const int kvh = n / group;
  const int q0 = qt * kBM;
  const int q_off = Sk - Sq;  // bottom-right causal alignment
  int n_kv = (Sk + kBN - 1) / kBN;
  if (causal) {
    // only KV tiles that start at or before the block's last aligned q row
    const int last = q0 + kBM - 1 + q_off;
    n_kv = min(n_kv, last < 0 ? 0 : last / kBN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128 && n_kv > 0) {
      mbar_expect_tx(q_full, kBM * H * 2);
#pragma unroll
      for (int c = 0; c < H / 64; ++c) {
        tma_load_4d(smem + L::kQ + c * L::kSub, &tm_q, q_full, c * 64, n, q0, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], kBN * H * 2);
#pragma unroll
        for (int c = 0; c < H / 64; ++c) {
          tma_load_4d(smem + L::kK + s * L::kTile + c * L::kSub, &tm_k, &k_full[s], c * 64, kvh,
                      j * kBN, b);
        }
        mbar_expect_tx(&v_full[s], kBN * H * 2);
#pragma unroll
        for (int c = 0; c < H / 64; ++c) {
          tma_load_4d(smem + L::kV + s * L::kTile + c * L::kSub, &tm_v, &v_full[s], c * 64, kvh,
                      j * kBN, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;  // accumulator row group
    const int tq = lane % 4; // thread within the row group
    const int qw0 = q0 + wg * 64;
    // This thread's two rows: accumulator elements 4j + {0, 1} lie on row
    // g of the warp's 16, 4j + {2, 3} on row g + 8; column 8j + 2 tq (+1).
    const int qi[2] = {qw0 + warp * 16 + g, qw0 + warp * 16 + g + 8};
    const float sl2 = scale * kLog2e;

    // Tiles [0, n_free) every row of this warpgroup sees whole; tiles
    // [n_free, n_need) are masked; tiles past n_need it sees nothing of.
    int n_need = n_kv;
    int n_free = min(n_kv, Sk / kBN);
    if (causal) {
      const int last = qw0 + 63 + q_off;
      n_need = min(n_kv, last < 0 ? 0 : last / kBN + 1);
      const int first = qw0 + q_off + 1;  // keys below it are seen by every row
      n_free = min(n_free, first <= 0 ? 0 : first / kBN);
    }

    float acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMaskValue, kMaskValue};  // running max, log2 units
    float l[2] = {0.f, 0.f};                // this thread's share of the row sums
    const uint8_t* sq = smem + L::kQ + wg * 64 * kRowBytes;
    if (n_kv > 0) mbar_wait(q_full, 0);

    auto tile = [&](int j, auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint8_t* sk = smem + L::kK + s * L::kTile;
      const uint8_t* sv = smem + L::kV + s * L::kTile;

      // S = Q K^T: 64 rows x 128 keys, H / 16 k-steps of 32 bytes each
      // along the swizzled rows, sub-tile by sub-tile.
      float sc[64];
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < H / 16; ++ks) {
        const int off = (ks / 4) * L::kSub + (ks % 4) * 32;
        wgmma_ss<F16, kBN>(sc, sw128_desc(sq + off, 16, 1024), sw128_desc(sk + off, 16, 1024),
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
          float x = sc[i] * sl2;
          if (key >= Sk) {
            x = -INFINITY;
          } else if (causal && key > qi[r] + q_off) {
            x = kMaskValue;
          }
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
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2_approx(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int i = 0; i < H / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }

      // P, rounded to 16 bits: accumulator elements 8kk..8kk+7 are the A
      // fragment of k-step kk of P V.
      uint32_t pf[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kk + e;
          const int r = (i >> 1) & 1;
          p[e] = ex2_approx(kMasked ? sc[i] - m[r] : fmaf(sc[i], sl2, -m[r]));
          l[r] += p[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) pf[kk][e] = pack2<F16>(p[2 * e], p[2 * e + 1]);
      }

      // O += P V: V MN-major, k-step kk is 16 key rows (2 KB) down the tile.
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs<F16, H>(acc, pf[kk], sw128_desc(sv + kk * 16 * kRowBytes, L::kSub, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    };

    for (int j = 0; j < n_kv; ++j) {
      if (j < n_free) {
        tile(j, std::false_type{});
      } else if (j < n_need) {
        tile(j, std::true_type{});
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);  // this warp is done with stage s
    }

    uint16_t* ob = o + b * o_sb + n * o_sn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (qi[r] >= Sq) continue;
      const float l_safe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / l_safe;
      uint16_t* orow = ob + (int64_t)qi[r] * o_ss;
#pragma unroll
      for (int jn = 0; jn < H / 8; ++jn) {
        *reinterpret_cast<uint32_t*>(orow + jn * 8 + tq * 2) =
            pack2<F16>(acc[4 * jn + 2 * r] * inv, acc[4 * jn + 2 * r + 1] * inv);
      }
      if (tq == 0) {
        const float m_nat = m[r] == kMaskValue ? kMaskValue : m[r] * kLn2;
        lse[((int64_t)b * N + n) * Sq + qi[r]] = m_nat + logf(l_safe);
      }
    }
  }
}

template <bool F16, int H>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
           void* lse, int B, int Sq, int Sk, int N, int group, long long o_sb, long long o_ss,
           long long o_sn, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Layout<H>::kBytes;
  static bool raised = false;  // above 48 KB only after opting in
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<F16, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const int n_qt = (Sq + kBM - 1) / kBM;
  if (n_qt > 65535 || (long long)N * B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid = causal ? dim3(N * B, n_qt) : dim3(n_qt, N, B);
  flash_fwd_sm90_kernel<F16, H><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), static_cast<float*>(lse), Sq, Sk, N, group, n_qt,
      o_sb, o_ss, o_sn, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 when
// it was accepted), cudaErrorInvalidValue for shapes or layouts the kernel
// does not take, or cudaErrorNotSupported when a tensor map cannot be
// encoded.  q, k, v are bf16 (f16 != 0: f16) [B, S, N, H] with unit
// stride on H; strides in elements; o has q's dtype, lse is f32 [B, N, Sq].
extern "C" int paddle_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int Sq, int Sk,
    int N, int Nkv, int H, long long q_sb, long long q_ss, long long q_sn, long long k_sb,
    long long k_ss, long long k_sn, long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn, int f16, float scale, int causal,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Nkv <= 0 || N % Nkv != 0 || (H != 64 && H != 128) ||
      !layout_ok(q, q_sb, q_ss, q_sn) || !layout_ok(k, k_sb, k_ss, k_sn) ||
      !layout_ok(v, v_sb, v_ss, v_sn) || o_ss % 2 != 0 || o_sn % 2 != 0 || o_sb % 2 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, f16, B, Sq, N, H, q_sb, q_ss, q_sn, kBM) ||
      !encode(&mk, k, f16, B, Sk, Nkv, H, k_sb, k_ss, k_sn, kBN) ||
      !encode(&mv, v, f16, B, Sk, Nkv, H, v_sb, v_ss, v_sn, kBN)) {
    return (int)cudaErrorNotSupported;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int group = N / Nkv;
  if (f16) {
    return H == 128 ? launch<true, 128>(mq, mk, mv, o, lse, B, Sq, Sk, N, group, o_sb, o_ss,
                                        o_sn, scale, causal, s)
                    : launch<true, 64>(mq, mk, mv, o, lse, B, Sq, Sk, N, group, o_sb, o_ss,
                                       o_sn, scale, causal, s);
  }
  return H == 128 ? launch<false, 128>(mq, mk, mv, o, lse, B, Sq, Sk, N, group, o_sb, o_ss, o_sn,
                                       scale, causal, s)
                  : launch<false, 64>(mq, mk, mv, o, lse, B, Sq, Sk, N, group, o_sb, o_ss, o_sn,
                                      scale, causal, s);
}

// Host microseconds one launch spends encoding its three tensor maps, the
// mean over `iters` encodings of q, k and v's maps (no launch).
extern "C" double paddle_flash_attention_fwd_sm90_encode_us(
    const void* q, const void* k, const void* v, int B, int Sq, int Sk, int N, int Nkv, int H,
    long long q_sb, long long q_ss, long long q_sn, long long k_sb, long long k_ss,
    long long k_sn, long long v_sb, long long v_ss, long long v_sn, int f16, int iters) {
  CUtensorMap mq, mk, mv;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (!encode(&mq, q, f16, B, Sq, N, H, q_sb, q_ss, q_sn, kBM) ||
        !encode(&mk, k, f16, B, Sk, Nkv, H, k_sb, k_ss, k_sn, kBN) ||
        !encode(&mv, v, f16, B, Sk, Nkv, H, v_sb, v_ss, v_sn, kBN)) {
      return -1.0;
    }
  }
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}
