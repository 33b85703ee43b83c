// The matmul epilogue designed for Hopper (sm_90a): out = act(x @ w + bias)
// with TMA loads into an mbarrier ring, wgmma, and a TMA store, one
// producer and two consumer warpgroups in a persistent block an SM.  bf16
// or f16 in, f32 accumulation; the bias and the activation run on the
// accumulator in registers before the single store.
//
// Replaces the TPU kernel paddle_tpu/ops/matmul_epilogue.py:_kernel (:40)
// on the layouts TMA can read: x [M, K], w [K, N] and out [M, N] row-major
// with unit column stride, row strides that are positive multiples of 16
// bytes and 16-byte aligned bases (N a multiple of 8).  Everything else
// (f32, rows such as N = 130 in bf16) takes the general kernel of
// matmul_epilogue.cu; ops/matmul_epilogue.py:_route picks the route before
// any launch.
//
// What bounds it on the card: operations, then the L2.  BERT-base's FFN
// product [4096, 768] x [768, 3072] does 19.3 GFLOP on 11 MB of operands,
// about 1,800 operations per byte of device memory against the H100's
// ~295; but every output tile re-reads its x rows and w columns from L2
// (226 MB at 128 x 256 tiles), which is what the tile size is chosen
// against.  The general kernel ran it at 15 % of the bf16 peak: mma.sync,
// one 32-deep K tile in flight staged through registers, a barrier pair
// every 32 k.  What this design does about it:
//   * the products run on wgmma m64n256k16 with both operands read from
//     shared memory through descriptors: x K-major, w MN-major (w is
//     [K, N] with N contiguous, so the instruction's transpose bit reads
//     it as it lies, no transposed copy);
//   * a 128 x 256 output tile at a time (the largest whose f32
//     accumulators fit: 128 a thread); warpgroups 0 and 1 consume 64 rows
//     x 256 columns each, warpgroup 2 produces: its one elected thread
//     issues the TMA loads of a 128 x 64 x tile and a 64 x 256 w tile
//     (four 64-column sub-tiles) a stage into a ring of three stages
//     (48 KB each), each with a full mbarrier (bytes arrived) and an empty
//     mbarrier (the 8 consumer warps done); setmaxnreg moves registers
//     from the producer (40) to the consumers (232);
//   * persistent: one block an SM walks the tiles (tile, tile + grid, ...)
//     and the ring runs on across them, so the producer loads the next
//     tile's first stages while the consumers run this tile's epilogue;
//   * the consumers keep one wgmma group in flight: a K tile's four
//     products are committed, then the previous tile's group is waited for
//     and its stage released;
//   * the epilogue runs on the accumulator in registers (the bias from a
//     shared copy staged per tile, the activation a template parameter),
//     writes the 16-bit tile into a 128-byte-swizzled shared staging
//     buffer (conflict-free) and stores it with TMA stores that clip at M
//     and N and run on while the next tile's products start; each
//     warpgroup waits only on its own named barrier (1 + wg), so the two
//     never stall on each other's epilogue.
// Two-block clusters multicasting each w tile (a third less L2 traffic)
// measured slower on the H100 (PERF.md), so blocks load their own tiles.
// Edges: TMA zero-fills loads past M, K and N (a zero row or column adds
// nothing) and the TMA store writes nothing past M and N, so every M, K
// and N (a multiple of 8) runs.  Shared memory: 3 x 48 KB of ring, 64 KB
// of output staging, 2 KB of bias, barriers (211 KB, dynamic, raised once
// per instantiation).  The tensor maps of x, w and out are encoded on the
// host at every launch (hopper_tiles.cuh: encode_2d) and passed as
// __grid_constant__ parameters.
//
// Traps (the descriptor layouts are hopper_tiles.cuh's):
//   * 128-byte swizzle limits a box's inner extent to 64 16-bit columns:
//     the 256-column w tile is four 64-column sub-tiles, which the MN-major
//     descriptor steps across by its leading byte offset (LBO = a
//     sub-tile's 8 KB), SBO = 1024 between 8-row groups of K, k-step s
//     starting 16 rows (2 KB) down; x's k-step s starts 32 bytes along its
//     128-byte rows; the staged output is four 64 x 64 boxes in the same
//     swizzle (the 16-byte chunk c of row r at c ^ (r % 8));
//   * the ring's phase runs on across tiles: K tile t of the whole walk
//     waits parity (t / 3) & 1 on stage t % 3, the producer the opposite
//     parity on the empty barrier, and the consumers release every stage
//     (the last of a tile after its final wait);
//   * the shared staging buffer is rewritten only after the previous
//     tile's TMA store has read it (cp.async.bulk.wait_group.read), and
//     the generic-proxy writes are fenced to the async proxy before the
//     store is issued;
//   * the setmaxnreg totals stay below the SM's 65,536 registers (40 x 128
//     + 232 x 256 = 64,512).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"
#include "matmul_act.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace paddle_hopper;
using namespace paddle_epilogue;
using paddle_tiles::pack2;
using paddle_tiles::to_float;

constexpr int kBM = 128;         // rows a tile: two consumer warpgroups of 64
constexpr int kBN = 256;         // columns a tile: one m64n256 product a warpgroup
constexpr int kBK = 64;          // K a stage: one 128-byte swizzled row of x
constexpr int kStages = 3;
constexpr int kThreads = 384;    // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int kRowBytes = 128;
constexpr int kConsumerWarps = 8;

// Byte offsets in the 1024-aligned dynamic shared memory.
struct Layout {
  static constexpr int kX = kBM * kRowBytes;        // x tile: 128 rows x 64 K (16 KB)
  static constexpr int kWSub = kBK * kRowBytes;     // w sub-tile: 64 K x 64 columns (8 KB)
  static constexpr int kStage = kX + kWSub * (kBN / 64);
  static constexpr int kBox = 64 * kRowBytes;       // a staged 64 x 64 output box (8 KB)
  static constexpr int kOut = kStages * kStage;     // output staging, 32 KB a warpgroup
  static constexpr int kBias = kOut + 2 * 4 * kBox; // the tile's bias, f32, a copy a warpgroup
  static constexpr int kBar = kBias + 2 * kBN * 4;
  static constexpr int kBytes = kBar + 8 * 2 * kStages + 1024;  // + alignment slack
};

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <bool F16, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
matmul_epilogue_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w,
                            const __grid_constant__ CUtensorMap tm_o,
                            const uint16_t* __restrict__ bias, int M, int N, int K, int n_tiles,
                            int tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Layout::kBar);
  uint64_t* empty = full + kStages;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
      int it = 0;  // K tiles loaded over the whole walk: the ring's position
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM;
        const int n0 = (tile % n_tiles) * kBN;
        for (int t = 0; t < nk; ++t, ++it) {
          const int s = it % kStages;
          uint8_t* stage = smem + s * Layout::kStage;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], Layout::kStage);
          tma_load_2d(stage, &tm_x, &full[s], t * kBK, m0);
#pragma unroll
          for (int c = 0; c < kBN / 64; ++c) {
            tma_load_2d(stage + Layout::kX + c * Layout::kWSub, &tm_w, &full[s], n0 + c * 64,
                        t * kBK);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;   // accumulator row group
    const int tq = lane % 4;  // thread within the row group
    float* sbias = reinterpret_cast<float*>(smem + Layout::kBias) + wg * kBN;
    uint8_t* sout = smem + Layout::kOut + wg * 4 * Layout::kBox;

    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * kBN;
      warpgroup_sync(wg);  // the previous tile's epilogue has read sbias
      for (int i = tid; i < kBN; i += 128) {
        sbias[i] = bias != nullptr && n0 + i < N ? to_float<F16>(bias[n0 + i]) : 0.f;
      }

      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int t = 0; t < nk; ++t, ++it) {
        const int s = it % kStages;
        const uint8_t* sx = smem + s * Layout::kStage + wg * 64 * kRowBytes;
        const uint8_t* sw = smem + s * Layout::kStage + Layout::kX;
        mbar_wait(&full[s], (it / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          wgmma_ss_n256_tb<F16>(acc, sw128_desc(sx + ks * 32, 16, 1024),
                                sw128_desc(sw + ks * 16 * kRowBytes, Layout::kWSub, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous K tile's products are done: release its stage
        if (t > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0 && nk > 0) mbar_arrive(&empty[(it - 1) % kStages]);  // the tile's last

      // Epilogue.  Accumulator elements 4j + {0, 1} lie on row g of the
      // warp's 16, 4j + {2, 3} on row g + 8; columns 8j + 2 tq (+1): the
      // 16-byte chunk j % 8 of 64-column box j / 8.
      if (tid == 0) bulk_wait_read();
      warpgroup_sync(wg);  // sbias staged; the previous tile's store has read sout
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(sbias + 8 * j + 2 * tq);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r;
          *reinterpret_cast<uint32_t*>(sout + (j / 8) * Layout::kBox + row * kRowBytes +
                                       (((j % 8) ^ (row % 8)) * 16) + 4 * tq) =
              pack2<F16>(activate(acc[4 * j + 2 * r] + b.x, ACT),
                         activate(acc[4 * j + 2 * r + 1] + b.y, ACT));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA store
      warpgroup_sync(wg);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < kBN / 64; ++b) {
          tma_store_2d(&tm_o, sout + b * Layout::kBox, n0 + b * 64, m0 + wg * 64);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_all();  // the last stores have completed
  }
}

template <bool F16, int ACT>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mo, const void* bias,
           int M, int N, int K, cudaStream_t stream) {
  constexpr int smem = Layout::kBytes;
  static bool raised = false;  // above 48 KB only after opting in
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_epilogue_sm90_kernel<F16, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_tiles = (N + kBN - 1) / kBN;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * n_tiles;
  if (tiles > 2147483647LL || sms <= 0) return (int)cudaErrorInvalidValue;
  const int grid = tiles < sms ? (int)tiles : sms;
  matmul_epilogue_sm90_kernel<F16, ACT><<<grid, kThreads, smem, stream>>>(
      mx, mw, mo, static_cast<const uint16_t*>(bias), M, N, K, n_tiles, (int)tiles);
  return (int)cudaGetLastError();
}

template <bool F16>
int launch_act(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& mo,
               const void* bias, int M, int N, int K, int act, cudaStream_t s) {
  switch (act) {
    case kNone:
      return launch<F16, kNone>(mx, mw, mo, bias, M, N, K, s);
    case kRelu:
      return launch<F16, kRelu>(mx, mw, mo, bias, M, N, K, s);
    case kGelu:
      return launch<F16, kGelu>(mx, mw, mo, bias, M, N, K, s);
    case kGeluTanh:
      return launch<F16, kGeluTanh>(mx, mw, mo, bias, M, N, K, s);
    case kSilu:
      return launch<F16, kSilu>(mx, mw, mo, bias, M, N, K, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool rows_ok(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld > 0 && ld % 8 == 0;
}

}  // namespace

// out [M, N] = act(x [M, K] @ w [K, N] + bias [N]) on `stream`; bf16 (f16
// != 0: f16) operands, bias and output; row pitches in elements, unit
// column strides; bias may be null; act 0 none, 1 relu, 2 gelu,
// 3 gelu_tanh, 4 silu.  Returns cudaGetLastError() after the launch (0
// when accepted), cudaErrorInvalidValue for shapes or layouts the kernel
// does not take (M, N, K > 0; x, w and out 16-byte aligned with row
// pitches that are multiples of 8 elements; N a multiple of 8), or
// cudaErrorNotSupported when a tensor map cannot be encoded.
extern "C" int paddle_matmul_epilogue_sm90(const void* x, const void* w, const void* bias,
                                           void* out, int M, int N, int K, long long lda,
                                           long long ldb, long long ldo, int act, int f16,
                                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || lda < K || ldb < N || ldo < N ||
      !rows_ok(x, lda) || !rows_ok(w, ldb) || !rows_ok(out, ldo) || act < kNone ||
      act > kSilu) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap mx, mw, mo;
  if (!encode_2d(&mx, x, f16, M, K, lda, kBM) || !encode_2d(&mw, w, f16, K, N, ldb, kBK) ||
      !encode_2d(&mo, out, f16, M, N, ldo, 64)) {
    return (int)cudaErrorNotSupported;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return f16 ? launch_act<true>(mx, mw, mo, bias, M, N, K, act, s)
             : launch_act<false>(mx, mw, mo, bias, M, N, K, act, s);
}
