// The decode chain designed for Hopper (sm_90a): write the new token's K and
// V into its page of the paged pools (bf16, or int8 with the running-max
// rescale), then attend one query token a row over the row's live
// positions.  bf16 q / k_new / v_new / o; bf16 or int8 pools; H 64 or 128;
// at most 8 query heads a kv head.
//
// Replaces the TPU kernels of paddle_tpu/ops/decode_chain.py on those
// inputs:
//   decode_chain_batch  <- _build_batch (:504): one launch, the blocks of a
//                          row's kv head in one cluster, merged through
//                          distributed shared memory;
//   decode_chain_rows   <- _build_rows (:574): int8 pools, the same blocks
//                          without a cluster, f32 partials in a workspace
//                          and a combine launch.
// f32 models take decode_chain.cu's kernel (the general route);
// ops/decode_chain.py:_decode_route picks the route before any launch.
//
// What bounds it on the card: bytes.  Every live K/V page of every row is
// read once (2 x bs x H x 2 bytes a page and kv head in bf16, half that in
// int8) for ~4 x H x G flops a position and kv head: about G flops a byte,
// far below the H100's ~295.  At the 7B serving geometry (B 4, N = Nkv 32,
// H 128, lengths 18/160/290/680) that is 18.9 MB, 5.67 us at 3.35 TB/s.
// decode_chain.cu's kernel took 106.6 us there: one block per (row, kv
// head) walked the row alone (the 680-position row's 43 pages set the
// time), loaded each 32-position tile synchronously into f32 shared memory
// with nothing in flight, and barriered the block four times a tile.  What
// this design does about it:
//   * Work dealt by pages.  Grid (P, Nkv, B): the P blocks of a (row, kv
//     head) deal the row's live pages among themselves in equal
//     page-aligned runs (run r holds pages [r * per, (r + 1) * per) of the
//     ceil(L / bs) live ones, per = ceil(pages / P)); a block whose run is
//     empty issues no load.  decode_chain_batch launches the P blocks as
//     one cluster (P = C in {1, 2, 4, 8}, ops/decode_chain.py:
//     decode_cluster) and merges the partial softmax sums (m, l and the
//     unnormalised G x H accumulator, f32) through distributed shared
//     memory (barrier.cluster, mapa): no workspace in device memory and no
//     second launch: every block pushes its partial into rank 0's shared
//     memory (st.shared::cluster) and rank 0 merges after one cluster
//     barrier.  decode_chain_rows launches P = splits blocks without a
//     cluster and merges in a combine launch (started early by programmatic
//     dependent launch, so its launch overlaps the split kernel), so the
//     search still weighs the two merges.  A block whose run is empty
//     leaves as soon as it has read the row's length; the merges read only
//     the runs that hold pages.
//   * Loads that stay in flight.  A kv head's page is one contiguous run of
//     bs x H elements in the [NB, Nkv, bs, H] pools (4 KB bf16 at bs 16, H
//     128), so one producer warp issues one cp.async.bulk for the K page and
//     one for the V page of each page of the run into a ring of stages, each
//     with a full mbarrier (bytes landed) and an empty one (the consumer
//     warps done).  The ring holds 32 KB (4 stages of bf16 K and V pages at
//     bs 16, H 128; 8 of int8): about what an SM needs in flight to stream
//     its share of 3.35 TB/s at ~1 us of latency, with several blocks an SM.
//     No tensor map: the table scatters the pages.  Each warp loads the
//     row's first 64 table entries into registers at its start, before the
//     row's length arrives, so a page copy waits on one dependent load.
//   * Consumers that neither stage in f32 nor barrier the block.  Four
//     consumer warps hold the group's G query rows in registers (f32,
//     prescaled by 1/sqrt(H) x log2 e) and read each landed page straight
//     from shared memory in the pool's dtype, 16-byte vectors, lanes over H.
//     A warp splits into R = 4 / G sub-warps (R = 1 from G = 4) that take
//     one key each, so at G = 1 a warp reads four keys at once and reduces
//     a score over 8 lanes.  int8 is dequantised in registers (a byte
//     permute into 2^23's mantissa, not the quarter-rate I2F): the score by
//     the page's K scale, the probability by its V scale (one float a page
//     and kv head, read straight from device memory by the consumers).
//     Each warp keeps its own online softmax (exp2) over its keys; the warps
//     merge once at the end of the run.  The only waits in the loop are the
//     ring's mbarriers.  At G = 8 one loaded K position serves 8 query rows,
//     ~4 x H x 8 flops for 2 x H bytes: still below the FMA ridge, so FMA.
//
// The write, bit-exact and ordered.  The block whose run holds the row's
// last position pos = lens - 1 writes the token before anything reads that
// page: consumer warp 0 the K token, warp 1 the V token, replaying
// paddle_tpu_torch/ops/paged_attention.py:_quant_write_chunk for int8 as
// decode_chain.cu does (the token's amax over 127 by IEEE division; new_s =
// max(old_s, tok); safe = max(new_s, 1e-12); the touched [bs, H] page
// rescaled by old_s / safe if and only if new_s > old_s; the token
// quantized as rint(x / safe) clipped to +-127; no --use_fast_math, no
// reciprocal multiply), so the pools equal the plain version's bit for bit.
// The write uses plain (generic-proxy) stores and the bulk copy reads
// through the async proxy, so each writing thread issues
// fence.proxy.async.global and arrives on a named barrier that the producer
// waits on before it copies that page (the page is the run's last, so the
// producer has the run's other pages in flight by then).  Runs are whole
// pages, so no other block reads the touched page, and the serving
// allocator's invariant (decode_chain.cu:26-34: every row owns the pages
// its table names, a masked lane writes its own scratch page) keeps the
// writes of different blocks apart.  The new scales reach the block's
// consumers through shared memory, ordered by the same barrier and the
// page's full mbarrier.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using namespace paddle_hopper;

constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // warp 4 produces
constexpr int kRingBytes = 32 * 1024;                // K and V pages in flight a block
constexpr int kMaxStages = 8;
constexpr int kMaxParts = 8;                         // portable cluster size
constexpr int kMinBlocks = 5;    // blocks an SM: 512 blocks (the 7B grid) in one wave
constexpr int kMaxSmem = 227 * 1024;
constexpr int kWriteBar = 1;     // the writer warps (0, 1) and the producer
constexpr int kConsumerBar = 2;  // the consumer warps
constexpr float kQMax = 127.f;
constexpr float kEps = 1e-12f;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory: the ring of `stages` x (K page, V page), its
// 2 x stages mbarriers, then f32 partials of GT x (H + 2) floats each (m
// and l of each row, then its H accumulators): one a consumer warp, and in
// a cluster one a block of the cluster (rank 0's gather the cluster's),
// then two floats (the written page's new scales).
__host__ __device__ constexpr int smem_bytes(int stages, int page_bytes, int gt, int h,
                                             int slots) {
  return stages * 2 * page_bytes + 2 * stages * 8 +
         ((kConsumerWarps + slots) * gt * (h + 2) + 2) * 4;
}

struct Args {
  void* kpool;          // [NB, Nkv, bs, H], bf16 or int8
  void* vpool;
  float* kscale;        // [NB, Nkv], int8 pools only
  float* vscale;
  const __nv_bfloat16* q;    // [B, N, H]
  const __nv_bfloat16* kn;   // [B, Nkv, H]
  const __nv_bfloat16* vn;
  const int64_t* tables;     // [B, W]
  const int64_t* lens;       // [B], including this token
  __nv_bfloat16* o;          // [B, N, H]
  float* ws_m;               // [B, N, parts] (rows layout), else null
  float* ws_l;
  float* ws_acc;             // [B, N, parts, H]
  int N, Nkv, G, bs, W, parts, stages;
  float qscale;              // 1/sqrt(H) x log2 e
};

// A lane's share of a row of H elements: E elements in vectors of kV bytes
// (16 where the share allows), vector t of sub-warp lane `sub` at column
// (t * SW + sub) * kEpv, so the lanes of a sub-warp read consecutive 16-byte
// chunks (no bank conflict).  Elements convert to f32 in registers.
template <class PT, int E, int SW>
struct Frag {
  static constexpr int kIsz = sizeof(PT);
  static constexpr int kV = E * kIsz < 16 ? E * kIsz : 16;
  static constexpr int kEpv = kV / kIsz;
  static constexpr int kNv = E / kEpv;

  __device__ static int col(int sub, int t) { return (t * SW + sub) * kEpv; }

  // kEpv consecutive elements of type T at p (kEpv x sizeof(T) bytes,
  // aligned to that size) into x[0, kEpv)
  template <class T>
  __device__ static void load_run(const T* p, float* x) {
    constexpr int bytes = kEpv * sizeof(T);
    uint32_t w[bytes >= 4 ? bytes / 4 : 1];
    if constexpr (bytes == 32) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[0];
      const uint4 b = reinterpret_cast<const uint4*>(p)[1];
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else if constexpr (bytes == 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    } else if constexpr (bytes == 8) {
      const uint2 a = *reinterpret_cast<const uint2*>(p);
      w[0] = a.x; w[1] = a.y;
    } else if constexpr (bytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      static_assert(bytes == 2, "a lane reads 2 to 32 bytes of a row");
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
#pragma unroll
    for (int e = 0; e < kEpv; ++e) {
      if constexpr (sizeof(T) == 1) {
        // int8 to f32 exactly without the quarter-rate I2F: byte x + 128 as
        // the low mantissa bits of 2^23, then subtract 2^23 + 128
        const uint32_t u = w[e / 4] ^ 0x80808080u;
        x[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e % 4)) - 8388736.f;
      } else {  // bf16: the high 16 bits of an f32
        const uint32_t h = (w[e / 2] >> (16 * (e % 2))) & 0xffffu;
        x[e] = __uint_as_float(h << 16);
      }
    }
  }

  template <class T>
  __device__ static void load(const T* row, int sub, float (&x)[E]) {
#pragma unroll
    for (int t = 0; t < kNv; ++t) load_run<T>(row + col(sub, t), x + t * kEpv);
  }
};

// A row's page table as a warp holds it: the first 64 entries loaded at
// the kernel's start, before the row's length is known (so the copies wait
// on one dependent load, not two), two a lane; past them 32 entries at a
// time as the walk reaches them.  Every lane of the warp calls at(p) with
// the same p.
struct TableRow {
  const int64_t* row;
  int w;
  int64_t pre[2];
  int64_t more = 0;
  int more_base = -1;

  __device__ TableRow(const int64_t* r, int width, int lane) : row(r), w(width) {
#pragma unroll
    for (int k = 0; k < 2; ++k) pre[k] = k * 32 + lane < w ? row[k * 32 + lane] : 0;
  }

  // The entry of page p for every lane (p the same in all lanes).
  __device__ int64_t at(int p) {
    const int lane = threadIdx.x & 31;
    const int64_t e0 = __shfl_sync(0xffffffffu, pre[0], p & 31);
    const int64_t e1 = __shfl_sync(0xffffffffu, pre[1], p & 31);
    if (p < 64) return p < 32 ? e0 : e1;
    const int base = p & ~31;
    if (base != more_base) {
      more = base + lane < w ? row[base + lane] : 0;
      more_base = base;
    }
    return __shfl_sync(0xffffffffu, more, p & 31);
  }

  // The entry of page q, a different page in each lane.
  __device__ int64_t lane_at(int q) {
    const int64_t e0 = __shfl_sync(0xffffffffu, pre[0], q & 31);
    const int64_t e1 = __shfl_sync(0xffffffffu, pre[1], q & 31);
    if (q < 64) return q < 32 ? e0 : e1;
    return q < w ? row[q] : 0;
  }
};

__device__ __forceinline__ int8_t quantize(float x) {
  return (int8_t)fminf(fmaxf(rintf(x), -kQMax), kQMax);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp writes one token of one kv head into `page` ([bs, H]) at `slot`;
// lane l holds the token's elements l, l + 32, ... in `tok`.  bf16 pools:
// a copy.  int8 pools: _quant_write_chunk's replay (see the note at the
// top); `scale` is the page's f32 scale, *published gets the new one.
template <int H>
__device__ __forceinline__ void write_token(__nv_bfloat16* page, float*,
                                            const __nv_bfloat16 (&tok)[H / 32], int slot, int,
                                            float*) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) page[slot * H + k * 32 + lane] = tok[k];
}

template <int H>
__device__ __forceinline__ void write_token(int8_t* page, float* scale,
                                            const __nv_bfloat16 (&tok)[H / 32], int slot, int bs,
                                            float* published) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < H / 32; ++k) amax = fmaxf(amax, fabsf(__bfloat162float(tok[k])));
  amax = warp_max(amax);
  const float old_s = *scale;
  const float new_s = fmaxf(old_s, amax / kQMax);
  const float safe = fmaxf(new_s, kEps);
  if (new_s > old_s) {
    // rescale the page, 4 bytes a lane, 8 words in flight
    const float ratio = old_s / safe;
    uint32_t* words = reinterpret_cast<uint32_t*>(page);
    const int nw = bs * H / 4;
    for (int i0 = 0; i0 < nw; i0 += 32 * 8) {
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * 32 + lane;
        w[k] = i < nw ? words[i] : 0u;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * 32 + lane;
        if (i >= nw) continue;
        uint32_t out = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int8_t v = (int8_t)((w[k] >> (8 * c)) & 0xffu);
          out |= (uint32_t)(uint8_t)quantize((float)v * ratio) << (8 * c);
        }
        words[i] = out;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < H / 32; ++k) {
    page[slot * H + k * 32 + lane] = quantize(__bfloat162float(tok[k]) / safe);
  }
  if (lane == 0) {
    *scale = new_s;
    *published = new_s;
  }
}

// Grid (parts, Nkv, B), kThreads threads.  Block (run, kvh, b) owns run
// `run` of row b's live pages for kv head kvh.  ws_m set: write the run's
// f32 partial (decode_chain_rows); else parts == 1: write o; else the
// parts blocks are one cluster and merge through distributed shared memory.
// The register cap keeps 5 blocks an SM at G <= 2, so the 7B grid (512
// blocks in clusters of 4) runs in one wave.
template <class PT, int H, int GT>
__global__ void __launch_bounds__(kThreads, GT <= 2 ? kMinBlocks : 1)
    decode_chain_sm90_kernel(const Args a) {
  constexpr int R = GT == 1 ? 4 : (GT == 2 ? 2 : 1);  // keys a warp reads at once
  constexpr int SW = 32 / R;                          // lanes a key
  constexpr int E = H / SW;                           // elements of a row a lane
  using F = Frag<PT, E, SW>;
  constexpr int kPart = GT * (H + 2);

  extern __shared__ __align__(128) unsigned char smem[];
  const int page_elems = a.bs * H;
  const int page_bytes = page_elems * (int)sizeof(PT);
  const int S = a.stages;
  const bool cluster = a.ws_m == nullptr && a.parts > 1;
  PT* ring = reinterpret_cast<PT*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)S * 2 * page_bytes);
  uint64_t* empty = full + S;
  float* part = reinterpret_cast<float*>(empty + S);  // [warp]: [GT] m, [GT] l, [GT][H] acc
  float* slots = part + kConsumerWarps * kPart;       // [rank], cluster only
  float* new_scale = slots + (cluster ? a.parts : 0) * kPart;  // K, V

  PT* kpool = static_cast<PT*>(a.kpool);
  PT* vpool = static_cast<PT*>(a.vpool);
  const int run = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t* trow = a.tables + (int64_t)b * a.W;
  TableRow table(trow, a.W, lane);  // issued before lens is read
  const int L = (int)a.lens[b];
  const int pages = L > 0 ? (L + a.bs - 1) / a.bs : 0;
  const int per = (pages + a.parts - 1) / a.parts;
  const int pg0 = min(pages, run * per), pg1 = min(pages, pg0 + per);
  const int n = pg1 - pg0;
  const int pos = L - 1;
  const int pw = pos / a.bs;  // the page the token goes to
  const bool writes = L > 0 && pg0 <= pw && pw < pg1;
  constexpr bool kInt8 = sizeof(PT) == 1;
  // the runs that hold pages: the merges read only these
  const int live_runs = per > 0 ? (pages + per - 1) / per : 0;
  if (n == 0 && (a.ws_m != nullptr || run > 0)) {
    // an empty run: nothing to load, write or merge; it leaves once it has
    // taken part in the cluster's barriers
    if (cluster) {
      cluster_arrive_relaxed();
      cluster_wait();
      cluster_sync();
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // rows: the combine
  if (cluster) cluster_arrive_relaxed();  // waited for before the first push

  if (warp == kConsumerWarps) {
    // ------------------------------------------------------------ producer
    for (int i = 0; i < n; ++i) {
      const int64_t page = table.at(pg0 + i);
      const int s = i % S;
      if (writes && pg0 + i == pw) {
        named_bar_sync(kWriteBar, 96);  // the token is in its page
        fence_proxy_async_global();
      }
      if (lane == 0) {
        if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
        const int64_t off = (page * a.Nkv + kvh) * page_elems;
        PT* dst = ring + (size_t)s * 2 * page_elems;
        mbar_expect_tx(&full[s], 2 * page_bytes);
        bulk_load(dst, kpool + off, page_bytes, &full[s]);
        bulk_load(dst + page_elems, vpool + off, page_bytes, &full[s]);
      }
      __syncwarp();
    }
    if (cluster) cluster_wait();
  } else {
    // ----------------------------------------------------------- consumers
    __nv_bfloat16 tok[H / 32];  // warps 0, 1: the K, V token, loaded ahead of the write
    if (warp < 2) {
      const __nv_bfloat16* t = (warp == 0 ? a.kn : a.vn) + ((int64_t)b * a.Nkv + kvh) * H;
#pragma unroll
      for (int k = 0; k < H / 32; ++k) tok[k] = t[k * 32 + lane];
    }
    const int sub = lane % SW, u = lane / SW;
    float qf[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < a.G) {
        F::template load<__nv_bfloat16>(a.q + ((int64_t)b * a.N + kvh * a.G + g) * H, sub, qf[g]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qf[g][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] *= a.qscale;
    }
    if (writes && warp < 2) {
      const int64_t blk = table.at(pw) * a.Nkv + kvh;
      float* sc = kInt8 ? (warp == 0 ? a.kscale : a.vscale) + blk : nullptr;
      write_token<H>((warp == 0 ? kpool : vpool) + blk * page_elems, sc, tok, pos % a.bs, a.bs,
                     new_scale + warp);
      fence_proxy_async_global();
      named_bar_arrive(kWriteBar, 96);
    }
    float m[GT], l[GT], acc[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
    float ks_lane = 1.f, vs_lane = 1.f;  // int8: page i0 + lane's scales
    for (int i = 0; i < n; ++i) {
      if (kInt8 && (i & 31) == 0) {
        const int64_t blk = table.lane_at(pg0 + i + lane) * a.Nkv + kvh;
        if (i + lane < n) {
          ks_lane = a.kscale[blk];
          vs_lane = a.vscale[blk];
        }
      }
      float ks = 1.f, vs = 1.f;
      if (kInt8) {
        ks = __shfl_sync(0xffffffffu, ks_lane, i & 31);
        vs = __shfl_sync(0xffffffffu, vs_lane, i & 31);
      }
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      if (kInt8 && writes && pg0 + i == pw) {  // the scales the write just set
        ks = new_scale[0];
        vs = new_scale[1];
      }
      const PT* kp = ring + (size_t)s * 2 * page_elems;
      const PT* vp = kp + page_elems;
      const int valid = min(a.bs, L - (pg0 + i) * a.bs);
      for (int j0 = warp * R; j0 < valid; j0 += kConsumerWarps * R) {
        const int j = j0 + u;
        const bool live = j < valid;
        float x[E];
        if (live) {
          F::template load<PT>(kp + j * H, sub, x);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) x[e] = 0.f;
        }
        float sc[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) {  // four independent sums, then added
          constexpr int A = E < 4 ? E : 4;
          float dot[A];
#pragma unroll
          for (int k = 0; k < A; ++k) dot[k] = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot[e % A] = fmaf(qf[g][e], x[e], dot[e % A]);
          sc[g] = dot[0];
#pragma unroll
          for (int k = 1; k < A; ++k) sc[g] += dot[k];
        }
#pragma unroll
        for (int o = SW / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int g = 0; g < GT; ++g) sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], o);
        }
        float p[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float s2 = live ? sc[g] * ks : -INFINITY;
          float mx = s2;
#pragma unroll
          for (int o = SW; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[g], mx);
          const float ms = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = ex2_approx(m[g] - ms);
          p[g] = ex2_approx(s2 - ms);
          l[g] = l[g] * alpha + p[g];
          m[g] = m_new;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
        }
        if (live) {
          F::template load<PT>(vp + j * H, sub, x);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float pv = p[g] * vs;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, x[e], acc[g][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the warp's sub-warps hold sums over different keys: add them up
#pragma unroll
    for (int o = SW; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
    float* wp = part + warp * kPart;
    if (u == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int t = 0; t < F::kNv; ++t) {
#pragma unroll
          for (int e = 0; e < F::kEpv; ++e) {
            wp[2 * GT + g * H + F::col(sub, t) + e] = acc[g][t * F::kEpv + e];
          }
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        wp[g] = m[g];
        wp[GT + g] = l[g];
      }
    }
    named_bar_sync(kConsumerBar, kConsumerWarps * 32);
    // merge the warps: the block's partial of every (row, column), pushed
    // to rank 0's slot of this block in a cluster
    float* slot = slots + run * kPart;
    if (cluster) cluster_wait();  // every block of the cluster has started
    for (int e = threadIdx.x; e < a.G * H; e += kConsumerWarps * 32) {
      const int g = e / H, d = e % H;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) mx = fmaxf(mx, part[w * kPart + g]);
      const float ms = mx == -INFINITY ? 0.f : mx;
      float ls = 0.f, as = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        const float f = ex2_approx(part[w * kPart + g] - ms);
        ls += f * part[w * kPart + GT + g];
        as += f * part[w * kPart + 2 * GT + g * H + d];
      }
      const int64_t row = (int64_t)b * a.N + kvh * a.G + g;
      if (a.ws_m != nullptr) {
        const int64_t pi = row * a.parts + run;
        a.ws_acc[pi * H + d] = as;
        if (d == 0) {
          a.ws_m[pi] = mx;
          a.ws_l[pi] = ls;
        }
      } else if (a.parts == 1) {
        a.o[row * H + d] = __float2bfloat16(as / (ls == 0.f ? 1.f : ls));
      } else {
        st_dsmem_f32(slot + 2 * GT + g * H + d, 0, as);
        if (d == 0) {
          st_dsmem_f32(slot + g, 0, mx);
          st_dsmem_f32(slot + GT + g, 0, ls);
        }
      }
    }
  }

  if (cluster) {
    // ------------------------------------------------ the cluster's merge
    cluster_sync();  // every block's partial is in rank 0's shared memory
    if (run == 0) {  // cluster rank 0: the grid's x is the cluster's
      const int C = max(1, live_runs);  // run 0 takes part even when the row is empty
      for (int e = threadIdx.x; e < a.G * H; e += kThreads) {
        const int g = e / H, d = e % H;
        float mx = -INFINITY;
        for (int c = 0; c < C; ++c) mx = fmaxf(mx, slots[c * kPart + g]);
        const float ms = mx == -INFINITY ? 0.f : mx;
        float ls = 0.f, as = 0.f;
        for (int c = 0; c < C; ++c) {
          const float f = ex2_approx(slots[c * kPart + g] - ms);
          ls += f * slots[c * kPart + GT + g];
          as += f * slots[c * kPart + 2 * GT + g * H + d];
        }
        const int64_t row = (int64_t)b * a.N + kvh * a.G + g;
        a.o[row * H + d] = __float2bfloat16(as / (ls == 0.f ? 1.f : ls));
      }
    }
  }
}

// decode_chain_rows' second step: merge the runs' partials of one (row,
// query head).  Grid (N, B); block H.  Only the runs that hold pages wrote
// a partial (the empty ones left early); m is in log2 units.
__global__ void combine_partials_sm90(const Args a, int H) {
  const int n = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int64_t row = (int64_t)b * a.N + n;
  const int64_t base = row * a.parts;
  const int L = (int)a.lens[b];
  const int pages = L > 0 ? (L + a.bs - 1) / a.bs : 0;
  const int per = (pages + a.parts - 1) / a.parts;
  const int live = per > 0 ? (pages + per - 1) / per : 0;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's partials
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, a.ws_m[base + s]);
  const float ms = mx == -INFINITY ? 0.f : mx;
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < live; ++s) {
    const float w = exp2f(a.ws_m[base + s] - ms);
    l += w * a.ws_l[base + s];
    acc += w * a.ws_acc[(base + s) * H + d];
  }
  a.o[row * H + d] = __float2bfloat16(acc / (l == 0.f ? 1.f : l));
}

template <class PT, int H, int GT>
int launch(const Args& a, int B, int smem, cudaStream_t s) {
  static int raised = 0;  // above 48 KB only after opting in
  if (smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_chain_sm90_kernel<PT, H, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised = smem;
  }
  const bool cluster = a.ws_m == nullptr && a.parts > 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.parts, a.Nkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster ? a.parts : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_chain_sm90_kernel<PT, H, GT>, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || a.ws_m == nullptr) return (int)err;
  // the combine launches while the split kernel runs (programmatic
  // dependent launch) and waits for its partials in griddepcontrol.wait
  cudaLaunchConfig_t c2 = {};
  c2.gridDim = dim3(a.N, B);
  c2.blockDim = dim3(H);
  c2.stream = s;
  cudaLaunchAttribute at2[1];
  at2[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at2[0].val.programmaticStreamSerializationAllowed = 1;
  c2.attrs = at2;
  c2.numAttrs = 1;
  err = cudaLaunchKernelEx(&c2, combine_partials_sm90, a, H);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

template <class PT, int H>
int dispatch(const Args& a, int B, cudaStream_t s) {
  const int page_bytes = a.bs * H * (int)sizeof(PT);
  const int gt = a.G == 1 ? 1 : a.G == 2 ? 2 : a.G <= 4 ? 4 : 8;
  const int smem = smem_bytes(a.stages, page_bytes, gt, H,
                              a.ws_m == nullptr && a.parts > 1 ? a.parts : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  switch (gt) {
    case 1: return launch<PT, H, 1>(a, B, smem, s);
    case 2: return launch<PT, H, 2>(a, B, smem, s);
    case 4: return launch<PT, H, 4>(a, B, smem, s);
    default: return launch<PT, H, 8>(a, B, smem, s);
  }
}

// The ring's stages for a page of `page_bytes` (K or V) when each run holds
// at most `run_pages` pages: 32 KB of K and V pages, at least one stage, at
// most 8 and never more than a run can fill (ops/decode_chain.py:
// _ring_stages is its twin, for the search's shared-memory model).
int ring_stages(int page_bytes, int run_pages) {
  int s = kRingBytes / (2 * page_bytes);
  s = s < kMaxStages ? s : kMaxStages;
  s = s < run_pages ? s : run_pages;
  return s > 1 ? s : 1;
}

}  // namespace

// The decode chain's Hopper route on `stream`.  ws_m null: decode_chain_batch,
// `parts` blocks a (row, kv head) as one cluster (1, 2, 4 or 8), one launch;
// ws_m set: decode_chain_rows, `parts` splits (2 to 8) writing f32
// partials (ws_m, ws_l [B, N, parts], ws_acc [B, N, parts, H]), then the
// combine launch.  bf16 q, k_new, v_new and o; pool_int8: int8 pools with
// f32 scales [NB, Nkv], else bf16 pools; pools updated in place.  Returns
// cudaGetLastError() after the launches (0 when accepted), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int paddle_decode_chain_sm90(void* kpool, void* vpool, void* kscale, void* vscale,
                                        const void* q, const void* kn, const void* vn,
                                        const void* tables, const void* lens, void* o,
                                        void* ws_m, void* ws_l, void* ws_acc, int B, int N,
                                        int Nkv, int H, int bs, int W, int parts, int pool_int8,
                                        float scale, void* stream) {
  const int page_bytes = bs * H * (pool_int8 ? 1 : 2);
  if (B <= 0 || B > 65535 || Nkv <= 0 || Nkv > 65535 || N % Nkv != 0 || N / Nkv > 8 ||
      (H != 64 && H != 128) || bs <= 0 || W <= 0 || parts < 1 || parts > kMaxParts ||
      page_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(kpool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vpool) % 16 != 0 ||
      (pool_int8 && (kscale == nullptr || vscale == nullptr)) ||
      (ws_m != nullptr && (ws_l == nullptr || ws_acc == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int run_pages = (W + parts - 1) / parts;
  Args a{kpool, vpool, static_cast<float*>(kscale), static_cast<float*>(vscale),
         static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kn),
         static_cast<const __nv_bfloat16*>(vn), static_cast<const int64_t*>(tables),
         static_cast<const int64_t*>(lens), static_cast<__nv_bfloat16*>(o),
         static_cast<float*>(ws_m), static_cast<float*>(ws_l), static_cast<float*>(ws_acc),
         N, Nkv, N / Nkv, bs, W, parts,
         ring_stages(page_bytes, run_pages), scale * kLog2e};
  if (!pool_int8) a.kscale = a.vscale = nullptr;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (H == 128) {
    return pool_int8 ? dispatch<int8_t, 128>(a, B, s) : dispatch<__nv_bfloat16, 128>(a, B, s);
  }
  return pool_int8 ? dispatch<int8_t, 64>(a, B, s) : dispatch<__nv_bfloat16, 64>(a, B, s);
}
