// RMSNorm (with the optional residual add) and SwiGLU for Hopper (sm_90a).
// bf16, f16 and f32; f32 arithmetic inside and one cast at the end.
//
// Replace the TPU kernels
//   rms_norm_kernel <- paddle_tpu/ops/fused_norm.py:_rms_kernel (:42):
//                      out = x * rsqrt(mean(x^2) + eps) * w over the last axis;
//                      with a residual, s = x + r rounded to the input dtype
//                      first, and both out = norm(s) and s are written;
//   swiglu_kernel   <- paddle_tpu/ops/swiglu.py:_swiglu_kernel (:17):
//                      out = x * sigmoid(x) * y, x and y the gate and up
//                      halves of one [rows, 2 * cols] projection, read in
//                      place through their row strides.
// ops/fused_norm.py:rms_geometry and ops/swiglu.py:swiglu_grid pick every
// launch's shape in Python before the launch; the CPU tests check them.
//
// What bounds them on this card: bytes.  RMSNorm reads a row once and
// writes it once for ~4 flops an element, SwiGLU reads two elements and
// writes one for ~5: a few flops a byte against the H100's ~295.  So the
// design is about bytes in flight and fixed cost; tensor cores have no
// part here.  The Triton kernels these replace (kept in ops/ as
// yardsticks) ran one 512-thread program a row whose sum crossed 16 warps
// through shared memory, with a trailing wave at 640 rows, and a flat 1-D
// SwiGLU grid with a 64-bit division and remainder per element.  What this
// design does:
//   * 16-byte loads and stores.  A lane owns whole 16-byte chunks of a row
//     (8 bf16 or f16, 4 f32), and the lanes of a warp own neighbouring
//     chunks, so each warp instruction moves 512 contiguous bytes.  A row
//     whose length, stride or base pointer is not a multiple of 16 bytes
//     takes the same chunks element by element (masked at the row's end):
//     one kernel, no second route.  A chunk past the row's end is a
//     predicated load into zeroed registers, never a load and a select:
//     a select waits for its load, and the warp, which issues in order,
//     would wait at the first one before issuing the next load.
//   * RMSNorm: every load of a row in flight before its reduction.  A row
//     is spread over W warps (1 to 8); each lane issues its NV chunks of x
//     (and of the residual) and of the weight (read-only path) before any
//     use.  The weight keeps its own dtype (bf16, f16 or f32, whatever x's),
//     converted to f32 in registers, as _rms_kernel casts it: its share of a
//     chunk is 8, 16 or 32 bytes.  The sum of squares is a warp shuffle, and
//     crosses warps through one shared-memory exchange and a second shuffle
//     when W > 1.  W and NV follow the rows (rms_geometry): 4 warps of 4
//     chunks a lane at 4096 bf16, 8 warps of 2 where few rows leave SMs
//     idle.  A block holds one row, or a few short ones, and the grid has a
//     block a row group: the card deals the blocks to the SMs as they free
//     up.  (Resident blocks walking the rows with the next row in flight
//     measured no faster at training's [4096, 2048] and slower with the
//     residual; PERF.md §6.)  __launch_bounds__(256, 2) leaves the compiler
//     128 registers (it takes 71 at 4096 bf16): a 64-register cap measured
//     no faster at prefill's 640 rows, though 1,024 rows then fit one wave.
//     A row longer than one tile
//     (W x 32 x NV chunks, TILED) is read twice: its sum of squares first,
//     then the scaled output.
//   * SwiGLU: a 2-D grid of column chunks by rows.  A thread owns one
//     16-byte chunk of one row: one 64-bit multiply a row for the address,
//     no division or remainder per element.  Two or four rows a thread,
//     to keep more bytes in flight, measured no faster on the card.
//   * The sigmoid is x / (1 + exp(-x)) with the fast exponential
//     (ex2.approx) and the fast division: within a few f32 ulps of the plain
//     version, far inside one bf16 or f16 rounding.  1 / sqrt of the mean
//     is rsqrtf (one rounding a row, ~2 ulps).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // RMSNorm: threads a block at most (8 warps)

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// The dtype codes of the C interface: 0 bf16, 1 f16, 2 f32.
template <int D> struct DType;
template <> struct DType<0> { using type = __nv_bfloat16; };
template <> struct DType<1> { using type = __half; };
template <> struct DType<2> { using type = float; };

// One 16-byte chunk of a row.
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// Chunk c (elements [c N, c N + N)) of a row of n elements.  VEC: n is a
// multiple of N and the row starts on 16 bytes, so every chunk inside the
// row is whole and one 16-byte load takes it; otherwise element loads,
// masked at the row's end.  Chunks past the row read as zeros.  RO: the
// read-only path (the input is not written during the launch).
template <typename T, bool VEC, bool RO>
__device__ __forceinline__ void load_chunk(Pack<T>& p, const T* __restrict__ row, int c, int n) {
  constexpr int N = Pack<T>::N;
  const int e0 = c * N;
  if (VEC) {
    // one predicated load into zeroed registers: no select after it, so a
    // lane's loads all issue before the first one is waited for
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (RO) {
      asm volatile("{\n .reg .pred p;\n setp.lt.s32 p, %4, %5;\n"
                   " @p ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%6];\n}"
                   : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
                   : "r"(e0), "r"(n), "l"(row + e0));
    } else {  // bytes this thread stored earlier in the launch: keep the order
      asm volatile("{\n .reg .pred p;\n setp.lt.s32 p, %4, %5;\n"
                   " @p ld.global.v4.u32 {%0, %1, %2, %3}, [%6];\n}"
                   : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
                   : "r"(e0), "r"(n), "l"(row + e0)
                   : "memory");
    }
    *reinterpret_cast<uint4*>(p.v) = v;
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p.v[i] = e0 + i < n ? row[e0 + i] : from_f32<T>(0.f);
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int c, int n, const Pack<T>& p) {
  constexpr int N = Pack<T>::N;
  const int e0 = c * N;
  if (VEC) {
    if (e0 < n) *reinterpret_cast<uint4*>(row + e0) = *reinterpret_cast<const uint4*>(p.v);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (e0 + i < n) row[e0 + i] = p.v[i];
  }
}

// The weight's elements of one chunk of a row of T (Pack<T>::N of them)
// in the weight's own dtype W: 8, 16 or 32 bytes.
template <typename T, typename W>
struct WPack {
  static constexpr int N = Pack<T>::N;
  static constexpr int BYTES = N * static_cast<int>(sizeof(W));
  alignas(16) W v[N];
};

// Chunk c of the weight (n elements), as load_chunk loads x's, through the
// read-only path.  VEC: whole chunks and a 16-byte aligned weight, so the
// chunk's BYTES are one or two 16-byte loads, or one 8-byte load.
template <typename T, typename W, bool VEC>
__device__ __forceinline__ void load_weight(WPack<T, W>& p, const W* __restrict__ w, int c, int n) {
  constexpr int N = Pack<T>::N;
  const int e0 = c * N;
  if (VEC) {
    if constexpr (WPack<T, W>::BYTES >= 16) {
#pragma unroll
      for (int k = 0; k < WPack<T, W>::BYTES / 16; ++k) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        asm volatile("{\n .reg .pred q;\n setp.lt.s32 q, %4, %5;\n"
                     " @q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%6];\n}"
                     : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
                     : "r"(e0), "r"(n), "l"(w + e0 + k * (16 / sizeof(W))));
        reinterpret_cast<uint4*>(p.v)[k] = v;
      }
    } else {
      uint2 v = make_uint2(0u, 0u);
      asm volatile("{\n .reg .pred q;\n setp.lt.s32 q, %2, %3;\n"
                   " @q ld.global.nc.v2.u32 {%0, %1}, [%4];\n}"
                   : "+r"(v.x), "+r"(v.y)
                   : "r"(e0), "r"(n), "l"(w + e0));
      *reinterpret_cast<uint2*>(p.v) = v;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p.v[i] = e0 + i < n ? w[e0 + i] : from_f32<W>(0.f);
}

template <typename T>
__device__ __forceinline__ float sum_squares(const Pack<T>& p) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < Pack<T>::N; ++i) {
    const float f = to_f32(p.v[i]);
    s = fmaf(f, f, s);
  }
  return s;
}

// s = x + r rounded to the dtype, into x.
template <typename T>
__device__ __forceinline__ void add_residual(Pack<T>& x, const Pack<T>& r) {
#pragma unroll
  for (int i = 0; i < Pack<T>::N; ++i) x.v[i] = from_f32<T>(to_f32(x.v[i]) + to_f32(r.v[i]));
}

template <typename T, typename W>
__device__ __forceinline__ Pack<T> scale_chunk(const Pack<T>& x, const WPack<T, W>& w, float inv) {
  Pack<T> o;
#pragma unroll
  for (int i = 0; i < Pack<T>::N; ++i) o.v[i] = from_f32<T>(to_f32(x.v[i]) * inv * to_f32(w.v[i]));
  return o;
}

template <typename T>
struct RmsArgs {
  const T* x;        // [rows, hidden], contiguous
  const T* r;        // the residual, or null
  const void* w;     // [hidden], of the kernel's weight dtype
  T* out;            // [rows, hidden]
  T* sum;            // x + r, [rows, hidden], or null
  long long rows;
  int hidden;
  int chunks;        // 16-byte chunks a row: ceil(hidden / N)
  int wpr_log2;      // warps a row: 1, 2, 4 or 8
  int rpb;           // rows a block: blockDim.x / (32 << wpr_log2)
  float inv_hidden;  // 1 / hidden
  float eps;
};

// Tile t of a row (chunks first + j * lanes, j < NV) into x (and r).
template <typename T, int NV, bool RES, bool VEC>
__device__ __forceinline__ void load_tile(Pack<T> (&x)[NV], Pack<T> (&r)[NV],
                                          const RmsArgs<T>& a, size_t off, int first, int lanes) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    load_chunk<T, VEC, true>(x[j], a.x + off, first + j * lanes, a.hidden);
    if (RES) load_chunk<T, VEC, true>(r[j], a.r + off, first + j * lanes, a.hidden);
  }
}

// A block of rpb rows, 32 << wpr_log2 lanes each, the weight of dtype
// code WD.  Lane lr of a row owns chunks t * NV * lanes + j * lanes + lr
// (j < NV) of tile t; only TILED rows have more than one tile.
template <typename T, int WD, int NV, bool RES, bool VEC, bool TILED>
__global__ void __launch_bounds__(kBlock, 2) rms_norm_kernel(const RmsArgs<T> a) {
  using W = typename DType<WD>::type;
  const W* w = static_cast<const W*>(a.w);
  const int lanes = 32 << a.wpr_log2;
  const int lr = threadIdx.x & (lanes - 1);
  const int rib = threadIdx.x >> (5 + a.wpr_log2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpr = 1 << a.wpr_log2;
  const int tiles = TILED ? (a.chunks + NV * lanes - 1) / (NV * lanes) : 1;
  __shared__ float part[kBlock / 32];

  const long long row = static_cast<long long>(blockIdx.x) * a.rpb + rib;
  const bool live = row < a.rows;
  const size_t off = static_cast<size_t>(live ? row : 0) * a.hidden;
  // the row's chunks and the weight's, all in flight before the first use
  Pack<T> xv[NV], rv[NV];
  WPack<T, W> wv[NV];
  if (live) load_tile<T, NV, RES, VEC>(xv, rv, a, off, lr, lanes);
#pragma unroll
  for (int j = 0; j < NV; ++j) load_weight<T, W, VEC>(wv[j], w, lr + j * lanes, a.hidden);

  float ss = 0.f;
  if (live) {
    for (int t = 0; t < tiles; ++t) {
      if (TILED && t > 0) load_tile<T, NV, RES, VEC>(xv, rv, a, off, t * NV * lanes + lr, lanes);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (RES) {
          add_residual(xv[j], rv[j]);
          store_chunk<T, VEC>(a.sum + off, t * NV * lanes + j * lanes + lr, a.hidden, xv[j]);
        }
        ss += sum_squares(xv[j]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (wpr > 1) {  // block-uniform
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = lane < wpr ? part[rib * wpr + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float inv = rsqrtf(ss * a.inv_hidden + a.eps);
  if (!live) return;
  if (!TILED) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      store_chunk<T, VEC>(a.out + off, j * lanes + lr, a.hidden, scale_chunk(xv[j], wv[j], inv));
    }
    return;
  }
  // a row of several tiles is read again: the sum this thread wrote, or x
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = t * NV * lanes + j * lanes + lr;
      WPack<T, W> wt = wv[j];
      if (t > 0) load_weight<T, W, VEC>(wt, w, c, a.hidden);
      if (RES) {
        load_chunk<T, VEC, false>(xv[j], a.sum + off, c, a.hidden);
      } else {
        load_chunk<T, VEC, true>(xv[j], a.x + off, c, a.hidden);
      }
      store_chunk<T, VEC>(a.out + off, c, a.hidden, scale_chunk(xv[j], wt, inv));
    }
  }
}

// One thread: chunk c of one row; grid (column blocks, rows), grid
// stride over the rows past gridDim.y.
template <typename T, bool VEC>
__global__ void __launch_bounds__(128) swiglu_kernel(const T* __restrict__ x,
                                                     const T* __restrict__ y, T* __restrict__ out,
                                                     long long rows, int cols, long long xs,
                                                     long long ys) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c * Pack<T>::N >= cols) return;  // no barriers below
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    Pack<T> xv, yv, o;
    load_chunk<T, VEC, true>(xv, x + row * xs, c, cols);
    load_chunk<T, VEC, true>(yv, y + row * ys, c, cols);
#pragma unroll
    for (int k = 0; k < Pack<T>::N; ++k) {
      const float xf = to_f32(xv.v[k]);
      o.v[k] = from_f32<T>(__fdividef(xf, 1.0f + __expf(-xf)) * to_f32(yv.v[k]));
    }
    store_chunk<T, VEC>(out + row * cols, c, cols, o);
  }
}

__global__ void empty_kernel() {}

// The kernel of one (NV, TILED) choice: the chosen instantiation, or null
// for a choice the kernel does not take (TILED only with NV 4).
template <typename T, int WD, bool RES, bool VEC>
const void* rms_kernel(int nv, bool tiled) {
  if (tiled) {
    return nv == 4 ? reinterpret_cast<const void*>(&rms_norm_kernel<T, WD, 4, RES, VEC, true>)
                   : nullptr;
  }
  switch (nv) {
    case 1: return reinterpret_cast<const void*>(&rms_norm_kernel<T, WD, 1, RES, VEC, false>);
    case 2: return reinterpret_cast<const void*>(&rms_norm_kernel<T, WD, 2, RES, VEC, false>);
    case 4: return reinterpret_cast<const void*>(&rms_norm_kernel<T, WD, 4, RES, VEC, false>);
    default: return nullptr;
  }
}

template <typename T, int WD>
const void* rms_kernel_of(bool res, bool vec, int nv, bool tiled) {
  if (res) {
    return vec ? rms_kernel<T, WD, true, true>(nv, tiled) : rms_kernel<T, WD, true, false>(nv, tiled);
  }
  return vec ? rms_kernel<T, WD, false, true>(nv, tiled) : rms_kernel<T, WD, false, false>(nv, tiled);
}

template <typename T>
const void* rms_kernel_w(int wdtype, bool res, bool vec, int nv, bool tiled) {
  switch (wdtype) {
    case 0: return rms_kernel_of<T, 0>(res, vec, nv, tiled);
    case 1: return rms_kernel_of<T, 1>(res, vec, nv, tiled);
    case 2: return rms_kernel_of<T, 2>(res, vec, nv, tiled);
    default: return nullptr;
  }
}

const void* rms_kernel_for(int dtype, int wdtype, bool res, bool vec, int nv, bool tiled) {
  switch (dtype) {
    case 0: return rms_kernel_w<__nv_bfloat16>(wdtype, res, vec, nv, tiled);
    case 1: return rms_kernel_w<__half>(wdtype, res, vec, nv, tiled);
    case 2: return rms_kernel_w<float>(wdtype, res, vec, nv, tiled);
    default: return nullptr;
  }
}

template <typename T>
cudaError_t launch_rms(const void* kernel, const void* x, const void* r, const void* w,
                       void* out, void* sum, long long rows, int hidden, float eps,
                       int wpr_log2, int rpb, long long grid, cudaStream_t s) {
  RmsArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(r), w,
               static_cast<T*>(out), static_cast<T*>(sum), rows, hidden,
               (hidden + Pack<T>::N - 1) / Pack<T>::N, wpr_log2, rpb, 1.0f / hidden, eps};
  void* args[] = {&a};
  return cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(grid)),
                          dim3((32 << wpr_log2) * rpb), args, 0, s);
}

template <typename T>
cudaError_t launch_swiglu(const void* x, const void* y, void* out, long long rows, int cols,
                          long long xs, long long ys, int threads, int gx, int gy, bool vec,
                          cudaStream_t s) {
  const auto* xp = static_cast<const T*>(x);
  const auto* yp = static_cast<const T*>(y);
  auto* op = static_cast<T*>(out);
  if (vec) {
    swiglu_kernel<T, true><<<dim3(gx, gy), threads, 0, s>>>(xp, yp, op, rows, cols, xs, ys);
  } else {
    swiglu_kernel<T, false><<<dim3(gx, gy), threads, 0, s>>>(xp, yp, op, rows, cols, xs, ys);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype, wdtype (the weight's): 0 bf16, 1 f16, 2 f32.  r and sum both null
// (no residual) or both set.  The geometry (nv, warps a row as wpr_log2,
// rows a block rpb, tiled) comes from ops/fused_norm.py:rms_geometry; the
// grid is a block a row group.  vec says that hidden is a multiple of a
// 16-byte chunk of x and every pointer is 16-byte aligned.  Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int paddle_rms_norm(const void* x, const void* r, const void* w, void* out, void* sum,
                               long long rows, int hidden, float eps, int dtype, int wdtype,
                               int nv, int wpr_log2, int rpb, int tiled, int vec, void* stream) {
  const int elems = dtype == 2 ? 4 : 8;
  const bool ok_vec = hidden % elems == 0 && aligned16(x) && aligned16(w) && aligned16(out) &&
                      (r == nullptr || (aligned16(r) && aligned16(sum)));
  const void* kernel = rms_kernel_for(dtype, wdtype, r != nullptr, vec != 0, nv, tiled != 0);
  const int chunks = (hidden + elems - 1) / elems;
  const long long grid = rpb >= 1 ? (rows + rpb - 1) / rpb : 0;
  if (kernel == nullptr || rows <= 0 || hidden <= 0 || (r == nullptr) != (sum == nullptr) ||
      wpr_log2 < 0 || wpr_log2 > 3 || rpb < 1 || (32 << wpr_log2) * rpb > kBlock ||
      grid > 0x7fffffffLL || (vec && !ok_vec) || (!tiled && chunks > nv * (32 << wpr_log2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_rms<__nv_bfloat16>(kernel, x, r, w, out, sum, rows, hidden, eps, wpr_log2,
                                      rpb, grid, s);
      break;
    case 1:
      err = launch_rms<__half>(kernel, x, r, w, out, sum, rows, hidden, eps, wpr_log2, rpb, grid,
                               s);
      break;
    default:
      err = launch_rms<float>(kernel, x, r, w, out, sum, rows, hidden, eps, wpr_log2, rpb, grid,
                              s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// out [rows, cols] contiguous = silu(x) * y, x and y [rows, cols] with row
// strides xs and ys (elements).  The geometry (threads a block, grid gx x
// gy) comes from ops/swiglu.py:swiglu_grid; vec says that cols and both
// strides are multiples of a 16-byte chunk and every pointer is 16-byte
// aligned.
extern "C" int paddle_swiglu(const void* x, const void* y, void* out, long long rows, int cols,
                             long long xs, long long ys, int dtype, int threads, int gx, int gy,
                             int vec, void* stream) {
  const int n = dtype == 2 ? 4 : 8;
  const bool ok_vec = cols % n == 0 && (rows == 1 || (xs % n == 0 && ys % n == 0)) &&
                      aligned16(x) && aligned16(y) && aligned16(out);
  if (rows <= 0 || cols <= 0 || xs < 0 || ys < 0 || dtype < 0 || dtype > 2 || threads < 32 ||
      threads > 128 || threads % 32 != 0 || gx < 1 || gy < 1 || gy > 65535 ||
      static_cast<long long>(gx) * threads * n < cols || (vec && !ok_vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_swiglu<__nv_bfloat16>(x, y, out, rows, cols, xs, ys,
                                                           threads, gx, gy, vec != 0, s));
    case 1:
      return static_cast<int>(
          launch_swiglu<__half>(x, y, out, rows, cols, xs, ys, threads, gx, gy, vec != 0, s));
    default:
      return static_cast<int>(
          launch_swiglu<float>(x, y, out, rows, cols, xs, ys, threads, gx, gy, vec != 0, s));
  }
}

// An empty launch: the fixed cost of a launch under a timer (chip_smoke.py's
// floor_ms).
extern "C" int paddle_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
