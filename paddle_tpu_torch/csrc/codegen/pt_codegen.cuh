// Helpers of the generated kernels (static/codegen.py): the storage types,
// the rounding of a value to its Variable's dtype, the op formulas the
// translator emits, the argument block and the warp reductions.
//
// The header compiles both with nvcc (the kernels) and with a host C++
// compiler (the tests build the same generated chain text for the CPU):
// PT_HD marks what runs on both, and the warp helpers reduce over one
// lane on the host.  Every conversion rounds to nearest even, as torch's
// bf16 and f16 casts do: the host in integer bit operations, the card by
// its conversion instructions.  No fast math:
// the generated sources are built without it and with --fmad=false, so
// each recorded op rounds on its own, as it does when torch runs the ops
// one by one.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#endif

#ifdef __CUDACC__
#define PT_HD __host__ __device__ __forceinline__
#else
#define PT_HD inline
#endif

#define PT_MAX_ARGS 24

// The argument block of every generated launch: the chain's external
// inputs in spec order, then its wide constants; ld is each one's row
// pitch in elements (0 where it has no rows).
struct PtArgs {
  const void* in[PT_MAX_ARGS];
  long long ld[PT_MAX_ARGS];
  void* out;
};

// Storage types; bf16 and f16 are their raw 16 bits.
struct pt_bf16 {
  uint16_t b;
};
struct pt_f16 {
  uint16_t b;
};

PT_HD uint32_t pt_f2u(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

PT_HD float pt_u2f(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

PT_HD uint16_t pt_bf16_bits(float f) {  // round to nearest even, as __float2bfloat16_rn
  uint32_t u = pt_f2u(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

PT_HD float pt_bf16_float(uint16_t b) { return pt_u2f((uint32_t)b << 16); }

PT_HD uint16_t pt_f16_bits(float f) {  // round to nearest even
  uint32_t x = pt_f2u(f);
  const uint32_t sign = x & 0x80000000u;
  x ^= sign;
  uint16_t o;
  if (x >= (uint32_t)(127 + 16) << 23) {
    o = x > 0x7f800000u ? 0x7e00 : 0x7c00;
  } else if (x < (uint32_t)113 << 23) {  // a subnormal or zero half
    const uint32_t magic = (uint32_t)((127 - 15) + (23 - 10) + 1) << 23;
    o = (uint16_t)(pt_f2u(pt_u2f(x) + pt_u2f(magic)) - magic);
  } else {
    const uint32_t odd = (x >> 13) & 1u;
    x += ((uint32_t)(15 - 127) << 23) + 0xfffu + odd;
    o = (uint16_t)(x >> 13);
  }
  return (uint16_t)(o | (sign >> 16));
}

PT_HD float pt_f16_float(uint16_t h) {
  const uint32_t shifted_exp = 0x7c00u << 13;
  uint32_t o = ((uint32_t)h & 0x7fffu) << 13;
  const uint32_t exp = shifted_exp & o;
  o += (uint32_t)(127 - 15) << 23;
  if (exp == shifted_exp) {
    o += (uint32_t)(128 - 16) << 23;
  } else if (exp == 0) {
    o += 1u << 23;
    o = pt_f2u(pt_u2f(o) - pt_u2f((uint32_t)113 << 23));
  }
  return pt_u2f(o | (((uint32_t)h & 0x8000u) << 16));
}

// A value rounded to a Variable's dtype (the compute type stays float).
// On the card the conversion instructions (cvt.rn) do the same rounding
// in one instruction each way; the host takes the bit operations.
PT_HD float pt_rbf16(float x) {
#ifdef __CUDA_ARCH__
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  return pt_bf16_float(pt_bf16_bits(x));
#endif
}
PT_HD float pt_rf16(float x) {
#ifdef __CUDA_ARCH__
  return __half2float(__float2half_rn(x));
#else
  return pt_f16_float(pt_f16_bits(x));
#endif
}

// Loads (to the compute type) and stores (from it) of each storage type.
PT_HD float pt_get(const pt_bf16& v) { return pt_bf16_float(v.b); }
PT_HD float pt_get(const pt_f16& v) { return pt_f16_float(v.b); }
PT_HD float pt_get(const float& v) { return v; }
PT_HD bool pt_get(const bool& v) { return v; }
PT_HD int pt_get(const int8_t& v) { return v; }
PT_HD int pt_get(const uint8_t& v) { return v; }
PT_HD int pt_get(const int16_t& v) { return v; }
PT_HD int pt_get(const int32_t& v) { return v; }
PT_HD long long pt_get(const int64_t& v) { return (long long)v; }

template <class S, class T>
PT_HD S pt_put(T v) {
  return (S)v;
}
template <>
PT_HD pt_bf16 pt_put<pt_bf16, float>(float v) {
#ifdef __CUDA_ARCH__
  return pt_bf16{__bfloat16_as_ushort(__float2bfloat16_rn(v))};
#else
  return pt_bf16{pt_bf16_bits(v)};
#endif
}
template <>
PT_HD pt_f16 pt_put<pt_f16, float>(float v) {
#ifdef __CUDA_ARCH__
  return pt_f16{__half_as_ushort(__float2half_rn(v))};
#else
  return pt_f16{pt_f16_bits(v)};
#endif
}

template <class S>
PT_HD auto pt_ld(const void* p, long long i) -> decltype(pt_get(S())) {
  return pt_get(static_cast<const S*>(p)[i]);
}
template <class S, class T>
PT_HD void pt_st(void* p, long long i, T v) {
  static_cast<S*>(p)[i] = pt_put<S>(v);
}

// ---------------------------------------------------------------- formulas
// Each follows the formula torch's CUDA kernel evaluates in its f32 math
// type (or the port's own functional, where one records the op).

PT_HD bool pt_isnan(float x) { return x != x; }
PT_HD float pt_nan() { return pt_u2f(0x7fc00000u); }

PT_HD float pt_maximum(float a, float b) {  // NaN propagates, as torch.maximum
  return (pt_isnan(a) || pt_isnan(b)) ? pt_nan() : (a > b ? a : b);
}
PT_HD float pt_minimum(float a, float b) {
  return (pt_isnan(a) || pt_isnan(b)) ? pt_nan() : (a < b ? a : b);
}
// integers of two widths (an int64 value against an int literal) compare
// and return in the wider
template <class T, class U>
PT_HD auto pt_imax(T a, U b) -> decltype(a + b) {
  return a > b ? a : b;
}
template <class T, class U>
PT_HD auto pt_imin(T a, U b) -> decltype(a + b) {
  return a < b ? a : b;
}
PT_HD float pt_clamp(float x, float lo, float hi) {  // torch.clamp: NaN stays, lo > hi gives hi
  if (pt_isnan(x)) return x;
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}
PT_HD float pt_relu(float x) { return pt_isnan(x) ? x : (x < 0.f ? 0.f : x); }
PT_HD float pt_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);  // torch's CUDA rsqrt
#else
  return 1.f / sqrtf(x);
#endif
}
PT_HD float pt_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// the port's functionals: silu and gelu computed in f32 and cast once
PT_HD float pt_silu(float x) { return x * pt_sigmoid(x); }
PT_HD float pt_gelu(float x) { return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f)); }
PT_HD float pt_gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.79788456080286535588f * (x + 0.044715f * x * x * x)));
}
PT_HD float pt_leaky_relu(float x, float slope) { return x > 0.f ? x : x * slope; }
PT_HD float pt_elu(float x, float alpha) { return x <= 0.f ? expm1f(x) * alpha : x; }
PT_HD float pt_softplus(float x, float beta, float threshold) {
  return x * beta > threshold ? x : log1pf(expf(x * beta)) / beta;
}
PT_HD float pt_mish(float x) { return x * tanhf(log1pf(expf(x))); }
PT_HD float pt_hardsigmoid(float x) {
  const float t = x + 3.f;
  return (t < 0.f ? 0.f : t > 6.f ? 6.f : t) * (1.f / 6.f);
}
PT_HD float pt_hardswish(float x) {
  const float t = x + 3.f;
  return x * (t < 0.f ? 0.f : t > 6.f ? 6.f : t) * (1.f / 6.f);
}
PT_HD float pt_pow(float x, float y) { return powf(x, y); }

// ------------------------------------------------- reductions across lanes
// LANES == 32: a warp's butterfly; LANES == 1: the host's single lane.

template <int LANES>
PT_HD float pt_lanes_sum(float v) {
#ifdef __CUDA_ARCH__
  if (LANES > 1) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
#endif
  return v;
}
template <int LANES>
PT_HD float pt_lanes_prod(float v) {
#ifdef __CUDA_ARCH__
  if (LANES > 1) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) v *= __shfl_xor_sync(0xffffffffu, v, o);
  }
#endif
  return v;
}
template <int LANES>
PT_HD float pt_lanes_max(float v) {
#ifdef __CUDA_ARCH__
  if (LANES > 1) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) v = pt_maximum(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
#endif
  return v;
}
template <int LANES>
PT_HD float pt_lanes_min(float v) {
#ifdef __CUDA_ARCH__
  if (LANES > 1) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) v = pt_minimum(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
#endif
  return v;
}
