// The activations of the matmul epilogue (matmul_epilogue.cu and
// matmul_epilogue_sm90.cu), in f32 on the accumulator: gelu is
// 0.5 v (1 + erf(v / sqrt 2)), gelu_tanh 0.5 v (1 + tanh(sqrt(2 / pi)
// (v + 0.044715 v^3))), silu v / (1 + e^-v), relu max(v, 0).  No
// fast-math: erff, tanhf and expf are the accurate library functions, so
// both kernels hold the plain version's tolerances.

#pragma once

#include <math.h>

namespace paddle_epilogue {

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kGeluTanh = 3, kSilu = 4 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.f);
    case kGelu:
      return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    case kGeluTanh:
      return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case kSilu:
      return v / (1.f + expf(-v));
    default:
      return v;
  }
}

}  // namespace paddle_epilogue
