// The elementwise operations of K14's generated code
// (ops/plan_codegen.py), one overload a type, callable from host and device
// code: a plan's segments compile for the card and, with __host__,
// __device__ and __forceinline__ defined empty, as host C++ (the codegen
// tests check them against the plain evaluator that way).
//
// Each is the card's own function where the reference composed a Mosaic
// workaround (tfdiffeq_tpu/ops/jaxpr_bridge.py:73-153: erf by Abramowitz &
// Stegun, pow as exp(b log a), expm1 / cosh / sinh from exp): the plan
// computes the user's function, as PyTorch's CUDA ops do. The logistic stays
// 1 / (1 + exp(-x)), as the plan defines it. max and min propagate a NaN
// operand and otherwise take fmax / fmin, as torch.maximum / torch.minimum.
// A predicate is held as 1 or 0 in the working type.
#pragma once

#include <math.h>

namespace tfd {

#define TFD_PLAN_UN(NAME, FN_F, FN_D)                                       \
  __host__ __device__ __forceinline__ float NAME(float x) { return FN_F(x); } \
  __host__ __device__ __forceinline__ double NAME(double x) { return FN_D(x); }

TFD_PLAN_UN(p_exp, expf, exp)
TFD_PLAN_UN(p_log, logf, log)
TFD_PLAN_UN(p_log1p, log1pf, log1p)
TFD_PLAN_UN(p_tanh, tanhf, tanh)
TFD_PLAN_UN(p_sin, sinf, sin)
TFD_PLAN_UN(p_cos, cosf, cos)
TFD_PLAN_UN(p_tan, tanf, tan)
TFD_PLAN_UN(p_sqrt, sqrtf, sqrt)
TFD_PLAN_UN(p_abs, fabsf, fabs)
TFD_PLAN_UN(p_floor, floorf, floor)
TFD_PLAN_UN(p_ceil, ceilf, ceil)
TFD_PLAN_UN(p_round, rintf, rint)   // half to even
TFD_PLAN_UN(p_expm1, expm1f, expm1)
TFD_PLAN_UN(p_cosh, coshf, cosh)
TFD_PLAN_UN(p_sinh, sinhf, sinh)
TFD_PLAN_UN(p_erf, erff, erf)
TFD_PLAN_UN(p_erfc, erfcf, erfc)
TFD_PLAN_UN(p_asinh, asinhf, asinh)
TFD_PLAN_UN(p_acosh, acoshf, acosh)
TFD_PLAN_UN(p_atanh, atanhf, atanh)
#undef TFD_PLAN_UN

__host__ __device__ __forceinline__ float p_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
__host__ __device__ __forceinline__ double p_rsqrt(double x) {
#ifdef __CUDA_ARCH__
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}

__host__ __device__ __forceinline__ float p_pow(float a, float b) {
  return powf(a, b);
}
__host__ __device__ __forceinline__ double p_pow(double a, double b) {
  return pow(a, b);
}

template <typename T>
__host__ __device__ __forceinline__ T p_logistic(T x) {
  return T(1) / (T(1) + p_exp(-x));
}

template <typename T>
__host__ __device__ __forceinline__ T p_sign(T x) {
  return T((T(0) < x) - (x < T(0)));
}

__host__ __device__ __forceinline__ float p_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__host__ __device__ __forceinline__ double p_max(double a, double b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}
__host__ __device__ __forceinline__ float p_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__host__ __device__ __forceinline__ double p_min(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

template <typename T>
__host__ __device__ __forceinline__ T p_bool(bool x) {
  return x ? T(1) : T(0);
}

// One dot of a plan at a reduced tier (ops/plan_codegen.py _Gen, a tile
// cut): its inputs and outputs, its weights W [dout][din] at w_off in the
// flat constants, its bf16 copy [pad16(dout)][pad16(din)] at w16_off in the
// packed weights, and the live rows ([row][B]) of its input and its result.
struct TierDot {
  int din, dout, w_off, w16_off, in_row, out_row;
};

}  // namespace tfd
