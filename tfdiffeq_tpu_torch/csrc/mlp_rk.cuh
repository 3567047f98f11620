// Device code shared by the fused-tier kernels (step_kernel.cu,
// solve_kernel.cu): the MLP right-hand side, the activations, the error
// scale, the controller factor and a fixed-order block reduction.
//
// Every formula follows its JAX reference in tfdiffeq_tpu/ops/
// pallas_kernels.py operation for operation (the library is built with
// --fmad=false, so each multiply and add rounds on its own), which is what
// lets a float64 solve here take the same accept/reject sequence as the
// plain PyTorch version in ops/cuda_kernels.py.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tfd {

// Widest layer of the solve kernel's MLP (state width D, D + 1 with a time
// column, hidden widths). ops/cuda_kernels.py raises above it.
constexpr int kMaxWidth = 128;
constexpr int kMaxLayers = 8;
constexpr int kMaxStages = 13;      // dopri8

// Activation codes; ops/cuda_kernels.py:_ACT_CODES holds the same table.
enum Act : int {
  kIdentity = 0,
  kTanh = 1,
  kRelu = 2,
  kElu = 3,
  kSigmoid = 4,
  kSoftplus = 5,
  kSilu = 6,
};

__device__ __forceinline__ float d_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double d_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double d_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
template <typename T>
__device__ __forceinline__ bool d_finite(T x) { return isfinite(x); }
template <typename T> __device__ __forceinline__ T d_inf();
template <> __device__ __forceinline__ float d_inf<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double d_inf<double>() {
  return __longlong_as_double(0x7ff0000000000000ULL);
}

// jnp.maximum / jnp.minimum for ordered operands (a NaN operand makes the
// step non-finite, and such a step is rejected whatever these return).
template <typename T>
__device__ __forceinline__ T d_max(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T d_min(T a, T b) { return a < b ? a : b; }

// pallas_kernels.py:_ACTIVATIONS.
template <typename T>
__device__ __forceinline__ T activate(int code, T x) {
  switch (code) {
    case kTanh:
      return d_tanh(x);
    case kRelu:
      return x < T(0) ? T(0) : x;
    case kElu:  // where(x > 0, x, exp(min(x, 0)) - 1)
      return x > T(0) ? x : d_exp(x) - T(1);
    case kSigmoid:
      return T(1) / (T(1) + d_exp(-x));
    case kSoftplus:
      return d_max(x, T(0)) + d_log1p(d_exp(-d_abs(x)));
    case kSilu:
      return x / (T(1) + d_exp(-x));
    default:
      return x;
  }
}

// A general MLP: layer l maps din[l] inputs to dout[l] outputs with
// weights W_l [dout][din] (row-major, the transpose of the JAX [din, dout])
// and bias b_l [dout], both at offsets into one packed weight array
// (ops/cuda_kernels.py:pack_mlp_weights).
struct Net {
  int n_layers;
  int din[kMaxLayers];
  int dout[kMaxLayers];
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int act_hidden;
  int act_final;
  int input_power;   // the state enters as y ** input_power
  int time_input;    // 1: the first layer's last input column is t
};

// f(t, y) of pallas_kernels.py:_make_net (its VPU path): each output sums
// its input terms in input order, then adds the time column, then the bias.
// The state comes in h_a[0, D) and is overwritten; returns the buffer (h_a
// or h_b) that holds the D outputs. h_a and h_b hold kMaxWidth values.
template <typename T>
__device__ T* mlp_eval(const Net& net, const T* __restrict__ w, T t, T* h_a,
                       T* h_b) {
  const int D = net.din[0] - net.time_input;
  for (int i = 0; i < D; ++i) {
    const T v = h_a[i];
    T h = v;
    for (int p = 1; p < net.input_power; ++p) h = h * v;
    h_a[i] = h;
  }
  T* hin = h_a;
  T* hout = h_b;
  for (int l = 0; l < net.n_layers; ++l) {
    const int din = net.din[l];
    const int dout = net.dout[l];
    const bool tcol = net.time_input && l == 0;
    const int n_state = tcol ? din - 1 : din;
    const T* W = w + net.w_off[l];
    const T* bias = w + net.b_off[l];
    const int code = (l == net.n_layers - 1) ? net.act_final : net.act_hidden;
    for (int o = 0; o < dout; ++o) {
      const T* row = W + o * din;
      T acc = row[0] * hin[0];
      for (int i = 1; i < n_state; ++i) acc = acc + row[i] * hin[i];
      if (tcol) acc = acc + row[n_state] * t;
      hout[o] = activate(code, acc + bias[o]);
    }
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  return hin;
}

// pallas_kernels.py:_controller_factor. r ** (-1/order) is exp(log) there,
// and stays exp(log) here: pow rounds differently and can flip a float64
// accept against the plain version.
template <typename T>
__device__ __forceinline__ T controller_factor(T ratio, bool finite,
                                               bool accept, T safety,
                                               T ifactor, T dfactor,
                                               int order) {
  const T tiny = T(1e-38);
  const T r = d_max(finite ? ratio : T(1048576.0), tiny);  // 2 ** 20
  T fac = safety * d_exp(T(-1.0 / double(order)) * d_log(r));
  if (ratio <= T(0)) fac = ifactor;
  const T lo = accept ? T(1) : dfactor;
  const T hi = accept ? ifactor : T(1);
  return d_min(d_max(fac, lo), hi);
}

// Sum of one value per thread in a fixed tree order (bitwise deterministic
// from run to run). blockDim.x must be a power of two; red holds blockDim.x
// values. Every thread returns the sum.
template <typename T>
__device__ T block_sum(T v, T* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  const T total = red[0];
  __syncthreads();  // red[0] is read by all before anyone writes red again
  return total;
}

}  // namespace tfd
