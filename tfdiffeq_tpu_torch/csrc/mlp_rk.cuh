// Code shared by the fused-tier kernels (csrc/*.cu): the MLP right-hand
// side, the activations and their derivatives, the tableau and network
// descriptions built on the host, the controller factor, a fixed-order
// block reduction, and the layout of the MLP walk of the per-sample
// adjoint sweeps (K6, K9) and K6's block sums.
//
// Every formula follows its JAX reference in tfdiffeq_tpu/ops/
// pallas_kernels.py operation for operation (the library is built with
// --fmad=false, so each multiply and add rounds on its own), which is what
// lets a float64 solve here take the same accept/reject sequence as the
// plain PyTorch version in ops/cuda_kernels.py.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lane_group.h"

namespace tfd {

// Widest layer of the MLP kernels (state width D, D + 1 with a time column,
// hidden widths); make_net refuses wider ones, as ops/cuda_kernels.py
// (MAX_WIDTH) does.
constexpr int kMaxWidth = 512;
constexpr int kMaxLayers = 8;
constexpr int kMaxStages = 13;      // dopri8

// Routes of the MLP kernels (ops/cuda_kernels.py:ROUTE_*). A thread walks
// its samples' MLP in per-thread layer vectors of a width class:
// kRouteNarrow holds kNarrowWidth values and keeps the weights in shared
// memory; kRouteWide holds kMaxWidth values and reads the weights from
// global memory (L2-resident: every thread of a warp reads the same weight
// together). kRouteBatch (K2 and K8 only, csrc/dot_tiers.cuh) evaluates a
// stage for the whole batch layer by layer, as the dot-precision tiers
// need. Every route sums each product in input order.
constexpr int kNarrowWidth = 128;
enum Route : int { kRouteNarrow = 0, kRouteWide = 1, kRouteBatch = 2 };
template <int kRoute>
__host__ __device__ constexpr int vec_width() {
  return kRoute == kRouteNarrow ? kNarrowWidth
                                : (kRoute == kRouteWide ? kMaxWidth : 1);
}

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

// pallas_kernels.py:_ACTIVATION_GRADS: act'(z) from z and a = act(z).
template <typename T>
__device__ __forceinline__ T act_grad(int code, T z, T a) {
  switch (code) {
    case kTanh:
      return T(1) - a * a;
    case kRelu:
      return z > T(0) ? T(1) : T(0);
    case kElu:
      return z > T(0) ? T(1) : a + T(1);
    case kSigmoid:
      return a * (T(1) - a);
    case kSoftplus:
      return T(1) / (T(1) + d_exp(-z));
    case kSilu: {
      const T s = T(1) / (T(1) + d_exp(-z));
      return s * (T(1) + z * (T(1) - s));
    }
    default:
      return T(1);
  }
}

// pallas_kernels.py:_ACTIVATION_GRAD2: act''(z) from z, a = act(z) and
// g = act'(z) (the CNF adjoint, csrc/cnf_net.cuh).
template <typename T>
__device__ __forceinline__ T act_grad2(int code, T z, T a, T g) {
  switch (code) {
    case kTanh:
      return (T(-2) * a) * g;
    case kElu:
      return z > T(0) ? T(0) : a + T(1);
    case kSigmoid:
      return g * (T(1) - T(2) * a);
    case kSoftplus: {
      const T s = T(1) / (T(1) + d_exp(-z));
      return s * (T(1) - s);
    }
    case kSilu: {
      const T s = T(1) / (T(1) + d_exp(-z));
      return (s * (T(1) - s)) * (T(2) + z * (T(1) - T(2) * s));
    }
    default:  // identity, relu
      return T(0);
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
  int tier[kMaxLayers];     // dot_tiers.cuh Tier of each layer
  int w16_off[kMaxLayers];  // the layer's bf16 weights (dot_tiers.cuh)
};

// Fill `net` from the host's (din, dout) pairs; returns the packed weight
// count, or -1 for a network the kernels cannot take. Every layer starts at
// the 'highest' tier.
inline int make_net(Net& net, int n_layers, const int* dims, int D,
                    int act_hidden, int act_final, int input_power,
                    int time_input) {
  if (n_layers < 1 || n_layers > kMaxLayers) return -1;
  net.n_layers = n_layers;
  int off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int din = dims[2 * l], dout = dims[2 * l + 1];
    if (din < 1 || dout < 1 || din > kMaxWidth || dout > kMaxWidth) return -1;
    net.din[l] = din;
    net.dout[l] = dout;
    net.w_off[l] = off;
    off += din * dout;
    net.b_off[l] = off;
    off += dout;
    net.tier[l] = 0;
    net.w16_off[l] = 0;
  }
  if (net.din[0] != D + time_input || net.dout[n_layers - 1] != D) return -1;
  net.act_hidden = act_hidden;
  net.act_final = act_final;
  net.input_power = input_power;
  net.time_input = time_input;
  return off;
}

// An explicit RK tableau, handed over as launch arguments so that one
// binary serves dopri5, bosh3, adaptive_heun, tsit5 and dopri8.
template <typename T>
struct Tableau {
  int S;          // stages
  int order;      // controller exponent 1 / order
  int fsal;       // last stage is f(t1, y1)
  int has_mid;    // 4th-order dense-output midpoint weights present
  int evals;      // evaluations counted per forward attempt
  T c[kMaxStages];
  T a[kMaxStages][kMaxStages];  // a[i][j], j < i: stage i's weights
  T b_sol[kMaxStages];
  T b_err[kMaxStages];
  T c_mid[kMaxStages];
};

// The host's doubles (ops/tableaus.py, the reference's exact rationals)
// rounded to T, as the JAX reference rounds its Python floats. a is
// [stages][stages] row-major; c_mid may be null.
template <typename T>
Tableau<T> make_tableau(int stages, int order, int fsal, const double* c,
                        const double* a, const double* b_sol,
                        const double* b_err, const double* c_mid) {
  Tableau<T> tab;
  tab.S = stages;
  tab.order = order;
  tab.fsal = fsal;
  tab.has_mid = c_mid != nullptr;
  tab.evals = fsal ? stages - 1 : stages;
  for (int i = 0; i < kMaxStages; ++i) {
    const bool in = i < stages;
    tab.c[i] = in ? T(c[i]) : T(0);
    tab.b_sol[i] = in ? T(b_sol[i]) : T(0);
    tab.b_err[i] = in ? T(b_err[i]) : T(0);
    tab.c_mid[i] = (in && c_mid) ? T(c_mid[i]) : T(0);
    for (int j = 0; j < kMaxStages; ++j)
      tab.a[i][j] = (in && j < stages) ? T(a[i * stages + j]) : T(0);
  }
  return tab;
}

// One state element's stage i: y + sum_j (dt a_ij) k(j) over the nonzero
// a_ij in order (pallas_kernels.py:_rk_stages, pallas_fixed.py:
// _fixed_stage_walk); k(j) is the element's stage j.
template <typename T, class KGet>
__device__ __forceinline__ T stage_value(const Tableau<T>& tab, int i, T dt,
                                         T y, KGet k) {
  T v = y;
  for (int j = 0; j < i; ++j) {
    const T a = tab.a[i][j];
    if (a != T(0)) v = v + (dt * a) * k(j);
  }
  return v;
}

// One state element's combines over the stages in order: delta = sum_j
// (dt b_sol_j) k(j) and err = sum_j (dt b_err_j) k(j) over the nonzero
// weights, each from its first term, and the dense-output midpoint ymid =
// y0 + sum_j (dt c_mid_j) k(j) where the tableau has one.
template <typename T, class KGet>
__device__ __forceinline__ void combine_value(const Tableau<T>& tab, T dt,
                                              T y0, KGet k, T& delta, T& err,
                                              T& ymid) {
  delta = T(0);
  err = T(0);
  ymid = y0;
  bool first_d = true, first_e = true;
  for (int j = 0; j < tab.S; ++j) {
    const T kj = k(j);
    if (tab.b_sol[j] != T(0)) {
      const T term = (dt * tab.b_sol[j]) * kj;
      delta = first_d ? term : delta + term;
      first_d = false;
    }
    if (tab.b_err[j] != T(0)) {
      const T term = (dt * tab.b_err[j]) * kj;
      err = first_e ? term : err + term;
      first_e = false;
    }
    if (tab.has_mid && tab.c_mid[j] != T(0))
      ymid = ymid + (dt * tab.c_mid[j]) * kj;
  }
}

// One state element's accepted step (K5): the interpolant of
// pallas_kernels.py:_interp_coeffs from y0, delta, the midpoint ymid and
// the end derivatives f0, f1; the Kahan update of y with its compensation
// comp (both updated); and every requested time o in [oi, oi_new) of
// (t, t1] written to out[o * stride + at], exactly the new y at t1.
template <typename T>
__device__ __forceinline__ void accept_value(const Tableau<T>& tab, T& y,
                                             T& comp, T delta, T ymid, T f0,
                                             T f1, T t, T t1, T dth,
                                             const T* tau, int oi,
                                             int oi_new, T* __restrict__ out,
                                             long stride, long at) {
  const T y0 = y;
  const T y1 = y0 + delta;
  const T df0 = dth * f0;
  const T df1 = dth * f1;
  const T r1 = y1 - y0 - df0;
  const T r2 = df1 - df0;
  T ca, cb, cc;
  if (tab.has_mid) {
    const T r3 = T(16) * (ymid - y0) - T(8) * df0;
    ca = r3 + T(2) * r2 - T(8) * r1;
    cb = r2 - T(2) * r1 - T(2) * ca;
    cc = r1 - ca - cb;
  } else {
    ca = T(0);
    cb = T(2) * (y0 - y1) + df0 + df1;
    cc = T(3) * (y1 - y0) - T(2) * df0 - df1;
  }
  const T adj = delta - comp;
  const T y_new = y0 + adj;
  comp = (y_new - y0) - adj;
  y = y_new;
  for (int o = oi; o < oi_new; ++o) {
    const T tj = tau[o];
    const T x = (tj - t) / dth;
    const T val = (((ca * x + cb) * x + cc) * x + df0) * x + y0;
    out[long(o) * stride + at] = (tj == t1) ? y_new : val;
  }
}

// Widest layer of a network built by make_net.
inline int net_max_width(const Net& net) {
  int m = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    if (net.din[l] > m) m = net.din[l];
    if (net.dout[l] > m) m = net.dout[l];
  }
  return m;
}

// Whether a per-thread route can hold the network's layer vectors.
inline bool route_fits(const Net& net, int route) {
  if (route == kRouteNarrow) return net_max_width(net) <= kNarrowWidth;
  return route == kRouteWide;
}

// f(t, y) of pallas_kernels.py:_make_net (its VPU path): each output sums
// its input terms in input order, then adds the time column, then the bias.
// The state comes in h_a[0, D) and is overwritten; returns the buffer (h_a
// or h_b) that holds the D outputs. h_a and h_b hold the network's widest
// layer (the route's vec_width).
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

// mlp_eval for one sample with the gsz threads of its group (member m;
// `on`: the group has a sample this round), every thread of the block
// calling it: the sample's D state values in hin[0 .. D) (2 gw values of
// shared memory, gw the widest layer: the two layer buffers), each layer's
// outputs spread over the members, one member an output, each output the
// same sum in input order (the time column last, then the bias) as
// mlp_eval's, so the same bits; a block barrier a layer. Returns the
// buffer that holds the outputs, which every member may read.
template <typename T>
__device__ const T* mlp_eval_group(const Net& net, const T* __restrict__ w,
                                   T t, T* hin, int gw, bool on, int m,
                                   int gsz) {
  T* hout = hin + gw;
  const int D = net.din[0] - net.time_input;
  for (int i = m; on && i < D; i += gsz) {
    const T v = hin[i];
    T h = v;
    for (int p = 1; p < net.input_power; ++p) h = h * v;
    hin[i] = h;
  }
  __syncthreads();
  for (int l = 0; l < net.n_layers; ++l) {
    const int din = net.din[l];
    const int dout = net.dout[l];
    const bool tcol = net.time_input && l == 0;
    const int n_state = tcol ? din - 1 : din;
    const T* W = w + net.w_off[l];
    const T* bias = w + net.b_off[l];
    const int code = (l == net.n_layers - 1) ? net.act_final : net.act_hidden;
    for (int o = m; on && o < dout; o += gsz) {
      const T* row = W + o * din;
      T acc = row[0] * hin[0];
      for (int i = 1; i < n_state; ++i) acc = acc + row[i] * hin[i];
      if (tcol) acc = acc + row[n_state] * t;
      hout[o] = activate(code, acc + bias[o]);
    }
    __syncthreads();
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  return hin;
}

// A group's barrier (csrc/lane_group.h: the forward solves' groups of
// `n` threads, K5's diverging from one another): __syncwarp over the
// group's lanes up to a warp, else a named barrier, one a group of the
// block (1 + its index; barrier 0 stays __syncthreads').
struct GroupSync {
  unsigned mask;  // the group's lanes of its warp (n <= 32)
  int bar;        // its named barrier (n > 32)
  int n;          // threads of the group

  __device__ static GroupSync of(int n) {
    const int tid = threadIdx.x;
    GroupSync s;
    s.mask = n >= 32 ? 0xFFFFFFFFu
                     : ((1u << n) - 1u) << ((tid & 31) & ~(n - 1));
    s.bar = 1 + tid / n;
    s.n = n;
    return s;
  }
  __device__ __forceinline__ void operator()() const {
    if (n <= 32)
      __syncwarp(mask);
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(n) : "memory");
  }
};

// The transposed weights of the forward solves' group walk (mlp_eval_lanes):
// layer l's weight (o, i) at w_off[l] + i dout[l] + o, so that the members
// of a group, one output each, read neighbouring values; the biases where
// they were. Elements r = r0, r0 + stride, ... of the n_w packed values.
template <typename T>
__device__ void transpose_weights(const Net& net, const T* __restrict__ w,
                                  T* __restrict__ wt, int n_w, int r0,
                                  int stride) {
  for (int r = r0; r < n_w; r += stride) {
    int l = 0;
    while (l + 1 < net.n_layers && r >= net.w_off[l + 1]) ++l;
    int at = r;
    if (r < net.b_off[l]) {
      const int idx = r - net.w_off[l];
      at = net.w_off[l] + (idx % net.din[l]) * net.dout[l] + idx / net.din[l];
    }
    wt[at] = w[r];
  }
}

// The wide route's transposed weights, into global memory before the solve.
template <typename T>
__global__ void transpose_weights_kernel(const T* __restrict__ w, Net net,
                                         int n_w, T* __restrict__ wt) {
  transpose_weights(net, w, wt, n_w, blockIdx.x * blockDim.x + threadIdx.x,
                    gridDim.x * blockDim.x);
}

// kJ outputs of one layer for member o0's pass of mlp_eval_lanes (o0,
// o0 + gsz, ...): each the product with input 0, then inputs 1 .. n_state
// - 1 in order, the time column, the bias, the activation; one pass over
// the inputs for all kJ, so kJ independent chains.
template <int kJ, typename T>
__device__ __forceinline__ void lane_outputs(const T* __restrict__ W,
                                             const T* __restrict__ bias,
                                             const T* hin, T* hout, int o0,
                                             int gsz, int dout, int n_state,
                                             bool tcol, T t, int code) {
  T acc[kJ];
  const T h0 = hin[0];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = W[o0 + j * gsz] * h0;
  for (int i = 1; i < n_state; ++i) {
    const T h = hin[i];
    const T* row = W + long(i) * dout + o0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[j] = acc[j] + row[j * gsz] * h;
  }
  if (tcol) {
    const T* row = W + long(n_state) * dout + o0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[j] = acc[j] + row[j * gsz] * t;
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    hout[o0 + j * gsz] = activate(code, acc[j] + bias[o0 + j * gsz]);
}

// mlp_eval for one sample with the gsz threads of its group (member m),
// the group meeting at `sync`: the sample's D state values in hin[0, D),
// hout the second layer vector (each as wide as the widest layer), wt the
// transposed weights (transpose_weights). Each layer's outputs o = m,
// m + gsz, ... go up to kLaneOuts at a time through one pass over the
// inputs (lane_outputs), each the same sum in input order (the time column
// last, then the bias) as mlp_eval's, so the same bits; the group meets
// after the input power and after each layer. Returns the buffer that
// holds the outputs, which every member may read.
constexpr int kLaneOuts = 4;

template <typename T, class Sync>
__device__ const T* mlp_eval_lanes(const Net& net, const T* __restrict__ wt,
                                   T t, T* hin, T* hout, int m, int gsz,
                                   const Sync& sync) {
  const int D = net.din[0] - net.time_input;
  for (int i = m; i < D; i += gsz) {
    const T v = hin[i];
    T h = v;
    for (int p = 1; p < net.input_power; ++p) h = h * v;
    hin[i] = h;
  }
  sync();
  for (int l = 0; l < net.n_layers; ++l) {
    const int din = net.din[l];
    const int dout = net.dout[l];
    const bool tcol = net.time_input && l == 0;
    const int n_state = tcol ? din - 1 : din;
    const T* W = wt + net.w_off[l];
    const T* bias = wt + net.b_off[l];
    const int code = (l == net.n_layers - 1) ? net.act_final : net.act_hidden;
    for (int o0 = m; o0 < dout; o0 += kLaneOuts * gsz) {
      const int left = (dout - o0 + gsz - 1) / gsz;
      switch (left < kLaneOuts ? left : kLaneOuts) {
        case 1:
          lane_outputs<1>(W, bias, hin, hout, o0, gsz, dout, n_state, tcol,
                          t, code);
          break;
        case 2:
          lane_outputs<2>(W, bias, hin, hout, o0, gsz, dout, n_state, tcol,
                          t, code);
          break;
        case 3:
          lane_outputs<3>(W, bias, hin, hout, o0, gsz, dout, n_state, tcol,
                          t, code);
          break;
        default:
          lane_outputs<kLaneOuts>(W, bias, hin, hout, o0, gsz, dout,
                                  n_state, tcol, t, code);
      }
    }
    sync();
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  return hin;
}

// The MLP right-hand side of K8's, K5's and explicit_adams' group engines
// (csrc/rk_fixed.cuh rk_fixed_group_kernel, csrc/rk_perlane.cuh
// rk_perlane_group_kernel, csrc/rk_adams.cuh rk_adams_group_kernel): one
// sample's mlp_eval_lanes with its group.
// Narrow route: setup copies the weights into shared memory, transposed;
// wide route: a first launch (transpose_weights_kernel) writes the
// transposed weights to `wt` in the workspace, read from global memory
// (L2). gw: the walk vectors' width, the widest layer.
template <typename T, int kRoute>
struct MlpLaneRhs {
  const T* wg;     // packed weights (pack_mlp_weights)
  const T* wt;     // the wide route's transposed weights
  int n_weights;
  int gw;
  Net net_in;

  struct Shared {
    Net net;
  };

  // Values the setup keeps in shared memory, and the transposed weights'
  // values in the workspace.
  long smem_values() const { return kRoute == kRouteNarrow ? n_weights : 0; }
  long wt_values() const { return kRoute == kRouteNarrow ? 0 : n_weights; }
  // The walk's values in a sample's slot: the two layer vectors.
  long walk_values() const { return 2L * gw; }

  __device__ __forceinline__ const T* weights() const {
    if constexpr (kRoute == kRouteNarrow) {
      extern __shared__ __align__(16) unsigned char smem_raw[];
      return reinterpret_cast<const T*>(smem_raw);
    } else {
      return wt;
    }
  }
  // Copies what it keeps in shared memory (no barrier); returns the free
  // shared memory.
  __device__ T* setup(Shared& sh, unsigned char* smem) const {
    T* rest = reinterpret_cast<T*>(smem);
    if constexpr (kRoute == kRouteNarrow) {
      transpose_weights(net_in, wg, rest, n_weights, threadIdx.x,
                        blockDim.x);
      rest += n_weights;
    }
    if (threadIdx.x == 0) sh.net = net_in;
    return rest;
  }
  // The sample's D inputs in hin (2 gw values: the two layer vectors).
  template <class Sync>
  __device__ const T* eval_lanes(const Shared& sh, T t, T* hin, int m,
                                 int gsz, const Sync& sync, int,
                                 int) const {
    return mlp_eval_lanes(sh.net, weights(), t, hin, hin + gw, m, gsz, sync);
  }
};

template <typename T, int kRoute>
MlpLaneRhs<T, kRoute> make_mlp_lane_rhs(const void* weights, void* wt,
                                        int n_w, const Net& net) {
  MlpLaneRhs<T, kRoute> rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.wt = static_cast<const T*>(wt);
  rhs.n_weights = n_w;
  rhs.gw = net_max_width(net);
  rhs.net_in = net;
  return rhs;
}

// The transposed weights of a wide-route launch: one small launch before
// the solve, on its stream (a no-op on the narrow route).
template <typename T, int kRoute>
cudaError_t launch_lane_weights(const MlpLaneRhs<T, kRoute>& rhs,
                                cudaStream_t stream) {
  if constexpr (kRoute == kRouteNarrow) {
    return cudaSuccess;
  } else {
    const int n = rhs.n_weights;
    transpose_weights_kernel<T><<<(n + 255) / 256 < 264 ? (n + 255) / 256
                                                         : 264,
                                  256, 0, stream>>>(
        rhs.wg, rhs.net_in, n, const_cast<T*>(rhs.wt));
    return cudaGetLastError();
  }
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

// ---------------------------------------------------------------------------
// The MLP walk of the adjoint sweeps that give each sample a group of
// threads (K6 and K9, csrc/mlp_group_aug.cuh): where each layer's inputs
// and act'(z) sit among a sample's walk values.
// ---------------------------------------------------------------------------

// Offsets of each layer's inputs (H) and act'(z) (G) among the walk's
// values.
struct AugRows {
  int h_off[kMaxLayers];
  int z_off[kMaxLayers];
};

inline AugRows make_aug_rows(const Net& net) {
  AugRows rows;
  int h = 0, z = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    rows.h_off[l] = h;
    rows.z_off[l] = z;
    h += net.din[l];
    z += net.dout[l];
  }
  return rows;
}

// The per-thread base of MlpGroupRhs (fixed_adams' K10 grid and K11):
// one sample's mlp_eval in its thread, on the narrow or the wide route.
template <typename T, int kRoute>
struct MlpThreadRhs {
  static constexpr bool kBatch = false;
  const T* wg;     // packed weights (pack_mlp_weights)
  int n_weights;
  Net net_in;

  struct Shared {
    Net net;
  };
  // The layer vectors. The weights' pointer stays out of this struct: a
  // store through h_a or h_b could alias it and force a reload each time.
  struct Local {
    T h_a[vec_width<kRoute>()], h_b[vec_width<kRoute>()];
  };

  // The packed weights: in shared memory on the narrow route (setup copies
  // them there), else in global memory.
  __device__ __forceinline__ const T* weights() const {
    if constexpr (kRoute == kRouteNarrow) {
      extern __shared__ __align__(16) unsigned char smem_raw[];
      return reinterpret_cast<const T*>(smem_raw);
    } else {
      return wg;
    }
  }

  __device__ T* setup(Shared& sh, Local&, unsigned char* smem) const {
    const int tid = threadIdx.x;
    T* rest;
    if constexpr (kRoute == kRouteNarrow) {
      T* ws = reinterpret_cast<T*>(smem);
      for (int i = tid; i < n_weights; i += blockDim.x) ws[i] = wg[i];
      rest = ws + n_weights;
    } else {
      rest = reinterpret_cast<T*>(smem);
    }
    if (tid == 0) sh.net = net_in;
    return rest;
  }
  __device__ T* in(Local& lo) const { return lo.h_a; }
  __device__ const T* eval(const Shared& sh, Local& lo, T t, int, int) const {
    return mlp_eval(sh.net, weights(), t, lo.h_a, lo.h_b);
  }
};

// MlpThreadRhs, and a group of threads a sample (mlp_eval_group) where the
// engine walks one: the MLP routes of K10's fixed_adams grid and of K11.
template <typename T, int kRoute>
struct MlpGroupRhs : MlpThreadRhs<T, kRoute> {
  static constexpr bool kGroup = true;
  int gw;      // the group vectors' width: the widest layer
  int slots;   // samples a round (the launch's choice)

  __device__ const T* eval_group(
      const typename MlpThreadRhs<T, kRoute>::Shared& sh, T t, bool on,
      int m, int gsz, T* hin) const {
    return mlp_eval_group(sh.net, this->weights(), t, hin, gw, on, m, gsz);
  }
};

template <typename T, int kRoute>
MlpGroupRhs<T, kRoute> make_mlp_group_rhs(const void* weights, int n_w,
                                          const Net& net) {
  MlpGroupRhs<T, kRoute> rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.n_weights = n_w;
  rhs.net_in = net;
  rhs.gw = net_max_width(net);
  rhs.slots = 1;
  return rhs;
}

// K6's batch sums of the per-sample quadratures: the block sums in
// `partial` ([n_blocks][R], R = n_w + ti) added in block order, one thread
// a value; aw gets the first n_w, at_out the a_t (0 without a time column).
template <typename T>
__global__ void quadrature_reduce_kernel(const T* __restrict__ partial,
                                         int n_blocks, int n_w, int ti,
                                         T* __restrict__ aw,
                                         T* __restrict__ at_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = n_w + ti;
  if (r == 0 && !ti) at_out[0] = T(0);
  if (r >= R) return;
  T total = partial[r];
  for (int k = 1; k < n_blocks; ++k) total = total + partial[long(k) * R + r];
  if (r < n_w)
    aw[r] = total;
  else
    at_out[0] = total;
}

}  // namespace tfd
