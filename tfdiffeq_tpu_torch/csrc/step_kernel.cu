// K1: one dopri5 step of the tanh-MLP neural ODE
//     f(y) = tanh(y^3 W1 + b1) W2 + b2,      y: [B, D] batch-major.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_kernels.py:614
// (_make_step_kernel, RHS _make_mlp :500, launcher dopri5_mlp_step :665).
// It computes the 7 stages, y1 = y0 + delta, the FSAL derivative f1, the
// 4th-order dense-output midpoint and, for each block of samples, the sum
// of squared scaled errors, +inf when the block's sum or any y1 of it is
// not finite (pallas_kernels.py:646-648).
//
// Design. A group of threads walks a sample: blocks of kStepBlock threads
// hold `samples` samples each (csrc/lane_group.h step_samples: 32, so 16
// threads a sample, unless the slots do not fit in shared memory), the
// weights (D H + H + H D + D values) and each sample's slot (its state,
// stage input, 7 stages, squared errors and hidden units) in shared memory.
// In each evaluation the members take the hidden units (h_j = tanh of the
// first layer's sum over i in order, on y^3), the block meets, then one
// member an output adds out[d] over j in order, as the plain version
// (ops/cuda_kernels.py dopri5_mlp_step_plain) does; the stage inputs and
// the combines are a member a feature. The TPU kernel adds all tiles into
// one SMEM scalar across its sequential grid (pallas_kernels.py:649-659).
// Hopper blocks run in no order, so each block writes its own partial sum
// to partial[blockIdx.x]: each sample's squared errors from 0 in feature
// order, then the block's samples in a fixed tree, without atomics; the
// wrapper adds the partials and takes sqrt(sum / (D * B)): the ratio is
// the same bits on every run.
//
// Bound on the H100. Per sample and step: 6 evaluations of about 4 D H
// flops plus H tanh, against 2 D values read and 3 D written, so the
// kernel is bound by the latency of an evaluation's chains (the output
// sums over H hidden units, one member each) and its barriers, not by
// memory. At the main path (B = 4096) it fills 128 blocks of 16 warps,
// one a SM: the step is short, and the launch and the host loop around it
// (solvers/adaptive.py) dominate.
#include "mlp_rk.cuh"

namespace tfd {

constexpr int kStepMaxD = 16;  // ops/cuda_kernels.py:STEP_MAX_D

// dopri5 coefficients, handed over from the host as doubles
// (tfdiffeq_tpu_torch/ops/tableaus.py DOPRI5, the exact rationals of the
// reference); the kernel rounds them to T as the JAX reference rounds its
// Python floats.
struct Dopri5Coeffs {
  double a[6][6];   // row i - 1 holds stage i's a_ij, j < i
  double b_sol[7];
  double b_err[7];
  double c_mid[7];
};

// f(yi) of one sample with the gsz members of its group (member m; `on`:
// the group has a sample), every thread of the block calling it: the
// members take the hidden units h[j], j = m, m + gsz, ..., then one member
// each output out[d] (pallas_kernels.py:_make_mlp; the hidden sum in the
// plain version's order).
template <typename T>
__device__ void mlp_tanh_group(const T* __restrict__ w1,
                               const T* __restrict__ b1,
                               const T* __restrict__ w2,
                               const T* __restrict__ b2, int D, int H,
                               const T* yi, T* h, T* out, bool on, int m,
                               int gsz) {
  T y3[kStepMaxD];
  for (int i = 0; i < D; ++i) y3[i] = yi[i] * yi[i] * yi[i];
  for (int j = m; on && j < H; j += gsz) {
    T acc = w1[j] * y3[0];  // w1 is [D, H]: column j is w1[i * H + j]
    for (int i = 1; i < D; ++i) acc = acc + w1[i * H + j] * y3[i];
    h[j] = d_tanh(acc + b1[j]);
  }
  __syncthreads();
  for (int d = m; on && d < D; d += gsz) {
    T acc = w2[d] * h[0];
    for (int j = 1; j < H; ++j) acc = acc + w2[j * D + d] * h[j];
    out[d] = acc + b2[d];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kStepBlock, 1) dopri5_mlp_step_kernel(
    const T* __restrict__ y, const T* __restrict__ f0,
    const T* __restrict__ w1g, const T* __restrict__ b1g,
    const T* __restrict__ w2g, const T* __restrict__ b2g, T* __restrict__ y1o,
    T* __restrict__ f1o, T* __restrict__ ymido, T* __restrict__ partial,
    int B, int D, int H, int samples, T dt, T rtol, T atol,
    Dopri5Coeffs cw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* w1 = smem;              // [D, H]
  T* b1 = w1 + D * H;        // [H]
  T* w2 = b1 + H;            // [H, D]
  T* b2 = w2 + H * D;        // [D]
  T* slots = b2 + D;         // [samples][10 D + H]
  T* red = slots + long(samples) * (10 * D + H);   // [samples]
  const int tid = threadIdx.x;
  for (int i = tid; i < D * H; i += blockDim.x) {
    w1[i] = w1g[i];
    w2[i] = w2g[i];
  }
  for (int i = tid; i < H; i += blockDim.x) b1[i] = b1g[i];
  for (int i = tid; i < D; i += blockDim.x) b2[i] = b2g[i];

  const int gsz = blockDim.x / samples, m = tid % gsz, slot = tid / gsz;
  const long b = long(blockIdx.x) * samples + slot;
  const bool on = b < B;
  T* y0 = slots + long(slot) * (10 * D + H);
  T* yi = y0 + D;
  T* k = yi + D;             // [7][D]
  T* es = k + 7 * D;         // squared scaled errors
  T* h = es + D;             // [H]
  for (int d = m; on && d < D; d += gsz) {
    y0[d] = y[b * D + d];
    k[d] = f0[b * D + d];
  }
  __syncthreads();
  for (int i = 1; i < 7; ++i) {
    // pallas_kernels.py:_rk_stages: yi = yi + (dt * a_ij) * k_j over the
    // nonzero a_ij, in order.
    for (int d = m; on && d < D; d += gsz) {
      T v = y0[d];
      for (int j = 0; j < i; ++j) {
        const T a = T(cw.a[i - 1][j]);
        if (a != T(0)) v = v + (dt * a) * k[j * D + d];
      }
      yi[d] = v;
    }
    __syncthreads();
    mlp_tanh_group(w1, b1, w2, b2, D, H, yi, h, k + i * D, on, m, gsz);
  }
  bool bad = false;
  for (int d = m; on && d < D; d += gsz) {
    T delta = T(0), err = T(0), ymid = y0[d];
    bool first_d = true, first_e = true;
    for (int j = 0; j < 7; ++j) {
      const T kj = k[j * D + d];
      const T bs = T(cw.b_sol[j]);
      if (bs != T(0)) {
        const T term = (dt * bs) * kj;
        delta = first_d ? term : delta + term;
        first_d = false;
      }
      const T be = T(cw.b_err[j]);
      if (be != T(0)) {
        const T term = (dt * be) * kj;
        err = first_e ? term : err + term;
        first_e = false;
      }
      const T cm = T(cw.c_mid[j]);
      if (cm != T(0)) ymid = ymid + (dt * cm) * kj;
    }
    const T y1 = y0[d] + delta;
    const T scale = atol + rtol * d_max(d_abs(y0[d]), d_abs(y1));
    const T esc = err / scale;
    es[d] = esc * esc;
    bad = bad || !d_finite(y1);
    y1o[b * D + d] = y1;
    f1o[b * D + d] = k[6 * D + d];  // FSAL
    ymido[b * D + d] = ymid;
  }
  const bool any_bad = __syncthreads_or(bad);
  // Each sample's sum from 0 in feature order, then the block's samples in
  // block_sum's tree (a missing sample adds +0).
  if (m == 0) {
    T ss = T(0);
    for (int d = 0; on && d < D; ++d) ss = ss + es[d];
    red[slot] = ss;
  }
  __syncthreads();
  for (int s = samples / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    const T total = red[0];
    partial[blockIdx.x] = (d_finite(total) && !any_bad) ? total : d_inf<T>();
  }
}

template <typename T>
int launch_step(const void* y, const void* f0, const void* w1,
                const void* b1, const void* w2, const void* b2, void* y1,
                void* f1, void* ymid, void* partial, int B, int D, int H,
                int samples, double dt, double rtol, double atol,
                const double* coeffs, void* stream) {
  // `samples` is the wrapper's step_samples: the partials' count follows it.
  if (D < 1 || D > kStepMaxD || H < 1 || B < 1 ||
      samples != step_samples(D, H, sizeof(T), kLaneSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Dopri5Coeffs cw;
  const double* p = coeffs;  // a (6 x 6), b_sol, b_err, c_mid
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) cw.a[i][j] = *p++;
  for (int j = 0; j < 7; ++j) cw.b_sol[j] = *p++;
  for (int j = 0; j < 7; ++j) cw.b_err[j] = *p++;
  for (int j = 0; j < 7; ++j) cw.c_mid[j] = *p++;
  const int blocks = (B + samples - 1) / samples;
  const size_t smem = sizeof(T) * size_t(step_smem_values(D, H, samples));
  auto kernel = dopri5_mlp_step_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kStepBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(f0),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(y1), static_cast<T*>(f1), static_cast<T*>(ymid),
      static_cast<T*>(partial), B, D, H, samples, T(dt), T(rtol), T(atol),
      cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfd

extern "C" {

int tfd_dopri5_mlp_step_f32(const void* y, const void* f0, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            void* y1, void* f1, void* ymid, void* partial,
                            int B, int D, int H, int samples, double dt,
                            double rtol, double atol, const double* coeffs,
                            void* stream) {
  return tfd::launch_step<float>(y, f0, w1, b1, w2, b2, y1, f1, ymid, partial,
                                 B, D, H, samples, dt, rtol, atol, coeffs,
                                 stream);
}

int tfd_dopri5_mlp_step_f64(const void* y, const void* f0, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            void* y1, void* f1, void* ymid, void* partial,
                            int B, int D, int H, int samples, double dt,
                            double rtol, double atol, const double* coeffs,
                            void* stream) {
  return tfd::launch_step<double>(y, f0, w1, b1, w2, b2, y1, f1, ymid,
                                  partial, B, D, H, samples, dt, rtol, atol,
                                  coeffs, stream);
}

const char* tfd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
