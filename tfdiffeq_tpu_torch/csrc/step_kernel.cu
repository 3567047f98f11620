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
// Design. One thread per sample over a 1-D grid; the weights (4 arrays,
// D*H + H + H*D + D values) sit in shared memory. The TPU kernel adds all
// tiles into one SMEM scalar across its sequential grid
// (pallas_kernels.py:649-659). Hopper blocks run in no order, so each block
// writes its own partial sum to partial[blockIdx.x] in a fixed tree order,
// without atomics, and the wrapper (ops/cuda_kernels.py) adds the partials
// and takes sqrt(sum / (D * B)): the ratio is the same bits on every run.
//
// Bound on the H100. Per sample and step: 6 evaluations of about 4 D H
// flops plus H tanh, against 2 D values read and 3 D written, so the
// kernel is bound by the instruction throughput of its arithmetic and tanh,
// not by memory. At the main path (B = 4096) it fills 16 blocks of 256
// threads, a fraction of the 132 SMs: the step is short, and the launch
// and the host loop around it (solvers/adaptive.py) dominate.
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

template <typename T>
__device__ void mlp_tanh(const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2, const T* __restrict__ b2,
                         int D, int H, const T* y, T* out) {
  T y3[kStepMaxD];
  for (int i = 0; i < D; ++i) y3[i] = y[i] * y[i] * y[i];
  for (int d = 0; d < D; ++d) out[d] = T(0);
  for (int j = 0; j < H; ++j) {
    T acc = w1[j] * y3[0];  // w1 is [D, H]: column j is w1[i * H + j]
    for (int i = 1; i < D; ++i) acc = acc + w1[i * H + j] * y3[i];
    const T h = d_tanh(acc + b1[j]);
    for (int d = 0; d < D; ++d) {
      const T term = w2[j * D + d] * h;
      out[d] = (j == 0) ? term : out[d] + term;
    }
  }
  for (int d = 0; d < D; ++d) out[d] = out[d] + b2[d];
}

template <typename T>
__global__ void dopri5_mlp_step_kernel(
    const T* __restrict__ y, const T* __restrict__ f0,
    const T* __restrict__ w1g, const T* __restrict__ b1g,
    const T* __restrict__ w2g, const T* __restrict__ b2g, T* __restrict__ y1o,
    T* __restrict__ f1o, T* __restrict__ ymido, T* __restrict__ partial,
    int B, int D, int H, T dt, T rtol, T atol, Dopri5Coeffs cw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* w1 = smem;              // [D, H]
  T* b1 = w1 + D * H;        // [H]
  T* w2 = b1 + H;            // [H, D]
  T* b2 = w2 + H * D;        // [D]
  T* red = b2 + D;           // [blockDim.x]
  for (int i = threadIdx.x; i < D * H; i += blockDim.x) {
    w1[i] = w1g[i];
    w2[i] = w2g[i];
  }
  for (int i = threadIdx.x; i < H; i += blockDim.x) b1[i] = b1g[i];
  for (int i = threadIdx.x; i < D; i += blockDim.x) b2[i] = b2g[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  T ss = T(0);
  bool bad = false;
  if (b < B) {
    T k[7][kStepMaxD];
    T y0[kStepMaxD];
    T yi[kStepMaxD];
    for (int d = 0; d < D; ++d) {
      y0[d] = y[b * D + d];
      k[0][d] = f0[b * D + d];
    }
    // pallas_kernels.py:_rk_stages: yi = yi + (dt * a_ij) * k_j over the
    // nonzero a_ij, in order.
    for (int i = 1; i < 7; ++i) {
      for (int d = 0; d < D; ++d) yi[d] = y0[d];
      for (int j = 0; j < i; ++j) {
        const T a = T(cw.a[i - 1][j]);
        if (a != T(0)) {
          const T s = dt * a;
          for (int d = 0; d < D; ++d) yi[d] = yi[d] + s * k[j][d];
        }
      }
      mlp_tanh(w1, b1, w2, b2, D, H, yi, k[i]);
    }
    for (int d = 0; d < D; ++d) {
      T delta = T(0), err = T(0), ymid = y0[d];
      bool first_d = true, first_e = true;
      for (int j = 0; j < 7; ++j) {
        const T bs = T(cw.b_sol[j]);
        if (bs != T(0)) {
          const T term = (dt * bs) * k[j][d];
          delta = first_d ? term : delta + term;
          first_d = false;
        }
        const T be = T(cw.b_err[j]);
        if (be != T(0)) {
          const T term = (dt * be) * k[j][d];
          err = first_e ? term : err + term;
          first_e = false;
        }
        const T cm = T(cw.c_mid[j]);
        if (cm != T(0)) ymid = ymid + (dt * cm) * k[j][d];
      }
      const T y1 = y0[d] + delta;
      const T scale = atol + rtol * d_max(d_abs(y0[d]), d_abs(y1));
      const T esc = err / scale;
      ss = ss + esc * esc;
      bad = bad || !d_finite(y1);
      y1o[b * D + d] = y1;
      f1o[b * D + d] = k[6][d];  // FSAL
      ymido[b * D + d] = ymid;
    }
  }
  const bool any_bad = __syncthreads_or(bad);
  const T total = block_sum(ss, red);
  if (threadIdx.x == 0)
    partial[blockIdx.x] = (d_finite(total) && !any_bad) ? total : d_inf<T>();
}

template <typename T>
int launch_step(const void* y, const void* f0, const void* w1,
                const void* b1, const void* w2, const void* b2, void* y1,
                void* f1, void* ymid, void* partial, int B, int D, int H,
                int threads, double dt, double rtol, double atol,
                const double* coeffs, void* stream) {
  if (D < 1 || D > kStepMaxD || H < 1 || B < 1 || threads < 32 ||
      threads > 1024 || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Dopri5Coeffs cw;
  const double* p = coeffs;  // a (6 x 6), b_sol, b_err, c_mid
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) cw.a[i][j] = *p++;
  for (int j = 0; j < 7; ++j) cw.b_sol[j] = *p++;
  for (int j = 0; j < 7; ++j) cw.b_err[j] = *p++;
  for (int j = 0; j < 7; ++j) cw.c_mid[j] = *p++;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = sizeof(T) * (size_t(2 * D * H + H + D) + threads);
  auto kernel = dopri5_mlp_step_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(f0),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(y1), static_cast<T*>(f1), static_cast<T*>(ymid),
      static_cast<T*>(partial), B, D, H, T(dt), T(rtol), T(atol), cw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfd

extern "C" {

int tfd_dopri5_mlp_step_f32(const void* y, const void* f0, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            void* y1, void* f1, void* ymid, void* partial,
                            int B, int D, int H, int threads, double dt,
                            double rtol, double atol, const double* coeffs,
                            void* stream) {
  return tfd::launch_step<float>(y, f0, w1, b1, w2, b2, y1, f1, ymid, partial,
                                 B, D, H, threads, dt, rtol, atol, coeffs,
                                 stream);
}

int tfd_dopri5_mlp_step_f64(const void* y, const void* f0, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            void* y1, void* f1, void* ymid, void* partial,
                            int B, int D, int H, int threads, double dt,
                            double rtol, double atol, const double* coeffs,
                            void* stream) {
  return tfd::launch_step<double>(y, f0, w1, b1, w2, b2, y1, f1, ymid,
                                  partial, B, D, H, threads, dt, rtol, atol,
                                  coeffs, stream);
}

const char* tfd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
