// The body of K5: a whole adaptive explicit-RK solve in one launch, every
// sample under its own step controller, templated on its right-hand side.
//
// Replaces the engine of tfdiffeq_tpu/ops/pallas_kernels.py:929
// (_make_perlane_kernel, with _rk_stages :522, _interp_coeffs :558 and
// _controller_factor :577; launched by perlane_solve_call :1108). Each
// sample keeps its own t, dt, accept decision, counters and status: per
// attempt the stages of the tableau, the RMS error over the sample's D
// features, the clamped I-controller, Kahan accumulation of the state and
// the dense-output drain of every requested time in the accepted interval
// (t, t1] (exactly y_new at t1). A sample stops at t_end, with status 1
// when its attempts reach max_steps before t_end, or status 2 when a
// rejected step falls below dt_min; the rows it never reaches stay zero.
// Invalid times give status 3 on every sample. lane_stats holds each
// sample's nfe, accepted, rejected and status; stats their sums and the
// largest status.
//
// Design. No sample ever reads another's state, so one thread owns one
// sample for the whole solve, over as many blocks as the batch needs, with
// no barrier after the prologue; a thread stops when its sample is done
// and drains through its own cursor. The output times sit in shared memory
// after what the right-hand side keeps there; the sample's state, FSAL
// derivative, compensation, increments and stages live in a device
// workspace laid out feature-major ([row][B]).
//
// The right-hand side `Rhs` (csrc/perlane_solve_kernel.cu: the MLP routes;
// csrc/plan_rhs.cuh: K14's generated plans) provides Shared and Local
// state, setup(sh, lo, smem) (copies what it keeps in shared memory, no
// barrier; returns the free shared memory), in(lo) (where the kernel writes
// a sample's D inputs) and eval(sh, lo, t, b, B) (sample b's D outputs).
#pragma once

#include "mlp_rk.cuh"

namespace tfd {

template <typename T>
struct PerlaneScalars {
  T rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, valid, T_out, B, D;
};

template <typename T, class Rhs>
__global__ void rk_perlane_kernel(const T* __restrict__ tau_g,
                                  const T* __restrict__ y0g,
                                  const T* __restrict__ f0g,
                                  const T* __restrict__ dt0g,
                                  T* __restrict__ out,
                                  int* __restrict__ lane_stats,
                                  int* __restrict__ stats,
                                  T* __restrict__ work, Rhs rhs,
                                  Tableau<T> tab_in, PerlaneScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  typename Rhs::Local lo;
  T* tau = rhs.setup(rsh, lo, smem_raw);   // [T_out]
  if (tid == 0) tab = tab_in;
  for (int i = tid; i < sc.T_out; i += blockDim.x) tau[i] = tau_g[i];
  __syncthreads();

  const int T_out = sc.T_out, B = sc.B, D = sc.D, S = tab.S;
  const int b = blockIdx.x * blockDim.x + tid;
  if (b >= B) return;  // no barrier follows

  const long BD = long(B) * D;
  // Feature-major workspace rows of B values: row d of Y is y[d].
  T* Y = work;              // state
  T* F = Y + BD;            // derivative at (t, y): stage 0 (FSAL cache)
  T* C = F + BD;            // Kahan compensation
  T* DEL = C + BD;          // delta = y1 - y0 of the attempt
  T* MID = DEL + BD;        // dense-output midpoint of the attempt
  T* F1 = MID + BD;         // f(t1, y1) for tableaus that are not FSAL
  T* K = F1 + BD;           // stages 1 .. S - 1
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  T* h_in = rhs.in(lo);
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless an accepted step writes it
  // (pallas_kernels.py:975-976).
  for (int d = 0; d < D; ++d) {
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[at(d)] = y0g[i];
    F[at(d)] = f0g[i];
    C[at(d)] = T(0);
  }

  const T t_start = tau[0];
  const T t_end = tau[T_out - 1];
  const T denom = T(D);
  T t = t_start;
  T dt = dt0g[b];
  int oi = 1, nfe = 0, nacc = 0, nrej = 0;
  int status = (t_end > t_start && sc.valid) ? 0 : 3;

  while (t < t_end && status == 0) {
    const T rem = t_end - t;
    const T dt_eff = d_min(dt, rem);
    const bool is_last = dt >= rem;
    const T t1 = is_last ? t_end : t + dt_eff;
    const T dth = t1 - t;

    // Stages: yi = yi + (dt * a_ij) * k_j (pallas_kernels.py:_rk_stages).
    for (int i = 1; i < S; ++i) {
      for (int d = 0; d < D; ++d) {
        T v = Y[at(d)];
        for (int j = 0; j < i; ++j) {
          const T a = tab.a[i][j];
          if (a != T(0)) {
            const T kj = j == 0 ? F[at(d)] : K[at((j - 1) * D + d)];
            v = v + (dth * a) * kj;
          }
        }
        h_in[d] = v;
      }
      const T ti = t + tab.c[i] * dth;
      const T* fo = rhs.eval(rsh, lo, sign * ti, b, B);
      for (int d = 0; d < D; ++d) K[at((i - 1) * D + d)] = sign * fo[d];
    }
    // The combines, the sample's error over its D features, finiteness.
    T ss = T(0);
    bool bad = false;
    for (int d = 0; d < D; ++d) {
      const T y0 = Y[at(d)];
      T delta = T(0), err = T(0), ymid = y0;
      bool first_d = true, first_e = true;
      for (int j = 0; j < S; ++j) {
        const T kj = j == 0 ? F[at(d)] : K[at((j - 1) * D + d)];
        if (tab.b_sol[j] != T(0)) {
          const T term = (dth * tab.b_sol[j]) * kj;
          delta = first_d ? term : delta + term;
          first_d = false;
        }
        if (tab.b_err[j] != T(0)) {
          const T term = (dth * tab.b_err[j]) * kj;
          err = first_e ? term : err + term;
          first_e = false;
        }
        if (tab.has_mid && tab.c_mid[j] != T(0))
          ymid = ymid + (dth * tab.c_mid[j]) * kj;
      }
      const T y1 = y0 + delta;
      const T scale = sc.atol + sc.rtol * d_max(d_abs(y0), d_abs(y1));
      const T esc = err / scale;
      ss = ss + esc * esc;
      bad = bad || !d_finite(y1);
      DEL[at(d)] = delta;
      MID[at(d)] = ymid;
      h_in[d] = y1;
    }
    const T ratio = d_sqrt(ss / denom);
    const bool finite = d_finite(ss) && !bad;
    const bool accept = (ratio <= T(1)) && finite;
    const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                    sc.ifactor, sc.dfactor, tab.order);
    // Rescale the CLAMPED attempted step, as the generic engine does.
    const T dt_next = dth * fac;

    if (accept) {
      if (!tab.fsal) {
        // The end derivative (counted in evals on every attempt).
        const T* fo = rhs.eval(rsh, lo, sign * t1, b, B);
        for (int d = 0; d < D; ++d) F1[at(d)] = sign * fo[d];
      }
      int oi_new = oi;
      while (oi_new < T_out && tau[oi_new] <= t1) ++oi_new;
      for (int d = 0; d < D; ++d) {
        const T y0 = Y[at(d)];
        const T delta = DEL[at(d)];
        const T f0 = F[at(d)];
        const T f1 = tab.fsal ? K[at((S - 2) * D + d)] : F1[at(d)];
        const T y1 = y0 + delta;
        const T df0 = dth * f0;
        const T df1 = dth * f1;
        // pallas_kernels.py:_interp_coeffs.
        const T r1 = y1 - y0 - df0;
        const T r2 = df1 - df0;
        T ca, cb, cc;
        if (tab.has_mid) {
          const T r3 = T(16) * (MID[at(d)] - y0) - T(8) * df0;
          ca = r3 + T(2) * r2 - T(8) * r1;
          cb = r2 - T(2) * r1 - T(2) * ca;
          cc = r1 - ca - cb;
        } else {
          ca = T(0);
          cb = T(2) * (y0 - y1) + df0 + df1;
          cc = T(3) * (y1 - y0) - T(2) * df0 - df1;
        }
        const T comp = C[at(d)];
        const T adj = delta - comp;
        const T y_new = y0 + adj;
        C[at(d)] = (y_new - y0) - adj;
        Y[at(d)] = y_new;
        F[at(d)] = f1;
        // Every requested time in (t, t1], exactly y_new at t1.
        for (int o = oi; o < oi_new; ++o) {
          const T tj = tau[o];
          const T x = (tj - t) / dth;
          const T val = (((ca * x + cb) * x + cc) * x + df0) * x + y0;
          out[long(o) * BD + long(b) * D + d] = (tj == t1) ? y_new : val;
        }
      }
      oi = oi_new;
      t = t1;
    }

    // The sample's status rules (pallas_kernels.py:1077-1092).
    nfe += tab.evals;
    nacc += accept ? 1 : 0;
    nrej += accept ? 0 : 1;
    if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
    if (nacc + nrej >= sc.max_steps && t < t_end && status == 0) status = 1;
    dt = dt_next;
  }
  lane_stats[b] = nfe;
  lane_stats[B + b] = nacc;
  lane_stats[2 * B + b] = nrej;
  lane_stats[3 * B + b] = status;
  // Integer sums: the same total in any order.
  atomicAdd(stats, nfe);
  atomicAdd(stats + 1, nacc);
  atomicAdd(stats + 2, nrej);
  atomicMax(stats + 3, status);
}

template <typename T, class Rhs>
cudaError_t launch_rk_perlane(const void* tau, const void* y0, const void* f0,
                              const void* dt0, void* out, void* lane_stats,
                              void* stats, void* work, const Rhs& rhs,
                              size_t smem, int threads,
                              const Tableau<T>& tab,
                              const PerlaneScalars<T>& sc,
                              cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(stats, 0, 4 * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  auto kernel = rk_perlane_kernel<T, Rhs>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (sc.B + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(tau), static_cast<const T*>(y0),
      static_cast<const T*>(f0), static_cast<const T*>(dt0),
      static_cast<T*>(out), static_cast<int*>(lane_stats),
      static_cast<int*>(stats), static_cast<T*>(work), rhs, tab, sc);
  return cudaGetLastError();
}

// The per-sample controllers' scalars from the host's doubles.
template <typename T>
PerlaneScalars<T> make_perlane_scalars(double rtol, double atol,
                                       double dt_min, double sign,
                                       double safety, double ifactor,
                                       double dfactor, int max_steps,
                                       int valid, int T_out, int B, int D) {
  PerlaneScalars<T> sc;
  sc.rtol = T(rtol);
  sc.atol = T(atol);
  sc.dt_min = T(dt_min);
  sc.sign = T(sign);
  sc.safety = T(safety);
  sc.ifactor = T(ifactor);
  sc.dfactor = T(dfactor);
  sc.max_steps = max_steps;
  sc.valid = valid;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;
  return sc;
}

}  // namespace tfd
