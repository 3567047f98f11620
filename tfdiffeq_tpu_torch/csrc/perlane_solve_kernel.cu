// K5: a whole adaptive explicit-RK solve of an MLP neural ODE in one
// launch, every sample under its own step controller.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_kernels.py:929
// (_make_perlane_kernel, with _rk_stages :522, _interp_coeffs :558,
// _controller_factor :577 and the RHS _make_net :374; launched by
// perlane_solve_call :1108 from mlp_solve(per_sample=True) :1276). Each
// sample keeps its own t, dt, accept decision, counters and status: per
// attempt the stages of the tableau, the RMS error over the sample's D
// features, the clamped I-controller, Kahan accumulation of the state and
// the dense-output drain of every requested time in the accepted interval
// (t, t1] (exactly y_new at t1). A sample stops at t_end, with status 1
// when its attempts reach max_steps before t_end, or status 2 when a
// rejected step falls below dt_min; the rows it never reaches stay zero.
// Invalid times give status 3 on every sample. lane_stats holds each
// sample's nfe, accepted, rejected and status; stats their sums and the
// largest status. The tableau comes in as launch arguments, so one binary
// serves dopri5, bosh3, adaptive_heun, tsit5 and dopri8. Output is written
// straight into the batch-major [T, B, D] layout.
//
// Design. No sample ever reads another's state, so one thread owns one
// sample for the whole solve, over as many blocks as the batch needs, with
// no barrier after the prologue. Where the TPU kernel steps every lane in
// lockstep (done or rejected lanes do masked work) and drains rows through
// a global cursor, a thread here simply stops when its sample is done and
// drains through its own cursor: every row is still written once, from the
// same interpolant. The weights and the output times sit in shared memory;
// the sample's state, FSAL derivative, compensation, increments and stages
// live in a device workspace laid out feature-major ([row][B]: a warp's 32
// threads touch 32 consecutive values); the MLP's layer vectors in
// per-thread local memory (mlp_rk.cuh mlp_eval).
//
// Bound on the H100. Each thread walks its sample's MLP evaluations (at
// the spiral 2 -> 50 -> 2: about 500 operations and 50 tanh each) one
// dependent instruction after another, so the solve is bound by the
// latency of that chain, not by the card's arithmetic or bandwidth: at
// B = 4096 there are 128 warps, about one an SM. The samples of a warp also
// diverge: a warp runs until its slowest sample is done. Several samples a
// thread, or a warp across one sample's hidden units, is the way to more
// throughput.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth or weights past shared memory, the layer vectors of 512 values
// in local memory and the weights read from global memory (L2).
#include "mlp_rk.cuh"

namespace tfd {

template <typename T>
struct PerlaneScalars {
  T rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, valid, T_out, B, D;
};

template <typename T, int kRoute>
__global__ void mlp_solve_perlane_kernel(
    const T* __restrict__ tau_g, const T* __restrict__ y0g,
    const T* __restrict__ f0g, const T* __restrict__ dt0g,
    const T* __restrict__ wg, T* __restrict__ out,
    int* __restrict__ lane_stats, int* __restrict__ stats,
    T* __restrict__ work, int n_weights, Net net_in, Tableau<T> tab_in,
    PerlaneScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Net net;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  const T* w;   // [n_weights]
  T* tau;       // [T_out]
  if constexpr (kRoute == kRouteNarrow) {
    T* ws = reinterpret_cast<T*>(smem_raw);
    for (int i = tid; i < n_weights; i += blockDim.x) ws[i] = wg[i];
    w = ws;
    tau = ws + n_weights;
  } else {
    w = wg;
    tau = reinterpret_cast<T*>(smem_raw);
  }
  if (tid == 0) {
    net = net_in;
    tab = tab_in;
  }
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
  T h_a[vec_width<kRoute>()], h_b[vec_width<kRoute>()];
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
        h_a[d] = v;
      }
      const T ti = t + tab.c[i] * dth;
      const T* fo = mlp_eval(net, w, sign * ti, h_a, h_b);
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
      h_a[d] = y1;
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
        const T* fo = mlp_eval(net, w, sign * t1, h_a, h_b);
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

template <typename T>
int launch_solve_perlane(const void* tau, const void* y0, const void* f0,
                         const void* dt0, const void* weights, void* out,
                         void* lane_stats, void* stats, void* work, int T_out,
                         int B, int D, int threads, double rtol, double atol,
                         double dt_min, double sign, double safety,
                         double ifactor, double dfactor, int max_steps,
                         int valid, int n_layers, const int* dims,
                         int act_hidden, int act_final, int input_power,
                         int time_input, int stages, int order, int fsal,
                         const double* c, const double* a,
                         const double* b_sol, const double* b_err,
                         const double* c_mid, int route, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_out < 1 || B < 1 || D < 1 ||
      D + time_input > kMaxWidth || input_power < 1 || max_steps < 1 ||
      threads < 32 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (off < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tableau<T> tab =
      make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);
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

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(stats, 0, 4 * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool narrow = route == kRouteNarrow;
  const size_t smem = sizeof(T) * ((narrow ? size_t(off) : 0) + T_out);
  auto kernel = narrow ? mlp_solve_perlane_kernel<T, kRouteNarrow>
                       : mlp_solve_perlane_kernel<T, kRouteWide>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + threads - 1) / threads;
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const T*>(tau), static_cast<const T*>(y0),
      static_cast<const T*>(f0), static_cast<const T*>(dt0),
      static_cast<const T*>(weights), static_cast<T*>(out),
      static_cast<int*>(lane_stats), static_cast<int*>(stats),
      static_cast<T*>(work), off, net, tab, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfd

#define TFD_SOLVE_PERLANE_ENTRY(NAME, TYPE)                                  \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* dt0,     \
      const void* weights, void* out, void* lane_stats, void* stats,        \
      void* work, int T_out, int B, int D, int threads, double rtol,        \
      double atol, double dt_min, double sign, double safety,               \
      double ifactor, double dfactor, int max_steps, int valid,             \
      int n_layers, const int* dims, int act_hidden, int act_final,         \
      int input_power, int time_input, int stages, int order, int fsal,     \
      const double* c, const double* a, const double* b_sol,                \
      const double* b_err, const double* c_mid, int route,                 \
      void* stream) {                                                        \
    return tfd::launch_solve_perlane<TYPE>(                                  \
        tau, y0, f0, dt0, weights, out, lane_stats, stats, work, T_out, B,  \
        D, threads, rtol, atol, dt_min, sign, safety, ifactor, dfactor,     \
        max_steps, valid, n_layers, dims, act_hidden, act_final,            \
        input_power, time_input, stages, order, fsal, c, a, b_sol, b_err,   \
        c_mid, route, stream);                                               \
  }

TFD_SOLVE_PERLANE_ENTRY(tfd_mlp_solve_perlane_f32, float)
TFD_SOLVE_PERLANE_ENTRY(tfd_mlp_solve_perlane_f64, double)
