// K2: a whole adaptive explicit-RK solve of an MLP neural ODE in one
// launch, under one step controller shared by the batch.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_kernels.py:726
// (_make_solve_kernel with _rk_stages :522, _interp_coeffs :558,
// _controller_factor :577 and the RHS _make_net :374; launched by
// whole_solve_call :1321 from mlp_solve :1228). Per attempt: the stages of
// the tableau, the masked RMS error over the whole batch, the clamped
// I-controller, Kahan accumulation of the state, the dense-output drain of
// every requested time the accepted step covers, the counters and the
// status; zero fill of the output on early exit. The tableau comes in as
// launch arguments, so one binary serves dopri5, bosh3, adaptive_heun,
// tsit5 and dopri8. Output is written straight into the batch-major
// [T, B, D] layout (the TPU kernel's feature-major [D, B] put the batch on
// its vector lanes and is not copied).
//
// Design. Every attempt's accept needs the error sum over the whole batch
// (pallas_kernels.py:823-832), so the threads that hold the batch must meet
// once per attempt. The simple, right design of this first version is ONE
// thread block for the whole solve: each thread owns the samples b = tid,
// tid + blockDim.x, ... through the whole solve and walks their stages one
// sample at a time; the stage derivatives, the state, the FSAL derivative
// and the Kahan term of the batch live in device scratch (`work`,
// [(S + 5) B D] values: 256 KB at the main path, L2-resident); the
// weights and the tableau sit in shared memory. One fixed-order block
// reduction per attempt gives the error sum (the same bits on every run),
// __syncthreads_or the finiteness flag, and every thread then takes the
// same accept and controller decision from them.
//
// Routes (mlp_rk.cuh Route). Narrow: the layer vectors of 128 values in
// each thread, the weights in shared memory (the main path). Wide: layers
// up to kMaxWidth, vectors of 512 values in local memory, the weights read
// from global memory (131,712 float32 weights, 527 KB, at the wide MLP
// 128 -> 256 -> 256 -> 128: L2-resident, a warp-uniform read per product).
// Batch (csrc/dot_tiers.cuh, the dot-precision tiers): every stage
// evaluation of the attempt is batch-wide, layer by layer, the tier layers
// on the tensor cores in float32; the controller is the same.
//
// rhs = cnf (K7's forward, csrc/cnf_net.cuh cnf_eval, replacing
// pallas_kernels.py:442 _make_cnf_net at :1291-1294): the state is the CNF
// state [z; logp] of D + 1 values, the network the concat-t flow, and each
// per-thread evaluation is the flow plus its exact divergence; a sample's
// act'(z) and f go to workspace rows after the solve's own. Narrow and wide
// routes only (the flow takes no tier).
//
// Bound on the H100. One SM of 132 does all the work: per sample and
// attempt, S - 1 evaluations of the MLP (at the main path 2 -> 50 -> 2:
// about 400 flops and 50 tanh each) run one instruction stream per
// thread, so the solve is bound by the instruction throughput of a single
// SM, and the other 131 idle. Spreading the batch over the card (one block
// per SM and a grid-wide barrier per attempt) is the first optimisation to
// make (see PERF.md). The wide route is bound the same way, with a
// global-memory load beside each multiply-add.
#include "cnf_net.cuh"
#include "dot_tiers.cuh"

namespace tfd {

// Most threads of the one block; the launch takes a power of two up to it
// (block_sum), ops/cuda_kernels.py:SOLVE_THREADS.
constexpr int kSolveThreads = 512;

template <typename T>
struct Scalars {
  T dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, valid, T_out, B, D;
};

template <typename T, int kRoute, bool kCnf>
__global__ void __launch_bounds__(kSolveThreads, 1)
    mlp_solve_kernel(const T* __restrict__ tau, const T* __restrict__ y0g,
                     const T* __restrict__ f0g, const T* __restrict__ wg,
                     T* __restrict__ out, int* __restrict__ stats,
                     T* __restrict__ work, BatchBufs<T> bb, int n_weights,
                     Net net_in, Tableau<T> tab_in, Scalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Net net;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const T* w;     // [n_weights]
  T* red;         // [blockDim.x]
  if constexpr (kRoute == kRouteNarrow) {
    T* ws = reinterpret_cast<T*>(smem_raw);
    for (int i = tid; i < n_weights; i += nth) ws[i] = wg[i];
    w = ws;
    red = ws + n_weights;
  } else {
    w = wg;
    red = reinterpret_cast<T*>(smem_raw);
  }
  if (tid == 0) {
    net = net_in;
    tab = tab_in;
  }
  const int T_out = sc.T_out, B = sc.B, D = sc.D;
  const int rows = (B + 15) / 16 * 16;
  if constexpr (kRoute == kRouteBatch) batch_clear(bb, 0, rows);
  __syncthreads();

  const int S = tab.S;
  const long BD = long(B) * D;
  T* Y = work;              // state
  T* F = Y + BD;            // derivative at (t, y): stage 0 (FSAL cache)
  T* C = F + BD;            // Kahan compensation
  T* DEL = C + BD;          // delta = y1 - y0 of the attempt
  T* MID = DEL + BD;        // dense-output midpoint of the attempt
  T* F1 = MID + BD;         // f(t1, y1) for tableaus that are not FSAL
  T* K = F1 + BD;           // stages 1 .. S - 1
  T* CW = K + (S - 1) * BD;  // rhs = cnf: cnf_eval's rows of B

  T h_a[vec_width<kRoute>()], h_b[vec_width<kRoute>()];
  const T sign = sc.sign;
  // The right-hand side of one sample b at time tt, state in h_a.
  auto rhs = [&](T tt, int b) -> const T* {
    if constexpr (kCnf)
      return cnf_eval(net, w, tt, h_a, h_b, CW, B, b);
    else
      return mlp_eval(net, w, tt, h_a, h_b);
  };

  // Deterministic output on early exit: zero fill, then y0 in row 0
  // (pallas_kernels.py:792-793). Each thread fills its own samples.
  for (int b = tid; b < B; b += nth) {
    for (int d = 0; d < D; ++d) {
      const long i = long(b) * D + d;
      out[i] = y0g[i];
      for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
      Y[i] = y0g[i];
      F[i] = f0g[i];
      C[i] = T(0);
    }
  }

  const T t_start = tau[0];
  const T t_end = tau[T_out - 1];
  const T denom = T(double(D) * double(B));
  T t = t_start;
  T dt = sc.dt0;
  int oi = 1, nfe = 0, nacc = 0, nrej = 0;
  // Non-monotonic times: status 3 (INVALID_TIMES), output zero beyond row 0.
  int status = (t_end > t_start && sc.valid) ? 0 : 3;

  while (t < t_end && status == 0) {
    const T rem = t_end - t;
    const T dt_eff = d_min(dt, rem);
    const bool is_last = dt >= rem;
    const T t1 = is_last ? t_end : t + dt_eff;
    const T dth = t1 - t;

    // ---- phase 1: stages, error and finiteness of each owned sample.
    T ss = T(0);
    bool bad = false;
    // Stage i's state, feature d of the sample at `base`
    // (pallas_kernels.py:_rk_stages: yi = yi + (dt * a_ij) * k_j).
    auto stage_state = [&](long base, int i, int d) {
      T v = Y[base + d];
      for (int j = 0; j < i; ++j) {
        const T a = tab.a[i][j];
        if (a != T(0)) {
          const T kj = j == 0 ? F[base + d] : K[(j - 1) * BD + base + d];
          v = v + (dth * a) * kj;
        }
      }
      return v;
    };
    // The solution, error and midpoint combines of feature d, its share of
    // the error sum and the finiteness flag; returns y1.
    auto combine = [&](long base, int d) {
      const T y0 = Y[base + d];
      T delta = T(0), err = T(0), ymid = y0;
      bool first_d = true, first_e = true;
      for (int j = 0; j < S; ++j) {
        const T kj = j == 0 ? F[base + d] : K[(j - 1) * BD + base + d];
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
      DEL[base + d] = delta;
      MID[base + d] = ymid;
      return y1;
    };
    if constexpr (kRoute != kRouteBatch) {
      for (int b = tid; b < B; b += nth) {
        const long base = long(b) * D;
        for (int i = 1; i < S; ++i) {
          for (int d = 0; d < D; ++d) h_a[d] = stage_state(base, i, d);
          const T ti = t + tab.c[i] * dth;
          const T* fo = rhs(sign * ti, b);
          for (int d = 0; d < D; ++d) K[(i - 1) * BD + base + d] = sign * fo[d];
        }
        for (int d = 0; d < D; ++d) h_a[d] = combine(base, d);
        if (!tab.fsal) {
          // The end derivative costs one more evaluation (counted in evals).
          const T* fo = rhs(sign * t1, b);
          for (int d = 0; d < D; ++d) F1[base + d] = sign * fo[d];
        }
      }
    } else {
      // The batch route: each stage's evaluation is batch-wide.
      for (int i = 1; i < S; ++i) {
        const T ti = t + tab.c[i] * dth;
        for (int b = tid; b < B; b += nth) {
          const long base = long(b) * D;
          batch_put(bb, net, b, sign * ti,
                    [&](int d) { return stage_state(base, i, d); });
        }
        __syncthreads();
        const T* fo = batch_mlp_eval(net, w, bb, 0, rows);
        for (int b = tid; b < B; b += nth)
          for (int d = 0; d < D; ++d)
            K[(i - 1) * BD + long(b) * D + d] = sign * fo[long(b) * bb.ld + d];
      }
      for (int b = tid; b < B; b += nth) {
        const long base = long(b) * D;
        batch_put(bb, net, b, sign * t1,
                  [&](int d) { return combine(base, d); });
      }
      if (!tab.fsal) {
        // The end derivative at (t1, y1), the inputs just written.
        __syncthreads();
        const T* fo = batch_mlp_eval(net, w, bb, 0, rows);
        for (int b = tid; b < B; b += nth)
          for (int d = 0; d < D; ++d)
            F1[long(b) * D + d] = sign * fo[long(b) * bb.ld + d];
      }
    }

    // ---- the batch meets: error sum, finiteness, one shared decision.
    const bool any_bad = __syncthreads_or(bad);
    const T total = block_sum(ss, red);
    const T ratio = d_sqrt(total / denom);
    const bool finite = d_finite(total) && !any_bad;
    const bool accept = (ratio <= T(1)) && finite;
    const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                    sc.ifactor, sc.dfactor, tab.order);
    // Rescale the CLAMPED attempted step, as the generic engine does.
    const T dt_next = dth * fac;

    if (accept) {
      int oi_new = oi;
      while (oi_new < T_out && tau[oi_new] <= t1) ++oi_new;
      // ---- phase 2: dense output, Kahan update, drain, FSAL.
      for (int b = tid; b < B; b += nth) {
        const long base = long(b) * D;
        for (int d = 0; d < D; ++d) {
          const T y0 = Y[base + d];
          const T delta = DEL[base + d];
          const T f0 = F[base + d];
          const T f1 = tab.fsal ? K[(S - 2) * BD + base + d] : F1[base + d];
          const T y1 = y0 + delta;
          const T df0 = dth * f0;
          const T df1 = dth * f1;
          // pallas_kernels.py:_interp_coeffs.
          const T r1 = y1 - y0 - df0;
          const T r2 = df1 - df0;
          T ca, cb, cc;
          if (tab.has_mid) {
            const T r3 = T(16) * (MID[base + d] - y0) - T(8) * df0;
            ca = r3 + T(2) * r2 - T(8) * r1;
            cb = r2 - T(2) * r1 - T(2) * ca;
            cc = r1 - ca - cb;
          } else {
            ca = T(0);
            cb = T(2) * (y0 - y1) + df0 + df1;
            cc = T(3) * (y1 - y0) - T(2) * df0 - df1;
          }
          // Kahan-compensated accumulation.
          const T comp = C[base + d];
          const T adj = delta - comp;
          const T y_new = y0 + adj;
          C[base + d] = (y_new - y0) - adj;
          Y[base + d] = y_new;
          F[base + d] = f1;
          // Every requested time in (t, t1], exactly y_new at t1.
          for (int o = oi; o < oi_new; ++o) {
            const T tj = tau[o];
            const T x = (tj - t) / dth;
            const T val = (((ca * x + cb) * x + cc) * x + df0) * x + y0;
            out[long(o) * BD + base + d] = (tj == t1) ? y_new : val;
          }
        }
      }
      oi = oi_new;
    }

    // Status rules of the kernel (pallas_kernels.py:896-902).
    const int n_att = nacc + nrej + 1;
    if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
    if (n_att >= sc.max_steps && t1 < t_end && status == 0) status = 1;
    if (accept) t = t1;
    dt = dt_next;
    nfe += tab.evals;
    nacc += accept ? 1 : 0;
    nrej += accept ? 0 : 1;
  }
  if (tid == 0) {
    stats[0] = nfe;
    stats[1] = nacc;
    stats[2] = nrej;
    stats[3] = status;
  }
}

template <typename T, int kRoute, bool kCnf>
cudaError_t launch_route(const void* tau, const void* y0, const void* f0,
                         const void* weights, void* out, void* stats,
                         void* work, const BatchBufs<T>& bb, int n_w,
                         int threads, const Net& net, const Tableau<T>& tab,
                         const Scalars<T>& sc, cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * ((kRoute == kRouteNarrow ? size_t(n_w) : 0) + threads);
  auto kernel = mlp_solve_kernel<T, kRoute, kCnf>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<1, threads, smem, stream>>>(
      static_cast<const T*>(tau), static_cast<const T*>(y0),
      static_cast<const T*>(f0), static_cast<const T*>(weights),
      static_cast<T*>(out), static_cast<int*>(stats), static_cast<T*>(work),
      bb, n_w, net, tab, sc);
  return cudaGetLastError();
}

template <typename T>
int launch_solve(const void* tau, const void* y0, const void* f0,
                 const void* weights, void* out, void* stats, void* work,
                 int T_out, int B, int D, int threads, double dt0,
                 double rtol, double atol,
                 double dt_min, double sign, double safety, double ifactor,
                 double dfactor, int max_steps, int valid, int n_layers,
                 const int* dims, int act_hidden, int act_final,
                 int input_power, int time_input, int stages, int order,
                 int fsal, const double* c, const double* a,
                 const double* b_sol, const double* b_err,
                 const double* c_mid, int route, const int* tiers,
                 void* batch_work, long batch_bytes, int cnf, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || stages < 2 ||
      stages > kMaxStages || T_out < 1 || B < 1 || D < 1 ||
      D + time_input > kMaxWidth || input_power < 1 || threads < 32 ||
      threads > kSolveThreads || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The CNF flow maps the D - 1 features of z and the time to D - 1.
  if (cnf && (D < 2 || !time_input || input_power != 1 || tiers ||
              route == kRouteBatch))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, cnf ? D - 1 : D, act_hidden,
                           act_final, input_power, time_input);
  if (off < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long n_w16 = set_tiers(net, tiers);
  if (n_w16 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long rows = (B + 15) / 16 * 16;
  BatchBufs<T> bb{};
  if (route == kRouteBatch) {
    if (!batch_work ||
        batch_bytes < batch_work_bytes(net, n_w16, rows, sizeof(T)))
      return static_cast<int>(cudaErrorInvalidValue);
    bb = batch_bufs<T>(batch_work, net, n_w16, rows);
  } else if (!route_fits(net, route) || tiers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const Tableau<T> tab =
      make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);

  Scalars<T> sc;
  sc.dt0 = T(dt0);
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
  cudaError_t e;
  if (cnf) {
    e = route == kRouteNarrow
            ? launch_route<T, kRouteNarrow, true>(tau, y0, f0, weights, out,
                                                  stats, work, bb, off,
                                                  threads, net, tab, sc, st)
            : launch_route<T, kRouteWide, true>(tau, y0, f0, weights, out,
                                                stats, work, bb, off,
                                                threads, net, tab, sc, st);
  } else if (route == kRouteNarrow) {
    e = launch_route<T, kRouteNarrow, false>(tau, y0, f0, weights, out,
                                             stats, work, bb, off, threads,
                                             net, tab, sc, st);
  } else if (route == kRouteWide) {
    e = launch_route<T, kRouteWide, false>(tau, y0, f0, weights, out, stats,
                                           work, bb, off, threads, net, tab,
                                           sc, st);
  } else {
    tier_pack_kernel<T><<<64, 256, 0, st>>>(
        static_cast<const T*>(weights), net,
        reinterpret_cast<__nv_bfloat16*>(batch_work));
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = launch_route<T, kRouteBatch, false>(tau, y0, f0, weights, out,
                                              stats, work, bb, off, threads,
                                              net, tab, sc, st);
  }
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_ENTRY(NAME, TYPE)                                          \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* weights, \
      void* out, void* stats, void* work, int T_out, int B, int D,          \
      int threads, double dt0, double rtol, double atol, double dt_min,     \
      double sign, double safety, double ifactor, double dfactor,           \
      int max_steps, int valid, int n_layers, const int* dims,              \
      int act_hidden, int act_final, int input_power, int time_input,       \
      int stages, int order, int fsal, const double* c, const double* a,    \
      const double* b_sol, const double* b_err, const double* c_mid,        \
      int route, const int* tiers, void* batch_work, long batch_bytes,      \
      int cnf, void* stream) {                                               \
    return tfd::launch_solve<TYPE>(                                          \
        tau, y0, f0, weights, out, stats, work, T_out, B, D, threads, dt0,  \
        rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps,      \
        valid, n_layers, dims, act_hidden, act_final, input_power,          \
        time_input, stages, order, fsal, c, a, b_sol, b_err, c_mid, route,  \
        tiers, batch_work, batch_bytes, cnf, stream);                        \
  }

TFD_SOLVE_ENTRY(tfd_mlp_solve_f32, float)
TFD_SOLVE_ENTRY(tfd_mlp_solve_f64, double)
