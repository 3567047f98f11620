// K10: a whole fixed-step Adams solve (explicit_adams: the AB predictor;
// fixed_adams: AB predictor and AM corrector) of an MLP neural ODE in one
// launch.
//
// The engine is csrc/rk_adams.cuh, a template on its right-hand side; this
// file instantiates it with the MLP routes (mlp_rk.cuh MlpThreadRhs), as
// csrc/plan_rhs.cuh does with K14's generated plans.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:512
// (_make_adams_solve_kernel; launched by adams_solve_call :653 from
// mlp_solve_adams :1090). What it computes, and its design, are in
// csrc/rk_adams.cuh.
//
// Bound on the H100. Each thread walks its samples' MLP evaluations (at the
// bench widths 2 -> 50 -> 2: about 400 operations and 50 tanh each) one
// dependent instruction after another: the solve is bound by the latency
// of that chain and by instruction throughput, as K8 is. explicit_adams
// spreads the batch over the card; fixed_adams keeps it on one SM, and the
// other 131 idle: a grid-wide meet per iteration is the way to spread it.
#include "rk_adams.cuh"

namespace tfd {

template <typename T, int kRoute>
cudaError_t launch_adams_route(const void* grid, const void* tau,
                               const void* y0, const void* f0,
                               const void* weights, void* out, void* stats,
                               void* work, int n_w, int threads, int blocks,
                               const Net& net, const AdamsTables<T>& tables,
                               const AdamsScalars<T>& sc,
                               cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * ((kRoute == kRouteNarrow ? size_t(n_w) : 0) + sc.G +
                   sc.T_out + threads);
  MlpThreadRhs<T, kRoute> rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.n_weights = n_w;
  rhs.net_in = net;
  return launch_rk_adams<T>(grid, tau, y0, f0, out, stats, work, rhs, smem,
                            threads, blocks, tables, sc, stream);
}

template <typename T>
int launch_solve_adams(const void* grid, const void* tau, const void* y0,
                       const void* f0, const void* weights, void* out,
                       void* stats, void* work, int G, int T_out, int B,
                       int D, int threads, int blocks, double sign,
                       double rtol, double atol, int valid, int max_order,
                       int max_iters, int implicit, int nfe,
                       const double* ab, const double* am, int n_layers,
                       const int* dims, int act_hidden, int act_final,
                       int input_power, int time_input, int route,
                       void* stream) {
  if (!adams_args_ok(G, T_out, B, D, max_order, max_iters, implicit,
                     threads, blocks) ||
      D + time_input > kMaxWidth || input_power < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (off < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamsTables<T> tables = make_adams_tables<T>(max_order, ab, am);
  const AdamsScalars<T> sc =
      make_adams_scalars<T>(G, T_out, B, D, sign, rtol, atol, valid,
                            max_order, max_iters, implicit, nfe);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kRouteNarrow)
    e = launch_adams_route<T, kRouteNarrow>(grid, tau, y0, f0, weights, out,
                                            stats, work, off, threads,
                                            blocks, net, tables, sc, st);
  else
    e = launch_adams_route<T, kRouteWide>(grid, tau, y0, f0, weights, out,
                                          stats, work, off, threads, blocks,
                                          net, tables, sc, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_ADAMS_ENTRY(NAME, TYPE)                                    \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, const void* f0,    \
      const void* weights, void* out, void* stats, void* work, int G,       \
      int T_out, int B, int D, int threads, int blocks, double sign,        \
      double rtol, double atol, int valid, int max_order, int max_iters,    \
      int implicit, int nfe, const double* ab, const double* am,            \
      int n_layers, const int* dims, int act_hidden, int act_final,         \
      int input_power, int time_input, int route, void* stream) {           \
    return tfd::launch_solve_adams<TYPE>(                                    \
        grid, tau, y0, f0, weights, out, stats, work, G, T_out, B, D,       \
        threads, blocks, sign, rtol, atol, valid, max_order, max_iters,     \
        implicit, nfe, ab, am, n_layers, dims, act_hidden, act_final,       \
        input_power, time_input, route, stream);                             \
  }

TFD_SOLVE_ADAMS_ENTRY(tfd_mlp_solve_adams_f32, float)
TFD_SOLVE_ADAMS_ENTRY(tfd_mlp_solve_adams_f64, double)
