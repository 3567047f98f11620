// K10: a whole fixed-step Adams solve (explicit_adams: the AB predictor;
// fixed_adams: AB predictor and AM corrector) of an MLP neural ODE in one
// launch.
//
// The engine is csrc/rk_adams.cuh, a template on its right-hand side; this
// file instantiates it with the MLP routes (mlp_rk.cuh MlpGroupRhs: a
// thread a sample for explicit_adams, a group of threads a sample on
// fixed_adams' grid), as csrc/plan_rhs.cuh does with K14's generated plans.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:512
// (_make_adams_solve_kernel; launched by adams_solve_call :653 from
// mlp_solve_adams :1090). What it computes, and its design, are in
// csrc/rk_adams.cuh.
//
// Bound on the H100. Per sample and step the MLP evaluations (at the bench
// widths 2 -> 50 -> 2: about 400 operations and 50 tanh each; 5 a
// fixed_adams step, 1 an explicit_adams one). explicit_adams gives each
// sample a thread's dependent chain, as K14 in K8 does. fixed_adams spreads the
// batch over a grid of one block per SM (about 31 samples a block at
// B = 4096), each evaluation a group of 16 threads a sample, so a corrector
// iteration costs a layer's longest sum a layer, a block barrier a layer
// and one grid meeting (an atomic and a spin in L2).
#include "rk_adams.cuh"

namespace tfd {

template <typename T, int kRoute>
cudaError_t launch_adams_route(const void* grid, const void* tau,
                               const void* y0, const void* f0,
                               const void* weights, void* out, void* stats,
                               void* work, void* gwork, long gwork_bytes,
                               int n_blocks, int n_w, int threads,
                               const Net& net, const AdamsTables<T>& tables,
                               const AdamsScalars<T>& sc,
                               cudaStream_t stream) {
  return launch_rk_adams<T>(
      grid, tau, y0, f0, out, stats, work, gwork, gwork_bytes, n_blocks,
      make_mlp_group_rhs<T, kRoute>(weights, n_w, net),
      sizeof(T) * (kRoute == kRouteNarrow ? size_t(n_w) : 0), threads,
      tables, sc, stream);
}

template <typename T>
int launch_solve_adams(const void* grid, const void* tau, const void* y0,
                       const void* f0, const void* weights, void* out,
                       void* stats, void* work, int G, int T_out, int B,
                       int D, int threads, double sign,
                       double rtol, double atol, int valid, int max_order,
                       int max_iters, int implicit, int nfe,
                       const double* ab, const double* am, int n_layers,
                       const int* dims, int act_hidden, int act_final,
                       int input_power, int time_input, int route,
                       void* gwork, long gwork_bytes, int n_blocks,
                       void* stream) {
  if (!adams_args_ok(G, T_out, B, D, max_order, max_iters, threads) ||
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
    e = launch_adams_route<T, kRouteNarrow>(
        grid, tau, y0, f0, weights, out, stats, work, gwork, gwork_bytes,
        n_blocks, off, threads, net, tables, sc, st);
  else
    e = launch_adams_route<T, kRouteWide>(
        grid, tau, y0, f0, weights, out, stats, work, gwork, gwork_bytes,
        n_blocks, off, threads, net, tables, sc, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_ADAMS_ENTRY(NAME, TYPE)                                    \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, const void* f0,    \
      const void* weights, void* out, void* stats, void* work, int G,       \
      int T_out, int B, int D, int threads, double sign, double rtol,       \
      double atol, int valid, int max_order, int max_iters, int implicit,   \
      int nfe, const double* ab, const double* am, int n_layers,            \
      const int* dims, int act_hidden, int act_final, int input_power,      \
      int time_input, int route, void* gwork, long gwork_bytes,             \
      int n_blocks, void* stream) {                                          \
    return tfd::launch_solve_adams<TYPE>(                                    \
        grid, tau, y0, f0, weights, out, stats, work, G, T_out, B, D,       \
        threads, sign, rtol, atol, valid, max_order, max_iters, implicit,   \
        nfe, ab, am, n_layers, dims, act_hidden, act_final, input_power,    \
        time_input, route, gwork, gwork_bytes, n_blocks, stream);            \
  }

TFD_SOLVE_ADAMS_ENTRY(tfd_mlp_solve_adams_f32, float)
TFD_SOLVE_ADAMS_ENTRY(tfd_mlp_solve_adams_f64, double)
