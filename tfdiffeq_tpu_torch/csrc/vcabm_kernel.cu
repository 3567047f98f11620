// K11: a whole variable-coefficient, variable-order Adams-Bashforth-Moulton
// solve (VCABM, method 'adams') of an MLP neural ODE in one launch.
//
// The engine is csrc/rk_vcabm.cuh, a template on its right-hand side; this
// file instantiates it with the MLP routes (mlp_rk.cuh MlpGroupRhs), as
// csrc/plan_rhs.cuh does with K14's generated plans.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_vcabm.py:51
// (_make_vcabm_kernel; launched by vcabm_solve_call :312 from
// mlp_solve_vcabm :399). What it computes, and its design, are in
// csrc/rk_vcabm.cuh.
//
// Bound on the H100. Per sample and attempt two MLP evaluations (at the
// bench widths 2 -> 50 -> 2: about 400 operations and 50 tanh each) and the
// phi rows (about 10 (max_order + 2) operations a feature), in one
// instruction stream a thread; the batch is spread over a grid of one block
// per SM (about 31 samples a block at B = 4096), so an attempt costs one
// thread's chain of those and one or two grid meetings, as in K2.
#include "rk_vcabm.cuh"

namespace tfd {

template <typename T, int kRoute>
cudaError_t launch_vcabm_route(const void* tau, const void* y0,
                               const void* f0, const void* weights,
                               void* out, void* stats, void* work,
                               void* gwork, long gwork_bytes, int n_blocks,
                               int n_w, int threads, const Net& net,
                               const VcabmScalars<T>& sc,
                               cudaStream_t stream) {
  return launch_rk_vcabm<T>(
      tau, y0, f0, out, stats, work, gwork, gwork_bytes, n_blocks,
      make_mlp_group_rhs<T, kRoute>(weights, n_w, net),
      sizeof(T) * (kRoute == kRouteNarrow ? size_t(n_w) : 0), threads, sc,
      stream);
}

template <typename T>
int launch_solve_vcabm(const void* tau, const void* y0, const void* f0,
                       const void* weights, void* out, void* stats,
                       void* work, int T_out, int B, int D, int threads,
                       double dt0, double rtol, double atol, double dt_min,
                       double sign, double safety, double ifactor,
                       double dfactor, int max_steps, int valid,
                       int max_order, const double* gstar, int n_layers,
                       const int* dims, int act_hidden, int act_final,
                       int input_power, int time_input, int route,
                       void* gwork, long gwork_bytes, int n_blocks,
                       void* stream) {
  if (!vcabm_args_ok(T_out, B, D, max_order, max_steps, threads) ||
      D + time_input > kMaxWidth || input_power < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (off < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  const VcabmScalars<T> sc = make_vcabm_scalars<T>(
      T_out, B, D, dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor,
      max_steps, valid, max_order, gstar);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kRouteNarrow)
    e = launch_vcabm_route<T, kRouteNarrow>(tau, y0, f0, weights, out,
                                            stats, work, gwork, gwork_bytes,
                                            n_blocks, off, threads, net, sc,
                                            st);
  else
    e = launch_vcabm_route<T, kRouteWide>(tau, y0, f0, weights, out, stats,
                                          work, gwork, gwork_bytes, n_blocks,
                                          off, threads, net, sc, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_VCABM_ENTRY(NAME, TYPE)                                    \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* weights, \
      void* out, void* stats, void* work, int T_out, int B, int D,          \
      int threads, double dt0, double rtol, double atol, double dt_min,     \
      double sign, double safety, double ifactor, double dfactor,           \
      int max_steps, int valid, int max_order, const double* gstar,         \
      int n_layers, const int* dims, int act_hidden, int act_final,         \
      int input_power, int time_input, int route, void* gwork,              \
      long gwork_bytes, int n_blocks, void* stream) {                       \
    return tfd::launch_solve_vcabm<TYPE>(                                    \
        tau, y0, f0, weights, out, stats, work, T_out, B, D, threads, dt0,  \
        rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps,      \
        valid, max_order, gstar, n_layers, dims, act_hidden, act_final,     \
        input_power, time_input, route, gwork, gwork_bytes, n_blocks,       \
        stream);                                                             \
  }

TFD_SOLVE_VCABM_ENTRY(tfd_mlp_solve_vcabm_f32, float)
TFD_SOLVE_VCABM_ENTRY(tfd_mlp_solve_vcabm_f64, double)
