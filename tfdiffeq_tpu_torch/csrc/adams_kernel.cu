// K10: a whole fixed-step Adams solve (explicit_adams: the AB predictor;
// fixed_adams: AB predictor and AM corrector) of an MLP neural ODE in one
// launch.
//
// The engine is csrc/rk_adams.cuh, a template on its right-hand side; this
// file instantiates it with the MLP routes (mlp_rk.cuh MlpLaneRhs: a group
// of threads a sample for explicit_adams; MlpGroupRhs on fixed_adams'
// grid), as csrc/plan_rhs.cuh does with K14's generated plans.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:512
// (_make_adams_solve_kernel; launched by adams_solve_call :653 from
// mlp_solve_adams :1090). What it computes, and its design, are in
// csrc/rk_adams.cuh.
//
// Bound on the H100. Per sample and step the MLP evaluations (at the bench
// widths 2 -> 50 -> 2: about 400 operations and 50 tanh each; 5 a
// fixed_adams step, 1 an explicit_adams one). explicit_adams gives each
// sample a group of 16 threads (32 samples a 512-thread block, 128 blocks
// of 16 warps at B = 4096, where 64 blocks of 2 warps ran with a thread a
// sample), as K8 does: an evaluation costs a layer's longest sum on a
// member and a group barrier a layer, so the solve is bound by that
// chain's latency over its evaluations, the SM's 16 warps hiding each
// other's. fixed_adams spreads the batch over a grid of one block per SM
// (about 31 samples a block at B = 4096), each evaluation a group of 16
// threads a sample, so a corrector iteration costs a layer's longest sum a
// layer, a block barrier a layer and one grid meeting (an atomic and a
// spin in L2).
#include "rk_adams.cuh"

namespace tfd {

// fixed_adams on its grid: a thread, or a group of threads, a sample in
// each evaluation (mlp_rk.cuh MlpGroupRhs).
template <typename T, int kRoute>
cudaError_t launch_adams_route(const void* grid, const void* tau,
                               const void* y0, const void* f0,
                               const void* weights, void* out, void* stats,
                               void* work, long work_size, void* gwork,
                               long gwork_bytes, int n_blocks, int n_w,
                               int threads, const Net& net,
                               const AdamsTables<T>& tables,
                               const AdamsScalars<T>& sc, int* layout,
                               cudaStream_t stream) {
  return launch_rk_adams<T>(
      grid, tau, y0, f0, out, stats, work, work_size, gwork, gwork_bytes,
      n_blocks, make_mlp_group_rhs<T, kRoute>(weights, n_w, net),
      sizeof(T) * (kRoute == kRouteNarrow ? size_t(n_w) : 0), threads,
      tables, sc, layout, stream);
}

// explicit_adams: a group of `group` threads a sample (csrc/rk_adams.cuh
// rk_adams_group_kernel, mlp_rk.cuh MlpLaneRhs), the wide route's
// transposed weights written to the end of the workspace first.
template <typename T, int kRoute>
cudaError_t launch_adams_lanes(const void* grid, const void* tau,
                               const void* y0, const void* f0,
                               const void* weights, void* out, void* stats,
                               void* work, long work_size, int n_w,
                               int group, const Net& net,
                               const AdamsTables<T>& tables,
                               const AdamsScalars<T>& sc, int* layout,
                               cudaStream_t stream) {
  const long slots = group_solve_work_size(
      adams_solve_slot_values(sc.D, sc.max_order, 2L * net_max_width(net)),
      sc.B, group, 0);
  const auto rhs = make_mlp_lane_rhs<T, kRoute>(
      weights, static_cast<T*>(work) + slots, n_w, net);
  cudaError_t e = launch_lane_weights(rhs, stream);
  if (e != cudaSuccess) return e;
  return launch_rk_adams_group<T>(grid, tau, y0, f0, out, stats, work,
                                  work_size, rhs, group, tables, sc, layout,
                                  stream);
}

template <typename T>
int launch_solve_adams(const void* grid, const void* tau, const void* y0,
                       const void* f0, const void* weights, void* out,
                       void* stats, void* work, long work_size, int G,
                       int T_out, int B, int D, int threads, int group,
                       double sign, double rtol, double atol, int max_order,
                       int max_iters, int implicit, int nfe,
                       const double* ab, const double* am, int n_layers,
                       const int* dims, int act_hidden, int act_final,
                       int input_power, int time_input, int route,
                       void* gwork, long gwork_bytes, int n_blocks,
                       int* layout, void* stream) {
  if (!layout || !adams_args_ok(G, T_out, B, D, max_order, max_iters,
                                threads) ||
      D + time_input > kMaxWidth || input_power < 1 ||
      (!implicit && threads != kGroupBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (off < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamsTables<T> tables = make_adams_tables<T>(max_order, ab, am);
  const AdamsScalars<T> sc =
      make_adams_scalars<T>(G, T_out, B, D, sign, rtol, atol, max_order,
                            max_iters, implicit, nfe);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (implicit && route == kRouteNarrow)
    e = launch_adams_route<T, kRouteNarrow>(
        grid, tau, y0, f0, weights, out, stats, work, work_size, gwork,
        gwork_bytes, n_blocks, off, threads, net, tables, sc, layout, st);
  else if (implicit)
    e = launch_adams_route<T, kRouteWide>(
        grid, tau, y0, f0, weights, out, stats, work, work_size, gwork,
        gwork_bytes, n_blocks, off, threads, net, tables, sc, layout, st);
  else if (route == kRouteNarrow)
    e = launch_adams_lanes<T, kRouteNarrow>(grid, tau, y0, f0, weights, out,
                                            stats, work, work_size, off,
                                            group, net, tables, sc, layout,
                                            st);
  else
    e = launch_adams_lanes<T, kRouteWide>(grid, tau, y0, f0, weights, out,
                                          stats, work, work_size, off, group,
                                          net, tables, sc, layout, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_ADAMS_ENTRY(NAME, TYPE)                                    \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, const void* f0,    \
      const void* weights, void* out, void* stats, void* work,              \
      long work_size, int G, int T_out, int B, int D, int threads,          \
      int group, double sign, double rtol, double atol, int max_order,      \
      int max_iters, int implicit, int nfe, const double* ab,               \
      const double* am, int n_layers, const int* dims, int act_hidden,      \
      int act_final, int input_power, int time_input, int route,            \
      void* gwork, long gwork_bytes, int n_blocks, int* layout,             \
      void* stream) {                                                        \
    return tfd::launch_solve_adams<TYPE>(                                    \
        grid, tau, y0, f0, weights, out, stats, work, work_size, G, T_out,  \
        B, D, threads, group, sign, rtol, atol, max_order, max_iters,       \
        implicit, nfe, ab, am, n_layers, dims, act_hidden, act_final,       \
        input_power, time_input, route, gwork, gwork_bytes, n_blocks,       \
        layout, stream);                                                     \
  }

TFD_SOLVE_ADAMS_ENTRY(tfd_mlp_solve_adams_f32, float)
TFD_SOLVE_ADAMS_ENTRY(tfd_mlp_solve_adams_f64, double)
