// K6: the whole continuous-adjoint backward sweep of an MLP neural ODE in
// one launch, every sample under its own step controller.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_adjoint.py:681
// (_make_perlane_adjoint_kernel, RHS _make_aug_eval :107 with parts='dyn'
// and parts='quad'; launched by perlane_adjoint_call :916 from
// mlp_perlane_adjoint_solve :987). In sigma = -tau it integrates
//
//     dy/dsigma   = -sign f(y),     da_y/dsigma = sign (df/dy)^T a_y,
//     da_w/dsigma = sign (df/dw)^T a_y (batch-summed),
//     da_t/dsigma = sign a_y . df/dt (batch-summed; time_input only),
//
// over the observation intervals in reverse: y is reset to the stored
// forward state ys[i] and g[i] is added into a_y at each interval start;
// each sample then takes adaptive steps on (y, a_y) with its own s, dt,
// accept decision, counters and status, under the (y, a_y) seminorm
// sqrt(sum of 2D squared scaled errors / 2D); dt carries over from one
// interval to the next. Every attempt takes all stages of the tableau (the
// MLP forward and its hand-written VJP in each) and an accepted one updates
// y and a_y Kahan-compensated. A sample whose attempts reach max_steps, or
// whose rejected step falls below dt_min, stops with status 1 or 2 and
// stays inactive. ay0 = a_y + g[0] at the end; lane_stats holds each
// sample's nfe (stages an attempt), accepted, rejected and status, stats
// their sums and the largest status.
//
// The engine is csrc/rk_adjoint.cuh (rk_perlane_adjoint_kernel), a template
// on its augmented right-hand side; this file instantiates it with the MLP
// routes (csrc/mlp_group_aug.cuh MlpGroupAug), csrc/plan_aug.cuh with
// K15's.
//
// Design (csrc/rk_adjoint.cuh rk_perlane_adjoint_kernel). A group of 16
// threads owns a sample for the whole sweep, under the sample's own
// controller, and a block of 512 threads the 32 consecutive samples of
// the end-of-sweep tree; the groups never wait for one another inside the
// sweep. The MLP walk (MlpGroupAug) splits each layer's outputs in
// the forward and its inputs in the VJP over the group's members, each
// value one member's sum in input (or output) order, as K3's stage_group
// does; the layer inputs, act' (overwritten by the pre-activation
// cotangents in the VJP), f and the input cotangent sit in the sample's
// slot, in the block's shared memory where the block's 32 slots fit. The
// TPU kernel decides each lane's acceptance in a first pass and then runs
// the stage evaluations again for the lane-summed parameter quadrature
// with each lane's accept x dt x b_sol folded into its cotangent. Here
// each trial's weighted stage terms, (dt b_j) (sign x_j), join the
// sample's STEP sums while the stages run (a member's share of the
// quadratures in its registers: 16 each at the spiral's 252), and ACC +=
// STEP (in the sample's slot) only when the sample accepts. That one rule
// replaces the second pass, and it keeps a rejected trial that overflowed
// out of the sums (the TPU kernel adds its Inf x 0 = NaN). The batch sums
// of ACC (the parameter and a_t quadratures) come once, at the end, in one
// fixed order with no atomics: a tree over each block's 32 samples (a warp's shuffles, in
// mlp_rk.cuh block_sum's order), then a second, small launch that adds
// the block sums in block order (mlp_rk.cuh quadrature_reduce_kernel).
// ops/cuda_perlane.py:mlp_perlane_adjoint_solve_plain repeats that order.
//
// Bound on the H100. Per stage a group walks its sample's MLP forward and
// VJP (about 1500 operations at the spiral) cut 16 ways: the chain is a
// layer's longest sum (50 terms at the spiral) and a group sync a layer,
// then each member's 16 weighted quadrature terms into registers. 128
// blocks of 16 warps at B = 4096: one block an SM, 16 warps to hide the
// latency where one did before. A group still runs until its own sample
// is done with each interval; its warp holds two samples.
//
// Routes (mlp_rk.cuh Route): narrow, the weights in shared memory; wide,
// for layers up to kMaxWidth or weights past shared memory, the weights
// read from global memory (L2) and the slots, too large for shared
// memory, in the workspace.
#include "mlp_group_aug.cuh"
#include "rk_adjoint.cuh"

namespace tfd {

template <typename T>
int launch_adjoint_perlane(
    const void* tau, const void* ys, const void* g, const void* dt0,
    const void* weights, void* ay0, void* aw, void* at, void* lane_stats,
    void* stats, void* partial, void* work, long work_size, int T_obs,
    int B, int D, int threads, double rtol, double atol, double dt_min,
    double sign, double safety, double ifactor, double dfactor,
    int max_steps, int n_layers, const int* dims, int act_hidden,
    int act_final, int input_power, int time_input, int stages, int order,
    const double* c, const double* a, const double* b_sol,
    const double* b_err, int route, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_obs < 1 || B < 1 || D < 1 ||
      D + time_input > kMaxWidth || input_power < 1 || max_steps < 1 ||
      threads != kLaneGroup * kLaneGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int n_w = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (n_w < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  bool any = false;
  for (int i = 0; i < stages; ++i) any = any || b_sol[i] != 0.0;
  if (!any) return static_cast<int>(cudaErrorInvalidValue);
  const Tableau<T> tab =
      make_tableau<T>(stages, order, 0, c, a, b_sol, b_err, nullptr);
  PerlaneAdjScalars<T> sc;
  sc.rtol = T(rtol);
  sc.atol = T(atol);
  sc.dt_min = T(dt_min);
  sc.sign = T(sign);
  sc.safety = T(safety);
  sc.ifactor = T(ifactor);
  sc.dfactor = T(dfactor);
  sc.max_steps = max_steps;
  sc.T_obs = T_obs;
  sc.B = B;
  sc.D = D;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kRouteNarrow) {
    const auto aug = make_mlp_group_aug<T, kRouteNarrow>(weights, n_w, net,
                                                         n_layers, dims, D);
    e = launch_rk_perlane_adjoint<T>(
        tau, ys, g, dt0, ay0, aw, at, nullptr, lane_stats, stats, partial,
        work, work_size, aug, sizeof(T) * aug.smem_values(), tab, sc, st);
  } else {
    const auto aug = make_mlp_group_aug<T, kRouteWide>(weights, n_w, net,
                                                       n_layers, dims, D);
    e = launch_rk_perlane_adjoint<T>(
        tau, ys, g, dt0, ay0, aw, at, nullptr, lane_stats, stats, partial,
        work, work_size, aug, sizeof(T) * aug.smem_values(), tab, sc, st);
  }
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_ADJOINT_PERLANE_ENTRY(NAME, TYPE)                                \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* dt0,      \
      const void* weights, void* ay0, void* aw, void* at, void* lane_stats, \
      void* stats, void* partial, void* work, long work_size, int T_obs,    \
      int B, int D, int threads, double rtol, double atol, double dt_min,   \
      double sign, double safety, double ifactor, double dfactor,           \
      int max_steps, int n_layers, const int* dims, int act_hidden,         \
      int act_final, int input_power, int time_input, int stages,           \
      int order, const double* c, const double* a, const double* b_sol,     \
      const double* b_err, int route, void* stream) {                        \
    return tfd::launch_adjoint_perlane<TYPE>(                                \
        tau, ys, g, dt0, weights, ay0, aw, at, lane_stats, stats, partial,  \
        work, work_size, T_obs, B, D, threads, rtol, atol, dt_min, sign,    \
        safety, ifactor, dfactor, max_steps, n_layers, dims, act_hidden,    \
        act_final, input_power, time_input, stages, order, c, a, b_sol,     \
        b_err, route, stream);                                               \
  }

TFD_ADJOINT_PERLANE_ENTRY(tfd_mlp_perlane_adjoint_f32, float)
TFD_ADJOINT_PERLANE_ENTRY(tfd_mlp_perlane_adjoint_f64, double)
