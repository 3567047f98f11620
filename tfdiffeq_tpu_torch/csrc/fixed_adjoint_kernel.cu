// K9: the whole fixed-grid continuous-adjoint backward sweep of an MLP
// neural ODE (euler, midpoint, rk4, rk4_38).
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:726
// (_make_fixed_adjoint_kernel, RHS pallas_adjoint.py:_make_aug_eval :107;
// launched by _fixed_adjoint_call :863 from mlp_adjoint_solve_fixed :938).
// In sigma = -tau it integrates, with n_sub equal steps per observation
// interval, the augmented system
//
//     dy/dsigma   = -sign f(y),     da_y/dsigma = sign (df/dy)^T a_y,
//     da_w/dsigma = sign (df/dw)^T a_y (batch-summed),
//     da_t/dsigma = sign a_y . df/dt (batch-summed; time_input only),
//
// over the intervals in reverse: y is reset to the stored forward state
// ys[i] and g[i] is added into a_y at each interval start; every step takes
// all stages of the tableau (the MLP forward and its hand-written VJP in
// each) and updates y and a_y Kahan-compensated. ay0 = a_y + g[0] at the
// end; stats are nfe = stages n_sub (T - 1), steps = n_sub (T - 1), 0, 0.
//
// The engine is csrc/rk_adjoint.cuh (rk_fixed_adjoint_kernel), a template
// on its augmented right-hand side; this file instantiates it with the MLP
// routes (csrc/mlp_group_aug.cuh MlpGroupAug, K6's), csrc/plan_aug.cuh
// with K15's.
//
// Design. Nothing in a fixed step reads the parameter or a_t quadratures,
// so the batch never has to meet during the sweep. A group of 16 threads
// (csrc/lane_group.h) owns one sample for the whole sweep, 32 samples a
// 512-thread block, with no barrier between groups: the stage states and
// the Kahan updates a feature a member, the MLP walk each layer's outputs
// (in the VJP its inputs) a member, the quadratures a member each. Each
// sample accumulates its own share of the quadratures: per step, sum_j
// (h b_j) (sign x_j) over the stages in order (the stage combine of the
// reference; each member's terms in registers), then added to its running
// sum ACC. The sample's slot (state, stages, ACC, the walk's layer inputs
// and act'(z)) sits in the block's shared memory where the 32 slots fit
// beside the weights (about 50 KB at the spiral in float32). The batch
// sums come once, at the end, in one fixed order with no atomics: a second,
// small launch takes, for each quadrature, block_sum's tree over each 64
// consecutive samples and adds the trees in order, the order of the
// 64-thread blocks K9 had when a sample was a thread, so
// ops/cuda_fixed.py:mlp_adjoint_solve_fixed_plain did not change and the
// two agree bitwise, and every run gives the same bits.
//
// Bound on the H100. Per stage a group walks its sample's MLP forward and
// VJP (about 1500 operations at the spiral) cut 16 ways: the chain is a
// layer's longest sum (50 terms at the spiral) and a group sync a layer,
// then each member's 16 weighted quadrature terms into registers. 128
// blocks of 16 warps at B = 4096, where 64 blocks of 2 warps ran.
//
// Routes (mlp_rk.cuh Route): narrow, the weights in shared memory; wide,
// for layers up to kMaxWidth or weights past shared memory, the weights
// read from global memory (L2) and the slots, too large for shared
// memory, in the workspace.
#include "mlp_group_aug.cuh"
#include "rk_adjoint.cuh"

namespace tfd {

template <typename T>
int launch_adjoint_fixed(const void* tau, const void* ys, const void* g,
                         const void* weights, void* ay0, void* aw, void* at,
                         void* stats, void* work, long work_size, int T_obs,
                         int B, int D, int threads, int n_sub, double sign,
                         int n_layers, const int* dims, int act_hidden,
                         int act_final, int input_power, int time_input,
                         int stages, const double* c, const double* a,
                         const double* b_sol, int route, void* stream) {
  if (stages < 1 || stages > kMaxStages || T_obs < 1 || B < 1 || D < 1 ||
      n_sub < 1 || D + time_input > kMaxWidth || input_power < 1 ||
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
  // Fixed tableaus have no error weights: b_sol stands in for b_err.
  const Tableau<T> tab =
      make_tableau<T>(stages, 0, 0, c, a, b_sol, b_sol, nullptr);
  FixedAdjScalars<T> sc;
  sc.sign = T(sign);
  sc.T_obs = T_obs;
  sc.B = B;
  sc.D = D;
  sc.n_sub = n_sub;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kRouteNarrow) {
    const auto aug = make_mlp_group_aug<T, kRouteNarrow>(weights, n_w, net,
                                                         n_layers, dims, D);
    e = launch_rk_fixed_adjoint<T>(tau, ys, g, ay0, aw, at, nullptr, stats,
                                   work, work_size, aug,
                                   sizeof(T) * aug.smem_values(), tab, sc,
                                   st);
  } else {
    const auto aug = make_mlp_group_aug<T, kRouteWide>(weights, n_w, net,
                                                       n_layers, dims, D);
    e = launch_rk_fixed_adjoint<T>(tau, ys, g, ay0, aw, at, nullptr, stats,
                                   work, work_size, aug,
                                   sizeof(T) * aug.smem_values(), tab, sc,
                                   st);
  }
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_ADJOINT_FIXED_ENTRY(NAME, TYPE)                                  \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* weights,  \
      void* ay0, void* aw, void* at, void* stats, void* work,               \
      long work_size, int T_obs, int B, int D, int threads, int n_sub,      \
      double sign, int n_layers, const int* dims, int act_hidden,           \
      int act_final, int input_power, int time_input, int stages,           \
      const double* c, const double* a, const double* b_sol, int route,     \
      void* stream) {                                                        \
    return tfd::launch_adjoint_fixed<TYPE>(                                  \
        tau, ys, g, weights, ay0, aw, at, stats, work, work_size, T_obs, B, \
        D, threads, n_sub, sign, n_layers, dims, act_hidden, act_final,     \
        input_power, time_input, stages, c, a, b_sol, route, stream);       \
  }

TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f32, float)
TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f64, double)
