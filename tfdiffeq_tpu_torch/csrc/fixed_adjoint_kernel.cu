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
// routes (mlp_rk.cuh MlpLaneAug), csrc/plan_aug.cuh with K15's.
//
// Design. Nothing in a fixed step reads the parameter or a_t quadratures,
// so the batch never has to meet during the sweep. One thread owns one
// sample for the whole sweep, over as many blocks as the batch needs, with
// no barrier until the end. Each sample accumulates its own share of the
// quadratures: per step, sum_j (h b_j) (sign x_j) over the stages in
// order (the stage combine of the reference), then added to its running
// sum. The batch sums come once, at the end, in one fixed order with no
// atomics: within a block a shared-memory tree over its threads
// (mlp_rk.cuh block_sum), across blocks a second, small launch that adds
// the block sums in block order. ops/cuda_fixed.py:
// mlp_adjoint_solve_fixed_plain repeats that order, so the two agree to
// roundoff in float64, and every run gives the same bits.
//
// The per-sample quadrature (n_w + time_input values: 252 at the spiral,
// 604 at the latent ODE) is too large for registers and has no static
// bound, so it lives in the device workspace with the rest of the sample's
// state, feature-major ([row][B]: a warp touches 32 consecutive values):
// y, a_y, their compensations and stage derivatives, each layer's inputs
// and act'(z), and the step's and the running quadrature sums. The weights
// sit in shared memory; the layer vectors in per-thread local memory.
//
// Bound on the H100. Per stage, each thread walks its sample's MLP forward
// and VJP (about 800 flops at the spiral) and reads and writes its 2 n_w
// quadrature values (the step sum, then once a step the running sum): at
// the spiral, 4096 x 252 values a stage, L2-resident. With one sample a
// thread there are only 128 warps at B = 4096, so the sweep is bound by
// the latency of each thread's dependent chain and of its workspace
// accesses, not by the card's arithmetic or bandwidth. Several samples a
// thread, or a warp across a sample's hidden units, is the way to more
// throughput.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth or weights past shared memory, the per-thread vectors of 512
// values in local memory and the weights read from global memory (L2).
#include "rk_adjoint.cuh"

namespace tfd {

// Workspace values the sweep needs; ops/cuda_fixed.py:_adjoint_work_size
// allocates the same count.
inline long fixed_adjoint_work_size(const Net& net, int n_w, int S, int B,
                                    int D) {
  return lane_adjoint_work_size(S, B, D, n_w + net.time_input) +
         aug_rows_count(net) * B;
}

template <typename T>
int launch_adjoint_fixed(const void* tau, const void* ys, const void* g,
                         const void* weights, void* ay0, void* aw, void* at,
                         void* stats, void* partial, void* work,
                         long work_size, int T_obs, int B, int D,
                         int threads, int n_sub, double sign, int n_layers,
                         const int* dims, int act_hidden, int act_final,
                         int input_power, int time_input, int stages,
                         const double* c, const double* a,
                         const double* b_sol, int route, void* stream) {
  if (stages < 1 || stages > kMaxStages || T_obs < 1 || B < 1 || D < 1 ||
      n_sub < 1 || D + time_input > kMaxWidth || input_power < 1 ||
      threads < 32 || threads > 1024 || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int n_w = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (n_w < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  if (work_size < fixed_adjoint_work_size(net, n_w, stages, B, D))
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

  const bool narrow = route == kRouteNarrow;
  const size_t smem = sizeof(T) * ((narrow ? size_t(n_w) : 0) + threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      narrow ? launch_rk_fixed_adjoint<T>(
                   tau, ys, g, ay0, aw, at, nullptr, stats, partial, work,
                   make_mlp_lane_aug<T, kRouteNarrow>(weights, n_w, net),
                   smem, threads, tab, sc, st)
             : launch_rk_fixed_adjoint<T>(
                   tau, ys, g, ay0, aw, at, nullptr, stats, partial, work,
                   make_mlp_lane_aug<T, kRouteWide>(weights, n_w, net), smem,
                   threads, tab, sc, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_ADJOINT_FIXED_ENTRY(NAME, TYPE)                                  \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* weights,  \
      void* ay0, void* aw, void* at, void* stats, void* partial,            \
      void* work, long work_size, int T_obs, int B, int D, int threads,     \
      int n_sub, double sign, int n_layers, const int* dims,                \
      int act_hidden, int act_final, int input_power, int time_input,       \
      int stages, const double* c, const double* a, const double* b_sol,    \
      int route, void* stream) {                                             \
    return tfd::launch_adjoint_fixed<TYPE>(                                  \
        tau, ys, g, weights, ay0, aw, at, stats, partial, work, work_size,  \
        T_obs, B, D, threads, n_sub, sign, n_layers, dims, act_hidden,      \
        act_final, input_power, time_input, stages, c, a, b_sol, route,     \
        stream);                                                             \
  }

TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f32, float)
TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f64, double)
