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
// routes (mlp_rk.cuh MlpLaneAug), csrc/plan_aug.cuh with K15's.
//
// Design. This is K9's design (fixed_adjoint_kernel.cu): one thread owns
// one sample for the whole sweep, over as many blocks as the batch needs,
// with no barrier until the end; the per-sample state lives in the device
// workspace, feature-major. The TPU kernel decides each lane's acceptance
// in a first pass and then runs the stage evaluations again for the
// lane-summed parameter quadrature with each lane's accept x dt x b_sol
// folded into its cotangent. Here each trial's weighted stage terms,
// (dt b_j) (sign x_j), join the sample's STEP rows while the stages run,
// and ACC += STEP only when the sample accepts. That one rule replaces the
// second pass, and it keeps a rejected trial that overflowed out of the
// sums (the TPU kernel adds its Inf x 0 = NaN). The batch sums of ACC (the
// parameter and a_t quadratures) come once, at the end, in one fixed
// order with no atomics: a shared-memory tree within each block
// (mlp_rk.cuh block_sum), then a second, small launch that adds the block
// sums in block order (mlp_rk.cuh quadrature_reduce_kernel).
// ops/cuda_perlane.py:mlp_perlane_adjoint_solve_plain repeats that order.
//
// Bound on the H100. As K9's: per stage each thread walks its sample's MLP
// forward and VJP (about 1500 operations at the spiral) and writes its n_w
// weighted quadrature terms (252 at the spiral) to the workspace, one
// dependent chain a sample, 128 warps at B = 4096: bound by the latency of
// that chain and of the workspace accesses, not by the card's arithmetic or
// bandwidth. A warp's samples also diverge: it runs until its slowest
// sample is done with each interval.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth or weights past shared memory, the per-thread vectors of 512
// values in local memory and the weights read from global memory (L2).
#include "rk_adjoint.cuh"

namespace tfd {

// Workspace values the sweep needs; ops/cuda_perlane.py:_adjoint_work_size
// allocates the same count.
inline long perlane_adjoint_work_size(const Net& net, int n_w, int S, int B,
                                      int D) {
  return lane_adjoint_work_size(S, B, D, n_w + net.time_input) +
         aug_rows_count(net) * B;
}

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
      threads < 32 || threads > 1024 || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int n_w = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (n_w < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  if (work_size < perlane_adjoint_work_size(net, n_w, stages, B, D))
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
  const bool narrow = route == kRouteNarrow;
  const size_t smem = sizeof(T) * ((narrow ? size_t(n_w) : 0) + threads);
  cudaError_t e =
      narrow ? launch_rk_perlane_adjoint<T>(
                   tau, ys, g, dt0, ay0, aw, at, nullptr, lane_stats, stats,
                   partial, work,
                   make_mlp_lane_aug<T, kRouteNarrow>(weights, n_w, net),
                   smem, threads, tab, sc, st)
             : launch_rk_perlane_adjoint<T>(
                   tau, ys, g, dt0, ay0, aw, at, nullptr, lane_stats, stats,
                   partial, work,
                   make_mlp_lane_aug<T, kRouteWide>(weights, n_w, net), smem,
                   threads, tab, sc, st);
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
