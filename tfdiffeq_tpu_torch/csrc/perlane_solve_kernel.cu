// K5: a whole adaptive explicit-RK solve of an MLP neural ODE in one
// launch, every sample under its own step controller.
//
// The engine is csrc/rk_perlane.cuh, a template on its right-hand side;
// this file instantiates it with the MLP routes below
// (csrc/plan_rhs.cuh does with K14's generated plans).
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
#include "rk_perlane.cuh"

namespace tfd {

// K5's MLP right-hand sides (csrc/rk_perlane.cuh's Rhs): the narrow and
// wide per-thread routes, mlp_rk.cuh MlpThreadRhs.
template <typename T, int kRoute>
cudaError_t launch_perlane_route(const void* tau, const void* y0,
                                 const void* f0, const void* dt0,
                                 const void* weights, void* out,
                                 void* lane_stats, void* stats, void* work,
                                 int n_w, int threads, const Net& net,
                                 const Tableau<T>& tab,
                                 const PerlaneScalars<T>& sc,
                                 cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * ((kRoute == kRouteNarrow ? size_t(n_w) : 0) + sc.T_out);
  MlpThreadRhs<T, kRoute> rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.n_weights = n_w;
  rhs.net_in = net;
  return launch_rk_perlane<T>(tau, y0, f0, dt0, out, lane_stats, stats, work,
                              rhs, smem, threads, tab, sc, stream);
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
  const PerlaneScalars<T> sc = make_perlane_scalars<T>(
      rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps, valid,
      T_out, B, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      route == kRouteNarrow
          ? launch_perlane_route<T, kRouteNarrow>(tau, y0, f0, dt0, weights,
                                                  out, lane_stats, stats,
                                                  work, off, threads, net,
                                                  tab, sc, st)
          : launch_perlane_route<T, kRouteWide>(tau, y0, f0, dt0, weights,
                                                out, lane_stats, stats, work,
                                                off, threads, net, tab, sc,
                                                st);
  return static_cast<int>(e);
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
