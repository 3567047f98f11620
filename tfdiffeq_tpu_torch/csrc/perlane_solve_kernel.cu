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
// Design. No sample ever reads another's state. On the MLP routes a group
// of threads owns one sample for the whole solve (csrc/rk_perlane.cuh
// rk_perlane_group_kernel; csrc/lane_group.h): 16 threads a sample on the
// narrow route, 32 samples a 512-thread block (128 blocks of 16 warps at
// B = 4096, where a warp of 32 samples ran a block), and on the wide route
// K8's wide group (ops/cuda_fixed.py FIXED_WIDE_GROUP). Each group
// keeps its own controller and meets only its own members (a __syncwarp
// over its lanes, a named barrier past a warp), so groups diverge freely;
// a group stops when its sample is done and drains through its own
// cursor. Where the TPU kernel steps every lane in lockstep (done or
// rejected lanes do masked work) and drains rows through a global cursor,
// every row is still written once, from the same interpolant. The members
// split the stages, the combines and the drain a feature a member, and
// each layer of an evaluation an output a member (mlp_rk.cuh
// mlp_eval_lanes, the weights transposed: in shared memory on the narrow
// route, in the workspace on the wide one); the error norm is every
// member's sum of the slot's squared errors in feature order, the plain
// version's. The output times and the block's sample slots sit in shared
// memory where they fit, the slots else in the workspace.
//
// Bound on the H100. A group's evaluation is a chain of one layer's
// longest sum a member (the spiral's output layer: 50 terms) and a group
// meeting a layer; the solve is bound by that chain over the slowest
// sample's attempts in each pair of a warp, with 16 warps an SM hiding
// each other's latencies. The wide route streams its weights from L2 to
// every group, as K8's does.
//
// Routes (mlp_rk.cuh Route): narrow; wide, for layers up to kMaxWidth or
// weights past shared memory, the weights read from global memory (L2).
// K14's plans take the same group engine with the generated group walk
// (csrc/plan_rhs.cuh PlanLaneRhs).
#include "dot_tiers.cuh"
#include "rk_perlane.cuh"

namespace tfd {

// K5's tile route for K4's tiers (csrc/rk_perlane.cuh rk_perlane_tile_kernel):
// the block's kTileRows samples' stage inputs in K4's layer-0 rows, one
// batch-wide evaluation of the tile (batch_mlp_eval: the tier layers on the
// tensor cores in float32, every layer on the CUDA cores in float64).
template <typename T>
struct MlpTileRhs {
  const T* wg;     // packed weights (pack_mlp_weights), in global memory
  Net net_in;
  BatchBufs<T> bb;

  struct Shared {
    Net net;
  };
  struct Local {};

  __device__ void setup(Shared& sh, Local&, unsigned char*, int row0,
                        int nr) const {
    if (threadIdx.x == 0) sh.net = net_in;
    batch_clear(bb, row0, nr);
  }
  // Input d of sample b: y ** p, and with d = 0 the time column.
  __device__ void put_elem(const Shared& sh, Local&, int b, int d, T t,
                           T v) const {
    T h = v;
    for (int p = 1; p < sh.net.input_power; ++p) h = h * v;
    bb.X0[long(d) * bb.rows + b] = h;
    if (sh.net.time_input && d == 0)
      bb.X0[long(sh.net.din[0] - 1) * bb.rows + b] = t;
  }
  __device__ const T* eval_batch(const Shared& sh, Local&, int row0,
                                 int nr) const {
    return batch_mlp_eval(sh.net, wg, bb, row0, nr);
  }
  __device__ long ld() const { return bb.ld; }
};

// K5's MLP right-hand sides: the narrow and wide routes with a group of
// `group` threads a sample (mlp_rk.cuh MlpLaneRhs), the wide route's
// transposed weights written to the end of the workspace first.
template <typename T, int kRoute>
cudaError_t launch_perlane_lanes(const void* tau, const void* y0,
                                 const void* f0, const void* dt0,
                                 const void* weights, void* out,
                                 void* lane_stats, void* stats, void* work,
                                 long work_size, int n_w, int group,
                                 const Net& net, const Tableau<T>& tab,
                                 const PerlaneScalars<T>& sc,
                                 cudaStream_t stream) {
  const long slots =
      group_solve_work_size(perlane_solve_slot_values(tab.S, sc.D,
                                                      net_max_width(net)),
                            sc.B, group, 0);
  const auto rhs = make_mlp_lane_rhs<T, kRoute>(
      weights, static_cast<T*>(work) + slots, n_w, net);
  cudaError_t e = launch_lane_weights(rhs, stream);
  if (e != cudaSuccess) return e;
  return launch_rk_perlane_group<T>(tau, y0, f0, dt0, out, lane_stats,
                                    stats, work, work_size, rhs, group, tab,
                                    sc, stream);
}

// The tile route: the bf16 weight pack (K4), then the tile engine, a
// kTileRows-row tile of K4 a block of kTileThreads threads.
template <typename T>
cudaError_t launch_perlane_tile(const void* tau, const void* y0,
                                const void* f0, const void* dt0,
                                const void* weights, void* out,
                                void* lane_stats, void* stats, void* work,
                                long work_size, Net net, const int* tiers,
                                void* batch_work, long batch_bytes,
                                const Tableau<T>& tab,
                                const PerlaneScalars<T>& sc,
                                cudaStream_t stream) {
  const long n_w16 = set_tiers(net, tiers);
  const long rows = (sc.B + kTileRows - 1) / kTileRows * kTileRows;
  if (n_w16 < 0 || !batch_work ||
      batch_bytes < batch_work_bytes(net, n_w16, rows, sizeof(T)))
    return cudaErrorInvalidValue;
  MlpTileRhs<T> rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.net_in = net;
  rhs.bb = batch_bufs<T>(batch_work, net, n_w16, rows,
                         kTileThreads / kWarpSize, kTileRows);
  if (rhs.bb.tile.bytes < 0) return cudaErrorInvalidValue;
  tier_pack_kernel<T><<<64, 256, 0, stream>>>(
      static_cast<const T*>(weights), net,
      reinterpret_cast<__nv_bfloat16*>(batch_work));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_rk_perlane_tile<T>(tau, y0, f0, dt0, out, lane_stats, stats,
                                   work, work_size, rhs, batch_smem(rhs.bb),
                                   tab, sc, stream);
}

template <typename T>
int launch_solve_perlane(const void* tau, const void* y0, const void* f0,
                         const void* dt0, const void* weights, void* out,
                         void* lane_stats, void* stats, void* work,
                         long work_size, int T_out, int B, int D,
                         int threads, int group, double rtol, double atol,
                         double dt_min, double sign, double safety,
                         double ifactor, double dfactor, int max_steps,
                         int valid, int n_layers, const int* dims,
                         int act_hidden, int act_final, int input_power,
                         int time_input, int stages, int order, int fsal,
                         const double* c, const double* a,
                         const double* b_sol, const double* b_err,
                         const double* c_mid, int route, const int* tiers,
                         void* batch_work, long batch_bytes, void* stream) {
  const bool tile = route == kRouteBatch;
  if (stages < 2 || stages > kMaxStages || T_out < 1 || B < 1 || D < 1 ||
      D + time_input > kMaxWidth || input_power < 1 || max_steps < 1 ||
      threads != (tile ? kTileThreads : kGroupBlock) || (tiers && !tile))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (off < 0 || (!tile && !route_fits(net, route)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tableau<T> tab =
      make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);
  const PerlaneScalars<T> sc = make_perlane_scalars<T>(
      rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps, valid,
      T_out, B, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile)
    return static_cast<int>(launch_perlane_tile<T>(
        tau, y0, f0, dt0, weights, out, lane_stats, stats, work, work_size,
        net, tiers, batch_work, batch_bytes, tab, sc, st));
  const cudaError_t e =
      route == kRouteNarrow
          ? launch_perlane_lanes<T, kRouteNarrow>(
                tau, y0, f0, dt0, weights, out, lane_stats, stats, work,
                work_size, off, group, net, tab, sc, st)
          : launch_perlane_lanes<T, kRouteWide>(
                tau, y0, f0, dt0, weights, out, lane_stats, stats, work,
                work_size, off, group, net, tab, sc, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_PERLANE_ENTRY(NAME, TYPE)                                  \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* dt0,     \
      const void* weights, void* out, void* lane_stats, void* stats,        \
      void* work, long work_size, int T_out, int B, int D, int threads,     \
      int group, double rtol, double atol, double dt_min, double sign,      \
      double safety, double ifactor, double dfactor, int max_steps,         \
      int valid, int n_layers, const int* dims, int act_hidden,             \
      int act_final, int input_power, int time_input, int stages,           \
      int order, int fsal, const double* c, const double* a,                \
      const double* b_sol, const double* b_err, const double* c_mid,        \
      int route, const int* tiers, void* batch_work, long batch_bytes,      \
      void* stream) {                                                        \
    return tfd::launch_solve_perlane<TYPE>(                                  \
        tau, y0, f0, dt0, weights, out, lane_stats, stats, work, work_size, \
        T_out, B, D, threads, group, rtol, atol, dt_min, sign, safety,      \
        ifactor, dfactor, max_steps, valid, n_layers, dims, act_hidden,     \
        act_final, input_power, time_input, stages, order, fsal, c, a,      \
        b_sol, b_err, c_mid, route, tiers, batch_work, batch_bytes, stream); \
  }

TFD_SOLVE_PERLANE_ENTRY(tfd_mlp_solve_perlane_f32, float)
TFD_SOLVE_PERLANE_ENTRY(tfd_mlp_solve_perlane_f64, double)
