// K8: a whole fixed-grid explicit-RK solve (euler, midpoint, rk4, rk4_38)
// of an MLP neural ODE in one launch.
//
// The engine is csrc/rk_fixed.cuh, a template on its right-hand side;
// this file instantiates it with the MLP routes below
// (csrc/plan_rhs.cuh does with K14's generated plans).
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:102
// (_make_fixed_solve_kernel with _fixed_stage_walk :59 and _hermite_drain
// :76; launched by fixed_solve_call :178 from mlp_solve_fixed :250). Per
// grid interval: the stages of the tableau from the chained derivative
// f(t0, y0), the Kahan-compensated state update, the end derivative
// f(t1, y1) (the next step's first stage and the interval's Hermite end
// slope, so a step costs `stages` evaluations and the solve
// 1 + stages (G - 1)), and the cubic-Hermite drain of every requested time
// the interval covers through an output cursor, the last interval flushing
// the times that roundoff left past the grid's end. Invalid times give
// status 3 and a zero tail. The tableau comes in as launch arguments, so
// one binary serves the four methods. Output is written straight into the
// batch-major [T, B, D] layout.
//
// Design. A fixed grid has no error norm and no controller, so no sample
// ever waits for another, and every sample takes the same stages on the
// same grid. On the narrow and wide routes a group of threads owns one
// sample for the whole solve (csrc/rk_fixed.cuh rk_fixed_group_kernel;
// csrc/lane_group.h): 16 threads a sample on the narrow route, 32 samples
// a 512-thread block (128 blocks of 16 warps at B = 4096, where 64 blocks
// of 2 warps ran with a thread a sample), and on the wide route a group as
// wide as ops/cuda_fixed.py FIXED_WIDE_GROUP. The members split the stage
// states, the Kahan update and the Hermite drain a feature a member, and
// each layer of an evaluation an output a member (mlp_rk.cuh
// mlp_eval_lanes), each output the same sum in input order as the plain
// version's, so the same bits; a group meets only its own members, after
// each layer. The weights sit transposed (a layer's weight (o, i) at
// i dout + o, so that the members of a warp read neighbouring values): in
// shared memory on the narrow route, in the workspace on the wide route
// (a first, small launch writes them). The grid, the output times and the
// block's sample slots (state, compensation, chained derivative,
// step-start state, stages, the walk's two layer vectors) sit in shared
// memory where they fit, the slots else in the workspace.
//
// Bound on the H100. A group's evaluation is a chain of one layer's
// longest sum a member (at the bench widths 2 -> 50 -> 2 the output layer's
// 50 terms on 2 of the 16 members) and a group barrier a layer; the
// narrow solve is bound by that chain's latency over the 2001 evaluations,
// 16 warps an SM hiding each other's. The wide route (128 -> 256 -> 256
// -> 128) does 131,072 multiply-adds a sample and evaluation: its weights
// (512 KB in float32) stream from L2 to every group, so it is bound by
// the L1/L2 traffic of those reads, coalesced across a warp's members.
//
// Routes (mlp_rk.cuh Route): narrow and wide as above; batch
// (csrc/dot_tiers.cuh, the dot-precision tiers), where a block of
// kFixedBatchThreads threads owns kFixedSamples samples (one a thread of
// its first warps, csrc/rk_fixed.cuh rk_fixed_kernel) and every
// evaluation of a step is block-wide, layer by layer, the tier layers on
// the tensor cores in float32 with all the block's warps. All samples
// share one grid, so the blocks stay independent.
#include "dot_tiers.cuh"
#include "rk_fixed.cuh"

namespace tfd {

// The batch route's block: threads, and samples (a multiple of 16: one
// 16-row tile of K4 a block, so that the batch spreads over 4x the SMs of
// 64-row blocks; ops/cuda_fixed.py pads the rows to FIXED_THREADS, a
// multiple of it).
constexpr int kFixedBatchThreads = 256;
constexpr int kFixedSamples = 16;

// K8's batch route (csrc/rk_fixed.cuh's batch-wide Rhs): batch_mlp_eval,
// K4's tiers, where a block of kFixedBatchThreads threads owns
// kFixedSamples samples.
template <typename T>
struct MlpBatchRhs {
  static constexpr bool kBatch = true;
  const T* wg;     // packed weights (pack_mlp_weights), in global memory
  Net net_in;
  BatchBufs<T> bb;

  struct Shared {
    Net net;
  };
  struct Local {};

  __device__ int spb() const { return kFixedSamples; }
  __device__ T* setup(Shared& sh, Local&, unsigned char*, int row0,
                      int spb) const {
    if (threadIdx.x == 0) sh.net = net_in;
    batch_clear(bb, row0, spb);
    return nullptr;   // K4's tiles take the shared memory; grid in global
  }
  template <class G>
  __device__ void put(const Shared& sh, Local&, int b, T t, G get) const {
    batch_put(bb, sh.net, b, t, get);
  }
  __device__ const T* eval_batch(const Shared& sh, Local&, int row0,
                                 int spb) const {
    return batch_mlp_eval(sh.net, wg, bb, row0, spb);
  }
  __device__ long ld() const { return bb.ld; }
};

// The narrow and wide routes: a group of `group` threads a sample
// (csrc/rk_fixed.cuh rk_fixed_group_kernel, mlp_rk.cuh MlpLaneRhs), the
// wide route's transposed weights written to the end of the workspace
// first.
template <typename T, int kRoute>
cudaError_t launch_fixed_lanes(const void* grid, const void* tau,
                               const void* y0, const void* f0,
                               const void* weights, void* out, void* stats,
                               void* work, long work_size, int n_w,
                               int group, const Net& net,
                               const Tableau<T>& tab,
                               const FixedScalars<T>& sc,
                               cudaStream_t stream) {
  const long slots =
      group_solve_work_size(fixed_solve_slot_values(tab.S, sc.D,
                                                    net_max_width(net)),
                            sc.B, group, 0);
  const auto rhs = make_mlp_lane_rhs<T, kRoute>(
      weights, static_cast<T*>(work) + slots, n_w, net);
  cudaError_t e = launch_lane_weights(rhs, stream);
  if (e != cudaSuccess) return e;
  return launch_rk_fixed_group<T>(grid, tau, y0, f0, out, stats, work,
                                  work_size, rhs, group, tab, sc, stream);
}

template <typename T>
int launch_solve_fixed(const void* grid, const void* tau, const void* y0,
                       const void* f0, const void* weights, void* out,
                       void* stats, void* work, long work_size, int G,
                       int T_out, int B, int D, int threads, int group,
                       double sign, int valid, int n_layers, const int* dims,
                       int act_hidden, int act_final, int input_power,
                       int time_input, int stages, const double* c,
                       const double* a, const double* b_sol, int route,
                       const int* tiers, void* batch_work, long batch_bytes,
                       void* stream) {
  if (stages < 1 || stages > kMaxStages || G < 1 || T_out < 1 || B < 1 ||
      D < 1 || D + time_input > kMaxWidth || input_power < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (off < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long n_w16 = set_tiers(net, tiers);
  if (n_w16 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long rows = long((B + kFixedSamples - 1) / kFixedSamples) *
                    kFixedSamples;
  BatchBufs<T> bb{};
  if (route == kRouteBatch) {
    if (threads != kFixedBatchThreads || !batch_work ||
        batch_bytes < batch_work_bytes(net, n_w16, rows, sizeof(T)))
      return static_cast<int>(cudaErrorInvalidValue);
    bb = batch_bufs<T>(batch_work, net, n_w16, rows,
                       kFixedBatchThreads / kWarpSize, kFixedSamples);
    if (bb.tile.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  } else if (!route_fits(net, route) || tiers || threads != kGroupBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Fixed tableaus have no error weights: b_sol stands in for b_err.
  const Tableau<T> tab =
      make_tableau<T>(stages, 0, 0, c, a, b_sol, b_sol, nullptr);
  FixedScalars<T> sc{};
  sc.sign = T(sign);
  sc.valid = valid;
  sc.G = G;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kRouteNarrow) {
    e = launch_fixed_lanes<T, kRouteNarrow>(grid, tau, y0, f0, weights, out,
                                            stats, work, work_size, off,
                                            group, net, tab, sc, st);
  } else if (route == kRouteWide) {
    e = launch_fixed_lanes<T, kRouteWide>(grid, tau, y0, f0, weights, out,
                                          stats, work, work_size, off, group,
                                          net, tab, sc, st);
  } else {
    if (work_size < long(stages + 3) * B * D)
      return static_cast<int>(cudaErrorInvalidValue);
    tier_pack_kernel<T><<<64, 256, 0, st>>>(
        static_cast<const T*>(weights), net,
        reinterpret_cast<__nv_bfloat16*>(batch_work));
    e = cudaGetLastError();
    if (e == cudaSuccess) {
      MlpBatchRhs<T> rhs;
      rhs.wg = static_cast<const T*>(weights);
      rhs.net_in = net;
      rhs.bb = bb;
      e = launch_rk_fixed<T>(grid, tau, y0, f0, out, stats, work, rhs,
                             batch_smem(bb), threads, kFixedSamples, tab, sc,
                             st);
    }
  }
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_FIXED_ENTRY(NAME, TYPE)                                    \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, const void* f0,    \
      const void* weights, void* out, void* stats, void* work,              \
      long work_size, int G, int T_out, int B, int D, int threads,          \
      int group, double sign, int valid, int n_layers, const int* dims,     \
      int act_hidden, int act_final, int input_power, int time_input,       \
      int stages, const double* c, const double* a, const double* b_sol,    \
      int route, const int* tiers, void* batch_work, long batch_bytes,      \
      void* stream) {                                                        \
    return tfd::launch_solve_fixed<TYPE>(                                    \
        grid, tau, y0, f0, weights, out, stats, work, work_size, G, T_out,  \
        B, D, threads, group, sign, valid, n_layers, dims, act_hidden,      \
        act_final, input_power, time_input, stages, c, a, b_sol, route,     \
        tiers, batch_work, batch_bytes, stream);                             \
  }

TFD_SOLVE_FIXED_ENTRY(tfd_mlp_solve_fixed_f32, float)
TFD_SOLVE_FIXED_ENTRY(tfd_mlp_solve_fixed_f64, double)
