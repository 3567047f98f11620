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
// ever waits for another: one thread owns one sample for the whole solve,
// over as many blocks as the batch needs (64 blocks of 64 threads at
// B = 4096), with no barrier after the prologue. All samples share one
// grid, so the output cursor is the same in every thread. The weights, the
// grid and the output times sit in shared memory (K2's packed layout); the
// sample's state, compensation, derivatives and stages live in a device
// workspace laid out feature-major ([row][B]: a warp's 32 threads touch 32
// consecutive values); the MLP's layer vectors in per-thread local memory
// (mlp_rk.cuh mlp_eval).
//
// Bound on the H100. Each thread walks its sample's MLP evaluations (at the
// bench widths 2 -> 50 -> 2: about 400 flops and 50 tanh each, 4 a step)
// one dependent instruction after another, so the solve is bound by the
// latency of that chain and by instruction issue: at B = 4096 there are
// only 128 warps, one or two to an SM, which cannot hide each other's
// latencies. Wider batches fill the card; narrower ones leave it idle.
// Working on several samples a thread, or splitting one sample's hidden
// units across a warp, is the way to more throughput.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth, the layer vectors of 512 values in local memory and the
// weights read from global memory; batch (csrc/dot_tiers.cuh, the
// dot-precision tiers), where a block of kFixedBatchThreads threads owns
// kFixedSamples samples (one a thread of its first warps) and every
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

// K8's MLP right-hand sides (csrc/rk_fixed.cuh's Rhs): the per-thread
// narrow and wide routes (mlp_eval) and the batch route (batch_mlp_eval,
// K4's tiers), where a block of kFixedBatchThreads threads owns
// kFixedSamples samples.
template <typename T, int kRoute>
struct MlpFixedRhs {
  static constexpr bool kBatch = kRoute == kRouteBatch;
  const T* wg;     // packed weights (pack_mlp_weights)
  int n_weights;
  Net net_in;
  BatchBufs<T> bb;

  struct Shared {
    Net net;
  };
  // The layer vectors. The weights' pointer stays out of this struct: a
  // store through h_a or h_b could alias it and force a reload each time.
  struct Local {
    T h_a[vec_width<kRoute>()], h_b[vec_width<kRoute>()];
  };

  // The packed weights: in shared memory on the narrow route (setup copies
  // them there), else in global memory.
  __device__ __forceinline__ const T* weights() const {
    if constexpr (kRoute == kRouteNarrow) {
      extern __shared__ __align__(16) unsigned char smem_raw[];
      return reinterpret_cast<const T*>(smem_raw);
    } else {
      return wg;
    }
  }

  __device__ int spb() const { return kFixedSamples; }
  __device__ T* setup(Shared& sh, Local&, unsigned char* smem, int row0,
                      int spb) const {
    const int tid = threadIdx.x;
    T* rest;
    if constexpr (kRoute == kRouteNarrow) {
      T* ws = reinterpret_cast<T*>(smem);
      for (int i = tid; i < n_weights; i += blockDim.x) ws[i] = wg[i];
      rest = ws + n_weights;
    } else if constexpr (kRoute == kRouteBatch) {
      rest = nullptr;   // K4's tiles take the shared memory; grid in global
    } else {
      rest = reinterpret_cast<T*>(smem);
    }
    if (tid == 0) sh.net = net_in;
    if constexpr (kRoute == kRouteBatch) batch_clear(bb, row0, spb);
    return rest;
  }

  __device__ T* in(Local& lo) const { return lo.h_a; }
  __device__ const T* eval(const Shared& sh, Local& lo, T t, int, int) const {
    return mlp_eval(sh.net, weights(), t, lo.h_a, lo.h_b);
  }

  template <class G>
  __device__ void put(const Shared& sh, Local&, int b, T t, G get) const {
    batch_put(bb, sh.net, b, t, get);
  }
  __device__ const T* eval_batch(const Shared& sh, Local& lo, int row0,
                                 int spb) const {
    return batch_mlp_eval(sh.net, weights(), bb, row0, spb);
  }
  __device__ long ld() const { return bb.ld; }
};

template <typename T, int kRoute>
cudaError_t launch_fixed_route(const void* grid, const void* tau,
                               const void* y0, const void* f0,
                               const void* weights, void* out, void* stats,
                               void* work, const BatchBufs<T>& bb, int n_w,
                               int threads, const Net& net,
                               const Tableau<T>& tab,
                               const FixedScalars<T>& sc,
                               cudaStream_t stream) {
  const size_t smem =
      kRoute == kRouteBatch
          ? batch_smem(bb)
          : sizeof(T) * ((kRoute == kRouteNarrow ? size_t(n_w) : 0) + sc.G +
                         sc.T_out);
  MlpFixedRhs<T, kRoute> rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.n_weights = n_w;
  rhs.net_in = net;
  rhs.bb = bb;
  const int spb = kRoute == kRouteBatch ? kFixedSamples : threads;
  return launch_rk_fixed<T>(grid, tau, y0, f0, out, stats, work, rhs, smem,
                            threads, spb, tab, sc, stream);
}

template <typename T>
int launch_solve_fixed(const void* grid, const void* tau, const void* y0,
                       const void* f0, const void* weights, void* out,
                       void* stats, void* work, int G, int T_out, int B,
                       int D, int threads, double sign, int valid,
                       int n_layers, const int* dims, int act_hidden,
                       int act_final, int input_power, int time_input,
                       int stages, const double* c, const double* a,
                       const double* b_sol, int route, const int* tiers,
                       void* batch_work, long batch_bytes, void* stream) {
  if (stages < 1 || stages > kMaxStages || G < 1 || T_out < 1 || B < 1 ||
      D < 1 || D + time_input > kMaxWidth || input_power < 1 ||
      threads < 32 || threads > 1024)
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
  } else if (!route_fits(net, route) || tiers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Fixed tableaus have no error weights: b_sol stands in for b_err.
  const Tableau<T> tab =
      make_tableau<T>(stages, 0, 0, c, a, b_sol, b_sol, nullptr);
  FixedScalars<T> sc;
  sc.sign = T(sign);
  sc.valid = valid;
  sc.G = G;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == kRouteNarrow) {
    e = launch_fixed_route<T, kRouteNarrow>(grid, tau, y0, f0, weights, out,
                                            stats, work, bb, off, threads,
                                            net, tab, sc, st);
  } else if (route == kRouteWide) {
    e = launch_fixed_route<T, kRouteWide>(grid, tau, y0, f0, weights, out,
                                          stats, work, bb, off, threads, net,
                                          tab, sc, st);
  } else {
    tier_pack_kernel<T><<<64, 256, 0, st>>>(
        static_cast<const T*>(weights), net,
        reinterpret_cast<__nv_bfloat16*>(batch_work));
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = launch_fixed_route<T, kRouteBatch>(grid, tau, y0, f0, weights, out,
                                             stats, work, bb, off, threads,
                                             net, tab, sc, st);
  }
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_FIXED_ENTRY(NAME, TYPE)                                    \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, const void* f0,    \
      const void* weights, void* out, void* stats, void* work, int G,       \
      int T_out, int B, int D, int threads, double sign, int valid,         \
      int n_layers, const int* dims, int act_hidden, int act_final,         \
      int input_power, int time_input, int stages, const double* c,         \
      const double* a, const double* b_sol, int route, const int* tiers,    \
      void* batch_work, long batch_bytes, void* stream) {                   \
    return tfd::launch_solve_fixed<TYPE>(                                    \
        grid, tau, y0, f0, weights, out, stats, work, G, T_out, B, D,       \
        threads, sign, valid, n_layers, dims, act_hidden, act_final,        \
        input_power, time_input, stages, c, a, b_sol, route, tiers,         \
        batch_work, batch_bytes, stream);                                    \
  }

TFD_SOLVE_FIXED_ENTRY(tfd_mlp_solve_fixed_f32, float)
TFD_SOLVE_FIXED_ENTRY(tfd_mlp_solve_fixed_f64, double)
