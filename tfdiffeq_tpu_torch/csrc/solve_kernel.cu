// K2: a whole adaptive explicit-RK solve of an MLP neural ODE in one
// launch, under one step controller shared by the batch.
//
// The engine is csrc/rk_solve.cuh, a template on its right-hand side;
// this file instantiates it with the MLP routes below
// (csrc/plan_rhs.cuh does with K14's generated plans).
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_kernels.py:726
// (_make_solve_kernel with _rk_stages :522, _interp_coeffs :558,
// _controller_factor :577 and the RHS _make_net :374; launched by
// whole_solve_call :1321 from mlp_solve :1228). Per attempt: the stages of
// the tableau, the masked RMS error over the whole batch, the clamped
// I-controller, Kahan accumulation of the state, the dense-output drain of
// every requested time the accepted step covers, the counters and the
// status; zero fill of the output on early exit. The tableau comes in as
// launch arguments, so one binary serves dopri5, bosh3, adaptive_heun,
// tsit5 and dopri8. Output is written straight into the batch-major
// [T, B, D] layout (the TPU kernel's feature-major [D, B] put the batch on
// its vector lanes and is not copied).
//
// Design. Every attempt's accept needs the error sum over the whole batch
// (pallas_kernels.py:823-832), so the threads that hold the batch must meet
// once per attempt. The simple, right design of this first version is ONE
// thread block for the whole solve: each thread owns the samples b = tid,
// tid + blockDim.x, ... through the whole solve and walks their stages one
// sample at a time; the stage derivatives, the state, the FSAL derivative
// and the Kahan term of the batch live in device scratch (`work`,
// [(S + 5) B D] values: 256 KB at the main path, L2-resident); the
// weights and the tableau sit in shared memory. One fixed-order block
// reduction per attempt gives the error sum (the same bits on every run),
// __syncthreads_or the finiteness flag, and every thread then takes the
// same accept and controller decision from them.
//
// Routes (mlp_rk.cuh Route). Narrow: the layer vectors of 128 values in
// each thread, the weights in shared memory (the main path). Wide: layers
// up to kMaxWidth, vectors of 512 values in local memory, the weights read
// from global memory (131,712 float32 weights, 527 KB, at the wide MLP
// 128 -> 256 -> 256 -> 128: L2-resident, a warp-uniform read per product).
// Batch (csrc/dot_tiers.cuh, the dot-precision tiers): every stage
// evaluation of the attempt is batch-wide, layer by layer, the tier layers
// on the tensor cores in float32; the controller is the same.
//
// rhs = cnf (K7's forward, csrc/cnf_net.cuh cnf_eval, replacing
// pallas_kernels.py:442 _make_cnf_net at :1291-1294): the state is the CNF
// state [z; logp] of D + 1 values, the network the concat-t flow, and each
// per-thread evaluation is the flow plus its exact divergence; a sample's
// act'(z) and f go to workspace rows after the solve's own. Narrow and wide
// routes only (the flow takes no tier).
//
// Bound on the H100. One SM of 132 does all the work: per sample and
// attempt, S - 1 evaluations of the MLP (at the main path 2 -> 50 -> 2:
// about 400 flops and 50 tanh each) run one instruction stream per
// thread, so the solve is bound by the instruction throughput of a single
// SM, and the other 131 idle. Spreading the batch over the card (one block
// per SM and a grid-wide barrier per attempt) is the first optimisation to
// make (see PERF.md). The wide route is bound the same way, with a
// global-memory load beside each multiply-add.
#include "cnf_net.cuh"
#include "dot_tiers.cuh"
#include "rk_solve.cuh"

namespace tfd {

// K2's MLP right-hand sides (csrc/rk_solve.cuh's Rhs): the per-thread
// narrow and wide routes (mlp_eval, or K7's cnf_eval with rhs = cnf, its
// rows of B in the workspace after the solve's own) and the batch route
// (batch_mlp_eval, K4's tiers).
template <typename T, int kRoute, bool kCnf>
struct MlpSolveRhs {
  static constexpr bool kBatch = kRoute == kRouteBatch;
  const T* wg;     // packed weights (pack_mlp_weights)
  int n_weights;
  Net net_in;
  BatchBufs<T> bb;
  int rows;        // the batch route's sample rows (B padded to 16)

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

  __device__ T* setup(Shared& sh, Local&, unsigned char* smem) const {
    const int tid = threadIdx.x, nth = blockDim.x;
    T* red;
    if constexpr (kRoute == kRouteNarrow) {
      T* ws = reinterpret_cast<T*>(smem);
      for (int i = tid; i < n_weights; i += nth) ws[i] = wg[i];
      red = ws + n_weights;
    } else if constexpr (kRoute == kRouteBatch) {
      red = reinterpret_cast<T*>(smem + batch_smem(bb));   // K4's tiles first
    } else {
      red = reinterpret_cast<T*>(smem);
    }
    if (tid == 0) sh.net = net_in;
    if constexpr (kRoute == kRouteBatch)
      batch_clear(bb, 0, rows);
    return red;
  }

  __device__ T* in(Local& lo) const { return lo.h_a; }
  __device__ const T* eval(const Shared& sh, Local& lo, T t, int b, int B,
                           T* rw) const {
    if constexpr (kCnf)
      return cnf_eval(sh.net, weights(), t, lo.h_a, lo.h_b, rw, B, b);
    else
      return mlp_eval(sh.net, weights(), t, lo.h_a, lo.h_b);
  }

  template <class G>
  __device__ void put(const Shared& sh, Local&, int b, T t, G get, T*,
                      int) const {
    batch_put(bb, sh.net, b, t, get);
  }
  __device__ const T* eval_batch(const Shared& sh, Local& lo, T*, T*,
                                 int) const {
    return batch_mlp_eval(sh.net, weights(), bb, 0, rows);
  }
  __device__ long ld(const Local&) const { return bb.ld; }
};

template <typename T, int kRoute, bool kCnf>
cudaError_t launch_route(const void* tau, const void* y0, const void* f0,
                         const void* weights, void* out, void* stats,
                         void* work, const BatchBufs<T>& bb, int n_w,
                         int threads, const Net& net, const Tableau<T>& tab,
                         const Scalars<T>& sc, cudaStream_t stream) {
  const size_t smem =
      sizeof(T) * ((kRoute == kRouteNarrow ? size_t(n_w) : 0) + threads) +
      (kRoute == kRouteBatch ? batch_smem(bb) : 0);
  MlpSolveRhs<T, kRoute, kCnf> rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.n_weights = n_w;
  rhs.net_in = net;
  rhs.bb = bb;
  rhs.rows = (sc.B + 15) / 16 * 16;
  return launch_rk_solve<T>(tau, y0, f0, out, stats, work, rhs, smem,
                            threads, tab, sc, stream);
}

template <typename T>
int launch_solve(const void* tau, const void* y0, const void* f0,
                 const void* weights, void* out, void* stats, void* work,
                 int T_out, int B, int D, int threads, double dt0,
                 double rtol, double atol,
                 double dt_min, double sign, double safety, double ifactor,
                 double dfactor, int max_steps, int valid, int n_layers,
                 const int* dims, int act_hidden, int act_final,
                 int input_power, int time_input, int stages, int order,
                 int fsal, const double* c, const double* a,
                 const double* b_sol, const double* b_err,
                 const double* c_mid, int route, const int* tiers,
                 void* batch_work, long batch_bytes, int cnf, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || stages < 2 ||
      stages > kMaxStages || T_out < 1 || B < 1 || D < 1 ||
      D + time_input > kMaxWidth || input_power < 1 || threads < 32 ||
      threads > kSolveThreads || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The CNF flow maps the D - 1 features of z and the time to D - 1.
  if (cnf && (D < 2 || !time_input || input_power != 1 || tiers ||
              route == kRouteBatch))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int off = make_net(net, n_layers, dims, cnf ? D - 1 : D, act_hidden,
                           act_final, input_power, time_input);
  if (off < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long n_w16 = set_tiers(net, tiers);
  if (n_w16 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long rows = (B + 15) / 16 * 16;
  BatchBufs<T> bb{};
  if (route == kRouteBatch) {
    if (!batch_work ||
        batch_bytes < batch_work_bytes(net, n_w16, rows, sizeof(T)))
      return static_cast<int>(cudaErrorInvalidValue);
    bb = batch_bufs<T>(batch_work, net, n_w16, rows, threads / kWarpSize,
                       rows);
    if (bb.tile.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  } else if (!route_fits(net, route) || tiers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const Tableau<T> tab =
      make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);

  const Scalars<T> sc =
      make_scalars<T>(dt0, rtol, atol, dt_min, sign, safety, ifactor,
                      dfactor, max_steps, valid, T_out, B, D);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cnf) {
    e = route == kRouteNarrow
            ? launch_route<T, kRouteNarrow, true>(tau, y0, f0, weights, out,
                                                  stats, work, bb, off,
                                                  threads, net, tab, sc, st)
            : launch_route<T, kRouteWide, true>(tau, y0, f0, weights, out,
                                                stats, work, bb, off,
                                                threads, net, tab, sc, st);
  } else if (route == kRouteNarrow) {
    e = launch_route<T, kRouteNarrow, false>(tau, y0, f0, weights, out,
                                             stats, work, bb, off, threads,
                                             net, tab, sc, st);
  } else if (route == kRouteWide) {
    e = launch_route<T, kRouteWide, false>(tau, y0, f0, weights, out, stats,
                                           work, bb, off, threads, net, tab,
                                           sc, st);
  } else {
    tier_pack_kernel<T><<<64, 256, 0, st>>>(
        static_cast<const T*>(weights), net,
        reinterpret_cast<__nv_bfloat16*>(batch_work));
    e = cudaGetLastError();
    if (e == cudaSuccess)
      e = launch_route<T, kRouteBatch, false>(tau, y0, f0, weights, out,
                                              stats, work, bb, off, threads,
                                              net, tab, sc, st);
  }
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_SOLVE_ENTRY(NAME, TYPE)                                          \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* weights, \
      void* out, void* stats, void* work, int T_out, int B, int D,          \
      int threads, double dt0, double rtol, double atol, double dt_min,     \
      double sign, double safety, double ifactor, double dfactor,           \
      int max_steps, int valid, int n_layers, const int* dims,              \
      int act_hidden, int act_final, int input_power, int time_input,       \
      int stages, int order, int fsal, const double* c, const double* a,    \
      const double* b_sol, const double* b_err, const double* c_mid,        \
      int route, const int* tiers, void* batch_work, long batch_bytes,      \
      int cnf, void* stream) {                                               \
    return tfd::launch_solve<TYPE>(                                          \
        tau, y0, f0, weights, out, stats, work, T_out, B, D, threads, dt0,  \
        rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps,      \
        valid, n_layers, dims, act_hidden, act_final, input_power,          \
        time_input, stages, order, fsal, c, a, b_sol, b_err, c_mid, route,  \
        tiers, batch_work, batch_bytes, cnf, stream);                        \
  }

TFD_SOLVE_ENTRY(tfd_mlp_solve_f32, float)
TFD_SOLVE_ENTRY(tfd_mlp_solve_f64, double)
