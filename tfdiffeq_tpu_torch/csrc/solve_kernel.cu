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
// Design (csrc/rk_solve.cuh). The solve runs on a grid of n_blocks blocks
// of 512 threads, one per SM (fewer for a small batch), all resident
// together; block k owns the samples [k B / n, (k + 1) B / n), a group of
// its threads walks each sample's stage evaluations (`slots` samples a
// round: 16 threads a sample at 32 slots), and each thread combines,
// updates and drains its own samples. The
// stage derivatives, the state, the FSAL derivative and the Kahan term of
// the batch live in device scratch (`work`, [(S + 5) B D] values: 256 KB
// at the main path, L2-resident); each block copies the weights (narrow
// route) and the tableau into its own shared memory. The blocks meet once
// an attempt: each block's share of the error sum (a fixed-order block
// reduction) and its finiteness flag, added in block order by every block
// (the same bits on every run), then every thread of every block takes the
// same accept and controller decision from them.
//
// Routes (mlp_rk.cuh Route). Narrow: layers up to 128 wide, the weights in
// shared memory (the main path). Wide: layers up to kMaxWidth, the weights
// read from global memory (131,712 float32 weights, 527 KB, at the wide MLP
// 128 -> 256 -> 256 -> 128: L2-resident). Both keep a group's layer
// vectors in its slot in shared memory.
// Batch (csrc/dot_tiers.cuh, the dot-precision tiers): every stage
// evaluation of the attempt is batch-wide over the block's own 16-row
// tiles, layer by layer, the tier layers on the tensor cores in float32;
// rows are independent within a stage, so a stage needs no meeting, and
// the grid has at most one block a tile. The controller is the same.
//
// rhs = cnf (K7's forward, csrc/cnf_net.cuh cnf_eval_group, replacing
// pallas_kernels.py:442 _make_cnf_net at :1291-1294): the state is the CNF
// state [z; logp] of D + 1 values, the network the concat-t flow, and each
// evaluation is the flow plus its exact divergence, walked by the same
// groups of threads as the MLP, a sample's act'(z), F and trace terms in
// its slot (lane_group.h cnf_solve_slot_values); on the narrow route the
// weights sit in shared memory transposed. Narrow and wide routes only (the
// flow takes no tier).
//
// Bound on the H100. Per sample and attempt, S - 1 evaluations of the MLP
// (at the main path 2 -> 50 -> 2: about 400 flops and 50 tanh each); at
// B = 4096 over 132 blocks a block owns about 31 samples, a round of its
// groups, so an attempt costs S - 1 evaluations' longest chains (a layer's
// longest sum a layer, and a block barrier after each) and one grid
// meeting (an atomic and a spin on L2, then n_blocks loads of the shares).
// The wide route is bound the same way, with a global-memory load beside
// each multiply-add.
#include "cnf_net.cuh"
#include "dot_tiers.cuh"
#include "rk_solve.cuh"

namespace tfd {

// K2's MLP right-hand sides (csrc/rk_solve.cuh's Rhs): the narrow and wide
// routes, a group of threads a sample (mlp_eval_group, or K7's
// cnf_eval_group with rhs = cnf), and the batch route (batch_mlp_eval, K4's
// tiers).
template <typename T, int kRoute, bool kCnf>
struct MlpSolveRhs {
  static constexpr bool kBatch = kRoute == kRouteBatch;
  static constexpr int kUnit = kBatch ? 16 : 1;   // K4's tile rows
  static constexpr bool kGrid = true;
  static constexpr bool kGroup = !kBatch;
  const T* wg;     // packed weights (pack_mlp_weights)
  int n_weights;
  int gw;          // the group vectors' width: the widest layer
  int slots;       // samples a round of the grouped walk
  int sv;          // values of a slot
  Net net_in;
  BatchBufs<T> bb;

  struct Shared {
    Net net;
  };
  struct Local {};

  // The packed weights: in shared memory on the narrow route (setup copies
  // them there; K7's flow transposed), else in global memory.
  __device__ __forceinline__ const T* weights() const {
    if constexpr (kRoute == kRouteNarrow) {
      extern __shared__ __align__(16) unsigned char smem_raw[];
      return reinterpret_cast<const T*>(smem_raw);
    } else {
      return wg;
    }
  }

  __device__ T* setup(Shared& sh, Local&, unsigned char* smem, int r0,
                      int nr) const {
    const int tid = threadIdx.x, nth = blockDim.x;
    T* red;
    if constexpr (kRoute == kRouteNarrow) {
      T* ws = reinterpret_cast<T*>(smem);
      if constexpr (kCnf)
        transpose_weights(net_in, wg, ws, n_weights, tid, nth);
      else
        for (int i = tid; i < n_weights; i += nth) ws[i] = wg[i];
      red = ws + n_weights;
    } else if constexpr (kRoute == kRouteBatch) {
      red = reinterpret_cast<T*>(smem + batch_smem(bb));   // K4's tiles first
    } else {
      red = reinterpret_cast<T*>(smem);
    }
    if (tid == 0) sh.net = net_in;
    if constexpr (kRoute == kRouteBatch)
      batch_clear(bb, r0, nr);
    return red;
  }

  __device__ const T* eval_group(const Shared& sh, T t, bool on, int m,
                                 int gsz, T* hin) const {
    if constexpr (kCnf)
      return cnf_eval_group<kRoute == kRouteNarrow>(sh.net, weights(), t,
                                                    hin, gw, on, m, gsz);
    else
      return mlp_eval_group(sh.net, weights(), t, hin, gw, on, m, gsz);
  }

  template <class G>
  __device__ void put(const Shared& sh, Local&, int b, T t, G get, T*,
                      int) const {
    batch_put(bb, sh.net, b, t, get);
  }
  __device__ const T* eval_batch(const Shared& sh, Local& lo, T*, T*, int,
                                 int r0, int nr) const {
    return batch_mlp_eval(sh.net, weights(), bb, r0, nr);
  }
  __device__ long ld(const Local&) const { return bb.ld; }
};

template <typename T, int kRoute, bool kCnf>
cudaError_t launch_route(const void* tau, const void* y0, const void* f0,
                         const void* weights, void* out, void* stats,
                         void* work, void* gwork, long gwork_bytes,
                         int n_blocks, const BatchBufs<T>& bb, int n_w,
                         int threads, const Net& net, const Tableau<T>& tab,
                         const Scalars<T>& sc, int* layout,
                         cudaStream_t stream) {
  using Rhs = MlpSolveRhs<T, kRoute, kCnf>;
  const size_t fixed =
      sizeof(T) * (kRoute == kRouteNarrow ? size_t(n_w) : 0) +
      (kRoute == kRouteBatch ? batch_smem(bb) : 0);
  // The grouped walk's slots: enough for a block's samples, up to
  // kGroupSlots, each sv values (the MLP's two layer vectors, K7's
  // cnf_solve_slot_values) in (or growing) the reduction scratch.
  const int gw = net_max_width(net);
  const long sv = kCnf ? cnf_solve_slot_values(gw, cnf_hidden(net),
                                               net.dout[net.n_layers - 1])
                       : 2L * gw;
  const int slots =
      Rhs::kGroup
          ? group_slots(fixed, kSolveSmemBytes + sizeof(T) * threads,
                        threads, sv, (sc.B + n_blocks - 1) / n_blocks,
                        sizeof(T))
          : 1;
  const size_t scratch =
      Rhs::kGroup && size_t(slots) * sv > size_t(threads)
          ? size_t(slots) * sv
          : size_t(threads);
  const size_t smem = fixed + sizeof(T) * scratch;
  // What this launch runs, for the wrapper to report: samples a round,
  // threads a sample and a slot's values (zeros on the batch route, which
  // walks no sample with a group).
  layout[0] = Rhs::kGroup ? slots : 0;
  layout[1] = Rhs::kGroup ? threads / slots : 0;
  layout[2] = Rhs::kGroup ? int(sv) : 0;
  Rhs rhs;
  rhs.wg = static_cast<const T*>(weights);
  rhs.n_weights = n_w;
  rhs.gw = gw;
  rhs.slots = slots;
  rhs.sv = int(sv);
  rhs.net_in = net;
  rhs.bb = bb;
  return launch_rk_solve<T>(tau, y0, f0, out, stats, work, gwork,
                            gwork_bytes, n_blocks, rhs, smem, threads, tab,
                            sc, stream);
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
                 void* batch_work, long batch_bytes, int cnf, void* gwork,
                 long gwork_bytes, int n_blocks, int* layout, void* stream) {
  if (!layout || n_layers < 1 || n_layers > kMaxLayers || stages < 2 ||
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
    // Each block owns at most ceil(tiles / n_blocks) tiles of 16 rows.
    const long tiles = rows / 16;
    if (!batch_work || n_blocks < 1 || n_blocks > tiles ||
        batch_bytes < batch_work_bytes(net, n_w16, rows, sizeof(T)))
      return static_cast<int>(cudaErrorInvalidValue);
    bb = batch_bufs<T>(batch_work, net, n_w16, rows, threads / kWarpSize,
                       16 * ((tiles + n_blocks - 1) / n_blocks));
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
  // The arguments every route takes.
  auto route_args = [&](auto launch) {
    return launch(tau, y0, f0, weights, out, stats, work, gwork,
                  gwork_bytes, n_blocks, bb, off, threads, net, tab, sc,
                  layout, st);
  };
  cudaError_t e;
  if (cnf) {
    e = route == kRouteNarrow
            ? route_args(launch_route<T, kRouteNarrow, true>)
            : route_args(launch_route<T, kRouteWide, true>);
  } else if (route == kRouteNarrow) {
    e = route_args(launch_route<T, kRouteNarrow, false>);
  } else if (route == kRouteWide) {
    e = route_args(launch_route<T, kRouteWide, false>);
  } else {
    tier_pack_kernel<T><<<64, 256, 0, st>>>(
        static_cast<const T*>(weights), net,
        reinterpret_cast<__nv_bfloat16*>(batch_work));
    e = cudaGetLastError();
    if (e == cudaSuccess) e = route_args(launch_route<T, kRouteBatch, false>);
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
      int cnf, void* gwork, long gwork_bytes, int n_blocks, int* layout,    \
      void* stream) {                                                        \
    return tfd::launch_solve<TYPE>(                                          \
        tau, y0, f0, weights, out, stats, work, T_out, B, D, threads, dt0,  \
        rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps,      \
        valid, n_layers, dims, act_hidden, act_final, input_power,          \
        time_input, stages, order, fsal, c, a, b_sol, b_err, c_mid, route,  \
        tiers, batch_work, batch_bytes, cnf, gwork, gwork_bytes, n_blocks,  \
        layout, stream);                                                     \
  }

TFD_SOLVE_ENTRY(tfd_mlp_solve_f32, float)
TFD_SOLVE_ENTRY(tfd_mlp_solve_f64, double)
