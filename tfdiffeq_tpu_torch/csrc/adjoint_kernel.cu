// K3: the whole continuous-adjoint backward sweep of an MLP neural ODE in
// one launch, under one step controller shared by the batch.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_adjoint.py:430
// (_make_adjoint_kernel, RHS _make_aug_eval :107; launched by
// mlp_adjoint_solve :1050). In sigma = -tau, which increases on every
// backward interval, it integrates the augmented system
//
//     dy/dsigma   = -sign f(y),     da_y/dsigma = sign (df/dy)^T a_y,
//     da_w/dsigma = sign (df/dw)^T a_y (batch-summed),
//     da_t/dsigma = sign a_y . df/dt (batch-summed; time_input only),
//
// over the observation intervals in reverse: y is reset to the stored
// forward state ys[i] and g[i] is added into a_y at each interval start,
// every attempt takes all S stages of the tableau (the MLP forward and its
// hand-written VJP in each), the error norm covers (y, a_y) and, unless
// `seminorm`, the parameter and a_t quadratures; the clamped I-controller,
// Kahan accumulation of y and a_y, the counters and the status follow the
// reference (:498-676). ay0 = a_y + g[0] at the end. The tableau comes in
// as launch arguments, so one binary serves the five adaptive methods.
//
// The engine is csrc/rk_adjoint.cuh (rk_adjoint_kernel), a template on its
// augmented right-hand side; this file holds the MLP and CNF right-hand
// sides (MlpAdjAug) and their launch; csrc/plan_aug.cuh holds K15's.
//
// Design (csrc/rk_adjoint.cuh rk_adjoint_kernel). A grid of n_blocks blocks,
// at most one per SM and all resident together, the wrapper's choice
// (ops/cuda_kernels.py solve_blocks: one per SM, or one a sample when the
// batch is smaller). Block k owns a contiguous range of samples, about 31
// at B = 4096 on 132 SMs. Phase A walks each one's stage state, MLP forward
// and VJP with a group of threads (stage_group: 16 of the block's 512 at 32
// samples a round; more for fewer samples), each layer's outputs, and in
// the VJP each layer's inputs, spread over the group, every value one
// thread's sum in input (or output) order, the layer vectors in shared
// memory; it writes the
// per-sample layer inputs, activation derivatives and pre-activation
// cotangents to the workspace feature-major ([row][B]). Phase B gives each
// thread whole parameter cotangents, summed over the block's samples in
// K3's lane order (lane j adds samples j, j + 32, ... of the range, then
// the 32 lane sums meet in the shuffle tree's order: csrc/rk_adjoint.cuh
// lane_sum_small, its 32 samples' terms loaded together into registers),
// into the block's partial of the stage. After the attempt's S stages the
// grid meets; the owner of each parameter (the parameters, too, are cut
// into n_blocks ranges) adds the blocks' partials in block order and
// combines; each block's share of the error norm meets the others' at a
// second grid meeting, in block order, so every block takes the same
// decision. Every sum (parameter cotangents, a_t, the error) is taken in
// one fixed order that the plain version in ops/cuda_adjoint.py repeats
// for the same n_blocks, with no atomics: the same bits on every run, and
// float64 sweeps that take the plain version's exact steps. The weights,
// the group vectors, the parameter accumulator and every stage's
// parameter cotangents sit in each block's shared memory ((S + 3) n_w
// values and the groups'; the block uses its own parameters' entries).
// K7's CNF walk (kCnf) takes the same groups.
//
// Bound on the H100. A stage's work is cut 132 ways (B = 4096) and a
// sample's walk 16 ways: the stage's chain is a layer's longest sum (50
// terms at the spiral) and a block barrier a layer, then about 2
// reductions of 31 samples a thread; an attempt adds two grid meetings (an
// atomic and a spin in L2) and the block-order merges (132 L2 loads a
// value). Latency, not operations or bytes, bounds it: the spiral sweep's
// 1540 stages do 0.14 ms of the card's float32 work.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth or weights past shared memory, the group vectors (fewer slots,
// more threads a sample) in shared memory and the weights, the parameter
// accumulator, its increment and the stage cotangents in global memory
// (`pwork`, L2-resident: 3.7 MB at the wide MLP 128 -> 256 -> 256 -> 128
// with dopri5). The sums keep their order, so both routes give the same
// bits.
//
// rhs = cnf (K7's adjoint, csrc/cnf_net.cuh, replacing pallas_adjoint.py:240
// _make_cnf_aug_eval at :1088-1131): the sweep of the augmented FFJORD
// system, the state [z; logp] of D + 1 values and the network the concat-t
// flow (time_input forced). Phase A runs cnf_aug_eval_group for each owned
// sample with its group, which keeps act', act'' and the passes' products
// in the sample's slot (lane_group.h cnf_aug_slot_values) and writes the
// sample's rows (cnf_net.cuh CnfRows, CnfRowsAt: in the block's shared
// memory where they fit) of the layers' inputs, the passes' u and vb, part
// A's cotangents and the deltas; phase B takes each weight's batch sum of
// cnf_weight_x, the sample's cotangent in one fixed order (2 D + 4 reads a
// sample, a thread's samples of a row next to each other), in K3's lane
// and tree order, without atomics, as the plain version repeats. On the
// narrow route the weights sit in shared memory twice, row-major for the
// VJPs and transposed for the products over a layer's inputs.
#include "cnf_net.cuh"
#include "rk_adjoint.cuh"

namespace tfd {

// Shared memory a K3 block may take in all (ops/cuda_kernels.py
// MAX_WEIGHT_BYTES): the grouped walk gets as many slots as fit beside the
// route's own values; the wrapper's route choice counts one slot.
constexpr long kAdjSmemBytes = 220L * 1024;

// Workspace rows of the per-stage batch reductions: layer l's inputs start
// at row h_off[l] of H, its activation derivatives act'(z) and the
// cotangents of its pre-activations at row z_off[l] of G and DZ; each row
// holds B samples.
struct Rows {
  int h_off[kMaxLayers];
  int z_off[kMaxLayers];
};

// K3's MLP right-hand sides (csrc/rk_adjoint.cuh's Aug): the narrow and
// wide routes, and K7's CNF adjoint with kCnf, each a group of threads a
// sample (stage_group). The right-hand side's rows: H [n_h][B], G [n_z][B],
// DZ [n_z][B] and VT [B] (kCnf: cnf_net.cuh's CnfRows, VT among them, in
// the block's shared memory where they fit).
template <typename T, int kRoute, bool kCnf>
struct MlpAdjAug {
  static constexpr bool kBatch = false;
  static constexpr bool kGroup = true;
  const T* wg;     // packed weights (pack_mlp_weights)
  int n_w, ti, n_ps;
  int n_h, n_z;
  int gw;          // the group vectors' width: the widest layer
  int slots;       // samples a round of the grouped walk
  int sv;          // values of a slot
  int rows_smem;   // kCnf: the block's rows in shared memory
  int row_stride;  // ... their stride (the block's samples + 1)
  Net net_in;
  Rows rows_in;
  CnfRows cr;

  struct Shared {
    Net net;
    Rows rows;
  };
  struct Local {};

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
    if (threadIdx.x == 0) {
      sh.net = net_in;
      sh.rows = rows_in;
    }
    T* ws = reinterpret_cast<T*>(smem);
    if constexpr (kRoute == kRouteNarrow) {
      for (int i = threadIdx.x; i < n_w; i += blockDim.x) ws[i] = wg[i];
      if constexpr (kCnf)
        transpose_weights(net_in, wg, ws + n_w, n_w, threadIdx.x,
                          blockDim.x);
    }
    return ws + smem_weights() + long(slots) * sv +
           (rows_smem ? long(cr.n) * row_stride : 0);
  }

  // The weights' values in shared memory (the narrow route's; K7's flow
  // twice: row-major, then transposed).
  __device__ int smem_weights() const {
    return kRoute == kRouteNarrow ? (kCnf ? 2 : 1) * n_w : 0;
  }
  // A group's slot of sv values, after the weights: the stage state ya,
  // aya (gw values each), then the walk's values (the MLP's two layer
  // buffers).
  __device__ T* group_vec(int slot) const {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<T*>(smem_raw) + smem_weights() + long(slot) * sv;
  }
  // K7's rows (cnf_net.cuh CnfRowsAt): in the block's shared memory after
  // the slots, or the workspace rows rw.
  __device__ CnfRowsAt<T> rows_at(T* rw, int B) const {
    if (!rows_smem) return {rw, B};
    const long b_lo = long(blockIdx.x) * B / gridDim.x;
    return {group_vec(slots) - b_lo, row_stride};
  }
  __device__ T* group_ya(int slot) const { return group_vec(slot); }
  __device__ T* group_aya(int slot) const { return group_vec(slot) + gw; }

  // Phase A for sample b (pallas_adjoint.py:_make_aug_eval) with the gsz
  // threads of its group: the MLP forward, keeping each layer's input and
  // act'(z) (the VJP needs nothing else of z), and its VJP, keeping the
  // pre-activations' cotangents, for the batch sums. Each layer's outputs
  // (forward) and inputs (backward) are spread over the members, one
  // member a value, and each value is one member's sum in a fixed order:
  // a pre-activation W[o][0] h[0] + W[o][1] h[1] + ... in input order, then
  // the bias; an input cotangent W[0][k] dz[0] + W[1][k] dz[1] + ... in
  // output order, then times act'. The plain version (ops/cuda_adjoint.py
  // _aug_eval_plain) sums in the same order. The block meets between layers.
  // Every thread of the block calls it; `on` says whether the group has a
  // sample this round.
  __device__ void stage_group(const Shared& sh, T t_user, int b, bool on,
                              int B, T sf, int m, int gsz, int slot, T* ky,
                              T* kay, T* rw) const {
    const Net& net = sh.net;
    const T* w = weights();
    if constexpr (kCnf) {
      cnf_aug_eval_group<kRoute == kRouteNarrow>(
          net, cr, w, kRoute == kRouteNarrow ? w + n_w : w, t_user,
          group_vec(slot), gw, rows_at(rw, B), b, ky, kay, sf, on, m, gsz);
      return;
    }
    const Rows& rows = sh.rows;
    const int L = net.n_layers;
    const int D = net.din[0] - net.time_input;
    T* __restrict__ H = rw;
    T* __restrict__ G = H + long(n_h) * B;
    T* __restrict__ DZ = G + long(n_z) * B;
    T* __restrict__ VT = DZ + long(n_z) * B;
    T* const gv = group_vec(slot);
    const T* ya_ = gv;
    const T* aya_ = gv + gw;
    T* hin = gv + 2 * gw;
    T* hout = gv + 3 * gw;
    for (int d = m; on && d < D; d += gsz) {
      T h = ya_[d];
      for (int p = 1; p < net.input_power; ++p) h = h * ya_[d];
      hin[d] = h;
    }
    if (on && net.time_input && m == 0) hin[D] = t_user;
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      const T* bias = w + net.b_off[l];
      const int code = (l == L - 1) ? net.act_final : net.act_hidden;
      for (int k = m; on && k < din; k += gsz)
        H[long(rows.h_off[l] + k) * B + b] = hin[k];
      for (int o = m; on && o < dout; o += gsz) {
        const T* row = W + o * din;
        T acc = row[0] * hin[0];
        for (int k = 1; k < din; ++k) acc = acc + row[k] * hin[k];
        const T z = acc + bias[o];
        const T a = activate(code, z);
        G[long(rows.z_off[l] + o) * B + b] = act_grad(code, z, a);
        hout[o] = a;
      }
      __syncthreads();
      T* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    // hin holds f. Backward: dz of the last layer into hout.
    for (int d = m; on && d < D; d += gsz) {
      ky[d] = (-sf) * hin[d];
      const T dz = aya_[d] * G[long(rows.z_off[L - 1] + d) * B + b];
      hout[d] = dz;
      DZ[long(rows.z_off[L - 1] + d) * B + b] = dz;
    }
    __syncthreads();
    T* dz = hout;
    T* dh = hin;
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      for (int k = m; on && k < din; k += gsz) {
        T acc = W[k] * dz[0];
        for (int o = 1; o < dout; ++o) acc = acc + W[o * din + k] * dz[o];
        if (l > 0) {
          acc = acc * G[long(rows.z_off[l - 1] + k) * B + b];
          DZ[long(rows.z_off[l - 1] + k) * B + b] = acc;
        }
        dh[k] = acc;
      }
      __syncthreads();
      T* tmp = dz;
      dz = dh;
      dh = tmp;
    }
    // dz now holds the layer-0 input cotangent: v_y, then v_t.
    for (int d = m; on && d < D; d += gsz) {
      T vy = dz[d];
      if (net.input_power > 1) {
        T yp = ya_[d];
        for (int p = 2; p < net.input_power; ++p) yp = yp * ya_[d];
        vy = vy * (T(net.input_power) * yp);
      }
      kay[d] = sf * vy;
    }
    if (on && net.time_input && m == 0) VT[b] = dz[D];
    __syncthreads();
  }

  // Phase B: sum(x) of reduction r's per-sample term x(b) (csrc/
  // rk_adjoint.cuh quad), weight (o, k) dz_o h_k, a bias dz_o, then a_t
  // v_t (kCnf: cnf_weight_x); the decode is the reduction's, once.
  template <class Sum>
  __device__ T quad(const Shared& sh, int r, const T* rw, int B,
                    const Sum& sum) const {
    const Net& net = sh.net;
    const Rows& rows = sh.rows;
    const int L = net.n_layers;
    const T* __restrict__ H = rw;
    const T* __restrict__ DZ = rw + long(n_h + n_z) * B;
    const T* __restrict__ VT = DZ + long(n_z) * B;
    if constexpr (kCnf) {
      const CnfRows crr = cr;
      const CnfRowsAt<T> at = rows_at(const_cast<T*>(rw), B);
      if (r >= n_w) return sum([&](int b) { return at(crr.vt, b); });
      int l = 0;
      while (l + 1 < L && r >= net.w_off[l + 1]) ++l;
      const bool weight = r < net.b_off[l];
      const int idx = weight ? r - net.w_off[l] : r - net.b_off[l];
      const CnfWeight cw = cnf_weight(net, crr, l,
                                      weight ? idx / net.din[l] : idx,
                                      weight ? idx % net.din[l] : -1);
      const int D = net.dout[L - 1];
      return sum([&](int b) { return cnf_weight_x<T>(crr, cw, at, b, D); });
    } else {
      if (r >= n_w) return sum([&](int b) { return VT[b]; });
      int l = 0;
      while (l + 1 < L && r >= net.w_off[l + 1]) ++l;
      if (r < net.b_off[l]) {
        const int idx = r - net.w_off[l];
        const int o = idx / net.din[l], k = idx % net.din[l];
        const T* __restrict__ xh = H + long(rows.h_off[l] + k) * B;
        const T* __restrict__ xz = DZ + long(rows.z_off[l] + o) * B;
        return sum([&](int b) { return xh[b] * xz[b]; });
      }
      const T* __restrict__ xz =
          DZ + long(rows.z_off[l] + r - net.b_off[l]) * B;
      return sum([&](int b) { return xz[b]; });
    }
  }
  __device__ T sample_x(const Shared&, int, const T*, int, int) const {
    return T(0);
  }
};

// Workspace values the sweep needs; ops/cuda_adjoint.py:_work_size
// allocates the same count.
inline long adjoint_work_size(const Net& net, int S, int B, int D) {
  long rows = 1;   // VT
  for (int l = 0; l < net.n_layers; ++l)
    rows += net.din[l] + 2 * net.dout[l];
  return rk_adjoint_work_size(S, B, D, 0) + rows * B;
}

template <typename T, int kRoute, bool kCnf>
cudaError_t launch_adjoint_route(const void* tau, const void* ys,
                                 const void* g, const void* weights,
                                 void* ay0, void* aw, void* at, void* stats,
                                 void* work, void* pwork, void* gwork,
                                 long gwork_bytes, int n_blocks, int n_w,
                                 int threads, const Net& net,
                                 const Rows& rows, const CnfRows& cr,
                                 const Tableau<T>& tab,
                                 const AdjScalars<T>& sc, int* layout,
                                 cudaStream_t stream) {
  const int S = tab.S, ti = net.time_input;
  using Aug = MlpAdjAug<T, kRoute, kCnf>;
  const int gw = net_max_width(net);
  // Slots of the grouped walk: enough for a block's samples, at most
  // kGroupSlots, and their values (the stage state, then the MLP's two
  // layer vectors or K7's cnf_aug_slot_values) within what the route
  // leaves of kAdjSmemBytes. The slots change no sum's order, only how
  // many threads share a sample.
  const long sv = kCnf ? cnf_aug_slot_values(gw, cr.n_hid,
                                             net.dout[net.n_layers - 1])
                       : 4L * gw;
  const size_t own =
      sizeof(T) * ((kRoute == kRouteNarrow
                        ? size_t(3 + S + kCnf) * n_w + size_t(S) * ti
                        : 0) +
                   threads);
  const size_t slot_bytes = sizeof(T) * size_t(sv);
  const int slots = adjoint_slots(own, slot_bytes,
                                  (sc.B + n_blocks - 1) / n_blocks,
                                  size_t(kAdjSmemBytes));
  // K7's rows go to shared memory after the slots where the block's
  // samples' (one column more: an odd stride) fit (adjoint_rows_fit), else
  // they stay in the workspace.
  const int cols = (sc.B + n_blocks - 1) / n_blocks + 1;
  const size_t row_bytes = kCnf ? sizeof(T) * size_t(cr.n) : 0;
  const bool rows_smem =
      kCnf && adjoint_rows_fit(own + slots * slot_bytes, row_bytes, cols,
                               size_t(kAdjSmemBytes));
  const size_t smem = own + slots * slot_bytes +
                      (rows_smem ? size_t(cols) * row_bytes : 0);
  // What this launch runs, for the wrapper to report.
  layout[0] = slots;
  layout[1] = threads / slots;
  layout[2] = int(sv);
  layout[3] = rows_smem;
  Aug aug;
  aug.gw = gw;
  aug.slots = slots;
  aug.sv = int(sv);
  aug.rows_smem = rows_smem;
  aug.row_stride = cols;
  aug.wg = static_cast<const T*>(weights);
  aug.n_w = n_w;
  aug.ti = ti;
  aug.n_ps = 0;
  aug.n_h = 0;
  aug.n_z = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    aug.n_h += net.din[l];
    aug.n_z += net.dout[l];
  }
  aug.net_in = net;
  aug.rows_in = rows;
  aug.cr = cr;
  AdjScalars<T> s2 = sc;
  s2.quad_smem = kRoute == kRouteNarrow;
  return launch_rk_adjoint<T>(tau, ys, g, ay0, aw, at, nullptr, stats, work,
                              pwork, gwork, gwork_bytes, n_blocks, aug, smem,
                              threads, tab, s2, stream);
}

template <typename T>
int launch_adjoint(const void* tau, const void* ys, const void* g,
                   const void* weights, void* ay0, void* aw, void* at,
                   void* stats, void* work, long work_size, int T_obs, int B,
                   int D, int threads, double dt0, double rtol, double atol,
                   double dt_min, double sign, double safety, double ifactor,
                   double dfactor, int max_steps, int seminorm, int n_layers,
                   const int* dims, int act_hidden, int act_final,
                   int input_power, int time_input, int stages, int order,
                   const double* c, const double* a, const double* b_sol,
                   const double* b_err, int route, void* pwork,
                   long pwork_size, int cnf, void* gwork, long gwork_bytes,
                   int n_blocks, int* layout, void* stream) {
  if (!layout || stages < 2 || stages > kMaxStages || T_obs < 1 || B < 1 ||
      D < 1 ||
      D + time_input > kMaxWidth || input_power < 1 || threads < kWarp ||
      threads > kAdjThreads || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The CNF flow maps the D - 1 features of z and the time to D - 1.
  if (cnf && (D < 2 || !time_input || input_power != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int n_w = make_net(net, n_layers, dims, cnf ? D - 1 : D, act_hidden,
                           act_final, input_power, time_input);
  if (n_w < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  const long need =
      cnf ? rk_adjoint_work_size(stages, B, D, 0) + make_cnf_rows(net).n * B
          : adjoint_work_size(net, stages, B, D);
  if (work_size < need) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWide &&
      (!pwork || pwork_size < rk_adjoint_quad_size(n_w, stages, time_input)))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows rows;
  int h = 0, z = 0;
  for (int l = 0; l < n_layers; ++l) {
    rows.h_off[l] = h;
    rows.z_off[l] = z;
    h += net.din[l];
    z += net.dout[l];
  }
  const Tableau<T> tab = make_tableau<T>(stages, order, 0, c, a, b_sol,
                                         b_err, nullptr);
  const AdjScalars<T> sc = make_adj_scalars<T>(
      dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps,
      T_obs, B, D, seminorm, 0);

  const CnfRows cr = cnf ? make_cnf_rows(net) : CnfRows{};

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cnf)
    e = route == kRouteNarrow
            ? launch_adjoint_route<T, kRouteNarrow, true>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, gwork,
                  gwork_bytes, n_blocks, n_w, threads, net, rows, cr, tab, sc,
                  layout, st)
            : launch_adjoint_route<T, kRouteWide, true>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, gwork,
                  gwork_bytes, n_blocks, n_w, threads, net, rows, cr, tab, sc,
                  layout, st);
  else
    e = route == kRouteNarrow
            ? launch_adjoint_route<T, kRouteNarrow, false>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, gwork,
                  gwork_bytes, n_blocks, n_w, threads, net, rows, cr, tab, sc,
                  layout, st)
            : launch_adjoint_route<T, kRouteWide, false>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, gwork,
                  gwork_bytes, n_blocks, n_w, threads, net, rows, cr, tab, sc,
                  layout, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_ADJOINT_ENTRY(NAME, TYPE)                                        \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* weights,  \
      void* ay0, void* aw, void* at, void* stats, void* work,               \
      long work_size, int T_obs, int B, int D, int threads, double dt0,     \
      double rtol, double atol, double dt_min, double sign, double safety,  \
      double ifactor, double dfactor, int max_steps, int seminorm,          \
      int n_layers, const int* dims, int act_hidden, int act_final,         \
      int input_power, int time_input, int stages, int order,               \
      const double* c, const double* a, const double* b_sol,                \
      const double* b_err, int route, void* pwork, long pwork_size,         \
      int cnf, void* gwork, long gwork_bytes, int n_blocks, int* layout,    \
      void* stream) {                                                        \
    return tfd::launch_adjoint<TYPE>(                                        \
        tau, ys, g, weights, ay0, aw, at, stats, work, work_size, T_obs, B, \
        D, threads, dt0, rtol, atol, dt_min, sign, safety, ifactor,         \
        dfactor, max_steps, seminorm, n_layers, dims, act_hidden,           \
        act_final, input_power, time_input, stages, order, c, a, b_sol,     \
        b_err, route, pwork, pwork_size, cnf, gwork, gwork_bytes, n_blocks, \
        layout, stream);                                                     \
  }

TFD_ADJOINT_ENTRY(tfd_mlp_adjoint_f32, float)
TFD_ADJOINT_ENTRY(tfd_mlp_adjoint_f64, double)
