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
// Design. One thread block for the whole sweep, as K2: thread tid owns the
// samples b = tid, tid + blockDim.x, ... and walks each one's stage state,
// MLP forward and VJP alone; the per-sample stage data live in a device
// workspace (`work`), the weights, the parameter accumulator and every
// stage's parameter cotangent in shared memory ((S + 3) n_w values; the
// b_sol and b_err combines need all S stages at once). Unlike K2, the
// batch meets at every STAGE, not only at every attempt: each stage's
// parameter cotangent is a sum over the whole batch
// (pallas_adjoint.py:196-201, :503-509). The per-sample layer inputs,
// activation derivatives and pre-activation cotangents go to the
// workspace feature-major ([row][B], so a warp reads 32 consecutive
// samples), and then each warp takes whole reductions: lane j adds samples
// j, j + 32, j + 64, ... in order (loading 8 ahead) and the 32 lane sums
// meet in a fixed shuffle tree. Every batch sum
// (parameter cotangents, a_t, the error) is taken in one fixed order that
// the plain version in ops/cuda_adjoint.py repeats, with no atomics: the
// same bits on every run, and float64 sweeps that take the plain version's
// exact steps.
//
// Bound on the H100. One SM of 132 does all the work. Per stage, each of
// the 512 threads walks the MLP forward and VJP of B / 512 samples (about
// 800 flops a sample at the spiral, its vectors in local memory), then each
// warp reads two values and adds once per (parameter, sample) pair of its
// share of the batch sums (252 x 4096 pairs at the spiral), with 2 block
// barriers a stage: both bound by one SM's instruction throughput and
// memory latency. Loading 8 samples ahead in the batch sums took the
// spiral training sweep on an H100 from 1053 to 816 ms (0.53 ms a stage,
// PERF.md), so most of the rest is likely the per-sample pass. Spreading the batch over the card
// (one block per SM, a grid-wide barrier per stage, per-block partial sums
// merged in a fixed order) is the follow-up, the same as K2's.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth or weights past shared memory, the per-thread vectors of 512
// values in local memory and the weights, the parameter accumulator, its
// increment and the stage cotangents in global memory (`pwork`, L2-resident:
// 3.7 MB at the wide MLP 128 -> 256 -> 256 -> 128 with dopri5). The sums
// keep their order, so both routes give the same bits.
//
// rhs = cnf (K7's adjoint, csrc/cnf_net.cuh, replacing pallas_adjoint.py:240
// _make_cnf_aug_eval at :1088-1131): the sweep of the augmented FFJORD
// system, the state [z; logp] of D + 1 values and the network the concat-t
// flow (time_input forced). Phase A runs cnf_aug_eval for each owned
// sample, which writes the sample's rows of the layers' inputs, act',
// act'', the passes' v, u and vb, part A's cotangents and the deltas; phase
// B takes each weight's batch sum of cnf_weight_x, the sample's cotangent
// in one fixed order (2 D + 4 workspace reads a sample), in K3's lane and
// tree order, without atomics, as the plain version repeats.
#include "cnf_net.cuh"
#include "rk_adjoint.cuh"

namespace tfd {

// Workspace rows of the per-stage batch reductions: layer l's inputs start
// at row h_off[l] of H, its activation derivatives act'(z) and the
// cotangents of its pre-activations at row z_off[l] of G and DZ; each row
// holds B samples.
struct Rows {
  int h_off[kMaxLayers];
  int z_off[kMaxLayers];
};

// K3's MLP right-hand sides (csrc/rk_adjoint.cuh's Aug): the narrow and
// wide routes, and K7's CNF adjoint with kCnf. The right-hand side's rows:
// H [n_h][B], G [n_z][B], DZ [n_z][B] and VT [B] (kCnf: cnf_net.cuh's
// rows, VT among them).
template <typename T, int kRoute, bool kCnf>
struct MlpAdjAug {
  static constexpr bool kBatch = false;
  const T* wg;     // packed weights (pack_mlp_weights)
  int n_w, ti, n_ps;
  int n_h, n_z;
  Net net_in;
  Rows rows_in;
  CnfRows cr;

  struct Shared {
    Net net;
    Rows rows;
  };
  // The per-thread vectors of one sample. The weights' pointer stays out
  // of this struct: a store through them could alias it.
  struct Local {
    T ya[vec_width<kRoute>()], aya[vec_width<kRoute>()];
    T buf_a[vec_width<kRoute>()], buf_b[vec_width<kRoute>()];
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
    if (threadIdx.x == 0) {
      sh.net = net_in;
      sh.rows = rows_in;
    }
    if constexpr (kRoute == kRouteNarrow) {
      T* ws = reinterpret_cast<T*>(smem);
      for (int i = threadIdx.x; i < n_w; i += blockDim.x) ws[i] = wg[i];
      return ws + n_w;
    } else {
      return reinterpret_cast<T*>(smem);
    }
  }
  __device__ T* ya(Local& lo) const { return lo.ya; }
  __device__ T* aya(Local& lo) const { return lo.aya; }

  // Phase A for sample b (pallas_adjoint.py:_make_aug_eval): the MLP
  // forward, keeping each layer's input and act'(z), and its VJP, keeping
  // the pre-activations' cotangents, for the batch sums.
  __device__ void stage(const Shared& sh, Local& lo, T t_user, int b, int B,
                        T sf, T* ky, T* kay, T* rw) const {
    const Net& net = sh.net;
    const Rows& rows = sh.rows;
    const T* w = weights();
    const int L = net.n_layers;
    const int D = net.din[0] - net.time_input;
    T* __restrict__ H = rw;
    T* __restrict__ G = H + long(n_h) * B;
    T* __restrict__ DZ = G + long(n_z) * B;
    T* __restrict__ VT = kCnf ? H + long(cr.vt) * B : DZ + long(n_z) * B;
    const T* ya_ = lo.ya;
    const T* aya_ = lo.aya;
    if constexpr (kCnf) {
      cnf_aug_eval(net, cr, w, t_user, ya_, aya_, lo.buf_a, lo.buf_b, H, B,
                   b, ky, kay, sf);
      return;
    }
    // Forward, keeping each layer's input and act'(z) (the VJP needs
    // nothing else of z).
    T* hin = lo.buf_a;
    T* hout = lo.buf_b;
    for (int d = 0; d < D; ++d) {
      T h = ya_[d];
      for (int p = 1; p < net.input_power; ++p) h = h * ya_[d];
      hin[d] = h;
    }
    if (net.time_input) hin[D] = t_user;
    for (int l = 0; l < L; ++l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      const T* bias = w + net.b_off[l];
      const int code = (l == L - 1) ? net.act_final : net.act_hidden;
      for (int k = 0; k < din; ++k)
        H[long(rows.h_off[l] + k) * B + b] = hin[k];
      for (int o = 0; o < dout; ++o) {
        const T* row = W + o * din;
        T acc = row[0] * hin[0];
        for (int k = 1; k < din; ++k) acc = acc + row[k] * hin[k];
        const T z = acc + bias[o];
        const T a = activate(code, z);
        G[long(rows.z_off[l] + o) * B + b] = act_grad(code, z, a);
        hout[o] = a;
      }
      T* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    // hin holds f. Backward: dz of the last layer into hout.
    for (int d = 0; d < D; ++d) {
      ky[d] = (-sf) * hin[d];
      const T dz = aya_[d] * G[long(rows.z_off[L - 1] + d) * B + b];
      hout[d] = dz;
      DZ[long(rows.z_off[L - 1] + d) * B + b] = dz;
    }
    T* dz = hout;
    T* dh = hin;
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      for (int k = 0; k < din; ++k) {
        T acc = W[k] * dz[0];
        for (int o = 1; o < dout; ++o) acc = acc + W[o * din + k] * dz[o];
        if (l > 0) {
          acc = acc * G[long(rows.z_off[l - 1] + k) * B + b];
          DZ[long(rows.z_off[l - 1] + k) * B + b] = acc;
        }
        dh[k] = acc;
      }
      T* tmp = dz;
      dz = dh;
      dh = tmp;
    }
    // dz now holds the layer-0 input cotangent: v_y, then v_t.
    for (int d = 0; d < D; ++d) {
      T vy = dz[d];
      if (net.input_power > 1) {
        T yp = ya_[d];
        for (int p = 2; p < net.input_power; ++p) yp = yp * ya_[d];
        vy = vy * (T(net.input_power) * yp);
      }
      kay[d] = sf * vy;
    }
    if (net.time_input) VT[b] = dz[D];
  }

  // Phase B: reduction r's batch sum in K3's order, weight (o, k) the sum
  // of dz_o h_k, a bias of dz_o, then a_t of v_t (kCnf: cnf_weight_x).
  __device__ T quad_sum(const Shared& sh, int r, const T* rw, int B,
                        int lane) const {
    const Net& net = sh.net;
    const Rows& rows = sh.rows;
    const int L = net.n_layers;
    const T* __restrict__ H = rw;
    const T* __restrict__ DZ = rw + long(n_h + n_z) * B;
    const T* __restrict__ VT =
        kCnf ? H + long(cr.vt) * B : DZ + long(n_z) * B;
    if (r >= n_w) return batch_sum<T, false>(VT, nullptr, B, lane);
    int l = 0;
    while (l + 1 < L && r >= net.w_off[l + 1]) ++l;
    if constexpr (kCnf) {
      const bool weight = r < net.b_off[l];
      const int idx = weight ? r - net.w_off[l] : r - net.b_off[l];
      const int o = weight ? idx / net.din[l] : idx;
      const int k = weight ? idx % net.din[l] : -1;
      const CnfRows crr = cr;
      return batch_sum_of<T>(
          [&](int b) { return cnf_weight_x<T>(net, crr, H, l, o, k, B, b); },
          B, lane);
    } else {
      if (r < net.b_off[l]) {
        const int idx = r - net.w_off[l];
        const int o = idx / net.din[l], k = idx % net.din[l];
        return batch_sum<T, true>(H + long(rows.h_off[l] + k) * B,
                                  DZ + long(rows.z_off[l] + o) * B, B, lane);
      }
      return batch_sum<T, false>(
          DZ + long(rows.z_off[l] + r - net.b_off[l]) * B, nullptr, B, lane);
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
                                 void* work, void* pwork, int n_w,
                                 int threads, const Net& net,
                                 const Rows& rows, const CnfRows& cr,
                                 const Tableau<T>& tab,
                                 const AdjScalars<T>& sc,
                                 cudaStream_t stream) {
  const int S = tab.S, ti = net.time_input;
  const size_t smem =
      sizeof(T) * ((kRoute == kRouteNarrow
                        ? size_t(3 + S) * n_w + size_t(S) * ti
                        : 0) +
                   threads);
  MlpAdjAug<T, kRoute, kCnf> aug;
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
                              pwork, aug, smem, threads, tab, s2, stream);
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
                   long pwork_size, int cnf, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_obs < 1 || B < 1 || D < 1 ||
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
      cnf ? rk_adjoint_work_size(stages, B, D, 0) + cnf_rows_count(net) * B
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
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st)
            : launch_adjoint_route<T, kRouteWide, true>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st);
  else
    e = route == kRouteNarrow
            ? launch_adjoint_route<T, kRouteNarrow, false>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st)
            : launch_adjoint_route<T, kRouteWide, false>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st);
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
      int cnf, void* stream) {                                               \
    return tfd::launch_adjoint<TYPE>(                                        \
        tau, ys, g, weights, ay0, aw, at, stats, work, work_size, T_obs, B, \
        D, threads, dt0, rtol, atol, dt_min, sign, safety, ifactor,         \
        dfactor, max_steps, seminorm, n_layers, dims, act_hidden,           \
        act_final, input_power, time_input, stages, order, c, a, b_sol,     \
        b_err, route, pwork, pwork_size, cnf, stream);                       \
  }

TFD_ADJOINT_ENTRY(tfd_mlp_adjoint_f32, float)
TFD_ADJOINT_ENTRY(tfd_mlp_adjoint_f64, double)
