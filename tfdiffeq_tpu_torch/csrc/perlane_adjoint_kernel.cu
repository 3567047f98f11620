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
#include "mlp_rk.cuh"

namespace tfd {

template <typename T>
struct PerlaneAdjScalars {
  T rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, T_obs, B, D;
};

template <typename T, int kRoute>
__global__ void mlp_perlane_adjoint_kernel(
    const T* __restrict__ tau, const T* __restrict__ ys,
    const T* __restrict__ g, const T* __restrict__ dt0g,
    const T* __restrict__ wg, T* __restrict__ ay0_out,
    int* __restrict__ lane_stats, int* __restrict__ stats,
    T* __restrict__ partial, T* __restrict__ work, int n_weights,
    Net net_in, AugRows rows_in, Tableau<T> tab_in,
    PerlaneAdjScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Net net;
  __shared__ AugRows rows;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  if (tid == 0) {
    net = net_in;
    rows = rows_in;
    tab = tab_in;
  }
  const int n_w = n_weights;
  const T* w;   // [n_w] weights
  T* red;       // [blockDim.x] block_sum scratch
  if constexpr (kRoute == kRouteNarrow) {
    T* ws = reinterpret_cast<T*>(smem_raw);
    for (int i = tid; i < n_w; i += blockDim.x) ws[i] = wg[i];
    w = ws;
    red = ws + n_w;
  } else {
    w = wg;
    red = reinterpret_cast<T*>(smem_raw);
  }
  __syncthreads();

  const int T_obs = sc.T_obs, B = sc.B, D = sc.D;
  const int S = tab.S, ti = net.time_input;
  const int R = n_w + ti;                 // quadrature values a sample
  const long BD = long(B) * D;
  int n_h = 0;
  for (int l = 0; l < net.n_layers; ++l) n_h += net.din[l];
  // Feature-major workspace rows of B values each.
  T* Y = work;                      // [D] y
  T* AY = Y + BD;                   // [D] a_y
  T* CY = AY + BD;                  // [D] Kahan compensation of y
  T* CAY = CY + BD;                 // [D] ... and of a_y
  T* KY = CAY + BD;                 // [S][D] stage derivatives of y
  T* KAY = KY + S * BD;             // [S][D] ... and of a_y
  T* H = KAY + S * BD;              // [n_h] each layer's inputs
  T* G = H + long(n_h) * B;         // [n_z] act'(z) of each layer
  T* STEP = H + aug_rows_count(net) * B;  // [R] the trial's quadrature
  T* ACC = STEP + long(R) * B;      // [R] the accepted quadrature

  const int b = blockIdx.x * blockDim.x + tid;
  const bool mine = b < B;          // idle threads still meet at the end
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  constexpr int kW = vec_width<kRoute>();
  T ya[kW], aya[kW], buf_a[kW], buf_b[kW];
  const T sf = sc.sign;
  const T denom = T(2 * D);
  int first_b = 0;                  // first stage with a nonzero weight
  while (tab.b_sol[first_b] == T(0)) ++first_b;

  T dt = mine ? dt0g[b] : T(0);
  int nfe = 0, nacc = 0, nrej = 0, status = 0;
  if (mine) {
    for (int d = 0; d < D; ++d) AY[at(d)] = T(0);
    for (int r = 0; r < R; ++r) ACC[at(r)] = T(0);
  }
  for (int i = T_obs - 1; mine && i >= 1; --i) {
    // Reset y to the stored forward state; inject the cotangent.
    for (int d = 0; d < D; ++d) {
      const long k = long(i) * BD + long(b) * D + d;
      Y[at(d)] = ys[k];
      AY[at(d)] = AY[at(d)] + g[k];
      CY[at(d)] = T(0);
      CAY[at(d)] = T(0);
    }
    T s = -tau[i];
    const T s_end = -tau[i - 1];
    while (s < s_end && status == 0) {
      const T rem = s_end - s;
      const T dt_eff = d_min(dt, rem);
      const bool is_last = dt >= rem;
      const T s1 = is_last ? s_end : s + dt_eff;
      const T dth = s1 - s;
      for (int st = 0; st < S; ++st) {
        aug_stage_state(tab, st, dth, Y, AY, KY, KAY, ya, aya, D, B, b);
        // The MLP forward and its VJP; the trial's weighted quadrature
        // term, (dt b_st) (sign x), joins STEP in stage order.
        aug_stage(net, rows, w, (-sf) * (s + tab.c[st] * dth), ya, aya,
                  buf_a, buf_b, H, G, KY + long(st) * BD,
                  KAY + long(st) * BD, STEP, B, b, sf,
                  dth * tab.b_sol[st], tab.b_sol[st] != T(0),
                  st == first_b);
      }
      // The (y, a_y) seminorm of the sample's error, and finiteness.
      T ss_part[2] = {T(0), T(0)};
      bool bad = false;
      for (int pass = 0; pass < 2; ++pass) {
        const T* V = pass ? AY : Y;
        const T* KV = pass ? KAY : KY;
        for (int d = 0; d < D; ++d) {
          T dv = T(0), ev = T(0);
          bool first_d = true, first_e = true;
          for (int q = 0; q < S; ++q) {
            const T kq = KV[at(q * D + d)];
            if (tab.b_sol[q] != T(0)) {
              const T term = (dth * tab.b_sol[q]) * kq;
              dv = first_d ? term : dv + term;
              first_d = false;
            }
            if (tab.b_err[q] != T(0)) {
              const T term = (dth * tab.b_err[q]) * kq;
              ev = first_e ? term : ev + term;
              first_e = false;
            }
          }
          const T v0 = V[at(d)];
          const T v1 = v0 + dv;
          const T esc = ev / (sc.atol + sc.rtol * d_max(d_abs(v0), d_abs(v1)));
          ss_part[pass] = ss_part[pass] + esc * esc;
          bad = bad || !d_finite(v1);
        }
      }
      const T ss = ss_part[0] + ss_part[1];
      const T ratio = d_sqrt(ss / denom);
      const bool finite = d_finite(ss) && !bad;
      const bool accept = (ratio <= T(1)) && finite;
      const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                      sc.ifactor, sc.dfactor, tab.order);
      const T dt_next = dth * fac;
      if (accept) {
        // The Kahan-compensated update of (y, a_y), and the trial's
        // quadrature into the sample's running sums.
        aug_kahan_update(tab, dth, Y, AY, CY, CAY, KY, KAY, D, B, b);
        for (int r = 0; r < R; ++r) ACC[at(r)] = ACC[at(r)] + STEP[at(r)];
        s = s1;
      }
      // The sample's status rules (pallas_adjoint.py:881-890).
      nfe += S;
      nacc += accept ? 1 : 0;
      nrej += accept ? 0 : 1;
      if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
      if (nacc + nrej >= sc.max_steps && s < s_end && status == 0)
        status = 1;
      dt = dt_next;
    }
  }
  if (mine) {
    for (int d = 0; d < D; ++d) {
      const long k = long(b) * D + d;
      ay0_out[k] = AY[at(d)] + g[k];
    }
    lane_stats[b] = nfe;
    lane_stats[B + b] = nacc;
    lane_stats[2 * B + b] = nrej;
    lane_stats[3 * B + b] = status;
    // Integer sums: the same total in any order.
    atomicAdd(stats, nfe);
    atomicAdd(stats + 1, nacc);
    atomicAdd(stats + 2, nrej);
    atomicMax(stats + 3, status);
  }
  // The block's sums of the per-sample quadratures, in block_sum's tree.
  for (int r = 0; r < R; ++r) {
    const T total = block_sum(mine ? ACC[at(r)] : T(0), red);
    if (tid == 0) partial[long(blockIdx.x) * R + r] = total;
  }
}

// Workspace values the sweep needs; ops/cuda_perlane.py:_adjoint_work_size
// allocates the same count.
inline long perlane_adjoint_work_size(const Net& net, int n_w, int S, int B,
                                      int D) {
  const long rows = (4 + 2 * long(S)) * D + aug_rows_count(net) +
                    2 * long(n_w + net.time_input);
  return rows * B;
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
  const AugRows rows = make_aug_rows(net);
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
  cudaError_t e = cudaMemsetAsync(stats, 0, 4 * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool narrow = route == kRouteNarrow;
  const size_t smem = sizeof(T) * ((narrow ? size_t(n_w) : 0) + threads);
  auto kernel = narrow ? mlp_perlane_adjoint_kernel<T, kRouteNarrow>
                       : mlp_perlane_adjoint_kernel<T, kRouteWide>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + threads - 1) / threads;
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const T*>(tau), static_cast<const T*>(ys),
      static_cast<const T*>(g), static_cast<const T*>(dt0),
      static_cast<const T*>(weights), static_cast<T*>(ay0),
      static_cast<int*>(lane_stats), static_cast<int*>(stats),
      static_cast<T*>(partial), static_cast<T*>(work), n_w, net, rows, tab,
      sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = n_w + time_input;
  quadrature_reduce_kernel<T><<<(R + 127) / 128, 128, 0, st>>>(
      static_cast<const T*>(partial), blocks, n_w, time_input,
      static_cast<T*>(aw), static_cast<T*>(at), nullptr, 0, 0);
  return static_cast<int>(cudaGetLastError());
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
