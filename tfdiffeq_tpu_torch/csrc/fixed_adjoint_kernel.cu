// K9: the whole fixed-grid continuous-adjoint backward sweep of an MLP
// neural ODE (euler, midpoint, rk4, rk4_38).
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:726
// (_make_fixed_adjoint_kernel, RHS pallas_adjoint.py:_make_aug_eval :107;
// launched by _fixed_adjoint_call :863 from mlp_adjoint_solve_fixed :938).
// In sigma = -tau it integrates, with n_sub equal steps per observation
// interval, the augmented system
//
//     dy/dsigma   = -sign f(y),     da_y/dsigma = sign (df/dy)^T a_y,
//     da_w/dsigma = sign (df/dw)^T a_y (batch-summed),
//     da_t/dsigma = sign a_y . df/dt (batch-summed; time_input only),
//
// over the intervals in reverse: y is reset to the stored forward state
// ys[i] and g[i] is added into a_y at each interval start; every step takes
// all stages of the tableau (the MLP forward and its hand-written VJP in
// each) and updates y and a_y Kahan-compensated. ay0 = a_y + g[0] at the
// end; stats are nfe = stages n_sub (T - 1), steps = n_sub (T - 1), 0, 0.
//
// Design. Nothing in a fixed step reads the parameter or a_t quadratures,
// so the batch never has to meet during the sweep. One thread owns one
// sample for the whole sweep, over as many blocks as the batch needs, with
// no barrier until the end. Each sample accumulates its own share of the
// quadratures: per step, sum_j (h b_j) (sign x_j) over the stages in
// order (the stage combine of the reference), then added to its running
// sum. The batch sums come once, at the end, in one fixed order with no
// atomics: within a block a shared-memory tree over its threads
// (mlp_rk.cuh block_sum), across blocks a second, small launch that adds
// the block sums in block order. ops/cuda_fixed.py:
// mlp_adjoint_solve_fixed_plain repeats that order, so the two agree to
// roundoff in float64, and every run gives the same bits.
//
// The per-sample quadrature (n_w + time_input values: 252 at the spiral,
// 604 at the latent ODE) is too large for registers and has no static
// bound, so it lives in the device workspace with the rest of the sample's
// state, feature-major ([row][B]: a warp touches 32 consecutive values):
// y, a_y, their compensations and stage derivatives, each layer's inputs
// and act'(z), and the step's and the running quadrature sums. The weights
// sit in shared memory; the layer vectors in per-thread local memory.
//
// Bound on the H100. Per stage, each thread walks its sample's MLP forward
// and VJP (about 800 flops at the spiral) and reads and writes its 2 n_w
// quadrature values (the step sum, then once a step the running sum): at
// the spiral, 4096 x 252 values a stage, L2-resident. With one sample a
// thread there are only 128 warps at B = 4096, so the sweep is bound by
// the latency of each thread's dependent chain and of its workspace
// accesses, not by the card's arithmetic or bandwidth. Several samples a
// thread, or a warp across a sample's hidden units, is the way to more
// throughput.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth or weights past shared memory, the per-thread vectors of 512
// values in local memory and the weights read from global memory (L2).
#include "mlp_rk.cuh"

namespace tfd {

template <typename T>
struct FixedAdjScalars {
  T sign;
  int T_obs, B, D, n_sub;
};

template <typename T, int kRoute>
__global__ void mlp_adjoint_fixed_kernel(
    const T* __restrict__ tau, const T* __restrict__ ys,
    const T* __restrict__ g, const T* __restrict__ wg,
    T* __restrict__ ay0_out, T* __restrict__ partial, T* __restrict__ work,
    int n_weights, Net net_in, AugRows rows_in, Tableau<T> tab_in,
    FixedAdjScalars<T> sc) {
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

  const int T_obs = sc.T_obs, B = sc.B, D = sc.D, n_sub = sc.n_sub;
  const int L = net.n_layers, S = tab.S, ti = net.time_input;
  const int R = n_w + ti;                 // quadrature values a sample
  const long BD = long(B) * D;
  int n_h = 0, n_z = 0;
  for (int l = 0; l < L; ++l) {
    n_h += net.din[l];
    n_z += net.dout[l];
  }
  // Feature-major workspace rows of B values each.
  T* Y = work;                      // [D] y
  T* AY = Y + BD;                   // [D] a_y
  T* CY = AY + BD;                  // [D] Kahan compensation of y
  T* CAY = CY + BD;                 // [D] ... and of a_y
  T* KY = CAY + BD;                 // [S][D] stage derivatives of y
  T* KAY = KY + S * BD;             // [S][D] ... and of a_y
  T* H = KAY + S * BD;              // [n_h] each layer's inputs
  T* G = H + long(n_h) * B;         // [n_z] act'(z) of each layer
  T* STEP = G + long(n_z) * B;      // [R] this step's quadrature
  T* ACC = STEP + long(R) * B;      // [R] the running quadrature

  const int b = blockIdx.x * blockDim.x + tid;
  const bool mine = b < B;          // idle threads still meet at the end
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  constexpr int kW = vec_width<kRoute>();
  T ya[kW], aya[kW], buf_a[kW], buf_b[kW];
  const T sf = sc.sign;
  int first_b = 0;                  // first stage with a nonzero weight
  while (tab.b_sol[first_b] == T(0)) ++first_b;

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
    const T s_start = -tau[i];
    const T h = (-tau[i - 1] - s_start) / T(n_sub);
    for (int j = 0; j < n_sub; ++j) {
      const T s = s_start + h * T(j);
      for (int st = 0; st < S; ++st) {
        aug_stage_state(tab, st, h, Y, AY, KY, KAY, ya, aya, D, B, b);
        // The MLP forward and its VJP; this stage's weighted quadrature
        // term, (h b_st) (sign x), joins the step's sum in stage order.
        aug_stage(net, rows, w, (-sf) * (s + tab.c[st] * h), ya, aya, buf_a,
                  buf_b, H, G, KY + long(st) * BD, KAY + long(st) * BD, STEP,
                  B, b, sf, h * tab.b_sol[st], tab.b_sol[st] != T(0),
                  st == first_b);
      }
      aug_kahan_update(tab, h, Y, AY, CY, CAY, KY, KAY, D, B, b);
      for (int r = 0; r < R; ++r) ACC[at(r)] = ACC[at(r)] + STEP[at(r)];
    }
  }
  if (mine) {
    for (int d = 0; d < D; ++d) {
      const long k = long(b) * D + d;
      ay0_out[k] = AY[at(d)] + g[k];
    }
  }
  // The block's sums of the per-sample quadratures, in block_sum's tree.
  for (int r = 0; r < R; ++r) {
    const T total = block_sum(mine ? ACC[at(r)] : T(0), red);
    if (tid == 0) partial[long(blockIdx.x) * R + r] = total;
  }
}

// Workspace values the sweep needs; ops/cuda_fixed.py:_adjoint_work_size
// allocates the same count.
inline long fixed_adjoint_work_size(const Net& net, int n_w, int S, int B,
                                    int D) {
  const long rows = (4 + 2 * long(S)) * D + aug_rows_count(net) +
                    2 * long(n_w + net.time_input);
  return rows * B;
}

template <typename T>
int launch_adjoint_fixed(const void* tau, const void* ys, const void* g,
                         const void* weights, void* ay0, void* aw, void* at,
                         void* stats, void* partial, void* work,
                         long work_size, int T_obs, int B, int D,
                         int threads, int n_sub, double sign, int n_layers,
                         const int* dims, int act_hidden, int act_final,
                         int input_power, int time_input, int stages,
                         const double* c, const double* a,
                         const double* b_sol, int route, void* stream) {
  if (stages < 1 || stages > kMaxStages || T_obs < 1 || B < 1 || D < 1 ||
      n_sub < 1 || D + time_input > kMaxWidth || input_power < 1 ||
      threads < 32 || threads > 1024 || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int n_w = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (n_w < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  if (work_size < fixed_adjoint_work_size(net, n_w, stages, B, D))
    return static_cast<int>(cudaErrorInvalidValue);
  bool any = false;
  for (int i = 0; i < stages; ++i) any = any || b_sol[i] != 0.0;
  if (!any) return static_cast<int>(cudaErrorInvalidValue);
  const AugRows rows = make_aug_rows(net);
  // Fixed tableaus have no error weights: b_sol stands in for b_err.
  const Tableau<T> tab =
      make_tableau<T>(stages, 0, 0, c, a, b_sol, b_sol, nullptr);
  FixedAdjScalars<T> sc;
  sc.sign = T(sign);
  sc.T_obs = T_obs;
  sc.B = B;
  sc.D = D;
  sc.n_sub = n_sub;

  const bool narrow = route == kRouteNarrow;
  const size_t smem = sizeof(T) * ((narrow ? size_t(n_w) : 0) + threads);
  auto kernel = narrow ? mlp_adjoint_fixed_kernel<T, kRouteNarrow>
                       : mlp_adjoint_fixed_kernel<T, kRouteWide>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const T*>(tau), static_cast<const T*>(ys),
      static_cast<const T*>(g), static_cast<const T*>(weights),
      static_cast<T*>(ay0), static_cast<T*>(partial), static_cast<T*>(work),
      n_w, net, rows, tab, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = n_w + time_input;
  const int steps = n_sub * (T_obs - 1);
  quadrature_reduce_kernel<T><<<(R + 127) / 128, 128, 0, st>>>(
      static_cast<const T*>(partial), blocks, n_w, time_input,
      static_cast<T*>(aw), static_cast<T*>(at), static_cast<int*>(stats),
      stages * steps, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfd

#define TFD_ADJOINT_FIXED_ENTRY(NAME, TYPE)                                  \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* weights,  \
      void* ay0, void* aw, void* at, void* stats, void* partial,            \
      void* work, long work_size, int T_obs, int B, int D, int threads,     \
      int n_sub, double sign, int n_layers, const int* dims,                \
      int act_hidden, int act_final, int input_power, int time_input,       \
      int stages, const double* c, const double* a, const double* b_sol,    \
      int route, void* stream) {                                             \
    return tfd::launch_adjoint_fixed<TYPE>(                                  \
        tau, ys, g, weights, ay0, aw, at, stats, partial, work, work_size,  \
        T_obs, B, D, threads, n_sub, sign, n_layers, dims, act_hidden,      \
        act_final, input_power, time_input, stages, c, a, b_sol, route,     \
        stream);                                                             \
  }

TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f32, float)
TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f64, double)
