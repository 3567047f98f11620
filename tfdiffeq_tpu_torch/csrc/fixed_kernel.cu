// K8: a whole fixed-grid explicit-RK solve (euler, midpoint, rk4, rk4_38)
// of an MLP neural ODE in one launch.
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

namespace tfd {

// The batch route's block: threads, and samples (a multiple of 16; the
// per-thread routes' block, ops/cuda_fixed.py:FIXED_THREADS).
constexpr int kFixedBatchThreads = 256;
constexpr int kFixedSamples = 64;

template <typename T>
struct FixedScalars {
  T sign;
  int valid, G, T_out, B, D;
};

template <typename T, int kRoute>
__global__ void mlp_solve_fixed_kernel(
    const T* __restrict__ grid_g, const T* __restrict__ tau_g,
    const T* __restrict__ y0g, const T* __restrict__ f0g,
    const T* __restrict__ wg, T* __restrict__ out, int* __restrict__ stats,
    T* __restrict__ work, BatchBufs<T> bb, int n_weights, Net net_in,
    Tableau<T> tab_in, FixedScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Net net;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  const T* w;   // [n_weights]
  T* grid;      // [G]
  if constexpr (kRoute == kRouteNarrow) {
    T* ws = reinterpret_cast<T*>(smem_raw);
    for (int i = tid; i < n_weights; i += blockDim.x) ws[i] = wg[i];
    w = ws;
    grid = ws + n_weights;
  } else {
    w = wg;
    grid = reinterpret_cast<T*>(smem_raw);
  }
  T* tau = grid + sc.G;                   // [T_out]
  if (tid == 0) {
    net = net_in;
    tab = tab_in;
  }
  for (int i = tid; i < sc.G; i += blockDim.x) grid[i] = grid_g[i];
  for (int i = tid; i < sc.T_out; i += blockDim.x) tau[i] = tau_g[i];
  // The batch route's block owns kFixedSamples rows of the workspace.
  const int spb = kRoute == kRouteBatch ? kFixedSamples : blockDim.x;
  const int row0 = blockIdx.x * spb;
  if constexpr (kRoute == kRouteBatch) batch_clear(bb, row0, spb);
  __syncthreads();

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D, S = tab.S;
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = sc.valid ? 1 + S * (G - 1) : 0;
    stats[1] = sc.valid ? G - 1 : 0;
    stats[2] = 0;
    stats[3] = sc.valid ? 0 : 3;
  }
  const int b = row0 + tid;
  const bool mine = tid < spb && b < B;
  if constexpr (kRoute != kRouteBatch) {
    if (!mine) return;  // no barrier follows
  }

  const long BD = long(B) * D;
  // Feature-major workspace rows of B values: row d of Y is y[d].
  T* Y = work;             // state
  T* C = Y + BD;           // Kahan compensation
  T* F = C + BD;           // f(t0, y0): stage 0, chained
  T* Y0 = F + BD;          // the step's start state (Hermite drain)
  T* K = Y0 + BD;          // stages 1 .. S - 1
  // This sample's value in workspace row `row`.
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  T h_a[vec_width<kRoute>()], h_b[vec_width<kRoute>()];
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless a step writes it
  // (pallas_fixed.py:125-126).
  for (int d = 0; mine && d < D; ++d) {
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[at(d)] = y0g[i];
    F[at(d)] = f0g[i];
    C[at(d)] = T(0);
  }
  if (!sc.valid) return;  // the same in every thread

  int oi = 1;
  for (int step = 0; step + 1 < G; ++step) {
    const T t0 = grid[step];
    const T t1 = grid[step + 1];
    const T dt = t1 - t0;
    // pallas_fixed.py:_fixed_stage_walk: yi = yi + (dt * a_ij) * k_j.
    auto stage_state = [&](int i, int d) {
      T v = Y[at(d)];
      for (int j = 0; j < i; ++j) {
        const T a = tab.a[i][j];
        if (a != T(0)) {
          const T kj = j == 0 ? F[at(d)] : K[at((j - 1) * D + d)];
          v = v + (dt * a) * kj;
        }
      }
      return v;
    };
    // The solution combine and the Kahan-compensated update; returns y1.
    auto update = [&](int d) {
      T delta = T(0);
      bool first = true;
      for (int j = 0; j < S; ++j) {
        if (tab.b_sol[j] != T(0)) {
          const T kj = j == 0 ? F[at(d)] : K[at((j - 1) * D + d)];
          const T term = (dt * tab.b_sol[j]) * kj;
          delta = first ? term : delta + term;
          first = false;
        }
      }
      const T y0 = Y[at(d)];
      const T adj = delta - C[at(d)];
      const T y1 = y0 + adj;
      C[at(d)] = (y1 - y0) - adj;
      Y[at(d)] = y1;
      Y0[at(d)] = y0;
      return y1;
    };
    const T* fo;     // f(t1, y1) of this thread's sample
    if constexpr (kRoute != kRouteBatch) {
      for (int i = 1; i < S; ++i) {
        for (int d = 0; d < D; ++d) h_a[d] = stage_state(i, d);
        const T ti = t0 + tab.c[i] * dt;
        const T* f = mlp_eval(net, w, sign * ti, h_a, h_b);
        for (int d = 0; d < D; ++d) K[at((i - 1) * D + d)] = sign * f[d];
      }
      for (int d = 0; d < D; ++d) h_a[d] = update(d);
      // The chained end derivative f(t1, y1).
      fo = mlp_eval(net, w, sign * t1, h_a, h_b);
    } else {
      for (int i = 1; i < S; ++i) {
        const T ti = t0 + tab.c[i] * dt;
        if (mine)
          batch_put(bb, net, b, sign * ti,
                    [&](int d) { return stage_state(i, d); });
        __syncthreads();
        const T* f = batch_mlp_eval(net, w, bb, row0, spb) + long(b) * bb.ld;
        for (int d = 0; mine && d < D; ++d)
          K[at((i - 1) * D + d)] = sign * f[d];
      }
      if (mine) batch_put(bb, net, b, sign * t1, update);
      __syncthreads();
      fo = batch_mlp_eval(net, w, bb, row0, spb) + long(b) * bb.ld;
    }
    // Every requested time in (t0, t1]; on the last interval, every one
    // left. The cursor is the same in every thread.
    const bool last = step + 2 == G;
    int oi_new = oi;
    while (oi_new < T_out && (tau[oi_new] <= t1 || last)) ++oi_new;
    for (int d = 0; mine && d < D; ++d) {
      const T f0 = F[at(d)];
      const T f1 = sign * fo[d];
      F[at(d)] = f1;
      const T y0 = Y0[at(d)];
      const T y1 = Y[at(d)];
      const T df0 = dt * f0;
      const T df1 = dt * f1;
      const T cb = T(2) * (y0 - y1) + df0 + df1;
      const T cc = T(3) * (y1 - y0) - T(2) * df0 - df1;
      for (int o = oi; o < oi_new; ++o) {
        const T tj = tau[o];
        const T x = (tj - t0) / dt;
        const T val = ((cb * x + cc) * x + df0) * x + y0;
        out[long(o) * BD + long(b) * D + d] = (tj == t1) ? y1 : val;
      }
    }
    oi = oi_new;
  }
}

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
      sizeof(T) * ((kRoute == kRouteNarrow ? size_t(n_w) : 0) + sc.G +
                   sc.T_out);
  auto kernel = mlp_solve_fixed_kernel<T, kRoute>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int spb = kRoute == kRouteBatch ? kFixedSamples : threads;
  const int blocks = (sc.B + spb - 1) / spb;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(tau),
      static_cast<const T*>(y0), static_cast<const T*>(f0),
      static_cast<const T*>(weights), static_cast<T*>(out),
      static_cast<int*>(stats), static_cast<T*>(work), bb, n_w, net, tab,
      sc);
  return cudaGetLastError();
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
    bb = batch_bufs<T>(batch_work, net, n_w16, rows);
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
