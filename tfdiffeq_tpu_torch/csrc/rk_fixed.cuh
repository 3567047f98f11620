// The body of K8: a whole fixed-grid explicit-RK solve (euler, midpoint,
// rk4, rk4_38) in one launch, templated on its right-hand side; and its
// output drain (drain_cursor, hermite_drain), which K10 and K12 share with
// load_times.
//
// Replaces the engine of tfdiffeq_tpu/ops/pallas_fixed.py:102
// (_make_fixed_solve_kernel with _fixed_stage_walk :59 and _hermite_drain
// :76; launched by fixed_solve_call :178). Per grid interval: the stages of
// the tableau from the chained derivative f(t0, y0), the Kahan-compensated
// state update, the end derivative f(t1, y1) (the next step's first stage
// and the interval's Hermite end slope, so a step costs `stages`
// evaluations and the solve 1 + stages (G - 1)), and the cubic-Hermite
// drain of every requested time the interval covers through an output
// cursor, the last interval flushing the times that roundoff left past the
// grid's end. Invalid times give status 3 and a zero tail.
//
// Design. A fixed grid has no error norm and no controller, so no sample
// waits for another but through a coupled plan's meets. Two kernels: rk_fixed_group_kernel (below; the
// MLP routes of csrc/fixed_kernel.cu and K14's plans, csrc/plan_rhs.cuh
// PlanLaneRhs) gives each sample a group of threads, its slot in shared
// memory; rk_fixed_kernel evaluates every stage batch-wide, a block's
// samples at once after a barrier: K4's batch route (a block of 16 samples,
// one a thread of its first warp, as many blocks as the batch needs) and a
// coupled plan (csrc/plan_rhs.cuh PlanBlockRhs: the whole batch on one
// block of 512 threads, each thread's samples b = tid, tid + 512, ...,
// the block meeting inside each evaluation). All samples share one grid,
// so the output cursor is the same in every thread. In rk_fixed_kernel
// the grid and the output times sit in shared memory after what the
// right-hand side keeps there, or, where setup returns null (K4's batch
// route, whose tiles take the block's shared memory; a coupled plan whose
// times do not fit), are read from global memory, so that their length is
// not bounded by the tiles. The sample's state, compensation, derivatives
// and stages live in a device workspace laid out feature-major ([row][B]:
// a warp's 32 threads touch 32 consecutive values).
//
// rk_fixed_kernel's right-hand side `Rhs` (csrc/fixed_kernel.cu: K4's
// batch route; csrc/plan_rhs.cuh: a coupled plan) provides Shared and
// Local state; setup(sh, lo, smem, row0, spb), which copies what it keeps
// in shared memory (no barrier) and returns the free shared memory (or
// null: the grid stays in global memory); spb() samples a block,
// put(sh, lo, b, t, get) (sample b's inputs from get(d)) and
// eval_batch(sh, lo, row0, spb), the block's evaluation after a barrier
// (sample b's outputs at b * ld()).
#pragma once

#include "lane_group.h"
#include "mlp_rk.cuh"

namespace tfd {

template <typename T>
struct FixedScalars {
  T sign;
  int valid, G, T_out, B, D;
  // The group engine's layout (rk_fixed_group_kernel).
  int group;        // threads a sample
  int slot_values;  // a sample's slot (lane_group.h fixed_solve_slot_values)
  int slot_smem;    // the block's slots in shared memory (else `work`)
};

// The output cursor (pallas_fixed.py:_hermite_drain's loop bound): past
// `oi`, every requested time in (t0, t1]; on the last interval every one
// left. All samples share the grid, so it is the same in every thread.
template <typename T>
__device__ __forceinline__ int drain_cursor(const T* tau, int oi, int T_out,
                                            T t1, bool last) {
  int o = oi;
  while (o < T_out && (tau[o] <= t1 || last)) ++o;
  return o;
}

// The cubic-Hermite drain of one state element over outputs [oi, oi_new)
// (pallas_fixed.py:76-98): y0, y1 the interval's end values, f0, f1 their
// canonical derivatives, the output element o at out[o * stride + at].
// Shared by K8, K10 and K12.
template <typename T>
__device__ __forceinline__ void hermite_drain(T* __restrict__ out,
                                              const T* tau, int oi,
                                              int oi_new, T t0, T t1, T dt,
                                              T y0, T y1, T f0, T f1,
                                              long stride, long at) {
  const T df0 = dt * f0;
  const T df1 = dt * f1;
  const T cb = T(2) * (y0 - y1) + df0 + df1;
  const T cc = T(3) * (y1 - y0) - T(2) * df0 - df1;
  for (int o = oi; o < oi_new; ++o) {
    const T tj = tau[o];
    const T x = (tj - t0) / dt;
    const T val = ((cb * x + cc) * x + df0) * x + y0;
    out[long(o) * stride + at] = (tj == t1) ? y1 : val;
  }
}

// The step grid and the output times into shared memory (grid at `to`, the
// times after it), every thread of the block taking its share, and whether
// both increase strictly: one block barrier, after which every thread
// returns the same answer. K10 and K12 decide their status 3 here, so that
// their wrappers never copy the times to the host (which would make each
// call wait for the card).
template <typename T>
__device__ __forceinline__ int load_times(const T* __restrict__ grid_g,
                                          const T* __restrict__ tau_g, T* to,
                                          int G, int T_out) {
  int ok = 1;
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    to[i] = grid_g[i];
    if (i > 0 && !(grid_g[i] > grid_g[i - 1])) ok = 0;
  }
  for (int i = threadIdx.x; i < T_out; i += blockDim.x) {
    to[G + i] = tau_g[i];
    if (i > 0 && !(tau_g[i] > tau_g[i - 1])) ok = 0;
  }
  return __syncthreads_and(ok);
}

// The solution combine of one element: sum_j (dt b_sol_j) k(j) over the
// nonzero weights in order, from the first term.
template <typename T, class KGet>
__device__ __forceinline__ T sol_delta(const Tableau<T>& tab, T dt, KGet k) {
  T delta = T(0);
  bool first = true;
  for (int j = 0; j < tab.S; ++j) {
    if (tab.b_sol[j] != T(0)) {
      const T term = (dt * tab.b_sol[j]) * k(j);
      delta = first ? term : delta + term;
      first = false;
    }
  }
  return delta;
}

// The Kahan-compensated update y0 + delta with compensation c (updated);
// returns the new y.
template <typename T>
__device__ __forceinline__ T kahan_step(T y0, T& c, T delta) {
  const T adj = delta - c;
  const T y1 = y0 + adj;
  c = (y1 - y0) - adj;
  return y1;
}

template <typename T, class Rhs>
__global__ void rk_fixed_kernel(const T* __restrict__ grid_g,
                                const T* __restrict__ tau_g,
                                const T* __restrict__ y0g,
                                const T* __restrict__ f0g,
                                T* __restrict__ out, int* __restrict__ stats,
                                T* __restrict__ work, Rhs rhs,
                                Tableau<T> tab_in, FixedScalars<T> sc) {
  static_assert(Rhs::kBatch, "rk_fixed_kernel takes a batch-wide Rhs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  // The block owns Rhs::spb() rows of the workspace, its samples
  // [row0, b_hi); thread tid owns row0 + tid, row0 + tid + nth, ... (K4's
  // route: one sample in each of its first spb threads; a coupled plan: the
  // whole batch on one block).
  const int spb = rhs.spb();
  const int row0 = blockIdx.x * spb;
  typename Rhs::Local lo;
  T* rest = rhs.setup(rsh, lo, smem_raw, row0, spb);
  if (tid == 0) tab = tab_in;
  if (rest) {
    for (int i = tid; i < sc.G; i += nth) rest[i] = grid_g[i];
    for (int i = tid; i < sc.T_out; i += nth) rest[sc.G + i] = tau_g[i];
  }
  const T* grid = rest ? rest : grid_g;               // [G]
  const T* tau = rest ? rest + sc.G : tau_g;          // [T_out]
  __syncthreads();

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D, S = tab.S;
  const int b_hi = row0 + spb < B ? row0 + spb : B;
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = sc.valid ? 1 + S * (G - 1) : 0;
    stats[1] = sc.valid ? G - 1 : 0;
    stats[2] = 0;
    stats[3] = sc.valid ? 0 : 3;
  }

  const long BD = long(B) * D;
  // Feature-major workspace rows of B values: row d of Y is y[d].
  T* Y = work;             // state
  T* C = Y + BD;           // Kahan compensation
  T* F = C + BD;           // f(t0, y0): stage 0, chained
  T* Y0 = F + BD;          // the step's start state (Hermite drain)
  T* K = Y0 + BD;          // stages 1 .. S - 1
  // Sample b's value in workspace row `row`.
  auto at = [B](int row, int b) -> long { return long(row) * B + b; };
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless a step writes it
  // (pallas_fixed.py:125-126).
  for (int b = row0 + tid; b < b_hi; b += nth)
    for (int d = 0; d < D; ++d) {
      const long i = long(b) * D + d;
      out[i] = y0g[i];
      for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
      Y[at(d, b)] = y0g[i];
      F[at(d, b)] = f0g[i];
      C[at(d, b)] = T(0);
    }
  if (!sc.valid) return;  // the same in every thread

  int oi = 1;
  for (int step = 0; step + 1 < G; ++step) {
    const T t0 = grid[step];
    const T t1 = grid[step + 1];
    const T dt = t1 - t0;
    // Element d's stage j of sample b.
    auto kd = [&](int d, int b) {
      return [&, d, b](int j) {
        return j == 0 ? F[at(d, b)] : K[at((j - 1) * D + d, b)];
      };
    };
    // The solution combine and the Kahan-compensated update; returns y1.
    auto update = [&](int d, int b) {
      const T y0 = Y[at(d, b)];
      T c = C[at(d, b)];
      const T y1 = kahan_step(y0, c, sol_delta(tab, dt, kd(d, b)));
      C[at(d, b)] = c;
      Y[at(d, b)] = y1;
      Y0[at(d, b)] = y0;
      return y1;
    };
    // Each stage's evaluation, then the chained end derivative f(t1, y1),
    // batch-wide after a barrier.
    for (int i = 1; i < S; ++i) {
      const T ti = t0 + tab.c[i] * dt;
      for (int b = row0 + tid; b < b_hi; b += nth)
        rhs.put(rsh, lo, b, sign * ti, [&](int d) {
          return stage_value(tab, i, dt, Y[at(d, b)], kd(d, b));
        });
      __syncthreads();
      const T* f = rhs.eval_batch(rsh, lo, row0, spb);
      for (int b = row0 + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d)
          K[at((i - 1) * D + d, b)] = sign * f[long(b) * rhs.ld() + d];
    }
    for (int b = row0 + tid; b < b_hi; b += nth)
      rhs.put(rsh, lo, b, sign * t1, [&](int d) { return update(d, b); });
    __syncthreads();
    const T* fo = rhs.eval_batch(rsh, lo, row0, spb);
    const int oi_new = drain_cursor(tau, oi, T_out, t1, step + 2 == G);
    for (int b = row0 + tid; b < b_hi; b += nth)
      for (int d = 0; d < D; ++d) {
        const T f0 = F[at(d, b)];
        const T f1 = sign * fo[long(b) * rhs.ld() + d];
        F[at(d, b)] = f1;
        hermite_drain(out, tau, oi, oi_new, t0, t1, dt, Y0[at(d, b)],
                      Y[at(d, b)], f0, f1, BD, long(b) * D + d);
      }
    oi = oi_new;
  }
}

template <typename T, class Rhs>
cudaError_t launch_rk_fixed(const void* grid, const void* tau,
                            const void* y0, const void* f0, void* out,
                            void* stats, void* work, const Rhs& rhs,
                            size_t smem, int threads, int spb,
                            const Tableau<T>& tab, const FixedScalars<T>& sc,
                            cudaStream_t stream) {
  auto kernel = rk_fixed_kernel<T, Rhs>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (sc.B + spb - 1) / spb;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(tau),
      static_cast<const T*>(y0), static_cast<const T*>(f0),
      static_cast<T*>(out), static_cast<int*>(stats), static_cast<T*>(work),
      rhs, tab, sc);
  return cudaGetLastError();
}

// K8 on the MLP routes: a group of sc.group threads walks one sample
// (csrc/lane_group.h), kGroupBlock / sc.group samples a block, where one
// thread walked one sample. A fixed grid has no controller and every
// sample takes the same stages on the same grid, so the groups of a block
// run the same instructions; each still meets only its own members
// (GroupSync), so a group past B leaves at once. The members split the
// sample's work: the stage states, the Kahan update and the Hermite drain
// a feature a member (d = m, m + group, ...), each evaluation's layers an
// output a member (Rhs::eval_lanes, mlp_rk.cuh mlp_eval_lanes), each sum
// in the plain version's order, so the same bits. Nothing but the walk
// reads another member's values. The sample's slot (state, compensation,
// chained derivative, step-start state, stages and the walk's values)
// sits in the block's shared memory after the right-hand side's
// share, the grid and the output times, where the block's slots fit
// there (about 15 KB at the spiral in float32), else in the workspace.
//
// The right-hand side `Rhs` (mlp_rk.cuh MlpLaneRhs, plan_rhs.cuh
// PlanLaneRhs) provides Shared, setup(sh, smem) (copies what it keeps in
// shared memory, no barrier; returns the free shared memory),
// smem_values(), wt_values(), walk_values() (the walk's values in the
// slot, its D inputs first) and eval_lanes(sh, t, hin, m, gsz, sync, b, B)
// (sample b's D inputs in hin; returns its D outputs).
template <typename T, class Rhs>
__global__ void __launch_bounds__(kGroupBlock, 1)
    rk_fixed_group_kernel(const T* __restrict__ grid_g,
                          const T* __restrict__ tau_g,
                          const T* __restrict__ y0g,
                          const T* __restrict__ f0g, T* __restrict__ out,
                          int* __restrict__ stats, T* __restrict__ work,
                          Rhs rhs, Tableau<T> tab_in, FixedScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  T* const rest = rhs.setup(rsh, smem_raw);
  if (tid == 0) tab = tab_in;
  for (int i = tid; i < sc.G; i += blockDim.x) rest[i] = grid_g[i];
  for (int i = tid; i < sc.T_out; i += blockDim.x) rest[sc.G + i] = tau_g[i];
  const T* const grid = rest;             // [G]
  const T* const tau = rest + sc.G;       // [T_out]
  __syncthreads();

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D, S = tab.S;
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = sc.valid ? 1 + S * (G - 1) : 0;
    stats[1] = sc.valid ? G - 1 : 0;
    stats[2] = 0;
    stats[3] = sc.valid ? 0 : 3;
  }
  const int gsz = sc.group, slot = tid / gsz, m = tid % gsz;
  const int b = blockIdx.x * (blockDim.x / gsz) + slot;
  if (b >= B) return;  // only the group's own members meet from here on
  const GroupSync sync = GroupSync::of(gsz);

  const long BD = long(B) * D;
  const long SV = sc.slot_values;
  // The sample's slot: in the block's shared memory or in the workspace.
  T* const Y = sc.slot_smem ? rest + sc.G + sc.T_out + slot * SV
                            : work + long(b) * SV;   // [D] state
  T* const C = Y + D;             // [D] Kahan compensation
  T* const F = C + D;             // [D] f(t0, y0): stage 0, chained
  T* const Y0 = F + D;            // [D] the step's start state
  T* const K = Y0 + D;            // [S - 1][D] stages 1 .. S - 1
  T* const H = K + (S - 1) * D;   // the walk's values, its D inputs first
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless a step writes it
  // (pallas_fixed.py:125-126).
  for (int d = m; d < D; d += gsz) {
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[d] = y0g[i];
    F[d] = f0g[i];
    C[d] = T(0);
  }
  if (!sc.valid) return;  // the same in every thread

  int oi = 1;
  for (int step = 0; step + 1 < G; ++step) {
    const T t0 = grid[step];
    const T t1 = grid[step + 1];
    const T dt = t1 - t0;
    // Element d's stage j.
    auto kd = [&](int d) {
      return [&, d](int j) { return j == 0 ? F[d] : K[(j - 1) * D + d]; };
    };
    for (int i = 1; i < S; ++i) {
      for (int d = m; d < D; d += gsz)
        H[d] = stage_value(tab, i, dt, Y[d], kd(d));
      const T ti = t0 + tab.c[i] * dt;
      const T* f = rhs.eval_lanes(rsh, sign * ti, H, m, gsz, sync, b, B);
      for (int d = m; d < D; d += gsz) K[(i - 1) * D + d] = sign * f[d];
    }
    // The solution combine and the Kahan-compensated update.
    for (int d = m; d < D; d += gsz) {
      const T y0 = Y[d];
      const T y1 = kahan_step(y0, C[d], sol_delta(tab, dt, kd(d)));
      Y[d] = y1;
      Y0[d] = y0;
      H[d] = y1;
    }
    // The chained end derivative f(t1, y1).
    const T* fo = rhs.eval_lanes(rsh, sign * t1, H, m, gsz, sync, b, B);
    const int oi_new = drain_cursor(tau, oi, T_out, t1, step + 2 == G);
    for (int d = m; d < D; d += gsz) {
      const T f0 = F[d];
      const T f1 = sign * fo[d];
      F[d] = f1;
      hermite_drain(out, tau, oi, oi_new, t0, t1, dt, Y0[d], Y[d], f0, f1,
                    BD, long(b) * D + d);
    }
    oi = oi_new;
  }
}

// K8's group launch: the slots in shared memory where the block's fit
// beside the right-hand side's share, the grid and the output times, else
// in `work` (work_size values; lane_group.h group_solve_work_size, then
// the wide route's transposed weights).
template <typename T, class Rhs>
cudaError_t launch_rk_fixed_group(const void* grid, const void* tau,
                                  const void* y0, const void* f0, void* out,
                                  void* stats, void* work, long work_size,
                                  const Rhs& rhs, int group,
                                  const Tableau<T>& tab,
                                  const FixedScalars<T>& sc_in,
                                  cudaStream_t stream) {
  if (!group_size_ok(group)) return cudaErrorInvalidValue;
  FixedScalars<T> sc = sc_in;
  sc.group = group;
  sc.slot_values =
      int(fixed_solve_slot_values(tab.S, sc.D, 0) + rhs.walk_values());
  if (work_size <
      group_solve_work_size(sc.slot_values, sc.B, group, rhs.wt_values()))
    return cudaErrorInvalidValue;
  const size_t fixed = sizeof(T) * (rhs.smem_values() + sc.G + sc.T_out);
  const size_t slots =
      sizeof(T) * size_t(group_samples(group)) * sc.slot_values;
  sc.slot_smem = fixed + slots <= size_t(kLaneSmemBytes);
  const size_t smem = fixed + (sc.slot_smem ? slots : 0);
  auto kernel = rk_fixed_group_kernel<T, Rhs>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int spb = group_samples(group);
  kernel<<<(sc.B + spb - 1) / spb, kGroupBlock, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(tau),
      static_cast<const T*>(y0), static_cast<const T*>(f0),
      static_cast<T*>(out), static_cast<int*>(stats), static_cast<T*>(work),
      rhs, tab, sc);
  return cudaGetLastError();
}

}  // namespace tfd
