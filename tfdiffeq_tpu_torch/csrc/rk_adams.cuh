// The body of K10: a whole fixed-step Adams solve (explicit_adams: the AB
// predictor; fixed_adams: AB predictor and AM corrector) in one launch,
// templated on its right-hand side.
//
// Replaces the engine of tfdiffeq_tpu/ops/pallas_fixed.py:512
// (_make_adams_solve_kernel, with _fixed_stage_walk :59 and _hermite_drain
// :76; launched by adams_solve_call :653 from mlp_solve_adams :1090 and
// plan_solve_adams :1143). Per grid interval n:
// - n < max_order - 1: an RK4 step from the chained derivative f_head,
//   then f(t1, y1) (4 evaluations);
// - else the AB predictor sum_j ab[k_eff - 1][j] hist[j] over the history,
//   newest first, k_eff = min(n + 1, max_order); explicit_adams evaluates
//   f(t1, y_pred) (1 evaluation); fixed_adams runs max_iters corrector
//   iterations y_next = y0 + dt (hist_part + g0 f(t1, y_cur)), each with
//   the RMS of (y_next - y_cur) / (atol + rtol max(|y_cur|, |y_next|)) over
//   all B D values and the `done` mask (a converged state stops updating),
//   then f1 = f(t1, y_cur) (max_iters + 1 evaluations);
// - the Kahan-compensated update on the step's increment, the history
//   shift, and K8's cubic-Hermite drain (csrc/rk_fixed.cuh hermite_drain)
//   of every requested time the interval covers (the last interval flushes
//   those that roundoff left past the grid's end).
// Stats are [nfe, G - 1, 0, 0], or [0, 0, 0, 3] with a zero tail for
// times that do not increase. Output is written straight into the
// batch-major [T, B, D] layout.
//
// Reference fault not copied: at max_order = 1 the reference's corrector
// has no history term and fails to trace (pallas_fixed.py:598-605); here
// the history part is 0, the generic engine's arithmetic.
//
// Design. explicit_adams has no batch meet, so it takes K8's layout
// (rk_adams_group_kernel): a group of sc.group threads walks one sample
// (csrc/lane_group.h: 16 on the narrow MLP route and the plan route,
// ops/cuda_fixed.py FIXED_WIDE_GROUP on the wide route), kGroupBlock /
// sc.group samples a 512-thread block, each group meeting only its own
// members (GroupSync), so a group past B leaves at once. The members split
// the sample's work a feature a member (d = m, m + group, ...): the RK4
// bootstrap's stage states and increment, the AB predictor sum (newest
// first, abr[j] in order), the Kahan update, the history shift and the
// Hermite drain; each evaluation's layers an output a member
// (Rhs::eval_lanes). Nothing but the walk reads another member's values.
// The sample's slot (csrc/lane_group.h adams_solve_slot_values: the
// state, its compensation, the step's increment, RK4 stages 1-3, the ring
// of max_order history slabs, then the walk's values, its D inputs first)
// sits in the block's shared memory after the right-hand side's share,
// the grid and the output times where the block's slots fit, else in the
// workspace. fixed_adams meets the batch
// at every corrector iteration (rk_adams_grid_kernel; a coupled plan runs
// both methods there, on one block, each evaluation batch-wide with the
// block meeting at its couplings, csrc/plan_rhs.cuh PlanBlockRhs): a grid
// of n_blocks
// blocks of 512 threads (ops/cuda_kernels.py solve_blocks: one per SM, or
// one a sample for a smaller batch), all resident together (csrc/
// grid_meet.cuh launch_grid; a grid that cannot be is an error, never one
// block instead). Block k owns the contiguous samples [k B / n, (k + 1)
// B / n); the RK4 bootstrap, the predictor, each corrector update and each
// step's finish (the Kahan update, the history shift, the Hermite drain)
// are a sample's own work and wait for no other block. Each evaluation is
// a step of its own: a thread a sample, or for the MLP routes a group of
// threads a sample (mlp_rk.cuh mlp_eval_group, `slots` samples a round, as
// K11's). A sample's state rows (the state, its compensation, y_cur,
// y_next, the history part, the evaluation, the RK4 stages and the ring of
// max_order history slabs, feature-major) sit in the block's shared memory
// when the block's rows fit there (26 values a sample at max_order 4,
// D = 2: 3.2 KB a block at B = 4096 in float32), else in the device
// workspace ([row][B]). The batch meets once a corrector iteration: each
// block's share of the convergence norm's sum is its threads' sums (thread
// i owning b = lo + i, lo + i + 512, ..., each adding its samples' D terms
// in order) in a fixed-order block reduction (mlp_rk.cuh block_sum); every
// block adds the n_blocks shares in block order (grid_shares, its two
// buffers alternating by the meeting's parity, so one grid_sync a meeting)
// and takes the same norm and the same `done`; block 0 writes the stats.
// Both kernels decide status 3 themselves from the times they load
// (rk_fixed.cuh load_times). The plain version (ops/cuda_adams.py
// adams_solve_plain) repeats every operation in this order for any
// n_blocks (n_blocks = 1 is the one-block order before the grid), and the
// libraries are built with --fmad=false, so kernel and plain version give
// the same bits.
//
// The group kernel's right-hand side `Rhs` (mlp_rk.cuh MlpLaneRhs: the MLP
// routes of csrc/adams_kernel.cu; csrc/plan_rhs.cuh PlanLaneRhs: K14's
// generated group walk) is K8's (csrc/rk_fixed.cuh rk_fixed_group_kernel).
// The grid kernel's (mlp_rk.cuh MlpGroupRhs; plan_rhs.cuh PlanRhs)
// evaluates one sample in its thread: Shared and Local state; setup(sh,
// lo, smem), which copies what it keeps in shared memory (no barrier) and
// returns the free shared memory; in(lo), where the D inputs go; and
// eval(sh, lo, t, b, B), sample b's D outputs; with kGroup (the MLP
// routes) also eval_group(sh, t, on, m, gsz, hin) for a group of threads a
// sample (its gw-wide vectors and `slots`, set by the launch); with kBatch
// (plan_rhs.cuh PlanBlockRhs, a coupled plan) put(sh, lo, b, t, get) and
// eval_batch(sh, lo, row0, n) instead, the block's samples at once.
#pragma once

#include "grid_meet.cuh"
#include "rk_fixed.cuh"

namespace tfd {

constexpr int kAdamsMaxOrder = 12;
// Threads of a fixed_adams block (a power of two for block_sum;
// ops/cuda_adams.py ADAMS_THREADS).
constexpr int kAdamsThreads = 512;

// The Adams-Bashforth and Adams-Moulton tables, rows 0 .. max_order - 1 of
// the host's exact doubles rounded to T, row-major [max_order][max_order].
template <typename T>
struct AdamsTables {
  T ab[kAdamsMaxOrder * kAdamsMaxOrder];
  T am[kAdamsMaxOrder * kAdamsMaxOrder];
};

template <typename T>
struct AdamsScalars {
  T sign, rtol, atol;
  int G, T_out, B, D, max_order, max_iters, implicit, nfe;
  int scratch;      // fixed_adams: values of the reduction scratch (and
                    // the group vectors)
  int state_smem;   // fixed_adams: the block's state rows in shared memory
  int group;        // explicit_adams: threads a sample
  int slot_values;  // explicit_adams: a sample's slot
  int slot_smem;    // explicit_adams: the block's slots in shared memory
};

// RK4 (ops/tableaus.py RK4, the same doubles rounded to T): the nodes and
// the solution weights; a = [[1/2], [0, 1/2], [0, 0, 1]].
template <typename T>
struct Rk4 {
  T c[4] = {T(0), T(0.5), T(0.5), T(1.0)};
  T b[4] = {T(1.0 / 6.0), T(1.0 / 3.0), T(1.0 / 3.0), T(1.0 / 6.0)};
};

// The stats of a launch: [nfe, G - 1, 0, 0], or [0, 0, 0, 3] for times
// that do not increase.
__device__ __forceinline__ void adams_stats(int* stats, int valid, int nfe,
                                            int G) {
  stats[0] = valid ? nfe : 0;
  stats[1] = valid ? G - 1 : 0;
  stats[2] = 0;
  stats[3] = valid ? 0 : 3;
}

// explicit_adams: a group of sc.group threads a sample; see the design
// above.
template <typename T, class Rhs>
__global__ void __launch_bounds__(kGroupBlock, 1)
    rk_adams_group_kernel(const T* __restrict__ grid_g,
                          const T* __restrict__ tau_g,
                          const T* __restrict__ y0g,
                          const T* __restrict__ f0g, T* __restrict__ out,
                          int* __restrict__ stats, T* __restrict__ work,
                          Rhs rhs, AdamsTables<T> tables_in,
                          AdamsScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ AdamsTables<T> tab;
  const int tid = threadIdx.x;
  T* const rest = rhs.setup(rsh, smem_raw);
  if (tid == 0) tab = tables_in;
  const int valid = load_times(grid_g, tau_g, rest, sc.G, sc.T_out);
  const T* const grid = rest;             // [G]
  const T* const tau = rest + sc.G;       // [T_out]

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D;
  const int MO = sc.max_order;
  if (blockIdx.x == 0 && tid == 0) adams_stats(stats, valid, sc.nfe, G);
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
  T* const YN = C + D;            // [D] the step's increment
  T* const KS = YN + D;           // [3][D] RK4 stages 1 .. 3
  T* const HIST = KS + 3 * D;     // [MO][D] ring of history slabs
  T* const H = HIST + MO * D;     // the walk's values, its D inputs first
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless a step writes it.
  for (int d = m; d < D; d += gsz) {
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[d] = y0g[i];
    C[d] = T(0);
    HIST[d] = f0g[i];
    for (int j = 1; j < MO; ++j) HIST[j * D + d] = T(0);
  }
  if (!valid) return;  // the same in every thread

  const Rk4<T> rk;
  int head = 0;  // ring slot of hist[0], the newest derivative
  int oi = 1;
  for (int n = 0; n + 1 < G; ++n) {
    const T t0 = grid[n];
    const T t1 = grid[n + 1];
    const T dt = t1 - t0;
    const int oi_new = drain_cursor(tau, oi, T_out, t1, n + 2 == G);
    const int slot_new = (head + MO - 1) % MO;
    // hist[j], feature d.
    auto hist = [&](int j, int d) -> T& {
      return HIST[((head + j) % MO) * D + d];
    };
    if (n < MO - 1) {
      // RK4 bootstrap: yi = y0 + (dt a_ij) k_j over the nonzero a_ij,
      // delta = sum_j (dt b_j) k_j.
      for (int i = 1; i < 4; ++i) {
        for (int d = m; d < D; d += gsz) {
          const T kp = i == 1 ? hist(0, d) : KS[(i - 2) * D + d];
          H[d] = Y[d] + (dt * rk.c[i]) * kp;
        }
        const T* fo = rhs.eval_lanes(rsh, sign * (t0 + rk.c[i] * dt), H, m,
                                     gsz, sync, b, B);
        for (int d = m; d < D; d += gsz) KS[(i - 1) * D + d] = sign * fo[d];
      }
      for (int d = m; d < D; d += gsz) {
        T acc = (dt * rk.b[0]) * hist(0, d);
        for (int i = 1; i < 4; ++i)
          acc = acc + (dt * rk.b[i]) * KS[(i - 1) * D + d];
        YN[d] = acc;
        H[d] = Y[d] + acc;
      }
    } else {
      // f1 = f(t1, y_pred), y_pred = y0 + delta with the increment
      // delta = dt sum_j ab[k_eff - 1][j] hist[j], newest first.
      const int k_eff = n + 1 < MO ? n + 1 : MO;
      const T* abr = tab.ab + (k_eff - 1) * MO;
      for (int d = m; d < D; d += gsz) {
        T acc = abr[0] * hist(0, d);
        for (int j = 1; j < MO; ++j) acc = acc + abr[j] * hist(j, d);
        YN[d] = dt * acc;
        H[d] = Y[d] + YN[d];
      }
    }
    // The step's end: the Kahan update, the history shift (the new slot
    // is the oldest, read already), the Hermite drain.
    const T* fo = rhs.eval_lanes(rsh, sign * t1, H, m, gsz, sync, b, B);
    for (int d = m; d < D; d += gsz) {
      const T f_head = hist(0, d);
      const T y0 = Y[d];
      const T adj = YN[d] - C[d];
      const T y1 = y0 + adj;
      C[d] = (y1 - y0) - adj;
      Y[d] = y1;
      const T f1 = sign * fo[d];
      HIST[slot_new * D + d] = f1;
      hermite_drain(out, tau, oi, oi_new, t0, t1, dt, y0, y1, f_head, f1,
                    BD, long(b) * D + d);
    }
    head = slot_new;
    oi = oi_new;
  }
}

// fixed_adams' state rows of D values a sample: the state, its
// compensation, y_cur, y_next, the history part, the evaluation, the RK4
// stages and the history ring (ops/cuda_adams.py adams_work_size).
inline long adams_grid_rows(int max_order) { return 9 + long(max_order); }

// fixed_adams on a grid of n_blocks blocks; see the design above.
template <typename T, class Rhs>
__global__ void __launch_bounds__(kAdamsThreads, 1)
    rk_adams_grid_kernel(const T* __restrict__ grid_g,
                         const T* __restrict__ tau_g,
                         const T* __restrict__ y0g,
                         const T* __restrict__ f0g, T* __restrict__ out,
                         int* __restrict__ stats, T* __restrict__ work,
                         unsigned char* __restrict__ gwork, Rhs rhs,
                         AdamsTables<T> tables_in, AdamsScalars<T> sc_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ AdamsTables<T> tab;
  __shared__ AdamsScalars<T> sc;
  __shared__ T met[1];   // a meeting's merged sum
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int nb = gridDim.x;
  const int blk = blockIdx.x;
  // The block's samples.
  const int b_lo = int(long(blk) * sc_in.B / nb);
  const int b_hi = int(long(blk + 1) * sc_in.B / nb);
  GridMeet gm{reinterpret_cast<unsigned long long*>(gwork), 0, 0};
  typename Rhs::Local lo;
  T* grid = rhs.setup(rsh, lo, smem_raw);  // [G]
  T* tau = grid + sc_in.G;     // [T_out]
  T* red = tau + sc_in.T_out;  // [scratch]: block_sum, grid_shares, groups
  if (tid == 0) {
    tab = tables_in;
    sc = sc_in;
  }
  const int valid = load_times(grid_g, tau_g, grid, sc_in.G, sc_in.T_out);

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D;
  const int MO = sc.max_order;
  const long BD = long(B) * D;
  if (blk == 0 && tid == 0) adams_stats(stats, valid, sc.nfe, G);
  // Feature-major state rows: in the block's shared memory when they fit
  // (rows of the most samples a block owns, from b_lo), else rows of B
  // values in `work`.
  const bool in_smem = sc.state_smem != 0;
  const long ldb = in_smem ? (long(B) + nb - 1) / nb : long(B);
  const int b0 = in_smem ? b_lo : 0;
  const long RD = ldb * D;
  T* Y = in_smem ? red + sc.scratch : work;   // state
  T* C = Y + RD;            // Kahan compensation
  T* YC = C + RD;           // y_cur (y_pred first); an evaluation's input
  T* YN = YC + RD;          // y_next; then the step's increment
  T* HP = YN + RD;          // the y-independent history part
  T* FE = HP + RD;          // an evaluation's output, sign f
  T* KS = FE + RD;          // RK4 stages 1 .. 3
  T* HIST = KS + 3 * RD;    // ring of max_order slabs of D rows
  auto row = [ldb, b0](long j, int d, int b) -> long {
    return (j + d) * ldb + (b - b0);
  };
  const T sign = sc.sign;

  // sign f(sign t_eval, IN) of every owned sample into OUT: a thread a
  // sample, or (Rhs::kGroup, the MLP routes) a group of gsz threads a
  // sample, `slots` samples a round, the group's vectors in the scratch.
  // Every thread of the block calls it; the rows are read and written
  // after a barrier, so by any thread.
  auto evaluate = [&](const T* IN, T t_eval, T* OUT) {
    if constexpr (Rhs::kGroup) {
      const int slots = rhs.slots;
      const int gsz = nth / slots, m = tid % gsz, slot = tid / gsz;
      T* const g_in = red + long(slot) * 2 * rhs.gw;
      __syncthreads();   // IN was written a thread a sample
      for (int r0 = b_lo; r0 < b_hi; r0 += slots) {
        const int b = r0 + slot;
        const bool on = b < b_hi;
        for (int d = m; on && d < D; d += gsz) g_in[d] = IN[row(0, d, b)];
        __syncthreads();
        const T* fo = rhs.eval_group(rsh, sign * t_eval, on, m, gsz, g_in);
        for (int d = m; on && d < D; d += gsz)
          OUT[row(0, d, b)] = sign * fo[d];
        __syncthreads();
      }
    } else if constexpr (Rhs::kBatch) {
      // A coupled plan on one block (csrc/plan_rhs.cuh PlanBlockRhs): each
      // thread puts its samples' inputs, the block evaluates the batch.
      for (int b = b_lo + tid; b < b_hi; b += nth)
        rhs.put(rsh, lo, b, sign * t_eval,
                [&](int d) { return IN[row(0, d, b)]; });
      __syncthreads();
      const T* fo = rhs.eval_batch(rsh, lo, b_lo, b_hi - b_lo);
      for (int b = b_lo + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d)
          OUT[row(0, d, b)] = sign * fo[long(b) * rhs.ld() + d];
    } else {
      T* h_in = rhs.in(lo);
      for (int b = b_lo + tid; b < b_hi; b += nth) {
        for (int d = 0; d < D; ++d) h_in[d] = IN[row(0, d, b)];
        const T* fo = rhs.eval(rsh, lo, sign * t_eval, b, B);
        for (int d = 0; d < D; ++d) OUT[row(0, d, b)] = sign * fo[d];
      }
    }
  };

  // Row 0 is y0; the rest stays zero unless a step writes it.
  for (int b = b_lo + tid; b < b_hi; b += nth) {
    for (int d = 0; d < D; ++d) {
      const long i = long(b) * D + d;
      out[i] = y0g[i];
      for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
      Y[row(0, d, b)] = y0g[i];
      C[row(0, d, b)] = T(0);
      HIST[row(0, d, b)] = f0g[i];
      for (int j = 1; j < MO; ++j) HIST[row(long(j) * D, d, b)] = T(0);
    }
  }
  if (!valid) return;  // the same in every block: no meeting follows

  const T denom = T(double(D) * double(B));
  const Rk4<T> rk;
  int head = 0;  // ring slot of hist[0], the newest derivative
  int oi = 1;
  for (int n = 0; n + 1 < G; ++n) {
    const T t0 = grid[n];
    const T t1 = grid[n + 1];
    const T dt = t1 - t0;
    const int oi_new = drain_cursor(tau, oi, T_out, t1, n + 2 == G);
    const int slot_new = (head + MO - 1) % MO;
    // Row of hist[j], feature d, sample b.
    auto hrow = [&](int j, int d, int b) -> long {
      return row(long((head + j) % MO) * D, d, b);
    };
    if (n < MO - 1) {
      // RK4 bootstrap: yi = y0 + (dt a_ij) k_j over the nonzero a_ij,
      // delta = sum_j (dt b_j) k_j (the increment, kept in YN).
      for (int i = 1; i < 4; ++i) {
        for (int b = b_lo + tid; b < b_hi; b += nth)
          for (int d = 0; d < D; ++d) {
            const T kp = i == 1 ? HIST[hrow(0, d, b)]
                                : KS[row(long(i - 2) * D, d, b)];
            YC[row(0, d, b)] = Y[row(0, d, b)] + (dt * rk.c[i]) * kp;
          }
        evaluate(YC, t0 + rk.c[i] * dt, KS + (i - 1) * RD);
      }
      for (int b = b_lo + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d) {
          T acc = (dt * rk.b[0]) * HIST[hrow(0, d, b)];
          for (int i = 1; i < 4; ++i)
            acc = acc + (dt * rk.b[i]) * KS[row(long(i - 1) * D, d, b)];
          YN[row(0, d, b)] = acc;
          YC[row(0, d, b)] = Y[row(0, d, b)] + acc;
        }
    } else if (!sc.implicit) {
      // explicit_adams (a coupled plan's one block): the increment
      // delta = dt sum_j ab[k_eff - 1][j] hist[j], newest first, kept in
      // YN, and f1 = f(t1, y0 + delta) below, as rk_adams_group_kernel.
      const int k_eff = n + 1 < MO ? n + 1 : MO;
      const T* abr = tab.ab + (k_eff - 1) * MO;
      for (int b = b_lo + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d) {
          T acc = abr[0] * HIST[hrow(0, d, b)];
          for (int j = 1; j < MO; ++j)
            acc = acc + abr[j] * HIST[hrow(j, d, b)];
          const T delta = dt * acc;
          YN[row(0, d, b)] = delta;
          YC[row(0, d, b)] = Y[row(0, d, b)] + delta;
        }
    } else {
      // The predictor y_pred = y0 + dt sum_j ab[k_eff - 1][j] hist[j] and
      // the history part sum_j am[k_eff - 1][j + 1] hist[j], newest first;
      // then the corrector y_next = y0 + dt (hist_part + g0 f(t1, y_cur)).
      const int k_eff = n + 1 < MO ? n + 1 : MO;
      const T* abr = tab.ab + (k_eff - 1) * MO;
      const T* amr = tab.am + (k_eff - 1) * MO;
      const T g0 = amr[0];
      for (int b = b_lo + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d) {
          T hp = T(0);
          if (MO > 1) {
            hp = amr[1] * HIST[hrow(0, d, b)];
            for (int j = 1; j < MO - 1; ++j)
              hp = hp + amr[j + 1] * HIST[hrow(j, d, b)];
          }
          HP[row(0, d, b)] = hp;
          T acc = abr[0] * HIST[hrow(0, d, b)];
          for (int j = 1; j < MO; ++j)
            acc = acc + abr[j] * HIST[hrow(j, d, b)];
          YC[row(0, d, b)] = Y[row(0, d, b)] + dt * acc;
        }
      bool done = false;
      for (int it = 0; it < sc.max_iters; ++it) {
        evaluate(YC, t1, FE);
        T ss = T(0);
        for (int b = b_lo + tid; b < b_hi; b += nth)
          for (int d = 0; d < D; ++d) {
            const long r = row(0, d, b);
            const T y_cur = YC[r];
            const T y_next = Y[r] + dt * (HP[r] + g0 * FE[r]);
            const T scale =
                sc.atol + sc.rtol * d_max(d_abs(y_cur), d_abs(y_next));
            const T esc = (y_next - y_cur) / scale;
            ss = ss + esc * esc;
            YN[r] = y_next;
          }
        // The batch meets: the convergence norm, one decision.
        const T share[1] = {block_sum(ss, red)};
        grid_shares(gm, gwork, share, met, red);
        const T norm = d_sqrt(met[0] / denom);
        if (!done)
          for (int b = b_lo + tid; b < b_hi; b += nth)
            for (int d = 0; d < D; ++d) YC[row(0, d, b)] = YN[row(0, d, b)];
        done = done || norm <= T(1);
      }
      // The increment y_cur - y0, kept in YN.
      for (int b = b_lo + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d)
          YN[row(0, d, b)] = YC[row(0, d, b)] - Y[row(0, d, b)];
    }
    // The step's end f1 = f(t1, YC): the Kahan update, the history shift
    // (the new slot is the oldest, read already), the Hermite drain.
    evaluate(YC, t1, FE);
    for (int b = b_lo + tid; b < b_hi; b += nth)
      for (int d = 0; d < D; ++d) {
        const long r = row(0, d, b);
        const T f_head = HIST[hrow(0, d, b)];
        const T y0 = Y[r];
        const T adj = YN[r] - C[r];
        const T y1 = y0 + adj;
        C[r] = (y1 - y0) - adj;
        Y[r] = y1;
        const T f1 = FE[r];
        HIST[row(long(slot_new) * D, d, b)] = f1;
        hermite_drain(out, tau, oi, oi_new, t0, t1, dt, y0, y1, f_head, f1,
                      BD, long(b) * D + d);
      }
    head = slot_new;
    oi = oi_new;
  }
}

// The launch arguments' checks that do not depend on the right-hand side.
inline bool adams_args_ok(int G, int T_out, int B, int D, int max_order,
                          int max_iters, int threads) {
  return G >= 2 && T_out >= 1 && B >= 1 && D >= 1 && max_order >= 1 &&
         max_order <= kAdamsMaxOrder && max_iters >= 0 && threads >= 32 &&
         threads <= kAdamsThreads && !(threads & (threads - 1));
}

// The tables and scalars of a launch from its arguments.
template <typename T>
AdamsTables<T> make_adams_tables(int max_order, const double* ab,
                                 const double* am) {
  AdamsTables<T> tables;
  for (int i = 0; i < kAdamsMaxOrder * kAdamsMaxOrder; ++i) {
    const bool in = i < max_order * max_order;
    tables.ab[i] = in ? T(ab[i]) : T(0);
    tables.am[i] = in ? T(am[i]) : T(0);
  }
  return tables;
}

template <typename T>
AdamsScalars<T> make_adams_scalars(int G, int T_out, int B, int D,
                                   double sign, double rtol, double atol,
                                   int max_order, int max_iters,
                                   int implicit, int nfe) {
  AdamsScalars<T> sc;
  sc.sign = T(sign);
  sc.rtol = T(rtol);
  sc.atol = T(atol);
  sc.G = G;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;
  sc.max_order = max_order;
  sc.max_iters = max_iters;
  sc.implicit = implicit;
  sc.nfe = nfe;
  sc.scratch = 0;
  sc.state_smem = 0;
  sc.group = 0;
  sc.slot_values = 0;
  sc.slot_smem = 0;
  return sc;
}

// Bytes of fixed_adams' grid workspace: the meetings' counter and the two
// share buffers of one value a block.
inline long rk_adams_grid_bytes(int n_blocks, long item) {
  return grid_shares_bytes(n_blocks, 1, item);
}

// Shared memory a fixed_adams block's right-hand side, grid and output
// times may take beside the reduction scratch (ops/cuda_kernels.py
// MAX_WEIGHT_BYTES); the grouped walk's slots and the block's state rows
// take what they leave.
constexpr long kAdamsSmemBytes = 220L * 1024;

// One launch of fixed_adams' K10 with `rhs`, or an error. `fixed` is the
// bytes the right-hand side keeps in shared memory (its setup); the launch
// adds the grid and output times. n_blocks blocks of `threads` threads,
// all resident together (launch_grid), with the reduction scratch (grown
// for the grouped walk's slots, Rhs::kGroup) and, when they fit, the
// block's state rows (layout[2]; layout[0] and [1], explicit_adams' group
// and samples a block, are 0).
template <typename T, class Rhs>
cudaError_t launch_rk_adams(const void* grid, const void* tau, const void* y0,
                            const void* f0, void* out, void* stats,
                            void* work, long work_size, void* gwork,
                            long gwork_bytes, int n_blocks, const Rhs& rhs,
                            size_t fixed, int threads,
                            const AdamsTables<T>& tables,
                            const AdamsScalars<T>& sc, int* layout,
                            cudaStream_t stream) {
  const size_t item = sizeof(T);
  const size_t own = fixed + item * (size_t(sc.G) + sc.T_out);
  const T* a_grid = static_cast<const T*>(grid);
  const T* a_tau = static_cast<const T*>(tau);
  const T* a_y0 = static_cast<const T*>(y0);
  const T* a_f0 = static_cast<const T*>(f0);
  T* a_out = static_cast<T*>(out);
  int* a_stats = static_cast<int*>(stats);
  T* a_work = static_cast<T*>(work);
  // explicit_adams takes this kernel with a coupled plan only (Rhs::kBatch,
  // one block); else rk_adams_group_kernel.
  if ((!sc.implicit && !Rhs::kBatch) ||
      work_size < adams_grid_rows(sc.max_order) * long(sc.B) * sc.D)
    return cudaErrorInvalidValue;
  if (n_blocks < 1 || !gwork ||
      gwork_bytes < rk_adams_grid_bytes(n_blocks, item))
    return cudaErrorInvalidValue;
  const size_t budget = size_t(kAdamsSmemBytes) + item * threads;
  const int per_block = (sc.B + n_blocks - 1) / n_blocks;
  Rhs a_rhs = rhs;
  AdamsScalars<T> a_sc = sc;
  size_t scratch = size_t(threads);
  if constexpr (Rhs::kGroup) {
    a_rhs.slots = group_slots(own, budget, threads, 2L * a_rhs.gw,
                              per_block, item);
    if (size_t(2) * a_rhs.slots * a_rhs.gw > scratch)
      scratch = size_t(2) * a_rhs.slots * a_rhs.gw;
  }
  const size_t rows =
      size_t(adams_grid_rows(sc.max_order)) * sc.D * size_t(per_block);
  a_sc.scratch = int(scratch);
  a_sc.state_smem = own + item * (scratch + rows) <= budget;
  const size_t smem = own + item * (scratch + (a_sc.state_smem ? rows : 0));
  layout[0] = 0;
  layout[1] = 0;
  layout[2] = a_sc.state_smem;
  unsigned char* a_gwork = static_cast<unsigned char*>(gwork);
  AdamsTables<T> a_tab = tables;
  void* args[] = {&a_grid, &a_tau,   &a_y0,  &a_f0,  &a_out, &a_stats,
                  &a_work, &a_gwork, &a_rhs, &a_tab, &a_sc};
  return launch_grid(rk_adams_grid_kernel<T, Rhs>, n_blocks, threads, smem,
                     args, gwork, stream);
}

// explicit_adams' group launch: `group` threads a sample (a power of two
// from 16 to kGroupBlock), the slots in shared memory where the block's
// fit beside the right-hand side's share, the grid and the output times,
// else in `work` (work_size values; lane_group.h group_solve_work_size of
// adams_solve_slot_values, then the wide route's transposed weights).
// Reports what it ran: layout = {threads a sample, samples a block, the
// slots in shared memory}.
template <typename T, class Rhs>
cudaError_t launch_rk_adams_group(const void* grid, const void* tau,
                                  const void* y0, const void* f0, void* out,
                                  void* stats, void* work, long work_size,
                                  const Rhs& rhs, int group,
                                  const AdamsTables<T>& tables,
                                  const AdamsScalars<T>& sc_in, int* layout,
                                  cudaStream_t stream) {
  if (sc_in.implicit || !group_size_ok(group)) return cudaErrorInvalidValue;
  AdamsScalars<T> sc = sc_in;
  sc.group = group;
  sc.slot_values = int(
      adams_solve_slot_values(sc.D, sc.max_order, rhs.walk_values()));
  if (work_size <
      group_solve_work_size(sc.slot_values, sc.B, group, rhs.wt_values()))
    return cudaErrorInvalidValue;
  const size_t fixed = sizeof(T) * (rhs.smem_values() + sc.G + sc.T_out);
  const size_t slots =
      sizeof(T) * size_t(group_samples(group)) * sc.slot_values;
  sc.slot_smem = fixed + slots <= size_t(kLaneSmemBytes);
  const size_t smem = fixed + (sc.slot_smem ? slots : 0);
  layout[0] = group;
  layout[1] = group_samples(group);
  layout[2] = sc.slot_smem;
  auto kernel = rk_adams_group_kernel<T, Rhs>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int spb = group_samples(group);
  kernel<<<(sc.B + spb - 1) / spb, kGroupBlock, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(tau),
      static_cast<const T*>(y0), static_cast<const T*>(f0),
      static_cast<T*>(out), static_cast<int*>(stats), static_cast<T*>(work),
      rhs, tables, sc);
  return cudaGetLastError();
}

}  // namespace tfd
