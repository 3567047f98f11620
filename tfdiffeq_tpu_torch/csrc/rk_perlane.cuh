// The body of K5: a whole adaptive explicit-RK solve in one launch, every
// sample under its own step controller, templated on its right-hand side.
//
// Replaces the engine of tfdiffeq_tpu/ops/pallas_kernels.py:929
// (_make_perlane_kernel, with _rk_stages :522, _interp_coeffs :558 and
// _controller_factor :577; launched by perlane_solve_call :1108). Each
// sample keeps its own t, dt, accept decision, counters and status: per
// attempt the stages of the tableau, the RMS error over the sample's D
// features, the clamped I-controller, Kahan accumulation of the state and
// the dense-output drain of every requested time in the accepted interval
// (t, t1] (exactly y_new at t1). A sample stops at t_end, with status 1
// when its attempts reach max_steps before t_end, or status 2 when a
// rejected step falls below dt_min; the rows it never reaches stay zero.
// Invalid times give status 3 on every sample. lane_stats holds each
// sample's nfe, accepted, rejected and status; stats their sums and the
// largest status.
//
// Design. No sample ever reads another's state. One kernel,
// rk_perlane_group_kernel (below), gives each sample a group of threads,
// its slot in shared memory, for the MLP routes (csrc/
// perlane_solve_kernel.cu) and K14's generated plans (csrc/plan_rhs.cuh
// PlanLaneRhs). A sample's threads stop when it is done and drain through
// its own cursor.
//
// Its right-hand side `Rhs` (mlp_rk.cuh MlpLaneRhs, plan_rhs.cuh
// PlanLaneRhs) provides Shared, setup(sh, smem) (copies what it keeps in
// shared memory, no barrier; returns the free shared memory),
// smem_values() and wt_values() (its shares of shared memory and of the
// workspace), walk_values() (the walk's values in a sample's slot, its D
// inputs first) and eval_lanes(sh, t, hin, m, gsz, sync, b, B) (sample b's
// D outputs from the D inputs at hin, member m of gsz).
#pragma once

#include "lane_group.h"
#include "mlp_rk.cuh"

namespace tfd {

template <typename T>
struct PerlaneScalars {
  T rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, valid, T_out, B, D;
  // The group engine's layout (rk_perlane_group_kernel).
  int group;        // threads a sample
  int slot_values;  // a sample's slot (lane_group.h perlane_solve_slot_values)
  int slot_smem;    // the block's slots in shared memory (else `work`)
};

// K5 on the MLP routes: a group of sc.group threads walks one sample under
// its own controller (csrc/lane_group.h), kGroupBlock / sc.group samples a
// block, where one thread walked one sample: at the spiral two samples
// share a warp where 32 did, so a warp waits for the slower of two
// controllers. Groups never wait for one another: every meeting is the
// group's own (GroupSync: __syncwarp over its lanes, a named barrier past
// a warp), and a group past B leaves at once. The members split the
// sample's work: the stages, the combines and the dense-output drain a
// feature a member (d = m, m + group, ...), each evaluation's layers an
// output a member (Rhs::eval_lanes), each sum in the plain version's order.
// The error norm stays the plain version's sum over the features in order
// (ops/cuda_perlane.py _row_sums): each member writes its features'
// squared scaled errors to the slot, and every member, after the group's
// meeting, adds all D of them in feature order from 0, as one thread did,
// and reads every feature's y1 for finiteness; so every member takes the
// same accept decision, step, counters and status, bitwise the plain
// version's. The sample's slot (state, FSAL derivative, compensation,
// increment, midpoint, end derivative, squared errors, stages and the
// walk's values) sits in the block's shared memory after the
// right-hand side's share and the output times where the block's slots fit
// there (about 16 KB at the spiral in float32), else in the workspace.
template <typename T, class Rhs>
__global__ void __launch_bounds__(kGroupBlock, 1)
    rk_perlane_group_kernel(const T* __restrict__ tau_g,
                            const T* __restrict__ y0g,
                            const T* __restrict__ f0g,
                            const T* __restrict__ dt0g, T* __restrict__ out,
                            int* __restrict__ lane_stats,
                            int* __restrict__ stats, T* __restrict__ work,
                            Rhs rhs, Tableau<T> tab_in, PerlaneScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  T* const tau = rhs.setup(rsh, smem_raw);   // [T_out]
  if (tid == 0) tab = tab_in;
  for (int i = tid; i < sc.T_out; i += blockDim.x) tau[i] = tau_g[i];
  __syncthreads();

  const int T_out = sc.T_out, B = sc.B, D = sc.D, S = tab.S;
  const int gsz = sc.group, slot = tid / gsz, m = tid % gsz;
  const int b = blockIdx.x * (blockDim.x / gsz) + slot;
  if (b >= B) return;  // only the group's own members meet from here on
  const GroupSync sync = GroupSync::of(gsz);

  const long BD = long(B) * D;
  const long SV = sc.slot_values;
  // The sample's slot: in the block's shared memory or in the workspace.
  T* const Y = sc.slot_smem ? tau + T_out + slot * SV
                            : work + long(b) * SV;   // [D] state
  T* const F = Y + D;             // [D] derivative at (t, y): FSAL cache
  T* const C = F + D;             // [D] Kahan compensation
  T* const DEL = C + D;           // [D] delta = y1 - y0 of the attempt
  T* const MID = DEL + D;         // [D] dense-output midpoint
  T* const F1 = MID + D;          // [D] f(t1, y1), tableaus not FSAL
  T* const E = F1 + D;            // [D] the squared scaled errors
  T* const K = E + D;             // [S - 1][D] stages 1 .. S - 1
  T* const H = K + (S - 1) * D;   // the walk's values, its D inputs first
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless an accepted step writes it
  // (pallas_kernels.py:975-976).
  for (int d = m; d < D; d += gsz) {
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[d] = y0g[i];
    F[d] = f0g[i];
    C[d] = T(0);
  }

  const T t_start = tau[0];
  const T t_end = tau[T_out - 1];
  const T denom = T(D);
  T t = t_start;
  T dt = dt0g[b];
  int oi = 1, nfe = 0, nacc = 0, nrej = 0;
  int status = (t_end > t_start && sc.valid) ? 0 : 3;

  while (t < t_end && status == 0) {
    const T rem = t_end - t;
    const T dt_eff = d_min(dt, rem);
    const bool is_last = dt >= rem;
    const T t1 = is_last ? t_end : t + dt_eff;
    const T dth = t1 - t;

    // Element d's stage j.
    auto kd = [&](int d) {
      return [&, d](int j) { return j == 0 ? F[d] : K[(j - 1) * D + d]; };
    };
    // Stages: yi = yi + (dt * a_ij) * k_j (pallas_kernels.py:_rk_stages).
    for (int i = 1; i < S; ++i) {
      for (int d = m; d < D; d += gsz)
        H[d] = stage_value(tab, i, dth, Y[d], kd(d));
      const T ti = t + tab.c[i] * dth;
      const T* fo = rhs.eval_lanes(rsh, sign * ti, H, m, gsz, sync, b, B);
      for (int d = m; d < D; d += gsz) K[(i - 1) * D + d] = sign * fo[d];
    }
    // The combines and each feature's squared scaled error; y1 into the
    // walk's input for the end derivative.
    for (int d = m; d < D; d += gsz) {
      const T y0 = Y[d];
      T delta, err, ymid;
      combine_value(tab, dth, y0, kd(d), delta, err, ymid);
      const T y1 = y0 + delta;
      const T scale = sc.atol + sc.rtol * d_max(d_abs(y0), d_abs(y1));
      const T esc = err / scale;
      E[d] = esc * esc;
      DEL[d] = delta;
      MID[d] = ymid;
      H[d] = y1;
    }
    sync();
    // The sample's error over its D features in feature order, and
    // finiteness, by every member from the slot.
    T ss = T(0);
    bool bad = false;
    for (int d = 0; d < D; ++d) {
      ss = ss + E[d];
      bad = bad || !d_finite(H[d]);
    }
    sync();   // read by all before a member writes E or H again
    const T ratio = d_sqrt(ss / denom);
    const bool finite = d_finite(ss) && !bad;
    const bool accept = (ratio <= T(1)) && finite;
    const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                    sc.ifactor, sc.dfactor, tab.order);
    // Rescale the CLAMPED attempted step, as the generic engine does.
    const T dt_next = dth * fac;

    if (accept) {
      if (!tab.fsal) {
        // The end derivative (counted in evals on every attempt).
        const T* fo = rhs.eval_lanes(rsh, sign * t1, H, m, gsz, sync, b, B);
        for (int d = m; d < D; d += gsz) F1[d] = sign * fo[d];
      }
      int oi_new = oi;
      while (oi_new < T_out && tau[oi_new] <= t1) ++oi_new;
      for (int d = m; d < D; d += gsz) {
        const T f1 = tab.fsal ? K[(S - 2) * D + d] : F1[d];
        accept_value(tab, Y[d], C[d], DEL[d], MID[d], F[d], f1, t, t1, dth,
                     tau, oi, oi_new, out, BD, long(b) * D + d);
        F[d] = f1;
      }
      oi = oi_new;
      t = t1;
    }

    // The sample's status rules (pallas_kernels.py:1077-1092).
    nfe += tab.evals;
    nacc += accept ? 1 : 0;
    nrej += accept ? 0 : 1;
    if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
    if (nacc + nrej >= sc.max_steps && t < t_end && status == 0) status = 1;
    dt = dt_next;
  }
  if (m == 0) {
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
}

// K5's group launch: the slots in shared memory where the block's fit
// beside the right-hand side's share and the output times, else in `work`
// (work_size values; lane_group.h group_solve_work_size, then the wide
// route's transposed weights).
template <typename T, class Rhs>
cudaError_t launch_rk_perlane_group(const void* tau, const void* y0,
                                    const void* f0, const void* dt0,
                                    void* out, void* lane_stats, void* stats,
                                    void* work, long work_size,
                                    const Rhs& rhs, int group,
                                    const Tableau<T>& tab,
                                    const PerlaneScalars<T>& sc_in,
                                    cudaStream_t stream) {
  if (!group_size_ok(group)) return cudaErrorInvalidValue;
  PerlaneScalars<T> sc = sc_in;
  sc.group = group;
  sc.slot_values =
      int(perlane_solve_slot_values(tab.S, sc.D, 0) + rhs.walk_values());
  if (work_size <
      group_solve_work_size(sc.slot_values, sc.B, group, rhs.wt_values()))
    return cudaErrorInvalidValue;
  const size_t fixed = sizeof(T) * (rhs.smem_values() + sc.T_out);
  const size_t slots =
      sizeof(T) * size_t(group_samples(group)) * sc.slot_values;
  sc.slot_smem = fixed + slots <= size_t(kLaneSmemBytes);
  const size_t smem = fixed + (sc.slot_smem ? slots : 0);
  cudaError_t e = cudaMemsetAsync(stats, 0, 4 * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  auto kernel = rk_perlane_group_kernel<T, Rhs>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return e;
  const int spb = group_samples(group);
  kernel<<<(sc.B + spb - 1) / spb, kGroupBlock, smem, stream>>>(
      static_cast<const T*>(tau), static_cast<const T*>(y0),
      static_cast<const T*>(f0), static_cast<const T*>(dt0),
      static_cast<T*>(out), static_cast<int*>(lane_stats),
      static_cast<int*>(stats), static_cast<T*>(work), rhs, tab, sc);
  return cudaGetLastError();
}

// K5's tile engine: the block's kTileRows samples in lockstep, for the
// right-hand sides whose evaluation is a tile of rows at once (K4's tiers:
// the MLP's batch route, csrc/perlane_solve_kernel.cu MlpTileRhs, and a
// plan cut at its tiered dots, csrc/plan_rhs.cuh PlanTileRhs). A tensor-core
// tile needs many samples' rows in the same stage, where the group kernel
// above walks each sample's attempts on its own.
//
// Each sample keeps the group kernel's own t, dt, accept decision, counters
// and status (in the block's shared memory, one slot a sample); an attempt
// runs for the samples still active (status 0, t < t_end), the stages of
// all of them evaluated together as one tile. A sample that has finished
// keeps its last row in the tile: a product's output row depends only on
// its own input row, and each output's sum runs over k in order
// (csrc/dot_tiers.cuh), so a masked row changes no other sample's bits,
// counters or status, and every sample takes the steps a solo solve takes.
// Every per-sample and per-element operation is the group kernel's, in its
// order: the stages and combines a (sample, feature) element a thread, the
// error norm one thread a sample summing its features in order from 0. The
// block stops when its last sample is done.
//
// The state, FSAL derivative, compensation, increment, midpoint, end
// derivative, squared errors and stages lie in the workspace feature-major
// ([row][B]: (S + 6) B D values); the output times stay in global memory,
// K4's tiles take the shared memory. Its right-hand side provides Shared,
// Local, setup(sh, lo, smem, row0, nr) (the block's rows, no barrier),
// put_elem(sh, lo, b, d, t, v) (sample b's input d at its time t),
// eval_batch(sh, lo, row0, nr) (after a barrier, by every thread; returns
// after one, sample b's outputs at b * ld() + d) and ld().
constexpr int kTileRows = 16;
constexpr int kTileThreads = 256;

template <typename T>
inline long perlane_tile_values(int S, int B, int D) {
  return long(S + 6) * B * D;
}

template <typename T, class Rhs>
__global__ void __launch_bounds__(kTileThreads, 1)
    rk_perlane_tile_kernel(const T* __restrict__ tau,
                           const T* __restrict__ y0g,
                           const T* __restrict__ f0g,
                           const T* __restrict__ dt0g, T* __restrict__ out,
                           int* __restrict__ lane_stats,
                           int* __restrict__ stats, T* __restrict__ work,
                           Rhs rhs, Tableau<T> tab_in, PerlaneScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ Tableau<T> tab;
  // A slot a sample: its time, step, attempt's end and length, next step,
  // cursor and counters, and the attempt's decisions.
  __shared__ T s_t[kTileRows], s_dt[kTileRows], s_t1[kTileRows],
      s_dth[kTileRows];
  __shared__ int s_oi[kTileRows], s_oi_new[kTileRows], s_nfe[kTileRows],
      s_nacc[kTileRows], s_nrej[kTileRows], s_status[kTileRows],
      s_act[kTileRows], s_accept[kTileRows];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int T_out = sc.T_out, B = sc.B, D = sc.D;
  const int row0 = blockIdx.x * kTileRows;
  const int nr = B - row0 < kTileRows ? B - row0 : kTileRows;  // samples
  typename Rhs::Local lo;
  rhs.setup(rsh, lo, smem_raw, row0, kTileRows);
  if (tid == 0) tab = tab_in;
  const T t_start = tau[0];
  const T t_end = tau[T_out - 1];
  if (tid < kTileRows) {
    s_t[tid] = t_start;
    s_dt[tid] = tid < nr ? dt0g[row0 + tid] : T(1);
    s_oi[tid] = 1;
    s_nfe[tid] = s_nacc[tid] = s_nrej[tid] = 0;
    s_status[tid] = (t_end > t_start && sc.valid) ? 0 : 3;
  }
  __syncthreads();

  const int S = tab.S;
  const long BD = long(B) * D;
  auto at = [B](int row, int b) -> long { return long(row) * B + b; };
  T* const Y = work;          // [D][B] state
  T* const F = Y + BD;        // FSAL derivative
  T* const C = F + BD;        // Kahan compensation
  T* const DEL = C + BD;      // delta of the attempt
  T* const MID = DEL + BD;    // dense-output midpoint
  T* const F1 = MID + BD;     // f(t1, y1), tableaus not FSAL
  T* const E = F1 + BD;       // squared scaled errors
  T* const K = E + BD;        // [S - 1][D][B] stages 1 .. S - 1
  const T sign = sc.sign;
  const int n_el = nr * D;    // (sample, feature) elements, features fastest

  // Row 0 is y0; the rest stays zero unless an accepted step writes it.
  for (int e = tid; e < n_el; e += nth) {
    const int s = e / D, d = e - s * D, b = row0 + s;
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[at(d, b)] = y0g[i];
    F[at(d, b)] = f0g[i];
    C[at(d, b)] = T(0);
  }

  for (;;) {
    // Each sample's attempt (the group kernel's loop head).
    bool mine = false;
    if (tid < nr) {
      const T t = s_t[tid], dt = s_dt[tid];
      mine = t < t_end && s_status[tid] == 0;
      s_act[tid] = mine;
      if (mine) {
        const T rem = t_end - t;
        const T dt_eff = d_min(dt, rem);
        const T t1 = dt >= rem ? t_end : t + dt_eff;
        s_t1[tid] = t1;
        s_dth[tid] = t1 - t;
      }
    }
    if (!__syncthreads_or(mine)) break;

    auto kd = [&](int d, int b) {
      return [&, d, b](int j) {
        return j == 0 ? F[at(d, b)] : K[at((j - 1) * D + d, b)];
      };
    };
    // Stages: the active samples' rows of the tile.
    for (int i = 1; i < S; ++i) {
      for (int e = tid; e < n_el; e += nth) {
        const int s = e / D, d = e - s * D, b = row0 + s;
        if (!s_act[s]) continue;
        const T dth = s_dth[s];
        const T ti = s_t[s] + tab.c[i] * dth;
        rhs.put_elem(rsh, lo, b, d, sign * ti,
                     stage_value(tab, i, dth, Y[at(d, b)], kd(d, b)));
      }
      __syncthreads();
      const T* fo = rhs.eval_batch(rsh, lo, row0, kTileRows);
      const long ld = rhs.ld();
      for (int e = tid; e < n_el; e += nth) {
        const int s = e / D, d = e - s * D, b = row0 + s;
        if (s_act[s]) K[at((i - 1) * D + d, b)] = sign * fo[long(b) * ld + d];
      }
    }
    // The combines and each feature's squared scaled error.
    for (int e = tid; e < n_el; e += nth) {
      const int s = e / D, d = e - s * D, b = row0 + s;
      if (!s_act[s]) continue;
      const T y0 = Y[at(d, b)];
      T delta, err, ymid;
      combine_value(tab, s_dth[s], y0, kd(d, b), delta, err, ymid);
      const T y1 = y0 + delta;
      const T scale = sc.atol + sc.rtol * d_max(d_abs(y0), d_abs(y1));
      const T esc = err / scale;
      E[at(d, b)] = esc * esc;
      DEL[at(d, b)] = delta;
      MID[at(d, b)] = ymid;
    }
    __syncthreads();
    // Each sample's error over its D features in feature order, and its
    // decision, by the thread of its slot.
    bool any_acc = false;
    if (tid < nr && s_act[tid]) {
      const int b = row0 + tid;
      T ss = T(0);
      bool bad = false;
      for (int d = 0; d < D; ++d) {
        ss = ss + E[at(d, b)];
        bad = bad || !d_finite(Y[at(d, b)] + DEL[at(d, b)]);
      }
      const T ratio = d_sqrt(ss / T(D));
      const bool finite = d_finite(ss) && !bad;
      const bool accept = (ratio <= T(1)) && finite;
      const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                      sc.ifactor, sc.dfactor, tab.order);
      const T t1 = s_t1[tid];
      int oi_new = s_oi[tid];
      if (accept)
        while (oi_new < T_out && tau[oi_new] <= t1) ++oi_new;
      s_accept[tid] = accept;
      s_oi_new[tid] = oi_new;
      // The next step from the clamped attempted one (the group kernel's
      // dt_next), kept in s_dth until the counters are updated.
      s_dth[tid] = s_dth[tid] * fac;
      any_acc = accept;
    }
    any_acc = __syncthreads_or(any_acc);
    if (any_acc && !tab.fsal) {
      // The end derivative of the accepting samples (counted in evals on
      // every attempt).
      for (int e = tid; e < n_el; e += nth) {
        const int s = e / D, d = e - s * D, b = row0 + s;
        if (s_act[s] && s_accept[s])
          rhs.put_elem(rsh, lo, b, d, sign * s_t1[s],
                       Y[at(d, b)] + DEL[at(d, b)]);
      }
      __syncthreads();
      const T* fo = rhs.eval_batch(rsh, lo, row0, kTileRows);
      const long ld = rhs.ld();
      for (int e = tid; e < n_el; e += nth) {
        const int s = e / D, d = e - s * D, b = row0 + s;
        if (s_act[s] && s_accept[s])
          F1[at(d, b)] = sign * fo[long(b) * ld + d];
      }
    }
    if (any_acc) {
      for (int e = tid; e < n_el; e += nth) {
        const int s = e / D, d = e - s * D, b = row0 + s;
        if (!(s_act[s] && s_accept[s])) continue;
        const T f1 = tab.fsal ? K[at((S - 2) * D + d, b)] : F1[at(d, b)];
        const T t = s_t[s], t1 = s_t1[s];
        accept_value(tab, Y[at(d, b)], C[at(d, b)], DEL[at(d, b)],
                     MID[at(d, b)], F[at(d, b)], f1, t, t1, t1 - t, tau,
                     s_oi[s], s_oi_new[s], out, BD, long(b) * D + d);
        F[at(d, b)] = f1;
      }
    }
    __syncthreads();
    // The sample's counters and status rules (the group kernel's order).
    if (tid < nr && s_act[tid]) {
      const bool accept = s_accept[tid];
      const T dt_next = s_dth[tid];
      if (accept) {
        s_oi[tid] = s_oi_new[tid];
        s_t[tid] = s_t1[tid];
      }
      s_nfe[tid] += tab.evals;
      s_nacc[tid] += accept ? 1 : 0;
      s_nrej[tid] += accept ? 0 : 1;
      int status = s_status[tid];
      if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
      if (s_nacc[tid] + s_nrej[tid] >= sc.max_steps && s_t[tid] < t_end &&
          status == 0)
        status = 1;
      s_status[tid] = status;
      s_dt[tid] = dt_next;
    }
    __syncthreads();
  }
  if (tid < nr) {
    const int b = row0 + tid;
    lane_stats[b] = s_nfe[tid];
    lane_stats[B + b] = s_nacc[tid];
    lane_stats[2 * B + b] = s_nrej[tid];
    lane_stats[3 * B + b] = s_status[tid];
    atomicAdd(stats, s_nfe[tid]);
    atomicAdd(stats + 1, s_nacc[tid]);
    atomicAdd(stats + 2, s_nrej[tid]);
    atomicMax(stats + 3, s_status[tid]);
  }
}

// K5's tile launch: a block of kTileThreads threads a kTileRows-sample tile,
// `smem` bytes of dynamic shared memory (the right-hand side's tiles);
// `work` holds perlane_tile_values values.
template <typename T, class Rhs>
cudaError_t launch_rk_perlane_tile(const void* tau, const void* y0,
                                   const void* f0, const void* dt0, void* out,
                                   void* lane_stats, void* stats, void* work,
                                   long work_size, const Rhs& rhs,
                                   size_t smem, const Tableau<T>& tab,
                                   const PerlaneScalars<T>& sc,
                                   cudaStream_t stream) {
  if (work_size < perlane_tile_values<T>(tab.S, sc.B, sc.D))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(stats, 0, 4 * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  auto kernel = rk_perlane_tile_kernel<T, Rhs>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<(sc.B + kTileRows - 1) / kTileRows, kTileThreads, smem, stream>>>(
      static_cast<const T*>(tau), static_cast<const T*>(y0),
      static_cast<const T*>(f0), static_cast<const T*>(dt0),
      static_cast<T*>(out), static_cast<int*>(lane_stats),
      static_cast<int*>(stats), static_cast<T*>(work), rhs, tab, sc);
  return cudaGetLastError();
}

// The per-sample controllers' scalars from the host's doubles.
template <typename T>
PerlaneScalars<T> make_perlane_scalars(double rtol, double atol,
                                       double dt_min, double sign,
                                       double safety, double ifactor,
                                       double dfactor, int max_steps,
                                       int valid, int T_out, int B, int D) {
  PerlaneScalars<T> sc{};
  sc.rtol = T(rtol);
  sc.atol = T(atol);
  sc.dt_min = T(dt_min);
  sc.sign = T(sign);
  sc.safety = T(safety);
  sc.ifactor = T(ifactor);
  sc.dfactor = T(dfactor);
  sc.max_steps = max_steps;
  sc.valid = valid;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;
  return sc;
}

}  // namespace tfd
