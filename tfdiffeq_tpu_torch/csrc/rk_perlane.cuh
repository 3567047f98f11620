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
