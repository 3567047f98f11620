// The body of K11: a whole variable-coefficient, variable-order
// Adams-Bashforth-Moulton solve (VCABM, method 'adams') in one launch,
// templated on its right-hand side.
//
// Replaces the engine of tfdiffeq_tpu/ops/pallas_vcabm.py:51
// (_make_vcabm_kernel; launched by vcabm_solve_call :312 from
// mlp_solve_vcabm :399 and plan_solve_vcabm :449). Per attempt, in the
// kernel's order (not the generic engine's, where the two differ):
// - the g / beta / c recurrences over orders 1 .. max_order, each entry
//   masked by the live order, a zero denominator replaced by 1 before the
//   divide; the explicit phi rows phi[j] beta_j;
// - the predictor y + dt sum_{j < max(order - 1, 1)} g_j ephi_j, one
//   evaluation f_pred, the implicit phi rows, the corrector at row
//   cidx = max(order - 1, 1), and the RMS error at order k over all B D
//   values with the finiteness flag;
// - on accept: a second evaluation f_next, the errors at orders k - 1,
//   k - 2 and k + 1, the 4-step / order-3 startup and the order choice,
//   "keep dt when raising the order" else the controller at order k + 1,
//   the committed state, phi and prev_t, and the output when the step
//   lands on the next requested time; on reject the controller at order k;
// - the controller factor safety exp((-1/k) log r), r >= 1e-38, clipped
//   to [1, ifactor] on accept and [dfactor, 1] on reject; the statuses
//   DT_UNDERFLOW (2) before MAX_STEPS (1), with max_num_steps counting
//   attempts; 3 with a zero tail for times that do not increase.
// The sentinel prev_t slots are t0 - slot (pallas_vcabm.py:93-95). Stats
// are [nfe, accepted, rejected, status], 2 evaluations an accepted attempt
// and 1 a rejected one. Output is written straight into [T, B, D].
//
// Design. The solve runs on a grid of n_blocks blocks of up to 512 threads
// (ops/cuda_kernels.py solve_blocks: one per SM, or fewer for a small
// batch), all resident together (csrc/grid_meet.cuh launch_grid). Block k
// owns the contiguous samples [k B / n, (k + 1) B / n) and its threads own
// them as b = lo + tid, lo + tid + blockDim.x, ..., walking their phi rows,
// predictor and corrector with no wait for another block. A sample's state
// (y, y_next, the attempt's evaluation and the three divided-difference
// stacks phi, explicit phi and the predictor's implicit phi: 3 + 3
// (max_order + 2) rows of D values, feature-major) sits in the block's
// shared memory when the block's rows fit there (90 values a sample at
// max_order 12, D = 2: 11.5 KB a block at B = 4096 in float32), else in the
// device workspace ([row][B], L2-resident). Each evaluation is a step of
// its own: a thread a sample, or for the MLP routes a group of threads a
// sample (mlp_rk.cuh mlp_eval_group, `slots` samples a round, as K2's).
// The scalar machinery (the c vector, g, beta, prev_t, the order and
// next_t) is computed by every thread of every block identically from the
// same values, unrolled to the largest order so that it stays in
// registers. The batch meets where the shared controller needs a sum over
// it: after the corrector (the error sum at order k and the finiteness
// flag) and, on an accepted attempt, after f_next (the sums of the errors
// at orders k - 1, k - 2 and k + 1, one share of three values). Each
// block's shares are its threads' sums in a fixed-order block reduction
// (mlp_rk.cuh block_sum); every block adds the n_blocks shares in block
// order (grid_shares: two share buffers alternate by the meeting's
// parity, so one grid_sync a meeting) and takes the same decisions; block
// 0 writes the stats. The plain version (ops/cuda_adams.py
// vcabm_solve_plain) repeats every operation in this order for any
// n_blocks (n_blocks = 1 is the one-block order before the grid), and the
// libraries are built with --fmad=false, so the two give the same bits.
// max_order is a launch argument: one binary serves orders 1 .. 12.
//
// The right-hand side `Rhs` (mlp_rk.cuh MlpGroupRhs: the MLP routes of
// csrc/vcabm_kernel.cu; csrc/plan_rhs.cuh PlanRhs: K14's generated plans)
// evaluates one sample in its thread, as csrc/rk_adams.cuh describes, and
// with kGroup (the MLP routes) also eval_group(sh, t, on, m, gsz, hin) for
// a group of threads a sample (its gw-wide vectors and `slots`, set by the
// launch); a coupled plan (plan_rhs.cuh PlanBlockRhs, kBatch) runs on one
// block, every evaluation batch-wide with the block meeting at its
// couplings.
#pragma once

#include "grid_meet.cuh"
#include "mlp_rk.cuh"

namespace tfd {

constexpr int kVcabmMaxOrder = 12;
constexpr int kVcabmK = kVcabmMaxOrder + 2;  // phi rows 0 .. order + 1
// Most threads of a block (a power of two for block_sum;
// ops/cuda_adams.py VCABM_THREADS).
constexpr int kVcabmThreads = 512;

template <typename T>
struct VcabmScalars {
  T dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  T gstar[kVcabmK + 1];  // gamma*_0 .. gamma*_K of the host's doubles
  int max_steps, valid, T_out, B, D, max_order;
  int scratch;     // values of the reduction scratch (and group vectors)
  int state_smem;  // the block's state rows in shared memory (else `work`)
};

// pallas_vcabm.py:optimal_dt: safety exp((-1/k) log r), r clamped to
// 1e-38, k = max(order, 1); ifactor when ratio <= 0; clipped.
template <typename T>
__device__ __forceinline__ T vcabm_dt(T dt, T ratio, int order,
                                      bool accepted, T safety, T ifactor,
                                      T dfactor) {
  const T r = d_max(ratio, T(1e-38));
  const T k = d_max(T(order), T(1));
  T fac = safety * d_exp((T(-1) / k) * d_log(r));
  const T lo = accepted ? T(1) : dfactor;
  const T hi = accepted ? ifactor : T(1);
  fac = ratio <= T(0) ? ifactor : d_min(d_max(fac, lo), hi);
  return dt * fac;
}

// Bytes of K11's grid workspace: the meetings' counter and the two share
// buffers of three values a block.
inline long rk_vcabm_grid_bytes(int n_blocks, long item) {
  return grid_shares_bytes(n_blocks, 3, item);
}

// State rows a sample: y, y_next, the evaluation's output and the three
// phi stacks, D values each.
inline long vcabm_state_rows(int max_order) { return 3 + 3L * (max_order + 2); }

template <typename T, class Rhs>
__global__ void __launch_bounds__(kVcabmThreads, 1)
    rk_vcabm_kernel(const T* __restrict__ tau_g, const T* __restrict__ y0g,
                    const T* __restrict__ f0g, T* __restrict__ out,
                    int* __restrict__ stats, T* __restrict__ work,
                    unsigned char* __restrict__ gwork, Rhs rhs,
                    VcabmScalars<T> sc_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ VcabmScalars<T> sc;
  __shared__ T met[3];   // a meeting's merged sums
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int nb = gridDim.x;
  const int blk = blockIdx.x;
  // The block's samples.
  const int b_lo = int(long(blk) * sc_in.B / nb);
  const int b_hi = int(long(blk + 1) * sc_in.B / nb);
  GridMeet gm{reinterpret_cast<unsigned long long*>(gwork), 0, 0};
  typename Rhs::Local lo;
  T* tau = rhs.setup(rsh, lo, smem_raw);  // [T_out]
  T* red = tau + sc_in.T_out;  // [scratch]: block_sum, grid_shares, groups
  if (tid == 0) sc = sc_in;
  for (int i = tid; i < sc_in.T_out; i += nth) tau[i] = tau_g[i];
  __syncthreads();

  const int T_out = sc.T_out, B = sc.B, D = sc.D;
  const int MO = sc.max_order, K = MO + 2;
  const long BD = long(B) * D;
  // Feature-major state rows: in the block's shared memory when they fit
  // (rows of the most samples a block owns, from b_lo), else rows of B
  // values in `work`.
  const bool in_smem = sc.state_smem != 0;
  const long ldb = in_smem ? (long(B) + nb - 1) / nb : long(B);
  const int b0 = in_smem ? b_lo : 0;
  const long RD = ldb * D;
  T* Y = in_smem ? red + sc.scratch : work;   // state
  T* YN = Y + RD;            // p_next, then y_next of the attempt
  T* FE = YN + RD;           // the attempt's evaluation, sign f
  T* PHI = FE + RD;          // phi rows 0 .. K - 1, D rows each
  T* EPHI = PHI + K * RD;    // explicit phi
  T* PHIP = EPHI + K * RD;   // the predictor's implicit phi
  const T sign = sc.sign;
  auto row = [ldb, b0](int j, int D_, int d, int b) -> long {
    return (long(j) * D_ + d) * ldb + (b - b0);
  };

  // sign f(sign next_t, YN) of every owned sample into FE: a thread a
  // sample, or (Rhs::kGroup, the MLP routes) a group of gsz threads a
  // sample, `slots` samples a round, the group's vectors in the scratch.
  // Every thread of the block calls it.
  auto evaluate = [&](T t_eval) {
    if constexpr (Rhs::kGroup) {
      const int slots = rhs.slots;
      const int gsz = nth / slots, m = tid % gsz, slot = tid / gsz;
      T* const g_in = red + long(slot) * 2 * rhs.gw;
      __syncthreads();   // YN was written a thread a sample
      for (int r0 = b_lo; r0 < b_hi; r0 += slots) {
        const int b = r0 + slot;
        const bool on = b < b_hi;
        for (int d = m; on && d < D; d += gsz) g_in[d] = YN[row(0, 1, d, b)];
        __syncthreads();
        const T* fo = rhs.eval_group(rsh, sign * t_eval, on, m, gsz, g_in);
        for (int d = m; on && d < D; d += gsz)
          FE[row(0, 1, d, b)] = sign * fo[d];
        __syncthreads();
      }
    } else if constexpr (Rhs::kBatch) {
      // A coupled plan on one block (csrc/plan_rhs.cuh PlanBlockRhs): each
      // thread puts its samples' inputs, the block evaluates the batch.
      for (int b = b_lo + tid; b < b_hi; b += nth)
        rhs.put(rsh, lo, b, sign * t_eval,
                [&](int d) { return YN[row(0, 1, d, b)]; });
      __syncthreads();
      const T* fo = rhs.eval_batch(rsh, lo, b_lo, b_hi - b_lo);
      for (int b = b_lo + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d)
          FE[row(0, 1, d, b)] = sign * fo[long(b) * rhs.ld() + d];
    } else {
      T* h_in = rhs.in(lo);
      for (int b = b_lo + tid; b < b_hi; b += nth) {
        for (int d = 0; d < D; ++d) h_in[d] = YN[row(0, 1, d, b)];
        const T* fo = rhs.eval(rsh, lo, sign * t_eval, b, B);
        for (int d = 0; d < D; ++d) FE[row(0, 1, d, b)] = sign * fo[d];
      }
    }
  };

  // Zero fill, y0 in row 0 (pallas_vcabm.py:81-87); each thread its own
  // samples.
  for (int b = b_lo + tid; b < b_hi; b += nth) {
    for (int d = 0; d < D; ++d) {
      const long i = long(b) * D + d;
      out[i] = y0g[i];
      for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
      Y[row(0, 1, d, b)] = y0g[i];
      for (int j = 0; j < K; ++j) {
        PHI[row(j, D, d, b)] = j == 0 ? f0g[i] : T(0);
        EPHI[row(j, D, d, b)] = T(0);
        PHIP[row(j, D, d, b)] = T(0);
      }
    }
  }

  const T denom = T(double(D) * double(B));
  const T t0 = tau[0];
  T prev_t[kVcabmK];
#pragma unroll
  for (int j = 0; j < kVcabmK; ++j) prev_t[j] = j ? t0 - T(double(j)) : t0;
  T next_t_c = t0 + sc.dt0;
  int order = 1, oi = 1, nacc = 0, nrej = 0, nfe = 0;
  int status = sc.valid ? 0 : 3;

  while (oi < T_out && status == 0) {
    const T final_t = tau[oi < T_out - 1 ? oi : T_out - 1];
    const T next_t = d_min(next_t_c, final_t);
    const T curr_t = prev_t[0];
    const T dt = next_t - curr_t;

    // ---- g / beta recurrences (pallas_vcabm.py:122-146), unrolled to the
    // largest order so that the vectors stay in registers; entries past
    // the live K and max_order take no part.
    T cvec[kVcabmK + 1];
#pragma unroll
    for (int i = 0; i <= kVcabmK; ++i) cvec[i] = T(1.0 / double(i + 1));
    T g[kVcabmK];
    T betas[kVcabmK];  // beta_j of explicit phi row j, for j < order
    g[0] = T(1);
    betas[0] = T(1);
    T beta = T(1);
#pragma unroll
    for (int j = 1; j <= kVcabmMaxOrder; ++j) {
      if (j <= MO && j <= order) {
        const T den = next_t - prev_t[j - 1];
        const T factor = dt / (den == T(0) ? T(1) : den);
#pragma unroll
        for (int i = 0; i <= kVcabmK; ++i)
          if (i <= K)
            cvec[i] = cvec[i] - (i < K ? cvec[i + 1 <= kVcabmK ? i + 1 : i]
                                       : cvec[i]) * factor;
        g[j] = cvec[0];
      } else {
        g[j] = T(0);
      }
      if (j <= MO && j < order) {
        const T den = curr_t - prev_t[j];
        beta = beta * ((next_t - prev_t[j - 1]) / (den == T(0) ? T(1) : den));
        betas[j] = beta;
      } else {
        betas[j] = T(0);
      }
    }
    g[kVcabmK - 1] = T(0);
    g[MO + 1] = T(0);  // never selected (order <= max_order)
    const int n_pred = order - 1 > 1 ? order - 1 : 1;
    const int om1 = order - 1 > 0 ? order - 1 : 0;
    const int cidx = order - 1 > 1 ? order - 1 : 1;
    const T c_corr = dt * g[cidx];
    const T c_err = dt * (g[order] - g[om1]);

    // ---- phase 1: explicit phi and the predictor of each owned sample,
    // f_pred, then the implicit phi, the corrector and the error at order
    // k.
    for (int b = b_lo + tid; b < b_hi; b += nth) {
      for (int d = 0; d < D; ++d) {
        EPHI[row(0, D, d, b)] = PHI[row(0, D, d, b)];
        for (int j = 1; j <= MO; ++j)
          EPHI[row(j, D, d, b)] =
              j < order ? PHI[row(j, D, d, b)] * betas[j] : T(0);
        T acc = (0 < n_pred ? g[0] : T(0)) * EPHI[row(0, D, d, b)];
        for (int j = 1; j < MO; ++j)
          acc = acc + (j < n_pred ? g[j] : T(0)) * EPHI[row(j, D, d, b)];
        YN[row(0, 1, d, b)] = Y[row(0, 1, d, b)] + dt * acc;
      }
    }
    evaluate(next_t);
    T ss = T(0);
    bool bad = false;
    for (int b = b_lo + tid; b < b_hi; b += nth) {
      for (int d = 0; d < D; ++d) {
        const T fp = FE[row(0, 1, d, b)];
        T run = T(0);
        for (int j = 0; j < K; ++j) {
          PHIP[row(j, D, d, b)] = j < order + 1 ? fp - run : T(0);
          if (j < K - 1) run = run + EPHI[row(j, D, d, b)];
        }
        const long r = row(0, 1, d, b);
        const T yn = YN[r] + c_corr * PHIP[row(cidx, D, d, b)];
        YN[r] = yn;
        const T scale = sc.atol + sc.rtol * d_max(d_abs(Y[r]), d_abs(yn));
        const T esc = (c_err * PHIP[row(order, D, d, b)]) / scale;
        ss = ss + esc * esc;
        bad = bad || !d_finite(yn);
      }
    }

    // ---- the batch meets: error at order k, finiteness, one decision.
    const bool blk_bad = __syncthreads_or(bad);
    const T share1[2] = {block_sum(ss, red), blk_bad ? T(1) : T(0)};
    grid_shares(gm, gwork, share1, met, red);
    const bool any_bad = met[1] != T(0);
    const T error_k = d_sqrt(met[0] / denom);
    const bool finite = d_finite(error_k) && !any_bad;
    const bool accept = error_k <= T(1) && finite;
    const T error_ctrl = finite ? error_k : T(1048576.0);  // 2 ** 20
    const bool hit = accept && next_t >= final_t;

    int next_order = order;
    T dt_acc = dt;
    if (accept) {
      // ---- phase 2: f_next, the errors at orders k - 1, k - 2, k + 1,
      // and the commit of each owned sample.
      const int om2 = order - 2 > 0 ? order - 2 : 0;
      const int om3 = order - 3 > 0 ? order - 3 : 0;
      const T c_km1 = dt * (g[om1] - g[om2]);
      const T c_km2 = dt * (g[om2] - g[om3]);
      const T c_kp1 = dt * sc.gstar[order];
      evaluate(next_t);
      T s1 = T(0), s2 = T(0), s3 = T(0);
      for (int b = b_lo + tid; b < b_hi; b += nth) {
        for (int d = 0; d < D; ++d) {
          const long r = row(0, 1, d, b);
          const T yn = YN[r];
          const T scale = sc.atol + sc.rtol * d_max(d_abs(Y[r]), d_abs(yn));
          const T e1 = (c_km1 * PHIP[row(om1, D, d, b)]) / scale;
          const T e2 = (c_km2 * PHIP[row(om2, D, d, b)]) / scale;
          s1 = s1 + e1 * e1;
          s2 = s2 + e2 * e2;
          // The new phi rows f_next - sum_{i<j} ephi_i, j < order + 2; row
          // `order` also feeds the error at order k + 1.
          const T fn = FE[r];
          T run = T(0);
          for (int j = 0; j < K; ++j) {
            const T v = j < order + 2 ? fn - run : T(0);
            if (j == order) {
              const T e3 = (c_kp1 * v) / scale;
              s3 = s3 + e3 * e3;
            }
            PHI[row(j, D, d, b)] = v;
            if (j < K - 1) run = run + EPHI[row(j, D, d, b)];
          }
          Y[r] = yn;
          if (hit) out[long(oi) * BD + long(b) * D + d] = yn;
        }
      }
      // ---- the batch meets again: the three sums in one share.
      const T share2[3] = {block_sum(s1, red), block_sum(s2, red),
                           block_sum(s3, red)};
      grid_shares(gm, gwork, share2, met, red);
      const T error_km1 = d_sqrt(met[0] / denom);
      const T error_km2 = d_sqrt(met[1] / denom);
      const T error_kp1 = d_sqrt(met[2] / denom);
      // Order adaptation (pallas_vcabm.py:246-257).
      const bool startup = nacc + 1 <= 4 || order < 3;
      const bool dec = d_min(error_km1, error_km2) < error_k;
      const int cap = MO < nacc + 1 ? MO : nacc + 1;
      const bool inc = !dec && order < cap && error_kp1 < error_k;
      if (startup) {
        next_order = order + 1 < 3 ? order + 1 : 3;
        next_order = next_order < MO ? next_order : MO;
      } else {
        next_order = dec ? order - 1 : (inc ? order + 1 : order);
      }
      next_order = next_order < 1 ? 1 : (next_order > MO ? MO : next_order);
      if (next_order <= order)
        dt_acc = vcabm_dt(dt, error_ctrl, order + 1, true, sc.safety,
                          sc.ifactor, sc.dfactor);
#pragma unroll
      for (int j = kVcabmK - 1; j > 0; --j) prev_t[j] = prev_t[j - 1];
      prev_t[0] = next_t;
    }
    const T dt_rej = vcabm_dt(dt, error_ctrl, order, false, sc.safety,
                              sc.ifactor, sc.dfactor);

    // Status rules (pallas_vcabm.py:280-287): 2 before 1.
    const int oi_new = oi + (hit ? 1 : 0);
    const int n_att = nacc + nrej + 1;
    if (!accept && dt_rej < sc.dt_min && status == 0) status = 2;
    if (n_att >= sc.max_steps && oi_new < T_out && status == 0) status = 1;
    next_t_c = accept ? next_t + dt_acc : curr_t + dt_rej;
    if (accept) order = next_order;
    oi = oi_new;
    nacc += accept ? 1 : 0;
    nrej += accept ? 0 : 1;
    nfe += accept ? 2 : 1;
  }
  if (blk == 0 && tid == 0) {
    stats[0] = nfe;
    stats[1] = nacc;
    stats[2] = nrej;
    stats[3] = status;
  }
}

// The launch arguments' checks that do not depend on the right-hand side.
inline bool vcabm_args_ok(int T_out, int B, int D, int max_order,
                          int max_steps, int threads) {
  return T_out >= 2 && B >= 1 && D >= 1 && max_order >= 1 &&
         max_order <= kVcabmMaxOrder && max_steps >= 1 && threads >= 32 &&
         threads <= kVcabmThreads && !(threads & (threads - 1));
}

template <typename T>
VcabmScalars<T> make_vcabm_scalars(int T_out, int B, int D, double dt0,
                                   double rtol, double atol, double dt_min,
                                   double sign, double safety, double ifactor,
                                   double dfactor, int max_steps, int valid,
                                   int max_order, const double* gstar) {
  VcabmScalars<T> sc;
  sc.dt0 = T(dt0);
  sc.rtol = T(rtol);
  sc.atol = T(atol);
  sc.dt_min = T(dt_min);
  sc.sign = T(sign);
  sc.safety = T(safety);
  sc.ifactor = T(ifactor);
  sc.dfactor = T(dfactor);
  for (int i = 0; i <= kVcabmK; ++i)
    sc.gstar[i] = i <= max_order + 2 ? T(gstar[i]) : T(0);
  sc.max_steps = max_steps;
  sc.valid = valid;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;
  sc.max_order = max_order;
  sc.scratch = 0;
  sc.state_smem = 0;
  return sc;
}

// Shared memory a K11 block's right-hand side and output times may take
// beside the reduction scratch (ops/cuda_kernels.py MAX_WEIGHT_BYTES); the
// grouped walk's slots and the block's state rows take what they leave.
constexpr long kVcabmSmemBytes = 220L * 1024;

// One launch of K11 on n_blocks blocks of `threads` threads with `rhs`,
// all resident together (launch_grid), or an error. `fixed` is the bytes
// the right-hand side keeps in shared memory (its setup); the launch adds
// the output times, the reduction scratch (grown for the grouped walk's
// slots, Rhs::kGroup) and, when they fit, the block's state rows.
template <typename T, class Rhs>
cudaError_t launch_rk_vcabm(const void* tau, const void* y0, const void* f0,
                            void* out, void* stats, void* work, void* gwork,
                            long gwork_bytes, int n_blocks, const Rhs& rhs,
                            size_t fixed, int threads,
                            const VcabmScalars<T>& sc, cudaStream_t stream) {
  if (n_blocks < 1 || !gwork ||
      gwork_bytes < rk_vcabm_grid_bytes(n_blocks, sizeof(T)))
    return cudaErrorInvalidValue;
  const size_t item = sizeof(T);
  const size_t own = fixed + item * size_t(sc.T_out);
  const size_t budget = size_t(kVcabmSmemBytes) + item * threads;
  const int per_block = (sc.B + n_blocks - 1) / n_blocks;
  Rhs a_rhs = rhs;
  VcabmScalars<T> a_sc = sc;
  size_t scratch = size_t(threads);
  if constexpr (Rhs::kGroup) {
    a_rhs.slots = group_slots(own, budget, threads, 2L * a_rhs.gw,
                              per_block, item);
    if (size_t(2) * a_rhs.slots * a_rhs.gw > scratch)
      scratch = size_t(2) * a_rhs.slots * a_rhs.gw;
  }
  const size_t rows =
      size_t(vcabm_state_rows(sc.max_order)) * sc.D * size_t(per_block);
  a_sc.scratch = int(scratch);
  a_sc.state_smem = own + item * (scratch + rows) <= budget;
  const size_t smem = own + item * (scratch + (a_sc.state_smem ? rows : 0));
  const T* a_tau = static_cast<const T*>(tau);
  const T* a_y0 = static_cast<const T*>(y0);
  const T* a_f0 = static_cast<const T*>(f0);
  T* a_out = static_cast<T*>(out);
  int* a_stats = static_cast<int*>(stats);
  T* a_work = static_cast<T*>(work);
  unsigned char* a_gwork = static_cast<unsigned char*>(gwork);
  void* args[] = {&a_tau,  &a_y0,    &a_f0,  &a_out, &a_stats,
                  &a_work, &a_gwork, &a_rhs, &a_sc};
  return launch_grid(rk_vcabm_kernel<T, Rhs>, n_blocks, threads, smem, args,
                     gwork, stream);
}

}  // namespace tfd
