// The body of K2: a whole adaptive explicit-RK solve in one launch, under
// one step controller shared by the batch, templated on its right-hand
// side.
//
// Replaces the engine of tfdiffeq_tpu/ops/pallas_kernels.py:726
// (_make_solve_kernel with _rk_stages :522, _interp_coeffs :558 and
// _controller_factor :577; launched by whole_solve_call :1321). Per attempt:
// the stages of the tableau, the masked RMS error over the whole batch, the
// clamped I-controller, Kahan accumulation of the state, the dense-output
// drain of every requested time the accepted step covers, the counters and
// the status; zero fill of the output on early exit. The tableau comes in as
// launch arguments. Output is written straight into the batch-major
// [T, B, D] layout.
//
// Dense output (emit_dense, pallas_kernels.py:729, :756-760, :864-906;
// fast.solve_fused(dense_output=True) and the interpolated adjoint's fused
// forward): when the launch passes the buffers (Scalars::meta, coef and
// dense_S = S > 0), each accepted step's interpolant goes to row si of
// coef [S, 5, B, D] (the planes ca, cb, cc, df0, y0 that the drain computes,
// in its layout, so the stores coalesce as the output rows do) and block 0's
// thread 0 writes meta[si] = (t, t1, dt); si advances on accept while
// si < S. The wrapper fills meta with +inf, so unused rows never win a
// search. The emission writes 5 S_acc B D values; it is bound by those
// bytes over the card's memory rate. With null buffers the solve is what it
// was without them.
//
// Design. The solve runs on a grid of n_blocks blocks of up to 512 threads
// (ops/cuda_kernels.py solve_blocks: one per SM, or fewer for a small
// batch), all resident together (csrc/grid_meet.cuh launch_grid). Block k
// owns the contiguous samples [k B / n, (k + 1) B / n) (on the batch route
// the rows of its own 16-row tiles, Rhs::kUnit rows a unit); its threads own
// them as b = lo + tid, lo + tid + blockDim.x, ... and walk their stages,
// combine, Kahan update and dense-output drain with no wait for another
// block. The stage derivatives, the state, the FSAL derivative and the
// Kahan term of the batch live in device scratch (`work`, [(S + 5) B D]
// values, then the right-hand side's own rows). The batch meets once an
// attempt, for the one shared controller (pallas_kernels.py:823-832): each
// block's share of the error sum (its threads' terms, block_sum's fixed
// tree) and its finiteness flag go to the grid workspace, and every block
// adds the n_blocks shares in block order (grid_shares: two share buffers
// alternate by the meeting's parity, so one grid_sync a meeting) and takes
// bitwise the same accept, factor, dt, status and counters; block 0
// writes the stats. ops/cuda_kernels.py adaptive_solve_plain repeats the
// order for any n_blocks (n_blocks = 1 is the one-block order before the
// grid). A coupled plan (csrc/plan_rhs.cuh PlanBatchRhs, whose block meets
// inside a stage) runs on one block.
//
// The right-hand side `Rhs` (csrc/solve_kernel.cu: the MLP routes and K7's
// CNF flow; csrc/plan_rhs.cuh: K14's generated plans) provides
//   Shared, Local         block-shared and per-thread state;
//   kUnit                 rows a unit of a block's range (16 on the batch
//                         route: K4's tiles; else 1);
//   kGrid                 whether it may run on more than one block;
//   setup(sh, lo, smem, r0, nr)  copies what it keeps in shared memory (no
//                         barrier; r0, nr: the block's rows) and returns the
//                         free shared memory;
// and either (kBatch false) a per-thread evaluation
//   in(lo)                where the kernel writes a sample's D inputs,
//   eval(sh, lo, t, b, B, rw)  sample b's D outputs (rw: its workspace rows),
// or (kGroup true: the MLP routes and K7's flow) a group of threads a
// sample, `slots` samples a round, each sample's slot (sv values: the MLP's
// two layer vectors, K7's walk values) in the block's reduction scratch,
// free during a walk:
//   eval_group(sh, t, on, m, gsz, hin)  the sample's D inputs in hin (its
//                         slot), member m of gsz (mlp_rk.cuh
//                         mlp_eval_group, cnf_net.cuh cnf_eval_group);
// or (kBatch true) a batch-wide one, every stage of an attempt evaluated for
// the block's rows:
//   put(sh, lo, b, t, get, rw, B)  sample b's inputs from get(d),
//   eval_batch(sh, lo, rw, red, B, r0, nr)  after a barrier, by every
//                         thread of the block; returns the outputs, sample
//                         b's at b * ld(lo) + d.
#pragma once

#include "grid_meet.cuh"
#include "mlp_rk.cuh"

namespace tfd {

// Most threads of a block; the launch takes a power of two up to it
// (block_sum), ops/cuda_kernels.py:SOLVE_THREADS.
constexpr int kSolveThreads = 512;

template <typename T>
struct Scalars {
  T dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, valid, T_out, B, D;
  // Dense output: meta [dense_S, 3], coef [dense_S, 5, B, D], or null and 0.
  T* meta;
  T* coef;
  int dense_S;
};

// Bytes of K2's grid workspace: the meetings' counter and the two share
// buffers of (error sum, non-finite flag) a block.
inline long rk_solve_grid_bytes(int n_blocks, long item) {
  return grid_shares_bytes(n_blocks, 2, item);
}

template <typename T, class Rhs>
__global__ void __launch_bounds__(kSolveThreads, 1)
    rk_solve_kernel(const T* __restrict__ tau, const T* __restrict__ y0g,
                    const T* __restrict__ f0g, T* __restrict__ out,
                    int* __restrict__ stats, T* __restrict__ work,
                    unsigned char* __restrict__ gwork, Rhs rhs,
                    Tableau<T> tab_in, Scalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ Tableau<T> tab;
  __shared__ T met[2];   // the merged error sum and non-finite count
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int nb = gridDim.x;
  const int blk = blockIdx.x;
  const int T_out = sc.T_out, B = sc.B, D = sc.D;
  // The block's rows [r_lo, r_hi) (units of kUnit rows, the last unit
  // padded) and its samples [b_lo, b_hi).
  const long units = (long(B) + Rhs::kUnit - 1) / Rhs::kUnit;
  const int r_lo = int(Rhs::kUnit * (long(blk) * units / nb));
  const int r_hi = int(Rhs::kUnit * (long(blk + 1) * units / nb));
  const int b_lo = r_lo < B ? r_lo : B;
  const int b_hi = r_hi < B ? r_hi : B;
  typename Rhs::Local lo;
  T* red = rhs.setup(rsh, lo, smem_raw, r_lo, r_hi - r_lo);  // [blockDim.x]
  if (tid == 0) tab = tab_in;
  GridMeet gm{reinterpret_cast<unsigned long long*>(gwork), 0, 0};
  __syncthreads();

  const int S = tab.S;
  const long BD = long(B) * D;
  T* Y = work;              // state
  T* F = Y + BD;            // derivative at (t, y): stage 0 (FSAL cache)
  T* C = F + BD;            // Kahan compensation
  T* DEL = C + BD;          // delta = y1 - y0 of the attempt
  T* MID = DEL + BD;        // dense-output midpoint of the attempt
  T* F1 = MID + BD;         // f(t1, y1) for tableaus that are not FSAL
  T* K = F1 + BD;           // stages 1 .. S - 1
  T* RW = K + (S - 1) * BD;  // the right-hand side's rows

  const T sign = sc.sign;

  // Deterministic output on early exit: zero fill, then y0 in row 0
  // (pallas_kernels.py:792-793). Each thread fills its own samples.
  for (int b = b_lo + tid; b < b_hi; b += nth) {
    for (int d = 0; d < D; ++d) {
      const long i = long(b) * D + d;
      out[i] = y0g[i];
      for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
      Y[i] = y0g[i];
      F[i] = f0g[i];
      C[i] = T(0);
    }
  }

  const T t_start = tau[0];
  const T t_end = tau[T_out - 1];
  const T denom = T(double(D) * double(B));
  T t = t_start;
  T dt = sc.dt0;
  int oi = 1, nfe = 0, nacc = 0, nrej = 0;
  int si = 0;  // the dense-output row of the next accepted step
  // Non-monotonic times: status 3 (INVALID_TIMES), output zero beyond row 0.
  int status = (t_end > t_start && sc.valid) ? 0 : 3;

  while (t < t_end && status == 0) {
    const T rem = t_end - t;
    const T dt_eff = d_min(dt, rem);
    const bool is_last = dt >= rem;
    const T t1 = is_last ? t_end : t + dt_eff;
    const T dth = t1 - t;

    // ---- phase 1: stages, error and finiteness of each owned sample.
    T ss = T(0);
    bool bad = false;
    // Stage i's state, feature d of the sample at `base`
    // (pallas_kernels.py:_rk_stages: yi = yi + (dt * a_ij) * k_j).
    auto stage_state = [&](long base, int i, int d) {
      T v = Y[base + d];
      for (int j = 0; j < i; ++j) {
        const T a = tab.a[i][j];
        if (a != T(0)) {
          const T kj = j == 0 ? F[base + d] : K[(j - 1) * BD + base + d];
          v = v + (dth * a) * kj;
        }
      }
      return v;
    };
    // The solution, error and midpoint combines of feature d, its share of
    // the error sum and the finiteness flag; returns y1.
    auto combine = [&](long base, int d) {
      const T y0 = Y[base + d];
      T delta = T(0), err = T(0), ymid = y0;
      bool first_d = true, first_e = true;
      for (int j = 0; j < S; ++j) {
        const T kj = j == 0 ? F[base + d] : K[(j - 1) * BD + base + d];
        if (tab.b_sol[j] != T(0)) {
          const T term = (dth * tab.b_sol[j]) * kj;
          delta = first_d ? term : delta + term;
          first_d = false;
        }
        if (tab.b_err[j] != T(0)) {
          const T term = (dth * tab.b_err[j]) * kj;
          err = first_e ? term : err + term;
          first_e = false;
        }
        if (tab.has_mid && tab.c_mid[j] != T(0))
          ymid = ymid + (dth * tab.c_mid[j]) * kj;
      }
      const T y1 = y0 + delta;
      const T scale = sc.atol + sc.rtol * d_max(d_abs(y0), d_abs(y1));
      const T esc = err / scale;
      ss = ss + esc * esc;
      bad = bad || !d_finite(y1);
      DEL[base + d] = delta;
      MID[base + d] = ymid;
      return y1;
    };
    if constexpr (Rhs::kGroup) {
      // A group of gsz threads a sample (member m), `slots` samples a
      // round, stage by stage: the stage state into the group's vector,
      // the walk with the group's threads across each layer's outputs.
      // The combine stays a thread a sample: the error sum's order.
      const int slots = rhs.slots;
      const int gsz = nth / slots, m = tid % gsz, slot = tid / gsz;
      T* const g_in = red + long(slot) * rhs.sv;
      auto walk = [&](T t_eval, auto input, T* dst) {
        for (int r0 = b_lo; r0 < b_hi; r0 += slots) {
          const int b = r0 + slot;
          const bool on = b < b_hi;
          const long base = long(b) * D;
          for (int d = m; on && d < D; d += gsz) g_in[d] = input(base, d);
          __syncthreads();
          const T* fo =
              rhs.eval_group(rsh, sign * t_eval, on, m, gsz, g_in);
          for (int d = m; on && d < D; d += gsz)
            dst[base + d] = sign * fo[d];
          __syncthreads();
        }
      };
      // Y and F were last written a thread a sample.
      __syncthreads();
      for (int i = 1; i < S; ++i)
        walk(t + tab.c[i] * dth,
             [&](long base, int d) { return stage_state(base, i, d); },
             K + (i - 1) * BD);
      for (int b = b_lo + tid; b < b_hi; b += nth)
        for (int d = 0; d < D; ++d) combine(long(b) * D, d);
      if (!tab.fsal) {
        // The end derivative at (t1, y1), y1 = y0 + delta as combine has it.
        __syncthreads();
        walk(t1, [&](long base, int d) { return Y[base + d] + DEL[base + d]; },
             F1);
      }
    } else if constexpr (!Rhs::kBatch) {
      T* h_in = rhs.in(lo);
      for (int b = b_lo + tid; b < b_hi; b += nth) {
        const long base = long(b) * D;
        for (int i = 1; i < S; ++i) {
          for (int d = 0; d < D; ++d) h_in[d] = stage_state(base, i, d);
          const T ti = t + tab.c[i] * dth;
          const T* fo = rhs.eval(rsh, lo, sign * ti, b, B, RW);
          for (int d = 0; d < D; ++d) K[(i - 1) * BD + base + d] = sign * fo[d];
        }
        for (int d = 0; d < D; ++d) h_in[d] = combine(base, d);
        if (!tab.fsal) {
          // The end derivative costs one more evaluation (counted in evals).
          const T* fo = rhs.eval(rsh, lo, sign * t1, b, B, RW);
          for (int d = 0; d < D; ++d) F1[base + d] = sign * fo[d];
        }
      }
    } else {
      // Each stage's evaluation is batch-wide.
      for (int i = 1; i < S; ++i) {
        const T ti = t + tab.c[i] * dth;
        for (int b = b_lo + tid; b < b_hi; b += nth) {
          const long base = long(b) * D;
          rhs.put(rsh, lo, b, sign * ti,
                  [&](int d) { return stage_state(base, i, d); }, RW, B);
        }
        __syncthreads();
        const T* fo = rhs.eval_batch(rsh, lo, RW, red, B, r_lo, r_hi - r_lo);
        const long ld = rhs.ld(lo);
        for (int b = b_lo + tid; b < b_hi; b += nth)
          for (int d = 0; d < D; ++d)
            K[(i - 1) * BD + long(b) * D + d] = sign * fo[long(b) * ld + d];
      }
      for (int b = b_lo + tid; b < b_hi; b += nth) {
        const long base = long(b) * D;
        rhs.put(rsh, lo, b, sign * t1,
                [&](int d) { return combine(base, d); }, RW, B);
      }
      if (!tab.fsal) {
        // The end derivative at (t1, y1), the inputs just written.
        __syncthreads();
        const T* fo = rhs.eval_batch(rsh, lo, RW, red, B, r_lo, r_hi - r_lo);
        const long ld = rhs.ld(lo);
        for (int b = b_lo + tid; b < b_hi; b += nth)
          for (int d = 0; d < D; ++d)
            F1[long(b) * D + d] = sign * fo[long(b) * ld + d];
      }
    }

    // ---- the batch meets: each block's share of the error sum and its
    // finiteness flag, merged in block order; one shared decision.
    const bool blk_bad = __syncthreads_or(bad);
    const T share[2] = {block_sum(ss, red), blk_bad ? T(1) : T(0)};
    grid_shares(gm, gwork, share, met, red);
    const T total = met[0];
    const bool any_bad = met[1] != T(0);
    const T ratio = d_sqrt(total / denom);
    const bool finite = d_finite(total) && !any_bad;
    const bool accept = (ratio <= T(1)) && finite;
    const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                    sc.ifactor, sc.dfactor, tab.order);
    // Rescale the CLAMPED attempted step, as the generic engine does.
    const T dt_next = dth * fac;

    if (accept) {
      int oi_new = oi;
      while (oi_new < T_out && tau[oi_new] <= t1) ++oi_new;
      T* const dc = si < sc.dense_S ? sc.coef + long(si) * 5 * BD : nullptr;
      if (dc && blk == 0 && tid == 0) {
        sc.meta[3L * si] = t;
        sc.meta[3L * si + 1] = t1;
        sc.meta[3L * si + 2] = dth;
      }
      // ---- phase 2: dense output, Kahan update, drain, FSAL.
      for (int b = b_lo + tid; b < b_hi; b += nth) {
        const long base = long(b) * D;
        for (int d = 0; d < D; ++d) {
          const T y0 = Y[base + d];
          const T delta = DEL[base + d];
          const T f0 = F[base + d];
          const T f1 = tab.fsal ? K[(S - 2) * BD + base + d] : F1[base + d];
          const T y1 = y0 + delta;
          const T df0 = dth * f0;
          const T df1 = dth * f1;
          // pallas_kernels.py:_interp_coeffs.
          const T r1 = y1 - y0 - df0;
          const T r2 = df1 - df0;
          T ca, cb, cc;
          if (tab.has_mid) {
            const T r3 = T(16) * (MID[base + d] - y0) - T(8) * df0;
            ca = r3 + T(2) * r2 - T(8) * r1;
            cb = r2 - T(2) * r1 - T(2) * ca;
            cc = r1 - ca - cb;
          } else {
            ca = T(0);
            cb = T(2) * (y0 - y1) + df0 + df1;
            cc = T(3) * (y1 - y0) - T(2) * df0 - df1;
          }
          if (dc) {
            T* const p = dc + base + d;
            p[0] = ca;
            p[BD] = cb;
            p[2 * BD] = cc;
            p[3 * BD] = df0;
            p[4 * BD] = y0;
          }
          // Kahan-compensated accumulation.
          const T comp = C[base + d];
          const T adj = delta - comp;
          const T y_new = y0 + adj;
          C[base + d] = (y_new - y0) - adj;
          Y[base + d] = y_new;
          F[base + d] = f1;
          // Every requested time in (t, t1], exactly y_new at t1.
          for (int o = oi; o < oi_new; ++o) {
            const T tj = tau[o];
            const T x = (tj - t) / dth;
            const T val = (((ca * x + cb) * x + cc) * x + df0) * x + y0;
            out[long(o) * BD + base + d] = (tj == t1) ? y_new : val;
          }
        }
      }
      oi = oi_new;
      if (dc) ++si;
    }

    // Status rules of the kernel (pallas_kernels.py:896-902).
    const int n_att = nacc + nrej + 1;
    if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
    if (n_att >= sc.max_steps && t1 < t_end && status == 0) status = 1;
    if (accept) t = t1;
    dt = dt_next;
    nfe += tab.evals;
    nacc += accept ? 1 : 0;
    nrej += accept ? 0 : 1;
  }
  if (blk == 0 && tid == 0) {
    stats[0] = nfe;
    stats[1] = nacc;
    stats[2] = nrej;
    stats[3] = status;
  }
}

// The controller's scalars from the host's doubles.
template <typename T>
Scalars<T> make_scalars(double dt0, double rtol, double atol, double dt_min,
                        double sign, double safety, double ifactor,
                        double dfactor, int max_steps, int valid, int T_out,
                        int B, int D) {
  Scalars<T> sc;
  sc.dt0 = T(dt0);
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
  sc.meta = nullptr;
  sc.coef = nullptr;
  sc.dense_S = 0;
  return sc;
}

// Shared memory a K2 block's right-hand side may take beside the reduction
// scratch (ops/cuda_kernels.py MAX_WEIGHT_BYTES); a grouped walk takes as
// many slots as fit within it and the scratch.
constexpr long kSolveSmemBytes = 220L * 1024;

// One launch of rk_solve_kernel<T, Rhs> on n_blocks blocks of `threads`
// threads with `smem` bytes of dynamic shared memory, all resident together
// (launch_grid), or an error; a right-hand side that meets inside a stage
// (not Rhs::kGrid) takes one block, and the batch route at most one block a
// unit.
template <typename T, class Rhs>
cudaError_t launch_rk_solve(const void* tau, const void* y0, const void* f0,
                            void* out, void* stats, void* work, void* gwork,
                            long gwork_bytes, int n_blocks, const Rhs& rhs,
                            size_t smem, int threads, const Tableau<T>& tab,
                            const Scalars<T>& sc, cudaStream_t stream) {
  const long units = (long(sc.B) + Rhs::kUnit - 1) / Rhs::kUnit;
  if (n_blocks < 1 || (!Rhs::kGrid && n_blocks != 1) ||
      (Rhs::kUnit > 1 && n_blocks > units) || !gwork ||
      gwork_bytes < rk_solve_grid_bytes(n_blocks, sizeof(T)))
    return cudaErrorInvalidValue;
  const T* a_tau = static_cast<const T*>(tau);
  const T* a_y0 = static_cast<const T*>(y0);
  const T* a_f0 = static_cast<const T*>(f0);
  T* a_out = static_cast<T*>(out);
  int* a_stats = static_cast<int*>(stats);
  T* a_work = static_cast<T*>(work);
  unsigned char* a_gwork = static_cast<unsigned char*>(gwork);
  Rhs a_rhs = rhs;
  Tableau<T> a_tab = tab;
  Scalars<T> a_sc = sc;
  void* args[] = {&a_tau,  &a_y0,   &a_f0,  &a_out, &a_stats,
                  &a_work, &a_gwork, &a_rhs, &a_tab, &a_sc};
  return launch_grid(rk_solve_kernel<T, Rhs>, n_blocks, threads, smem, args,
                     gwork, stream);
}

}  // namespace tfd
