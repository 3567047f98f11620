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
// Design. The history is a ring of max_order slabs with a rotating head in
// a device workspace laid out feature-major ([row][B]: a warp's threads
// touch consecutive values), as is the rest of a sample's state (the
// state, its compensation, the RK4 stages, and the corrector's y_cur,
// y_next and history part); the grid, output times and the coefficient
// tables sit in shared memory after what the right-hand side keeps there.
// explicit_adams has no batch meet, so it takes K8's layout: one thread a
// sample, over as many blocks as the batch needs. fixed_adams meets the
// batch at every corrector iteration, so it runs on ONE block (as K2 does):
// each thread owns the samples b = tid, tid + blockDim.x, ..., and the
// norm's sum is a block reduction in a fixed order (mlp_rk.cuh block_sum)
// that the plain version (ops/cuda_adams.py adams_solve_plain) repeats, as
// it repeats every other operation here: the libraries are built with
// --fmad=false, so kernel and plain version give the same bits.
//
// The right-hand side `Rhs` (mlp_rk.cuh MlpThreadRhs: the MLP routes of
// csrc/adams_kernel.cu; csrc/plan_rhs.cuh PlanRhs: K14's generated plans)
// evaluates one sample in its thread: Shared and Local state; setup(sh,
// lo, smem), which copies what it keeps in shared memory (no barrier) and
// returns the free shared memory; in(lo), where the D inputs go; and
// eval(sh, lo, t, b, B), sample b's D outputs.
#pragma once

#include "rk_fixed.cuh"

namespace tfd {

constexpr int kAdamsMaxOrder = 12;
// Threads of fixed_adams' one block (a power of two for block_sum) and of
// an explicit_adams block (ops/cuda_adams.py ADAMS_THREADS,
// ADAMS_EXPLICIT_THREADS).
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
  int valid, G, T_out, B, D, max_order, max_iters, implicit, nfe;
};

template <typename T, class Rhs>
__global__ void __launch_bounds__(kAdamsThreads)
    rk_adams_kernel(const T* __restrict__ grid_g, const T* __restrict__ tau_g,
                    const T* __restrict__ y0g, const T* __restrict__ f0g,
                    T* __restrict__ out, int* __restrict__ stats,
                    T* __restrict__ work, Rhs rhs, AdamsTables<T> tables_in,
                    AdamsScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Rhs::Shared rsh;
  __shared__ AdamsTables<T> tab;
  const int tid = threadIdx.x;
  typename Rhs::Local lo;
  T* grid = rhs.setup(rsh, lo, smem_raw);  // [G]
  T* tau = grid + sc.G;      // [T_out]
  T* red = tau + sc.T_out;   // [blockDim.x]: fixed_adams' reduction
  if (tid == 0) tab = tables_in;
  for (int i = tid; i < sc.G; i += blockDim.x) grid[i] = grid_g[i];
  for (int i = tid; i < sc.T_out; i += blockDim.x) tau[i] = tau_g[i];
  __syncthreads();

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D;
  const int MO = sc.max_order;
  const bool implicit = sc.implicit != 0;
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = sc.valid ? sc.nfe : 0;
    stats[1] = sc.valid ? G - 1 : 0;
    stats[2] = 0;
    stats[3] = sc.valid ? 0 : 3;
  }
  // Samples b = first, first + stride, ...: one a thread for
  // explicit_adams, B / blockDim.x a thread on fixed_adams' one block.
  const int first = blockIdx.x * blockDim.x + tid;
  const int stride = gridDim.x * blockDim.x;

  const long BD = long(B) * D;
  // Feature-major workspace rows of B values.
  T* Y = work;              // state
  T* C = Y + BD;            // Kahan compensation
  T* YC = C + BD;           // fixed_adams: y_cur (y_pred first)
  T* YN = YC + BD;          // fixed_adams: y_next; then the increment
  T* HP = YN + BD;          // fixed_adams: y-independent history part
  T* KS = HP + BD;          // RK4 stages 1 .. 3
  T* HIST = KS + 3 * BD;    // ring of max_order slabs of D rows
  T* h_in = rhs.in(lo);
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless a step writes it.
  for (int b = first; b < B; b += stride) {
    for (int d = 0; d < D; ++d) {
      const long i = long(b) * D + d;
      const long r = long(d) * B + b;
      out[i] = y0g[i];
      for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
      Y[r] = y0g[i];
      C[r] = T(0);
      HIST[r] = f0g[i];
      for (int j = 1; j < MO; ++j) HIST[long(j) * BD + r] = T(0);
    }
  }
  if (!sc.valid) return;  // the same in every thread

  const T denom = T(double(D) * double(B));
  // RK4 (ops/tableaus.py RK4, the same doubles rounded to T).
  const T rk_c[4] = {T(0), T(0.5), T(0.5), T(1.0)};
  const T rk_b[4] = {T(1.0 / 6.0), T(1.0 / 3.0), T(1.0 / 3.0), T(1.0 / 6.0)};
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
      return long((head + j) % MO) * BD + long(d) * B + b;
    };
    const int k_eff = n + 1 < MO ? n + 1 : MO;
    const T* abr = tab.ab + (k_eff - 1) * MO;
    const T* amr = tab.am + (k_eff - 1) * MO;
    // The predictor's history sum of feature d of sample b, newest first.
    auto predictor = [&](int d, int b) {
      T acc = abr[0] * HIST[hrow(0, d, b)];
      for (int j = 1; j < MO; ++j) acc = acc + abr[j] * HIST[hrow(j, d, b)];
      return acc;
    };
    // The step's end for sample b, its increment in YN and fo = the
    // unsigned f(t1, .) that becomes hist[0]: the Kahan update, the
    // history shift (the new slot is the oldest, read already), the
    // Hermite drain.
    auto finish = [&](int b, const T* fo) {
      for (int d = 0; d < D; ++d) {
        const long r = long(d) * B + b;
        const T f_head = HIST[hrow(0, d, b)];
        const T y0 = Y[r];
        const T adj = YN[r] - C[r];
        const T y1 = y0 + adj;
        C[r] = (y1 - y0) - adj;
        Y[r] = y1;
        const T f1 = sign * fo[d];
        HIST[long(slot_new) * BD + r] = f1;
        hermite_drain(out, tau, oi, oi_new, t0, t1, dt, y0, y1, f_head, f1,
                      BD, long(b) * D + d);
      }
    };

    if (n < MO - 1) {
      // RK4 bootstrap: yi = y0 + (dt a_ij) k_j over the nonzero a_ij
      // (a = [[1/2], [0, 1/2], [0, 0, 1]]), delta = sum_j (dt b_j) k_j.
      for (int b = first; b < B; b += stride) {
        for (int i = 1; i < 4; ++i) {
          for (int d = 0; d < D; ++d) {
            const long r = long(d) * B + b;
            const T kp = i == 1 ? HIST[hrow(0, d, b)]
                                : KS[long(i - 2) * BD + r];
            h_in[d] = Y[r] + (dt * rk_c[i]) * kp;
          }
          const T* fo = rhs.eval(rsh, lo, sign * (t0 + rk_c[i] * dt), b, B);
          for (int d = 0; d < D; ++d)
            KS[long(i - 1) * BD + long(d) * B + b] = sign * fo[d];
        }
        // The increment, kept in YN (unused by the bootstrap).
        for (int d = 0; d < D; ++d) {
          const long r = long(d) * B + b;
          T acc = (dt * rk_b[0]) * HIST[hrow(0, d, b)];
          for (int i = 1; i < 4; ++i)
            acc = acc + (dt * rk_b[i]) * KS[long(i - 1) * BD + r];
          YN[r] = acc;
          h_in[d] = Y[r] + acc;
        }
        finish(b, rhs.eval(rsh, lo, sign * t1, b, B));
      }
    } else if (!implicit) {
      // explicit_adams: f1 = f(t1, y_pred), y_pred = y0 + delta with the
      // increment delta = dt acc kept in YN.
      for (int b = first; b < B; b += stride) {
        for (int d = 0; d < D; ++d) {
          const long r = long(d) * B + b;
          YN[r] = dt * predictor(d, b);
          h_in[d] = Y[r] + YN[r];
        }
        finish(b, rhs.eval(rsh, lo, sign * t1, b, B));
      }
    } else {
      // fixed_adams: y_pred and the history part, then the corrector.
      const T g0 = amr[0];
      for (int b = first; b < B; b += stride) {
        for (int d = 0; d < D; ++d) {
          const long r = long(d) * B + b;
          T hp = T(0);
          if (MO > 1) {
            hp = amr[1] * HIST[hrow(0, d, b)];
            for (int j = 1; j < MO - 1; ++j)
              hp = hp + amr[j + 1] * HIST[hrow(j, d, b)];
          }
          HP[r] = hp;
          YC[r] = Y[r] + dt * predictor(d, b);
        }
      }
      bool done = false;
      for (int it = 0; it < sc.max_iters; ++it) {
        T ss = T(0);
        for (int b = first; b < B; b += stride) {
          for (int d = 0; d < D; ++d) h_in[d] = YC[long(d) * B + b];
          const T* fo = rhs.eval(rsh, lo, sign * t1, b, B);
          for (int d = 0; d < D; ++d) {
            const long r = long(d) * B + b;
            const T y_cur = YC[r];
            const T y_next = Y[r] + dt * (HP[r] + g0 * (sign * fo[d]));
            const T scale =
                sc.atol + sc.rtol * d_max(d_abs(y_cur), d_abs(y_next));
            const T esc = (y_next - y_cur) / scale;
            ss = ss + esc * esc;
            YN[r] = y_next;
          }
        }
        const T norm = d_sqrt(block_sum(ss, red) / denom);
        if (!done) {
          for (int b = first; b < B; b += stride)
            for (int d = 0; d < D; ++d)
              YC[long(d) * B + b] = YN[long(d) * B + b];
        }
        done = done || norm <= T(1);
      }
      // The increment y_cur - y0, kept in YN.
      for (int b = first; b < B; b += stride) {
        for (int d = 0; d < D; ++d) {
          const long r = long(d) * B + b;
          h_in[d] = YC[r];
          YN[r] = YC[r] - Y[r];
        }
        finish(b, rhs.eval(rsh, lo, sign * t1, b, B));
      }
    }
    head = slot_new;
    oi = oi_new;
  }
}

// The launch arguments' checks that do not depend on the right-hand side.
inline bool adams_args_ok(int G, int T_out, int B, int D, int max_order,
                          int max_iters, int implicit, int threads,
                          int blocks) {
  return G >= 2 && T_out >= 1 && B >= 1 && D >= 1 && max_order >= 1 &&
         max_order <= kAdamsMaxOrder && max_iters >= 0 && threads >= 32 &&
         threads <= kAdamsThreads && !(threads & (threads - 1)) &&
         blocks >= 1 && !(implicit && blocks != 1);
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
                                   int valid, int max_order, int max_iters,
                                   int implicit, int nfe) {
  AdamsScalars<T> sc;
  sc.sign = T(sign);
  sc.rtol = T(rtol);
  sc.atol = T(atol);
  sc.valid = valid;
  sc.G = G;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;
  sc.max_order = max_order;
  sc.max_iters = max_iters;
  sc.implicit = implicit;
  sc.nfe = nfe;
  return sc;
}

// One launch of K10 with `rhs`; `smem` is the right-hand side's shared
// memory (its setup) and the grid, output times and reduction's.
template <typename T, class Rhs>
cudaError_t launch_rk_adams(const void* grid, const void* tau, const void* y0,
                            const void* f0, void* out, void* stats,
                            void* work, const Rhs& rhs, size_t smem,
                            int threads, int blocks,
                            const AdamsTables<T>& tables,
                            const AdamsScalars<T>& sc, cudaStream_t stream) {
  auto kernel = rk_adams_kernel<T, Rhs>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(tau),
      static_cast<const T*>(y0), static_cast<const T*>(f0),
      static_cast<T*>(out), static_cast<int*>(stats), static_cast<T*>(work),
      rhs, tables, sc);
  return cudaGetLastError();
}

}  // namespace tfd
