// K12: a whole hypersolver solve (hyper_euler, hyper_midpoint, hyper_heun;
// Poli et al. 2020) in one launch, templated on two right-hand sides: the
// dynamics f and the correction net g.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:313
// (_make_hyper_solve_kernel; launched by plan_solve_hyper :440 from
// fast.solve_hyper, tfdiffeq_tpu/fast.py:1223). Per grid interval
// [t0, t1], dt = t1 - t0, in tau = sign * t:
// - f0 = f(t0, y), the canonical derivative sign * f_user(sign * t0, y);
// - the base update of order p: euler f0 (p = 1, one evaluation);
//   midpoint f(t0 + dt / 2, y + (dt / 2) f0); heun (f0 + f(t1, y + dt f0))
//   / 2 (p = 2, two evaluations);
// - the learned correction in user space, g(sign * t0, [y; sign * f0])
//   with the [y; f_user] stack as g's 2 D inputs, times (sign dt)^(p+1)
//   formed by repeated products: y1 = y + dt base + (sign dt)^(p+1) g;
// - on a grid equal to the output times, node i + 1's output is y1; on a
//   finer grid, K8's cubic-Hermite drain (csrc/rk_fixed.cuh
//   hermite_drain) of every requested time in the PREVIOUS interval, one
//   step late: its end slope is this step's f0, which costs nothing, and
//   the last interval pays one evaluation f(t_end, y_end).
// NFE counts the evaluations of f (evals (G - 1), plus 1 off the output
// grid), not those of g. Stats are [nfe, G - 1, 0, 0], or [0, 0, 0, 3]
// with a zero tail for times that do not increase. Output is written
// straight into the batch-major [T, B, D] layout.
//
// Design. Like K8's a fixed grid has no meet between samples: one thread
// owns one sample for the whole solve, over as many blocks as the batch
// needs, with no barrier after the prologue; the output cursor is the same
// in every thread. f's and g's constants sit in shared memory when they
// fit (f's first, g's after them), then the grid and the output times; the
// sample's state, the previous node's state and derivative and f0 live in
// a device workspace laid out feature-major ([row][B]). f's outputs stay
// in its own per-thread buffer while g evaluates into g's, so the base
// update needs no row of its own. The plain version
// (ops/cuda_plan.py plan_solve_hyper_plain) repeats every operation in
// this order, and the plan libraries are built with --fmad=false, so the
// two give the same bits.
//
// The right-hand sides RF and RG (csrc/plan_rhs.cuh PlanRhs of K14's two
// generated plans) each evaluate one sample in its thread: Shared and
// Local state; setup(sh, lo, smem), which copies what it keeps in shared
// memory (no barrier) and returns the free shared memory; in(lo), where
// the inputs go (D for f, 2 D for g); and eval(sh, lo, t, b, B), sample
// b's D outputs.
//
// Bound on the H100. Each thread walks its sample's evaluations of both
// nets (at the example's widths f = (y^3) A: about 20 operations; g
// 5 -> 32 -> 2: about 450 operations and 32 tanh) one dependent
// instruction after another, so the solve is bound by the latency of that
// chain and by instruction issue, as K14 in K8 is.
#pragma once

#include "rk_fixed.cuh"

namespace tfd {

template <typename T>
struct HyperScalars {
  T sign;
  int valid, G, T_out, B, D;
  int kind;       // 0 euler, 1 midpoint, 2 heun
  int grid_is_t;  // the grid is the output times
};

template <typename T, class RF, class RG>
__global__ void rk_hyper_kernel(const T* __restrict__ grid_g,
                                const T* __restrict__ tau_g,
                                const T* __restrict__ y0g,
                                T* __restrict__ out, int* __restrict__ stats,
                                T* __restrict__ work, RF rf, RG rg,
                                HyperScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename RF::Shared fsh;
  __shared__ typename RG::Shared gsh;
  const int tid = threadIdx.x;
  typename RF::Local flo;
  typename RG::Local glo;
  T* rest = rf.setup(fsh, flo, smem_raw);
  T* grid = rg.setup(gsh, glo, reinterpret_cast<unsigned char*>(rest));
  T* tau = grid + sc.G;  // [T_out]
  for (int i = tid; i < sc.G; i += blockDim.x) grid[i] = grid_g[i];
  for (int i = tid; i < sc.T_out; i += blockDim.x) tau[i] = tau_g[i];
  __syncthreads();

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D;
  const int kind = sc.kind;
  const bool grid_is_t = sc.grid_is_t != 0;
  const int evals = kind == 0 ? 1 : 2;
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = sc.valid ? evals * (G - 1) + (grid_is_t ? 0 : 1) : 0;
    stats[1] = sc.valid ? G - 1 : 0;
    stats[2] = 0;
    stats[3] = sc.valid ? 0 : 3;
  }
  const int b = blockIdx.x * blockDim.x + tid;
  if (b >= B) return;  // no barrier follows

  const long BD = long(B) * D;
  // Feature-major workspace rows of B values.
  T* Y = work;        // state
  T* YP = Y + BD;     // the previous node's state (the delayed drain)
  T* FP = YP + BD;    // the previous node's canonical derivative
  T* F0 = FP + BD;    // this step's f0
  auto at = [B, b](int d) -> long { return long(d) * B + b; };
  const T sign = sc.sign;
  T* f_in = rf.in(flo);
  T* g_in = rg.in(glo);

  // Row 0 is y0; the rest stays zero unless a step writes it.
  for (int d = 0; d < D; ++d) {
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[at(d)] = y0g[i];
  }
  if (!sc.valid) return;  // the same in every thread

  int oi = 1;
  for (int step = 0; step + 1 < G; ++step) {
    const T t0 = grid[step];
    const T t1 = grid[step + 1];
    const T dt = t1 - t0;
    for (int d = 0; d < D; ++d) f_in[d] = Y[at(d)];
    const T* fo = rf.eval(fsh, flo, sign * t0, b, B);
    for (int d = 0; d < D; ++d) F0[at(d)] = sign * fo[d];
    if (!grid_is_t) {
      if (step > 0) {
        // The previous interval's drain, its end slope this step's f0.
        const T tp = grid[step - 1];
        const int oi_new = drain_cursor(tau, oi, T_out, t0, false);
        for (int d = 0; d < D; ++d)
          hermite_drain(out, tau, oi, oi_new, tp, t0, t0 - tp, YP[at(d)],
                        Y[at(d)], FP[at(d)], F0[at(d)], BD,
                        long(b) * D + d);
        oi = oi_new;
      }
      for (int d = 0; d < D; ++d) {
        YP[at(d)] = Y[at(d)];
        FP[at(d)] = F0[at(d)];
      }
    }
    if (kind == 1) {
      const T h = T(0.5) * dt;
      for (int d = 0; d < D; ++d) f_in[d] = Y[at(d)] + h * F0[at(d)];
      fo = rf.eval(fsh, flo, sign * (t0 + h), b, B);
    } else if (kind == 2) {
      for (int d = 0; d < D; ++d) f_in[d] = Y[at(d)] + dt * F0[at(d)];
      fo = rf.eval(fsh, flo, sign * t1, b, B);
    }
    // The correction in user space: g(sign t0, [y; sign f0]).
    for (int d = 0; d < D; ++d) {
      g_in[d] = Y[at(d)];
      g_in[D + d] = sign * F0[at(d)];
    }
    const T* go = rg.eval(gsh, glo, sign * t0, b, B);
    const T sdt = sign * dt;
    T sdt_p = sdt * sdt;
    if (kind != 0) sdt_p = sdt_p * sdt;
    for (int d = 0; d < D; ++d) {
      const T f0 = F0[at(d)];
      const T base = kind == 0 ? f0
                               : (kind == 1 ? sign * fo[d]
                                            : T(0.5) * (f0 + sign * fo[d]));
      const T y1 = Y[at(d)] + dt * base + sdt_p * go[d];
      Y[at(d)] = y1;
      if (grid_is_t) out[long(step + 1) * BD + long(b) * D + d] = y1;
    }
  }
  if (!grid_is_t) {
    // The last interval: one f(t_end, y_end) and every time left.
    const T t0 = grid[G - 2];
    const T t1 = grid[G - 1];
    for (int d = 0; d < D; ++d) f_in[d] = Y[at(d)];
    const T* fo = rf.eval(fsh, flo, sign * t1, b, B);
    const int oi_new = drain_cursor(tau, oi, T_out, t1, true);
    for (int d = 0; d < D; ++d)
      hermite_drain(out, tau, oi, oi_new, t0, t1, t1 - t0, YP[at(d)],
                    Y[at(d)], FP[at(d)], sign * fo[d], BD, long(b) * D + d);
  }
}

// One launch of K12; `smem` holds both right-hand sides' shared memory
// (their setups) and the grid and output times.
template <typename T, class RF, class RG>
cudaError_t launch_rk_hyper(const void* grid, const void* tau, const void* y0,
                            void* out, void* stats, void* work, const RF& rf,
                            const RG& rg, size_t smem, int threads,
                            const HyperScalars<T>& sc, cudaStream_t stream) {
  auto kernel = rk_hyper_kernel<T, RF, RG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (sc.B + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(tau),
      static_cast<const T*>(y0), static_cast<T*>(out),
      static_cast<int*>(stats), static_cast<T*>(work), rf, rg, sc);
  return cudaGetLastError();
}

}  // namespace tfd
