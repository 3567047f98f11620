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
// with a zero tail for times that do not increase (decided on the card
// from the times the kernel loads, rk_fixed.cuh load_times). Output is
// written straight into the batch-major [T, B, D] layout.
//
// Design. Like K8's a fixed grid has no meet between samples, so K12 takes
// K8's group layout (csrc/rk_fixed.cuh rk_fixed_group_kernel): a group of
// sc.group threads walks one sample (lane_group.h hyper_group: 16 where
// the batch fills the card, wider for a small batch), kGroupBlock /
// sc.group samples a 512-thread block, each group meeting only its own
// members (GroupSync), so a group past B leaves at once. Both plans run
// K14's generated group walk (csrc/plan_rhs.cuh PlanLaneRhs), each row of
// a value computed by the member that owns it, a dot's outputs over the
// members; the members split the base update, the correction and the
// delayed drain a feature a member (d = m, m + group, ...), in the order
// of the plain version (ops/cuda_plan.py plan_solve_hyper_plain), and the
// plan libraries are built with --fmad=false, so the two give the same
// bits. f's constants and their transposed copy sit in shared memory when
// they fit, g's after them, then the grid and the output times; then the
// block's sample slots (lane_group.h hyper_solve_slot_values: the state,
// the previous node's state and derivative, f0, f's walk after its D
// inputs and g's walk after its 2 D inputs) where they fit, else the
// workspace. f's outputs stay in f's walk while g evaluates in its own,
// so the base update needs no row of its own. g's inputs [y; sign f0] are
// written a feature a member, so the group meets once before g's walk
// (its rows D + d are owned by other members than the writers').
//
// The right-hand sides RF and RG (plan_rhs.cuh PlanLaneRhs) provide
// Shared, setup(sh, smem) (copies what they keep in shared memory, no
// barrier; returns the free shared memory), smem_values(), walk_values()
// (the walk's values in the slot, its inputs first) and eval_lanes(sh, t,
// hin, m, gsz, sync, b, B) (sample b's outputs from its inputs at hin).
//
// Bound on the H100. Each sample's step is a chain of its walks (at the
// example's widths f = (y^3) A: about 20 operations; g 5 -> 32 -> 2: about
// 450 operations and 32 tanh) split over the group's members: g's hidden
// layer two outputs a member of 16, a group barrier between the walk's
// phases; the solve is bound by that chain's latency and the barriers,
// the SM's 16 warps hiding each other's.
#pragma once

#include "rk_fixed.cuh"

namespace tfd {

template <typename T>
struct HyperScalars {
  T sign;
  int G, T_out, B, D;
  int kind;         // 0 euler, 1 midpoint, 2 heun
  int grid_is_t;    // the grid is the output times
  int group;        // threads a sample
  int walk_f;       // f's walk values in the slot (its D inputs first)
  int slot_values;  // a sample's slot (lane_group.h hyper_solve_slot_values)
  int slot_smem;    // the block's slots in shared memory (else `work`)
};

template <typename T, class RF, class RG>
__global__ void __launch_bounds__(kGroupBlock, 1)
    rk_hyper_group_kernel(const T* __restrict__ grid_g,
                          const T* __restrict__ tau_g,
                          const T* __restrict__ y0g, T* __restrict__ out,
                          int* __restrict__ stats, T* __restrict__ work,
                          RF rf, RG rg, HyperScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename RF::Shared fsh;
  __shared__ typename RG::Shared gsh;
  const int tid = threadIdx.x;
  T* const after_f = rf.setup(fsh, smem_raw);
  T* const rest = rg.setup(gsh, reinterpret_cast<unsigned char*>(after_f));
  const int valid = load_times(grid_g, tau_g, rest, sc.G, sc.T_out);
  const T* const grid = rest;             // [G]
  const T* const tau = rest + sc.G;       // [T_out]

  const int G = sc.G, T_out = sc.T_out, B = sc.B, D = sc.D;
  const int kind = sc.kind;
  const bool grid_is_t = sc.grid_is_t != 0;
  const int evals = kind == 0 ? 1 : 2;
  if (blockIdx.x == 0 && tid == 0) {
    stats[0] = valid ? evals * (G - 1) + (grid_is_t ? 0 : 1) : 0;
    stats[1] = valid ? G - 1 : 0;
    stats[2] = 0;
    stats[3] = valid ? 0 : 3;
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
  T* const YP = Y + D;     // [D] the previous node's state (delayed drain)
  T* const FP = YP + D;    // [D] the previous node's canonical derivative
  T* const F0 = FP + D;    // [D] this step's f0
  T* const HF = F0 + D;    // f's walk, its D inputs first
  T* const HG = HF + sc.walk_f;   // g's walk, its 2 D inputs first
  const T sign = sc.sign;

  // Row 0 is y0; the rest stays zero unless a step writes it.
  for (int d = m; d < D; d += gsz) {
    const long i = long(b) * D + d;
    out[i] = y0g[i];
    for (int o = 1; o < T_out; ++o) out[long(o) * BD + i] = T(0);
    Y[d] = y0g[i];
  }
  if (!valid) return;  // the same in every thread

  int oi = 1;
  for (int step = 0; step + 1 < G; ++step) {
    const T t0 = grid[step];
    const T t1 = grid[step + 1];
    const T dt = t1 - t0;
    for (int d = m; d < D; d += gsz) HF[d] = Y[d];
    const T* fo = rf.eval_lanes(fsh, sign * t0, HF, m, gsz, sync, b, B);
    for (int d = m; d < D; d += gsz) F0[d] = sign * fo[d];
    if (!grid_is_t) {
      if (step > 0) {
        // The previous interval's drain, its end slope this step's f0.
        const T tp = grid[step - 1];
        const int oi_new = drain_cursor(tau, oi, T_out, t0, false);
        for (int d = m; d < D; d += gsz)
          hermite_drain(out, tau, oi, oi_new, tp, t0, t0 - tp, YP[d], Y[d],
                        FP[d], F0[d], BD, long(b) * D + d);
        oi = oi_new;
      }
      for (int d = m; d < D; d += gsz) {
        YP[d] = Y[d];
        FP[d] = F0[d];
      }
    }
    if (kind == 1) {
      const T h = T(0.5) * dt;
      for (int d = m; d < D; d += gsz) HF[d] = Y[d] + h * F0[d];
      fo = rf.eval_lanes(fsh, sign * (t0 + h), HF, m, gsz, sync, b, B);
    } else if (kind == 2) {
      for (int d = m; d < D; d += gsz) HF[d] = Y[d] + dt * F0[d];
      fo = rf.eval_lanes(fsh, sign * t1, HF, m, gsz, sync, b, B);
    }
    // The correction in user space: g(sign t0, [y; sign f0]).
    for (int d = m; d < D; d += gsz) {
      HG[d] = Y[d];
      HG[D + d] = sign * F0[d];
    }
    sync();
    const T* go = rg.eval_lanes(gsh, sign * t0, HG, m, gsz, sync, b, B);
    const T sdt = sign * dt;
    T sdt_p = sdt * sdt;
    if (kind != 0) sdt_p = sdt_p * sdt;
    for (int d = m; d < D; d += gsz) {
      const T f0 = F0[d];
      const T base = kind == 0 ? f0
                               : (kind == 1 ? sign * fo[d]
                                            : T(0.5) * (f0 + sign * fo[d]));
      const T y1 = Y[d] + dt * base + sdt_p * go[d];
      Y[d] = y1;
      if (grid_is_t) out[long(step + 1) * BD + long(b) * D + d] = y1;
    }
  }
  if (!grid_is_t) {
    // The last interval: one f(t_end, y_end) and every time left.
    const T t0 = grid[G - 2];
    const T t1 = grid[G - 1];
    for (int d = m; d < D; d += gsz) HF[d] = Y[d];
    const T* fo = rf.eval_lanes(fsh, sign * t1, HF, m, gsz, sync, b, B);
    const int oi_new = drain_cursor(tau, oi, T_out, t1, true);
    for (int d = m; d < D; d += gsz)
      hermite_drain(out, tau, oi, oi_new, t0, t1, t1 - t0, YP[d], Y[d],
                    FP[d], sign * fo[d], BD, long(b) * D + d);
  }
}

// One launch of K12: the group from B (lane_group.h hyper_group), the
// slots in shared memory where the block's fit beside both right-hand
// sides' shares, the grid and the output times, else in `work` (work_size
// values; lane_group.h group_solve_work_size of hyper_solve_slot_values).
// Reports what it ran: layout = {threads a sample, samples a block, the
// slots in shared memory}.
template <typename T, class RF, class RG>
cudaError_t launch_rk_hyper_group(const void* grid, const void* tau,
                                  const void* y0, void* out, void* stats,
                                  void* work, long work_size, const RF& rf,
                                  const RG& rg, const HyperScalars<T>& sc_in,
                                  int* layout, cudaStream_t stream) {
  HyperScalars<T> sc = sc_in;
  const int group = hyper_group(sc.B);
  sc.group = group;
  sc.walk_f = int(rf.walk_values());
  sc.slot_values =
      int(hyper_solve_slot_values(sc.D, rf.walk_values(), rg.walk_values()));
  if (!group_size_ok(group) ||
      work_size < group_solve_work_size(sc.slot_values, sc.B, group, 0))
    return cudaErrorInvalidValue;
  const size_t fixed =
      sizeof(T) * (rf.smem_values() + rg.smem_values() + sc.G + sc.T_out);
  const size_t slots =
      sizeof(T) * size_t(group_samples(group)) * sc.slot_values;
  sc.slot_smem = fixed + slots <= size_t(kLaneSmemBytes);
  const size_t smem = fixed + (sc.slot_smem ? slots : 0);
  layout[0] = group;
  layout[1] = group_samples(group);
  layout[2] = sc.slot_smem;
  auto kernel = rk_hyper_group_kernel<T, RF, RG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int spb = group_samples(group);
  kernel<<<(sc.B + spb - 1) / spb, kGroupBlock, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(tau),
      static_cast<const T*>(y0), static_cast<T*>(out),
      static_cast<int*>(stats), static_cast<T*>(work), rf, rg, sc);
  return cudaGetLastError();
}

}  // namespace tfd
