// K15 inside its hosts: the augmented right-hand sides that run a
// generated plan's reverse walk (ops/plan_codegen.py `PlanAug`) in K3, K6
// and K9 (csrc/rk_adjoint.cuh), and the launch functions of a plan adjoint
// library.
//
// Replaces the TPU kernel function tfdiffeq_tpu/ops/plan_adjoint.py:154
// (make_plan_aug_eval), which walks a traced plan in reverse inside the
// Pallas adjoint kernels launched by plan_adjoint_solve (:529),
// plan_perlane_adjoint_solve (:469) and plan_adjoint_solve_fixed
// (tfdiffeq_tpu/ops/pallas_fixed.py:1019). Here the walk is CUDA C++
// generated for the plan's structure (one source per structure and host,
// built with nvcc at first use, ops/_build.py plan_libraries) and compiled
// into the adjoint engine in place of its MLP right-hand side.
//
// A generated `PlanAug` provides the constants of `Plan` (kDim, kOutRows,
// kSegments, kLiveRows, kRedValues), kQRows (the walk's per-sample output
// rows: each dot's input h and output cotangent c, each column, scalar and
// per-sample constant's cotangent, v_t), kNQuad (the flat constants'
// count: the shared quadratures), kTimeInput and kNSample (the per-sample
// constants' rows), and
//   seg<T>(k, t, y, ay, c, sc, b, B, live, red, qr, f, vy)
//                 segment k of the walk for sample b: y and ay its kDim
//                 state and output cotangent, f and vy its outputs (written
//                 by the last segment), qr the rows [kQRows][B];
//   meet(k, m)    the block meets that end segment k;
//   quad_x<T>(r, qr, B, b), sample_x<T>(j, qr, B, b)
//                 shared quadrature r's and per-sample quadrature j's term
//                 for sample b: a weight's element (o, i) the sum of
//                 c_s[o] h_s[i] over its dots s, a column's or a scalar's
//                 cotangent row, v_t last.
// A plan without a coupling is one segment.
//
// PlanAugRhs walks a sample at a time in its thread (K3, over the grid that
// cuts the batch into ranges, csrc/rk_adjoint.cuh); PlanGroupAug splits a
// sample's walk over its group of threads in K6 and K9 (group_stage);
// PlanBatchAugRhs (K3 and K9, one block; rk_adjoint_kernel and
// rk_fixed_adjoint_block_kernel) walks a stage batch-wide, segment
// by segment, every thread for the samples it owns, the block meeting at
// each coupling and at each coupling's transpose (csrc/plan_rhs.cuh
// BlockMeet: each thread's samples in order, then block_fold's tree),
// in the order ops/plan_adjoint.py aug_terms repeats (_batch_sums).
//
// The right-hand side's rows: qr [kQRows][B]; the batch route then its
// stage inputs X and AX and outputs FO and VO ([B][kDim] each), the live
// rows [kLiveRows][B] and the reduced values. Constants sit in shared
// memory when the launch says they fit (smem_consts), else they are read
// from global memory; so do the shared quadratures of K3 (quad_smem).
#pragma once

#include "plan_ops.cuh"
#include "plan_rhs.cuh"
#include "rk_adjoint.cuh"

namespace tfd {

template <typename T, class P>
struct PlanAugBase {
  const T* cg;    // constants (plan_codegen.flat_consts)
  const T* scg;   // per-sample constants [rows][B]
  int n_consts;
  int in_smem;    // copy the constants to shared memory
  static constexpr int n_w = P::kNQuad;
  static constexpr int ti = P::kTimeInput;
  static constexpr int n_ps = P::kNSample;

  struct Shared {
    int unused;
  };
  __device__ T* setup(Shared&, void*, unsigned char* smem) const {
    return plan_setup_consts<T>(cg, n_consts, in_smem, smem);
  }
  __device__ T sample_x(const Shared&, int j, const T* rw, int B,
                        int b) const {
    return P::template sample_x<T>(j, rw, B, b);
  }
  // Shared quadrature r's term for sample b (K9's one-block sweep).
  __device__ T quad_x(const Shared&, int r, const T* rw, int B,
                      int b) const {
    return P::template quad_x<T>(r, rw, B, b);
  }
  // sum(x) of shared quadrature r's per-sample term (csrc/rk_adjoint.cuh
  // quad).
  template <class Sum>
  __device__ T quad(const Shared&, int r, const T* rw, int B,
                    const Sum& sum) const {
    return sum([&](int b) { return P::template quad_x<T>(r, rw, B, b); });
  }
};

template <typename T, class P>
struct PlanAugRhs : PlanAugBase<T, P> {
  static_assert(P::kSegments == 1, "a per-thread walk has no coupling");
  static constexpr bool kBatch = false;
  static constexpr bool kGroup = false;
  using Shared = typename PlanAugBase<T, P>::Shared;
  struct Local {
    T ya[P::kDim], aya[P::kDim], f[P::kOutRows], vy[P::kDim];
  };
  __device__ T* setup(Shared& sh, Local&, unsigned char* smem) const {
    return PlanAugBase<T, P>::setup(sh, nullptr, smem);
  }
  __device__ T* ya(Local& lo) const { return lo.ya; }
  __device__ T* aya(Local& lo) const { return lo.aya; }
  // K3's stage of sample b: ky, kay its D values.
  __device__ void stage(const Shared&, Local& lo, T t, int b, int B, T sf,
                        T* ky, T* kay, T* rw) const {
    P::template seg<T>(0, t, lo.ya, lo.aya,
                       plan_consts(this->cg, this->in_smem), this->scg, b, B,
                       nullptr, nullptr, rw, lo.f, lo.vy);
    for (int d = 0; d < P::kDim; ++d) {
      ky[d] = (-sf) * lo.f[d];
      kay[d] = sf * lo.vy[d];
    }
  }
};

// K6's and K9's stage of sample b with its group of threads
// (csrc/rk_adjoint.cuh rk_perlane_adjoint_kernel, rk_fixed_adjoint_kernel):
// the generated group walk (`PlanAug::group_walk`, ops/plan_codegen.py),
// each row of a value computed by the member that owns it (row i: member
// i % gsz), a dot's outputs and the VJP dot's inputs over the
// members, a reduction by member 0, the group meeting (__syncwarp with its
// lanes' mask) only where a member reads a row another one wrote, and
// after the walk. Every row is the same expression as in the per-thread
// walk, computed in the same order, so the same bits. The walk's rows sit
// in the sample's slot gs, one value a row: the qr rows, the sample's
// per-sample constants (copied there once by group_init), the walk's own
// values, then f and v_y; so the walk runs with a row stride of 1 (B = 1,
// b = 0), in shared memory where the slots fit; member m then writes
// ky[d], kay[d] for d = m, m + gsz, ... The constants are the flat array
// and its transposed copy (n_consts counts both). The walk takes its group
// size from `walk_group` (kLaneGroup, set at launch), not the kernel's
// compile-time gsz: with the constant, K15 in K9 took 21.8 ms a spiral
// sweep against 13.7 (chip_ab.py, PERF.md §6).
template <typename T, class P>
struct PlanGroupAug : PlanAugBase<T, P> {
  static_assert(P::kSegments == 1, "a group walk has no coupling");
  static constexpr bool kBatch = false;
  using Shared = typename PlanAugBase<T, P>::Shared;
  struct Local {};
  int walk_group;   // == the engine's kLaneGroup

  long walk_values() const {
    return plan_aug_walk_values(P::kQRows, P::kNSample, P::kGroupValues,
                                P::kOutRows, P::kDim);
  }
  __device__ T* setup(Shared& sh, Local&, unsigned char* smem) const {
    return PlanAugBase<T, P>::setup(sh, nullptr, smem);
  }
  __device__ void group_init(const Shared&, T* gs, int b, int B, int m,
                             int gsz) const {
    for (int r = m; r < P::kNSample; r += gsz)
      gs[P::kQRows + r] = this->scg[long(r) * B + b];
  }
  __device__ void group_stage(const Shared&, Local&, T t, int, int, T sf,
                              const T* ya, const T* aya, T* ky, T* kay,
                              T* gs, int m, int gsz, unsigned mask) const {
    T* const ws = gs + P::kQRows + P::kNSample;
    T* const F = ws + P::kGroupValues;
    T* const VY = F + P::kOutRows;
    P::template group_walk<T>(t, ya, aya,
                              plan_consts(this->cg, this->in_smem),
                              gs + P::kQRows, 0, 1, gs, F, VY, ws, m,
                              walk_group, [mask]() { __syncwarp(mask); });
    for (int d = m; d < P::kDim; d += gsz) {
      ky[d] = (-sf) * F[d];
      kay[d] = sf * VY[d];
    }
  }
  __device__ T group_x(const Shared&, int r, const T* gs) const {
    constexpr int R = P::kNQuad + P::kTimeInput;
    return r < R ? P::template quad_x<T>(r, gs, 1, 0)
                 : P::template sample_x<T>(r - R, gs, 1, 0);
  }
};

// The rows of the batch-wide walk: qr [kQRows][B], X and AX the stage
// inputs, FO and VO the outputs ([B][kDim] each), the live rows
// [kLiveRows][B], then kRedValues reduced values.
template <class P>
inline long plan_batch_aug_values(int B) {
  return long(B) * (P::kQRows + 4L * P::kDim + P::kLiveRows) +
         P::kRedValues;
}

// K3's and K9's batch-wide walk (coupled plans, one block): its rows
// (plan_batch_aug_values) after the sweep's own.
template <typename T, class P>
struct PlanBatchAugRhs : PlanAugBase<T, P> {
  static constexpr bool kBatch = true;
  static constexpr bool kGroup = false;
  using Shared = typename PlanAugBase<T, P>::Shared;
  struct Local {
    T ya[P::kDim], aya[P::kDim];
  };
  __device__ T* setup(Shared& sh, Local&, unsigned char* smem) const {
    return PlanAugBase<T, P>::setup(sh, nullptr, smem);
  }
  __device__ T* ya(Local& lo) const { return lo.ya; }
  __device__ T* aya(Local& lo) const { return lo.aya; }
  __device__ void put(const Shared&, Local& lo, int b, int B, T* rw) const {
    T* X = rw + long(P::kQRows) * B;
    T* AX = X + long(B) * P::kDim;
    for (int d = 0; d < P::kDim; ++d) {
      X[long(b) * P::kDim + d] = lo.ya[d];
      AX[long(b) * P::kDim + d] = lo.aya[d];
    }
  }
  // Every thread: the walk's segments for its samples, the block meeting
  // between them; then ky, kay of its samples ([B][D] rows KY, KAY).
  __device__ void stage_batch(const Shared&, Local&, T t, int B, T sf,
                              T* KY, T* KAY, T* rw, T* scratch) const {
    T* qr = rw;
    T* X = rw + long(P::kQRows) * B;
    T* AX = X + long(B) * P::kDim;
    T* FO = AX + long(B) * P::kDim;
    T* VO = FO + long(B) * P::kDim;
    T* live = VO + long(B) * P::kDim;
    T* redv = live + long(B) * P::kLiveRows;
    const T* c = plan_consts(this->cg, this->in_smem);
    for (int k = 0; k < P::kSegments; ++k) {
      for (int b = threadIdx.x; b < B; b += blockDim.x)
        P::template seg<T>(k, t, X + long(b) * P::kDim,
                           AX + long(b) * P::kDim, c, this->scg, b, B, live,
                           redv, qr, FO + long(b) * P::kDim,
                           VO + long(b) * P::kDim);
      if (k + 1 < P::kSegments) {
        BlockMeet<T> m{live, redv, scratch, B};
        P::meet(k, m);
      }
    }
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      for (int d = 0; d < P::kDim; ++d) {
        KY[long(b) * P::kDim + d] = (-sf) * FO[long(b) * P::kDim + d];
        KAY[long(b) * P::kDim + d] = sf * VO[long(b) * P::kDim + d];
      }
  }
};

// ---- launch functions of a plan adjoint library (one host each) ----

template <typename T, class P>
int launch_plan_adjoint(const void* tau, const void* ys, const void* g,
                        void* ay0, void* aw, void* at, void* aps,
                        void* stats, void* work, void* pwork, int T_obs,
                        int B, int D, int threads, double dt0, double rtol,
                        double atol, double dt_min, double sign,
                        double safety, double ifactor, double dfactor,
                        int max_steps, int seminorm, int stages, int order,
                        const double* c, const double* a,
                        const double* b_sol, const double* b_err,
                        const void* consts, int n_consts,
                        const void* sample_consts, int smem_consts,
                        int quad_smem, void* gwork, long gwork_bytes,
                        int n_blocks, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_obs < 1 || B < 1 ||
      D != P::kDim || P::kOutRows != D || threads < kWarp ||
      threads > kAdjThreads || (threads & (threads - 1)) ||
      (!quad_smem && !pwork))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tableau<T> tab =
      make_tableau<T>(stages, order, 0, c, a, b_sol, b_err, nullptr);
  const AdjScalars<T> sc = make_adj_scalars<T>(
      dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps,
      T_obs, B, D, seminorm, quad_smem);
  const size_t smem =
      sizeof(T) *
      ((smem_consts ? size_t(n_consts) : 0) +
       (quad_smem ? size_t(rk_adjoint_quad_size(P::kNQuad, stages,
                                                P::kTimeInput))
                  : 0) +
       threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* cg = static_cast<const T*>(consts);
  const T* scg = static_cast<const T*>(sample_consts);
  cudaError_t e;
  if constexpr (P::kSegments > 1) {
    PlanBatchAugRhs<T, P> aug;
    aug.cg = cg;
    aug.scg = scg;
    aug.n_consts = n_consts;
    aug.in_smem = smem_consts;
    e = launch_rk_adjoint<T>(tau, ys, g, ay0, aw, at, aps, stats, work,
                             pwork, gwork, gwork_bytes, n_blocks, aug, smem,
                             threads, tab, sc, st);
  } else {
    PlanAugRhs<T, P> aug;
    aug.cg = cg;
    aug.scg = scg;
    aug.n_consts = n_consts;
    aug.in_smem = smem_consts;
    e = launch_rk_adjoint<T>(tau, ys, g, ay0, aw, at, aps, stats, work,
                             pwork, gwork, gwork_bytes, n_blocks, aug, smem,
                             threads, tab, sc, st);
  }
  return static_cast<int>(e);
}

template <typename T, class P>
PlanGroupAug<T, P> make_plan_group_aug(const void* consts, int n_consts,
                                       const void* sample_consts,
                                       int smem_consts) {
  PlanGroupAug<T, P> aug;
  aug.cg = static_cast<const T*>(consts);
  aug.scg = static_cast<const T*>(sample_consts);
  aug.n_consts = n_consts;
  aug.in_smem = smem_consts;
  aug.walk_group = kLaneGroup;
  return aug;
}

template <typename T, class P>
int launch_plan_perlane_adjoint(
    const void* tau, const void* ys, const void* g, const void* dt0,
    void* ay0, void* aw, void* at, void* aps, void* lane_stats, void* stats,
    void* partial, void* work, long work_size, int T_obs, int B, int D,
    int threads, double rtol, double atol, double dt_min, double sign,
    double safety, double ifactor, double dfactor, int max_steps, int stages,
    int order, const double* c, const double* a, const double* b_sol,
    const double* b_err, const void* consts, int n_consts,
    const void* sample_consts, int smem_consts, void* stream) {
  if constexpr (P::kSegments > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    bool any = false;
    for (int i = 0; i < stages && i < kMaxStages; ++i)
      any = any || b_sol[i] != 0.0;
    if (stages < 2 || stages > kMaxStages || T_obs < 1 || B < 1 ||
        D != P::kDim || P::kOutRows != D || max_steps < 1 ||
        threads != kLaneGroup * kLaneGroups || !any)
      return static_cast<int>(cudaErrorInvalidValue);
    const Tableau<T> tab =
        make_tableau<T>(stages, order, 0, c, a, b_sol, b_err, nullptr);
    PerlaneAdjScalars<T> sc;
    sc.rtol = T(rtol);
    sc.atol = T(atol);
    sc.dt_min = T(dt_min);
    sc.sign = T(sign);
    sc.safety = T(safety);
    sc.ifactor = T(ifactor);
    sc.dfactor = T(dfactor);
    sc.max_steps = max_steps;
    sc.T_obs = T_obs;
    sc.B = B;
    sc.D = D;
    const size_t fixed = sizeof(T) * (smem_consts ? size_t(n_consts) : 0);
    return static_cast<int>(launch_rk_perlane_adjoint<T>(
        tau, ys, g, dt0, ay0, aw, at, aps, lane_stats, stats, partial, work,
        work_size,
        make_plan_group_aug<T, P>(consts, n_consts, sample_consts,
                                  smem_consts),
        fixed, tab, sc, static_cast<cudaStream_t>(stream)));
  }
}

template <typename T, class P>
int launch_plan_fixed_adjoint(const void* tau, const void* ys, const void* g,
                              void* ay0, void* aw, void* at, void* aps,
                              void* stats, void* work, long work_size,
                              int T_obs, int B, int D, int threads,
                              int n_sub, double sign, int stages,
                              const double* c, const double* a,
                              const double* b_sol, const void* consts,
                              int n_consts, const void* sample_consts,
                              int smem_consts, void* stream) {
  bool any = false;
  for (int i = 0; i < stages && i < kMaxStages; ++i)
    any = any || b_sol[i] != 0.0;
  if (stages < 1 || stages > kMaxStages || T_obs < 1 || B < 1 ||
      n_sub < 1 || D != P::kDim || P::kOutRows != D ||
      threads != kLaneGroup * kLaneGroups || !any)
    return static_cast<int>(cudaErrorInvalidValue);
  // Fixed tableaus have no error weights: b_sol stands in for b_err.
  const Tableau<T> tab =
      make_tableau<T>(stages, 0, 0, c, a, b_sol, b_sol, nullptr);
  FixedAdjScalars<T> sc{};
  sc.sign = T(sign);
  sc.T_obs = T_obs;
  sc.B = B;
  sc.D = D;
  sc.n_sub = n_sub;
  const size_t fixed = sizeof(T) * (smem_consts ? size_t(n_consts) : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (P::kSegments > 1) {
    // A coupled plan: one block of `threads` = kAdjThreads threads walking
    // the batch (PlanBatchAugRhs, n_consts the flat constants), the meets'
    // scratch after the constants.
    const int n_q = P::kNQuad + P::kTimeInput + P::kNSample;
    if (threads != kAdjThreads ||
        work_size < fixed_block_own_values(stages, B, D, n_q) +
                        plan_batch_aug_values<P>(B))
      return static_cast<int>(cudaErrorInvalidValue);
    PlanBatchAugRhs<T, P> aug;
    aug.cg = static_cast<const T*>(consts);
    aug.scg = static_cast<const T*>(sample_consts);
    aug.n_consts = n_consts;
    aug.in_smem = smem_consts;
    return static_cast<int>(launch_rk_fixed_adjoint_block<T>(
        tau, ys, g, ay0, aw, at, aps, stats, work, aug,
        fixed + sizeof(T) * threads, threads, tab, sc, st));
  } else {
    return static_cast<int>(launch_rk_fixed_adjoint<T>(
        tau, ys, g, ay0, aw, at, aps, stats, work, work_size,
        make_plan_group_aug<T, P>(consts, n_consts, sample_consts,
                                  smem_consts),
        fixed, tab, sc, st));
  }
}

}  // namespace tfd

// The C entry points of a plan adjoint library, float32 and float64, for
// one host (ops/_build.py binds them by these names).
#define TFD_PLAN_ADJOINT_ENTRY(NAME, TYPE)                                   \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, void* ay0, void* aw,  \
      void* at, void* aps, void* stats, void* work, void* pwork, int T_obs, \
      int B, int D, int threads, double dt0, double rtol, double atol,      \
      double dt_min, double sign, double safety, double ifactor,            \
      double dfactor, int max_steps, int seminorm, int stages, int order,   \
      const double* c, const double* a, const double* b_sol,                \
      const double* b_err, const void* consts, int n_consts,                \
      const void* sample_consts, int smem_consts, int quad_smem,            \
      void* gwork, long gwork_bytes, int n_blocks, void* stream) {          \
    return tfd::launch_plan_adjoint<TYPE, tfd::PlanAug>(                    \
        tau, ys, g, ay0, aw, at, aps, stats, work, pwork, T_obs, B, D,      \
        threads, dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor,   \
        max_steps, seminorm, stages, order, c, a, b_sol, b_err, consts,     \
        n_consts, sample_consts, smem_consts, quad_smem, gwork, gwork_bytes,\
        n_blocks, stream);                                                   \
  }
#define TFD_PLAN_PERLANE_ADJOINT_ENTRY(NAME, TYPE)                           \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* dt0,      \
      void* ay0, void* aw, void* at, void* aps, void* lane_stats,           \
      void* stats, void* partial, void* work, long work_size, int T_obs,    \
      int B, int D, int threads, double rtol, double atol, double dt_min,   \
      double sign, double safety, double ifactor, double dfactor,           \
      int max_steps, int stages, int order, const double* c,                \
      const double* a, const double* b_sol, const double* b_err,            \
      const void* consts, int n_consts, const void* sample_consts,          \
      int smem_consts, void* stream) {                                       \
    return tfd::launch_plan_perlane_adjoint<TYPE, tfd::PlanAug>(            \
        tau, ys, g, dt0, ay0, aw, at, aps, lane_stats, stats, partial, work,\
        work_size, T_obs, B, D, threads, rtol, atol, dt_min, sign, safety,  \
        ifactor, dfactor, max_steps, stages, order, c, a, b_sol, b_err,     \
        consts, n_consts, sample_consts, smem_consts, stream);               \
  }
#define TFD_PLAN_FIXED_ADJOINT_ENTRY(NAME, TYPE)                             \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, void* ay0, void* aw,  \
      void* at, void* aps, void* stats, void* work, long work_size,         \
      int T_obs, int B, int D, int threads, int n_sub, double sign,         \
      int stages, const double* c, const double* a, const double* b_sol,    \
      const void* consts, int n_consts, const void* sample_consts,          \
      int smem_consts, void* stream) {                                       \
    return tfd::launch_plan_fixed_adjoint<TYPE, tfd::PlanAug>(              \
        tau, ys, g, ay0, aw, at, aps, stats, work, work_size, T_obs, B, D,  \
        threads, n_sub, sign, stages, c, a, b_sol, consts, n_consts,        \
        sample_consts, smem_consts, stream);                                 \
  }
