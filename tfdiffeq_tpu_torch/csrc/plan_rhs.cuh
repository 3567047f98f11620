// K14 inside its hosts: the right-hand sides that run a generated plan
// (ops/plan_codegen.py) in K2 (csrc/rk_solve.cuh), K8 (csrc/rk_fixed.cuh),
// K5 (csrc/rk_perlane.cuh), K10 (csrc/rk_adams.cuh), K11
// (csrc/rk_vcabm.cuh) and K12 (csrc/rk_hyper.cuh, two plans: the dynamics
// `Plan` and the correction net `PlanG`), and the launch functions of a
// plan library.
//
// Replaces the TPU kernel functions tfdiffeq_tpu/ops/jaxpr_bridge.py:826
// (eval_plan) and :1000 (make_plan_f), which walk a traced plan inside the
// Pallas solve kernels launched by plan_solve (:1038) and plan_solve_fixed
// (tfdiffeq_tpu/ops/pallas_fixed.py:1167). Where Mosaic unrolled the walk
// when it compiled each plan structure, a plan here is generated as CUDA
// C++ (one source per structure and host, built with nvcc at first use and
// cached by the structure, ops/_build.py plan_library) and compiled into
// the host kernel in place of its MLP right-hand side.
//
// A generated `Plan` provides kDim, kOutRows, kSegments, kLiveRows and
// kRedValues, seg<T>(k, t, y, c, sc, b, B, live, red, out) (segment k of
// the plan for sample b: y its kDim inputs, c the constants, sc the
// per-sample constants as [rows][B], live the workspace rows [kLiveRows][B]
// of values that outlive a segment, red the reduced values, out its
// kOutRows outputs, written by the last segment) and meet(k, m) (the batch
// couplings that end segment k, handed to m(kind, row, rows, red_off,
// to_scalar)). A plan without a coupling is one segment.
//
// PlanRhs evaluates a sample at a time in its thread (K2, K11 and
// fixed_adams' K10, for uncoupled plans, over their grids). PlanLaneRhs
// walks a sample with a group of threads (K5, K8, explicit_adams' K10 and
// both plans of K12: csrc/rk_perlane.cuh, rk_fixed.cuh, rk_adams.cuh and
// rk_hyper.cuh rk_*_group_kernel): the generated group walk (`Plan::
// group_walk`, ops/plan_codegen.py), each row of a value computed by the
// member that owns it, a dot's outputs over the members, the group meeting
// only where a member reads a row another one wrote; every row the same
// expression as in the per-thread walk, so the same bits. Its values sit in
// the sample's slot after its D inputs; its constants are the flat array
// and its transposed copy (plan_codegen.flat_consts(transposed=True)), in
// shared memory where they fit.
// PlanBatchRhs (K2) and PlanBlockRhs (K8, K10 and K11), on one block,
// evaluate a stage batch-wide (plan_batch_eval): every thread runs segment
// k for the samples it owns, writing the rows a coupling reduces into live
// rows; the block then meets and reduces them (each thread's samples in
// order from 0, or from -inf / +inf for max / min, then block_fold's fixed
// tree over the threads; a to-scalar coupling folds its row results in row
// order), and segment k + 1 runs. ops/plan_bridge.py eval_plan repeats
// that order (_batch_sums) for a block of kPlanBlockThreads threads.
//
// Constants sit in shared memory when the launch says they fit
// (smem_consts, from ops/cuda_plan.py against cuda_kernels.
// MAX_WEIGHT_BYTES), else they are read from global memory.
#pragma once

#include "dot_tiers.cuh"
#include "mlp_rk.cuh"
#include "plan_ops.cuh"
#include "rk_adams.cuh"
#include "rk_fixed.cuh"
#include "rk_hyper.cuh"
#include "rk_perlane.cuh"
#include "rk_solve.cuh"
#include "rk_vcabm.cuh"

namespace tfd {

// The constants into shared memory when `in_smem` (no barrier); returns
// the free shared memory.
template <typename T>
__device__ __forceinline__ T* plan_setup_consts(const T* cg, int n_consts,
                                                int in_smem,
                                                unsigned char* smem) {
  T* s = reinterpret_cast<T*>(smem);
  if (!in_smem) return s;
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) s[i] = cg[i];
  return s + n_consts;
}

// Where the segments read the constants: shared memory (plan_setup_consts
// copied them) or global memory. It is worked out at each evaluation, not
// kept in a per-thread struct, where a store could alias it.
// `off` is where they start in shared memory: 0, or past the first plan's
// for K12's second plan (PlanLaneRhs::smem_off).
template <typename T>
__device__ __forceinline__ const T* plan_consts(const T* cg, int in_smem,
                                                int off = 0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return in_smem ? reinterpret_cast<const T*>(smem_raw) + off : cg;
}

template <typename T, class P>
struct PlanRhs {
  static_assert(P::kSegments == 1, "a per-thread plan has no coupling");
  static constexpr bool kBatch = false;
  static constexpr int kUnit = 1;       // K2's grid: a block any samples
  static constexpr bool kGrid = true;
  static constexpr bool kGroup = false;  // its vectors stay in registers
  const T* cg;    // constants (plan_codegen.flat_consts)
  const T* scg;   // per-sample constants [rows][B]
  int n_consts;
  int in_smem;    // copy the constants to shared memory

  struct Shared {
    int unused;
  };
  struct Local {
    T in[P::kDim];
    T out[P::kOutRows];
  };

  __device__ int spb() const { return blockDim.x; }
  __device__ T* setup(Shared&, Local&, unsigned char* smem, int = 0,
                      int = 0) const {
    return plan_setup_consts<T>(cg, n_consts, in_smem, smem);
  }
  __device__ T* in(Local& lo) const { return lo.in; }
  __device__ const T* eval(const Shared&, Local& lo, T t, int b, int B,
                           T* = nullptr) const {
    P::template seg<T>(0, t, lo.in, plan_consts(cg, in_smem), scg, b, B,
                       nullptr, nullptr, lo.out);
    return lo.out;
  }
};

// The group walk of K5, K8, explicit_adams' K10 and K12 (csrc/
// lane_group.h). n_consts counts both copies of the constants. K12's
// correction net keeps its constants in shared memory past the dynamics'
// (smem_off values in).
template <typename T, class P>
struct PlanLaneRhs {
  static_assert(P::kSegments == 1, "a group walk has no coupling");
  const T* cg;    // the constants and their transposed copy
  const T* scg;   // per-sample constants [rows][B]
  int n_consts;
  int in_smem;
  int smem_off = 0;

  struct Shared {
    int unused;
  };
  long smem_values() const { return in_smem ? n_consts : 0; }
  long wt_values() const { return 0; }
  long walk_values() const {
    return plan_solve_walk_values(P::kDim, P::kOutRows, P::kGroupValues);
  }
  __device__ T* setup(Shared&, unsigned char* smem) const {
    return plan_setup_consts<T>(cg, n_consts, in_smem, smem);
  }
  // Sample b's outputs from its D inputs at hin; the walk's values follow
  // them, then the outputs.
  template <class Sync>
  __device__ const T* eval_lanes(const Shared&, T t, T* hin, int m, int gsz,
                                 const Sync& sync, int b, int B) const {
    T* const gs = hin + P::kDim;
    T* const out = gs + P::kGroupValues;
    P::template group_walk<T>(t, hin, plan_consts(cg, in_smem, smem_off),
                              scg, b, B, gs, out, m, gsz, sync);
    return out;
  }
};

// Sum, max or min of one value per thread in a fixed tree order (every
// thread returns it); blockDim.x a power of two, red [blockDim.x].
template <typename T>
__device__ T block_fold(T v, T* red, int kind) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const T a = red[tid], b = red[tid + s];
      red[tid] = kind == 0 ? a + b : (kind == 1 ? p_max(a, b) : p_min(a, b));
    }
    __syncthreads();
  }
  const T total = red[0];
  __syncthreads();
  return total;
}

// The block's meet at a batch coupling: live rows [row, row + rows) reduced
// over the batch into red[off ...], and with to_scalar their fold into
// red[off + rows].
template <typename T>
struct BlockMeet {
  const T* live;
  T* red;
  T* scratch;   // [blockDim.x]
  int B;
  __device__ void operator()(int kind, int row, int rows, int off,
                             int to_scalar) {
    const T init = kind == 0 ? T(0) : (kind == 1 ? -T(HUGE_VAL) : T(HUGE_VAL));
    for (int r = 0; r < rows; ++r) {
      T p = init;
      for (int b = threadIdx.x; b < B; b += blockDim.x) {
        const T v = live[long(row + r) * B + b];
        p = kind == 0 ? p + v : (kind == 1 ? p_max(p, v) : p_min(p, v));
      }
      const T total = block_fold(p, scratch, kind);
      if (threadIdx.x == 0) red[off + r] = total;
    }
    if (to_scalar && threadIdx.x == 0) {
      T s = red[off];
      for (int r = 1; r < rows; ++r)
        s = kind == 0 ? s + red[off + r]
                      : (kind == 1 ? p_max(s, red[off + r])
                                   : p_min(s, red[off + r]));
      red[off + rows] = s;
    }
    __syncthreads();
  }
};

// Threads of the one block that runs a coupled plan in K8, K10 and K11 (and
// K2 and K3 launch as many): the block meets' tree over them is the order
// of ops/plan_bridge.py _batch_sums at cuda_plan.PLAN_BLOCK_THREADS.
constexpr int kPlanBlockThreads = 512;

// The rows of a batch-wide evaluation: X [B][kDim] stage inputs, FO
// [B][kOutRows] outputs, the live rows [kLiveRows][B], then kRedValues
// reduced values.
template <class P>
inline long plan_batch_values(int B) {
  return long(B) * (P::kDim + P::kOutRows + P::kLiveRows) + P::kRedValues;
}

// One batch-wide evaluation of the plan at t from the inputs in the rows
// `rw` (plan_batch_values), by every thread of the block; scratch
// [blockDim.x] is the block meets' (BlockMeet). Returns FO, sample b's
// outputs at b * kOutRows. The samples' inputs were written by the threads
// that own them here (b = threadIdx.x, + blockDim.x, ...), and the outputs
// are read by them.
template <typename T, class P>
__device__ const T* plan_batch_eval(T t, T* rw, const T* c, const T* scg,
                                    T* scratch, int B) {
  const T* X = rw;
  T* FO = rw + long(B) * P::kDim;
  T* live = FO + long(B) * P::kOutRows;
  T* redv = live + long(B) * P::kLiveRows;
  for (int k = 0; k < P::kSegments; ++k) {
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      P::template seg<T>(k, t, X + long(b) * P::kDim, c, scg, b, B, live,
                         redv, FO + long(b) * P::kOutRows);
    if (k + 1 < P::kSegments) {
      BlockMeet<T> m{live, redv, scratch, B};
      P::meet(k, m);
    }
  }
  return FO;
}

// K2's batch-wide plan route (coupled plans): its rows (plan_batch_values)
// after the solve's own workspace. Its block meets inside a stage, so it
// runs on one block (kGrid false).
template <typename T, class P>
struct PlanBatchRhs {
  static constexpr bool kBatch = true;
  static constexpr int kUnit = 1;
  static constexpr bool kGrid = false;
  static constexpr bool kGroup = false;
  const T* cg;
  const T* scg;
  int n_consts;
  int in_smem;

  struct Shared {
    int unused;
  };
  struct Local {
    T t;
  };

  __device__ T* setup(Shared&, Local&, unsigned char* smem, int,
                      int) const {
    return plan_setup_consts<T>(cg, n_consts, in_smem, smem);
  }
  template <class G>
  __device__ void put(const Shared&, Local& lo, int b, T t, G get, T* rw,
                      int) const {
    lo.t = t;
    T* x = rw + long(b) * P::kDim;
    for (int d = 0; d < P::kDim; ++d) x[d] = get(d);
  }
  __device__ const T* eval_batch(const Shared&, Local& lo, T* rw, T* scratch,
                                 int B, int, int) const {
    return plan_batch_eval<T, P>(lo.t, rw, plan_consts(cg, in_smem), scg,
                                 scratch, B);
  }
  __device__ long ld(const Local&) const { return P::kOutRows; }
};

// The batch-wide plan route of K8 (csrc/rk_fixed.cuh rk_fixed_kernel, its
// kBatch contract with spb() = B), fixed_adams' and explicit_adams' K10
// (rk_adams.cuh rk_adams_grid_kernel) and K11 (rk_vcabm.cuh
// rk_vcabm_kernel), each on one block of kPlanBlockThreads threads: the
// host puts each of its samples' stage inputs (put), meets the block, and
// every thread runs eval_batch (plan_batch_eval). Its rows `rw`
// (plan_batch_values) follow the host's own in the workspace; the block
// meets' scratch [blockDim.x] follows the constants in shared memory (where
// they sit there), and the host's own shared arrays follow it (K8's grid
// and output times where `times_smem`, else none: they stay in global
// memory, as on K4's batch route). Replaces the coupled plans of
// tfdiffeq_tpu/ops/pallas_fixed.py:1167 (plan_solve_fixed), :1143
// (plan_solve_adams) and pallas_vcabm.py:449 (plan_solve_vcabm), which run
// one grid block there. Bound on the H100: one SM walks the batch, 8
// samples a thread at B = 4096, and every coupling is a block barrier
// chain (block_fold): latency, thousands of times the card's bound in
// bytes or operations (PERF.md §6); a simple route that is right first.
template <typename T, class P>
struct PlanBlockRhs {
  static constexpr bool kBatch = true;
  static constexpr bool kGroup = false;
  const T* cg;    // constants (plan_codegen.flat_consts)
  const T* scg;   // per-sample constants [rows][B]
  int n_consts;
  int in_smem;
  T* rw;          // the rows (plan_batch_values)
  int B;
  int times_smem;  // K8: the grid and the output times in shared memory

  struct Shared {
    int unused;
  };
  struct Local {
    T t = T(0);
  };

  __device__ int spb() const { return B; }
  __device__ T* scratch() const {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<T*>(smem_raw) + (in_smem ? n_consts : 0);
  }
  // K10, K11: the free shared memory past the scratch.
  __device__ T* setup(Shared&, Local&, unsigned char* smem) const {
    return plan_setup_consts<T>(cg, n_consts, in_smem, smem) + blockDim.x;
  }
  // K8: the same, or null where the grid stays in global memory.
  __device__ T* setup(Shared& sh, Local& lo, unsigned char* smem, int,
                      int) const {
    T* const rest = setup(sh, lo, smem);
    return times_smem ? rest : nullptr;
  }
  template <class G>
  __device__ void put(const Shared&, Local& lo, int b, T t, G get) const {
    lo.t = t;
    T* x = rw + long(b) * P::kDim;
    for (int d = 0; d < P::kDim; ++d) x[d] = get(d);
  }
  __device__ const T* eval_batch(const Shared&, const Local& lo, int,
                                 int) const {
    return plan_batch_eval<T, P>(lo.t, rw, plan_consts(cg, in_smem), scg,
                                 scratch(), B);
  }
  __device__ long ld() const { return P::kOutRows; }
};

// ---- K4 at a plan's dots: the tile route of K2, K8 and K5 ----
//
// A plan generated at a reduced tier (ops/plan_codegen.py _Gen with a
// dot_precision: every dot whose mxu flag is set ends a segment) runs over
// a block's rows: each segment a thread a sample, elementwise over the
// block's rows as plan_batch_eval runs a coupled plan's segments; each
// tiered dot K4's product on the block's tiles of 16 rows (dot_tiers.cuh
// plan_tile_dot on the tensor cores in float32, plan_dot_scalar on the CUDA
// cores in float64), from the live rows its segment stored to the dot's own
// live rows, which the next segments load; each coupling the block meet of
// plan_batch_eval (a coupled plan runs on one block). Replaces the tiered
// dots of tfdiffeq_tpu/ops/jaxpr_bridge.py:979-983 (eval_plan, through
// make_plan_f :1000) inside the reference's plan_solve (:1038, with and
// without per_sample) and plan_solve_fixed (pallas_fixed.py:1167).
// ops/plan_bridge.py eval_plan(dot_precision=...) with cuda_kernels.
// dot_tier_plain is its plain version: float64 bitwise, float32 to the
// tensor cores' summation order.
//
// Its workspace (plan_tile_bytes, ops/cuda_plan.py tile_work_bytes): the
// tiered dots' bf16 weights (P::kW16 values, 256-byte aligned), then the
// stage inputs X [B][kDim], each row's time [B], the outputs FO
// [B][kOutRows], the live rows [kLiveRows][B] and the reduced values. Its
// shared memory: K4's tiles (float32), then a block's [blockDim.x] meet
// scratch (K2's reduction scratch).

template <class P>
inline long plan_tile_w16_bytes() {
  return (2 * P::kW16 + 255) / 256 * 256;
}

template <class P>
inline long plan_tile_bytes(int B, long item) {
  return plan_tile_w16_bytes<P>() +
         item * (long(B) * (P::kDim + 1 + P::kOutRows + P::kLiveRows) +
                 P::kRedValues);
}

// The tiered dots' weights into bf16 ([pad16(dout)][pad16(din)] from the
// flat constants' [dout][din], zeros in the padding; tier_pack_kernel's
// element rule), one grid-stride pass a dot.
template <typename T, class P>
__global__ void plan_tier_pack_kernel(const T* __restrict__ c,
                                      __nv_bfloat16* __restrict__ w16) {
  const long stride = long(gridDim.x) * blockDim.x;
  for (int j = 0; j < P::kTierDots; ++j) {
    const TierDot d = P::tier_dot(j);
    const int din_p = pad16(d.din);
    const long n = long(pad16(d.dout)) * din_p;
    for (long e = long(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
         e += stride) {
      const int o = int(e / din_p), i = int(e % din_p);
      const float v = (o < d.dout && i < d.din)
                          ? float(c[d.w_off + long(o) * d.din + i])
                          : 0.0f;
      w16[d.w16_off + e] = __float2bfloat16_rn(v);
    }
  }
}

template <typename T, class P>
struct PlanTileRhs {
  static constexpr bool kBatch = true;
  static constexpr int kUnit = 16;                   // K4's tile rows
  static constexpr bool kGrid = P::kCouplings == 0;  // else one block
  static constexpr bool kGroup = false;
  const T* cg;     // constants (plan_codegen.flat_consts), global memory
  const T* scg;    // per-sample constants [rows][B]
  const __nv_bfloat16* w16;
  T* X;            // [B][kDim] stage inputs
  T* tr;           // [B] each row's time
  T* FO;           // [B][kOutRows] outputs
  T* live;         // [kLiveRows][B]
  T* redv;         // [kRedValues]
  int B;
  int spb_;        // K8: rows a block
  int rest;        // K2: setup returns the meet scratch (its reduction's)
  TierTile tt;     // float32: K4's tiles at the start of shared memory

  struct Shared {
    int unused;
  };
  struct Local {};

  // The workspace's pointers for B samples.
  static PlanTileRhs make(const void* consts, const void* sample_consts,
                          void* tile_work, int B, int n_warps,
                          long block_rows) {
    PlanTileRhs r{};
    unsigned char* base = static_cast<unsigned char*>(tile_work);
    r.cg = static_cast<const T*>(consts);
    r.scg = static_cast<const T*>(sample_consts);
    r.w16 = reinterpret_cast<const __nv_bfloat16*>(base);
    r.X = reinterpret_cast<T*>(base + plan_tile_w16_bytes<P>());
    r.tr = r.X + long(B) * P::kDim;
    r.FO = r.tr + B;
    r.live = r.FO + long(B) * P::kOutRows;
    r.redv = r.live + long(B) * P::kLiveRows;
    r.B = B;
    if (sizeof(T) == sizeof(float)) {
      r.tt = tier_tile_for(P::kTierWidth, P::kTierWidth, n_warps,
                           block_rows);
    } else {
      r.tt = TierTile{};
      r.tt.bytes = 0;
    }
    return r;
  }
  __host__ __device__ size_t tile_smem() const {
    return tt.bytes > 0 ? size_t(tt.bytes) : 0;
  }
  __device__ T* scratch() const {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<T*>(smem_raw + tile_smem());
  }

  __device__ int spb() const { return spb_; }
  // K2 (the reduction scratch after the tiles), K8 (null: the grid and the
  // output times stay in global memory, as on K4's MLP batch route) and
  // K5's tile engine.
  __device__ T* setup(Shared&, Local&, unsigned char*, int, int) const {
    return rest ? scratch() : nullptr;
  }
  // K2.
  template <class G>
  __device__ void put(const Shared&, Local&, int b, T t, G get, T*,
                      int) const {
    tr[b] = t;
    T* x = X + long(b) * P::kDim;
    for (int d = 0; d < P::kDim; ++d) x[d] = get(d);
  }
  // K8.
  template <class G>
  __device__ void put(const Shared& sh, Local& lo, int b, T t, G get) const {
    put(sh, lo, b, t, get, nullptr, 0);
  }
  // K5's tile engine.
  __device__ void put_elem(const Shared&, Local&, int b, int d, T t,
                           T v) const {
    X[long(b) * P::kDim + d] = v;
    if (d == 0) tr[b] = t;
  }

  // The block's meets: a tiered dot's product on its rows, or (a coupled
  // plan, on one block) BlockMeet's reduction over the batch.
  struct Meet {
    const PlanTileRhs* r;
    int row0, nr;
    __device__ void dot(int j) {
      extern __shared__ __align__(16) unsigned char smem_raw[];
      const TierDot d = P::tier_dot(j);
      if constexpr (sizeof(T) == sizeof(float))
        plan_tile_dot(r->live, r->B, d.in_row, d.out_row, d.din, d.dout,
                      r->w16 + d.w16_off, r->tt, smem_raw, row0, nr,
                      P::kTier);
      else
        plan_dot_scalar<T>(r->live, r->B, d.in_row, d.out_row, d.din,
                           d.dout, r->w16 + d.w16_off, row0, nr, P::kTier);
    }
    __device__ void operator()(int kind, int row, int rows, int off,
                               int to_scalar) {
      BlockMeet<T> m{r->live, r->redv, r->scratch(), r->B};
      m(kind, row, rows, off, to_scalar);
    }
  };

  // The block's rows [row0, row0 + nr) (nr a multiple of 16), every thread,
  // after a barrier; returns after one, sample b's outputs at b * kOutRows.
  __device__ const T* eval_rows(int row0, int nr) const {
    const int hi = row0 + nr < B ? row0 + nr : B;
    for (int k = 0; k < P::kSegments; ++k) {
      for (int b = row0 + threadIdx.x; b < hi; b += blockDim.x)
        P::template seg<T>(k, tr[b], X + long(b) * P::kDim, cg, scg, b, B,
                           live, redv, FO + long(b) * P::kOutRows);
      __syncthreads();
      if (k + 1 < P::kSegments) {
        Meet m{this, row0, nr};
        P::meet(k, m);
      }
    }
    return FO;
  }
  // K2.
  __device__ const T* eval_batch(const Shared&, Local&, T*, T*, int,
                                 int r0, int nr) const {
    return eval_rows(r0, nr);
  }
  // K8 and K5.
  __device__ const T* eval_batch(const Shared&, Local&, int row0,
                                 int nr) const {
    return eval_rows(row0, nr);
  }
  __device__ long ld(const Local&) const { return P::kOutRows; }
  __device__ long ld() const { return P::kOutRows; }
};

// The tiled plan's bf16 weights, before the solve on the same stream.
template <typename T, class P>
cudaError_t launch_plan_tier_pack(const void* consts, void* tile_work,
                                  cudaStream_t stream) {
  plan_tier_pack_kernel<T, P><<<64, 256, 0, stream>>>(
      static_cast<const T*>(consts),
      reinterpret_cast<__nv_bfloat16*>(tile_work));
  return cudaGetLastError();
}

// ---- launch functions of a plan library (one host each) ----

template <typename T, class P>
int launch_plan_solve(const void* tau, const void* y0, const void* f0,
                      void* out, void* stats, void* work, int T_out, int B,
                      int D, int threads, double dt0, double rtol,
                      double atol, double dt_min, double sign,
                      double safety, double ifactor, double dfactor,
                      int max_steps, int valid, int stages, int order,
                      int fsal, const double* c, const double* a,
                      const double* b_sol, const double* b_err,
                      const double* c_mid, const void* consts, int n_consts,
                      const void* sample_consts, int smem_consts,
                      void* gwork, long gwork_bytes, int n_blocks,
                      void* meta, void* coef, int dense_S, void* tile_work,
                      long tile_bytes, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_out < 1 || B < 1 ||
      D != P::kDim || P::kOutRows != D || threads < 32 ||
      threads > kSolveThreads || (threads & (threads - 1)) ||
      dense_S < 0 || (dense_S > 0 && (!meta || !coef)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tableau<T> tab =
      make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);
  Scalars<T> sc =
      make_scalars<T>(dt0, rtol, atol, dt_min, sign, safety, ifactor,
                      dfactor, max_steps, valid, T_out, B, D);
  // K2's dense output (csrc/rk_solve.cuh): null buffers and 0 without it.
  if (dense_S > 0) {
    sc.meta = static_cast<T*>(meta);
    sc.coef = static_cast<T*>(coef);
    sc.dense_S = dense_S;
  }
  const size_t smem =
      sizeof(T) * ((smem_consts ? size_t(n_consts) : 0) + threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* cg = static_cast<const T*>(consts);
  const T* scg = static_cast<const T*>(sample_consts);
  cudaError_t e;
  if constexpr (P::kTierDots > 0) {
    // The tile route: each block its share of the 16-row tiles (a coupled
    // plan all of them on one block), the constants in global memory.
    const long tiles = (B + 15) / 16;
    if (!tile_work || tile_bytes < plan_tile_bytes<P>(B, sizeof(T)) ||
        n_blocks < 1 || n_blocks > tiles)
      return static_cast<int>(cudaErrorInvalidValue);
    auto rhs = PlanTileRhs<T, P>::make(consts, sample_consts, tile_work, B,
                                       threads / kWarpSize,
                                       16 * ((tiles + n_blocks - 1) /
                                             n_blocks));
    rhs.rest = 1;
    if (rhs.tt.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
    e = launch_plan_tier_pack<T, P>(consts, tile_work, st);
    if (e == cudaSuccess)
      e = launch_rk_solve<T>(tau, y0, f0, out, stats, work, gwork,
                             gwork_bytes, n_blocks, rhs,
                             rhs.tile_smem() + sizeof(T) * threads, threads,
                             tab, sc, st);
  } else if constexpr (P::kSegments > 1)
    e = launch_rk_solve<T>(tau, y0, f0, out, stats, work, gwork, gwork_bytes,
                           n_blocks,
                           PlanBatchRhs<T, P>{cg, scg, n_consts, smem_consts},
                           smem, threads, tab, sc, st);
  else
    e = launch_rk_solve<T>(tau, y0, f0, out, stats, work, gwork, gwork_bytes,
                           n_blocks,
                           PlanRhs<T, P>{cg, scg, n_consts, smem_consts},
                           smem, threads, tab, sc, st);
  return static_cast<int>(e);
}

// K8 with the plan: an uncoupled plan `group` threads a sample
// (PlanLaneRhs, n_consts counting the transposed copy); a coupled one on
// one block of `group` = kPlanBlockThreads threads (rk_fixed_kernel with
// PlanBlockRhs, n_consts the flat constants), its rows after the engine's
// (stages + 3) B D values, the grid and output times in shared memory after
// the constants and the scratch where they fit.
template <typename T, class P>
int launch_plan_fixed(const void* grid, const void* tau, const void* y0,
                      const void* f0, void* out, void* stats, void* work,
                      long work_size, int G, int T_out, int B, int D,
                      int group, double sign, int valid, int stages,
                      const double* c, const double* a, const double* b_sol,
                      const void* consts, int n_consts,
                      const void* sample_consts, int smem_consts,
                      void* tile_work, long tile_bytes, void* stream) {
  if (stages < 1 || stages > kMaxStages || G < 1 || T_out < 1 || B < 1 ||
      D != P::kDim || P::kOutRows != D)
    return static_cast<int>(cudaErrorInvalidValue);
  // Fixed tableaus have no error weights: b_sol stands in for b_err.
  const Tableau<T> tab =
      make_tableau<T>(stages, 0, 0, c, a, b_sol, b_sol, nullptr);
  FixedScalars<T> sc{};
  sc.sign = T(sign);
  sc.valid = valid;
  sc.G = G;
  sc.T_out = T_out;
  sc.B = B;
  sc.D = D;
  const T* cg = static_cast<const T*>(consts);
  const T* scg = static_cast<const T*>(sample_consts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (P::kTierDots > 0) {
    // The tile route (rk_fixed_kernel): a block of `group` = kTileThreads
    // threads a 16-row tile, or a coupled plan's whole batch on one such
    // block (its meets fold over those threads; rk_fixed_kernel has no
    // launch bound, and a wide plan's segments leave too few registers for
    // kPlanBlockThreads); the grid and the output times in global memory.
    const int rows = P::kCouplings > 0 ? (B + 15) / 16 * 16 : kTileRows;
    if (group != kTileThreads ||
        work_size < long(stages + 3) * B * D || !tile_work ||
        tile_bytes < plan_tile_bytes<P>(B, sizeof(T)))
      return static_cast<int>(cudaErrorInvalidValue);
    auto rhs = PlanTileRhs<T, P>::make(consts, sample_consts, tile_work, B,
                                       group / kWarpSize, rows);
    rhs.spb_ = rows;
    rhs.rest = 0;
    if (rhs.tt.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = launch_plan_tier_pack<T, P>(consts, tile_work, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(launch_rk_fixed<T>(
        grid, tau, y0, f0, out, stats, work, rhs,
        rhs.tile_smem() + sizeof(T) * group, group, rows, tab, sc, st));
  } else if constexpr (P::kSegments > 1) {
    const long own = long(stages + 3) * B * D;
    if (group != kPlanBlockThreads ||
        work_size < own + plan_batch_values<P>(B))
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t head =
        sizeof(T) * ((smem_consts ? size_t(n_consts) : 0) + group);
    const size_t times = sizeof(T) * (size_t(G) + T_out);
    const int times_smem = head + times <= size_t(kSolveSmemBytes);
    const PlanBlockRhs<T, P> rhs{cg, scg, n_consts, smem_consts,
                                 static_cast<T*>(work) + own, B, times_smem};
    return static_cast<int>(launch_rk_fixed<T>(
        grid, tau, y0, f0, out, stats, work, rhs,
        head + (times_smem ? times : 0), group, B, tab, sc, st));
  } else {
    return static_cast<int>(launch_rk_fixed_group<T>(
        grid, tau, y0, f0, out, stats, work, work_size,
        PlanLaneRhs<T, P>{cg, scg, n_consts, smem_consts}, group, tab, sc,
        st));
  }
}

// K5 with the plan: `group` threads a sample (PlanLaneRhs, n_consts
// counting the transposed copy).
template <typename T, class P>
int launch_plan_perlane(const void* tau, const void* y0, const void* f0,
                        const void* dt0, void* out, void* lane_stats,
                        void* stats, void* work, long work_size, int T_out,
                        int B, int D, int group, double rtol, double atol,
                        double dt_min,
                        double sign, double safety, double ifactor,
                        double dfactor, int max_steps, int valid, int stages,
                        int order, int fsal, const double* c,
                        const double* a, const double* b_sol,
                        const double* b_err, const double* c_mid,
                        const void* consts, int n_consts,
                        const void* sample_consts, int smem_consts,
                        void* tile_work, long tile_bytes, void* stream) {
  if constexpr (P::kCouplings > 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (P::kTierDots > 0) {
    // K5's tile engine: kTileRows samples a block in lockstep.
    if (stages < 2 || stages > kMaxStages || T_out < 1 || B < 1 ||
        D != P::kDim || P::kOutRows != D || max_steps < 1 ||
        group != kTileThreads || !tile_work ||
        tile_bytes < plan_tile_bytes<P>(B, sizeof(T)))
      return static_cast<int>(cudaErrorInvalidValue);
    const Tableau<T> tab =
        make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);
    const PerlaneScalars<T> sc = make_perlane_scalars<T>(
        rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps, valid,
        T_out, B, D);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto rhs = PlanTileRhs<T, P>::make(consts, sample_consts, tile_work, B,
                                       kTileThreads / kWarpSize, kTileRows);
    rhs.spb_ = kTileRows;
    rhs.rest = 0;
    if (rhs.tt.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = launch_plan_tier_pack<T, P>(consts, tile_work, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(launch_rk_perlane_tile<T>(
        tau, y0, f0, dt0, out, lane_stats, stats, work, work_size, rhs,
        rhs.tile_smem(), tab, sc, st));
  } else {
    if (stages < 2 || stages > kMaxStages || T_out < 1 || B < 1 ||
        D != P::kDim || P::kOutRows != D || max_steps < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const Tableau<T> tab =
        make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);
    const PerlaneScalars<T> sc = make_perlane_scalars<T>(
        rtol, atol, dt_min, sign, safety, ifactor, dfactor, max_steps, valid,
        T_out, B, D);
    return static_cast<int>(launch_rk_perlane_group<T>(
        tau, y0, f0, dt0, out, lane_stats, stats, work, work_size,
        PlanLaneRhs<T, P>{static_cast<const T*>(consts),
                          static_cast<const T*>(sample_consts), n_consts,
                          smem_consts},
        group, tab, sc, static_cast<cudaStream_t>(stream)));
  }
}

// K10 with the plan. Uncoupled: fixed_adams on K10's grid, a thread a
// sample (PlanRhs, n_consts the flat constants); explicit_adams `group`
// threads a sample (PlanLaneRhs, n_consts counting the transposed copy).
// Coupled: both methods on K10's grid kernel at one block of
// kPlanBlockThreads threads (PlanBlockRhs, n_consts the flat constants),
// its rows after the engine's adams_grid_rows B D values.
template <typename T, class P>
int launch_plan_adams(const void* grid, const void* tau, const void* y0,
                      const void* f0, void* out, void* stats, void* work,
                      long work_size, int G, int T_out, int B, int D,
                      int threads, int group, double sign, double rtol,
                      double atol, int max_order, int max_iters,
                      int implicit, int nfe, const double* ab,
                      const double* am, const void* consts, int n_consts,
                      const void* sample_consts, int smem_consts,
                      void* gwork, long gwork_bytes, int n_blocks,
                      int* layout, void* stream) {
  if (!layout ||
      !adams_args_ok(G, T_out, B, D, max_order, max_iters, threads) ||
      D != P::kDim || P::kOutRows != D)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* cg = static_cast<const T*>(consts);
  const T* scg = static_cast<const T*>(sample_consts);
  const AdamsTables<T> tables = make_adams_tables<T>(max_order, ab, am);
  const AdamsScalars<T> sc =
      make_adams_scalars<T>(G, T_out, B, D, sign, rtol, atol, max_order,
                            max_iters, implicit, nfe);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t fixed = sizeof(T) * (smem_consts ? size_t(n_consts) : 0);
  if constexpr (P::kSegments > 1) {
    const long own = adams_grid_rows(max_order) * B * D;
    if (n_blocks != 1 || threads != kPlanBlockThreads ||
        work_size < own + plan_batch_values<P>(B))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_rk_adams<T>(
        grid, tau, y0, f0, out, stats, work, work_size, gwork, gwork_bytes,
        1,
        PlanBlockRhs<T, P>{cg, scg, n_consts, smem_consts,
                           static_cast<T*>(work) + own, B, 0},
        fixed + sizeof(T) * threads, threads, tables, sc, layout, st));
  } else {
    if (!implicit)
      return static_cast<int>(launch_rk_adams_group<T>(
          grid, tau, y0, f0, out, stats, work, work_size,
          PlanLaneRhs<T, P>{cg, scg, n_consts, smem_consts}, group, tables,
          sc, layout, st));
    return static_cast<int>(launch_rk_adams<T>(
        grid, tau, y0, f0, out, stats, work, work_size, gwork, gwork_bytes,
        n_blocks, PlanRhs<T, P>{cg, scg, n_consts, smem_consts}, fixed,
        threads, tables, sc, layout, st));
  }
}

template <typename T, class P>
int launch_plan_vcabm(const void* tau, const void* y0, const void* f0,
                      void* out, void* stats, void* work, int T_out, int B,
                      int D, int threads, double dt0, double rtol,
                      double atol, double dt_min, double sign, double safety,
                      double ifactor, double dfactor, int max_steps,
                      int valid, int max_order, const double* gstar,
                      const void* consts, int n_consts,
                      const void* sample_consts, int smem_consts,
                      void* gwork, long gwork_bytes, int n_blocks,
                      long work_size, void* stream) {
  if (!vcabm_args_ok(T_out, B, D, max_order, max_steps, threads) ||
      D != P::kDim || P::kOutRows != D)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t fixed = sizeof(T) * (smem_consts ? size_t(n_consts) : 0);
  const T* cg = static_cast<const T*>(consts);
  const T* scg = static_cast<const T*>(sample_consts);
  const long own = vcabm_state_rows(max_order) * B * D;
  const VcabmScalars<T> sc = make_vcabm_scalars<T>(
      T_out, B, D, dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor,
      max_steps, valid, max_order, gstar);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (P::kSegments > 1) {
    // A coupled plan: one block of kPlanBlockThreads threads (PlanBlockRhs),
    // its rows after the engine's state rows.
    if (n_blocks != 1 || threads != kPlanBlockThreads ||
        work_size < own + plan_batch_values<P>(B))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_rk_vcabm<T>(
        tau, y0, f0, out, stats, work, gwork, gwork_bytes, 1,
        PlanBlockRhs<T, P>{cg, scg, n_consts, smem_consts,
                           static_cast<T*>(work) + own, B, 0},
        fixed + sizeof(T) * threads, threads, sc, st));
  } else {
    if (work_size < own) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_rk_vcabm<T>(
        tau, y0, f0, out, stats, work, gwork, gwork_bytes, n_blocks,
        PlanRhs<T, P>{cg, scg, n_consts, smem_consts}, fixed, threads, sc,
        st));
  }
}

// K12 with the dynamics PF (square) and the correction net PG (2 D inputs,
// D outputs), both on the group walk (PlanLaneRhs, each n_consts counting
// the transposed copy); g's constants follow f's in shared memory.
template <typename T, class PF, class PG>
int launch_plan_hyper(const void* grid, const void* tau, const void* y0,
                      void* out, void* stats, void* work, long work_size,
                      int G, int T_out, int B, int D, double sign, int kind,
                      int grid_is_t, const void* consts_f, int n_f,
                      const void* sample_f, int smem_f, const void* consts_g,
                      int n_g, const void* sample_g, int smem_g, int* layout,
                      void* stream) {
  if constexpr (PF::kSegments > 1 || PG::kSegments > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (!layout || G < 2 || T_out < 1 || B < 1 || D != PF::kDim ||
        PF::kOutRows != D || PG::kDim != 2 * D || PG::kOutRows != D ||
        kind < 0 || kind > 2)
      return static_cast<int>(cudaErrorInvalidValue);
    HyperScalars<T> sc{};
    sc.sign = T(sign);
    sc.G = G;
    sc.T_out = T_out;
    sc.B = B;
    sc.D = D;
    sc.kind = kind;
    sc.grid_is_t = grid_is_t;
    const PlanLaneRhs<T, PF> rf{static_cast<const T*>(consts_f),
                                static_cast<const T*>(sample_f), n_f, smem_f};
    const PlanLaneRhs<T, PG> rg{static_cast<const T*>(consts_g),
                                static_cast<const T*>(sample_g), n_g, smem_g,
                                int(rf.smem_values())};
    return static_cast<int>(launch_rk_hyper_group<T>(
        grid, tau, y0, out, stats, work, work_size, rf, rg, sc, layout,
        static_cast<cudaStream_t>(stream)));
  }
}

}  // namespace tfd

// The C entry points of a plan library, float32 and float64, for one host
// (ops/_build.py binds them by these names).
#define TFD_PLAN_SOLVE_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, void* out,           \
      void* stats, void* work, int T_out, int B, int D, int threads,        \
      double dt0, double rtol, double atol, double dt_min, double sign,     \
      double safety, double ifactor, double dfactor, int max_steps,         \
      int valid, int stages, int order, int fsal, const double* c,          \
      const double* a, const double* b_sol, const double* b_err,            \
      const double* c_mid, const void* consts, int n_consts,                \
      const void* sample_consts, int smem_consts, void* gwork,              \
      long gwork_bytes, int n_blocks, void* meta, void* coef, int dense_S,  \
      void* tile_work, long tile_bytes, void* stream) {                     \
    return tfd::launch_plan_solve<TYPE, tfd::Plan>(                         \
        tau, y0, f0, out, stats, work, T_out, B, D, threads, dt0, rtol,     \
        atol, dt_min, sign, safety, ifactor, dfactor, max_steps, valid,     \
        stages, order, fsal, c, a, b_sol, b_err, c_mid, consts, n_consts,   \
        sample_consts, smem_consts, gwork, gwork_bytes, n_blocks, meta,     \
        coef, dense_S, tile_work, tile_bytes, stream);                      \
  }
#define TFD_PLAN_FIXED_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, const void* f0,    \
      void* out, void* stats, void* work, long work_size, int G, int T_out, \
      int B, int D, int group, double sign, int valid, int stages,          \
      const double* c, const double* a, const double* b_sol,                \
      const void* consts, int n_consts, const void* sample_consts,          \
      int smem_consts, void* tile_work, long tile_bytes, void* stream) {    \
    return tfd::launch_plan_fixed<TYPE, tfd::Plan>(                         \
        grid, tau, y0, f0, out, stats, work, work_size, G, T_out, B, D,     \
        group, sign, valid, stages, c, a, b_sol, consts, n_consts,          \
        sample_consts, smem_consts, tile_work, tile_bytes, stream);         \
  }
#define TFD_PLAN_PERLANE_ENTRY(NAME, TYPE)                                   \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* dt0,     \
      void* out, void* lane_stats, void* stats, void* work, long work_size, \
      int T_out, int B, int D, int group, double rtol, double atol,         \
      double dt_min,                                                        \
      double sign, double safety, double ifactor, double dfactor,           \
      int max_steps, int valid, int stages, int order, int fsal,            \
      const double* c, const double* a, const double* b_sol,                \
      const double* b_err, const double* c_mid, const void* consts,         \
      int n_consts, const void* sample_consts, int smem_consts,             \
      void* tile_work, long tile_bytes, void* stream) {                     \
    return tfd::launch_plan_perlane<TYPE, tfd::Plan>(                       \
        tau, y0, f0, dt0, out, lane_stats, stats, work, work_size, T_out, B,\
        D, group, rtol, atol, dt_min, sign, safety, ifactor, dfactor,        \
        max_steps, valid, stages, order, fsal, c, a, b_sol, b_err, c_mid,   \
        consts, n_consts, sample_consts, smem_consts, tile_work, tile_bytes,\
        stream);                                                             \
  }
#define TFD_PLAN_ADAMS_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, const void* f0,    \
      void* out, void* stats, void* work, long work_size, int G, int T_out, \
      int B, int D, int threads, int group, double sign, double rtol,       \
      double atol, int max_order, int max_iters, int implicit, int nfe,     \
      const double* ab, const double* am, const void* consts, int n_consts, \
      const void* sample_consts, int smem_consts, void* gwork,              \
      long gwork_bytes, int n_blocks, int* layout, void* stream) {          \
    return tfd::launch_plan_adams<TYPE, tfd::Plan>(                         \
        grid, tau, y0, f0, out, stats, work, work_size, G, T_out, B, D,     \
        threads, group, sign, rtol, atol, max_order, max_iters, implicit,   \
        nfe, ab, am, consts, n_consts, sample_consts, smem_consts, gwork,   \
        gwork_bytes, n_blocks, layout, stream);                              \
  }
#define TFD_PLAN_VCABM_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, void* out,           \
      void* stats, void* work, int T_out, int B, int D, int threads,        \
      double dt0, double rtol, double atol, double dt_min, double sign,     \
      double safety, double ifactor, double dfactor, int max_steps,         \
      int valid, int max_order, const double* gstar, const void* consts,    \
      int n_consts, const void* sample_consts, int smem_consts,             \
      void* gwork, long gwork_bytes, int n_blocks, long work_size,          \
      void* stream) {                                                        \
    return tfd::launch_plan_vcabm<TYPE, tfd::Plan>(                         \
        tau, y0, f0, out, stats, work, T_out, B, D, threads, dt0, rtol,     \
        atol, dt_min, sign, safety, ifactor, dfactor, max_steps, valid,     \
        max_order, gstar, consts, n_consts, sample_consts, smem_consts,     \
        gwork, gwork_bytes, n_blocks, work_size, stream);                    \
  }
// K12's entry: the dynamics `Plan` and the correction net `PlanG` of one
// source.
#define TFD_PLAN_HYPER_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(                                                       \
      const void* grid, const void* tau, const void* y0, void* out,         \
      void* stats, void* work, long work_size, int G, int T_out, int B,     \
      int D, double sign, int kind, int grid_is_t, const void* consts_f,    \
      int n_f, const void* sample_f, int smem_f, const void* consts_g,      \
      int n_g, const void* sample_g, int smem_g, int* layout,               \
      void* stream) {                                                        \
    return tfd::launch_plan_hyper<TYPE, tfd::Plan, tfd::PlanG>(             \
        grid, tau, y0, out, stats, work, work_size, G, T_out, B, D, sign,   \
        kind, grid_is_t, consts_f, n_f, sample_f, smem_f, consts_g, n_g,    \
        sample_g, smem_g, layout, stream);                                   \
  }
extern "C" const char* tfd_plan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
