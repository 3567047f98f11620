// The layout of K6 and K9 (csrc/rk_adjoint.cuh rk_perlane_adjoint_kernel,
// rk_fixed_adjoint_kernel): a group of kLaneGroup threads a sample,
// kLaneGroups samples a block, and the workspace each sweep needs; and
// that of K8's and K5's MLP routes (csrc/rk_fixed.cuh, rk_perlane.cuh
// rk_*_group_kernel), explicit_adams' K10 and K12 (csrc/rk_adams.cuh,
// rk_hyper.cuh). Plain C++, so that the host (and a test through a
// host compiler) computes the same sizes the launch checks;
// ops/cuda_fixed.py repeats them (_group_work_size, _fixed_work_size,
// _solve_work_size). Also the grouped walks' slot counts of K2 and K3
// (group_slots, adjoint_slots; the launches report what they chose), K7's
// slot and row sizes and K1's block (ops/cuda_kernels.py and
// ops/cuda_adjoint.py repeat the sizes the wrappers allocate or route by).
#pragma once

#include <cstddef>

namespace tfd {

// Threads a sample (a tile of one warp), samples a block (the 32
// consecutive samples of the end-of-sweep tree), and the quadratures a
// member keeps in registers: a trial's quadrature terms (STEP) live in
// registers when a sample has at most kLaneGroup * kLaneQuadRegs of them,
// else in workspace rows.
constexpr int kLaneGroup = 16;
constexpr int kLaneGroups = 32;
constexpr int kLaneQuadRegs = 16;

inline bool lane_group_quad_regs(long n_q) {
  return n_q <= long(kLaneGroup) * kLaneQuadRegs;
}

// Values of a sample's slot: y, a_y, their compensations, the stages of
// both (S each), the stage state of both and the error terms (2 D), the
// running sums ACC of its n_q quadratures, then the right-hand side's own
// walk values.
inline long lane_group_slot_values(int S, int D, long n_q, long walk_values) {
  return (8 + 2L * S) * D + n_q + walk_values;
}

// The walk values of the MLP routes: each layer's inputs and
// pre-activation cotangents, f (D values) and the layer-0 input cotangent
// (din[0] values). dims holds the (din, dout) pairs.
inline long lane_group_mlp_walk_values(int n_layers, const int* dims,
                                       int D) {
  long v = long(D) + dims[0];
  for (int l = 0; l < n_layers; ++l) v += dims[2 * l] + dims[2 * l + 1];
  return v;
}

// The walk values of K15's generated group walk (csrc/plan_aug.cuh
// PlanGroupAug) in K6's and K9's slot: the walk's quadrature rows
// (q_rows), the sample's per-sample constants (n_sample), the walk's own
// values (group_values, ops/plan_codegen.py kGroupValues), then f and v_y.
inline long plan_aug_walk_values(int q_rows, int n_sample, int group_values,
                                 int out_rows, int D) {
  return long(q_rows) + n_sample + group_values + out_rows + D;
}

// The sweep's workspace: every sample's slot (used where the block's slots
// do not fit in its shared memory), then the STEP rows of its n_q
// quadratures (sample-major; used where they do not fit in registers).
inline long lane_group_work_size(int S, int B, int D, long n_q,
                                 long walk_values) {
  return long(B) * (lane_group_slot_values(S, D, n_q, walk_values) + n_q);
}

// Shared memory a block of these layouts may give its right-hand side and
// its slots (K6, K9, K8's and K5's MLP routes, and K1).
constexpr long kLaneSmemBytes = 220L * 1024;

// ---------------------------------------------------------------------------
// The forward solves with a group of threads a sample (K8 and K5 on the
// MLP routes): a block of kGroupBlock threads, `group` threads a sample
// (a power of two from 16 to kGroupBlock), kGroupBlock / group samples a
// block, each sample's slot in the block's shared memory where the block's
// slots fit there beside the right-hand side's share, else in the
// workspace.
// ---------------------------------------------------------------------------

constexpr int kGroupBlock = kLaneGroup * kLaneGroups;

inline bool group_size_ok(int group) {
  return group >= 16 && group <= kGroupBlock && (group & (group - 1)) == 0;
}

// Samples a block of `group` threads a sample.
inline int group_samples(int group) { return kGroupBlock / group; }

// The walk values of K14's generated group walk (csrc/plan_rhs.cuh
// PlanLaneRhs) in K8's and K5's slot: the sample's D inputs, the walk's own
// values (group_values, ops/plan_codegen.py kGroupValues), its outputs.
inline long plan_solve_walk_values(int D, int out_rows, int group_values) {
  return long(D) + group_values + out_rows;
}

// K8's slot: the state, its Kahan compensation, the chained derivative
// f(t0, y0), the step's start state, the S - 1 later stages (D values
// each), then the walk's two layer vectors of gw values (the widest
// layer).
inline long fixed_solve_slot_values(int S, int D, int gw) {
  return long(S + 3) * D + 2L * gw;
}

// K5's slot: the state, the FSAL derivative, the compensation, the
// attempt's increment, dense-output midpoint, end derivative and squared
// scaled errors, the S - 1 later stages (D values each), then the walk's
// two layer vectors.
inline long perlane_solve_slot_values(int S, int D, int gw) {
  return long(S + 6) * D + 2L * gw;
}

// explicit_adams' slot (K10's group kernel, csrc/rk_adams.cuh): the state,
// its compensation, the step's increment, RK4 stages 1-3 and the ring of
// max_order history slabs (D values each), then the walk's values.
inline long adams_solve_slot_values(int D, int max_order, long walk_values) {
  return long(6 + max_order) * D + walk_values;
}

// K12's slot (csrc/rk_hyper.cuh): the state, the previous node's state and
// derivative, this step's f0 (D values each), then f's walk (its D inputs
// first) and g's walk (its 2 D inputs first).
inline long hyper_solve_slot_values(int D, long walk_f, long walk_g) {
  return 4L * D + walk_f + walk_g;
}

// K12's group from the batch: 16 threads a sample where the blocks of 16
// reach kHyperFillBlocks (the batch fills the card: 128 blocks at
// B = 4096), else the narrowest wider group, up to kHyperMaxGroup, whose
// blocks do (a small batch spreads over more SMs, each sample's walk over
// more members). On the H100 the example's hypersolver at B = 256 took
// 0.111 / 0.106 / 0.103 ms at 16 / 32 / 64 threads a sample, and at
// B = 4096 0.112 at 16 against 0.205 at 32 (PERF.md, PR 19).
constexpr int kHyperFillBlocks = 128;
constexpr int kHyperMaxGroup = 64;

inline int hyper_group(int B) {
  int g = kLaneGroup;
  while (g < kHyperMaxGroup &&
         (long(B) + group_samples(g) - 1) / group_samples(g) <
             kHyperFillBlocks)
    g *= 2;
  return g;
}

// The workspace of K8's, K5's, explicit_adams' and K12's group launches: a
// slot for every sample of the blocks (B rounded up to whole blocks), then
// n_wt values (the wide route's transposed weights; 0 on the narrow and
// plan routes).
inline long group_solve_work_size(long slot_values, int B, int group,
                                  long n_wt) {
  const long spb = group_samples(group);
  return (long(B) + spb - 1) / spb * spb * slot_values + n_wt;
}

// K9's end-of-sweep tree: the shared quadratures' batch sums take
// block_sum's tree over kFixedTree consecutive samples (two blocks' worth),
// then the trees in order: the order K9 had when a sample was a thread of
// a 64-thread block.
constexpr int kFixedTree = 64;

// K9's workspace: K6's (the slots and the STEP rows), then every sample's
// running sums of its R shared quadratures ([R][B]) for the end-of-sweep
// trees.
inline long fixed_group_work_size(int S, int B, int D, long n_q,
                                  long walk_values, long R) {
  return lane_group_work_size(S, B, D, n_q, walk_values) + R * B;
}

// The samples a round of a grouped walk in K2, K10 and K11 (a power of two
// up to kGroupSlots) that fit: the slots (slot_values values each; the MLP
// walk's two layer vectors, 2 gw) share the block's reduction scratch
// (`threads` values, free during a walk) and may grow it while `fixed`
// bytes plus the scratch stay within `budget`; never more slots than a
// block has samples. Returns at least 1.
constexpr int kGroupSlots = 32;

inline int group_slots(size_t fixed, size_t budget, int threads,
                       long slot_values, int per_block, size_t item) {
  auto scratch = [&](int s) {
    const size_t v = size_t(s) * size_t(slot_values);
    return item * (size_t(threads) > v ? size_t(threads) : v);
  };
  int slots = 1;
  while (slots < kGroupSlots && slots < per_block &&
         fixed + scratch(2 * slots) <= budget)
    slots *= 2;
  return slots;
}

// K3's grouped walk: the samples a round (a power of two up to
// kGroupSlots, at most a block's samples) whose slots of slot_bytes fit
// beside the block's own `own` bytes within `budget`; at least 1.
inline int adjoint_slots(size_t own, size_t slot_bytes, int per_block,
                         size_t budget) {
  int slots = 1;
  while (slots < kGroupSlots && slots < per_block &&
         own + 2 * size_t(slots) * slot_bytes <= budget)
    slots *= 2;
  return slots;
}

// Whether K3's block keeps K7's rows (`cols` columns, its samples and one
// more, of row_bytes each) in shared memory beside the `used` bytes within
// `budget`.
inline bool adjoint_rows_fit(size_t used, size_t row_bytes, int cols,
                             size_t budget) {
  return used + size_t(cols) * row_bytes <= budget;
}

// K7's group walks (csrc/cnf_net.cuh): gw the widest layer, n_hid the
// hidden layers' outputs, D the flow's outputs (the state is [z; logp],
// D + 1 values). K2's slot: the two layer vectors, act' of the hidden
// outputs, F (D + 1) and the passes' trace terms (D).
inline long cnf_solve_slot_values(int gw, int n_hid, int D) {
  return 2L * gw + n_hid + 2L * D + 1;
}

// K3's slot: the stage state y and a_y and the two layer vectors (gw each),
// act' and act'' of the hidden outputs, the passes' products v (D of
// them), the gathered zbar, part A's input cotangent (D + 1) and the
// passes' trace terms (D).
inline long cnf_aug_slot_values(int gw, int n_hid, int D) {
  return 4L * gw + (3L + D) * n_hid + 2L * D + 1;
}

// K3's rows, which its phase B reads, in values a sample (cnf_net.cuh
// CnfRowsAt: row-major, row X of sample b at X * stride + b, each row's
// samples contiguous; the stride is the block's samples plus one in shared
// memory, B in the workspace): the layers' inputs (n_h), then over the
// layers' outputs (n_z) part A's cotangents and the deltas, the passes' u
// and vb (D each), then v_t.
inline long cnf_aug_row_values(int n_h, int n_z, int D) {
  return n_h + (2L + 2L * D) * n_z + 1;
}

// K1 (csrc/step_kernel.cu): blocks of kStepBlock threads, `samples` samples a
// block (a power of two up to kStepSamples), kStepBlock / samples threads a
// sample. Shared memory in values: the weights (2 D H + H + D), then each
// sample's slot (y0, the stage input, the 7 stages, the squared errors: 10
// D; the hidden units: H) and its error sum.
constexpr int kStepBlock = 512;
constexpr int kStepSamples = 32;

inline long step_smem_values(int D, int H, int samples) {
  return 2L * D * H + H + D + long(samples) * (10L * D + H + 1);
}

// The most samples a block whose shared memory fits `budget` bytes (items
// of `item` bytes), or 0 when even one does not.
inline int step_samples(int D, int H, size_t item, size_t budget) {
  for (int s = kStepSamples; s >= 1; s /= 2)
    if (item * size_t(step_smem_values(D, H, s)) <= budget) return s;
  return 0;
}

}  // namespace tfd
