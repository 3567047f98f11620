// The layout of K6 and K9 (csrc/rk_adjoint.cuh rk_perlane_adjoint_kernel,
// rk_fixed_adjoint_kernel): a group of kLaneGroup threads a sample,
// kLaneGroups samples a block, and the workspace each sweep needs. Plain
// C++, so that the host (and a test through a host compiler) computes the
// same sizes the launch checks; ops/cuda_fixed.py repeats them
// (_group_work_size, _fixed_work_size).
#pragma once

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

// The sweep's workspace: every sample's slot (used where the block's slots
// do not fit in its shared memory), then the STEP rows of its n_q
// quadratures (sample-major; used where they do not fit in registers).
inline long lane_group_work_size(int S, int B, int D, long n_q,
                                 long walk_values) {
  return long(B) * (lane_group_slot_values(S, D, n_q, walk_values) + n_q);
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

}  // namespace tfd
