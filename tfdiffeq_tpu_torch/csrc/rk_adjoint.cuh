// The engines of the adjoint sweeps, templated on their augmented
// right-hand side: K3 (one step controller shared by the batch), K6 (one a
// sample) and K9 (a fixed grid).
//
// Replaces the engines of tfdiffeq_tpu/ops/pallas_adjoint.py:430
// (_make_adjoint_kernel), :681 (_make_perlane_adjoint_kernel) and
// tfdiffeq_tpu/ops/pallas_fixed.py:726 (_make_fixed_adjoint_kernel). In
// sigma = -tau, which increases on every backward interval, each integrates
//
//     dy/dsigma   = -sign f(y),     da_y/dsigma = sign (df/dy)^T a_y,
//     da_q/dsigma = sign (df/dq)^T a_y  (each quadrature q),
//
// over the observation intervals in reverse: y is reset to the stored
// forward state ys[i] and g[i] is added into a_y at each interval start;
// ay0 = a_y + g[0] at the end. The quadratures are of two kinds: shared
// ones, summed over the batch (the parameters' cotangents, then a_t when
// the dynamics read the time), and per-sample ones (a per-sample
// constant's cotangent: K15's 'batch' and 'bvec' constants), integrated a
// sample each. Each engine's own comment says how it steps; the stage
// states, combines, Kahan updates, controller and status rules are the
// reference's, as before this file existed (csrc/adjoint_kernel.cu,
// perlane_adjoint_kernel.cu and fixed_adjoint_kernel.cu hold the MLP and
// CNF right-hand sides, csrc/plan_aug.cuh K15's).
//
// The augmented right-hand side `Aug` provides
//   Shared, Local           block-shared and per-thread state;
//   setup(sh, lo, smem)     copies what it keeps in shared memory (no
//                           barrier), returns the free shared memory;
//   n_w, ti, n_ps           the shared quadratures (then a_t when ti) and
//                           the per-sample ones;
//   ya(lo), aya(lo)         where the engine writes a sample's stage state
//                           (not with kGroup);
// for K3, either (kBatch false) a sample at a time
//   stage(sh, lo, t, b, B, sf, ky, kay, rw)
//                           sample b's stage: ky[d] = -sf f_d, kay[d] =
//                           sf v_y,d (D values each), and what the batch
//                           sums read into its rows rw;
// or (kGroup true) a group of threads a sample, every thread of the block:
//   group_ya(slot), group_aya(slot)  the group's stage state (shared),
//   stage_group(sh, t, b, on, B, sf, m, gsz, slot, ky, kay, rw)
//                           the same for sample b (on: the slot has one),
//                           member m of gsz;
// or (kBatch true) the whole batch, every thread:
//   put(sh, lo, b, B, rw)   sample b's state (ya, aya) into the rows,
//   stage_batch(sh, lo, t, B, sf, KY, KAY, rw, red)  after a barrier;
// and the stage's batch sums:
//   quad(sh, r, rw, B, sum)  sum(x) of x(b), shared quadrature r's term for
//                           sample b (sum: lane_sum_small or lane_sum_warp
//                           over the block's samples),
//   sample_x(sh, j, rw, B, b)     per-sample quadrature j's term;
// for K6 and K9 a group of kLaneGroup threads a sample
// (csrc/lane_group.h):
//   walk_values()           values of a sample's walk scratch gs (host
//                           too);
//   group_init(sh, gs, b, B, m, gsz)  sample b's own values into gs, once
//                           (member m of gsz; the engine syncs after);
//   group_stage(sh, lo, t, b, B, sf, ya, aya, ky, kay, gs, m, gsz, mask)
//                           sample b's stage from its stage state ya, aya
//                           (D values each, every member reads them):
//                           member m writes ky[d], kay[d] for d = m, m +
//                           gsz, ...; gs keeps what the quadratures read
//                           (mask: the group's lanes, for its syncs);
//   group_x(sh, r, gs)      quadrature r's term after group_stage, the
//                           shared ones (a_t last), then the per-sample
//                           ones.
#pragma once

#include "grid_meet.cuh"
#include "lane_group.h"
#include "mlp_rk.cuh"

namespace tfd {

// Threads of each K3 block (the block sums' tree, block_sum, takes a power
// of two), ops/cuda_adjoint.py:ADJOINT_THREADS.
constexpr int kAdjThreads = 512;
constexpr int kWarp = 32;

template <typename T>
struct AdjScalars {
  T dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, T_obs, B, D, seminorm;
  int quad_smem;   // the shared quadratures' rows in shared memory
};

// Sum of v over the 32 lanes of a warp in the tree order of
// ops/cuda_kernels.py:_tree_sum; lane 0 returns the sum.
template <typename T>
__device__ __forceinline__ T warp_tree_sum(T v) {
  for (int s = kWarp / 2; s > 0; s >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// Batch samples a lane loads before it adds them (lane_sum_warp): the adds
// stay in sample order, the loads overlap.
constexpr int kUnroll = 8;
// Most chunks of K3's staged merges (rk_adjoint_kernel's first meeting).
constexpr int kStagedChunks = 8;

// The sum of x(b) over the samples [lo, lo + n) in K3's lane order: lane j
// adds samples lo + j, lo + j + 32, ... in turn from +0, then the 32 lane
// sums meet in warp_tree_sum's tree (ops/cuda_adjoint.py _lane_sums on the
// rows lo .. lo + n - 1). A lane past the range sums to +0, which the tree
// adds without changing a bit, so n = B gives the bits of the one-block
// kernel's batch sum. Two ways to the same bits:
//   lane_sum_warp   (n > 32) a warp together, lane 0 returns the sum;
//   lane_sum_small  (n <= 32) one thread, its (at most) 32 samples loaded
//                   together into registers, then the tree.
template <typename T, typename Fn>
__device__ __forceinline__ T lane_sum_warp(const Fn& x, int lo, int n,
                                           int lane) {
  T acc = T(0);
  for (int b0 = lane; b0 < n; b0 += kUnroll * kWarp) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * kWarp;
      v[u] = b < n ? x(lo + b) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = acc + v[u];
  }
  return warp_tree_sum(acc);
}

template <typename T, typename Fn>
__device__ __forceinline__ T lane_sum_small(const Fn& x, int lo, int n) {
  T v[kWarp];
#pragma unroll
  for (int j = 0; j < kWarp; ++j) v[j] = j < n ? T(0) + x(lo + j) : T(0);
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1)
#pragma unroll
    for (int j = 0; j < s; ++j) v[j] = v[j] + v[j + s];
  return v[0];
}

// sum_j (dth c_j) k_j over the nonzero c_j, in stage order; k_j = K(j).
template <typename T, typename Fn>
__device__ __forceinline__ T stage_combine(const T* coef, int S, T dth,
                                           Fn K) {
  T acc = T(0);
  bool first = true;
  for (int j = 0; j < S; ++j) {
    if (coef[j] != T(0)) {
      const T term = (dth * coef[j]) * K(j);
      acc = first ? term : acc + term;
      first = false;
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// K3: one controller for the batch, the sweep spread over the card.
//
// A grid of n_blocks blocks (at most one per SM, all resident together)
// cuts the batch into n_blocks contiguous ranges, block k the samples
// [k B / n_blocks, (k + 1) B / n_blocks), and the shared quadratures into
// as many ranges, block k the parameters [k n_w / n_blocks, ...). The batch
// meets at every STAGE, not only at every attempt: each stage's shared
// quadratures are sums over the whole batch (pallas_adjoint.py:196-201,
// :503-509). Phase A evaluates the augmented right-hand side of each of
// the block's samples (a thread a sample, or a group of threads a sample:
// kGroup), which writes what the sums read to
// workspace rows of B values; phase B gives each thread (or, past 32
// samples a block, each warp) whole reductions over the block's samples
// (quad), into the block's partial of that stage, [S][n_blocks][n_w + ti]
// in `gwork`. Nothing of a stage waits for another block, so the grid
// meets twice an attempt: after the S stages,
// when each block merges the partials of its own parameters (and every
// block those of a_t) in block order, combines, and writes its share of
// the error norm (its samples', then its parameters', summed by its
// threads and block_sum) and its finiteness flag; and after that, when
// every block adds the n_blocks shares in block order and ORs the flags.
// Every block merges the same values in the same order with the same
// instructions, so every block takes bitwise the same total, the same
// accept/reject, the same dt, status and counters, and leaves the attempt
// loop at the same meeting (a block that decided otherwise would leave the
// others waiting for it). No atomics sum a value: the same bits on every
// run, and float64 sweeps that take the plain version's exact steps
// (ops/cuda_adjoint.py adjoint_sweep_plain repeats the order for any
// n_blocks; n_blocks = 1 is the order of the one-block kernel before it).
// The error norm covers (y, a_y), then, unless `seminorm`, the per-sample
// quadratures after each sample's own and the shared ones; the clamped
// I-controller, Kahan accumulation of y and a_y (the quadratures add
// plainly), the counters and the status follow the reference (:498-676).
// A coupled plan (kBatch: the block meets inside a stage) runs on one
// block. The grid primitives (grid_sync, merge_blocks, launch_grid) are
// csrc/grid_meet.cuh's, shared with K2 and K11.
//
// Workspace (`work`): y, a_y, their compensations and increments, the
// stages of both ([S][B][D] each), the per-sample quadratures, their
// increments and stages ([n_ps][B], [n_ps][B], [S][n_ps][B]), then the
// right-hand side's rows. The shared quadratures' accumulator, increment
// and stage values ((S + 2) n_w + S ti values, each block using its own
// parameters' entries) sit in shared memory when `quad_smem`, else in
// `pwork`. `gwork`: the meetings' counter (16 bytes), the stage partials
// and the error shares ([n_blocks][2]).
//
// Bound on the H100. A stage costs one walk of a sample's augmented
// right-hand side (about 31 samples a block at B = 4096) and one thread's
// lane sums over the block's samples, with no wait for other blocks; an
// attempt adds the two meetings (an atomic and a spin on L2) and the
// block-order merges (n_blocks partials a value; a few merges a chunk
// loaded by the block at once, many a thread a merge). The walk is a
// dependent chain: a thread a sample for K15's generated plans (their
// vectors in registers; at about 31 samples a block that is one warp whose
// lanes are all busy, and a clock64 profile put the walk at 14% of a
// sweep, phase B and the merges and meetings at 75%, PERF.md §6); a group
// of threads a sample for the MLP routes and K7's flow (kGroup,
// csrc/adjoint_kernel.cu stage_group: each layer's outputs over the
// group's threads, its vectors in shared memory; the block's threads split
// into Aug::slots groups, a power of two up to lane_group.h kGroupSlots,
// 16 threads a sample at 512 and 32 slots), whose chain is then a layer's
// longest sum and a block barrier a layer.
// ---------------------------------------------------------------------------

template <typename T, class Aug>
__global__ void __launch_bounds__(kAdjThreads, 1)
    rk_adjoint_kernel(const T* __restrict__ tau, const T* __restrict__ ys,
                      const T* __restrict__ g, T* __restrict__ ay0_out,
                      T* __restrict__ aw_out, T* __restrict__ at_out,
                      T* __restrict__ aps_out, int* __restrict__ stats,
                      T* __restrict__ work, T* __restrict__ pwork,
                      unsigned char* __restrict__ gwork, Aug aug,
                      Tableau<T> tab_in, AdjScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Aug::Shared ash;
  __shared__ Tableau<T> tab;
  __shared__ T kat[kMaxStages];   // a_t's stage values (every block's)
  __shared__ T s_total;           // the merged error norm
  __shared__ int s_bad;           // ... and non-finite flag
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_warps = nth / kWarp;
  const int nb = gridDim.x;
  const int blk = blockIdx.x;
  typename Aug::Local lo;
  T* const free = aug.setup(ash, lo, smem_raw);
  if (tid == 0) tab = tab_in;
  const int n_w = aug.n_w;
  const int ti = aug.ti;
  const int n_ps = aug.n_ps;
  const int n_red = n_w + ti;               // reductions per stage
  const int S = tab_in.S;
  T* AW;        // [n_w] shared quadratures
  T* DW;        // [n_w] their attempt increment
  T* KW;        // [S][n_red] stage values
  T* red;       // [nth] block_sum scratch
  if (sc.quad_smem) {
    AW = free;
    DW = AW + n_w;
    KW = DW + n_w;
    red = KW + S * n_red;
  } else {
    AW = pwork;
    DW = AW + n_w;
    KW = DW + n_w;
    red = free;
  }
  const int T_obs = sc.T_obs, B = sc.B, D = sc.D;
  // The block's samples and parameters.
  const int b_lo = int(long(blk) * B / nb);
  const int b_hi = int(long(blk + 1) * B / nb);
  const int n_own = b_hi - b_lo;
  const int p_lo = int(long(blk) * n_w / nb);
  const int p_hi = int(long(blk + 1) * n_w / nb);
  unsigned long long* const meet =
      reinterpret_cast<unsigned long long*>(gwork);
  T* const PART = reinterpret_cast<T*>(gwork + 16);   // [S][nb][n_red]
  T* const ERR = PART + long(S) * nb * n_red;          // [nb][2]
  unsigned long long target = 0;

  for (int p = p_lo + tid; p < p_hi; p += nth) AW[p] = T(0);
  __syncthreads();

  const long BD = long(B) * D;
  T* Y = work;              // y
  T* AY = Y + BD;           // a_y
  T* CY = AY + BD;          // Kahan compensation of y
  T* CAY = CY + BD;         // ... and of a_y
  T* DY = CAY + BD;         // the attempt's increments
  T* DAY = DY + BD;
  T* KY = DAY + BD;         // [S][B][D] stage derivatives of y
  T* KAY = KY + S * BD;     // [S][B][D] ... and of a_y
  const long BP = long(B) * n_ps;
  T* APS = KAY + S * BD;    // [n_ps][B] per-sample quadratures
  T* DPS = APS + BP;        // ... their attempt increment
  T* KPS = DPS + BP;        // [S][n_ps][B] ... their stage values
  T* RW = KPS + S * BP;     // the right-hand side's rows

  const T sf = sc.sign;
  const T denom = sc.seminorm
      ? T(2.0 * double(D) * double(B))
      : T(2.0 * double(D) * double(B) + double(n_w) + double(ti) +
          double(n_ps) * double(B));

  for (int b = b_lo + tid; b < b_hi; b += nth) {
    for (int d = 0; d < D; ++d) AY[long(b) * D + d] = T(0);
    for (int j = 0; j < n_ps; ++j) APS[long(j) * B + b] = T(0);
  }

  T dt = sc.dt0, at = T(0);
  int nfe = 0, nacc = 0, nrej = 0, status = 0;

  for (int i = T_obs - 1; i >= 1; --i) {
    // Reset y to the stored forward state; inject the cotangent.
    for (int b = b_lo + tid; b < b_hi; b += nth) {
      for (int d = 0; d < D; ++d) {
        const long k = long(b) * D + d;
        Y[k] = ys[long(i) * BD + k];
        AY[k] = AY[k] + g[long(i) * BD + k];
        CY[k] = T(0);
        CAY[k] = T(0);
      }
    }
    T s = -tau[i];
    const T s_end = -tau[i - 1];

    while (s < s_end && status == 0) {
      const T rem = s_end - s;
      const T dt_eff = d_min(dt, rem);
      const bool is_last = dt >= rem;
      const T s1 = is_last ? s_end : s + dt_eff;
      const T dth = s1 - s;

      for (int st = 0; st < S; ++st) {
        // ---- phase A: each of the block's samples' stage state and
        // augmented right-hand side.
        const T t_user = (-sf) * (s + tab.c[st] * dth);
        if constexpr (Aug::kGroup) {
          // A group of gsz threads a sample (member m), `slots` samples a
          // round: the stage state into the group's shared vectors, then
          // the walk with the group's threads across each layer's outputs.
          const int slots = aug.slots;
          const int gsz = nth / slots, m = tid % gsz, slot = tid / gsz;
          // y and a_y were last written a thread a sample (the reset, the
          // accepted update), not by the group's members.
          __syncthreads();
          for (int r0 = b_lo; r0 < b_hi; r0 += slots) {
            const int b = r0 + slot;
            const bool on = b < b_hi;
            const long base = long(b) * D;
            T* ya = aug.group_ya(slot);
            T* aya = aug.group_aya(slot);
            for (int d = m; on && d < D; d += gsz) {
              T yv = Y[base + d], av = AY[base + d];
              for (int j = 0; j < st; ++j) {
                const T a = tab.a[st][j];
                if (a != T(0)) {
                  yv = yv + (dth * a) * KY[j * BD + base + d];
                  av = av + (dth * a) * KAY[j * BD + base + d];
                }
              }
              ya[d] = yv;
              aya[d] = av;
            }
            __syncthreads();
            aug.stage_group(ash, t_user, b, on, B, sf, m, gsz, slot,
                            KY + st * BD + base, KAY + st * BD + base, RW);
          }
        } else {
          for (int b = b_lo + tid; b < b_hi; b += nth) {
            const long base = long(b) * D;
            T* ya = aug.ya(lo);
            T* aya = aug.aya(lo);
            for (int d = 0; d < D; ++d) {
              T yv = Y[base + d], av = AY[base + d];
              for (int j = 0; j < st; ++j) {
                const T a = tab.a[st][j];
                if (a != T(0)) {
                  yv = yv + (dth * a) * KY[j * BD + base + d];
                  av = av + (dth * a) * KAY[j * BD + base + d];
                }
              }
              ya[d] = yv;
              aya[d] = av;
            }
            if constexpr (Aug::kBatch) {
              aug.put(ash, lo, b, B, RW);
            } else {
              aug.stage(ash, lo, t_user, b, B, sf, KY + st * BD + base,
                        KAY + st * BD + base, RW);
              for (int j = 0; j < n_ps; ++j)
                KPS[(long(st) * n_ps + j) * B + b] =
                    sf * aug.sample_x(ash, j, RW, B, b);
            }
          }
        }
        if constexpr (Aug::kBatch) {
          __syncthreads();
          aug.stage_batch(ash, lo, t_user, B, sf, KY + st * BD,
                          KAY + st * BD, RW, red);
          for (int b = tid; b < B; b += nth)
            for (int j = 0; j < n_ps; ++j)
              KPS[(long(st) * n_ps + j) * B + b] =
                  sf * aug.sample_x(ash, j, RW, B, b);
        }
        __syncthreads();

        // ---- phase B: the block's partial of each of the stage's batch
        // sums: a thread a reduction over at most 32 samples, else a warp.
        T* const part = PART + (long(st) * nb + blk) * n_red;
        if (n_own <= kWarp) {
          for (int r = tid; r < n_red; r += nth)
            part[r] = aug.quad(ash, r, RW, B, [&](const auto& x) {
              return lane_sum_small<T>(x, b_lo, n_own);
            });
        } else {
          for (int r = warp; r < n_red; r += n_warps) {
            const T acc = aug.quad(ash, r, RW, B, [&](const auto& x) {
              return lane_sum_warp<T>(x, b_lo, n_own, lane);
            });
            if (lane == 0) part[r] = acc;
          }
        }
        __syncthreads();
      }

      // ---- the grid meets: every stage's partials are in. Each block
      // merges its parameters' stage values, KW[st][p] = sign * sum over
      // the blocks in block order, and every block a_t's: the merges
      // (st, p) in order, then a_t's S. Where they fill at most
      // kStagedChunks chunks of whole merges (the spiral's 14 at 132
      // blocks: 5), a chunk's nb partials a merge are loaded by the block
      // together (past L1: other blocks wrote them) into `red`, then a
      // thread a merge adds them in block order (one L2 round trip a
      // chunk, where a thread's nb loads in turn took 63k cycles an
      // attempt); past that (the wide net's thousands), a thread a merge
      // loads and adds its own (merge_blocks). The same adds either way.
      grid_sync(meet, target);
      {
        const long st_stride = long(nb) * n_red;
        const int np = p_hi - p_lo;
        const int n_pm = S * np;
        const int n_merge = n_pm + (ti ? S : 0);
        const int per = nth / nb;   // merges a chunk
        const bool staged = n_merge <= kStagedChunks * per;
        if (!staged) {
          for (int q = tid; q < n_merge; q += nth) {
            const int st = q < n_pm ? q / np : q - n_pm;
            const int col = q < n_pm ? p_lo + q % np : n_w;
            const T acc =
                merge_blocks(PART + st * st_stride + col, long(n_red), nb);
            if (q < n_pm)
              KW[st * n_red + col] = sf * acc;
            else
              kat[q - n_pm] = sf * acc;
          }
          __syncthreads();
        }
        for (int q0 = 0; staged && q0 < n_merge; q0 += per) {
          const int cnt = n_merge - q0 < per ? n_merge - q0 : per;
          for (int i = tid; i < cnt * nb; i += nth) {
            const int q = q0 + i / nb, k = i % nb;
            const int st = q < n_pm ? q / np : q - n_pm;
            const int col = q < n_pm ? p_lo + q % np : n_w;
            red[i] = __ldcg(PART + st * st_stride + long(k) * n_red + col);
          }
          __syncthreads();
          if (tid < cnt) {
            const int q = q0 + tid;
            const T* v = red + tid * nb;
            T acc = v[0];
            for (int k = 1; k < nb; ++k) acc = acc + v[k];
            if (q < n_pm)
              KW[(q / np) * n_red + p_lo + q % np] = sf * acc;
            else
              kat[q - n_pm] = sf * acc;
          }
          __syncthreads();
        }
      }

      // ---- combine: increments, errors and finiteness of the block's
      // samples, then of its shared quadratures (pallas_adjoint.py:578-621).
      T ss = T(0);
      bool bad = false;
      for (int b = b_lo + tid; b < b_hi; b += nth) {
        const long base = long(b) * D;
        for (int pass = 0; pass < 2; ++pass) {
          const T* V = pass ? AY : Y;
          const T* KV = pass ? KAY : KY;
          T* DV = pass ? DAY : DY;
          for (int d = 0; d < D; ++d) {
            T dv = T(0), ev = T(0);
            bool first_d = true, first_e = true;
            for (int j = 0; j < S; ++j) {
              const T kj = KV[j * BD + base + d];
              if (tab.b_sol[j] != T(0)) {
                const T term = (dth * tab.b_sol[j]) * kj;
                dv = first_d ? term : dv + term;
                first_d = false;
              }
              if (tab.b_err[j] != T(0)) {
                const T term = (dth * tab.b_err[j]) * kj;
                ev = first_e ? term : ev + term;
                first_e = false;
              }
            }
            const T v0 = V[base + d];
            const T v1 = v0 + dv;
            const T scale = sc.atol + sc.rtol * d_max(d_abs(v0), d_abs(v1));
            const T esc = ev / scale;
            ss = ss + esc * esc;
            bad = bad || !d_finite(v1);
            DV[base + d] = dv;
          }
        }
        for (int j = 0; j < n_ps; ++j) {
          auto kq = [&](int q) { return KPS[(long(q) * n_ps + j) * B + b]; };
          const T dv = stage_combine(tab.b_sol, S, dth, kq);
          if (!sc.seminorm) {
            const T ev = stage_combine(tab.b_err, S, dth, kq);
            const T v0 = APS[long(j) * B + b];
            const T scale =
                sc.atol + sc.rtol * d_max(d_abs(v0), d_abs(v0 + dv));
            const T esc = ev / scale;
            ss = ss + esc * esc;
          }
          DPS[long(j) * B + b] = dv;
        }
      }
      for (int p = p_lo + tid; p < p_hi; p += nth) {
        T dv = T(0), ev = T(0);
        bool first_d = true, first_e = true;
        for (int j = 0; j < S; ++j) {
          const T kj = KW[j * n_red + p];
          if (tab.b_sol[j] != T(0)) {
            const T term = (dth * tab.b_sol[j]) * kj;
            dv = first_d ? term : dv + term;
            first_d = false;
          }
          if (tab.b_err[j] != T(0)) {
            const T term = (dth * tab.b_err[j]) * kj;
            ev = first_e ? term : ev + term;
            first_e = false;
          }
        }
        if (!sc.seminorm) {
          const T v0 = AW[p];
          const T scale = sc.atol + sc.rtol * d_max(d_abs(v0),
                                                    d_abs(v0 + dv));
          const T esc = ev / scale;
          ss = ss + esc * esc;
        }
        DW[p] = dv;
      }
      // The a_t quadrature, the same in every thread of every block.
      T d_at = T(0), e_at = T(0);
      if (ti) {
        bool first_d = true, first_e = true;
        for (int j = 0; j < S; ++j) {
          const T kj = kat[j];
          if (tab.b_sol[j] != T(0)) {
            const T term = (dth * tab.b_sol[j]) * kj;
            d_at = first_d ? term : d_at + term;
            first_d = false;
          }
          if (tab.b_err[j] != T(0)) {
            const T term = (dth * tab.b_err[j]) * kj;
            e_at = first_e ? term : e_at + term;
            first_e = false;
          }
        }
      }
      const T at1 = at + d_at;

      // ---- the grid meets again: one shared decision. Each block's
      // share of the error norm and its flag; then every block merges the
      // shares in block order (thread 0, into shared memory).
      const bool blk_bad = __syncthreads_or(bad);
      const T blk_ss = block_sum(ss, red);
      if (tid == 0) {
        ERR[2 * blk] = blk_ss;
        ERR[2 * blk + 1] = blk_bad ? T(1) : T(0);
      }
      grid_sync(meet, target);
      if (tid == 0) {
        T tot = __ldcg(ERR);
        bool any = __ldcg(ERR + 1) != T(0);
        for (int k = 1; k < nb; ++k) {
          tot = tot + __ldcg(ERR + 2 * k);
          any = any || __ldcg(ERR + 2 * k + 1) != T(0);
        }
        s_total = tot;
        s_bad = any;
      }
      __syncthreads();
      T total = s_total;
      const bool any_bad = s_bad != 0;
      if (ti && !sc.seminorm) {
        const T scale = sc.atol + sc.rtol * d_max(d_abs(at), d_abs(at1));
        const T esc = e_at / scale;
        total = total + esc * esc;
      }
      const T ratio = d_sqrt(total / denom);
      const bool finite = d_finite(total) && !any_bad;
      const bool accept = (ratio <= T(1)) && finite;
      const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                      sc.ifactor, sc.dfactor, tab.order);
      const T dt_next = dth * fac;

      if (accept) {
        // Kahan-compensated accumulation of y and a_y; the quadratures
        // add plainly (pallas_adjoint.py:627-645).
        for (int b = b_lo + tid; b < b_hi; b += nth) {
          const long base = long(b) * D;
          for (int d = 0; d < D; ++d) {
            const long k = base + d;
            const T adj_y = DY[k] - CY[k];
            const T y0 = Y[k];
            const T y_new = y0 + adj_y;
            CY[k] = (y_new - y0) - adj_y;
            Y[k] = y_new;
            const T adj_a = DAY[k] - CAY[k];
            const T a0 = AY[k];
            const T a_new = a0 + adj_a;
            CAY[k] = (a_new - a0) - adj_a;
            AY[k] = a_new;
          }
          for (int j = 0; j < n_ps; ++j)
            APS[long(j) * B + b] = APS[long(j) * B + b] +
                                   DPS[long(j) * B + b];
        }
        for (int p = p_lo + tid; p < p_hi; p += nth) AW[p] = AW[p] + DW[p];
        at = at1;
        s = s1;
      }
      // Status rules of the kernel (pallas_adjoint.py:647-653).
      const int n_att = nacc + nrej + 1;
      if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
      if (n_att >= sc.max_steps && s1 < s_end && status == 0) status = 1;
      dt = dt_next;
      nfe += S;
      nacc += accept ? 1 : 0;
      nrej += accept ? 0 : 1;
    }
  }

  for (int b = b_lo + tid; b < b_hi; b += nth) {
    for (int d = 0; d < D; ++d) {
      const long k = long(b) * D + d;
      ay0_out[k] = AY[k] + g[k];
    }
    for (int j = 0; j < n_ps; ++j)
      aps_out[long(j) * B + b] = APS[long(j) * B + b];
  }
  for (int p = p_lo + tid; p < p_hi; p += nth) aw_out[p] = AW[p];
  if (blk == 0 && tid == 0) {
    at_out[0] = at;
    stats[0] = nfe;
    stats[1] = nacc;
    stats[2] = nrej;
    stats[3] = status;
  }
}

// Workspace values of K3's engine before the right-hand side's rows.
inline long rk_adjoint_work_size(int S, int B, int D, int n_ps) {
  return (6 + 2 * long(S)) * B * D + (2 + long(S)) * n_ps * long(B);
}

// Shared quadrature values K3 keeps (in shared memory or pwork): the
// accumulator, its increment and every stage's values.
inline long rk_adjoint_quad_size(int n_w, int S, int ti) {
  return 2 * long(n_w) + long(S) * (n_w + ti);
}

// Bytes of K3's grid workspace: the meetings' counter, the stage partials
// [S][n_blocks][n_w + ti] and the error shares [n_blocks][2].
inline long rk_adjoint_grid_bytes(int S, int n_blocks, int n_red,
                                  long item) {
  return 16 + (long(S) * n_blocks * n_red + 2L * n_blocks) * item;
}

// K3's launch: n_blocks blocks of `threads`, all resident together (a
// cooperative launch, which refuses a grid that cannot be), or an error;
// never fewer blocks than asked. A coupled plan takes one block.
template <typename T, class Aug>
cudaError_t launch_rk_adjoint(const void* tau, const void* ys, const void* g,
                              void* ay0, void* aw, void* at, void* aps,
                              void* stats, void* work, void* pwork,
                              void* gwork, long gwork_bytes, int n_blocks,
                              const Aug& aug, size_t smem, int threads,
                              const Tableau<T>& tab, const AdjScalars<T>& sc,
                              cudaStream_t stream) {
  if (n_blocks < 1 || (Aug::kBatch && n_blocks != 1) || !gwork ||
      gwork_bytes < rk_adjoint_grid_bytes(tab.S, n_blocks,
                                          aug.n_w + aug.ti, sizeof(T)))
    return cudaErrorInvalidValue;
  const T* a_tau = static_cast<const T*>(tau);
  const T* a_ys = static_cast<const T*>(ys);
  const T* a_g = static_cast<const T*>(g);
  T* a_ay0 = static_cast<T*>(ay0);
  T* a_aw = static_cast<T*>(aw);
  T* a_at = static_cast<T*>(at);
  T* a_aps = static_cast<T*>(aps);
  int* a_stats = static_cast<int*>(stats);
  T* a_work = static_cast<T*>(work);
  T* a_pwork = static_cast<T*>(pwork);
  unsigned char* a_gwork = static_cast<unsigned char*>(gwork);
  Aug a_aug = aug;
  Tableau<T> a_tab = tab;
  AdjScalars<T> a_sc = sc;
  void* args[] = {&a_tau,  &a_ys,    &a_g,     &a_ay0,   &a_aw,
                  &a_at,   &a_aps,   &a_stats, &a_work,  &a_pwork,
                  &a_gwork, &a_aug,  &a_tab,   &a_sc};
  return launch_grid(rk_adjoint_kernel<T, Aug>, n_blocks, threads, smem,
                     args, gwork, stream);
}

template <typename T>
AdjScalars<T> make_adj_scalars(double dt0, double rtol, double atol,
                               double dt_min, double sign, double safety,
                               double ifactor, double dfactor, int max_steps,
                               int T_obs, int B, int D, int seminorm,
                               int quad_smem) {
  AdjScalars<T> sc;
  sc.dt0 = T(dt0);
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
  sc.seminorm = seminorm;
  sc.quad_smem = quad_smem;
  return sc;
}

template <typename T>
struct PerlaneAdjScalars {
  T rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, T_obs, B, D;
  int slot_values;  // a sample's slot (lane_group_slot_values)
  int slot_smem;    // the block's slots in shared memory (else `work`)
  int quad_regs;    // the quadratures in registers (lane_group_quad_regs)
};

// K6: every sample under its own step controller (pallas_adjoint.py:681).
// Each sample takes adaptive steps on (y, a_y) with its own s, dt, accept
// decision, counters and status, under the (y, a_y) seminorm sqrt(sum of
// 2D squared scaled errors / 2D); dt carries over from one interval to the
// next. The TPU kernel decides each lane's acceptance in a first pass and
// then runs the stage evaluations again for the lane-summed quadratures
// with each lane's accept x dt x b_sol folded into its cotangent. Here each
// trial's weighted stage terms, (dt b_j) (sign x_j), join the sample's STEP
// sums while the stages run, and ACC += STEP only when the sample accepts.
// That one rule replaces the second pass, and it keeps a rejected trial
// that overflowed out of the sums (the TPU kernel adds its Inf x 0 = NaN).
// A sample whose attempts reach max_steps, or whose rejected step falls
// below dt_min, stops with status 1 or 2 and stays inactive. lane_stats
// holds each sample's nfe (stages an attempt), accepted, rejected and
// status, stats their sums and the largest status.
//
// Design. A group of kLaneGroup = 16 threads (a tile of one warp) owns a
// sample for the whole sweep, and a block of 512 threads the 32
// consecutive samples [32 k, 32 k + 32): 128 blocks of 16 warps at
// B = 4096. The group splits the sample's work: the stage states, the
// error terms and the Kahan updates a feature a member (d = m, m + 16,
// ...), the right-hand side's walk as the Aug says (the MLP routes a
// layer's outputs and, in the VJP, its inputs a member; K15's generated
// group walk each row of a value a member, csrc/plan_aug.cuh
// PlanGroupAug), and the quadratures a member each (r = m,
// m + 16, ...), each member's STEP terms in registers when a sample has
// at most 16 x 16 of them (else in workspace rows, sample-major, so that a
// group's members touch neighbouring values), their running sums ACC in
// the sample's slot (read and written once an accepted attempt). Every
// member takes the same decisions from the same values: the seminorm is
// summed by every member from the group's error terms in the plain order
// (y's D terms, then a_y's), the finiteness by a vote of the group. A
// sample's slot (y, a_y, their compensations and stages, the stage state,
// the error terms, ACC and the walk's values) sits in the block's shared
// memory when the block's 32 slots fit there (about 52 KB at the spiral
// in float32), else in the workspace. Groups never wait for one another
// inside the sweep: every sync is the group's (__syncwarp with its lanes'
// mask). At the end every
// thread, idle groups past B too, meets at one barrier; then each
// quadrature's 32 sample sums meet in a warp's shuffle tree, the order of
// block_sum over 32 values, and a second, small launch adds the block
// sums in block order (quadrature_reduce_kernel):
// ops/cuda_perlane.py:perlane_adjoint_plain repeats that order
// (cuda_fixed._block_sums(acc, 32)).
template <typename T, class Aug>
__global__ void __launch_bounds__(kLaneGroup * kLaneGroups, 1)
    rk_perlane_adjoint_kernel(
        const T* __restrict__ tau, const T* __restrict__ ys,
        const T* __restrict__ g, const T* __restrict__ dt0g,
        T* __restrict__ ay0_out, T* __restrict__ aps_out,
        int* __restrict__ lane_stats, int* __restrict__ stats,
        T* __restrict__ partial, T* __restrict__ work, Aug aug,
        Tableau<T> tab_in, PerlaneAdjScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Aug::Shared ash;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  typename Aug::Local lo;
  T* const rest = aug.setup(ash, lo, smem_raw);
  if (tid == 0) tab = tab_in;
  __syncthreads();

  constexpr int gsz = kLaneGroup;
  const unsigned mask = 0xFFFFu << (tid & 16);   // the group's lanes
  const int slot = tid / gsz, m = tid % gsz;
  const int T_obs = sc.T_obs, B = sc.B, D = sc.D;
  const int S = tab.S;
  const int R = aug.n_w + aug.ti;         // shared quadratures a sample
  const int n_q = R + aug.n_ps;           // every quadrature a sample
  const long BD = long(B) * D;
  const long SV = sc.slot_values;
  const int b = blockIdx.x * kLaneGroups + slot;
  const bool mine = b < B;          // idle groups still meet at the end
  // The sample's slot: in the block's shared memory or in the workspace.
  T* const SL = sc.slot_smem ? rest + slot * SV
                             : work + long(mine ? b : 0) * SV;
  T* const Y = SL;                  // [D] y
  T* const AY = Y + D;              // [D] a_y
  T* const CY = AY + D;             // [D] Kahan compensation of y
  T* const CAY = CY + D;            // [D] ... and of a_y
  T* const KY = CAY + D;            // [S][D] stage derivatives of y
  T* const KAY = KY + S * D;        // [S][D] ... and of a_y
  T* const YA = KAY + S * D;        // [D] the stage state of y
  T* const AYA = YA + D;            // [D] ... and of a_y
  T* const E = AYA + D;             // [2 D] the squared scaled errors
  T* const ACC = E + 2 * D;         // [n_q] the accepted quadratures
  T* const GS = ACC + n_q;          // the walk's values
  // [B][n_q] the trial's quadratures where they do not fit in registers.
  T* const STEP = work + long(B) * SV + long(mine ? b : 0) * n_q;
  const bool regs = sc.quad_regs != 0;
  T stepr[kLaneQuadRegs];
  const T sf = sc.sign;
  const T denom = T(2 * D);
  int first_b = 0;                  // first stage with a nonzero weight
  while (tab.b_sol[first_b] == T(0)) ++first_b;

  T dt = mine ? dt0g[b] : T(0);
  int nfe = 0, nacc = 0, nrej = 0, status = 0;
  if (mine) {
    for (int d = m; d < D; d += gsz) AY[d] = T(0);
    for (int r = m; r < n_q; r += gsz) ACC[r] = T(0);
    aug.group_init(ash, GS, b, B, m, gsz);
    __syncwarp(mask);
  }
  for (int i = T_obs - 1; mine && i >= 1; --i) {
    // Reset y to the stored forward state; inject the cotangent.
    for (int d = m; d < D; d += gsz) {
      const long k = long(i) * BD + long(b) * D + d;
      Y[d] = ys[k];
      AY[d] = AY[d] + g[k];
      CY[d] = T(0);
      CAY[d] = T(0);
    }
    T s = -tau[i];
    const T s_end = -tau[i - 1];
    while (s < s_end && status == 0) {
      const T rem = s_end - s;
      const T dt_eff = d_min(dt, rem);
      const bool is_last = dt >= rem;
      const T s1 = is_last ? s_end : s + dt_eff;
      const T dth = s1 - s;
      for (int st = 0; st < S; ++st) {
        // Stage st's state ya = y + sum_q (h a_stq) ky_q, aya likewise.
        for (int d = m; d < D; d += gsz) {
          T yv = Y[d], av = AY[d];
          for (int q = 0; q < st; ++q) {
            const T a = tab.a[st][q];
            if (a != T(0)) {
              yv = yv + (dth * a) * KY[q * D + d];
              av = av + (dth * a) * KAY[q * D + d];
            }
          }
          YA[d] = yv;
          AYA[d] = av;
        }
        __syncwarp(mask);
        aug.group_stage(ash, lo, (-sf) * (s + tab.c[st] * dth), b, B, sf,
                        YA, AYA, KY + st * D, KAY + st * D, GS, m, gsz,
                        mask);
        // The trial's weighted quadrature terms, (dt b_st) (sign x), join
        // STEP in stage order, set at the first weighted stage.
        if (tab.b_sol[st] != T(0)) {
          const T hb = dth * tab.b_sol[st];
          const bool first = st == first_b;
          if (regs) {
#pragma unroll
            for (int j = 0; j < kLaneQuadRegs; ++j) {
              const int r = m + j * gsz;
              if (r < n_q) {
                const T term = hb * (sf * aug.group_x(ash, r, GS));
                stepr[j] = first ? term : stepr[j] + term;
              }
            }
          } else {
            for (int r = m; r < n_q; r += gsz) {
              const T term = hb * (sf * aug.group_x(ash, r, GS));
              STEP[r] = first ? term : STEP[r] + term;
            }
          }
        }
        __syncwarp(mask);   // the next walk overwrites what these read
      }
      // The (y, a_y) seminorm of the sample's error, and finiteness.
      bool bad = false;
      for (int pass = 0; pass < 2; ++pass) {
        const T* V = pass ? AY : Y;
        const T* KV = pass ? KAY : KY;
        for (int d = m; d < D; d += gsz) {
          T dv = T(0), ev = T(0);
          bool first_d = true, first_e = true;
          for (int q = 0; q < S; ++q) {
            const T kq = KV[q * D + d];
            if (tab.b_sol[q] != T(0)) {
              const T term = (dth * tab.b_sol[q]) * kq;
              dv = first_d ? term : dv + term;
              first_d = false;
            }
            if (tab.b_err[q] != T(0)) {
              const T term = (dth * tab.b_err[q]) * kq;
              ev = first_e ? term : ev + term;
              first_e = false;
            }
          }
          const T v0 = V[d];
          const T v1 = v0 + dv;
          const T esc = ev / (sc.atol + sc.rtol * d_max(d_abs(v0), d_abs(v1)));
          E[pass * D + d] = esc * esc;
          bad = bad || !d_finite(v1);
        }
      }
      const bool any_bad = __any_sync(mask, bad);
      __syncwarp(mask);
      T ss_part[2] = {T(0), T(0)};
      for (int pass = 0; pass < 2; ++pass)
        for (int d = 0; d < D; ++d)
          ss_part[pass] = ss_part[pass] + E[pass * D + d];
      const T ss = ss_part[0] + ss_part[1];
      const T ratio = d_sqrt(ss / denom);
      const bool finite = d_finite(ss) && !any_bad;
      const bool accept = (ratio <= T(1)) && finite;
      const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                      sc.ifactor, sc.dfactor, tab.order);
      const T dt_next = dth * fac;
      if (accept) {
        // The Kahan-compensated update of (y, a_y), and the trial's
        // quadratures into the sample's running sums.
        for (int pass = 0; pass < 2; ++pass) {
          T* V = pass ? AY : Y;
          T* CV = pass ? CAY : CY;
          const T* KV = pass ? KAY : KY;
          for (int d = m; d < D; d += gsz) {
            T dv = T(0);
            bool first = true;
            for (int q = 0; q < S; ++q) {
              if (tab.b_sol[q] != T(0)) {
                const T term = (dth * tab.b_sol[q]) * KV[q * D + d];
                dv = first ? term : dv + term;
                first = false;
              }
            }
            const T v0 = V[d];
            const T adj = dv - CV[d];
            const T v1 = v0 + adj;
            CV[d] = (v1 - v0) - adj;
            V[d] = v1;
          }
        }
        if (regs) {
#pragma unroll
          for (int j = 0; j < kLaneQuadRegs; ++j) {
            const int r = m + j * gsz;
            if (r < n_q) ACC[r] = ACC[r] + stepr[j];
          }
        } else {
          for (int r = m; r < n_q; r += gsz) ACC[r] = ACC[r] + STEP[r];
        }
        s = s1;
      }
      // The sample's status rules (pallas_adjoint.py:881-890).
      nfe += S;
      nacc += accept ? 1 : 0;
      nrej += accept ? 0 : 1;
      if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
      if (nacc + nrej >= sc.max_steps && s < s_end && status == 0)
        status = 1;
      dt = dt_next;
    }
  }
  if (mine) {
    for (int d = m; d < D; d += gsz) {
      const long k = long(b) * D + d;
      ay0_out[k] = AY[d] + g[k];
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
    // The per-sample quadratures out.
    for (int r = R + m; r < n_q; r += gsz)
      aps_out[long(r - R) * B + b] = ACC[r];
  }
  __syncthreads();   // every thread: the block's sums are final
  // The block's sum of each shared quadrature over its 32 samples, a warp
  // a quadrature: block_sum's tree over 32 values, by shuffles.
  const int lane = tid % kWarp;
  const int bl = blockIdx.x * kLaneGroups + lane;
  const T* const acc_l =
      (sc.slot_smem ? rest + lane * SV : work + long(bl < B ? bl : 0) * SV) +
      (ACC - SL);
  for (int r = tid / kWarp; r < R; r += blockDim.x / kWarp) {
    T v = bl < B ? acc_l[r] : T(0);
    for (int o = kWarp / 2; o > 0; o >>= 1)
      v = v + __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) partial[long(blockIdx.x) * R + r] = v;
  }
}

// K6's launch: the sweep, then the block sums in block order. `fixed` is
// the bytes the right-hand side keeps in shared memory (its setup); the
// launch adds the block's 32 slots where they fit beside it.
template <typename T, class Aug>
cudaError_t launch_rk_perlane_adjoint(
    const void* tau, const void* ys, const void* g, const void* dt0,
    void* ay0, void* aw, void* at, void* aps, void* lane_stats, void* stats,
    void* partial, void* work, long work_size, const Aug& aug, size_t fixed,
    const Tableau<T>& tab, const PerlaneAdjScalars<T>& sc_in,
    cudaStream_t st) {
  const int n_q = aug.n_w + aug.ti + aug.n_ps;
  const long walk = aug.walk_values();
  if (work_size < lane_group_work_size(tab.S, sc_in.B, sc_in.D, n_q, walk))
    return cudaErrorInvalidValue;
  PerlaneAdjScalars<T> sc = sc_in;
  sc.slot_values = int(lane_group_slot_values(tab.S, sc.D, n_q, walk));
  sc.quad_regs = lane_group_quad_regs(n_q);
  const size_t slots = sizeof(T) * size_t(kLaneGroups) * sc.slot_values;
  sc.slot_smem = fixed + slots <= size_t(kLaneSmemBytes);
  const size_t smem = fixed + (sc.slot_smem ? slots : 0);
  cudaError_t e = cudaMemsetAsync(stats, 0, 4 * sizeof(int), st);
  if (e != cudaSuccess) return e;
  auto kernel = rk_perlane_adjoint_kernel<T, Aug>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (sc.B + kLaneGroups - 1) / kLaneGroups;
  kernel<<<blocks, kLaneGroup * kLaneGroups, smem, st>>>(
      static_cast<const T*>(tau), static_cast<const T*>(ys),
      static_cast<const T*>(g), static_cast<const T*>(dt0),
      static_cast<T*>(ay0), static_cast<T*>(aps),
      static_cast<int*>(lane_stats), static_cast<int*>(stats),
      static_cast<T*>(partial), static_cast<T*>(work), aug, tab, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int R = aug.n_w + aug.ti;
  quadrature_reduce_kernel<T><<<(R + 127) / 128 + (R == 0), 128, 0, st>>>(
      static_cast<const T*>(partial), blocks, aug.n_w, aug.ti,
      static_cast<T*>(aw), static_cast<T*>(at));
  return cudaGetLastError();
}

template <typename T>
struct FixedAdjScalars {
  T sign;
  int T_obs, B, D, n_sub;
  int slot_values;  // a sample's slot (lane_group_slot_values)
  int slot_smem;    // the block's slots in shared memory (else `work`)
  int quad_regs;    // the quadratures in registers (lane_group_quad_regs)
};

// K9: n_sub equal steps per observation interval
// (pallas_fixed.py:726; a coupled plan: rk_fixed_adjoint_block_kernel
// below). Nothing in a fixed step reads the quadratures, so
// the batch never has to meet during the sweep. Each sample accumulates
// its own share of the quadratures: per step, sum_j (h b_j) (sign x_j)
// over the stages in order (the stage combine of the reference), then
// added to its running sum. stats: nfe = stages n_sub (T - 1), steps =
// n_sub (T - 1), 0, 0.
//
// Design: K6's layout without its controller. A group of kLaneGroup = 16
// threads (a tile of one warp) owns a sample for the whole sweep, a block
// of 512 threads the 32 consecutive samples [32 k, 32 k + 32): 128 blocks
// of 16 warps at B = 4096. The group splits the sample's work: the stage
// states and the Kahan updates a feature a member (d = m, m + 16, ...),
// the right-hand side's walk as the Aug says (group_stage), and the
// quadratures a member each (r = m, m + 16, ...): each member's STEP terms
// in registers when a sample has at most 16 x 16 of them (else in
// workspace rows, sample-major), their running sums ACC in the sample's
// slot, added to once a step. The slot (y, a_y, their compensations and
// stages, the stage state, ACC and the walk's values) sits in the block's
// shared memory when the block's 32 slots fit there, else in the
// workspace. The groups never wait for one another: every sync is the
// group's (__syncwarp with its lanes' mask), and a group past B leaves at
// once. At the end each sample writes its shared quadratures' running sums
// to the workspace ([R][B]) and its per-sample ones out; a second, small
// launch (fixed_tree_reduce_kernel) sums the shared ones over the batch.
template <typename T, class Aug>
__global__ void __launch_bounds__(kLaneGroup * kLaneGroups, 1)
    rk_fixed_adjoint_kernel(const T* __restrict__ tau,
                            const T* __restrict__ ys,
                            const T* __restrict__ g, T* __restrict__ ay0_out,
                            T* __restrict__ aps_out, T* __restrict__ work,
                            Aug aug, Tableau<T> tab_in,
                            FixedAdjScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Aug::Shared ash;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  typename Aug::Local lo;
  T* const rest = aug.setup(ash, lo, smem_raw);
  if (tid == 0) tab = tab_in;
  __syncthreads();

  constexpr int gsz = kLaneGroup;
  const unsigned mask = 0xFFFFu << (tid & 16);   // the group's lanes
  const int slot = tid / gsz, m = tid % gsz;
  const int T_obs = sc.T_obs, B = sc.B, D = sc.D, n_sub = sc.n_sub;
  const int b = blockIdx.x * kLaneGroups + slot;
  if (b >= B) return;
  const int S = tab.S;
  const int R = aug.n_w + aug.ti;         // shared quadratures a sample
  const int n_q = R + aug.n_ps;           // every quadrature a sample
  const long BD = long(B) * D;
  const long SV = sc.slot_values;
  // The sample's slot: in the block's shared memory or in the workspace.
  T* const SL = sc.slot_smem ? rest + slot * SV : work + long(b) * SV;
  T* const Y = SL;                  // [D] y
  T* const AY = Y + D;              // [D] a_y
  T* const CY = AY + D;             // [D] Kahan compensation of y
  T* const CAY = CY + D;            // [D] ... and of a_y
  T* const KY = CAY + D;            // [S][D] stage derivatives of y
  T* const KAY = KY + S * D;        // [S][D] ... and of a_y
  T* const YA = KAY + S * D;        // [D] the stage state of y
  T* const AYA = YA + D;            // [D] ... and of a_y
  // (K6's error terms, 2 D values, unused here.)
  T* const ACC = AYA + 3 * D;       // [n_q] the running quadratures
  T* const GS = ACC + n_q;          // the walk's values
  // [B][n_q] the step's quadratures where they do not fit in registers,
  // then [R][B] the running sums for the end-of-sweep trees.
  T* const STEP = work + long(B) * SV + long(b) * n_q;
  T* const X = work + long(B) * (SV + n_q);
  const bool regs = sc.quad_regs != 0;
  T stepr[kLaneQuadRegs];
  const T sf = sc.sign;
  int first_b = 0;                  // first stage with a nonzero weight
  while (tab.b_sol[first_b] == T(0)) ++first_b;

  for (int d = m; d < D; d += gsz) AY[d] = T(0);
  for (int r = m; r < n_q; r += gsz) ACC[r] = T(0);
  aug.group_init(ash, GS, b, B, m, gsz);
  __syncwarp(mask);
  for (int i = T_obs - 1; i >= 1; --i) {
    // Reset y to the stored forward state; inject the cotangent.
    for (int d = m; d < D; d += gsz) {
      const long k = long(i) * BD + long(b) * D + d;
      Y[d] = ys[k];
      AY[d] = AY[d] + g[k];
      CY[d] = T(0);
      CAY[d] = T(0);
    }
    const T s_start = -tau[i];
    const T h = (-tau[i - 1] - s_start) / T(n_sub);
    for (int j = 0; j < n_sub; ++j) {
      const T s = s_start + h * T(j);
      for (int st = 0; st < S; ++st) {
        // Stage st's state ya = y + sum_q (h a_stq) ky_q, aya likewise.
        for (int d = m; d < D; d += gsz) {
          T yv = Y[d], av = AY[d];
          for (int q = 0; q < st; ++q) {
            const T a = tab.a[st][q];
            if (a != T(0)) {
              yv = yv + (h * a) * KY[q * D + d];
              av = av + (h * a) * KAY[q * D + d];
            }
          }
          YA[d] = yv;
          AYA[d] = av;
        }
        __syncwarp(mask);
        aug.group_stage(ash, lo, (-sf) * (s + tab.c[st] * h), b, B, sf, YA,
                        AYA, KY + st * D, KAY + st * D, GS, m, gsz, mask);
        // This stage's weighted quadrature terms, (h b_st) (sign x), join
        // the step's sums in stage order, set at the first weighted stage.
        if (tab.b_sol[st] != T(0)) {
          const T hb = h * tab.b_sol[st];
          const bool first = st == first_b;
          if (regs) {
#pragma unroll
            for (int q = 0; q < kLaneQuadRegs; ++q) {
              const int r = m + q * gsz;
              if (r < n_q) {
                const T term = hb * (sf * aug.group_x(ash, r, GS));
                stepr[q] = first ? term : stepr[q] + term;
              }
            }
          } else {
            for (int r = m; r < n_q; r += gsz) {
              const T term = hb * (sf * aug.group_x(ash, r, GS));
              STEP[r] = first ? term : STEP[r] + term;
            }
          }
        }
        __syncwarp(mask);   // the next walk overwrites what these read
      }
      // The Kahan-compensated update of (y, a_y), and the step's
      // quadratures into the running sums.
      for (int pass = 0; pass < 2; ++pass) {
        T* V = pass ? AY : Y;
        T* CV = pass ? CAY : CY;
        const T* KV = pass ? KAY : KY;
        for (int d = m; d < D; d += gsz) {
          T dv = T(0);
          bool first = true;
          for (int q = 0; q < S; ++q) {
            if (tab.b_sol[q] != T(0)) {
              const T term = (h * tab.b_sol[q]) * KV[q * D + d];
              dv = first ? term : dv + term;
              first = false;
            }
          }
          const T v0 = V[d];
          const T adj = dv - CV[d];
          const T v1 = v0 + adj;
          CV[d] = (v1 - v0) - adj;
          V[d] = v1;
        }
      }
      if (regs) {
#pragma unroll
        for (int q = 0; q < kLaneQuadRegs; ++q) {
          const int r = m + q * gsz;
          if (r < n_q) ACC[r] = ACC[r] + stepr[q];
        }
      } else {
        for (int r = m; r < n_q; r += gsz) ACC[r] = ACC[r] + STEP[r];
      }
    }
  }
  for (int d = m; d < D; d += gsz) {
    const long k = long(b) * D + d;
    ay0_out[k] = AY[d] + g[k];
  }
  for (int r = m; r < R; r += gsz) X[long(r) * B + b] = ACC[r];
  for (int r = R + m; r < n_q; r += gsz)
    aps_out[long(r - R) * B + b] = ACC[r];
}

// K9's batch sums of the shared quadratures, a warp a quadrature r: over
// each kFixedTree samples, block_sum's tree (lane j adds samples 64 k + j
// and 64 k + 32 + j, then warp_tree_sum's shuffles by 16, 8, 4, 2, 1;
// samples past B add +0), the trees then added in order
// (ops/cuda_fixed.py _block_sums(acc, 64)). X: [R][B]; aw gets the first
// n_w, at_out the a_t (0 without a time column); block 0's thread 0 writes
// stats nfe, steps, 0, 0.
template <typename T>
__global__ void fixed_tree_reduce_kernel(const T* __restrict__ X, int B,
                                         int n_w, int ti,
                                         T* __restrict__ aw,
                                         T* __restrict__ at_out,
                                         int* __restrict__ stats, int nfe,
                                         int steps) {
  const int lane = threadIdx.x % kWarp;
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[0] = nfe;
    stats[1] = steps;
    stats[2] = 0;
    stats[3] = 0;
    if (!ti) at_out[0] = T(0);
  }
  if (r >= n_w + ti) return;
  const T* const x = X + long(r) * B;
  T total = T(0);
  for (int k = 0; k * kFixedTree < B; ++k) {
    const int b0 = k * kFixedTree + lane, b1 = b0 + kWarp;
    const T v = warp_tree_sum((b0 < B ? x[b0] : T(0)) +
                              (b1 < B ? x[b1] : T(0)));
    total = k == 0 ? v : total + v;
  }
  if (lane == 0) {
    if (r < n_w)
      aw[r] = total;
    else
      at_out[0] = total;
  }
}

// K9's launch: the sweep, then the trees. `fixed` is the bytes the
// right-hand side keeps in shared memory (its setup); the launch adds the
// block's 32 slots where they fit beside it.
template <typename T, class Aug>
cudaError_t launch_rk_fixed_adjoint(const void* tau, const void* ys,
                                    const void* g, void* ay0, void* aw,
                                    void* at, void* aps, void* stats,
                                    void* work, long work_size,
                                    const Aug& aug, size_t fixed,
                                    const Tableau<T>& tab,
                                    const FixedAdjScalars<T>& sc_in,
                                    cudaStream_t st) {
  const int R = aug.n_w + aug.ti;
  const int n_q = R + aug.n_ps;
  const long walk = aug.walk_values();
  if (work_size <
      fixed_group_work_size(tab.S, sc_in.B, sc_in.D, n_q, walk, R))
    return cudaErrorInvalidValue;
  FixedAdjScalars<T> sc = sc_in;
  sc.slot_values = int(lane_group_slot_values(tab.S, sc.D, n_q, walk));
  sc.quad_regs = lane_group_quad_regs(n_q);
  const size_t slots = sizeof(T) * size_t(kLaneGroups) * sc.slot_values;
  sc.slot_smem = fixed + slots <= size_t(kLaneSmemBytes);
  const size_t smem = fixed + (sc.slot_smem ? slots : 0);
  auto kernel = rk_fixed_adjoint_kernel<T, Aug>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int blocks = (sc.B + kLaneGroups - 1) / kLaneGroups;
  kernel<<<blocks, kLaneGroup * kLaneGroups, smem, st>>>(
      static_cast<const T*>(tau), static_cast<const T*>(ys),
      static_cast<const T*>(g), static_cast<T*>(ay0), static_cast<T*>(aps),
      static_cast<T*>(work), aug, tab, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long SV = sc.slot_values;
  const T* X = static_cast<const T*>(work) + long(sc.B) * (SV + n_q);
  const int steps = sc.n_sub * (sc.T_obs - 1);
  constexpr int kReduceWarps = 8;
  fixed_tree_reduce_kernel<T>
      <<<(R + kReduceWarps - 1) / kReduceWarps + (R == 0),
         kReduceWarps * kWarp, 0, st>>>(
          X, sc.B, aug.n_w, aug.ti, static_cast<T*>(aw),
          static_cast<T*>(at), static_cast<int*>(stats), tab.S * steps,
          steps);
  return cudaGetLastError();
}

// K9 with a coupled plan (csrc/plan_aug.cuh PlanBatchAugRhs, K3's
// batch-wide walk): the sweep of rk_fixed_adjoint_kernel on ONE block of
// kAdjThreads threads, since every stage's walk meets the block at each
// coupling and at each coupling's transpose (the meets' order is the one
// ops/plan_adjoint.py aug_terms repeats, bmax ties split evenly). Thread
// tid owns the samples b = tid, tid + kAdjThreads, ... for the stage
// states, the Kahan updates and the quadratures; per stage it puts its
// samples' stage state, the block meets, every thread runs the walk
// (stage_batch), and each sample's weighted quadrature terms join its
// step's sums in stage order, then its running sums once a step, exactly
// as a group does in rk_fixed_adjoint_kernel. So the end-of-sweep trees
// (fixed_tree_reduce_kernel) and ops/cuda_fixed.py fixed_adjoint_plain are
// the uncoupled route's. Workspace: y, a_y, their compensations ([B][D]
// each), the stages of both ([S][B][D] each), the running quadratures and
// the step's ([n_q][B] each: the shared ones first, the trees' rows), then
// the walk's rows (plan_aug.cuh plan_batch_aug_values). Bound on the H100:
// one SM walks the whole batch, 8 samples a thread at B = 4096, and the
// meets are block barriers; nothing of the card's other SMs takes part.
template <typename T, class Aug>
__global__ void __launch_bounds__(kAdjThreads, 1)
    rk_fixed_adjoint_block_kernel(const T* __restrict__ tau,
                                  const T* __restrict__ ys,
                                  const T* __restrict__ g,
                                  T* __restrict__ ay0_out,
                                  T* __restrict__ aps_out,
                                  T* __restrict__ work, Aug aug,
                                  Tableau<T> tab_in, FixedAdjScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ typename Aug::Shared ash;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  typename Aug::Local lo;
  T* const red = aug.setup(ash, lo, smem_raw);   // [nth] the meets' scratch
  if (tid == 0) tab = tab_in;
  __syncthreads();

  const int T_obs = sc.T_obs, B = sc.B, D = sc.D, n_sub = sc.n_sub;
  const int S = tab.S;
  const int R = aug.n_w + aug.ti;         // shared quadratures a sample
  const int n_q = R + aug.n_ps;           // every quadrature a sample
  const long BD = long(B) * D;
  const long BQ = long(B) * n_q;
  T* const Y = work;               // [B][D] y
  T* const AY = Y + BD;            // [B][D] a_y
  T* const CY = AY + BD;           // [B][D] Kahan compensation of y
  T* const CAY = CY + BD;          // ... and of a_y
  T* const KY = CAY + BD;          // [S][B][D] stage derivatives of y
  T* const KAY = KY + S * BD;      // [S][B][D] ... and of a_y
  T* const ACC = KAY + S * BD;     // [n_q][B] the running quadratures
  T* const STEP = ACC + BQ;        // [n_q][B] the step's
  T* const RW = STEP + BQ;         // the walk's rows
  const T sf = sc.sign;
  int first_b = 0;                 // first stage with a nonzero weight
  while (tab.b_sol[first_b] == T(0)) ++first_b;

  for (int b = tid; b < B; b += nth) {
    for (int d = 0; d < D; ++d) AY[long(b) * D + d] = T(0);
    for (int r = 0; r < n_q; ++r) ACC[long(r) * B + b] = T(0);
  }
  for (int i = T_obs - 1; i >= 1; --i) {
    // Reset y to the stored forward state; inject the cotangent.
    for (int b = tid; b < B; b += nth)
      for (int d = 0; d < D; ++d) {
        const long k = long(b) * D + d;
        Y[k] = ys[long(i) * BD + k];
        AY[k] = AY[k] + g[long(i) * BD + k];
        CY[k] = T(0);
        CAY[k] = T(0);
      }
    const T s_start = -tau[i];
    const T h = (-tau[i - 1] - s_start) / T(n_sub);
    for (int j = 0; j < n_sub; ++j) {
      const T s = s_start + h * T(j);
      for (int st = 0; st < S; ++st) {
        // Stage st's state ya = y + sum_q (h a_stq) ky_q, aya likewise.
        for (int b = tid; b < B; b += nth) {
          const long base = long(b) * D;
          T* ya = aug.ya(lo);
          T* aya = aug.aya(lo);
          for (int d = 0; d < D; ++d) {
            T yv = Y[base + d], av = AY[base + d];
            for (int q = 0; q < st; ++q) {
              const T a = tab.a[st][q];
              if (a != T(0)) {
                yv = yv + (h * a) * KY[q * BD + base + d];
                av = av + (h * a) * KAY[q * BD + base + d];
              }
            }
            ya[d] = yv;
            aya[d] = av;
          }
          aug.put(ash, lo, b, B, RW);
        }
        __syncthreads();
        aug.stage_batch(ash, lo, (-sf) * (s + tab.c[st] * h), B, sf,
                        KY + st * BD, KAY + st * BD, RW, red);
        __syncthreads();
        // This stage's weighted quadrature terms, (h b_st) (sign x), join
        // the step's sums in stage order, set at the first weighted stage.
        if (tab.b_sol[st] != T(0)) {
          const T hb = h * tab.b_sol[st];
          const bool first = st == first_b;
          for (int b = tid; b < B; b += nth)
            for (int r = 0; r < n_q; ++r) {
              const T x = r < R ? aug.quad_x(ash, r, RW, B, b)
                                : aug.sample_x(ash, r - R, RW, B, b);
              const T term = hb * (sf * x);
              T& acc = STEP[long(r) * B + b];
              acc = first ? term : acc + term;
            }
        }
      }
      // The Kahan-compensated update of (y, a_y), and the step's
      // quadratures into the running sums.
      for (int b = tid; b < B; b += nth) {
        const long base = long(b) * D;
        for (int pass = 0; pass < 2; ++pass) {
          T* V = pass ? AY : Y;
          T* CV = pass ? CAY : CY;
          const T* KV = pass ? KAY : KY;
          for (int d = 0; d < D; ++d) {
            T dv = T(0);
            bool first = true;
            for (int q = 0; q < S; ++q) {
              if (tab.b_sol[q] != T(0)) {
                const T term = (h * tab.b_sol[q]) * KV[q * BD + base + d];
                dv = first ? term : dv + term;
                first = false;
              }
            }
            const T v0 = V[base + d];
            const T adj = dv - CV[base + d];
            const T v1 = v0 + adj;
            CV[base + d] = (v1 - v0) - adj;
            V[base + d] = v1;
          }
        }
        for (int r = 0; r < n_q; ++r)
          ACC[long(r) * B + b] = ACC[long(r) * B + b] + STEP[long(r) * B + b];
      }
    }
  }
  for (int b = tid; b < B; b += nth) {
    for (int d = 0; d < D; ++d) {
      const long k = long(b) * D + d;
      ay0_out[k] = AY[k] + g[k];
    }
    for (int r = R; r < n_q; ++r)
      aps_out[long(r - R) * B + b] = ACC[long(r) * B + b];
  }
}

// Values of rk_fixed_adjoint_block_kernel's workspace before the walk's
// rows.
inline long fixed_block_own_values(int S, int B, int D, int n_q) {
  return (4L + 2L * S) * B * D + 2L * n_q * B;
}

// K9's one-block launch (a coupled plan): the sweep, then the trees of
// launch_rk_fixed_adjoint over the running quadratures' shared rows.
// `smem` is the bytes the walk keeps in shared memory (its constants) and
// the meets' scratch; the walk's rows follow the sweep's own in `work`
// (the caller checked work_size).
template <typename T, class Aug>
cudaError_t launch_rk_fixed_adjoint_block(
    const void* tau, const void* ys, const void* g, void* ay0, void* aw,
    void* at, void* aps, void* stats, void* work, const Aug& aug,
    size_t smem, int threads, const Tableau<T>& tab,
    const FixedAdjScalars<T>& sc, cudaStream_t st) {
  if (threads != kAdjThreads) return cudaErrorInvalidValue;
  auto kernel = rk_fixed_adjoint_block_kernel<T, Aug>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<1, threads, smem, st>>>(
      static_cast<const T*>(tau), static_cast<const T*>(ys),
      static_cast<const T*>(g), static_cast<T*>(ay0), static_cast<T*>(aps),
      static_cast<T*>(work), aug, tab, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int R = aug.n_w + aug.ti;
  const T* X = static_cast<const T*>(work) + (4L + 2L * tab.S) * sc.B * sc.D;
  const int steps = sc.n_sub * (sc.T_obs - 1);
  constexpr int kReduceWarps = 8;
  fixed_tree_reduce_kernel<T>
      <<<(R + kReduceWarps - 1) / kReduceWarps + (R == 0),
         kReduceWarps * kWarp, 0, st>>>(
          X, sc.B, aug.n_w, aug.ti, static_cast<T*>(aw),
          static_cast<T*>(at), static_cast<int*>(stats), tab.S * steps,
          steps);
  return cudaGetLastError();
}

}  // namespace tfd
