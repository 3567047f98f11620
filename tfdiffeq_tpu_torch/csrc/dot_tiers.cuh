// K4: the dot-precision tiers of the MLP right-hand side, and the batch-wide
// stage evaluation of K2 and K8 that carries them.
//
// Replaces tfdiffeq_tpu/ops/pallas_kernels.py:361 (_mixed_dot) and the tier
// choice of _make_net (:374-439; no pallas_call of its own: the TPU runs it
// inside K2, K5 and K8). A layer that _layer_uses_mxu selects (the host's
// tier code per layer, Net.tier) computes its product
//
//   'mixed' (kTierMixed): w16 = bf16(W), h_hi = bf16(h), h_lo = bf16(h -
//       h_hi), acc = w16 . h_hi + w16 . h_lo  (two passes);
//   'bf16'  (kTierBf16):  acc = bf16(W) . bf16(h)  (one pass);
//
// with the time column of layer 0 as one more input, split like the state;
// the bias is added afterwards in the working type, then the activation.
// Every other layer ('highest') sums its float products in input order on
// the CUDA cores, as the per-thread routes do, so it keeps their bits.
// bf16() rounds to nearest even, from float64 through float32 (what
// astype(bfloat16) and torch's .to(torch.bfloat16) do).
//
// Float32 (tier_tile_eval). A block takes its rows a tile of `rt` rows at a
// time (TierTile: up to 64, no more than the block owns; K8 and tier_net give
// a block 16 rows, K2's grid a block its own share of the 16-row tiles, one
// each at B = 1024 over 64 blocks) and keeps the tile's
// activations in shared memory across all layers, in two float regions of rt x
// (ld + 8); only the layer-0 inputs come from the workspace and only the last
// layer's outputs go back to it. A tier layer first writes its input's hi and
// lo bf16 parts once, into two A tiles (row stride din + 8, so the 8 rows of
// an ldmatrix hit 8 distinct bank groups) in the other region; then the
// layer's packed bf16 weights stream through a two-stage ring of k-slices
// (kKSlice = 64 columns of a chunk of nc output rows), `cp.async` copies of
// the next slice in flight while the warps multiply the current one, one block
// barrier a slice. Each warp owns 16 rows x 64 outputs of the chunk:
// ldmatrix.x4 brings its A fragments (hi and lo) and each 16-output group's B
// fragments from shared memory, and
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` accumulates hi and lo
// in separate float32 register sets over k in order, added at the end as the
// reference adds its two dots; the epilogue adds the bias, applies the
// activation and writes the layer's outputs over its input floats. mma.sync,
// not wgmma: a warpgroup's 64-row wgmma needs its A and B tiles in the
// canonical core-matrix layouts its shared-memory descriptors address, and
// that layout could only be checked on the card; ldmatrix and mma.sync take
// the padded row-major tiles above. The tensor cores' accumulation order is
// their own, so a float32 tier matches its plain version
// (ops/cuda_kernels.py:dot_tier_plain) to roundoff; each output's mma chain
// runs over k in order in separate hi and lo accumulators, so the tile's shape
// does not change a bit. Float64: the same rounding and splitting on the CUDA
// cores, float64 sums in input order, the activations in the workspace
// (batch_mlp_eval's scalar layers): bitwise equal to the plain version, which
// checks the tier logic exactly on the card.
//
// Bound on the H100: the mma work is 2 passes x 2 flops x B x n_w a 'mixed'
// evaluation (537 MFLOP at B = 1024 on the wide MLP), 0.54 us at the 989
// TFLOP/s bf16 peak; the bf16 weights (256 KB at the wide MLP) are read
// once a tile from L2. It is bound by neither: a tile is one block's chain
// of k-slices (a barrier, a cp.async wait and a few dozen mma each), its
// splits and its epilogues (the activation of every output, tanh on the
// CUDA cores), so 'bf16' takes as long as 'mixed' (chip_smoke.py [19]
// times both). The epilogue's activation is a template argument and its
// biases load before its stores; 16-row tiles give each block a quarter of
// that chain's elementwise work and spread B = 1024 over 64 SMs, in K8 and
// in K2 alike.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mlp_rk.cuh"

namespace tfd {

// Tier codes; ops/cuda_kernels.py:_TIER_CODES holds the same table.
enum Tier : int { kTierHighest = 0, kTierMixed = 1, kTierBf16 = 2 };

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int min_i(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

// Give the layers their tiers and the offsets of their bf16 weights
// ([pad16(dout)][pad16(din)] row-major, zero-padded); returns the bf16
// weight count, or -1 for an unknown tier.
inline long set_tiers(Net& net, const int* tiers) {
  long off = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    const int tier = tiers ? tiers[l] : kTierHighest;
    if (tier < kTierHighest || tier > kTierBf16) return -1;
    net.tier[l] = tier;
    net.w16_off[l] = int(off);
    off += long(pad16(net.dout[l])) * pad16(net.din[l]);
  }
  return off;
}

// Row stride of the batch route's activation buffers.
inline int batch_ld(const Net& net) { return pad16(net_max_width(net)); }

// Bytes of the batch route's workspace for `rows` samples (a multiple of
// 16): the bf16 weights, then the layer-0 inputs X0 ([ld][rows]) and two
// hidden buffers of [rows][ld] values each. ops/cuda_kernels.py:
// _tier_work_bytes mirrors it.
inline long batch_work_bytes(const Net& net, long n_w16, long rows,
                             long item) {
  const long w16_bytes = (2 * n_w16 + 255) / 256 * 256;
  return w16_bytes + 3 * rows * batch_ld(net) * item;
}

// bf16(x) in the working type (round to nearest even, float64 through
// float32).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ double round_bf16(double x) {
  return double(__bfloat162float(__float2bfloat16_rn(float(x))));
}

// Pack the weights of every layer into bf16 ([pad16(dout)][pad16(din)],
// zeros in the padding), one grid-stride pass a layer.
template <typename T>
__global__ void tier_pack_kernel(const T* __restrict__ w, Net net,
                                 __nv_bfloat16* __restrict__ w16) {
  const long stride = long(gridDim.x) * blockDim.x;
  for (int l = 0; l < net.n_layers; ++l) {
    const int din = net.din[l], dout = net.dout[l], din_p = pad16(din);
    const long n = long(pad16(dout)) * din_p;
    for (long e = long(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
         e += stride) {
      const int o = int(e / din_p), i = int(e % din_p);
      const float v = (o < dout && i < din)
                          ? float(w[net.w_off[l] + long(o) * din + i])
                          : 0.0f;
      w16[net.w16_off[l] + e] = __float2bfloat16_rn(v);
    }
  }
}

// Two floats as the bf16x2 register of an mma fragment (the first in the
// low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 float32.
__device__ __forceinline__ void mma_bf16_16x8x16(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, lane i giving the address of
// row i % 8 of matrix i / 8; r[m] is this lane's part of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The float32 tile geometry of a block of n_warps warps that owns
// block_rows rows (the host's choice, tier_tile): rg x cg warps take the
// mma tiles, each 16 rows x kWarpCols outputs; rt = 16 rg rows a tile (at
// most the block's rows); nc = kWarpCols cg outputs a chunk; two float
// regions of rt x ldf (ldf = ld + 8) and a ring of two k-slices of
// nc x (kKSlice + 8) bf16, `bytes` in all (-1: none fits).
constexpr int kWarpSize = 32;
constexpr int kKSlice = 64;
constexpr int kWarpCols = 64;
constexpr long kTierSmemBudget = 216L * 1024;

struct TierTile {
  int rg, cg, rt, nc, ldf;
  long region, bytes;
};

inline TierTile tier_tile_for(int ld, int widest, int n_warps,
                              long block_rows);

inline TierTile tier_tile(const Net& net, int n_warps, long block_rows) {
  int widest = 16;
  for (int l = 0; l < net.n_layers; ++l)
    widest = max_i(widest, pad16(net.dout[l]));
  return tier_tile_for(batch_ld(net), widest, n_warps, block_rows);
}

// The geometry for activations of row stride ld and outputs up to `widest`
// (a multiple of 16) a layer.
inline TierTile tier_tile_for(int ld, int widest, int n_warps,
                              long block_rows) {
  const int cg_need = (widest + kWarpCols - 1) / kWarpCols;
  TierTile t{};
  t.bytes = -1;
  for (int rg = 4; rg >= 1; rg /= 2) {
    if (n_warps % rg || 16L * rg > max_i(16, int(block_rows))) continue;
    TierTile c{};
    c.rg = rg;
    c.cg = min_i(n_warps / rg, cg_need);
    c.rt = 16 * rg;
    c.nc = kWarpCols * c.cg;
    c.ldf = ld + 8;
    c.region = (long(c.rt) * c.ldf * 4 + 15) / 16 * 16;
    c.bytes = 2 * c.region + 2L * c.nc * (kKSlice + 8) * 2;
    if (c.bytes <= kTierSmemBudget) return c;
  }
  return t;
}

// A warp's outputs of a chunk, act(acc + bias) into X (zero past dout):
// C fragment rows g (c0, c1) and g + 8 (c2, c3), columns 2q, 2q + 1. The
// activation is a template argument, so the element loop has no switch;
// the thread's biases are loaded before its first store (a store to X
// could otherwise hold each bias load behind it). Without kBias (a plan's
// dot: its bias and activation are instructions of their own) the output
// is acc itself.
template <int kAct, bool kBias = true>
__device__ __forceinline__ void tier_epilogue(
    float* __restrict__ X, int ldf, const float (&hi)[4][2][4],
    const float (&lo)[4][2][4], bool mixed, int row0, int cbase, int dout,
    int dout_p, const float* __restrict__ bias, int g, int q) {
  float bv[4][2][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = cbase + 16 * j + 8 * n + 2 * q + e;
        bv[j][n][e] = (kBias && o < dout) ? __ldg(bias + o) : 0.0f;
      }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = cbase + 16 * j + 8 * n + 2 * q + (c & 1);
        if (o >= dout_p) continue;
        const int s = row0 + g + 8 * (c >> 1);
        const float acc = mixed ? hi[j][n][c] + lo[j][n][c] : hi[j][n][c];
        X[long(s) * ldf + o] =
            o >= dout ? 0.0f
                      : (kBias ? activate(kAct, acc + bv[j][n][c & 1]) : acc);
      }
}

// A float32 tier layer on the tensor cores for the tile's nr rows: the
// input floats X (stride ldf) are split into the A tiles at A (hi, then
// lo; row stride din_p + 8), the weights stream through `ring`, and the
// outputs act(acc + bias) overwrite X (zero past dout); with a null bias
// the product alone (a plan's dot).
__device__ inline void mma_tier_layer(float* __restrict__ X,
                                      __nv_bfloat16* __restrict__ A,
                                      __nv_bfloat16* __restrict__ ring,
                                      const TierTile& tt, int nr,
                                      const __nv_bfloat16* __restrict__ w16,
                                      int din, int dout,
                                      const float* __restrict__ bias,
                                      int code, int tier) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  const int din_p = pad16(din), dout_p = pad16(dout);
  const int lda = din_p + 8;
  const int lds = kKSlice + 8;          // a ring row, in bf16
  const bool mixed = tier == kTierMixed;
  __nv_bfloat16* const Ahi = A;
  __nv_bfloat16* const Alo = A + long(tt.rt) * lda;
  const int n_slices = (din_p + kKSlice - 1) / kKSlice;
  const int n_chunks = (dout_p + tt.nc - 1) / tt.nc;
  const int n_units = n_slices * n_chunks;
  // Unit u: chunk u / n_slices, k-slice u % n_slices, into ring stage
  // u & 1; thread t copies 16-byte piece t % 8 of rows t / 8, t / 8 + nth
  // / 8, ... (a slice row has at most 8 pieces).
  auto load_unit = [&](int u) {
    const int chunk = u / n_slices;
    const int o0 = chunk * tt.nc, k0 = (u - chunk * n_slices) * kKSlice;
    const int rows = min_i(tt.nc, dout_p - o0);
    const int per = min_i(kKSlice, din_p - k0) / 8;   // 16-byte pieces
    const int c = (tid & 7) * 8;
    __nv_bfloat16* st = ring + long(u & 1) * tt.nc * lds;
    if ((tid & 7) < per)
      for (int r = tid >> 3; r < rows; r += nth >> 3)
        cp_async16(st + long(r) * lds + c,
                   w16 + long(o0 + r) * din_p + k0 + c);
    cp_async_commit();
  };
  load_unit(0);
  // The input's hi and lo parts, once: a warp a row at a time.
  for (int s = warp; s < nr; s += n_warps)
    for (int c = 2 * lane; c < din_p; c += 2 * kWarpSize) {
      const float2 v =
          *reinterpret_cast<const float2*>(X + long(s) * tt.ldf + c);
      const float h0 = round_bf16(v.x), h1 = round_bf16(v.y);
      *reinterpret_cast<uint32_t*>(Ahi + long(s) * lda + c) =
          pack_bf16x2(h0, h1);
      if (mixed)
        *reinterpret_cast<uint32_t*>(Alo + long(s) * lda + c) =
            pack_bf16x2(v.x - h0, v.y - h1);
    }
  // This warp's mma tile: rows 16 rgi.., outputs kWarpCols cgi.. of a chunk.
  const int rgi = warp % tt.rg, cgi = warp / tt.rg;
  const bool active = warp < tt.rg * tt.cg && 16 * rgi < nr;
  const int g = lane >> 2, q = lane & 3;
  float hi[4][2][4], lo[4][2][4];
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait_all();
    __syncthreads();            // unit u is in; unit u - 1's stage is free
    if (u + 1 < n_units) load_unit(u + 1);
    const int chunk = u / n_slices, slice = u - chunk * n_slices;
    const int k0 = slice * kKSlice;
    const int nk = min_i(kKSlice, din_p - k0) / 16;
    const int cbase = chunk * tt.nc + cgi * kWarpCols;
    bool jv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) jv[j] = cbase + 16 * j < dout_p;
    if (slice == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) hi[j][n][c] = lo[j][n][c] = 0.0f;
    }
    if (active) {
      const __nv_bfloat16* st = ring + long(u & 1) * tt.nc * lds;
      for (int kk = 0; kk < nk; ++kk) {
        // Every fragment of this k-step first, then its mma: A rows 16 rgi
        // + lane % 16, columns k0 + 16 kk + 8 (lane / 16); B outputs cgi 64
        // + 16 j + lane % 8 + 8 (lane / 16) of the chunk, columns 16 kk +
        // 8 ((lane / 8) % 2) of the slice.
        const long a_off = long(16 * rgi + (lane & 15)) * lda + k0 +
                           16 * kk + (lane >> 4) * 8;
        uint32_t a_hi[4], a_lo[4], b[4][4];
        ldmatrix_x4(a_hi, Ahi + a_off);
        if (mixed) ldmatrix_x4(a_lo, Alo + a_off);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (jv[j])
            ldmatrix_x4(b[j], st + long(cgi * kWarpCols + 16 * j +
                                        (lane & 7) + (lane >> 4) * 8) * lds +
                                  16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!jv[j]) continue;
          mma_bf16_16x8x16(hi[j][0], a_hi, b[j][0], b[j][1]);
          mma_bf16_16x8x16(hi[j][1], a_hi, b[j][2], b[j][3]);
          if (mixed) {
            mma_bf16_16x8x16(lo[j][0], a_lo, b[j][0], b[j][1]);
            mma_bf16_16x8x16(lo[j][1], a_lo, b[j][2], b[j][3]);
          }
        }
      }
    }
    if (active && slice == n_slices - 1 && !bias) {
      tier_epilogue<kIdentity, false>(X, tt.ldf, hi, lo, mixed, 16 * rgi,
                                      cbase, dout, dout_p, bias, g, q);
    } else if (active && slice == n_slices - 1) {
      const int row0 = 16 * rgi;
      switch (code) {
        case kTanh:
          tier_epilogue<kTanh>(X, tt.ldf, hi, lo, mixed, row0, cbase, dout,
                               dout_p, bias, g, q);
          break;
        case kRelu:
          tier_epilogue<kRelu>(X, tt.ldf, hi, lo, mixed, row0, cbase, dout,
                               dout_p, bias, g, q);
          break;
        case kElu:
          tier_epilogue<kElu>(X, tt.ldf, hi, lo, mixed, row0, cbase, dout,
                              dout_p, bias, g, q);
          break;
        case kSigmoid:
          tier_epilogue<kSigmoid>(X, tt.ldf, hi, lo, mixed, row0, cbase,
                                  dout, dout_p, bias, g, q);
          break;
        case kSoftplus:
          tier_epilogue<kSoftplus>(X, tt.ldf, hi, lo, mixed, row0, cbase,
                                   dout, dout_p, bias, g, q);
          break;
        case kSilu:
          tier_epilogue<kSilu>(X, tt.ldf, hi, lo, mixed, row0, cbase, dout,
                               dout_p, bias, g, q);
          break;
        default:
          tier_epilogue<kIdentity>(X, tt.ldf, hi, lo, mixed, row0, cbase,
                                   dout, dout_p, bias, g, q);
      }
    }
  }
  __syncthreads();
}

// A 'highest' float32 layer of the tile in shared memory: Y[s][o] =
// act(sum_i W[o][i] X[s][i] in input order + bias[o]), zero past dout.
__device__ inline void smem_scalar_layer(const float* __restrict__ X,
                                         float* __restrict__ Y, int ldf,
                                         int nr, const float* __restrict__ W,
                                         int din, int dout,
                                         const float* __restrict__ bias,
                                         int code) {
  const int dout_p = pad16(dout);
  for (int e = threadIdx.x; e < nr * dout_p; e += blockDim.x) {
    const int s = e / dout_p, o = e % dout_p;
    float out = 0.0f;
    if (o < dout) {
      const float* x = X + long(s) * ldf;
      const float* row = W + long(o) * din;
      float acc = row[0] * x[0];
      for (int i = 1; i < din; ++i) acc = acc + row[i] * x[i];
      out = activate(code, acc + bias[o]);
    }
    Y[long(s) * ldf + o] = out;
  }
  __syncthreads();
}

// One float64 layer on the CUDA cores, every product in input order:
// 'highest' layers and the tiers (bf16-rounded weights and activation
// parts, products and sums in T). Row s's input i is X[s xs + i xi] (X0 is
// feature-major, the hidden buffers row-major); Y is [rows][ld]. Threads
// take (row, output) pairs in turn, outputs fastest.
template <typename T>
__device__ void scalar_layer(const T* __restrict__ X, long xs, long xi,
                             T* __restrict__ Y, int ld, int row0, int nrows,
                             const T* __restrict__ W,
                             const __nv_bfloat16* __restrict__ w16, int din,
                             int dout, const T* __restrict__ bias, int code,
                             int tier) {
  const int dout_p = pad16(dout), din_p = pad16(din);
  const long n = long(nrows) * dout_p;
  for (long e = threadIdx.x; e < n; e += blockDim.x) {
    const int s = row0 + int(e / dout_p), o = int(e % dout_p);
    T out = T(0);
    if (o < dout) {
      const T* x = X + long(s) * xs;
      T acc;
      if (tier == kTierHighest) {
        const T* row = W + long(o) * din;
        acc = row[0] * x[0];
        for (int i = 1; i < din; ++i) acc = acc + row[i] * x[i * xi];
      } else {
        const __nv_bfloat16* row = w16 + long(o) * din_p;
        T acc_hi = T(0), acc_lo = T(0);
        for (int i = 0; i < din; ++i) {
          const T xv = x[i * xi];
          const T wv = T(__bfloat162float(row[i]));
          const T h_hi = round_bf16(xv);
          const T t_hi = wv * h_hi;
          acc_hi = i == 0 ? t_hi : acc_hi + t_hi;
          if (tier == kTierMixed) {
            const T t_lo = wv * round_bf16(xv - h_hi);
            acc_lo = i == 0 ? t_lo : acc_lo + t_lo;
          }
        }
        acc = tier == kTierMixed ? acc_hi + acc_lo : acc_hi;
      }
      out = activate(code, acc + bias[o]);
    }
    Y[long(s) * ld + o] = out;
  }
}

// The batch route's pointers into its workspace (batch_work_bytes' layout)
// and, in float32, its tile geometry in shared memory.
template <typename T>
struct BatchBufs {
  const __nv_bfloat16* w16;
  T* X0;   // layer-0 inputs: y ** p, then the time column, feature-major
           // ([ld][rows], so a warp's samples write a row together)
  T* H1;   // outputs, [rows][ld] (float64: hidden activations, ping)
  T* H2;   // float64: ... and pong
  int ld;
  long rows;
  TierTile tile;   // float32: the tiles in shared memory
};

// The buffers of blocks of n_warps warps that own block_rows rows each;
// float32 fails (tile.bytes < 0) when no tile fits in shared memory.
template <typename T>
BatchBufs<T> batch_bufs(void* work, const Net& net, long n_w16, long rows,
                        int n_warps, long block_rows) {
  BatchBufs<T> bb;
  unsigned char* base = static_cast<unsigned char*>(work);
  bb.w16 = reinterpret_cast<const __nv_bfloat16*>(base);
  bb.ld = batch_ld(net);
  bb.X0 = reinterpret_cast<T*>(base + (2 * n_w16 + 255) / 256 * 256);
  bb.rows = rows;
  bb.H1 = bb.X0 + rows * bb.ld;
  bb.H2 = bb.H1 + rows * bb.ld;
  if (sizeof(T) == sizeof(float)) {
    bb.tile = tier_tile(net, n_warps, block_rows);
  } else {
    bb.tile = TierTile{};
    bb.tile.bytes = 0;
  }
  return bb;
}

// Shared memory the batch route takes at the start of the dynamic shared
// memory (16-byte aligned), before the engine's own.
template <typename T>
__host__ __device__ size_t batch_smem(const BatchBufs<T>& bb) {
  return bb.tile.bytes > 0 ? size_t(bb.tile.bytes) : 0;
}

// Zero the block's rows of X0 (its padded columns and rows stay zero).
template <typename T>
__device__ void batch_clear(const BatchBufs<T>& bb, int row0, int nrows) {
  for (int d = threadIdx.x / kWarpSize; d < bb.ld;
       d += blockDim.x / kWarpSize)
    for (int s = threadIdx.x % kWarpSize; s < nrows; s += kWarpSize)
      bb.X0[d * bb.rows + row0 + s] = T(0);
}

// Sample b's layer-0 inputs from its state (read by `state(d)`): y ** p and,
// with a time column, t.
template <typename T, typename F>
__device__ __forceinline__ void batch_put(const BatchBufs<T>& bb,
                                          const Net& net, int b, T t,
                                          F state) {
  const int D = net.din[0] - net.time_input;
  T* x = bb.X0 + b;
  const long step = bb.rows;
  for (int d = 0; d < D; ++d) {
    const T v = state(d);
    T h = v;
    for (int p = 1; p < net.input_power; ++p) h = h * v;
    x[d * step] = h;
  }
  if (net.time_input) x[D * step] = t;
}

// Float32: the MLP for the rows [r0, r0 + nr) (nr a multiple of 16, at most
// tt.rt) in shared memory at `sm`, from X0 to the rows of `out`.
__device__ inline void tier_tile_eval(const Net& net,
                                      const float* __restrict__ w,
                                      const BatchBufs<float>& bb,
                                      unsigned char* sm, int r0, int nr,
                                      float* __restrict__ out) {
  const TierTile& tt = bb.tile;
  const int ld = bb.ld, ldf = tt.ldf;
  float* cur = reinterpret_cast<float*>(sm);
  float* oth = reinterpret_cast<float*>(sm + tt.region);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(sm + 2 * tt.region);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int d = warp; d < ld; d += n_warps)
    for (int s = lane; s < nr; s += kWarpSize)
      cur[long(s) * ldf + d] = bb.X0[d * bb.rows + r0 + s];
  __syncthreads();
  for (int l = 0; l < net.n_layers; ++l) {
    const int code = (l == net.n_layers - 1) ? net.act_final : net.act_hidden;
    const float* bias = w + net.b_off[l];
    if (net.tier[l] != kTierHighest) {
      mma_tier_layer(cur, reinterpret_cast<__nv_bfloat16*>(oth), ring, tt,
                     nr, bb.w16 + net.w16_off[l], net.din[l], net.dout[l],
                     bias, code, net.tier[l]);
    } else {
      smem_scalar_layer(cur, oth, ldf, nr, w + net.w_off[l], net.din[l],
                        net.dout[l], bias, code);
      float* tmp = cur;
      cur = oth;
      oth = tmp;
    }
  }
  const int dout_p = pad16(net.dout[net.n_layers - 1]);
  for (int s = warp; s < nr; s += n_warps)
    for (int o = lane; o < dout_p; o += kWarpSize)
      out[long(r0 + s) * ld + o] = cur[long(s) * ldf + o];
  __syncthreads();
}

// The MLP for the block's rows [row0, row0 + nrows) from X0, layer by layer
// (the caller has written X0 and met the block before). Float32 takes the
// rows a tile at a time in shared memory (its region at the start of the
// dynamic shared memory); float64 every layer on the CUDA cores through
// the workspace, a barrier after each. Returns the buffer that holds the
// outputs (row stride bb.ld), which every thread may read on return.
template <typename T>
__device__ const T* batch_mlp_eval(const Net& net, const T* __restrict__ w,
                                   const BatchBufs<T>& bb, int row0,
                                   int nrows) {
  if constexpr (sizeof(T) == sizeof(float)) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    for (int r0 = row0; r0 < row0 + nrows; r0 += bb.tile.rt)
      tier_tile_eval(net, w, bb, smem_raw, r0,
                     min_i(bb.tile.rt, row0 + nrows - r0), bb.H1);
    return bb.H1;
  } else {
    const T* hin = bb.X0;
    T* hout = bb.H1;
    for (int l = 0; l < net.n_layers; ++l) {
      const int code =
          (l == net.n_layers - 1) ? net.act_final : net.act_hidden;
      const long xs = l == 0 ? 1 : bb.ld, xi = l == 0 ? bb.rows : 1;
      scalar_layer<T>(hin, xs, xi, hout, bb.ld, row0, nrows,
                      w + net.w_off[l], bb.w16 + net.w16_off[l], net.din[l],
                      net.dout[l], w + net.b_off[l], code, net.tier[l]);
      __syncthreads();
      hin = hout;
      hout = hout == bb.H1 ? bb.H2 : bb.H1;
    }
    return hin;
  }
}

// ---- a plan's dot at a tier (csrc/plan_rhs.cuh PlanTileRhs) ----
//
// The product alone: a plan's bias and activation are instructions of
// their own, and its time enters as a row of the dot's input like any
// other, so the entry has an identity epilogue and no time column. The
// input and the output are live rows of the plan ([row][B], sample b at
// column b); the weights are the dot's wT constant packed to bf16 by the
// plan's pack (tier_pack_kernel's element rule). Rows at or past B read as
// zero and are not written.

// Float32: the block's rows [row0, row0 + nr) (nr a multiple of 16) a tile
// of at most tt.rt rows at a time in shared memory at `sm`: the input rows
// into the tile's first region (zero past din), mma_tier_layer with a null
// bias, the outputs back to the live rows.
__device__ inline void plan_tile_dot(float* __restrict__ live, int B,
                                     int in_row, int out_row, int din,
                                     int dout,
                                     const __nv_bfloat16* __restrict__ w16,
                                     const TierTile& tt, unsigned char* sm,
                                     int row0, int nr, int tier) {
  float* X = reinterpret_cast<float*>(sm);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(sm + tt.region);
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(sm + 2 * tt.region);
  const int din_p = pad16(din);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r0 = row0; r0 < row0 + nr; r0 += tt.rt) {
    const int n = min_i(tt.rt, row0 + nr - r0);
    for (int i = warp; i < din_p; i += n_warps)
      for (int s = lane; s < n; s += kWarpSize) {
        const int b = r0 + s;
        X[long(s) * tt.ldf + i] =
            (i < din && b < B) ? live[long(in_row + i) * B + b] : 0.0f;
      }
    __syncthreads();
    mma_tier_layer(X, A, ring, tt, n, w16, din, dout, nullptr, kIdentity,
                   tier);
    for (int o = warp; o < dout; o += n_warps)
      for (int s = lane; s < n; s += kWarpSize) {
        const int b = r0 + s;
        if (b < B) live[long(out_row + o) * B + b] = X[long(s) * tt.ldf + o];
      }
    __syncthreads();
  }
}

// Any type on the CUDA cores (the float64 route): each output the tier's
// sums in input order, as scalar_layer's tier branch (bf16-rounded weights
// and input parts, products and sums in T) and ops/cuda_kernels.py
// dot_tier_plain; threads take (row, output) pairs, outputs fastest.
template <typename T>
__device__ void plan_dot_scalar(T* __restrict__ live, int B, int in_row,
                                int out_row, int din, int dout,
                                const __nv_bfloat16* __restrict__ w16,
                                int row0, int nr, int tier) {
  const int din_p = pad16(din);
  const long n = long(nr) * dout;
  for (long e = threadIdx.x; e < n; e += blockDim.x) {
    const int b = row0 + int(e / dout), o = int(e % dout);
    if (b >= B) continue;
    const __nv_bfloat16* row = w16 + long(o) * din_p;
    T acc_hi = T(0), acc_lo = T(0);
    for (int i = 0; i < din; ++i) {
      const T xv = live[long(in_row + i) * B + b];
      const T wv = T(__bfloat162float(row[i]));
      const T h_hi = round_bf16(xv);
      const T t_hi = wv * h_hi;
      acc_hi = i == 0 ? t_hi : acc_hi + t_hi;
      if (tier == kTierMixed) {
        const T t_lo = wv * round_bf16(xv - h_hi);
        acc_lo = i == 0 ? t_lo : acc_lo + t_lo;
      }
    }
    live[long(out_row + o) * B + b] =
        tier == kTierMixed ? acc_hi + acc_lo : acc_hi;
  }
  __syncthreads();
}

}  // namespace tfd
