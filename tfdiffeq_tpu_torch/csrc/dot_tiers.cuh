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
// Float32: the tier products run on the tensor cores, one warp a tile of 16
// samples x 16 outputs, `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
// (A = the samples' activations, split into bf16 parts as the fragment is
// loaded; B = the packed bf16 weights; float32 accumulation, hi and lo in
// separate accumulators added at the end, as the reference adds its two
// dots). The tensor cores' accumulation order is their own, so a float32
// tier matches its plain version (ops/cuda_kernels.py:dot_tier_plain) to
// roundoff. Float64: the same rounding and splitting on the CUDA cores,
// float64 sums in input order: bitwise equal to the plain version, which
// checks the tier logic exactly on the card.
//
// Design. An mma needs 16 samples of a warp together, so on this route a
// stage evaluation is batch-wide: each thread writes its samples' layer-0
// inputs (y ** p and the time column) to the workspace X0, the block meets,
// and then layer by layer every warp takes output tiles of the block's rows,
// with a barrier between layers. Activations live in device workspace rows
// of `ld` values (global memory, L2-resident at the main path's 1024 x 256);
// the padded columns of X0 stay zero and the padded weights are zero, so
// they add nothing.
//
// Bound on the H100: the mma work is 2 passes x 2 flops x B x n_w a 'mixed'
// evaluation (537 MFLOP at B = 1024 on the wide MLP), 0.54 us at the 989
// TFLOP/s bf16 peak. Here it is bound by the latency of each warp's
// fragment loads from L2 (no shared-memory staging, no wgmma, no TMA: a
// later PR's work) and, in K2, by running on one SM.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mlp_rk.cuh"

namespace tfd {

// Tier codes; ops/cuda_kernels.py:_TIER_CODES holds the same table.
enum Tier : int { kTierHighest = 0, kTierMixed = 1, kTierBf16 = 2 };

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }

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
// 16): the bf16 weights, then the layer-0 inputs X0 and two hidden buffers
// of [rows][ld] values each. ops/cuda_kernels.py:_tier_work_bytes mirrors it.
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

// x's hi part bf16(x) and lo part bf16(x - hi) as bf16x2 registers.
__device__ __forceinline__ void split_bf16x2(float2 x, uint32_t& hi,
                                             uint32_t& lo) {
  const float h0 = round_bf16(x.x), h1 = round_bf16(x.y);
  hi = pack_bf16x2(h0, h1);
  lo = pack_bf16x2(x.x - h0, x.y - h1);
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

// One float32 tier layer on the tensor cores: Y[s][o] = act(acc + bias[o])
// for the rows [row0, row0 + nrows) (a multiple of 16) and o < pad16(dout),
// zero past dout. Each warp takes 16-sample x 16-output tiles in turn.
__device__ inline void mma_tier_layer(const float* __restrict__ X,
                               float* __restrict__ Y, int ld, int row0,
                               int nrows, const __nv_bfloat16* __restrict__ w16,
                               int din, int dout,
                               const float* __restrict__ bias, int code,
                               int tier, int warp, int n_warps) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int din_p = pad16(din), dout_p = pad16(dout);
  const int n_nt = dout_p / 16;
  const int n_tiles = (nrows / 16) * n_nt;
  const bool mixed = tier == kTierMixed;
  for (int tile = warp; tile < n_tiles; tile += n_warps) {
    const int s0 = row0 + (tile / n_nt) * 16;
    const int o0 = (tile % n_nt) * 16;
    const float* x0 = X + long(s0 + g) * ld + 2 * q;
    const float* x1 = x0 + 8L * ld;
    float hi[2][4] = {}, lo[2][4] = {};
    for (int k0 = 0; k0 < din_p; k0 += 16) {
      // A fragment: rows g and g + 8, columns 2q, 2q + 1 (+ 8).
      const float2 v[4] = {*reinterpret_cast<const float2*>(x0 + k0),
                           *reinterpret_cast<const float2*>(x1 + k0),
                           *reinterpret_cast<const float2*>(x0 + k0 + 8),
                           *reinterpret_cast<const float2*>(x1 + k0 + 8)};
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (mixed)
          split_bf16x2(v[r], a_hi[r], a_lo[r]);
        else
          a_hi[r] = pack_bf16x2(v[r].x, v[r].y);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B fragment: output o0 + 8j + g, inputs k0 + 2q, 2q + 1 (+ 8).
        const __nv_bfloat16* wr =
            w16 + long(o0 + 8 * j + g) * din_p + k0 + 2 * q;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + 8);
        mma_bf16_16x8x16(hi[j], a_hi, b0, b1);
        if (mixed) mma_bf16_16x8x16(lo[j], a_lo, b0, b1);
      }
    }
    // C fragment: rows g (c0, c1) and g + 8 (c2, c3), columns 2q, 2q + 1.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = s0 + g + 8 * (c >> 1);
        const int o = o0 + 8 * j + 2 * q + (c & 1);
        const float acc = mixed ? hi[j][c] + lo[j][c] : hi[j][c];
        Y[long(s) * ld + o] =
            o < dout ? activate(code, acc + bias[o]) : 0.0f;
      }
    }
  }
}

// One layer on the CUDA cores, every product in input order: 'highest'
// layers of either type, and the tiers in float64 (bf16-rounded weights and
// activation parts, products and sums in T). Threads take (row, output)
// pairs in turn, outputs fastest.
template <typename T>
__device__ void scalar_layer(const T* __restrict__ X, T* __restrict__ Y,
                             int ld, int row0, int nrows,
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
      const T* x = X + long(s) * ld;
      T acc;
      if (tier == kTierHighest) {
        const T* row = W + long(o) * din;
        acc = row[0] * x[0];
        for (int i = 1; i < din; ++i) acc = acc + row[i] * x[i];
      } else {
        const __nv_bfloat16* row = w16 + long(o) * din_p;
        T acc_hi = T(0), acc_lo = T(0);
        for (int i = 0; i < din; ++i) {
          const T wv = T(__bfloat162float(row[i]));
          const T h_hi = round_bf16(x[i]);
          const T t_hi = wv * h_hi;
          acc_hi = i == 0 ? t_hi : acc_hi + t_hi;
          if (tier == kTierMixed) {
            const T t_lo = wv * round_bf16(x[i] - h_hi);
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

// The batch route's pointers into its workspace (batch_work_bytes' layout).
template <typename T>
struct BatchBufs {
  const __nv_bfloat16* w16;
  T* X0;   // layer-0 inputs: y ** p, then the time column
  T* H1;   // hidden activations, ping
  T* H2;   // ... and pong
  int ld;
};

template <typename T>
BatchBufs<T> batch_bufs(void* work, const Net& net, long n_w16, long rows) {
  BatchBufs<T> bb;
  unsigned char* base = static_cast<unsigned char*>(work);
  bb.w16 = reinterpret_cast<const __nv_bfloat16*>(base);
  bb.ld = batch_ld(net);
  bb.X0 = reinterpret_cast<T*>(base + (2 * n_w16 + 255) / 256 * 256);
  bb.H1 = bb.X0 + rows * bb.ld;
  bb.H2 = bb.H1 + rows * bb.ld;
  return bb;
}

// Zero the block's rows of X0 (its padded columns and rows stay zero).
template <typename T>
__device__ void batch_clear(const BatchBufs<T>& bb, int row0, int nrows) {
  const long n = long(nrows) * bb.ld;
  for (long e = threadIdx.x; e < n; e += blockDim.x)
    bb.X0[long(row0) * bb.ld + e] = T(0);
}

// Sample b's layer-0 inputs from its state (read by `state(d)`): y ** p and,
// with a time column, t.
template <typename T, typename F>
__device__ __forceinline__ void batch_put(const BatchBufs<T>& bb,
                                          const Net& net, int b, T t,
                                          F state) {
  const int D = net.din[0] - net.time_input;
  T* x = bb.X0 + long(b) * bb.ld;
  for (int d = 0; d < D; ++d) {
    const T v = state(d);
    T h = v;
    for (int p = 1; p < net.input_power; ++p) h = h * v;
    x[d] = h;
  }
  if (net.time_input) x[D] = t;
}

// The MLP for the block's rows [row0, row0 + nrows) from X0, layer by layer,
// with a barrier after each (the caller has written X0 and met the block
// before). Returns the buffer that holds the outputs (row stride bb.ld).
template <typename T>
__device__ const T* batch_mlp_eval(const Net& net, const T* __restrict__ w,
                                   const BatchBufs<T>& bb, int row0,
                                   int nrows) {
  const T* hin = bb.X0;
  T* hout = bb.H1;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int l = 0; l < net.n_layers; ++l) {
    const int code = (l == net.n_layers - 1) ? net.act_final : net.act_hidden;
    const __nv_bfloat16* w16 = bb.w16 + net.w16_off[l];
    const T* bias = w + net.b_off[l];
    if constexpr (sizeof(T) == sizeof(float)) {
      if (net.tier[l] != kTierHighest) {
        mma_tier_layer(hin, hout, bb.ld, row0, nrows, w16, net.din[l],
                       net.dout[l], bias, code, net.tier[l], warp, n_warps);
      } else {
        scalar_layer<T>(hin, hout, bb.ld, row0, nrows, w + net.w_off[l], w16,
                        net.din[l], net.dout[l], bias, code, kTierHighest);
      }
    } else {
      scalar_layer<T>(hin, hout, bb.ld, row0, nrows, w + net.w_off[l], w16,
                      net.din[l], net.dout[l], bias, code, net.tier[l]);
    }
    __syncthreads();
    hin = hout;
    hout = hout == bb.H1 ? bb.H2 : bb.H1;
  }
  return hin;
}

}  // namespace tfd
