// K13: a whole adaptive explicit-RK solve of the ODE-Net conv-ODE block in
// one launch, one step controller per block of samples.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_conv.py:110 (conv_solve:
// the right-hand side _make_conv_f :36 inside the shared whole-solve engine
// _make_solve_kernel, pallas_kernels.py:726; launched by fast.py:2416 from
// solve_conv_ode). The field is GN -> relu -> ConcatConv3x3 -> GN -> relu ->
// ConcatConv3x3 -> GN over a [C, H, W] map per sample (upstream
// examples/odenet_mnist.py ODEfunc); the time enters as the conv's last
// input channel, t * TM with TM precomputed on the host. Per attempt: the
// stages of the tableau, the RMS error over the block, the clamped
// I-controller, Kahan accumulation, the dense-output drain of every
// requested time the accepted step covers, the counters and the status;
// zero fill of the output on early exit. The tableau comes in as launch
// arguments, as in K2.
//
// Design. The batch is cut into controller blocks (ops/cuda_conv.py), each
// with its own controller, error norm and first step, as the reference's
// grid programs are. A controller block runs on several CTAs of one
// cooperative grid (at most one 512-thread block per SM, csrc/grid_meet.cuh
// launch_grid): ops/cuda_conv.py conv_grid gives the controller blocks the
// CTAs in proportion to their samples, at least one each and at most one a
// sample, and CTA k of a controller block of nb samples on n CTAs owns its
// samples [k nb / n, (k + 1) nb / n) (one sample a CTA at B = 128, two at
// B = 256). GroupNorm and the conv are per sample, so a CTA's samples need
// nothing from other CTAs but the step decision: the CTAs of a controller
// block meet once an attempt (group_shares at the controller block's own
// counter), each bringing its share of the error sum (its threads' owned
// elements in order, then block_sum's tree) and its finiteness flag; every
// CTA adds the shares in CTA order and takes the same total and decision.
// The state and the stages sit in device scratch (L2-resident; [S + 7]
// buffers of B * C * H * W values, each CTA its samples' rows). In shared
// memory: the conv input of one sample, zero-padded to (H + 2) x (W + 2)
// (so every tap reads a value and the loop has no branch), the applied
// conv's weights where they fit (float32 up to C = 64: 147 KB; float64
// reads them from L2; they arrive by cp.async while the GroupNorm before
// the conv runs), and the conv outputs of the CTA's samples where they
// fit. The conv runs on the CUDA cores in full precision: a thread
// computes kCoTile output channels at one position (a warp 32 positions of
// one channel tile), each output summing its nine taps in OFFSETS order
// (an outside tap multiplies the zero padding, as the plain version does)
// and each tap input channel after input channel, one load of the input
// and two of eight weights (16-byte loads, the warp's broadcast) feeding
// eight products. GroupNorm sums each channel's positions in order, then
// each group's channels in order. Built with --fmad=false, the plain
// version in ops/cuda_conv.py repeats all of it operation for operation,
// the error sum in the grid's order (cuda_kernels.adaptive_solve_plain
// with n_blocks the controller block's CTAs, a sample's elements a unit).
//
// Bound on the H100. Two convs of 2 C^2 9 H W flops a sample (7.2 MFLOP at
// C = 64, 7x7) an evaluation: compute-bound (a few MB move a solve). A CTA
// owns one or two samples at the ODE-Net's batches, so 128 SMs work where
// 8 did (one a controller block). Measured with clock64 stamps at B = 128
// (one sample a CTA): the conv is about 70% of a CTA's cycles, 392 of its
// 512 threads busy and each input channel's step about 130 cycles for the
// CTA's 13 warps, near what the shared-memory wavefronts of its loads
// allow (a 16-byte broadcast costs four); two positions a thread, with
// half the warps, ran slower. The tensor-core tiers (3xTF32) are later
// work (ROADMAP).
#include "grid_meet.cuh"
#include "mlp_rk.cuh"

namespace tfd {

// Threads of each CTA, a power of two (block_sum);
// ops/cuda_conv.py:CONV_THREADS.
constexpr int kConvThreads = 512;
// Output channels a thread computes at one position of the conv.
constexpr int kCoTile = 8;
// Ints a CTA's row of the grid table (ops/cuda_conv.py _conv_table): its
// controller block, the block's first sample and samples, the CTA's rank
// in it and the block's CTAs, the block's first CTA and its meeting
// counter.
constexpr int kConvCtaInts = 7;

template <typename T>
struct ConvScalars {
  T rtol, atol, dt_min, sign, eps, safety, ifactor, dfactor;
  int max_steps, valid, T_out, B, C, G, H, W, w_smem, z_smem, n_meet;
};

// One CTA's view of the field, the same in every thread.
template <typename T>
struct ConvCtx {
  int n_own, C, G, H, W, P, PW, PP;   // PW, PP: the padded row and map
  T eps;
  const T* wg;       // packed weights in device memory
  T* w_s;            // one conv's weights in shared memory, or null
  T* s_ch;           // [2][C] channel sums, sums of squares
  T* s_grp;          // [2][G] group means, inverse deviations
  T* Hs;             // [C][PP] the conv input, zero-padded (shared)
  int h_off, w_off;  // Hs and w_s as offsets into the shared array
  T* Zb;             // [n_own][C][P] conv outputs (shared, or scratch)
};

// Where position p of a [C][P] map sits in the padded [C][PP] layout.
__device__ __forceinline__ int padded(int p, int W) {
  return (p / W + 1) * (W + 2) + p % W + 1;
}

// GroupNorm of one sample's X [C][H][W] (padded layout when kPadIn) into Y
// (padded when kPadOut; Y may be X): mode 0 applies relu after it, mode 1
// multiplies it by `mult` (the time direction's sign). s_ch [2 C] and
// s_grp [2 G] are shared scratch. Not inlined (nor is conv3x3): inside the
// kernel, with its whole solve's state live, the loops spilled registers
// to local memory, which the shared-memory carve-out leaves to L2.
template <typename T, bool kPadIn, bool kPadOut>
__device__ __noinline__ void group_norm(const T* X, T* Y, const T* scale,
                                        const T* bias, int mode, T mult,
                                        int C, int G, int H, int W, T eps,
                                        T* s_ch, T* s_grp) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int cg = C / G, P = H * W, PW = W + 2, PP = (H + 2) * PW;
  // Where row i of channel c starts in each layout.
  auto in_row = [=](int c, int i) {
    return kPadIn ? c * PP + (i + 1) * PW + 1 : c * P + i * W;
  };
  auto out_row = [=](int c, int i) {
    return kPadOut ? c * PP + (i + 1) * PW + 1 : c * P + i * W;
  };
  for (int c = tid; c < C; c += nth) {
    const T x0 = X[in_row(c, 0)];
    T s1 = x0;
    T s2 = x0 * x0;
    for (int i = 0; i < H; ++i) {
      const T* x = X + in_row(c, i);
      for (int j = i == 0 ? 1 : 0; j < W; ++j) {
        s1 = s1 + x[j];
        s2 = s2 + x[j] * x[j];
      }
    }
    s_ch[c] = s1;
    s_ch[C + c] = s2;
  }
  __syncthreads();
  const T cnt = T(cg * P);
  for (int g = tid; g < G; g += nth) {
    const T* c1 = s_ch + g * cg;
    const T* c2 = c1 + C;
    T gs = c1[0], gq = c2[0];
    for (int k = 1; k < cg; ++k) {
      gs = gs + c1[k];
      gq = gq + c2[k];
    }
    const T mean = gs / cnt;
    T var = gq / cnt - mean * mean;
    var = var < T(0) ? T(0) : var;   // flax's clamp; NaN stays NaN
    s_grp[g] = mean;
    s_grp[G + g] = T(1) / d_sqrt(var + eps);
  }
  __syncthreads();
  // A row of W elements a thread.
  for (int r = tid; r < C * H; r += nth) {
    const int c = r / H, i = r % H, gi = c / cg;
    const T* x = X + in_row(c, i);
    T* y = Y + out_row(c, i);
    const T mean = s_grp[gi], inv = s_grp[G + gi];
    const T sc = scale[c], bc = bias[c];
    for (int j = 0; j < W; ++j) {
      T v = ((x[j] - mean) * inv) * sc + bc;
      if (mode == 0) {
        v = v < T(0) ? T(0) : v;
      } else {
        v = mult * v;
      }
      y[j] = v;
    }
  }
  __syncthreads();
}

// The kCoTile weights of one tap and input channel from wt (0 past ntile
// unless kFull): two 16-byte loads where kVec.
template <typename T, bool kFull, bool kVec>
__device__ __forceinline__ void load_weights(const T* __restrict__ wt,
                                             int ntile, T (&w)[kCoTile]) {
  if constexpr (kVec) {
    const float4 a = reinterpret_cast<const float4*>(wt)[0];
    const float4 b = reinterpret_cast<const float4*>(wt)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < kCoTile; ++u)
      w[u] = (kFull || u < ntile) ? wt[u] : T(0);
  }
}

// One output tile of the conv: kCoTile output channels from co0 (ntile
// of them real unless kFull) at position p. Hs: the padded input [C][PP]
// in shared memory; Wt: [tap][c_in][c_out], in shared memory (16-byte
// loads where kVec) or device memory.
template <typename T, bool kFull, bool kVec>
__device__ __forceinline__ void conv_tile(const T* __restrict__ Hs,
                                          const T* __restrict__ Wt, T* Z,
                                          const T* bias, const T* tm,
                                          T tval, int C, int P, int W,
                                          int PP, int co0, int p) {
  const int ntile = kFull ? kCoTile : min(kCoTile, C - co0);
  const int PW = W + 2;
  const T* const h_tl = Hs + (p / W) * PW + p % W;   // tap (0, 0)
  T acc[kCoTile];
  for (int tap = 0; tap < 9; ++tap) {
    const T* h = h_tl + (tap / 3) * PW + tap % 3;
    const T* wt = Wt + tap * C * C + co0;
    T term[kCoTile], w[kCoTile];
    load_weights<T, kFull, kVec>(wt, ntile, w);
    const T h0 = h[0];
#pragma unroll
    for (int u = 0; u < kCoTile; ++u) term[u] = w[u] * h0;
    for (int ci = 1; ci < C; ++ci) {
      load_weights<T, kFull, kVec>(wt + ci * C, ntile, w);
      const T hv = h[ci * PP];
#pragma unroll
      for (int u = 0; u < kCoTile; ++u) term[u] = term[u] + w[u] * hv;
    }
#pragma unroll
    for (int u = 0; u < kCoTile; ++u)
      acc[u] = tap == 0 ? term[u] : acc[u] + term[u];
  }
#pragma unroll
  for (int u = 0; u < kCoTile; ++u) {
    if (kFull || u < ntile) {
      const int co = co0 + u;
      Z[co * P + p] = (acc[u] + bias[co]) + tm[co * P + p] * tval;
    }
  }
}

// The concat-t 3x3 SAME conv of the padded input (shared memory, h_off
// values into it) into Z [C][P]: out = (sum over the nine taps of (sum
// over c_in of w * h) + bias) + tm * t. The weights [tap][c_in][c_out]
// sit in shared memory at w_off when kSmemW, else at Wg in device memory.
// A thread computes a tile of kCoTile output channels at one position (a
// warp 32 positions of one tile): per input channel one load of the input
// and one of eight weights (two 16-byte loads in float, the warp's
// broadcast) feed eight products. The buffers are named as offsets into
// the shared array so that the loads are shared-memory loads.
template <typename T, bool kSmemW>
__device__ __noinline__ void conv3x3(int h_off, const T* Wg, int w_off,
                                     T* Z, const T* bias, const T* tm,
                                     T tval, int C, int P, int W, int PP) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* const Hs = reinterpret_cast<const T*>(smem_raw) + h_off;
  const T* const Wt =
      kSmemW ? reinterpret_cast<const T*>(smem_raw) + w_off : Wg;
  const int n_ct = (C + kCoTile - 1) / kCoTile;
  constexpr bool kVec = kSmemW && sizeof(T) == 4;
  for (int it = threadIdx.x; it < n_ct * P; it += blockDim.x) {
    const int p = it % P;
    const int co0 = (it / P) * kCoTile;
    if (C % kCoTile == 0)
      conv_tile<T, true, kVec>(Hs, Wt, Z, bias, tm, tval, C, P, W, PP, co0,
                               p);
    else
      conv_tile<T, false, false>(Hs, Wt, Z, bias, tm, tval, C, P, W, PP,
                                 co0, p);
  }
  __syncthreads();
}

// Start copying n values from device memory into shared memory with
// 16-byte cp.async (the caller waits, cp_async_wait_all, and meets at a
// barrier before reading them); where either end is not 16-byte aligned,
// copy them now with plain loads (the caller's barrier still orders them).
template <typename T>
__device__ void copy_in_async(T* dst, const T* src, int n) {
  const int tid = threadIdx.x, nth = blockDim.x;
  constexpr int kV = 16 / sizeof(T);
  if (n % kV == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0 &&
      (reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
    for (int i = tid; i < n / kV; i += nth) {
      const unsigned a = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + i * kV));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                   "l"(src + i * kV));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = tid; i < n; i += nth) dst[i] = src[i];
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// out = sign * f(sign * s, X) for the CTA's samples (X, out: [n_own][C][P]
// in scratch); tval = sign * s is the raw time the conv's time channel
// sees. Conv by conv, sample by sample: GN -> relu into the padded input,
// the conv into Z; then the last GN.
template <typename T>
__device__ void conv_rhs(const ConvCtx<T>& cx, const T* X, T* out, T tval,
                         T sign) {
  const int C = cx.C, P = cx.P;
  const long CP = long(C) * P;
  const T* w0 = cx.wg;
  const T* w1 = w0 + 9L * C * C;
  const T* b0 = w1 + 9L * C * C;
  const T* b1 = b0 + C;
  const T* tm0 = b1 + C;
  const T* tm1 = tm0 + CP;
  const T* gs = tm1 + CP;
  const T* gb = gs + 3 * C;
  for (int k = 0; k < 2; ++k) {
    const T* Wt = k ? w1 : w0;
    // The previous conv's last barrier: nobody reads w_s any more. The
    // weights arrive while the first sample's GroupNorm runs.
    if (cx.w_s != nullptr) copy_in_async(cx.w_s, Wt, 9 * C * C);
    for (int s = 0; s < cx.n_own; ++s) {
      T* Z = cx.Zb + s * CP;
      if (k == 0) {
        for (int e = threadIdx.x; e < C * P; e += blockDim.x)
          cx.Hs[(e / P) * cx.PP + padded(e % P, cx.W)] = X[s * CP + e];
        __syncthreads();
        group_norm<T, true, true>(cx.Hs, cx.Hs, gs, gb, 0, sign, C, cx.G,
                                  cx.H, cx.W, cx.eps, cx.s_ch, cx.s_grp);
      } else {
        group_norm<T, false, true>(Z, cx.Hs, gs + C, gb + C, 0, sign, C,
                                   cx.G, cx.H, cx.W, cx.eps, cx.s_ch,
                                   cx.s_grp);
      }
      if (cx.w_s != nullptr && s == 0) {
        cp_async_wait_all();
        __syncthreads();
      }
      if (cx.w_s != nullptr)
        conv3x3<T, true>(cx.h_off, nullptr, cx.w_off, Z, k ? b1 : b0,
                         k ? tm1 : tm0, tval, C, P, cx.W, cx.PP);
      else
        conv3x3<T, false>(cx.h_off, Wt, 0, Z, k ? b1 : b0, k ? tm1 : tm0,
                          tval, C, P, cx.W, cx.PP);
    }
  }
  for (int s = 0; s < cx.n_own; ++s)
    group_norm<T, false, false>(cx.Zb + s * CP, out + s * CP, gs + 2 * C,
                                gb + 2 * C, 1, sign, C, cx.G, cx.H, cx.W,
                                cx.eps, cx.s_ch, cx.s_grp);
}

// Values of a shared-memory region of n values, rounded up to 16 bytes.
template <typename T>
__host__ __device__ inline long smem_align(long n) {
  constexpr long kV = 16 / long(sizeof(T));
  return (n + kV - 1) / kV * kV;
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads, 1)
    conv_solve_kernel(const T* __restrict__ tau, const T* __restrict__ y0g,
                      const T* __restrict__ f0g, const T* __restrict__ wg,
                      const T* __restrict__ dt0g, T* __restrict__ out,
                      int* __restrict__ stats, T* __restrict__ work,
                      unsigned char* __restrict__ gwork,
                      const int* __restrict__ ctab, Tableau<T> tab_in,
                      ConvScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Tableau<T> tab;
  __shared__ T merged[2];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  if (tid == 0) tab = tab_in;

  // The CTA's row of the grid table.
  const int* const row = ctab + kConvCtaInts * blockIdx.x;
  const int cblk = row[0], b_first = row[1], nb = row[2], rank = row[3];
  const int n_ctas = row[4], cta0 = row[5], meet = row[6];
  const int s_lo = b_first + int(long(rank) * nb / n_ctas);
  const int s_hi = b_first + int(long(rank + 1) * nb / n_ctas);

  const int C = sc.C, G = sc.G;
  const int P = sc.H * sc.W;
  const long CP = long(C) * P;
  ConvCtx<T> cx;
  cx.n_own = s_hi - s_lo;
  cx.C = C;
  cx.G = G;
  cx.H = sc.H;
  cx.W = sc.W;
  cx.P = P;
  cx.PW = sc.W + 2;
  cx.PP = (sc.H + 2) * cx.PW;
  cx.eps = sc.eps;
  cx.wg = wg;
  T* red = reinterpret_cast<T*>(smem_raw);                 // [nth]
  cx.s_ch = red + smem_align<T>(nth);                      // [2 C]
  cx.s_grp = cx.s_ch + smem_align<T>(2 * C);               // [2 G]
  cx.Hs = cx.s_grp + smem_align<T>(2 * G);                 // [C][PP]
  T* next = cx.Hs + smem_align<T>(long(C) * cx.PP);
  cx.w_s = sc.w_smem ? next : nullptr;                     // [9 C C]
  cx.h_off = int(cx.Hs - red);
  cx.w_off = int(next - red);
  if (sc.w_smem) next += smem_align<T>(9L * C * C);
  // The padded input's border stays zero.
  for (int i = tid; i < C * cx.PP; i += nth) cx.Hs[i] = T(0);

  const int S = tab_in.S;
  const long BN = long(sc.B) * CP;                  // one scratch buffer
  const long off = long(s_lo) * CP;                 // the CTA's samples
  T* Y = work + off;         // state
  T* F = Y + BN;             // derivative at (t, y): stage 0 (FSAL cache)
  T* Cm = F + BN;            // Kahan compensation
  T* DEL = Cm + BN;          // delta = y1 - y0 of the attempt
  T* MID = DEL + BN;         // dense-output midpoint of the attempt
  T* F1 = MID + BN;          // f(t1, y1) for tableaus that are not FSAL
  T* YS = F1 + BN;           // the stage's input state
  T* Zg = YS + BN;           // conv outputs where shared memory has no room
  T* K = Zg + BN;            // stages 1 .. S - 1
  cx.Zb = sc.z_smem ? next : Zg;

  const long N = long(cx.n_own) * CP;               // the CTA's elements
  const T T_den = T(double(nb) * double(CP));       // the block's elements
  const int T_out = sc.T_out;
  const T sign = sc.sign;
  unsigned long long* const count =
      reinterpret_cast<unsigned long long*>(gwork) + 2 * meet;
  T* const shares = reinterpret_cast<T*>(gwork + 16L * sc.n_meet);
  unsigned long long target = 0;
  int meeting = 0;

  // Deterministic output on early exit: zero fill, then y0 in row 0.
  for (long e = tid; e < N; e += nth) {
    out[off + e] = y0g[off + e];
    for (int o = 1; o < T_out; ++o) out[long(o) * BN + off + e] = T(0);
    Y[e] = y0g[off + e];
    F[e] = f0g[off + e];
    Cm[e] = T(0);
  }

  const T t_start = tau[0];
  const T t_end = tau[T_out - 1];
  T t = t_start;
  T dt = d_max(d_abs(dt0g[cblk]), sc.dt_min);
  int oi = 1, nfe = 0, nacc = 0, nrej = 0;
  // Non-monotonic times: status 3 (INVALID_TIMES), output zero beyond row 0.
  int status = (t_end > t_start && sc.valid) ? 0 : 3;
  __syncthreads();

  while (t < t_end && status == 0) {
    const T rem = t_end - t;
    const T dt_eff = d_min(dt, rem);
    const bool is_last = dt >= rem;
    const T t1 = is_last ? t_end : t + dt_eff;
    const T dth = t1 - t;

    // ---- stages: yi = y0 + sum_j (dt a_ij) k_j, then k_i = g(ti, yi).
    for (int i = 1; i < S; ++i) {
      for (long e = tid; e < N; e += nth) {
        T v = Y[e];
        for (int j = 0; j < i; ++j) {
          const T a = tab.a[i][j];
          if (a != T(0)) {
            const T kj = j == 0 ? F[e] : K[(j - 1) * BN + e];
            v = v + (dth * a) * kj;
          }
        }
        YS[e] = v;
      }
      __syncthreads();
      const T ti = t + tab.c[i] * dth;
      conv_rhs(cx, YS, K + (i - 1) * BN, sign * ti, sign);
    }

    // ---- solution, error and midpoint of each owned element.
    T ss = T(0);
    bool bad = false;
    for (long e = tid; e < N; e += nth) {
      const T y0 = Y[e];
      T delta = T(0), err = T(0), ymid = y0;
      bool first_d = true, first_e = true;
      for (int j = 0; j < S; ++j) {
        const T kj = j == 0 ? F[e] : K[(j - 1) * BN + e];
        if (tab.b_sol[j] != T(0)) {
          const T term = (dth * tab.b_sol[j]) * kj;
          delta = first_d ? term : delta + term;
          first_d = false;
        }
        if (tab.b_err[j] != T(0)) {
          const T term = (dth * tab.b_err[j]) * kj;
          err = first_e ? term : err + term;
          first_e = false;
        }
        if (tab.has_mid && tab.c_mid[j] != T(0))
          ymid = ymid + (dth * tab.c_mid[j]) * kj;
      }
      const T y1 = y0 + delta;
      const T scale = sc.atol + sc.rtol * d_max(d_abs(y0), d_abs(y1));
      const T esc = err / scale;
      ss = ss + esc * esc;
      bad = bad || !d_finite(y1);
      DEL[e] = delta;
      MID[e] = ymid;
      YS[e] = y1;
    }
    if (!tab.fsal) {
      // The end derivative costs one more evaluation (counted in evals).
      __syncthreads();
      conv_rhs(cx, YS, F1, sign * t1, sign);
    }

    // ---- the controller block's CTAs meet: each brings its share of the
    // error sum and its finiteness flag, every one adds them in CTA order.
    const bool cta_bad = __syncthreads_or(bad);
    const T share[2] = {block_sum(ss, red), cta_bad ? T(1) : T(0)};
    group_shares<T, 2>(count, target, meeting, shares, gridDim.x, cta0,
                       n_ctas, share, merged, red);
    const T total = merged[0];
    const bool any_bad = merged[1] != T(0);
    const T ratio = d_sqrt(total / T_den);
    const bool finite = d_finite(total) && !any_bad;
    const bool accept = (ratio <= T(1)) && finite;
    const T fac = controller_factor(ratio, finite, accept, sc.safety,
                                    sc.ifactor, sc.dfactor, tab.order);
    // Rescale the CLAMPED attempted step, as the generic engine does.
    const T dt_next = dth * fac;

    if (accept) {
      int oi_new = oi;
      while (oi_new < T_out && tau[oi_new] <= t1) ++oi_new;
      // ---- dense output, Kahan update, drain, FSAL.
      for (long e = tid; e < N; e += nth) {
        const T y0 = Y[e];
        const T delta = DEL[e];
        const T f0 = F[e];
        const T f1 = tab.fsal ? K[(S - 2) * BN + e] : F1[e];
        const T y1 = y0 + delta;
        const T df0 = dth * f0;
        const T df1 = dth * f1;
        // pallas_kernels.py:_interp_coeffs.
        const T r1 = y1 - y0 - df0;
        const T r2 = df1 - df0;
        T ca, cb, cc;
        if (tab.has_mid) {
          const T r3 = T(16) * (MID[e] - y0) - T(8) * df0;
          ca = r3 + T(2) * r2 - T(8) * r1;
          cb = r2 - T(2) * r1 - T(2) * ca;
          cc = r1 - ca - cb;
        } else {
          ca = T(0);
          cb = T(2) * (y0 - y1) + df0 + df1;
          cc = T(3) * (y1 - y0) - T(2) * df0 - df1;
        }
        // Kahan-compensated accumulation.
        const T comp = Cm[e];
        const T adj = delta - comp;
        const T y_new = y0 + adj;
        Cm[e] = (y_new - y0) - adj;
        Y[e] = y_new;
        F[e] = f1;
        // Every requested time in (t, t1], exactly y_new at t1.
        for (int o = oi; o < oi_new; ++o) {
          const T tj = tau[o];
          const T x = (tj - t) / dth;
          const T val = (((ca * x + cb) * x + cc) * x + df0) * x + y0;
          out[long(o) * BN + off + e] = (tj == t1) ? y_new : val;
        }
      }
      oi = oi_new;
    }
    __syncthreads();

    // Status rules of the kernel (pallas_kernels.py:896-902).
    const int n_att = nacc + nrej + 1;
    if (!accept && dt_next < sc.dt_min && status == 0) status = 2;
    if (n_att >= sc.max_steps && t1 < t_end && status == 0) status = 1;
    if (accept) t = t1;
    dt = dt_next;
    nfe += tab.evals;
    nacc += accept ? 1 : 0;
    nrej += accept ? 0 : 1;
  }
  if (rank == 0 && tid == 0) {
    stats[4 * cblk + 0] = nfe;
    stats[4 * cblk + 1] = nacc;
    stats[4 * cblk + 2] = nrej;
    stats[4 * cblk + 3] = status;
  }
}

// Shared memory of a CTA: the reduction, the GroupNorm statistics and the
// padded conv input (always), the applied conv's weights (w_smem), the
// conv outputs of n_max samples (z_smem); ops/cuda_conv.py _conv_smem
// repeats it.
template <typename T>
long conv_smem_bytes(int threads, int C, int G, int H, int W, int w_smem,
                     int z_smem, int n_max) {
  return long(sizeof(T)) *
         (smem_align<T>(threads) + smem_align<T>(2L * C) +
          smem_align<T>(2L * G) + smem_align<T>(long(C) * (H + 2) * (W + 2)) +
          (w_smem ? smem_align<T>(9L * C * C) : 0) +
          (z_smem ? long(n_max) * C * H * W : 0));
}

// Bytes of a launch's grid workspace: a 16-byte meeting counter a
// controller block, then the share buffers [2][n_cta][2].
inline long conv_grid_bytes(int n_meet, int n_cta, long item) {
  return 16L * n_meet + 4L * n_cta * item;
}

template <typename T>
int launch_conv_solve(const void* tau, const void* y0, const void* f0,
                      const void* weights, const void* dt0, void* out,
                      void* stats, void* work, void* gwork, long gwork_bytes,
                      const void* ctab, int n_cta, int n_meet, int n_max,
                      int T_out, int B, int C, int G, int H, int W,
                      int threads, int w_smem, int z_smem, double rtol,
                      double atol, double dt_min, double sign, double eps,
                      double safety, double ifactor, double dfactor,
                      int max_steps, int valid, int stages, int order,
                      int fsal, const double* c, const double* a,
                      const double* b_sol, const double* b_err,
                      const double* c_mid, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_out < 1 || B < 1 || C < 1 ||
      G < 1 || C % G || H < 1 || W < 1 || threads != kConvThreads ||
      n_cta < 1 || n_meet < 1 || n_meet > n_cta || n_max < 1 || !gwork ||
      gwork_bytes < conv_grid_bytes(n_meet, n_cta, sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tableau<T> tab =
      make_tableau<T>(stages, order, fsal, c, a, b_sol, b_err, c_mid);

  ConvScalars<T> sc;
  sc.rtol = T(rtol);
  sc.atol = T(atol);
  sc.dt_min = T(dt_min);
  sc.sign = T(sign);
  sc.eps = T(eps);
  sc.safety = T(safety);
  sc.ifactor = T(ifactor);
  sc.dfactor = T(dfactor);
  sc.max_steps = max_steps;
  sc.valid = valid;
  sc.T_out = T_out;
  sc.B = B;
  sc.C = C;
  sc.G = G;
  sc.H = H;
  sc.W = W;
  sc.w_smem = w_smem;
  sc.z_smem = z_smem;
  sc.n_meet = n_meet;

  const size_t smem = size_t(
      conv_smem_bytes<T>(threads, C, G, H, W, w_smem, z_smem, n_max));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Every controller block's meeting counter starts at zero.
  cudaError_t e = cudaMemsetAsync(gwork, 0, 16L * n_meet, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* a_tau = static_cast<const T*>(tau);
  const T* a_y0 = static_cast<const T*>(y0);
  const T* a_f0 = static_cast<const T*>(f0);
  const T* a_w = static_cast<const T*>(weights);
  const T* a_dt0 = static_cast<const T*>(dt0);
  T* a_out = static_cast<T*>(out);
  int* a_stats = static_cast<int*>(stats);
  T* a_work = static_cast<T*>(work);
  unsigned char* a_gwork = static_cast<unsigned char*>(gwork);
  const int* a_ctab = static_cast<const int*>(ctab);
  Tableau<T> a_tab = tab;
  ConvScalars<T> a_sc = sc;
  void* args[] = {&a_tau,  &a_y0,    &a_f0,   &a_w,    &a_dt0,
                  &a_out,  &a_stats, &a_work, &a_gwork, &a_ctab,
                  &a_tab,  &a_sc};
  return static_cast<int>(launch_grid(conv_solve_kernel<T>, n_cta, threads,
                                      smem, args, gwork, st));
}

}  // namespace tfd

#define TFD_CONV_SOLVE_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* weights, \
      const void* dt0, void* out, void* stats, void* work, void* gwork,     \
      long gwork_bytes, const void* ctab, int n_cta, int n_meet, int n_max, \
      int T_out, int B, int C, int G, int H, int W, int threads,            \
      int w_smem, int z_smem, double rtol, double atol, double dt_min,      \
      double sign, double eps, double safety, double ifactor,               \
      double dfactor, int max_steps, int valid, int stages, int order,      \
      int fsal, const double* c, const double* a, const double* b_sol,      \
      const double* b_err, const double* c_mid, void* stream) {            \
    return tfd::launch_conv_solve<TYPE>(                                     \
        tau, y0, f0, weights, dt0, out, stats, work, gwork, gwork_bytes,    \
        ctab, n_cta, n_meet, n_max, T_out, B, C, G, H, W, threads, w_smem,  \
        z_smem, rtol, atol, dt_min, sign, eps, safety, ifactor, dfactor,    \
        max_steps, valid, stages, order, fsal, c, a, b_sol, b_err, c_mid,   \
        stream);                                                             \
  }

TFD_CONV_SOLVE_ENTRY(tfd_conv_solve_f32, float)
TFD_CONV_SOLVE_ENTRY(tfd_conv_solve_f64, double)
