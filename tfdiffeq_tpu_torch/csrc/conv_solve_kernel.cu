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
// grid programs are; a block's accept needs only its own error sum, so ONE
// thread block runs one controller block and no grid-wide barrier exists.
// Every phase of an attempt (stage combine, each GroupNorm, each conv, the
// error sum, the drain) is a loop of the block's threads over the block's
// elements, closed by __syncthreads(). A sample's state is C * H * W values
// (12.5 KB in float32 at C = 64), so a block's state and stages do not fit
// in shared memory: they live in device scratch (`work`, (S + 8) buffers of
// b * C * H * W values a block, L2-resident at the ODE-Net's batches). The
// conv weights of the conv being applied sit in shared memory when they fit
// (float32 up to C = 64: 147 KB), else are read from device memory (float64).
// The conv runs on the CUDA cores in full precision, each output summing its
// taps in OFFSETS order and each tap input channel after input channel; a
// thread computes kCoTile output channels at one position, so one load of
// the input serves kCoTile products. GroupNorm sums each channel's
// positions in order, then each group's channels in order. The error sum
// is each thread's owned elements in order, then a fixed tree. Built with
// --fmad=false, the plain version in ops/cuda_conv.py repeats all of it
// operation for operation.
//
// Bound on the H100. Two convs of 2 C^2 9 H W flops a sample (7.2 MFLOP at
// C = 64, 7x7) an evaluation: compute-bound (a few MB move a solve). One SM
// runs a controller block, so at the ODE-Net's batch 128 only 8 of 132 SMs
// work; a cluster of SMs a controller block, and the tensor-core tiers,
// are later work (PERF.md, ROADMAP.md).
#include "mlp_rk.cuh"

namespace tfd {

// Threads of each thread block, a power of two (block_sum);
// ops/cuda_conv.py:CONV_THREADS.
constexpr int kConvThreads = 512;
// Output channels a thread computes at one position of the conv.
constexpr int kCoTile = 8;

template <typename T>
struct ConvScalars {
  T rtol, atol, dt_min, sign, eps, safety, ifactor, dfactor;
  int max_steps, valid, T_out, B, b_blk, C, G, H, W, w_smem;
};

// One controller block's view of the problem, the same in every thread.
template <typename T>
struct ConvCtx {
  int nb, C, G, H, W, P;
  long N;            // nb * C * P elements this block owns
  T eps;
  const T* wg;       // packed weights in device memory
  T* w_s;            // one conv's weights in shared memory, or null
  T* s_ch;           // [2][nb * C] channel sums, sums of squares
  T* s_grp;          // [2][nb * G] group means, inverse deviations
  T* Hb;             // GroupNorm output (scratch)
  T* Zb;             // conv output (scratch)
};

// GroupNorm of X [nb, C, P] into Y: mode 0 applies relu after it, mode 1
// multiplies it by `mult` (the time direction's sign).
template <typename T>
__device__ void group_norm(const ConvCtx<T>& cx, const T* X, T* Y,
                           const T* scale, const T* bias, int mode, T mult) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int C = cx.C, G = cx.G, P = cx.P, cg = C / G;
  const int nbC = cx.nb * C, nbG = cx.nb * G;
  for (int i = tid; i < nbC; i += nth) {
    const T* x = X + long(i) * P;
    T s1 = x[0];
    T s2 = x[0] * x[0];
    for (int p = 1; p < P; ++p) {
      s1 = s1 + x[p];
      s2 = s2 + x[p] * x[p];
    }
    cx.s_ch[i] = s1;
    cx.s_ch[nbC + i] = s2;
  }
  __syncthreads();
  const T cnt = T(cg * P);
  for (int i = tid; i < nbG; i += nth) {
    const int s = i / G, g = i % G;
    const T* c1 = cx.s_ch + s * C + g * cg;
    const T* c2 = c1 + nbC;
    T gs = c1[0], gq = c2[0];
    for (int k = 1; k < cg; ++k) {
      gs = gs + c1[k];
      gq = gq + c2[k];
    }
    const T mean = gs / cnt;
    T var = gq / cnt - mean * mean;
    var = var < T(0) ? T(0) : var;   // flax's clamp; NaN stays NaN
    cx.s_grp[i] = mean;
    cx.s_grp[nbG + i] = T(1) / d_sqrt(var + cx.eps);
  }
  __syncthreads();
  for (long e = tid; e < cx.N; e += nth) {
    const int sc = int(e / P);            // s * C + c
    const int c = sc % C;
    const int gi = (sc / C) * G + c / cg;
    T v = ((X[e] - cx.s_grp[gi]) * cx.s_grp[nbG + gi]) * scale[c] + bias[c];
    if (mode == 0) {
      v = v < T(0) ? T(0) : v;
    } else {
      v = mult * v;
    }
    Y[e] = v;
  }
  __syncthreads();
}

// The concat-t 3x3 SAME conv of Hin [nb, C, P] into Zout:
// out = (sum over valid taps of (sum over c_in of w * h) + bias) + tm * t.
// Wc: [tap][c_in][c_out] in device memory; copied to shared memory first
// when cx.w_s is set.
template <typename T>
__device__ void conv3x3(const ConvCtx<T>& cx, const T* Hin, T* Zout,
                        const T* Wc, const T* bias, const T* tm, T tval) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int C = cx.C, P = cx.P, H = cx.H, W = cx.W;
  const T* Wt = Wc;
  if (cx.w_s != nullptr) {
    for (int i = tid; i < 9 * C * C; i += nth) cx.w_s[i] = Wc[i];
    __syncthreads();
    Wt = cx.w_s;
  }
  const int n_ct = (C + kCoTile - 1) / kCoTile;
  const long items = long(cx.nb) * n_ct * P;
  for (long it = tid; it < items; it += nth) {
    const int p = int(it % P);
    const long r = it / P;
    const int co0 = int(r % n_ct) * kCoTile;
    const int s = int(r / n_ct);
    const int ntile = min(kCoTile, C - co0);
    const int i = p / W, j = p % W;
    const T* hs = Hin + long(s) * C * P;
    T acc[kCoTile];
    bool first = true;
    for (int tap = 0; tap < 9; ++tap) {
      const int ii = i + tap / 3 - 1, jj = j + tap % 3 - 1;
      // A tap outside the map adds an exact zero in the reference.
      if (ii < 0 || ii >= H || jj < 0 || jj >= W) continue;
      const int q = ii * W + jj;
      const T* wt = Wt + long(tap) * C * C + co0;
      T term[kCoTile];
      const T h0 = hs[q];
#pragma unroll
      for (int u = 0; u < kCoTile; ++u)
        term[u] = u < ntile ? wt[u] * h0 : T(0);
      for (int ci = 1; ci < C; ++ci) {
        const T hv = hs[long(ci) * P + q];
        const T* w = wt + long(ci) * C;
#pragma unroll
        for (int u = 0; u < kCoTile; ++u)
          if (u < ntile) term[u] = term[u] + w[u] * hv;
      }
#pragma unroll
      for (int u = 0; u < kCoTile; ++u)
        acc[u] = first ? term[u] : acc[u] + term[u];
      first = false;
    }
    // The centre tap is always valid, so every acc is set.
#pragma unroll
    for (int u = 0; u < kCoTile; ++u) {
      if (u < ntile) {
        const int co = co0 + u;
        Zout[(long(s) * C + co) * P + p] =
            (acc[u] + bias[co]) + tm[long(co) * P + p] * tval;
      }
    }
  }
  __syncthreads();
}

// out = sign * f(sign * s, X) of the whole field; tval = sign * s is the
// raw time the conv's time channel sees.
template <typename T>
__device__ void conv_rhs(const ConvCtx<T>& cx, const T* X, T* out, T tval,
                         T sign) {
  const int C = cx.C, P = cx.P;
  const T* w0 = cx.wg;
  const T* w1 = w0 + 9L * C * C;
  const T* b0 = w1 + 9L * C * C;
  const T* b1 = b0 + C;
  const T* tm0 = b1 + C;
  const T* tm1 = tm0 + long(C) * P;
  const T* gs = tm1 + long(C) * P;
  const T* gb = gs + 3 * C;
  group_norm(cx, X, cx.Hb, gs, gb, 0, sign);
  conv3x3(cx, cx.Hb, cx.Zb, w0, b0, tm0, tval);
  group_norm(cx, cx.Zb, cx.Hb, gs + C, gb + C, 0, sign);
  conv3x3(cx, cx.Hb, cx.Zb, w1, b1, tm1, tval);
  group_norm(cx, cx.Zb, out, gs + 2 * C, gb + 2 * C, 1, sign);
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads, 1)
    conv_solve_kernel(const T* __restrict__ tau, const T* __restrict__ y0g,
                      const T* __restrict__ f0g, const T* __restrict__ wg,
                      const T* __restrict__ dt0g, T* __restrict__ out,
                      int* __restrict__ stats, T* __restrict__ work,
                      Tableau<T> tab_in, ConvScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  if (tid == 0) tab = tab_in;

  const int blk = blockIdx.x;
  const int P = sc.H * sc.W;
  const long CP = long(sc.C) * P;
  const int b_first = blk * sc.b_blk;
  ConvCtx<T> cx;
  cx.nb = min(sc.b_blk, sc.B - b_first);
  cx.C = sc.C;
  cx.G = sc.G;
  cx.H = sc.H;
  cx.W = sc.W;
  cx.P = P;
  cx.N = long(cx.nb) * CP;
  cx.eps = sc.eps;
  cx.wg = wg;
  T* red = reinterpret_cast<T*>(smem_raw);          // [nth]
  cx.s_ch = red + nth;                              // [2 * b_blk * C]
  cx.s_grp = cx.s_ch + 2 * sc.b_blk * sc.C;         // [2 * b_blk * G]
  cx.w_s = sc.w_smem ? cx.s_grp + 2 * sc.b_blk * sc.G : nullptr;
  __syncthreads();

  const int S = tab.S;
  const long Nb = long(sc.b_blk) * CP;              // one scratch buffer
  T* base = work + long(blk) * (S + 8) * Nb;
  T* Y = base;               // state
  T* F = Y + Nb;             // derivative at (t, y): stage 0 (FSAL cache)
  T* Cm = F + Nb;            // Kahan compensation
  T* DEL = Cm + Nb;          // delta = y1 - y0 of the attempt
  T* MID = DEL + Nb;         // dense-output midpoint of the attempt
  T* F1 = MID + Nb;          // f(t1, y1) for tableaus that are not FSAL
  T* YS = F1 + Nb;           // the stage's input state
  cx.Hb = YS + Nb;
  cx.Zb = cx.Hb + Nb;
  T* K = cx.Zb + Nb;         // stages 1 .. S - 1

  const long N = cx.N;
  const long off = long(b_first) * CP;              // the block's samples
  const long BN = long(sc.B) * CP;                  // one output row
  const int T_out = sc.T_out;
  const T sign = sc.sign;

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
  const T denom = T(double(N));
  T t = t_start;
  T dt = d_max(d_abs(dt0g[blk]), sc.dt_min);
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
            const T kj = j == 0 ? F[e] : K[(j - 1) * Nb + e];
            v = v + (dth * a) * kj;
          }
        }
        YS[e] = v;
      }
      __syncthreads();
      const T ti = t + tab.c[i] * dth;
      conv_rhs(cx, YS, K + (i - 1) * Nb, sign * ti, sign);
    }

    // ---- solution, error and midpoint of each owned element.
    T ss = T(0);
    bool bad = false;
    for (long e = tid; e < N; e += nth) {
      const T y0 = Y[e];
      T delta = T(0), err = T(0), ymid = y0;
      bool first_d = true, first_e = true;
      for (int j = 0; j < S; ++j) {
        const T kj = j == 0 ? F[e] : K[(j - 1) * Nb + e];
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

    // ---- the block meets: error sum, finiteness, one shared decision.
    const bool any_bad = __syncthreads_or(bad);
    const T total = block_sum(ss, red);
    const T ratio = d_sqrt(total / denom);
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
        const T f1 = tab.fsal ? K[(S - 2) * Nb + e] : F1[e];
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
  if (tid == 0) {
    stats[4 * blk + 0] = nfe;
    stats[4 * blk + 1] = nacc;
    stats[4 * blk + 2] = nrej;
    stats[4 * blk + 3] = status;
  }
}

template <typename T>
int launch_conv_solve(const void* tau, const void* y0, const void* f0,
                      const void* weights, const void* dt0, void* out,
                      void* stats, void* work, int T_out, int B, int b_blk,
                      int C, int G, int H, int W, int threads, int w_smem,
                      double rtol, double atol, double dt_min, double sign,
                      double eps, double safety, double ifactor,
                      double dfactor, int max_steps, int valid, int stages,
                      int order, int fsal, const double* c, const double* a,
                      const double* b_sol, const double* b_err,
                      const double* c_mid, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_out < 1 || B < 1 ||
      b_blk < 1 || C < 1 || G < 1 || C % G || H < 1 || W < 1 ||
      threads < 32 || threads > kConvThreads || (threads & (threads - 1)))
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
  sc.b_blk = b_blk;
  sc.C = C;
  sc.G = G;
  sc.H = H;
  sc.W = W;
  sc.w_smem = w_smem;

  const int n_blocks = (B + b_blk - 1) / b_blk;
  const size_t smem =
      sizeof(T) * (size_t(threads) + 2 * size_t(b_blk) * (C + G) +
                   (w_smem ? 9 * size_t(C) * C : 0));
  auto kernel = conv_solve_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tau), static_cast<const T*>(y0),
      static_cast<const T*>(f0), static_cast<const T*>(weights),
      static_cast<const T*>(dt0), static_cast<T*>(out),
      static_cast<int*>(stats), static_cast<T*>(work), tab, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfd

#define TFD_CONV_SOLVE_ENTRY(NAME, TYPE)                                     \
  extern "C" int NAME(                                                       \
      const void* tau, const void* y0, const void* f0, const void* weights, \
      const void* dt0, void* out, void* stats, void* work, int T_out,       \
      int B, int b_blk, int C, int G, int H, int W, int threads,            \
      int w_smem, double rtol, double atol, double dt_min, double sign,     \
      double eps, double safety, double ifactor, double dfactor,            \
      int max_steps, int valid, int stages, int order, int fsal,            \
      const double* c, const double* a, const double* b_sol,                \
      const double* b_err, const double* c_mid, void* stream) {            \
    return tfd::launch_conv_solve<TYPE>(                                     \
        tau, y0, f0, weights, dt0, out, stats, work, T_out, B, b_blk, C, G, \
        H, W, threads, w_smem, rtol, atol, dt_min, sign, eps, safety,       \
        ifactor, dfactor, max_steps, valid, stages, order, fsal, c, a,      \
        b_sol, b_err, c_mid, stream);                                        \
  }

TFD_CONV_SOLVE_ENTRY(tfd_conv_solve_f32, float)
TFD_CONV_SOLVE_ENTRY(tfd_conv_solve_f64, double)
