// K3: the whole continuous-adjoint backward sweep of an MLP neural ODE in
// one launch, under one step controller shared by the batch.
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_adjoint.py:430
// (_make_adjoint_kernel, RHS _make_aug_eval :107; launched by
// mlp_adjoint_solve :1050). In sigma = -tau, which increases on every
// backward interval, it integrates the augmented system
//
//     dy/dsigma   = -sign f(y),     da_y/dsigma = sign (df/dy)^T a_y,
//     da_w/dsigma = sign (df/dw)^T a_y (batch-summed),
//     da_t/dsigma = sign a_y . df/dt (batch-summed; time_input only),
//
// over the observation intervals in reverse: y is reset to the stored
// forward state ys[i] and g[i] is added into a_y at each interval start,
// every attempt takes all S stages of the tableau (the MLP forward and its
// hand-written VJP in each), the error norm covers (y, a_y) and, unless
// `seminorm`, the parameter and a_t quadratures; the clamped I-controller,
// Kahan accumulation of y and a_y, the counters and the status follow the
// reference (:498-676). ay0 = a_y + g[0] at the end. The tableau comes in
// as launch arguments, so one binary serves the five adaptive methods.
//
// Design. One thread block for the whole sweep, as K2: thread tid owns the
// samples b = tid, tid + blockDim.x, ... and walks each one's stage state,
// MLP forward and VJP alone; the per-sample stage data live in a device
// workspace (`work`), the weights, the parameter accumulator and every
// stage's parameter cotangent in shared memory ((S + 3) n_w values; the
// b_sol and b_err combines need all S stages at once). Unlike K2, the
// batch meets at every STAGE, not only at every attempt: each stage's
// parameter cotangent is a sum over the whole batch
// (pallas_adjoint.py:196-201, :503-509). The per-sample layer inputs,
// activation derivatives and pre-activation cotangents go to the
// workspace feature-major ([row][B], so a warp reads 32 consecutive
// samples), and then each warp takes whole reductions: lane j adds samples
// j, j + 32, j + 64, ... in order (loading 8 ahead) and the 32 lane sums
// meet in a fixed shuffle tree. Every batch sum
// (parameter cotangents, a_t, the error) is taken in one fixed order that
// the plain version in ops/cuda_adjoint.py repeats, with no atomics: the
// same bits on every run, and float64 sweeps that take the plain version's
// exact steps.
//
// Bound on the H100. One SM of 132 does all the work. Per stage, each of
// the 512 threads walks the MLP forward and VJP of B / 512 samples (about
// 800 flops a sample at the spiral, its vectors in local memory), then each
// warp reads two values and adds once per (parameter, sample) pair of its
// share of the batch sums (252 x 4096 pairs at the spiral), with 2 block
// barriers a stage: both bound by one SM's instruction throughput and
// memory latency. Loading 8 samples ahead in the batch sums took the
// spiral training sweep on an H100 from 1053 to 816 ms (0.53 ms a stage,
// PERF.md), so most of the rest is likely the per-sample pass. Spreading the batch over the card
// (one block per SM, a grid-wide barrier per stage, per-block partial sums
// merged in a fixed order) is the follow-up, the same as K2's.
//
// Routes (mlp_rk.cuh Route): narrow as above; wide, for layers up to
// kMaxWidth or weights past shared memory, the per-thread vectors of 512
// values in local memory and the weights, the parameter accumulator, its
// increment and the stage cotangents in global memory (`pwork`, L2-resident:
// 3.7 MB at the wide MLP 128 -> 256 -> 256 -> 128 with dopri5). The sums
// keep their order, so both routes give the same bits.
//
// rhs = cnf (K7's adjoint, csrc/cnf_net.cuh, replacing pallas_adjoint.py:240
// _make_cnf_aug_eval at :1088-1131): the sweep of the augmented FFJORD
// system, the state [z; logp] of D + 1 values and the network the concat-t
// flow (time_input forced). Phase A runs cnf_aug_eval for each owned
// sample, which writes the sample's rows of the layers' inputs, act',
// act'', the passes' v, u and vb, part A's cotangents and the deltas; phase
// B takes each weight's batch sum of cnf_weight_x, the sample's cotangent
// in one fixed order (2 D + 4 workspace reads a sample), in K3's lane and
// tree order, without atomics, as the plain version repeats.
#include "cnf_net.cuh"

namespace tfd {

// Most threads of the one block; the launch takes a power of two from 32
// up to it (block_sum, whole warps), ops/cuda_adjoint.py:ADJOINT_THREADS.
constexpr int kAdjThreads = 512;
constexpr int kWarp = 32;

template <typename T>
struct AdjScalars {
  T dt0, rtol, atol, dt_min, sign, safety, ifactor, dfactor;
  int max_steps, T_obs, B, D, seminorm;
};

// Workspace rows of the per-stage batch reductions: layer l's inputs start
// at row h_off[l] of H, its activation derivatives act'(z) and the
// cotangents of its pre-activations at row z_off[l] of G and DZ; each row
// holds B samples.
struct Rows {
  int h_off[kMaxLayers];
  int z_off[kMaxLayers];
};

// Sum of v over the 32 lanes of a warp in the tree order of
// ops/cuda_kernels.py:_tree_sum; lane 0 returns the sum.
template <typename T>
__device__ __forceinline__ T warp_tree_sum(T v) {
  for (int s = kWarp / 2; s > 0; s >>= 1)
    v = v + __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// Batch samples a lane loads before it adds them: the adds stay in sample
// order, the loads overlap (one at a time would leave the warp waiting on
// memory latency for every sample).
constexpr int kUnroll = 8;

// The batch sum of x(b) = xa[b] * xb[b] (kProduct) or xa[b], in K3's
// order: lane j adds samples j, j + 32, ... in turn from 0 (a sample past
// B adds +0, which changes no bit), then the warp's shuffle tree. Lane 0
// returns the sum.
template <typename T, bool kProduct>
__device__ __forceinline__ T batch_sum(const T* __restrict__ xa,
                                       const T* __restrict__ xb, int B,
                                       int lane) {
  T acc = T(0);
  for (int b0 = lane; b0 < B; b0 += kUnroll * kWarp) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * kWarp;
      v[u] = b < B ? (kProduct ? xa[b] * xb[b] : xa[b]) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = acc + v[u];
  }
  return warp_tree_sum(acc);
}

// The same order for x(b) given by a function of the sample.
template <typename T, typename Fn>
__device__ __forceinline__ T batch_sum_of(Fn x, int B, int lane) {
  T acc = T(0);
  for (int b0 = lane; b0 < B; b0 += kUnroll * kWarp) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int b = b0 + u * kWarp;
      v[u] = b < B ? x(b) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = acc + v[u];
  }
  return warp_tree_sum(acc);
}

template <typename T, int kRoute, bool kCnf>
__global__ void __launch_bounds__(kAdjThreads, 1)
    mlp_adjoint_kernel(const T* __restrict__ tau, const T* __restrict__ ys,
                       const T* __restrict__ g, const T* __restrict__ wg,
                       T* __restrict__ ay0_out, T* __restrict__ aw_out,
                       T* __restrict__ at_out, int* __restrict__ stats,
                       T* __restrict__ work, T* __restrict__ pwork,
                       int n_weights, Net net_in, Rows rows_in, CnfRows cr,
                       Tableau<T> tab_in, AdjScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Net net;
  __shared__ Rows rows;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int n_warps = nth / kWarp;
  if (tid == 0) {
    net = net_in;
    rows = rows_in;
    tab = tab_in;
  }
  const int n_w = n_weights;
  const int ti = net_in.time_input;
  const int n_red = n_w + ti;               // reductions per stage
  const int S = tab_in.S;
  const T* w;   // [n_w] weights
  T* AW;        // [n_w] parameter quadrature
  T* DW;        // [n_w] its attempt increment
  T* KW;        // [S][n_red] stage cotangents
  T* red;       // [nth] block_sum scratch
  if constexpr (kRoute == kRouteNarrow) {
    T* ws = reinterpret_cast<T*>(smem_raw);
    AW = ws + n_w;
    DW = AW + n_w;
    KW = DW + n_w;
    red = KW + S * n_red;
    for (int i = tid; i < n_w; i += nth) ws[i] = wg[i];
    w = ws;
  } else {
    w = wg;
    AW = pwork;
    DW = AW + n_w;
    KW = DW + n_w;
    red = reinterpret_cast<T*>(smem_raw);
  }
  for (int i = tid; i < n_w; i += nth) AW[i] = T(0);
  __syncthreads();

  const int T_obs = sc.T_obs, B = sc.B, D = sc.D, L = net.n_layers;
  const long BD = long(B) * D;
  T* Y = work;              // y
  T* AY = Y + BD;           // a_y
  T* CY = AY + BD;          // Kahan compensation of y
  T* CAY = CY + BD;         // ... and of a_y
  T* DY = CAY + BD;         // the attempt's increments
  T* DAY = DY + BD;
  T* KY = DAY + BD;         // [S][B][D] stage derivatives of y
  T* KAY = KY + S * BD;     // [S][B][D] ... and of a_y
  int n_h = 0, n_z = 0;
  for (int l = 0; l < L; ++l) {
    n_h += net.din[l];
    n_z += net.dout[l];
  }
  // The per-stage rows do not overlap: restrict lets loads pass stores.
  T* __restrict__ H = KAY + S * BD;        // [rows][B] layer inputs
  T* __restrict__ G = H + long(n_h) * B;   // [rows][B] act'(z)
  T* __restrict__ DZ = G + long(n_z) * B;  // [rows][B] cotangents of z
  T* __restrict__ VT =                     // [B] a_y . df/dt
      kCnf ? H + long(cr.vt) * B : DZ + long(n_z) * B;

  // Per-thread vectors of one sample (local memory).
  constexpr int kW = vec_width<kRoute>();
  T ya[kW], aya[kW], buf_a[kW], buf_b[kW];
  const T sf = sc.sign;
  const T denom = sc.seminorm
      ? T(2.0 * double(D) * double(B))
      : T(2.0 * double(D) * double(B) + double(n_w) + double(ti));

  for (int b = tid; b < B; b += nth)
    for (int d = 0; d < D; ++d) AY[long(b) * D + d] = T(0);

  T dt = sc.dt0, at = T(0);
  int nfe = 0, nacc = 0, nrej = 0, status = 0;

  for (int i = T_obs - 1; i >= 1; --i) {
    // Reset y to the stored forward state; inject the cotangent.
    for (int b = tid; b < B; b += nth) {
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
        // ---- phase A: each owned sample's stage state, MLP forward and
        // VJP (pallas_adjoint.py:_make_aug_eval).
        const T t_user = (-sf) * (s + tab.c[st] * dth);
        for (int b = tid; b < B; b += nth) {
          const long base = long(b) * D;
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
          if constexpr (kCnf) {
            cnf_aug_eval(net, cr, w, t_user, ya, aya, buf_a, buf_b, H, B, b,
                         KY + st * BD + base, KAY + st * BD + base, sf);
            continue;
          }
          // Forward, keeping each layer's input and act'(z) (the VJP
          // needs nothing else of z).
          T* hin = buf_a;
          T* hout = buf_b;
          for (int d = 0; d < D; ++d) {
            T h = ya[d];
            for (int p = 1; p < net.input_power; ++p) h = h * ya[d];
            hin[d] = h;
          }
          if (ti) hin[D] = t_user;
          for (int l = 0; l < L; ++l) {
            const int din = net.din[l], dout = net.dout[l];
            const T* W = w + net.w_off[l];
            const T* bias = w + net.b_off[l];
            const int code = (l == L - 1) ? net.act_final : net.act_hidden;
            for (int k = 0; k < din; ++k)
              H[long(rows.h_off[l] + k) * B + b] = hin[k];
            for (int o = 0; o < dout; ++o) {
              const T* row = W + o * din;
              T acc = row[0] * hin[0];
              for (int k = 1; k < din; ++k) acc = acc + row[k] * hin[k];
              const T z = acc + bias[o];
              const T a = activate(code, z);
              G[long(rows.z_off[l] + o) * B + b] = act_grad(code, z, a);
              hout[o] = a;
            }
            T* tmp = hin;
            hin = hout;
            hout = tmp;
          }
          // hin holds f. Backward: dz of the last layer into hout.
          for (int d = 0; d < D; ++d) {
            KY[st * BD + base + d] = (-sf) * hin[d];
            const T dz = aya[d] * G[long(rows.z_off[L - 1] + d) * B + b];
            hout[d] = dz;
            DZ[long(rows.z_off[L - 1] + d) * B + b] = dz;
          }
          T* dz = hout;
          T* dh = hin;
          for (int l = L - 1; l >= 0; --l) {
            const int din = net.din[l], dout = net.dout[l];
            const T* W = w + net.w_off[l];
            for (int k = 0; k < din; ++k) {
              T acc = W[k] * dz[0];
              for (int o = 1; o < dout; ++o)
                acc = acc + W[o * din + k] * dz[o];
              if (l > 0) {
                acc = acc * G[long(rows.z_off[l - 1] + k) * B + b];
                DZ[long(rows.z_off[l - 1] + k) * B + b] = acc;
              }
              dh[k] = acc;
            }
            T* tmp = dz;
            dz = dh;
            dh = tmp;
          }
          // dz now holds the layer-0 input cotangent: v_y, then v_t.
          for (int d = 0; d < D; ++d) {
            T vy = dz[d];
            if (net.input_power > 1) {
              T yp = ya[d];
              for (int p = 2; p < net.input_power; ++p) yp = yp * ya[d];
              vy = vy * (T(net.input_power) * yp);
            }
            KAY[st * BD + base + d] = sf * vy;
          }
          if (ti) VT[b] = dz[D];
        }
        __syncthreads();

        // ---- phase B: the stage's batch sums, one reduction per warp at a
        // time: KW[st][r] = sign * sum_b x_r(b).
        for (int r = warp; r < n_red; r += n_warps) {
          T acc;
          if (r >= n_w) {
            acc = batch_sum<T, false>(VT, nullptr, B, lane);
          } else if constexpr (kCnf) {
            int l = 0;
            while (l + 1 < L && r >= net.w_off[l + 1]) ++l;
            const bool weight = r < net.b_off[l];
            const int idx = weight ? r - net.w_off[l] : r - net.b_off[l];
            const int o = weight ? idx / net.din[l] : idx;
            const int k = weight ? idx % net.din[l] : -1;
            acc = batch_sum_of<T>(
                [&](int b) {
                  return cnf_weight_x<T>(net, cr, H, l, o, k, B, b);
                },
                B, lane);
          } else {
            int l = 0;
            while (l + 1 < L && r >= net.w_off[l + 1]) ++l;
            if (r < net.b_off[l]) {
              const int idx = r - net.w_off[l];
              const int o = idx / net.din[l], k = idx % net.din[l];
              acc = batch_sum<T, true>(H + long(rows.h_off[l] + k) * B,
                                       DZ + long(rows.z_off[l] + o) * B, B,
                                       lane);
            } else {
              acc = batch_sum<T, false>(
                  DZ + long(rows.z_off[l] + r - net.b_off[l]) * B, nullptr,
                  B, lane);
            }
          }
          if (lane == 0) KW[st * n_red + r] = sf * acc;
        }
        __syncthreads();
      }

      // ---- combine: increments, errors and finiteness of owned samples,
      // then of owned parameters (pallas_adjoint.py:578-621).
      T ss = T(0);
      bool bad = false;
      for (int b = tid; b < B; b += nth) {
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
      }
      for (int p = tid; p < n_w; p += nth) {
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
      // The a_t quadrature, the same in every thread.
      T d_at = T(0), e_at = T(0);
      if (ti) {
        bool first_d = true, first_e = true;
        for (int j = 0; j < S; ++j) {
          const T kj = KW[j * n_red + n_w];
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

      // ---- the batch meets: one shared decision.
      const bool any_bad = __syncthreads_or(bad);
      T total = block_sum(ss, red);
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
        for (int b = tid; b < B; b += nth) {
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
        }
        for (int p = tid; p < n_w; p += nth) AW[p] = AW[p] + DW[p];
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

  for (int b = tid; b < B; b += nth) {
    for (int d = 0; d < D; ++d) {
      const long k = long(b) * D + d;
      ay0_out[k] = AY[k] + g[k];
    }
  }
  for (int p = tid; p < n_w; p += nth) aw_out[p] = AW[p];
  if (tid == 0) {
    at_out[0] = at;
    stats[0] = nfe;
    stats[1] = nacc;
    stats[2] = nrej;
    stats[3] = status;
  }
}

// Workspace values the sweep needs; ops/cuda_adjoint.py:_work_size
// allocates the same count.
inline long adjoint_work_size(const Net& net, int S, int B, int D) {
  long rows = 1;   // VT
  for (int l = 0; l < net.n_layers; ++l)
    rows += net.din[l] + 2 * net.dout[l];
  return (6 + 2 * long(S)) * B * D + rows * B;
}

// Global values of the wide route's pwork: the parameter accumulator, its
// increment and the stage cotangents (ops/cuda_adjoint.py:_wide_work_size).
inline long adjoint_pwork_size(int n_w, int S, int ti) {
  return 2 * long(n_w) + long(S) * (n_w + ti);
}

template <typename T, int kRoute, bool kCnf>
cudaError_t launch_adjoint_route(const void* tau, const void* ys,
                                 const void* g, const void* weights,
                                 void* ay0, void* aw, void* at, void* stats,
                                 void* work, void* pwork, int n_w,
                                 int threads, const Net& net,
                                 const Rows& rows, const CnfRows& cr,
                                 const Tableau<T>& tab,
                                 const AdjScalars<T>& sc,
                                 cudaStream_t stream) {
  const int S = tab.S, ti = net.time_input;
  const size_t smem =
      sizeof(T) * ((kRoute == kRouteNarrow
                        ? size_t(3 + S) * n_w + size_t(S) * ti
                        : 0) +
                   threads);
  auto kernel = mlp_adjoint_kernel<T, kRoute, kCnf>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<1, threads, smem, stream>>>(
      static_cast<const T*>(tau), static_cast<const T*>(ys),
      static_cast<const T*>(g), static_cast<const T*>(weights),
      static_cast<T*>(ay0), static_cast<T*>(aw), static_cast<T*>(at),
      static_cast<int*>(stats), static_cast<T*>(work),
      static_cast<T*>(pwork), n_w, net, rows, cr, tab, sc);
  return cudaGetLastError();
}

template <typename T>
int launch_adjoint(const void* tau, const void* ys, const void* g,
                   const void* weights, void* ay0, void* aw, void* at,
                   void* stats, void* work, long work_size, int T_obs, int B,
                   int D, int threads, double dt0, double rtol, double atol,
                   double dt_min, double sign, double safety, double ifactor,
                   double dfactor, int max_steps, int seminorm, int n_layers,
                   const int* dims, int act_hidden, int act_final,
                   int input_power, int time_input, int stages, int order,
                   const double* c, const double* a, const double* b_sol,
                   const double* b_err, int route, void* pwork,
                   long pwork_size, int cnf, void* stream) {
  if (stages < 2 || stages > kMaxStages || T_obs < 1 || B < 1 || D < 1 ||
      D + time_input > kMaxWidth || input_power < 1 || threads < kWarp ||
      threads > kAdjThreads || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The CNF flow maps the D - 1 features of z and the time to D - 1.
  if (cnf && (D < 2 || !time_input || input_power != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int n_w = make_net(net, n_layers, dims, cnf ? D - 1 : D, act_hidden,
                           act_final, input_power, time_input);
  if (n_w < 0 || !route_fits(net, route))
    return static_cast<int>(cudaErrorInvalidValue);
  const long need =
      cnf ? (6 + 2 * long(stages)) * B * D + cnf_rows_count(net) * B
          : adjoint_work_size(net, stages, B, D);
  if (work_size < need) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWide &&
      (!pwork || pwork_size < adjoint_pwork_size(n_w, stages, time_input)))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows rows;
  int h = 0, z = 0;
  for (int l = 0; l < n_layers; ++l) {
    rows.h_off[l] = h;
    rows.z_off[l] = z;
    h += net.din[l];
    z += net.dout[l];
  }
  const Tableau<T> tab = make_tableau<T>(stages, order, 0, c, a, b_sol,
                                         b_err, nullptr);
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

  const CnfRows cr = cnf ? make_cnf_rows(net) : CnfRows{};

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cnf)
    e = route == kRouteNarrow
            ? launch_adjoint_route<T, kRouteNarrow, true>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st)
            : launch_adjoint_route<T, kRouteWide, true>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st);
  else
    e = route == kRouteNarrow
            ? launch_adjoint_route<T, kRouteNarrow, false>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st)
            : launch_adjoint_route<T, kRouteWide, false>(
                  tau, ys, g, weights, ay0, aw, at, stats, work, pwork, n_w,
                  threads, net, rows, cr, tab, sc, st);
  return static_cast<int>(e);
}

}  // namespace tfd

#define TFD_ADJOINT_ENTRY(NAME, TYPE)                                        \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* weights,  \
      void* ay0, void* aw, void* at, void* stats, void* work,               \
      long work_size, int T_obs, int B, int D, int threads, double dt0,     \
      double rtol, double atol, double dt_min, double sign, double safety,  \
      double ifactor, double dfactor, int max_steps, int seminorm,          \
      int n_layers, const int* dims, int act_hidden, int act_final,         \
      int input_power, int time_input, int stages, int order,               \
      const double* c, const double* a, const double* b_sol,                \
      const double* b_err, int route, void* pwork, long pwork_size,         \
      int cnf, void* stream) {                                               \
    return tfd::launch_adjoint<TYPE>(                                        \
        tau, ys, g, weights, ay0, aw, at, stats, work, work_size, T_obs, B, \
        D, threads, dt0, rtol, atol, dt_min, sign, safety, ifactor,         \
        dfactor, max_steps, seminorm, n_layers, dims, act_hidden,           \
        act_final, input_power, time_input, stages, order, c, a, b_sol,     \
        b_err, route, pwork, pwork_size, cnf, stream);                       \
  }

TFD_ADJOINT_ENTRY(tfd_mlp_adjoint_f32, float)
TFD_ADJOINT_ENTRY(tfd_mlp_adjoint_f64, double)
