// K9: the whole fixed-grid continuous-adjoint backward sweep of an MLP
// neural ODE (euler, midpoint, rk4, rk4_38).
//
// Replaces the TPU kernel tfdiffeq_tpu/ops/pallas_fixed.py:726
// (_make_fixed_adjoint_kernel, RHS pallas_adjoint.py:_make_aug_eval :107;
// launched by _fixed_adjoint_call :863 from mlp_adjoint_solve_fixed :938).
// In sigma = -tau it integrates, with n_sub equal steps per observation
// interval, the augmented system
//
//     dy/dsigma   = -sign f(y),     da_y/dsigma = sign (df/dy)^T a_y,
//     da_w/dsigma = sign (df/dw)^T a_y (batch-summed),
//     da_t/dsigma = sign a_y . df/dt (batch-summed; time_input only),
//
// over the intervals in reverse: y is reset to the stored forward state
// ys[i] and g[i] is added into a_y at each interval start; every step takes
// all stages of the tableau (the MLP forward and its hand-written VJP in
// each) and updates y and a_y Kahan-compensated. ay0 = a_y + g[0] at the
// end; stats are nfe = stages n_sub (T - 1), steps = n_sub (T - 1), 0, 0.
//
// Design. Nothing in a fixed step reads the parameter or a_t quadratures,
// so the batch never has to meet during the sweep. One thread owns one
// sample for the whole sweep, over as many blocks as the batch needs, with
// no barrier until the end. Each sample accumulates its own share of the
// quadratures: per step, sum_j (h b_j) (sign x_j) over the stages in
// order (the stage combine of the reference), then added to its running
// sum. The batch sums come once, at the end, in one fixed order with no
// atomics: within a block a shared-memory tree over its threads
// (mlp_rk.cuh block_sum), across blocks a second, small launch that adds
// the block sums in block order. ops/cuda_fixed.py:
// mlp_adjoint_solve_fixed_plain repeats that order, so the two agree to
// roundoff in float64, and every run gives the same bits.
//
// The per-sample quadrature (n_w + time_input values: 252 at the spiral,
// 604 at the latent ODE) is too large for registers and has no static
// bound, so it lives in the device workspace with the rest of the sample's
// state, feature-major ([row][B]: a warp touches 32 consecutive values):
// y, a_y, their compensations and stage derivatives, each layer's inputs
// and act'(z), and the step's and the running quadrature sums. The weights
// sit in shared memory; the layer vectors in per-thread local memory.
//
// Bound on the H100. Per stage, each thread walks its sample's MLP forward
// and VJP (about 800 flops at the spiral) and reads and writes its 2 n_w
// quadrature values (the step sum, then once a step the running sum): at
// the spiral, 4096 x 252 values a stage, L2-resident. With one sample a
// thread there are only 128 warps at B = 4096, so the sweep is bound by
// the latency of each thread's dependent chain and of its workspace
// accesses, not by the card's arithmetic or bandwidth. Several samples a
// thread, or a warp across a sample's hidden units, is the way to more
// throughput.
#include "mlp_rk.cuh"

namespace tfd {

template <typename T>
struct FixedAdjScalars {
  T sign;
  int T_obs, B, D, n_sub;
};

// Workspace row offsets of each layer's inputs (H) and act'(z) (G).
struct FixedRows {
  int h_off[kMaxLayers];
  int z_off[kMaxLayers];
};

template <typename T>
__global__ void mlp_adjoint_fixed_kernel(
    const T* __restrict__ tau, const T* __restrict__ ys,
    const T* __restrict__ g, const T* __restrict__ wg,
    T* __restrict__ ay0_out, T* __restrict__ partial, T* __restrict__ work,
    int n_weights, Net net_in, FixedRows rows_in, Tableau<T> tab_in,
    FixedAdjScalars<T> sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Net net;
  __shared__ FixedRows rows;
  __shared__ Tableau<T> tab;
  const int tid = threadIdx.x;
  if (tid == 0) {
    net = net_in;
    rows = rows_in;
    tab = tab_in;
  }
  const int n_w = n_weights;
  T* w = reinterpret_cast<T*>(smem_raw);  // [n_w] weights
  T* red = w + n_w;                       // [blockDim.x] block_sum scratch
  for (int i = tid; i < n_w; i += blockDim.x) w[i] = wg[i];
  __syncthreads();

  const int T_obs = sc.T_obs, B = sc.B, D = sc.D, n_sub = sc.n_sub;
  const int L = net.n_layers, S = tab.S, ti = net.time_input;
  const int R = n_w + ti;                 // quadrature values a sample
  const long BD = long(B) * D;
  int n_h = 0, n_z = 0;
  for (int l = 0; l < L; ++l) {
    n_h += net.din[l];
    n_z += net.dout[l];
  }
  // Feature-major workspace rows of B values each.
  T* Y = work;                      // [D] y
  T* AY = Y + BD;                   // [D] a_y
  T* CY = AY + BD;                  // [D] Kahan compensation of y
  T* CAY = CY + BD;                 // [D] ... and of a_y
  T* KY = CAY + BD;                 // [S][D] stage derivatives of y
  T* KAY = KY + S * BD;             // [S][D] ... and of a_y
  T* H = KAY + S * BD;              // [n_h] each layer's inputs
  T* G = H + long(n_h) * B;         // [n_z] act'(z) of each layer
  T* STEP = G + long(n_z) * B;      // [R] this step's quadrature
  T* ACC = STEP + long(R) * B;      // [R] the running quadrature

  const int b = blockIdx.x * blockDim.x + tid;
  const bool mine = b < B;          // idle threads still meet at the end
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  T ya[kMaxWidth], aya[kMaxWidth], buf_a[kMaxWidth], buf_b[kMaxWidth];
  const T sf = sc.sign;
  int first_b = 0;                  // first stage with a nonzero weight
  while (tab.b_sol[first_b] == T(0)) ++first_b;

  if (mine) {
    for (int d = 0; d < D; ++d) AY[at(d)] = T(0);
    for (int r = 0; r < R; ++r) ACC[at(r)] = T(0);
  }
  for (int i = T_obs - 1; mine && i >= 1; --i) {
    // Reset y to the stored forward state; inject the cotangent.
    for (int d = 0; d < D; ++d) {
      const long k = long(i) * BD + long(b) * D + d;
      Y[at(d)] = ys[k];
      AY[at(d)] = AY[at(d)] + g[k];
      CY[at(d)] = T(0);
      CAY[at(d)] = T(0);
    }
    const T s_start = -tau[i];
    const T h = (-tau[i - 1] - s_start) / T(n_sub);
    for (int j = 0; j < n_sub; ++j) {
      const T s = s_start + h * T(j);
      for (int st = 0; st < S; ++st) {
        // The stage state: yi = yi + (h * a_ij) * k_j.
        for (int d = 0; d < D; ++d) {
          T yv = Y[at(d)], av = AY[at(d)];
          for (int q = 0; q < st; ++q) {
            const T a = tab.a[st][q];
            if (a != T(0)) {
              yv = yv + (h * a) * KY[at(q * D + d)];
              av = av + (h * a) * KAY[at(q * D + d)];
            }
          }
          ya[d] = yv;
          aya[d] = av;
        }
        // Forward (pallas_adjoint.py:_make_aug_eval), keeping each
        // layer's input and act'(z).
        T* hin = buf_a;
        T* hout = buf_b;
        for (int d = 0; d < D; ++d) {
          T v = ya[d];
          for (int p = 1; p < net.input_power; ++p) v = v * ya[d];
          hin[d] = v;
        }
        if (ti) hin[D] = (-sf) * (s + tab.c[st] * h);
        for (int l = 0; l < L; ++l) {
          const int din = net.din[l], dout = net.dout[l];
          const T* W = w + net.w_off[l];
          const T* bias = w + net.b_off[l];
          const int code = (l == L - 1) ? net.act_final : net.act_hidden;
          for (int k = 0; k < din; ++k) H[at(rows.h_off[l] + k)] = hin[k];
          for (int o = 0; o < dout; ++o) {
            const T* row = W + o * din;
            T acc = row[0] * hin[0];
            for (int k = 1; k < din; ++k) acc = acc + row[k] * hin[k];
            const T z = acc + bias[o];
            const T a = activate(code, z);
            G[at(rows.z_off[l] + o)] = act_grad(code, z, a);
            hout[o] = a;
          }
          T* tmp = hin;
          hin = hout;
          hout = tmp;
        }
        // hin holds f. Backward: the last layer's dz into hout.
        for (int d = 0; d < D; ++d) {
          KY[at(st * D + d)] = (-sf) * hin[d];
          hout[d] = aya[d] * G[at(rows.z_off[L - 1] + d)];
        }
        // This stage's weighted quadrature term, (h b_st) (sign x), joins
        // the step's sum in stage order.
        const T hb = h * tab.b_sol[st];
        const bool add = tab.b_sol[st] != T(0);
        const bool first = st == first_b;
        auto quad = [&](int r, T x) {
          const T term = hb * (sf * x);
          STEP[at(r)] = first ? term : STEP[at(r)] + term;
        };
        T* dz = hout;
        T* dh = hin;
        for (int l = L - 1; l >= 0; --l) {
          const int din = net.din[l], dout = net.dout[l];
          const T* W = w + net.w_off[l];
          if (add) {
            for (int o = 0; o < dout; ++o) {
              for (int k = 0; k < din; ++k)
                quad(net.w_off[l] + o * din + k,
                     dz[o] * H[at(rows.h_off[l] + k)]);
              quad(net.b_off[l] + o, dz[o]);
            }
          }
          for (int k = 0; k < din; ++k) {
            T acc = W[k] * dz[0];
            for (int o = 1; o < dout; ++o) acc = acc + W[o * din + k] * dz[o];
            if (l > 0) acc = acc * G[at(rows.z_off[l - 1] + k)];
            dh[k] = acc;
          }
          T* tmp = dz;
          dz = dh;
          dh = tmp;
        }
        // dz holds the layer-0 input cotangent: v_y, then v_t.
        for (int d = 0; d < D; ++d) {
          T vy = dz[d];
          if (net.input_power > 1) {
            T yp = ya[d];
            for (int p = 2; p < net.input_power; ++p) yp = yp * ya[d];
            vy = vy * (T(net.input_power) * yp);
          }
          KAY[at(st * D + d)] = sf * vy;
        }
        if (ti && add) quad(n_w, dz[D]);
      }
      // The solution combine of (y, a_y), Kahan-compensated.
      for (int pass = 0; pass < 2; ++pass) {
        T* V = pass ? AY : Y;
        T* CV = pass ? CAY : CY;
        const T* KV = pass ? KAY : KY;
        for (int d = 0; d < D; ++d) {
          T dv = T(0);
          bool first = true;
          for (int q = 0; q < S; ++q) {
            if (tab.b_sol[q] != T(0)) {
              const T term = (h * tab.b_sol[q]) * KV[at(q * D + d)];
              dv = first ? term : dv + term;
              first = false;
            }
          }
          const T v0 = V[at(d)];
          const T adj = dv - CV[at(d)];
          const T v1 = v0 + adj;
          CV[at(d)] = (v1 - v0) - adj;
          V[at(d)] = v1;
        }
      }
      for (int r = 0; r < R; ++r) ACC[at(r)] = ACC[at(r)] + STEP[at(r)];
    }
  }
  if (mine) {
    for (int d = 0; d < D; ++d) {
      const long k = long(b) * D + d;
      ay0_out[k] = AY[at(d)] + g[k];
    }
  }
  // The block's sums of the per-sample quadratures, in block_sum's tree.
  for (int r = 0; r < R; ++r) {
    const T total = block_sum(mine ? ACC[at(r)] : T(0), red);
    if (tid == 0) partial[long(blockIdx.x) * R + r] = total;
  }
}

// The batch sums: block sums added in block order, one thread a value.
template <typename T>
__global__ void fixed_adjoint_reduce_kernel(const T* __restrict__ partial,
                                            int n_blocks, int n_w, int ti,
                                            T* __restrict__ aw,
                                            T* __restrict__ at_out,
                                            int* __restrict__ stats,
                                            int nfe, int steps) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = n_w + ti;
  if (r == 0) {
    stats[0] = nfe;
    stats[1] = steps;
    stats[2] = 0;
    stats[3] = 0;
    if (!ti) at_out[0] = T(0);
  }
  if (r >= R) return;
  T total = partial[r];
  for (int k = 1; k < n_blocks; ++k) total = total + partial[long(k) * R + r];
  if (r < n_w)
    aw[r] = total;
  else
    at_out[0] = total;
}

// Workspace values the sweep needs; ops/cuda_fixed.py:_adjoint_work_size
// allocates the same count.
inline long fixed_adjoint_work_size(const Net& net, int S, int B, int D) {
  long rows = (4 + 2 * long(S)) * D;
  int n_w = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    rows += net.din[l] + net.dout[l];
    n_w += net.din[l] * net.dout[l] + net.dout[l];
  }
  rows += 2 * long(n_w + net.time_input);
  return rows * B;
}

template <typename T>
int launch_adjoint_fixed(const void* tau, const void* ys, const void* g,
                         const void* weights, void* ay0, void* aw, void* at,
                         void* stats, void* partial, void* work,
                         long work_size, int T_obs, int B, int D,
                         int threads, int n_sub, double sign, int n_layers,
                         const int* dims, int act_hidden, int act_final,
                         int input_power, int time_input, int stages,
                         const double* c, const double* a,
                         const double* b_sol, void* stream) {
  if (stages < 1 || stages > kMaxStages || T_obs < 1 || B < 1 || D < 1 ||
      n_sub < 1 || D + time_input > kMaxWidth || input_power < 1 ||
      threads < 32 || threads > 1024 || (threads & (threads - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  const int n_w = make_net(net, n_layers, dims, D, act_hidden, act_final,
                           input_power, time_input);
  if (n_w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (work_size < fixed_adjoint_work_size(net, stages, B, D))
    return static_cast<int>(cudaErrorInvalidValue);
  bool any = false;
  for (int i = 0; i < stages; ++i) any = any || b_sol[i] != 0.0;
  if (!any) return static_cast<int>(cudaErrorInvalidValue);
  FixedRows rows;
  int h = 0, z = 0;
  for (int l = 0; l < n_layers; ++l) {
    rows.h_off[l] = h;
    rows.z_off[l] = z;
    h += net.din[l];
    z += net.dout[l];
  }
  // Fixed tableaus have no error weights: b_sol stands in for b_err.
  const Tableau<T> tab =
      make_tableau<T>(stages, 0, 0, c, a, b_sol, b_sol, nullptr);
  FixedAdjScalars<T> sc;
  sc.sign = T(sign);
  sc.T_obs = T_obs;
  sc.B = B;
  sc.D = D;
  sc.n_sub = n_sub;

  const size_t smem = sizeof(T) * (size_t(n_w) + threads);
  auto kernel = mlp_adjoint_fixed_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const T*>(tau), static_cast<const T*>(ys),
      static_cast<const T*>(g), static_cast<const T*>(weights),
      static_cast<T*>(ay0), static_cast<T*>(partial), static_cast<T*>(work),
      n_w, net, rows, tab, sc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = n_w + time_input;
  const int steps = n_sub * (T_obs - 1);
  fixed_adjoint_reduce_kernel<T><<<(R + 127) / 128, 128, 0, st>>>(
      static_cast<const T*>(partial), blocks, n_w, time_input,
      static_cast<T*>(aw), static_cast<T*>(at), static_cast<int*>(stats),
      stages * steps, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfd

#define TFD_ADJOINT_FIXED_ENTRY(NAME, TYPE)                                  \
  extern "C" int NAME(                                                       \
      const void* tau, const void* ys, const void* g, const void* weights,  \
      void* ay0, void* aw, void* at, void* stats, void* partial,            \
      void* work, long work_size, int T_obs, int B, int D, int threads,     \
      int n_sub, double sign, int n_layers, const int* dims,                \
      int act_hidden, int act_final, int input_power, int time_input,       \
      int stages, const double* c, const double* a, const double* b_sol,    \
      void* stream) {                                                        \
    return tfd::launch_adjoint_fixed<TYPE>(                                  \
        tau, ys, g, weights, ay0, aw, at, stats, partial, work, work_size,  \
        T_obs, B, D, threads, n_sub, sign, n_layers, dims, act_hidden,      \
        act_final, input_power, time_input, stages, c, a, b_sol, stream);   \
  }

TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f32, float)
TFD_ADJOINT_FIXED_ENTRY(tfd_mlp_adjoint_fixed_f64, double)
