// K7: the right-hand side of a continuous normalizing flow (FFJORD) and its
// second-order adjoint, for one sample, inside K2 (csrc/solve_kernel.cu,
// cnf_eval_group) and K3 (csrc/adjoint_kernel.cu, cnf_aug_eval_group in
// its phase A and cnf_weight_x in its batch sums).
//
// Replaces the TPU kernel functions tfdiffeq_tpu/ops/pallas_kernels.py:442
// (_make_cnf_net, inside _make_solve_kernel via mlp_solve(rhs='cnf')) and
// tfdiffeq_tpu/ops/pallas_adjoint.py:240 (_make_cnf_aug_eval, inside
// _make_adjoint_kernel via mlp_adjoint_solve(rhs='cnf')). The flow is a
// concat-t MLP f(t, z) (Net with a time column; hidden layers act_hidden,
// the last layer linear); the state is s = [z; logp], D + 1 values, and
//
//     F(t, s) = [f(t, z); -div f],  div f = sum_i0 (J e_i0)_i0,
//
// the divergence exact, from D forward-mode passes through the stored
// act'(z). The adjoint takes a = [a_z; a_l] and returns F, v_y = (dF/ds)^T a
// (its logp entry 0), v_t and, per weight, the sample's cotangent, as part
// A (the f-VJP with a_z) minus part B (the divergence's VJP with a_l: a
// reverse walk through each pass, gathering the pre-activation cotangents
// zbar from act'', then zbar injected through the primal backward). Each
// operation follows the plain versions (ops/cuda_kernels.py:_cnf_net_plain,
// ops/cuda_adjoint.py:_cnf_aug_eval_plain) in order: products sum their
// inputs in order, the divergence in i0 order; with --fmad=false the
// kernels give the plain versions' bits.
//
// Design. A group of threads walks a sample (the engines' grouped walks:
// K2's `slots` samples a round of the block's 512 threads, 16 threads a
// sample at 32 slots; K3's the same), each layer's outputs spread over the
// members and, in the VJPs, each layer's inputs, every value one member's
// sum in the plain version's order, the block meeting after each layer.
// What only the walk reads (act', act'', the passes' products, zbar) sits
// in the sample's slot in shared memory; what K3's batch sums read (the
// layers' inputs, part A's cotangents, the deltas, the passes' u and vb,
// v_t) goes to rows of the block's samples (CnfRowsAt), in its shared
// memory where they fit, which phase B sums a thread a weight. The
// products over a layer's inputs read the weights
// transposed on the narrow route (both layouts in shared memory), so that
// the members' loads fall in different banks. Bound on the H100: a stage's
// chain is a layer's longest sum (the flow's width) a layer, about
// 2 D + 3 times a network's depth of them in the adjoint, and a block
// barrier after each; phase B reads 2 D + 4 values a sample for each
// weight (PERF.md has the clock64 profile).
#pragma once

#include "mlp_rk.cuh"

namespace tfd {

// Layer l's weight (o, i) for a product over its inputs: from the
// transposed weights (kT; mlp_rk.cuh transpose_weights, so that the
// members of a group, one output each, read neighbouring values) or the
// packed row-major ones.
template <bool kT, typename T>
__device__ __forceinline__ T fwd_w(const T* __restrict__ W, int o, int i,
                                   int din, int dout) {
  return kT ? W[i * dout + o] : W[o * din + i];
}

// A member's products over a layer's n inputs h, for its outputs o = m,
// m + gsz, ... < dout: acc = W(o, 0) h[0] + W(o, 1) h[1] + ... in input
// order, handed to take(o, acc).
template <bool kT, typename T, class Take>
__device__ __forceinline__ void fwd_products(const T* __restrict__ W,
                                             const T* h, int n, int din,
                                             int dout, int m, int gsz,
                                             Take take) {
  for (int o = m; o < dout; o += gsz) {
    T a = fwd_w<kT>(W, o, 0, din, dout) * h[0];
    for (int i = 1; i < n; ++i) a = a + fwd_w<kT>(W, o, i, din, dout) * h[i];
    take(o, a);
  }
}

// A member's VJP products of a layer (row-major weights W [dout][din]) for
// its inputs k = m, m + gsz, ... < din: acc = W[0][k] g[0] + W[1][k] g[1] +
// ... in output order, handed to take(k, acc).
template <typename T, class Take>
__device__ __forceinline__ void vjp_products(const T* __restrict__ W,
                                             const T* g, int din, int dout,
                                             int m, int gsz, Take take) {
  for (int k = m; k < din; k += gsz) {
    T a = W[k] * g[0];
    for (int o = 1; o < dout; ++o) a = a + W[o * din + k] * g[o];
    take(k, a);
  }
}

// The hidden layers' outputs of the flow (every layer but the last).
__host__ __device__ inline int cnf_hidden(const Net& net) {
  int n = 0;
  for (int l = 0; l + 1 < net.n_layers; ++l) n += net.dout[l];
  return n;
}

// F(t, s) of one sample (pallas_kernels.py:_make_cnf_net) with the gsz
// threads of its group (member m; `on`: the group has a sample this round),
// every thread of the block calling it. The slot `sl`
// (lane_group.h cnf_solve_slot_values) holds the two layer vectors (gw
// values each; s comes in the first, logp at s[D] is not read), act'(z) of
// the hidden outputs, F (D + 1) and the passes' trace terms (D). wf: the
// weights of the products (transposed with kT). Each layer's outputs go
// one a member (o = m, m + gsz, ...), each the same sum in input order as
// ops/cuda_kernels.py _cnf_net_plain's (the time column last, then the
// bias); the D passes run in i0 order, the last product of pass i0 (its
// output i0 alone) on member i0 % gsz, and member 0 adds the divergence in
// i0 order. The block meets after each layer. Returns F, which every
// member may read.
template <bool kT, typename T>
__device__ const T* cnf_eval_group(const Net& net, const T* __restrict__ wf,
                                   T t, T* sl, int gw, bool on, int m,
                                   int gsz) {
  const int L = net.n_layers, D = net.dout[L - 1], code = net.act_hidden;
  T* const va = sl;
  T* const vb = sl + gw;
  T* const G = sl + 2 * gw;
  T* const F = G + cnf_hidden(net);
  T* const DV = F + D + 1;
  // Forward, keeping act'(z) of the hidden layers; the last layer into F.
  T* hin = va;
  T* hout = vb;
  int g_off = 0;
  for (int l = 0; l < L; ++l) {
    const int din = net.din[l], dout = net.dout[l];
    const int n_in = l == 0 ? din - 1 : din;
    const T* W = wf + net.w_off[l];
    const T* bias = wf + net.b_off[l];
    T* dst = l < L - 1 ? hout : F;
    if (on)
      fwd_products<kT>(W, hin, n_in, din, dout, m, gsz, [&](int o, T acc) {
        if (l == 0) acc = acc + fwd_w<kT>(W, o, n_in, din, dout) * t;
        const T zp = acc + bias[o];
        if (l < L - 1) {
          const T a = activate(code, zp);
          G[g_off + o] = act_grad(code, zp, a);
          dst[o] = a;
        } else {
          dst[o] = zp;
        }
      });
    __syncthreads();
    g_off += dout;
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  // The divergence: pass i0 seeded with the first layer's column i0.
  const T* W0 = wf + net.w_off[0];
  const int din0 = net.din[0], dout0 = net.dout[0];
  for (int i0 = 0; i0 < D; ++i0) {
    if (L == 1) {
      if (on && m == i0 % gsz) DV[i0] = fwd_w<kT>(W0, i0, i0, din0, dout0);
      continue;
    }
    T* du = va;
    T* v = vb;
    for (int o = m; on && o < dout0; o += gsz)
      du[o] = G[o] * fwd_w<kT>(W0, o, i0, din0, dout0);
    __syncthreads();
    int gl = dout0;
    for (int l = 1; l < L; ++l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = wf + net.w_off[l];
      if (l == L - 1) {  // only output i0 enters the trace
        if (on && m == i0 % gsz) {
          T acc = fwd_w<kT>(W, i0, 0, din, dout) * du[0];
          for (int i = 1; i < din; ++i)
            acc = acc + fwd_w<kT>(W, i0, i, din, dout) * du[i];
          DV[i0] = acc;
        }
      } else {
        if (on)
          fwd_products<kT>(W, du, din, din, dout, m, gsz,
                           [&](int o, T acc) { v[o] = G[gl + o] * acc; });
        __syncthreads();
        gl += dout;
        T* tmp = du;
        du = v;
        v = tmp;
      }
    }
    // The last product read du; the next pass writes va first.
    if (du == va) __syncthreads();
  }
  __syncthreads();
  if (on && m == 0) {
    T div = DV[0];
    for (int i0 = 1; i0 < D; ++i0) div = div + DV[i0];
    F[D] = -div;
  }
  __syncthreads();
  return F;
}

// Rows of K3's CNF stage that its phase B reads, n a sample (CnfRowsAt
// places them): the layers' inputs (h_off), then over the layers' outputs
// (z_off, n_z in all) part A's cotangents (dz), the deltas (dl; the first
// zbar), the D passes' u and vb, then v_t. lane_group.h cnf_aug_row_values
// and ops/cuda_adjoint.py _work_size count the same values.
struct CnfRows {
  int h_off[kMaxLayers];
  int z_off[kMaxLayers];
  int n_z, n_hid, dz, dl, u, vb, vt, n;
};

inline CnfRows make_cnf_rows(const Net& net) {
  CnfRows r;
  int h = 0, z = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    r.h_off[l] = h;
    r.z_off[l] = z;
    h += net.din[l];
    z += net.dout[l];
  }
  const int D = net.dout[net.n_layers - 1];
  r.n_z = z;
  r.n_hid = z - D;
  r.dz = h;
  r.dl = r.dz + z;
  r.u = r.dl + z;
  r.vb = r.u + D * z;
  r.vt = r.vb + D * z;
  r.n = r.vt + 1;
  return r;
}

// A block's view of K7's rows: row X of sample b at p[X stride + b]. In the
// block's shared memory (p offset by the block's first sample, stride its
// samples + 1: odd, so that a group's stores, one sample and many rows,
// and a warp's loads in phase B, one weight a thread and so one row a
// thread, each fall in different banks) where they fit, else the
// workspace's rows of B.
template <typename T>
struct CnfRowsAt {
  T* p;
  long stride;
  __device__ __forceinline__ T& operator()(int X, int b) const {
    return p[X * stride + b];
  }
};

// One stage of K3 for sample b (pallas_adjoint.py:_make_cnf_aug_eval) with
// the gsz threads of its group (member m; `on`: the group has a sample),
// every thread of the block calling it. The slot `sl` (lane_group.h
// cnf_aug_slot_values) holds the stage's [z; logp] and [a_z; a_l] (gw
// values each), the two layer vectors, act' and act'' of the hidden
// outputs, the passes' products v, the gathered zbar, part A's input
// cotangent and the passes' trace terms; ws(X, b) are its rows (CnfRows).
// w: the packed row-major weights (the VJPs: each input's cotangent on one
// member, its sum over the layer's outputs in order); wf: the weights of
// the products (transposed with kT: each output on one member, its sum
// over the inputs in order). Every sum is _cnf_aug_eval_plain's
// (ops/cuda_adjoint.py) in its order. Writes ky = -sf F and kay = sf v_y
// (D + 1 values each), v_t and the rows.
template <bool kT, typename T>
__device__ void cnf_aug_eval_group(const Net& net, const CnfRows& r,
                                   const T* __restrict__ w,
                                   const T* __restrict__ wf, T t, T* sl,
                                   int gw, const CnfRowsAt<T>& ws, int b,
                                   T* ky, T* kay, T sf, bool on, int m,
                                   int gsz) {
  const int L = net.n_layers, D = net.dout[L - 1], code = net.act_hidden;
  const int n_z = r.n_z, n_hid = r.n_hid;
  const T* ya = sl;
  const T* aya = sl + gw;
  T* const P = sl + 2 * gw;
  T* const Q = sl + 3 * gw;
  T* const G = sl + 4 * gw;
  T* const G2 = G + n_hid;
  T* const V = G2 + n_hid;
  T* const DL = V + D * n_hid;
  T* const VA = DL + n_hid;
  T* const DV = VA + D + 1;
  // Forward, keeping the layers' inputs (rows), act' and act'' (slot).
  for (int d = m; on && d <= D; d += gsz) P[d] = d < D ? ya[d] : t;
  __syncthreads();
  T* hin = P;
  T* hout = Q;
  for (int l = 0; l < L; ++l) {
    const int din = net.din[l], dout = net.dout[l];
    const T* W = wf + net.w_off[l];
    const T* bias = wf + net.b_off[l];
    for (int k = m; on && k < din; k += gsz) ws(r.h_off[l] + k, b) = hin[k];
    if (on)
      fwd_products<kT>(W, hin, din, din, dout, m, gsz, [&](int o, T acc) {
        const T zp = acc + bias[o];
        if (l < L - 1) {
          const int zo = r.z_off[l] + o;
          const T a = activate(code, zp);
          const T g = act_grad(code, zp, a);
          G[zo] = g;
          G2[zo] = act_grad2(code, zp, a, g);
          hout[o] = a;
        } else {
          hout[o] = zp;
        }
      });
    __syncthreads();
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  for (int d = m; on && d < D; d += gsz) ky[d] = (-sf) * hin[d];
  // The divergence's D passes, keeping v (slot) and u = act' v (rows) of
  // the hidden layers; the first writes hout, not f's vector.
  for (int i0 = 0; i0 < D; ++i0) {
    T* u = hin;
    T* v = hout;
    for (int l = 0; l < L; ++l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = wf + net.w_off[l];
      if (l == L - 1) {  // only output i0 enters the trace
        if (on && m == i0 % gsz) {
          T d_i;
          if (l == 0) {
            d_i = fwd_w<kT>(W, i0, i0, din, dout);
          } else {
            d_i = fwd_w<kT>(W, i0, 0, din, dout) * u[0];
            for (int k = 1; k < din; ++k)
              d_i = d_i + fwd_w<kT>(W, i0, k, din, dout) * u[k];
          }
          DV[i0] = d_i;
        }
        break;
      }
      auto keep = [&](int o, T vv) {
        const int zo = r.z_off[l] + o;
        const T uu = G[zo] * vv;
        V[i0 * n_hid + zo] = vv;
        ws(r.u + i0 * n_z + zo, b) = uu;
        v[o] = uu;
      };
      if (on && l == 0) {
        for (int o = m; o < dout; o += gsz)
          keep(o, fwd_w<kT>(W, o, i0, din, dout));
      } else if (on) {
        fwd_products<kT>(W, u, din, din, dout, m, gsz, keep);
      }
      __syncthreads();
      T* tmp = u;
      u = v;
      v = tmp;
    }
    // The last product read u; the next pass writes hout first.
    if (L > 1 && u == hout) __syncthreads();
  }
  __syncthreads();
  if (on && m == 0) {
    T div = DV[0];
    for (int i0 = 1; i0 < D; ++i0) div = div + DV[i0];
    ky[D] = (-sf) * (-div);
  }
  // Part A: the f-VJP with a_z (the last layer is linear).
  T* dz = P;
  T* dh = Q;
  for (int d = m; on && d < D; d += gsz) dz[d] = aya[d];
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.din[l], dout = net.dout[l];
    const T* W = w + net.w_off[l];
    for (int o = m; on && o < dout; o += gsz)
      ws(r.dz + r.z_off[l] + o, b) = dz[o];
    if (on)
      vjp_products(W, dz, din, dout, m, gsz, [&](int k, T acc) {
        dh[k] = l > 0 ? G[r.z_off[l - 1] + k] * acc : acc;
      });
    __syncthreads();
    T* tmp = dz;
    dz = dh;
    dh = tmp;
  }
  for (int d = m; on && d <= D; d += gsz) VA[d] = dz[d];  // v_z_A, v_t_A
  // Part B: each pass walked back from a_l on its output i0.
  const T al = aya[D];
  T* ub = dz;
  T* vb = dh;
  for (int i0 = 0; i0 < D; ++i0) {
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      for (int o = m; on && o < dout; o += gsz) {
        const int zo = r.z_off[l] + o;
        T x;
        if (l == L - 1) {
          x = o == i0 ? al : T(0);
        } else {
          const T ubo = ub[o];
          x = G[zo] * ubo;
          const T zb = (G2[zo] * V[i0 * n_hid + zo]) * ubo;
          DL[zo] = i0 == 0 ? zb : DL[zo] + zb;
        }
        vb[o] = x;
        ws(r.vb + i0 * n_z + zo, b) = x;
      }
      __syncthreads();
      if (l > 0) {
        if (on)
          vjp_products(W, vb, din, dout, m, gsz,
                       [&](int k, T acc) { ub[k] = acc; });
        __syncthreads();
      }
    }
  }
  // ... then zbar injected through the primal backward as the deltas.
  T* delta = ub;
  dh = vb;
  for (int l = L - 2; l >= 0; --l) {
    const int din = net.din[l], dout = net.dout[l];
    const T* W = w + net.w_off[l];
    for (int o = m; on && o < dout; o += gsz) {
      const int zo = r.z_off[l] + o;
      const T dv = l == L - 2 ? DL[zo] : delta[o] + DL[zo];
      ws(r.dl + zo, b) = dv;
      delta[o] = dv;
    }
    __syncthreads();
    if (on)
      vjp_products(W, delta, din, dout, m, gsz, [&](int k, T acc) {
        dh[k] = l > 0 ? G[r.z_off[l - 1] + k] * acc : acc;
      });
    __syncthreads();
    T* tmp = delta;
    delta = dh;
    dh = tmp;
  }
  // delta holds part B's layer-0 input cotangent when there is a hidden
  // layer; v_y = v_A - v_B with v_B = 0 + that, its logp entry 0.
  for (int d = m; on && d < D; d += gsz) {
    const T vb_d = L > 1 ? T(0) + delta[d] : T(0);
    kay[d] = sf * (VA[d] - vb_d);
  }
  if (on && m == 0) {
    kay[D] = sf * T(0);
    ws(r.vt, b) = VA[D] - (L > 1 ? T(0) + delta[D] : T(0));
  }
  __syncthreads();
}

// Weight (o, k) of layer l (bias when k < 0) decoded once for its batch
// sum: its offsets in a sample's row block (cnf_weight_x).
struct CnfWeight {
  int l, k, zo, hk, uk;
  bool hidden;
};

__device__ __forceinline__ CnfWeight cnf_weight(const Net& net,
                                                const CnfRows& r, int l,
                                                int o, int k) {
  CnfWeight w;
  w.l = l;
  w.k = k;
  w.zo = r.z_off[l] + o;
  w.hk = k < 0 ? 0 : r.h_off[l] + k;
  w.uk = k < 0 || l == 0 ? 0 : r.z_off[l - 1] + k;
  w.hidden = l < net.n_layers - 1;
  return w;
}

// Sample b's cotangent of weight w, from its rows s (CnfRows): dz[o]
// h[k] minus the direct terms vb_i0[o] u_i0[k] in i0 order (on layer 0
// vb_k[o] for a state column k) plus delta[o] h[k] on a hidden layer; a
// bias dz[o] minus delta[o] on a hidden layer.
template <typename T>
__device__ __forceinline__ T cnf_weight_x(const CnfRows& r,
                                          const CnfWeight& w,
                                          const CnfRowsAt<T>& s, int b,
                                          int D) {
  const int n_z = r.n_z, zo = w.zo;
  const T dz = s(r.dz + zo, b);
  if (w.k < 0) return w.hidden ? dz - s(r.dl + zo, b) : dz;
  const T hk = s(w.hk, b);
  T xb;
  if (w.l == 0) {
    xb = w.k < D ? s(r.vb + w.k * n_z + zo, b) : T(0);
  } else {
    xb = s(r.vb + zo, b) * s(r.u + w.uk, b);
    for (int i0 = 1; i0 < D; ++i0)
      xb = xb + s(r.vb + i0 * n_z + zo, b) * s(r.u + i0 * n_z + w.uk, b);
  }
  if (w.hidden) xb = xb + s(r.dl + zo, b) * hk;
  return dz * hk - xb;
}

}  // namespace tfd
