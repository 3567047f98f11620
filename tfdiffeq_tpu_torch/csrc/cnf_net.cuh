// K7: the right-hand side of a continuous normalizing flow (FFJORD) and its
// second-order adjoint, for one sample, inside K2 (csrc/solve_kernel.cu,
// cnf_eval) and K3 (csrc/adjoint_kernel.cu, cnf_aug_eval in its phase A
// and cnf_weight_x in its batch sums).
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
// Design. A thread walks one sample at a time, as in the MLP kernels; its
// vectors of one layer sit in the route's two per-thread buffers, and
// everything a later pass reads (act', act'', the passes' v and u, part
// A's cotangents, part B's vb and deltas) goes to workspace rows of B
// values (row r of sample b at r * B + b, so a warp touches 32 consecutive
// values), as K3's batch sums read them. Bound on the H100: one sample's
// forward and D passes are about (D + 1) times an MLP evaluation, the
// adjoint about 2 D + 3 times, a dependent chain per thread; in K3 each
// weight's batch sum reads up to 2 D + 3 workspace values a sample where
// the MLP reads 2, on K3's one SM.
#pragma once

#include "mlp_rk.cuh"

namespace tfd {

// F(t, s) of one sample (pallas_kernels.py:_make_cnf_net): s in h_a[0, D]
// (logp at h_a[D] is not read), t the time. CW holds the sample's
// workspace rows: act'(z) of each layer's outputs (the layers' outputs in
// order; the last layer's rows are unused), then f
// (ops/cuda_kernels.mlp_solve allocates them). Returns h_a holding the
// D + 1 values of F.
template <typename T>
__device__ T* cnf_eval(const Net& net, const T* __restrict__ w, T t, T* h_a,
                       T* h_b, T* __restrict__ CW, int B, int b) {
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  const int L = net.n_layers, D = net.dout[L - 1], code = net.act_hidden;
  // Forward, keeping act'(z) of the hidden layers.
  T* hin = h_a;
  T* hout = h_b;
  int z_off = 0;
  for (int l = 0; l < L; ++l) {
    const int din = net.din[l], dout = net.dout[l];
    const int n_in = l == 0 ? din - 1 : din;
    const T* W = w + net.w_off[l];
    const T* bias = w + net.b_off[l];
    for (int o = 0; o < dout; ++o) {
      const T* row = W + o * din;
      T acc = row[0] * hin[0];
      for (int i = 1; i < n_in; ++i) acc = acc + row[i] * hin[i];
      if (l == 0) acc = acc + row[n_in] * t;
      const T zp = acc + bias[o];
      if (l < L - 1) {
        const T a = activate(code, zp);
        CW[at(z_off + o)] = act_grad(code, zp, a);
        hout[o] = a;
      } else {
        hout[o] = zp;
      }
    }
    z_off += dout;
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  for (int d = 0; d < D; ++d) CW[at(z_off + d)] = hin[d];
  // The divergence: pass i0 seeded with the first layer's column i0.
  const T* W0 = w + net.w_off[0];
  const int din0 = net.din[0];
  T div = T(0);
  for (int i0 = 0; i0 < D; ++i0) {
    T d_i;
    if (L == 1) {
      d_i = W0[i0 * din0 + i0];
    } else {
      T* du = h_a;
      T* v = h_b;
      for (int o = 0; o < net.dout[0]; ++o)
        du[o] = CW[at(o)] * W0[o * din0 + i0];
      int g_off = net.dout[0];
      for (int l = 1; l < L; ++l) {
        const int din = net.din[l], dout = net.dout[l];
        const T* W = w + net.w_off[l];
        if (l == L - 1) {  // only output i0 enters the trace
          const T* row = W + i0 * din;
          T acc = row[0] * du[0];
          for (int i = 1; i < din; ++i) acc = acc + row[i] * du[i];
          d_i = acc;
        } else {
          for (int o = 0; o < dout; ++o) {
            const T* row = W + o * din;
            T acc = row[0] * du[0];
            for (int i = 1; i < din; ++i) acc = acc + row[i] * du[i];
            v[o] = CW[at(g_off + o)] * acc;
          }
          g_off += dout;
          T* tmp = du;
          du = v;
          v = tmp;
        }
      }
    }
    div = i0 == 0 ? d_i : div + d_i;
  }
  for (int d = 0; d < D; ++d) h_a[d] = CW[at(z_off + d)];
  h_a[D] = -div;
  return h_a;
}

// Workspace rows of K3's CNF stage, from row 0 of its per-stage block: the
// layers' inputs (h_off), then blocks of n_z rows (the layers' outputs in
// order, z_off): act' (g), act'' (g2), part A's cotangents (dz), the deltas
// (dl, first zbar); then D blocks each of the passes' v, u and vb; then
// v_t. ops/cuda_adjoint.py:_work_size counts the same rows.
struct CnfRows {
  int h_off[kMaxLayers];
  int z_off[kMaxLayers];
  int n_z, g, g2, dz, dl, v, u, vb, vt;
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
  r.g = h;
  r.g2 = r.g + z;
  r.dz = r.g2 + z;
  r.dl = r.dz + z;
  r.v = r.dl + z;
  r.u = r.v + D * z;
  r.vb = r.u + D * z;
  r.vt = r.vb + D * z;
  return r;
}

inline long cnf_rows_count(const Net& net) { return make_cnf_rows(net).vt + 1; }

// One stage of K3 for sample b (pallas_adjoint.py:_make_cnf_aug_eval): ya,
// aya the stage's [z; logp] and [a_z; a_l]; writes ky = -sf F and
// kay = sf v_y (D + 1 values each), v_t and every row a batch sum reads.
template <typename T>
__device__ void cnf_aug_eval(const Net& net, const CnfRows& r,
                             const T* __restrict__ w, T t, const T* ya,
                             const T* aya, T* buf_a, T* buf_b,
                             T* __restrict__ WS, int B, int b, T* ky, T* kay,
                             T sf) {
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  const int L = net.n_layers, D = net.dout[L - 1], code = net.act_hidden;
  const int n_z = r.n_z;
  // Forward, keeping the layers' inputs, act' and act''.
  T* hin = buf_a;
  T* hout = buf_b;
  for (int d = 0; d < D; ++d) hin[d] = ya[d];
  hin[D] = t;
  for (int l = 0; l < L; ++l) {
    const int din = net.din[l], dout = net.dout[l];
    const T* W = w + net.w_off[l];
    const T* bias = w + net.b_off[l];
    for (int k = 0; k < din; ++k) WS[at(r.h_off[l] + k)] = hin[k];
    for (int o = 0; o < dout; ++o) {
      const T* row = W + o * din;
      T acc = row[0] * hin[0];
      for (int k = 1; k < din; ++k) acc = acc + row[k] * hin[k];
      const T zp = acc + bias[o];
      if (l < L - 1) {
        const int zo = r.z_off[l] + o;
        const T a = activate(code, zp);
        const T g = act_grad(code, zp, a);
        WS[at(r.g + zo)] = g;
        WS[at(r.g2 + zo)] = act_grad2(code, zp, a, g);
        hout[o] = a;
      } else {
        hout[o] = zp;
      }
    }
    T* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  for (int d = 0; d < D; ++d) ky[d] = (-sf) * hin[d];
  // The divergence's D passes, keeping v and u = act' v of hidden layers.
  T div = T(0);
  for (int i0 = 0; i0 < D; ++i0) {
    T* u = buf_a;
    T* v = buf_b;
    T d_i = T(0);
    for (int l = 0; l < L; ++l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      if (l == L - 1) {  // only output i0 enters the trace
        const T* row = W + i0 * din;
        if (l == 0) {
          d_i = row[i0];
        } else {
          T acc = row[0] * u[0];
          for (int k = 1; k < din; ++k) acc = acc + row[k] * u[k];
          d_i = acc;
        }
        break;
      }
      for (int o = 0; o < dout; ++o) {
        const T* row = W + o * din;
        T vv;
        if (l == 0) {
          vv = row[i0];
        } else {
          vv = row[0] * u[0];
          for (int k = 1; k < din; ++k) vv = vv + row[k] * u[k];
        }
        const int zo = i0 * n_z + r.z_off[l] + o;
        const T uu = WS[at(r.g + r.z_off[l] + o)] * vv;
        WS[at(r.v + zo)] = vv;
        WS[at(r.u + zo)] = uu;
        v[o] = uu;
      }
      T* tmp = u;
      u = v;
      v = tmp;
    }
    div = i0 == 0 ? d_i : div + d_i;
  }
  ky[D] = (-sf) * (-div);
  // Part A: the f-VJP with a_z (the last layer is linear).
  T* dz = buf_a;
  T* dh = buf_b;
  for (int d = 0; d < D; ++d) dz[d] = aya[d];
  for (int l = L - 1; l >= 0; --l) {
    const int din = net.din[l], dout = net.dout[l];
    const T* W = w + net.w_off[l];
    for (int o = 0; o < dout; ++o) WS[at(r.dz + r.z_off[l] + o)] = dz[o];
    for (int k = 0; k < din; ++k) {
      T acc = W[k] * dz[0];
      for (int o = 1; o < dout; ++o) acc = acc + W[o * din + k] * dz[o];
      dh[k] = l > 0 ? WS[at(r.g + r.z_off[l - 1] + k)] * acc : acc;
    }
    T* tmp = dz;
    dz = dh;
    dh = tmp;
  }
  for (int d = 0; d < D; ++d) kay[d] = dz[d];  // v_z_A until the end
  const T vt_a = dz[D];
  // Part B: each pass walked back from a_l on its output i0.
  const T al = aya[D];
  for (int i0 = 0; i0 < D; ++i0) {
    T* ub = buf_a;
    T* vb = buf_b;
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      for (int o = 0; o < dout; ++o) {
        const int zo = r.z_off[l] + o;
        T x;
        if (l == L - 1) {
          x = o == i0 ? al : T(0);
        } else {
          const T ubo = ub[o];
          x = WS[at(r.g + zo)] * ubo;
          const T zb = (WS[at(r.g2 + zo)] * WS[at(r.v + i0 * n_z + zo)]) * ubo;
          WS[at(r.dl + zo)] = i0 == 0 ? zb : WS[at(r.dl + zo)] + zb;
        }
        vb[o] = x;
        WS[at(r.vb + i0 * n_z + zo)] = x;
      }
      if (l > 0) {
        for (int k = 0; k < din; ++k) {
          T acc = W[k] * vb[0];
          for (int o = 1; o < dout; ++o) acc = acc + W[o * din + k] * vb[o];
          ub[k] = acc;
        }
      }
    }
  }
  // ... then zbar injected through the primal backward as the deltas.
  T* delta = buf_a;
  dh = buf_b;
  for (int l = L - 2; l >= 0; --l) {
    const int din = net.din[l], dout = net.dout[l];
    const T* W = w + net.w_off[l];
    for (int o = 0; o < dout; ++o) {
      const long row = at(r.dl + r.z_off[l] + o);
      const T dv = l == L - 2 ? WS[row] : delta[o] + WS[row];
      WS[row] = dv;
      delta[o] = dv;
    }
    for (int k = 0; k < din; ++k) {
      T acc = W[k] * delta[0];
      for (int o = 1; o < dout; ++o) acc = acc + W[o * din + k] * delta[o];
      dh[k] = l > 0 ? WS[at(r.g + r.z_off[l - 1] + k)] * acc : acc;
    }
    T* tmp = delta;
    delta = dh;
    dh = tmp;
  }
  // delta holds part B's layer-0 input cotangent when there is a hidden
  // layer; v_y = v_A - v_B with v_B = 0 + that, its logp entry 0.
  for (int d = 0; d < D; ++d) {
    const T vb_d = L > 1 ? T(0) + delta[d] : T(0);
    kay[d] = sf * (kay[d] - vb_d);
  }
  kay[D] = sf * T(0);
  WS[at(r.vt)] = vt_a - (L > 1 ? T(0) + delta[D] : T(0));
}

// Sample b's cotangent of weight (o, k) of layer l (bias when k < 0):
// dz[o] h[k] minus the direct terms vb_i0[o] u_i0[k] in i0 order (on layer
// 0 vb_k[o] for a state column k) plus delta[o] h[k] on a hidden layer.
template <typename T>
__device__ __forceinline__ T cnf_weight_x(const Net& net, const CnfRows& r,
                                          const T* __restrict__ WS, int l,
                                          int o, int k, int B, int b) {
  auto at = [B, b](int row) -> long { return long(row) * B + b; };
  const int L = net.n_layers, D = net.dout[L - 1], n_z = r.n_z;
  const int zo = r.z_off[l] + o;
  const T dz = WS[at(r.dz + zo)];
  if (k < 0) return l < L - 1 ? dz - WS[at(r.dl + zo)] : dz;
  const T hk = WS[at(r.h_off[l] + k)];
  T xb;
  if (l == 0) {
    xb = k < D ? WS[at(r.vb + k * n_z + zo)] : T(0);
  } else {
    const int uk = r.z_off[l - 1] + k;
    xb = WS[at(r.vb + zo)] * WS[at(r.u + uk)];
    for (int i0 = 1; i0 < D; ++i0)
      xb = xb + WS[at(r.vb + i0 * n_z + zo)] * WS[at(r.u + i0 * n_z + uk)];
  }
  if (l < L - 1) xb = xb + WS[at(r.dl + zo)] * hk;
  return dz * hk - xb;
}

}  // namespace tfd
