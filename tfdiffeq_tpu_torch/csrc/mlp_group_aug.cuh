// The MLP routes' augmented right-hand side of K6 and K9
// (csrc/rk_adjoint.cuh rk_perlane_adjoint_kernel, rk_fixed_adjoint_kernel):
// one sample's MLP forward and its hand-written VJP, walked by a group of
// threads (csrc/lane_group.h), in the order of the reference's
// pallas_adjoint.py:_make_aug_eval (:107).
//
// The group splits each layer's outputs in the forward and its inputs in
// the VJP over its members, each value one member's sum in input (or
// output) order, the group syncing (__syncwarp with its lanes' mask) after
// each layer. The walk's values sit in the sample's slot gs: H (each
// layer's inputs, n_h), GZ (each layer's act'(z), then its pre-activation
// cotangents, n_z), F (f, D) and V (the layer-0 input cotangent: v_y, then
// v_t). A quadrature's term is read from them afterwards (group_x): weight
// (o, k) dz_o h_k, bias dz_o, a_t v_t; its operands, (the H index + 1) <<
// 16 | the GZ index (0 << 16: a bias), are decoded once into a shared table
// for the first n_tab quadratures. Narrow route: the weights in shared
// memory; wide: read from global memory (L2).
#pragma once

#include "lane_group.h"
#include "mlp_rk.cuh"

namespace tfd {

template <typename T, int kRoute>
struct MlpGroupAug {
  static constexpr bool kBatch = false;
  const T* wg;     // packed weights (pack_mlp_weights)
  int n_w, ti, n_ps;
  int n_h, n_z, D, n_tab;
  long walk;       // lane_group_mlp_walk_values
  Net net_in;
  AugRows rows_in;

  struct Shared {
    Net net;
    AugRows rows;
  };
  struct Local {};

  __host__ __device__ long walk_values() const { return walk; }
  // Shared memory values the setup takes: the weights (narrow route), then
  // the quadrature table.
  __host__ __device__ long smem_values() const {
    return (kRoute == kRouteNarrow ? n_w : 0) +
           (long(n_tab) * sizeof(int) + sizeof(T) - 1) / sizeof(T);
  }
  __device__ __forceinline__ const T* weights() const {
    if constexpr (kRoute == kRouteNarrow) {
      extern __shared__ __align__(16) unsigned char smem_raw[];
      return reinterpret_cast<const T*>(smem_raw);
    } else {
      return wg;
    }
  }
  __device__ const int* qtab() const {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    return reinterpret_cast<const int*>(reinterpret_cast<const T*>(smem_raw) +
                                        (kRoute == kRouteNarrow ? n_w : 0));
  }
  static __device__ int quad_code(const Net& net, const AugRows& rows,
                                  int r) {
    int l = 0;
    while (l + 1 < net.n_layers && r >= net.w_off[l + 1]) ++l;
    if (r < net.b_off[l]) {
      const int idx = r - net.w_off[l];
      const int o = idx / net.din[l], k = idx % net.din[l];
      return ((rows.h_off[l] + k + 1) << 16) | (rows.z_off[l] + o);
    }
    return rows.z_off[l] + r - net.b_off[l];
  }
  __device__ T* setup(Shared& sh, Local&, unsigned char* smem) const {
    if (threadIdx.x == 0) {
      sh.net = net_in;
      sh.rows = rows_in;
    }
    T* rest = reinterpret_cast<T*>(smem);
    if constexpr (kRoute == kRouteNarrow) {
      for (int i = threadIdx.x; i < n_w; i += blockDim.x) rest[i] = wg[i];
      rest += n_w;
    }
    int* qt = reinterpret_cast<int*>(rest);
    for (int r = threadIdx.x; r < n_tab; r += blockDim.x)
      qt[r] = quad_code(net_in, rows_in, r);
    return rest + (long(n_tab) * sizeof(int) + sizeof(T) - 1) / sizeof(T);
  }

  __device__ void group_init(const Shared&, T*, int, int, int, int) const {}
  // Sample b's stage with member m of the gsz threads of its group.
  __device__ void group_stage(const Shared& sh, Local&, T t, int, int, T sf,
                              const T* ya, const T* aya, T* ky, T* kay,
                              T* gs, int m, int gsz, unsigned mask) const {
    const Net& net = sh.net;
    const AugRows& rows = sh.rows;
    const T* w = weights();
    const int L = net.n_layers;
    T* const H = gs;
    T* const GZ = H + n_h;
    T* const F = GZ + n_z;
    T* const V = F + D;
    for (int d = m; d < D; d += gsz) {
      T v = ya[d];
      for (int p = 1; p < net.input_power; ++p) v = v * ya[d];
      H[d] = v;
    }
    if (net.time_input && m == 0) H[D] = t;
    __syncwarp(mask);
    // Forward, keeping each layer's input and act'(z).
    for (int l = 0; l < L; ++l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      const T* bias = w + net.b_off[l];
      const int code = (l == L - 1) ? net.act_final : net.act_hidden;
      const T* hin = H + rows.h_off[l];
      T* hout = l + 1 < L ? H + rows.h_off[l + 1] : F;
      for (int o = m; o < dout; o += gsz) {
        const T* row = W + o * din;
        T acc = row[0] * hin[0];
        for (int k = 1; k < din; ++k) acc = acc + row[k] * hin[k];
        const T z = acc + bias[o];
        const T a = activate(code, z);
        GZ[rows.z_off[l] + o] = act_grad(code, z, a);
        hout[o] = a;
      }
      __syncwarp(mask);
    }
    // Backward: the last layer's dz over its act', then each layer's
    // input cotangents (times the layer below's act', which they replace).
    for (int d = m; d < D; d += gsz) {
      ky[d] = (-sf) * F[d];
      GZ[rows.z_off[L - 1] + d] = aya[d] * GZ[rows.z_off[L - 1] + d];
    }
    __syncwarp(mask);
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.din[l], dout = net.dout[l];
      const T* W = w + net.w_off[l];
      const T* dz = GZ + rows.z_off[l];
      for (int k = m; k < din; k += gsz) {
        T acc = W[k] * dz[0];
        for (int o = 1; o < dout; ++o) acc = acc + W[o * din + k] * dz[o];
        if (l > 0) {
          T* gz = GZ + rows.z_off[l - 1] + k;
          *gz = acc * *gz;
        } else {
          V[k] = acc;
        }
      }
      __syncwarp(mask);
    }
    // V holds the layer-0 input cotangent: v_y, then v_t.
    for (int d = m; d < D; d += gsz) {
      T vy = V[d];
      if (net.input_power > 1) {
        T yp = ya[d];
        for (int p = 2; p < net.input_power; ++p) yp = yp * ya[d];
        vy = vy * (T(net.input_power) * yp);
      }
      kay[d] = sf * vy;
    }
  }

  // Quadrature r's term: weight (o, k) dz_o h_k, a bias dz_o, a_t v_t.
  __device__ T group_x(const Shared& sh, int r, const T* gs) const {
    const T* H = gs;
    const T* GZ = H + n_h;
    if (r >= n_w) return GZ[n_z + 2 * D];
    const int c = r < n_tab ? qtab()[r] : quad_code(sh.net, sh.rows, r);
    const int h = c >> 16, z = c & 0xFFFF;
    return h ? GZ[z] * H[h - 1] : GZ[z];
  }
};

template <typename T, int kRoute>
MlpGroupAug<T, kRoute> make_mlp_group_aug(const void* weights, int n_w,
                                          const Net& net, int n_layers,
                                          const int* dims, int D) {
  MlpGroupAug<T, kRoute> aug;
  aug.wg = static_cast<const T*>(weights);
  aug.n_w = n_w;
  aug.ti = net.time_input;
  aug.n_ps = 0;
  aug.n_h = 0;
  aug.n_z = 0;
  for (int l = 0; l < net.n_layers; ++l) {
    aug.n_h += net.din[l];
    aug.n_z += net.dout[l];
  }
  aug.D = D;
  const long n_q = n_w + net.time_input;
  const long cap = long(kLaneGroup) * kLaneQuadRegs;
  aug.n_tab = int(n_q < cap ? n_q : cap);
  aug.walk = lane_group_mlp_walk_values(n_layers, dims, D);
  aug.net_in = net;
  aug.rows_in = make_aug_rows(net);
  return aug;
}

}  // namespace tfd
