// K4 on its own: one batch-wide evaluation of an MLP with dot-precision
// tiers, the layer products that K2 and K8 run on their batch route
// (csrc/dot_tiers.cuh), and nothing else of a solve.
//
// The reference has no launch of K4 alone (pallas_kernels.py:361-439 runs
// inside K2, K5 and K8), and neither do the solves here. This entry point
// exists so that K4 can be held against its plain version
// (ops/cuda_kernels.py:_net_plain) and timed without a solve around it:
// ops/cuda_kernels.py:tier_net launches it.
//
// Design. K8's batch-route block: kTierNetThreads threads own kTierNetRows
// samples, write their layer-0 inputs to the workspace, meet, and evaluate
// the net (batch_mlp_eval: in float32 one 16-row tile in shared memory
// through every layer); the blocks are independent. The weights are packed
// to bf16 by tier_pack_kernel first, a launch of its own, as in the solves;
// `mode` runs both (0), the pack alone (1) or the evaluation alone on a
// workspace already packed (2), so that each can be timed.
#include "dot_tiers.cuh"

namespace tfd {

constexpr int kTierNetThreads = 256;
constexpr int kTierNetRows = 16;

template <typename T>
__global__ void __launch_bounds__(kTierNetThreads)
    tier_net_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, BatchBufs<T> bb, Net net_in, T t,
                    int B, int D) {
  __shared__ Net net;
  if (threadIdx.x == 0) net = net_in;
  const int row0 = blockIdx.x * kTierNetRows;
  batch_clear(bb, row0, kTierNetRows);
  __syncthreads();
  const int b = row0 + int(threadIdx.x);
  if (threadIdx.x < kTierNetRows && b < B)
    batch_put(bb, net, b, t, [&](int d) { return x[long(b) * D + d]; });
  __syncthreads();
  const T* fo = batch_mlp_eval(net, w, bb, row0, kTierNetRows);
  for (int e = threadIdx.x; e < kTierNetRows * D; e += blockDim.x) {
    const int s = row0 + e / D, d = e % D;
    if (s < B) out[long(s) * D + d] = fo[long(s) * bb.ld + d];
  }
}

template <typename T>
int launch_tier_net(const void* x, const void* weights, void* out, int B,
                    int D, int n_layers, const int* dims, int act_hidden,
                    int act_final, int input_power, int time_input, double t,
                    const int* tiers, void* batch_work, long batch_bytes,
                    int mode, void* stream) {
  if (B < 1 || D < 1 || D + time_input > kMaxWidth || input_power < 1 ||
      mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Net net;
  if (make_net(net, n_layers, dims, D, act_hidden, act_final, input_power,
               time_input) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_w16 = set_tiers(net, tiers);
  const long rows = long((B + kTierNetRows - 1) / kTierNetRows) *
                    kTierNetRows;
  if (n_w16 < 0 || !batch_work ||
      batch_bytes < batch_work_bytes(net, n_w16, rows, sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BatchBufs<T> bb = batch_bufs<T>(batch_work, net, n_w16, rows,
                                        kTierNetThreads / kWarpSize,
                                        kTierNetRows);
  if (bb.tile.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (mode != 2) {
    tier_pack_kernel<T><<<64, 256, 0, st>>>(
        static_cast<const T*>(weights), net,
        reinterpret_cast<__nv_bfloat16*>(batch_work));
    e = cudaGetLastError();
    if (e != cudaSuccess || mode == 1) return static_cast<int>(e);
  }
  const size_t smem = batch_smem(bb);
  auto kernel = tier_net_kernel<T>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<int(rows / kTierNetRows), kTierNetThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(weights),
      static_cast<T*>(out), bb, net, T(t), B, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfd

#define TFD_TIER_NET_ENTRY(NAME, TYPE)                                       \
  extern "C" int NAME(const void* x, const void* weights, void* out, int B, \
                      int D, int n_layers, const int* dims, int act_hidden, \
                      int act_final, int input_power, int time_input,       \
                      double t, const int* tiers, void* batch_work,         \
                      long batch_bytes, int mode, void* stream) {           \
    return tfd::launch_tier_net<TYPE>(                                       \
        x, weights, out, B, D, n_layers, dims, act_hidden, act_final,       \
        input_power, time_input, t, tiers, batch_work, batch_bytes, mode,   \
        stream);                                                             \
  }

TFD_TIER_NET_ENTRY(tfd_tier_net_f32, float)
TFD_TIER_NET_ENTRY(tfd_tier_net_f64, double)
