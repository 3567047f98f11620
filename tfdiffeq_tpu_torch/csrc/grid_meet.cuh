// The grid primitives of the kernels that spread one step controller over
// the card: K2 (csrc/rk_solve.cuh), K3 (csrc/rk_adjoint.cuh), K11
// (csrc/rk_vcabm.cuh), fixed_adams' K10 (csrc/rk_adams.cuh), and K13
// (csrc/conv_solve_kernel.cu: a controller a group of blocks). Each
// launches one block of 512 threads per SM, all resident together (a
// cooperative launch, launch_grid), and the blocks meet only where the
// controller needs a sum over its samples:
//
//   grid_sync      the meeting point (an atomic counter in the grid
//                  workspace, zeroed before each launch); group_sync a
//                  group of blocks' own;
//   merge_blocks   a value's per-block partials added in block order;
//   grid_shares    one meeting of the solves (K2, K11, K10): each block's
//                  share of a few sums in, every block's merged sums out
//                  (the adds of merge_blocks, its loads spread over the
//                  block); group_shares the same for a group of blocks (K3
//                  stages a few merges the same way, rk_adjoint_kernel).
//
// Every block merges the same values in the same order with the same
// instructions, read past L1, so every block takes bitwise the same total
// and the same decisions; no atomic sums a value.
#pragma once

namespace tfd {

// The grid's meeting point. Thread 0 of every block publishes the block's
// writes (a device-scope fence), adds one to `count` and waits until every
// block of this meeting has; `target` counts the meetings' arrivals, the
// same in every block. The block's other threads wait at its barriers.
// The launch makes every block resident together (a cooperative launch),
// or this would wait forever; a wait of some seconds (2^28 polls), far
// past any stage, traps, so that a fault fails the launch instead of
// holding the card. group_sync is the same for a group of n blocks that
// meet at their own counter (K13's controller blocks).
__device__ __forceinline__ void group_sync(unsigned long long* count,
                                           unsigned long long& target,
                                           int n) {
  __syncthreads();
  target += n;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1ull);
    for (unsigned polls = 0;
         *static_cast<volatile unsigned long long*>(count) < target;
         ++polls) {
      if (polls == (1u << 28)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_sync(unsigned long long* count,
                                          unsigned long long& target) {
  group_sync(count, target, gridDim.x);
}

// v[0] + v[stride] + ... + v[(nb - 1) stride] in block order, read past L1
// (other blocks wrote them).
template <typename T>
__device__ __forceinline__ T merge_blocks(const T* v, long stride, int nb) {
  T acc = __ldcg(v);
  for (int k = 1; k < nb; ++k) acc = acc + __ldcg(v + k * stride);
  return acc;
}

// A solve's grid workspace: the meetings' counter (16 bytes), then two
// share buffers [2][n_blocks][N] of the working type.
struct GridMeet {
  unsigned long long* count;
  unsigned long long target;
  int meeting;   // meetings so far: the parity picks the share buffer
};

inline long grid_shares_bytes(int n_blocks, int n_values, long item) {
  return 16 + 2L * n_blocks * n_values * item;
}

// One meeting of a group of n blocks of the grid, [first, first + n), at
// their counter `count`. Every thread passes its block's shares `v` (the
// same in every thread: block sums); thread 0 writes them into this
// meeting's buffer, [n_total][N] at `base` (a slot a block of the grid,
// indexed by blockIdx.x). After group_sync the block's threads load the
// group's n shares together (past L1) into `stage` (the block's reduction
// scratch, blockDim.x values, free at a meeting), a chunk of whole blocks
// at a time, and thread 0 adds each value's shares in block order: the
// adds of merge_blocks, one L2 round trip a chunk instead of one a share.
// The merged sums go to `merged` (shared memory), which every thread reads
// on return. The two buffers alternate with the meeting's parity: a block
// writes a buffer again only at the meeting after next, which it reaches
// only after every block of its group has arrived at the next one, and so
// has read this one's shares. So one group_sync a meeting does.
template <typename T, int N>
__device__ __forceinline__ void group_shares(
    unsigned long long* count, unsigned long long& target, int& meeting,
    T* base, int n_total, int first, int n, const T (&v)[N], T* merged,
    T* stage) {
  const int tid = threadIdx.x;
  T* const buf = base + long(meeting & 1) * n_total * N;
  if (tid == 0)
    for (int i = 0; i < N; ++i) buf[long(blockIdx.x) * N + i] = v[i];
  group_sync(count, target, n);
  const T* const src = buf + long(first) * N;
  const int total = n * N;
  const int chunk = blockDim.x / N * N;
  T acc[N];
  for (int c0 = 0; c0 < total; c0 += chunk) {
    const int cnt = total - c0 < chunk ? total - c0 : chunk;
    if (tid < cnt) stage[tid] = __ldcg(src + c0 + tid);
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < cnt; j += N) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          acc[i] = c0 + j == 0 ? stage[j + i] : acc[i] + stage[j + i];
      }
    }
    __syncthreads();
  }
  if (tid == 0)
    for (int i = 0; i < N; ++i) merged[i] = acc[i];
  __syncthreads();
  ++meeting;
}

// One meeting of a solve's grid (K2, K11, fixed_adams' K10): group_shares
// over the whole grid, its buffers after the counter in `gwork`.
template <typename T, int N>
__device__ __forceinline__ void grid_shares(GridMeet& gm, unsigned char* gwork,
                                            const T (&v)[N], T* merged,
                                            T* stage) {
  group_shares<T, N>(gm.count, gm.target, gm.meeting,
                     reinterpret_cast<T*>(gwork + 16), gridDim.x, 0,
                     gridDim.x, v, merged, stage);
}

// Launch `kernel` on n_blocks blocks of `threads` threads with `smem` bytes
// of dynamic shared memory, all resident together (a cooperative launch,
// which refuses a grid that cannot be), after zeroing the meetings' counter
// at the start of `gwork`; or an error. Never fewer blocks than asked.
template <typename K>
cudaError_t launch_grid(K* kernel, int n_blocks, int threads, size_t smem,
                        void** args, void* gwork, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (long(per_sm) * n_sm < n_blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  if ((e = cudaMemsetAsync(gwork, 0, 16, stream)) != cudaSuccess) return e;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(n_blocks), dim3(threads), args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace tfd
