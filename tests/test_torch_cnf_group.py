"""PyTorch port: K7's group walks (csrc/cnf_net.cuh) and K1's group kernel
(csrc/step_kernel.cu), run on the CPU, and the host-side size helpers.

- The sizes the wrappers allocate or route by (csrc/lane_group.h: K3's
  CNF slot and row values, K1's step_samples), compiled as host C++ and
  called through ctypes, against their Python counterparts in
  ops/cuda_kernels.py and ops/cuda_adjoint.py.
- The CUDA sources themselves, compiled as host C++ with a stand-in
  cuda_runtime.h whose __syncthreads is a barrier of host threads: a group
  of gsz threads walks one sample (cnf_eval_group, cnf_aug_eval_group and
  each weight's cnf_weight_x), and K1's kernel runs block by block with
  kStepBlock threads, against the plain versions (_cnf_net_plain,
  _cnf_aug_eval_plain, dopri5_mlp_step_plain), bitwise: the plain
  versions' tanh is swapped for the host libm's (`_libm_tanh`, the one the
  compiled walk calls), so every remaining difference would be an order of
  operations.

The card's bits are held by tests/test_torch_gpu.py and chip_smoke.py.
"""

import ctypes
import ctypes.util
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tfdiffeq_tpu_torch.ops import cuda_adjoint as ca, cuda_kernels as ck

CSRC = pathlib.Path(ck.__file__).resolve().parent.parent / "csrc"
CXX = shutil.which("c++") or shutil.which("g++")

# A stand-in for the CUDA runtime header: the qualifiers empty, threadIdx
# and blockIdx each host thread's own, __syncthreads a barrier of the
# threads that run one block (or one group).
_RUNTIME = r"""#pragma once
#include <condition_variable>
#include <cstring>
#include <math.h>
#include <mutex>
#include <stddef.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__
#define __restrict__
#define __align__(x) __attribute__((aligned(x)))
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct HostBarrier {
  std::mutex mu;
  std::condition_variable cv;
  int n = 1, waiting = 0, acc = 0, res = 0;
  long gen = 0;
  int wait(int v) {
    std::unique_lock<std::mutex> lk(mu);
    acc |= v;
    const long g = gen;
    if (++waiting == n) {
      res = acc;
      acc = 0;
      waiting = 0;
      ++gen;
      cv.notify_all();
      return res;
    }
    cv.wait(lk, [&] { return gen != g; });
    return res;
  }
};
inline HostBarrier host_barrier;
inline void __syncthreads() { host_barrier.wait(0); }
inline int __syncthreads_or(int p) { return host_barrier.wait(p != 0); }
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline double __longlong_as_double(long long i) {
  double f; std::memcpy(&f, &i, 8); return f;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
"""

_DRIVER = r"""#include <thread>
#include <vector>
#include "step_kernel.cu"
#include "cnf_net.cuh"

namespace tfd {
alignas(16) unsigned char smem_raw[1 << 21];
}
using namespace tfd;

template <class Fn>
static void run_threads(int n, Fn fn) {
  host_barrier.n = n;
  std::vector<std::thread> th;
  for (int i = 0; i < n; ++i) th.emplace_back([&, i] {
    threadIdx = dim3(i);
    fn(i);
  });
  for (auto& t : th) t.join();
}

static Net flow(int L, const int* dims, int act) {
  Net net;
  make_net(net, L, dims, dims[2 * L - 1], act, kIdentity, 1, 1);
  return net;
}

template <typename T>
static std::vector<T> transposed(const Net& net, const T* w) {
  int n_w = 0;
  for (int l = 0; l < net.n_layers; ++l)
    n_w += net.din[l] * net.dout[l] + net.dout[l];
  std::vector<T> wt(n_w);
  transpose_weights(net, w, wt.data(), n_w, 0, 1);
  return wt;
}

template <typename T>
static void solve_walk(int L, const int* dims, int act, const T* w, int kt,
                       T t, const T* s, int gsz, T* out) {
  const Net net = flow(L, dims, act);
  const int gw = net_max_width(net), D = dims[2 * L - 1];
  const std::vector<T> wt = transposed(net, w);
  std::vector<T> sl(cnf_solve_slot_values(gw, cnf_hidden(net), D));
  for (int d = 0; d <= D; ++d) sl[d] = s[d];
  const T* F = nullptr;
  run_threads(gsz, [&](int m) {
    const T* f = kt ? cnf_eval_group<true>(net, wt.data(), t, sl.data(), gw,
                                           true, m, gsz)
                    : cnf_eval_group<false>(net, w, t, sl.data(), gw, true, m,
                                            gsz);
    if (m == 0) F = f;
  });
  for (int d = 0; d <= D; ++d) out[d] = F[d];
}

template <typename T>
static void aug_walk(int L, const int* dims, int act, const T* w, int kt,
                     T t, const T* ya, const T* aya, T sf, int gsz, T* ky,
                     T* kay, T* xw, T* vt) {
  const Net net = flow(L, dims, act);
  const CnfRows r = make_cnf_rows(net);
  const int gw = net_max_width(net), D = dims[2 * L - 1];
  const std::vector<T> wt = transposed(net, w);
  std::vector<T> sl(cnf_aug_slot_values(gw, r.n_hid, D));
  std::vector<T> ws(cnf_aug_row_values(r.dz, r.n_z, D));
  const CnfRowsAt<T> at{ws.data(), 1};
  for (int d = 0; d <= D; ++d) {
    sl[d] = ya[d];
    sl[gw + d] = aya[d];
  }
  run_threads(gsz, [&](int m) {
    if (kt)
      cnf_aug_eval_group<true>(net, r, w, wt.data(), t, sl.data(), gw, at,
                               0, ky, kay, sf, true, m, gsz);
    else
      cnf_aug_eval_group<false>(net, r, w, w, t, sl.data(), gw, at, 0, ky,
                                kay, sf, true, m, gsz);
  });
  int q = 0;
  for (int l = 0; l < L; ++l) {
    for (int o = 0; o < net.dout[l]; ++o)
      for (int k = 0; k < net.din[l]; ++k)
        xw[q++] = cnf_weight_x<T>(r, cnf_weight(net, r, l, o, k), at, 0, D);
    for (int o = 0; o < net.dout[l]; ++o)
      xw[q++] = cnf_weight_x<T>(r, cnf_weight(net, r, l, o, -1), at, 0, D);
  }
  *vt = ws[r.vt];
}

template <typename T>
static void step(const T* y, const T* f0, const T* w1, const T* b1,
                 const T* w2, const T* b2, T* y1, T* f1, T* ymid, T* part,
                 int B, int D, int H, int samples, double dt, double rtol,
                 double atol, const double* coeffs) {
  Dopri5Coeffs cw;
  const double* p = coeffs;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) cw.a[i][j] = *p++;
  for (int j = 0; j < 7; ++j) cw.b_sol[j] = *p++;
  for (int j = 0; j < 7; ++j) cw.b_err[j] = *p++;
  for (int j = 0; j < 7; ++j) cw.c_mid[j] = *p++;
  blockDim = dim3(kStepBlock);
  for (int blk = 0; blk < (B + samples - 1) / samples; ++blk)
    run_threads(kStepBlock, [&](int) {
      blockIdx = dim3(blk);
      dopri5_mlp_step_kernel<T>(y, f0, w1, b1, w2, b2, y1, f1, ymid, part,
                                B, D, H, samples, T(dt), T(rtol), T(atol),
                                cw);
    });
}

#define ENTRIES(S, T)                                                        \
  extern "C" void solve_walk_##S(int L, const int* dims, int act,          \
                                 const T* w, int kt, T t, const T* s,      \
                                 int gsz, T* out) {                        \
    solve_walk<T>(L, dims, act, w, kt, t, s, gsz, out);                    \
  }                                                                        \
  extern "C" void aug_walk_##S(int L, const int* dims, int act,            \
                               const T* w, int kt, T t, const T* ya,       \
                               const T* aya, T sf, int gsz, T* ky, T* kay, \
                               T* xw, T* vt) {                             \
    aug_walk<T>(L, dims, act, w, kt, t, ya, aya, sf, gsz, ky, kay, xw, vt);\
  }                                                                        \
  extern "C" void step_##S(const T* y, const T* f0, const T* w1,           \
                           const T* b1, const T* w2, const T* b2, T* y1,   \
                           T* f1, T* ymid, T* part, int B, int D, int H,   \
                           int samples, double dt, double rtol,            \
                           double atol, const double* coeffs) {            \
    step<T>(y, f0, w1, b1, w2, b2, y1, f1, ymid, part, B, D, H, samples,   \
            dt, rtol, atol, coeffs);                                       \
  }
ENTRIES(f32, float)
ENTRIES(f64, double)

extern "C" long cnf_aug_slot_(int gw, int n_hid, int D) {
  return cnf_aug_slot_values(gw, n_hid, D);
}
extern "C" long cnf_aug_rows_(int n_h, int n_z, int D) {
  return cnf_aug_row_values(n_h, n_z, D);
}
extern "C" long step_smem_(int D, int H, int samples) {
  return step_smem_values(D, H, samples);
}
extern "C" int step_samples_(int D, int H, long item, long budget) {
  return step_samples(D, H, item, budget);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/ copied with the launches' <<<...>>> removed (they are never
    called here), compiled with the stand-in runtime into a ctypes
    library."""
    if CXX is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("cnf_group")
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh", ".h"):
            (d / f.name).write_text(
                re.sub(r"<<<[^;]*?>>>", "", f.read_text()))
    (d / "cuda_runtime.h").write_text(_RUNTIME)
    (d / "driver.cpp").write_text(_DRIVER)
    so = d / "libcnf_group.so"
    subprocess.run([CXX, "-O1", "-std=c++17", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-I", str(d), "-o",
                    str(so), str(d / "driver.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for s, T in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        getattr(lib, f"solve_walk_{s}").argtypes = [I, P, I, P, I, T, P, I,
                                                    P]
        getattr(lib, f"aug_walk_{s}").argtypes = [I, P, I, P, I, T, P, P, T,
                                                  I, P, P, P, P]
        getattr(lib, f"step_{s}").argtypes = ([P] * 10 + [I] * 4
                                              + [ctypes.c_double] * 3 + [P])
    for name in ("cnf_aug_slot_", "cnf_aug_rows_", "step_smem_"):
        getattr(lib, name).argtypes = [I, I, I]
        getattr(lib, name).restype = L
    lib.step_samples_.argtypes = [I, I, L, L]
    return lib


def _p(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
_LIBM.tanh.argtypes, _LIBM.tanh.restype = [ctypes.c_double], ctypes.c_double
_LIBM.tanhf.argtypes, _LIBM.tanhf.restype = [ctypes.c_float], ctypes.c_float


def _libm_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh of each element by the host's libm (tanhf in float32), as the
    host-compiled kernels compute it."""
    f = _LIBM.tanhf if x.dtype == torch.float32 else _LIBM.tanh
    return torch.tensor([f(v) for v in x.detach().reshape(-1).tolist()],
                        dtype=x.dtype).view(x.shape)


@pytest.fixture
def libm_tanh(monkeypatch):
    """The plain versions' tanh taken from the host's libm."""
    monkeypatch.setitem(ck._ACTIVATIONS, "tanh", _libm_tanh)
    monkeypatch.setattr(ck.torch, "tanh", _libm_tanh)


# Flows of 1 to 4 layers (the last linear), D = 2 or 3: the passes' last
# product reads the vector the next pass writes first when the depth is
# even, which takes a barrier of its own.
FLOWS = [((3, 2),), ((3, 8), (8, 2)), ((3, 8), (8, 5), (5, 2)),
         ((4, 6), (6, 7), (7, 6), (6, 3))]


def _flow(dims, dtype, seed=0):
    rng = np.random.RandomState(seed)
    W = [(torch.tensor(rng.randn(i, o) * 0.7, dtype=dtype),
          torch.tensor(rng.randn(o) * 0.3, dtype=dtype)) for i, o in dims]
    return ck.pack_mlp_weights(W, dtype)[0]


def _check(a, b):
    assert torch.equal(a, b), (a, b)


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gsz", [1, 2, 4, 16])
@pytest.mark.parametrize("dims", FLOWS)
def test_cnf_eval_group_matches_plain(host, libm_tanh, dims, gsz, dtype,
                                      act):
    """K2's walk of one sample with gsz members, both weight layouts,
    against _cnf_net_plain."""
    packed = _flow(dims, dtype)
    D = dims[-1][1]
    s = torch.tensor(np.random.RandomState(1).randn(3, D + 1),
                     dtype=dtype)
    t = 0.375
    ref = ck._cnf_net_plain(packed, dims, act)(
        torch.tensor(t, dtype=dtype), s)
    dims_c = ck._dims_arg(dims)
    fn = getattr(host, "solve_walk_" + ("f32" if dtype == torch.float32
                                        else "f64"))
    for kt in (0, 1):
        for b in range(s.shape[0]):
            out = torch.empty(D + 1, dtype=dtype)
            sb = s[b].contiguous()
            fn(len(dims), dims_c, ck._ACT_CODES[act], _p(packed), kt, t,
               _p(sb), gsz, _p(out))
            _check(out, ref[b])


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gsz", [1, 2, 4, 16])
@pytest.mark.parametrize("dims", FLOWS)
def test_cnf_aug_eval_group_matches_plain(host, libm_tanh, dims, gsz,
                                          dtype, act):
    """K3's walk of one sample with gsz members and each weight's cotangent
    from its rows, against _cnf_aug_eval_plain: ky = -sf F, kay = sf v_y,
    the per-sample parameter cotangents and v_t."""
    packed = _flow(dims, dtype, seed=2)
    D = dims[-1][1]
    rng = np.random.RandomState(3)
    y = torch.tensor(rng.randn(3, D + 1), dtype=dtype)
    ay = torch.tensor(rng.randn(3, D + 1), dtype=dtype)
    t, sf = -0.625, -1.0
    F, vy, xw, vt = ca._cnf_aug_eval_plain(packed, dims, act)(
        torch.tensor(t, dtype=dtype), y, ay)
    dims_c = ck._dims_arg(dims)
    fn = getattr(host, "aug_walk_" + ("f32" if dtype == torch.float32
                                      else "f64"))
    n_w = packed.shape[0]
    for kt in (0, 1):
        for b in range(y.shape[0]):
            ky = torch.empty(D + 1, dtype=dtype)
            kay = torch.empty(D + 1, dtype=dtype)
            got_xw = torch.empty(n_w, dtype=dtype)
            got_vt = torch.empty(1, dtype=dtype)
            yb, ab = y[b].contiguous(), ay[b].contiguous()
            fn(len(dims), dims_c, ck._ACT_CODES[act], _p(packed), kt, t,
               _p(yb), _p(ab), sf, gsz, _p(ky), _p(kay), _p(got_xw),
               _p(got_vt))
            _check(ky, (-sf) * F[b])
            _check(kay, sf * vy[b])
            _check(got_xw, xw[b])
            _check(got_vt[0], vt[b])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,D,H", [(1, 2, 50), (33, 2, 50), (70, 5, 9),
                                   (40, 16, 24)])
def test_step_group_kernel_matches_plain(host, libm_tanh, B, D, H,
                                         dtype):
    """K1's kernel, block by block with its kStepBlock threads, against
    dopri5_mlp_step_plain: the step's values, one partial a block of
    step_samples samples, and the ratio from them."""
    rng = np.random.RandomState(B + D)
    p = {"w1": rng.randn(D, H) * 0.3, "b1": rng.randn(H) * 0.1,
         "w2": rng.randn(H, D) * 0.3, "b2": rng.randn(D) * 0.1}
    p = {k: torch.tensor(v, dtype=dtype) for k, v in p.items()}
    y = torch.tensor(rng.randn(B, D), dtype=dtype)
    f0 = ck._mlp_tanh_plain(p, y)
    dt, rtol, atol = 0.2, 1e-6, 1e-8
    ref = ck.dopri5_mlp_step_plain(p, y, f0, dt, rtol, atol)
    spb = ck.step_samples(D, H, y.element_size())
    n_blocks = -(-B // spb)
    out = [torch.empty_like(y) for _ in range(3)]
    part = torch.empty(n_blocks, dtype=dtype)
    coeffs = [x for row in ck.DOPRI5.a for x in row + (0.0,) * (6 - len(row))]
    coeffs += (list(ck.DOPRI5.b_sol) + list(ck.DOPRI5.b_err)
               + list(ck.DOPRI5.c_mid))
    cw = (ctypes.c_double * len(coeffs))(*coeffs)
    fn = getattr(host, "step_" + ("f32" if dtype == torch.float32 else
                                  "f64"))
    fn(*(_p(x) for x in (y, f0, p["w1"], p["b1"], p["w2"], p["b2"], *out,
                         part)), B, D, H, spb, dt, rtol, atol, cw)
    ratio = torch.sqrt(torch.sum(part) / ck._count(y))
    for a, b in zip((out[0], out[1], ratio, out[2]), ref):
        _check(a, b)


@pytest.mark.parametrize("item", [4, 8])
def test_layout_helpers_match_the_headers(host, item):
    """lane_group.h's sizes against the Python counterparts the wrappers
    allocate and route by: K3's CNF slot (the narrow route's share) and
    rows (the workspace), K1's shared memory and samples a block (the
    partial sums' count)."""
    for dims in [((3, 32), (32, 32), (32, 2)), ((3, 64), (64, 64), (64, 2)),
                 ((3, 128), (128, 128), (128, 2)), ((5, 512), (512, 4)),
                 ((2, 50), (50, 2))]:
        gw, n_hid, D = ck._net_widths(dims)
        n_h = sum(i for i, _ in dims)
        n_z = sum(o for _, o in dims)
        assert host.cnf_aug_slot_(gw, n_hid, D) == \
            ca.cnf_aug_slot_values(dims)
        assert host.cnf_aug_rows_(n_h, n_z, D) == \
            ca.cnf_aug_row_values(dims)
    for D in (1, 2, 5, 16):
        for H in (1, 50, 300, 2000, 7000):
            assert host.step_smem_(D, H, 32) == ck._step_smem_values(D, H, 32)
            assert host.step_samples_(D, H, item, ck.MAX_WEIGHT_BYTES) == \
                ck.step_samples(D, H, item)
    assert ck.step_samples(2, 50, 4) == ck.STEP_SAMPLES
