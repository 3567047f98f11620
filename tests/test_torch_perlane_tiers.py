"""PyTorch port: K4's tiers in the per-sample solve K5 (its tile engine) on
the MLP route, against the JAX package and against solo solves.

- `fast.solve_mlp_spec(MLPSpec(matmul='mxu', dot_precision='mixed'),
  per_sample=True)` against the reference's in interpret mode on the net
  D = 32 -> 144 -> 144 -> 32, B = 8: trajectories within 1e-5 relative to
  their largest entry and each sample's accepted and rejected counts within
  one, at rtol 1e-5 (why: tests/test_torch_plan_tiers.py).
- A batch whose samples need different numbers of attempts (states
  scaled by logspace(0, 2, B); a captured plan's dynamics scaled by it too,
  bench.py's per-lane battery, for a threefold spread): each sample's
  trajectory and counts equal its solo solve's, through the MLP route and
  through the plan's tile route.
- The tile engine itself, `csrc/rk_perlane.cuh rk_perlane_tile_kernel` with
  the MLP tile route (`csrc/perlane_solve_kernel.cu MlpTileRhs`) in float64,
  compiled as host C++ with the stand-in runtime of
  tests/test_torch_cnf_group.py (its __syncthreads a barrier of the block's
  host threads, its shared arrays the block's), run block by block with 256
  threads on the battery: every sample's trajectory, counts and status
  bit for bit the plain version's (`mlp_solve_perlane_plain` with tiers,
  its controller's exp, log and sqrt by the host's libm, as the
  host-compiled kernel's: PyTorch's CPU versions may differ in the last
  bit). About half the samples run out of steps while the others
  finish at their own attempts: the masked rows of finished samples change
  nothing of the others. relu, not tanh, keeps libm out of the network.
"""

import ctypes
import ctypes.util
import math
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu_torch import convert, fast as PF
from tfdiffeq_tpu_torch.ops import cuda_kernels as PK
from tfdiffeq_tpu_torch.ops import cuda_perlane as PL
from tfdiffeq_tpu_torch.ops.tableaus import TABLEAUS_BY_NAME

from test_torch_cnf_group import CSRC, _RUNTIME

D, H, B = 32, 144, 8
F32, F64 = torch.float32, torch.float64
T = np.linspace(0.0, 2.0, 5)


def _weights(seed=0, bias=0.05, d=D, h=H):
    rng = np.random.RandomState(seed)
    dims = (d, h, h, d)
    return [(rng.randn(dims[i], dims[i + 1]) / np.sqrt(dims[i]),
             rng.randn(dims[i + 1]) * bias) for i in range(3)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_mlp_per_sample_mixed_matches_reference():
    W = _weights()
    y0 = np.random.RandomState(1).randn(B, D) * 0.5
    kw = dict(rtol=1e-5, atol=1e-5, first_step=0.01, per_sample=True)
    ref = JF.solve_mlp_spec(
        JF.MLPSpec(activation="tanh", matmul="mxu", dot_precision="mixed"),
        [(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
         for a, b in W], jnp.asarray(y0, jnp.float32),
        jnp.asarray(T, jnp.float32), interpret=True, **kw)
    got = PF.solve_mlp_spec(
        PF.MLPSpec(activation="tanh", matmul="mxu", dot_precision="mixed"),
        convert.weights_from_jax(W), torch.tensor(y0, dtype=F32),
        torch.tensor(T, dtype=F32), **kw)
    assert int(got.stats.status) == 0 and int(ref.stats.status) == 0
    for a, b in zip(got.lane_stats[1:3], ref.lane_stats[1:3]):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= 1
    assert _rel(got.ys.numpy(), ref.ys) < 1e-5


def _battery(n, d, dtype):
    """States scaled by logspace(0, 2, n): the larger ones take more
    attempts."""
    sc = np.logspace(0.0, 2.0, n)
    y0 = np.random.RandomState(2).randn(n, d) * 0.5 * sc[:, None]
    return torch.tensor(y0, dtype=dtype), sc


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_per_sample_tiers_match_solo_solves(dtype):
    """Each sample of a mixed-stiffness batch takes the steps its solo
    solve takes, on the MLP route and on a plan's tile route (the plan
    scales its dynamics by a per-sample constant)."""
    W = [(torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype))
         for a, b in _weights(d=8, h=24)]
    y0, sc = _battery(6, 8, dtype)
    t = torch.tensor(T, dtype=dtype)
    spec = PF.MLPSpec(activation="tanh", matmul="mxu", dot_precision="mixed")
    kw = dict(rtol=1e-5, atol=1e-5, per_sample=True)
    scale = torch.tensor(sc, dtype=dtype)[:, None]

    def plan_dyn(s):
        def f(tt, y):
            return s * PF.mlp_apply(PF.MLPSpec(activation="tanh"), W, y, tt)
        return f

    warr, dims = PK.pack_mlp_weights(W, dtype)
    tiers = PK.layer_tiers(dims, spec.matmul, spec.dot_precision)

    def mlp(y):
        # K5 on the MLP route from f0 by the plain net (its sums in input
        # order, so a sample's f0 does not depend on the batch around it).
        f0 = PK._net_plain(warr, dims, "tanh", "identity", 1, False)(t[0], y)
        return PL.mlp_solve_perlane(warr, dims, y, t, 0.01, 1e-5, 1e-5, 1.0,
                                    f0=f0, tiers=tiers)

    out, _, lane = mlp(y0)
    pbatch = PF.solve_fused(plan_dyn(scale), y0, t, dot_precision="mixed",
                            **kw)
    assert int(lane[1].max()) > int(lane[1].min())
    assert int(pbatch.lane_stats.n_accepted.max()) >= \
        3 * int(pbatch.lane_stats.n_accepted.min())
    for b in range(y0.shape[0]):
        solo, _, slane = mlp(y0[b:b + 1])
        assert torch.equal(out[:, b:b + 1], solo)
        assert torch.equal(lane[:, b:b + 1], slane)
        psolo = PF.solve_fused(plan_dyn(scale[b:b + 1]), y0[b:b + 1], t,
                               dot_precision="mixed", **kw)
        assert torch.equal(pbatch.ys[:, b:b + 1], psolo.ys)
        assert [int(x[b]) for x in pbatch.lane_stats] == \
            [int(x[0]) for x in psolo.lane_stats]


# ---------------------------------------------------------------------------
# K5's tile engine as host C++
# ---------------------------------------------------------------------------

CXX = shutil.which("c++") or shutil.which("g++")

# The stand-in runtime with shared arrays a block's own (static: the block's
# host threads share them, and blocks run one after another), atomics, and
# bf16 conversions rounding to nearest even as the card's do.
_TILE_RUNTIME = _RUNTIME.replace("#define __shared__\n",
                                 "#define __shared__ static\n") + r"""
#include <stdint.h>
struct float2 { float x, y; };
inline std::mutex host_atomic_mu;
inline int atomicAdd(int* p, int v) {
  std::lock_guard<std::mutex> g(host_atomic_mu);
  const int o = *p;
  *p = o + v;
  return o;
}
inline int atomicMax(int* p, int v) {
  std::lock_guard<std::mutex> g(host_atomic_mu);
  const int o = *p;
  if (v > o) *p = v;
  return o;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned long __cvta_generic_to_shared(const void*) { return 0; }
"""
_BF16 = r"""#pragma once
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) {
    if (u & 0x7fffffu) u |= 0x400000u;
  } else {
    u += 0x7fffu + ((u >> 16) & 1u);
  }
  __nv_bfloat16 r;
  r.x = (unsigned short)(u >> 16);
  return r;
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const unsigned u = unsigned(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
"""
_TILE_DRIVER = r"""#include <thread>
#include <vector>
#include "perlane_solve_kernel.cu"

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

// K5's tile route in float64, block by block: the weight pack, then each
// block's kTileThreads threads.
extern "C" int tile_solve_f64(
    const double* tau, const double* y0, const double* f0,
    const double* dt0, const double* w, double* out, int* lane, int* stats,
    double* work, long work_size, unsigned char* bwork, long bbytes,
    int T_out, int B, int D, int n_layers, const int* dims, int act_h,
    int act_f, const int* tiers, double rtol, double atol, double dt_min,
    int max_steps, int stages, int order, int fsal, const double* c,
    const double* a, const double* bs, const double* be, const double* cm) {
  Net net;
  if (make_net(net, n_layers, dims, D, act_h, act_f, 1, 0) < 0) return 1;
  const long n_w16 = set_tiers(net, tiers);
  const long rows = (B + kTileRows - 1) / kTileRows * kTileRows;
  if (bbytes < batch_work_bytes(net, n_w16, rows, sizeof(double)) ||
      work_size < perlane_tile_values<double>(stages, B, D))
    return 2;
  MlpTileRhs<double> rhs;
  rhs.wg = w;
  rhs.net_in = net;
  rhs.bb = batch_bufs<double>(bwork, net, n_w16, rows,
                              kTileThreads / kWarpSize, kTileRows);
  blockDim = dim3(1);
  gridDim = dim3(1);
  threadIdx = dim3(0);
  blockIdx = dim3(0);
  tier_pack_kernel<double>(w, net,
                           reinterpret_cast<__nv_bfloat16*>(bwork));
  const Tableau<double> tab =
      make_tableau<double>(stages, order, fsal, c, a, bs, be, cm);
  const PerlaneScalars<double> sc = make_perlane_scalars<double>(
      rtol, atol, dt_min, 1.0, 0.9, 10.0, 0.2, max_steps, 1, T_out, B, D);
  std::memset(stats, 0, 4 * sizeof(int));
  blockDim = dim3(kTileThreads);
  const int blocks = (B + kTileRows - 1) / kTileRows;
  gridDim = dim3(blocks);
  for (int blk = 0; blk < blocks; ++blk)
    run_threads(kTileThreads, [&](int) {
      blockIdx = dim3(blk);
      rk_perlane_tile_kernel<double, MlpTileRhs<double>>(
          tau, y0, f0, dt0, out, lane, stats, work, rhs, tab, sc);
    });
  return 0;
}

extern "C" void tile_eval_f64(const double* w, const double* x, double* f,
                              unsigned char* bwork, int B, int D,
                              int n_layers, const int* dims, int act_h,
                              int act_f, const int* tiers) {
  Net net;
  make_net(net, n_layers, dims, D, act_h, act_f, 1, 0);
  const long n_w16 = set_tiers(net, tiers);
  const long rows = (B + kTileRows - 1) / kTileRows * kTileRows;
  MlpTileRhs<double> rhs;
  rhs.wg = w;
  rhs.net_in = net;
  rhs.bb = batch_bufs<double>(bwork, net, n_w16, rows,
                              kTileThreads / kWarpSize, kTileRows);
  blockDim = dim3(1);
  threadIdx = dim3(0);
  blockIdx = dim3(0);
  tier_pack_kernel<double>(w, net, reinterpret_cast<__nv_bfloat16*>(bwork));
  blockDim = dim3(kTileThreads);
  for (int r0 = 0; r0 < B; r0 += kTileRows)
    run_threads(kTileThreads, [&](int) {
      static MlpTileRhs<double>::Shared sh;
      MlpTileRhs<double>::Local lo;
      rhs.setup(sh, lo, nullptr, r0, kTileRows);
      __syncthreads();
      for (int e = threadIdx.x; e < kTileRows * D; e += blockDim.x) {
        const int b = r0 + e / D, d = e % D;
        if (b < B) rhs.put_elem(sh, lo, b, d, 0.0, x[long(b) * D + d]);
      }
      __syncthreads();
      const double* fo = rhs.eval_batch(sh, lo, r0, kTileRows);
      for (int e = threadIdx.x; e < kTileRows * D; e += blockDim.x) {
        const int b = r0 + e / D, d = e % D;
        if (b < B) f[long(b) * D + d] = fo[long(b) * rhs.ld() + d];
      }
    });
}
"""


@pytest.fixture(scope="module")
def tile_host(tmp_path_factory):
    """csrc/ copied with the launches' <<<...>>> and the PTX asm removed
    (the float64 route runs neither), `extern __shared__` kept extern,
    compiled with the stand-in runtime into a ctypes library."""
    if CXX is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("tile_host")
    for f in CSRC.iterdir():
        if f.suffix in (".cu", ".cuh", ".h"):
            src = re.sub(r"<<<[^;]*?>>>", "", f.read_text())
            src = re.sub(r"asm volatile\(.*?\);(?=\n)", "(void)0;", src,
                         flags=re.S)
            src = src.replace("extern __shared__", "extern")
            (d / f.name).write_text(src)
    (d / "cuda_runtime.h").write_text(_TILE_RUNTIME)
    (d / "cuda_bf16.h").write_text(_BF16)
    (d / "driver.cpp").write_text(_TILE_DRIVER)
    so = d / "libtile.so"
    subprocess.run([CXX, "-O1", "-std=c++17", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-I", str(d), "-o",
                    str(so), str(d / "driver.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    P, I, L, Dd = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                   ctypes.c_double)
    lib.tile_solve_f64.argtypes = ([P] * 8 + [P, L, P, L] + [I] * 4 + [P]
                                   + [I, I, P] + [Dd] * 3 + [I] * 4
                                   + [P] * 5)
    lib.tile_solve_f64.restype = I
    return lib


_LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
for _fn in ("exp", "log"):
    getattr(_LIBM, _fn).argtypes = [ctypes.c_double]
    getattr(_LIBM, _fn).restype = ctypes.c_double


def _libm(fn, x: torch.Tensor) -> torch.Tensor:
    f = getattr(_LIBM, fn)
    return torch.tensor([f(v) for v in x.reshape(-1).tolist()],
                        dtype=x.dtype).view(x.shape)


def _libm_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of each element (PyTorch's CPU
    sqrt may differ in the last bit; the card's and the host's do not)."""
    return torch.tensor([math.sqrt(v) for v in x.reshape(-1).tolist()],
                        dtype=x.dtype).view(x.shape)


def _libm_controller(ratio, finite, accept, safety, ifactor, dfactor,
                     order):
    """cuda_kernels._controller_factor with the host libm's exp and log,
    as the host-compiled kernel computes them."""
    full = lambda v: torch.full_like(ratio, v)                  # noqa: E731
    r = torch.maximum(torch.where(finite, ratio, full(2.0 ** 20)),
                      full(1e-38))
    fac = safety * _libm("exp", (-1.0 / float(order)) * _libm("log", r))
    fac = torch.where(ratio <= 0.0, full(ifactor), fac)
    lo = torch.where(accept, full(1.0), full(dfactor))
    hi = torch.where(accept, full(ifactor), full(1.0))
    return torch.minimum(torch.maximum(fac, lo), hi)


@pytest.mark.parametrize("method,tier,tol", [("dopri5", "mixed", 1e-6),
                                             ("adaptive_heun", "bf16", 1e-3)])
def test_tile_engine_matches_plain(tile_host, monkeypatch, method, tier,
                                   tol):
    """dopri5 (FSAL) and adaptive_heun (the end derivative a tile
    evaluation of its own, for the accepting samples only)."""
    d, h, n = 8, 24, 20
    Wn = _weights(seed=3, d=d, h=h)
    W = [(torch.tensor(a, dtype=F64), torch.tensor(b, dtype=F64))
         for a, b in Wn]
    warr, dims = PK.pack_mlp_weights(W, F64)
    sc = np.logspace(0.0, 2.0, n)
    y0 = torch.tensor(np.random.RandomState(4).randn(n, d) * sc[:, None],
                      dtype=F64)
    tau = torch.tensor(T, dtype=F64)
    tiers = (tier,) * 3
    net = dict(activation="relu", final_activation="identity")
    f0 = PK._net_plain(warr, dims, "relu", "identity", 1, False,
                       tiers)(tau[0], y0)
    dt0 = torch.full((n,), 0.01, dtype=F64)
    tab = TABLEAUS_BY_NAME[method]
    monkeypatch.setattr(PL, "_controller_factor", _libm_controller)
    monkeypatch.setattr(torch, "sqrt", _libm_sqrt)
    run = lambda cap: PL.mlp_solve_perlane_plain(                # noqa
        warr, dims, y0, tau, dt0, tol, tol, 1.0, f0=f0, method=method,
        max_steps=cap, tiers=tiers, **net)
    # A step budget that the samples of the largest need run out of
    # (status 1) while the others finish at their own attempts.
    need = (lambda f: f[1] + f[2])(run(1000)[2])
    cap = int(need.median()) + 1
    want, wst, wlane = run(cap)
    assert set(wlane[3].tolist()) == {0, 1}
    out = torch.zeros_like(want)
    lane = torch.zeros((4, n), dtype=torch.int32)
    stats = torch.zeros(4, dtype=torch.int32)
    work = torch.zeros((tab.stages + 6) * n * d, dtype=F64)
    bwork = torch.zeros(PK._tier_work_bytes(dims, 32, 8), dtype=torch.uint8)
    tau_h, dt_min, _, _ = PK._solve_setup(tau, 0.0, F64)
    c, a, bs, be = PK._tableau_args(tab)
    cm = (None if tab.c_mid is None
          else (ctypes.c_double * tab.stages)(*tab.c_mid))
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())               # noqa: E731
    err = tile_host.tile_solve_f64(
        ptr(tau), ptr(y0), ptr(f0), ptr(dt0), ptr(warr), ptr(out),
        ptr(lane), ptr(stats), ptr(work), work.numel(), ptr(bwork),
        bwork.numel(), len(T), n, d, 3, PK._dims_arg(dims),
        PK._ACT_CODES["relu"], PK._ACT_CODES["identity"],
        PK._tiers_arg(tiers), tol, tol, float(dt_min), cap, tab.stages,
        tab.order, int(tab.fsal), c, a, bs, be, cm)
    assert err == 0
    assert torch.equal(lane, wlane) and torch.equal(stats, wst)
    assert torch.equal(out, want)
