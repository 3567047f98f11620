"""PyTorch port: K6 with a group of threads a sample, what the CPU can hold.

K6 (the per-sample adjoint sweep) gives each sample a group of 16 threads
under its own controller, 32 consecutive samples a 512-thread block, and
sums the shared quadratures at the end in the order it had when a sample
was a thread of a 32-thread block: a tree over each block's 32 samples
(now a warp's shuffles, `__shfl_down_sync` by 16, 8, 4, 2, 1), then the
block sums in block order. So its plain version did not change. Held here,
with no card:

- a Python mirror of the kernel's end-of-sweep order (each lane's value
  after each shuffle, lane 0 read) against `cuda_fixed._block_sums(acc,
  PERLANE_THREADS)`, the plain version's, for ragged B in {1, 31, 33,
  4096}, float64 and float32: bitwise;
- the workspace size the launch checks (csrc/lane_group.h, compiled as
  host C++ and called through ctypes) against its Python counterpart
  `cuda_perlane._group_work_size` / `_mlp_walk_values`, and the layout's
  constants against the wrapper's (skipped without a host compiler);
- `perlane_adjoint_plain` on the MLP route (B = 33: two blocks, the last
  one 31 samples idle) and the plan route (a per-sample constant) against
  float64 fingerprints taken from the tree before the change, and against
  the reference in interpret mode with the existing tolerances:
  `pallas_adjoint.mlp_perlane_adjoint_solve` and
  `plan_adjoint.plan_perlane_adjoint_solve`, identical per-sample counts,
  1e-9 relative to each output's largest entry (the port sums each
  sample's quadrature over its accepted steps before it sums over the
  batch, the reference each stage over the batch first).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.ops import pallas_adjoint as JA, pallas_kernels as JK
from tfdiffeq_tpu.ops import plan_adjoint as JPA
from tfdiffeq_tpu_torch.ops import cuda_fixed as PFX, cuda_kernels as PK, \
    cuda_perlane as PL, cuda_plan as CP

from test_torch_plan_adjoint import _check_consts, _ref_sweep_inputs, \
    _sweep_inputs

F64, F32 = torch.float64, torch.float32
CXX = shutil.which("c++") or shutil.which("g++")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tfdiffeq_tpu_torch", "csrc")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------------
# The end-of-sweep order
# ---------------------------------------------------------------------------

def _kernel_block_sums(acc: np.ndarray, samples: int = 32) -> np.ndarray:
    """K6's shared-quadrature sums of acc [B, R], one value at a time in
    acc's dtype: for each block of `samples` consecutive samples and each
    quadrature, a warp's lane j holds sample j's value (0 past B); each
    shuffle step o = 16, 8, 4, 2, 1 gives lane j v[j] + v[j + o] (its own
    value where j + o is past the warp); lane 0 is the block's sum; the
    block sums then add in block order (quadrature_reduce_kernel)."""
    B, R = acc.shape
    zero = acc.dtype.type(0)
    total = None
    for k in range(-(-B // samples)):
        part = []
        for r in range(R):
            v = [acc[b, r] if b < B else zero
                 for b in range(k * samples, (k + 1) * samples)]
            o = samples // 2
            while o:
                v = [v[j] + (v[j + o] if j + o < samples else v[j])
                     for j in range(samples)]
                o //= 2
            part.append(v[0])
        total = part if total is None else [a + b
                                            for a, b in zip(total, part)]
    return np.array(total, dtype=acc.dtype)


@pytest.mark.parametrize("B", [1, 31, 33, 4096])
def test_end_of_sweep_order_is_the_plain_versions(B):
    """The kernel's shuffle tree and block order, written out, is bitwise
    `_block_sums(acc, PERLANE_THREADS)`, the order the plain version
    takes."""
    rng = np.random.RandomState(B)
    R = 3 if B == 4096 else 7
    for dtype, tdt in ((np.float64, F64), (np.float32, F32)):
        acc = (rng.randn(B, R) * 10.0 ** rng.randint(-6, 6, (B, 1))
               ).astype(dtype)
        got = PFX._block_sums(torch.tensor(acc, dtype=tdt),
                              PL.PERLANE_THREADS)
        want = _kernel_block_sums(acc, PL.PERLANE_THREADS)
        assert got.dtype == tdt
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The workspace size: csrc/lane_group.h against ops/cuda_perlane.py
# ---------------------------------------------------------------------------

_SHIM = """#include "lane_group.h"
extern "C" long work_size(int S, int B, int D, long n_q, long walk) {
  return tfd::lane_group_work_size(S, B, D, n_q, walk);
}
extern "C" long mlp_walk(int n_layers, const int* dims, int D) {
  return tfd::lane_group_mlp_walk_values(n_layers, dims, D);
}
extern "C" int quad_regs(long n_q) { return tfd::lane_group_quad_regs(n_q); }
extern "C" int group() { return tfd::kLaneGroup; }
extern "C" int groups() { return tfd::kLaneGroups; }
"""


@pytest.fixture(scope="module")
def lane_group(tmp_path_factory):
    if CXX is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("lane_group")
    cpp, so = d / "lane_group.cpp", d / "lane_group.so"
    cpp.write_text(_SHIM)
    subprocess.run([CXX, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    L, I = ctypes.c_long, ctypes.c_int
    lib.work_size.argtypes = [I, I, I, L, L]
    lib.work_size.restype = L
    lib.mlp_walk.argtypes = [I, ctypes.POINTER(I), I]
    lib.mlp_walk.restype = L
    lib.quad_regs.argtypes = [L]
    return lib


# dims of MLPs: the spiral, a time column, the wide net, deep narrow.
NETS = [((2, 50), (50, 2)), ((3, 16), (16, 2)),
        ((128, 256), (256, 256), (256, 128)),
        ((4, 8), (8, 8), (8, 8), (8, 4))]


@pytest.mark.parametrize("dims", NETS)
def test_work_size_matches_the_launch(lane_group, dims):
    """`_group_work_size` and `_mlp_walk_values` (what the wrappers
    allocate) equal csrc/lane_group.h's (what the launch checks), for the
    MLP routes and for a plan's walk values; the layout's constants are
    the wrapper's."""
    D = dims[-1][1]
    flat = (ctypes.c_int * (2 * len(dims)))(*[x for p in dims for x in p])
    walk = lane_group.mlp_walk(len(dims), flat, D)
    assert walk == PL._mlp_walk_values(dims, D)
    for S in (4, 7, 13):
        for B in (1, 33, 4096):
            for ti in (False, True):
                R = sum(i * o + o for i, o in dims) + int(ti)
                assert lane_group.work_size(S, B, D, R, walk) == \
                    PL._adjoint_work_size(dims, S, B, D, ti)
            for n_q, walk_values in ((5, 17), (300, 0), (253, 111)):
                assert lane_group.work_size(S, B, D, n_q, walk_values) == \
                    PL._group_work_size(S, B, D, n_q, walk_values)
    assert lane_group.group() == PL.PERLANE_GROUP
    assert lane_group.groups() == PL.PERLANE_THREADS
    assert PL.PERLANE_ADJOINT_THREADS == PL.PERLANE_GROUP * PL.PERLANE_THREADS
    # A trial's quadrature terms sit in registers up to 16 a member.
    regs = 16 * PL.PERLANE_GROUP
    for n_q in (1, 253, regs, regs + 1):
        assert bool(lane_group.quad_regs(n_q)) == (n_q <= regs)


# ---------------------------------------------------------------------------
# The plain version: fingerprints and the reference
# ---------------------------------------------------------------------------

def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        for x in (t if isinstance(t, list) else [t]):
            h.update(x.detach().numpy().tobytes())
    return h.hexdigest()[:16]


#: sha256 prefixes of the outputs and the stats of the plain K6 before the
#: change: the MLP route at B = 33 and the plan route with a per-sample
#: constant (`test_torch_plan_adjoint._sweep_inputs('batch_const')`).
FINGERPRINTS = {"mlp": ("2c5bb4500f7e40e4", [2128, 275, 29, 0]),
                "plan": ("df4186a98acc0fc5", [322, 46, 0, 0])}


def _mlp_case():
    rng = np.random.RandomState(1)
    dims = (2, 8, 2)
    W = [(rng.randn(a, b) / np.sqrt(a), rng.randn(b) * 0.05)
         for a, b in zip(dims[:-1], dims[1:])]
    rng = np.random.RandomState(2)
    T, B, D = 5, 33, 2
    ys = rng.randn(T, B, D) * np.linspace(0.2, 2.0, B)[None, :, None]
    g = rng.randn(T, B, D)
    tau = np.array([0.0, 0.4, 0.5, 1.2, 2.0])
    dt0 = np.linspace(0.02, 0.1, B)
    return W, dims, ys, g, tau, dt0


def _plain_runs():
    W, _, ys, g, tau, dt0 = _mlp_case()
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], F64)
    mlp = PL.mlp_perlane_adjoint_solve(
        pw, pd, torch.tensor(ys), torch.tensor(g), torch.tensor(tau),
        torch.tensor(dt0), 1e-6, 1e-8, 1.0, activation="tanh",
        input_power=3)
    plan, packed, ys, g, tau = _sweep_inputs("batch_const")
    pl = CP.plan_perlane_adjoint_solve(
        plan, packed, torch.tensor(ys, dtype=F64), torch.tensor(g, dtype=F64),
        torch.tensor(tau, dtype=F64), 0.05, 1e-7, 1e-9, 1.0)
    return {"mlp": mlp, "plan": pl}


def test_plain_version_keeps_its_bits():
    """The plain K6 on both routes gives bitwise its results before the
    kernel took a group of threads a sample."""
    for name, res in _plain_runs().items():
        *outs, st, _ = res
        assert (_digest(*outs), st.tolist()) == FINGERPRINTS[name], name


def test_plain_mlp_route_matches_reference():
    """The MLP route at B = 33 against the reference's
    `mlp_perlane_adjoint_solve` in interpret mode: identical per-sample
    counts, 1e-9 relative."""
    W, dims, ys, g, tau, dt0 = _mlp_case()
    jw, jd = JK.pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                                 for a, b in W], jnp.float64)
    j_ay0, j_aws, _, j_st, j_lane = JA.mlp_perlane_adjoint_solve(
        jw, jd, jnp.asarray(ys.transpose(0, 2, 1)),
        jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau),
        jnp.asarray(dt0), 1e-6, 1e-8, 1.0, activation="tanh",
        input_power=3, interpret=True)
    ay0, aw, at, st, lane = _plain_runs()["mlp"]
    np.testing.assert_array_equal(lane.numpy(),
                                  np.asarray(j_lane)[:, :lane.shape[1]])
    assert st.tolist() == [int(x) for x in j_st] and st[3].item() == 0
    ref_aw = np.concatenate(
        [np.concatenate([np.asarray(dW)[:b, :a].reshape(-1),
                         np.asarray(db)[:b, 0]])
         for (dW, db), (a, b) in zip(j_aws, zip(dims[:-1], dims[1:]))])
    assert _rel(ay0.numpy(), np.asarray(j_ay0).T) < 1e-9
    assert _rel(aw.numpy(), ref_aw) < 1e-9
    assert float(at) == 0.0


def test_plain_plan_route_matches_reference():
    """The plan route with a per-sample constant against the reference's
    `plan_perlane_adjoint_solve` in interpret mode: identical per-sample
    counts, the constants' cotangents (the per-sample ones too) and ay0
    within 1e-9 relative."""
    plan, _, _, _, _ = _sweep_inputs("batch_const")
    ay0, dconsts, at, stats, lane = _plain_runs()["plan"]
    jplan, jpacked, jys, jg, jtau = _ref_sweep_inputs("batch_const")
    jay0, jdc, jat, _, jlane = JPA.plan_perlane_adjoint_solve(
        jplan, tuple(jpacked), jys, jg, jtau, jnp.full((1, 1), 0.05), 1e-7,
        1e-9, 1.0, interpret=True)
    np.testing.assert_array_equal(lane.numpy(),
                                  np.asarray(jlane)[:, :lane.shape[1]])
    assert _rel(ay0, np.asarray(jay0).T) <= 1e-9
    assert abs(float(at) - float(jat)) <= 1e-9 * max(1.0, abs(float(jat)))
    _check_consts(plan, dconsts, jdc, 1e-9)
    assert int(stats[3]) == 0
