"""PyTorch port: K9 with a group of threads a sample, what the CPU can hold.

K9 (the fixed-grid adjoint sweep) takes K6's layout: a group of 16 threads
a sample, 32 consecutive samples a 512-thread block. It sums the shared
quadratures at the end in the order it had when a sample was a thread of a
64-thread block: a second launch takes, for each quadrature, a warp over
each 64 consecutive samples (lane j adds samples j and j + 32, the first
level of block_sum's tree, then the shuffles by 16, 8, 4, 2, 1), and adds
the trees in order. So its plain version did not change. Held here, with
no card:

- a Python mirror of that order (each lane's value after each step, lane
  0 read) against `cuda_fixed._block_sums(acc, FIXED_TREE)`, the plain
  version's, for ragged B in {1, 33, 65, 300, 4096}, float64 and float32:
  bitwise;
- the workspace the launch checks (csrc/lane_group.h, compiled as host C++
  and called through ctypes) against its Python counterpart
  `cuda_fixed._fixed_work_size` / `_adjoint_work_size`, and the layout's
  constants against the wrapper's (skipped without a host compiler);
- `mlp_adjoint_solve_fixed_plain` (a narrow net at B = 100 and 70, a wide
  one past 128) and `cuda_plan.plan_adjoint_solve_fixed` (a per-sample
  constant; a plan that reads t) against float64 fingerprints taken from
  the tree before the change;
- the same plain versions against the reference in interpret mode
  (`pallas_fixed.mlp_adjoint_solve_fixed` and `plan_adjoint_solve_fixed`,
  pack=1), with the tolerances of tests/test_torch_fixed_fused.py and
  tests/test_torch_plan_adjoint.py: identical stats, 1e-10 (MLP) and 1e-9
  (plan) relative to each output's largest entry. The port sums each
  sample's quadrature over its steps before it sums over the batch, the
  reference each stage over the batch first, so the two agree to roundoff
  and not to the bit.
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

from tfdiffeq_tpu.ops import pallas_fixed as JPF
from tfdiffeq_tpu.ops.pallas_kernels import pad_mlp_weights
from tfdiffeq_tpu_torch.ops import cuda_fixed as PFX, cuda_kernels as PK, \
    cuda_plan as CP

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

def _kernel_tree_sums(acc: np.ndarray, tree: int = 64) -> np.ndarray:
    """K9's shared-quadrature sums of acc [B, R], one value at a time in
    acc's dtype (csrc/rk_adjoint.cuh fixed_tree_reduce_kernel): for each
    run of `tree` consecutive samples and each quadrature, lane j of a warp
    holds sample j's value plus sample j + 32's (0 past B); each shuffle
    step o = 16, 8, 4, 2, 1 gives lane j v[j] + v[j + o] (its own value
    where j + o is past the warp); lane 0 is the run's sum; the run sums
    then add in order."""
    B, R = acc.shape
    zero = acc.dtype.type(0)
    warp = tree // 2
    at = lambda b, r: acc[b, r] if b < B else zero
    total = None
    for k in range(-(-B // tree)):
        part = []
        for r in range(R):
            v = [at(k * tree + j, r) + at(k * tree + warp + j, r)
                 for j in range(warp)]
            o = warp // 2
            while o:
                v = [v[j] + (v[j + o] if j + o < warp else v[j])
                     for j in range(warp)]
                o //= 2
            part.append(v[0])
        total = part if total is None else [a + b
                                            for a, b in zip(total, part)]
    return np.array(total, dtype=acc.dtype)


@pytest.mark.parametrize("B", [1, 33, 65, 300, 4096])
def test_end_of_sweep_order_is_the_plain_versions(B):
    """The kernel's trees and their order, written out, are bitwise
    `_block_sums(acc, FIXED_TREE)`, the order the plain version takes."""
    rng = np.random.RandomState(B)
    R = 3 if B == 4096 else 7
    for dtype, tdt in ((np.float64, F64), (np.float32, F32)):
        acc = (rng.randn(B, R) * 10.0 ** rng.randint(-6, 6, (B, 1))
               ).astype(dtype)
        got = PFX._block_sums(torch.tensor(acc, dtype=tdt), PFX.FIXED_TREE)
        want = _kernel_tree_sums(acc, PFX.FIXED_TREE)
        assert got.dtype == tdt
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The workspace: csrc/lane_group.h against ops/cuda_fixed.py
# ---------------------------------------------------------------------------

_SHIM = """#include "lane_group.h"
extern "C" long work_size(int S, int B, int D, long n_q, long walk, long R) {
  return tfd::fixed_group_work_size(S, B, D, n_q, walk, R);
}
extern "C" long mlp_walk(int n_layers, const int* dims, int D) {
  return tfd::lane_group_mlp_walk_values(n_layers, dims, D);
}
extern "C" int quad_regs(long n_q) { return tfd::lane_group_quad_regs(n_q); }
extern "C" int group() { return tfd::kLaneGroup; }
extern "C" int groups() { return tfd::kLaneGroups; }
extern "C" int tree() { return tfd::kFixedTree; }
"""


@pytest.fixture(scope="module")
def lane_group(tmp_path_factory):
    if CXX is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("fixed_group")
    cpp, so = d / "fixed_group.cpp", d / "fixed_group.so"
    cpp.write_text(_SHIM)
    subprocess.run([CXX, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    L, I = ctypes.c_long, ctypes.c_int
    lib.work_size.argtypes = [I, I, I, L, L, L]
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
    """`_adjoint_work_size` and `_fixed_work_size` (what the wrappers
    allocate) equal csrc/lane_group.h's fixed_group_work_size (what the
    launch checks), for the MLP routes and for a plan's walk values; the
    layout's constants are the wrapper's."""
    D = dims[-1][1]
    flat = (ctypes.c_int * (2 * len(dims)))(*[x for p in dims for x in p])
    walk = lane_group.mlp_walk(len(dims), flat, D)
    assert walk == PFX._mlp_walk_values(dims, D)
    for S in (1, 2, 4, 13):
        for B in (1, 33, 300, 4096):
            for ti in (False, True):
                R = sum(i * o + o for i, o in dims) + int(ti)
                assert lane_group.work_size(S, B, D, R, walk, R) == \
                    PFX._adjoint_work_size(dims, S, B, D, ti)
            # A plan: the per-sample quadratures after the shared ones.
            for n_q, walk_values, R in ((5, 17, 3), (300, 0, 300),
                                        (253, 111, 252)):
                assert lane_group.work_size(S, B, D, n_q, walk_values, R) \
                    == PFX._fixed_work_size(S, B, D, n_q, walk_values, R)
    assert lane_group.group() * lane_group.groups() == \
        PFX.FIXED_ADJOINT_THREADS
    assert lane_group.tree() == PFX.FIXED_TREE == 2 * lane_group.groups()
    # The spiral's 252 quadratures sit in registers, 16 a member.
    regs = 16 * lane_group.group()
    for n_q in (1, 252, regs, regs + 1, 604):
        assert bool(lane_group.quad_regs(n_q)) == (n_q <= regs)


# ---------------------------------------------------------------------------
# The plain versions: fingerprints and the reference
# ---------------------------------------------------------------------------

def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        for x in (t if isinstance(t, list) else [t]):
            h.update(x.detach().numpy().tobytes())
    return h.hexdigest()[:16]


# name: (dims, activation, input_power, time_input, method, num_steps, B,
#        sign)
K9_CASES = {
    "narrow": ((2, 16, 2), "tanh", 3, False, "rk4", 3, 100, 1.0),
    "narrow_time": ((3, 12, 12, 2), "elu", 1, True, "rk4_38", 2, 70, -1.0),
    "wide": ((2, 160, 2), "tanh", 1, False, "midpoint", 2, 6, 1.0),
}

#: sha256 prefixes of (ay0, aw, at) and the stats of the plain K9 before
#: the change: the MLP cases above and K15 in K9 on two plans of
#: `test_torch_plan_adjoint._sweep_inputs` (rk4, 3 steps an interval).
FINGERPRINTS = {
    "narrow": ("68720e48983c24ae", [36, 9, 0, 0]),
    "narrow_time": ("39a7b4123d29e35a", [24, 6, 0, 0]),
    "wide": ("394d16b355caaee1", [12, 6, 0, 0]),
    "plan_batch_const": ("7fc952e6c43e5cc6", [48, 12, 0, 0]),
    "plan_timedep": ("1aa105316f70fadc", [48, 12, 0, 0]),
}


def _k9_case(name):
    dims, act, power, ti, method, n, B, sign = K9_CASES[name]
    rng = np.random.RandomState(21)
    W = [(rng.randn(a, b) * 0.4 / np.sqrt(a), rng.randn(b) * 0.05)
         for a, b in zip(dims[:-1], dims[1:])]
    rng = np.random.RandomState(22)
    T, D = 4, dims[-1]
    ys, g = rng.randn(T, B, D) * 0.7, rng.randn(T, B, D)
    tau = np.array([0.0, 0.3, 0.55, 1.0])
    kw = dict(num_steps=n, activation=act, input_power=power,
              time_input=ti, method=method)
    return W, dims, ys, g, tau, sign, kw


def _mlp_plain(name):
    W, _, ys, g, tau, sign, kw = _k9_case(name)
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], F64)
    return PFX.mlp_adjoint_solve_fixed_plain(
        pw, pd, torch.tensor(ys), torch.tensor(g), torch.tensor(tau), sign,
        **kw)


def _plan_plain(name):
    plan, packed, ys, g, tau = _sweep_inputs(name)
    return plan, CP.plan_adjoint_solve_fixed(
        plan, packed, torch.tensor(ys, dtype=F64), torch.tensor(g, dtype=F64),
        torch.tensor(tau, dtype=F64), 1.0, num_steps=3, method="rk4")


@pytest.mark.parametrize("name", sorted(K9_CASES))
def test_plain_mlp_version_keeps_its_bits(name):
    """The plain K9 on the narrow and wide nets gives bitwise its results
    before the kernel took a group of threads a sample."""
    ay0, aw, at, st = _mlp_plain(name)
    assert (_digest(ay0, aw, at), st.tolist()) == FINGERPRINTS[name]


@pytest.mark.parametrize("name", ["batch_const", "timedep"])
def test_plain_plan_version_keeps_its_bits(name):
    """K15 in K9's plain version, likewise (its per-sample quadratures and
    a_t among the outputs)."""
    _, (ay0, dconsts, at, st) = _plan_plain(name)
    assert (_digest(ay0, list(dconsts), at), st.tolist()) == \
        FINGERPRINTS["plan_" + name]


@pytest.mark.parametrize("name", sorted(K9_CASES))
def test_plain_mlp_version_matches_reference(name):
    """The plain K9 against the reference's `mlp_adjoint_solve_fixed` in
    interpret mode with pack=1: identical stats, ay0, the parameters'
    cotangents and a_t within 1e-10 relative (tests/
    test_torch_fixed_fused.py's bar)."""
    W, dims, ys, g, tau, sign, kw = _k9_case(name)
    jw, jd = pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                              for a, b in W], jnp.float64)
    j_ay0, j_aw, j_at, j_st = JPF.mlp_adjoint_solve_fixed(
        jw, jd, jnp.asarray(ys.transpose(0, 2, 1)),
        jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau),
        jnp.asarray(sign), interpret=True, pack=1, **kw)
    ay0, aw, at, st = _mlp_plain(name)
    assert st.tolist() == [int(x) for x in j_st]
    assert _rel(ay0.numpy(), np.asarray(j_ay0).T) < 1e-10
    ref_aw = np.concatenate(
        [np.concatenate([np.asarray(dW)[:b, :a].reshape(-1),
                         np.asarray(db)[:b, 0]])
         for (dW, db), (a, b) in zip(j_aw, zip(dims[:-1], dims[1:]))])
    assert _rel(aw.numpy(), ref_aw) < 1e-10
    if kw["time_input"]:
        assert abs(float(at) - float(j_at)) <= 1e-10 * abs(float(j_at))
    else:
        assert float(at) == 0.0


@pytest.mark.parametrize("name", ["batch_const", "timedep"])
def test_plain_plan_version_matches_reference(name):
    """K15 in K9's plain version against the reference's
    `plan_adjoint_solve_fixed` in interpret mode with pack=1: identical
    stats, ay0, every constant's cotangent (the per-sample ones too) and
    a_t within 1e-9 relative (tests/test_torch_plan_adjoint.py's bar)."""
    plan, (ay0, dconsts, at, st) = _plan_plain(name)
    jplan, jpacked, jys, jg, jtau = _ref_sweep_inputs(name)
    jay0, jdc, jat, jst = JPF.plan_adjoint_solve_fixed(
        jplan, tuple(jpacked), jys, jg, jtau, 1.0, num_steps=3,
        method="rk4", interpret=True, pack=1)
    assert st.tolist() == [int(x) for x in jst]
    assert _rel(ay0, np.asarray(jay0).T) <= 1e-9
    assert abs(float(at) - float(jat)) <= 1e-9 * max(1.0, abs(float(jat)))
    _check_consts(plan, dconsts, jdc, 1e-9)
