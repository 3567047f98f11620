"""PyTorch port: explicit_adams' K10 with a group of threads a sample, what
the CPU can hold.

explicit_adams' K10 (the whole fixed-step Adams solve with the AB
predictor alone) walks each sample with a group of threads in 512-thread
blocks (csrc/rk_adams.cuh rk_adams_group_kernel): 16 threads a sample on
the narrow MLP route and on the plan route (K14's generated group walk),
`cuda_fixed.FIXED_WIDE_GROUP` on the wide one. The members split the RK4
bootstrap's stage states, the AB predictor sum, the Kahan update, the
history shift and the Hermite drain a feature a member, and each layer an
output a member, every sum in the plain version's order, so the plain
version did not change. Held here, with no card:

- the slot and workspace sizes the launch checks (csrc/lane_group.h,
  compiled as host C++ and called through ctypes) against their Python
  counterparts (`cuda_adams.adams_slot_values`, the workspace of
  `cuda_fixed._solve_work_size`, `cuda_plan.adams_group_work`), on the
  narrow, wide and plan routes, for ragged B (skipped without a host
  compiler);
- `mlp_solve_adams_plain` (explicit_adams on the narrow route at orders 2
  (with a time column, in reverse time), 4 and 12, the wide route past
  128) and `adams_solve_plain` with a captured plan at orders 1 and 4 (the
  plan route's plain version) against float64 fingerprints taken from the
  tree before the change;
- the MLP cases against the reference in interpret mode (whose
  explicit_adams does not trace at max_order 1)
  (`pallas_fixed.mlp_solve_adams`, pack=1) at the bar of
  tests/test_torch_adams_fused.py: identical stats, float64 within 1e-12
  relative.
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
from tfdiffeq_tpu_torch.ops import cuda_adams as PA, cuda_fixed as PFX, \
    cuda_kernels as PK, cuda_plan as CP, plan_bridge as PB
from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid

F64 = torch.float64
CXX = shutil.which("c++") or shutil.which("g++")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tfdiffeq_tpu_torch", "csrc")


# ---------------------------------------------------------------------------
# The slot and workspace sizes the launch checks
# ---------------------------------------------------------------------------

_SHIM = r"""
#include "lane_group.h"
extern "C" int block() { return tfd::kGroupBlock; }
extern "C" int group_ok(int g) { return tfd::group_size_ok(g); }
extern "C" int samples(int g) { return tfd::group_samples(g); }
extern "C" long adams_slot(int D, int max_order, long walk) {
  return tfd::adams_solve_slot_values(D, max_order, walk);
}
extern "C" long plan_walk(int D, int out_rows, int group_values) {
  return tfd::plan_solve_walk_values(D, out_rows, group_values);
}
extern "C" long work_size(long slot, int B, int group, long n_wt) {
  return tfd::group_solve_work_size(slot, B, group, n_wt);
}
"""


@pytest.fixture(scope="module")
def adams_group(tmp_path_factory):
    """csrc/lane_group.h compiled as host C++ into a ctypes library."""
    if CXX is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("adams_group")
    cpp, so = d / "adams_group.cpp", d / "adams_group.so"
    cpp.write_text(_SHIM)
    subprocess.run([CXX, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    L, I = ctypes.c_long, ctypes.c_int
    lib.adams_slot.argtypes = [I, I, L]
    lib.adams_slot.restype = L
    lib.plan_walk.argtypes = [I, I, I]
    lib.plan_walk.restype = L
    lib.work_size.argtypes = [L, I, I, L]
    lib.work_size.restype = L
    return lib


# dims of MLPs: the spiral, a time column, a wide one past 128.
NETS = [((2, 50), (50, 2)), ((3, 16), (16, 2)), ((2, 160), (160, 2))]


@pytest.mark.parametrize("max_order", [1, 4, 12])
@pytest.mark.parametrize("dims", NETS)
def test_mlp_slot_and_work_size_match_the_launch(adams_group, dims,
                                                 max_order):
    """explicit_adams' slot (state, compensation, increment, RK4 stages
    1-3, the history ring, the walk's two layer vectors) and workspace on
    the narrow and wide MLP routes, as the wrapper allocates them and the
    launch checks them, for ragged B; the groups are ones the launch
    takes, and the wide route's transposed weights follow the slots."""
    D = dims[-1][1]
    gw = max(w for dd in dims for w in dd)
    n_w = sum(i * o + o for i, o in dims)
    route = PK.ROUTE_NARROW if gw <= 128 else PK.ROUTE_WIDE
    group = PFX.fixed_group(route)
    assert adams_group.group_ok(group)
    assert adams_group.samples(group) * group == adams_group.block() \
        == PA.ADAMS_THREADS
    slot = PA.adams_slot_values(max_order, D, 2 * gw)
    assert slot == (6 + max_order) * D + 2 * gw
    assert adams_group.adams_slot(D, max_order, 2 * gw) == slot
    for B in (1, 33, 100, 4096, 4097):
        n_wt = PFX._wt_values(route, n_w)
        assert adams_group.work_size(slot, B, group, n_wt) == \
            PA.adams_group_work(max_order, D, dims, route, B)


def _spiral_plan(B=8):
    rng = np.random.RandomState(7)
    w1, b1 = torch.tensor(rng.randn(2, 12) * 0.4), torch.tensor(
        rng.randn(12) * 0.1)
    w2 = torch.tensor(rng.randn(12, 2) * 0.4)

    def f(t, y):
        return torch.tanh((y ** 3) @ w1 + b1) @ w2

    y0 = torch.tensor(np.random.RandomState(8).randn(B, 2) * 0.5)
    plan, consts = PB.build_plan(f, torch.tensor(0.0, dtype=F64), y0)
    return plan, PB.pack_consts(plan, consts, F64), y0, f


@pytest.mark.parametrize("max_order", [1, 4, 12])
def test_plan_slot_and_work_size_match_the_launch(adams_group, max_order):
    """The plan route: the walk's values (the sample's inputs, the
    generated group walk's scratch, its outputs) in explicit_adams' slot,
    and the workspace the wrapper allocates, equal the launch's."""
    plan = _spiral_plan()[0]
    from tfdiffeq_tpu_torch.ops import plan_codegen
    walk = CP.plan_walk_values(plan)
    assert adams_group.plan_walk(plan.dim, plan.out_rows,
                                 plan_codegen.group_values(plan)) == walk
    slot = adams_group.adams_slot(plan.dim, max_order, walk)
    for B in (1, 33, 4096, 4097):
        assert adams_group.work_size(slot, B, PFX.FIXED_GROUP, 0) == \
            CP.adams_group_work(plan, max_order, B)


# ---------------------------------------------------------------------------
# The plain version: fingerprints and the reference
# ---------------------------------------------------------------------------

def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()[:16]


# name: (dims, activation, input_power, time_input, max_order, B, sign,
#        grid points)
K10_CASES = {
    "narrow_o4": ((2, 16, 2), "tanh", 3, False, 4, 33, 1.0, 17),
    "narrow_o2_time_reverse": ((3, 12, 2), "elu", 1, True, 2, 100, -1.0,
                               None),
    # AB12 amplifies roundoff from step to step: a short grid, 11
    # bootstrap steps, then 6 AB12 steps.
    "narrow_o12": ((2, 16, 2), "tanh", 3, False, 12, 17, 1.0, 18),
    "wide_o4": ((2, 160, 2), "tanh", 1, False, 4, 1, 1.0, 9),
}

#: sha256 prefixes of the output and the stats of the plain explicit_adams
#: before the change, float64.
FINGERPRINTS = {
    "narrow_o4": ("dafc1fd7892b12de", [26, 16, 0, 0]),
    "narrow_o2_time_reverse": ("1f2634cd543fb8a2", [9, 5, 0, 0]),
    "narrow_o12": ("111f50370c31c686", [51, 17, 0, 0]),
    "wide_o4": ("eb5120aa9c19beec", [18, 8, 0, 0]),
    "plan_o1": ("352f206c598c78bd", [25, 24, 0, 0]),
    "plan_o4": ("00f73d77ae107092", [34, 24, 0, 0]),
}


def _k10_case(name):
    dims, act, power, ti, mo, B, sign, n_grid = K10_CASES[name]
    rng = np.random.RandomState(41)
    W = [(rng.randn(a, b) * 0.4 / np.sqrt(a), rng.randn(b) * 0.05)
         for a, b in zip(dims[:-1], dims[1:])]
    y0 = np.random.RandomState(42).randn(B, dims[-1]) * 0.7
    t = np.array([0.0, 0.3, 0.55, 1.0, 1.7, 2.0])
    tau = t if sign > 0 else (-t)[::-1].copy()
    grid = tau if n_grid is None else np.linspace(tau[0], tau[-1], n_grid)
    kw = dict(activation=act, input_power=power, time_input=ti,
              implicit=False, max_order=mo)
    return W, y0, tau, grid, sign, kw


def _plain(name):
    W, y0, tau, grid, sign, kw = _k10_case(name)
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], F64)
    return PA.mlp_solve_adams(pw, pd, torch.tensor(y0), torch.tensor(tau),
                              torch.tensor(grid), 1e-6, 1e-8, sign, **kw)


@pytest.mark.parametrize("name", sorted(K10_CASES))
def test_plain_version_keeps_its_bits(name):
    """The plain explicit_adams (the wrapper on CPU tensors) gives bitwise
    its results before the kernel took a group of threads a sample."""
    out, st = _plain(name)
    assert (_digest(out), st.tolist()) == FINGERPRINTS[name]


@pytest.mark.parametrize("max_order", [1, 4])
def test_plan_route_plain_keeps_its_bits(max_order):
    """The plan route's plain version (`adams_solve_plain` with
    `eval_plan`, reached by `plan_solve_adams` on CPU tensors) gives
    bitwise its results before the change, and equals `adams_solve_plain`
    called with the plan's right-hand side."""
    plan, packed, y0, _ = _spiral_plan(B=33)
    t = torch.linspace(0.0, 2.0, 5, dtype=F64)
    grid = uniform_grid(t[0], t[-1], 24)
    g = CP.plan_rhs(plan, packed, torch.tensor(1.0, dtype=F64))
    f0 = g(t[0], y0)
    out, st = CP.plan_solve_adams(plan, packed, y0, t, grid, 1e-6, 1e-6, 1.0,
                                  f0, implicit=False, max_order=max_order)
    ref = PA.adams_solve_plain(g, y0, f0, t, grid, 1e-6, 1e-6,
                               implicit=False, max_order=max_order)
    assert torch.equal(out, ref[0]) and torch.equal(st, ref[1])
    assert (_digest(out), st.tolist()) == \
        FINGERPRINTS[f"plan_o{max_order}"]


@pytest.mark.parametrize("name", sorted(K10_CASES))
def test_plain_version_matches_reference(name):
    """The plain explicit_adams against the reference's `mlp_solve_adams`
    in interpret mode with pack=1: identical stats, float64 within 1e-12
    relative."""
    W, y0, tau, grid, sign, kw = _k10_case(name)
    jw, jd = pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                              for a, b in W], jnp.float64)
    jo, js = JPF.mlp_solve_adams(jw, jd, jnp.asarray(y0.T),
                                 jnp.asarray(tau), jnp.asarray(grid), 1e-6,
                                 1e-8, jnp.asarray(sign), interpret=True,
                                 pack=1, **kw)
    out, st = _plain(name)
    assert st.tolist() == [int(x) for x in js] and st[3].item() == 0
    ref = np.asarray(jo).transpose(0, 2, 1)
    err = np.max(np.abs(out.numpy() - ref)) / max(np.max(np.abs(ref)),
                                                  1e-30)
    assert err < 1e-12
