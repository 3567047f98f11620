"""PyTorch port: K12 (the hypersolvers) with a group of threads a sample,
what the CPU can hold.

K12 walks each sample with a group of threads in 512-thread blocks
(csrc/rk_hyper.cuh rk_hyper_group_kernel), both of its plans, the dynamics
and the correction net, on K14's generated group walk: the members split
the base update, the correction (sign dt)^(p+1) g and the delayed Hermite
drain a feature a member, and each walk's rows as the walk assigns them,
so the plain version did not change. The launch picks the group from B
(16 where the batch fills the card). Held here, with no card:

- the group, slot and workspace sizes the launch uses (csrc/lane_group.h
  `hyper_group`, `hyper_solve_slot_values`, `group_solve_work_size`,
  compiled as host C++ and called through ctypes) against their Python
  counterparts (`cuda_plan.hyper_group`, `hyper_group_work`), for ragged
  B (skipped without a host compiler);
- `plan_solve_hyper_plain` (reached by `plan_solve_hyper` on CPU tensors)
  for the three kinds on the output grid, a finer grid and reverse time
  against float64 fingerprints taken from the tree before the change;
- `fast.solve_hyper` on CPU tensors (K12's plain version) against the
  reference's `fast.solve_hyper(..., interpret=True)` (its K12 in
  interpret mode) at the bar of tests/test_torch_hyper.py: float32 within
  2e-6, identical stats.
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

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_plan as CP, plan_bridge as PB, \
    plan_codegen
from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid

F32, F64 = torch.float32, torch.float64
CXX = shutil.which("c++") or shutil.which("g++")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tfdiffeq_tpu_torch", "csrc")
KINDS = ["euler", "midpoint", "heun"]


def _weights(seed=71):
    rng = np.random.RandomState(seed)
    return {"W1": rng.randn(2, 16) * 0.3, "b1": rng.randn(16) * 0.05,
            "W2": rng.randn(16, 2) * 0.3, "Hw": rng.randn(5, 12) * 0.2,
            "Hv": rng.randn(12, 2) * 0.2}


def _pair(xp, dtype, w):
    """(f, g) in the framework `xp` (jnp or torch) over the numpy `w`: a
    tanh MLP of y^3 and a correction net over [y, f, t]."""
    if xp is jnp:
        a = {k: jnp.asarray(v, dtype) for k, v in w.items()}

        def g(t, y, f):
            tc = jnp.broadcast_to(jnp.reshape(t, (1, 1)), (y.shape[0], 1))
            return jnp.tanh(jnp.concatenate([y, f, tc], 1) @ a["Hw"]) \
                @ a["Hv"]
    else:
        a = {k: torch.tensor(v, dtype=dtype) for k, v in w.items()}

        def g(t, y, f):
            tc = t.reshape(1, 1).expand(y.shape[0], 1)
            return torch.tanh(torch.cat([y, f, tc], 1) @ a["Hw"]) @ a["Hv"]

    def f(t, y):
        return xp.tanh((y ** 3) @ a["W1"] + a["b1"]) @ a["W2"]

    return f, g


def _plans(B, dtype=F64):
    """K12's two plans and their packed constants, and B states."""
    w = _weights()
    f, g = _pair(torch, dtype, w)
    y0 = torch.tensor(np.random.RandomState(72).randn(B, 2) * 0.8,
                      dtype=dtype)
    t0 = torch.tensor(0.0, dtype=dtype)
    pf, cf = PB.build_plan(f, t0, y0)
    pg, cg = PB.build_plan(lambda tt, ss: g(tt, ss[:, :2], ss[:, 2:]), t0,
                           torch.cat([y0, f(t0, y0)], 1), out_dim=2)
    return (pf, pg, PB.pack_consts(pf, cf, dtype),
            PB.pack_consts(pg, cg, dtype), y0)


# ---------------------------------------------------------------------------
# The group, slot and workspace sizes the launch uses
# ---------------------------------------------------------------------------

_SHIM = r"""
#include "lane_group.h"
extern "C" int hyper_group(int B) { return tfd::hyper_group(B); }
extern "C" int group_ok(int g) { return tfd::group_size_ok(g); }
extern "C" long hyper_slot(int D, long walk_f, long walk_g) {
  return tfd::hyper_solve_slot_values(D, walk_f, walk_g);
}
extern "C" long plan_walk(int D, int out_rows, int group_values) {
  return tfd::plan_solve_walk_values(D, out_rows, group_values);
}
extern "C" long work_size(long slot, int B, int group, long n_wt) {
  return tfd::group_solve_work_size(slot, B, group, n_wt);
}
"""


@pytest.fixture(scope="module")
def hyper_shim(tmp_path_factory):
    """csrc/lane_group.h compiled as host C++ into a ctypes library."""
    if CXX is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("hyper_group")
    cpp, so = d / "hyper_group.cpp", d / "hyper_group.so"
    cpp.write_text(_SHIM)
    subprocess.run([CXX, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    L, I = ctypes.c_long, ctypes.c_int
    lib.hyper_slot.argtypes = [I, L, L]
    lib.hyper_slot.restype = L
    lib.plan_walk.argtypes = [I, I, I]
    lib.plan_walk.restype = L
    lib.work_size.argtypes = [L, I, I, L]
    lib.work_size.restype = L
    return lib


@pytest.mark.parametrize("B", [1, 33, 256, 300, 1024, 2048, 4096, 4097,
                               100000])
def test_group_and_work_size_match_the_launch(hyper_shim, B):
    """The group the launch picks from B (16 where the batch fills the
    card), K12's slot (Y, YP, FP, F0, f's walk after its D inputs, g's
    after its 2 D inputs) and the workspace the wrapper allocates equal
    csrc/lane_group.h's."""
    group = CP.hyper_group(B)
    assert hyper_shim.hyper_group(B) == group and hyper_shim.group_ok(group)
    if B >= 4096:
        assert group == 16
    pf, pg = _plans(8)[:2]
    wf = CP.plan_walk_values(pf)
    wg = CP.plan_walk_values(pg)
    assert hyper_shim.plan_walk(pf.dim, pf.out_rows,
                                plan_codegen.group_values(pf)) == wf
    assert hyper_shim.plan_walk(pg.dim, pg.out_rows,
                                plan_codegen.group_values(pg)) == wg
    assert wf >= 2 * pf.dim and wg >= pg.dim + pf.dim
    slot = hyper_shim.hyper_slot(pf.dim, wf, wg)
    assert slot == 4 * pf.dim + wf + wg
    assert hyper_shim.work_size(slot, B, group, 0) == \
        CP.hyper_group_work(pf, pg, B)


# ---------------------------------------------------------------------------
# The plain version: fingerprints and the reference
# ---------------------------------------------------------------------------

def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()[:16]


def _grids(case):
    """(tau, grid, sign, grid_is_t) of a case: the output grid, a finer
    grid, reverse time."""
    t = np.array([0.0, 0.25, 0.6, 1.0, 1.5])
    if case == "grid_is_t":
        tau = torch.tensor(t, dtype=F64)
        return tau, tau, 1.0, True
    if case == "finer":
        tau = torch.tensor(t, dtype=F64)
        return tau, uniform_grid(tau[0], tau[-1], 24), 1.0, False
    tau = torch.tensor((-t)[::-1].copy(), dtype=F64)
    return tau, uniform_grid(tau[0], tau[-1], 12), -1.0, False


CASES = [(kind, case) for kind in KINDS
         for case in ("grid_is_t", "finer", "reverse")]

#: sha256 prefixes of the output and the stats of the plain K12 before the
#: change, float64, B = 33.
FINGERPRINTS = {
    "euler_grid_is_t": ("4a349ae819ef8b87", [4, 4, 0, 0]),
    "euler_finer": ("7a1ac152189adf0a", [25, 24, 0, 0]),
    "euler_reverse": ("815efd1ab138f28d", [13, 12, 0, 0]),
    "midpoint_grid_is_t": ("c7dc23249b0f50b9", [8, 4, 0, 0]),
    "midpoint_finer": ("b78f41a6ee0eb808", [49, 24, 0, 0]),
    "midpoint_reverse": ("2697c134b93a146d", [25, 12, 0, 0]),
    "heun_grid_is_t": ("96e5ba34f76eecaf", [8, 4, 0, 0]),
    "heun_finer": ("b5766f20255365f8", [49, 24, 0, 0]),
    "heun_reverse": ("9d366082778282e6", [25, 12, 0, 0]),
}


@pytest.mark.parametrize("kind,case", CASES)
def test_plain_version_keeps_its_bits(kind, case):
    """`plan_solve_hyper` on CPU tensors (its plain version) gives bitwise
    its results before the kernel took a group of threads a sample, and
    equals `plan_solve_hyper_plain` called directly."""
    pf, pg, kf, kg, y0 = _plans(33)
    tau, grid, sign, grid_is_t = _grids(case)
    out, st = CP.plan_solve_hyper(pf, pg, kf, kg, y0, tau, grid, sign,
                                  kind=kind, grid_is_t=grid_is_t)
    ref = CP.plan_solve_hyper_plain(pf, pg, kf, kg, y0, tau, grid, sign,
                                    kind=kind, grid_is_t=grid_is_t)
    assert torch.equal(out, ref[0]) and torch.equal(st, ref[1])
    assert st[3].item() == 0 and torch.isfinite(out).all()
    assert (_digest(out), st.tolist()) == FINGERPRINTS[f"{kind}_{case}"]


@pytest.mark.parametrize("case", [(np.linspace(0.0, 2.0, 9), {}),
                                  (np.linspace(0.0, 2.0, 5),
                                   {"num_steps": 24}),
                                  (np.linspace(1.5, 0.0, 4),
                                   {"step_size": 0.125})],
                         ids=["grid_is_t", "num_steps", "reverse"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_matches_reference(kind, case):
    """`fast.solve_hyper` (K12's plain version) at B = 33 against the
    reference's `fast.solve_hyper(..., interpret=True)`: identical stats,
    float32 within 2e-6."""
    t, opts = case
    w = _weights()
    jf, jg = _pair(jnp, jnp.float32, w)
    pf, pg = _pair(torch, F32, w)
    y0 = np.random.RandomState(72).randn(33, 2) * 0.8
    method = f"hyper_{kind}"
    rj = JF.solve_hyper(jf, jg, jnp.asarray(y0, jnp.float32),
                        jnp.asarray(t, jnp.float32), method=method,
                        interpret=True, **opts)
    rp = PF.solve_hyper(pf, pg, torch.tensor(y0, dtype=F32),
                        torch.tensor(t, dtype=F32), method=method, **opts)
    assert [int(x) for x in rp.stats] == [int(x) for x in rj.stats]
    assert rp.stats.status == 0
    np.testing.assert_allclose(rp.ys.numpy(), np.asarray(rj.ys), rtol=0,
                               atol=2e-6)
