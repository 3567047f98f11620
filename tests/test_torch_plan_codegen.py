"""PyTorch port: K14's generated code checked without a card.

For each plan of tests/test_torch_plan_bridge.py, the segments that
`ops/plan_codegen.py` generates (the code that runs inside K2, K8 and K5)
are compiled as host C++ (`c++ -O1 -shared -fPIC`, with a shim that
defines __host__, __device__ and __forceinline__ as empty; csrc/
plan_ops.cuh maps each operation to <math.h>), loaded with ctypes and run
on the whole batch, every batch coupling reduced in the order of a K2
block of 512 threads. The result is held against `plan_bridge.eval_plan`
within 1e-12 relative to the output's largest entry in float64 and 1e-6 in
float32: the host's libm is not PyTorch's, so transcendental functions may
differ in their last bits, while a codegen fault (a wrong row, operand or
op) shows as an O(1) gap. Generation is deterministic, and the source
depends on neither the batch size nor the constants' values.

The reverse walk (K15, `plan_codegen.host_aug_source`: the code that runs
inside K3, K6 and K9) is held the same way against `plan_adjoint.
aug_terms` on every plan the walk takes: f, v_y, every shared
quadrature's per-sample term (`quad_x`), v_t and the per-sample
constants' cotangents (`sample_x`), each meet in the order of a K3 block
of 512 threads, within the same bars.

Skipped only where no host C++ compiler is found.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tfdiffeq_tpu_torch.ops import plan_adjoint as PA
from tfdiffeq_tpu_torch.ops import plan_bridge as PB
from tfdiffeq_tpu_torch.ops import plan_codegen as PC
from tfdiffeq_tpu_torch.ops.cuda_adjoint import ADJOINT_THREADS
from tfdiffeq_tpu_torch.ops.cuda_kernels import SOLVE_THREADS

from test_torch_plan_bridge import NAMES, T0, _dyn

CXX = shutil.which("c++") or shutil.which("g++")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tfdiffeq_tpu_torch", "csrc")
SHIM = ("#define __host__\n#define __device__\n"
        "#define __forceinline__ inline\n")

pytestmark = pytest.mark.skipif(CXX is None, reason="no host C++ compiler")


def _plan(name, dtype):
    f, y0 = _dyn(torch, dtype)[name]
    y = torch.tensor(y0, dtype=dtype)
    t = torch.tensor(T0, dtype=dtype)
    plan, consts = PB.build_plan(f, t, y)
    return plan, PB.pack_consts(plan, consts, dtype), t, y


#: The plans the reverse walk takes (a full feature reduction it refuses).
AUG_NAMES = [n for n in NAMES if n != "b1_mean_exp"]


def _compile_all(d, sources):
    """{name: ctypes library} of host C++ sources, all compilers started
    together."""
    jobs = {}
    for name, src in sources.items():
        cpp, so = d / f"{name}.cpp", d / f"{name}.so"
        cpp.write_text(SHIM + src)
        jobs[name] = (so, subprocess.Popen(
            [CXX, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC, "-o",
             str(so), str(cpp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, f"{name}:\n{log}"
        out[name] = ctypes.CDLL(str(so))
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every plan of the set compiled as host C++."""
    return _compile_all(tmp_path_factory.mktemp("plans"), {
        name: PC.host_source(_plan(name, torch.float64)[0], SOLVE_THREADS)
        for name in NAMES})


@pytest.fixture(scope="module")
def aug_libs(tmp_path_factory):
    """Every reverse walk of the set compiled as host C++."""
    return _compile_all(tmp_path_factory.mktemp("augs"), {
        name: PC.host_aug_source(_plan(name, torch.float64)[0],
                                 ADJOINT_THREADS)
        for name in AUG_NAMES})


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", NAMES)
def test_generated_segments_match_eval_plan(libs, name, dtype):
    plan, packed, t, y = _plan(name, dtype)
    B = y.shape[0]
    want = PB.eval_plan_host(plan, packed, t, y)
    lay = PC.layout(plan)
    c, sc = PC.flat_consts(plan, packed, B)
    out = torch.full((B, plan.out_rows), float("nan"), dtype=dtype)
    live = torch.zeros(max(1, lay.live_rows * B), dtype=dtype)
    red = torch.zeros(max(1, lay.red_values), dtype=dtype)
    suffix, ct = (("f32", ctypes.c_float) if dtype == torch.float32
                  else ("f64", ctypes.c_double))
    fn = getattr(libs[name], f"plan_eval_{suffix}")
    fn.argtypes = [ct] + [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 3
    fn.restype = None
    fn(float(t), _ptr(y.contiguous()), _ptr(c), _ptr(sc), B, _ptr(out),
       _ptr(live), _ptr(red))
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    rel = float((out - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert rel <= tol, (name, rel)
    assert lay.segments == 1 + sum(ins[0] in ("bsum", "bmax")
                                   for ins in plan.instrs)


@pytest.mark.parametrize("host", PC.HOSTS)
def test_source_depends_on_structure_alone(host):
    """The same structure at another batch size and with other weights
    gives the same source; generation is deterministic; a coupled plan
    runs on the one-block hosts (K2, K8, K10, K11), not on K5's group
    walk."""
    a1 = torch.tensor(np.random.RandomState(0).randn(2, 16))
    a2 = torch.tensor(np.random.RandomState(1).randn(2, 16))
    b2 = torch.tensor(np.random.RandomState(2).randn(16, 2))

    def f(a):
        return lambda t, y: torch.tanh(y @ a + t) @ b2

    p8, _ = PB.build_plan(f(a1), 0.0, torch.randn(8, 2, dtype=torch.float64))
    p12, _ = PB.build_plan(f(a2), 0.0,
                           torch.randn(12, 2, dtype=torch.float64))
    assert p8 != p12                     # the batch is part of the plan
    src = PC.cuda_source(p8, host)
    assert src == PC.cuda_source(p12, host) == PC.cuda_source(p8, host)
    coupled = _plan("meanfield", torch.float64)[0]
    if host in PC.COUPLED_HOSTS:
        assert "kSegments = 2" in PC.cuda_source(coupled, host)
    else:
        with pytest.raises(ValueError, match="coupled plan runs on the "
                                             "hosts"):
            PC.cuda_source(coupled, host)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", AUG_NAMES)
def test_generated_reverse_walk_matches_aug_terms(aug_libs, name, dtype):
    plan, packed, t, y = _plan(name, dtype)
    B = y.shape[0]
    ay = torch.tensor(np.random.RandomState(3).randn(B, plan.out_rows),
                      dtype=dtype)
    want = PA.aug_terms(plan, packed, t, y.t().contiguous(),
                        ay.t().contiguous())
    lay = PC.aug_layout(plan)
    nq = lay.n_quad + lay.time_input
    buf = lambda n: torch.zeros(max(1, n), dtype=dtype)
    f, vy = buf(B * plan.out_rows), buf(B * plan.dim)
    xq, xs = buf(nq * B), buf(lay.n_sample * B)
    live, red, qr = (buf(lay.live_rows * B), buf(lay.red_values),
                     buf(lay.q_rows * B))
    c, sc = PC.flat_consts(plan, packed, B)
    suffix, ct = (("f32", ctypes.c_float) if dtype == torch.float32
                  else ("f64", ctypes.c_double))
    fn = getattr(aug_libs[name], f"aug_eval_{suffix}")
    fn.argtypes = [ct] + [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 7
    fn.restype = None
    fn(float(t), _ptr(y.contiguous()), _ptr(ay), _ptr(c), _ptr(sc), B,
       _ptr(f), _ptr(vy), _ptr(xq), _ptr(xs), _ptr(live), _ptr(red),
       _ptr(qr))
    got = [f.view(B, -1).t(), vy.view(B, -1).t(),
           xq[:lay.n_quad * B].view(-1, B), xs[:lay.n_sample * B].view(-1, B),
           xq[lay.n_quad * B:nq * B].view(-1, B)]
    wants = list(want[:4]) + [want[4] if lay.time_input
                              else want[4][:0]]
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for i, (a, b) in enumerate(zip(got, wants)):
        assert a.shape == b.shape, (name, i)
        if b.numel():
            rel = float((a - b).abs().max()
                        / b.abs().max().clamp_min(1e-30))
            assert rel <= tol, (name, i, rel)
    assert lay.segments == 1 + 2 * sum(ins[0] in ("bsum", "bmax")
                                       for ins in plan.instrs)


def test_reverse_walk_source_depends_on_structure_alone():
    a1 = torch.tensor(np.random.RandomState(0).randn(2, 16))
    a2 = torch.tensor(np.random.RandomState(1).randn(2, 16))
    b2 = torch.tensor(np.random.RandomState(2).randn(16, 2))

    def f(a):
        return lambda t, y: torch.tanh(y @ a + t) @ b2

    p8, _ = PB.build_plan(f(a1), 0.0, torch.randn(8, 2, dtype=torch.float64))
    p12, _ = PB.build_plan(f(a2), 0.0,
                           torch.randn(12, 2, dtype=torch.float64))
    for host in PC.AUG_HOSTS:
        assert PC.cuda_source(p8, host) == PC.cuda_source(p12, host)
    coupled = _plan("meanfield", torch.float64)[0]
    for host in ("adjoint", "fixed_adjoint"):
        assert "kSegments = 3" in PC.cuda_source(coupled, host)
    # K6's group walk and K12 (queue 2 item 3) take no coupled plan.
    for plan, host in ((coupled, "perlane_adjoint"),
                       ((coupled, coupled), "hyper")):
        with pytest.raises(ValueError, match="coupled plan runs on the "
                                             "hosts"):
            PC.cuda_source(plan, host)


def _hyper_plans(dtype):
    """K12's two plans: the spiral dynamics (square) and a correction net
    over the stacked [y, f, t] ([B, 4] -> [B, 2])."""
    rng = np.random.RandomState(7)
    w1 = torch.tensor(rng.randn(2, 12) * 0.4, dtype=dtype)
    w2 = torch.tensor(rng.randn(12, 2) * 0.4, dtype=dtype)
    hw = torch.tensor(rng.randn(5, 10) * 0.3, dtype=dtype)
    hv = torch.tensor(rng.randn(10, 2) * 0.3, dtype=dtype)

    def f(t, y):
        return torch.tanh((y ** 3) @ w1) @ w2

    def g(t, y, fv):
        tc = t.reshape(1, 1).expand(y.shape[0], 1)
        return torch.tanh(torch.cat([y, fv, tc], 1) @ hw) @ hv

    y = torch.tensor(rng.randn(6, 2), dtype=dtype)
    t = torch.tensor(0.3, dtype=dtype)
    pf, cf = PB.build_plan(f, t, y)
    s = torch.cat([y, f(t, y)], 1)
    pg, cg = PB.build_plan(lambda tt, ss: g(tt, ss[:, :2], ss[:, 2:]), t, s,
                           out_dim=2)
    return ((pf, PB.pack_consts(pf, cf, dtype), y),
            (pg, PB.pack_consts(pg, cg, dtype), s), t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_hyper_source_holds_both_plans(tmp_path, dtype):
    """The 'hyper' host's two plans (`Plan`, `PlanG`) in one translation
    unit compile as host C++, and each evaluates as `eval_plan` does; the
    CUDA source names both structs and K12's entry points."""
    (pf, kf, y), (pg, kg, s), t = _hyper_plans(dtype)
    src = PC.cuda_source((pf, pg), PC.HYPER_HOST)
    assert "struct Plan {" in src and "struct PlanG {" in src
    assert "TFD_PLAN_HYPER_ENTRY(tfd_plan_hyper_f32, float)" in src
    lib = _compile_all(tmp_path, {"hyper": PC.host_hyper_source(pf, pg)})[
        "hyper"]
    suffix, ct = (("f32", ctypes.c_float) if dtype == torch.float32
                  else ("f64", ctypes.c_double))
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for prefix, plan, packed, x in (("plan", pf, kf, y), ("plang", pg, kg, s)):
        B = x.shape[0]
        want = PB.eval_plan_host(plan, packed, t, x)
        c, sc = PC.flat_consts(plan, packed, B)
        out = torch.full((B, plan.out_rows), float("nan"), dtype=dtype)
        buf = torch.zeros(1, dtype=dtype)
        fn = getattr(lib, f"{prefix}_eval_{suffix}")
        fn.argtypes = [ct] + [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 3
        fn.restype = None
        fn(float(t), _ptr(x.contiguous()), _ptr(c), _ptr(sc), B, _ptr(out),
           _ptr(buf), _ptr(buf))
        rel = float((out - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        assert rel <= tol, (prefix, rel)
