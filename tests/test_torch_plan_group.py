"""PyTorch port: the group walks of K14 and K15 checked without a card.

`ops/plan_codegen.py` emits, beside each uncoupled plan's per-thread walk,
a group walk: one sample's walk split over the gsz members of its group
(the code that runs in K5 and K8, `Plan::group_walk`, and in K6 and K9,
`PlanAug::group_walk`). Each row of a value is computed by the member
that owns it, a dot's outputs (and the VJP dot's inputs) over the members,
a reduction by member 0, and the walk is cut into phases at every read of
a row that another member wrote. Compiled as host C++ (the shim of
tests/test_torch_plan_codegen.py, `-O1 -ffp-contract=off`), the phases
run member by member for gsz in {1, 4, 8, 16}, and every output is held
bitwise against the per-thread walk compiled in the same translation
unit: every row is the same expression in the same order. Both are held
within the codegen tests' bars (1e-6 relative in float32, 1e-12 in
float64: the host's libm is not PyTorch's) against `plan_bridge.eval_plan`
and `plan_adjoint.aug_terms`.

Also: the group walk's source depends on the plan's structure alone; and
the slot and workspace sizes the group launches check (csrc/lane_group.h
with the generated kGroupValues) equal their Python counterparts in
`ops/cuda_plan.py`.

Skipped only where no host C++ compiler is found.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tfdiffeq_tpu_torch.ops import cuda_plan as CP
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
GROUPS = [1, 4, 8, 16]

pytestmark = pytest.mark.skipif(CXX is None, reason="no host C++ compiler")


def _plan(name, dtype):
    f, y0 = _dyn(torch, dtype)[name]
    y = torch.tensor(y0, dtype=dtype)
    t = torch.tensor(T0, dtype=dtype)
    plan, consts = PB.build_plan(f, t, y)
    return plan, PB.pack_consts(plan, consts, dtype), t, y


#: The plans the group walks take: uncoupled ones (the reverse walk also
#: refuses a full feature reduction).
FWD_NAMES = [n for n in NAMES
             if not _plan(n, torch.float64)[0].batch_coupled]
AUG_NAMES = [n for n in FWD_NAMES if n != "b1_mean_exp"]


def _compile_all(d, sources):
    """{name: ctypes library} of host C++ sources, all compilers started
    together."""
    jobs = {}
    for name, src in sources.items():
        cpp, so = d / f"{name}.cpp", d / f"{name}.so"
        cpp.write_text(SHIM + src)
        jobs[name] = (so, subprocess.Popen(
            [CXX, "-O1", "-ffp-contract=off", "-std=c++17", "-shared",
             "-fPIC", "-I", CSRC, "-o", str(so), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        assert proc.returncode == 0, f"{name}:\n{log}"
        out[name] = ctypes.CDLL(str(so))
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every forward walk of the set, per-thread and group, as host C++."""
    return _compile_all(tmp_path_factory.mktemp("group_plans"), {
        name: PC.host_source(_plan(name, torch.float64)[0], SOLVE_THREADS)
        for name in FWD_NAMES})


@pytest.fixture(scope="module")
def aug_libs(tmp_path_factory):
    """Every reverse walk of the set, per-thread and group, as host C++."""
    return _compile_all(tmp_path_factory.mktemp("group_augs"), {
        name: PC.host_aug_source(_plan(name, torch.float64)[0],
                                 ADJOINT_THREADS)
        for name in AUG_NAMES})


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _fn(lib, stem, dtype, n_ptr_a, n_ptr_b, tail):
    suffix, ct = (("f32", ctypes.c_float) if dtype == torch.float32
                  else ("f64", ctypes.c_double))
    fn = getattr(lib, f"{stem}_{suffix}")
    fn.argtypes = ([ct] + [ctypes.c_void_p] * n_ptr_a + [ctypes.c_int]
                   + [ctypes.c_void_p] * n_ptr_b + [ctypes.c_int] * tail)
    fn.restype = None
    return fn


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


def _near(a, b, dtype):
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    if not b.numel():
        return True
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) <= tol


def _forward(lib, plan, packed, t, y, dtype, gsz):
    """(per-thread outputs, group outputs) of the batch."""
    B = y.shape[0]
    lay = PC.layout(plan)
    c, sc = PC.flat_consts(plan, packed, B, transposed=True)
    yc = y.contiguous()
    ref = torch.zeros((B, plan.out_rows), dtype=dtype)
    live = torch.zeros(max(1, lay.live_rows * B), dtype=dtype)
    red = torch.zeros(max(1, lay.red_values), dtype=dtype)
    _fn(lib, "plan_eval", dtype, 3, 3, 0)(
        float(t), _ptr(yc), _ptr(c), _ptr(sc), B, _ptr(ref), _ptr(live),
        _ptr(red))
    lib.plan_group_values.restype = ctypes.c_int
    n = lib.plan_group_values()
    assert n == PC.group_values(plan)
    out = torch.zeros((B, plan.out_rows), dtype=dtype)
    gs = torch.zeros(max(1, n), dtype=dtype)
    _fn(lib, "plan_group", dtype, 3, 2, 1)(
        float(t), _ptr(yc), _ptr(c), _ptr(sc), B, _ptr(out), _ptr(gs), gsz)
    return ref, out


@pytest.mark.parametrize("gsz", GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", FWD_NAMES)
def test_forward_group_walk_is_bitwise_the_thread_walk(libs, name, dtype,
                                                       gsz):
    plan, packed, t, y = _plan(name, dtype)
    ref, out = _forward(libs[name], plan, packed, t, y, dtype, gsz)
    assert _same(out, ref), (name, float((out - ref).abs().max()))
    assert _near(out, PB.eval_plan_host(plan, packed, t, y), dtype), name


def _reverse(lib, plan, packed, t, y, dtype, gsz):
    """(per-thread outputs, group outputs) of the batch: f, v_y, the shared
    quadratures' terms (a_t's last) and the per-sample ones."""
    B = y.shape[0]
    ay = torch.tensor(np.random.RandomState(3).randn(B, plan.out_rows),
                      dtype=dtype)
    lay = PC.aug_layout(plan)
    nq = lay.n_quad + lay.time_input
    c, sc = PC.flat_consts(plan, packed, B, transposed=True)
    yc = y.contiguous()
    buf = lambda n: torch.zeros(max(1, n), dtype=dtype)

    def outs():
        return [buf(B * plan.out_rows), buf(B * plan.dim), buf(nq * B),
                buf(lay.n_sample * B)]

    ref = outs()
    # Named, so that they live through the call.
    live, red, qr0 = (buf(lay.live_rows * B), buf(lay.red_values),
                      buf(lay.q_rows * B))
    _fn(lib, "aug_eval", dtype, 4, 7, 0)(
        float(t), _ptr(yc), _ptr(ay), _ptr(c), _ptr(sc), B,
        *[_ptr(x) for x in ref], _ptr(live), _ptr(red), _ptr(qr0))
    lib.aug_group_values.restype = ctypes.c_int
    n = lib.aug_group_values()
    assert n == PC.aug_group_values(plan)
    got = outs()
    gs, qr = buf(n), buf(lay.q_rows * B)
    _fn(lib, "aug_group", dtype, 4, 6, 1)(
        float(t), _ptr(yc), _ptr(ay), _ptr(c), _ptr(sc), B,
        *[_ptr(x) for x in got], _ptr(qr), _ptr(gs), gsz)
    return ay, ref, got


@pytest.mark.parametrize("gsz", GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", AUG_NAMES)
def test_reverse_group_walk_is_bitwise_the_thread_walk(aug_libs, name, dtype,
                                                       gsz):
    plan, packed, t, y = _plan(name, dtype)
    ay, ref, got = _reverse(aug_libs[name], plan, packed, t, y, dtype, gsz)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _same(a, b), (name, i, float((a - b).abs().max()))
    B = y.shape[0]
    lay = PC.aug_layout(plan)
    want = PA.aug_terms(plan, packed, t, y.t().contiguous(),
                        ay.t().contiguous())
    nq = lay.n_quad + lay.time_input
    f, vy, xq, xs = got
    pairs = [(f[:B * plan.out_rows].view(B, -1).t(), want[0]),
             (vy[:B * plan.dim].view(B, -1).t(), want[1]),
             (xq[:lay.n_quad * B].view(-1, B), want[2]),
             (xs[:lay.n_sample * B].view(-1, B), want[3]),
             (xq[lay.n_quad * B:nq * B].view(-1, B),
              want[4] if lay.time_input else want[4][:0])]
    for i, (a, b) in enumerate(pairs):
        assert a.shape == b.shape and _near(a, b, dtype), (name, i)


def test_group_walk_source_depends_on_structure_alone():
    """The same structure at another batch size and with other weights
    gives the same group walk; generation is deterministic; every uncoupled
    plan's source holds the group walk, a coupled one's none."""
    a1 = torch.tensor(np.random.RandomState(0).randn(2, 16))
    a2 = torch.tensor(np.random.RandomState(1).randn(2, 16))
    b2 = torch.tensor(np.random.RandomState(2).randn(16, 2))

    def f(a):
        return lambda t, y: torch.tanh(y @ a + t) @ b2

    p8, _ = PB.build_plan(f(a1), 0.0, torch.randn(8, 2, dtype=torch.float64))
    p12, _ = PB.build_plan(f(a2), 0.0,
                           torch.randn(12, 2, dtype=torch.float64))
    for host in ("perlane", "fixed", "perlane_adjoint", "fixed_adjoint"):
        src = PC.cuda_source(p8, host)
        assert src == PC.cuda_source(p12, host) == PC.cuda_source(p8, host)
        assert "group_walk" in src and "kGroupPhases" in src
    assert PC.group_values(p8) == PC.group_values(p12)
    assert PC.aug_group_values(p8) == PC.aug_group_values(p12)
    coupled = _plan("meanfield", torch.float64)[0]
    for host in ("solve", "adjoint"):
        assert "kGroupPhases = 0" in PC.cuda_source(coupled, host)


#: The launches' size checks (csrc/rk_fixed.cuh launch_rk_fixed_group,
#: rk_perlane.cuh launch_rk_perlane_group, rk_adjoint.cuh
#: launch_rk_perlane_adjoint and launch_rk_fixed_adjoint with csrc/
#: plan_rhs.cuh PlanLaneRhs and plan_aug.cuh PlanGroupAug).
_SIZES = """
using P = tfd::Plan;
using A = tfd::PlanAug;
extern "C" long k8_work(int S, int B, int group) {
  return tfd::group_solve_work_size(
      tfd::fixed_solve_slot_values(S, P::kDim, 0) +
          tfd::plan_solve_walk_values(P::kDim, P::kOutRows, P::kGroupValues),
      B, group, 0);
}
extern "C" long k5_work(int S, int B, int group) {
  return tfd::group_solve_work_size(
      tfd::perlane_solve_slot_values(S, P::kDim, 0) +
          tfd::plan_solve_walk_values(P::kDim, P::kOutRows, P::kGroupValues),
      B, group, 0);
}
static long aug_walk() {
  return tfd::plan_aug_walk_values(A::kQRows, A::kNSample, A::kGroupValues,
                                   A::kOutRows, A::kDim);
}
extern "C" long k6_work(int S, int B) {
  return tfd::lane_group_work_size(
      S, B, A::kDim, A::kNQuad + A::kTimeInput + A::kNSample, aug_walk());
}
extern "C" long k9_work(int S, int B) {
  return tfd::fixed_group_work_size(
      S, B, A::kDim, A::kNQuad + A::kTimeInput + A::kNSample, aug_walk(),
      A::kNQuad + A::kTimeInput);
}
"""


@pytest.mark.parametrize("name", ["spiral", "concat_t", "concat_scalar",
                                  "timedep"])
def test_group_sizes_match_the_wrappers(tmp_path, name):
    plan = _plan(name, torch.float64)[0]
    gen, aug = PC._Gen(plan), PC._AugGen(plan)
    src = ("#include <vector>\n#include \"plan_ops.cuh\"\n"
           "#include \"lane_group.h\"\n" + gen.body() + aug.body() + _SIZES)
    lib = _compile_all(tmp_path, {name: src})[name]
    for fn in ("k8_work", "k5_work", "k6_work", "k9_work"):
        getattr(lib, fn).restype = ctypes.c_long
    for S in (1, 4, 7):
        for B in (1, 33, 300, 4097):
            assert lib.k8_work(S, B, CP.FIXED_GROUP) == \
                CP.fixed_group_work(plan, S, B)
            assert lib.k5_work(S, B, CP.PERLANE_GROUP) == \
                CP.perlane_group_work(plan, S, B)
            assert lib.k6_work(S, B) == CP.aug_group_work(plan, S, B, False)
            assert lib.k9_work(S, B) == CP.aug_group_work(plan, S, B, True)
