"""PyTorch port: K15's plain version (`ops/plan_adjoint.py`), its generated
code's contract, and the plain plan adjoint sweeps of `ops/cuda_plan.py`
against the JAX package.

- `eval_plan_aug` on every plan of tests/test_torch_plan_bridge.py that
  the reverse walk takes, and on a set that reaches every instruction kind
  and constant layout (the couplings with exact ties, clamp, pow, div,
  slices, feature sums, the 'batch' and 'bvec' per-sample constants and a
  learnable 0-d scalar), against `torch.func.vjp` of `eval_plan`: f, v_y,
  v_t and every packed constant's cotangent within 1e-12 relative to the
  largest entry in float64 and 1e-5 in float32 (the same function,
  differentiated by autograd's rules in another order of sums).
- The plain `plan_adjoint_solve`, `plan_perlane_adjoint_solve` and
  `plan_adjoint_solve_fixed` against the reference's kernels in interpret
  mode with pack=1, on the same plans, ys and g in float64: ay0, every
  constant's cotangent and a_t within 1e-9 relative to the largest entry
  (the same sweep, the batch sums in another order), and the step counts
  equal where the reference's controller is the port's (K3, K9; the
  reference's per-lane sweep is compared on its answers and lane counts).
- The capture for training: a 0-d tensor that requires grad becomes a
  'scalar' constant, so two values of it give one plan and one source;
  `build_plan` hands back the user's tensors (or their transpose) as
  sources; `check_plan_adjoint` rejects what the reference rejects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.ops import jaxpr_bridge as JB
from tfdiffeq_tpu.ops import pallas_fixed as JPF
from tfdiffeq_tpu.ops import plan_adjoint as JPA
from tfdiffeq_tpu_torch.ops import cuda_plan as CP
from tfdiffeq_tpu_torch.ops import plan_adjoint as PA
from tfdiffeq_tpu_torch.ops import plan_bridge as PB
from tfdiffeq_tpu_torch.ops import plan_codegen as PC

from test_torch_plan_bridge import NAMES, T0, _dyn

RNG = np.random.RandomState(11)
WX1 = RNG.randn(2, 6) * 0.4
WX2 = RNG.randn(6, 2) * 0.4
DRIVE = RNG.randn(8, 2) * 0.5
BV8 = RNG.randn(8) * 0.3
YX = np.random.RandomState(4).randn(8, 2)
# Rows 0 and 3 tie for the batch max of feature 0, rows 2 and 5 for the
# min of feature 1.
YT = YX.copy()
YT[3, 0] = YT[0, 0] = np.max(YX[:, 0]) + 0.5
YT[5, 1] = YT[2, 1] = np.min(YX[:, 1]) - 0.5


def _extra(xp, dtype):
    """Dynamics that reach every instruction kind and constant layout."""
    tor = xp is torch
    K = {n: (torch.tensor(a, dtype=dtype) if tor else jnp.asarray(a, dtype))
         for n, a in (("W1", WX1), ("W2", WX2), ("DR", DRIVE),
                      ("BV", BV8))}
    k = (torch.tensor(0.7, dtype=dtype, requires_grad=True) if tor
         else jnp.asarray(0.7, dtype))

    def amax(y, axis=None, mn=False):
        if tor:
            if axis is None:
                return y.amin() if mn else y.amax()
            return y.amin(axis) if mn else y.amax(axis)
        return jnp.min(y, axis=axis) if mn else jnp.max(y, axis=axis)

    def ysum(y, axis=None, keep=False):
        if tor:
            return y.sum() if axis is None else y.sum(axis, keepdim=keep)
        return jnp.sum(y, axis=axis, keepdims=keep)

    def clip(y, lo, hi):
        return torch.clamp(y, lo, hi) if tor else jnp.clip(y, lo, hi)

    def maximum(a, b):
        return torch.maximum(a, b) if tor else jnp.maximum(a, b)

    def rsqrt(x):
        return torch.rsqrt(x) if tor else jax_rsqrt(x)

    return {
        "ties_bmax": (lambda t, y: y - amax(y, 0) + 0.1 * amax(y, 0, True),
                      YT),
        "scalar_bmax": (lambda t, y: y * 0.1 - 0.2 * amax(y), YT),
        "scalar_bsum": (lambda t, y: y * 0.1 - 0.01 * ysum(y) * y, YX),
        "clamp_div_pow": (lambda t, y: clip(y, -0.5, 0.8) / (1.5 + y * y)
                          + (1.0 + y * y) ** 1.5, YX),
        "max_tie": (lambda t, y: maximum(y, y * 1.0) + maximum(y, 0.3 * t),
                    YX),
        "slices": (lambda t, y: xp.concatenate([y[:, 1:2] * y[:, 0:1],
                                                -y[:, 0:1]], 1)
                   if not tor else torch.cat([y[:, 1:2] * y[:, 0:1],
                                              -y[:, 0:1]], 1), YX),
        "feature_sum": (lambda t, y: y - 0.3 * ysum(y, 1, True)
                        + rsqrt(2.0 + y * y) + (1.5 + y * y) ** -2, YX),
        "log_sqrt_abs": (lambda t, y: xp.log(1.5 + y * y) * xp.sqrt(
            2.0 + xp.abs(y)), YX),
        "batch_const": (lambda t, y: xp.tanh(y @ K["W1"]) @ K["W2"]
                        + K["DR"] * y, YX),
        "bvec_const": (lambda t, y: y * K["BV"][:, None] if tor
                       else y * K["BV"][:, None], YX),
        "scalar_param": (lambda t, y: -k * y + xp.sin(t) * y ** 3, YX),
    }


def jax_rsqrt(x):
    import jax
    return jax.lax.rsqrt(x)


def _plan(f, y0, dtype):
    y = torch.tensor(y0, dtype=dtype)
    t = torch.tensor(T0, dtype=dtype)
    plan, consts = PB.build_plan(f, t, y)
    return plan, PB.pack_consts(plan, consts, dtype), t, y


def _rel(a, b) -> float:
    a = np.asarray(torch.as_tensor(a).detach(), np.float64)
    b = np.asarray(torch.as_tensor(b).detach(), np.float64)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(np.max(np.abs(b), initial=0.0), 1e-30))


def _aug_cases(dtype):
    cases = dict(_dyn(torch, dtype))
    cases.update(_extra(torch, dtype))
    return cases


AUG_NAMES = [n for n in NAMES if n != "b1_mean_exp"] + sorted(
    _extra(torch, torch.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", AUG_NAMES)
def test_eval_plan_aug_matches_vjp(name, dtype):
    f, y0 = _aug_cases(dtype)[name]
    plan, packed, t, y = _plan(f, y0, dtype)
    PB.check_plan_adjoint(plan)
    B = y.shape[0]
    ay = torch.tensor(np.random.RandomState(3).randn(plan.out_rows, B),
                      dtype=dtype)
    yT = y.t().contiguous()

    def fn(yy, tt, *cv):
        return PB.eval_plan_host(plan, list(cv), tt, yy.t()).t()

    out, vjp = torch.func.vjp(fn, yT, t, *packed)
    want = vjp(ay)
    f_, v_y, dconsts, v_t = PA.eval_plan_aug(plan, packed, t, yT, ay)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(f_, out) <= tol
    assert _rel(v_y, want[0]) <= tol, (name, _rel(v_y, want[0]))
    assert v_t.shape == (1, B)
    assert abs(float(v_t.sum() - want[1])) <= tol * max(
        1.0, float(want[1].abs())), name
    assert len(dconsts) == len(packed)
    for i, (d, w, p) in enumerate(zip(dconsts, want[2:], packed)):
        assert d.shape == p.shape, (name, i)
        assert _rel(d, w) <= tol, (name, i, _rel(d, w))
    # parts: the dynamics alone, and the quadratures alone.
    f2, vy2 = PA.eval_plan_aug(plan, packed, t, yT, ay, parts="dyn")
    assert torch.equal(f2, f_) and torch.equal(vy2, v_y)
    dc2, vt2 = PA.eval_plan_aug(plan, packed, t, yT, ay, parts="quad")
    assert torch.equal(vt2, v_t)
    assert all(torch.equal(a, b) for a, b in zip(dc2, dconsts))


def test_ties_split_evenly():
    """Exact ties of a batch max share its cotangent (JAX's reduce_max
    VJP, the reference's tie split)."""
    plan, packed, t, y = _plan(lambda t, yy: yy - yy.amax(0), YT,
                               torch.float64)
    ay = torch.ones((2, y.shape[0]), dtype=torch.float64)
    _, v_y, _, _ = PA.eval_plan_aug(plan, packed, t, y.t().contiguous(), ay)
    # The batch max's cotangent (sum over the batch of -1 = -B) splits over
    # the two tied samples of feature 0.
    B = y.shape[0]
    assert float(v_y[0, 0]) == pytest.approx(1.0 - B / 2)
    assert float(v_y[0, 3]) == pytest.approx(1.0 - B / 2)
    assert float(v_y[0, 1]) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# The plain sweeps against the reference's kernels
# ---------------------------------------------------------------------------

SWEEP = ["spiral", "mlp", "timedep", "concat_t", "gelu_exact", "meanfield",
         "bmax", "batch_const"]


def _sweep_inputs(name, dtype=torch.float64):
    f, y0 = _aug_cases(dtype)[name]
    plan, packed, _, y = _plan(f, 0.5 * y0, dtype)
    B, D = y.shape
    rs = np.random.RandomState(5)
    T = 5
    # Near y0 at half its scale: the cubic dynamics stay tame backward.
    ys = 0.5 * np.concatenate([y0[None],
                               y0[None] + 0.2 * rs.randn(T - 1, B, D)])
    g = rs.randn(T, B, D)
    tau = np.linspace(0.0, 1.0, T)
    return plan, packed, ys, g, tau


def _ref_sweep_inputs(name):
    jf = {**_dyn(jnp, jnp.float64), **_extra(jnp, jnp.float64)}[name][0]
    _, _, ys, g, tau = _sweep_inputs(name)
    B = ys.shape[1]
    jplan, jc = JB.build_plan(jf, jnp.float64(T0), jnp.asarray(ys[0]))
    assert jplan.batch == B
    # The reference's kernels pad the batch to 128 lanes.
    jpacked = JB.pack_consts(jplan, jc, jnp.float64, max(128, B))
    return (jplan, jpacked, jnp.asarray(ys.transpose(0, 2, 1)),
            jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau))


def _sweep_tol(name):
    """1e-9; the exact GELU 1e-6: the reference's erf is Abramowitz &
    Stegun's (1.5e-7 absolute, jaxpr_bridge.py:73-96), the port's
    PyTorch's own."""
    return 1e-6 if name == "gelu_exact" else 1e-9


def _check_consts(plan, dconsts, jdconsts, tol):
    for lay, d, jd in zip(plan.const_layouts, dconsts, jdconsts):
        jd = np.asarray(jd)
        if lay[0] == "unused":
            continue
        if lay[0] == "scalar":
            jd = jd.reshape(())
        elif lay[0] in ("batch", "bvec"):
            jd = jd[:, :d.shape[1]]
        else:
            jd = jd[:d.shape[0], :d.shape[1]]
        assert _rel(d, jd) <= tol, (lay, _rel(d, jd))


@pytest.mark.parametrize("name", SWEEP)
def test_plain_adjoint_sweep_matches_reference(name):
    plan, packed, ys, g, tau = _sweep_inputs(name)
    f64 = torch.float64
    ay0, dconsts, at, stats = CP.plan_adjoint_solve(
        plan, packed, torch.tensor(ys, dtype=f64), torch.tensor(g, dtype=f64),
        torch.tensor(tau, dtype=f64), 0.05, 1e-7, 1e-9, 1.0)
    jplan, jpacked, jys, jg, jtau = _ref_sweep_inputs(name)
    jay0, jdc, jat, jst = JPA.plan_adjoint_solve(
        jplan, tuple(jpacked), jys, jg, jtau, 0.05, 1e-7, 1e-9, 1.0,
        interpret=True, pack=1)
    assert [int(x) for x in stats] == [int(x) for x in jst]
    tol = _sweep_tol(name)
    assert _rel(ay0, np.asarray(jay0).T) <= tol
    assert abs(float(at) - float(jat)) <= tol * max(1.0, abs(float(jat)))
    _check_consts(plan, dconsts, jdc, tol)


@pytest.mark.parametrize("name", ["mlp", "timedep", "batch_const"])
def test_plain_perlane_adjoint_sweep_matches_reference(name):
    plan, packed, ys, g, tau = _sweep_inputs(name)
    f64 = torch.float64
    ay0, dconsts, at, stats, lane = CP.plan_perlane_adjoint_solve(
        plan, packed, torch.tensor(ys, dtype=f64), torch.tensor(g, dtype=f64),
        torch.tensor(tau, dtype=f64), 0.05, 1e-7, 1e-9, 1.0)
    jplan, jpacked, jys, jg, jtau = _ref_sweep_inputs(name)
    jay0, jdc, jat, jst, jlane = JPA.plan_perlane_adjoint_solve(
        jplan, tuple(jpacked), jys, jg, jtau, jnp.full((1, 1), 0.05), 1e-7,
        1e-9, 1.0, interpret=True)
    np.testing.assert_array_equal(lane.numpy(),
                                  np.asarray(jlane)[:, :lane.shape[1]])
    assert _rel(ay0, np.asarray(jay0).T) <= 1e-9
    assert abs(float(at) - float(jat)) <= 1e-9 * max(1.0, abs(float(jat)))
    _check_consts(plan, dconsts, jdc, 1e-9)
    assert int(stats[3]) == 0


@pytest.mark.parametrize("name", ["spiral", "timedep", "batch_const"])
def test_plain_fixed_adjoint_sweep_matches_reference(name):
    plan, packed, ys, g, tau = _sweep_inputs(name)
    f64 = torch.float64
    ay0, dconsts, at, stats = CP.plan_adjoint_solve_fixed(
        plan, packed, torch.tensor(ys, dtype=f64), torch.tensor(g, dtype=f64),
        torch.tensor(tau, dtype=f64), 1.0, num_steps=3, method="rk4")
    jplan, jpacked, jys, jg, jtau = _ref_sweep_inputs(name)
    jay0, jdc, jat, jst = JPF.plan_adjoint_solve_fixed(
        jplan, tuple(jpacked), jys, jg, jtau, 1.0, num_steps=3,
        method="rk4", interpret=True, pack=1)
    assert [int(x) for x in stats] == [int(x) for x in jst]
    assert _rel(ay0, np.asarray(jay0).T) <= 1e-9
    assert abs(float(at) - float(jat)) <= 1e-9 * max(1.0, abs(float(jat)))
    _check_consts(plan, dconsts, jdc, 1e-9)


def test_sweep_refusals():
    plan, packed, ys, g, tau = _sweep_inputs("meanfield")
    args = (plan, packed, torch.tensor(ys), torch.tensor(g),
            torch.tensor(tau))
    with pytest.raises(ValueError, match="batch-coupled"):
        CP.plan_perlane_adjoint_solve(*args, 0.05, 1e-7, 1e-9, 1.0)
    # A coupled plan's fixed-grid sweep, once refused here (ROADMAP queue 1
    # item 16), runs K9's one-block route (its plain version on the CPU;
    # tests/test_torch_coupled_adjoint.py holds it to the reference).
    ay0, dconsts, _, stats = CP.plan_adjoint_solve_fixed(*args, 1.0)
    assert [int(x) for x in stats] == [4 * 4, 4, 0, 0]
    assert torch.isfinite(ay0).all()
    assert all(torch.isfinite(d).all() for d in dconsts)
    plan2, packed2, ys2, g2, tau2 = _sweep_inputs("spiral")
    with pytest.raises(ValueError, match="the plan takes"):
        CP.plan_adjoint_solve(plan2, packed2, torch.tensor(ys2[:, :4]),
                              torch.tensor(g2[:, :4]), torch.tensor(tau2),
                              0.05, 1e-7, 1e-9, 1.0)


# ---------------------------------------------------------------------------
# The capture for training
# ---------------------------------------------------------------------------

def test_learnable_scalar_is_a_constant_of_one_structure():
    y = torch.tensor(YX)
    k1 = torch.nn.Parameter(torch.tensor(0.7, dtype=torch.float64))
    k2 = torch.nn.Parameter(torch.tensor(-1.3, dtype=torch.float64))
    p1, c1 = PB.build_plan(lambda t, yy: -k1 * yy, 0.0, y)
    p2, c2 = PB.build_plan(lambda t, yy: -k2 * yy, 0.0, y)
    assert p1 == p2 and ("scalar",) in p1.const_layouts
    assert c1[p1.const_layouts.index(("scalar",))] is k1
    assert not any(ins[0] == "litv" and ins[2] == 0.7 for ins in p1.instrs)
    for host in PC.AUG_HOSTS:
        assert PC.cuda_source(p1, host) == PC.cuda_source(p2, host)
    # A 0-d tensor without a gradient stays a literal of the plan.
    k3 = torch.tensor(0.7, dtype=torch.float64)
    p3, _ = PB.build_plan(lambda t, yy: -k3 * yy, 0.0, y)
    assert ("scalar",) not in p3.const_layouts


def test_sources_keep_the_users_tensors():
    W = torch.nn.Parameter(torch.tensor(WX1))
    y = torch.tensor(YX)
    plan, consts = PB.build_plan(lambda t, yy: torch.tanh(yy @ W) @ W.t(),
                                 0.0, y)
    assert any(c is W for c in consts)
    packed = PB.pack_consts(plan, consts, torch.float64,
                            differentiable=True)
    assert all(p.requires_grad for p, lay in zip(packed, plan.const_layouts)
               if lay[0] == "wT")
    # Tied: both packed weights lead back to W, and their cotangents sum.
    (sum(p.sum() for p in packed)).backward()
    assert torch.allclose(W.grad, torch.full_like(W, 2.0))
    assert not any(p.requires_grad
                   for p in PB.pack_consts(plan, consts, torch.float64))


def test_check_plan_adjoint_and_uses_t_match_reference():
    y = torch.tensor(YX, dtype=torch.float32)
    jy = jnp.asarray(YX, jnp.float32)
    plan, _ = PB.build_plan(lambda t, yy: yy - yy.amax(1, keepdim=True),
                            0.0, y)
    with pytest.raises(PB.FusionError, match="reduce_max"):
        PB.check_plan_adjoint(plan)
    jplan, _ = JB.build_plan(
        lambda t, yy: yy - jnp.max(yy, axis=-1, keepdims=True), 0.0, jy)
    with pytest.raises(JB.FusionError, match="reduce_max"):
        JPA.check_plan_adjoint(jplan)
    A = torch.tensor(np.array([[-0.1, 2.0], [-2.0, -0.1]]),
                     dtype=torch.float32)
    p1, _ = PB.build_plan(lambda t, yy: (yy ** 3) @ A, 0.0, y)
    p2, _ = PB.build_plan(lambda t, yy: torch.sin(t) * yy, 0.0, y)
    assert not PB.plan_uses_t(p1) and PB.plan_uses_t(p2)
    assert PB._true_elems(p1) == 4
