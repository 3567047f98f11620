"""PyTorch port: numerics core and generic adaptive engine against the JAX
package.

Both packages get the same numpy inputs. Float64 throughout: the two run
the same arithmetic in the same order, so the pieces agree to 1e-13 and
whole solves take identical step sequences, with trajectories within
rtol 1e-10 (only reduction orders differ, at about 1e-16).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from problems import construct_problem
import tfdiffeq_tpu as J
from tfdiffeq_tpu.ops import controller as JC, norms as JN, rk as JR
from tfdiffeq_tpu.ops import tableaus as JT
from tfdiffeq_tpu.ops.pytree import flatten_state as j_flatten

import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch.ops import controller as PC, norms as PN, rk as PR
from tfdiffeq_tpu_torch.ops import tableaus as PT
from tfdiffeq_tpu_torch.ops.pytree import flatten_state as p_flatten

ADAPTIVE = ["dopri5", "bosh3", "adaptive_heun", "tsit5", "dopri8"]
_A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
F64 = torch.float64


def _tt(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# Torch twins of tests/problems.py, formula for formula.
_PORT_FUNCS = {
    "linear": lambda t, y: y @ _tt(_A).T,
    "sine": lambda t, y: torch.cos(t) / t - (y - 0.5) / t,
    "constant": lambda t, y: 0.2 + (y - (0.2 * t + 3.0)) ** 5,
}


# ---------------------------------------------------------------------------
# numerics core
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.RandomState(0)
    x, y0, y1, err = (rng.randn(7, 3) for _ in range(4))
    np.testing.assert_allclose(_np(PN.rms_norm(_tt(x))),
                               _np(JN.rms_norm(jnp.asarray(x))), rtol=1e-13)
    np.testing.assert_allclose(_np(PN.max_norm(_tt(x))),
                               _np(JN.max_norm(jnp.asarray(x))), rtol=1e-13)
    assert float(PN.rms_norm(torch.zeros(3, dtype=F64))) == 0.0
    for norm_p, norm_j in ((None, None), (PN.max_norm, JN.max_norm)):
        got = PN.error_ratio(_tt(err), 1e-6, 1e-8, _tt(y0), _tt(y1), norm_p)
        ref = JN.error_ratio(jnp.asarray(err), 1e-6, 1e-8, jnp.asarray(y0),
                             jnp.asarray(y1), norm_j)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-13)


@pytest.mark.parametrize("order", [1, 4, 7])
def test_select_initial_step_matches_reference(order):
    rng = np.random.RandomState(order)
    y0 = rng.randn(5, 2)
    fj = lambda t, y: jnp.tanh(y @ jnp.asarray(_A)) * (1.0 + t)
    fp = lambda t, y: torch.tanh(y @ _tt(_A)) * (1.0 + t)
    ref = JN.select_initial_step(fj, jnp.float64(0.5), jnp.asarray(y0),
                                 fj(0.5, jnp.asarray(y0)), order,
                                 jnp.float64(1e-6), jnp.float64(1e-8))
    got = PN.select_initial_step(fp, _tt(0.5), _tt(y0), fp(_tt(0.5), _tt(y0)),
                                 order, 1e-6, 1e-8)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-13)


@pytest.mark.parametrize("ratio", [0.0, 1e-9, 0.3, 1.0, 7.5, 2.0 ** 20])
@pytest.mark.parametrize("accepted", [True, False])
@pytest.mark.parametrize("pcoeff", [0.0, 0.4])
def test_next_step_size_matches_reference(ratio, accepted, pcoeff):
    ctrl_j = JC.StepController(pcoeff=pcoeff, icoeff=0.7 if pcoeff else 1.0)
    ctrl_p = PC.StepController(pcoeff=pcoeff, icoeff=0.7 if pcoeff else 1.0)
    dt_j, prev_j = JC.next_step_size(
        jnp.float64(0.13), jnp.float64(ratio), jnp.float64(0.6),
        jnp.asarray(accepted), 5, ctrl_j)
    dt_p, prev_p = PC.next_step_size(_tt(0.13), _tt(ratio), _tt(0.6),
                                     accepted, 5, ctrl_p)
    np.testing.assert_allclose(_np(dt_p), _np(dt_j), rtol=1e-13)
    np.testing.assert_allclose(_np(prev_p), _np(prev_j), rtol=1e-13)


@pytest.mark.parametrize("method", ADAPTIVE)
def test_rk_step_and_dense_output_match_reference(method):
    tab_j, tab_p = JT.TABLEAUS_BY_NAME[method], PT.TABLEAUS_BY_NAME[method]
    rng = np.random.RandomState(1)
    y0 = rng.randn(4)
    M = rng.randn(4, 4) * 0.5
    fj = lambda t, y: jnp.sin(jnp.asarray(M) @ y) + t
    fp = lambda t, y: torch.sin(_tt(M) @ y) + t
    t0, dt = 0.25, 0.1
    rj = JR.runge_kutta_step(fj, jnp.asarray(y0), fj(t0, jnp.asarray(y0)),
                             jnp.float64(t0), jnp.float64(dt), tab_j)
    rp = PR.runge_kutta_step(fp, _tt(y0), fp(_tt(t0), _tt(y0)), _tt(t0),
                             _tt(dt), tab_p)
    assert rp.n_evals == rj.n_evals
    for a, b in ((rp.y1, rj.y1), (rp.f1, rj.f1), (rp.delta, rj.delta)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-13, atol=1e-15)
    # The error estimate and the higher dense-output coefficients cancel
    # terms of size dt * |k| ~ 0.1: their rounding is 1e-13 of those terms,
    # not of themselves.
    np.testing.assert_allclose(_np(rp.y_err), _np(rj.y_err), rtol=0,
                               atol=1e-14)
    cj = JR.interp_fit(tab_j, jnp.asarray(y0), rj.y1, fj(t0, y0), rj.f1,
                       rj.k, jnp.float64(dt))
    cp = PR.interp_fit(tab_p, _tt(y0), rp.y1, fp(_tt(t0), _tt(y0)), rp.f1,
                       rp.k, _tt(dt))
    for a, b in zip(cp, cj):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-13, atol=1e-14)
    tq = np.array([0.25, 0.28, 0.35])
    np.testing.assert_allclose(
        _np(PR.interp_evaluate(cp, _tt(t0), _tt(dt), _tt(tq))),
        _np(JR.interp_evaluate(cj, jnp.float64(t0), jnp.float64(dt),
                               jnp.asarray(tq))), rtol=1e-13, atol=1e-15)


def test_kahan_add_matches_reference_engine_update():
    y, comp, delta = np.array([1.0, 1e8]), np.array([1e-17, -3e-9]), \
        np.array([1e-16, 1e-8])
    adj = delta - comp
    y_new = y + adj
    got_y, got_c = PR.kahan_add(_tt(y), _tt(comp), _tt(delta))
    np.testing.assert_array_equal(_np(got_y), y_new)
    np.testing.assert_array_equal(_np(got_c), (y_new - y) - adj)


def test_flatten_state_matches_reference_order():
    rng = np.random.RandomState(2)
    tree = {"b": (rng.randn(2, 3), rng.randn(4)), "a": rng.randn(3)}
    flat_j, _ = j_flatten(jax.tree_util.tree_map(jnp.asarray, tree))
    flat_p, unravel = p_flatten({"b": (_tt(tree["b"][0]), _tt(tree["b"][1])),
                                 "a": _tt(tree["a"])})
    np.testing.assert_array_equal(_np(flat_p), np.asarray(flat_j))
    back = unravel(torch.stack([flat_p, 2 * flat_p]))     # [2, N] at once
    np.testing.assert_array_equal(_np(back["b"][0][1]), 2 * tree["b"][0])
    np.testing.assert_array_equal(_np(back["a"][0]), tree["a"])


# ---------------------------------------------------------------------------
# generic engine
# ---------------------------------------------------------------------------

def _opts(method):
    # dopri8's HNW first step is so short that the error estimate of the
    # first attempt is rounding noise (about 1e-3 relative between the
    # reference's fused XLA arithmetic and the eager port), which shifts
    # the next step size without changing any count; a first step of 0.5
    # keeps every error estimate above rounding.
    return {"first_step": 0.5} if method == "dopri8" else {}


def _tols(method):
    return (1e-4, 1e-6) if method == "adaptive_heun" else (1e-6, 1e-8)


def _compare(problem, method, reverse):
    pr = construct_problem(problem, reverse=reverse)
    rtol, atol = _tols(method)
    ref = J.solve(pr.func, pr.y0, pr.t, rtol=rtol, atol=atol, method=method,
                  options={"loop": "while", **_opts(method)})
    got = P.solve(_PORT_FUNCS[problem], _tt(pr.y0), _tt(pr.t), rtol=rtol,
                  atol=atol, method=method, options=_opts(method))
    assert list(got.stats) == [int(s) for s in ref.stats]
    np.testing.assert_allclose(_np(got.ys), np.asarray(ref.ys), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("method", ADAPTIVE)
def test_solve_matches_reference(method, reverse):
    _compare("linear", method, reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("problem", ["sine", "constant"])
def test_solve_time_dependent_problems_match_reference(problem, reverse):
    _compare(problem, "dopri5", reverse)


def test_tuple_and_dict_states_match_reference():
    rng = np.random.RandomState(3)
    a, b = rng.randn(2), rng.randn(3)
    t = np.linspace(0.0, 2.0, 5)
    ref = J.solve(lambda tt, s: {"a": -s["b"][:2], "b": jnp.cos(s["b"])
                                 + s["a"][0]},
                  {"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(t),
                  rtol=1e-7, atol=1e-9, options={"loop": "while"})
    got = P.solve(lambda tt, s: {"a": -s["b"][:2], "b": torch.cos(s["b"])
                                 + s["a"][0]},
                  {"a": _tt(a), "b": _tt(b)}, _tt(t), rtol=1e-7, atol=1e-9)
    assert list(got.stats) == [int(s) for s in ref.stats]
    for k in ("a", "b"):
        assert got.ys[k].shape == (5,) + ref.ys[k].shape[1:]
        np.testing.assert_allclose(_np(got.ys[k]), np.asarray(ref.ys[k]),
                                   rtol=1e-10, atol=1e-12)
    tup = P.solve(lambda tt, s: (-s[1][:2], torch.cos(s[1]) + s[0][0]),
                  (_tt(a), _tt(b)), _tt(t), rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(_np(tup.ys[1]), _np(got.ys["b"]))


@pytest.mark.parametrize("options", [
    {"max_num_steps": 7},
    {"norm": "max"},
    {"pcoeff": 0.3, "icoeff": 0.6, "safety": 0.8},
    {"ifactor": 3.0, "dfactor": 0.5, "first_step": 0.02},
    {"dt_min": 0.5, "first_step": 1.0},
])
def test_solve_options_match_reference(options):
    pr = construct_problem("linear")
    ref = J.solve(pr.func, pr.y0, pr.t, rtol=1e-6, atol=1e-8,
                  options={"loop": "while", **options})
    got = P.solve(_PORT_FUNCS["linear"], _tt(pr.y0), _tt(pr.t), rtol=1e-6,
                  atol=1e-8, options=options)
    assert list(got.stats) == [int(s) for s in ref.stats]
    np.testing.assert_allclose(_np(got.ys), np.asarray(ref.ys), rtol=1e-10,
                               atol=1e-12)


def test_loop_options_are_no_ops_and_max_steps_is_refused():
    pr = construct_problem("sine")
    f = _PORT_FUNCS["sine"]
    base = P.solve(f, _tt(pr.y0), _tt(pr.t))
    same = P.solve(f, _tt(pr.y0), _tt(pr.t), options={
        "loop": "bounded", "unroll": 4, "chunk_size": 8})
    assert same.stats == base.stats
    assert torch.equal(same.ys, base.ys)
    with pytest.raises(ValueError, match="max_num_steps"):
        P.solve(f, _tt(pr.y0), _tt(pr.t), options={"max_steps": 64})
    with pytest.raises(ValueError, match="loop mode"):
        P.solve(f, _tt(pr.y0), _tt(pr.t), options={"loop": "scan"})
    with pytest.raises(TypeError, match="Unknown solver options"):
        P.solve(f, _tt(pr.y0), _tt(pr.t), options={"bogus": 1})


@pytest.mark.parametrize("method,options", [
    ("adams", {}), ("fixed_adams", {}),
    ("hyper_euler", {"hypernet": lambda t, y, f: 0.0 * y})],
    ids=["adams-item 12", "fixed_adams-item 12", "hyper_euler-item 13"])
def test_unported_methods_name_their_roadmap_item(method, options):
    """The Adams family (ROADMAP item 12) and the hypersolvers (item 13),
    once refused here, now solve as the reference does
    (tests/test_torch_adams.py and tests/test_torch_hyper.py hold them to
    the reference in full); a zero hypernet leaves hyper_euler's euler
    step."""
    res = P.solve(lambda t, y: -y, torch.ones(2, dtype=torch.float64),
                  [0.0, 0.5, 1.0], method=method, options=options)
    assert res.stats.status == 0
    if method == "hyper_euler":
        ref = P.solve(lambda t, y: -y, torch.ones(2, dtype=torch.float64),
                      [0.0, 0.5, 1.0], method="euler")
        np.testing.assert_allclose(res.ys.numpy(), ref.ys.numpy(),
                                   rtol=1e-12)
        return
    np.testing.assert_allclose(res.ys[-1].numpy(), np.exp(-1.0), rtol=1e-2)


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_fixed_grid_methods_are_ported(method):
    """The fixed-grid methods (once refused here, ROADMAP item 4) solve
    as the reference does (tests/test_torch_fixed_grid.py holds them to it
    in full)."""
    t = np.array([0.0, 0.5, 1.0])
    ref = J.solve(lambda tt, y: -y, jnp.ones(2, jnp.float64), jnp.asarray(t),
                  method=method)
    res = P.solve(lambda tt, y: -y, torch.ones(2, dtype=F64), _tt(t),
                  method=method)
    np.testing.assert_allclose(res.ys.numpy(), np.asarray(ref.ys),
                               rtol=1e-14)
    assert list(res.stats) == [int(x) for x in ref.stats]


@pytest.mark.parametrize("options,item", [
    ({"fuse": True, "dot_precision": "mixed"}, "item 16"),
    ({"dense_output": True}, None), ({"telemetry": True}, None)],
    ids=["fuse-item 16", "dense_output-item 3", "telemetry-item 3"])
def test_unported_options_name_their_roadmap_item(options, item):
    # 'fuse' runs the fused tier with every method
    # (tests/test_torch_fuse.py), and with K4's reduced tiers at a plan's
    # dots (item 16, once refused here; tests/test_torch_plan_tiers.py
    # holds them to the reference): a plan with no dot solves as at
    # 'highest'. dense_output and telemetry (once refused here, ROADMAP
    # item 3) run and match the reference's bounded loop
    # (tests/test_torch_dense_output.py holds them in full).
    if item is not None:
        got = P.solve(lambda t, y: -y, torch.ones(2), [0.0, 1.0],
                      options={**options, "first_step": 0.1})
        ref = P.solve(lambda t, y: -y, torch.ones(2), [0.0, 1.0],
                      options={"fuse": True, "first_step": 0.1})
        assert got.stats.status == 0
        assert torch.equal(got.ys, ref.ys)
        return
    got = P.solve(lambda t, y: -y, torch.ones(2, dtype=F64), _tt([0.0, 1.0]),
                  options={**options, "first_step": 0.1})
    ref = J.solve(lambda t, y: -y, jnp.ones(2, jnp.float64),
                  jnp.asarray([0.0, 1.0]),
                  options={**options, "first_step": 0.1, "max_steps": 64})
    assert list(got.stats) == [int(s) for s in ref.stats]
    if "telemetry" in options:
        n = got.telemetry.dt.shape[0]
        assert n == int(np.asarray(ref.telemetry.active).sum())
        # The error ratio's cancellation drifts the step sizes by about
        # eps / rtol (tests/test_torch_dense_output.py, its tolerances).
        np.testing.assert_allclose(got.telemetry.dt.numpy(),
                                   np.asarray(ref.telemetry.dt)[:n],
                                   rtol=0, atol=5e-8)
    else:
        q = np.linspace(0.0, 1.0, 7)
        np.testing.assert_allclose(got.dense.eval_flat(_tt(q)).numpy(),
                                   np.asarray(ref.dense.eval_flat(
                                       jnp.asarray(q))), rtol=0, atol=1e-11)


def test_odeint_returns_trajectory_and_raises_on_failure():
    pr = construct_problem("linear")
    ys = P.odeint(_PORT_FUNCS["linear"], _tt(pr.y0), _tt(pr.t))
    assert ys.shape == (10, 2)
    with pytest.raises(RuntimeError, match="MAX_STEPS_REACHED"):
        P.odeint(_PORT_FUNCS["linear"], _tt(pr.y0), _tt(pr.t),
                 options={"max_num_steps": 2})
    with pytest.raises(ValueError, match="monotonic"):
        P.odeint(_PORT_FUNCS["linear"], _tt(pr.y0), [0.0, 1.0, 0.5])


def test_port_imports_without_jax():
    code = ("import sys, tfdiffeq_tpu_torch, tfdiffeq_tpu_torch.fast, "
            "tfdiffeq_tpu_torch.convert, tfdiffeq_tpu_torch.ops.cuda_kernels;"
            " assert 'jax' not in sys.modules, 'jax imported';"
            " assert 'tfdiffeq_tpu' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_per_leaf_tolerances_match_reference():
    rng = np.random.RandomState(6)
    a, b = rng.randn(2), rng.randn(3)
    t = np.linspace(0.0, 1.5, 4)
    tol_j = {"a": 1e-8, "b": jnp.asarray([1e-5, 1e-7, 1e-6])}
    tol_p = {"a": 1e-8, "b": _tt([1e-5, 1e-7, 1e-6])}
    ref = J.solve(lambda tt, s: {"a": -s["a"] * s["b"][0],
                                 "b": jnp.sin(s["b"])},
                  {"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(t),
                  rtol=tol_j, atol=1e-9, options={"loop": "while"})
    got = P.solve(lambda tt, s: {"a": -s["a"] * s["b"][0],
                                 "b": torch.sin(s["b"])},
                  {"a": _tt(a), "b": _tt(b)}, _tt(t), rtol=tol_p, atol=1e-9)
    assert list(got.stats) == [int(s) for s in ref.stats]
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(got.ys[k]), np.asarray(ref.ys[k]),
                                   rtol=1e-10, atol=1e-12)


def test_register_solver_runs_a_custom_solver():
    from tfdiffeq_tpu_torch.odeint import SOLVERS, _CUSTOM_ALLOWED
    from tfdiffeq_tpu_torch.solvers.adaptive import (AdaptiveConfig,
                                                     solve_adaptive)

    def impl(prob, options, rtol, atol):
        return solve_adaptive(prob, AdaptiveConfig(PT.BOSH3), rtol, atol,
                              first_step=options.get("first_step"))

    P.register_solver("my_bosh3", "custom", impl, allowed={"first_step"})
    try:
        pr = construct_problem("sine")
        got = P.solve(_PORT_FUNCS["sine"], _tt(pr.y0), _tt(pr.t),
                      method="my_bosh3", options={"first_step": 0.1})
        ref = P.solve(_PORT_FUNCS["sine"], _tt(pr.y0), _tt(pr.t),
                      method="bosh3", options={"first_step": 0.1})
        assert got.stats == ref.stats and torch.equal(got.ys, ref.ys)
        with pytest.raises(TypeError, match="Unknown solver options"):
            P.solve(_PORT_FUNCS["sine"], _tt(pr.y0), _tt(pr.t),
                    method="my_bosh3", options={"safety": 0.5})
    finally:
        SOLVERS.pop("my_bosh3")
        _CUSTOM_ALLOWED.pop("my_bosh3")
