"""PyTorch port: the fixed-grid solvers (`solvers/fixed_grid.py`; `solve`
and `odeint` with euler, midpoint, rk4 and rk4_38) against the JAX
package's `solve`.

Both packages get the same numpy inputs and run the same steps with the
same arithmetic in the same order, in float64: trajectories agree within
1e-12 (relative and absolute; the dynamics' own matrix products may sum in
another order, about 1e-16 a step), and NFE and step counts are identical,
NFE = 1 + stages * (G - 1) on a grid of G points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from problems import construct_problem
import tfdiffeq_tpu as J
from tfdiffeq_tpu.solvers.base import hermite_interp_at as j_hermite

import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch.solvers.base import hermite_interp_at as p_hermite

FIXED = {"euler": 1, "midpoint": 2, "rk4": 4, "rk4_38": 4}   # stages
_A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
F64 = torch.float64

# Torch twins of tests/problems.py, formula for formula.
_PORT_FUNCS = {
    "linear": lambda t, y: y @ torch.tensor(_A, dtype=F64).T,
    "sine": lambda t, y: torch.cos(t) / t - (y - 0.5) / t,
    "constant": lambda t, y: 0.2 + (y - (0.2 * t + 3.0)) ** 5,
}


def _tt(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _grid_constructor(lib):
    """An irregular grid over [t0, t_end] (denser at the start), the same
    values in both packages."""
    def gc(func, y0, t):
        u = np.linspace(0.0, 1.0, 11) ** 1.5
        t0, t1 = float(t[0]), float(t[-1])
        return lib(t0 + (t1 - t0) * u)
    return gc


OPTIONS = {
    "default": ({}, {}),
    "num_steps": ({"num_steps": 7}, {"num_steps": 7}),
    "step_size": ({"step_size": 0.3}, {"step_size": 0.3}),
    "grid_constructor": ({"grid_constructor": _grid_constructor(jnp.asarray)},
                         {"grid_constructor": _grid_constructor(_tt)}),
}


def _compare(name, method, j_opts, p_opts, reverse=False):
    pr = construct_problem(name, reverse=reverse)
    rj = J.solve(pr.func, pr.y0, pr.t, method=method, options=j_opts)
    rp = P.solve(_PORT_FUNCS[name], _tt(pr.y0), _tt(pr.t), method=method,
                 options=p_opts)
    np.testing.assert_allclose(rp.ys.numpy(), np.asarray(rj.ys), rtol=1e-12,
                               atol=1e-12)
    assert list(rp.stats) == [int(x) for x in rj.stats]
    return rp


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("method", sorted(FIXED))
def test_fixed_grid_matches_reference(method, option, reverse):
    """Every method, every grid option, both time directions."""
    j_opts, p_opts = OPTIONS[option]
    rp = _compare("sine", method, j_opts, p_opts, reverse)
    steps = rp.stats.n_accepted
    assert rp.stats.nfe == 1 + FIXED[method] * steps
    assert rp.stats.n_rejected == 0 and rp.stats.status == 0
    expected_steps = {"default": 9, "num_steps": 7, "step_size": 24,
                      "grid_constructor": 10}[option]
    assert steps == expected_steps


@pytest.mark.parametrize("name", ["linear", "constant"])
def test_fixed_grid_problems_match_reference(name):
    _compare(name, "rk4", {}, {})
    _compare(name, "midpoint", {"num_steps": 13}, {"num_steps": 13}, True)


def test_tuple_state_matches_reference():
    """A (tensor, tensor) state rides as one flat vector, as in the
    reference; output leaves keep their shapes."""
    rng = np.random.RandomState(0)
    a0, b0 = rng.randn(3), rng.randn(2, 2)
    t = np.linspace(0.0, 1.5, 6)

    def jf(tt, y):
        a, b = y
        return (-a * jnp.sum(b), jnp.sin(tt) * b - 0.3 * a[:2, None])

    def pf(tt, y):
        a, b = y
        return (-a * torch.sum(b), torch.sin(tt) * b - 0.3 * a[:2, None])

    rj = J.solve(jf, (jnp.asarray(a0), jnp.asarray(b0)), jnp.asarray(t),
                 method="rk4", options={"num_steps": 9})
    rp = P.solve(pf, (_tt(a0), _tt(b0)), _tt(t), method="rk4",
                 options={"num_steps": 9})
    for lp, lj in zip(rp.ys, rj.ys):
        assert tuple(lp.shape) == tuple(lj.shape)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-12,
                                   atol=1e-12)
    assert list(rp.stats) == [int(x) for x in rj.stats] == [37, 9, 0, 0]


def test_fixed_grid_convergence_order():
    """tests/test_odeint.py::test_fixed_grid_convergence_order on the
    port: rk4's global error scales as h^4."""
    pr = construct_problem("linear", npts=10)
    errs = {}
    for n in (40, 80):
        t = np.linspace(float(pr.t[0]), float(pr.t[-1]), n)
        ys = P.odeint(_PORT_FUNCS["linear"], _tt(pr.y0), _tt(t),
                      method="rk4")
        errs[n] = float(np.max(np.abs(ys.numpy()
                                      - np.asarray(pr.y_exact(t)))))
    rate = np.log2(errs[40] / errs[80])
    assert 3.5 < rate < 4.8, f"rk4 rate {rate}, errs {errs}"


def test_hermite_interp_matches_reference():
    rng = np.random.RandomState(3)
    grid = np.cumsum(rng.rand(9) + 0.1)
    ys, fs = rng.randn(9, 2, 3), rng.randn(9, 2, 3)
    ts = np.concatenate([[grid[0]], np.sort(rng.uniform(grid[0], grid[-1],
                                                        7)), [grid[-1]]])
    got = p_hermite(_tt(grid), _tt(ys), _tt(fs), _tt(ts))
    ref = j_hermite(jnp.asarray(grid), jnp.asarray(ys), jnp.asarray(fs),
                    jnp.asarray(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14,
                               atol=1e-14)


def test_grid_constructor_receives_user_func_and_y0():
    calls = {}

    def gc(func, y0, t):
        calls["y0_is_dict"] = isinstance(y0, dict)
        _ = func(t[0], y0)["a"]        # a call in the caller's own terms
        return torch.linspace(float(t[0]), float(t[-1]), 33, dtype=F64)

    ys = P.odeint(lambda t, y: {"a": -y["a"]}, {"a": torch.ones(3, dtype=F64)},
                  torch.tensor([0.0, 1.0], dtype=F64), method="rk4",
                  options={"grid_constructor": gc})
    assert calls["y0_is_dict"]
    np.testing.assert_allclose(ys["a"][-1].numpy(), np.exp(-1.0) * np.ones(3),
                               rtol=1e-5)


def test_fixed_grid_options_are_checked():
    f = lambda t, y: -y
    y0, t = torch.ones(2, dtype=F64), torch.tensor([0.0, 1.0], dtype=F64)
    for opts in ({"first_step": 0.1}, {"max_num_steps": 4}, {"loop": "while"},
                 {"per_sample": True}):
        with pytest.raises(TypeError, match="Unknown solver options"):
            P.solve(f, y0, t, method="rk4", options=opts)
    with pytest.raises(TypeError, match="step_size"):
        P.solve(f, y0, t, method="dopri5", options={"step_size": 0.5})
    with pytest.raises(ValueError, match="num_steps must be >= 1"):
        P.solve(f, y0, t, method="euler", options={"num_steps": 0})
    # 'fuse' runs K8 with the plan, a batch coupling too (on its one
    # block): the generic solve's steps, to roundoff.
    yc = torch.tensor([[1.0, 0.0], [0.0, 2.0], [3.0, -1.0]], dtype=F64)
    fused = P.solve(lambda t, y: y - y.mean(0), yc, t, method="rk4",
                    options={"fuse": True, "num_steps": 8})
    plain = P.solve(lambda t, y: y - y.mean(0), yc, t, method="rk4",
                    options={"num_steps": 8})
    assert list(fused.stats) == list(plain.stats)
    np.testing.assert_allclose(fused.ys.numpy(), plain.ys.numpy(),
                               rtol=1e-13, atol=1e-13)
    one = P.solve(f, y0, torch.tensor([0.5], dtype=F64), method="rk4")
    assert list(one.stats) == [0, 0, 0, 0] and torch.equal(one.ys[0], y0)
