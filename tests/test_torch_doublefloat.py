"""PyTorch port: the float64 tier (`solve_df`, `odeint_df`,
`odeint_adjoint_df`, `tfdiffeq_tpu_torch/ops/doublefloat.py`) against the
JAX package.

The reference carries double-floats on a float32 chip; the port solves in
native float64 (K2 with the plan's K14 forward, K3 with K15 backward; their
plain versions here on the CPU). So each behaviour test of
tests/test_doublefloat.py is held to the reference's two yardsticks on the
same numpy inputs (A32, RandomState(1) states [16, 2], 32 times over
[0, 25]):

- the JAX float64 oracle (`solve` with x64, rtol 1e-12 / atol 1e-14,
  loop='while'), at the reference's own bar of 1e-6 (its gradients at 2e-6
  relative to each gradient's largest entry);
- the JAX `solve_df` (and `odeint_adjoint_df`) at 1e-6: two float64-grade
  solves of one problem, each within its tolerance of the truth.

The port's float64 solve follows the JAX package's float64 `solve` step
for step at the same tolerances (equal nfe, accepted and rejected counts);
the trajectories then differ by the two libraries' last bits carried
through the steps, measured at 4.5e-15 on [0, 5] from float64 inputs (bar
1e-12) and at float32's rounding of the output from float32 inputs.

Not ported, so not tested here: the double-float arithmetic
(tests/test_doublefloat.py:37-53: `two_sum`, `two_prod`, `df_*`, which
exist only for a chip without float64) and `jax.jit` of `solve_df`
(:115: eager PyTorch has no trace to take).

The port's own contract: float32 in, float32 out (float64 in, float64
out; a nest's leaves keep their dtypes); dynamics outside the plan's
subset warn, count one `fast.fuse_fallbacks` and equal the generic engine
in float64; such a function over float32 tensors raises torch's dtype
error there, and `cast_double` of those tensors fixes it.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import odeint_adjoint as j_odeint_adjoint
from tfdiffeq_tpu import odeint_df as j_odeint_df, solve as jsolve
from tfdiffeq_tpu import solve_df as j_solve_df
from tfdiffeq_tpu.ops.doublefloat import odeint_adjoint_df as j_adjoint_df
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import fast as PF

A32 = np.asarray([[-0.1, 2.0], [-2.0, -0.1]], np.float32)
Y32 = (np.random.RandomState(1).randn(16, 2) * 1.5).astype(np.float32)
T32 = np.linspace(0.0, 25.0, 32).astype(np.float32)
BAR = 1e-6


def _pf(A=A32):
    At = torch.tensor(A)
    return lambda t, y: (y ** 3) @ At


def _jf32(t, y):
    return jnp.dot(y ** 3, jnp.asarray(A32),
                   precision=jax.lax.Precision.HIGHEST)


def _jf64(t, y):
    return (y ** 3) @ jnp.asarray(A32, jnp.float64)


def _t(a):
    return torch.tensor(np.asarray(a))


def _oracle(t):
    return np.asarray(jsolve(_jf64, jnp.asarray(Y32, jnp.float64),
                             jnp.asarray(t, jnp.float64), rtol=1e-12,
                             atol=1e-14, options={"loop": "while"}).ys)


def _gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.fixture(scope="module")
def oracle25():
    return _oracle(T32)


def test_df_breaks_the_f32_floor(oracle25):
    """tests/test_doublefloat.py:66: the error falls with rtol, and rtol
    1e-10 meets 1e-6 over the benchmark span; the JAX solve_df agrees."""
    errs = {}
    for rtol, atol in ((1e-8, 1e-10), (1e-10, 1e-12)):
        r = P.solve_df(_pf(), _t(Y32), _t(T32), rtol=rtol, atol=atol)
        assert r.stats.status == 0 and r.ys.dtype == torch.float32
        errs[rtol] = _gap(r.ys, oracle25)
    assert errs[1e-10] < errs[1e-8]
    assert errs[1e-10] <= BAR, errs
    rj = j_solve_df(_jf32, jnp.asarray(Y32), jnp.asarray(T32), rtol=1e-10,
                    atol=1e-12)
    assert _gap(r.ys, rj.ys) <= BAR


def test_df_matches_f64_short_span():
    """:80: span 5, rtol 1e-9, within 1e-6 of the oracle and of the JAX
    solve_df."""
    t = np.linspace(0.0, 5.0, 9).astype(np.float32)
    r = P.solve_df(_pf(), _t(Y32), _t(t), rtol=1e-9, atol=1e-11)
    assert r.stats.status == 0
    assert _gap(r.ys, _oracle(t)) <= BAR
    rj = j_solve_df(_jf32, jnp.asarray(Y32), jnp.asarray(t), rtol=1e-9,
                    atol=1e-11)
    assert _gap(r.ys, rj.ys) <= BAR


@pytest.mark.parametrize("inputs", ["float32", "float64"])
def test_df_follows_jax_float64_step_for_step(inputs):
    """The float64 solve takes the JAX float64 solve's steps at the same
    tolerances: equal nfe, accepted and rejected counts. From float64
    inputs the trajectories agree within 1e-12 (measured 4.5e-15); from
    float32 inputs the output is the float64 answer rounded once to
    float32 (within float32's half ulp of |y|, 1.2e-7 here)."""
    t = np.linspace(0.0, 5.0, 9)
    dt = np.float32 if inputs == "float32" else np.float64
    f = _pf(A32.astype(dt))
    r = P.solve_df(f, _t(Y32.astype(dt)), _t(t.astype(dt)), rtol=1e-8,
                   atol=1e-10)
    rj = jsolve(_jf64, jnp.asarray(Y32, jnp.float64),
                jnp.asarray(t.astype(dt), jnp.float64), rtol=1e-8,
                atol=1e-10, options={"loop": "while"})
    assert tuple(r.stats) == tuple(int(x) for x in rj.stats)
    assert r.ys.dtype == (torch.float32 if inputs == "float32"
                          else torch.float64)
    bar = 1e-12 if inputs == "float64" else 1.2e-7
    assert _gap(r.ys, rj.ys) <= bar


def test_df_reverse_time_and_pytree():
    """:91: a dict state of leaves [3] and [2] (no shared batch axis: the
    generic engine in float64, with the warning and the count) in reverse
    time, within 1e-5 relative of the JAX odeint_df."""
    t = np.linspace(2.0, 0.0, 5).astype(np.float32)
    y0 = {"a": np.ones(3, np.float32), "b": np.ones(2, np.float32)}

    def f(tt, y):
        return {"a": -y["a"], "b": 0.5 * y["b"]}

    before = PF.fuse_fallbacks
    with pytest.warns(UserWarning, match="generic engine in float64"):
        ys = P.odeint_df(f, {k: _t(v) for k, v in y0.items()}, _t(t),
                         rtol=1e-9, atol=1e-11)
    assert PF.fuse_fallbacks == before + 1
    ref = j_odeint_df(f, {k: jnp.asarray(v) for k, v in y0.items()},
                      jnp.asarray(t), rtol=1e-9, atol=1e-11)
    for k in ("a", "b"):
        assert ys[k].dtype == torch.float32
        np.testing.assert_allclose(ys[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5)


def test_df_tree_state_with_a_batch_axis_fuses():
    """A tuple state whose leaves share the batch axis rides the plan
    route (no warning, no fallback) and at rtol 1e-10 lies within 1e-6 of
    the JAX float64 oracle relative to max(1, |y|) (|y| reaches 71 here,
    where float32 rounds by 3.8e-6 alone); with a float64 leaf beside a
    float32 one, each comes back in its own dtype."""
    y0 = (Y32, Y32[:, :1])
    t = np.linspace(0.0, 2.0, 5).astype(np.float32)

    def f(tt, y):
        return (-y[0] * y[1], 0.3 * y[0][:, :1] - y[1])

    before = PF.fuse_fallbacks
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = P.solve_df(f, tuple(_t(v) for v in y0), _t(t), rtol=1e-10,
                       atol=1e-12)
        mixed = P.solve_df(f, (_t(Y32), _t(Y32[:, :1]).double()), _t(t))
    assert PF.fuse_fallbacks == before and r.stats.status == 0
    assert [x.dtype for x in r.ys] == [torch.float32, torch.float32]
    assert [x.dtype for x in mixed.ys] == [torch.float32, torch.float64]
    rj = jsolve(f, tuple(jnp.asarray(v, jnp.float64) for v in y0),
                jnp.asarray(t, jnp.float64), rtol=1e-12, atol=1e-14,
                options={"loop": "while"})
    for a, b in zip(r.ys, rj.ys):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b) / np.maximum(1.0, np.abs(b))) \
            <= BAR


def test_df_failure_status():
    """:106: a budget of 5 attempts is status 1, and odeint_df raises
    naming MAX_STEPS."""
    r = P.solve_df(_pf(), _t(Y32), _t(T32), rtol=1e-8, atol=1e-10,
                   max_num_steps=5)
    assert r.stats.status == 1
    with pytest.raises(RuntimeError, match="MAX_STEPS"):
        P.odeint_df(_pf(), _t(Y32), _t(T32), options={"max_num_steps": 5})


def test_df_edges_and_refusals():
    """One time is y0 with zero stats; times that are not monotonic are
    status 3 with zeros beyond row 0 (the reference's INVALID_TIMES); a
    method without an adaptive tableau and an unknown odeint_df option
    raise as in the reference."""
    y = _t(Y32)
    r = P.solve_df(_pf(), y, _t([1.0]))
    assert tuple(r.stats) == (0, 0, 0, 0) and torch.equal(r.ys[0], y)
    r = P.solve_df(_pf(), y, _t([0.0, 1.0, 0.5, 2.0]))
    assert r.stats.status == int(P.Status.INVALID_TIMES)
    assert torch.equal(r.ys[0], y) and not r.ys[1:].any()
    # The reference validates concrete times eagerly; traced, they reach
    # its status.
    rj = jax.jit(lambda tq: j_solve_df(_jf32, jnp.asarray(Y32), tq))(
        jnp.asarray([0.0, 1.0, 0.5, 2.0], jnp.float32))
    assert int(rj.stats.status) == 3 and not np.asarray(rj.ys[1:]).any()
    with pytest.raises(ValueError, match="adaptive tableau methods"):
        P.solve_df(_pf(), y, _t(T32), method="rk4")
    with pytest.raises(TypeError, match="Unknown solve_df options"):
        P.odeint_df(_pf(), y, _t(T32), options={"norm": "max"})


def _cumsum_dyn(torch_A):
    return lambda t, y: -torch.cumsum(y, 1) @ torch_A


def test_df_unfusable_dynamics_run_the_generic_engine():
    """Outside the plan's subset (cumsum): a warning, one counted
    fallback, and the generic engine's float64 answer rounded to float32,
    within 1e-6 of the JAX float64 solve at rtol 1e-10 (the JAX solve_df
    evaluates this f in float32 and sits 2.9e-6 away where |y| reaches
    12)."""
    t = np.linspace(0.0, 2.0, 5).astype(np.float32)
    A64 = torch.tensor(A32, dtype=torch.float64)
    tol = dict(rtol=1e-10, atol=1e-12)
    before = PF.fuse_fallbacks
    with pytest.warns(UserWarning, match="outside the plan's subset"):
        r = P.solve_df(_cumsum_dyn(A64), _t(Y32), _t(t), **tol)
    assert PF.fuse_fallbacks == before + 1
    g = P.solve(_cumsum_dyn(A64), _t(Y32).double(), _t(t).double(), **tol)
    assert torch.equal(r.ys, g.ys.float()) and r.stats == g.stats
    rj = jsolve(lambda tt, y: -jnp.cumsum(y, 1) @ jnp.asarray(A32,
                                                              jnp.float64),
                jnp.asarray(Y32, jnp.float64), jnp.asarray(t, jnp.float64),
                options={"loop": "while"}, **tol)
    assert _gap(r.ys, rj.ys) <= BAR


def test_df_float32_closure_fails_loudly_and_cast_double_fixes_it():
    """The generic route hands func float64 states: a func over a float32
    tensor raises torch's dtype error (no route switches on it);
    `cast_double` of that tensor makes the same call run."""
    t = _t(np.linspace(0.0, 1.0, 3).astype(np.float32))
    with pytest.warns(UserWarning):
        with pytest.raises(RuntimeError, match="dtype|Double|Float"):
            P.solve_df(_cumsum_dyn(torch.tensor(A32)), _t(Y32), t)
    with pytest.warns(UserWarning):
        r = P.solve_df(_cumsum_dyn(P.cast_double(torch.tensor(A32))),
                       _t(Y32), t)
    assert r.stats.status == 0 and r.ys.dtype == torch.float32


# ---------------------------------------------------------------------------
# odeint_adjoint_df (tests/test_doublefloat.py:130-230)
# ---------------------------------------------------------------------------

def _mlp_setup():
    """:130: the reference's inputs, its RandomState(0) draws in order."""
    rng = np.random.RandomState(0)
    p = {"w1": (rng.randn(2, 16) * 0.3).astype(np.float32),
         "b1": (rng.randn(16) * 0.05).astype(np.float32),
         "w2": (rng.randn(16, 2) * 0.3).astype(np.float32)}
    y0 = rng.randn(8, 2).astype(np.float32)
    t = np.linspace(0.0, 2.0, 5).astype(np.float32)
    g_out = rng.randn(5, 8, 2).astype(np.float32)
    return p, y0, t, g_out


def _dyn(lib):
    def dyn(tt, yy, pp):
        return lib.tanh((yy ** 3) @ pp["w1"] + pp["b1"]) @ pp["w2"]
    return dyn


def _port_grads(dyn, p, y0, t, g_out, **kw):
    """Gradients of sum(ys * g_out) wrt (params, y0, t), in the
    reference's tree order: (b1, w1, w2), y0, t."""
    pt = {k: _t(v).requires_grad_() for k, v in p.items()}
    yt, tt = _t(y0).requires_grad_(), _t(t).requires_grad_()
    ys = P.odeint_adjoint_df(dyn, yt, tt, params=pt, **kw)
    loss = torch.sum(ys * _t(g_out))
    return torch.autograd.grad(loss, [pt["b1"], pt["w1"], pt["w2"], yt,
                                      tt])


def _check_grads(got, ref, bar):
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        assert _gap(a, b) / (np.abs(b).max() + 1e-12) < bar


@pytest.fixture(scope="module")
def grads64():
    """:147's oracle: the JAX float64 generic adjoint at rtol 1e-11."""
    p, y0, t, g_out = _mlp_setup()
    p64 = {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}

    def loss64(pp, yy, tq):
        ys = j_odeint_adjoint(_dyn(jnp), yy, tq, params=pp, rtol=1e-11,
                              atol=1e-13)
        return jnp.sum(ys * jnp.asarray(g_out, jnp.float64))

    g = jax.grad(loss64, argnums=(0, 1, 2))(
        p64, jnp.asarray(y0, jnp.float64), jnp.asarray(t, jnp.float64))
    return jax.tree_util.tree_leaves(g)


def test_df_adjoint_matches_f64_oracle(grads64):
    """:147: every gradient (weights, y0, t) within 2e-6 of the float64
    oracle relative to its largest entry, on the plan route (K2 + K3, no
    fallback), and within 2e-6 of the JAX odeint_adjoint_df."""
    p, y0, t, g_out = _mlp_setup()
    before = PF.fuse_fallbacks
    got = _port_grads(_dyn(torch), p, y0, t, g_out, rtol=1e-9, atol=1e-11)
    assert PF.fuse_fallbacks == before
    _check_grads(got, grads64, 2e-6)

    def loss_df(pp, yy, tq):
        ys = j_adjoint_df(_dyn(jnp), yy, tq, params=pp, rtol=1e-9,
                          atol=1e-11)
        return jnp.sum(ys * jnp.asarray(g_out))

    gj = jax.grad(loss_df, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(y0),
        jnp.asarray(t))
    _check_grads(got, jax.tree_util.tree_leaves(gj), 2e-6)


def test_df_adjoint_generic_route_matches_f64_oracle(grads64):
    """The same gradients through dynamics outside the fused adjoint's
    subset (the cotangent flows through cumsum(x) - cumsum(x), an exact
    zero): the generic odeint_adjoint in float64 with the params cast,
    one counted fallback, within 2e-6 of the oracle."""
    p, y0, t, g_out = _mlp_setup()
    dyn = _dyn(torch)

    def odd(tt, yy, pp):
        c = torch.cumsum(yy, 1)
        return dyn(tt, yy, pp) + (c - c)

    before = PF.fuse_fallbacks
    with pytest.warns(UserWarning, match="generic engine in float64"):
        got = _port_grads(odd, p, y0, t, g_out, rtol=1e-9, atol=1e-11)
    assert PF.fuse_fallbacks == before + 1
    _check_grads(got, grads64, 2e-6)


def test_df_adjoint_trains():
    """:180: one SGD step through the float64 adjoint lowers the loss;
    every gradient finite."""
    p, y0, t, _ = _mlp_setup()
    pt = {k: _t(v).requires_grad_() for k, v in p.items()}
    yt, tt = _t(y0), _t(t)
    dyn = _dyn(torch)

    def loss(pp):
        ys = P.odeint_adjoint_df(dyn, yt, tt, params=pp, rtol=1e-8,
                                 atol=1e-10)
        return torch.mean((ys[-1] + yt) ** 2)

    l0 = loss(pt)
    g = torch.autograd.grad(l0, list(pt.values()))
    assert all(torch.isfinite(x).all() for x in g)
    with torch.no_grad():
        p1 = {k: v - 0.1 * gk for (k, v), gk in zip(pt.items(), g)}
        assert float(loss(p1)) < float(l0)


def test_df_adjoint_no_params_and_failure_poison(monkeypatch):
    """:201: d sum(y(2)) / d y0 of y' = -y is exp(-2) within 1e-6; a
    forward that runs out of its 3 attempts makes every gradient NaN
    (the sweep does not run), and return_stats shows its status."""
    _, y0, t, _ = _mlp_setup()
    yt = _t(y0).requires_grad_()
    ys = P.odeint_adjoint_df(lambda tt, zz: -zz, yt, _t(t), rtol=1e-9,
                             atol=1e-11)
    g, = torch.autograd.grad(ys[-1].sum(), [yt])
    assert _gap(g, np.full(y0.shape, np.exp(-(t[-1] - t[0])))) < 1e-6
    from tfdiffeq_tpu_torch.ops import cuda_plan as CP
    sweeps = []
    monkeypatch.setattr(CP, "plan_adjoint_solve",
                        lambda *a, **k: sweeps.append(a))
    ys, st = P.odeint_adjoint_df(lambda tt, zz: -zz * (1 + zz * zz), yt,
                                 _t(t), rtol=1e-12, atol=1e-14,
                                 max_num_steps=3, return_stats=True)
    assert st.status == 1
    g_bad, = torch.autograd.grad(ys[-1].sum(), [yt])
    assert torch.isnan(g_bad).all() and not sweeps


def test_exports_cover_the_reference():
    """The port exports every name of the reference's `__all__` (the
    float64 tier and the helpers were its last eight), plus its own
    `solve_fused` and `register_solver`, and each resolves."""
    import tfdiffeq_tpu

    assert set(tfdiffeq_tpu.__all__) <= set(P.__all__)
    assert set(P.__all__) - set(tfdiffeq_tpu.__all__) == {
        "solve_fused", "register_solver"}
    assert all(getattr(P, name) is not None for name in P.__all__)
