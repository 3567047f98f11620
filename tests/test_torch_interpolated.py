"""PyTorch port: `odeint_adjoint(adjoint_mode='interpolated')` (Daulbaev
et al. 2020) against the JAX package's.

The backward evaluates y(s) from the forward's dense output instead of
re-solving it. Both packages get the same numpy inputs; the gradients with
respect to y0, t and the parameters are held to each other:
- generic engine, float64, forward and reverse time, with and without the
  seminorm: within 1e-7 relative to the largest gradient (the step
  sequences agree to the controller's roundoff drift, about 1e-10 of a
  step, tests/test_torch_dense_output.py), and to direct backpropagation
  through `odeint` within 1e-4 (the reference's own bar,
  tests/test_gradients.py:256);
- the fused forward (tier 2: `fast.solve_fused(dense_output=True)`, then
  the generic backward) in float32 at B = 8, where the reference runs one
  block: within 1e-4 relative of the port's generic interpolated adjoint
  and of the reference's fused one (tests/test_fuse.py:377-416's bar; two
  adjoints of one ODE differ by solver error, and in float32 the two
  packages take other steps from the second one on);
- the refusals, the loud budget exhaustion and the reference's ported
  tests (tests/test_gradients.py:256, :290, :362; tests/test_fuse.py:377).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfdiffeq_tpu as J
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_plan

A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
Y0 = np.array([2.0, 0.0])
T = np.linspace(0.0, 1.5, 7)
B_VEC = np.array([0.1, -0.2])
G_OUT = np.random.RandomState(7).randn(T.shape[0], 2)
F64 = torch.float64


def _tt(x, dtype=F64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _fj(t, y, p):
    return jnp.tanh(y @ p["A"].T + p["b"]) - 0.1 * y


def _fp(t, y, p):
    return torch.tanh(y @ p["A"].t() + p["b"]) - 0.1 * y


def _port_grads(t_obs, f=_fp, direct=False, **kw):
    y0 = _tt(Y0).requires_grad_(True)
    t = _tt(t_obs).requires_grad_(True)
    p = {"A": _tt(A * 0.9).requires_grad_(True),
         "b": _tt(B_VEC).requires_grad_(True)}
    if direct:
        ys = P.odeint(lambda tt, yy: f(tt, yy, p), y0, t, rtol=1e-9,
                      atol=1e-11)
    else:
        ys = P.odeint_adjoint(f, y0, t, params=p, rtol=1e-9, atol=1e-11,
                              **kw)
    (ys * _tt(G_OUT)).sum().backward()
    return [x.grad.numpy() if x.grad is not None else None
            for x in (y0, t, p["A"], p["b"])]


def _ref_grads(t_obs, **kw):
    params = {"A": jnp.asarray(A * 0.9), "b": jnp.asarray(B_VEC)}

    def loss(y0, t, p):
        ys = J.odeint_adjoint(_fj, y0, t, params=p, rtol=1e-9, atol=1e-11,
                              adjoint_mode="interpolated", **kw)
        return jnp.sum(ys * jnp.asarray(G_OUT))

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(Y0),
                                           jnp.asarray(t_obs), params)
    return [np.asarray(g[0]), np.asarray(g[1]), np.asarray(g[2]["A"]),
            np.asarray(g[2]["b"])]


def _close(got, want, rel):
    for a, b in zip(got, want):
        if b is None:
            continue
        m = float(np.max(np.abs(b))) + 1e-12
        d = float(np.max(np.abs(a - b)))
        assert d / m < rel, (d, m)


@pytest.mark.parametrize("seminorm", [False, True], ids=["full", "semi"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_generic_interpolated_matches_reference(reverse, seminorm):
    t_obs = T[::-1].copy() if reverse else T
    got = _port_grads(t_obs, adjoint_mode="interpolated",
                      adjoint_seminorm=seminorm,
                      options={"max_num_steps": 2048})
    want = _ref_grads(t_obs, adjoint_seminorm=seminorm,
                      options={"max_steps": 2048, "max_num_steps": 2048})
    _close(got, want, 1e-7)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_adjoint_interpolated_mode_matches_direct(reverse):
    """tests/test_gradients.py:256: gradients match direct
    backpropagation through the solve within 1e-4 (y0 and the parameters:
    the port's generic engine takes its times off autograd's tape, so the
    direct solve has no t gradient; the test above holds t's against the
    reference)."""
    t_obs = T[::-1].copy() if reverse else T
    got = _port_grads(t_obs, adjoint_mode="interpolated",
                      options={"max_num_steps": 2048})
    direct = _port_grads(t_obs, direct=True)
    _close(got, direct, 1e-4)


def test_interpolated_backward_nfe_matches_reference():
    """The backward integrates (a_y, a_params, a_t) under the seminorm over
    a_y alone: its evaluations (+1 an interval for t's gradient) and steps
    are the reference's."""
    from tfdiffeq_tpu.utils.nfe import NFEMeter as JMeter
    from tfdiffeq_tpu_torch.utils.nfe import NFEMeter
    meter, jmeter = NFEMeter(), JMeter()
    _port_grads(T, adjoint_mode="interpolated", adjoint_seminorm=True,
                nfe_meter=meter, options={"max_num_steps": 2048})
    _ref_grads(T, adjoint_seminorm=True, nfe_meter=jmeter,
               options={"max_steps": 2048, "max_num_steps": 2048})
    jax.effects_barrier()
    assert meter.b_nfe > 0
    assert (meter.f_nfe, meter.b_nfe, meter.b_steps) == (
        jmeter.f_nfe, jmeter.b_nfe, jmeter.b_steps)


def test_adjoint_interpolated_rejects_fixed_forward():
    """tests/test_gradients.py:290: a fixed-grid forward, and a fixed-grid
    adjoint method with step_size, raise ValueError; num_steps runs."""
    y0, t = _tt(Y0), _tt(T)
    with pytest.raises(ValueError, match="interpolated"):
        P.odeint_adjoint(lambda tt, y: -y, y0, t, method="rk4",
                         adjoint_mode="interpolated")
    with pytest.raises(ValueError, match="num_steps"):
        P.odeint_adjoint(lambda tt, y: -y, y0, t, method="dopri5",
                         adjoint_method="rk4",
                         adjoint_options={"step_size": 0.1},
                         adjoint_mode="interpolated")
    y = y0.clone().requires_grad_(True)
    ys = P.odeint_adjoint(lambda tt, yy: -yy, y, t, method="dopri5",
                          adjoint_method="rk4",
                          adjoint_options={"num_steps": 20},
                          adjoint_mode="interpolated")
    ys[-1].sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), np.exp(-T[-1]) * np.ones(2),
                               rtol=1e-4)
    # The reference raises the same for the same calls.
    with pytest.raises(ValueError, match="interpolated"):
        J.odeint_adjoint(lambda tt, yy: -yy, jnp.asarray(Y0),
                         jnp.asarray(T), method="rk4",
                         adjoint_mode="interpolated")


def test_adjoint_interpolated_budget_exhaustion_is_loud():
    """tests/test_gradients.py:362: an exhausted forward raises (the eager
    port has no traced path)."""
    with pytest.raises(RuntimeError, match="status"):
        P.odeint_adjoint(lambda t, y: -y, _tt(Y0), _tt(np.linspace(0, 10, 5)),
                         rtol=1e-12, atol=1e-14,
                         options={"max_num_steps": 4},
                         adjoint_mode="interpolated")
    with pytest.raises(RuntimeError, match="status"):
        P.odeint_adjoint(lambda t, y: -y, _tt(np.ones((3, 2))),
                         _tt(np.linspace(0, 10, 5)), rtol=1e-12, atol=1e-14,
                         options={"max_num_steps": 4, "fuse": True},
                         adjoint_mode="interpolated")


def test_forward_solver_must_emit_dense():
    """A forward_solver without `emits_dense` is refused; one that returns
    (ys, stats, DenseOutput) drives the interpolated backward."""
    def plain(y0, t, params):
        r = P.solve(lambda tt, y: -y, y0, t)
        return r.ys, r.stats

    with pytest.raises(ValueError, match="emits_dense"):
        P.odeint_adjoint(lambda t, y: -y, _tt(Y0), _tt(T),
                         forward_solver=plain, adjoint_mode="interpolated")

    def dense(y0, t, params):
        r = P.solve(lambda tt, y: -y, y0, t,
                    options={"dense_output": True})
        return r.ys, r.stats, r.dense

    dense.emits_dense = True
    y = _tt(Y0).requires_grad_(True)
    ys = P.odeint_adjoint(lambda t, yy: -yy, y, _tt(T), forward_solver=dense,
                          adjoint_mode="interpolated")
    ys[-1].sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), np.exp(-T[-1]), rtol=1e-6)


def test_per_sample_is_refused_before_any_solve():
    """The reference silently runs the resets backward with per_sample
    (generic) or drops per_sample from its fused forward (ROADMAP.md
    queue 3, known faults in the reference); the port refuses it."""
    before = cuda_plan.plan_solve_launches
    for opts in ({"per_sample": True}, {"per_sample": True, "fuse": True}):
        with pytest.raises(ValueError, match="per_sample"):
            P.odeint_adjoint(lambda t, y: -y, _tt(np.ones((3, 2))), _tt(T),
                             options=opts, adjoint_mode="interpolated")
    assert cuda_plan.plan_solve_launches == before


# ---- the fused forward (tier 2) ------------------------------------------

_RNG = np.random.RandomState(4)
W1 = _RNG.randn(2, 16) * 0.5
B1 = _RNG.randn(16) * 0.1
W2 = _RNG.randn(16, 2) * 0.5
Y8 = np.random.RandomState(0).randn(8, 2) * 1.5
T5 = np.linspace(0.0, 2.0, 5)
G8 = np.random.RandomState(4).randn(5, 8, 2)


def _fused_port(fuse, t_obs=T5, seminorm=False):
    ps = [_tt(W1, torch.float32).requires_grad_(True),
          _tt(B1, torch.float32).requires_grad_(True),
          _tt(W2, torch.float32).requires_grad_(True)]

    def fp(tt, yy, p):
        return torch.tanh(yy @ p[0] + p[1]) @ p[2]

    ys = P.odeint_adjoint(
        fp, _tt(Y8, torch.float32), _tt(t_obs, torch.float32), params=ps,
        rtol=1e-6, atol=1e-8, adjoint_mode="interpolated",
        adjoint_seminorm=seminorm,
        options={"fuse": True, "max_num_steps": 256} if fuse
        else {"max_num_steps": 2048})
    (ys * _tt(G8, torch.float32)).sum().backward()
    return [p.grad.numpy() for p in ps]


def _fused_ref(t_obs=T5):
    def fp(tt, yy, p):
        return jnp.tanh(yy @ p[0] + p[1]) @ p[2]

    params = tuple(jnp.asarray(x, jnp.float32) for x in (W1, B1, W2))

    def loss(p):
        ys = J.odeint_adjoint(fp, jnp.asarray(Y8, jnp.float32),
                              jnp.asarray(t_obs, jnp.float32), params=p,
                              rtol=1e-6, atol=1e-8,
                              adjoint_mode="interpolated",
                              options={"fuse": True, "max_num_steps": 256})
        return jnp.sum(ys * jnp.asarray(G8, jnp.float32))

    return [np.asarray(g) for g in jax.grad(loss)(params)]


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_interpolated_adjoint_with_fused_forward(reverse):
    """tests/test_fuse.py:377 (single block): the fused forward's dense
    output drives the interpolated backward, one K2 launch (its plain
    version here) and no fallback; gradients within 1e-4 of the generic
    interpolated adjoint and of the reference's fused one."""
    t_obs = T5[::-1].copy() if reverse else T5
    before = PF.fuse_fallbacks
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        gf = _fused_port(True, t_obs)
    assert PF.fuse_fallbacks == before
    _close(gf, _fused_port(False, t_obs), 1e-4)
    _close(gf, _fused_ref(t_obs), 1e-4)


def test_fused_interpolated_seminorm():
    _close(_fused_port(True, seminorm=True), _fused_port(False), 1e-4)


def test_fused_forward_runs_k2_with_the_emission(monkeypatch):
    """Tier 1 is skipped (the reference runs it in 'resets' mode only);
    the forward is one plan solve with emit_dense = max_num_steps."""
    seen = []
    real = cuda_plan.plan_solve

    def spy(*a, **kw):
        seen.append(kw.get("emit_dense", 0))
        return real(*a, **kw)

    monkeypatch.setattr(cuda_plan, "plan_solve", spy)
    called = []
    monkeypatch.setattr(PF, "odeint_adjoint_fused",
                        lambda *a, **k: called.append(1))
    _fused_port(True)
    assert seen == [256] and not called


def test_unfusable_dynamics_fall_back_and_count():
    """Dynamics outside the plan's subset warn, count one fallback and
    run the generic forward with its dense output."""
    y = _tt(np.ones((3, 2))).requires_grad_(True)
    before = PF.fuse_fallbacks
    with pytest.warns(UserWarning, match="generic engine"):
        ys = P.odeint_adjoint(lambda t, v: -torch.cumsum(v, 1) * 0.3, y,
                              _tt([0.0, 1.0]), adjoint_mode="interpolated",
                              options={"fuse": True})
    assert PF.fuse_fallbacks == before + 1
    ys[-1].sum().backward()
    y2 = _tt(np.ones((3, 2))).requires_grad_(True)
    P.odeint_adjoint(lambda t, v: -torch.cumsum(v, 1) * 0.3, y2,
                     _tt([0.0, 1.0]), adjoint_mode="interpolated")[-1] \
        .sum().backward()
    assert torch.equal(y.grad, y2.grad)
