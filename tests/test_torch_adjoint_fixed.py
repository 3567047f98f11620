"""PyTorch port: the generic `odeint_adjoint` with fixed-grid forward and
adjoint methods against the JAX package's gradients and backward counts.

Covers a fixed forward with `num_steps` (inherited by the fixed backward,
steps per observation interval) and with `step_size` (resolved to the
equivalent `num_steps`), a fixed adjoint under an adaptive forward, and
the per-interval backward walk of `adjoint_options={'step_size': h}` on an
irregular observation grid and in reverse time (after
tests/test_gradients.py:135-245). Float64: both packages take the same
steps with the same arithmetic, so gradients agree within 1e-12 relative to
each leaf's largest entry and forward and backward NFE and step counts are
identical. The reference needs concrete times to build a grid from
step_size, so those cases differentiate with respect to y0 and the
parameters only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfdiffeq_tpu as J
from tfdiffeq_tpu.utils.nfe import NFEMeter as JMeter
import tfdiffeq_tpu_torch as P

_A = np.array([[-0.1, 2.0], [-2.0, -0.1]])


def _jf(t, y, p):
    return jnp.tanh(y @ (0.9 * p["A"]).T + p["b"] + 0.2 * t) - 0.1 * y


def _pf(t, y, p):
    return torch.tanh(y @ (0.9 * p["A"]).T + p["b"] + 0.2 * t) - 0.1 * y


CASES = {
    # name: (t, kwargs, differentiate t)
    "rk4_num_steps": (np.linspace(0.0, 1.5, 5),
                      dict(method="rk4", options={"num_steps": 3}), True),
    "midpoint_step_size_reverse": (
        np.array([2.0, 1.5, 0.3, 0.0]),
        dict(method="midpoint", options={"step_size": 0.2}), False),
    "dopri5_euler_adjoint": (np.linspace(0.0, 1.0, 4),
                             dict(method="dopri5", adjoint_method="euler",
                                  adjoint_options={"num_steps": 6}), True),
    # The per-interval walk: spans (0.1, 0.05, 0.85, 2.0) / 0.01 give
    # 10 + 5 + 85 + 200 = 300 backward steps.
    "rk4_walk_irregular": (np.array([0.0, 0.1, 0.15, 1.0, 3.0]),
                           dict(method="rk4", options={"step_size": 0.01}),
                           False),
    "rk4_walk_reverse": (np.array([2.0, 1.5, 0.3, 0.0]),
                         dict(method="dopri5", adjoint_method="rk4",
                              adjoint_options={"step_size": 0.05}), False),
    "euler_default_grid_time": (np.array([0.0, 0.3, 0.9, 1.0]),
                                dict(method="euler"), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fixed_adjoint_matches_reference(name):
    t, kw, grad_t = CASES[name]
    rng = np.random.RandomState(3)
    params = {"A": _A, "b": np.array([0.1, -0.2])}
    y0 = rng.randn(3, 2)
    g = rng.randn(t.shape[0], 3, 2)

    jmeter = JMeter()

    def jloss(p, y, tt):
        ys = J.odeint_adjoint(_jf, y, tt, params=p, nfe_meter=jmeter,
                              **kw)
        return jnp.sum(ys * jnp.asarray(g))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    if grad_t:
        jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(y0),
                                                jnp.asarray(t))
    else:
        jg = jax.grad(lambda p, y: jloss(p, y, t), argnums=(0, 1))(
            jp, jnp.asarray(y0))
    jax.effects_barrier()

    pmeter = P.NFEMeter()
    pp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    py0 = torch.tensor(y0, requires_grad=True)
    pt = torch.tensor(t, requires_grad=grad_t)
    ys = P.odeint_adjoint(_pf, py0, pt, params=pp, nfe_meter=pmeter, **kw)
    torch.sum(ys * torch.tensor(g)).backward()
    got = [pp["A"].grad, pp["b"].grad, py0.grad] + ([pt.grad] if grad_t
                                                    else [])
    for a, b in zip(got, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-12 * np.max(np.abs(b))
    assert (pmeter.f_nfe, pmeter.f_steps, pmeter.b_nfe, pmeter.b_steps) == \
        (jmeter.f_nfe, jmeter.f_steps, jmeter.b_nfe, jmeter.b_steps)
    if name == "rk4_walk_irregular":
        # Backward NFE = steps * stages + resets + T.
        assert pmeter.b_steps == 300
        assert pmeter.b_nfe == 300 * 4 + 4 + 5


def test_fixed_adjoint_step_size_exact_gradient():
    """tests/test_gradients.py's analytic check on the port: with
    f = -p y and rk4 at step 0.05, d/dp of sum(y(1)) from y0 = 1 is
    -2/e."""
    p = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    ys = P.odeint_adjoint(lambda t, y, q: -q * y,
                          torch.ones(2, dtype=torch.float64),
                          torch.linspace(0.0, 1.0, 4, dtype=torch.float64),
                          params=p, method="rk4", options={"step_size": 0.05})
    ys[-1].sum().backward()
    np.testing.assert_allclose(float(p.grad), -2.0 * np.exp(-1.0), rtol=1e-5)
