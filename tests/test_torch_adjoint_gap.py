"""PyTorch port: the resets and interpolated adjoints against a direct
gradient at the bench training protocol (ROADMAP queue 3's open item).

The protocol is bench.py:788-804's: the spiral f = tanh(y^3 W1 + b1) W2 + b2
(seed-0 weights, zero biases), 64 outputs over [0, 25], rtol = atol = 1e-6
and the MSE against the seed-2 target; here at B = 16 in float64, where
the direct gradient (autograd through the generic `solve` at rtol = atol
= 1e-10) is cheap. Held to it, each parameter's gradient on its own scale
(max |got - direct| / max |direct|):
- the port's `odeint_adjoint` in resets mode (the generic sweep);
- its interpolated mode on the fused forward (K2's emission on the CPU,
  chip_smoke.py [42]'s path);
- the reference's interpolated `odeint_adjoint` on the same inputs.
Each is within 1e-3, the solver error at rtol 1e-6 (2e-4 to 3e-4 here),
and the two port adjoints move to the direct gradient as the tolerance
tightens (at 1e-7, within 1e-4: 5e-5 and 2e-5 here), as two right answers
to one ODE must.
The 0.42 and 0.24 gaps of [42] on b1 and b2 at B = 4096 are the same
solver error where those gradients cancel: `tools/torch_adjoint_gap.py`
measures the cancellation and the convergence there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfdiffeq_tpu as J
import tfdiffeq_tpu_torch as P

B, T_OUT, SPAN, D, H = 16, 64, 25.0, 2, 50
F64 = torch.float64
_RNG = np.random.RandomState(0)
PARAMS = [_RNG.randn(D, H) * 0.1, np.zeros(H), _RNG.randn(H, D) * 0.1,
          np.zeros(D)]
Y0 = np.random.RandomState(1).randn(4096, D)[:B] * 1.5
TARGET = np.random.RandomState(2).randn(T_OUT, 4096, D)[:, :B] * 0.5
T = np.linspace(0.0, SPAN, T_OUT)


def _f(t, y, q):
    return torch.tanh((y ** 3) @ q[0] + q[1]) @ q[2] + q[3]


def _grads(run):
    q = tuple(torch.tensor(p, dtype=F64, requires_grad=True) for p in PARAMS)
    ys = run(q, torch.tensor(Y0, dtype=F64), torch.tensor(T, dtype=F64))
    loss = torch.mean((ys - torch.tensor(TARGET, dtype=F64)) ** 2)
    return [g.numpy() for g in torch.autograd.grad(loss, q)]


@pytest.fixture(scope="module")
def direct():
    return _grads(lambda q, y, t: P.odeint(lambda tt, yy: _f(tt, yy, q), y,
                                           t, rtol=1e-10, atol=1e-10))


def _port(mode, tol=1e-6):
    return _grads(lambda q, y, t: P.odeint_adjoint(
        _f, y, t, params=q, rtol=tol, atol=tol, adjoint_mode=mode,
        options={"fuse": True} if mode == "interpolated" else None))


def _reference():
    import jax

    def fj(t, y, q):
        return jnp.tanh((y ** 3) @ q[0] + q[1]) @ q[2] + q[3]

    def loss(q):
        ys = J.odeint_adjoint(fj, jnp.asarray(Y0), jnp.asarray(T), params=q,
                              rtol=1e-6, atol=1e-6,
                              adjoint_mode="interpolated")
        return jnp.mean((ys - jnp.asarray(TARGET)) ** 2)

    return [np.asarray(g) for g in jax.grad(loss)(
        tuple(jnp.asarray(p) for p in PARAMS))]


def _gaps(got, want):
    return [float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
            for a, b in zip(got, want)]


def test_both_adjoints_are_within_solver_error_of_the_direct_gradient(
        direct):
    for name, got in (("resets", _port("resets")),
                      ("interpolated", _port("interpolated")),
                      ("reference interpolated", _reference())):
        gaps = _gaps(got, direct)
        assert max(gaps) < 1e-3, (name, gaps)
    # Two right answers converge on the direct gradient as the tolerance
    # tightens; a fault in either sweep would not.
    for mode in ("resets", "interpolated"):
        gaps = _gaps(_port(mode, 1e-7), direct)
        assert max(gaps) < 1e-4, (mode, gaps)
