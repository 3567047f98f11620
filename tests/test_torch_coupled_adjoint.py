"""PyTorch port: training batch-coupled plans on a fixed grid (K15's
coupled reverse walk inside K9, on one block) against the JAX package.

tests/test_meanfield.py's problem (B = 12, D = 3, 7 outputs over [0, 2],
float32 as there). `odeint_adjoint(options={'fuse': True})` trains the
mean-field coupling on the three mixes that reach the new route: K8 + K9
(rk4 both ways), K2 + K9 (dopri5 forward, rk4 backward) and K8 + K3 (rk4
forward, dopri5 backward); on the CPU these run the kernels' plain
versions. Tolerances:
- gradients (the weight and y0) within 1e-4 relative to the largest entry
  of the reference's fused adjoint (tests/test_meanfield.py:73-95's bar:
  two float32 implementations of one discretized adjoint, the batch sums
  and tanh rounding differently) and of the port's generic
  `odeint_adjoint` with the same methods and grids;
- the batch-max coupling in its separated regime (tests/test_meanfield.py:
  158-200; the arg-max and arg-min samples pulled apart, so the field is
  smooth along the trajectory) within 1e-5 of the generic adjoint;
- the plain K9 (`cuda_plan.plan_adjoint_solve_fixed_plain`) against the
  reference's `plan_adjoint_solve_fixed` in interpret mode with pack=1 in
  float64 on the mean-field and batch-max plans of
  tests/test_torch_plan_adjoint.py: step counts equal, ay0, every
  constant's cotangent and a_t within 1e-9 relative (the same sweep, the
  batch sums in another order).
No case warns or falls back, and each mix reaches the wrappers it names.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfdiffeq_tpu as J
from tfdiffeq_tpu.ops import pallas_fixed as JPF
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_plan as CP

from test_torch_plan_adjoint import (_check_consts, _ref_sweep_inputs, _rel,
                                     _sweep_inputs)

B, D = 12, 3
RNG = np.random.RandomState(0)
W = RNG.randn(D, D) * 0.3
Y0 = RNG.randn(B, D)
T = np.linspace(0.0, 2.0, 7)
TGT = np.random.RandomState(1).randn(T.shape[0], B, D)
F32 = torch.float32
#: (forward method, its options, adjoint method, its options) and the
#: plan wrappers each mix reaches.
MIXES = {
    "k8_k9": (("rk4", {"num_steps": 32}, "rk4", {"num_steps": 8}),
              ["plan_solve_fixed", "plan_adjoint_solve_fixed"]),
    "k2_k9": (("dopri5", {}, "rk4", {"num_steps": 8}),
              ["plan_solve", "plan_adjoint_solve_fixed"]),
    "k8_k3": (("rk4", {"num_steps": 32}, "dopri5", {}),
              ["plan_solve_fixed", "plan_adjoint_solve"]),
}


def _mf_torch(t, y, p):
    return torch.tanh(y @ p["W"]) - 0.5 * (y - y.mean(0))


def _mf_jax(t, y, p):
    return jnp.tanh(y @ p["W"]) - 0.5 * (y - jnp.mean(y, axis=0))


def _port_grads(f, y0, mix, fuse):
    """d mean((ys - TGT)^2) / d(W, y0) through the port's odeint_adjoint,
    with the plan wrappers it reached (fused: no warning, no fallback)."""
    (m, mo, am, ao) = mix
    p = {"W": torch.tensor(W, dtype=F32, requires_grad=True)}
    y = torch.tensor(y0, dtype=F32, requires_grad=True)
    seen, origs = [], {}
    for name in ("plan_solve", "plan_solve_fixed", "plan_adjoint_solve",
                 "plan_adjoint_solve_fixed"):
        origs[name] = getattr(CP, name)

        def spy(*a, _n=name, **k):
            seen.append(_n)
            return origs[_n](*a, **k)
        setattr(CP, name, spy)
    before = PF.fuse_fallbacks
    try:
        with warnings.catch_warnings():
            if fuse:
                warnings.simplefilter("error")
            ys = P.odeint_adjoint(
                f, y, torch.tensor(T, dtype=F32), params=p, rtol=1e-6,
                atol=1e-8, method=m, adjoint_method=am,
                options=dict(mo, fuse=True) if fuse else (mo or None),
                adjoint_options=ao or None)
            loss = torch.mean((ys - torch.tensor(TGT, dtype=F32)) ** 2)
            g = torch.autograd.grad(loss, [p["W"], y])
    finally:
        for name, fn in origs.items():
            setattr(CP, name, fn)
    assert PF.fuse_fallbacks == before
    return [x.numpy() for x in g], seen


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's fused adjoint of each mix, computed once."""
    out = {}
    for key, ((m, mo, am, ao), _) in MIXES.items():
        def loss(pp, y0_):
            ys = J.odeint_adjoint(_mf_jax, y0_, jnp.asarray(T, jnp.float32),
                                  params=pp, rtol=1e-6, atol=1e-8, method=m,
                                  adjoint_method=am,
                                  options=dict(mo, fuse=True),
                                  adjoint_options=ao or None)
            return jnp.mean((ys - jnp.asarray(TGT, jnp.float32)) ** 2)

        g = jax.grad(loss, argnums=(0, 1))(
            {"W": jnp.asarray(W, jnp.float32)}, jnp.asarray(Y0, jnp.float32))
        out[key] = [np.asarray(g[0]["W"]), np.asarray(g[1])]
    return out


def _close(got, want, rel):
    for a, b in zip(got, want):
        d = float(np.max(np.abs(a - b)))
        m = float(np.max(np.abs(b))) + 1e-12
        assert d / m < rel, (d, m)


@pytest.mark.parametrize("key", sorted(MIXES))
def test_meanfield_training_matches_reference(reference_grads, key):
    mix, wrappers = MIXES[key]
    got, seen = _port_grads(_mf_torch, Y0, mix, True)
    assert sorted(seen) == sorted(wrappers)
    _close(got, reference_grads[key], 1e-4)
    _close(got, _port_grads(_mf_torch, Y0, mix, False)[0], 1e-4)


def test_batch_max_training_separated_regime():
    """tests/test_meanfield.py:158-200's separated regime on K8 + K9."""
    def dyn(t, y, p):
        return (torch.tanh(y @ p["W"]) - 0.02 * y.amax(0)
                - 0.01 * (y - y.amin()))

    y_sep = Y0.copy()
    y_sep[0] += 8.0
    y_sep[1] -= 8.0
    mix = MIXES["k8_k9"][0]
    got, seen = _port_grads(dyn, y_sep, mix, True)
    assert sorted(seen) == sorted(MIXES["k8_k9"][1])
    _close(got, _port_grads(dyn, y_sep, mix, False)[0], 1e-5)


@pytest.mark.parametrize("name", ["meanfield", "bmax"])
def test_plain_k9_matches_reference_kernel(name):
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
