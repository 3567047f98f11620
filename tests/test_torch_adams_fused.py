"""PyTorch port: the fused Adams tier against the JAX package.

- The plain K10 (`ops/cuda_adams.mlp_solve_adams` on CPU tensors) against
  the JAX `pallas_fixed.mlp_solve_adams(..., interpret=True, pack=1)`:
  explicit_adams and fixed_adams, orders 4 and 12, max_iters 1 and 4, both
  time directions, a Hermite grid, a time column, the wide route (a layer
  past 128), invalid times (status 3). Float64: identical stats, within
  1e-12 relative to the largest entry (the same arithmetic in the same
  order; the networks' tanh and products may round differently in the
  last bit, and a stable Adams step does not grow that). Float32: identical
  stats, within 1e-5 absolute (tests/test_fixed_fused.py's bar).
- max_order = 1: the reference's K10 fails to trace there (its corrector
  history sum is empty, pallas_fixed.py:598-605, and its history shift an
  empty slice); the port computes the generic engine's step, held to the
  JAX generic `solve` within 1e-12.
- The plain K11 (`mlp_solve_vcabm`) against the JAX
  `pallas_vcabm.mlp_solve_vcabm(..., interpret=True, pack=1)`: orders 1,
  4 and 12, both directions, a time column, the wide route,
  `first_step=0` (clamped to dt_min, it terminates) and a forced status 1.
  Float64: identical stats, 1e-12 relative. Float32: the accept sequence
  may diverge by an ulp (tests/test_fixed_fused.py:443-488 allows it),
  so status 0 and the trajectories within 1e-4.
- `fast.solve_mlp_spec` / `solve_mlp` with the three methods against the
  JAX `solve_mlp_spec(..., interpret=True)`, stats included; the
  reference's refusals (a reduced tier, per_sample).
- K14 inside K10 and K11: the same MLP as plain PyTorch through
  `fast.solve_fused` (the plan route's plain versions) against the
  reference's `solve_fused(method=...)` in interpret mode and against the
  port's MLP route, float64, identical stats, 1e-12 relative; the plan
  route's refusals; `odeint_adjoint(options={'fuse': True})` with an Adams
  forward taking tier 2.
- `fast.odeint_adjoint_mlp(method='adams', adjoint_method='dopri5')` and
  `('fixed_adams', 'rk4')` gradients against `jax.grad` of the reference,
  within 1e-6 relative in float64; an Adams adjoint_method raises
  ValueError in the port before any launch, where the reference raises
  KeyError in its backward.

Batches stay at 8 to 40 (under one lane tile, so the reference never
packs); each reference kernel compiles once in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfdiffeq_tpu as J
from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.ops import pallas_fixed as JPF, pallas_vcabm as JPV
from tfdiffeq_tpu.ops.pallas_kernels import pad_mlp_weights
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_adams as PA, cuda_kernels as PK

F64, F32 = torch.float64, torch.float32


def _weights(dims, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(a, b) * scale / np.sqrt(a), rng.randn(b) * 0.05)
            for a, b in zip(dims[:-1], dims[1:])]


def _packed(W, dtype):
    jdt = getattr(jnp, str(dtype).split(".")[-1])
    jw, jd = pad_mlp_weights([(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
                              for a, b in W], jdt)
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], dtype)
    return jw, jd, pw, pd, jdt


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


_T5 = np.linspace(0.0, 2.0, 5)
_REV = -np.linspace(1.5, 0.0, 6)       # tau = -t increasing, sign -1
# name: (implicit, max_order, max_iters, dims, activation, time_input,
#        tau, grid, sign, dtype)
K10_CASES = {
    "explicit_o4_default": (False, 4, 4, (2, 16, 2), "tanh", False, _T5,
                            None, 1.0, F64),
    "explicit_o4_hermite_reverse": (False, 4, 4, (2, 16, 2), "softplus",
                                    False, _REV, np.linspace(-1.5, 0.0, 41),
                                    -1.0, F64),
    # AB12 amplifies roundoff from step to step (its stability region is
    # tiny), so the grid is short: 11 bootstrap steps, then 6 AB12 steps.
    "explicit_o12": (False, 12, 4, (2, 16, 2), "tanh", False, _T5,
                     np.linspace(0.0, 2.0, 18), 1.0, F64),
    "implicit_o4_it4": (True, 4, 4, (2, 16, 2), "tanh", False, _T5,
                        np.linspace(0.0, 2.0, 33), 1.0, F64),
    "implicit_o4_it1_time": (True, 4, 1, (3, 12, 2), "elu", True, _T5,
                             np.linspace(0.0, 2.0, 25), 1.0, F64),
    "implicit_o12_it4_reverse": (True, 12, 4, (2, 16, 2), "tanh", False,
                                 _REV, np.linspace(-1.5, 0.0, 49), -1.0,
                                 F64),
    "implicit_wide": (True, 4, 2, (2, 144, 2), "tanh", False, _T5,
                      np.linspace(0.0, 2.0, 17), 1.0, F64),
    "explicit_float32": (False, 4, 4, (2, 16, 2), "tanh", False, _T5,
                         np.linspace(0.0, 2.0, 33), 1.0, F32),
    "implicit_float32": (True, 5, 3, (2, 16, 2), "tanh", False, _T5,
                         np.linspace(0.0, 2.0, 33), 1.0, F32),
    "implicit_invalid_times": (True, 4, 4, (2, 16, 2), "tanh", False,
                               np.array([0.0, 1.0, 0.5, 2.0]), None, 1.0,
                               F64),
}


@pytest.mark.parametrize("name", sorted(K10_CASES))
def test_plain_adams_matches_reference(name):
    (implicit, mo, iters, dims, act, ti, tau, grid, sign,
     dtype) = K10_CASES[name]
    grid = tau if grid is None else grid
    W = _weights(dims, seed=3)
    jw, jd, pw, pd, jdt = _packed(W, dtype)
    y0 = np.random.RandomState(4).randn(9, dims[-1])
    kw = dict(activation=act, input_power=3 if not ti else 1,
              time_input=ti, implicit=implicit, max_order=mo,
              max_iters=iters)
    jo, js = JPF.mlp_solve_adams(jw, jd, jnp.asarray(y0.T, jdt),
                                 jnp.asarray(tau, jdt), jnp.asarray(grid, jdt),
                                 1e-6, 1e-8, jnp.asarray(sign, jdt),
                                 interpret=True, pack=1, **kw)
    po, ps = PA.mlp_solve_adams(pw, pd, torch.tensor(y0, dtype=dtype),
                                torch.tensor(tau, dtype=dtype),
                                torch.tensor(grid, dtype=dtype), 1e-6, 1e-8,
                                sign, **kw)
    assert ps.tolist() == [int(x) for x in js]
    ref = np.asarray(jo).transpose(0, 2, 1)
    if dtype == F64:
        assert _rel(po.numpy(), ref) < 1e-12
    else:
        np.testing.assert_allclose(po.numpy(), ref, rtol=0, atol=1e-5)
    if name == "implicit_invalid_times":
        assert ps.tolist() == [0, 0, 0, 3] and not po[1:].any()
    else:
        G, boot = len(grid), min(mo - 1, len(grid) - 1)
        per = iters + 1 if implicit else 1
        assert ps.tolist() == [1 + 4 * boot + per * (G - 1 - boot), G - 1,
                               0, 0]
        assert torch.isfinite(po).all()


@pytest.mark.parametrize("method", ["explicit_adams", "fixed_adams"])
def test_plain_adams_order_one_matches_generic(method):
    """The reference's K10 does not trace at max_order = 1; the port's
    plain K10 takes the generic engine's steps there."""
    W = _weights((2, 16, 2), seed=5)
    jw, jd, pw, pd, _ = _packed(W, F64)
    y0 = np.random.RandomState(6).randn(7, 2)
    t = np.linspace(0.0, 1.0, 4)
    implicit = method == "fixed_adams"
    with pytest.raises(Exception):
        JPF.mlp_solve_adams(jw, jd, jnp.asarray(y0.T), jnp.asarray(t),
                            jnp.asarray(t), 1e-6, 1e-8, 1.0, interpret=True,
                            pack=1, implicit=implicit, max_order=1)
    spec = J.fast.MLPSpec(activation="tanh")
    jW = [(jnp.asarray(a), jnp.asarray(b)) for a, b in W]
    ref = J.solve(lambda tt, yy: JF.mlp_apply(spec, jW, yy),
                  jnp.asarray(y0), jnp.asarray(t), rtol=1e-6, atol=1e-8,
                  method=method, options={"max_order": 1, "num_steps": 24})
    grid = np.linspace(0.0, 1.0, 25)
    po, ps = PA.mlp_solve_adams(pw, pd, torch.tensor(y0), torch.tensor(t),
                                torch.tensor(grid), 1e-6, 1e-8, 1.0,
                                activation="tanh", implicit=implicit,
                                max_order=1)
    assert ps.tolist() == [int(x) for x in ref.stats]
    assert _rel(po.numpy(), ref.ys) < 1e-12


# name: (max_order, dims, activation, time_input, tau, sign, dt0,
#        max_steps, dtype)
K11_CASES = {
    "o12": (12, (2, 16, 2), "tanh", False, _T5, 1.0, 0.02, None, F64),
    "o4_reverse": (4, (2, 16, 2), "softplus", False, _REV, -1.0, 0.02, None,
                   F64),
    "o1": (1, (2, 8, 2), "tanh", False, np.linspace(0.0, 0.5, 3), 1.0, 0.02,
           None, F64),
    "o6_time_elu": (6, (3, 12, 2), "elu", True, _T5, 1.0, 0.05, None, F64),
    "o5_wide": (5, (2, 144, 2), "tanh", False, _T5, 1.0, 0.05, None, F64),
    "first_step_zero": (12, (2, 16, 2), "tanh", False,
                        np.linspace(0.0, 1.0, 3), 1.0, 0.0, None, F64),
    "max_steps": (12, (2, 16, 2), "tanh", False, _T5, 1.0, 0.02, 7, F64),
    "invalid_times": (12, (2, 16, 2), "tanh", False,
                      np.array([0.0, 1.0, 0.5, 2.0]), 1.0, 0.02, None, F64),
}


@pytest.mark.parametrize("name", sorted(K11_CASES))
def test_plain_vcabm_matches_reference(name):
    mo, dims, act, ti, tau, sign, dt0, max_steps, dtype = K11_CASES[name]
    W = _weights(dims, seed=7)
    jw, jd, pw, pd, jdt = _packed(W, dtype)
    y0 = np.random.RandomState(8).randn(8, dims[-1])
    kw = dict(activation=act, input_power=1 if ti else 3, time_input=ti,
              max_order=mo)
    steps = {} if max_steps is None else {"max_steps": max_steps}
    jo, js = JPV.mlp_solve_vcabm(jw, jd, jnp.asarray(y0.T, jdt),
                                 jnp.asarray(tau, jdt), dt0, 1e-6, 1e-8,
                                 jnp.asarray(sign, jdt), interpret=True,
                                 pack=1, **kw, **steps)
    po, ps = PA.mlp_solve_vcabm(pw, pd, torch.tensor(y0, dtype=dtype),
                                torch.tensor(tau, dtype=dtype), dt0, 1e-6,
                                1e-8, sign, **kw, **steps)
    ref = np.asarray(jo).transpose(0, 2, 1)
    if name == "first_step_zero":
        # dt0 clamps to dt_min (4 eps): the first error estimates are
        # roundoff, so the two step sequences may part; the solve ends
        # and agrees within the solutions' own error (1.5e-5 here; the
        # reference's test, tests/test_fixed_fused.py:666, allows 2e-4).
        assert ps[3].item() == int(js[3]) == 0
        np.testing.assert_allclose(po.numpy(), ref, rtol=0, atol=1e-4)
        return
    assert ps.tolist() == [int(x) for x in js]
    assert _rel(po.numpy(), ref) < 1e-12
    status = {"max_steps": 1, "invalid_times": 3}.get(name, 0)
    assert ps[3].item() == status
    if name == "max_steps":
        assert ps[1].item() + ps[2].item() == 7
    if name == "invalid_times":
        assert ps.tolist() == [0, 0, 0, 3] and not po[1:].any()


def test_plain_vcabm_float32_tracks_reference():
    """Float32: the accept sequence may part from the reference's by an
    ulp in a ratio near 1 (tests/test_fixed_fused.py:443-488), so the
    counts agree within a few and the trajectories within 1e-4."""
    W = _weights((2, 16, 2), seed=9)
    jw, jd, pw, pd, jdt = _packed(W, F32)
    y0 = np.random.RandomState(10).randn(16, 2)
    kw = dict(activation="tanh", input_power=3)
    jo, js = JPV.mlp_solve_vcabm(jw, jd, jnp.asarray(y0.T, jdt),
                                 jnp.asarray(_T5, jdt), 0.02, 1e-5, 1e-7,
                                 jnp.float32(1.0), interpret=True, pack=1,
                                 **kw)
    po, ps = PA.mlp_solve_vcabm(pw, pd, torch.tensor(y0, dtype=F32),
                                torch.tensor(_T5, dtype=F32), 0.02, 1e-5,
                                1e-7, 1.0, **kw)
    js = [int(x) for x in js]
    assert ps[3].item() == js[3] == 0
    assert abs(ps[1].item() - js[1]) <= 0.12 * js[1] + 2
    np.testing.assert_allclose(po.numpy(), np.asarray(jo).transpose(0, 2, 1),
                               rtol=0, atol=1e-4)


def _spec_weights(dims=(2, 24, 2), seed=11):
    W = _weights(dims, seed, scale=0.8)
    return ([(jnp.asarray(a), jnp.asarray(b)) for a, b in W],
            [(torch.tensor(a), torch.tensor(b)) for a, b in W])


# name: (method, t, kwargs)
SPEC_CASES = {
    "adams_first_step": ("adams", np.linspace(0.0, 2.0, 6),
                         dict(first_step=0.02, rtol=1e-6, atol=1e-8)),
    # The HNW first step (2 extra evaluations) at a loose tolerance: from
    # a small first step, error estimates far below the tolerance carry
    # roundoff into the controller in proportion to tol / estimate.
    "adams_hnw_reverse": ("adams", np.linspace(1.5, 0.0, 5),
                          dict(rtol=1e-4, atol=1e-6, max_order=7)),
    "explicit_num_steps": ("explicit_adams", np.linspace(0.0, 2.0, 6),
                           dict(num_steps=40)),
    "fixed_step_size_reverse": ("fixed_adams", np.linspace(1.0, 0.0, 5),
                                dict(step_size=0.05, max_order=6,
                                     max_iters=2)),
    "fixed_default_grid": ("fixed_adams", np.linspace(0.0, 2.0, 9), {}),
}


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_solve_mlp_spec_matches_reference(name):
    method, t, kw = SPEC_CASES[name]
    jW, pW = _spec_weights()
    y0 = np.random.RandomState(12).randn(8, 2)
    jr = JF.solve_mlp_spec(JF.MLPSpec(activation="tanh", input_power=3), jW,
                           jnp.asarray(y0), jnp.asarray(t), method=method,
                           interpret=True, **kw)
    pr = PF.solve_mlp_spec(PF.MLPSpec(activation="tanh", input_power=3), pW,
                           torch.tensor(y0), torch.tensor(t), method=method,
                           **kw)
    assert list(pr.stats) == [int(x) for x in jr.stats]
    assert pr.stats.status == 0
    assert _rel(pr.ys.numpy(), jr.ys) < 1e-12


def test_solve_mlp_adams_matches_reference():
    """`solve_mlp` / `odeint_mlp` pass the method through (VCABM on the
    spiral)."""
    rng = np.random.RandomState(13)
    p = {"w1": rng.randn(2, 16) * 0.1, "b1": np.zeros(16),
         "w2": rng.randn(16, 2) * 0.1, "b2": np.zeros(2)}
    y0 = rng.randn(8, 2) * 1.5
    t = np.linspace(0.0, 3.0, 7)
    jr = JF.solve_mlp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(y0), jnp.asarray(t), method="adams",
                      first_step=0.01, interpret=True)
    pp = {k: torch.tensor(v) for k, v in p.items()}
    pr = PF.solve_mlp(pp, torch.tensor(y0), torch.tensor(t), method="adams",
                      first_step=0.01)
    assert list(pr.stats) == [int(x) for x in jr.stats]
    assert _rel(pr.ys.numpy(), jr.ys) < 1e-12
    assert torch.equal(PF.odeint_mlp(pp, torch.tensor(y0), torch.tensor(t),
                                     method="adams", first_step=0.01),
                       pr.ys)


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_plan_route_matches_reference_and_mlp_route(name):
    """K14 inside K10 and K11: the same MLP written as plain PyTorch through
    `fast.solve_fused` (the plan's plain K10 / K11:
    `cuda_plan.plan_solve_adams_plain` / `plan_solve_vcabm_plain`) against
    the reference's `solve_fused(method=...)` in interpret mode (identical
    stats, 1e-12 relative) and against the port's MLP route on the same
    weights (`solve_mlp_spec`, identical stats, within 1e-12 relative: the
    plan evaluates the same products in the same order)."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as CP

    method, t, kw = SPEC_CASES[name]
    jW, pW = _spec_weights()
    y0 = np.random.RandomState(12).randn(8, 2)

    def jf(tt, y):
        return jnp.tanh((y ** 3) @ jW[0][0] + jW[0][1]) @ jW[1][0] \
            + jW[1][1]

    def pf(tt, y):
        return torch.tanh((y ** 3) @ pW[0][0] + pW[0][1]) @ pW[1][0] \
            + pW[1][1]

    jr = JF.solve_fused(jf, jnp.asarray(y0), jnp.asarray(t), method=method,
                        interpret=True, **kw)
    wrapper = "plan_solve_vcabm" if method == "adams" else "plan_solve_adams"
    calls = []
    orig = getattr(CP, wrapper)

    def seen(*a, **k):
        calls.append(wrapper)
        return orig(*a, **k)

    setattr(CP, wrapper, seen)
    try:
        pr = PF.solve_fused(pf, torch.tensor(y0), torch.tensor(t),
                            method=method, **kw)
    finally:
        setattr(CP, wrapper, orig)
    assert calls == [wrapper]
    assert pr.stats.status == 0
    assert list(pr.stats) == [int(x) for x in jr.stats]
    assert _rel(pr.ys.numpy(), jr.ys) < 1e-12
    mr = PF.solve_mlp_spec(PF.MLPSpec(activation="tanh", input_power=3), pW,
                           torch.tensor(y0), torch.tensor(t), method=method,
                           **kw)
    assert list(pr.stats) == list(mr.stats)
    assert _rel(pr.ys.numpy(), mr.ys.numpy()) < 1e-12


def test_plan_route_refusals():
    """A coupled plan on K10 / K11, once refused (ROADMAP queue 2 item 3),
    runs on their one-block route and matches the generic engine; a reduced
    dot_precision with an Adams method raises ValueError, as in the
    reference (odeint.py:137-143)."""
    y = torch.tensor(np.random.RandomState(5).randn(3, 2), dtype=F64)
    t = torch.tensor([0.0, 0.5, 1.0], dtype=F64)
    centred = lambda tt, v: v - v.mean(0)
    for method in ("explicit_adams", "fixed_adams", "adams"):
        got = PF.solve_fused(centred, y, t, rtol=1e-8, atol=1e-8,
                             method=method)
        want = P.solve(centred, y, t, rtol=1e-8, atol=1e-8, method=method)
        assert got.stats.status == 0
        assert _rel(got.ys.numpy(), want.ys.numpy()) < 1e-5
        with pytest.raises(ValueError, match="not supported on the Adams"):
            PF.solve_fused(lambda tt, v: -v, y, t, method=method,
                           dot_precision="bf16")
        with pytest.raises(ValueError, match="not supported on the Adams"):
            _solve_fused_mixed(method)


def _solve_fused_mixed(method):
    from tfdiffeq_tpu_torch import solve
    return solve(lambda tt, v: -v, torch.ones(3, 2, dtype=F64), [0.0, 1.0],
                 method=method, options={"fuse": True,
                                         "dot_precision": "mixed"})


def test_fused_adams_adjoint_takes_tier_two():
    """odeint_adjoint(options={'fuse': True}) with an Adams method: the
    fused forward on K10 / K11 and the generic backward (the reference's
    tier 2), no fallback counted; the gradient of sum(y(1)) for
    dy/dt = -y is exp(-1)."""
    from tfdiffeq_tpu_torch import odeint_adjoint
    from tfdiffeq_tpu_torch.ops import cuda_plan as CP

    for method, opts in (("adams", {}), ("fixed_adams", {"num_steps": 50})):
        before = PF.fuse_fallbacks
        calls = []
        name = "plan_solve_vcabm" if method == "adams" else "plan_solve_adams"
        orig = getattr(CP, name)
        setattr(CP, name, lambda *a, _o=orig, **k: (calls.append(1),
                                                     _o(*a, **k))[1])
        try:
            y0 = torch.ones(3, 2, dtype=F64, requires_grad=True)
            ys = odeint_adjoint(lambda tt, v: -v, y0,
                                torch.tensor([0.0, 1.0], dtype=F64),
                                method=method, adjoint_method="dopri5",
                                options={"fuse": True, **opts})
            ys[-1].sum().backward()
        finally:
            setattr(CP, name, orig)
        assert calls == [1] and PF.fuse_fallbacks == before
        np.testing.assert_allclose(y0.grad.numpy(), np.exp(-1.0), rtol=1e-5)


@pytest.mark.parametrize("call, exc, match", [
    (lambda W, y, t: PF.solve_mlp_spec(
        PF.MLPSpec(dot_precision="mixed", matmul="mxu"), W, y, t,
        method="fixed_adams"), ValueError, "not supported on the Adams"),
    (lambda W, y, t: PF.solve_mlp_spec(PF.MLPSpec(), W, y, t,
                                       method="adams", per_sample=True),
     ValueError, "adaptive RK methods only"),
    (lambda W, y, t: PF.solve_mlp_spec(PF.MLPSpec(), W, y, t,
                                       method="explicit_adams",
                                       max_order=13),
     ValueError, "max_order"),
    (lambda W, y, t: PF.solve_mlp_spec(PF.MLPSpec(), W, y, t,
                                       method="adams", max_order=0),
     ValueError, "max_order"),
    (lambda W, y, t: PF.odeint_adjoint_mlp(PF.MLPSpec(), W, y, t,
                                           method="adams"),
     ValueError, "adjoint_method='adams'"),
    (lambda W, y, t: PF.odeint_adjoint_mlp(PF.MLPSpec(), W, y, t,
                                           method="dopri5",
                                           adjoint_method="fixed_adams"),
     ValueError, "dopri5"),
], ids=["tier", "per_sample", "fixed_order", "vcabm_order",
        "adjoint_default", "adjoint_fixed_adams"])
def test_fused_adams_refusals(call, exc, match):
    W = [(torch.zeros(2, 4, dtype=F64), torch.zeros(4, dtype=F64)),
         (torch.zeros(4, 2, dtype=F64), None)]
    with pytest.raises(exc, match=match):
        call(W, torch.ones(3, 2, dtype=F64), torch.tensor([0.0, 1.0],
                                                          dtype=F64))


_TRAIN_T = np.linspace(0.0, 1.5, 5)


@pytest.mark.parametrize("method, adjoint_method, kw", [
    ("adams", "dopri5", dict(first_step=0.02)),
    ("fixed_adams", "rk4", dict(num_steps=40, adjoint_num_steps=6)),
], ids=["adams_dopri5", "fixed_adams_rk4"])
def test_adjoint_mlp_adams_forward_matches_reference(method, adjoint_method,
                                                     kw):
    jW, pW = _spec_weights(seed=14)
    y0 = np.random.RandomState(15).randn(8, 2)
    g = np.random.RandomState(16).randn(len(_TRAIN_T), 8, 2)
    opts = dict(method=method, adjoint_method=adjoint_method, rtol=1e-7,
                atol=1e-9, **kw)

    def jloss(w, y):
        ys = JF.odeint_adjoint_mlp(JF.MLPSpec(activation="tanh"), w, y,
                                   jnp.asarray(_TRAIN_T), interpret=True,
                                   **opts)
        return jnp.sum(ys * jnp.asarray(g))

    jg_w, jg_y = jax.grad(jloss, argnums=(0, 1))(jW, jnp.asarray(y0))
    pw = [(a.clone().requires_grad_(), b.clone().requires_grad_())
          for a, b in pW]
    py = torch.tensor(y0, requires_grad=True)
    ys = PF.odeint_adjoint_mlp(PF.MLPSpec(activation="tanh"), pw, py,
                               torch.tensor(_TRAIN_T), **opts)
    torch.sum(ys * torch.tensor(g)).backward()
    pairs = [(py.grad, jg_y)] + [
        (p.grad, j) for (pa, pb), (ja, jb) in zip(pw, jg_w)
        for p, j in ((pa, ja), (pb, jb))]
    for p, j in pairs:
        assert _rel(p.numpy(), j) < 1e-6


def test_adams_adjoint_method_raises_before_any_launch():
    """The reference's fused backward has no Adams sweep: with
    adjoint_method left at its default (= method) its jax.grad raises
    KeyError (fast.py:1524-1531 -> pallas_adjoint.py:1083). The port
    refuses the call up front, before any kernel or plain version runs."""
    jW, pW = _spec_weights(seed=17)
    y0 = np.random.RandomState(18).randn(8, 2)

    def jloss(w):
        ys = JF.odeint_adjoint_mlp(JF.MLPSpec(activation="tanh"), w,
                                   jnp.asarray(y0), jnp.asarray(_TRAIN_T),
                                   method="adams", first_step=0.02,
                                   interpret=True)
        return jnp.sum(ys)

    with pytest.raises(KeyError, match="adams"):
        jax.grad(jloss)(jW)
    PA.reset_launch_counts()
    calls = []
    saved = PF.mlp_solve_vcabm
    PF.mlp_solve_vcabm = lambda *a, **k: calls.append(1)
    try:
        with pytest.raises(ValueError, match="adjoint_method='adams'"):
            PF.odeint_adjoint_mlp(PF.MLPSpec(activation="tanh"), pW,
                                  torch.tensor(y0), torch.tensor(_TRAIN_T),
                                  method="adams", first_step=0.02)
    finally:
        PF.mlp_solve_vcabm = saved
    assert not calls
