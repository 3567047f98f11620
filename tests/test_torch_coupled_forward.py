"""PyTorch port: batch-coupled plans on a fixed grid and on the Adams
kernels (K14's coupled mode inside K8, K10 and K11, each on one block)
against the JAX package.

The problem is tests/test_meanfield.py's: B = 12, D = 3, W = 0.3 randn,
7 outputs over [0, 2], the mean-field coupling y - mean(y), the to-scalar
energy mean(y^2) y and a batch max. On the CPU `solve(options={'fuse':
True})` runs the plain versions of the kernels (`cuda_plan.
plan_solve_fixed_plain`, `plan_solve_adams_plain`, `plan_solve_vcabm_plain`:
the engines of `cuda_fixed` and `cuda_adams` with `eval_plan`, every batch
sum in the order of the kernels' one block), and the reference's
`solve_fused(interpret=True)` runs its kernels `plan_solve_fixed`,
`plan_solve_adams` and `plan_solve_vcabm` in interpret mode, so each
comparison holds a plain version to the reference kernel it replaces.
Tolerances:
- the fixed-grid methods and both fixed-step Adams methods at num_steps=32:
  identical stats, 5e-6 absolute in float32 (tests/test_meanfield.py:54-60's
  bar: the two packages' tanh and batch sums round differently, a few ulps
  a step over 32 steps) and 1e-12 in float64 (the same arithmetic; only the
  summation order of the batch mean and the last ulp of tanh differ);
- VCABM in float64 from a pinned first step: step-exact (the stats equal)
  and within 1e-10 (from HNW's tiny first step the error estimates run on
  roundoff, ROADMAP queue 3's caveat, so the first step is pinned);
- the batch max (tests/test_meanfield.py:125-155) on VCABM against the
  port's generic engine: a field that is only C^0 amplifies roundoff, so a
  tanh-coupled max is held to the envelope (2e-4, nfe at most twice), and
  a pure max-coupled field, which takes the same steps, to 5e-6 with equal
  nfe;
- the conserved mean of dy_i/dt = -(y_i - mean y) on rk4 and fixed_adams
  (tests/test_meanfield.py:98-114): within 1e-5, the spread shrinking.
No case warns or falls back (`fast.fuse_fallbacks` does not move), and the
wrappers that run are the plan kernels' own.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_plan as CP

B, D = 12, 3
RNG = np.random.RandomState(0)
W = RNG.randn(D, D) * 0.3
Y0 = RNG.randn(B, D)
T = np.linspace(0.0, 2.0, 7)
FIXED = ["euler", "midpoint", "rk4", "rk4_38", "fixed_adams",
         "explicit_adams"]
F32, F64 = torch.float32, torch.float64


def _dyn(xp, w):
    """The couplings of tests/test_meanfield.py in either package."""
    if xp is torch:
        return {
            "meanfield": lambda t, y: torch.tanh(y @ w)
            - 0.5 * (y - y.mean(0)),
            "scalar_coupled": lambda t, y: torch.tanh(y @ w)
            - 0.1 * (y ** 2).mean() * y,
            "bmax": lambda t, y: torch.tanh(y @ w)
            - 0.3 * (y - y.amax(0)),
        }
    return {
        "meanfield": lambda t, y: jnp.tanh(y @ w)
        - 0.5 * (y - jnp.mean(y, axis=0)),
        "scalar_coupled": lambda t, y: jnp.tanh(y @ w)
        - 0.1 * jnp.mean(y ** 2) * y,
        "bmax": lambda t, y: jnp.tanh(y @ w) - 0.3 * (y - jnp.max(y, axis=0)),
    }


def _port(name, method, dtype, **opts):
    """solve(fuse) with the plan wrapper that ran, no warning and no
    fallback."""
    f = _dyn(torch, torch.tensor(W, dtype=dtype))[name]
    wrapper = {"adams": "plan_solve_vcabm", "fixed_adams": "plan_solve_adams",
               "explicit_adams": "plan_solve_adams"}.get(method,
                                                         "plan_solve_fixed")
    seen, orig = [], getattr(CP, wrapper)

    def spy(*a, **k):
        seen.append(a[0].batch_coupled)
        return orig(*a, **k)

    before = PF.fuse_fallbacks
    setattr(CP, wrapper, spy)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            r = P.solve(f, torch.tensor(Y0, dtype=dtype),
                        torch.tensor(T, dtype=dtype), rtol=1e-6, atol=1e-8,
                        method=method, options={"fuse": True, **opts})
    finally:
        setattr(CP, wrapper, orig)
    assert seen == [True] and PF.fuse_fallbacks == before
    return r


def _ref(name, method, dtype, **opts):
    f = _dyn(jnp, jnp.asarray(W, dtype))[name]
    r = JF.solve_fused(f, jnp.asarray(Y0, dtype), jnp.asarray(T, dtype),
                       rtol=1e-6, atol=1e-8, method=method, interpret=True,
                       **opts)
    return np.asarray(r.ys), [int(x) for x in r.stats]


@pytest.mark.parametrize("method", FIXED)
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_meanfield_fixed_methods_match_reference(dtype, method):
    r = _port("meanfield", method, dtype, num_steps=32)
    ys, stats = _ref("meanfield", method,
                     jnp.float32 if dtype == F32 else jnp.float64,
                     num_steps=32)
    assert [int(x) for x in r.stats] == stats and stats[3] == 0
    tol = 5e-6 if dtype == F32 else 1e-12
    np.testing.assert_allclose(r.ys.numpy(), ys, rtol=0, atol=tol)


@pytest.mark.parametrize("method", ["rk4", "fixed_adams", "explicit_adams"])
@pytest.mark.parametrize("name", ["scalar_coupled", "bmax"])
def test_other_couplings_match_reference(name, method):
    """The to-scalar coupling and the batch max on the fixed grids, where
    the max is as smooth as its field lets it be (no step control)."""
    r = _port(name, method, F32, num_steps=32)
    ys, stats = _ref(name, method, jnp.float32, num_steps=32)
    assert [int(x) for x in r.stats] == stats
    np.testing.assert_allclose(r.ys.numpy(), ys, rtol=0, atol=5e-6)


def test_meanfield_vcabm_matches_reference_step_for_step():
    r = _port("meanfield", "adams", F64, first_step=0.05)
    ys, stats = _ref("meanfield", "adams", jnp.float64, first_step=0.05)
    assert [int(x) for x in r.stats] == stats and stats[3] == 0
    np.testing.assert_allclose(r.ys.numpy(), ys, rtol=0, atol=1e-10)


def test_batch_max_on_vcabm_keeps_the_envelope():
    """tests/test_meanfield.py:125-155 on K11's coupled route (float32)."""
    w = torch.tensor(W, dtype=F32)
    y0, t = torch.tensor(Y0, dtype=F32), torch.tensor(T, dtype=F32)

    def mx(tt, yy):
        return (torch.tanh(yy @ w) - 0.1 * yy.amax(0) + 0.05 * yy.amin(0))

    def pure(tt, yy):
        return -0.5 * yy - 0.1 * yy.amax(0) + 0.05 * yy.amin(0)

    for f, atol, same_nfe in ((mx, 2e-4, False), (pure, 5e-6, True)):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            rf = P.solve(f, y0, t, rtol=1e-6, atol=1e-8, method="adams",
                         options={"fuse": True})
        rg = P.solve(f, y0, t, rtol=1e-6, atol=1e-8, method="adams")
        assert int(rf.stats.status) == 0
        np.testing.assert_allclose(rf.ys.numpy(), rg.ys.numpy(), atol=atol)
        if same_nfe:
            assert int(rf.stats.nfe) == int(rg.stats.nfe)
        else:
            assert int(rf.stats.nfe) <= 2 * int(rg.stats.nfe)


@pytest.mark.parametrize("method", ["rk4", "fixed_adams"])
def test_meanfield_matches_oracle_mean_dynamics(method):
    """tests/test_meanfield.py:98-114 on K8 and K10: the mean of
    dy_i/dt = -(y_i - mean y) is conserved and the samples relax to it."""
    y0 = torch.tensor(Y0, dtype=F32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = P.solve(lambda tt, yy: -(yy - yy.mean(0)), y0,
                    torch.tensor(T, dtype=F32), method=method,
                    options={"fuse": True, "num_steps": 64})
    m0, mT = y0.mean(0), r.ys[-1].mean(0)
    np.testing.assert_allclose(mT.numpy(), m0.numpy(), atol=1e-5)
    spread0 = float((y0 - m0).abs().max())
    spreadT = float((r.ys[-1] - mT).abs().max())
    assert spreadT < 0.2 * spread0


def test_coupled_plans_reach_one_block_and_k12_still_refuses():
    """The wrappers' one-block contract: a coupled plan takes no wider
    grid (ValueError before any launch), and K12 keeps its refusal
    (ROADMAP queue 2 item 3)."""
    from tfdiffeq_tpu_torch.ops import plan_bridge as PB
    y0 = torch.tensor(Y0, dtype=F64)
    f = _dyn(torch, torch.tensor(W, dtype=F64))["meanfield"]
    plan, consts = PB.build_plan(f, torch.tensor(0.0, dtype=F64), y0)
    packed = PB.pack_consts(plan, consts, F64)
    t = torch.tensor(T, dtype=F64)
    f0 = CP.plan_rhs(plan, packed, torch.tensor(1.0, dtype=F64))(t[0], y0)
    grid = torch.linspace(0.0, 2.0, 9, dtype=F64)
    assert CP.plan_blocks(plan, B, torch.device("cpu")) == 1
    with pytest.raises(ValueError, match="one block"):
        CP.plan_solve_adams(plan, packed, y0, t, grid, 1e-6, 1e-8, 1.0, f0,
                            n_blocks=2)
    with pytest.raises(ValueError, match="one block"):
        CP.plan_solve_vcabm(plan, packed, y0, t, 0.05, 1e-6, 1e-8, 1.0, f0,
                            n_blocks=3)
    with pytest.raises(NotImplementedError, match="queue 2 item 3"):
        CP.plan_solve_hyper(plan, plan, packed, packed, y0, t, grid, 1.0)
