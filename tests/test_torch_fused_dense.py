"""PyTorch port: `fast.solve_fused(dense_output=True)` (K2's per-step
interpolant emission through its plain version on the CPU) against the
reference's `solve_fused(dense_output=True, interpret=True)`.

B = 8 (12 for the mean-field coupling; one block in the reference, whose
grid-blocked `BlockDenseOutput` needs a larger batch), 5 outputs over a
span of 5, `max_num_steps` 64 in both packages (the rows, S, and the step
budget), the first step pinned; the dynamics and states are
tests/test_torch_plan_bridge.py's.
Compared: the trajectory, the stats, the metadata rows (t0, t1, dt in tau)
and the coefficient rows of the accepted steps, and `eval_flat` at the
output times and between them. The reference's coefficients come
feature-major from its kernel and are transposed to the port's batch-major
[S, 5, B * D] by its front end, so rows compare directly.

Tolerances, from the measured gaps. Float64: equal stats, trajectories
and evaluations within 1e-12 (measured 1.4e-14), rows within 1e-9
(measured 4.1e-10): the error ratio cancels, so a last-bit difference in
f moves it by about eps / rtol, and the controller carries that into the
later step times and their coefficients. Float32: the error estimate of
the pinned first step is itself roundoff, so the two packages take other
step sizes from the second step on (up to 0.2 apart, and a rejection more
or less): rows and stats are not compared, trajectories and evaluations
are held within 2e-5 (measured 1.2e-5 at rtol 1e-6; tests/test_torch_
fuse.py holds f32 trajectories within 1e-5 at span 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.ops.jaxpr_bridge import FusionError as JFusionError
from tfdiffeq_tpu_torch import fast as PF, solve
from tfdiffeq_tpu_torch.ops import cuda_plan
from tfdiffeq_tpu_torch.ops import plan_bridge as pb
from tfdiffeq_tpu_torch.ops.plan_bridge import FusionError

from test_torch_plan_bridge import _dyn

S, FIRST = 64, 0.05
T = np.linspace(0.0, 5.0, 5)
TOL = {np.float64: (1e-9, 1e-12), np.float32: (None, 2e-5)}


def _t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _tdt(dtype):
    return torch.float32 if dtype == np.float32 else torch.float64


def _pair(name, dtype):
    """(torch f, jax f, numpy y0) of the dynamics set."""
    f, y0 = _dyn(torch, _tdt(dtype))[name]
    jf, _ = _dyn(jnp, dtype)[name]
    return f, jf, np.asarray(y0)


def _both(name, dtype, t=T, **kw):
    f, jf, y0 = _pair(name, dtype)
    kw = {**dict(rtol=1e-6, atol=1e-8, first_step=FIRST, max_num_steps=S,
                 dense_output=True), **kw}
    r = PF.solve_fused(f, _t(y0, _tdt(dtype)), _t(t, _tdt(dtype)), **kw)
    rj = JF.solve_fused(jf, jnp.asarray(y0, dtype), jnp.asarray(t, dtype),
                        interpret=True, **kw)
    return r, rj


def _check(r, rj, dtype, t=T):
    rows, traj = TOL[dtype]
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), rtol=0,
                               atol=traj)
    n = int(r.stats.n_accepted)
    d, dj = r.dense, rj.dense
    assert d.coeffs.shape == (S, 5, r.ys[0].numel()) == dj.coeffs.shape
    # Unused rows never win a search (pallas_kernels.py:758-760).
    assert torch.isfinite(d.t1s[:n]).all() and torch.isinf(d.t1s[n:]).all()
    assert np.isinf(np.asarray(dj.t1s)[int(rj.stats.n_accepted):]).all()
    if rows is not None:
        assert [int(x) for x in r.stats] == [int(x) for x in rj.stats]
        for a, b in ((d.t0s, dj.t0s), (d.t1s, dj.t1s), (d.dts, dj.dts)):
            np.testing.assert_allclose(a[:n].numpy(), np.asarray(b)[:n],
                                       rtol=0, atol=rows)
        np.testing.assert_allclose(d.coeffs[:n].numpy(),
                                   np.asarray(dj.coeffs)[:n], rtol=0,
                                   atol=rows)
    assert float(d.sign) == float(dj.sign)
    lo, hi = min(t[0], t[-1]), max(t[0], t[-1])
    q = np.concatenate([t, np.linspace(lo, hi, 17)])
    np.testing.assert_allclose(
        d.eval_flat(_t(q, _tdt(dtype))).numpy(),
        np.asarray(dj.eval_flat(jnp.asarray(q, dtype))), rtol=0, atol=traj)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["mlp", "concat_t"])
def test_fused_dense_output_matches_reference(name, dtype, reverse):
    t = T[::-1].copy() if reverse else T
    r, rj = _both(name, dtype, t)
    assert int(r.stats.status) == 0
    _check(r, rj, dtype, t)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_coupled_plan_dense_output_matches_reference(dtype):
    """A mean-field coupling (y.mean(0)): the plan runs K2's batch route
    on one block and emits the same rows."""
    r, rj = _both("meanfield", dtype)
    assert int(r.stats.status) == 0
    _check(r, rj, dtype)


def test_budget_exhaustion_is_status_one():
    """max_steps = S (reference fast.py:1170-1174): out of rows is out of
    steps, status 1, in both packages, with the rows kept so far."""
    r, rj = _both("mlp", np.float64, max_num_steps=3)
    assert int(r.stats.status) == int(rj.stats.status) == 1
    assert int(r.stats.n_accepted) + int(r.stats.n_rejected) == 3
    n = int(r.stats.n_accepted)
    assert r.dense.coeffs.shape[0] == 3
    np.testing.assert_allclose(r.dense.coeffs[:n].numpy(),
                               np.asarray(rj.dense.coeffs)[:n], rtol=0,
                               atol=TOL[np.float64][0])


@pytest.mark.parametrize("kw", [
    dict(method="adams"), dict(method="rk4"), dict(method="explicit_adams"),
    dict(method="fixed_adams"), dict(per_sample=True)],
    ids=["vcabm", "fixed_grid", "explicit_adams", "fixed_adams",
         "per_sample"])
def test_refusals_match_reference(kw):
    """The reference's refusals with its exception type (FusionError):
    VCABM fast.py:838-840, fixed grids and Adams :862-864, per_sample
    :872-874."""
    f, jf, y0 = _pair("mlp", np.float32)
    with pytest.raises(JFusionError, match="dense_output"):
        JF.solve_fused(jf, jnp.asarray(y0, jnp.float32),
                       jnp.asarray(T, jnp.float32), dense_output=True,
                       interpret=True, **kw)
    with pytest.raises(FusionError, match="dense_output"):
        PF.solve_fused(f, _t(y0, torch.float32), _t(T, torch.float32),
                       dense_output=True, **kw)


@pytest.mark.parametrize("name", ["mlp", "meanfield"])
def test_plain_rows_leave_out_unchanged(name):
    """K2's plain version with emit_dense gives the same out and stats,
    bit for bit, as without it; the rows are the drain's coefficients."""
    f, _, y0 = _pair(name, np.float64)
    y0 = _t(y0, torch.float64)
    tau = _t(T, torch.float64)
    plan, consts = pb.build_plan(f, tau[0], y0)
    packed = pb.pack_consts(plan, consts, torch.float64, y0.device)
    g = cuda_plan.plan_rhs(plan, packed, torch.tensor(1.0,
                                                      dtype=torch.float64))
    f0 = g(tau[0], y0)
    kw = dict(max_steps=S)
    out, stats = cuda_plan.plan_solve_plain(plan, packed, y0, tau, FIRST,
                                            1e-6, 1e-8, 1.0, f0, **kw)
    out2, stats2, meta, coef = cuda_plan.plan_solve_plain(
        plan, packed, y0, tau, FIRST, 1e-6, 1e-8, 1.0, f0, emit_dense=S,
        **kw)
    assert torch.equal(out, out2) and torch.equal(stats, stats2)
    n = int(stats[1])
    assert meta.shape == (S, 3) and coef.shape == (S, 5) + tuple(y0.shape)
    assert torch.isinf(meta[n:]).all() and (coef[n:] == 0).all()
    assert torch.equal(meta[0, 0], tau[0]) and meta[n - 1, 1] == tau[-1]
    # Row s evaluated at x = 1 is the step's end state up to roundoff;
    # the drain wrote that state into the last output row exactly.
    end = coef[n - 1].sum(0)
    torch.testing.assert_close(end, out[-1], rtol=0, atol=1e-12)
    # The wrapper on the CPU is the plain version.
    got = cuda_plan.plan_solve(plan, packed, y0, tau, FIRST, 1e-6, 1e-8,
                               1.0, f0, emit_dense=S, **kw)
    for a, b in zip(got, (out2, stats2, meta, coef)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="emit_dense"):
        cuda_plan.plan_solve_plain(plan, packed, y0, tau, FIRST, 1e-6,
                                   1e-8, 1.0, f0, per_sample=True,
                                   emit_dense=S)


def test_fused_dense_output():
    """The reference's test_fused_dense_output (tests/test_fuse.py:360):
    evaluation between the outputs matches direct solves within 1e-5."""
    f, _, y0 = _pair("mlp", np.float32)
    y0 = _t(y0, torch.float32)
    r = PF.solve_fused(f, y0, _t(T, torch.float32), rtol=1e-6, atol=1e-8,
                       dense_output=True, max_num_steps=256)
    assert r.dense is not None
    for tq in (0.37, 2.11, 4.93):
        got = r.dense.eval_flat(torch.tensor(tq)).reshape(y0.shape)
        want = solve(f, y0, torch.tensor([0.0, tq]), rtol=1e-8,
                     atol=1e-10).ys[-1]
        assert float((got - want).abs().max()) < 1e-5
    # At the end, the interpolant at x = 1 against the drain's y1
    # (tests/test_fuse.py:441-445 allows 1e-6 there).
    v_end = r.dense.eval_flat(torch.tensor(T[-1], dtype=torch.float32))
    assert float((v_end - r.ys[-1].reshape(-1)).abs().max()) < 1e-6


def test_unbatched_state_and_unit_span():
    """A [D] state is a batch of one, its coefficients [S, 5, D]; one
    output time returns no dense output, as in the reference."""
    f, jf, y0 = _pair("mlp", np.float64)
    r = PF.solve_fused(f, _t(y0[0], torch.float64), _t(T, torch.float64),
                       first_step=FIRST, dense_output=True, max_num_steps=S)
    rj = JF.solve_fused(jf, jnp.asarray(y0[0]), jnp.asarray(T),
                        first_step=FIRST, dense_output=True,
                        max_num_steps=S, interpret=True)
    assert r.dense.coeffs.shape == (S, 5, 2)
    q = np.linspace(0.0, 5.0, 9)
    np.testing.assert_allclose(
        r.dense.eval_flat(_t(q, torch.float64)).numpy(),
        np.asarray(rj.dense.eval_flat(jnp.asarray(q))), rtol=0, atol=1e-12)
    one = PF.solve_fused(f, _t(y0, torch.float64), _t(T[:1], torch.float64),
                         dense_output=True)
    assert one.dense is None and one.ys.shape == (1,) + y0.shape


def test_generic_dense_output_agrees_with_fused():
    """The fused rows and the generic engine's rows describe the same
    solution: both evaluations agree within the solve's tolerance."""
    f, _, y0 = _pair("mlp", np.float64)
    y0, t = _t(y0, torch.float64), _t(T, torch.float64)
    r = PF.solve_fused(f, y0, t, rtol=1e-9, atol=1e-11, dense_output=True,
                       max_num_steps=512)
    g = solve(f, y0, t, rtol=1e-9, atol=1e-11,
              options={"dense_output": True})
    q = _t(np.linspace(0.0, 5.0, 21), torch.float64)
    torch.testing.assert_close(r.dense.eval_flat(q), g.dense.eval_flat(q),
                               rtol=0, atol=1e-6)
