"""PyTorch port: the per-sample forward tier against the JAX package.

- The plain K5 (`ops/cuda_perlane.mlp_solve_perlane` on CPU tensors)
  against the JAX per-lane kernel `pallas_kernels.mlp_solve(...,
  per_sample=True, interpret=True)`, float64, B = 16: the spiral MLP with a
  spread of state magnitudes (tests/test_per_sample.py:79-101), reverse
  time, tsit5 with a time column, and a `max_steps` that stops only the
  stiff samples. Each sample's counts are identical and the trajectories
  agree within 1e-12 relative (the same arithmetic; the JAX kernel's
  feature sums are its own reductions).
- `fast.solve_mlp_spec(per_sample=True)` against the JAX one: trajectories
  (1e-12 relative), stats with the initial-step evaluations, lane_stats;
  `select_initial_step_per_sample` against the JAX one.
- The generic `solve(options={'per_sample': True})` against the JAX
  `_per_sample_vmap` route (a vmapped generic solve a sample): identical
  per-sample counts, trajectories within 1e-12.
- The refusals.

Each JAX reference compiles once, in a module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF, solve as j_solve
from tfdiffeq_tpu.ops import norms as JN, pallas_kernels as JK
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_kernels as PK, cuda_perlane as PL
from tfdiffeq_tpu_torch.ops.norms import select_initial_step_per_sample

F64 = torch.float64
B = 16


def _weights(dims, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(a, b) * scale, rng.randn(b) * 0.05)
            for a, b in zip(dims[:-1], dims[1:])]


def _states(seed=0, D=2):
    """tests/test_per_sample.py:87: a spread of magnitudes, so a spread of
    local stiffness over the samples."""
    rng = np.random.RandomState(seed + 1)
    return rng.randn(B, D) * np.linspace(0.2, 2.0, B)[:, None]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# name: (dims, power, time_input, method, sign, rtol, atol, max_steps)
K5_CASES = {
    "spiral_spread": ((2, 16, 2), 3, False, "dopri5", 1.0, 1e-6, 1e-8, None),
    "spiral_reverse": ((2, 16, 2), 3, False, "dopri5", -1.0, 1e-6, 1e-8,
                       None),
    "tsit5_time_column": ((3, 12, 2), 1, True, "tsit5", 1.0, 1e-7, 1e-9,
                          None),
    "max_steps_stiff_lanes": ((2, 16, 2), 3, False, "dopri5", 1.0, 1e-8,
                              1e-10, 12),
}


@pytest.fixture(scope="module", params=sorted(K5_CASES))
def k5(request):
    dims, power, ti, method, sign, rtol, atol, max_steps = \
        K5_CASES[request.param]
    W = _weights(dims)
    y0 = _states()
    tau = np.linspace(0.0, 2.0, 7)
    dt0 = np.linspace(0.01, 0.08, B)
    kw = dict(activation="tanh", input_power=power, time_input=ti,
              method=method)
    if max_steps is not None:
        kw["max_steps"] = max_steps
    jw, jd = JK.pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                                 for a, b in W], jnp.float64)
    jo, js, jl = JK.mlp_solve(jw, jd, jnp.asarray(y0.T), jnp.asarray(tau),
                              jnp.asarray(dt0), rtol, atol, sign,
                              per_sample=True, interpret=True, **kw)
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], F64)
    po, ps, pl = PL.mlp_solve_perlane(pw, pd, torch.tensor(y0),
                                      torch.tensor(tau), torch.tensor(dt0),
                                      rtol, atol, sign, **kw)
    return {"name": request.param,
            "ref": (np.asarray(jo).transpose(0, 2, 1)[:, :B],
                    [int(x) for x in js], np.asarray(jl)[:, :B]),
            "got": (po, ps, pl)}


def test_plain_perlane_matches_reference(k5):
    ref_out, ref_st, ref_lane = k5["ref"]
    out, st, lane = k5["got"]
    np.testing.assert_array_equal(lane.numpy(), ref_lane)
    assert st.tolist() == ref_st
    assert _rel(out.numpy(), ref_out) < 1e-12
    # Per-sample stepping: the samples take different step counts, and the
    # scalar stats sum them.
    assert len(set(lane[0].tolist())) > 3
    assert st.tolist()[:3] == lane[:3].sum(dim=1).tolist()


def test_perlane_status_is_per_sample(k5):
    out, st, lane = k5["got"]
    if k5["name"] != "max_steps_stiff_lanes":
        assert st[3].item() == 0 and (lane[3] == 0).all()
        assert torch.isfinite(out).all()
        return
    failed = lane[3] == 1
    # The mild samples finish inside the budget; the stiff ones cannot,
    # and the rows they never reach stay zero.
    assert st[3].item() == 1 and 0 < int(failed.sum()) < B
    assert (lane[1] + lane[2])[failed].eq(12).all()
    assert not out[-1][failed].any() and out[-1][~failed].abs().min() > 0


def test_plain_perlane_invalid_times():
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in _weights((2, 16, 2))], F64)
    y0 = torch.tensor(_states())
    out, st, lane = PL.mlp_solve_perlane(
        pw, pd, y0, torch.tensor([0.0, 1.0, 0.5], dtype=F64), 0.05, 1e-6,
        1e-8, 1.0, input_power=3)
    assert st.tolist() == [0, 0, 0, 3] and (lane[3] == 3).all()
    assert torch.equal(out[0], y0) and not out[1:].any()
    with pytest.raises(ValueError, match="one a sample"):
        PL.mlp_solve_perlane(pw, pd, y0, torch.tensor([0.0, 1.0]),
                             torch.ones(3), 1e-6, 1e-8, 1.0)


# name: (first_step, reverse, method)
SPEC_CASES = {"hnw_per_sample": (None, False, "dopri5"),
              "first_step_reverse": (0.02, True, "bosh3")}


@pytest.fixture(scope="module", params=sorted(SPEC_CASES))
def spec_case(request):
    first, reverse, method = SPEC_CASES[request.param]
    W = _weights((2, 16, 2), seed=3)
    y0 = _states(seed=3)
    t = np.linspace(0.0, 2.0, 7)
    if reverse:
        t = t[::-1].copy()
    kw = dict(rtol=1e-6, atol=1e-8, method=method, first_step=first,
              per_sample=True)
    rj = JF.solve_mlp_spec(JF.MLPSpec(activation="tanh", input_power=3),
                           [(jnp.asarray(a), jnp.asarray(b)) for a, b in W],
                           jnp.asarray(y0), jnp.asarray(t), interpret=True,
                           **kw)
    rp = PF.solve_mlp_spec(PF.MLPSpec(activation="tanh", input_power=3),
                           [(torch.tensor(a), torch.tensor(b)) for a, b in W],
                           torch.tensor(y0), torch.tensor(t), **kw)
    return first, method, rj, rp


def test_solve_mlp_spec_per_sample_matches_reference(spec_case):
    first, method, rj, rp = spec_case
    assert list(rp.stats) == [int(x) for x in rj.stats]
    for got, ref in zip(rp.lane_stats, rj.lane_stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # The initial-step evaluations: 2 a sample (HNW), 1 with first_step,
    # on top of whole attempts.
    extra = 1 if first is not None else 2
    evals = PF.tableaus.TABLEAUS_BY_NAME[method].evals_per_step
    assert rp.stats.nfe == int(rp.lane_stats.nfe.sum())
    assert ((rp.lane_stats.nfe - extra) % evals == 0).all()
    assert rp.ys.shape == (7, B, 2)
    assert _rel(rp.ys.numpy(), np.asarray(rj.ys)) < 1e-12


def test_select_initial_step_per_sample_matches_reference():
    W = _weights((2, 16, 2), seed=5)
    y0 = _states(seed=5)
    jspec = JF.MLPSpec(activation="tanh", input_power=3)
    pspec = PF.MLPSpec(activation="tanh", input_power=3)
    jw = [(jnp.asarray(a), jnp.asarray(b)) for a, b in W]
    pw = [(torch.tensor(a), torch.tensor(b)) for a, b in W]
    for order in (4, 2):
        ref = JN.select_initial_step_per_sample(
            lambda s, y: JF.mlp_apply(jspec, jw, y, s), jnp.asarray(0.1),
            jnp.asarray(y0), JF.mlp_apply(jspec, jw, jnp.asarray(y0), 0.1),
            order, jnp.asarray(1e-6), jnp.asarray(1e-8))
        got = select_initial_step_per_sample(
            lambda s, y: PF.mlp_apply(pspec, pw, y, s),
            torch.tensor(0.1, dtype=F64), torch.tensor(y0),
            PF.mlp_apply(pspec, pw, torch.tensor(y0), 0.1), order,
            torch.tensor(1e-6, dtype=F64), torch.tensor(1e-8, dtype=F64))
        assert got.shape == (B,) and len(set(got.tolist())) > 1
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


@pytest.fixture(scope="module")
def generic_per_sample():
    y0 = np.abs(np.random.RandomState(7).randn(4, 2)) * np.array(
        [[0.5], [1.0], [2.0], [4.0]])
    t = np.linspace(0.0, 1.0, 5)
    opts = {"per_sample": True}
    rj = j_solve(lambda tt, yy: -yy * jnp.abs(yy), jnp.asarray(y0),
                 jnp.asarray(t), rtol=1e-8, atol=1e-10, options=opts)
    rp = P.solve(lambda tt, yy: -yy * torch.abs(yy), torch.tensor(y0),
                 torch.tensor(t), rtol=1e-8, atol=1e-10, options=opts)
    return rj, rp


def test_generic_per_sample_matches_reference(generic_per_sample):
    rj, rp = generic_per_sample
    assert list(rp.stats) == [int(x) for x in rj.stats]
    for got, ref in zip(rp.lane_stats, rj.lane_stats):
        assert got.tolist() == [int(x) for x in ref]
    assert len(set(rp.lane_stats.nfe.tolist())) > 1
    assert _rel(rp.ys.numpy(), np.asarray(rj.ys)) < 1e-12


def test_generic_per_sample_is_one_solve_a_sample(generic_per_sample):
    _, rp = generic_per_sample
    y0 = torch.tensor(np.abs(np.random.RandomState(7).randn(4, 2))
                      * np.array([[0.5], [1.0], [2.0], [4.0]]))
    t = torch.linspace(0.0, 1.0, 5, dtype=F64)
    for b in (0, 3):
        one = P.solve(lambda tt, yy: -yy * torch.abs(yy), y0[b:b + 1], t,
                      rtol=1e-8, atol=1e-10)
        assert torch.equal(one.ys[:, 0], rp.ys[:, b])
        assert list(one.stats) == [int(x[b]) for x in rp.lane_stats]


def _spec_args():
    W = [(torch.zeros(2, 4), torch.zeros(4)), (torch.zeros(4, 2), None)]
    return PF.MLPSpec(activation="tanh"), W, torch.ones(3, 2), \
        torch.tensor([0.0, 1.0])


@pytest.mark.parametrize("call, exc, match", [
    (lambda: PF.solve_mlp_spec(*_spec_args(), method="rk4",
                               per_sample=True),
     ValueError, "adaptive RK methods only"),
    (lambda: PF.odeint_adjoint_mlp(*_spec_args(), method="euler",
                                   per_sample=True),
     ValueError, "adaptive RK methods only"),
    (lambda: PF.odeint_adjoint_mlp(*_spec_args(), adjoint_method="rk4",
                                   per_sample=True),
     ValueError, "adaptive RK methods only"),
    (lambda: PF.solve_mlp_spec(*_spec_args(), method="adams",
                               per_sample=True),
     ValueError, "adaptive RK methods only"),
    (lambda: P.solve(lambda t, y: -y, torch.ones(2), [0.0, 1.0],
                     options={"per_sample": True}),
     ValueError, r"\[B, D\]"),
    (lambda: P.solve(lambda t, y: -y, torch.ones(2, 2), [0.0, 1.0],
                     method="rk4", options={"per_sample": True}),
     TypeError, "Unknown solver options"),
    (lambda: P.solve(lambda t, y: y - y.mean(0), torch.ones(3, 2),
                     [0.0, 1.0], options={"per_sample": True, "fuse": True}),
     ValueError, "batch-coupled"),
], ids=["spec_fixed", "adjoint_fixed_forward", "adjoint_fixed_backward",
        "spec_adams", "generic_not_2d", "generic_fixed", "generic_fuse"])
def test_per_sample_refusals(call, exc, match):
    with pytest.raises(exc, match=match):
        call()


def test_generic_per_sample_refuses_a_custom_non_adaptive_solver():
    def impl(prob, options, rtol, atol):
        raise AssertionError("never called")

    P.register_solver("custom_fixed_ps", "custom", impl,
                      allowed={"per_sample"})
    try:
        with pytest.raises(ValueError, match="adaptive methods only"):
            P.solve(lambda t, y: -y, torch.ones(2, 2), [0.0, 1.0],
                    method="custom_fixed_ps", options={"per_sample": True})
    finally:
        from tfdiffeq_tpu_torch.odeint import SOLVERS, _CUSTOM_ALLOWED
        SOLVERS.pop("custom_fixed_ps")
        _CUSTOM_ALLOWED.pop("custom_fixed_ps")
