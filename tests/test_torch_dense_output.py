"""PyTorch port: the generic engine's dense output and step telemetry
(`options={'dense_output': True, 'telemetry': True}`) against the JAX
package's bounded loop.

Both packages get the same numpy inputs, in float64, on a tanh field
(B = 4, D = 3) in both time directions, with a pinned first step (the two
HNW estimates differ in the last bits; dopri8 pins a long one, ROADMAP.md
queue 3 caveats) and the same `max_num_steps` (the reference's bounded
loop stops at its budget, the eager loop has none). The reference keeps a
row per attempt of its budget, rejected and inactive ones repeating the
last accepted step; the port keeps a row per accepted step. So rows are
compared at the reference's accepted attempts (its telemetry's
`accepted & active`), and both `eval_flat`s at probes that include t[0]
and t[-1]. The telemetry's prefix of active attempts must be equal.

Tolerances. The stats are equal and the arithmetic is the same, but the
embedded error estimate cancels: a last-bit difference in f (XLA's fused
tanh against torch's) moves the error ratio by about eps / rtol relative,
and the controller carries that into every later step size. Measured
over these cases: step times, sizes and coefficients up to 1.1e-8 apart
(tsit5), 2e-13 for bosh3; so rows and telemetry are held within 5e-8.
The interpolants themselves agree far closer, since a shifted step
boundary moves the polynomial only by its own error: `eval_flat` at the
probes within 1e-11 (measured up to 7.5e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfdiffeq_tpu as J
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch.ops.pytree import tree_leaves

ADAPTIVE = ["dopri5", "bosh3", "adaptive_heun", "tsit5", "dopri8"]
F64 = torch.float64
_RNG = np.random.RandomState(20)
_W = _RNG.randn(3, 3) * 0.8
_Y0 = _RNG.randn(4, 3)
_T = np.linspace(0.0, 2.0, 5)
STEPS = 256
ROWS, EVAL = 5e-8, 1e-11      # see the module docstring


def _tt(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _fj(t, y):
    return jnp.tanh(y @ jnp.asarray(_W)) * (1.0 + 0.1 * t) - 0.2 * y


def _fp(t, y):
    return torch.tanh(y @ _tt(_W)) * (1.0 + 0.1 * t) - 0.2 * y


def _pin(method):
    return {"first_step": 0.5 if method == "dopri8" else 0.05}


def _tols(method):
    return (1e-3, 1e-5) if method == "adaptive_heun" else (1e-6, 1e-8)


def _both(fj, fp, y0j, y0p, t, method, **opts):
    rtol, atol = _tols(method)
    ref = J.solve(fj, y0j, jnp.asarray(t), rtol=rtol, atol=atol,
                  method=method,
                  options={"dense_output": True, "telemetry": True,
                           "max_steps": STEPS, "max_num_steps": STEPS,
                           **opts})
    got = P.solve(fp, y0p, _tt(t), rtol=rtol, atol=atol, method=method,
                  options={"dense_output": True, "telemetry": True,
                           "max_num_steps": STEPS, **opts})
    return ref, got


def _probes(t):
    lo, hi = min(t[0], t[-1]), max(t[0], t[-1])
    return np.concatenate([[t[0], t[-1]], np.linspace(lo, hi, 23)])


def _check(ref, got, t):
    assert list(got.stats) == [int(s) for s in ref.stats]
    # The reference's bounded output evaluates the interpolant at x = 1 on
    # a step's end, the port's loop writes y1 there: roundoff apart.
    np.testing.assert_allclose(
        np.concatenate([x.numpy().ravel() for x in tree_leaves(got.ys)]),
        np.concatenate([np.asarray(x).ravel()
                        for x in jax.tree_util.tree_leaves(ref.ys)]),
        rtol=1e-10, atol=1e-12)
    tel_r, tel_p = ref.telemetry, got.telemetry
    A = tel_p.t0.shape[0]
    assert A == int(ref.stats.n_accepted) + int(ref.stats.n_rejected)
    act = np.asarray(tel_r.active)
    assert act[:A].all() and not act[A:].any()
    assert tel_p.active.all()
    np.testing.assert_array_equal(tel_p.accepted.numpy(),
                                  np.asarray(tel_r.accepted)[:A])
    np.testing.assert_allclose(tel_p.t0.numpy(), np.asarray(tel_r.t0)[:A],
                               rtol=0, atol=ROWS)
    np.testing.assert_allclose(tel_p.dt.numpy(), np.asarray(tel_r.dt)[:A],
                               rtol=0, atol=ROWS)
    # Rows at the reference's accepted attempts.
    d_r, d_p = ref.dense, got.dense
    acc = np.asarray(tel_r.accepted) & act
    assert d_p.t0s.shape[0] == int(acc.sum()) == int(got.stats.n_accepted)
    for a, b in ((d_p.t0s, d_r.t0s), (d_p.t1s, d_r.t1s),
                 (d_p.dts, d_r.dts)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[acc],
                                   rtol=0, atol=ROWS)
    np.testing.assert_allclose(d_p.coeffs.numpy(),
                               np.asarray(d_r.coeffs)[acc],
                               rtol=0, atol=ROWS)
    assert float(d_p.sign) == float(d_r.sign) == (1.0 if t[-1] > t[0]
                                                  else -1.0)
    q = _probes(t)
    np.testing.assert_allclose(d_p.eval_flat(_tt(q)).numpy(),
                               np.asarray(d_r.eval_flat(jnp.asarray(q))),
                               rtol=0, atol=EVAL)
    # A 0-d time gives the flat state.
    np.testing.assert_allclose(d_p.eval_flat(_tt(q[3])).numpy(),
                               np.asarray(d_r.eval_flat(jnp.asarray(q[3]))),
                               rtol=0, atol=EVAL)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("method", ADAPTIVE)
def test_dense_output_and_telemetry_match_reference(method, reverse):
    t = _T[::-1].copy() if reverse else _T
    ref, got = _both(_fj, _fp, jnp.asarray(_Y0), _tt(_Y0), t, method,
                     **_pin(method))
    assert int(ref.stats.status) == 0
    _check(ref, got, t)


def test_tuple_state_dense_output_matches_reference():
    """A tuple state: the coefficients flatten once to [S, 5, N] in the
    state's ravel order (reference adaptive.py:405-410)."""
    a0, b0 = _Y0[0], _Y0[1:3]

    def fj(t, y):
        a, b = y
        return (jnp.tanh(b[0] * a) - 0.1 * a, jnp.sin(a[:3]) * b - 0.3 * b)

    def fp(t, y):
        a, b = y
        return (torch.tanh(b[0] * a) - 0.1 * a, torch.sin(a[:3]) * b
                - 0.3 * b)

    ref, got = _both(fj, fp, (jnp.asarray(a0), jnp.asarray(b0)),
                     (_tt(a0), _tt(b0)), _T, "dopri5", **_pin("dopri5"))
    assert got.dense.coeffs.shape[1:] == (5, 9)
    _check(ref, got, _T)


def test_unit_span_edge_cases():
    """One output time: no attempt, the reference's initial cache as the
    one row (eval gives y0); no step accepted before a failure: the same
    row."""
    y0 = _tt(_Y0)
    res = P.solve(_fp, y0, [0.5], options={"dense_output": True,
                                            "telemetry": True})
    assert res.telemetry.t0.shape == (0,)
    torch.testing.assert_close(res.dense.eval_flat(0.5), y0.reshape(-1),
                               rtol=0, atol=0)
    bad = P.solve(lambda t, y: y * float("nan"), y0, _tt(_T),
                  options={"dense_output": True, "telemetry": True,
                           "first_step": 0.1})
    assert bad.stats.status == 2 and bad.stats.n_accepted == 0
    assert not bad.telemetry.accepted.any()
    torch.testing.assert_close(bad.dense.eval_flat(1.0), y0.reshape(-1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("key", ["dense_output", "telemetry"])
def test_while_loop_refuses_dense_output_and_telemetry(key):
    """The reference's refusals (odeint.py:360-363, :374-378), also on the
    per-sample route, whose vmap runs the while loop by default."""
    with pytest.raises(ValueError, match=key):
        P.solve(_fp, _tt(_Y0), _tt(_T), options={key: True,
                                                 "loop": "while"})
    with pytest.raises(ValueError, match=key):
        P.solve(_fp, _tt(_Y0), _tt(_T), options={key: True,
                                                 "per_sample": True})


def test_dense_output_option():
    """The reference's test_dense_output_option (tests/test_gradients.py
    :316): eval at arbitrary times matches the exact solution."""
    A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
    y0 = np.array([2.0, 0.0])

    def expm_at(tt):
        e = np.exp(-0.1 * tt)
        c, s = np.cos(2.0 * tt), np.sin(2.0 * tt)
        return e * np.array([[c, s], [-s, c]])

    res = P.solve(lambda t, y: y @ _tt(A).T, _tt(y0),
                  _tt(np.linspace(0.0, 1.5, 7)), rtol=1e-9, atol=1e-11,
                  options={"dense_output": True})
    assert res.dense is not None
    for tq in (0.33, 0.77, 1.31):
        np.testing.assert_allclose(res.dense.eval_flat(_tt(tq)).numpy(),
                                   expm_at(tq) @ y0, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="dense_output"):
        P.solve(lambda t, y: y @ _tt(A).T, _tt(y0), _tt([0.0, 1.0]),
                options={"dense_output": True, "loop": "while"})


def test_step_telemetry():
    """The reference's test_step_telemetry (tests/test_api.py:112): counts
    agree with the stats, every attempt's dt is positive."""
    res = P.solve(lambda t, y: -y, torch.ones(3, dtype=F64),
                  _tt(np.linspace(0.0, 2.0, 5)), options={"telemetry": True})
    tel = res.telemetry
    assert tel is not None
    assert int(tel.accepted.sum()) == res.stats.n_accepted
    assert int(tel.active.sum()) == (res.stats.n_accepted
                                     + res.stats.n_rejected)
    assert (tel.dt[tel.active] > 0).all()
    with pytest.raises(ValueError, match="telemetry"):
        P.solve(lambda t, y: -y, torch.ones(3, dtype=F64),
                _tt(np.linspace(0.0, 2.0, 5)),
                options={"telemetry": True, "loop": "while"})


def test_fuse_with_dense_output_runs_the_generic_engine():
    """dense_output beside fuse is outside the fused allowlist, as in the
    reference's `_FUSABLE_OPTIONS`: the generic engine answers, with the
    port's warning and one count in `fast.fuse_fallbacks`."""
    from tfdiffeq_tpu_torch import fast as PF
    before = PF.fuse_fallbacks
    with pytest.warns(UserWarning, match="falling back"):
        res = P.solve(_fp, _tt(_Y0), _tt(_T),
                      options={"fuse": True, "dense_output": True,
                               "telemetry": True})
    assert PF.fuse_fallbacks == before + 1
    gen = P.solve(_fp, _tt(_Y0), _tt(_T), options={"dense_output": True,
                                                  "telemetry": True})
    assert torch.equal(res.ys, gen.ys)
    assert torch.equal(res.dense.coeffs, gen.dense.coeffs)
    assert torch.equal(res.telemetry.dt, gen.telemetry.dt)
