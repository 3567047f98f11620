"""PyTorch port: the hypersolvers (`solvers/hyper.py`), K12's plain version
(`ops/cuda_plan.plan_solve_hyper` on CPU tensors), `fast.solve_hyper` and
the example against the JAX package.

- The generic `solve(..., method='hyper_*', options={'hypernet': g})`
  against the reference's on the same numpy inputs: the three kinds on the
  output grid, a `num_steps` grid, reverse time, and reverse time with
  `step_size`. Float64: within 1e-12 absolute (the same arithmetic in the
  same order; tanh and the products may round differently in the last
  bit) with identical stats.
- A missing hypernet raises ValueError naming it.
- The gradient of a loss through the generic walk wrt a linear hypernet's
  weight against `jax.grad` of the reference, float64, 1e-9 relative.
- `fast.solve_hyper` (K12's plain version: both plans by `eval_plan`)
  against the reference's `fast.solve_hyper(..., interpret=True)` (its K12
  in interpret mode) in float32: within the reference's own bar of 2e-6
  (tests/test_fixed_fused.py:560-563) with identical NFE; and
  `odeint(options={'fuse': True})` against the generic engine at the same
  bar, with no warning.
- K12's contract: status 3 with a zero tail for times that do not
  increase, a [D] state, one output time, the refusals.
- An unfusable hypernet (torch.sort) warns, adds 1 to
  `fast.fuse_fallbacks` and gives the generic answer bit for bit.
- The port's example: `hypernet(params)` against the reference's on the
  same numpy weights, and a short run with `--device cpu`.

B <= 8 and widths <= 16.
"""

import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tfdiffeq_tpu import fast as JF, odeint as j_odeint, solve as jsolve  # noqa: E402,E501
from tfdiffeq_tpu_torch import fast as PF, odeint, solve  # noqa: E402
from tfdiffeq_tpu_torch.ops import cuda_plan as CP, plan_bridge as PB  # noqa: E402
from tfdiffeq_tpu_torch.examples import hypersolver as PX  # noqa: E402

F32, F64 = torch.float32, torch.float64
KINDS = ["hyper_euler", "hyper_midpoint", "hyper_heun"]
CASES = {
    "grid_is_t": (np.linspace(0.0, 2.0, 9), {}),
    "num_steps": (np.linspace(0.0, 2.0, 5), {"num_steps": 32}),
    "reverse": (np.linspace(1.5, 0.0, 7), {}),
    "reverse_step_size": (np.linspace(1.5, 0.0, 4), {"step_size": 0.125}),
}


def _weights(seed=61):
    rng = np.random.RandomState(seed)
    return {"W1": rng.randn(2, 16) * 0.3, "b1": rng.randn(16) * 0.05,
            "W2": rng.randn(16, 2) * 0.3, "Hw": rng.randn(5, 12) * 0.2,
            "Hv": rng.randn(12, 2) * 0.2,
            "y0": rng.randn(8, 2) * 0.8}


def _pair(xp, dtype, w):
    """(f, g) in the framework `xp` (jnp or torch) over the numpy `w`."""
    if xp is jnp:
        a = {k: jnp.asarray(v, dtype) for k, v in w.items()}

        def g(t, y, f):
            tc = jnp.broadcast_to(jnp.reshape(t, (1, 1)), (y.shape[0], 1))
            return jnp.tanh(jnp.concatenate([y, f, tc], 1) @ a["Hw"]) \
                @ a["Hv"]
    else:
        a = {k: torch.tensor(v, dtype=dtype) for k, v in w.items()}

        def g(t, y, f):
            tc = t.reshape(1, 1).expand(y.shape[0], 1)
            return torch.tanh(torch.cat([y, f, tc], 1) @ a["Hw"]) @ a["Hv"]

    def f(t, y):
        return xp.tanh((y ** 3) @ a["W1"] + a["b1"]) @ a["W2"]

    return f, g


def _stats(st):
    return [int(x) for x in st]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", KINDS)
def test_generic_hypersolver_matches_reference(method, case):
    t, opts = CASES[case]
    w = _weights()
    jf, jg = _pair(jnp, jnp.float64, w)
    pf, pg = _pair(torch, F64, w)
    rj = jsolve(jf, jnp.asarray(w["y0"]), jnp.asarray(t), method=method,
                options={"hypernet": jg, **opts})
    rp = solve(pf, torch.tensor(w["y0"]), torch.tensor(t), method=method,
               options={"hypernet": pg, **opts})
    assert _stats(rp.stats) == _stats(rj.stats)
    np.testing.assert_allclose(rp.ys.numpy(), np.asarray(rj.ys), rtol=0,
                               atol=1e-12)


def test_hypernet_is_required():
    for opts in ({}, {"fuse": True}):
        with pytest.raises(ValueError, match="hypernet"):
            odeint(lambda t, y: -y, torch.ones(2, 1), [0.0, 1.0],
                   method="hyper_euler", options=opts)


def test_hypernet_gradient_matches_jax_grad():
    """d loss / d W of a linear hypernet W y through the generic walk
    (the reference's tests/test_dopri8_hyper.py:77 problem)."""
    A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
    t = np.linspace(0.0, 2.0, 11)
    y0 = np.array([2.0, 0.0])
    target = np.cos(t)[:, None] * np.array([2.0, 0.0])
    W0 = np.array([[0.1, -0.2], [0.3, 0.05]])

    def jloss(W):
        ys = j_odeint(lambda tt, yy: jnp.asarray(A) @ yy, jnp.asarray(y0),
                      jnp.asarray(t), method="hyper_midpoint",
                      options={"hypernet": lambda tt, yy, ff: W @ yy})
        return jnp.mean((ys - target) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(W0)))
    W = torch.tensor(W0, requires_grad=True)
    At = torch.tensor(A)
    ys = odeint(lambda tt, yy: At @ yy, torch.tensor(y0), torch.tensor(t),
                method="hyper_midpoint",
                options={"hypernet": lambda tt, yy, ff: W @ yy})
    torch.mean((ys - torch.tensor(target)) ** 2).backward()
    rel = np.abs(W.grad.numpy() - want).max() / np.abs(want).max()
    assert rel < 1e-9, rel


def test_reverse_time_sign():
    """A reverse-time solve keeps the correction's sign: with the exact
    residual the midpoint hypersolver beats midpoint (the reference's
    tests/test_pallas_fast.py:150)."""
    A = torch.tensor([[-0.1, 2.0], [-2.0, -0.1]], dtype=F64)
    t = torch.linspace(0.0, -2.0, 21, dtype=F64)
    exact = torch.stack([torch.linalg.matrix_exp(A * ti)
                         @ torch.tensor([2.0, 0.0], dtype=F64) for ti in t])
    f = lambda tt, yy: A @ yy                            # noqa: E731
    g3 = lambda tt, yy, ff: (A @ (A @ (A @ yy))) / 6.0   # noqa: E731
    y0 = torch.tensor([2.0, 0.0], dtype=F64)
    err_b = (odeint(f, y0, t, method="midpoint") - exact).abs().max()
    err_h = (odeint(f, y0, t, method="hyper_midpoint",
                    options={"hypernet": g3}) - exact).abs().max()
    assert err_h < err_b


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", KINDS)
def test_fused_hypersolver_matches_reference_and_generic(method, case):
    t, opts = CASES[case]
    w = _weights()
    jf, jg = _pair(jnp, jnp.float32, w)
    pf, pg = _pair(torch, F32, w)
    y0 = torch.tensor(w["y0"], dtype=F32)
    tt = torch.tensor(t, dtype=F32)
    rj = JF.solve_hyper(jf, jg, jnp.asarray(w["y0"], jnp.float32),
                        jnp.asarray(t, jnp.float32), method=method,
                        interpret=True, **opts)
    calls = []
    orig = CP.plan_solve_hyper

    def seen(*a, **k):
        calls.append(k["kind"])
        return orig(*a, **k)

    CP.plan_solve_hyper = seen
    try:
        rp = PF.solve_hyper(pf, pg, y0, tt, method=method, **opts)
        with warnings.catch_warnings():
            warnings.simplefilter("error")        # a fallback fails here
            rs = solve(pf, y0, tt, method=method,
                       options={"fuse": True, "hypernet": pg, **opts})
    finally:
        CP.plan_solve_hyper = orig
    assert calls == [method[6:]] * 2
    assert torch.equal(rp.ys, rs.ys)
    assert _stats(rp.stats) == _stats(rj.stats)
    np.testing.assert_allclose(rp.ys.numpy(), np.asarray(rj.ys), rtol=0,
                               atol=2e-6)
    rg = solve(pf, y0, tt, method=method, options={"hypernet": pg, **opts})
    assert _stats(rs.stats) == _stats(rg.stats)
    np.testing.assert_allclose(rs.ys.numpy(), rg.ys.numpy(), rtol=0,
                               atol=2e-6)


def _plans(dtype=F64):
    w = _weights()
    f, g = _pair(torch, dtype, w)
    y0 = torch.tensor(w["y0"], dtype=dtype)
    t0 = torch.tensor(0.0, dtype=dtype)
    pf, cf = PB.build_plan(f, t0, y0)
    pg, cg = PB.build_plan(lambda tt, ss: g(tt, ss[:, :2], ss[:, 2:]), t0,
                           torch.cat([y0, f(t0, y0)], 1), out_dim=2)
    return (pf, pg, PB.pack_consts(pf, cf, dtype),
            PB.pack_consts(pg, cg, dtype), y0)


def test_k12_contract():
    pf, pg, kf, kg, y0 = _plans()
    tau = torch.linspace(0.0, 1.0, 5, dtype=F64)
    bad = torch.tensor([0.0, 0.5, 0.4, 1.0], dtype=F64)
    out, st = CP.plan_solve_hyper(pf, pg, kf, kg, y0, bad, bad, 1.0,
                                  kind="heun", grid_is_t=True)
    assert st.tolist() == [0, 0, 0, 3]
    assert torch.equal(out[0], y0) and not out[1:].any()
    out, st = CP.plan_solve_hyper(pf, pg, kf, kg, y0, tau, tau, 1.0,
                                  kind="midpoint", grid_is_t=True)
    ref = CP.plan_solve_hyper_plain(pf, pg, kf, kg, y0, tau, tau, 1.0,
                                    kind="midpoint", grid_is_t=True)
    assert torch.equal(out, ref[0]) and st.tolist() == [8, 4, 0, 0]
    with pytest.raises(ValueError, match="kind"):
        CP.plan_solve_hyper(pf, pg, kf, kg, y0, tau, tau, 1.0, kind="rk4")
    with pytest.raises(ValueError, match="correction plan"):
        CP.plan_solve_hyper(pf, pf, kf, kf, y0, tau, tau, 1.0)
    # A [D] state (per-sample functions, vmapped), and one output time.
    w = _weights()
    f, g = _pair(torch, F64, w)
    Hw, Hv = torch.tensor(w["Hw"]), torch.tensor(w["Hv"])

    def g1(tt, yy, ff):
        return torch.tanh(torch.cat([yy, ff, tt.reshape(1)]) @ Hw) @ Hv

    one = PF.solve_hyper(f, g1, y0[0], tau, method="hyper_heun")
    many = PF.solve_hyper(f, g, y0, tau, method="hyper_heun")
    assert one.ys.shape == (5, 2)
    np.testing.assert_allclose(one.ys.numpy(), many.ys[:, 0].numpy(),
                               atol=1e-12)
    r1 = PF.solve_hyper(f, g, y0, tau[:1])
    assert torch.equal(r1.ys[0], y0) and list(r1.stats) == [0, 0, 0, 0]


def test_k12_refuses_coupled_plans():
    w = _weights()
    f, _ = _pair(torch, F64, w)
    y0 = torch.tensor(w["y0"])
    with pytest.raises(NotImplementedError, match="queue 2 item 3"):
        PF.solve_hyper(f, lambda t, y, fv: y - y.mean(0), y0,
                       torch.linspace(0.0, 1.0, 3, dtype=F64))


def test_unfusable_hypernet_falls_back():
    def f(t, y):
        return -y

    def g(t, y, fv):
        return torch.sort(y, dim=-1).values * 0.01

    y0 = torch.ones(4, 2)
    t = torch.linspace(0.0, 1.0, 5)
    before = PF.fuse_fallbacks
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        rf = solve(f, y0, t, method="hyper_euler",
                   options={"fuse": True, "hypernet": g})
    assert any("falling back" in str(x.message) for x in wl)
    assert PF.fuse_fallbacks == before + 1
    rg = solve(f, y0, t, method="hyper_euler", options={"hypernet": g})
    assert torch.equal(rf.ys, rg.ys)


def test_example_hypernet_matches_reference():
    """The example's `hypernet(params)` on the reference's keys and shapes
    with the same numpy weights, and its fused serving against the
    reference's fused hypersolver (interpret mode)."""
    pytest.importorskip("optax")
    from examples import hypersolver as JX

    rng = np.random.RandomState(4)
    p_np = {"w1": rng.randn(5, 8) * 0.3, "b1": rng.randn(8) * 0.1,
            "w2": rng.randn(8, 2) * 0.1, "b2": rng.randn(2) * 0.1}
    init = PX.init_hypernet(torch.Generator().manual_seed(0), 8)
    jinit = JX.init_hypernet(jax.random.PRNGKey(0), 8)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in jinit.items()}
    # B = 6: the capture refuses a batch equal to a feature width (8).
    y0 = PX.disk(np.random.RandomState(0), 6, 1.0)
    jy0 = JX._disk(np.random.RandomState(0), 6, 1.0)
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jy0))
    t = np.linspace(0.0, 2.0, 9)
    fv = np.random.RandomState(5).randn(6, 2)
    got = PX.hypernet({k: torch.tensor(v, dtype=F32)
                       for k, v in p_np.items()})(
        torch.tensor(0.5), y0, torch.tensor(fv, dtype=F32))
    want = JX.hypernet({k: jnp.asarray(v, jnp.float32)
                        for k, v in p_np.items()})(
        jnp.float32(0.5), jy0, jnp.asarray(fv, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    g = PX.hypernet({k: torch.tensor(v, dtype=F32)
                     for k, v in p_np.items()})
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # a fallback fails here
        rp = solve(PX.dynamics(), y0, torch.tensor(t, dtype=F32),
                   method="hyper_euler",
                   options={"hypernet": g, "fuse": True})
    rj = JF.solve_hyper(JX.f, JX.hypernet({k: jnp.asarray(v, jnp.float32)
                                           for k, v in p_np.items()}),
                        jy0, jnp.asarray(t, jnp.float32), interpret=True)
    assert _stats(rp.stats) == _stats(rj.stats)
    np.testing.assert_allclose(rp.ys.numpy(), np.asarray(rj.ys), atol=2e-6)


def test_example_runs_on_the_cpu():
    out = PX.main(["--device", "cpu", "--iters", "3", "--batch", "16",
                   "--num_steps", "8", "--hidden", "8"])
    assert out["fused_nfe"] == 8
    assert np.isfinite([out["base_err"], out["hyper_err"], out["fused_err"],
                        out["loss"]]).all()
    assert abs(out["fused_err"] - out["hyper_err"]) < 1e-5
