"""PyTorch port: the fused tier (`tfdiffeq_tpu_torch.fast`) against the JAX
package's `fast` (Pallas in interpret mode), and the slice as a whole.

On the CPU the port's whole-solve wrapper runs its plain PyTorch version.
Float64 comparisons demand identical nfe / accepted / rejected / status and
trajectories within rtol 1e-10 (the same arithmetic; only reduction orders
and the last bit of tanh differ). Float32 comparisons hold the port to
the reference's own float32 budget (tests/test_pallas_fast.py: rtol 1e-3,
atol 2e-4), since a summation-order difference can shift a borderline
accept. Batches stay under 256, where the reference does not pack
sublanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF, solve as j_solve
from tfdiffeq_tpu.models.dynamics import (make_ode_func as j_make_ode_func,
                                          spiral_dynamics as j_spiral)
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import convert, fast as PF
from tfdiffeq_tpu_torch.models.dynamics import (ODEFunc, make_ode_func,
                                                spiral_dynamics)
from tfdiffeq_tpu_torch.ops import cuda_kernels as PK

F64 = torch.float64
ADAPTIVE = ["dopri5", "bosh3", "adaptive_heun", "tsit5", "dopri8"]


def _setup(B=96, H=50, D=2, seed=0):
    """tests/test_pallas_fast.py's recipe, as numpy."""
    rng = np.random.RandomState(seed)
    params = {"w1": rng.randn(D, H) * 0.1, "b1": rng.randn(H) * 0.05,
              "w2": rng.randn(H, D) * 0.1, "b2": rng.randn(D) * 0.05}
    return params, rng.randn(B, D) * 1.5


def _jax(params, dtype):
    return {k: jnp.asarray(v, dtype) for k, v in params.items()}


def _times(reverse, T=12, span=5.0):
    t = np.linspace(0.0, span, T)
    return t[::-1].copy() if reverse else t


def _first_steps(method):
    # dopri8's HNW first step is so short that its first error estimate is
    # rounding noise, which shifts the next step size between the two
    # implementations (tests/test_torch_engine.py); start it above that.
    return [0.3, 0.5] if method == "dopri8" else [None, 0.01]


def _tols(method):
    return (1e-4, 1e-6) if method == "adaptive_heun" else (1e-6, 1e-8)


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("method", ADAPTIVE)
def test_solve_mlp_matches_reference_f64(method, reverse, first):
    params, y0 = _setup()
    t = _times(reverse)
    fs = _first_steps(method)[first]
    rtol, atol = _tols(method)
    ref = JF.solve_mlp(_jax(params, jnp.float64), jnp.asarray(y0),
                       jnp.asarray(t), rtol=rtol, atol=atol, method=method,
                       interpret=True, first_step=fs)
    got = PF.solve_mlp(convert.params_from_jax(params, dtype=F64),
                       torch.tensor(y0), torch.tensor(t), rtol=rtol,
                       atol=atol, method=method, first_step=fs)
    assert list(got.stats) == [int(s) for s in ref.stats]
    assert got.stats.status == 0
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys),
                               rtol=1e-10, atol=1e-12)


def test_solve_mlp_reference_stats_at_b96():
    """The documented operating point: B=96, T=12, span 5, seed-0 weights,
    dopri5 at rtol 1e-6 / atol 1e-8 with the HNW first step."""
    params, y0 = _setup()
    got = PF.solve_mlp(convert.params_from_jax(params, dtype=F64),
                       torch.tensor(y0), torch.tensor(_times(False)))
    assert list(got.stats) == [122, 15, 5, 0]
    assert PK.mlp_solve_launches == 0          # the plain version ran


@pytest.mark.parametrize("reverse", [False, True])
def test_solve_mlp_matches_reference_f32(reverse):
    params, y0 = _setup()
    t = _times(reverse)
    ref = JF.solve_mlp(_jax(params, jnp.float32), jnp.asarray(y0, jnp.float32),
                       jnp.asarray(t, jnp.float32), interpret=True)
    got = PF.solve_mlp(convert.params_from_jax(params),
                       torch.tensor(y0, dtype=torch.float32),
                       torch.tensor(t, dtype=torch.float32))
    assert int(ref.stats.status) == got.stats.status == 0
    assert got.ys.dtype == torch.float32
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys), rtol=1e-3,
                               atol=2e-4)


def test_max_steps_status_and_zero_filled_tail():
    params, y0 = _setup(B=32)
    t = np.linspace(0.0, 50.0, 6)
    ref = JF.solve_mlp(_jax(params, jnp.float64), jnp.asarray(y0),
                       jnp.asarray(t), rtol=1e-7, atol=1e-9, interpret=True,
                       max_num_steps=3, first_step=0.01)
    got = PF.solve_mlp(convert.params_from_jax(params, dtype=F64),
                       torch.tensor(y0), torch.tensor(t), rtol=1e-7,
                       atol=1e-9, max_num_steps=3, first_step=0.01)
    assert list(got.stats) == [int(s) for s in ref.stats]
    assert got.stats.status == 1
    np.testing.assert_array_equal(got.ys[-1].numpy(), 0.0)
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys),
                               rtol=1e-10, atol=1e-12)


def test_solve_mlp_spec_general_mlp_matches_reference():
    """A 3-layer ELU MLP with a time column (the latent-ODE family),
    reverse time, through solve_mlp_spec."""
    rng = np.random.RandomState(11)
    dims = [(3, 20), (20, 20), (20, 2)]
    weights = [(rng.randn(i, o) * 0.3, rng.randn(o) * 0.1) for i, o in dims]
    y0 = rng.randn(48, 2)
    t = _times(True, T=8, span=3.0)
    jspec = JF.MLPSpec(activation="elu", time_input=True, matmul="vpu")
    ref = JF.solve_mlp_spec(jspec, [(jnp.asarray(W), jnp.asarray(b))
                                    for W, b in weights],
                            jnp.asarray(y0), jnp.asarray(t), interpret=True)
    got = PF.solve_mlp_spec(PF.MLPSpec(activation="elu", time_input=True),
                            convert.weights_from_jax(weights, dtype=F64),
                            torch.tensor(y0), torch.tensor(t))
    assert list(got.stats) == [int(s) for s in ref.stats]
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys),
                               rtol=1e-10, atol=1e-10)


def test_stepwise_matches_reference_and_whole_solve():
    params, y0 = _setup(B=64)
    t = np.linspace(0.0, 5.0, 12)
    ref = JF.solve_mlp_stepwise(_jax(params, jnp.float64), jnp.asarray(y0),
                                jnp.asarray(t), interpret=True)
    p = convert.params_from_jax(params, dtype=F64)
    got = PF.solve_mlp_stepwise(p, torch.tensor(y0), torch.tensor(t))
    assert list(got.stats) == [int(s) for s in ref.stats]
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys),
                               rtol=1e-10, atol=1e-12)
    assert PK.dopri5_mlp_step_launches == 0
    # The whole-solve kernel runs the same dopri5 with its own stage
    # arithmetic: the same solution to well inside the tolerance.
    whole = PF.solve_mlp(p, torch.tensor(y0), torch.tensor(t))
    np.testing.assert_allclose(got.ys.numpy(), whole.ys.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_bench_slice_through_convert():
    """The bench recipe (bench.py:32-39, :268-270) at B=64: the same numpy
    weights and y0 through both packages, dopri5, first_step 0.01."""
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(2, 50) * 0.1, "b1": np.zeros(50),
              "w2": rng.randn(50, 2) * 0.1, "b2": np.zeros(2)}
    y0 = np.random.RandomState(1).randn(64, 2) * 1.5
    t = np.linspace(0.0, 5.0, 12)
    for jdt, tdt, tol in ((jnp.float64, F64, dict(rtol=1e-10, atol=1e-12)),
                          (jnp.float32, torch.float32,
                           dict(rtol=1e-3, atol=2e-4))):
        ref = JF.solve_mlp(_jax(params, jdt), jnp.asarray(y0, jdt),
                           jnp.asarray(t, jdt), rtol=1e-6, atol=1e-6,
                           interpret=True, first_step=0.01)
        got = PF.solve_mlp(convert.params_from_jax(params, dtype=tdt),
                           torch.tensor(y0, dtype=tdt),
                           torch.tensor(t, dtype=tdt), rtol=1e-6, atol=1e-6,
                           first_step=0.01)
        assert got.stats.status == int(ref.stats.status) == 0
        if tdt == F64:
            assert list(got.stats) == [int(s) for s in ref.stats]
        np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys), **tol)


def test_ode_func_from_flax_generic_solve_matches_reference():
    func_j, variables = j_make_ode_func(seed=3)
    np_vars = {"params": {k: {n: np.asarray(a) for n, a in v.items()}
                          for k, v in variables["params"].items()}}
    func_p = convert.ode_func_from_flax(np_vars, dtype=F64)
    y0 = np.random.RandomState(4).randn(16, 2)
    t = np.linspace(0.0, 3.0, 7)
    ref = j_solve(lambda tt, yy: func_j(tt, yy, variables), jnp.asarray(y0),
                  jnp.asarray(t), rtol=1e-7, atol=1e-9,
                  options={"loop": "while"})
    with torch.no_grad():
        got = P.solve(func_p, torch.tensor(y0), torch.tensor(t), rtol=1e-7,
                      atol=1e-9)
    assert list(got.stats) == [int(s) for s in ref.stats]
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(ref.ys),
                               rtol=1e-10, atol=1e-12)
    # The same weights through the fused tier.
    fused = PF.solve_mlp_spec(PF.MLPSpec(input_power=3),
                              PF.weights_from_linears(func_p),
                              torch.tensor(y0), torch.tensor(t), rtol=1e-7,
                              atol=1e-9)
    np.testing.assert_allclose(fused.ys.numpy(), got.ys.numpy(), rtol=1e-6,
                               atol=1e-8)


def test_spiral_dynamics_and_odeint_mlp():
    y = np.random.RandomState(12).randn(5, 2)
    np.testing.assert_allclose(
        spiral_dynamics(0.0, torch.tensor(y)).numpy(),
        np.asarray(j_spiral(0.0, jnp.asarray(y))), rtol=1e-14)
    params, y0 = _setup(B=16)
    p = convert.params_from_jax(params, dtype=F64)
    t = torch.linspace(0.0, 1.0, 4, dtype=F64)
    assert torch.equal(PF.odeint_mlp(p, torch.tensor(y0), t),
                       PF.solve_mlp(p, torch.tensor(y0), t).ys)


def test_ode_func_module_and_seeded_generator():
    a, b = make_ode_func(seed=5), make_ode_func(seed=5)
    assert torch.equal(a.dense_0.weight, b.dense_0.weight)
    assert not a.dense_0.bias.any()
    assert isinstance(a, ODEFunc) and a(0.0, torch.ones(3, 2)).shape == (3, 2)


@pytest.mark.parametrize("kwargs,item", [
    (dict(method="fixed_adams"), "item 12"),
])
def test_unported_fused_options_name_their_roadmap_item(kwargs, item):
    """The fused fixed_adams (ROADMAP item 12, once refused here) solves
    (tests/test_torch_adams_fused.py holds it to the reference), and so do
    the per-sample tiers (item 20, once refused here: K5's tile engine,
    near the per-sample 'highest' solve; tests/test_torch_perlane_tiers.py
    holds them to the reference); the multi-card coupling (item 18) still
    raises."""
    params, y0 = _setup(B=8)
    spec = PF.MLPSpec(input_power=3)
    w = [(torch.tensor(params["w1"]), torch.tensor(params["b1"])),
         (torch.tensor(params["w2"]), torch.tensor(params["b2"]))]
    res = PF.solve_mlp_spec(spec, w, torch.tensor(y0), [0.0, 1.0], **kwargs)
    assert res.stats.status == 0 and torch.isfinite(res.ys).all()
    tiered, hi = (PF.solve_mlp_spec(
        PF.MLPSpec(input_power=3, matmul="mxu", dot_precision=p), w,
        torch.tensor(y0), [0.0, 1.0], per_sample=True)
        for p in ("mixed", "highest"))
    assert int(tiered.lane_stats.status.max()) == 0
    assert 0 < float((tiered.ys - hi.ys).abs().max()) < 1e-2
    with pytest.raises(NotImplementedError, match="item 18"):
        PF.solve_mlp_stepwise(convert.params_from_jax(params, dtype=F64),
                              torch.tensor(y0), [0.0, 1.0], axis_name="b")


def test_fused_input_validation():
    params, y0 = _setup(B=8)
    p = convert.params_from_jax(params, dtype=F64)
    with pytest.raises(ValueError, match="batch, dim"):
        PF.solve_mlp(p, torch.tensor(y0[0]), [0.0, 1.0])
    with pytest.raises(ValueError, match="monotonic"):
        PF.solve_mlp(p, torch.tensor(y0), [0.0, 1.0, 0.5])
    with pytest.raises(ValueError, match="increasing"):
        PF.solve_mlp_stepwise(p, torch.tensor(y0), [1.0, 0.0])
    one = PF.solve_mlp(p, torch.tensor(y0), [0.5])
    assert one.ys.shape == (1, 8, 2) and list(one.stats) == [0, 0, 0, 0]


def test_fused_rk4_is_ported():
    """solve_mlp_spec(method='rk4') (once refused, ROADMAP item 11) runs
    the fixed-grid kernel's plain version on the CPU and matches the
    generic rk4 on the same grid (tests/test_torch_fixed_fused.py holds it
    to the reference)."""
    params, y0 = _setup(B=8)
    spec = PF.MLPSpec(input_power=3)
    w = [(torch.tensor(params["w1"]), torch.tensor(params["b1"])),
         (torch.tensor(params["w2"]), torch.tensor(params["b2"]))]
    t = torch.linspace(0.0, 1.0, 5, dtype=F64)
    res = PF.solve_mlp_spec(spec, w, torch.tensor(y0), t, method="rk4")
    ref = P.solve(lambda tt, y: PF.mlp_apply(spec, w, y), torch.tensor(y0),
                  t, method="rk4")
    assert list(res.stats) == list(ref.stats) == [17, 4, 0, 0]
    torch.testing.assert_close(res.ys, ref.ys, rtol=1e-12, atol=1e-12)
