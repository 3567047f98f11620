"""PyTorch port: the fused fixed-grid tier against the JAX package.

- The plain K8 (`ops/cuda_fixed.mlp_solve_fixed` on CPU tensors) against
  the JAX `mlp_solve_fixed(..., interpret=True, pack=1)`, after
  tests/test_fixed_fused.py:42-133: every method, a finer Hermite grid,
  reverse time, a grid whose float sum stops short of tau[-1] (the last
  interval flushes the stranded time), invalid times (status 3). Float64:
  the same arithmetic in the same order, within 1e-12; float32 within 1e-5
  absolute, the bar of tests/test_fixed_fused.py.
- The plain K9 (`mlp_adjoint_solve_fixed`) against the JAX
  `mlp_adjoint_solve_fixed(..., interpret=True, pack=1)`, with and without
  the time column. Float64 within 1e-10 relative to each output's largest
  entry: the port sums each sample's quadrature over the steps before it
  sums over the batch, the reference the other way round.
- `fast.solve_mlp_spec` with fixed methods and `fast.odeint_adjoint_mlp`
  gradients (weights, y0, t) against the JAX front-ends, including the two
  mixed fixed/adaptive cases (tests/test_fixed_fused.py:186, :237, :312).
  Float64, within 1e-9 relative, with identical forward and backward
  counts.

Batches stay under 128 (one lane tile on the reference, no packing); each
reference kernel compiles once in interpret mode (a few seconds on the
CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.ops import pallas_fixed as JPF
from tfdiffeq_tpu.ops.pallas_kernels import pad_mlp_weights
from tfdiffeq_tpu.utils.nfe import NFEMeter as JMeter
from tfdiffeq_tpu_torch import NFEMeter, fast as PF
from tfdiffeq_tpu_torch.ops import cuda_fixed as PFX, cuda_kernels as PK

F64 = torch.float64


def _weights(dims, seed, no_bias_layer=None):
    rng = np.random.RandomState(seed)
    return [(rng.randn(a, b) * 0.4 / np.sqrt(a),
             None if l == no_bias_layer else rng.randn(b) * 0.05)
            for l, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]


def _packed(W, dtype):
    jdt = getattr(jnp, str(dtype).split(".")[-1])
    jw, jd = pad_mlp_weights([(jnp.asarray(a, jdt),
                               None if b is None else jnp.asarray(b, jdt))
                              for a, b in W], jdt)
    pw, pd = PK.pack_mlp_weights(
        [(torch.tensor(a), None if b is None else torch.tensor(b))
         for a, b in W], dtype)
    return jw, jd, pw, pd, jdt


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# name: (method, dims, activation, power, time_input, tau, grid, sign, dtype)
_T4 = np.array([0.0, 0.37, 1.11, 2.0])
K8_CASES = {
    "euler_default": ("euler", (2, 16, 2), "tanh", 1, False, _T4, None, 1.0,
                      F64),
    "midpoint_default": ("midpoint", (2, 16, 2), "tanh", 3, False, _T4, None,
                         1.0, F64),
    "rk4_38_default": ("rk4_38", (3, 12, 2), "elu", 1, True, _T4, None, 1.0,
                       F64),
    "rk4_hermite_time": ("rk4", (3, 16, 2), "tanh", 1, True, _T4,
                         np.linspace(0.0, 2.0, 33), 1.0, F64),
    # Reverse time: tau = -t increasing, sign -1.
    "rk4_reverse": ("rk4", (2, 16, 2), "softplus", 3, False,
                    -np.linspace(1.5, 0.0, 7), None, -1.0, F64),
    # A step grid of ten 0.1 steps: its float sum is 0.9999999999999999,
    # so tau[-1] = 1 lies past the grid's end and only the last
    # interval's flush writes it.
    "rk4_stranded_tail": ("rk4", (2, 16, 2), "tanh", 1, False,
                          np.array([0.0, 0.3, 0.7, 1.0]),
                          np.concatenate([[0.0], np.cumsum([0.1] * 10)]),
                          1.0, F64),
    "rk4_float32_hermite": ("rk4", (2, 16, 2), "tanh", 3, False, _T4,
                            np.linspace(0.0, 2.0, 17), 1.0, torch.float32),
    # Non-monotonic times: status 3, zero tail.
    "rk4_invalid_times": ("rk4", (2, 16, 2), "tanh", 1, False,
                          np.array([0.0, 1.0, 0.5, 2.0]), None, 1.0, F64),
}


@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_plain_fixed_solve_matches_reference(name):
    method, dims, act, power, ti, tau, grid, sign, dtype = K8_CASES[name]
    grid = tau if grid is None else grid
    W = _weights(dims, seed=3)
    jw, jd, pw, pd, jdt = _packed(W, dtype)
    y0 = np.random.RandomState(4).randn(9, dims[-1])
    kw = dict(activation=act, input_power=power, time_input=ti,
              method=method)
    jo, js = JPF.mlp_solve_fixed(jw, jd, jnp.asarray(y0.T, jdt),
                                 jnp.asarray(tau, jdt), jnp.asarray(grid, jdt),
                                 jnp.asarray(sign, jdt), interpret=True,
                                 pack=1, **kw)
    po, ps = PFX.mlp_solve_fixed(pw, pd, torch.tensor(y0, dtype=dtype),
                                 torch.tensor(tau, dtype=dtype),
                                 torch.tensor(grid, dtype=dtype), sign, **kw)
    assert ps.tolist() == [int(x) for x in js]
    ref = np.asarray(jo).transpose(0, 2, 1)
    tol = 1e-12 if dtype == F64 else 1e-5
    np.testing.assert_allclose(po.numpy(), ref, rtol=0, atol=tol)
    if name == "rk4_invalid_times":
        assert ps.tolist() == [0, 0, 0, 3] and not po[1:].any()
    else:
        G = len(grid)
        assert ps.tolist() == [1 + PFX.FIXED_TABLEAUS_BY_NAME[method].stages
                               * (G - 1), G - 1, 0, 0]
        assert torch.isfinite(po).all()


# name: (method, dims, activation, power, time_input, sign, num_steps,
#        no_bias_layer)
K9_CASES = {
    "rk4": ("rk4", (2, 16, 2), "tanh", 3, False, 1.0, 3, None),
    "rk4_time_reverse": ("rk4", (3, 12, 12, 2), "elu", 1, True, -1.0, 2,
                         1),
    "euler_time": ("euler", (3, 16, 2), "tanh", 1, True, 1.0, 4, None),
    "midpoint": ("midpoint", (2, 16, 2), "silu", 1, False, 1.0, 2, None),
}


@pytest.mark.parametrize("name", sorted(K9_CASES))
def test_plain_fixed_adjoint_matches_reference(name):
    method, dims, act, power, ti, sign, n, nb = K9_CASES[name]
    W = _weights(dims, seed=5, no_bias_layer=nb)
    jw, jd, pw, pd, jdt = _packed(W, F64)
    rng = np.random.RandomState(6)
    T, B, D = 5, 10, dims[-1]
    ys, g = rng.randn(T, B, D) * 0.7, rng.randn(T, B, D)
    tau = np.array([0.0, 0.4, 0.5, 1.2, 2.0])      # canonical, increasing
    kw = dict(num_steps=n, activation=act, input_power=power,
              time_input=ti, method=method)
    j_ay0, j_aw, j_at, j_st = JPF.mlp_adjoint_solve_fixed(
        jw, jd, jnp.asarray(ys.transpose(0, 2, 1)),
        jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau),
        jnp.asarray(sign), interpret=True, pack=1, **kw)
    p_ay0, p_aw, p_at, p_st = PFX.mlp_adjoint_solve_fixed(
        pw, pd, torch.tensor(ys), torch.tensor(g), torch.tensor(tau), sign,
        **kw)
    assert p_st.tolist() == [int(x) for x in j_st]
    assert p_st[0].item() == PFX.FIXED_TABLEAUS_BY_NAME[method].stages * n \
        * (T - 1)
    assert _rel(p_ay0.numpy(), np.asarray(j_ay0).T) < 1e-10
    # The reference's (dW [dout, din] padded, db [dout, 1] padded) per
    # layer, in pack_mlp_weights' layout.
    ref_aw = np.concatenate(
        [np.concatenate([np.asarray(dW)[:b, :a].reshape(-1),
                         np.asarray(db)[:b, 0]])
         for (dW, db), (a, b) in zip(j_aw, zip(dims[:-1], dims[1:]))])
    assert _rel(p_aw.numpy(), ref_aw) < 1e-10
    if ti:
        assert abs(float(p_at) - float(j_at)) <= 1e-10 * abs(float(j_at))
    else:
        assert float(p_at) == 0.0


@pytest.mark.parametrize("opts", [dict(num_steps=32), dict(step_size=0.07),
                                  dict()], ids=["num_steps", "step_size",
                                                "default"])
def test_solve_mlp_spec_fixed_matches_reference(opts):
    W = _weights((2, 16, 2), seed=17)
    y0 = np.random.RandomState(18).randn(8, 2)
    t = np.linspace(0.0, 2.0, 9)
    rj = JF.solve_mlp_spec(JF.MLPSpec(activation="tanh", input_power=3),
                           [(jnp.asarray(a), jnp.asarray(b)) for a, b in W],
                           jnp.asarray(y0), jnp.asarray(t), method="rk4",
                           interpret=True, **opts)
    rp = PF.solve_mlp_spec(PF.MLPSpec(activation="tanh", input_power=3),
                           [(torch.tensor(a), torch.tensor(b)) for a, b in W],
                           torch.tensor(y0), torch.tensor(t), method="rk4",
                           **opts)
    assert list(rp.stats) == [int(x) for x in rj.stats]
    assert rp.stats.nfe == 1 + 4 * {"num_steps": 32, "step_size": 29}.get(
        next(iter(opts), None), 8)
    np.testing.assert_allclose(rp.ys.numpy(), np.asarray(rj.ys), rtol=0,
                               atol=1e-12)


# name: (method, adjoint_method, extra options, time_input, reverse)
TRAIN_CASES = {
    "rk4_rk4": ("rk4", "rk4", dict(num_steps=16, adjoint_num_steps=8),
                False, False),
    # rk4 forward, dopri5 adjoint: K8 + K3.
    "rk4_dopri5": ("rk4", "dopri5", dict(num_steps=12), True, True),
    # dopri5 forward, rk4 adjoint taking the forward's num_steps: K2 + K9.
    "dopri5_rk4": ("dopri5", "rk4", dict(num_steps=4), False, False),
    # A forward step_size: the fixed backward takes 1 step an interval.
    "midpoint_step_size": ("midpoint", None, dict(step_size=0.05), True,
                           False),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_odeint_adjoint_mlp_fixed_matches_reference(name):
    method, adj, extra, ti, reverse = TRAIN_CASES[name]
    dims = (2 + int(ti), 16, 2)
    W = _weights(dims, seed=21)
    rng = np.random.RandomState(22)
    y0 = rng.randn(12, 2)
    t = np.linspace(0.0, 2.0, 7)
    if reverse:
        t = t[::-1].copy()
    g = rng.randn(7, 12, 2)
    opts = dict(rtol=1e-7, atol=1e-9, method=method, adjoint_method=adj,
                **extra)
    jmeter = JMeter()
    jspec = JF.MLPSpec(activation="tanh", time_input=ti)

    def jloss(w, y, tt):
        ys = JF.odeint_adjoint_mlp(jspec, w, y, tt, interpret=True,
                                   nfe_meter=jmeter, **opts)
        return jnp.sum(ys * jnp.asarray(g))

    jw = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in W)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jw, jnp.asarray(y0),
                                              jnp.asarray(t))
    jax.effects_barrier()

    pmeter = NFEMeter()
    pw = [(torch.tensor(a, requires_grad=True),
           torch.tensor(b, requires_grad=True)) for a, b in W]
    py0 = torch.tensor(y0, requires_grad=True)
    pt = torch.tensor(t, requires_grad=True)
    ys = PF.odeint_adjoint_mlp(PF.MLPSpec(activation="tanh", time_input=ti),
                               pw, py0, pt, nfe_meter=pmeter, **opts)
    torch.sum(ys * torch.tensor(g)).backward()
    got = [x.grad for pair in pw for x in pair] + [py0.grad, pt.grad]
    ref = jax.tree_util.tree_leaves(jg)
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b) < 1e-9
    assert (pmeter.f_nfe, pmeter.b_nfe, pmeter.b_steps) == \
        (jmeter.f_nfe, jmeter.b_nfe, jmeter.b_steps)


def test_fused_fixed_options_are_checked():
    spec = PF.MLPSpec(activation="tanh")
    w = [(torch.zeros(2, 4), torch.zeros(4)), (torch.zeros(4, 2), None)]
    y0, t = torch.ones(3, 2), torch.tensor([0.0, 1.0])
    with pytest.raises(ValueError, match="not both"):
        PF.solve_mlp_spec(spec, w, y0, t, method="rk4", num_steps=4,
                          step_size=0.1)
    with pytest.raises(ValueError, match="num_steps must be >= 1"):
        PF.solve_mlp_spec(spec, w, y0, t, method="euler", num_steps=0)
    with pytest.raises(ValueError, match="unknown method"):
        PF.odeint_adjoint_mlp(spec, w, y0, t, adjoint_method="rk5")
    # explicit_adams (ROADMAP item 12, once refused here) takes the same
    # grid options (tests/test_torch_adams_fused.py).
    with pytest.raises(ValueError, match="not both"):
        PF.solve_mlp_spec(spec, w, y0, t, method="explicit_adams",
                          num_steps=4, step_size=0.1)
    # One interval: one RK4 bootstrap step (f0 and 4 evaluations).
    res = PF.solve_mlp_spec(spec, w, y0, t, method="explicit_adams")
    assert list(res.stats) == [5, 1, 0, 0]
