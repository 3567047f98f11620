"""PyTorch port: training arbitrary plain-PyTorch dynamics through
`fast.odeint_adjoint_fused` and `odeint_adjoint(options={'fuse': True})`
(the plan's forward with K14 and its backward sweep with K15) against the
JAX package's `odeint_adjoint_fused`, which runs its Pallas kernels in
interpret mode here.

Each dynamics is written in both frameworks over the same numpy arrays
(the reference's training families, tests/test_plan_adjoint.py:64-80);
B <= 12 and at most 7 output times, float32. On the CPU the port's plan
kernels run their plain versions (`ops/cuda_plan.py`), so these hold the
whole training front end (capture, differentiable packing, the forward,
t_bars, the sweep, ts_bar, the stats, the fallbacks) to the reference:

- the gradients of sum(ys * g) wrt the parameters, y0 and t within 1e-4
  relative to each gradient's largest entry (the reference's own bar for
  its fused path, tests/test_plan_adjoint.py:38-44), on the six families;
  `odeint_adjoint(options={'fuse': True})` gives the same gradients with
  no fallback, and the port's generic `odeint_adjoint` agrees within 2e-4
  (the reference's bar for fused against generic);
- the reference's further cases (tests/test_plan_adjoint.py:91-248,
  tests/test_meanfield.py:73, :161, tests/test_tree_fuse.py:192): reverse
  time without parameters, an unbatched y0, the seminorm, return_stats
  with the meter, NaN gradients on a failed sweep, a rejected reverse
  walk falling to the fused forward with the generic backward with one
  counted fallback, mean-field and batch-max training, a dict state, rk4
  (K8 + K9) and per_sample (K5 + K6; compared on gradients only, since
  the reference's backward takes its shared controller, ROADMAP.md queue
  3);
- a 0-d learnable parameter receives its gradient, and two values of it
  give one generated source (no new library);
- K15 in K3's plain sweep in the order of a grid of 1, 3 or 7 blocks
  against the reference's `plan_adjoint_solve`, float64 (identical stats,
  1e-9 relative), and a coupled plan's sweep on one block.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import odeint_adjoint as j_odeint_adjoint
from tfdiffeq_tpu.fast import odeint_adjoint_fused as j_fused
from tfdiffeq_tpu.ops import plan_adjoint as JPA
from tfdiffeq_tpu_torch import fast as PF, odeint_adjoint
from tfdiffeq_tpu_torch.ops import cuda_plan as CP
from tfdiffeq_tpu_torch.ops import plan_bridge as PB
from tfdiffeq_tpu_torch.utils.nfe import NFEMeter

A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
_rng = np.random.RandomState(7)
W1 = _rng.randn(2, 16) * 0.3
B1 = _rng.randn(16) * 0.1
W2 = _rng.randn(16, 2) * 0.3
Y0 = np.random.RandomState(0).randn(8, 2) * 1.2
T5 = np.linspace(0.0, 2.0, 5)
G5 = np.random.RandomState(2).randn(5, 8, 2)
F32 = torch.float32


def _families(xp):
    """{name: (func(t, y, p), params as a tuple of numpy arrays)}."""
    tor = xp is torch

    def gelu(x):
        return (torch.nn.functional.gelu(x) if tor
                else jax.nn.gelu(x, approximate=False))

    def tr(w):
        return w.t() if tor else w.T

    return {
        "spiral": (lambda t, y, p: (y ** 3) @ p[0], (A,)),
        "mlp_bias": (lambda t, y, p: xp.tanh(y @ p[0] + p[1]) @ p[2],
                     (W1, B1, W2)),
        "timedep": (lambda t, y, p: xp.sin(t) * y - p[0] * y ** 3 + 0.1,
                    (np.array(0.3),)),
        "tied": (lambda t, y, p: xp.tanh(y @ p[0]) @ tr(p[0]) * 0.5, (W1,)),
        "computed_bias": (lambda t, y, p: xp.tanh(y @ p[0] + 2.0 * p[1])
                          @ p[2] - 0.1 * y, (W1, B1, W2)),
        "gelu_exact": (lambda t, y, p: gelu(y @ p[0] + p[1]) @ p[2],
                       (W1, B1, W2)),
    }


def _tt(a, grad=True):
    return torch.tensor(np.asarray(a), dtype=F32, requires_grad=grad)


def _jj(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def _port(f, params, y0=Y0, t=T5, g=G5, route="fused", options=None,
          **kw):
    """d sum(ys * g) / d (params..., y0, t) through the port."""
    p = tuple(_tt(a) for a in params)
    y, tt = _tt(y0), _tt(t)
    if route == "fused":
        ys = PF.odeint_adjoint_fused(f, y, tt, params=p, rtol=1e-6,
                                     atol=1e-8, **kw)
    else:
        opts = dict(options or {})
        if route == "fuse":
            opts["fuse"] = True
        ys = odeint_adjoint(f, y, tt, params=p, rtol=1e-6, atol=1e-8,
                            options=opts or None, **kw)
    loss = torch.sum(ys * torch.tensor(np.asarray(g), dtype=F32))
    return [x.detach().numpy()
            for x in torch.autograd.grad(loss, list(p) + [y, tt])]


def _ref(f, params, y0=Y0, t=T5, g=G5, **kw):
    def loss(p, y, tt):
        ys = j_fused(f, y, tt, params=p, rtol=1e-6, atol=1e-8,
                     interpret=True, **kw)
        return jnp.sum(ys * _jj(g))

    gp, gy, gt = jax.grad(loss, argnums=(0, 1, 2))(
        tuple(_jj(a) for a in params), _jj(y0), _jj(t))
    return [np.asarray(x) for x in list(gp) + [gy, gt]]


def _close(got, want, rel, label=""):
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (label, i, a.shape, b.shape)
        d = float(np.max(np.abs(a - b)))
        m = float(np.max(np.abs(b))) + 1e-12
        assert d / m < rel, (label, i, d, m)


def _quietly(fn, *a, **kw):
    """A call that must not fall back (no warning, no counted fallback)."""
    before = PF.fuse_fallbacks
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = fn(*a, **kw)
    assert PF.fuse_fallbacks == before
    return out


@pytest.fixture(scope="module")
def ref_grads():
    """The reference's fused gradients, computed once a family."""
    cache = {}

    def get(name):
        if name not in cache:
            f, p = _families(jnp)[name]
            cache[name] = _ref(f, p)
        return cache[name]
    return get


@pytest.mark.parametrize("name", sorted(_families(jnp)))
def test_gradients_match_reference_and_generic(name, ref_grads):
    f, p = _families(torch)[name]
    got = _quietly(_port, f, p)
    _close(got, ref_grads(name), 1e-4, name)
    via_option = _quietly(_port, f, p, route="fuse")
    for a, b in zip(via_option, got):
        np.testing.assert_array_equal(a, b)
    _close(got, _port(f, p, route="generic"), 2e-4, name)


def test_reverse_time_without_params():
    tr = np.linspace(2.0, 0.0, 5)
    # Small amplitude: the cubic spiral grows backward in time.
    y_small = Y0 * 0.4
    At, Aj = torch.tensor(A, dtype=F32), _jj(A)
    y, tt = _tt(y_small), _tt(tr)
    ys = _quietly(PF.odeint_adjoint_fused, lambda t_, y_: (y_ ** 3) @ At, y,
                  tt, rtol=1e-6, atol=1e-8)
    got = [x.numpy() for x in torch.autograd.grad(
        torch.sum(ys * torch.tensor(G5, dtype=F32)), [y, tt])]
    want = jax.grad(lambda y_, t_: jnp.sum(j_fused(
        lambda a, b: (b ** 3) @ Aj, y_, t_, rtol=1e-6, atol=1e-8,
        interpret=True) * _jj(G5)), argnums=(0, 1))(_jj(y_small), _jj(tr))
    _close(got, want, 1e-4, "reverse")


def test_unbatched_y0():
    g1 = np.random.RandomState(3).randn(5, 2)
    f, p = _families(torch)["spiral"]
    pt, y = _tt(A), _tt(Y0[0])
    ys = _quietly(PF.odeint_adjoint_fused, f, y, _tt(T5, False),
                  params=(pt,))
    assert ys.shape == (5, 2)
    got = [x.numpy() for x in torch.autograd.grad(
        torch.sum(ys * torch.tensor(g1, dtype=F32)), [pt, y])]
    jf, _ = _families(jnp)["spiral"]
    want = jax.grad(lambda p_, y_: jnp.sum(j_fused(
        jf, y_, _jj(T5), params=(p_,), interpret=True) * _jj(g1)),
        argnums=(0, 1))(_jj(A), _jj(Y0[0]))
    _close(got, want, 1e-4, "unbatched")


def test_seminorm():
    f, p = _families(torch)["mlp_bias"]
    jf, _ = _families(jnp)["mlp_bias"]
    got = _quietly(_port, f, p, adjoint_seminorm=True)
    _close(got, _ref(jf, p, adjoint_seminorm=True), 1e-4, "seminorm")


def test_return_stats_and_meter():
    f, p = _families(torch)["mlp_bias"]
    meter = NFEMeter()
    pt = tuple(_tt(a) for a in p)
    ys, stats = PF.odeint_adjoint_fused(f, _tt(Y0, False), _tt(T5, False),
                                        params=pt, return_stats=True,
                                        nfe_meter=meter)
    assert stats.status == 0 and stats.nfe > 0
    g = torch.autograd.grad(torch.sum(ys * torch.tensor(G5, dtype=F32)), pt)
    assert all(bool(torch.isfinite(x).all()) for x in g)
    assert meter.f_nfe == stats.nfe and meter.b_nfe > 0


def test_failed_sweep_poisons_gradients():
    f, p = _families(torch)["mlp_bias"]
    got = _port(f, p, adjoint_rtol=1e-9, adjoint_atol=1e-12,
                max_num_steps=3)
    assert all(np.isnan(x).all() for x in got)


def test_rejected_reverse_walk_falls_back_once():
    """A plan that fuses forward but not backward (a feature-axis max)
    falls to the fused forward with the generic backward: one counted
    fallback, the generic gradients."""
    def f(t, y, p):
        return (y - y.amax(-1, keepdim=True)) * p[0]

    p = (np.array(-0.5),)
    before = PF.fuse_fallbacks
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        got = _port(f, p, route="fuse")
    assert PF.fuse_fallbacks == before + 1
    assert any("generic backward" in str(w.message) for w in wl)
    _close(got, _port(f, p, route="generic"), 2e-4, "tier2")
    with pytest.raises(PB.FusionError, match="reduce_max"):
        _port(f, p)


RNG_MF = np.random.RandomState(0)
W_MF = RNG_MF.randn(3, 3) * 0.3
Y_MF = RNG_MF.randn(12, 3)
T_MF = np.linspace(0.0, 2.0, 7)


def _coupled(xp):
    tor = xp is torch

    def mean0(y):
        return y.mean(0) if tor else jnp.mean(y, axis=0)

    def max0(y):
        return y.amax(0) if tor else jnp.max(y, axis=0)

    def min_all(y):
        return y.amin() if tor else jnp.min(y)

    return {
        "meanfield": lambda t, y, p: xp.tanh(y @ p[0]) - 0.5 * (y - mean0(y)),
        "bmax": lambda t, y, p: (xp.tanh(y @ p[0]) - 0.02 * max0(y)
                                 - 0.01 * (y - min_all(y))),
    }


@pytest.mark.parametrize("name", ["meanfield", "bmax"])
def test_coupled_training(name):
    """tests/test_meanfield.py:73, :161: the coupled reverse walk (the
    couplings' transposes with their block meets) on the reference's
    dynamics, the extremal samples kept apart for the batch max."""
    y0 = Y_MF.copy()
    if name == "bmax":
        y0[0] += 8.0
        y0[1] -= 8.0
    g = np.random.RandomState(1).randn(7, 12, 3)
    f = _coupled(torch)[name]
    got = _quietly(_port, f, (W_MF,), y0=y0, t=T_MF, g=g, route="fuse")
    want = _ref(_coupled(jnp)[name], (W_MF,), y0=y0, t=T_MF, g=g)
    _close(got, want, 1e-4, name)
    _close(got, _port(f, (W_MF,), y0=y0, t=T_MF, g=g, route="generic"),
           2e-4, name)


def test_dict_state_trains():
    """tests/test_tree_fuse.py:192: a dict state rides tier 1."""
    rs = np.random.RandomState(0)
    W = rs.randn(2, 2) * 0.5
    pos = rs.randn(8, 2)
    t4 = np.linspace(0.0, 1.5, 4)

    def dp(tt, y, p):
        v = torch.tanh(y["pos"] @ p["W"] + p["b"])
        return {"pos": v, "logp": -torch.sum(v, dim=-1)}

    def run(fuse):
        p = {"W": _tt(W), "b": _tt(np.zeros(2))}
        y = {"pos": _tt(pos), "logp": _tt(np.zeros(8))}
        ys = odeint_adjoint(dp, y, _tt(t4, False), params=p, rtol=1e-6,
                            atol=1e-8, options={"fuse": True} if fuse
                            else None)
        loss = torch.sum(ys["pos"] ** 2) + torch.sum(torch.sin(ys["logp"]))
        return [x.numpy() for x in torch.autograd.grad(
            loss, [p["W"], p["b"], y["pos"], y["logp"]])]

    got = _quietly(run, True)

    def jdp(tt, y, p):
        v = jnp.tanh(y["pos"] @ p["W"] + p["b"])
        return {"pos": v, "logp": -jnp.sum(v, axis=-1)}

    def jloss(p, y):
        ys = j_odeint_adjoint(jdp, y, _jj(t4), params=p, rtol=1e-6,
                              atol=1e-8, options={"fuse": True})
        return jnp.sum(ys["pos"] ** 2) + jnp.sum(jnp.sin(ys["logp"]))

    gp, gy = jax.grad(jloss, argnums=(0, 1))(
        {"W": _jj(W), "b": _jj(np.zeros(2))},
        {"pos": _jj(pos), "logp": _jj(np.zeros(8))})
    _close(got, [gp["W"], gp["b"], gy["pos"], gy["logp"]], 1e-4, "dict")
    _close(got, run(False), 2e-4, "dict generic")


def test_rk4_trains_on_k8_and_k9():
    f, p = _families(torch)["mlp_bias"]
    jf, _ = _families(jnp)["mlp_bias"]
    kw = dict(method="rk4", num_steps=20, adjoint_num_steps=5)
    got = _quietly(_port, f, p, **kw)
    _close(got, _ref(jf, p, **kw), 1e-4, "rk4")


def test_per_sample_trains():
    """A controller a sample in both sweeps. The reference's backward
    takes its shared controller (ROADMAP.md queue 3), so the two sweeps
    step differently: held at the tolerance's scale, 1e-3."""
    f, p = _families(torch)["mlp_bias"]
    jf, _ = _families(jnp)["mlp_bias"]
    got = _quietly(_port, f, p, route="fuse", options={"per_sample": True})
    _close(got, _ref(jf, p, per_sample=True), 1e-3, "per_sample")
    for a, b in zip(got, _quietly(_port, f, p, per_sample=True)):
        np.testing.assert_array_equal(a, b)


def test_learnable_scalar_gets_its_gradient_and_no_new_source():
    def make(v):
        k = torch.nn.Parameter(torch.tensor(v))

        def f(t, y):
            return torch.sin(t) * y - k * y ** 3 + 0.1
        return f, k

    f1, k1 = make(0.3)
    ys = _quietly(PF.odeint_adjoint_fused, f1, _tt(Y0, False),
                  _tt(T5, False))
    (gk,) = torch.autograd.grad(torch.sum(ys * torch.tensor(G5,
                                                            dtype=F32)), k1)
    jf, _ = _families(jnp)["timedep"]
    want = _ref(jf, (np.array(0.3),))[0]
    _close([gk.numpy()], [want], 1e-4, "k")
    f2, _ = make(-1.2)
    y = torch.tensor(Y0, dtype=F32)
    p1, _ = PB.build_plan(f1, torch.tensor(0.0), y)
    p2, _ = PB.build_plan(f2, torch.tensor(0.0), y)
    assert p1 == p2
    assert CP.source(p1, "adjoint") == CP.source(p2, "adjoint")


def test_refusals():
    f, p = _families(torch)["mlp_bias"]
    with pytest.raises(ValueError, match="adaptive RK methods only"):
        _port(f, p, method="rk4", per_sample=True)
    with pytest.raises(PB.FusionError, match="no whole-solve tableau"):
        _port(f, p, adjoint_method="adams")
    g = _coupled(torch)["meanfield"]
    with pytest.raises(PB.FusionError, match="batch-coupled"):
        _port(g, (W_MF,), y0=Y_MF, t=T_MF, g=np.ones((7, 12, 3)),
              per_sample=True)


_PLAN_REF = {}


@pytest.mark.parametrize("n_blocks", [1, 3, 7])
@pytest.mark.parametrize("name", ["spiral", "timedep", "batch_const"])
def test_plan_sweep_grid_matches_reference(name, n_blocks):
    """K15 in K3's plain version in the order of a grid of n_blocks blocks
    (B = 8: ranges of unequal length past one block; 'batch_const' has
    per-sample quadratures, 'timedep' the a_t one) against the
    reference's `plan_adjoint_solve` (interpret mode, pack=1), float64:
    identical stats, outputs within the plan sweeps' tolerance (1e-9
    relative, tests/test_torch_plan_adjoint.py)."""
    from test_torch_plan_adjoint import (_check_consts, _ref_sweep_inputs,
                                         _rel, _sweep_inputs, _sweep_tol)
    plan, packed, ys, g, tau = _sweep_inputs(name)
    f64 = torch.float64
    assert ys.shape[1] == 8
    ay0, dconsts, at, stats = CP.plan_adjoint_solve(
        plan, packed, torch.tensor(ys, dtype=f64), torch.tensor(g, dtype=f64),
        torch.tensor(tau, dtype=f64), 0.05, 1e-7, 1e-9, 1.0,
        n_blocks=n_blocks)
    if name not in _PLAN_REF:
        jplan, jpacked, jys, jg, jtau = _ref_sweep_inputs(name)
        _PLAN_REF[name] = JPA.plan_adjoint_solve(
            jplan, tuple(jpacked), jys, jg, jtau, 0.05, 1e-7, 1e-9, 1.0,
            interpret=True, pack=1)
    jay0, jdc, jat, jst = _PLAN_REF[name]
    assert [int(x) for x in stats] == [int(x) for x in jst]
    tol = _sweep_tol(name)
    assert _rel(ay0, np.asarray(jay0).T) <= tol
    assert abs(float(at) - float(jat)) <= tol * max(1.0, abs(float(jat)))
    _check_consts(plan, dconsts, jdc, tol)


def test_coupled_plan_sweep_takes_one_block():
    """A coupled plan's sweep meets the block inside a stage: it runs on
    one block and refuses a wider grid."""
    from test_torch_plan_adjoint import _sweep_inputs
    plan, packed, ys, g, tau = _sweep_inputs("meanfield")
    assert plan.batch_coupled and CP.plan_blocks(plan, 8, "cpu") == 1
    with pytest.raises(ValueError, match="one block"):
        CP.plan_adjoint_solve(plan, packed, torch.tensor(ys),
                              torch.tensor(g), torch.tensor(tau), 0.05, 1e-7,
                              1e-9, 1.0, n_blocks=3)
