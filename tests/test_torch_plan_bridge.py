"""PyTorch port: the plan capture (`ops/plan_bridge.build_plan`) and K14's
plain version (`eval_plan`) against the JAX package's jaxpr bridge.

Each dynamics is written once in PyTorch and once in jax.numpy over the
same numpy arrays (tests/test_fuse.py:23-73's set, the training families
of tests/test_plan_adjoint.py:64-80 with their tied and computed weights,
the round-half-even, feature-flip, trig and inverse-hyperbolic cases of
tests/test_fuse.py:448-582, its B = 1 edge plans, and the couplings of
tests/test_meanfield.py). One evaluation of the port's plan is held
- against the PyTorch function itself, and
- against the reference's `eval_plan_xla` on the reference's own plan,
both within 1e-6 relative to the output's largest entry in float32 and
1e-12 in float64 (the same operations; dots and reductions may sum in
another order, and XLA's transcendental functions are not PyTorch's). The
reference computes erf by Abramowitz & Stegun (jaxpr_bridge.py:73-96,
1.5e-7 absolute), the port by PyTorch's own erf, so the erf case is held
to that error plus four rounding units of the working type (the formula's
own float32 arithmetic), and the exact GELU to it carried through x / 2
and the output's weights.

Every FusionError case of the reference raises here too, equal structures
give equal plans with equal hashes, and an nn.Module's parameters are
captured as constants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.ops import jaxpr_bridge as JB
from tfdiffeq_tpu_torch.ops import plan_bridge as PB

RNG = np.random.RandomState(1)
A = np.array([[-0.1, 2.0], [-2.0, -0.1]])
W1 = RNG.randn(2, 16) * 0.3
B1 = RNG.randn(16) * 0.1
W2 = RNG.randn(16, 2) * 0.3
W1C = RNG.randn(3, 16) * 0.3
WM1 = RNG.randn(2, 64) * 0.2
WM2 = RNG.randn(64, 2) * 0.2
WF = RNG.randn(3, 3) * 0.3
BV = np.array([0.3])
Y0 = np.random.RandomState(0).randn(8, 2) * 1.5
Y3 = np.random.RandomState(2).randn(12, 3)
Y1 = np.array([[0.5, -0.3]])
Y4 = np.random.RandomState(0).rand(4, 2) + 1.0
#: Exact ties of round-half-to-even, and values between them.
YR = np.array([[0.5, 1.5], [2.5, -0.5], [-1.5, 0.25], [3.5, -2.5],
               [0.75, -0.75], [4.5, 1.0], [-3.5, 2.2], [5.5, -4.5]])
T0 = 0.7


def _dyn(xp, dtype):
    """The dynamics set in one framework (xp is torch or jnp) over the
    module's numpy arrays as constants of `dtype`: {name: (f, y0)}."""
    tor = xp is torch
    K = {n: (torch.tensor(a, dtype=dtype) if tor else jnp.asarray(a, dtype))
         for n, a in (("A", A), ("W1", W1), ("B1", B1), ("W2", W2),
                      ("W1C", W1C), ("WM1", WM1), ("WM2", WM2), ("WF", WF),
                      ("BV", BV))}

    def cat(xs, axis):
        return torch.cat(xs, dim=axis) if tor else jnp.concatenate(
            xs, axis=axis)

    def bcast_t(t, y):
        return (t.expand(y.shape[0], 1) if tor
                else jnp.broadcast_to(t, (y.shape[0], 1)).astype(y.dtype))

    def gelu(x):
        return (torch.nn.functional.gelu(x) if tor
                else jax.nn.gelu(x, approximate=False))

    def sigmoid(x):
        return torch.sigmoid(x) if tor else jax.nn.sigmoid(x)

    def erf(x):
        return torch.erf(x) if tor else jax.scipy.special.erf(x)

    def flip1(y):
        return torch.flip(y, (1,)) if tor else jnp.flip(y, axis=1)

    def mean(y, axis=None):
        if tor:
            return y.mean() if axis is None else y.mean(axis)
        return jnp.mean(y, axis=axis)

    def amax(y, axis, mn=False):
        if tor:
            return y.amin(axis) if mn else y.amax(axis)
        return jnp.min(y, axis=axis) if mn else jnp.max(y, axis=axis)

    def ysum(y, axis):
        return y.sum(axis) if tor else jnp.sum(y, axis=axis)

    def tr(w):
        return w.t() if tor else w.T

    def reshape1(t):
        return t.reshape(1) if tor else jnp.reshape(t, (1,))

    return {
        "spiral": (lambda t, y: (y ** 3) @ K["A"], Y0),
        "mlp": (lambda t, y: xp.tanh(y @ K["W1"] + K["B1"]) @ K["W2"], Y0),
        "timedep": (lambda t, y: xp.sin(t) * y - 0.3 * y ** 3 + 0.1, Y0),
        "concat_t": (lambda t, y: xp.tanh(cat([y, bcast_t(t, y)], 1)
                                          @ K["W1C"]) @ K["W2"], Y0),
        "gated": (lambda t, y: xp.where(y > 0, -0.5 * y, -0.1 * y), Y0),
        "sigmoid": (lambda t, y: sigmoid(y @ K["WM1"]) @ K["WM2"] - 0.2 * y,
                    Y0),
        "gelu_exact": (lambda t, y: gelu(y @ K["W1"] + K["B1"]) @ K["W2"],
                       Y0),
        "tied": (lambda t, y: xp.tanh(y @ K["W1"]) @ tr(K["W1"]) * 0.5, Y0),
        "computed_bias": (lambda t, y: xp.tanh(y @ K["W1"] + 2.0 * K["B1"])
                          @ K["W2"] - 0.1 * y, Y0),
        "erf": (lambda t, y: erf(y), Y0),
        "round_half_even": (lambda t, y: xp.round(y) - 0.1 * y, YR),
        "flip": (lambda t, y: flip1(y) * xp.exp(-0.1 * y), Y0),
        "trig": (lambda t, y: (xp.tan(0.3 * y) + xp.cos(y) * xp.sinh(0.2 * y)
                               + xp.asinh(y) + xp.arccosh(1.5 + y * y)
                               + xp.arctanh(0.5 * xp.tanh(y))), Y0),
        "meanfield": (lambda t, y: xp.tanh(y @ K["WF"])
                      - 0.5 * (y - mean(y, 0)), Y3),
        "scalar_coupled": (lambda t, y: xp.tanh(y @ K["WF"])
                           - 0.1 * mean(y ** 2) * y, Y3),
        "bmax": (lambda t, y: y - amax(y, 0), Y3),
        "bmax_tanh": (lambda t, y: xp.tanh(y @ K["WF"])
                      - 0.3 * (y - amax(y, 0)), Y3),
        "bmin": (lambda t, y: y - amax(y, 0, mn=True), Y3),
        "b1_mean_exp": (lambda t, y: -y * mean(xp.exp(y)), Y1),
        "b1_sum": (lambda t, y: y * 0.1 + 0.1 * ysum(y, 0), Y1),
        "concat_scalar": (lambda t, y: y * cat([reshape1(t), K["BV"]], 0),
                          Y4),
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


NAMES = sorted(_dyn(jnp, jnp.float32))
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", NAMES)
def test_eval_plan_matches_function_and_reference(name, dtype):
    f, y0 = _dyn(torch, dtype)[name]
    y = torch.tensor(y0, dtype=dtype)
    t = torch.tensor(T0, dtype=dtype)
    plan, consts = PB.build_plan(f, t, y)
    packed = PB.pack_consts(plan, consts, dtype)
    got = PB.eval_plan_host(plan, packed, t, y)
    with torch.no_grad():
        want = f(t, y)
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= TOL[dtype], (name, _rel(got, want))
    assert plan.batch_coupled == (name in ("meanfield", "scalar_coupled",
                                           "bmax", "bmin", "bmax_tanh"))

    # The reference's own plan on the same numbers.
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jf, jy0 = _dyn(jnp, jdt)[name]
    jy = jnp.asarray(jy0, jdt)
    jt = jnp.asarray(T0, jdt)
    jplan, jconsts = JB.build_plan(jf, jt, jy)
    jpacked = JB.pack_consts(jplan, jconsts, jdt, jy.shape[0])
    ref = np.asarray(JB.eval_plan_xla(jplan, jpacked, jt, jy.T).T)
    eps = torch.finfo(dtype).eps
    if name == "erf":
        # A&S's error, and four rounding units of the reference's own
        # arithmetic of the formula in the working type.
        assert np.max(np.abs(got.numpy() - ref)) <= 1.5e-7 + 4 * eps
    elif name == "gelu_exact":
        # The reference's erf error, carried through x / 2 and W2.
        pre = np.asarray(jy0) @ W1 + B1
        bound = 1.5e-7 * np.max((0.5 * np.abs(pre)) @ np.abs(W2))
        assert np.max(np.abs(got.numpy() - ref)) <= bound + TOL[dtype]
    else:
        assert _rel(got, ref) <= TOL[dtype], (name, _rel(got, ref))


def _refusals(xp):
    tor = xp is torch

    def flip0(y):
        return torch.flip(y, (0,)) if tor else jnp.flip(y, axis=0)

    def to_int(y):
        return (y.to(torch.int32).to(y.dtype) if tor
                else y.astype(jnp.int32).astype(y.dtype))

    def cumsum(y):
        return torch.cumsum(y, 1) if tor else jnp.cumsum(y, axis=1)

    def total(w):
        return w.sum() if tor else jnp.sum(w)

    def arr(a):
        return torch.tensor(a, dtype=torch.float32) if tor else \
            jnp.asarray(a, jnp.float32)

    Ad, Wd, Wc = arr(A), arr(A * 0.2), arr(WF)
    return {
        "computed_weights": (lambda t, y: y @ (Ad @ Ad), Y0),
        "weight_and_elementwise": (lambda t, y: (y @ Wd) * total(Wd), Y4),
        "batch_collision": (lambda t, y: y @ Wc, Y3[:3]),
        "batch_slice": (lambda t, y: y - y[:1], Y0),
        "batch_flip": (lambda t, y: flip0(y), Y0),
        "float_to_int": (lambda t, y: to_int(y), Y0),
        "unsupported_op": (lambda t, y: cumsum(y), Y0),
    }


@pytest.mark.parametrize("name", sorted(_refusals(jnp)))
def test_fusion_errors_match_reference(name):
    f, y0 = _refusals(torch)[name]
    with pytest.raises(PB.FusionError):
        PB.build_plan(f, torch.tensor(0.0), torch.tensor(y0,
                                                          dtype=torch.float32))
    jf, _ = _refusals(jnp)[name]
    with pytest.raises(JB.FusionError):
        JB.build_plan(jf, jnp.float32(0.0), jnp.asarray(y0, jnp.float32))


def test_equal_structures_give_equal_plans():
    """tests/test_fuse.py:351-357: the weights' values are not part of the
    plan."""
    a1, a2 = torch.tensor(A), torch.tensor(2.0 * A)
    y = torch.tensor(Y0)
    p1, c1 = PB.build_plan(lambda t, y: (y ** 3) @ a1, 0.0, y)
    p2, c2 = PB.build_plan(lambda t, y: (y ** 3) @ a2, 0.0, y)
    assert p1 == p2 and hash(p1) == hash(p2)
    assert len(c1) == len(c2) == 1
    assert not torch.equal(c1[0], c2[0])
    p3, _ = PB.build_plan(lambda t, y: torch.tanh(y ** 3) @ a1, 0.0, y)
    assert p3 != p1


def test_module_parameters_are_captured():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(2, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 2))
    y = torch.tensor(Y0, dtype=torch.float32)
    t = torch.tensor(0.0)
    plan, consts = PB.build_plan(lambda tt, yy: net(yy), t, y)
    layouts = sorted(lay[0] for lay in plan.const_layouts)
    assert layouts.count("wT") == 2 and layouts.count("col") == 2
    got = PB.eval_plan_host(plan, PB.pack_consts(plan, consts, y.dtype), t,
                            y)
    with torch.no_grad():
        assert _rel(got, net(y)) <= 1e-6
    # The same weights through the reference's bridge.
    w = [(net[i].weight.detach().numpy().T, net[i].bias.detach().numpy())
         for i in (0, 2)]
    jf = lambda tt, yy: jnp.tanh(yy @ w[0][0] + w[0][1]) @ w[1][0] + w[1][1]
    jy = jnp.asarray(Y0, jnp.float32)
    jplan, jc = JB.build_plan(jf, jnp.float32(0.0), jy)
    ref = JB.eval_plan_xla(jplan, JB.pack_consts(jplan, jc, jnp.float32, 8),
                           jnp.float32(0.0), jy.T).T
    assert _rel(got, np.asarray(ref)) <= 1e-6
