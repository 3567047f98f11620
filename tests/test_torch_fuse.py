"""PyTorch port: `fast.solve_fused` and the `odeint(options={'fuse': True})`
route against the JAX package's, which runs its Pallas kernels in
interpret mode here.

Each dynamics is written in both frameworks over the same numpy arrays
(tests/test_torch_plan_bridge.py); y0 is drawn from a seed; B <= 12 and at
most 7 output times. On the CPU the port's plan kernels run their plain
versions (`ops/cuda_plan.py`), so these hold the whole front end (capture,
f0, first step, the engines, the stats) to the reference:
- trajectories within 1e-5 absolute in float32 (tests/test_fuse.py's
  bar), with the first step pinned (the HNW estimate sums in another order
  in the two packages);
- identical stats wherever the reference asserts NFE against its generic
  engine (the forward set but its MXU-sized sigmoid and its A&S erf,
  tests/test_fuse.py:67-91; the mean-field and tree states), and identical
  fixed-grid stats and per-sample counts. Reverse time and the unbatched
  state are held to the trajectories only, as the reference holds them
  (tests/test_fuse.py:96-105, :220-227): an accept near a ratio of 1 can
  flip with the last bit of XLA's exp and log in the controller;
- dopri5, bosh3 and tsit5 in reverse time; rk4, euler, midpoint and
  rk4_38; `per_sample` lane_stats; an unbatched y0; tuple and dict states
  (tests/test_tree_fuse.py); the mean-field couplings
  (tests/test_meanfield.py), each with the reference's NFE;
- the port's own contract: an unfusable function warns, matches the
  generic engine bitwise and counts one fallback; what is not ported
  raises NotImplementedError naming its ROADMAP item; every built-in
  method in `SOLVERS` fuses (the reference's
  test_every_builtin_method_fuses): no warning, its kernel's wrapper
  reached, the generic engine's answer within 5e-4; `cnf_sample_auto`
  equals `cnf_sample_fused` within 1e-4 on the same base noise.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF, solve as jsolve
from tfdiffeq_tpu_torch import fast as PF, odeint_adjoint, solve

from test_torch_plan_bridge import Y0, _dyn

T = np.linspace(0.0, 2.0, 5)
FIRST = 0.05


def _pair(name, dtype=np.float32):
    """(torch f, jax f, y0) of the dynamics set."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    f, y0 = _dyn(torch, tdt)[name]
    jf, _ = _dyn(jnp, dtype)[name]
    return f, jf, y0


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _stats(st):
    return [int(x) for x in st]


def _centred(t, v):
    """A batch coupling: each sample relaxes toward the batch mean."""
    return v - v.mean(0)


def _fused_quietly(fn, *a, **kw):
    """A fused call that must not fall back."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return fn(*a, **kw)


@pytest.mark.parametrize("name", ["spiral", "mlp", "timedep", "concat_t",
                                  "gated", "sigmoid", "gelu_exact"])
def test_solve_fused_matches_reference(name):
    f, jf, y0 = _pair(name)
    r = PF.solve_fused(f, _t(y0), _t(T), rtol=1e-6, atol=1e-8,
                       first_step=FIRST)
    rj = JF.solve_fused(jf, jnp.asarray(y0, jnp.float32),
                        jnp.asarray(T, jnp.float32), rtol=1e-6, atol=1e-8,
                        first_step=FIRST, interpret=True)
    assert r.stats.status == 0
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), atol=1e-5)
    if name not in ("sigmoid", "gelu_exact"):
        assert _stats(r.stats) == _stats(rj.stats)


@pytest.mark.parametrize("method", ["dopri5", "bosh3", "tsit5"])
def test_reverse_time_methods(method):
    f, jf, y0 = _pair("mlp")
    tr = T[::-1].copy()
    r = PF.solve_fused(f, _t(y0), _t(tr), rtol=1e-6, atol=1e-8,
                       method=method, first_step=FIRST)
    rj = JF.solve_fused(jf, jnp.asarray(y0, jnp.float32),
                        jnp.asarray(tr, jnp.float32), rtol=1e-6, atol=1e-8,
                        method=method, first_step=FIRST, interpret=True)
    assert r.stats.status == 0
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), atol=1e-5)


@pytest.mark.parametrize("method", ["rk4", "euler", "midpoint", "rk4_38"])
def test_fixed_grid_methods(method):
    f, jf, y0 = _pair("mlp")
    r = PF.solve_fused(f, _t(y0), _t(T), method=method, num_steps=24)
    rj = JF.solve_fused(jf, jnp.asarray(y0, jnp.float32),
                        jnp.asarray(T, jnp.float32), method=method,
                        num_steps=24, interpret=True)
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), atol=1e-5)
    assert _stats(r.stats) == _stats(rj.stats)


def test_per_sample_lane_stats():
    f, jf, y0 = _pair("spiral")
    r = PF.solve_fused(f, _t(y0), _t(T), rtol=1e-6, atol=1e-8,
                       first_step=FIRST, per_sample=True)
    rj = JF.solve_fused(jf, jnp.asarray(y0, jnp.float32),
                        jnp.asarray(T, jnp.float32), rtol=1e-6, atol=1e-8,
                        first_step=FIRST, per_sample=True, interpret=True)
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), atol=1e-5)
    for a, b in zip(r.lane_stats, rj.lane_stats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert _stats(r.stats) == _stats(rj.stats)


def test_unbatched_y0():
    f, jf, y0 = _pair("spiral")
    r = PF.solve_fused(lambda t, y: (y ** 3) @ torch.tensor(
        [[-0.1, 2.0], [-2.0, -0.1]]), _t(y0[0]), _t(T), first_step=FIRST)
    rj = JF.solve_fused(jf, jnp.asarray(y0[0], jnp.float32),
                        jnp.asarray(T, jnp.float32), first_step=FIRST,
                        interpret=True)
    assert tuple(r.ys.shape) == (len(T), 2)
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), atol=1e-5)


W_TREE = np.random.RandomState(0).randn(2, 2) * 0.5


def _tree_dyns(xp):
    tor = xp is torch
    W = (torch.tensor(W_TREE, dtype=torch.float32) if tor
         else jnp.asarray(W_TREE, jnp.float32))

    def rowsum(v):
        return v.sum(-1) if tor else jnp.sum(v, axis=-1)

    def dyn_dict(t, y):
        v = xp.tanh(y["pos"] @ W)
        return {"pos": v, "logp": -rowsum(v)}

    def dyn_tuple(t, y):
        return (y[1], -xp.sin(y[0]) - 0.1 * y[1])

    return dyn_dict, dyn_tuple


@pytest.mark.parametrize("kind", ["dict", "tuple"])
def test_tree_states(kind):
    rng = np.random.RandomState(0)
    if kind == "dict":
        y0 = {"pos": rng.randn(8, 2), "logp": rng.randn(8)}
    else:
        y0 = (rng.randn(8, 1), rng.randn(8, 1))
    conv = (lambda a, mk: {k: mk(v) for k, v in a.items()}) \
        if kind == "dict" else (lambda a, mk: tuple(mk(v) for v in a))
    pf = _tree_dyns(torch)[0 if kind == "dict" else 1]
    jf = _tree_dyns(jnp)[0 if kind == "dict" else 1]
    opts = {"fuse": True, "first_step": FIRST}
    r = _fused_quietly(solve, pf, conv(y0, _t), _t(T), rtol=1e-6, atol=1e-8,
                       options=opts)
    rj = jsolve(jf, conv(y0, lambda a: jnp.asarray(a, jnp.float32)),
                jnp.asarray(T, jnp.float32), rtol=1e-6, atol=1e-8,
                options=opts)
    leaves = (lambda y: [y[k] for k in sorted(y)]) if kind == "dict" \
        else list
    for a, b in zip(leaves(r.ys), leaves(rj.ys)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert _stats(r.stats) == _stats(rj.stats)


@pytest.mark.parametrize("name", ["meanfield", "scalar_coupled", "bmax"])
def test_mean_field_couplings(name):
    """tests/test_meanfield.py:37-50: the coupled plans run K2's batch
    route (block sums in its order) and take the reference's steps."""
    f, jf, y0 = _pair(name)
    opts = {"fuse": True}
    r = _fused_quietly(solve, f, _t(y0), _t(T), rtol=1e-6, atol=1e-8,
                       options=opts)
    rj = jsolve(jf, jnp.asarray(y0, jnp.float32), jnp.asarray(T, jnp.float32),
                rtol=1e-6, atol=1e-8, options=opts)
    assert r.stats.status == 0
    np.testing.assert_allclose(r.ys.numpy(), np.asarray(rj.ys), atol=1e-5)
    assert _stats(r.stats) == _stats(rj.stats)


def test_unfusable_dynamics_fall_back_and_count():
    def f(t, y):
        return -torch.cumsum(y, 1) * 0.3

    y0 = _t(Y0)
    before = PF.fuse_fallbacks
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        r = solve(f, y0, _t(T), options={"fuse": True})
    assert any("falling back" in str(w.message) for w in wl)
    assert PF.fuse_fallbacks == before + 1
    g = solve(f, y0, _t(T))
    assert torch.equal(r.ys, g.ys) and _stats(r.stats) == _stats(g.stats)
    # per_sample keeps its semantics through the fallback.
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        rp = solve(f, y0[:3], _t(T), options={"fuse": True,
                                              "per_sample": True})
    assert PF.fuse_fallbacks == before + 2
    assert rp.lane_stats is not None and rp.lane_stats.nfe.shape == (3,)


@pytest.mark.parametrize("call, exc, match", [
    # A reduced dot_precision, once refused here (ROADMAP queue 1 item 16),
    # runs the plan's tile route where a dot is selected
    # (tests/test_torch_plan_tiers.py); the spiral's dots are too narrow for
    # matmul='auto', so its trajectory is held to the generic dopri5's.
    (lambda f, y: PF.solve_fused(f, y, _t(T), dot_precision="mixed"),
     None, "dopri5"),
    # dense_output (once refused here, ROADMAP item 3) runs K2 with its
    # interpolant emission (tests/test_torch_fused_dense.py holds it to
    # the reference): its trajectory is held to the generic dopri5's.
    (lambda f, y: PF.solve_fused(f, y, _t(T), dense_output=True),
     None, "dopri5"),
    # The Adams methods, once refused here (K14 inside K10 and K11,
    # ROADMAP queue 2 items 1-2), now run: `match` names the method whose
    # generic solve the fused one is held to.
    (lambda f, y: solve(f, y, _t(T), method="adams",
                        options={"fuse": True}),
     None, "adams"),
    (lambda f, y: PF.solve_fused(f, y, _t(T), method="explicit_adams"),
     None, "explicit_adams"),
    # A coupled plan on a fixed grid, once refused here (ROADMAP queue 1
    # item 16.1), runs on K8's one block, and trains on K8 + K9: `match`
    # is the generic solve its trajectory is held to.
    (lambda f, y: PF.solve_fused(_centred, y, _t(T), method="rk4"),
     None, lambda y: solve(_centred, y, _t(T), method="rk4").ys),
    (lambda f, y: PF.solve_fused(lambda t, v: v - v.mean(0), y, _t(T),
                                 per_sample=True),
     ValueError, "per_sample"),
    (lambda f, y: odeint_adjoint(_centred, y, _t(T), method="rk4",
                                 options={"fuse": True}),
     None, lambda y: odeint_adjoint(_centred, y, _t(T), method="rk4")),
    (lambda f, y: solve(f, y, _t(T), options={"dot_precision": "mixed"}),
     ValueError, "requires the fused kernel"),
], ids=["dot_precision", "dense_output", "adams", "explicit_adams",
        "coupled_fixed", "coupled_per_sample", "adjoint", "precision_alone"])
def test_refusals(call, exc, match):
    f, _, y0 = _pair("spiral")
    if exc is None:
        res = _fused_quietly(call, f, _t(y0))
        if callable(match):
            # The coupled cases: trajectories (a solve's or a training
            # forward's) against the generic engine's.
            ys, want = getattr(res, "ys", res), match(_t(y0))
        else:
            assert res.stats.status == 0
            ys, want = res.ys, solve(f, _t(y0), _t(T), method=match).ys
        np.testing.assert_allclose(ys.detach().numpy(),
                                   want.detach().numpy(), atol=5e-4)
        return
    with pytest.raises(exc, match=match):
        call(f, _t(y0))


def test_cnf_sample_auto_matches_fused_and_reference():
    """A concat-t flow written as plain PyTorch: `cnf_sample_auto` (the
    plan in K2) against `cnf_sample_fused` (K2's MLP route) on the same
    generator draws within 1e-4, and against the reference's fused solve of
    the same flow on the same noise (what its `cnf_sample_auto` runs)."""
    rng = np.random.RandomState(3)
    widths = [3, 8, 8, 2]
    W = [(rng.randn(i, o) * 0.6 / np.sqrt(i), rng.randn(o) * 0.1)
         for i, o in zip(widths[:-1], widths[1:])]
    tw = [(_t(a), _t(b)) for a, b in W]

    def flow(t, z, params):
        h = torch.cat([z, t.expand(z.shape[0], 1)], dim=1)
        for i, (a, b) in enumerate(params):
            h = h @ a + b
            if i < len(params) - 1:
                h = torch.tanh(h)
        return h

    got = PF.cnf_sample_auto(flow, tw, torch.Generator().manual_seed(5), 6, 2)
    want = PF.cnf_sample_fused(tw, torch.Generator().manual_seed(5), 6, 2)
    assert float((got - want).abs().max()) <= 1e-4

    z = torch.randn((6, 2), generator=torch.Generator().manual_seed(5))
    jw = [(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
          for a, b in W]

    def jflow(t, zz):
        h = jnp.concatenate([zz, jnp.broadcast_to(t, (zz.shape[0], 1))
                             .astype(zz.dtype)], axis=1)
        for i, (a, b) in enumerate(jw):
            h = h @ a + b
            if i < len(jw) - 1:
                h = jnp.tanh(h)
        return h

    rj = JF.solve_fused(jflow, jnp.asarray(z.numpy()),
                        jnp.asarray([0.0, 1.0], jnp.float32), rtol=1e-5,
                        atol=1e-7, interpret=True)
    mine = PF.cnf_sample_auto(flow, tw, None, 6, 2, z=z)
    assert torch.equal(mine, got)
    np.testing.assert_allclose(mine.numpy(), np.asarray(rj.ys[-1]),
                               atol=1e-5)


#: Each built-in method's kernel wrapper (ops/cuda_plan.py).
_WRAPPER = {**{m: "plan_solve" for m in ("dopri5", "bosh3", "adaptive_heun",
                                         "tsit5", "dopri8")},
            **{m: "plan_solve_fixed" for m in ("euler", "midpoint", "rk4",
                                               "rk4_38")},
            "explicit_adams": "plan_solve_adams",
            "fixed_adams": "plan_solve_adams", "adams": "plan_solve_vcabm",
            **{m: "plan_solve_hyper" for m in ("hyper_euler",
                                               "hyper_midpoint",
                                               "hyper_heun")}}


def test_every_builtin_method_fuses(monkeypatch):
    """The reference's tests/test_fixed_fused.py:612 in the port: with
    options={'fuse': True} every method in SOLVERS reaches its whole-solve
    kernel's wrapper (its plain version here) with no fallback warning,
    and agrees with the generic engine within 5e-4."""
    from tfdiffeq_tpu_torch import SOLVERS
    from tfdiffeq_tpu_torch.ops import cuda_plan as CP

    rng = np.random.RandomState(81)
    W1 = _t(rng.randn(2, 16) * 0.3)
    W2 = _t(rng.randn(16, 2) * 0.3)
    # Hidden width 12: distinct from the batch of 8 (the capture refuses a
    # batch equal to a feature width).
    Hw = _t(rng.randn(5, 12) * 0.2)
    Hv = _t(rng.randn(12, 2) * 0.2)

    def f(tt, yy):
        return torch.tanh((yy ** 3) @ W1) @ W2

    def g(tt, yy, ff):
        tc = tt.reshape(1, 1).expand(yy.shape[0], 1)
        return torch.tanh(torch.cat([yy, ff, tc], 1) @ Hw) @ Hv

    y0 = _t(rng.randn(8, 2))
    t = _t(np.linspace(0.0, 1.0, 5))
    per_method = {
        "dopri5": {}, "bosh3": {}, "adaptive_heun": {}, "tsit5": {},
        "dopri8": {}, "euler": {"num_steps": 32}, "midpoint": {}, "rk4": {},
        "rk4_38": {}, "explicit_adams": {"num_steps": 16}, "fixed_adams": {},
        "adams": {"first_step": 0.05}, "hyper_euler": {"hypernet": g},
        "hyper_midpoint": {"hypernet": g}, "hyper_heun": {"hypernet": g}}
    assert set(per_method) == set(SOLVERS) == set(_WRAPPER)
    seen = []
    for name in set(_WRAPPER.values()):
        orig = getattr(CP, name)
        monkeypatch.setattr(CP, name, lambda *a, _n=name, _o=orig, **k: (
            seen.append(_n), _o(*a, **k))[1])
    for method, opts in per_method.items():
        seen.clear()
        rf = _fused_quietly(solve, f, y0, t, rtol=1e-5, atol=1e-7,
                            method=method, options={"fuse": True, **opts})
        assert seen == [_WRAPPER[method]], method
        rg = solve(f, y0, t, rtol=1e-5, atol=1e-7, method=method,
                   options=opts)
        assert rf.stats.status == 0, method
        np.testing.assert_allclose(rf.ys.numpy(), rg.ys.numpy(), rtol=0,
                                   atol=5e-4, err_msg=method)
