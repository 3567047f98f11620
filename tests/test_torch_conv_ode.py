"""PyTorch port: the conv-ODE dynamics (`ops/conv_ode.py`), K13's plain
version (`ops/cuda_conv.py`) and `fast.solve_conv_ode` against the JAX
package (`ops/conv_ode.py`, `fast.solve_conv_ode` in interpret mode).

The same numpy inputs go to both packages; the flax `ODEConvFunc`'s
parameters are carried across by `convert.odenet_from_flax` and
`conv_params_from_flax`. Tolerances are the JAX tests' own
(tests/test_conv_ode.py): the dynamics within 1e-5 at full width, whole
solves step for step (identical stats) with ys within atol 5e-4 / rtol 1e-3.
The port's layout is NCHW, the reference's NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.fast import solve_conv_ode as jax_solve_conv_ode
from tfdiffeq_tpu.models.odenet import ODEConvFunc as FlaxODEConvFunc
from tfdiffeq_tpu.ops import conv_ode as jco
from tfdiffeq_tpu_torch import convert, fast, solve
from tfdiffeq_tpu_torch.ops import conv_ode as co, cuda_conv as cc


def _setup(B=3, C=16, groups=8, seed=0):
    mod = FlaxODEConvFunc(features=C, groups=groups)
    x = (np.random.RandomState(seed).randn(B, 7, 7, C) * 0.5) \
        .astype(np.float32)
    vs = jax.tree_util.tree_map(
        np.asarray, mod.init(jax.random.PRNGKey(seed), 0.0, jnp.asarray(x)))
    return mod, vs, x


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(y):
    return np.moveaxis(np.asarray(y), -3, -1)


def test_dynamics_match_flax_full_width():
    """conv_ode_apply, the port's ODEConvFunc and K13's plain right-hand
    side against flax ODEConvFunc.apply and the JAX conv_ode_apply, at
    B = 4, C = 64, 32 groups."""
    mod, vs, x = _setup(B=4, C=64, groups=32)
    params = co.conv_params_from_flax(vs)
    spec = co.ConvODESpec(channels=64, groups=32)
    func = convert.odenet_from_flax(vs)
    xt = _nchw(x)
    rhs = cc.conv_rhs_plain(
        cc.pack_conv_ode_weights(params, spec, torch.float32), spec)
    for t in (0.0, 0.37, 1.0):
        want = np.asarray(mod.apply(vs, t, jnp.asarray(x)))
        jref = np.asarray(jco.conv_ode_apply(jco.conv_params_from_flax(vs),
                                             t, jnp.asarray(x),
                                             jco.ConvODESpec()))
        with torch.no_grad():
            got = [co.conv_ode_apply(params, t, xt, spec), func(t, xt),
                   rhs(torch.tensor(t), xt.view(4, 64, 49)).view(xt.shape)]
        for g in got:
            np.testing.assert_allclose(_nhwc(g), want, atol=1e-5)
            np.testing.assert_allclose(_nhwc(g), jref, atol=1e-5)


@pytest.mark.parametrize("t", [[0.0, 0.5, 1.0], [1.0, 0.4, 0.0]])
def test_fused_solve_matches_jax(t):
    """The port's solve_conv_ode on the CPU (K13's plain version) against
    the JAX solve_conv_ode in interpret mode, forward and reverse time:
    the same step sequence, ys within atol 5e-4 / rtol 1e-3."""
    _, vs, x = _setup()
    ref = jax_solve_conv_ode(vs, jnp.asarray(x), jnp.asarray(t, jnp.float32),
                             groups=8, rtol=1e-4, atol=1e-4, interpret=True)
    got = fast.solve_conv_ode(convert.odenet_from_flax(vs), _nchw(x), t,
                              groups=8, rtol=1e-4, atol=1e-4)
    assert tuple(got.stats) == tuple(int(s) for s in ref.stats)
    assert got.stats.status == 0
    np.testing.assert_allclose(_nhwc(got.ys), np.asarray(ref.ys), atol=5e-4,
                               rtol=1e-3)


def test_exhausted_step_budget_matches_jax():
    """max_num_steps (the ODE block's 256) exhausted: status 1
    (MAX_STEPS_REACHED) and the same counts as the reference."""
    _, vs, x = _setup(seed=2)
    t = [0.0, 1.0]
    ref = jax_solve_conv_ode(vs, jnp.asarray(x), jnp.asarray(t, jnp.float32),
                             groups=8, rtol=1e-4, atol=1e-4, interpret=True,
                             max_num_steps=2)
    got = fast.solve_conv_ode(co.conv_params_from_flax(vs), _nchw(x), t,
                              groups=8, rtol=1e-4, atol=1e-4,
                              max_num_steps=2)
    assert tuple(got.stats) == tuple(int(s) for s in ref.stats)
    assert got.stats.status == 1


def _small_blocks(monkeypatch):
    # Blocks of 2 samples at C = 16 and two output times, as
    # tests/test_conv_ode.py shrinks the reference's budget.
    import tfdiffeq_tpu.fast as JF
    budget = 4 * (fast._CONV_STACK_BLOCKS + 2) * 16 * 128
    monkeypatch.setattr(fast, "_CONV_STACK_BUDGET", budget)
    monkeypatch.setattr(JF, "_CONV_STACK_BUDGET", budget)
    assert fast.conv_block_size(16, 2, 49) == 2


def test_partition_into_controller_blocks(monkeypatch):
    """B = 4 in blocks of 2: each block's ys and stats equal the port's own
    solve of those samples alone, and the stats are summed the reference's
    way (the HNW evaluations counted once)."""
    _, vs, x = _setup(B=4, seed=3)
    params, xt, t = co.conv_params_from_flax(vs), _nchw(x), [0.0, 1.0]
    kw = dict(groups=8, rtol=1e-4, atol=1e-4)
    alone = [fast.solve_conv_ode(params, xt[b:b + 2], t, **kw)
             for b in (0, 2)]
    _small_blocks(monkeypatch)
    res = fast.solve_conv_ode(params, xt, t, **kw)
    for b, one in zip((0, 2), alone):
        assert torch.equal(res.ys[:, b:b + 2], one.ys)
    assert res.stats.nfe == sum(a.stats.nfe - 2 for a in alone) + 2
    assert res.stats.n_accepted == sum(a.stats.n_accepted for a in alone)
    assert res.stats.n_rejected == sum(a.stats.n_rejected for a in alone)


def test_ragged_last_block_differs_from_zero_padded_reference(monkeypatch):
    """B = 3 in blocks of 2: the reference pads its last block with a zero
    sample, which joins that block's error norm and first step; the port's
    last block holds its one true sample (ROADMAP.md, known faults of the
    reference). The first block agrees with the reference step for step;
    the last sample agrees with the port's solve of it alone, and differs
    from the reference's by more than roundoff, within the bar of the
    reference's own chunked-against-unchunked check (atol 2e-2,
    tests/test_conv_ode.py:105)."""
    _, vs, x = _setup(B=3, seed=4)
    params, xt, t = co.conv_params_from_flax(vs), _nchw(x), [0.0, 1.0]
    kw = dict(groups=8, rtol=1e-4, atol=1e-4)
    lone = fast.solve_conv_ode(params, xt[2:], t, **kw)
    _small_blocks(monkeypatch)
    ref = jax_solve_conv_ode(vs, jnp.asarray(x), jnp.asarray(t, jnp.float32),
                             interpret=True, **kw)
    got = fast.solve_conv_ode(params, xt, t, **kw)
    ref_ys = np.asarray(ref.ys)
    np.testing.assert_allclose(_nhwc(got.ys[:, :2]), ref_ys[:, :2],
                               atol=1e-5)
    assert torch.equal(got.ys[:, 2:], lone.ys)
    gap = np.abs(_nhwc(got.ys[:, 2:]) - ref_ys[:, 2:]).max()
    assert 1e-6 < gap < 2e-2, gap


def test_plain_kernel_matches_generic_engine_float64():
    """In float64, K13's plain version and the generic engine on the port's
    ODEConvFunc take the same steps (the generic count adds its f0
    evaluation) and agree within 1e-10."""
    _, vs, x = _setup(B=2, seed=5)
    func = convert.odenet_from_flax(vs, dtype=torch.float64, groups=8)
    params = co.conv_params_from_flax(vs)
    spec = co.ConvODESpec(channels=16, groups=8)
    xt = _nchw(x).double()
    t = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
    with torch.no_grad():
        gen = solve(func, xt, t, rtol=1e-6, atol=1e-6,
                    options={"first_step": 0.05})
        f0 = func(t[0], xt)
    out, st = cc.conv_solve_plain(
        cc.pack_conv_ode_weights(params, spec, torch.float64), spec, xt, t,
        torch.tensor([0.05], dtype=torch.float64), 1e-6, 1e-6, 1.0, f0=f0,
        block_size=2)
    nfe, acc, rej, status = st[0].tolist()
    assert (nfe + 1, acc, rej, status) == tuple(gen.stats)
    assert float((out - gen.ys).abs().max()) < 1e-10


def test_input_validation():
    _, vs, x = _setup()
    params, xt = co.conv_params_from_flax(vs), _nchw(x)
    with pytest.raises(ValueError, match="B, H, W, C"):
        fast.solve_conv_ode(params, xt[0], [0.0, 1.0], groups=8)
    with pytest.raises(ValueError, match="monotonic"):
        fast.solve_conv_ode(params, xt, [0.0, 1.0, 0.5], groups=8)
    with pytest.raises(ValueError, match="divisible"):
        fast.solve_conv_ode(params, xt, [0.0, 1.0], groups=5)
    # Past the block limit the reference warns and solves with its generic
    # engine (tfdiffeq_tpu/fast.py:2357-2371); so does the port.
    assert fast.conv_block_size(16, 2000, 49) == 0
    with pytest.warns(UserWarning, match="falling back to the generic"):
        res = fast.solve_conv_ode(params, xt, np.linspace(0.0, 1.0, 2000),
                                  groups=8)
    assert res.ys.shape == (2000,) + tuple(xt.shape)
    assert res.stats.status == 0 and torch.isfinite(res.ys).all()


def test_group_norm_negative_variance_clamp():
    """A near-constant group at large magnitude: float32 cancellation in
    E[x^2] - mean^2 goes negative; both GroupNorms of the port (the plain
    function and K13's order) clamp it as flax does and stay finite; the
    healthy groups match flax's GroupNorm (tests/test_conv_ode.py:163)."""
    import flax.linen as nn

    spec = co.ConvODESpec(channels=16, groups=8)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 7, 16).astype(np.float32)
    x[..., 0:2] = 173.2578
    ref = np.asarray(nn.GroupNorm(num_groups=8, use_bias=False,
                                  use_scale=False, epsilon=spec.eps)
                     .apply({}, jnp.asarray(x)))
    xt = _nchw(x)
    one, zero = torch.ones(16), torch.zeros(16)
    count = torch.tensor(2.0 * 49)
    outs = [co.group_norm(xt, one, zero, spec),
            cc._group_norm_plain(xt.view(2, 16, 49), one, zero, spec,
                                 count).view(xt.shape)]
    for out in outs:
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(_nhwc(out)[..., 2:], ref[..., 2:],
                                   atol=1e-3)
