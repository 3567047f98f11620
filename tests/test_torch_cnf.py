"""PyTorch port: the CNF models (`models/cnf.py`) and the plain versions
of K7's right-hand sides (`ops/cuda_kernels._cnf_net_plain`,
`ops/cuda_adjoint._cnf_aug_eval_plain`) against the JAX package.

The same numpy inputs go to both packages. Tolerances:
- one evaluation of a right-hand side in float64: both sides run the same
  arithmetic, only sums over the hidden units may take another order, so
  1e-13 (forward) and 1e-12 (adjoint, relative to each output's largest
  entry: its batch sums add B per-sample terms);
- whole generic solves in float64 (`log_prob`, its gradient, `sample`):
  both engines take the same steps, so 1e-10 relative;
- the analytic linear flow at rtol 1e-10 and the Hutchinson estimate with
  64 probes: 1e-8, the reference's own bar (tests/test_cnf.py);
- K3's plain sweep with K7's adjoint in the order of a grid of 1, 3 or 7
  blocks against the reference's sweep: identical stats, 1e-10 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.models import cnf as jcnf
from tfdiffeq_tpu.ops import pallas_adjoint as JA, pallas_kernels as JK
from tfdiffeq_tpu_torch import convert
from tfdiffeq_tpu_torch.examples import cnf as example
from tfdiffeq_tpu_torch.models import cnf
from tfdiffeq_tpu_torch.ops import cuda_adjoint as PA, cuda_kernels as PK

F64 = torch.float64


def _flow(D=2, H=8, depth=3, seed=0, scale=0.5):
    """Concat-t flow weights [(W [din, dout], b), ...] as numpy."""
    rng = np.random.RandomState(seed)
    widths = [D + 1] + [H] * (depth - 1) + [D]
    return [(rng.randn(i, o) * scale / np.sqrt(i), rng.randn(o) * 0.1)
            for i, o in zip(widths[:-1], widths[1:])]


def _jax_f(W):
    Wj = [(jnp.asarray(a), jnp.asarray(b)) for a, b in W]

    def f(t, z):
        h = jnp.concatenate([z, jnp.broadcast_to(jnp.asarray(t, z.dtype),
                                                 z.shape[:-1] + (1,))], -1)
        for l, (a, b) in enumerate(Wj):
            h = h @ a + b
            if l < len(Wj) - 1:
                h = jnp.tanh(h)
        return h

    return f


def _port_flow(W):
    flow = cnf.CNFDynamics(W[0][0].shape[0] - 1, W[0][0].shape[1], len(W),
                           dtype=F64)
    with torch.no_grad():
        for layer, (a, b) in zip(flow.layers, W):
            layer.weight.copy_(torch.tensor(a).t())
            layer.bias.copy_(torch.tensor(b))
    return flow


def test_log_prob_matches_analytic_linear_flow():
    # f(z) = a z: log p(x) = log N(x e^{-aT}) - D a T.
    a, T, D = 0.3, 1.0, 2
    f = lambda t, z: a * z
    x = torch.tensor(np.random.RandomState(0).randn(5, D))
    z0 = x.numpy() * np.exp(-a * T)
    exact = (-0.5 * np.sum(z0 ** 2, -1) - 0.5 * D * np.log(2 * np.pi)
             - D * a * T)
    for trace, kw in [("exact", {}),
                      ("hutchinson",
                       {"n_probes": 64,
                        "generator": torch.Generator().manual_seed(0)})]:
        lp = cnf.log_prob(f, x, t0=0.0, t1=T, rtol=1e-10, atol=1e-12,
                          trace=trace, **kw)
        np.testing.assert_allclose(lp.numpy(), exact, rtol=1e-8)


def test_exact_trace_matches_reference():
    W = _flow()
    rng = np.random.RandomState(1)
    z, logp = rng.randn(6, 2), rng.randn(6)
    dz_j, dl_j = jcnf.augmented_dynamics(_jax_f(W), trace="exact")(
        0.4, (jnp.asarray(z), jnp.asarray(logp)))
    dz, dl = cnf.augmented_dynamics(_port_flow(W), trace="exact")(
        torch.tensor(0.4, dtype=F64), (torch.tensor(z), torch.tensor(logp)))
    np.testing.assert_allclose(dz.detach().numpy(), np.asarray(dz_j),
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(dl.detach().numpy(), np.asarray(dl_j),
                               rtol=1e-13, atol=1e-14)


def test_hutchinson_trace_matches_reference_with_its_probes():
    W = _flow(seed=2)
    rng = np.random.RandomState(3)
    z, logp = rng.randn(6, 2), rng.randn(6)
    key = jax.random.PRNGKey(5)
    n = 3
    dz_j, dl_j = jcnf.augmented_dynamics(
        _jax_f(W), trace="hutchinson", n_probes=n, key=key)(
        0.4, (jnp.asarray(z), jnp.asarray(logp)))
    probes = torch.tensor(np.stack([np.asarray(jax.random.rademacher(
        jax.random.fold_in(key, i), (6, 2), dtype=jnp.float64))
        for i in range(n)]))
    dz, dl = cnf.augmented_dynamics(_port_flow(W), trace="hutchinson",
                                    n_probes=n, probes=probes)(
        torch.tensor(0.4, dtype=F64), (torch.tensor(z), torch.tensor(logp)))
    np.testing.assert_allclose(dz.detach().numpy(), np.asarray(dz_j),
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(dl.detach().numpy(), np.asarray(dl_j),
                               rtol=1e-13, atol=1e-14)
    # Drawn from a generator: fixed over the solve, +1 or -1.
    aug = cnf.augmented_dynamics(lambda t, zz: zz, trace="hutchinson",
                                 n_probes=2, shape=(6, 2),
                                 generator=torch.Generator().manual_seed(0))
    s = (torch.tensor(z), torch.tensor(logp))
    assert torch.equal(aug(0.0, s)[1], aug(1.0, s)[1])
    assert torch.allclose(aug(0.0, s)[1], torch.full((6,), -2.0, dtype=F64))


def test_hutchinson_requires_a_generator_or_probes():
    with pytest.raises(ValueError, match="generator"):
        cnf.augmented_dynamics(lambda t, z: z, trace="hutchinson")


def test_log_prob_and_gradient_match_reference():
    W = _flow(seed=4)
    x = np.random.RandomState(5).randn(6, 2) * 0.8

    def loss_j(w, xx):
        return jnp.sum(jcnf.log_prob(_jax_f(w), xx, rtol=1e-6, atol=1e-8))

    lp_j = jcnf.log_prob(_jax_f(W), jnp.asarray(x), rtol=1e-6, atol=1e-8)
    gw_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(W, jnp.asarray(x))

    flow = _port_flow(W)
    xt = torch.tensor(x, requires_grad=True)
    lp = cnf.log_prob(flow, xt, rtol=1e-6, atol=1e-8)
    lp.sum().backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(lp_j),
                               rtol=1e-10)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                               rtol=1e-10, atol=1e-12)
    for layer, (ga, gb) in zip(flow.layers, gw_j):
        np.testing.assert_allclose(layer.weight.grad.t().numpy(),
                                   np.asarray(ga), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(gb),
                                   rtol=1e-10, atol=1e-12)


def test_sample_matches_reference_from_the_same_draw():
    W = _flow(seed=6)
    gen = torch.Generator().manual_seed(7)
    xs = cnf.sample(_port_flow(W), gen, 10, 2, rtol=1e-6, atol=1e-8,
                    dtype=F64)
    z = torch.randn((10, 2), generator=torch.Generator().manual_seed(7),
                    dtype=F64)
    from tfdiffeq_tpu.odeint import odeint as jodeint
    ref = jodeint(_jax_f(W), jnp.asarray(z.numpy()),
                  jnp.asarray([0.0, 1.0]), rtol=1e-6, atol=1e-8)[-1]
    np.testing.assert_allclose(xs.detach().numpy(), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)


def test_cnf_from_flax_matches_apply():
    model = jcnf.CNFDynamics(dim=2, hidden=12, depth=3)
    vs = model.init(jax.random.PRNGKey(0), jnp.zeros(()),
                    jnp.zeros((1, 2)))
    np_vs = jax.tree_util.tree_map(np.asarray, vs)
    flow = convert.cnf_from_flax(np_vs, dtype=F64)
    z = np.random.RandomState(8).randn(5, 2)
    ref = model.apply(vs, 0.3, jnp.asarray(z))
    got = flow(0.3, torch.tensor(z))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)   # flax's float32 kernels
    from tfdiffeq_tpu_torch.fast import weights_from_linears
    W = weights_from_linears(flow)
    assert [tuple(w.shape) for w, _ in W] == [(3, 12), (12, 12), (12, 2)]
    with pytest.raises(ValueError, match="concat-t"):
        convert.cnf_from_flax({"params": {
            "Dense_0": {"kernel": np.zeros((2, 4)), "bias": np.zeros(4)},
            "Dense_1": {"kernel": np.zeros((4, 2)), "bias": np.zeros(2)}}})


def test_cnf_trains_by_likelihood():
    flow = cnf.CNFDynamics(dim=2, hidden=16, depth=2, dtype=F64,
                           generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    # A shifted gaussian: a few steps must lower the NLL.
    x = torch.tensor(rng.randn(64, 2) * 0.4 + np.array([1.5, -0.5]))
    opt = torch.optim.SGD(flow.parameters(), lr=0.05)

    def nll():
        return -torch.mean(cnf.log_prob(flow, x, rtol=1e-5, atol=1e-7))

    l0 = float(nll().detach())
    for _ in range(6):
        opt.zero_grad()
        loss = nll()
        loss.backward()
        opt.step()
    assert float(nll().detach()) < l0 - 0.1


# ---------------------------------------------------------------------------
# The plain versions of K7, one evaluation each, against the reference's
# Pallas right-hand sides run on plain arrays (no Pallas call).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", sorted(PK._ACTIVATIONS))
def test_k7_forward_plain_matches_reference(act):
    for depth in (1, 2, 3):
        W = _flow(D=2, H=7, depth=depth, seed=depth, scale=1.0)
        s = np.random.RandomState(9).randn(5, 3)
        wa, dims = JK.pad_mlp_weights(
            [(jnp.asarray(a), jnp.asarray(b)) for a, b in W], jnp.float64)
        ref = JK._make_cnf_net(wa, dims, act, True)(jnp.asarray(0.3),
                                                    jnp.asarray(s.T))
        packed, pd = PK.pack_mlp_weights(
            [(torch.tensor(a), torch.tensor(b)) for a, b in W], F64)
        got = PK._cnf_net_plain(packed, pd, act)(
            torch.tensor(0.3, dtype=F64), torch.tensor(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).T,
                                   rtol=1e-13, atol=1e-13)


def _rel_close(got, ref, bar):
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= bar * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("act", sorted(PK._ACTIVATIONS))
def test_k7_adjoint_plain_matches_reference(act):
    for depth in (1, 2, 3):
        W = _flow(D=2, H=7, depth=depth, seed=depth, scale=1.0)
        rng = np.random.RandomState(10)
        s, a = rng.randn(5, 3), rng.randn(5, 3)
        wa, dims = JK.pad_mlp_weights(
            [(jnp.asarray(x), jnp.asarray(b)) for x, b in W], jnp.float64)
        F_j, vy_j, flat, vt_j = JA._make_cnf_aug_eval(wa, dims, act)(
            jnp.asarray(0.3), jnp.asarray(s.T), jnp.asarray(a.T))
        packed, pd = PK.pack_mlp_weights(
            [(torch.tensor(x), torch.tensor(b)) for x, b in W], F64)
        F, vy, xw, vt = PA._cnf_aug_eval_plain(packed, pd, act)(
            torch.tensor(0.3, dtype=F64), torch.tensor(s), torch.tensor(a))
        _rel_close(F.numpy(), np.asarray(F_j).T, 1e-12)
        _rel_close(vy.numpy(), np.asarray(vy_j).T, 1e-12)
        assert torch.all(vy[:, 2] == 0.0)           # the logp row
        _rel_close(vt.sum().numpy(), np.asarray(vt_j).sum(), 1e-12)
        ref = []
        for (dW, db), (din, dout) in zip(zip(flat[::2], flat[1::2]), dims):
            ref += [np.asarray(dW)[:dout, :din].reshape(-1),
                    np.asarray(db)[:dout, 0]]
        # The kernel's per-sample cotangents, summed over the batch.
        _rel_close(xw.sum(0).numpy(), np.concatenate(ref), 1e-12)
        _rel_close(vt.numpy(), np.asarray(vt_j)[0], 1e-12)


@pytest.mark.parametrize("act", sorted(PK._ACTIVATION_GRAD2))
def test_activation_grad2_matches_reference(act):
    z = np.linspace(-3.0, 3.0, 41)
    a = np.asarray(JK._ACTIVATIONS[act](jnp.asarray(z)))
    g = np.asarray(JK._ACTIVATION_GRADS[act](jnp.asarray(z), jnp.asarray(a)))
    want = np.asarray(JK._ACTIVATION_GRAD2[act](
        jnp.asarray(z), jnp.asarray(a), jnp.asarray(g)))
    got = PK._ACTIVATION_GRAD2[act](torch.tensor(z), torch.tensor(a),
                                    torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


# ---------------------------------------------------------------------------
# The example.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_example_runs_on_the_cpu(fused):
    args = ["--device", "cpu", "--niters", "3", "--batch_size", "32",
            "--hidden", "8"] + (["--fused"] if fused else [])
    flow, losses, xs = example.main(args)
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert xs.shape == (1000, 2) and np.all(np.isfinite(xs))


def test_example_auto_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 16"):
        example.main(["--device", "cpu", "--auto", "--niters", "1"])



_SWEEP_REF = {}


@pytest.mark.parametrize("n_blocks", [1, 3, 7])
def test_k7_sweep_grid_matches_reference(n_blocks):
    """K3's plain version with K7's adjoint (rhs='cnf') in the order of a
    grid of n_blocks blocks (B = 8: ranges of unequal length past one
    block) against the reference's sweep (`pallas_adjoint`
    mlp_adjoint_solve with rhs='cnf', interpret mode, pack=1), float64:
    identical stats, outputs within rtol 1e-10 (its batch sums add
    per-sample cotangents, which the reference sums product by product)."""
    W, B = _flow(D=2, H=8, depth=3, seed=1, scale=0.6), 8
    wa, dims = JK.pad_mlp_weights(
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in W], jnp.float64)
    packed, pd = PK.pack_mlp_weights(
        [(torch.tensor(a), torch.tensor(b)) for a, b in W], F64)
    rng = np.random.RandomState(4)
    s0 = np.concatenate([rng.randn(B, 2), np.zeros((B, 1))], axis=1)
    tau = np.array([-1.0, -0.5, 0.0])            # t = 1 -> 0, sign -1
    sign, rtol, atol = -1.0, 1e-6, 1e-8
    f0 = sign * PK._cnf_net_plain(packed, pd, "tanh")(
        torch.tensor(1.0, dtype=F64), torch.tensor(s0))
    ys, st = PK.mlp_solve(packed, pd, torch.tensor(s0), torch.tensor(tau),
                          0.05, rtol, atol, sign, f0=f0, activation="tanh",
                          time_input=True, rhs="cnf")
    assert st[3].item() == 0
    g = rng.randn(*ys.shape)
    kw = dict(activation="tanh", method="dopri5", seminorm=False)
    if "ref" not in _SWEEP_REF:
        _SWEEP_REF["ref"] = JA.mlp_adjoint_solve(
            wa, dims, jnp.asarray(ys.numpy().transpose(0, 2, 1)),
            jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau), 0.05, rtol,
            atol, sign, rhs="cnf", interpret=True, pack=1, **kw)
    ay0_j, aws_j, at_j, bst_j = _SWEEP_REF["ref"]
    ay0, aw, at, bst = PA.mlp_adjoint_solve(
        packed, pd, ys, torch.tensor(g), torch.tensor(tau), 0.05, rtol, atol,
        sign, rhs="cnf", n_blocks=n_blocks, **kw)
    assert bst.tolist() == [int(v) for v in bst_j] and bst[3].item() == 0
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_j).T, rtol=1e-10,
                               atol=1e-12)
    ref = []
    for (dW, db), (din, dout) in zip(aws_j, dims):
        ref += [np.asarray(dW)[:dout, :din].reshape(-1),
                np.asarray(db)[:dout, 0]]
    np.testing.assert_allclose(aw.numpy(), np.concatenate(ref), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(at), float(at_j), rtol=1e-10,
                               atol=1e-12)
    assert PA.mlp_adjoint_solve_launches == 0
