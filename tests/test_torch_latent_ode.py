"""PyTorch port: the latent ODE (`models/latent_ode.py`,
`examples/latent_ode.py`) against the JAX package's flax modules and
training step.

The JAX example's parameters (flax init) are carried across as numpy by
`convert.latent_ode_from_flax`, and the noise the reference's loss draws
from its key is handed to the port's loss as `eps`. The modules agree
within 1e-5 in float32 (products summed in other orders). At a small size,
8 spirals of 10 samples, one training step's loss and gradients:

- float64, `--fused`: both packages run the same fused arithmetic, so the
  loss and every gradient agree within 1e-9 relative (to the leaf's
  largest entry).
- float64, generic: the reference backpropagates through its solver, the
  port integrates the adjoint (`odeint_adjoint`). The loss and the
  decoder's gradients agree within 1e-9; the gradients that pass through
  the ODE (dynamics and encoder) agree to the solver's tolerance
  (rtol 1e-4): within 5e-3, where the reference's own fused and generic
  gradients differ by up to 1.7e-3 on these inputs.
- float32, both decoders: the loss within 1e-3, gradients within 5e-3. At
  rtol 1e-4 float32 rounding changes the step sequence in either package;
  the reference's own two decoders disagree by up to 2.6e-3 here.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples import latent_ode as JL  # noqa: E402
from tfdiffeq_tpu_torch import convert  # noqa: E402
from tfdiffeq_tpu_torch.examples import latent_ode as PL  # noqa: E402
from tfdiffeq_tpu_torch.models import latent_ode as PM  # noqa: E402

NSPIRAL, NSAMPLE = 8, 10


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    args = JL.parse_args([])
    args.nspiral, args.nsample = NSPIRAL, NSAMPLE
    _, samp, _, ts = JL.generate_spirals(nspiral=NSPIRAL, nsample=NSAMPLE,
                                         seed=0)
    rec, dyn, dec = JL.build_model(args)
    params = JL.init_params(args, rec, dyn, dec, jax.random.PRNGKey(0))
    return args, (rec, dyn, dec), params, samp, ts


def _port(params):
    return convert.latent_ode_from_flax(_np(params), dtype=torch.float32)


def test_generate_spirals_is_the_reference():
    ref = JL.generate_spirals(nspiral=5, ntotal=60, nsample=12, seed=3)
    got = PL.generate_spirals(nspiral=5, ntotal=60, nsample=12, seed=3)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_modules_match_flax(setup):
    args, (jrec, jdyn, jdec), params, samp, _ = setup
    rec, dyn, dec = _port(params)
    xs = samp.astype(np.float32)
    mean_j, logvar_j = jrec.apply(params["rec"], jnp.asarray(xs))
    mean, logvar = rec(torch.tensor(xs))
    np.testing.assert_allclose(mean.detach().numpy(), mean_j, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(logvar.detach().numpy(), logvar_j,
                               rtol=1e-5, atol=1e-5)
    z = np.random.RandomState(1).randn(7, args.latent_dim).astype(np.float32)
    np.testing.assert_allclose(
        dyn(0.0, torch.tensor(z)).detach().numpy(),
        jdyn.apply(params["dyn"], 0.0, jnp.asarray(z)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        dec(torch.tensor(z)).detach().numpy(),
        jdec.apply(params["dec"], jnp.asarray(z)), rtol=1e-5, atol=1e-5)
    x = np.linspace(-2.0, 2.0, 9)
    c = lambda v: torch.tensor(v, dtype=torch.float64)
    for got, ref in ((PM.log_normal_pdf(c(x), c(0.3), c(-0.5)),
                      JL.log_normal_pdf(x, 0.3, -0.5)),
                     (PM.normal_kl(c(x), c(0.2), c(0.1), c(-0.4)),
                      JL.normal_kl(x, 0.2, 0.1, -0.4))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def _port_grads(rec, dyn, dec):
    """The port's gradients in the flax layout."""
    def dense(m):
        return {"kernel": m.weight.grad.t(), "bias": m.bias.grad}
    return {
        "rec": {"params": {"i2h_kernel": rec.i2h.weight.grad.t(),
                           "i2h_bias": rec.i2h.bias.grad,
                           "h2o": dense(rec.h2o)}},
        "dyn": {"params": {f"Dense_{i}": dense(getattr(dyn, f"dense_{i}"))
                           for i in range(3)}},
        "dec": {"params": {f"Dense_{i}": dense(getattr(dec, f"dense_{i}"))
                           for i in range(2)}},
    }


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "generic"])
def test_training_step_matches_reference(setup, fused, dtype):
    _, (jrec, jdyn, jdec), params, samp, ts = setup
    args = JL.parse_args(["--fused"] if fused else [])
    args.nspiral, args.nsample = NSPIRAL, NSAMPLE
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = jax.tree_util.tree_map(lambda a: a.astype(jdt), params)
    xs = samp.astype(jdt)
    key = jax.random.PRNGKey(5)
    _, jloss_fn = JL.make_train_step(args, jrec, jdyn, jdec,
                                     optax.adam(args.lr),
                                     jnp.asarray(ts, jdt))
    jloss, jgrads = jax.value_and_grad(jloss_fn)(params, jnp.asarray(xs),
                                                 key)
    # The noise the reference's loss draws from `key`.
    eps = np.asarray(jax.random.normal(key, (NSPIRAL, args.latent_dim),
                                       jdt))

    rec, dyn, dec = convert.latent_ode_from_flax(_np(params), dtype=tdt)
    opt = torch.optim.Adam([p for m in (rec, dyn, dec)
                            for p in m.parameters()], lr=args.lr)
    _, loss_fn = PL.make_train_step(args, rec, dyn, dec, opt,
                                    torch.tensor(ts, dtype=tdt))
    loss = loss_fn(torch.tensor(xs), eps=torch.tensor(eps))
    loss.backward()
    loss = float(loss.detach())
    f64 = dtype == "float64"
    assert abs(loss - float(jloss)) <= (1e-9 if f64 else 1e-3) * abs(
        float(jloss))
    got = _np(jax.tree_util.tree_map(lambda x: x.detach().numpy(),
                                     _port_grads(rec, dyn, dec)))
    ref = _np(jgrads)
    for part in ("dec", "dyn", "rec"):
        bar = 1e-9 if f64 and (fused or part == "dec") else 5e-3
        leaves = zip(jax.tree_util.tree_leaves(got[part]),
                     jax.tree_util.tree_leaves(ref[part]))
        for a, b in leaves:
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= bar * np.abs(b).max(), part


def test_adam_update_matches_optax():
    """torch.optim.Adam's first step against optax.adam's, from the same
    parameters and gradients."""
    rng = np.random.RandomState(2)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(2)]
    opt = optax.adam(0.01)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([tp], lr=0.01)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.tensor(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)


def test_default_device_is_the_card(monkeypatch):
    """--device defaults to cuda; without a card the example raises and
    names --device cpu instead of running on the CPU unasked."""
    assert PL.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        PL.main(["--niters", "1"])
