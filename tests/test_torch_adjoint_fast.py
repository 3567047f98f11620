"""PyTorch port: `fast.odeint_adjoint_mlp` (forward K2, backward K3, their
plain versions on the CPU) against the JAX package's
`fast.odeint_adjoint_mlp` (Pallas in interpret mode).

The same numpy weights, states, times and output cotangents go to both,
and the loss is <ys, g_out>. Float64: gradients wrt the weights, y0 and t
agree within 1e-9 relative to each leaf's largest entry (the same
arithmetic; only the order of the batch sums differs), and the forward and
backward counts are identical. Float32: within 1e-3 relative, the bar of
tests/test_fused_adjoint.py. Each case compiles the reference's forward and
backward kernels once (about 20 s on the CPU), so each is computed once in
a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.utils.nfe import NFEMeter as JMeter
from tfdiffeq_tpu_torch import NFEMeter, fast as PF

CASES = {
    # The latent ODE's ELU dynamics.
    "dopri5_elu": dict(dims=(4, 20, 20, 4), act="elu", power=1, ti=False,
                       method="dopri5", adjoint_method=None, seminorm=False,
                       reverse=False, no_bias=None, dtype="float64",
                       rtol=1e-7, atol=1e-9),
    # Concat-t dynamics (a_t and the t-column gradient), decreasing t, a
    # bias-free layer, seminorm, and a backward tableau other than the
    # forward's.
    "bosh3_tsit5_time_reverse": dict(
        dims=(3, 16, 2), act="tanh", power=1, ti=True, method="bosh3",
        adjoint_method="tsit5", seminorm=True, reverse=True, no_bias=0,
        dtype="float64", rtol=1e-6, atol=1e-8),
    # The spiral's MLP on y**3 in float32.
    "dopri5_spiral_f32": dict(dims=(2, 50, 2), act="tanh", power=3,
                              ti=False, method="dopri5",
                              adjoint_method=None, seminorm=False,
                              reverse=False, no_bias=None, dtype="float32",
                              rtol=1e-6, atol=1e-6),
}


def _problem(c, seed=4, B=12, T=7):
    rng = np.random.RandomState(seed)
    dims = c["dims"]
    W = []
    for l, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        W.append((rng.randn(a, b) * 0.3 / np.sqrt(a),
                  None if l == c["no_bias"] else rng.randn(b) * 0.05))
    D = dims[-1]
    y0 = rng.randn(B, D)
    t = np.linspace(0.0, 2.0, T)
    if c["reverse"]:
        t = t[::-1].copy()
    g = rng.randn(T, B, D)
    return W, y0, t, g


def _opts(c, **extra):
    return dict(rtol=c["rtol"], atol=c["atol"], method=c["method"],
                adjoint_method=c["adjoint_method"],
                adjoint_seminorm=c["seminorm"], **extra)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both packages' gradients, stats and meters for one case."""
    c = CASES[request.param]
    W, y0, t, g = _problem(c)
    jdt = getattr(jnp, c["dtype"])
    jspec = JF.MLPSpec(activation=c["act"], input_power=c["power"],
                       time_input=c["ti"])
    jmeter = JMeter()

    def jloss(w, y, tt):
        ys, st = JF.odeint_adjoint_mlp(jspec, w, y, tt, interpret=True,
                                       nfe_meter=jmeter, return_stats=True,
                                       **_opts(c))
        return jnp.sum(ys * jnp.asarray(g, jdt)), st

    jw = tuple((jnp.asarray(a, jdt), None if b is None else jnp.asarray(b,
                                                                      jdt))
               for a, b in W)
    (_, jst), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(
        jw, jnp.asarray(y0, jdt), jnp.asarray(t, jdt))
    jax.effects_barrier()

    pdt = getattr(torch, c["dtype"])
    pspec = PF.MLPSpec(activation=c["act"], input_power=c["power"],
                       time_input=c["ti"])
    pw = [(torch.tensor(a, dtype=pdt, requires_grad=True),
           None if b is None else torch.tensor(b, dtype=pdt,
                                               requires_grad=True))
          for a, b in W]
    py0 = torch.tensor(y0, dtype=pdt, requires_grad=True)
    pt = torch.tensor(t, dtype=pdt, requires_grad=True)
    pmeter = NFEMeter()
    ys, pst = PF.odeint_adjoint_mlp(pspec, pw, py0, pt, nfe_meter=pmeter,
                                    return_stats=True, **_opts(c))
    torch.sum(ys * torch.tensor(g, dtype=pdt)).backward()

    ref = [x for pair in jg[0] for x in pair if x is not None]
    got = [x.grad for pair in pw for x in pair if x is not None]
    return {"c": c, "ref": ref + [jg[1], jg[2]],
            "got": got + [py0.grad, pt.grad], "jst": jst, "pst": pst,
            "jmeter": jmeter, "pmeter": pmeter}


def test_gradients_match_reference(case):
    bar = 1e-9 if case["c"]["dtype"] == "float64" else 1e-3
    assert len(case["got"]) == len(case["ref"])
    for got, ref in zip(case["got"], case["ref"]):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        err = np.abs(got.detach().numpy() - ref).max()
        assert err <= bar * np.abs(ref).max(), (err, np.abs(ref).max())


def test_stats_and_meter_match_reference(case):
    assert case["pst"].status == 0
    assert case["pmeter"].f_calls == case["pmeter"].b_calls == 1
    assert case["pmeter"].f_nfe == case["pst"].nfe
    assert case["pmeter"].b_nfe > 0 and case["pmeter"].b_steps > 0
    if case["c"]["dtype"] == "float64":
        assert list(case["pst"]) == [int(s) for s in case["jst"]]
        if case["jmeter"].disabled_reason is None:
            assert case["pmeter"].snapshot() == case["jmeter"].snapshot()


def test_failed_sweep_poisons_gradients():
    """A max_num_steps budget too small for the sweep: NaN gradients, as
    the reference returns."""
    c = CASES["dopri5_elu"]
    W, y0, t, g = _problem(c)
    spec = PF.MLPSpec(activation="elu")
    pw = [(torch.tensor(a, requires_grad=True),
           torch.tensor(b, requires_grad=True)) for a, b in W]
    py0 = torch.tensor(y0, requires_grad=True)
    ys, st = PF.odeint_adjoint_mlp(spec, pw, py0, torch.tensor(t),
                                   rtol=1e-9, atol=1e-11, max_num_steps=4,
                                   return_stats=True)
    torch.sum(ys * torch.tensor(g)).backward()
    assert st.status == 1
    for x in [py0] + [p for pair in pw for p in pair]:
        assert torch.isnan(x.grad).all()


def test_fused_matches_generic_adjoint_f64():
    """The port's two training paths agree (tests/test_fused_adjoint.py's
    check, here in float64 and held to 1e-5: the two sweeps step
    differently, so they agree to the tolerance, not the bit)."""
    from tfdiffeq_tpu_torch import odeint_adjoint
    c = CASES["dopri5_elu"]
    W, y0, t, g = _problem(c, seed=9)
    spec = PF.MLPSpec(activation="elu")
    grads = []
    for fused in (True, False):
        pw = [(torch.tensor(a, requires_grad=True),
               torch.tensor(b, requires_grad=True)) for a, b in W]
        py0 = torch.tensor(y0, requires_grad=True)
        pt = torch.tensor(t, requires_grad=True)
        if fused:
            ys = PF.odeint_adjoint_mlp(spec, pw, py0, pt, rtol=1e-9,
                                       atol=1e-11)
        else:
            ys = odeint_adjoint(lambda tt, yy, w: PF.mlp_apply(spec, w, yy),
                                py0, pt, params=pw, rtol=1e-9, atol=1e-11)
        torch.sum(ys * torch.tensor(g)).backward()
        grads.append([x.grad for pair in pw for x in pair]
                     + [py0.grad, pt.grad])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
