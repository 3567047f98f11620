"""PyTorch port: the generic `odeint_adjoint` against the JAX package's, and
the options of the training path that are not ported yet (and, beside
them, the fixed-grid options that once were refused).

The same numpy inputs go to both packages and the loss is <ys, g_out>.
Gradients wrt the parameters, y0 and t agree within 1e-7 relative to each
leaf's largest entry. That bound is looser than the fused path's: the
augmented dynamics take the VJP with `torch.autograd.grad` here and
`jax.vjp` there, which sum the matmul VJPs in different orders, and a
last-bit difference in the error norm can move a step. Float64 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF, odeint_adjoint as j_odeint_adjoint
from tfdiffeq_tpu.utils.nfe import NFEMeter as JMeter
import tfdiffeq_tpu_torch as P
from tfdiffeq_tpu_torch import convert, fast as PF
from tfdiffeq_tpu_torch.examples import latent_ode as PL

BAR = 1e-7


def _mlp(dims, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(a, b) * 0.3 / np.sqrt(a), rng.randn(b) * 0.05)
            for a, b in zip(dims[:-1], dims[1:])]


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= BAR * np.abs(ref).max(), (err, np.abs(ref).max())


def _concat_t(mlp_apply, spec):
    """Time-dependent dynamics: the MLP on [y, t]."""
    def f(t, y, w):
        return mlp_apply(spec, w, y, t)
    return f


CASES = {
    "elu": dict(dims=(4, 20, 20, 4), act="elu", ti=False, reverse=False,
                seminorm=False, adjoint_method=None),
    # Seminorm, decreasing t and a backward tableau other than the
    # forward's.
    "seminorm_reverse_bosh3": dict(dims=(3, 16, 3), act="tanh", ti=False,
                                   reverse=True, seminorm=True,
                                   adjoint_method="bosh3"),
    # Dynamics that read t: the a_t quadrature feeds ts_bar[0].
    "time_dependent": dict(dims=(3, 12, 2), act="softplus", ti=True,
                           reverse=False, seminorm=False,
                           adjoint_method="tsit5"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_odeint_adjoint_matches_reference(name):
    c = CASES[name]
    W = _mlp(c["dims"], seed=len(name))
    rng = np.random.RandomState(7)
    D = c["dims"][-1]
    y0 = rng.randn(8, D)
    t = np.linspace(0.0, 1.5, 5)
    if c["reverse"]:
        t = t[::-1].copy()
    g = rng.randn(5, 8, D)
    kw = dict(rtol=1e-7, atol=1e-9, method="dopri5",
              adjoint_method=c["adjoint_method"],
              adjoint_seminorm=c["seminorm"], return_stats=True)

    jspec = JF.MLPSpec(activation=c["act"], time_input=c["ti"])
    jmeter = JMeter()

    def jloss(w, y, tt):
        ys, st = j_odeint_adjoint(_concat_t(JF.mlp_apply, jspec), y, tt,
                                  params=w, nfe_meter=jmeter, **kw)
        return jnp.sum(ys * g), st

    jw = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in W)
    (_, jst), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(
        jw, jnp.asarray(y0), jnp.asarray(t))
    jax.effects_barrier()

    pspec = PF.MLPSpec(activation=c["act"], time_input=c["ti"])
    pw = tuple((torch.tensor(a, requires_grad=True),
                torch.tensor(b, requires_grad=True)) for a, b in W)
    py0 = torch.tensor(y0, requires_grad=True)
    pt = torch.tensor(t, requires_grad=True)
    pmeter = P.NFEMeter()
    ys, pst = P.odeint_adjoint(_concat_t(PF.mlp_apply, pspec), py0, pt,
                               params=pw, nfe_meter=pmeter, **kw)
    torch.sum(ys * torch.tensor(g)).backward()

    for (pa, pb), (ja, jb) in zip(pw, jg[0]):
        _close(pa.grad, ja)
        _close(pb.grad, jb)
    _close(py0.grad, jg[1])
    _close(pt.grad, jg[2])
    if c["ti"]:
        assert abs(float(pt.grad[0])) > 0.0
    assert list(pst) == [int(s) for s in jst] and pst.status == 0
    assert pmeter.f_calls == pmeter.b_calls == 1 and pmeter.b_nfe > 0
    if jmeter.disabled_reason is None:
        assert pmeter.snapshot() == jmeter.snapshot()


def test_module_parameters_are_the_adjoint_parameters():
    """An nn.Module `func(t, y)` gets gradients on its own parameters (the
    torchdiffeq idiom), equal to the reference's explicit-params ones."""
    W = _mlp((2, 16, 2), seed=3)
    flax_like = {"params": {"Dense_0": {"kernel": W[0][0], "bias": W[0][1]},
                            "Dense_1": {"kernel": W[1][0],
                                        "bias": W[1][1]}}}
    func = convert.ode_func_from_flax(flax_like, dtype=torch.float64)
    rng = np.random.RandomState(8)
    y0 = rng.randn(6, 2)
    t = np.linspace(0.0, 1.0, 4)
    g = rng.randn(4, 6, 2)
    spec = JF.MLPSpec(activation="tanh", input_power=3)

    def jloss(w, y):
        ys = j_odeint_adjoint(lambda tt, yy, p: JF.mlp_apply(spec, p, yy),
                              y, jnp.asarray(t), params=w, rtol=1e-7,
                              atol=1e-9)
        return jnp.sum(ys * g)

    jg = jax.grad(jloss, argnums=(0, 1))(
        tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in W),
        jnp.asarray(y0))
    py0 = torch.tensor(y0, requires_grad=True)
    ys = P.odeint_adjoint(func, py0, torch.tensor(t), rtol=1e-7, atol=1e-9)
    torch.sum(ys * torch.tensor(g)).backward()
    _close(func.dense_0.weight.grad.t(), jg[0][0][0])
    _close(func.dense_0.bias.grad, jg[0][0][1])
    _close(func.dense_1.weight.grad.t(), jg[0][1][0])
    _close(func.dense_1.bias.grad, jg[0][1][1])
    _close(py0.grad, jg[1])


def test_tuple_state_and_dict_params_match_reference():
    """A tuple state and a dict of parameters (leaves in sorted-key order
    on both sides)."""
    rng = np.random.RandomState(11)
    p_np = {"b_mat": rng.randn(3, 3) * 0.4, "a_mat": rng.randn(3, 3) * 0.4}
    u0, v0 = rng.randn(5, 3), rng.randn(5, 3)
    t = np.linspace(0.0, 1.0, 4)
    gu, gv = rng.randn(4, 5, 3), rng.randn(4, 5, 3)

    def jf(tt, y, p):
        u, v = y
        return (jnp.tanh(v @ p["a_mat"]), -u @ p["b_mat"])

    def pf(tt, y, p):
        u, v = y
        return (torch.tanh(v @ p["a_mat"]), -u @ p["b_mat"])

    def jloss(p, u, v):
        yu, yv = j_odeint_adjoint(jf, (u, v), jnp.asarray(t), params=p,
                                  rtol=1e-7, atol=1e-9)
        return jnp.sum(yu * gu) + jnp.sum(yv * gv)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(u0),
        jnp.asarray(v0))
    pp = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    pu = torch.tensor(u0, requires_grad=True)
    pv = torch.tensor(v0, requires_grad=True)
    yu, yv = P.odeint_adjoint(pf, (pu, pv), torch.tensor(t), params=pp,
                              rtol=1e-7, atol=1e-9)
    (torch.sum(yu * torch.tensor(gu))
     + torch.sum(yv * torch.tensor(gv))).backward()
    for k in p_np:
        _close(pp[k].grad, jg[0][k])
    _close(pu.grad, jg[1])
    _close(pv.grad, jg[2])


def test_failed_forward_raises():
    func = lambda t, y: y * y
    with pytest.raises(RuntimeError, match="MAX_STEPS_REACHED"):
        P.odeint_adjoint(func, torch.ones(3, dtype=torch.float64),
                         torch.tensor([0.0, 5.0], dtype=torch.float64),
                         options={"max_num_steps": 3})


def test_reduced_dot_precision_is_refused():
    with pytest.raises(ValueError, match="dot_precision"):
        P.odeint_adjoint(lambda t, y: -y, torch.ones(2),
                         torch.tensor([0.0, 1.0]),
                         options={"dot_precision": "mixed"})


def _spec_call(**kw):
    spec = PF.MLPSpec(activation="tanh")
    w = [(torch.zeros(2, 4), torch.zeros(4)), (torch.zeros(4, 2), None)]
    return lambda: PF.odeint_adjoint_mlp(spec, w, torch.ones(3, 2),
                                         torch.tensor([0.0, 1.0]), **kw)


def _generic_call(**kw):
    return lambda: P.odeint_adjoint(lambda t, y: -y, torch.ones(2),
                                    torch.tensor([0.0, 1.0]), **kw)


def _interpolated_trains():
    """The generic odeint_adjoint with adjoint_mode='interpolated': d
    sum(y(1)) / dy0 of dy/dt = -y is close to exp(-1), and equal to the
    reference's within 1e-9 on the same inputs."""
    y0 = torch.ones(2, dtype=torch.float64, requires_grad=True)
    ys = P.odeint_adjoint(lambda t, y: -y, y0,
                          torch.tensor([0.0, 1.0], dtype=torch.float64),
                          adjoint_mode="interpolated")
    ys[-1].sum().backward()
    np.testing.assert_allclose(y0.grad.numpy(), np.exp(-1.0), rtol=1e-6)
    ref = jax.grad(lambda y: jnp.sum(j_odeint_adjoint(
        lambda t, yy: -yy, y, jnp.asarray([0.0, 1.0]),
        adjoint_mode="interpolated")[-1]))(jnp.ones(2, jnp.float64))
    np.testing.assert_allclose(y0.grad.numpy(), np.asarray(ref), rtol=1e-9)


def _adams_trains():
    """The generic odeint_adjoint with a fixed_adams forward (once refused
    here, ROADMAP item 12) trains: d sum(y(1)) / dy0 of dy/dt = -y is
    close to exp(-1) (tests/test_torch_adams.py holds the Adams adjoint
    paths to direct gradients)."""
    y0 = torch.ones(2, dtype=torch.float64, requires_grad=True)
    ys = P.odeint_adjoint(lambda t, y: -y, y0,
                          torch.tensor([0.0, 1.0], dtype=torch.float64),
                          method="fixed_adams",
                          options={"num_steps": 50})
    ys[-1].sum().backward()
    np.testing.assert_allclose(y0.grad.numpy(), np.exp(-1.0), rtol=1e-6)


def _trains_with(options):
    """odeint_adjoint with `options` (fuse, per_sample: once refused here,
    ROADMAP item 16) trains without a fallback: d sum(y(1)) / dy0 of
    dy/dt = -y is close to exp(-1) (tests/test_torch_fused_adjoint.py
    holds the fused route to the reference's gradients)."""
    def call():
        before = PF.fuse_fallbacks
        y0 = torch.ones(3, 2, dtype=torch.float64, requires_grad=True)
        ys = P.odeint_adjoint(lambda t, y: -y, y0,
                              torch.tensor([0.0, 1.0], dtype=torch.float64),
                              options=options)
        ys[-1].sum().backward()
        np.testing.assert_allclose(y0.grad.numpy(), np.exp(-1.0),
                                   rtol=1e-6)
        assert PF.fuse_fallbacks == before
    return call


def _train_dir_resumes():
    import contextlib
    import io
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        argv = ["--train_dir", d, "--niters", "1", "--nspiral", "4",
                "--ntimes", "40", "--nsample", "8", "--device", "cpu"]
        PL.main(argv)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            PL.main(argv)
        assert f"resumed from {d} at iter 1" in out.getvalue()


@pytest.mark.parametrize("call, exc, match", [
    # adjoint_mode='interpolated' (once refused here, ROADMAP item 3)
    # trains (tests/test_torch_interpolated.py holds it to the reference).
    (_interpolated_trains, None, None),
    (_trains_with({"fuse": True}), None, None),
    (_adams_trains, None, None),
    (_trains_with({"per_sample": True}), None, None),
    # No adjoint kernel exists for the Adams family in either package.
    (_spec_call(adjoint_method="adams"), ValueError,
     "adjoint_method='adams'"),
    # --train_dir (once refused here, ROADMAP item 19) saves and resumes
    # (tests/test_torch_checkpoint.py holds the resume bit for bit).
    (_train_dir_resumes, None, None),
    (lambda: PL.main(["--dp", "--niters", "1"]), NotImplementedError,
     "item 18"),
], ids=["interpolated", "fuse", "adams", "per_sample", "fused_adams",
        "train_dir", "dp"])
def test_unported_options_raise(call, exc, match):
    if exc is None:
        call()
        return
    with pytest.raises(exc, match=match):
        call()


@pytest.mark.parametrize("fused, kw, grad", [
    (False, dict(method="rk4"), 0.375),
    (False, dict(adjoint_method="euler"), 0.0),
    (True, dict(num_steps=4), np.exp(-1.0)),
    (True, dict(method="rk4"), 0.375),
], ids=["fixed_forward", "fixed_adjoint", "num_steps", "fused_fixed"])
def test_fixed_grid_training_options_run(fused, kw, grad):
    """The fixed-grid options these calls once refused (ROADMAP items 4, 5
    and 11) now train. On dy/dt = -y over one unit interval, the forward
    matches the generic solve and d sum(y(1)) / dy0 is the adjoint
    method's one-step factor: 1 - 1 + 1/2 - 1/6 + 1/24 = 0.375 for rk4, 0
    for euler, exp(-1) for dopri5, which ignores num_steps
    (tests/test_torch_adjoint_fixed.py and test_torch_fixed_fused.py hold
    these paths to the reference)."""
    y0 = torch.ones(3, 2, dtype=torch.float64, requires_grad=True)
    t = torch.tensor([0.0, 1.0], dtype=torch.float64)
    if fused:
        spec = PF.MLPSpec(activation="identity")
        w = [(-torch.eye(2, dtype=torch.float64), None)]
        ys = PF.odeint_adjoint_mlp(spec, w, y0, t, **kw)
    else:
        ys = P.odeint_adjoint(lambda tt, y: -y, y0, t, **kw)
    ys[-1].sum().backward()
    method = kw.get("method", "dopri5")
    ref = P.solve(lambda tt, y: -y, torch.ones(3, 2, dtype=torch.float64), t,
                  method=method, rtol=1e-6 if fused else 1e-7,
                  atol=1e-8 if fused else 1e-9)
    np.testing.assert_allclose(ys.detach().numpy(), ref.ys.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(y0.grad.numpy(), grad, rtol=1e-5,
                               atol=1e-15)
