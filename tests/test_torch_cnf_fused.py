"""PyTorch port: the fused CNF tier against the JAX package.

- The plain K2 with K7's forward (`ops/cuda_kernels.mlp_solve(rhs='cnf')`)
  and the plain K3 with K7's adjoint (`ops/cuda_adjoint.mlp_adjoint_solve(
  rhs='cnf')`) against the reference's kernels (`mlp_solve` and
  `mlp_adjoint_solve` with rhs='cnf', interpret mode, `pack=1`), float64:
  identical stats ([nfe, accepted, rejected, status]); the trajectory
  within 1e-12 (the same arithmetic; only sums over hidden units and the
  batch may take another order), the sweep's outputs within 1e-10
  relative (its batch sums add per-sample cotangents, which the reference
  sums product by product).
- `fast.cnf_log_prob_fused`, `cnf_sample_fused` (from the same base draw)
  and `cnf_log_prob_train` (values and gradients for the weights and x)
  against the reference's front ends with interpret=True: float64 with
  identical nfe, within 1e-10; float32 within 1e-4, the reference's bar
  for its fused CNF (tests/test_fused_adjoint.py:406-434, :642-685).
- The port's own contract: NaN gradients from a failing sweep, the
  reference's training chunks, the refusals.

The flow is 3 -> 8 -> 8 -> 2 (tanh) at B = 8, so each case compiles the
reference's interpret-mode kernels once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.ops import pallas_adjoint as JA, pallas_kernels as JK
from tfdiffeq_tpu_torch import NFEMeter, fast
from tfdiffeq_tpu_torch.ops import cuda_adjoint as PA, cuda_kernels as PK

F64 = torch.float64
D, H, B = 2, 8, 8


def _flow(seed=0, H=H, depth=3):
    rng = np.random.RandomState(seed)
    widths = [D + 1] + [H] * (depth - 1) + [D]
    return [(rng.randn(i, o) * 0.6 / np.sqrt(i), rng.randn(o) * 0.1)
            for i, o in zip(widths[:-1], widths[1:])]


def _both(W, dtype):
    """The weights for the reference (jnp, padded and as a list) and for
    the port (packed and as a list of tensors)."""
    jw = [(jnp.asarray(a, dtype), jnp.asarray(b, dtype)) for a, b in W]
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tw = [(torch.tensor(a, dtype=tdt), torch.tensor(b, dtype=tdt))
          for a, b in W]
    return jw, tw


def test_k7_solve_and_sweep_plain_match_reference():
    W = _flow(seed=1)
    jw, tw = _both(W, np.float64)
    wa, dims = JK.pad_mlp_weights(jw, jnp.float64)
    packed, pdims = PK.pack_mlp_weights(tw, F64)
    rng = np.random.RandomState(2)
    s0 = np.concatenate([rng.randn(B, D), np.zeros((B, 1))], axis=1)
    tau = np.array([-1.0, -0.5, 0.0])            # t = 1 -> 0, sign -1
    sign, rtol, atol = -1.0, 1e-6, 1e-8
    # f0 from the port's plain right-hand side, handed to both.
    f0 = sign * PK._cnf_net_plain(packed, pdims, "tanh")(
        torch.tensor(1.0, dtype=F64), torch.tensor(s0))
    out_j, st_j = JK.mlp_solve(
        wa, dims, jnp.asarray(s0.T), jnp.asarray(tau), 0.05, rtol, atol,
        sign, f0=jnp.asarray(f0.numpy().T), activation="tanh",
        time_input=True, rhs="cnf", interpret=True, pack=1)
    out, st = PK.mlp_solve(packed, pdims, torch.tensor(s0),
                           torch.tensor(tau), 0.05, rtol, atol, sign, f0=f0,
                           activation="tanh", time_input=True, rhs="cnf")
    assert st.tolist() == [int(v) for v in st_j]
    assert st[3].item() == 0
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(out_j).transpose(0, 2, 1),
                               rtol=1e-12, atol=1e-12)
    assert PK.mlp_solve_launches == 0              # the plain version ran

    # The sweep on that trajectory, with a cotangent on every row.
    ys = out.numpy()
    g = rng.randn(*ys.shape)
    kw = dict(activation="tanh", method="dopri5", seminorm=False)
    ay0_j, aws_j, at_j, bst_j = JA.mlp_adjoint_solve(
        wa, dims, jnp.asarray(ys.transpose(0, 2, 1)),
        jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau), 0.05, rtol,
        atol, sign, rhs="cnf", interpret=True, pack=1, **kw)
    ay0, aw, at, bst = PA.mlp_adjoint_solve(
        packed, pdims, torch.tensor(ys), torch.tensor(g), torch.tensor(tau),
        0.05, rtol, atol, sign, rhs="cnf", **kw)
    assert bst.tolist() == [int(v) for v in bst_j]
    assert bst[3].item() == 0
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_j).T,
                               rtol=1e-10, atol=1e-12)
    ref = []
    for (dW, db), (din, dout) in zip(aws_j, dims):
        ref += [np.asarray(dW)[:dout, :din].reshape(-1),
                np.asarray(db)[:dout, 0]]
    np.testing.assert_allclose(aw.numpy(), np.concatenate(ref), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(at), float(at_j), rtol=1e-10,
                               atol=1e-12)
    assert PA.mlp_adjoint_solve_launches == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_front_ends_match_reference(dtype):
    W = _flow(seed=3)
    jw, tw = _both(W, dtype)
    x = (np.random.RandomState(4).randn(B, D) * 0.8).astype(dtype)
    tdt = tw[0][0].dtype
    close = (dict(rtol=1e-10, atol=1e-12) if dtype == np.float64
             else dict(rtol=1e-4, atol=1e-4))

    # Density.
    lp_j, st_j = JF.cnf_log_prob_fused(jw, jnp.asarray(x), interpret=True)
    lp, st = fast.cnf_log_prob_fused(tw, torch.tensor(x))
    assert st.status == 0 and int(st_j.status) == 0
    if dtype == np.float64:
        assert st.nfe == int(st_j.nfe)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), **close)

    # Sampling: the port's base draw, solved by the reference's body of
    # cnf_sample_fused (its key draws other numbers).
    xs = fast.cnf_sample_fused(tw, torch.Generator().manual_seed(5), 6, D,
                               dtype=tdt)
    z = torch.randn((6, D), generator=torch.Generator().manual_seed(5),
                    dtype=tdt)
    ref = JF.solve_mlp_spec(JF.MLPSpec(activation="tanh", time_input=True),
                            jw, jnp.asarray(z.numpy()),
                            jnp.asarray([0.0, 1.0], dtype), rtol=1e-5,
                            atol=1e-7, interpret=True).ys[-1]
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref), **close)

    # Training: values and gradients for the weights and x.
    def loss_j(w, xx):
        return -jnp.mean(JF.cnf_log_prob_train(w, xx, interpret=True))

    v_j, (gw_j, gx_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        tuple(jw), jnp.asarray(x))
    tw = [(a.requires_grad_(), b.requires_grad_()) for a, b in tw]
    xt = torch.tensor(x, requires_grad=True)
    meter = NFEMeter()
    loss = -torch.mean(fast.cnf_log_prob_train(tw, xt, nfe_meter=meter))
    loss.backward()
    assert meter.f_calls == 1 and meter.b_calls == 1
    if dtype == np.float64:
        assert meter.f_nfe == int(st_j.nfe)        # the same forward solve
    np.testing.assert_allclose(float(loss), float(v_j), **close)
    scale = lambda a: max(float(np.abs(np.asarray(a)).max()), 1e-30)
    bar = 1e-10 if dtype == np.float64 else 1e-4
    for (a, b), (ga, gb) in zip(tw, gw_j):
        assert np.abs(a.grad.numpy() - np.asarray(ga)).max() <= bar * scale(ga)
        assert np.abs(b.grad.numpy() - np.asarray(gb)).max() <= bar * scale(gb)
    assert np.abs(xt.grad.numpy() - np.asarray(gx_j)).max() <= \
        bar * scale(gx_j)


def test_failing_sweep_poisons_gradients():
    """A sweep that exhausts max_num_steps returns NaN gradients (the
    reference's test_fused_adjoint_backward_failure_poisons_grads)."""
    W = _flow(seed=6)
    _, tw = _both(W, np.float64)
    tw = [(a.requires_grad_(), b.requires_grad_()) for a, b in tw]
    x = torch.tensor(np.random.RandomState(7).randn(4, D), requires_grad=True)
    meter = NFEMeter()
    lp = fast.cnf_log_prob_train(tw, x, rtol=1e-3, atol=1e-5,
                                 adjoint_rtol=1e-10, adjoint_atol=1e-12,
                                 max_num_steps=12, nfe_meter=meter)
    assert torch.isfinite(lp).all()              # the forward fits
    lp.sum().backward()
    assert meter.b_calls == 1
    for v in [x] + [p for pair in tw for p in pair]:
        assert torch.isnan(v.grad).all()


def test_training_chunks_follow_the_reference(monkeypatch):
    """Past cnf_train_block_size samples the batch runs in chunks, each its
    own forward and sweep: the log-probs are those of the chunks alone and
    the gradients add."""
    assert fast.cnf_train_block_size(2, [32, 32, 2]) == 2048
    assert fast.cnf_train_block_size(2, [64, 64, 2]) == 1024
    assert fast.cnf_train_block_size(2, [512, 2]) == 128
    W = _flow(seed=8, H=4, depth=2)
    x = np.random.RandomState(9).randn(5, D)
    monkeypatch.setattr(fast, "cnf_train_block_size", lambda d, widths: 3)

    def run(xx):
        _, tw = _both(W, np.float64)
        tw = [(a.requires_grad_(), b.requires_grad_()) for a, b in tw]
        xt = torch.tensor(xx, requires_grad=True)
        meter = NFEMeter()
        lp = fast.cnf_log_prob_train(tw, xt, nfe_meter=meter)
        lp.sum().backward()
        return lp.detach(), [xt.grad] + [p.grad for pr in tw for p in pr], \
            meter

    lp, grads, meter = run(x)
    assert meter.f_calls == 2 and meter.b_calls == 2
    parts = [run(x[:3]), run(x[3:])]
    assert torch.equal(lp, torch.cat([parts[0][0], parts[1][0]]))
    assert torch.equal(grads[0], torch.cat([parts[0][1][0],
                                            parts[1][1][0]]))
    for g, g0, g1 in zip(grads[1:], parts[0][1][1:], parts[1][1][1:]):
        torch.testing.assert_close(g, g0 + g1, rtol=1e-14, atol=1e-15)


def test_refusals():
    W = _flow(seed=10)
    _, tw = _both(W, np.float64)
    x = torch.tensor(np.random.RandomState(11).randn(4, D))
    bad = [(torch.zeros(D, H, dtype=F64), torch.zeros(H, dtype=F64))] + tw[1:]
    for fn in (fast.cnf_log_prob_fused, fast.cnf_log_prob_train):
        with pytest.raises(ValueError, match="D\\+1"):
            fn(bad, x)
    with pytest.raises(ValueError, match="adaptive"):
        fast.cnf_log_prob_fused(tw, x, method="rk4")
    packed, dims = PK.pack_mlp_weights(tw, F64)
    s = torch.zeros(4, D + 1, dtype=F64)
    tau = torch.tensor([-1.0, 0.0], dtype=F64)
    with pytest.raises(ValueError, match="f0"):
        PK.mlp_solve(packed, dims, s, tau, 0.1, 1e-6, 1e-8, -1.0, rhs="cnf")
    with pytest.raises(ValueError, match="rhs"):
        PK.mlp_solve(packed, dims, s, tau, 0.1, 1e-6, 1e-8, -1.0, f0=s,
                     rhs="conv")
    # A state that is not [z; logp] for this flow.
    s4 = torch.zeros(4, D + 2, dtype=F64)
    with pytest.raises(ValueError, match="rhs='cnf'"):
        PK.mlp_solve(packed, dims, s4, tau, 0.1, 1e-6, 1e-8, -1.0, f0=s4,
                     rhs="cnf")
    ys = torch.zeros(2, 4, D + 2, dtype=F64)
    with pytest.raises(ValueError, match="rhs='cnf'"):
        PA.mlp_adjoint_solve(packed, dims, ys, ys, tau, 0.1, 1e-6, 1e-8,
                             -1.0, rhs="cnf")
