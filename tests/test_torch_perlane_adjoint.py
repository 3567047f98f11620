"""PyTorch port: the per-sample training tier against the JAX package.

- The plain K6 (`ops/cuda_perlane.mlp_perlane_adjoint_solve` on CPU
  tensors) against the JAX `pallas_adjoint.mlp_perlane_adjoint_solve(...,
  interpret=True)`, float64: identical per-sample counts; ay0, the weight
  cotangents and a_t within 1e-9 relative to each output's largest entry
  (the port sums each sample's quadrature over its accepted steps before
  it sums over the batch, the reference each stage over the batch first).
- `fast.odeint_adjoint_mlp(per_sample=True)` (K5 forward, K6 backward)
  gradients wrt the weights, y0 and t against the JAX front-end: 1e-9 in
  float64 with identical forward and backward counts, 1e-3 in float32
  (tests/test_fused_adjoint.py's bar), with a time column for d/dt.
- The reference's known fault (ROADMAP, "Known faults", High,
  `pallas_adjoint.py:848-866`): one sample's rejected first trial
  overflows while the others accept. The reference's sums turn NaN with
  status 0; the port's stay finite and equal a per-sample loop of the
  port's generic `odeint_adjoint`.

Each JAX reference compiles once, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.ops import pallas_adjoint as JA, pallas_kernels as JK
from tfdiffeq_tpu.utils.nfe import NFEMeter as JMeter
from tfdiffeq_tpu_torch import NFEMeter, fast as PF, odeint_adjoint
from tfdiffeq_tpu_torch.ops import cuda_kernels as PK, cuda_perlane as PL

F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _weights(dims, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(a, b) * scale / np.sqrt(a), rng.randn(b) * 0.05)
            for a, b in zip(dims[:-1], dims[1:])]


def _ref_aw(aws, dims):
    """The reference's padded (dW [dout, din], db [dout, 1]) per layer in
    pack_mlp_weights' layout."""
    return np.concatenate(
        [np.concatenate([np.asarray(dW)[:b, :a].reshape(-1),
                         np.asarray(db)[:b, 0]])
         for (dW, db), (a, b) in zip(aws, zip(dims[:-1], dims[1:]))])


# name: (dims, activation, power, time_input, method, sign)
K6_CASES = {
    "spiral_dopri5": ((2, 8, 2), "tanh", 3, False, "dopri5", 1.0),
    "elu_time_bosh3_reverse": ((3, 8, 8, 2), "elu", 1, True, "bosh3", -1.0),
}


@pytest.fixture(scope="module", params=sorted(K6_CASES))
def k6(request):
    dims, act, power, ti, method, sign = K6_CASES[request.param]
    W = _weights(dims, seed=1, scale=1.0)
    rng = np.random.RandomState(2)
    T, B, D = 5, 12, dims[-1]
    ys = rng.randn(T, B, D) * np.linspace(0.2, 2.0, B)[None, :, None]
    g = rng.randn(T, B, D)
    tau = np.array([0.0, 0.4, 0.5, 1.2, 2.0])
    dt0 = np.linspace(0.02, 0.1, B)
    kw = dict(activation=act, input_power=power, time_input=ti,
              method=method)
    jw, jd = JK.pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                                 for a, b in W], jnp.float64)
    ref = JA.mlp_perlane_adjoint_solve(
        jw, jd, jnp.asarray(ys.transpose(0, 2, 1)),
        jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau),
        jnp.asarray(dt0), 1e-6, 1e-8, sign, interpret=True, **kw)
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], F64)
    got = PL.mlp_perlane_adjoint_solve(pw, pd, torch.tensor(ys),
                                       torch.tensor(g), torch.tensor(tau),
                                       torch.tensor(dt0), 1e-6, 1e-8, sign,
                                       **kw)
    return dims, ti, ref, got


def test_plain_perlane_adjoint_matches_reference(k6):
    dims, ti, ref, got = k6
    j_ay0, j_aws, j_at, j_st, j_lane = ref
    ay0, aw, at, st, lane = got
    np.testing.assert_array_equal(lane.numpy(), np.asarray(j_lane))
    assert st.tolist() == [int(x) for x in j_st] and st[3].item() == 0
    assert len(set(lane[0].tolist())) > 3
    assert _rel(ay0.numpy(), np.asarray(j_ay0).T) < 1e-9
    assert _rel(aw.numpy(), _ref_aw(j_aws, dims)) < 1e-9
    if ti:
        assert abs(float(at) - float(j_at)) <= 1e-9 * abs(float(j_at))
    else:
        assert float(at) == 0.0 == float(j_at)


# name: (dtype, time_input, reverse)
TRAIN_CASES = {"f64_time_reverse": ("float64", True, True),
               "f32_spiral": ("float32", False, False)}


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def train(request):
    dtype, ti, reverse = TRAIN_CASES[request.param]
    dims = (2 + int(ti), 8, 2)
    W = _weights(dims, seed=4, scale=1.2)
    rng = np.random.RandomState(5)
    B, T = 12, 6
    y0 = rng.randn(B, 2) * np.linspace(0.2, 2.0, B)[:, None]
    t = np.linspace(0.0, 1.5, T)
    if reverse:
        t = t[::-1].copy()
    g = rng.randn(T, B, 2)
    opts = dict(rtol=1e-6, atol=1e-8, per_sample=True)
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    jspec = JF.MLPSpec(activation="tanh", input_power=1 if ti else 3,
                       time_input=ti)
    pspec = PF.MLPSpec(activation="tanh", input_power=1 if ti else 3,
                       time_input=ti)
    jmeter = JMeter()

    def jloss(w, y, tt):
        ys = JF.odeint_adjoint_mlp(jspec, w, y, tt, interpret=True,
                                   nfe_meter=jmeter, **opts)
        return jnp.sum(ys * jnp.asarray(g, jdt))

    jw = tuple((jnp.asarray(a, jdt), jnp.asarray(b, jdt)) for a, b in W)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jw, jnp.asarray(y0, jdt),
                                              jnp.asarray(t, jdt))
    jax.effects_barrier()

    pmeter = NFEMeter()
    pw = [(torch.tensor(a, dtype=pdt, requires_grad=True),
           torch.tensor(b, dtype=pdt, requires_grad=True)) for a, b in W]
    py0 = torch.tensor(y0, dtype=pdt, requires_grad=True)
    pt = torch.tensor(t, dtype=pdt, requires_grad=True)
    ys, st = PF.odeint_adjoint_mlp(pspec, pw, py0, pt, nfe_meter=pmeter,
                                   return_stats=True, **opts)
    torch.sum(ys * torch.tensor(g, dtype=pdt)).backward()
    got = [x.grad for pair in pw for x in pair] + [py0.grad, pt.grad]
    return dtype, jax.tree_util.tree_leaves(jg), got, st, jmeter, pmeter


def test_per_sample_training_gradients_match_reference(train):
    dtype, ref, got, st, _, _ = train
    bar = 1e-9 if dtype == "float64" else 1e-3
    assert st.status == 0 and len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == np.shape(b) and torch.isfinite(a).all()
        assert _rel(a.detach().numpy(), b) <= bar


def test_per_sample_training_counts_match_reference(train):
    dtype, _, _, st, jmeter, pmeter = train
    assert pmeter.f_calls == pmeter.b_calls == 1
    assert pmeter.f_nfe == st.nfe and pmeter.b_nfe > 0
    if dtype == "float64":
        assert pmeter.snapshot() == jmeter.snapshot()


def test_failed_per_sample_sweep_poisons_gradients():
    """A max_num_steps budget that the forward keeps and the far tighter
    backward tolerance exhausts: NaN gradients, as on the shared-controller
    path."""
    W = _weights((2, 16, 2), seed=4, scale=1.2)
    pw = [(torch.tensor(a, requires_grad=True),
           torch.tensor(b, requires_grad=True)) for a, b in W]
    py0 = torch.tensor(np.random.RandomState(5).randn(6, 2),
                       requires_grad=True)
    t = torch.linspace(0.0, 1.5, 4, dtype=F64)
    ys, st = PF.odeint_adjoint_mlp(PF.MLPSpec(input_power=3), pw, py0, t,
                                   rtol=1e-5, atol=1e-7, adjoint_rtol=1e-12,
                                   adjoint_atol=1e-14, max_num_steps=40,
                                   per_sample=True, return_stats=True)
    torch.sum(ys).backward()
    assert st.status == 0
    for x in [py0] + [p for pair in pw for p in pair]:
        assert torch.isnan(x.grad).all()


# The reference's fault: f(y) = -0.1 tanh(100 y). Sample 0 sits in the
# linear regime, stiff (df/dy = -10), with a cotangent near the float64
# limit; samples 1 and 2 sit in tanh's flat tail (df/dy = 0). A backward
# first step of the whole interval (0.8) lets the flat samples accept it,
# while sample 0's trial (dt df/dy = -8) overflows in its stages: it is
# rejected and retried with smaller steps, and its status stays 0.
FAULT_W = [(np.array([[100.0]]), np.zeros(1)),
           (np.array([[-0.1]]), np.zeros(1))]
FAULT_Y0 = np.array([[1e-3], [1.0], [0.5]])
FAULT_T = np.array([0.0, 0.8])
FAULT_G = np.array([[[0.0], [0.0], [0.0]], [[5e306], [1.0], [-2.0]]])
FAULT_TOL = dict(rtol=1e-9, atol=1e-14)


def test_overflowing_rejected_trial_is_a_known_fault_of_the_reference():
    """On the same inputs the reference's sums are NaN with status 0 (it
    weights every sample's stage cotangent by accept x dt x b, and an
    overflowed stage gives Inf x 0); the port's are finite, with the same
    per-sample counts."""
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in FAULT_W], F64)
    spec = PF.MLPSpec(activation="tanh")
    ys = PF.solve_mlp_spec(spec, [(torch.tensor(a), torch.tensor(b))
                                  for a, b in FAULT_W],
                           torch.tensor(FAULT_Y0), torch.tensor(FAULT_T),
                           per_sample=True, **FAULT_TOL).ys
    got = PL.mlp_perlane_adjoint_solve(pw, pd, ys, torch.tensor(FAULT_G),
                                       torch.tensor(FAULT_T), 0.8,
                                       FAULT_TOL["rtol"], FAULT_TOL["atol"],
                                       1.0)
    jw, jd = JK.pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                                 for a, b in FAULT_W], jnp.float64)
    ref = JA.mlp_perlane_adjoint_solve(
        jw, jd, jnp.asarray(ys.numpy().transpose(0, 2, 1)),
        jnp.asarray(FAULT_G.transpose(0, 2, 1)), jnp.asarray(FAULT_T), 0.8,
        FAULT_TOL["rtol"], FAULT_TOL["atol"], 1.0, interpret=True)
    # Sample 0 rejected at least its first trial; every sample finished.
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4])[:, :3])
    assert got[4][2, 0].item() > 0 and got[3][3].item() == 0
    assert int(ref[3][3]) == 0
    # The known fault: NaN in the reference's weight cotangents.
    assert np.isnan(_ref_aw(ref[1], (1, 1, 1))).all()
    assert torch.isfinite(got[1]).all() and torch.isfinite(got[0]).all()


def test_overflowing_rejected_trial_matches_the_generic_adjoint():
    """The port's per-sample gradients on the fault's input equal a loop of
    the port's generic `odeint_adjoint` over the samples, at the solve
    tolerance. The generic engine's first backward step cannot take
    sample 0's cotangent of 5e306 (its HNW norms overflow), so each sample
    runs with its cotangent scaled to 1 and the gradients are scaled
    back: the adjoint is linear in the cotangent."""
    spec = PF.MLPSpec(activation="tanh")

    def leaves():
        w = [(torch.tensor(a, requires_grad=True),
              torch.tensor(b, requires_grad=True)) for a, b in FAULT_W]
        return w, torch.tensor(FAULT_Y0, requires_grad=True)

    w, y0 = leaves()
    ys = PF.odeint_adjoint_mlp(spec, w, y0, torch.tensor(FAULT_T),
                               per_sample=True, adjoint_first_step=0.8,
                               **FAULT_TOL)
    torch.sum(ys * torch.tensor(FAULT_G)).backward()
    got = [x.grad for pair in w for x in pair] + [y0.grad]

    ref = [torch.zeros_like(x) for x in got]
    for b in range(FAULT_Y0.shape[0]):
        w, y0 = leaves()
        scale = float(np.abs(FAULT_G[:, b]).max())
        ys = odeint_adjoint(lambda tt, yy, ww: PF.mlp_apply(spec, ww, yy),
                            y0[b:b + 1], torch.tensor(FAULT_T), params=w,
                            adjoint_seminorm=True, **FAULT_TOL)
        torch.sum(ys * torch.tensor(FAULT_G[:, b:b + 1] / scale)).backward()
        for r, x in zip(ref, [x.grad for pair in w for x in pair]
                        + [y0.grad]):
            r += scale * x
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert _rel(a.numpy(), b.numpy()) < 1e-6
