"""PyTorch port: the dot-precision tiers (K4) against the JAX package.

The net is D = 32 -> H = 144 -> 144 -> 32 with tanh, so under
matmul='auto' every layer is selected for a reduced tier and crosses the
narrow route's 128. On the CPU the port's K2 and K8 run their plain
versions, whose tier layers take `ops/cuda_kernels.dot_tier_plain`; the
reference runs its Pallas kernels in interpret mode, as
tests/test_mixed_precision.py does.

- 'mixed' against the reference's 'mixed' (dopri5 at rtol 1e-4, rk4 at 64
  steps, float32): trajectories within 1e-5 relative to their largest
  entry, accepted and rejected counts within one. Both solve the
  bf16-weight model with dots good to about 2^-16; the remaining gap is the
  order of the float32 sums (the reference's dots are XLA's, the port sums
  in input order), which can also move one activation's bf16 rounding.
- The reference's own checks of 'mixed' (tests/test_mixed_precision.py):
  the bf16-weight model within 5e-5 of 'highest' on pre-quantized weights,
  more than 1e-4 from the float32-weight run.
- 'bf16': the plain product is the float32 sum of exact products of
  bf16-rounded operands. No comparison with the reference is possible on
  the CPU: there its 'bf16' is Mosaic's default dot, which computes exact
  float32 (tests/test_mixed_precision.py:11-13). The port's 'bf16'
  trajectory stays within 1e-2 of 'highest' (relative to its largest
  entry) and differs from it.
- K4 alone (`cuda_kernels.tier_net`) against the reference's `_make_net`
  on the same inputs, with and without the time column.
- The policy of `matmul` and the tier gates, `calibrate_dot_precision`
  against the reference's, and the training path with a 'mixed' forward.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu_torch import convert, fast as PF
from tfdiffeq_tpu_torch.ops import cuda_kernels as PK

D, H, B = 32, 144, 24
F32 = torch.float32


def _wide(seed=0, bias=0.0):
    rng = np.random.RandomState(seed)
    dims = (D, H, H, D)
    W = [(rng.randn(dims[i], dims[i + 1]) / np.sqrt(dims[i]),
          rng.randn(dims[i + 1]) * bias) for i in range(3)]
    return W, rng.randn(B, D) * 0.5


T = np.linspace(0.0, 2.0, 5)


def _jax(prec, W, y0, method, **kw):
    spec = JF.MLPSpec(activation="tanh", matmul="auto", dot_precision=prec)
    w = [(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
         for a, b in W]
    return JF.solve_mlp_spec(spec, w, jnp.asarray(y0, jnp.float32),
                             jnp.asarray(T, jnp.float32), method=method,
                             interpret=True, **kw)


def _port(prec, W, y0, method, matmul="auto", **kw):
    spec = PF.MLPSpec(activation="tanh", matmul=matmul, dot_precision=prec)
    return PF.solve_mlp_spec(spec, convert.weights_from_jax(W),
                             torch.tensor(y0, dtype=F32),
                             torch.tensor(T, dtype=F32), method=method, **kw)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


SOLVES = {"dopri5": dict(rtol=1e-4, atol=1e-4, first_step=0.01),
          "rk4": dict(num_steps=64)}


@pytest.mark.parametrize("method", sorted(SOLVES))
def test_mixed_matches_reference(method):
    W, y0 = _wide()
    ref = _jax("mixed", W, y0, method, **SOLVES[method])
    got = _port("mixed", W, y0, method, **SOLVES[method])
    assert got.stats.status == 0 and int(ref.stats.status) == 0
    assert got.stats.nfe == int(ref.stats.nfe) or method == "dopri5"
    assert abs(got.stats.n_accepted - int(ref.stats.n_accepted)) <= 1
    assert abs(got.stats.n_rejected - int(ref.stats.n_rejected)) <= 1
    assert _rel(got.ys.numpy(), ref.ys) < 1e-5


def test_mixed_integrates_the_bf16_weight_model():
    """tests/test_mixed_precision.py's first check, on the port alone."""
    W, y0 = _wide()
    Wq = [(torch.tensor(a, dtype=F32).to(torch.bfloat16).double().numpy(),
           b) for a, b in W]
    kw = dict(rtol=1e-6, atol=1e-6, first_step=0.01)
    mixed = _port("mixed", W, y0, "dopri5", **kw)
    quantized = _port("highest", Wq, y0, "dopri5", **kw)
    full = _port("highest", W, y0, "dopri5", **kw)
    assert mixed.stats.status == 0
    assert float((mixed.ys - quantized.ys).abs().max()) < 5e-5
    assert float((mixed.ys - full.ys).abs().max()) > 1e-4


def test_bf16_plain_product_is_exact():
    """Each product of two bf16 values is exact in float32, so the plain
    'bf16' product equals the float32 sum, in input order, of the exactly
    rounded float64 products; 'mixed' splits h into parts that rebuild it
    to 2^-16."""
    rng = np.random.RandomState(3)
    wT = torch.tensor(rng.randn(7, 40), dtype=F32)
    h = torch.tensor(rng.randn(5, 40), dtype=F32)
    w16 = wT.to(torch.bfloat16).double()
    h16 = h.to(torch.bfloat16).double()
    acc = None
    for i in range(40):
        term = (w16[:, i] * h16[:, i:i + 1]).float()
        assert torch.equal(term.double(), w16[:, i] * h16[:, i:i + 1])
        acc = term if acc is None else acc + term
    assert torch.equal(PK.dot_tier_plain(wT, h, "bf16"), acc)
    hi = PK._bf16(h)
    lo = PK._bf16(h - hi)
    assert float(((hi + lo - h).abs() / h.abs()).max()) < 2.0 ** -16
    mixed = PK.dot_tier_plain(wT, h, "mixed")
    exact = h.double() @ w16.t()
    assert float((mixed.double() - exact).abs().max()) < 1e-3
    with pytest.raises(ValueError, match="no reduced tier"):
        PK.dot_tier_plain(wT, h, "highest")


@pytest.mark.parametrize("time_input", [False, True])
@pytest.mark.parametrize("tier", ["highest", "mixed"])
def test_tier_net_matches_reference_net(tier, time_input):
    """`cuda_kernels.tier_net` (K4 alone; its plain version on the CPU)
    against the reference's `_make_net` evaluated outside a kernel on the
    same inputs, the time column last in layer 0 and split like the state.
    'highest' sums in input order on both sides (matmul='vpu'); 'mixed'
    differs only in the order of the float32 sums of exact bf16 products
    (XLA's dot against input order). 'bf16' has no CPU reference (its
    CPU dot is exact float32)."""
    from tfdiffeq_tpu.ops import pallas_kernels as JK
    W, y0 = _wide(bias=0.05)
    if time_input:
        rng = np.random.RandomState(4)
        W[0] = (rng.randn(D + 1, H) / np.sqrt(D + 1), W[0][1])
    t = 0.375
    dims = tuple((a.shape[0], a.shape[1]) for a, _ in W)
    matmul = "vpu" if tier == "highest" else "auto"
    f = JK._make_net(
        [x for a, b in W for x in (jnp.asarray(a.T, jnp.float32),
                                   jnp.asarray(b[:, None], jnp.float32))],
        dims, "tanh", "identity", 1, time_input, matmul=matmul,
        dot_precision=tier)
    ref = np.asarray(f(jnp.float32(t), jnp.asarray(y0.T, jnp.float32))).T
    warr, pdims = PK.pack_mlp_weights(convert.weights_from_jax(W), F32)
    tiers = PK.layer_tiers(pdims, matmul, tier)
    assert tiers == (tier,) * 3
    got = PK.tier_net(warr, pdims, torch.tensor(y0, dtype=F32), t,
                      tiers=tiers, time_input=time_input)
    assert got.shape == (B, D) and PK.tier_net_launches == 0
    assert _rel(got.numpy(), ref) < (1e-6 if tier == "highest" else 1e-5)


def test_bf16_trajectory_stays_near_highest():
    """No reference comparison (its CPU 'bf16' is exact float32): the port's
    one-pass trajectory is within 1e-2 of 'highest', relative to its
    largest entry, and differs from it."""
    W, y0 = _wide()
    hi = _port("highest", W, y0, "rk4", num_steps=64)
    bf = _port("bf16", W, y0, "rk4", num_steps=64)
    assert 1e-4 < _rel(bf.ys.numpy(), hi.ys.numpy()) < 1e-2
    assert list(bf.stats) == list(hi.stats)


def test_tiers_act_only_on_selected_layers():
    """The spiral's 2 -> 50 -> 2 has no layer that 'auto' selects, and
    matmul='vpu' selects none: 'mixed' then gives the bits of 'highest'.
    A fifth positional argument of MLPSpec is matmul, as in the
    reference."""
    rng = np.random.RandomState(1)
    Ws = [(rng.randn(2, 50) * 0.1, np.zeros(50)),
          (rng.randn(50, 2) * 0.1, np.zeros(2))]
    ys = torch.tensor(rng.randn(B, 2), dtype=F32)
    t = torch.tensor(T, dtype=F32)
    runs = [PF.solve_mlp_spec(
        PF.MLPSpec(input_power=3, dot_precision=p),
        convert.weights_from_jax(Ws), ys, t, rtol=1e-6, atol=1e-6)
        for p in ("highest", "mixed")]
    assert torch.equal(runs[0].ys, runs[1].ys)
    assert list(runs[0].stats) == list(runs[1].stats)
    W, y0 = _wide()
    vpu = _port("mixed", W, y0, "rk4", matmul="vpu", num_steps=8)
    hi = _port("highest", W, y0, "rk4", num_steps=8)
    assert torch.equal(vpu.ys, hi.ys)
    assert PF.MLPSpec("tanh", "identity", 1, False, "mxu").matmul == "mxu"
    assert JF.MLPSpec("tanh", "identity", 1, False, "mxu").matmul == "mxu"
    assert PK.layer_tiers(((2, 50), (50, 2)), "auto", "mixed") == \
        ("highest", "highest")
    assert PK.layer_tiers(((33, 64), (64, 31)), "auto", "bf16") == \
        ("bf16", "highest")
    with pytest.raises(ValueError, match="matmul must be"):
        PF.MLPSpec(matmul="tpu")


@pytest.mark.parametrize("rtol,inflation,tier", [(1e-6, 0.5, "mixed"),
                                                 (1e-8, 0.3, "highest")])
def test_calibrate_picks_mixed_then_falls_back(rtol, inflation, tier):
    """tests/test_mixed_precision.py::test_calibrate_picks_mixed_then_
    falls_back on the wide net: the port picks the tier the reference picks
    from the same inputs."""
    W, y0 = _wide()
    kw = dict(rtol=rtol, atol=rtol, candidates=("mixed",),
              max_nfe_inflation=inflation, first_step=0.01)
    ref = JF.calibrate_dot_precision(
        JF.MLPSpec(activation="tanh"),
        [(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
         for a, b in W], jnp.asarray(y0, jnp.float32),
        jnp.asarray(T, jnp.float32), interpret=True, **kw)
    got = PF.calibrate_dot_precision(
        PF.MLPSpec(activation="tanh"), convert.weights_from_jax(W),
        torch.tensor(y0, dtype=F32), torch.tensor(T, dtype=F32), **kw)
    assert got.dot_precision == ref.dot_precision == tier
    assert PF.DOT_PASSES == JF.DOT_PASSES


def test_tier_gates():
    """per_sample=True with a tier (ROADMAP item 20, once refused here) runs
    K5's tile engine: each sample under its own controller, near the
    one-controller 'mixed' solve (tests/test_torch_perlane_tiers.py holds it
    to the reference); Adams methods refuse the tiers with the reference's
    ValueError, and solve at 'highest' (ROADMAP item 12, once refused
    here)."""
    W, y0 = _wide()
    per = _port("mixed", W, y0, "dopri5", per_sample=True,
                **SOLVES["dopri5"])
    one = _port("mixed", W, y0, "dopri5", **SOLVES["dopri5"])
    assert int(per.lane_stats.status.max()) == 0
    assert per.lane_stats.n_accepted.shape == (B,)
    assert _rel(per.ys.numpy(), one.ys.numpy()) < 1e-3
    with pytest.raises(ValueError, match="not supported on the Adams"):
        _port("mixed", W, y0, "adams")
    res = _port("highest", W, y0, "adams", first_step=0.05, rtol=1e-4,
                atol=1e-4)
    assert res.stats.status == 0 and torch.isfinite(res.ys).all()


def test_mixed_training_matches_reference():
    """odeint_adjoint_mlp with a 'mixed' spec: the forward on the tier, the
    backward float32-accurate on the float32 weights, in both packages;
    gradients within 1e-4 relative to each leaf's largest entry."""
    W, y0 = _wide(bias=0.05)
    y0, t = y0[:8], T[:4]
    g = np.random.RandomState(9).randn(4, 8, D)
    kw = dict(rtol=1e-5, atol=1e-5, first_step=0.01)
    jspec = JF.MLPSpec(activation="tanh", dot_precision="mixed")

    import jax

    def jloss(w, y):
        ys = JF.odeint_adjoint_mlp(jspec, w, y, jnp.asarray(t, jnp.float32),
                                   interpret=True, **kw)
        return jnp.sum(ys * jnp.asarray(g, jnp.float32))

    jw = [(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
          for a, b in W]
    jg_w, jg_y = jax.grad(jloss, argnums=(0, 1))(jw, jnp.asarray(
        y0, jnp.float32))
    pw = [(a.requires_grad_(), b.requires_grad_())
          for a, b in convert.weights_from_jax(W)]
    py = torch.tensor(y0, dtype=F32, requires_grad=True)
    ys = PF.odeint_adjoint_mlp(
        PF.MLPSpec(activation="tanh", dot_precision="mixed"), pw, py,
        torch.tensor(t, dtype=F32), **kw)
    torch.sum(ys * torch.tensor(g, dtype=F32)).backward()
    pairs = [(py.grad, jg_y)] + [
        (p.grad, j) for (pa, pb), (ja, jb) in zip(pw, jg_w)
        for p, j in ((pa, ja), (pb, jb))]
    for p, j in pairs:
        assert _rel(p.numpy(), j) < 1e-4


def test_dataclass_replace_keeps_matmul():
    spec = dataclasses.replace(PF.MLPSpec(matmul="mxu"),
                               dot_precision="bf16")
    assert (spec.matmul, spec.dot_precision) == ("mxu", "bf16")


@pytest.mark.parametrize("width", [256, 512])
def test_batch_route_keeps_long_grids(width):
    """K8's batch route keeps its grid and output times in global memory
    (K4's tiles take the shared memory), so a grid too long for the other
    routes' shared memory still takes it; those routes raise."""
    dims = [(64, width), (width, width), (width, 64)]
    n_w = sum(i * o + o for i, o in dims)
    long_grid = 60000
    for tier in ("mixed", "bf16"):
        tiers = PK.layer_tiers(dims, "auto", tier)
        assert PK._route("mlp_solve_fixed", dims, n_w, 4, tiers,
                         input_values=long_grid) == PK.ROUTE_BATCH
    with pytest.raises(ValueError, match="grid points"):
        PK._route("mlp_solve_fixed", dims, n_w, 4,
                  PK.layer_tiers(dims, "auto", "highest"),
                  input_values=long_grid)
