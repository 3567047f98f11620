"""PyTorch port: K4's dot-precision tiers at a captured plan's dots (K14's
tile route in K2, K8 and K5) against the JAX package.

The dynamics are the wide MLP written as plain code, D = 32 -> 144 -> 144
-> 32 with tanh (every layer selected under matmul='auto'), B <= 12, in
both frameworks over the same numpy arrays. On the CPU the port's plan
kernels run their plain versions (`ops/cuda_plan.py`), whose tiered dots
take `ops/cuda_kernels.dot_tier_plain` (`plan_bridge.eval_plan(
dot_precision=...)`); the reference runs `solve_fused` in interpret mode.

- 'mixed' against the reference's 'mixed': dopri5, dense output, rk4 and
  per sample; trajectories within 1e-5 relative to their largest entry,
  accepted and rejected counts within one (the float32 sums of exact bf16
  products run in input order here and in XLA's order there, which can
  also move one activation's bf16 rounding; tests/test_torch_dot_tiers.py).
  Per sample at rtol 1e-5: each lane's steps follow its own error
  estimate, a difference of nearly equal stage sums, so the two summation
  orders move every later step size of every lane, by an amount that
  scales with the tolerance (at rtol 1e-4 the lanes take the same step
  counts and still part by 1.6e-5).
- The port's mirror of tests/test_mixed_precision.py:160-225: 'mixed'
  within 5e-5 of 'highest' on pre-quantized weights, at fewer NFE x
  passes, and more than 1e-4 from the float32-weight run; rk4 'mixed'
  near the quantized 'highest'; the gates (adaptive 'bf16', the Adams
  kernels, an unfusable function, training) with the reference's
  ValueError.
- 'bf16' on a fixed grid: the plan's route equals K8's MLP route
  (`cuda_fixed.mlp_solve_fixed` with the same f0) bit for bit, two
  independent plain versions of the same tier, and stays near 'highest'.
- A batch coupling with a tier (the mean-field term, on one block) against
  the reference, and the plan's generated tile segments compiled as host
  C++ against `eval_plan(dot_precision=...)` bit for bit (exact
  operations only, so the host's libm plays no part).
"""

import ctypes
import os
import shutil
import subprocess
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu_torch import fast as PF, odeint_adjoint, solve
from tfdiffeq_tpu_torch.ops import cuda_fixed as PX
from tfdiffeq_tpu_torch.ops import cuda_kernels as PK
from tfdiffeq_tpu_torch.ops import plan_bridge as PB
from tfdiffeq_tpu_torch.ops import plan_codegen as PC

D, H, B = 32, 144, 8
F32 = torch.float32
T = np.linspace(0.0, 2.0, 5)
ADAPT = dict(rtol=1e-4, atol=1e-4, first_step=0.01)


def _weights(seed=0, bias=0.05):
    rng = np.random.RandomState(seed)
    dims = (D, H, H, D)
    return [(rng.randn(dims[i], dims[i + 1]) / np.sqrt(dims[i]),
             rng.randn(dims[i + 1]) * bias) for i in range(3)]


def _y0(n=B, seed=1):
    return np.random.RandomState(seed).randn(n, D) * 0.5


def _dyn(np_weights, xp, dtype, coupled=False):
    """The wide MLP as plain code in `xp` (torch or jax.numpy)."""
    if xp is torch:
        W = [(torch.tensor(a, dtype=dtype), torch.tensor(b, dtype=dtype))
             for a, b in np_weights]
        act = torch.tanh
    else:
        W = [(jnp.asarray(a, dtype), jnp.asarray(b, dtype))
             for a, b in np_weights]
        act = jnp.tanh

    def f(t, y):
        h = y
        for i, (w, b) in enumerate(W):
            h = h @ w + b
            if i < len(W) - 1:
                h = act(h)
        if coupled:
            h = h - 0.5 * (y - y.mean(0))
        return h
    return f


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _jax(W, y0, prec, coupled=False, **kw):
    return JF.solve_fused(_dyn(W, jnp, jnp.float32, coupled),
                          jnp.asarray(y0, jnp.float32),
                          jnp.asarray(T, jnp.float32), dot_precision=prec,
                          interpret=True, **kw)


def _port(W, y0, prec, coupled=False, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # no fallback allowed
        return PF.solve_fused(_dyn(W, torch, F32, coupled),
                              torch.tensor(y0, dtype=F32),
                              torch.tensor(T, dtype=F32), dot_precision=prec,
                              **kw)


CASES = {"dopri5": dict(ADAPT),
         "dense": dict(ADAPT, dense_output=True, max_num_steps=64),
         "rk4": dict(method="rk4", num_steps=16),
         "per_sample": dict(ADAPT, per_sample=True, rtol=1e-5, atol=1e-5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_mixed_matches_reference(case):
    W, y0 = _weights(), _y0()
    ref = _jax(W, y0, "mixed", **CASES[case])
    got = _port(W, y0, "mixed", **CASES[case])
    assert got.stats.status == 0 and int(ref.stats.status) == 0
    assert abs(got.stats.n_accepted - int(ref.stats.n_accepted)) <= 1
    assert abs(got.stats.n_rejected - int(ref.stats.n_rejected)) <= 1
    assert _rel(got.ys.numpy(), ref.ys) < 1e-5
    if case == "per_sample":
        for a, b in zip(got.lane_stats[1:3], ref.lane_stats[1:3]):
            assert np.max(np.abs(a.numpy() - np.asarray(b))) <= 1
    if case == "dense":
        assert got.dense is not None and ref.dense is not None
        for tq in (0.3, 1.1, 1.7):
            assert _rel(got.dense.eval_flat(torch.tensor(tq)).numpy(),
                        ref.dense.eval_flat(jnp.float32(tq))) < 1e-5


def test_plan_mixed_coupled_matches_reference():
    """A batch coupling with a tier: K2 on one block, the mean over the
    batch between the tiered dots' tiles."""
    W, y0 = _weights(), _y0()
    ref = _jax(W, y0, "mixed", coupled=True, method="rk4", num_steps=8)
    got = _port(W, y0, "mixed", coupled=True, method="rk4", num_steps=8)
    assert [int(x) for x in got.stats] == [int(x) for x in ref.stats]
    assert _rel(got.ys.numpy(), ref.ys) < 1e-5
    ref = _jax(W, y0, "mixed", coupled=True, **ADAPT)
    got = _port(W, y0, "mixed", coupled=True, **ADAPT)
    assert abs(got.stats.n_accepted - int(ref.stats.n_accepted)) <= 1
    assert _rel(got.ys.numpy(), ref.ys) < 1e-5


def test_plan_mixed_integrates_the_bf16_weight_model():
    """tests/test_mixed_precision.py::test_plan_mixed_integrates_the_bf16_
    weight_model on the port: within 5e-5 of 'highest' fusion of the
    pre-quantized weights, at fewer NFE x passes, and not the float32-weight
    trajectory."""
    W, y0 = _weights(bias=0.0), _y0(16)
    Wq = [(torch.tensor(a, dtype=F32).to(torch.bfloat16).double().numpy(),
           b) for a, b in W]
    kw = dict(rtol=1e-6, atol=1e-6, first_step=0.01)
    mixed = _port(W, y0, "mixed", **kw)
    quant = _port(Wq, y0, "highest", **kw)
    full = _port(W, y0, "highest", **kw)
    assert mixed.stats.status == 0
    assert float((mixed.ys - quant.ys).abs().max()) < 5e-5
    assert (mixed.stats.nfe * PF.DOT_PASSES["mixed"]
            < quant.stats.nfe * PF.DOT_PASSES["highest"])
    assert float((mixed.ys - full.ys).abs().max()) > 1e-4


def test_plan_tiers_fixed_grid_and_gates():
    """tests/test_mixed_precision.py::test_plan_mixed_fixed_grid_and_gates:
    rk4 takes 'mixed' (near the quantized 'highest') and 'bf16'; adaptive
    'bf16', the Adams kernels and an unfusable function raise ValueError,
    through `solve(options={'fuse': True, ...})` as the reference's."""
    W, y0 = _weights(bias=0.0), _y0()
    Wq = [(torch.tensor(a, dtype=F32).to(torch.bfloat16).double().numpy(),
           b) for a, b in W]
    f, tt = _dyn(W, torch, F32), torch.tensor(T, dtype=F32)
    y = torch.tensor(y0, dtype=F32)
    r = solve(f, y, tt, method="rk4", options={
        "fuse": True, "dot_precision": "mixed", "num_steps": 64})
    ref = solve(_dyn(Wq, torch, F32), y, tt, method="rk4",
                options={"fuse": True, "num_steps": 64})
    assert float((r.ys - ref.ys).abs().max()) < 5e-5
    with pytest.raises(ValueError, match="fixed-grid"):
        solve(f, y, tt, rtol=1e-4, atol=1e-4,
              options={"fuse": True, "dot_precision": "bf16"})
    with pytest.raises(ValueError, match="fixed-grid"):
        PF.solve_fused(f, y, tt, per_sample=True, dot_precision="bf16")
    with pytest.raises(ValueError, match="Adams"):
        solve(f, y, tt, rtol=1e-4, atol=1e-4, method="adams",
              options={"fuse": True, "dot_precision": "mixed"})
    with pytest.raises(ValueError, match="Adams"):
        PF.solve_fused(f, y, tt, method="fixed_adams", num_steps=8,
                       dot_precision="mixed")
    with pytest.raises(ValueError, match="fusion failed"):
        solve(lambda t_, y_: -y_ * torch.cumsum(y_, dim=0), y, tt,
              rtol=1e-4, atol=1e-4,
              options={"fuse": True, "dot_precision": "mixed"})
    with pytest.raises(ValueError, match="dot_precision must be"):
        PF.solve_fused(f, y, tt, dot_precision="tf32")


def test_plan_tiers_refused_for_training():
    """Tiered training is refused with the reference's 'serving' message
    (tests/test_mixed_precision.py::test_plan_mixed_rejected_for_training)."""
    W, y0 = _weights(), _y0()
    w = [torch.tensor(W[0][0], dtype=F32, requires_grad=True)]

    def dyn(t, y):
        return torch.tanh(y @ w[0]) @ w[0].t()

    with pytest.raises(ValueError, match="serving"):
        odeint_adjoint(dyn, torch.tensor(y0, dtype=F32),
                       torch.tensor(T, dtype=F32), rtol=1e-4, atol=1e-4,
                       options={"fuse": True, "dot_precision": "mixed"})


def test_plan_bf16_fixed_grid_equals_mlp_route():
    """'bf16' on a fixed grid: the plan's tile route (its dots by
    `eval_plan` with `dot_tier_plain`) equals K8's MLP batch route
    (`_net_plain`'s tier layers) bit for bit from the same f0; the
    trajectory stays within 1e-2 of 'highest' and differs from it."""
    W, y0 = _weights(), _y0()
    y = torch.tensor(y0, dtype=F32)
    tt = torch.tensor(T, dtype=F32)
    f = _dyn(W, torch, F32)
    plan, consts = PB.build_plan(f, tt[0], y)
    assert PB.tiered_dots(plan, "bf16") == 3
    packed = PB.pack_consts(plan, consts, F32)
    grid = torch.linspace(0.0, 2.0, 17, dtype=F32)
    f0 = PB.eval_plan_host(plan, packed, grid[0], y)
    from tfdiffeq_tpu_torch.ops import cuda_plan as PP
    got, st = PP.plan_solve_fixed(plan, packed, y, tt, grid, 1.0, f0,
                                  dot_precision="bf16")
    warr, dims = PK.pack_mlp_weights(
        [(torch.tensor(a, dtype=F32), torch.tensor(b, dtype=F32))
         for a, b in W], F32)
    want, st2 = PX.mlp_solve_fixed(warr, dims, y, tt, grid, 1.0, f0=f0,
                                   tiers=("bf16",) * 3)
    assert torch.equal(got, want) and torch.equal(st, st2)
    hi, _ = PP.plan_solve_fixed(plan, packed, y, tt, grid, 1.0, f0)
    assert 1e-4 < _rel(got.numpy(), hi.numpy()) < 1e-2


CXX = shutil.which("c++") or shutil.which("g++")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tfdiffeq_tpu_torch", "csrc")
SHIM = ("#define __host__\n#define __device__\n"
        "#define __forceinline__ inline\n")


def _exact_dyn(dtype):
    """Dynamics of exact operations only (relu, products by powers of two,
    sums of two terms, a batch mean, a feature sum), three tiered dots, one
    fed straight by another, and the time as a row of a dot's input."""
    rng = np.random.RandomState(5)
    W1 = torch.tensor(rng.randn(D, H) / 6, dtype=dtype)
    W2 = torch.tensor(rng.randn(H, H) / 12, dtype=dtype)
    W3 = torch.tensor(rng.randn(H + 1, D) / 12, dtype=dtype)
    b1 = torch.tensor(rng.randn(H) * 0.1, dtype=dtype)

    def f(t, y):
        h = torch.relu(y @ W1 + b1) * 0.5
        h = (h @ W2) @ W2.t()
        h = torch.cat([h, t.expand(y.shape[0], 1)], dim=1)
        return h @ W3 - 0.25 * y.mean(0) + y.sum(1, keepdim=True) * 0.125
    return f


@pytest.mark.skipif(CXX is None, reason="no host C++ compiler")
@pytest.mark.parametrize("prec", ["mixed", "bf16"])
def test_tile_segments_match_eval_plan(tmp_path, prec):
    for dtype, ct, sfx in ((torch.float32, ctypes.c_float, "f32"),
                           (torch.float64, ctypes.c_double, "f64")):
        y = torch.tensor(np.random.RandomState(6).randn(5, D), dtype=dtype)
        t = torch.tensor(0.375, dtype=dtype)
        plan, consts = PB.build_plan(_exact_dyn(dtype), t, y, matmul="mxu")
        packed = PB.pack_consts(plan, consts, dtype)
        lay = PC.layout(plan, prec)
        assert (lay.tier_dots, lay.segments) == (4, 6)
        cpp, so = tmp_path / f"{sfx}.cpp", tmp_path / f"{sfx}.so"
        cpp.write_text(SHIM + PC.host_source(plan, 512, prec))
        subprocess.run([CXX, "-O1", "-std=c++17", "-ffp-contract=off",
                        "-shared", "-fPIC", "-I", CSRC, "-o", str(so),
                        str(cpp)], check=True)
        fn = getattr(ctypes.CDLL(str(so)), f"plan_eval_{sfx}")
        fn.argtypes = [ct] + [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 3
        c, sc = PC.flat_consts(plan, packed, y.shape[0])
        out = torch.full((y.shape[0], D), float("nan"), dtype=dtype)
        live = torch.zeros(lay.live_rows * y.shape[0], dtype=dtype)
        red = torch.zeros(max(1, lay.red_values), dtype=dtype)
        ptr = lambda x: ctypes.c_void_p(x.data_ptr())          # noqa: E731
        fn(float(t), ptr(y), ptr(c), ptr(sc), y.shape[0], ptr(out),
           ptr(live), ptr(red))
        want = PB.eval_plan_host(plan, packed, t, y, dot_precision=prec)
        hi = PB.eval_plan_host(plan, packed, t, y)
        assert torch.equal(out, want), sfx
        assert not torch.equal(want, hi)
