"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the launch counters of the slices (the forward solve, the
training step of `fast.odeint_adjoint_mlp`, their fixed-grid paths, and
`fast.solve_conv_ode`).

Marked `gpu`; the `cuda` fixture skips every test where
torch.cuda.is_available() is false (it decides when a test runs, never at
import, so every pytest-xdist worker collects the same tests). This file
imports no JAX, so on the machine with the card it runs without the JAX
package's conftest:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerances: the plain versions repeat each kernel's arithmetic in the same
order (the kernels are built with --fmad=false and sum their errors, and
K3 its batch sums, in a fixed order the plain versions follow), so float64
results agree to 1e-12 and whole solves and sweeps take identical step
sequences. Float32 whole solves are held to the reference's float32 budget
(rtol 1e-3, atol 2e-4); float32 sweeps to 1e-3 relative to each output's
largest entry (tests/test_fused_adjoint.py's bar). The fixed-grid kernels
K8 and K9 take no step decisions: float64 within 1e-12 (relative to each
output's largest entry for K9), float32 within 1e-5 absolute (K8, the bar
of tests/test_fixed_fused.py) and 1e-4 relative (K9), and both bitwise
equal from run to run. K13, the whole conv-ODE solve of the ODE-Net block,
repeats its plain version's summation order too: identical stats in every
controller block, float64 within 1e-12 relative, float32 within 1e-5.
K5 and K6, the per-sample solve and sweep, repeat their plain versions'
order per sample: identical per-sample counts and float64 within 1e-12,
float32 within the whole-solve and sweep bars above, bitwise from run to
run. Past 128-wide layers all six MLP kernels take the wide route and stay
bitwise equal to their plain versions in both types. The dot-precision
tiers (K4 in K2 and K8): float64 bitwise (the tier's rounding on the CUDA
cores, sums in input order); float32 on the tensor cores, whose
accumulation order is their own: 'mixed' K2 within 5e-5 of its plain
version with accepted and rejected counts within one, K8 within 1e-5.
Float32 'bf16' rounds every layer input to 8 bits, so a last-bit difference
in a sum can move a rounding by 2^-8 on a few outputs: K8 within 2e-3 at
most and 2e-5 on average; a whole adaptive K2 solve amplifies that noise
to the tier's own error (1e-2), so one K2 step is held instead, far nearer
its own tier's plain version than the others'. Each float32 tier is also
held against the other tiers' plain versions, where it must fail its bar.
K4 at its last sites: K5's tile engine on the MLP route (a battery whose
samples take different attempts, some out of steps) and a plan's tile
route in K2 (with its dense output), K8, K5 and, coupled, on one block of
K2 and K8: float64 bitwise; float32 'mixed' K2 within 5e-5 with counts
within one, K8 within `SOLVE_BARS`, K5 within the reference's float32
budget with each sample's counts within one.
K4 alone (`tier_net`): the largest and mean gap of one evaluation
(chip_smoke.py EVAL_BARS). K7, the CNF right-hand side in K2 and its
second-order adjoint in K3 (rhs='cnf'), narrow and wide: bitwise equal to
their plain versions in both types, with identical stats. K10 and K11, the
fixed-step Adams and VCABM solves, narrow and wide, every order and both
directions: bitwise equal to their plain versions in both types, with
identical stats, and from run to run; so are K14 (a generated plan) inside
K2, K8, K5, K10 and K11, K15 inside K3, K6 and K9, and K12 (the
hypersolvers, two plans) for its three kinds on the output grid, a finer
grid and in reverse time. Every built-in method with options={'fuse':
True} launches one whole-solve kernel and never falls back. K3 on a grid
of n_blocks blocks (1, 2, 132; the wrapper's default one per SM) is
bitwise equal to its plain version at the same n_blocks in both types on
the narrow, wide, CNF and plan routes; a grid the card cannot hold at once
raises. So are K2 (narrow, wide, CNF, plan) and K11 (narrow, wide, plan)
on grids of 1, 7 and the card's blocks, and K2's batch route (a block a
16-row tile) in float64; its float32 tiers sum on the tensor cores, so
they are held to the bars above at the same grid. fixed_adams' K10
(narrow, wide, plan) on grids of 1, 7 and the card's blocks is bitwise
equal to its plain version at the same n_blocks; explicit_adams' K10
(narrow, wide, plan) and K12 with a group of threads a sample are bitwise
equal to their plain versions at B in {4096, 256, 33, 1}, report the
layout their wrappers expect, and their wrappers return before a sleep
queued on the card ends (status 3 decided on the card);
K6 with a group of threads a sample (narrow, wide, plan, a float32
stiffness battery whose stiffest samples fail, the overflowing trial) is
bitwise equal to its plain version, outputs, stats and lane stats, a NaN
only where the plain version has one. K4's shared-memory tiles at widths
256 and 512: one evaluation
within EVAL_BARS, float64 bitwise; K8 on them within chip_smoke.py's
SOLVE_BARS for the wide rk4 x 128 (its 'bf16' mean gap grows with the
width, so the tier is told apart per evaluation there). K2's plan launch
with its dense-output emission is bitwise equal to its plain version
(out, stats, meta, coef) on the per-thread and coupled routes at B in
{4096, 256, 33, 1}, and gives without the buffers the same out and stats;
a refused launch raises. A coupled plan on the one-block routes of K8 (rk4,
euler), K10 (both methods), K11 and K9 is bitwise equal to its plain
version at B in {4096, 256, 33} (at 1 the capture folds the coupling
away), and every fused entry point launches those kernels. The float64
tier from float32 callers: `solve_df` is one K2 launch and
`odeint_adjoint_df` one K2 and one K3 launch, each in float64 and bitwise
equal to its plain version at B in {4096, 33, 1}.
"""

import numpy as np
import pytest
import torch

from tfdiffeq_tpu_torch import fast
from tfdiffeq_tpu_torch.ops import cuda_adjoint as ca, cuda_fixed as cf, \
    cuda_kernels as ck, cuda_perlane as cp
from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    ck.reset_launch_counts()
    ca.reset_launch_counts()
    cf.reset_launch_counts()
    cp.reset_launch_counts()
    return torch.device("cuda")


def _bench(B, dtype, device):
    """The benchmark's weights and states (bench.py:32-39, :268-270)."""
    rng = np.random.RandomState(0)
    p = {"w1": rng.randn(2, 50) * 0.1, "b1": np.zeros(50),
         "w2": rng.randn(50, 2) * 0.1, "b2": np.zeros(2)}
    y0 = np.random.RandomState(1).randn(B, 2) * 1.5
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return {k: as_t(v) for k, v in p.items()}, as_t(y0)


@pytest.mark.parametrize("B,D", [(4096, 2), (1, 2), (33, 2), (4097, 2),
                                 (33, 7), (300, ck.STEP_MAX_D)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_kernel_matches_plain(cuda, dtype, B, D):
    """K1 (a group of threads a sample, step_samples samples a block)
    bitwise equal to its plain version: the step, the midpoint and the
    ratio from the blocks' partial sums."""
    if D == 2:
        p, y = _bench(B, dtype, cuda)
    else:
        rng = np.random.RandomState(D)
        p = {k: torch.tensor(v, dtype=dtype, device=cuda) for k, v in (
            ("w1", rng.randn(D, 24) * 0.3), ("b1", rng.randn(24) * 0.1),
            ("w2", rng.randn(24, D) * 0.3), ("b2", rng.randn(D) * 0.1))}
        y = torch.tensor(rng.randn(B, D), dtype=dtype, device=cuda)
    f0 = fast.mlp_apply(fast.MLPSpec(input_power=3),
                        [(p["w1"], p["b1"]), (p["w2"], p["b2"])], y)
    got = ck.dopri5_mlp_step(p, y, f0, 0.3, 1e-6, 1e-6)
    ref = ck.dopri5_mlp_step_plain(p, y, f0, 0.3, 1e-6, 1e-6)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.isfinite(got[2])
    assert ck.dopri5_mlp_step_launches == 1


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "adaptive_heun"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_kernel_matches_plain(cuda, dtype, method):
    p, y = _bench(1024, dtype, cuda)
    spec = fast.MLPSpec(input_power=3)
    W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
    warr, dims = ck.pack_mlp_weights(W, dtype, cuda)
    f0 = fast.mlp_apply(spec, W, y)
    t = torch.linspace(0.0, 10.0, 16, dtype=dtype)
    kw = dict(f0=f0, activation="tanh", input_power=3, method=method)
    out, st = ck.mlp_solve(warr, dims, y, t, 0.01, 1e-5, 1e-5, 1.0, **kw)
    ref, st_ref = ck.mlp_solve_plain(warr, dims, y, t, 0.01, 1e-5, 1e-5,
                                     1.0, **kw)
    torch.cuda.synchronize()
    assert st[3].item() == 0
    if dtype == torch.float64:
        assert st.tolist() == st_ref.tolist()
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-9)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-3, atol=2e-4)
    again, st2 = ck.mlp_solve(warr, dims, y, t, 0.01, 1e-5, 1e-5, 1.0, **kw)
    assert torch.equal(again, out) and torch.equal(st2, st)   # bitwise
    assert ck.mlp_solve_launches == 2


@pytest.mark.parametrize("case", [
    dict(act="elu", final="identity", power=1, time_input=True,
         dims=[(3, 16), (16, 16), (16, 2)], method="tsit5"),
    dict(act="softplus", final="tanh", power=2, time_input=False,
         dims=[(2, 12), (12, 2)], method="bosh3"),
    dict(act="silu", final="identity", power=1, time_input=False,
         dims=[(2, 10), (10, 2)], method="adaptive_heun"),
    dict(act="sigmoid", final="relu", power=1, time_input=True,
         dims=[(3, 8), (8, 2)], method="dopri8"),
    dict(act="tanh", final="identity", power=3, time_input=False,
         dims=[(4, 128), (128, 64), (64, 4)], method="dopri5"),
])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_solve_kernel_general_mlp_matches_plain(cuda, case, sign):
    """Every feature of the kernel's MLP (depth, widths up to MAX_WIDTH,
    activations, time column, input power) and every tableau family, in
    both directions, float64, at a batch that leaves some threads idle."""
    rng = np.random.RandomState(4)
    weights = [(torch.tensor(rng.randn(i, o) * 0.3, device=cuda),
                torch.tensor(rng.randn(o) * 0.1, device=cuda))
               for i, o in case["dims"]]
    D = case["dims"][-1][1]
    y0 = torch.tensor(rng.randn(300, D), device=cuda)
    warr, dims = ck.pack_mlp_weights(weights, torch.float64, cuda)
    t = torch.linspace(0.0, 2.0, 7, dtype=torch.float64)
    kw = dict(activation=case["act"], final_activation=case["final"],
              input_power=case["power"], time_input=case["time_input"],
              method=case["method"])
    spec = fast.MLPSpec(activation=case["act"],
                        final_activation=case["final"],
                        input_power=case["power"],
                        time_input=case["time_input"])
    f0 = sign * fast.mlp_apply(spec, weights, y0, t=0.0)
    out, st = ck.mlp_solve(warr, dims, y0, t, 0.05, 1e-6, 1e-8, sign, f0=f0,
                           **kw)
    ref, st_ref = ck.mlp_solve_plain(warr, dims, y0, t, 0.05, 1e-6, 1e-8,
                                     sign, f0=f0, **kw)
    torch.cuda.synchronize()
    assert st.tolist() == st_ref.tolist() and st[3].item() == 0
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-9)


def test_solve_kernel_status_codes(cuda):
    p, y = _bench(256, torch.float32, cuda)
    warr, dims = ck.pack_mlp_weights([(p["w1"], p["b1"]),
                                      (p["w2"], p["b2"])], torch.float32,
                                     cuda)
    bad_t = torch.tensor([0.0, 1.0, 0.5])
    out, st = ck.mlp_solve(warr, dims, y, bad_t, 0.01, 1e-6, 1e-6, 1.0,
                           input_power=3)
    assert st.tolist() == [0, 0, 0, 3]
    assert torch.equal(out[0], y) and not out[1:].any()
    out, st = ck.mlp_solve(warr, dims, y, torch.linspace(0.0, 50.0, 6), 0.01,
                           1e-7, 1e-7, 1.0, input_power=3, max_steps=3)
    assert st[3].item() == 1 and st[1].item() + st[2].item() == 3
    assert not out[-1].any()


def test_slice_launches_both_kernels(cuda):
    p, y = _bench(512, torch.float32, cuda)
    t = torch.linspace(0.0, 5.0, 12)
    whole = fast.solve_mlp(p, y, t, rtol=1e-6, atol=1e-6, first_step=0.01)
    assert ck.mlp_solve_launches == 1 and whole.stats.status == 0
    step = fast.solve_mlp_stepwise(p, y, t, rtol=1e-6, atol=1e-6,
                                   first_step=0.01)
    assert ck.dopri5_mlp_step_launches == step.stats.n_accepted + \
        step.stats.n_rejected
    torch.testing.assert_close(step.ys, whole.ys, rtol=1e-3, atol=2e-4)


def test_wrappers_raise_instead_of_falling_back(cuda):
    p, y = _bench(64, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        ck.dopri5_mlp_step({k: v.half() for k, v in p.items()}, y.half(),
                           y.half(), 0.1, 1e-6, 1e-6)
    with pytest.raises(ValueError, match="different devices"):
        ck.dopri5_mlp_step(p, y, y.cpu(), 0.1, 1e-6, 1e-6)
    warr, dims = ck.pack_mlp_weights(
        [(torch.zeros(2, 513), None), (torch.zeros(513, 2), None)],
        torch.float32, cuda)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        ck.mlp_solve(warr, dims, y, torch.linspace(0.0, 1.0, 3), 0.1, 1e-6,
                     1e-6, 1.0, f0=torch.zeros_like(y))
    assert ck.mlp_solve_launches == ck.dopri5_mlp_step_launches == 0


def _adjoint_case(device, dtype, B=300, T=6, time_input=False, seed=5):
    """A 2 -> 16 -> 16 -> 2 ELU MLP, its forward trajectory and random
    cotangents, packed for K3."""
    rng = np.random.RandomState(seed)
    dims = [(2 + int(time_input), 16), (16, 16), (16, 2)]
    weights = [(torch.tensor(rng.randn(i, o) * 0.5 / np.sqrt(i), dtype=dtype,
                             device=device),
                torch.tensor(rng.randn(o) * 0.1, dtype=dtype, device=device))
               for i, o in dims]
    spec = fast.MLPSpec(activation="elu", time_input=time_input)
    y0 = torch.tensor(rng.randn(B, 2), dtype=dtype, device=device)
    t = torch.linspace(0.0, 2.0, T, dtype=dtype)
    ys = fast.solve_mlp_spec(spec, weights, y0, t, rtol=1e-7,
                             atol=1e-9).ys
    g = torch.tensor(rng.randn(T, B, 2), dtype=dtype, device=device)
    warr, pdims = ck.pack_mlp_weights(weights, dtype, device)
    return warr, pdims, ys.contiguous(), g, t


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("method",
                         ["dopri5", "bosh3", "adaptive_heun", "tsit5",
                          "dopri8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adjoint_kernel_matches_plain(cuda, dtype, method):
    """K3 against its plain version for every tableau, with the time
    column (a_t quadrature); seminorm off in float64, on in float32."""
    warr, dims, ys, g, t = _adjoint_case(cuda, dtype, time_input=True)
    kw = dict(activation="elu", time_input=True, method=method,
              seminorm=dtype == torch.float32)
    args = (warr, dims, ys, g, t, 0.05, 1e-6, 1e-8, 1.0)
    got = ca.mlp_adjoint_solve(*args, **kw)
    ref = ca.mlp_adjoint_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[3][3].item() == 0 and ref[3][3].item() == 0
    if dtype == torch.float64:
        assert got[3].tolist() == ref[3].tolist()
        for a, b in zip(got[:3], ref[:3]):
            assert _rel(a, b) < 1e-12
    else:
        for a, b in zip(got[:3], ref[:3]):
            assert _rel(a, b) < 1e-3
    assert ca.mlp_adjoint_solve_launches == 1


@pytest.mark.parametrize("seminorm", [False, True])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_adjoint_kernel_bench_mlp_matches_plain(cuda, seminorm, sign):
    """The spiral's tanh MLP on y**3 (no time column), both directions,
    float64 step-exact, and bitwise equal from run to run."""
    p, y = _bench(300, torch.float64, cuda)
    W = [(p["w1"], p["b1"]), (p["w2"], p["b2"])]
    warr, dims = ck.pack_mlp_weights(W, torch.float64, cuda)
    rng = np.random.RandomState(3)
    ys = torch.tensor(rng.randn(5, 300, 2), device=cuda)
    g = torch.tensor(rng.randn(5, 300, 2), device=cuda)
    t = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    args = (warr, dims, ys, g, t, 0.05, 1e-6, 1e-6, sign)
    kw = dict(activation="tanh", input_power=3, seminorm=seminorm)
    got = ca.mlp_adjoint_solve(*args, **kw)
    again = ca.mlp_adjoint_solve(*args, **kw)
    ref = ca.mlp_adjoint_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[3].tolist() == ref[3].tolist() and got[3][3].item() == 0
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, b)                       # run to run
        if a.is_floating_point():
            assert _rel(a, c) < 1e-12
    assert ca.mlp_adjoint_solve_launches == 2


def test_adjoint_kernel_raises_past_shared_memory(cuda):
    """A network whose stage cotangents do not fit in shared memory takes
    the wide route (its sums in global memory); one past MAX_WIDTH raises;
    nothing falls back to the plain version."""
    W = [(torch.zeros(2, 128), None), (torch.zeros(128, 128), None),
         (torch.zeros(128, 2), None)]
    warr, dims = ck.pack_mlp_weights(W, torch.float64, cuda)
    ys = torch.zeros(3, 64, 2, dtype=torch.float64, device=cuda)
    assert ck._route("K3", dims, ca._shared_values(dims, 7, False), 8) == \
        ck.ROUTE_WIDE
    got = ca.mlp_adjoint_solve(warr, dims, ys, ys, torch.linspace(0, 1, 3),
                               0.1, 1e-6, 1e-6, 1.0)
    assert got[3][3].item() == 0 and not got[1].any()
    wide, wdims = ck.pack_mlp_weights(
        [(torch.zeros(2, 513), None), (torch.zeros(513, 2), None)],
        torch.float64, cuda)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        ca.mlp_adjoint_solve(wide, wdims, ys, ys, torch.linspace(0, 1, 3),
                             0.1, 1e-6, 1e-6, 1.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        ca.mlp_adjoint_solve(warr.half(), dims, ys.half(), ys.half(),
                             torch.linspace(0, 1, 3), 0.1, 1e-6, 1e-6, 1.0)
    assert ca.mlp_adjoint_solve_launches == 1


def test_training_step_launches_each_kernel_once(cuda):
    """One fused training step = one K2 launch forward, one K3 launch
    backward; the gradients are finite and the sweep ends with status 0."""
    from tfdiffeq_tpu_torch import NFEMeter
    p, y = _bench(512, torch.float32, cuda)
    W = [(p["w1"].requires_grad_(), p["b1"].requires_grad_()),
         (p["w2"].requires_grad_(), p["b2"].requires_grad_())]
    t = torch.linspace(0.0, 5.0, 12)
    meter = NFEMeter()
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    for step in range(2):
        ys = fast.odeint_adjoint_mlp(spec, W, y, t, rtol=1e-6, atol=1e-6,
                                     nfe_meter=meter)
        torch.mean(ys ** 2).backward()
        assert ck.mlp_solve_launches == step + 1
        assert ca.mlp_adjoint_solve_launches == step + 1
    assert meter.f_calls == meter.b_calls == 2 and meter.b_nfe > 0
    for w, b in W:
        assert torch.isfinite(w.grad).all() and torch.isfinite(b.grad).all()


def _fixed_case(device, dtype, time_input=False, B=300, seed=7):
    """A 2 -> 24 -> 2 tanh MLP on y**3 (with a time column when asked)
    and its packed weights."""
    rng = np.random.RandomState(seed)
    dims = [(2 + int(time_input), 24), (24, 2)]
    weights = [(torch.tensor(rng.randn(i, o) * 0.4 / np.sqrt(i), dtype=dtype,
                             device=device),
                torch.tensor(rng.randn(o) * 0.05, dtype=dtype, device=device))
               for i, o in dims]
    y0 = torch.tensor(rng.randn(B, 2), dtype=dtype, device=device)
    spec = fast.MLPSpec(input_power=3, time_input=time_input)
    warr, pdims = ck.pack_mlp_weights(weights, dtype, device)
    return spec, weights, warr, pdims, y0


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4", "rk4_38"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_kernel_matches_plain(cuda, dtype, sign, method):
    """K8 on the default grid and on a finer num_steps grid (the Hermite
    drain, with the time column), both directions."""
    for time_input, fine in ((False, False), (True, True)):
        spec, W, warr, dims, y0 = _fixed_case(cuda, dtype, time_input)
        t = torch.tensor([0.0, 0.37, 1.11, 2.0], dtype=dtype)
        tau = sign * t if sign > 0 else (sign * t).flip(0)
        grid = uniform_grid(tau[0], tau[-1], 25) if fine else tau
        f0 = sign * fast.mlp_apply(spec, W, y0, t=sign * float(tau[0]))
        kw = dict(f0=f0, activation="tanh", input_power=3,
                  time_input=time_input, method=method)
        out, st = cf.mlp_solve_fixed(warr, dims, y0, tau, grid, sign, **kw)
        again, st2 = cf.mlp_solve_fixed(warr, dims, y0, tau, grid, sign, **kw)
        ref, st_ref = cf.mlp_solve_fixed_plain(warr, dims, y0, tau, grid,
                                               sign, **kw)
        torch.cuda.synchronize()
        assert st.tolist() == st_ref.tolist() and st[3].item() == 0
        assert torch.equal(out, again) and torch.equal(st, st2)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    assert cf.mlp_solve_fixed_launches == 4


def test_fixed_kernel_status_and_raises(cuda):
    """Invalid times give status 3 and a zero tail; what K8 or K9 cannot
    take raises instead of running the plain version."""
    spec, W, warr, dims, y0 = _fixed_case(cuda, torch.float32)
    bad = torch.tensor([0.0, 1.0, 0.5])
    out, st = cf.mlp_solve_fixed(warr, dims, y0, bad, bad, 1.0,
                                 input_power=3)
    assert st.tolist() == [0, 0, 0, 3]
    assert torch.equal(out[0], y0) and not out[1:].any()
    wide, wdims = ck.pack_mlp_weights(
        [(torch.zeros(2, 513), None), (torch.zeros(513, 2), None)],
        torch.float32, cuda)
    t = torch.linspace(0.0, 1.0, 3)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        cf.mlp_solve_fixed(wide, wdims, y0, t, t, 1.0)
    ys = torch.zeros(3, 64, 2, device=cuda)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        cf.mlp_adjoint_solve_fixed(wide, wdims, ys, ys, t, 1.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        cf.mlp_adjoint_solve_fixed(warr.half(), dims, ys.half(), ys.half(),
                                   t, 1.0)
    assert cf.mlp_solve_fixed_launches == 1
    assert cf.mlp_adjoint_solve_fixed_launches == 0


@pytest.mark.parametrize("B", [300, 4096])
@pytest.mark.parametrize("time_input", [False, True])
@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_adjoint_kernel_matches_plain(cuda, dtype, method, time_input,
                                            B):
    """K9 (a group of 16 threads a sample, 32 samples a block) against its
    plain version, with and without the a_t quadrature, at B = 300 (idle
    groups in the last block, a ragged last 64-sample tree) and 4096:
    bitwise equal, stats included, and bitwise equal run to run."""
    spec, W, warr, dims, y0 = _fixed_case(cuda, dtype, time_input, B=B)
    t = torch.linspace(0.0, 2.0, 6, dtype=dtype)
    ys = fast.solve_mlp_spec(spec, W, y0, t, method="rk4",
                             num_steps=20).ys.contiguous()
    g = torch.tensor(np.random.RandomState(8).randn(*ys.shape), dtype=dtype,
                     device=cuda)
    kw = dict(num_steps=3, activation="tanh", input_power=3,
              time_input=time_input, method=method)
    got = cf.mlp_adjoint_solve_fixed(warr, dims, ys, g, t, 1.0, **kw)
    again = cf.mlp_adjoint_solve_fixed(warr, dims, ys, g, t, 1.0, **kw)
    ref = cf.mlp_adjoint_solve_fixed_plain(warr, dims, ys, g, t, 1.0, **kw)
    torch.cuda.synchronize()
    assert _same(got, again) and _same(got, ref)
    assert got[3].tolist() == [(4 if method == "rk4" else 1) * 3 * 5, 15, 0,
                               0]
    assert all(torch.isfinite(x).all() for x in got[:3])
    assert cf.mlp_adjoint_solve_fixed_launches == 2


@pytest.mark.parametrize("route", ["wide", "plan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_adjoint_group_routes_match_plain(cuda, dtype, route):
    """K9's wide route (layers past 128: the slots in the workspace) and K15
    in K9 (a plan with a per-sample constant: its per-sample quadratures)
    with a group of threads a sample: bitwise equal to their plain
    versions, stats included, and run to run."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    cpl.reset_launch_counts()
    if route == "plan":
        plan, packed, ys, ct, t = _aug_case("drive", dtype, cuda)
        args = (plan, packed, ys, ct, t, 1.0)
        fn, plain = (cpl.plan_adjoint_solve_fixed,
                     cpl.plan_adjoint_solve_fixed_plain)
        kw = dict(num_steps=4)
    else:
        weights, warr, dims, y0, t = _wide_case(cuda, dtype, B=300)
        ys = fast.solve_mlp_spec(fast.MLPSpec(), weights, y0, t, rtol=1e-7,
                                 atol=1e-9).ys.contiguous()
        ct = torch.tensor(np.random.RandomState(9).randn(*ys.shape),
                          dtype=dtype, device=cuda)
        args = (warr, dims, ys, ct, t, 1.0)
        fn, plain = cf.mlp_adjoint_solve_fixed, \
            cf.mlp_adjoint_solve_fixed_plain
        kw = dict(num_steps=2, method="midpoint")
    got = fn(*args, **kw)
    assert _same_sweep(got, fn(*args, **kw))
    assert _same_sweep(got, plain(*args, **kw))
    torch.cuda.synchronize()
    assert (cpl.plan_fixed_adjoint_launches if route == "plan"
            else cf.mlp_adjoint_solve_fixed_launches) == 2


def test_fixed_training_step_launches_each_kernel_once(cuda):
    """A fused rk4 training step = one K8 launch forward, one K9 launch
    backward; the mixed cases take K8 + K3 and K2 + K9."""
    p, y = _bench(512, torch.float32, cuda)
    W = [(p["w1"].requires_grad_(), p["b1"].requires_grad_()),
         (p["w2"].requires_grad_(), p["b2"].requires_grad_())]
    t = torch.linspace(0.0, 5.0, 12)
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    res = fast.solve_mlp_spec(spec, W, y, t, method="rk4", num_steps=40)
    assert cf.mlp_solve_fixed_launches == 1 and res.stats.nfe == 161
    for method, adjoint_method, counts in (
            ("rk4", "rk4", (2, 1, 0, 0)), ("rk4", "dopri5", (3, 1, 0, 1)),
            ("dopri5", "rk4", (3, 2, 1, 1))):
        ys = fast.odeint_adjoint_mlp(spec, W, y, t, rtol=1e-6, atol=1e-6,
                                     method=method,
                                     adjoint_method=adjoint_method,
                                     num_steps=40, adjoint_num_steps=4)
        torch.mean(ys ** 2).backward()
        assert (cf.mlp_solve_fixed_launches,
                cf.mlp_adjoint_solve_fixed_launches, ck.mlp_solve_launches,
                ca.mlp_adjoint_solve_launches) == counts
        for w, b in W:
            assert torch.isfinite(w.grad).all() and torch.isfinite(b.grad).all()


# ---------------------------------------------------------------------------
# K13: the whole conv-ODE solve (ODE-Net block)
# ---------------------------------------------------------------------------

def _conv_case(device, dtype, B, C, G, seed=11):
    """Conv-ODE parameters in the reference's dict layout (HWIO kernels
    with flax's lecun-normal variance, perturbed GroupNorm affines) and a
    state [B, C, 7, 7], drawn with numpy."""
    from tfdiffeq_tpu_torch.ops.conv_ode import ConvODESpec
    rng = np.random.RandomState(seed)
    params = {
        "gn": [(1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C))
               for _ in range(3)],
        "conv": [(rng.randn(3, 3, C + 1, C) / np.sqrt(9 * (C + 1)),
                  0.1 * rng.randn(C)) for _ in range(2)]}
    x = torch.tensor(rng.randn(B, C, 7, 7) * 0.5, dtype=dtype, device=device)
    return params, x, ConvODESpec(channels=C, groups=G)


def _conv_inputs(params, x, spec, t, block, first_step=0.05):
    from tfdiffeq_tpu_torch.ops import conv_ode as co
    from tfdiffeq_tpu_torch.ops.cuda_conv import pack_conv_ode_weights
    dtype, dev = x.dtype, x.device
    t = torch.tensor(t, dtype=dtype)
    sign = 1.0 if float(t[-1]) >= float(t[0]) else -1.0
    tau = sign * t
    f0 = sign * co.conv_ode_apply(params, sign * tau[0].to(dev), x, spec)
    n_blocks = -(-x.shape[0] // block)
    dt0 = torch.full((n_blocks,), first_step, dtype=dtype, device=dev)
    wpack = pack_conv_ode_weights(params, spec, dtype, dev)
    return (wpack, spec, x, tau, dt0, 1e-3, 1e-3, sign), dict(
        f0=f0.contiguous(), block_size=block)


@pytest.mark.parametrize("case", [
    (5, 16, 8, 2, [0.0, 0.5, 1.0]),       # small, ragged last block
    (5, 16, 8, 2, [1.0, 0.4, 0.0]),       # reverse time
    (36, 64, 32, 18, [0.0, 1.0]),         # full width, two whole blocks
    (20, 64, 32, 18, [0.0, 1.0]),         # full width, ragged last block
    (7, 12, 4, 3, [0.0, 1.0]),            # a ragged channel tile (12 = 8 + 4)
    (128, 64, 32, 18, [0.0, 1.0]),        # the ODE-Net's batch: 128 CTAs
    (256, 64, 32, 18, [0.0, 1.0]),        # its evaluation batch
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_conv_kernel_matches_plain(cuda, dtype, case):
    """K13 on its grid (each controller block on several CTAs, one or two
    samples a CTA at B = 128 and 256) against its plain version at the
    same grid: identical stats in each block, bitwise equal outputs, and
    bitwise equal from run to run."""
    from tfdiffeq_tpu_torch.ops import cuda_conv as cc
    B, C, G, block, t = case
    params, x, spec = _conv_case(cuda, dtype, B, C, G)
    args, kw = _conv_inputs(params, x, spec, t, block)
    cc.reset_launch_counts()
    out, st = cc.conv_solve(*args, **kw)
    again, st2 = cc.conv_solve(*args, **kw)
    ref, st_ref = cc.conv_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    assert cc.conv_solve_launches == 2
    assert torch.equal(out, again) and torch.equal(st, st2)
    assert st.tolist() == st_ref.tolist()
    assert st.shape == (-(-B // block), 4) and (st[:, 3] == 0).all()
    assert torch.isfinite(out).all()
    assert torch.equal(out, ref)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ctas = cc.conv_ctas(B, block, cuda)
    assert sum(ctas) <= sms and all(1 <= c <= block for c in ctas)
    if B == 128:
        assert sum(ctas) > 8


def test_conv_grid_refuses_what_cannot_be_resident(cuda):
    """A K13 grid of more CTAs than the card holds at once (300 controller
    blocks of one sample, a CTA each) raises, launches nothing and takes
    no plain version; one CTA a controller block on a smaller batch is
    bitwise the plain version at that grid."""
    from tfdiffeq_tpu_torch.ops import cuda_conv as cc
    params, x, spec = _conv_case(cuda, torch.float32, 300, 16, 8)
    args, kw = _conv_inputs(params, x, spec, [0.0, 1.0], 1)
    cc.reset_launch_counts()
    with pytest.raises(RuntimeError, match="conv_solve launch"):
        cc.conv_solve(*args, **kw, max_ctas=300)
    assert cc.conv_solve_launches == 0
    with pytest.raises(ValueError, match="n_blocks"):
        cc.conv_solve(*args, **kw, max_ctas=0)
    params, x, spec = _conv_case(cuda, torch.float64, 20, 16, 8)
    args, kw = _conv_inputs(params, x, spec, [0.0, 1.0], 6)
    out, st = cc.conv_solve(*args, **kw, max_ctas=4)
    ref, st_ref = cc.conv_solve_plain(*args, **kw, max_ctas=4)
    assert cc.conv_ctas(20, 6, cuda, 4) == [1, 1, 1, 1]
    assert torch.equal(out, ref) and torch.equal(st, st_ref.to(st.device))


def test_conv_kernel_status_codes(cuda):
    """An exhausted step budget gives status 1 in every block; times that
    are not increasing give status 3 and a zero tail."""
    from tfdiffeq_tpu_torch.ops import cuda_conv as cc
    params, x, spec = _conv_case(cuda, torch.float32, 4, 16, 8)
    args, kw = _conv_inputs(params, x, spec, [0.0, 1.0], 2, first_step=1e-3)
    _, st = cc.conv_solve(*args, **kw, max_steps=2)
    assert st[:, 3].tolist() == [1, 1] and st[:, 1].tolist() == [2, 2]
    wpack, spec, x, _, dt0, rtol, atol, sign = args
    bad = torch.tensor([0.0, 1.0, 0.5])
    out, st = cc.conv_solve(wpack, spec, x, bad, dt0, rtol, atol, sign, **kw)
    assert st[:, 3].tolist() == [3, 3]
    assert torch.equal(out[0], x) and not out[1:].any()


def test_solve_conv_ode_launches_k13_once(cuda):
    """fast.solve_conv_ode at B = 128 (8 controller blocks of 18): one K13
    launch, finite output, the reference's stats convention."""
    from tfdiffeq_tpu_torch.ops import cuda_conv as cc
    params, x, spec = _conv_case(cuda, torch.float32, 128, 64, 32)
    cc.reset_launch_counts()
    res = fast.solve_conv_ode(params, x, [0.0, 1.0])
    torch.cuda.synchronize()
    assert cc.conv_solve_launches == 1
    assert res.ys.shape == (2, 128, 64, 7, 7) and torch.isfinite(res.ys).all()
    assert res.stats.status == 0 and res.stats.nfe == \
        6 * (res.stats.n_accepted + res.stats.n_rejected) + 2
    args, kw = _conv_inputs(params, x, spec, [0.0, 1.0], 18)
    with pytest.raises(TypeError, match="float32 or float64"):
        cc.conv_solve(args[0].half(), spec, x.half(), *args[3:],
                      f0=kw["f0"].half(), block_size=18)


def test_concat_conv_runs_without_tf32(cuda):
    """The ODE dynamics' convs, forward and both VJPs, in full float32 on
    the card (cuDNN's default TF32 keeps about three digits, which would
    miss by about 1e-3): within 1e-5 of the same conv in float64, relative
    to each output's largest entry."""
    from tfdiffeq_tpu_torch.models.odenet import ConcatConv2d
    m = ConcatConv2d(64, 64, device=cuda)
    m64 = ConcatConv2d(64, 64, device=cuda, dtype=torch.float64)
    m64.load_state_dict(m.state_dict())
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(16, 64, 7, 7), device=cuda)
    gy = torch.tensor(rng.randn(16, 64, 7, 7), device=cuda)
    got = []
    for mod, dtype in ((m, torch.float32), (m64, torch.float64)):
        xx = x.to(dtype).requires_grad_()
        out = mod(0.3, xx)
        torch.sum(out * gy.to(dtype)).backward()
        got.append((out.detach(), xx.grad, mod.conv.weight.grad,
                    mod.conv.bias.grad))
    for a, b in zip(*got):
        assert _rel(a.double(), b) < 1e-5


def _perlane_case(device, dtype, B=300, time_input=False, seed=13):
    """The spiral's tanh MLP on y**3 (with a time column when asked) and
    states whose magnitudes spread over a decade, so that the samples take
    different step counts."""
    rng = np.random.RandomState(seed)
    dims = [(2 + int(time_input), 16), (16, 2)]
    weights = [(torch.tensor(rng.randn(i, o) * 0.3, dtype=dtype,
                             device=device),
                torch.tensor(rng.randn(o) * 0.05, dtype=dtype, device=device))
               for i, o in dims]
    y0 = torch.tensor(rng.randn(B, 2) * np.linspace(0.2, 2.0, B)[:, None],
                      dtype=dtype, device=device)
    spec = fast.MLPSpec(input_power=3, time_input=time_input)
    warr, pdims = ck.pack_mlp_weights(weights, dtype, device)
    return spec, weights, warr, pdims, y0


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "bosh3"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_perlane_kernel_matches_plain(cuda, dtype, sign, method):
    spec, weights, warr, dims, y0 = _perlane_case(
        cuda, dtype, time_input=method == "tsit5")
    t = torch.linspace(0.0, 2.0, 7, dtype=dtype)
    f0 = sign * fast.mlp_apply(spec, weights, y0, t=0.0)
    dt0 = torch.linspace(0.01, 0.1, y0.shape[0], dtype=dtype, device=cuda)
    args = (warr, dims, y0, t, dt0, 1e-6, 1e-8, sign)
    kw = dict(f0=f0, input_power=3, time_input=spec.time_input,
              method=method)
    out, st, lane = cp.mlp_solve_perlane(*args, **kw)
    again = cp.mlp_solve_perlane(*args, **kw)
    ref, st_ref, lane_ref = cp.mlp_solve_perlane_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lane, again[2])
    assert st[3].item() == 0 and len(set(lane[0].tolist())) > 3
    assert st.tolist() == [*lane[:3].sum(dim=1).tolist(), 0]
    if dtype == torch.float64:
        assert torch.equal(lane, lane_ref) and torch.equal(st, st_ref)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-12)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-3, atol=2e-4)
    assert cp.mlp_solve_perlane_launches == 2


def test_perlane_kernel_status_codes(cuda):
    """Status 1 on the samples whose own attempts run out, status 3 on
    every sample for invalid times; unreached rows stay zero."""
    spec, weights, warr, dims, y0 = _perlane_case(cuda, torch.float64)
    t = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    kw = dict(f0=fast.mlp_apply(spec, weights, y0), input_power=3,
              max_steps=6)
    args = (warr, dims, y0, t, 0.05, 1e-8, 1e-10, 1.0)
    out, st, lane = cp.mlp_solve_perlane(*args, **kw)
    ref, st_ref, lane_ref = cp.mlp_solve_perlane_plain(*args, **kw)
    assert torch.equal(lane, lane_ref) and torch.equal(out, ref)
    failed = lane[3] == 1
    assert st[3].item() == 1 and 0 < int(failed.sum()) < y0.shape[0]
    assert not out[-1][failed].any()
    out, st, lane = cp.mlp_solve_perlane(
        warr, dims, y0, torch.tensor([0.0, 1.0, 0.5], dtype=torch.float64),
        0.05, 1e-6, 1e-8, 1.0, input_power=3)
    assert st.tolist() == [0, 0, 0, 3] and (lane[3] == 3).all()
    assert torch.equal(out[0], y0) and not out[1:].any()


@pytest.mark.parametrize("time_input", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_perlane_adjoint_kernel_matches_plain(cuda, dtype, time_input):
    spec, weights, warr, dims, y0 = _perlane_case(cuda, dtype,
                                                  time_input=time_input)
    t = torch.linspace(0.0, 2.0, 6, dtype=dtype)
    ys = fast.solve_mlp_spec(spec, weights, y0, t, rtol=1e-7, atol=1e-9,
                             per_sample=True).ys
    g = torch.tensor(np.random.RandomState(3).randn(*ys.shape), dtype=dtype,
                     device=cuda)
    args = (warr, dims, ys.contiguous(), g, t, 0.05, 1e-6, 1e-8, 1.0)
    kw = dict(input_power=3, time_input=time_input)
    got = cp.mlp_perlane_adjoint_solve(*args, **kw)
    again = cp.mlp_perlane_adjoint_solve(*args, **kw)
    ref = cp.mlp_perlane_adjoint_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[3][3].item() == 0 and len(set(got[4][0].tolist())) > 3
    if dtype == torch.float64:
        assert torch.equal(got[4], ref[4]) and torch.equal(got[3], ref[3])
        for a, b in zip(got[:3], ref[:3]):
            assert _rel(a, b) < 1e-12
    else:
        for a, b in zip(got[:3], ref[:3]):
            assert _rel(a, b) < 1e-3
    assert cp.mlp_perlane_adjoint_solve_launches == 2


def test_perlane_training_launches_k5_and_k6_once(cuda):
    """One per-sample training step: one K5 launch forward, one K6
    backward, no shared-controller launch; lane_stats come back per
    sample."""
    spec, weights, _, _, y0 = _perlane_case(cuda, torch.float32, B=512)
    W = [(w.requires_grad_(), b.requires_grad_()) for w, b in weights]
    t = torch.linspace(0.0, 2.0, 8)
    res = fast.solve_mlp_spec(spec, W, y0, t, rtol=1e-6, atol=1e-6,
                              per_sample=True)
    assert cp.mlp_solve_perlane_launches == 1 and res.stats.status == 0
    assert res.lane_stats.nfe.shape == (512,)
    assert int(res.lane_stats.nfe.sum()) == res.stats.nfe
    ys = fast.odeint_adjoint_mlp(spec, W, y0, t, rtol=1e-6, atol=1e-6,
                                 per_sample=True)
    torch.mean(ys ** 2).backward()
    assert cp.mlp_solve_perlane_launches == 2
    assert cp.mlp_perlane_adjoint_solve_launches == 1
    assert ck.mlp_solve_launches == ca.mlp_adjoint_solve_launches == 0
    for w, b in W:
        assert torch.isfinite(w.grad).all() and torch.isfinite(b.grad).all()


def test_perlane_adjoint_keeps_overflowing_trials_out(cuda):
    """A sample whose first backward trial overflows (a stiff sample with
    a cotangent near the float64 limit, a first step of the whole
    interval) while the others accept: the sums stay finite on the card
    and bitwise equal to the plain version's
    (tests/test_torch_perlane_adjoint.py holds this input to the generic
    adjoint and shows the reference's NaN)."""
    f64 = torch.float64
    W = [(torch.tensor([[100.0]], dtype=f64, device=cuda), None),
         (torch.tensor([[-0.1]], dtype=f64, device=cuda), None)]
    warr, dims = ck.pack_mlp_weights(W, f64, cuda)
    spec = fast.MLPSpec(activation="tanh")
    y0 = torch.tensor([[1e-3], [1.0], [0.5]], dtype=f64, device=cuda)
    t = torch.tensor([0.0, 0.8], dtype=f64)
    ys = fast.solve_mlp_spec(spec, W, y0, t, rtol=1e-9, atol=1e-14,
                             per_sample=True).ys
    g = torch.zeros_like(ys)
    g[1, :, 0] = torch.tensor([5e306, 1.0, -2.0], dtype=f64)
    args = (warr, dims, ys.contiguous(), g, t, 0.8, 1e-9, 1e-14, 1.0)
    got = cp.mlp_perlane_adjoint_solve(*args)
    ref = cp.mlp_perlane_adjoint_solve_plain(*args)
    assert got[3][3].item() == 0 and got[4][2, 0].item() > 0
    assert torch.equal(got[4], ref[4])
    for a, b in zip(got[:3], ref[:3]):
        assert torch.isfinite(a).all() and _rel(a, b) < 1e-12
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The wide route (layers past 128) and the dot-precision tiers (K4)
# ---------------------------------------------------------------------------

def _wide_case(device, dtype, B=48, D=32, H=144, seed=21):
    """A D -> H -> H -> D tanh MLP with small biases (every layer past the
    narrow route's 128 and selected by matmul='auto'), states and times."""
    rng = np.random.RandomState(seed)
    dims = [(D, H), (H, H), (H, D)]
    weights = [(torch.tensor(rng.randn(i, o) / np.sqrt(i), dtype=dtype,
                             device=device),
                torch.tensor(rng.randn(o) * 0.05, dtype=dtype, device=device))
               for i, o in dims]
    y0 = torch.tensor(rng.randn(B, D) * 0.5, dtype=dtype, device=device)
    warr, pdims = ck.pack_mlp_weights(weights, dtype, device)
    t = torch.linspace(0.0, 2.0, 5, dtype=dtype)
    return weights, warr, pdims, y0, t


def _gap(a, b):
    """(largest, mean) |a - b|."""
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


#: (Largest, mean) |kernel - plain| of K8's 16-step float32 tier solve
#: below, and of one evaluation (chip_smoke.py EVAL_BARS). A CPU model of
#: another summation order gives about a tenth of each; the other tiers'
#: plain versions lie 10x or more past the mean bars.
SOLVE_BARS = {"mixed": (1e-5, 1e-6), "bf16": (2e-3, 2e-5)}
EVAL_BARS = {"highest": (0.0, 0.0), "mixed": (2e-5, 2e-6),
             "bf16": (3e-3, 1e-5)}


@pytest.mark.parametrize("kernel", ["K2", "K3", "K5", "K6", "K8", "K9"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_kernels_match_plain(cuda, dtype, kernel):
    """Width 144 (past the narrow route): each MLP kernel takes the wide
    route and is bitwise equal to its plain version, counts included, in
    float32 and float64."""
    weights, warr, dims, y0, t = _wide_case(cuda, dtype)
    spec = fast.MLPSpec(activation="tanh")
    f0 = fast.mlp_apply(spec, weights, y0)
    rng = np.random.RandomState(5)
    if kernel in ("K2", "K5"):
        mod, name = (ck, "mlp_solve") if kernel == "K2" else \
            (cp, "mlp_solve_perlane")
        args = (warr, dims, y0, t, 0.05, 1e-6, 1e-8, 1.0)
        kw = dict(f0=f0)
    elif kernel == "K8":
        mod, name = cf, "mlp_solve_fixed"
        args = (warr, dims, y0, t, uniform_grid(t[0], t[-1], 16), 1.0)
        kw = dict(f0=f0, method="rk4")
    else:
        ys = fast.solve_mlp_spec(spec, weights, y0, t, rtol=1e-7,
                                 atol=1e-9).ys.contiguous()
        g = torch.tensor(rng.randn(*ys.shape), dtype=dtype, device=cuda)
        if kernel == "K9":
            mod, name = cf, "mlp_adjoint_solve_fixed"
            args, kw = (warr, dims, ys, g, t, 1.0), dict(num_steps=3)
        else:
            mod, name = (ca, "mlp_adjoint_solve") if kernel == "K3" else \
                (cp, "mlp_perlane_adjoint_solve")
            args, kw = (warr, dims, ys, g, t, 0.05, 1e-6, 1e-8, 1.0), {}
    got = getattr(mod, name)(*args, **kw)
    ref = getattr(mod, name + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(mod, name + "_launches") == 1
    assert all(torch.isfinite(x).all() for x in got)
    _same(got, ref)


@pytest.mark.parametrize("tier", ["mixed", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tier_solve_kernel_matches_plain(cuda, dtype, tier):
    """K2 with every layer at a reduced tier (the batch route, K4)."""
    weights, warr, dims, y0, t = _wide_case(cuda, dtype)
    tiers = ck.layer_tiers(dims, "auto", tier)
    assert tiers == (tier,) * 3
    f0 = fast.mlp_apply(fast.MLPSpec(), weights, y0)
    args = (warr, dims, y0, t, 0.05, 1e-4, 1e-4, 1.0)
    out, st = ck.mlp_solve(*args, f0=f0, tiers=tiers)
    again, st2 = ck.mlp_solve(*args, f0=f0, tiers=tiers)
    ref, st_ref = ck.mlp_solve_plain(*args, f0=f0, tiers=tiers)
    torch.cuda.synchronize()
    assert ck.mlp_solve_launches == ck.dot_tier_launches == 2
    assert torch.equal(out, again) and torch.equal(st, st2)
    assert st[3].item() == 0 and torch.isfinite(out).all()
    if dtype == torch.float64:
        assert torch.equal(st, st_ref) and torch.equal(out, ref)
        return
    if tier == "mixed":
        assert abs(st[1].item() - st_ref[1].item()) <= 1
        assert abs(st[2].item() - st_ref[2].item()) <= 1
        assert float((out - ref).abs().max()) < 5e-5
        hi = ck.mlp_solve_plain(*args, f0=f0)[0]
        assert float((out - hi).abs().max()) > 5e-5      # a control
    else:
        # Over a whole adaptive solve the controller amplifies the order
        # noise of 'bf16' to the size of the tier's own error (the
        # reference keeps 'bf16' for fixed grids): that budget only.
        assert float((out - ref).abs().max()) < 1e-2
    # One accepted dopri5 step of 0.25 isolates the stage evaluations: the
    # kernel is far nearer its own tier's plain version than the others' on
    # average (a rounding flip can still reach 5e-4 on one output; 'bf16'
    # on the card: mean 2.2e-6 against 8.8e-5 and more).
    one = (warr, dims, y0, torch.tensor([0.0, 0.25], dtype=dtype), 0.25,
           1.0, 1.0, 1.0)
    got, st1 = ck.mlp_solve(*one, f0=f0, tiers=tiers)
    plains = {o: ck.mlp_solve_plain(*one, f0=f0, tiers=ck.layer_tiers(
        dims, "auto", o))[0] for o in ("highest", "mixed", "bf16")}
    own = _gap(got, plains[tier])
    ctl = [_gap(got, r) for o, r in plains.items() if o != tier]
    assert st1.tolist() == [6, 1, 0, 0]
    assert own[0] < {"mixed": 5e-5, "bf16": 2e-3}[tier], (own, ctl)
    assert all(own[1] < c[1] / 10 for c in ctl), (own, ctl)


@pytest.mark.parametrize("tier", ["highest", "mixed", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tier_fixed_kernel_matches_plain(cuda, dtype, tier):
    """K8 at each tier with a time column (split and quantized like the
    state), rk4 on a 16-step grid."""
    rng = np.random.RandomState(22)
    dims = [(33, 144), (144, 32)]
    weights = [(torch.tensor(rng.randn(i, o) / np.sqrt(i), dtype=dtype,
                             device=cuda),
                torch.tensor(rng.randn(o) * 0.05, dtype=dtype, device=cuda))
               for i, o in dims]
    y0 = torch.tensor(rng.randn(70, 32) * 0.5, dtype=dtype, device=cuda)
    warr, pdims = ck.pack_mlp_weights(weights, dtype, cuda)
    spec = fast.MLPSpec(time_input=True)
    t = torch.linspace(0.0, 2.0, 5, dtype=dtype)
    tiers = ck.layer_tiers(pdims, "mxu", tier)
    kw = dict(f0=fast.mlp_apply(spec, weights, y0), time_input=True,
              method="rk4", tiers=tiers)
    args = (warr, pdims, y0, t, uniform_grid(t[0], t[-1], 16), 1.0)
    out, st = cf.mlp_solve_fixed(*args, **kw)
    ref, st_ref = cf.mlp_solve_fixed_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st, st_ref) and st[3].item() == 0
    assert ck.dot_tier_launches == (tier != "highest")
    if dtype == torch.float64 or tier == "highest":
        assert torch.equal(out, ref)
        return
    bar = SOLVE_BARS[tier]
    ok = lambda g: g[0] <= bar[0] and g[1] <= bar[1]
    own = _gap(out, ref)
    ctl = {o: _gap(out, cf.mlp_solve_fixed_plain(*args, **dict(
        kw, tiers=ck.layer_tiers(pdims, "mxu", o)))[0])
        for o in ("highest", "mixed", "bf16") if o != tier}
    assert ok(own), (own, ctl)
    assert not any(ok(c) for c in ctl.values()), (own, ctl)


@pytest.mark.parametrize("time_input", [False, True])
@pytest.mark.parametrize("tier", ["highest", "mixed", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tier_net_matches_plain(cuda, dtype, tier, time_input):
    """K4 alone (`tier_net`, one batch-wide evaluation) at 70 samples (a
    partial block): float64 and 'highest' bitwise equal to the plain net;
    float32 tiers within EVAL_BARS, and outside them against the other
    tiers' plain versions."""
    weights, warr, dims, y0, _ = _wide_case(cuda, dtype, B=70)
    if time_input:
        rng = np.random.RandomState(5)
        weights[0] = (torch.tensor(rng.randn(33, 144) / np.sqrt(33),
                                   dtype=dtype, device=cuda), weights[0][1])
        warr, dims = ck.pack_mlp_weights(weights, dtype, cuda)
    plains = {o: ck._net_plain(warr, dims, "tanh", "identity", 1,
                               time_input, ck.layer_tiers(dims, "auto", o))(
        0.625, y0) for o in ("highest", "mixed", "bf16")}
    got = ck.tier_net(warr, dims, y0, 0.625,
                      tiers=ck.layer_tiers(dims, "auto", tier),
                      time_input=time_input)
    torch.cuda.synchronize()
    assert ck.tier_net_launches == 1 and ck.dot_tier_launches == 0
    if dtype == torch.float64 or tier == "highest":
        assert torch.equal(got, plains[tier])
        return
    bar = EVAL_BARS[tier]
    ok = lambda g: g[0] <= bar[0] and g[1] <= bar[1]
    own = _gap(got, plains[tier])
    ctl = {o: _gap(got, r) for o, r in plains.items() if o != tier}
    assert ok(own), (own, ctl)
    assert not any(ok(c) for c in ctl.values()), (own, ctl)


def test_wide_mixed_training_step(cuda):
    """fast.odeint_adjoint_mlp with a 'mixed' spec on the wide net: K2 on
    the batch route forward (one K4 launch), K3 on the wide route backward
    on the float32 weights; finite gradients."""
    weights, _, _, y0, t = _wide_case(cuda, torch.float32, B=64)
    W = [(w.requires_grad_(), b.requires_grad_()) for w, b in weights]
    spec = fast.MLPSpec(activation="tanh", dot_precision="mixed")
    ys = fast.odeint_adjoint_mlp(spec, W, y0, t, rtol=1e-4, atol=1e-4)
    torch.mean(ys ** 2).backward()
    assert ck.mlp_solve_launches == ck.dot_tier_launches == 1
    assert ca.mlp_adjoint_solve_launches == 1
    for w, b in W:
        assert torch.isfinite(w.grad).all() and torch.isfinite(b.grad).all()


def _cnf_case(device, dtype, H, B, seed=31):
    """A concat-t flow 3 -> H -> H -> 2 and the CNF state [z; 0] at B
    samples, integrated from t = 1 to 0 (tau = [-1, -0.5, 0], sign -1)."""
    rng = np.random.RandomState(seed)
    W = [(torch.tensor(rng.randn(i, o) * 0.6 / np.sqrt(i), dtype=dtype,
                       device=device),
          torch.tensor(rng.randn(o) * 0.1, dtype=dtype, device=device))
         for i, o in ((3, H), (H, H), (H, 2))]
    packed, dims = ck.pack_mlp_weights(W, dtype, device)
    s0 = torch.cat([torch.tensor(rng.randn(B, 2), dtype=dtype, device=device),
                    torch.zeros(B, 1, dtype=dtype, device=device)], dim=1)
    tau = torch.tensor([-1.0, -0.5, 0.0], dtype=dtype)
    f0 = -ck._cnf_net_plain(packed, dims, "tanh")(
        torch.tensor(1.0, dtype=dtype, device=device), s0)
    return W, packed, dims, s0, tau, f0.contiguous()


@pytest.mark.parametrize("H,B,route", [
    (64, 96, ck.ROUTE_NARROW), (144, 40, ck.ROUTE_WIDE),
    (32, 4096, ck.ROUTE_NARROW), (32, 2048, ck.ROUTE_NARROW),
    (32, 512, ck.ROUTE_NARROW), (32, 100, ck.ROUTE_NARROW),
    (64, 4096, ck.ROUTE_NARROW), (64, 2048, ck.ROUTE_NARROW),
    (64, 512, ck.ROUTE_NARROW), (64, 100, ck.ROUTE_NARROW),
    (144, 512, ck.ROUTE_WIDE)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cnf_kernels_match_plain(cuda, dtype, H, B, route):
    """K7's forward in K2 and its adjoint in K3 (rhs='cnf'), narrow and wide,
    at batches that give a block about 31, 16, 4 and 1 samples (a group of
    16, 32, 128 and 512 threads a sample): bitwise equal to their plain
    versions with identical stats. The layouts are the ones the launches
    report: K2 a round of as many samples as a block owns, up to 32
    (csrc/lane_group.h kGroupSlots), K3 at most that many."""
    _, packed, dims, s0, tau, f0 = _cnf_case(cuda, dtype, H, B)
    assert ck._route("t", dims, packed.numel(), s0.element_size()) == route
    nb = ck.solve_blocks(B, cuda)
    per = -(-B // nb)
    round_max = min(32, 1 << (per - 1).bit_length())
    args = (packed, dims, s0, tau, 0.05, 1e-5, 1e-7, -1.0)
    kw = dict(f0=f0, activation="tanh", time_input=True, rhs="cnf")
    out, st = ck.mlp_solve(*args, **kw)
    lay = ck.last_solve_layout
    assert lay["blocks"] == nb and lay["slots"] == round_max
    assert lay["slots"] * lay["threads_a_sample"] == ck.SOLVE_THREADS
    ref, st_r = ck.mlp_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    assert st.tolist() == st_r.tolist() and st[3].item() == 0
    assert torch.equal(out, ref)
    assert ck.mlp_solve_launches == ck.cnf_solve_launches == 1
    g = torch.tensor(np.random.RandomState(32).randn(*out.shape),
                     dtype=dtype, device=cuda)
    aargs = (packed, dims, out.contiguous(), g, tau, 0.05, 1e-5, 1e-7, -1.0)
    got = ca.mlp_adjoint_solve(*aargs, activation="tanh", rhs="cnf")
    want = ca.mlp_adjoint_solve_plain(*aargs, activation="tanh", rhs="cnf")
    torch.cuda.synchronize()
    alay = ca.last_adjoint_layout
    assert alay["slot_values"] == ca.cnf_aug_slot_values(dims)
    assert 1 <= alay["slots"] <= round_max
    assert alay["slots"] * alay["threads_a_sample"] == ca.ADJOINT_THREADS
    assert got[3].tolist() == want[3].tolist() and got[3][3].item() == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ca.mlp_adjoint_solve_launches == ca.cnf_adjoint_launches == 1


def test_cnf_wrappers_raise_instead_of_falling_back(cuda):
    """A flow wider than MAX_WIDTH and a state that is not [z; logp] for
    the flow raise on the card; nothing launches, no plain version runs."""
    _, packed, dims, s0, tau, f0 = _cnf_case(cuda, torch.float32, 8, 16)
    warr, wide = ck.pack_mlp_weights(
        [(torch.zeros(3, 513), None), (torch.zeros(513, 2), None)],
        torch.float32, cuda)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        ck.mlp_solve(warr, wide, s0, tau, 0.1, 1e-5, 1e-7, -1.0, f0=f0,
                     rhs="cnf")
    ys = torch.zeros(3, 16, 3, device=cuda)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        ca.mlp_adjoint_solve(warr, wide, ys, ys, tau, 0.1, 1e-5, 1e-7, -1.0,
                             rhs="cnf")
    s4 = torch.zeros(16, 4, device=cuda)
    with pytest.raises(ValueError, match="rhs='cnf'"):
        ck.mlp_solve(packed, dims, s4, tau, 0.1, 1e-5, 1e-7, -1.0, f0=s4,
                     rhs="cnf")
    with pytest.raises(ValueError, match="rhs='cnf'"):
        ca.mlp_adjoint_solve(packed, dims, ys[..., :2].contiguous(),
                             ys[..., :2].contiguous(), tau, 0.1, 1e-5, 1e-7,
                             -1.0, rhs="cnf")
    assert ck.mlp_solve_launches == ca.mlp_adjoint_solve_launches == 0


def test_cnf_entry_points_launch_k7(cuda):
    """fast.cnf_log_prob_fused is one K2 launch with K7's forward,
    cnf_log_prob_train one K2 and one K3 with K7 (a chunk), and
    cnf_sample_fused one K2 of the plain concat-t MLP."""
    W, _, _, s0, _, _ = _cnf_case(cuda, torch.float32, 16, 64)
    x = s0[:, :2].contiguous()
    lp, st = fast.cnf_log_prob_fused(W, x)
    assert st.status == 0 and torch.isfinite(lp).all()
    assert ck.mlp_solve_launches == ck.cnf_solve_launches == 1
    ck.reset_launch_counts()
    Wg = [(w.clone().requires_grad_(), b.clone().requires_grad_())
          for w, b in W]
    lp2 = fast.cnf_log_prob_train(Wg, x)
    torch.testing.assert_close(lp2.detach(), lp, rtol=0.0, atol=0.0)
    (-lp2.mean()).backward()
    assert ck.cnf_solve_launches == ca.cnf_adjoint_launches == 1
    assert all(torch.isfinite(v.grad).all() for pair in Wg for v in pair)
    ck.reset_launch_counts()
    xs = fast.cnf_sample_fused(W, torch.Generator(device=cuda).manual_seed(0),
                               32, 2)
    assert ck.mlp_solve_launches == 1 and ck.cnf_solve_launches == 0
    assert xs.shape == (32, 2) and torch.isfinite(xs).all()


# ---------------------------------------------------------------------------
# K10 and K11: the whole fixed-step Adams and VCABM solves
# ---------------------------------------------------------------------------

def _adams_case(device, dtype, width=24, time_input=False, B=300, seed=21):
    """A tanh MLP (the state cubed, or a time column) and a state, drawn
    with numpy; B leaves threads of the last block idle."""
    rng = np.random.RandomState(seed)
    dims = [(2 + int(time_input), width), (width, 2)]
    weights = [(torch.tensor(rng.randn(i, o) * 0.5 / np.sqrt(i), dtype=dtype,
                             device=device),
                torch.tensor(rng.randn(o) * 0.05, dtype=dtype, device=device))
               for i, o in dims]
    y0 = torch.tensor(rng.randn(B, 2), dtype=dtype, device=device)
    warr, pdims = ck.pack_mlp_weights(weights, dtype, device)
    kw = dict(activation="tanh", input_power=1 if time_input else 3,
              time_input=time_input)
    return warr, pdims, y0, kw


@pytest.mark.parametrize("order, iters", [(1, 4), (4, 4), (12, 1)])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adams_kernel_matches_plain(cuda, dtype, sign, implicit, order,
                                    iters):
    """K10 bitwise equal to its plain version: both methods, orders 1, 4
    and 12, both directions, a Hermite grid with a time column and the
    default grid; bitwise from run to run."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad
    cad.reset_launch_counts()
    for time_input, steps in ((False, None), (True, 40)):
        warr, dims, y0, kw = _adams_case(cuda, dtype, time_input=time_input)
        t = torch.tensor([0.0, 0.37, 1.11, 2.0], dtype=dtype)
        tau = sign * t if sign > 0 else (sign * t).flip(0)
        grid = tau if steps is None else uniform_grid(tau[0], tau[-1], steps)
        args = (warr, dims, y0, tau, grid, 1e-6, 1e-8, sign)
        kw = dict(kw, implicit=implicit, max_order=order, max_iters=iters)
        got = cad.mlp_solve_adams(*args, **kw)
        again = cad.mlp_solve_adams(*args, **kw)
        ref = cad.mlp_solve_adams_plain(*args, f0=cad._f0(
            warr, dims, y0, grid[0], sign, kw["activation"], "identity",
            kw["input_power"], kw["time_input"]), **kw)
        torch.cuda.synchronize()
        assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
        _same(got, again)
        _same(got, ref)
    assert cad.mlp_solve_adams_launches == 4


@pytest.mark.parametrize("order", [1, 4, 12])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vcabm_kernel_matches_plain(cuda, dtype, sign, order):
    """K11 bitwise equal to its plain version with identical stats, at
    orders 1, 4 and 12, both directions, with and without a time column;
    bitwise from run to run."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad
    cad.reset_launch_counts()
    for time_input in (False, True):
        warr, dims, y0, kw = _adams_case(cuda, dtype, time_input=time_input)
        t = torch.tensor([0.0, 0.37, 1.11, 2.0], dtype=dtype)
        tau = sign * t if sign > 0 else (sign * t).flip(0)
        args = (warr, dims, y0, tau, 0.02, 1e-5, 1e-7, sign)
        kw = dict(kw, max_order=order)
        got = cad.mlp_solve_vcabm(*args, **kw)
        again = cad.mlp_solve_vcabm(*args, **kw)
        ref = cad.mlp_solve_vcabm_plain(*args, f0=cad._f0(
            warr, dims, y0, tau[0], sign, kw["activation"], "identity",
            kw["input_power"], kw["time_input"]), **kw)
        torch.cuda.synchronize()
        assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
        _same(got, again)
        _same(got, ref)
    assert cad.mlp_solve_vcabm_launches == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adams_kernels_wide_route_and_statuses(cuda, dtype):
    """Past 128-wide layers K10 and K11 take the wide route, bitwise equal
    to their plain versions; K11's statuses 1 (max_steps) and 3 (invalid
    times) and K10's 3 match the plain versions' too."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad
    warr, dims, y0, kw = _adams_case(cuda, dtype, width=160, B=96)
    t = torch.linspace(0.0, 1.0, 4, dtype=dtype)
    f0 = cad._f0(warr, dims, y0, t[0], 1.0, "tanh", "identity", 3, False)
    bad = torch.tensor([0.0, 1.0, 0.5], dtype=dtype)
    for args, extra in (((t, t, 1e-6, 1e-8, 1.0), dict(implicit=True)),
                        ((t, uniform_grid(t[0], t[-1], 30), 1e-6, 1e-8,
                          1.0), dict(implicit=False)),
                        ((bad, bad, 1e-6, 1e-8, 1.0), {})):
        got = cad.mlp_solve_adams(warr, dims, y0, *args, **kw, **extra)
        ref = cad.mlp_solve_adams_plain(warr, dims, y0, *args, f0=f0, **kw,
                                        **extra)
        _same(got, ref)
    for tau, extra, status in ((t, {}, 0), (t, dict(max_steps=5), 1),
                               (bad, {}, 3)):
        args = (warr, dims, y0, tau, 0.02, 1e-6, 1e-8, 1.0)
        got = cad.mlp_solve_vcabm(*args, **kw, **extra)
        ref = cad.mlp_solve_vcabm_plain(*args, f0=f0, **kw, **extra)
        assert got[1][3].item() == status
        _same(got, ref)


@pytest.mark.parametrize("B", [4096, 256, 33, 1])
@pytest.mark.parametrize("route", ["narrow", "wide", "plan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adams_group_matches_plain(cuda, dtype, route, B):
    """explicit_adams' K10 with a group of threads a sample (16 on the
    narrow and plan routes, FIXED_WIDE_GROUP on the wide one, 512-thread
    blocks; B = 33 and 1 leave groups past B) bitwise equal to its plain
    version at max_order 1 and 12, forward and in reverse time on a Hermite
    grid; run to run; the launch reports the layout the wrapper expects.
    The span is short: AB12 multiplies roundoff by about 1e5 over 40 steps
    of 0.0125."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_plan as cpl
    t = torch.tensor([0.0, 0.1, 0.3, 0.5], dtype=dtype)
    for order, sign in ((1, 1.0), (12, -1.0)):
        tau = sign * t if sign > 0 else (sign * t).flip(0)
        grid = uniform_grid(tau[0], tau[-1], 40)
        if route == "plan":
            # The bench spiral as plain PyTorch (bounded by its tanh).
            from tfdiffeq_tpu_torch.ops import plan_bridge as pb
            p, y0 = _bench(B, dtype, cuda)
            plan, consts = pb.build_plan(
                lambda tt, yy: torch.tanh((yy ** 3) @ p["w1"] + p["b1"])
                @ p["w2"] + p["b2"], t[0].to(cuda), y0)
            packed = pb.pack_consts(plan, consts, dtype, cuda)
            g = cpl.plan_rhs(plan, packed, torch.tensor(
                sign, dtype=dtype, device=cuda))
            f0 = g(grid[0].to(cuda), y0).contiguous()
            args = (plan, packed, y0, tau, grid, 1e-6, 1e-6, sign, f0)
            kw = dict(implicit=False, max_order=order)
            got = cpl.plan_solve_adams(*args, **kw)
            layout = cpl.last_layout["adams"]
            assert torch.isfinite(got[0]).all()
            _same(got, cpl.plan_solve_adams(*args, **kw))
            ref = cad.adams_solve_plain(g, y0, f0, tau, grid, 1e-6, 1e-6,
                                        **kw)
            group = cf.FIXED_GROUP
        else:
            warr, dims, y0, kw = _adams_case(
                cuda, dtype, width=160 if route == "wide" else 24, B=B)
            y0 = 0.5 * y0
            args = (warr, dims, y0, tau, grid, 1e-6, 1e-8, sign)
            kw = dict(kw, implicit=False, max_order=order)
            got = cad.mlp_solve_adams(*args, **kw)
            layout = cad.last_adams_layout
            assert torch.isfinite(got[0]).all()
            _same(got, cad.mlp_solve_adams(*args, **kw))
            ref = cad.mlp_solve_adams_plain(*args, f0=cad._f0(
                warr, dims, y0, grid[0], sign, kw["activation"], "identity",
                kw["input_power"], kw["time_input"]), **kw)
            group = cf.FIXED_WIDE_GROUP if route == "wide" else cf.FIXED_GROUP
        torch.cuda.synchronize()
        assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
        _same(got, ref)
        assert layout["threads_a_sample"] == group
        assert layout["samples_a_block"] == cad.ADAMS_THREADS // group


def test_group_wrappers_do_not_wait_for_the_card(cuda):
    """explicit_adams' K10 and K12 wrappers return while a sleep queued
    before them still runs (the times' validity is decided on the card),
    and times that do not increase give status 3 with a zero tail, as
    their plain versions do."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_plan as cpl
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    warr, dims, y0, kw = _adams_case(cuda, torch.float32, B=256)
    t = torch.linspace(0.0, 1.0, 5)
    f0 = cad._f0(warr, dims, y0, t[0], 1.0, "tanh", "identity",
                 kw["input_power"], False)
    f, g, hy0 = _hyper_case(torch.float32, cuda, B=256)
    t0 = torch.tensor(0.0, device=cuda)
    pf, cfs = pb.build_plan(f, t0, hy0)
    pg, cgs = pb.build_plan(lambda tt, ss: g(tt, ss[:, :2], ss[:, 2:]), t0,
                            torch.cat([hy0, f(t0, hy0)], 1), out_dim=2)
    hargs = (pf, pg, pb.pack_consts(pf, cfs, torch.float32, cuda),
             pb.pack_consts(pg, cgs, torch.float32, cuda), hy0)
    calls = {"K10": lambda tt: cad.mlp_solve_adams(
                 warr, dims, y0, tt, tt, 1e-6, 1e-8, 1.0, f0=f0,
                 implicit=False, **kw),
             "K12": lambda tt: cpl.plan_solve_hyper(
                 *hargs, tt, tt, 1.0, kind="heun", grid_is_t=True)}
    for name, call in calls.items():
        call(t)                       # builds and warms up
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        out, st = call(t)
        assert not torch.cuda.current_stream().query(), name
        torch.cuda.synchronize()
        assert st[3].item() == 0 and torch.isfinite(out).all()
        bad = torch.tensor([0.0, 0.5, 0.4, 1.0])
        out, st = call(bad)
        assert st.tolist() == [0, 0, 0, 3], name
        assert not out[1:].any()
    bad = torch.tensor([0.0, 0.5, 0.4, 1.0])
    ref = cad.mlp_solve_adams_plain(warr, dims, y0, bad, bad, 1e-6, 1e-8,
                                    1.0, f0=f0, implicit=False, **kw)
    _same(calls["K10"](bad), ref)
    ref = cpl.plan_solve_hyper_plain(*hargs, bad, bad, 1.0, kind="heun",
                                     grid_is_t=True)
    _same(calls["K12"](bad), ref)


def test_adams_entry_points_launch_k10_k11(cuda):
    """fast.solve_mlp_spec is one K10 launch for explicit_adams and
    fixed_adams and one K11 for adams; an Adams-forward training step is
    K11 + K3 (adjoint dopri5) or K10 + K9 (adjoint rk4); an Adams
    adjoint_method raises before any launch; the tiers are refused."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad
    cad.reset_launch_counts()
    p, y = _bench(512, torch.float32, cuda)
    W = [(p["w1"].requires_grad_(), p["b1"].requires_grad_()),
         (p["w2"].requires_grad_(), p["b2"].requires_grad_())]
    t = torch.linspace(0.0, 5.0, 12)
    spec = fast.MLPSpec(activation="tanh", input_power=3)
    for method in ("explicit_adams", "fixed_adams"):
        res = fast.solve_mlp_spec(spec, W, y, t, method=method, num_steps=64)
        assert res.stats.status == 0 and torch.isfinite(res.ys).all()
    res = fast.solve_mlp_spec(spec, W, y, t, method="adams", first_step=0.01)
    assert res.stats.status == 0 and torch.isfinite(res.ys).all()
    assert (cad.mlp_solve_adams_launches,
            cad.mlp_solve_vcabm_launches) == (2, 1)
    for method, adjoint_method, counts in (
            ("adams", "dopri5", (2, 2, 1, 0)),
            ("fixed_adams", "rk4", (3, 2, 1, 1))):
        ys = fast.odeint_adjoint_mlp(spec, W, y, t, rtol=1e-6, atol=1e-6,
                                     method=method,
                                     adjoint_method=adjoint_method,
                                     num_steps=64, adjoint_num_steps=4,
                                     first_step=0.01)
        torch.mean(ys ** 2).backward()
        assert (cad.mlp_solve_adams_launches, cad.mlp_solve_vcabm_launches,
                ca.mlp_adjoint_solve_launches,
                cf.mlp_adjoint_solve_fixed_launches) == counts
        assert all(torch.isfinite(x.grad).all() for pair in W for x in pair)
    with pytest.raises(ValueError, match="adjoint_method='adams'"):
        fast.odeint_adjoint_mlp(spec, W, y, t, method="adams")
    with pytest.raises(ValueError, match="not supported on the Adams"):
        fast.solve_mlp_spec(fast.MLPSpec(matmul="mxu", dot_precision="bf16"),
                            W, y, t, method="fixed_adams")
    assert (cad.mlp_solve_adams_launches,
            cad.mlp_solve_vcabm_launches) == (3, 2)


# ---------------------------------------------------------------------------
# K14: generated plans inside K2, K8 and K5 (ops/cuda_plan.py)
# ---------------------------------------------------------------------------

def _plan_dyns(dtype, device):
    """Plain PyTorch dynamics that cover the plan's ops: products against
    captured weights and module parameters, a time column, the activations,
    round-half-even, a feature flip, trig and inverse hyperbolics, and the
    batch couplings (K2 only)."""
    rng = np.random.RandomState(3)
    c = lambda a: torch.tensor(a, dtype=dtype, device=device)
    A = c([[-0.1, 2.0], [-2.0, -0.1]])
    W1, b1, W2 = c(rng.randn(3, 16) * 0.3), c(rng.randn(16) * 0.1), \
        c(rng.randn(16, 2) * 0.3)
    WF = c(rng.randn(3, 3) * 0.3)
    return {
        "spiral": (lambda t, y: (y ** 3) @ A, 2),
        "concat_t_gelu": (lambda t, y: torch.nn.functional.gelu(
            torch.cat([y, t.expand(y.shape[0], 1)], 1) @ W1 + b1) @ W2, 2),
        "gated_sigmoid": (lambda t, y: torch.where(
            y > 0, -0.5 * y, torch.sigmoid(y) - 0.6) + 0.1 * torch.sin(t), 2),
        "ops": (lambda t, y: 0.1 * (torch.tan(0.3 * y) + torch.asinh(y)
                                    + torch.atanh(0.5 * torch.tanh(y))
                                    + torch.erf(y) + torch.flip(y, (1,))
                                    + torch.round(4 * y) / 64
                                    + torch.expm1(-y * y)) - y, 2),
        "meanfield": (lambda t, y: torch.tanh(y @ WF)
                      - 0.5 * (y - y.mean(0)), 3),
        "scalar_coupled": (lambda t, y: torch.tanh(y @ WF)
                           - 0.1 * (y ** 2).mean() * y, 3),
        "bmax": (lambda t, y: torch.tanh(y @ WF) - 0.3 * (y - y.amax(0)), 3),
    }


def _plan_case(name, dtype, device, B=96):
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl, plan_bridge as pb
    f, D = _plan_dyns(dtype, device)[name]
    y0 = torch.tensor(np.random.RandomState(1).randn(B, D), dtype=dtype,
                      device=device)
    t = torch.linspace(0.0, 2.0, 7, dtype=dtype)
    plan, consts = pb.build_plan(f, t[0].to(device), y0)
    packed = pb.pack_consts(plan, consts, dtype, device)
    g = cpl.plan_rhs(plan, packed, torch.tensor(1.0, dtype=dtype,
                                                 device=device))
    return plan, packed, y0, t, g, g(t[0].to(device), y0).contiguous()


def _same(got, ref):
    """Bitwise equal, tensor by tensor (asserted, so that a bare call
    checks too); True."""
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    return True


@pytest.mark.parametrize("name", ["spiral", "concat_t_gelu",
                                  "gated_sigmoid", "ops", "meanfield",
                                  "scalar_coupled", "bmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_hosts_match_plain(cuda, dtype, name):
    """K14 in K2 (coupled plans batch-wide), K8 and K5: bitwise equal to
    the plain engines with `eval_plan`, identical stats, and run to run;
    the launch counters move, the plain engines are never reached."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    cpl.reset_launch_counts()
    plan, packed, y0, t, g, f0 = _plan_case(name, dtype, cuda)
    args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    got = cpl.plan_solve(*args)
    assert _same(got, cpl.plan_solve(*args))
    # The wrapper's grid: one block per SM, one block for a coupled plan.
    ref = ck.adaptive_solve_plain(
        g, y0, f0, t, 0.01, 1e-6, 1e-6, ck.TABLEAUS_BY_NAME["dopri5"],
        safety=0.9, ifactor=10.0, dfactor=0.2, max_steps=2 ** 31 - 1,
        threads=ck.SOLVE_THREADS,
        n_blocks=cpl.plan_blocks(plan, y0.shape[0], cuda))
    assert _same(got, ref), (got[1].tolist(), ref[1].tolist())
    assert got[1][3].item() == 0
    if plan.batch_coupled:
        assert cpl.plan_solve_launches == 2
        return
    grid = uniform_grid(t[0], t[-1], 40)
    got = cpl.plan_solve_fixed(plan, packed, y0, t, grid, 1.0, f0)
    ref = cf.fixed_solve_plain(g, y0, f0, t, grid,
                               cf.FIXED_TABLEAUS_BY_NAME["rk4"])
    assert _same(got, ref)
    got = cpl.plan_solve(*args, per_sample=True)
    ref = cp.perlane_solve_plain(
        g, y0, f0, t, 0.01, 1e-6, 1e-6, cp.TABLEAUS_BY_NAME["dopri5"],
        safety=0.9, ifactor=10.0, dfactor=0.2, max_steps=2 ** 31 - 1)
    assert _same(got, ref)
    assert (cpl.plan_solve_launches, cpl.plan_fixed_launches,
            cpl.plan_perlane_launches) == (2, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_constants_past_shared_memory(cuda, dtype):
    """A plan whose constants pass 220 KB reads them from global memory,
    bitwise equal to its plain version on every host."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl, plan_bridge as pb
    rng = np.random.RandomState(4)
    c = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    Ws = [c(rng.randn(2, 256) / 2), c(rng.randn(256, 256) / 16),
          c(rng.randn(256, 2) / 16)]

    def f(t, y):
        return torch.tanh(torch.tanh(y @ Ws[0]) @ Ws[1]) @ Ws[2]

    y0 = torch.tensor(rng.randn(64, 2), dtype=dtype, device=cuda)
    t = torch.linspace(0.0, 1.0, 4, dtype=dtype)
    plan, consts = pb.build_plan(f, t[0].to(cuda), y0)
    packed = pb.pack_consts(plan, consts, dtype, cuda)
    g = cpl.plan_rhs(plan, packed, torch.tensor(1.0, dtype=dtype,
                                                 device=cuda))
    f0 = g(t[0].to(cuda), y0).contiguous()
    args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    got = cpl.plan_solve(*args)
    assert cpl.last_route["solve"] == "global"
    ref = ck.adaptive_solve_plain(
        g, y0, f0, t, 0.01, 1e-6, 1e-6, ck.TABLEAUS_BY_NAME["dopri5"],
        safety=0.9, ifactor=10.0, dfactor=0.2, max_steps=2 ** 31 - 1,
        threads=ck.SOLVE_THREADS)
    assert _same(got, ref)
    grid = uniform_grid(t[0], t[-1], 8)
    got = cpl.plan_solve_fixed(plan, packed, y0, t, grid, 1.0, f0)
    assert cpl.last_route["fixed"] == "global"
    assert _same(got, cf.fixed_solve_plain(g, y0, f0, t, grid,
                                           cf.FIXED_TABLEAUS_BY_NAME["rk4"]))
    got = cpl.plan_solve(*args, per_sample=True)
    assert cpl.last_route["perlane"] == "global"
    assert _same(got, cp.perlane_solve_plain(
        g, y0, f0, t, 0.01, 1e-6, 1e-6, cp.TABLEAUS_BY_NAME["dopri5"],
        safety=0.9, ifactor=10.0, dfactor=0.2, max_steps=2 ** 31 - 1))


def test_fused_entry_points_launch_and_never_fall_back(cuda, monkeypatch):
    """odeint(options={'fuse': True}) and fast.solve_fused on the card:
    one plan launch each, no plain engine reached (they are replaced by a
    function that raises), no fallback counted; a broken generated source
    raises RuntimeError (never FusionError, never the generic engine)."""
    from tfdiffeq_tpu_torch import odeint
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl

    def never(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("adaptive_solve_plain", "fixed_solve_plain",
                 "perlane_solve_plain"):
        monkeypatch.setattr(cpl, name, never)
    cpl.reset_launch_counts()
    before = fast.fuse_fallbacks
    p, y = _bench(256, torch.float32, cuda)
    t = torch.linspace(0.0, 5.0, 12)

    def f(tt, yy):
        return torch.tanh((yy ** 3) @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    ys = odeint(f, y, t, rtol=1e-6, atol=1e-6,
                options={"fuse": True, "first_step": 0.01})
    ref = fast.solve_mlp(p, y, t, rtol=1e-6, atol=1e-6, first_step=0.01)
    torch.testing.assert_close(ys, ref.ys, rtol=1e-3, atol=2e-4)
    res = fast.solve_fused(f, y, t, method="rk4", num_steps=50)
    res2 = fast.solve_fused(f, y, t, per_sample=True)
    assert res.stats.status == 0 and res2.stats.status == 0
    assert (cpl.plan_solve_launches, cpl.plan_fixed_launches,
            cpl.plan_perlane_launches) == (1, 1, 1)
    assert fast.fuse_fallbacks == before

    cpl.source.cache_clear()
    monkeypatch.setattr(cpl.plan_codegen, "cuda_source",
                        lambda plan, host, *tier: "#error a broken plan\n")
    g = lambda tt, yy: -yy * 0.5 + 0.25 * torch.cos(yy)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        odeint(g, y, t, options={"fuse": True})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fast.solve_fused(g, y, t)
    assert fast.fuse_fallbacks == before
    cpl.source.cache_clear()


# ---------------------------------------------------------------------------
# K15: the plan's reverse walk inside K3, K6 and K9 (ops/cuda_plan.py)
# ---------------------------------------------------------------------------

def _aug_case(name, dtype, device, B=96):
    """A plan of `_plan_dyns` (or 'drive': a per-sample constant and a
    learnable scalar) at batch B, its forward trajectory from the plain
    solve and a seeded output cotangent."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl, plan_bridge as pb
    if name == "drive":
        rng = np.random.RandomState(5)
        W = torch.tensor(rng.randn(2, 8) * 0.4, dtype=dtype, device=device)
        V = torch.tensor(rng.randn(8, 2) * 0.4, dtype=dtype, device=device)
        DR = torch.tensor(rng.randn(B, 2) * 0.3, dtype=dtype, device=device)
        k = torch.nn.Parameter(torch.tensor(0.4, dtype=dtype, device=device))
        f = lambda t, y: torch.tanh(y @ W) @ V + DR * y - k * y * torch.sin(t)
        y0 = torch.tensor(np.random.RandomState(1).randn(B, 2), dtype=dtype,
                          device=device)
        t = torch.linspace(0.0, 2.0, 7, dtype=dtype)
        plan, consts = pb.build_plan(f, t[0].to(device), y0)
        packed = pb.pack_consts(plan, consts, dtype, device)
        g = cpl.plan_rhs(plan, packed, torch.tensor(1.0, dtype=dtype,
                                                     device=device))
        f0 = g(t[0].to(device), y0).contiguous()
    else:
        plan, packed, y0, t, g, f0 = _plan_case(name, dtype, device, B)
    ys, st = cpl.plan_solve_plain(plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0,
                                  f0)
    assert int(st[3]) == 0
    ct = torch.tensor(np.random.RandomState(2).randn(*ys.shape), dtype=dtype,
                      device=device)
    return plan, packed, ys.contiguous(), ct, t


def _same_sweep(a, b):
    flat = lambda r: [x for v in r for x in (v if isinstance(v, list)
                                             else [v])]
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


@pytest.mark.parametrize("name", ["spiral", "concat_t_gelu",
                                  "gated_sigmoid", "ops", "drive",
                                  "meanfield", "scalar_coupled", "bmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_adjoint_hosts_match_plain(cuda, dtype, name):
    """K15 in K3 (coupled plans batch-wide), K6 and K9: bitwise equal to
    the plain sweeps with `aug_terms` on the card, identical stats, and
    run to run; each sweep moves its launch counter by one."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    cpl.reset_launch_counts()
    plan, packed, ys, ct, t = _aug_case(name, dtype, cuda)
    args = (plan, packed, ys, ct, t, 0.05, 1e-6, 1e-6, 1.0)
    got = cpl.plan_adjoint_solve(*args)
    assert _same_sweep(got, cpl.plan_adjoint_solve(*args))
    ref = cpl.plan_adjoint_solve_plain(*args)
    assert _same_sweep(got, ref), (got[3].tolist(), ref[3].tolist())
    assert got[3][3].item() == 0
    if plan.batch_coupled:
        assert cpl.plan_adjoint_launches == 2
        return
    got = cpl.plan_perlane_adjoint_solve(*args)
    assert _same_sweep(got, cpl.plan_perlane_adjoint_solve_plain(*args))
    got = cpl.plan_adjoint_solve_fixed(plan, packed, ys, ct, t, 1.0,
                                       num_steps=4)
    assert _same_sweep(got, cpl.plan_adjoint_solve_fixed_plain(
        plan, packed, ys, ct, t, 1.0, num_steps=4))
    assert (cpl.plan_adjoint_launches, cpl.plan_perlane_adjoint_launches,
            cpl.plan_fixed_adjoint_launches) == (2, 1, 1)


@pytest.mark.parametrize("B", [1, 33, 300, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_group_walks_match_plain(cuda, dtype, B):
    """The generated group walks: K14 in K5 and K8, K15 in K6 and K9, with
    a time column and a per-sample constant,
    at B = 1, 33, 300 and 4097 (idle groups in the last block): bitwise
    equal to the unchanged plain versions and from run to run; each host
    records the group its walk took."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    plan, packed, y0, t, g, f0 = _plan_case("concat_t_gelu", dtype, cuda, B)
    args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    got = cpl.plan_solve(*args, per_sample=True)
    assert _same(got, cpl.plan_solve(*args, per_sample=True))
    assert _same(got, cpl.plan_solve_plain(*args, per_sample=True))
    assert cpl.last_group["perlane"] == cpl.PERLANE_GROUP
    grid = uniform_grid(t[0], t[-1], 40)
    got = cpl.plan_solve_fixed(plan, packed, y0, t, grid, 1.0, f0)
    assert _same(got, cpl.plan_solve_fixed(plan, packed, y0, t, grid, 1.0,
                                           f0))
    assert _same(got, cpl.plan_solve_fixed_plain(plan, packed, y0, t, grid,
                                                 1.0, f0))
    assert cpl.last_group["fixed"] == cpl.FIXED_GROUP
    plan, packed, ys, ct, t = _aug_case("drive", dtype, cuda, B)
    args = (plan, packed, ys, ct, t, 0.05, 1e-6, 1e-6, 1.0)
    got = cpl.plan_perlane_adjoint_solve(*args)
    assert _same_sweep(got, cpl.plan_perlane_adjoint_solve(*args))
    assert _same_sweep(got, cpl.plan_perlane_adjoint_solve_plain(*args))
    assert cpl.last_group["perlane_adjoint"] == cpl.PERLANE_GROUP
    fargs = (plan, packed, ys, ct, t, 1.0)
    got = cpl.plan_adjoint_solve_fixed(*fargs, num_steps=4)
    assert _same_sweep(got, cpl.plan_adjoint_solve_fixed(*fargs,
                                                         num_steps=4))
    assert _same_sweep(got, cpl.plan_adjoint_solve_fixed_plain(
        *fargs, num_steps=4))
    assert cpl.last_group["fixed_adjoint"] == cpl.PERLANE_GROUP


def test_fused_training_launches_and_never_falls_back(cuda, monkeypatch):
    """fast.odeint_adjoint_fused and odeint_adjoint(options={'fuse': True})
    on the card: one plan forward and one K15 sweep a step (K2 + K3, K8 +
    K9, K5 + K6), no plain sweep reached, no fallback counted, gradients
    within the sweep's bar of the MLP route's K3 on the same function."""
    from tfdiffeq_tpu_torch import odeint_adjoint
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl

    def never(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("adjoint_sweep_plain", "perlane_adjoint_plain",
                 "fixed_adjoint_plain", "adaptive_solve_plain",
                 "fixed_solve_plain", "perlane_solve_plain"):
        monkeypatch.setattr(cpl, name, never)
    cpl.reset_launch_counts()
    before = fast.fuse_fallbacks
    p, y = _bench(256, torch.float32, cuda)
    W = [(p["w1"].clone().requires_grad_(), p["b1"].clone().requires_grad_()),
         (p["w2"].clone().requires_grad_(), p["b2"].clone().requires_grad_())]
    t = torch.linspace(0.0, 5.0, 12)

    def f(tt, yy, q):
        return torch.tanh((yy ** 3) @ q[0][0] + q[0][1]) @ q[1][0] + q[1][1]

    ys = fast.odeint_adjoint_fused(f, y, t, params=W, rtol=1e-6, atol=1e-6,
                                   first_step=0.01, adjoint_first_step=0.05)
    got = torch.autograd.grad(torch.mean(ys ** 2), [x for l in W for x in l])
    ys = fast.odeint_adjoint_mlp(fast.MLPSpec(input_power=3), W, y, t,
                                 rtol=1e-6, atol=1e-6, first_step=0.01,
                                 adjoint_first_step=0.05)
    ref = torch.autograd.grad(torch.mean(ys ** 2), [x for l in W for x in l])
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    assert (cpl.plan_solve_launches, cpl.plan_adjoint_launches) == (1, 1)
    for method, opts in (("rk4", {"num_steps": 40}),
                         ("dopri5", {"per_sample": True})):
        ys = odeint_adjoint(f, y, t, params=W, rtol=1e-6, atol=1e-6,
                            method=method, options={"fuse": True, **opts})
        torch.mean(ys ** 2).backward()
    assert (cpl.plan_fixed_launches, cpl.plan_fixed_adjoint_launches,
            cpl.plan_perlane_launches,
            cpl.plan_perlane_adjoint_launches) == (1, 1, 1, 1)
    assert fast.fuse_fallbacks == before


# ---------------------------------------------------------------------------
# K14 inside K10 and K11, and K12 with two plans (ops/cuda_plan.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["spiral", "concat_t_gelu", "ops"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_adams_hosts_match_plain(cuda, dtype, name):
    """K14 in K10 (explicit_adams and fixed_adams on a 40-step grid) and in
    K11 (VCABM): bitwise equal to the plain engines with `eval_plan`,
    identical stats, and run to run; a coupled plan's K11 on one block
    too (test_coupled_plans_on_one_block_match_plain holds the rest)."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_plan as cpl
    cpl.reset_launch_counts()
    plan, packed, y0, t, g, _ = _plan_case(name, dtype, cuda)
    # States of norm about 0.5: 40 explicit Adams steps over [0, 2] keep
    # the spiral stable there (from randn states it overflows to NaN).
    y0 = 0.5 * y0
    f0 = g(t[0].to(cuda), y0).contiguous()
    grid = uniform_grid(t[0], t[-1], 40)
    for implicit in (False, True):
        args = (plan, packed, y0, t, grid, 1e-6, 1e-6, 1.0, f0)
        got = cpl.plan_solve_adams(*args, implicit=implicit)
        assert _same(got, cpl.plan_solve_adams(*args, implicit=implicit))
        ref = cad.adams_solve_plain(g, y0, f0, t, grid, 1e-6, 1e-6,
                                    implicit=implicit)
        assert _same(got, ref), (got[1].tolist(), ref[1].tolist())
        assert torch.isfinite(got[0]).all()
    args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    got = cpl.plan_solve_vcabm(*args)
    assert _same(got, cpl.plan_solve_vcabm(*args))
    ref = cad.vcabm_solve_plain(g, y0, f0, t, 0.01, 1e-6, 1e-6)
    assert _same(got, ref), (got[1].tolist(), ref[1].tolist())
    assert got[1][3].item() == 0
    assert (cpl.plan_adams_launches, cpl.plan_vcabm_launches) == (4, 2)
    # A coupled plan, once refused here (queue 2 item 3), runs K11 on one
    # block.
    plan, packed, y0, t, g, f0 = _plan_case("meanfield", dtype, cuda)
    args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    got = cpl.plan_solve_vcabm(*args)
    assert _same(got, cpl.plan_solve_vcabm_plain(*args))
    assert got[1][3].item() == 0 and cpl.plan_vcabm_launches == 3


@pytest.mark.parametrize("B", [4096, 256, 33, 1])
@pytest.mark.parametrize("name", ["meanfield", "scalar_coupled", "bmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coupled_plans_on_one_block_match_plain(cuda, dtype, name, B):
    """A coupled plan's one-block routes: K8 (rk4, euler on a 32-step
    grid), K10 (fixed_adams, explicit_adams), K11 and K9 (rk4, 4 steps an
    interval over K8's trajectory), each launch bitwise equal to its plain
    version (the block meets in `_batch_sums`' order) and run to run, on
    the batch-wide route with the launch counters moving. At B = 1 the
    capture folds the batch reduction away (the plan is uncoupled) and the
    group routes run."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    cpl.reset_launch_counts()
    plan, packed, y0, t, g, f0 = _plan_case(name, dtype, cuda, B)
    assert plan.batch_coupled == (B > 1)
    grid = uniform_grid(t[0], t[-1], 33)
    for method in ("rk4", "euler"):
        args = (plan, packed, y0, t, grid, 1.0, f0)
        got = cpl.plan_solve_fixed(*args, method=method)
        assert _same(got, cpl.plan_solve_fixed(*args, method=method))
        assert _same(got, cpl.plan_solve_fixed_plain(*args, method=method))
        assert cpl.last_route["fixed"].startswith("batch/") == (B > 1)
        assert torch.isfinite(got[0]).all() and got[1][3].item() == 0
        if method == "rk4":
            ys = got[0]
    for implicit in (True, False):
        args = (plan, packed, y0, t, grid, 1e-6, 1e-6, 1.0, f0)
        got = cpl.plan_solve_adams(*args, implicit=implicit)
        assert _same(got, cpl.plan_solve_adams(*args, implicit=implicit))
        assert _same(got, cpl.plan_solve_adams_plain(*args,
                                                     implicit=implicit))
        assert torch.isfinite(got[0]).all()
    args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    got = cpl.plan_solve_vcabm(*args)
    assert _same(got, cpl.plan_solve_vcabm_plain(*args))
    assert got[1][3].item() == 0
    ct = torch.tensor(np.random.RandomState(2).randn(*ys.shape), dtype=dtype,
                      device=cuda)
    args = (plan, packed, ys.contiguous(), ct, t, 1.0)
    if B == 1 and name == "scalar_coupled":
        # One sample's energy is a to-scalar feature sum, whose reverse
        # walk the reference refuses too.
        from tfdiffeq_tpu_torch.ops.plan_bridge import FusionError
        with pytest.raises(FusionError, match="to-scalar"):
            cpl.plan_adjoint_solve_fixed(*args, num_steps=4)
        return
    got = cpl.plan_adjoint_solve_fixed(*args, num_steps=4)
    assert _same_sweep(got, cpl.plan_adjoint_solve_fixed(*args, num_steps=4))
    assert _same_sweep(got, cpl.plan_adjoint_solve_fixed_plain(
        *args, num_steps=4))
    assert cpl.last_route["fixed_adjoint"].startswith("batch/") == (B > 1)
    assert (cpl.plan_fixed_launches, cpl.plan_adams_launches,
            cpl.plan_vcabm_launches,
            cpl.plan_fixed_adjoint_launches) == (4, 4, 1, 2)


def test_coupled_entry_points_launch_one_block(cuda):
    """solve(fuse) with every fixed-grid and Adams method and the three
    training mixes (K8 + K9, K2 + K9, K8 + K3) launch their kernels on a
    coupled plan, never the generic engine: the counters move and
    `fast.fuse_fallbacks` does not."""
    from tfdiffeq_tpu_torch import odeint_adjoint, solve
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    f, D = _plan_dyns(torch.float32, cuda)["meanfield"]
    y = torch.tensor(np.random.RandomState(1).randn(256, D),
                     dtype=torch.float32, device=cuda)
    t = torch.linspace(0.0, 2.0, 7)
    before = fast.fuse_fallbacks
    cpl.reset_launch_counts()
    for method in ("euler", "midpoint", "rk4", "rk4_38", "fixed_adams",
                   "explicit_adams", "adams"):
        opts = {} if method == "adams" else {"num_steps": 32}
        res = solve(f, y, t, method=method, options={"fuse": True, **opts})
        assert res.stats.status == 0 and torch.isfinite(res.ys).all()
    assert (cpl.plan_fixed_launches, cpl.plan_adams_launches,
            cpl.plan_vcabm_launches) == (4, 2, 1)
    W = torch.nn.Parameter(torch.tensor(np.random.RandomState(0).randn(D, D)
                                        * 0.3, dtype=torch.float32,
                                        device=cuda))
    fw = lambda tt, yy, w: torch.tanh(yy @ w) - 0.5 * (yy - yy.mean(0))
    cpl.reset_launch_counts()
    for method, adj, fo, bo in (
            ("rk4", "rk4", {"num_steps": 32}, {}),
            ("dopri5", "rk4", {}, {"num_steps": 8}),
            ("rk4", "dopri5", {"num_steps": 32}, {})):
        ys = odeint_adjoint(fw, y, t, params=W, rtol=1e-6, atol=1e-6,
                            method=method, adjoint_method=adj,
                            options={"fuse": True, **fo},
                            adjoint_options=bo or None)
        torch.mean(ys ** 2).backward()
        assert torch.isfinite(W.grad).all()
    assert (cpl.plan_fixed_launches, cpl.plan_solve_launches,
            cpl.plan_fixed_adjoint_launches,
            cpl.plan_adjoint_launches) == (2, 1, 2, 1)
    assert fast.fuse_fallbacks == before


def _hyper_case(dtype, device, B=300):
    """The example's dynamics y^3 A and a 5 -> 16 -> 2 tanh hypernet over
    [y, f, t], states in the unit disk."""
    from tfdiffeq_tpu_torch.examples import hypersolver as hx
    rng = np.random.RandomState(5)
    c = lambda a: torch.tensor(a, dtype=dtype, device=device)
    w1, b1, w2 = c(rng.randn(5, 16) * 0.3), c(rng.randn(16) * 0.1), \
        c(rng.randn(16, 2) * 0.1)

    def g(t, y, fv):
        tc = t.reshape(1, 1).expand(y.shape[0], 1)
        return torch.tanh(torch.cat([y, fv, tc], 1) @ w1 + b1) @ w2

    y0 = hx.disk(np.random.RandomState(1), B, 1.0, device, dtype)
    return hx.dynamics(device, dtype), g, y0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hyper_kernel_matches_plain(cuda, dtype, monkeypatch):
    """K12 through `fast.solve_hyper` for the three kinds on the output
    grid, a num_steps grid and reverse time with step_size: each launch
    bitwise equal to `plan_solve_hyper_plain` on its own inputs, identical
    stats, and run to run; one launch a solve, no plain engine reached."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    f, g, y0 = _hyper_case(dtype, cuda)
    calls = []
    orig = cpl.plan_solve_hyper

    def record(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(cpl, "plan_solve_hyper", record)
    cpl.reset_launch_counts()
    cases = [(torch.linspace(0.0, 2.0, 33, dtype=dtype), {}),
             (torch.linspace(0.0, 2.0, 9, dtype=dtype), {"num_steps": 32}),
             (torch.linspace(2.0, 0.0, 5, dtype=dtype),
              {"step_size": 0.0625})]
    n = 0
    for method in ("hyper_euler", "hyper_midpoint", "hyper_heun"):
        for t, opts in cases:
            res = fast.solve_hyper(f, g, y0, t, method=method, **opts)
            n += 1
            a, k, got = calls[-1]
            assert _same(got, orig(*a, **k))
            ref = cpl.plan_solve_hyper_plain(*a, **k)
            assert _same(got, ref), (got[1].tolist(), ref[1].tolist())
            assert res.stats.status == 0 and torch.isfinite(res.ys).all()
    assert cpl.plan_hyper_launches == 2 * n


@pytest.mark.parametrize("B", [4096, 256, 33, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hyper_group_matches_plain(cuda, dtype, B):
    """K12 with a group of threads a sample (`cuda_plan.hyper_group(B)`:
    16 at B = 4096; B = 33 and 1 leave groups past B), both plans on the
    group walk: the three kinds on the output grid, a finer grid and in
    reverse time, each bitwise equal to `plan_solve_hyper_plain` and run
    to run; the launch reports the group the wrapper expects."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl, plan_bridge as pb
    f, g, y0 = _hyper_case(dtype, cuda, B=B)
    t0 = torch.tensor(0.0, dtype=dtype, device=cuda)
    pf, cfs = pb.build_plan(f, t0, y0)
    pg, cgs = pb.build_plan(lambda tt, ss: g(tt, ss[:, :2], ss[:, 2:]), t0,
                            torch.cat([y0, f(t0, y0)], 1), out_dim=2)
    plans = (pf, pg, pb.pack_consts(pf, cfs, dtype, cuda),
             pb.pack_consts(pg, cgs, dtype, cuda), y0)
    t = torch.linspace(0.0, 2.0, 9, dtype=dtype)
    rev = torch.linspace(-2.0, 0.0, 5, dtype=dtype)
    cases = ((t, t, 1.0, True), (t, uniform_grid(t[0], t[-1], 32), 1.0,
                                 False),
             (rev, uniform_grid(rev[0], rev[-1], 32), -1.0, False))
    for kind in ("euler", "midpoint", "heun"):
        for tau, grid, sign, grid_is_t in cases:
            kw = dict(kind=kind, grid_is_t=grid_is_t)
            got = cpl.plan_solve_hyper(*plans, tau, grid, sign, **kw)
            layout = cpl.last_layout["hyper"]
            _same(got, cpl.plan_solve_hyper(*plans, tau, grid, sign, **kw))
            ref = cpl.plan_solve_hyper_plain(*plans, tau, grid, sign, **kw)
            torch.cuda.synchronize()
            assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
            _same(got, ref)
            assert layout["threads_a_sample"] == cpl.hyper_group(B)
    if B == 4096:
        assert cpl.hyper_group(B) == 16


def test_every_builtin_method_launches_its_kernel(cuda):
    """odeint(options={'fuse': True}) launches one whole-solve kernel for
    each of the 15 built-in methods, with no fallback."""
    from tfdiffeq_tpu_torch import SOLVERS, solve
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    f, g, y0 = _hyper_case(torch.float32, cuda, B=96)
    t = torch.linspace(0.0, 1.0, 5)
    before = fast.fuse_fallbacks
    counters = ("plan_solve_launches", "plan_fixed_launches",
                "plan_adams_launches", "plan_vcabm_launches",
                "plan_hyper_launches")
    for method in SOLVERS:
        opts = {"hypernet": g} if method.startswith("hyper_") else {}
        cpl.reset_launch_counts()
        res = solve(f, y0, t, rtol=1e-5, atol=1e-7, method=method,
                    options={"fuse": True, **opts})
        assert sum(getattr(cpl, c) for c in counters) == 1, method
        assert res.stats.status == 0, method
    assert fast.fuse_fallbacks == before


# ---------------------------------------------------------------------------
# K3 over the card: a grid of n_blocks blocks, each a range of the samples
# and of the parameters, the blocks' partials merged in block order.
# ---------------------------------------------------------------------------

def _k3_grid_case(route, dtype, device):
    """(wrapper, plain, args, kw) of a K3 sweep on `route`: the narrow MLP
    (B = 300, the time column), a narrow MLP that nearly fills shared
    memory (B = 64), the wide MLP (width 144, B = 48), K7's
    adjoint (B = 96) and K15's 'drive' plan (B = 96, a per-sample constant
    and a learnable scalar)."""
    if route == "narrow":
        warr, dims, ys, g, t = _adjoint_case(device, dtype, time_input=True)
        return (ca.mlp_adjoint_solve, ca.mlp_adjoint_solve_plain,
                (warr, dims, ys, g, t, 0.05, 1e-6, 1e-8, 1.0),
                dict(activation="elu", time_input=True))
    if route == "narrow_full":
        # 8 -> 128 -> 8: in float64 its weights and stage cotangents take
        # 179 KB of shared memory, so the grouped walk fits 8 slots of 32.
        rng = np.random.RandomState(9)
        weights = [(torch.tensor(rng.randn(i, o) / np.sqrt(i), dtype=dtype,
                                 device=device),
                    torch.tensor(rng.randn(o) * 0.1, dtype=dtype,
                                 device=device))
                   for i, o in ((8, 128), (128, 8))]
        y0 = torch.tensor(rng.randn(64, 8) * 0.5, dtype=dtype, device=device)
        t = torch.linspace(0.0, 1.0, 4, dtype=dtype)
        ys = fast.solve_mlp_spec(fast.MLPSpec(activation="tanh"), weights,
                                 y0, t, rtol=1e-7, atol=1e-9).ys.contiguous()
        g = torch.tensor(rng.randn(*ys.shape), dtype=dtype, device=device)
        warr, dims = ck.pack_mlp_weights(weights, dtype, device)
        assert ck._route("K3", dims, ca._shared_values(dims, 7, False),
                         ys.element_size()) == ck.ROUTE_NARROW
        return (ca.mlp_adjoint_solve, ca.mlp_adjoint_solve_plain,
                (warr, dims, ys, g, t, 0.05, 1e-6, 1e-8, 1.0), {})
    if route == "wide":
        weights, warr, dims, y0, t = _wide_case(device, dtype)
        ys = fast.solve_mlp_spec(fast.MLPSpec(activation="tanh"), weights,
                                 y0, t, rtol=1e-7, atol=1e-9).ys.contiguous()
        g = torch.tensor(np.random.RandomState(5).randn(*ys.shape),
                         dtype=dtype, device=device)
        assert ck._route("K3", dims, ca._shared_values(dims, 7, False),
                         ys.element_size()) == ck.ROUTE_WIDE
        return (ca.mlp_adjoint_solve, ca.mlp_adjoint_solve_plain,
                (warr, dims, ys, g, t, 0.05, 1e-6, 1e-8, 1.0), {})
    if route == "cnf":
        _, packed, dims, s0, tau, f0 = _cnf_case(device, dtype, 64, 96)
        out, st = ck.mlp_solve_plain(packed, dims, s0, tau, 0.05, 1e-5, 1e-7,
                                     -1.0, f0=f0, activation="tanh",
                                     time_input=True, rhs="cnf")
        g = torch.tensor(np.random.RandomState(32).randn(*out.shape),
                         dtype=dtype, device=device)
        return (ca.mlp_adjoint_solve, ca.mlp_adjoint_solve_plain,
                (packed, dims, out.contiguous(), g, tau, 0.05, 1e-5, 1e-7,
                 -1.0), dict(activation="tanh", rhs="cnf"))
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    plan, packed, ys, ct, t = _aug_case("drive", dtype, device)
    return (cpl.plan_adjoint_solve, cpl.plan_adjoint_solve_plain,
            (plan, packed, ys, ct, t, 0.05, 1e-6, 1e-6, 1.0), {})


@pytest.mark.parametrize("n_blocks", [1, 2, 132])
@pytest.mark.parametrize("route",
                         ["narrow", "narrow_full", "wide", "cnf", "plan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adjoint_grid_matches_plain(cuda, dtype, route, n_blocks):
    """K3 on a grid of n_blocks blocks (132: blocks past the batch own no
    samples) bitwise equal to its plain version at the same n_blocks, in
    both types, on every route: trajectories' cotangents, parameter
    cotangents, a_t and stats; and equal from run to run."""
    fn, plain, args, kw = _k3_grid_case(route, dtype, cuda)
    got = fn(*args, n_blocks=n_blocks, **kw)
    again = fn(*args, n_blocks=n_blocks, **kw)
    ref = plain(*args, n_blocks=n_blocks, **kw)
    torch.cuda.synchronize()
    assert _same_sweep(got, again) and _same_sweep(got, ref), \
        (got[3].tolist(), ref[3].tolist())
    assert got[3][3].item() == 0


@pytest.mark.parametrize("route", ["narrow", "plan"])
def test_adjoint_default_grid_is_the_cards(cuda, route):
    """With no n_blocks the wrapper takes one block per SM (fewer for a
    smaller batch), and the plain version on the card's tensors the same
    grid; the spiral's batch of 4096 takes every SM."""
    fn, plain, args, kw = _k3_grid_case(route, torch.float64, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ck.solve_blocks(4096, cuda) == sms > 1
    assert ck.solve_blocks(3, cuda) == 3
    got = fn(*args, **kw)
    ref = plain(*args, **kw)
    assert _same_sweep(got, ref)


def test_adjoint_grid_refuses_what_cannot_be_resident(cuda):
    """A grid larger than the card can hold at once is refused with an
    error; it never runs on fewer blocks. A coupled plan refuses a wider
    grid than one block."""
    fn, _, args, kw = _k3_grid_case("narrow", torch.float32, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    before = ca.mlp_adjoint_solve_launches
    with pytest.raises(RuntimeError, match="mlp_adjoint_solve launch"):
        fn(*args, n_blocks=64 * sms, **kw)
    assert ca.mlp_adjoint_solve_launches == before
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    plan, packed, ys, ct, t = _aug_case("meanfield", torch.float32, cuda)
    with pytest.raises(ValueError, match="one block"):
        cpl.plan_adjoint_solve(plan, packed, ys, ct, t, 0.05, 1e-6, 1e-6,
                               1.0, n_blocks=2)


@pytest.mark.parametrize("tier", ["mixed", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tier_net_tiles_at_the_wide_widths(cuda, dtype, tier):
    """K4 alone on the wide MLP 128 -> 256 -> 256 -> 128 at B = 1024 (16
    tiles of 64 rows, two 128-output chunks a layer) and on a 512-wide
    hidden layer (32-row tiles): float32 within EVAL_BARS of its own tier's
    plain version and outside them against the other tiers', float64
    bitwise; the evaluation alone on a packed workspace equals the whole
    call."""
    for D, H, B in ((128, 256, 1024), (64, 512, 200)):
        weights, warr, dims, y0, _ = _wide_case(cuda, dtype, B=B, D=D, H=H)
        plains = {o: ck._net_plain(warr, dims, "tanh", "identity", 1, False,
                                   ck.layer_tiers(dims, "auto", o))(0.0, y0)
                  for o in ("highest", "mixed", "bf16")}
        tiers = ck.layer_tiers(dims, "auto", tier)
        got = ck.tier_net(warr, dims, y0, tiers=tiers)
        out, work = torch.empty_like(y0), ck.tier_net_work(dims, y0)
        ck.tier_net_parts(warr, dims, y0, 0.0, out, work, tiers=tiers,
                          mode=1)
        ck.tier_net_parts(warr, dims, y0, 0.0, out, work, tiers=tiers,
                          mode=2)
        torch.cuda.synchronize()
        assert torch.equal(out, got)
        if dtype == torch.float64:
            assert torch.equal(got, plains[tier])
            continue
        bar = EVAL_BARS[tier]
        ok = lambda g: g[0] <= bar[0] and g[1] <= bar[1]
        own = _gap(got, plains[tier])
        ctl = {o: _gap(got, r) for o, r in plains.items() if o != tier}
        assert ok(own), (D, H, own, ctl)
        assert not any(ok(c) for c in ctl.values()), (D, H, own, ctl)


@pytest.mark.parametrize("H", [256, 512])
@pytest.mark.parametrize("tier", ["mixed", "bf16"])
def test_tier_batch_routes_at_the_wide_widths(cuda, tier, H):
    """K8 (rk4, 16 steps) and K2 (dopri5) on the batch route with the
    shared-memory tiles at widths 256 and 512 (K2's one block of 16 warps
    takes 16-row tiles at 512). K8: its largest gap to its plain version
    within chip_smoke.py's SOLVE_BARS for the wide rk4 x 128 (1e-5 'mixed',
    2e-3 'bf16'), and for 'mixed' the other tiers' plain versions outside
    that bar (the 'bf16' tier's mean gap grows with the width, 7e-5 at 512
    on the card, as more inputs meet a bf16 rounding boundary, so a whole
    solve does not separate it from 'mixed'; one evaluation does, in
    test_tier_net_tiles_at_the_wide_widths). K2's one accepted step of
    0.25 within the step's bar (as test_tier_solve_kernel_matches_plain)."""
    weights, warr, dims, y0, t = _wide_case(cuda, torch.float32, B=96, D=64,
                                            H=H)
    tiers = ck.layer_tiers(dims, "auto", tier)
    f0 = fast.mlp_apply(fast.MLPSpec(), weights, y0)
    args = (warr, dims, y0, t, uniform_grid(t[0], t[-1], 16), 1.0)
    kw = dict(f0=f0, method="rk4", tiers=tiers)
    out, st = cf.mlp_solve_fixed(*args, **kw)
    ref, st_ref = cf.mlp_solve_fixed_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st, st_ref) and st[3].item() == 0
    bar = {"mixed": 1e-5, "bf16": 2e-3}[tier]
    own = _gap(out, ref)
    assert own[0] <= bar, own
    if tier == "mixed":
        for o in ("highest", "bf16"):
            ctl = _gap(out, cf.mlp_solve_fixed_plain(*args, **dict(
                kw, tiers=ck.layer_tiers(dims, "auto", o)))[0])
            assert ctl[0] > bar, (own, o, ctl)
    one = (warr, dims, y0, torch.tensor([0.0, 0.25]), 0.25, 1.0, 1.0, 1.0)
    got, st1 = ck.mlp_solve(*one, f0=f0, tiers=tiers)
    want = ck.mlp_solve_plain(*one, f0=f0, tiers=tiers)[0]
    assert st1.tolist() == [6, 1, 0, 0]
    assert _gap(got, want)[0] < {"mixed": 5e-5, "bf16": 2e-3}[tier]


def test_fixed_batch_route_takes_long_grids(cuda):
    """K8's batch route at width 512 with output times and grid points
    (6017 values) that no longer fit in shared memory beside K4's tiles:
    they stay in global memory, the solve runs and is within SOLVE_BARS of
    its plain version ('mixed', euler on 16 steps, 6000 outputs)."""
    weights, warr, dims, y0, _ = _wide_case(cuda, torch.float32, B=32, D=64,
                                            H=512)
    tiers = ck.layer_tiers(dims, "auto", "mixed")
    t = torch.linspace(0.0, 1.0, 6000)
    f0 = fast.mlp_apply(fast.MLPSpec(), weights, y0)
    args = (warr, dims, y0, t, uniform_grid(t[0], t[-1], 16), 1.0)
    kw = dict(f0=f0, method="euler", tiers=tiers)
    out, st = cf.mlp_solve_fixed(*args, **kw)
    ref, st_ref = cf.mlp_solve_fixed_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st, st_ref) and st[3].item() == 0
    assert bool(torch.isfinite(out).all())
    assert _gap(out, ref)[0] <= SOLVE_BARS["mixed"][0]


# ---------------------------------------------------------------------------
# K2 and K11 over the card: a grid of n_blocks blocks, each a range of the
# samples, one controller, the error sums' shares merged in block order.
# ---------------------------------------------------------------------------

def _k2_grid_case(route, dtype, device):
    """(wrapper, plain, args, kw) of a K2 solve on `route`: the narrow MLP
    (B = 300, ELU with a time column), the wide MLP (width 144, B = 200),
    K7's CNF flow (B = 96), K14's 'concat_t_gelu' plan (B = 96) and the
    batch route at 'mixed' or 'bf16' (the wide MLP, B = 200: 13 tiles)."""
    if route == "narrow":
        from tfdiffeq_tpu_torch.ops import cuda_adams as cad
        warr, dims, y0, kw = _adams_case(device, dtype, time_input=True)
        t = torch.linspace(0.0, 2.0, 6, dtype=dtype)
        f0 = cad._f0(warr, dims, y0, t[0], 1.0, kw["activation"],
                     "identity", kw["input_power"], kw["time_input"])
        return (ck.mlp_solve, ck.mlp_solve_plain,
                (warr, dims, y0, t, 0.05, 1e-6, 1e-8, 1.0),
                dict(kw, f0=f0))
    if route == "cnf":
        _, packed, dims, s0, tau, f0 = _cnf_case(device, dtype, 64, 96)
        return (ck.mlp_solve, ck.mlp_solve_plain,
                (packed, dims, s0, tau, 0.05, 1e-5, 1e-7, -1.0),
                dict(f0=f0, activation="tanh", time_input=True, rhs="cnf"))
    if route == "plan":
        from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
        plan, packed, y0, t, _, f0 = _plan_case("concat_t_gelu", dtype,
                                                device)
        return (cpl.plan_solve, cpl.plan_solve_plain,
                (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0), {})
    weights, warr, dims, y0, t = _wide_case(device, dtype, B=200)
    f0 = fast.mlp_apply(fast.MLPSpec(activation="tanh"), weights, y0)
    kw = dict(f0=f0)
    if route != "wide":
        kw["tiers"] = ck.layer_tiers(dims, "auto", route)
    return (ck.mlp_solve, ck.mlp_solve_plain,
            (warr, dims, y0, t, 0.05, 1e-4, 1e-4, 1.0), kw)


def _grid_of(n_blocks, device):
    """n_blocks, or the card's SM count for 'card'."""
    if n_blocks == "card":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return n_blocks


@pytest.mark.parametrize("n_blocks", [1, 7, "card"])
@pytest.mark.parametrize("route", ["narrow", "wide", "cnf", "plan", "mixed",
                                   "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_grid_matches_plain(cuda, dtype, route, n_blocks):
    """K2 on a grid of n_blocks blocks (the card's: blocks past the batch
    own no samples; the batch route takes at most a block a tile, so 13
    here) bitwise equal to its plain version at the same n_blocks, stats
    included, on the per-thread routes in both types and on the batch
    route in float64; the float32 tiers within their bars (their products
    sum on the tensor cores); two launches bitwise equal."""
    fn, plain, args, kw = _k2_grid_case(route, dtype, cuda)
    nb = _grid_of(n_blocks, cuda)
    if route in ("mixed", "bf16"):
        nb = min(nb, 13)
    got = fn(*args, n_blocks=nb, **kw)
    again = fn(*args, n_blocks=nb, **kw)
    ref = plain(*args, n_blocks=nb, **kw)
    torch.cuda.synchronize()
    assert _same(got, again)
    assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
    if route in ("mixed", "bf16") and dtype == torch.float32:
        if route == "mixed":
            assert abs(got[1][1].item() - ref[1][1].item()) <= 1
            assert abs(got[1][2].item() - ref[1][2].item()) <= 1
        assert float((got[0] - ref[0]).abs().max()) < (
            5e-5 if route == "mixed" else 1e-2)
        return
    assert _same(got, ref), (got[1].tolist(), ref[1].tolist())


@pytest.mark.parametrize("n_blocks", [1, 7, "card"])
@pytest.mark.parametrize("route", ["narrow", "wide", "plan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vcabm_grid_matches_plain(cuda, dtype, route, n_blocks):
    """K11 on a grid of n_blocks blocks bitwise equal to its plain version
    at the same n_blocks, stats included, in both types, on the narrow and
    wide MLP routes and a plan; two launches bitwise equal."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_plan as cpl
    nb = _grid_of(n_blocks, cuda)
    if route == "plan":
        plan, packed, y0, t, g, _ = _plan_case("spiral", dtype, cuda)
        y0 = 0.5 * y0
        f0 = g(t[0].to(cuda), y0).contiguous()
        args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
        fn, plain, kw, pkw = (cpl.plan_solve_vcabm,
                              cpl.plan_solve_vcabm_plain, {}, {})
    else:
        width = 24 if route == "narrow" else 144
        warr, dims, y0, kw = _adams_case(cuda, dtype, width=width)
        assert ck._route("t", dims, warr.numel(), y0.element_size()) == (
            ck.ROUTE_NARROW if route == "narrow" else ck.ROUTE_WIDE)
        t = torch.tensor([0.0, 0.37, 1.11, 2.0], dtype=dtype)
        args = (warr, dims, y0, t, 0.02, 1e-5, 1e-7, 1.0)
        fn, plain = cad.mlp_solve_vcabm, cad.mlp_solve_vcabm_plain
        pkw = dict(f0=cad._f0(warr, dims, y0, t[0], 1.0, kw["activation"],
                              "identity", kw["input_power"],
                              kw["time_input"]))
    got = fn(*args, n_blocks=nb, **kw)
    again = fn(*args, n_blocks=nb, **kw)
    ref = plain(*args, n_blocks=nb, **kw, **pkw)
    torch.cuda.synchronize()
    assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
    assert _same(got, again)
    assert _same(got, ref), (got[1].tolist(), ref[1].tolist())


def test_solve_grids_default_to_the_card_and_refuse_the_rest(cuda):
    """With no n_blocks K2 and K11 take one block per SM (fewer for a
    smaller batch; the batch route one a tile), as their plain versions do
    on the card's tensors; a grid the card cannot hold at once raises
    (never a quiet one-block launch); the batch route refuses more blocks
    than tiles; a coupled plan runs on one block and refuses more."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_plan as cpl
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ck.solve_blocks(4096, cuda) == sms > 1
    assert ck.solve_blocks(5, cuda) == 5
    assert ck.solve_blocks(200, cuda, ck.TILE_ROWS) == 13
    for route in ("narrow", "mixed"):
        fn, plain, args, kw = _k2_grid_case(route, torch.float64, cuda)
        assert _same(fn(*args, **kw), plain(*args, **kw))
    warr, dims, y0, kw = _adams_case(cuda, torch.float64)
    t = torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64)
    f0 = cad._f0(warr, dims, y0, t[0], 1.0, kw["activation"], "identity",
                 kw["input_power"], kw["time_input"])
    args = (warr, dims, y0, t, 0.02, 1e-5, 1e-7, 1.0)
    assert _same(cad.mlp_solve_vcabm(*args, **kw),
                 cad.mlp_solve_vcabm_plain(*args, f0=f0, **kw))
    ck.reset_launch_counts()
    cad.reset_launch_counts()
    fn, _, args2, kw2 = _k2_grid_case("narrow", torch.float32, cuda)
    with pytest.raises(RuntimeError, match="mlp_solve launch"):
        fn(*args2, n_blocks=64 * sms, **kw2)
    with pytest.raises(RuntimeError, match="mlp_solve_vcabm launch"):
        cad.mlp_solve_vcabm(*args, n_blocks=64 * sms, **kw)
    fn, _, args2, kw2 = _k2_grid_case("mixed", torch.float32, cuda)
    with pytest.raises(ValueError, match="one block a tile"):
        fn(*args2, n_blocks=14, **kw2)
    assert ck.mlp_solve_launches == cad.mlp_solve_vcabm_launches == 0
    plan, packed, y0, t, g, f0 = _plan_case("meanfield", torch.float64, cuda)
    pargs = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    with pytest.raises(ValueError, match="one block"):
        cpl.plan_solve(*pargs, n_blocks=2)
    assert cpl.plan_blocks(plan, y0.shape[0], cuda) == 1
    assert _same(cpl.plan_solve(*pargs),
                 cpl.plan_solve_plain(*pargs, n_blocks=1))


# ---------------------------------------------------------------------------
# fixed_adams' K10 over the card (a grid of n_blocks blocks, one convergence
# decision a corrector iteration), and K6 a group of threads a sample
# ---------------------------------------------------------------------------

def _k10_grid_case(route, dtype, device):
    """(wrapper, plain version, args, kw, the plain version's extra kw) of a
    K10 solve on a 40-step grid: the MLP narrow or wide route at B = 300,
    or the spiral as a plan at B = 96."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_plan as cpl
    if route == "plan":
        plan, packed, y0, t, g, _ = _plan_case("spiral", dtype, device)
        y0 = 0.5 * y0
        f0 = g(t[0].to(device), y0).contiguous()
        grid = uniform_grid(t[0], t[-1], 40)
        return (cpl.plan_solve_adams, cpl.plan_solve_adams_plain,
                (plan, packed, y0, t, grid, 1e-6, 1e-6, 1.0, f0), {}, {})
    warr, dims, y0, kw = _adams_case(device, dtype,
                                     width=24 if route == "narrow" else 144)
    assert ck._route("t", dims, warr.numel(), y0.element_size()) == (
        ck.ROUTE_NARROW if route == "narrow" else ck.ROUTE_WIDE)
    t = torch.tensor([0.0, 0.37, 1.11, 2.0], dtype=dtype)
    grid = uniform_grid(t[0], t[-1], 40)
    f0 = cad._f0(warr, dims, y0, grid[0], 1.0, kw["activation"], "identity",
                 kw["input_power"], kw["time_input"])
    return (cad.mlp_solve_adams, cad.mlp_solve_adams_plain,
            (warr, dims, y0, t, grid, 1e-6, 1e-8, 1.0), kw, dict(f0=f0))


@pytest.mark.parametrize("n_blocks", [1, 7, "card"])
@pytest.mark.parametrize("route", ["narrow", "wide", "plan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_adams_grid_matches_plain(cuda, dtype, route, n_blocks):
    """fixed_adams' K10 on a grid of n_blocks blocks (the card's: on the
    plan's 96 samples, blocks past the batch own none) bitwise equal to its
    plain version at the same n_blocks, stats included, on the narrow and
    wide MLP routes and a plan, in both types; two launches bitwise equal.
    explicit_adams (a thread a sample, no grid) stays bitwise too."""
    fn, plain, args, kw, pkw = _k10_grid_case(route, dtype, cuda)
    nb = _grid_of(n_blocks, cuda)
    for implicit in (True, False):
        got = fn(*args, n_blocks=nb, implicit=implicit, **kw)
        again = fn(*args, n_blocks=nb, implicit=implicit, **kw)
        ref = plain(*args, n_blocks=nb, implicit=implicit, **kw, **pkw)
        torch.cuda.synchronize()
        assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
        assert _same(got, again)
        assert _same(got, ref), (got[1].tolist(), ref[1].tolist())


def test_adams_grid_defaults_to_the_card_and_refuses_the_rest(cuda):
    """With no n_blocks fixed_adams' K10 takes one block per SM (one a
    sample for a smaller batch), as its plain version does on the card's
    tensors; a grid the card cannot hold at once raises before counting a
    launch, never a quiet one-block launch; a bad n_blocks raises before
    any launch."""
    from tfdiffeq_tpu_torch.ops import cuda_adams as cad, cuda_plan as cpl
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for route in ("narrow", "plan"):
        fn, plain, args, kw, pkw = _k10_grid_case(route, torch.float64, cuda)
        assert _same(fn(*args, **kw), plain(*args, **kw, **pkw))
        assert _same(fn(*args, **kw),
                     plain(*args, n_blocks=min(sms, args[2].shape[0]), **kw,
                           **pkw))
    cad.reset_launch_counts()
    cpl.reset_launch_counts()
    fn, _, args, kw, _ = _k10_grid_case("narrow", torch.float32, cuda)
    with pytest.raises(RuntimeError, match="mlp_solve_adams launch"):
        fn(*args, n_blocks=64 * sms, **kw)
    for bad in (0, -1, 2.0):
        with pytest.raises(ValueError, match="n_blocks"):
            fn(*args, n_blocks=bad, **kw)
    fn, _, args, kw, _ = _k10_grid_case("plan", torch.float32, cuda)
    with pytest.raises(RuntimeError, match="plan_solve_adams launch"):
        fn(*args, n_blocks=64 * sms, **kw)
    assert cad.mlp_solve_adams_launches == cpl.plan_adams_launches == 0


def _same_nan(got, ref):
    """Bitwise equal, tensor by tensor (lists flattened), a NaN matching
    only a NaN at the same place."""
    flat = lambda r: [x for v in r for x in (v if isinstance(v, list)
                                             else [v])]
    for a, b in zip(flat(got), flat(ref)):
        if not a.is_floating_point():
            assert torch.equal(a, b)
            continue
        na, nb = torch.isnan(a), torch.isnan(b)
        assert torch.equal(na, nb) and torch.equal(a[~na], b[~nb])
    return True


@pytest.mark.parametrize("route", ["narrow", "narrow_t", "wide", "plan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_perlane_adjoint_group_matches_plain(cuda, dtype, route):
    """K6 with a group of 16 threads a sample, 32 samples a block: bitwise
    equal to its plain version (ay0, the quadratures, stats and lane stats)
    on the narrow route (with a time column: a_t), the wide route and a
    plan with a per-sample constant (its per-sample quadratures), in both
    types; B = 300 and 96 leave idle groups in the last block; two launches
    bitwise equal."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    if route == "plan":
        plan, packed, ys, ct, t = _aug_case("drive", dtype, cuda)
        args = (plan, packed, ys, ct, t, 0.05, 1e-6, 1e-6, 1.0)
        fn, plain, kw = (cpl.plan_perlane_adjoint_solve,
                         cpl.plan_perlane_adjoint_solve_plain, {})
    else:
        if route == "wide":
            weights, warr, dims, y0, t = _wide_case(cuda, dtype)
            spec = fast.MLPSpec()
            kw = {}
        else:
            spec, weights, warr, dims, y0 = _perlane_case(
                cuda, dtype, time_input=route == "narrow_t")
            t = torch.linspace(0.0, 2.0, 6, dtype=dtype)
            kw = dict(input_power=3, time_input=route == "narrow_t")
        ys = fast.solve_mlp_spec(spec, weights, y0, t, rtol=1e-7, atol=1e-9,
                                 per_sample=True).ys
        g = torch.tensor(np.random.RandomState(3).randn(*ys.shape),
                         dtype=dtype, device=cuda)
        args = (warr, dims, ys.contiguous(), g, t, 0.05, 1e-6, 1e-8, 1.0)
        fn, plain = cp.mlp_perlane_adjoint_solve, \
            cp.mlp_perlane_adjoint_solve_plain
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    stats, lane = got[-2], got[-1]
    assert stats[3].item() == 0 and len(set(lane[0].tolist())) > 1
    assert _same_nan(got, again) and _same_nan(got, ref)


def test_perlane_adjoint_group_battery_slice(cuda):
    """K15 in K6 on a slice of the stiffness battery (bench.py:483-535:
    a per-sample scale from 1 to 100 over the spiral's net, float32,
    B = 300): its stiffest samples fail (dt underflow, status 2, NaN rows
    by contract) while the rest finish; outputs, stats and lane stats
    bitwise equal to the plain version, a NaN only where it has one."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl, plan_bridge as pb
    f32, B = torch.float32, 300
    p, y0 = _bench(B, f32, cuda)
    sc = torch.tensor(np.logspace(0.0, 2.0, B), dtype=f32, device=cuda)

    def f(t, y):
        return sc[:, None] * (torch.tanh((y ** 3) @ p["w1"] + p["b1"])
                              @ p["w2"])
    t = torch.linspace(0.0, 2.0, 5)
    plan, consts = pb.build_plan(f, t[0].to(cuda), y0)
    packed = pb.pack_consts(plan, consts, f32, cuda)
    g = cpl.plan_rhs(plan, packed, torch.tensor(1.0, device=cuda))
    f0 = g(t[0].to(cuda), y0).contiguous()
    ys = cpl.plan_solve(plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0,
                        per_sample=True)[0]
    args = (plan, packed, ys.contiguous(), 2.0 * ys, t, 0.05, 1e-6, 1e-6,
            1.0)
    got = cpl.plan_perlane_adjoint_solve(*args)
    ref = cpl.plan_perlane_adjoint_solve_plain(*args)
    lane = got[-1]
    failed = lane[3] != 0
    assert 0 < int(failed.sum()) < B and int(got[-2][3]) == 2
    assert torch.isfinite(got[0][~failed]).all()
    assert _same_nan(got, ref)
    assert _same_nan(got, cpl.plan_perlane_adjoint_solve(*args))


def _group_solve_case(route, dtype, device, B):
    """An MLP on each route of K8's and K5's group engines: 'narrow' the
    perlane case's 2 -> 16 -> 2 on y**3, 'narrow_t' with a time column,
    'wide' a 32 -> 144 -> 144 -> 32 net (a group of FIXED_WIDE_GROUP
    threads a sample). Returns (spec, weights, packed, dims, y0, kw)."""
    if route == "wide":
        weights, warr, dims, y0, _ = _wide_case(device, dtype, B=B)
        return fast.MLPSpec(), weights, warr, dims, y0, {}
    ti = route == "narrow_t"
    spec, weights, warr, dims, y0 = _perlane_case(device, dtype, B=B,
                                                  time_input=ti)
    return spec, weights, warr, dims, y0, dict(input_power=3, time_input=ti)


@pytest.mark.parametrize("B", [1, 33, 300, 4097])
@pytest.mark.parametrize("route", ["narrow", "narrow_t", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_group_routes_match_plain(cuda, dtype, route, B):
    """K8 with a group of threads a sample on each MLP route, at ragged B
    (a last block part-empty at 33, 300 and 4097): bitwise equal to its
    plain version, outputs and stats, on a finer grid (the Hermite drain)
    in reverse time, and run to run."""
    spec, W, warr, dims, y0, kw = _group_solve_case(route, dtype, cuda, B)
    t = torch.tensor([0.0, 0.37, 1.11, 2.0], dtype=dtype)
    tau = (-t).flip(0)
    grid = uniform_grid(tau[0], tau[-1], 11)
    f0 = -fast.mlp_apply(spec, W, y0, t=float(-tau[0]))
    kw = dict(kw, f0=f0, method="rk4" if route != "narrow_t" else "rk4_38")
    args = (warr, dims, y0, tau, grid, -1.0)
    got = cf.mlp_solve_fixed(*args, **kw)
    again = cf.mlp_solve_fixed(*args, **kw)
    ref = cf.mlp_solve_fixed_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[1].tolist() == [1 + 4 * 11, 11, 0, 0]
    assert torch.isfinite(got[0]).all()
    assert _same(got, again) and _same(got, ref)
    assert cf.mlp_solve_fixed_launches == 2


@pytest.mark.parametrize("B", [1, 33, 300, 4097])
@pytest.mark.parametrize("route", ["narrow", "narrow_t", "wide"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_perlane_group_routes_match_plain(cuda, dtype, route, B):
    """K5 with a group of threads a sample under its own controller on
    each MLP route, at ragged B: bitwise equal to its plain version
    (outputs, stats, every sample's counts) and run to run; the samples
    take different numbers of attempts (tsit5 on the time column: an end
    derivative past FSAL's)."""
    spec, W, warr, dims, y0, kw = _group_solve_case(route, dtype, cuda, B)
    t = torch.linspace(0.0, 2.0, 7, dtype=dtype)
    f0 = fast.mlp_apply(spec, W, y0, t=0.0)
    dt0 = torch.linspace(0.01, 0.1, B, dtype=dtype, device=cuda)
    kw = dict(kw, f0=f0,
              method="tsit5" if route == "narrow_t" else "dopri5")
    args = (warr, dims, y0, t, dt0, 1e-6, 1e-8, 1.0)
    got = cp.mlp_solve_perlane(*args, **kw)
    again = cp.mlp_solve_perlane(*args, **kw)
    ref = cp.mlp_solve_perlane_plain(*args, **kw)
    torch.cuda.synchronize()
    st, lane = got[1], got[2]
    assert st[3].item() == 0 and torch.isfinite(got[0]).all()
    assert B < 33 or len(set(lane[0].tolist())) > 1
    assert _same(got, again) and _same(got, ref)
    assert cp.mlp_solve_perlane_launches == 2


def test_group_solves_keep_their_statuses(cuda):
    """K5's group engine: status 1 on the samples whose own attempts run
    out, invalid times status 3 with a zero tail, bitwise its plain
    version; K8's invalid times likewise."""
    spec, W, warr, dims, y0, kw = _group_solve_case("narrow", torch.float64,
                                                    cuda, 300)
    t = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    args = (warr, dims, y0, t, 0.05, 1e-8, 1e-10, 1.0)
    kw = dict(kw, f0=fast.mlp_apply(spec, W, y0), max_steps=6)
    got = cp.mlp_solve_perlane(*args, **kw)
    assert _same(got, cp.mlp_solve_perlane_plain(*args, **kw))
    assert got[1][3].item() == 1 and 0 < int((got[2][3] == 1).sum()) < 300
    bad = torch.tensor([0.0, 1.0, 0.5], dtype=torch.float64)
    out, st, lane = cp.mlp_solve_perlane(warr, dims, y0, bad, 0.05, 1e-6,
                                         1e-8, 1.0, input_power=3)
    assert st.tolist() == [0, 0, 0, 3] and (lane[3] == 3).all()
    assert torch.equal(out[0], y0) and not out[1:].any()
    out, st = cf.mlp_solve_fixed(warr, dims, y0, bad, bad, 1.0,
                                 input_power=3)
    assert st.tolist() == [0, 0, 0, 3]
    assert torch.equal(out[0], y0) and not out[1:].any()


# ---- K2's dense-output emission (fast.solve_fused(dense_output=True)) ----

DENSE_ROWS = 256


@pytest.mark.parametrize("B", [4096, 256, 33, 1])
@pytest.mark.parametrize("name", ["spiral", "meanfield"],
                         ids=["per_thread", "coupled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_dense_emission_matches_plain(cuda, dtype, name, B):
    """K2's plan launch with the emission (`csrc/rk_solve.cuh`): out,
    stats, meta and coef bitwise equal to its plain version at the
    wrapper's grid, on the per-thread route and a coupled plan's batch
    route; the same launch without the buffers gives the same out and
    stats, and two launches agree bitwise."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    cpl.reset_launch_counts()
    plan, packed, y0, t, g, f0 = _plan_case(name, dtype, cuda, B=B)
    args = (plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0)
    kw = dict(max_steps=DENSE_ROWS, emit_dense=DENSE_ROWS)
    got = cpl.plan_solve(*args, **kw)
    assert len(got) == 4 and got[1][3].item() == 0
    assert _same(got, cpl.plan_solve(*args, **kw))
    ref = cpl.plan_solve_plain(
        *args, n_blocks=cpl.plan_blocks(plan, B, cuda), **kw)
    assert _same(got, ref), (got[1].tolist(), ref[1].tolist())
    bare = cpl.plan_solve(*args, max_steps=DENSE_ROWS)
    assert _same(bare, got[:2])
    n = got[1][1].item()
    meta, coef = got[2], got[3]
    assert coef.shape == (DENSE_ROWS, 5, B, y0.shape[1])
    assert torch.isinf(meta[n:]).all() and (coef[n:] == 0).all()
    assert meta[n - 1, 1].item() == t[-1].item()
    assert cpl.plan_solve_launches == 3


def test_failed_emission_launch_raises(cuda, monkeypatch):
    """A launch that the kernel refuses (here: rows without a metadata
    buffer) raises RuntimeError; nothing falls back."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    plan, packed, y0, t, g, f0 = _plan_case("spiral", torch.float32, cuda)
    real = cpl._ptr

    def null_meta(x):
        if x.ndim == 2 and x.shape == (DENSE_ROWS, 3):
            return real(x).__class__(0)
        return real(x)

    monkeypatch.setattr(cpl, "_ptr", null_meta)
    with pytest.raises(RuntimeError, match="plan_solve launch"):
        cpl.plan_solve(plan, packed, y0, t, 0.01, 1e-6, 1e-6, 1.0, f0,
                       max_steps=DENSE_ROWS, emit_dense=DENSE_ROWS)


def test_dense_entry_points_launch_k2_once(cuda):
    """fast.solve_fused(dense_output=True) is one K2 plan launch with the
    emission; odeint_adjoint(adjoint_mode='interpolated', options={'fuse':
    True}) one such launch forward, no K3, the generic backward, no
    fallback, finite gradients; the interpolant at the outputs agrees with
    the trajectory (interior outputs are the drain's own evaluation)."""
    from tfdiffeq_tpu_torch import odeint_adjoint
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    p, y = _bench(256, torch.float32, cuda)

    def f(tt, yy, q):
        return torch.tanh((yy ** 3) @ q[0] + q[1]) @ q[2] + q[3]

    q = tuple(p[k].clone().requires_grad_() for k in ("w1", "b1", "w2",
                                                      "b2"))
    t = torch.linspace(0.0, 5.0, 12)
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    res = fast.solve_fused(lambda tt, yy: f(tt, yy, q), y, t,
                           dense_output=True)
    torch.cuda.synchronize()
    assert (cpl.plan_solve_launches, cpl.plan_adjoint_launches) == (1, 0)
    assert res.stats.status == 0 and res.dense.coeffs.is_cuda
    ev = res.dense.eval_flat(t).reshape(res.ys.shape)
    assert float((ev - res.ys).abs().max()) < 1e-5
    cpl.reset_launch_counts()
    ys = odeint_adjoint(f, y, t, params=q, adjoint_mode="interpolated",
                        options={"fuse": True})
    grads = torch.autograd.grad((ys ** 2).mean(), q)
    torch.cuda.synchronize()
    assert (cpl.plan_solve_launches, cpl.plan_adjoint_launches) == (1, 0)
    assert fast.fuse_fallbacks == fb
    assert all(torch.isfinite(x).all() for x in grads)


def _recorded(monkeypatch, module, name):
    """Every call of module.name passed through, its (args, kwargs,
    result) kept in the returned list."""
    calls, fn = [], getattr(module, name)

    def record(*args, **kw):
        res = fn(*args, **kw)
        calls.append((args, kw, res))
        return res

    monkeypatch.setattr(module, name, record)
    return calls


def _df_spiral(B, device):
    """The spiral over float32 weights (w1, b1, w2, b2), float32 states,
    12 outputs over [0, 5], and its MSE target."""
    p, y = _bench(B, torch.float32, device)
    q = tuple(p[k].clone().requires_grad_() for k in ("w1", "b1", "w2",
                                                      "b2"))
    tgt = torch.tensor(np.random.RandomState(2).randn(12, B, 2) * 0.5,
                       dtype=torch.float32, device=device)

    def f(tt, yy, w):
        return torch.tanh((yy ** 3) @ w[0] + w[1]) @ w[2] + w[3]

    return f, q, y, torch.linspace(0.0, 5.0, 12), tgt


def test_solve_df_launches_k2_once(cuda):
    """solve_df on float32 dynamics: one K2 plan launch in float64, no
    fallback, the trajectory back in float32 with status 0."""
    from tfdiffeq_tpu_torch import solve_df
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    f, q, y, t, _ = _df_spiral(256, cuda)
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    with torch.no_grad():
        res = solve_df(lambda tt, yy: f(tt, yy, q), y, t)
    torch.cuda.synchronize()
    assert (cpl.plan_solve_launches, cpl.plan_adjoint_launches) == (1, 0)
    assert fast.fuse_fallbacks == fb
    assert res.stats.status == 0 and res.ys.dtype == torch.float32
    assert res.ys.is_cuda and torch.isfinite(res.ys).all()


def test_odeint_adjoint_df_launches_k2_and_k3_once(cuda):
    """One odeint_adjoint_df step: one K2 launch forward, one K3 sweep
    backward, no fallback, finite float32 gradients."""
    from tfdiffeq_tpu_torch import odeint_adjoint_df
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    f, q, y, t, tgt = _df_spiral(256, cuda)
    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    ys = odeint_adjoint_df(f, y, t, params=q)
    grads = torch.autograd.grad(torch.mean((ys - tgt) ** 2), q)
    torch.cuda.synchronize()
    assert (cpl.plan_solve_launches, cpl.plan_adjoint_launches) == (1, 1)
    assert fast.fuse_fallbacks == fb
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


@pytest.mark.parametrize("B", [4096, 33, 1])
def test_float64_tier_matches_plain(cuda, monkeypatch, B):
    """The float64 tier's launches from float32 callers: solve_df's K2
    launch and odeint_adjoint_df's K2 and K3 launches run in float64 and
    are bitwise equal to their plain versions at the wrapper's grid."""
    from tfdiffeq_tpu_torch import odeint_adjoint_df, solve_df
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    f, q, y, t, tgt = _df_spiral(B, cuda)
    solves = _recorded(monkeypatch, cpl, "plan_solve")
    sweeps = _recorded(monkeypatch, cpl, "plan_adjoint_solve")
    with torch.no_grad():
        solve_df(lambda tt, yy: f(tt, yy, q), y, t)
    ys = odeint_adjoint_df(f, y, t, params=q)
    torch.autograd.grad(torch.mean((ys - tgt) ** 2), q)
    assert len(solves) == 2 and len(sweeps) == 1
    with torch.no_grad():      # the training launch's packed constants
        for args, kw, got in solves:
            assert args[2].dtype == torch.float64
            assert got[1][3].item() == 0
            ref = cpl.plan_solve_plain(
                *args, n_blocks=cpl.plan_blocks(args[0], B, cuda), **kw)
            assert _same(got, ref), (got[1].tolist(), ref[1].tolist())
        args, kw, got = sweeps[0]
        assert args[2].dtype == torch.float64 and got[3][3].item() == 0
        ref = cpl.plan_adjoint_solve_plain(*args, **kw)
        assert _same_sweep(got, ref), (got[3].tolist(), ref[3].tolist())


# ---------------------------------------------------------------------------
# K4 at the sites the tiers reached last: K5's tile engine (the MLP and a
# plan) and a plan's tiered dots in K2 and K8 (K14's tile walk)
# ---------------------------------------------------------------------------

def _tier_plan(device, dtype, B=48, coupled=False, scale=None):
    """The wide case's MLP as plain code, captured (every dot selected
    under matmul='auto'); with `coupled` a mean-field term, with `scale` a
    per-sample factor. Returns (plan, packed, y0, t, f0)."""
    from tfdiffeq_tpu_torch.ops import plan_bridge as pb
    weights, _, _, y0, t = _wide_case(device, dtype, B=B)

    def f(tt, y):
        h = y
        for i, (w, b) in enumerate(weights):
            h = h @ w + b
            if i < len(weights) - 1:
                h = torch.tanh(h)
        if coupled:
            h = h - 0.5 * (y - y.mean(0))
        return h if scale is None else scale * h

    plan, consts = pb.build_plan(f, t[0].to(device), y0)
    packed = pb.pack_consts(plan, consts, dtype, device)
    f0 = pb.eval_plan_host(plan, packed, t[0].to(device), y0).contiguous()
    return plan, packed, y0, t, f0


def _tier_held(got, ref, dtype, tier, adaptive, per_sample=False):
    """float64 bitwise; float32 'mixed' within 5e-5 with counts within one
    (adaptive) or equal (fixed grid), 'bf16' on a fixed grid within its
    solve bar; per sample each sample's counts within one and the
    reference's float32 budget (a flipped decision moves that sample's
    later steps)."""
    out, st = got[0], got[1]
    if dtype == torch.float64:
        return _same(got, ref)
    if per_sample:
        assert int((got[2][1:3] - ref[2][1:3]).abs().max()) <= 1
        torch.testing.assert_close(out, ref[0], rtol=1e-3, atol=2e-4)
        return True
    if adaptive:
        assert all(abs(a - b) <= 1 for a, b in zip(st[1:3].tolist(),
                                                   ref[1][1:3].tolist()))
    else:
        assert torch.equal(st, ref[1])
    bar = 5e-5 if tier == "mixed" else SOLVE_BARS["bf16"][0]
    assert float((out - ref[0]).abs().max()) < bar
    return True


@pytest.mark.parametrize("tier", ["mixed", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tier_perlane_kernel_matches_plain(cuda, dtype, tier):
    """K5's tile engine on the MLP route (16 samples a block in lockstep),
    a battery whose samples take different numbers of attempts (states
    scaled and first steps spread) and about half run out of steps: float64 bitwise, lane counts included; float32
    'mixed' with each sample's counts within one and within the reference's
    float32 budget (rtol 1e-3, atol 2e-4), 'bf16' within its tier's error
    (1e-2); run to run bitwise."""
    weights, warr, dims, y0, t = _wide_case(cuda, dtype, B=40)
    y0 = y0 * torch.logspace(0.0, 1.0, 40, dtype=dtype,
                             device=cuda)[:, None]
    tiers = ck.layer_tiers(dims, "auto", tier)
    f0 = fast.mlp_apply(fast.MLPSpec(), weights, y0)
    # First steps from 1e-4 to 0.1: the samples need different attempts.
    dt0 = torch.logspace(-4.0, -1.0, 40, dtype=dtype, device=cuda)
    args = (warr, dims, y0, t, dt0, 1e-4, 1e-4, 1.0)
    # A step budget at the samples' median need: about half run out, the
    # others finish at their own attempts.
    lane = cp.mlp_solve_perlane_plain(*args, f0=f0, tiers=tiers)[2]
    kw = dict(f0=f0, tiers=tiers,
              max_steps=int((lane[1] + lane[2]).median()) + 1)
    got = cp.mlp_solve_perlane(*args, **kw)
    again = cp.mlp_solve_perlane(*args, **kw)
    ref = cp.mlp_solve_perlane_plain(*args, **kw)
    torch.cuda.synchronize()
    assert cp.mlp_solve_perlane_launches == ck.dot_tier_launches == 2
    assert _same(got, again)
    assert torch.isfinite(got[0]).all()
    if dtype == torch.float64:
        assert set(got[2][3].tolist()) == {0, 1}
        assert _same(got, ref)
    elif tier == "mixed":
        # Each sample under its own controller: a decision the tensor
        # cores' summation order flips moves that sample's later steps, so
        # the reference's float32 budget for whole solves holds it.
        lane, lref = got[2], ref[2]
        assert int((lane[1:3] - lref[1:3]).abs().max()) <= 1
        torch.testing.assert_close(got[0], ref[0], rtol=1e-3, atol=2e-4)
    else:
        assert float((got[0] - ref[0]).abs().max()) < 1e-2


@pytest.mark.parametrize("route", ["solve", "dense", "fixed", "perlane",
                                   "coupled_solve", "coupled_fixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tier_plan_routes_match_plain(cuda, dtype, route):
    """K14's tile walk at a reduced tier in K2 (with and without its dense
    output), K8 and K5's tile engine, and a coupled plan on one block of K2
    and K8: each launch against `plan_solve_plain` / `plan_solve_fixed_plain`
    at the same tier, float64 bitwise, float32 within the tier's bars."""
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    coupled = route.startswith("coupled")
    plan, packed, y0, t, f0 = _tier_plan(cuda, dtype, coupled=coupled)
    cpl.reset_launch_counts()
    tau = t
    fixed = route.endswith("fixed")
    tier = "bf16" if fixed and not coupled else "mixed"
    if fixed:
        grid = uniform_grid(t[0], t[-1], 16)
        args = (plan, packed, y0, tau, grid, 1.0, f0)
        kw = dict(method="rk4", dot_precision=tier)
        fn, plain = cpl.plan_solve_fixed, cpl.plan_solve_fixed_plain
    else:
        args = (plan, packed, y0, tau, 0.05, 1e-4, 1e-4, 1.0, f0)
        kw = dict(dot_precision=tier, per_sample=route == "perlane")
        if route == "dense":
            kw.update(emit_dense=64, max_steps=64)
        fn, plain = cpl.plan_solve, cpl.plan_solve_plain
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    pkw = dict(kw)
    if not fixed and route != "perlane":
        pkw["n_blocks"] = cpl.plan_blocks(plan, y0.shape[0], cuda, True)
    ref = plain(*args, **pkw)
    torch.cuda.synchronize()
    assert cpl.last_route["fixed" if fixed else (
        "perlane" if route == "perlane" else "solve")] == f"tile/{tier}"
    assert ck.dot_tier_launches == 2
    assert _same(got, again)
    assert got[1][3].item() == 0 and torch.isfinite(got[0]).all()
    _tier_held(got, ref, dtype, tier, not fixed, route == "perlane")
    if route == "dense" and dtype == torch.float64:
        assert torch.isfinite(got[3]).all()


def test_tiered_entry_points_launch_their_kernels(cuda):
    """The slice's public entry points at a reduced tier launch the tile
    routes and never fall back: solve(fuse, 'mixed') on K2, rk4 'bf16' and
    'mixed' on K8, per_sample 'mixed' on K5's tile engine through a plan and
    through `solve_mlp_spec`; the gates raise before any launch."""
    from tfdiffeq_tpu_torch import solve
    from tfdiffeq_tpu_torch.ops import cuda_plan as cpl
    weights, _, _, y0, t = _wide_case(cuda, torch.float32, B=64)

    def f(tt, y):
        h = y
        for i, (w, b) in enumerate(weights):
            h = h @ w + b
            if i < len(weights) - 1:
                h = torch.tanh(h)
        return h

    cpl.reset_launch_counts()
    fb = fast.fuse_fallbacks
    runs = [solve(f, y0, t, rtol=1e-4, atol=1e-4, options={
        "fuse": True, "dot_precision": "mixed", "first_step": 0.01})]
    for prec in ("bf16", "mixed"):
        runs.append(solve(f, y0, t, method="rk4", options={
            "fuse": True, "dot_precision": prec, "num_steps": 16}))
    runs.append(solve(f, y0, t, rtol=1e-4, atol=1e-4, options={
        "fuse": True, "per_sample": True, "dot_precision": "mixed",
        "first_step": 0.01}))
    runs.append(fast.solve_mlp_spec(
        fast.MLPSpec(matmul="mxu", dot_precision="mixed"), weights, y0, t,
        rtol=1e-4, atol=1e-4, first_step=0.01, per_sample=True))
    torch.cuda.synchronize()
    assert (cpl.plan_solve_launches, cpl.plan_fixed_launches,
            cpl.plan_perlane_launches,
            cp.mlp_solve_perlane_launches) == (1, 2, 1, 1)
    assert ck.dot_tier_launches == 5 and fast.fuse_fallbacks == fb
    for r in runs:
        assert int(torch.as_tensor(r.stats.status).max()) == 0
        assert torch.isfinite(r.ys).all()
    with pytest.raises(ValueError, match="fixed-grid"):
        solve(f, y0, t, options={"fuse": True, "dot_precision": "bf16"})
    assert ck.dot_tier_launches == 5
