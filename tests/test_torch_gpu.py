"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, and the launch counters of the slice.

Marked `gpu`; the `cuda` fixture skips every test where
torch.cuda.is_available() is false (it decides when a test runs, never at
import, so every pytest-xdist worker collects the same tests). This file
imports no JAX, so on the machine with the card it runs without the JAX
package's conftest:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerances: the plain versions repeat each kernel's arithmetic in the same
order (the kernels are built with --fmad=false and sum their errors in a
fixed tree the plain versions follow), so float64 results agree to 1e-12
and whole solves take identical step sequences. Float32 whole solves are
held to the reference's float32 budget (rtol 1e-3, atol 2e-4).
"""

import numpy as np
import pytest
import torch

from tfdiffeq_tpu_torch import fast
from tfdiffeq_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    ck.reset_launch_counts()
    return torch.device("cuda")


def _bench(B, dtype, device):
    """The benchmark's weights and states (bench.py:32-39, :268-270)."""
    rng = np.random.RandomState(0)
    p = {"w1": rng.randn(2, 50) * 0.1, "b1": np.zeros(50),
         "w2": rng.randn(50, 2) * 0.1, "b2": np.zeros(2)}
    y0 = np.random.RandomState(1).randn(B, 2) * 1.5
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return {k: as_t(v) for k, v in p.items()}, as_t(y0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_kernel_matches_plain(cuda, dtype):
    p, y = _bench(4096, dtype, cuda)
    f0 = fast.mlp_apply(fast.MLPSpec(input_power=3),
                        [(p["w1"], p["b1"]), (p["w2"], p["b2"])], y)
    got = ck.dopri5_mlp_step(p, y, f0, 0.3, 1e-6, 1e-6)
    ref = ck.dopri5_mlp_step_plain(p, y, f0, 0.3, 1e-6, 1e-6)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
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
        [(torch.zeros(2, 200), None), (torch.zeros(200, 2), None)],
        torch.float32, cuda)
    with pytest.raises(ValueError, match="MAX_WIDTH"):
        ck.mlp_solve(warr, dims, y, torch.linspace(0.0, 1.0, 3), 0.1, 1e-6,
                     1e-6, 1.0, f0=torch.zeros_like(y))
    assert ck.mlp_solve_launches == ck.dopri5_mlp_step_launches == 0
