"""PyTorch port: the fused-tier kernels' plain versions against the JAX
Pallas kernels (run in interpret mode, as tests/test_pallas_fast.py does).

On the CPU each wrapper in tfdiffeq_tpu_torch.ops.cuda_kernels takes its
kernel's plain PyTorch version; tests/test_torch_gpu.py holds the CUDA
kernels to those plain versions on the card. Float64 here: the plain
versions repeat the Pallas kernels' arithmetic, so values agree to
1e-12 and whole solves take identical step sequences. Batches stay under
256, where the reference does not pack sublanes (packing reorders its
error sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.ops import pallas_kernels as JK
from tfdiffeq_tpu_torch.ops import _build, cuda_kernels as PK

F64 = torch.float64


def _params(D=2, H=50, seed=0):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(D, H) * 0.1, "b1": rng.randn(H) * 0.05,
            "w2": rng.randn(H, D) * 0.1, "b2": rng.randn(D) * 0.05}


def _tt(x, dtype=F64):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("B", [96, 300])
def test_step_plain_matches_reference(B):
    p = _params()
    y0 = np.random.RandomState(1).randn(B, 2) * 1.5
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    f0 = np.asarray(JK.mlp_f(pj, jnp.asarray(y0.T))).T
    # A step whose error is well above rounding, so that the ratio is
    # resolved to 1e-10 whatever order either side sums in.
    dt = 0.5
    y1, f1, ratio, ymid = JK.dopri5_mlp_step(
        pj, jnp.asarray(y0.T), jnp.asarray(f0.T), jnp.float64(dt),
        jnp.float64(1e-6), jnp.float64(1e-8), interpret=True)
    got = PK.dopri5_mlp_step({k: _tt(v) for k, v in p.items()}, _tt(y0),
                             _tt(f0), dt, 1e-6, 1e-8)
    for a, b in zip((got[0], got[1], got[3]), (y1, f1, ymid)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).T, rtol=1e-12,
                                   atol=1e-14)
    np.testing.assert_allclose(float(got[2]), float(ratio), rtol=1e-10)
    assert PK.dopri5_mlp_step_launches == 0       # the plain version ran


def test_step_plain_folds_non_finite_into_inf():
    p = _params()
    y0 = np.random.RandomState(2).randn(40, 2)
    y0[7, 1] = np.nan
    pt = {k: _tt(v) for k, v in p.items()}
    f0 = PK._mlp_tanh_plain(pt, _tt(y0))
    _, _, ratio, _ = PK.dopri5_mlp_step(pt, _tt(y0), f0, 0.1, 1e-6, 1e-8)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    ref = JK.dopri5_mlp_step(pj, jnp.asarray(y0.T), jnp.asarray(f0.numpy().T),
                             jnp.float64(0.1), jnp.float64(1e-6),
                             jnp.float64(1e-8), interpret=True)[2]
    assert float(ratio) == float(ref) == float("inf")


def test_tree_sums_follow_the_kernel_order():
    v = torch.arange(1.0, 21.0, dtype=F64).view(10, 2)
    owned = PK._owned_sums(v * v, 4)      # thread i owns samples i, i + 4, ..
    expect = [sum(float(x) ** 2 for b in range(i, 10, 4) for x in v[b])
              for i in range(4)]
    assert owned.tolist() == expect
    assert float(PK._tree_sum(owned)) == (expect[0] + expect[2]) + \
        (expect[1] + expect[3])


def _spec_weights(seed, dims, bias=True):
    rng = np.random.RandomState(seed)
    return [(rng.randn(i, o) * 0.3, rng.randn(o) * 0.1 if bias else None)
            for i, o in dims]


def _solve_both(weights, y0, tau, sign, dt0, **kw):
    """Run JAX mlp_solve (interpret) and the port's mlp_solve on the same
    numpy inputs; returns ((out [T, B, D], stats) of the reference,
    (out, stats) of the port)."""
    warr, dims = JK.pad_mlp_weights(
        [(jnp.asarray(W), None if b is None else jnp.asarray(b))
         for W, b in weights], jnp.float64)
    out, st = JK.mlp_solve(warr, dims, jnp.asarray(y0.T), jnp.asarray(tau),
                           jnp.float64(dt0), 1e-6, 1e-8, sign,
                           interpret=True, **kw)
    pw, pdims = PK.pack_mlp_weights(
        [(_tt(W), None if b is None else _tt(b)) for W, b in weights], F64)
    assert pdims == dims
    got = PK.mlp_solve(pw, pdims, _tt(y0), _tt(tau), dt0, 1e-6, 1e-8, sign,
                       **kw)
    return (np.asarray(out).transpose(0, 2, 1), [int(s) for s in st]), got


@pytest.mark.parametrize("case", [
    dict(act="tanh", final="identity", power=3, time_input=False,
         dims=[(2, 50), (50, 2)], method="dopri5"),
    dict(act="elu", final="identity", power=1, time_input=True,
         dims=[(3, 16), (16, 16), (16, 2)], method="tsit5"),
    dict(act="softplus", final="tanh", power=2, time_input=False,
         dims=[(2, 12), (12, 2)], method="bosh3"),
    dict(act="silu", final="identity", power=1, time_input=False,
         dims=[(2, 10), (10, 2)], method="adaptive_heun"),
    dict(act="sigmoid", final="relu", power=1, time_input=True,
         dims=[(3, 8), (8, 2)], method="dopri8"),
])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_solve_plain_matches_reference(case, sign):
    weights = _spec_weights(4, case["dims"])
    y0 = np.random.RandomState(5).randn(64, 2)
    tau = np.linspace(0.0, 2.0, 7)
    kw = dict(activation=case["act"], final_activation=case["final"],
              input_power=case["power"], time_input=case["time_input"],
              method=case["method"])
    # tau increases in both directions: sign = -1 integrates the canonical
    # g(tau, y) = -f(-tau, y) of a decreasing t (solvers/base.py).
    (ref_out, ref_st), (out, st) = _solve_both(weights, y0, tau, sign,
                                               dt0=0.05, **kw)
    assert st.tolist() == ref_st
    assert ref_st[3] == 0
    # XLA's and PyTorch's exp / tanh may differ in the last bit; over the
    # solve that moves the O(1) states by up to ~1e-11, hence the atol.
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-10, atol=1e-10)
    assert PK.mlp_solve_launches == 0


def test_solve_invalid_times_status_3_and_zero_fill():
    weights = _spec_weights(6, [(2, 50), (50, 2)])
    y0 = np.random.RandomState(7).randn(16, 2)
    tau = np.array([0.0, 1.0, 0.5])          # not increasing
    (ref_out, ref_st), (out, st) = _solve_both(
        weights, y0, tau, 1.0, dt0=0.05, input_power=3)
    assert st.tolist() == ref_st == [0, 0, 0, 3]
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(out[0].numpy(), y0)
    assert not out[1:].any()


def test_solve_max_steps_status_1_and_zero_filled_tail():
    weights = _spec_weights(8, [(2, 50), (50, 2)])
    y0 = np.random.RandomState(9).randn(32, 2)
    tau = np.linspace(0.0, 50.0, 6)
    (ref_out, ref_st), (out, st) = _solve_both(
        weights, y0, tau, 1.0, dt0=0.01, input_power=3, max_steps=3)
    assert st.tolist() == ref_st
    assert ref_st[3] == 1 and ref_st[1] + ref_st[2] == 3
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-10, atol=1e-12)
    assert not out[-1].any()


@pytest.mark.parametrize("name", sorted(JK._ACTIVATIONS))
def test_activations_match_reference(name):
    x = np.linspace(-6.0, 6.0, 101)
    np.testing.assert_allclose(PK._ACTIVATIONS[name](_tt(x)).numpy(),
                               np.asarray(JK._ACTIVATIONS[name](
                                   jnp.asarray(x))), rtol=1e-14, atol=1e-15)
    assert name in PK._ACT_CODES


def test_pack_mlp_weights_layout():
    weights = _spec_weights(10, [(3, 5), (5, 2)], bias=False)
    packed, dims = PK.pack_mlp_weights(
        [(_tt(W), None) for W, _ in weights], F64)
    assert dims == ((3, 5), (5, 2))
    assert packed.shape == (3 * 5 + 5 + 5 * 2 + 2,)
    (w0, b0), (w1, b1) = PK._unpack(packed, dims)
    np.testing.assert_array_equal(w0.numpy(), weights[0][0].T)
    np.testing.assert_array_equal(w1.numpy(), weights[1][0].T)
    assert not b0.any() and not b1.any()


def test_wrappers_refuse_bad_inputs():
    p = {k: _tt(v) for k, v in _params().items()}
    y = torch.zeros(4, 2, dtype=F64)
    with pytest.raises(ValueError, match="different devices"):
        PK.dopri5_mlp_step(p, y, torch.zeros(4, 2, dtype=F64,
                                             device="meta"), 0.1, 1e-6, 1e-8)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        meta = torch.zeros(4, 2, dtype=F64, device="meta")
        PK.dopri5_mlp_step({k: v.to("meta") for k, v in p.items()}, meta,
                           meta, 0.1, 1e-6, 1e-8)
    with pytest.raises(ValueError, match="unknown method"):
        PK.mlp_solve(torch.zeros(1, dtype=F64), ((1, 1),), y, _tt([0., 1.]),
                     0.1, 1e-6, 1e-8, 1.0, method="rk4")


def test_build_sources_cover_csrc():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert names == set(_build.SOURCES + _build.HEADERS
                        + _build.PLAN_HEADERS)
    assert "adjoint_kernel.cu" in _build.SOURCES
    assert len(_build.source_hash()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_first_step_reaches_the_solve_in_its_dtype():
    """A Python-float first step enters a float64 solve as float64. It
    once passed through float32 on the way (0.02 became 0.0200000004),
    which moved every step of a float64 solve or sweep off the
    reference's."""
    tau = torch.linspace(0.0, 1.0, 3, dtype=F64)
    assert PK._solve_setup(tau, 0.02, F64)[2].item() == 0.02
    p = {k: _tt(v) for k, v in _params().items()}
    warr, dims = PK.pack_mlp_weights([(p["w1"], p["b1"]),
                                      (p["w2"], p["b2"])], F64)
    y0 = _tt(np.random.RandomState(3).randn(20, 2))
    kw = dict(activation="tanh", input_power=3)
    a = PK.mlp_solve(warr, dims, y0, tau, 0.02, 1e-8, 1e-10, 1.0, **kw)
    b = PK.mlp_solve(warr, dims, y0, tau, torch.tensor(0.02, dtype=F64),
                     1e-8, 1e-10, 1.0, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
