"""PyTorch port: the plain version of K3 (`ops/cuda_adjoint.py`) against the
JAX package's fused adjoint sweep (`pallas_adjoint.mlp_adjoint_solve`, run
in interpret mode with `pack=1`), and the activation derivatives.

The same numpy inputs go to both: ys and g batch-major [T, B, D] for the
port, transposed to the reference's feature-major [T, D, B]; the weights
packed by `pack_mlp_weights` and padded by `pad_mlp_weights`. Float64
throughout: both sides run the same arithmetic and only the order of the
batch sums differs, so every case takes identical steps ([nfe, accepted,
rejected, status]) and ay0, the parameter cotangents and a_t agree within
rtol 1e-10. Batches stay under 128 (one lane tile on the reference, no
packing). Each case compiles the reference once (about 12 s on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.ops import pallas_kernels as JK
from tfdiffeq_tpu.ops.pallas_adjoint import mlp_adjoint_solve as j_adjoint
from tfdiffeq_tpu_torch.ops import cuda_adjoint as PA, cuda_kernels as PK

F64 = torch.float64


def _weights(dims, seed, bias=True, no_bias_layer=None):
    rng = np.random.RandomState(seed)
    out = []
    for l, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        W = rng.randn(a, b) * 0.3 / np.sqrt(a)
        bb = rng.randn(b) * 0.05
        out.append((W, None if (not bias or l == no_bias_layer) else bb))
    return out


CASES = {
    # name: (dims, activation, input_power, time_input, method, seminorm,
    #        sign, rtol, atol)
    "dopri5_elu": ((4, 20, 20, 4), "elu", 1, False, "dopri5", False, 1.0,
                   1e-6, 1e-8),
    "dopri5_elu_seminorm": ((4, 20, 20, 4), "elu", 1, False, "dopri5",
                            True, 1.0, 1e-6, 1e-8),
    # The a_t quadrature inside the error norm.
    "bosh3_time_input": ((3, 16, 2), "softplus", 1, True, "bosh3", False,
                         1.0, 1e-6, 1e-8),
    # The spiral's MLP on y**3, in reverse time (sign -1).
    "tsit5_power3_reverse": ((2, 50, 2), "tanh", 3, False, "tsit5", False,
                             -1.0, 1e-6, 1e-6),
    # A bias-free layer with the time column and seminorm.
    "dopri5_nobias_time_seminorm": ((3, 12, 12, 2), "silu", 1, True,
                                    "dopri5", True, 1.0, 1e-6, 1e-8),
}


def _inputs(dims, time_input, seed, B=12, T=6):
    rng = np.random.RandomState(seed + 100)
    D = dims[-1]
    ys = rng.randn(T, B, D)
    g = rng.randn(T, B, D)
    tau = np.sort(rng.uniform(0.0, 2.0, T))
    tau[0] = 0.0
    return ys, g, tau


@pytest.mark.parametrize("name", sorted(CASES))
def test_adjoint_plain_matches_reference(name):
    (dims, act, power, time_input, method, seminorm, sign, rtol,
     atol) = CASES[name]
    no_bias = 1 if "nobias" in name else None
    W = _weights(dims, seed=len(name), no_bias_layer=no_bias)
    ys, g, tau = _inputs(dims, time_input, seed=len(name))
    dt0 = 0.1 * (tau[-1] - tau[-2])
    kw = dict(activation=act, input_power=power, time_input=time_input,
              method=method, seminorm=seminorm)

    warr_j, dims_j = JK.pad_mlp_weights(
        [(jnp.asarray(a), None if b is None else jnp.asarray(b))
         for a, b in W], jnp.float64)
    ay0_j, aws_j, at_j, st_j = j_adjoint(
        warr_j, dims_j, jnp.asarray(ys.transpose(0, 2, 1)),
        jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau), dt0, rtol,
        atol, sign, interpret=True, pack=1, **kw)

    warr, pdims = PK.pack_mlp_weights(
        [(torch.tensor(a), None if b is None else torch.tensor(b))
         for a, b in W], F64)
    ay0, aw, at, st = PA.mlp_adjoint_solve(
        warr, pdims, torch.tensor(ys), torch.tensor(g), torch.tensor(tau),
        dt0, rtol, atol, sign, **kw)

    assert st.tolist() == [int(s) for s in st_j]
    assert st[3].item() == 0 and st[2].item() >= 0
    np.testing.assert_allclose(ay0.numpy(), np.asarray(ay0_j).T, rtol=1e-10,
                               atol=1e-12)
    ref_w = []
    for (dW, db), (din, dout) in zip(aws_j, dims_j):
        ref_w += [np.asarray(dW)[:dout, :din].reshape(-1),
                  np.asarray(db)[:dout, 0]]
    np.testing.assert_allclose(aw.numpy(), np.concatenate(ref_w),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(at), float(at_j), rtol=1e-10,
                               atol=1e-12)
    if not time_input:
        assert float(at) == 0.0
    assert PA.mlp_adjoint_solve_launches == 0     # the plain version ran


@pytest.mark.parametrize("act", sorted(PK._ACTIVATION_GRADS))
def test_activation_grads_match_reference(act):
    z = np.linspace(-3.0, 3.0, 41)
    a = np.asarray(JK._ACTIVATIONS[act](jnp.asarray(z)))
    want = np.asarray(JK._ACTIVATION_GRADS[act](jnp.asarray(z),
                                                jnp.asarray(a)))
    got = PK._ACTIVATION_GRADS[act](torch.tensor(z), torch.tensor(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


def test_lane_sums_follow_the_kernel_order():
    """Lane j adds rows j, j + 32, ... in turn, then a 32-lane tree: the
    order csrc/adjoint_kernel.cu takes every batch sum in."""
    x = torch.tensor(np.random.RandomState(0).randn(70, 3))
    lanes = [sum((x[b] for b in range(j, 70, 32)),
                 torch.zeros(3, dtype=F64)) for j in range(32)]
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + h] for i in range(h)]
    assert torch.equal(PA._lane_sums(x), lanes[0])


def test_adjoint_plain_status_codes():
    """max_steps cuts the sweep with status 1 at the first attempt past
    the budget that ends short of its interval (the reference's rule)."""
    W = _weights((4, 20, 20, 4), seed=3)
    ys, g, tau = _inputs((4, 20, 20, 4), False, seed=3)
    warr, pdims = PK.pack_mlp_weights(
        [(torch.tensor(a), torch.tensor(b)) for a, b in W], F64)
    _, _, _, st = PA.mlp_adjoint_solve(
        warr, pdims, torch.tensor(ys), torch.tensor(g), torch.tensor(tau),
        0.01, 1e-8, 1e-10, 1.0, activation="elu", max_steps=3)
    nfe, nacc, nrej, status = st.tolist()
    assert status == 1 and 3 <= nacc + nrej <= 4
    assert nfe == 7 * (nacc + nrej)
