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
The grid's order (n_blocks ranges of the batch, each block's lane sums,
the partials in block order): n_blocks = 1 bitwise equal to a saved copy
of the one-block functions, 3 and 7 (ranges of unequal length) against
the reference within the same bars, and any grid against one block within
1e-12 with the same steps.
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


# ---------------------------------------------------------------------------
# The grid's sum order: K3 cuts the batch into n_blocks contiguous ranges;
# each block sums its own samples in the lane order, and the blocks'
# partials meet in block order. n_blocks = 1 is the one-block order.
# ---------------------------------------------------------------------------

def _old_lane_sums(x):
    """ops/cuda_adjoint.py `_lane_sums` as it stood before the grid (the
    order of the one-block kernel's batch sums), kept to hold n_blocks = 1
    to it."""
    B, R = x.shape
    K = -(-B // 32)
    x = torch.nn.functional.pad(x, (0, 0, 0, K * 32 - B)).view(K, 32, R)
    acc = torch.zeros(32, R, dtype=x.dtype)
    for k in range(K):
        acc = acc + x[k]
    return PK._tree_sum(acc.t())


@pytest.mark.parametrize("B", [1, 31, 70, 129])
def test_one_block_sums_keep_the_old_order(B):
    """At n_blocks = 1 the lane sums and the error norm's per-thread sums
    and tree are bitwise the one-block kernel's."""
    rng = np.random.RandomState(B)
    x = torch.tensor(rng.randn(B, 5))
    lanes = PA._block_lane_sums(x, PA._block_index(B, 1, PA.LANES, "cpu"))
    assert lanes.shape == (1, 5) and torch.equal(lanes[0], _old_lane_sums(x))
    sq = torch.tensor(rng.randn(B, 3)) ** 2
    owned = PA._block_owned_sums(
        sq, PA._block_index(B, 1, PA.ADJOINT_THREADS, "cpu"))
    assert torch.equal(PA._merge_blocks(PK._tree_sum(owned)),
                       PK._tree_sum(PK._owned_sums(sq, PA.ADJOINT_THREADS)))


@pytest.mark.parametrize("n_blocks", [3, 7])
def test_block_partials_are_the_lane_sums_of_their_ranges(n_blocks):
    """Block k's partial is the lane-order sum of its own range [k B / n,
    (k + 1) B / n) (ranges of unequal length here), and the merge adds the
    partials in block order."""
    B = 40
    x = torch.tensor(np.random.RandomState(n_blocks).randn(B, 4))
    e = PK._block_bounds(B, n_blocks)
    assert e[0] == 0 and e[-1] == B and len(set(np.diff(e))) > 1
    parts = PA._block_lane_sums(x, PA._block_index(B, n_blocks, PA.LANES,
                                                   "cpu"))
    for k in range(n_blocks):
        assert torch.equal(parts[k], _old_lane_sums(x[e[k]:e[k + 1]]))
    want = parts[0]
    for k in range(1, n_blocks):
        want = want + parts[k]
    assert torch.equal(PA._merge_blocks(parts), want)


def test_one_block_sweep_keeps_the_old_order(monkeypatch):
    """The whole plain sweep at n_blocks = 1 against the same sweep with
    its sums taken by the one-block functions: bitwise equal."""
    (dims, act, power, time_input, method, seminorm, sign, rtol,
     atol) = CASES["bosh3_time_input"]
    W = _weights(dims, seed=4)
    ys, g, tau = _inputs(dims, time_input, seed=4, B=40)
    warr, pdims = PK.pack_mlp_weights(
        [(torch.tensor(a), torch.tensor(b)) for a, b in W], F64)
    args = (warr, pdims, torch.tensor(ys), torch.tensor(g),
            torch.tensor(tau), 0.05, rtol, atol, sign)
    kw = dict(activation=act, input_power=power, time_input=time_input,
              method=method, seminorm=seminorm)
    got = PA.mlp_adjoint_solve_plain(*args, n_blocks=1, **kw)
    monkeypatch.setattr(PA, "_block_lane_sums",
                        lambda x, idx: _old_lane_sums(x)[None])
    monkeypatch.setattr(
        PA, "_block_owned_sums",
        lambda sq, idx, acc=None: PK._owned_sums(
            sq, PA.ADJOINT_THREADS, None if acc is None else acc[0])[None])
    old = PA.mlp_adjoint_solve_plain(*args, n_blocks=1, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, old))


_REFERENCE = {}


def _grid_case(name, B=40):
    """A case's inputs at B samples, and the reference's sweep on them
    (computed once a case)."""
    (dims, act, power, time_input, method, seminorm, sign, rtol,
     atol) = CASES[name]
    no_bias = 1 if "nobias" in name else None
    W = _weights(dims, seed=len(name), no_bias_layer=no_bias)
    ys, g, tau = _inputs(dims, time_input, seed=len(name), B=B)
    dt0 = 0.1 * (tau[-1] - tau[-2])
    kw = dict(activation=act, input_power=power, time_input=time_input,
              method=method, seminorm=seminorm)
    if (name, B) not in _REFERENCE:
        warr_j, dims_j = JK.pad_mlp_weights(
            [(jnp.asarray(a), None if b is None else jnp.asarray(b))
             for a, b in W], jnp.float64)
        out = j_adjoint(warr_j, dims_j, jnp.asarray(ys.transpose(0, 2, 1)),
                        jnp.asarray(g.transpose(0, 2, 1)), jnp.asarray(tau),
                        dt0, rtol, atol, sign, interpret=True, pack=1, **kw)
        _REFERENCE[name, B] = (out, dims_j)
    warr, pdims = PK.pack_mlp_weights(
        [(torch.tensor(a), None if b is None else torch.tensor(b))
         for a, b in W], F64)
    args = (warr, pdims, torch.tensor(ys), torch.tensor(g),
            torch.tensor(tau), dt0, rtol, atol, sign)
    return args, kw, _REFERENCE[name, B]


@pytest.mark.parametrize("n_blocks", [1, 3, 7])
@pytest.mark.parametrize("name", ["bosh3_time_input",
                                  "dopri5_nobias_time_seminorm"])
def test_grid_plain_matches_reference(name, n_blocks):
    """The plain K3 in the order of a grid of n_blocks blocks (B = 40:
    ranges of unequal length) against the reference's sweep, float64:
    identical stats, outputs within rtol 1e-10 (as above)."""
    args, kw, ((ay0_j, aws_j, at_j, st_j), dims_j) = _grid_case(name)
    ay0, aw, at, st = PA.mlp_adjoint_solve(*args, n_blocks=n_blocks, **kw)
    assert st.tolist() == [int(s) for s in st_j] and st[3].item() == 0
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
    assert PA.mlp_adjoint_solve_launches == 0


@pytest.mark.parametrize("n_blocks", [3, 7, 40, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_grid_plain_matches_one_block(name, n_blocks):
    """Another grid changes only the order of the batch sums: float64
    sweeps take the same steps (stats) and agree within rtol 1e-12; a grid
    wider than the batch (64 > B = 40) leaves blocks without samples."""
    (dims, act, power, time_input, method, seminorm, sign, rtol,
     atol) = CASES[name]
    W = _weights(dims, seed=len(name) + 1)
    ys, g, tau = _inputs(dims, time_input, seed=len(name) + 1, B=40)
    warr, pdims = PK.pack_mlp_weights(
        [(torch.tensor(a), torch.tensor(b)) for a, b in W], F64)
    args = (warr, pdims, torch.tensor(ys), torch.tensor(g),
            torch.tensor(tau), 0.05, rtol, atol, sign)
    kw = dict(activation=act, input_power=power, time_input=time_input,
              method=method, seminorm=seminorm)
    one = PA.mlp_adjoint_solve_plain(*args, n_blocks=1, **kw)
    grid = PA.mlp_adjoint_solve_plain(*args, n_blocks=n_blocks, **kw)
    assert grid[3].tolist() == one[3].tolist() and one[3][3].item() == 0
    for a, b in zip(grid[:3], one[:3]):
        assert float((a - b).abs().max()) <= 1e-12 * max(
            float(b.abs().max()), 1e-300)


def test_grid_refusals():
    """n_blocks is a positive int or None (the kernel's grid)."""
    W = _weights((4, 20, 20, 4), seed=3)
    ys, g, tau = _inputs((4, 20, 20, 4), False, seed=3)
    warr, pdims = PK.pack_mlp_weights(
        [(torch.tensor(a), torch.tensor(b)) for a, b in W], F64)
    for bad in (0, -2, 2.0):
        with pytest.raises(ValueError, match="n_blocks"):
            PA.mlp_adjoint_solve(warr, pdims, torch.tensor(ys),
                                 torch.tensor(g), torch.tensor(tau), 0.05,
                                 1e-6, 1e-8, 1.0, n_blocks=bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_narrow_route_counts_one_group_slot(dtype):
    """K3's route counts one slot of the grouped walk's four vectors for an
    MLP (the kernel fits as many more as shared memory holds) and, for
    K7's CNF walk, one of its slots and the weights' transposed copy: a
    net whose weights and stage cotangents nearly fill MAX_WEIGHT_BYTES in
    float64 keeps the narrow route."""
    isz = torch.empty((), dtype=dtype).element_size()
    dims = [(8, 128), (128, 8)]
    n_w = sum(i * o + o for i, o in dims)
    own = (3 + 7) * n_w + PA.ADJOINT_THREADS
    assert PA._shared_values(dims, 7, False) == own + 4 * 128
    assert PA._shared_values(dims, 7, True) == own + 7 + 4 * 128
    assert PK._route("K3", dims, PA._shared_values(dims, 7, False),
                     isz) == PK.ROUTE_NARROW
    cnf_dims = [(3, 32), (32, 32), (32, 2)]
    n_c = sum(i * o + o for i, o in cnf_dims)
    assert PA._shared_values(cnf_dims, 7, True, cnf=True) == \
        (4 + 7) * n_c + 7 + PA.ADJOINT_THREADS + \
        PA.cnf_aug_slot_values(cnf_dims)
