"""PyTorch port: MLPs past 128-wide layers, against the JAX package.

- `fast.solve_mlp_spec` at 'highest' on a D = 32 -> H = 144 -> 144 -> 32
  tanh net (every layer past the narrow route's 128), dopri5 and rk4,
  against the reference's `solve_mlp_spec(matmul='vpu')` in interpret
  mode: both sum every product in input order, so the counts are equal
  and the trajectories agree within 1e-12 in float64 and 1e-5 in float32
  (relative to their largest entry; the reference's float32 combines keep
  their own order).
- The checks every MLP kernel wrapper runs before a launch: widths up to
  MAX_WIDTH = 512 pass (a 300-wide net takes the wide route in all six:
  K2, K3, K5, K6, K8 and K9), 513 raises; the narrow main path keeps its
  route, and an input's length never changes a route.
- `fast.solve_conv_ode` where not one sample fits a controller block: a
  warning, then the generic engine over the whole batch, as the reference
  does (tfdiffeq_tpu/fast.py:2357-2371), equal to that solve, and counted
  in `fast.conv_ode_fallbacks`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu_torch import convert, fast as PF, solve
from tfdiffeq_tpu_torch.ops import conv_ode as co
from tfdiffeq_tpu_torch.ops import cuda_adjoint as PA, cuda_fixed as PX
from tfdiffeq_tpu_torch.ops import cuda_kernels as PK, cuda_perlane as PL

D, H, B = 32, 144, 16
T = np.linspace(0.0, 2.0, 5)


def _wide(seed=0):
    rng = np.random.RandomState(seed)
    dims = (D, H, H, D)
    W = [(rng.randn(dims[i], dims[i + 1]) / np.sqrt(dims[i]),
          rng.randn(dims[i + 1]) * 0.05) for i in range(3)]
    return W, rng.randn(B, D) * 0.5


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


SOLVES = {"dopri5": dict(rtol=1e-6, atol=1e-6, first_step=0.01),
          "rk4": dict(num_steps=32)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", sorted(SOLVES))
def test_wide_highest_matches_reference(method, dtype):
    W, y0 = _wide()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JF.solve_mlp_spec(
        JF.MLPSpec(activation="tanh", matmul="vpu"),
        [(jnp.asarray(a, jdt), jnp.asarray(b, jdt)) for a, b in W],
        jnp.asarray(y0, jdt), jnp.asarray(T, jdt), method=method,
        interpret=True, **SOLVES[method])
    got = PF.solve_mlp_spec(
        PF.MLPSpec(activation="tanh"), convert.weights_from_jax(W,
                                                                 dtype=tdt),
        torch.tensor(y0, dtype=tdt), torch.tensor(T, dtype=tdt),
        method=method, **SOLVES[method])
    assert list(got.stats) == [int(x) for x in ref.stats]
    assert got.stats.status == 0
    assert _rel(got.ys.numpy(), ref.ys) < (1e-12 if dtype == "float64"
                                           else 1e-5)


def _narrow_share(kernel, dims, T=5, G=33, S=7):
    """Each wrapper's shared-memory values on the narrow route: (the
    network's, the inputs' grid points and output times)."""
    n_w = sum(i * o + o for i, o in dims)
    return {"K2": (n_w, 0), "K3": (PA._shared_values(dims, S, False), 0),
            "K5": (n_w, T), "K6": (n_w + PL.PERLANE_THREADS, 0),
            "K8": (n_w, G + T), "K9": (n_w + PX.FIXED_THREADS, 0)}[kernel]


def _route(kernel, dims, tiers=None, **kw):
    net, inputs = _narrow_share(kernel, dims, **kw)
    return PK._route(kernel, dims, net, 4, tiers, input_values=inputs)


@pytest.mark.parametrize("kernel", ["K2", "K3", "K5", "K6", "K8", "K9"])
def test_wrapper_checks_take_width_300_and_refuse_513(kernel):
    for width, ok in ((300, True), (512, True), (513, False)):
        W = [(torch.zeros(4, width), None), (torch.zeros(width, 4), None)]
        warr, dims = PK.pack_mlp_weights(W, torch.float32)
        if ok:
            assert PK._check_mlp(kernel, warr, dims, 4, False) == warr.numel()
            assert _route(kernel, dims) == PK.ROUTE_WIDE
        else:
            with pytest.raises(ValueError, match="MAX_WIDTH=512"):
                PK._check_mlp(kernel, warr, dims, 4, False)
    # The spiral stays on the narrow route; weights past shared memory
    # take the wide one at any width; a reduced tier takes the batch one.
    spiral = ((2, 50), (50, 2))
    assert _route(kernel, spiral) == PK.ROUTE_NARROW
    deep = ((2, 128),) + ((128, 128),) * 6 + ((128, 2),)
    assert _route(kernel, deep) == PK.ROUTE_WIDE
    assert _route(kernel, spiral, ("mixed", "highest")) == PK.ROUTE_BATCH
    with pytest.raises(ValueError, match="tiers"):
        PK._check_mlp(kernel, *PK.pack_mlp_weights(
            [(torch.zeros(2, 50), None), (torch.zeros(50, 2), None)],
            torch.float32), 2, False, ("mixed",))


@pytest.mark.parametrize("kernel", ["K5", "K8"])
def test_route_ignores_the_input_length(kernel):
    """A grid or output times that do not fit beside a narrow net's
    weights raise; they never move the net to the slower wide route. On
    the wide route they have the whole of the shared memory."""
    net = ((2, 128), (128, 128), (128, 128), (128, 2))
    n_w = _narrow_share(kernel, net)[0]
    room = PK.MAX_WEIGHT_BYTES // 4 - n_w
    assert _route(kernel, net, T=room, G=0) == PK.ROUTE_NARROW
    with pytest.raises(ValueError, match="shared memory"):
        _route(kernel, net, T=room + 1, G=0)
    wide = ((2, 300), (300, 2))
    assert _route(kernel, wide, T=room + 1, G=0) == PK.ROUTE_WIDE
    with pytest.raises(ValueError, match="shared memory"):
        _route(kernel, wide, T=PK.MAX_WEIGHT_BYTES // 4 + 1, G=0)


def test_tier_work_matches_the_kernel_layout():
    """_tier_work_bytes: 256-aligned bf16 weights padded to 16 x 16 tiles,
    then three [rows][ld] activation buffers (csrc/dot_tiers.cuh
    batch_work_bytes)."""
    dims = ((33, 144), (144, 32))
    n_w16 = 144 * 48 + 32 * 144
    assert PK._tier_work_bytes(dims, 64, 4) == \
        -(-2 * n_w16 // 256) * 256 + 3 * 64 * 144 * 4


def test_solve_conv_ode_falls_back_to_the_generic_engine():
    """At C = 64 on a 28 x 28 map with 16 output times not one sample fits
    the reference's block limit: the port warns and returns the generic
    engine's solve of the whole batch, on the caller's device."""
    rng = np.random.RandomState(2)
    C, G = 64, 32
    params = {"gn": [(1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C))
                     for _ in range(3)],
              "conv": [(rng.randn(3, 3, C + 1, C) / np.sqrt(9 * (C + 1)),
                        0.1 * rng.randn(C)) for _ in range(2)]}
    x = torch.tensor(rng.randn(2, C, 28, 28) * 0.5, dtype=torch.float32)
    t = torch.linspace(0.0, 0.5, 16)
    assert PF.conv_block_size(C, 16, 28 * 28) == 0
    before = PF.conv_ode_fallbacks
    with pytest.warns(UserWarning, match="falling back to the generic"):
        got = PF.solve_conv_ode(params, x, t, groups=G, max_num_steps=50)
    assert PF.conv_ode_fallbacks == before + 1
    spec = co.ConvODESpec(height=28, width=28, channels=C, groups=G)
    with torch.no_grad():
        ref = solve(co.make_conv_ode_f(params, spec), x, t, rtol=1e-3,
                    atol=1e-3, options={"max_num_steps": 50})
    assert got.ys.shape == (16, 2, C, 28, 28)
    assert got.ys.device == x.device and got.stats.status == 0
    assert torch.equal(got.ys, ref.ys)
    assert list(got.stats) == list(ref.stats)
