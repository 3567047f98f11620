"""PyTorch port: K13 with each controller block spread over several CTAs,
what the CPU can hold.

K13 (the whole conv-ODE solve of the ODE-Net block) runs as one
cooperative grid of at most one CTA per SM; `cuda_conv.conv_grid` gives
the controller blocks (the reference's partition, 18 samples at C = 64,
7x7) CTAs in proportion to their samples, and each CTA owns whole samples
of one controller block. The CTAs of a controller block meet once an
attempt and add their shares of the error sum in CTA order; the plain
version takes the same order (`adaptive_solve_plain` with n_blocks the
block's CTAs and a sample's C H W elements as the unit). Held here, with
no card:

- the partition at B in {1, 5, 20, 36, 128, 256, 300} and 132 SMs (and
  beyond 132 controller blocks): every sample owned by exactly one CTA,
  every CTA inside one controller block, every controller block at least
  one CTA, at most 132 CTAs a launch;
- `conv_solve_plain` at that partition against the reference
  (`tfdiffeq_tpu.fast.solve_conv_ode`, whose kernel is
  `pallas_conv.conv_solve`, in interpret mode, each controller block from
  the same first step): identical per-block stats, ys within atol 5e-4 /
  rtol 1e-3 (tests/test_torch_conv_ode.py::test_fused_solve_matches_jax's
  bar: the reference contracts the conv on the MXU and sums its error norm
  in its own order);
- `conv_solve_plain` at one CTA a controller block (the CPU's default)
  bitwise equal to float64 fingerprints taken from the tree before the
  change, and at another grid equal to them in its stats and to 1e-12.
"""

import hashlib

import numpy as np
import pytest
import torch

from tfdiffeq_tpu.fast import solve_conv_ode as jax_solve_conv_ode
from tfdiffeq_tpu_torch import fast
from tfdiffeq_tpu_torch.ops import conv_ode as co, cuda_conv as cc
from tfdiffeq_tpu_torch.ops.conv_ode import ConvODESpec

from test_torch_conv_ode import _nchw, _nhwc, _setup, _small_blocks

F64 = torch.float64


# ---------------------------------------------------------------------------
# The partition
# ---------------------------------------------------------------------------

def _check_partition(B, block, sms):
    launches = cc.conv_grid(B, block, sms)
    owner = []
    blocks = []
    for launch in launches:
        assert 1 <= sum(c for _, _, c in launch) <= sms
        assert len(launch) <= sms
        for first, n, c in launch:
            assert 1 <= c <= n
            blocks.append((first, n))
            for k in range(c):
                lo, hi = first + k * n // c, first + (k + 1) * n // c
                # A CTA owns whole samples of its own controller block.
                assert first <= lo < hi <= first + n
                owner += list(range(lo, hi))
    assert owner == list(range(B))        # each sample exactly once
    assert blocks == [(b, min(block, B - b)) for b in range(0, B, block)]
    return launches


@pytest.mark.parametrize("B", [1, 5, 20, 36, 128, 256, 300])
def test_partition_at_the_odenet_block(B):
    """18-sample controller blocks (C = 64, 7x7, two times) on 132 SMs."""
    assert fast.conv_block_size(64, 2, 49) == 18
    launches = _check_partition(B, 18, 132)
    assert len(launches) == 1
    ctas = [c for _, _, c in launches[0]]
    assert cc.conv_ctas(B, 18, "cpu", 132) == ctas
    if B == 128:
        # Far more than one SM a controller block: one sample a CTA.
        assert ctas == [18] * 7 + [2]
    if B == 256:
        assert ctas == [9] * 14 + [2]


@pytest.mark.parametrize("B,block,sms", [(2377, 18, 132), (5000, 18, 132),
                                         (9, 2, 3), (17, 4, 5), (7, 7, 1)])
def test_partition_beyond_the_card(B, block, sms):
    """More controller blocks than SMs: a launch each SMs' worth, every
    launch within the card; the CPU's default is one CTA a block."""
    launches = _check_partition(B, block, sms)
    assert len(launches) == -(-(-(-B // block)) // sms)
    assert cc.conv_ctas(B, block, "cpu") == [1] * -(-B // block)


def test_partition_refusals():
    for bad in ((0, 18, 132), (5, 0, 132), (5, 18, 0)):
        with pytest.raises(ValueError):
            cc.conv_grid(*bad)
    for bad in (0, -2, 1.5):
        with pytest.raises(ValueError, match="n_blocks"):
            cc.conv_ctas(5, 2, "cpu", bad)


# ---------------------------------------------------------------------------
# The plain version at the grid against the reference
# ---------------------------------------------------------------------------

def _port_blocks(vs, x, t, **kw):
    """The port's plain K13 at 132 SMs' partition, each controller block
    from first step 0.05: (ys [T, B, H, W, C] NHWC, per-block stats)."""
    from tfdiffeq_tpu_torch import convert
    args, pkw, _ = fast.conv_solve_inputs(convert.odenet_from_flax(vs),
                                          _nchw(x), t, groups=8,
                                          first_step=0.05, **kw)
    assert len(cc.conv_ctas(x.shape[0], pkw["block_size"], "cpu", 132)) \
        == args[4].shape[0]
    out, st = cc.conv_solve_plain(*args, **pkw, max_ctas=132)
    return _nhwc(out), st.tolist(), pkw["block_size"]


@pytest.mark.parametrize("t", [[0.0, 0.5, 1.0], [1.0, 0.4, 0.0]])
def test_grid_plain_matches_reference_one_block(t):
    """B = 3 in one controller block on three CTAs (a sample each): the
    reference's whole solve of the block from the same first step."""
    _, vs, x = _setup()
    kw = dict(rtol=1e-4, atol=1e-4)
    ys, st, block = _port_blocks(vs, x, t, **kw)
    assert block == 3 and cc.conv_ctas(3, block, "cpu", 132) == [3]
    ref = jax_solve_conv_ode(vs, x, np.asarray(t, np.float32), groups=8,
                             interpret=True, first_step=0.05, **kw)
    # The reference's stats count the given first step's one evaluation.
    assert st == [[int(ref.stats[0]) - 1] + [int(s) for s in ref.stats[1:]]]
    assert st[0][3] == 0
    np.testing.assert_allclose(ys, np.asarray(ref.ys), atol=5e-4, rtol=1e-3)


def test_grid_plain_matches_reference_per_block(monkeypatch):
    """B = 4 in controller blocks of 2 (the reference's budget shrunk as in
    tests/test_conv_ode.py), each on two CTAs: each block's stats and ys
    equal the reference's solve of that block's samples from the same
    first step."""
    _, vs, x = _setup(B=4, seed=3)
    t = [0.0, 1.0]
    kw = dict(rtol=1e-4, atol=1e-4)
    _small_blocks(monkeypatch)
    ys, st, block = _port_blocks(vs, x, t, **kw)
    assert block == 2 and cc.conv_ctas(4, 2, "cpu", 132) == [2, 2]
    for k, b in enumerate((0, 2)):
        ref = jax_solve_conv_ode(vs, x[b:b + 2], np.asarray(t, np.float32),
                                 groups=8, interpret=True, first_step=0.05,
                                 **kw)
        assert st[k] == [int(ref.stats[0]) - 1] + \
            [int(s) for s in ref.stats[1:]]
        np.testing.assert_allclose(ys[:, b:b + 2], np.asarray(ref.ys),
                                   atol=5e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# One CTA a controller block: the bits from before the grid
# ---------------------------------------------------------------------------

def _digest(t):
    return hashlib.sha256(t.detach().numpy().tobytes()).hexdigest()[:16]


#: sha256 prefix of the output and the per-block stats of the plain K13
#: before the change (one thread block a controller block), float64.
FINGERPRINTS = {
    (5, 2): ("233bc308e9c16c66", [[30, 5, 0, 0]] * 3),
    (7, 3): ("44e717a2df87e668", [[30, 5, 0, 0]] * 3),
}


def _fp_case(B, block):
    """tests/test_torch_gpu.py's conv case at C = 16 in float64: forward
    time for B = 5, reverse for B = 7, first steps 0.05."""
    rng = np.random.RandomState(11)
    C = 16
    params = {"gn": [(1.0 + 0.1 * rng.randn(C), 0.1 * rng.randn(C))
                     for _ in range(3)],
              "conv": [(rng.randn(3, 3, C + 1, C) / np.sqrt(9 * (C + 1)),
                        0.1 * rng.randn(C)) for _ in range(2)]}
    x = torch.tensor(rng.randn(B, C, 7, 7) * 0.5, dtype=F64)
    spec = ConvODESpec(channels=C, groups=8)
    t = [0.0, 0.5, 1.0] if B == 5 else [1.0, 0.4, 0.0]
    sign = 1.0 if t[-1] >= t[0] else -1.0
    tau = sign * torch.tensor(t, dtype=F64)
    f0 = sign * co.conv_ode_apply(params, sign * tau[0], x, spec)
    dt0 = torch.full((-(-B // block),), 0.05, dtype=F64)
    wpack = cc.pack_conv_ode_weights(params, spec, F64)
    return (wpack, spec, x, tau, dt0, 1e-3, 1e-3, sign), dict(
        f0=f0.contiguous(), block_size=block)


@pytest.mark.parametrize("B,block", sorted(FINGERPRINTS))
def test_one_cta_a_block_keeps_its_bits(B, block):
    """The plain K13 at one CTA a controller block (the CPU's default, and
    the same asked for by max_ctas) is bitwise its result before the
    grid; at 132 SMs' partition (a sample a CTA) the error sums move by
    roundoff only: the same stats, outputs within 1e-12."""
    args, kw = _fp_case(B, block)
    out, st = cc.conv_solve_plain(*args, **kw)
    assert (_digest(out), st.tolist()) == FINGERPRINTS[(B, block)]
    n_cb = -(-B // block)
    again, st1 = cc.conv_solve_plain(*args, **kw, max_ctas=n_cb)
    assert cc.conv_ctas(B, block, "cpu", n_cb) == [1] * n_cb
    assert torch.equal(again, out) and torch.equal(st1, st)
    grid, st2 = cc.conv_solve_plain(*args, **kw, max_ctas=132)
    assert max(cc.conv_ctas(B, block, "cpu", 132)) > 1
    assert torch.equal(st2, st)
    gap = float((grid - out).abs().max() / out.abs().max())
    assert gap < 1e-12
