"""PyTorch port: K5 with a group of threads a sample, what the CPU can hold.

K5 (the whole per-sample adaptive solve) walks each sample on its MLP
routes with a group of threads under the sample's own controller (16 on
the narrow route, K8's `cuda_fixed.FIXED_WIDE_GROUP` on the wide one) in
512-thread blocks: the members split the stages, the combines and the
dense-output drain a feature a member and each layer of an evaluation an
output a member, K8's walk (tests/test_torch_fixed_solve_group.py holds
it to the plain evaluation). The sample's error norm stays the plain
version's sum over its features in order: each member writes its
features' squared scaled errors to the sample's slot, then every member
adds all of them from 0 in feature order and reads every feature's y1 for
finiteness, so the members take the same decisions. So the plain version
did not change. Held here, with no card:

- a Python mirror of that sum and that scan (one value at a time in the
  working type) against `cuda_perlane._row_sums` and the plain version's
  finiteness, on errors with zeros, subnormals, huge values, infinities
  and NaNs, for ragged D, in float32 and float64: bitwise;
- the block, slot and workspace sizes the launch checks (csrc/
  lane_group.h, compiled as host C++ and called through ctypes) against
  their Python counterparts in `ops/cuda_perlane.py` (skipped without a
  host compiler);
- `mlp_solve_perlane_plain` on a narrow net (B = 33), a narrow net with a
  time column (tsit5, B = 100, reverse time) and a wide one past 128
  (B = 1) against float64 fingerprints taken from the tree before the
  change;
- the same plain version against the reference in interpret mode
  (`pallas_kernels.mlp_solve(per_sample=True)`, pack=1) with the bar of
  tests/test_torch_perlane.py: identical per-sample counts and stats,
  float64 within 1e-12 relative to the largest entry. The tsit5 case's
  100 samples take 2e-12: XLA's and PyTorch's float64 tanh differ in the
  last bit on about half of all inputs, and over its attempts the largest
  of its samples' gaps reaches 1.2e-12 (the existing bar holds 16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu.ops import pallas_kernels as JK
from tfdiffeq_tpu_torch.ops import cuda_fixed as PFX, cuda_kernels as PK, \
    cuda_perlane as PL

from test_torch_fixed_solve_group import NETS, _digest, build_shim

F64, F32 = torch.float64, torch.float32


# ---------------------------------------------------------------------------
# The error norm, mirrored
# ---------------------------------------------------------------------------

def norm_mirror(sq: np.ndarray, y1: np.ndarray):
    """Every member's sum of one sample's squared scaled errors sq [D]
    (the slot's E row) from 0 in feature order, one value at a time in
    sq's dtype, and its scan of the sample's y1 [D] for a non-finite
    value."""
    ss = sq.dtype.type(0)
    bad = False
    for d in range(sq.shape[0]):
        ss = ss + sq[d]
        bad = bad or not np.isfinite(y1[d])
    return ss, bad


@pytest.mark.parametrize("D", [1, 2, 3, 17, 128])
def test_error_norm_mirror_is_the_plain_versions(D):
    """The members' sum and scan, written out, give bitwise `_row_sums`
    (the plain version's error sum) and its finiteness, sample by sample,
    in float32 and float64."""
    rng = np.random.RandomState(D)
    B = 40
    for tdt, ndt in ((F64, np.float64), (F32, np.float32)):
        info = np.finfo(ndt)
        esc = rng.randn(B, D) * 10.0 ** rng.randint(-20, 20, (B, D))
        esc = esc.astype(ndt)
        esc[0] = 0.0
        esc[1, 0] = info.tiny / 4           # a subnormal square's root
        esc[2] = np.sqrt(info.max) * 2      # squares that overflow
        esc[3, -1] = np.nan
        esc[4, 0] = -np.inf
        with np.errstate(over="ignore"):
            sq = esc * esc
        y1 = rng.randn(B, D).astype(ndt)
        y1[5, -1] = np.inf
        y1[6, 0] = np.nan
        want = PL._row_sums(torch.tensor(sq, dtype=tdt)).numpy()
        finite = torch.isfinite(torch.tensor(y1)).all(dim=1).numpy()
        for b in range(B):
            with np.errstate(over="ignore", invalid="ignore"):
                ss, bad = norm_mirror(sq[b], y1[b])
            assert ss.dtype == ndt
            assert np.array_equal(ss, want[b], equal_nan=True)
            assert bad == (not finite[b])


# ---------------------------------------------------------------------------
# The block and the workspace: csrc/lane_group.h against ops/cuda_perlane.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solve_group(tmp_path_factory):
    return build_shim(tmp_path_factory)


@pytest.mark.parametrize("dims", NETS)
def test_block_and_work_size_match_the_launch(solve_group, dims):
    """K5's block, samples a block, slot and workspace (what the wrapper
    allocates) equal csrc/lane_group.h's (what the launch checks), on both
    MLP routes, for ragged B; K5 takes K8's groups; K6's constants keep
    their meaning."""
    D = dims[-1][1]
    gw = max(w for dd in dims for w in dd)
    n_w = sum(i * o + o for i, o in dims)
    assert solve_group.block() == PL.PERLANE_SOLVE_THREADS == 512
    assert PL.perlane_group(PK.ROUTE_NARROW) == PL.PERLANE_GROUP == 16
    assert PL.perlane_group(PK.ROUTE_WIDE) == PFX.FIXED_WIDE_GROUP
    assert PL.PERLANE_ADJOINT_THREADS == 16 * PL.PERLANE_THREADS == 512
    for route in (PK.ROUTE_NARROW, PK.ROUTE_WIDE):
        group = PL.perlane_group(route)
        assert solve_group.group_ok(group)
        assert solve_group.samples(group) * group == PL.PERLANE_SOLVE_THREADS
        for S in (3, 6, 7, 13):
            slot = PL._perlane_slot_values(S, D, dims)
            assert solve_group.perlane_slot(S, D, gw) == slot
            for B in (1, 33, 100, 4096, 4097):
                n_wt = PFX._wt_values(route, n_w)
                assert solve_group.work_size(slot, B, group, n_wt) == \
                    PFX._solve_work_size(slot, B, group, n_wt)
    # The spiral's 32 dopri5 slots take about 16 KB of shared memory in
    # float32.
    if dims == NETS[0]:
        assert 32 * 4 * PL._perlane_slot_values(7, 2, dims) < 17 * 1024


# ---------------------------------------------------------------------------
# The plain version: fingerprints and the reference
# ---------------------------------------------------------------------------

# name: (dims, input_power, time_input, method, B, sign, rtol, atol, the
#        bar against the reference)
K5_CASES = {
    "narrow": ((2, 16, 2), 3, False, "dopri5", 33, 1.0, 1e-6, 1e-8, 1e-12),
    "narrow_time": ((3, 12, 2), 1, True, "tsit5", 100, -1.0, 1e-7, 1e-9,
                    2e-12),
    "wide": ((2, 160, 2), 1, False, "dopri5", 1, 1.0, 1e-6, 1e-8, 1e-12),
}

#: sha256 prefixes of the output and the stats and per-sample counts of
#: the plain K5 before the change, float64.
FINGERPRINTS = {
    "narrow": "175a65ce73427982",
    "narrow_time": "897dea0dd89cc0a8",
    "wide": "b2de551b4b87ac66",
}


def _k5_case(name):
    dims, power, ti, method, B, sign, rtol, atol, _ = K5_CASES[name]
    rng = np.random.RandomState(41)
    W = [(rng.randn(a, b) * 0.3 / np.sqrt(a / 2), rng.randn(b) * 0.05)
         for a, b in zip(dims[:-1], dims[1:])]
    rng = np.random.RandomState(42)
    y0 = rng.randn(B, dims[-1]) * np.linspace(0.2, 2.0, B)[:, None]
    t = np.linspace(0.0, 2.0, 7)
    tau = t if sign > 0 else (-t)[::-1].copy()
    dt0 = np.linspace(0.01, 0.08, B)
    kw = dict(activation="tanh", input_power=power, time_input=ti,
              method=method)
    return W, y0, tau, dt0, rtol, atol, sign, kw


def _plain(name):
    W, y0, tau, dt0, rtol, atol, sign, kw = _k5_case(name)
    pw, pd = PK.pack_mlp_weights([(torch.tensor(a), torch.tensor(b))
                                  for a, b in W], F64)
    return PL.mlp_solve_perlane(pw, pd, torch.tensor(y0), torch.tensor(tau),
                                torch.tensor(dt0), rtol, atol, sign, **kw)


@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_plain_version_keeps_its_bits(name):
    """The plain K5 (the wrapper on CPU tensors) gives bitwise its results
    before the kernel took a group of threads a sample."""
    out, st, lane = _plain(name)
    assert _digest(out, st, lane) == FINGERPRINTS[name]
    assert st[3].item() == 0 and (lane[3] == 0).all()


@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_plain_version_matches_reference(name):
    """The plain K5 against the reference's `mlp_solve(per_sample=True)`
    in interpret mode with pack=1: identical per-sample counts and stats,
    float64 within the case's bar relative to the largest entry."""
    W, y0, tau, dt0, rtol, atol, sign, kw = _k5_case(name)
    B = y0.shape[0]
    jw, jd = JK.pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                                 for a, b in W], jnp.float64)
    jo, js, jl = JK.mlp_solve(jw, jd, jnp.asarray(y0.T), jnp.asarray(tau),
                              jnp.asarray(dt0), rtol, atol, sign,
                              per_sample=True, interpret=True, pack=1, **kw)
    out, st, lane = _plain(name)
    np.testing.assert_array_equal(lane.numpy(), np.asarray(jl)[:, :B])
    assert st.tolist() == [int(x) for x in js]
    ref = np.asarray(jo).transpose(0, 2, 1)[:, :B]
    assert float(np.max(np.abs(out.numpy() - ref))
                 / np.max(np.abs(ref))) < K5_CASES[name][-1]
