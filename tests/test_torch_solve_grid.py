"""PyTorch port: the plain versions of K2 and K11 on their grids.

K2 (the whole adaptive solve) and K11 (the whole VCABM solve) run on a
cooperative grid of `n_blocks` blocks, block k owning the samples
[k B / n, (k + 1) B / n) (on K2's batch route whole 16-row tiles), under one
step controller: the only thing the grid changes is the order of the batch
sums the controller reads (each block's threads' in-order sums, the
block's fixed tree, then the blocks' shares in block order). Their plain
versions repeat that order for any n_blocks, one block on the CPU by
default. Held here, with no card:

- the block-order sum (`cuda_kernels._grid_sum` over `_block_index`)
  against an explicit Python loop of the kernel's order, in float64 and
  float32, for ragged ranges (B in {1, 7, 200, 4096}, n_blocks in {1, 2,
  3, 132} capped at B) and for the batch route's tile units: bitwise;
- `mlp_solve_plain` (the narrow route and the batch route at 'mixed') and
  `mlp_solve_vcabm_plain` at n_blocks = 1 and by default: bitwise the
  results before the grid (float64 fingerprints of small problems, taken
  from the tree before the change);
- at n_blocks in {2, 5, 132}, float64, B = 200 over a span of 5, each plain
  version against the JAX reference in interpret mode: K2's MLP route
  against `pallas_kernels.mlp_solve` and the plan route (through
  `fast.solve_fused`) against the reference's `solve_fused`, identical
  stats and ys within 1e-10 (another summation order of the error sum
  moves its last bits only: both take the same steps, and the solution
  differs by the networks' own last-bit roundoff grown over some 20
  steps); K11's MLP and plan routes against `pallas_vcabm.mlp_solve_vcabm`
  and the reference's `solve_fused(method='adams')`, with the first step
  pinned, identical stats and the same orders, ys within 1e-9 (VCABM's
  divided differences amplify the last-bit roundoff of each evaluation
  more than an RK step does);
- a coupled plan on K2 asked for more than one block raises ValueError
  before any launch, as K3 does.
"""

import functools
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.ops import pallas_kernels as JK, pallas_vcabm as JPV
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_adams as PA, cuda_kernels as PK, \
    cuda_plan as CP

F64, F32 = torch.float64, torch.float32


# ---------------------------------------------------------------------------
# The block-order sum against the kernel's order written out
# ---------------------------------------------------------------------------

def _kernel_order_sum(sq: np.ndarray, n_blocks: int, threads: int,
                      unit: int = 1):
    """The kernels' error sum of sq [B, C], one value at a time in sq's
    dtype: block k owns [e_k, e_k+1), e_k = min(B, unit (k U // n)); its
    thread i adds the C values of samples e_k + i, e_k + i + threads, ...
    in order from 0; the block's `block_sum` tree red[i] += red[i + s] for
    s = threads / 2, ..., 1; the shares added in block order."""
    B = sq.shape[0]
    units = -(-B // unit)
    e = [min(B, unit * (k * units // n_blocks)) for k in range(n_blocks + 1)]
    zero = sq.dtype.type(0)
    shares = []
    for k in range(n_blocks):
        red = [zero] * threads
        for i in range(threads):
            acc = zero
            for b in range(e[k] + i, e[k + 1], threads):
                for c in range(sq.shape[1]):
                    acc = acc + sq[b, c]
            red[i] = acc
        s = threads // 2
        while s:
            for i in range(s):
                red[i] = red[i] + red[i + s]
            s //= 2
        shares.append(red[0])
    total = shares[0]
    for v in shares[1:]:
        total = total + v
    return total


@pytest.mark.parametrize("n_blocks", [1, 2, 3, 132])
@pytest.mark.parametrize("B", [1, 7, 200, 4096])
def test_grid_sum_is_the_kernels_order(B, n_blocks):
    """`_grid_sum` bitwise the kernel's order written out, in float64 and
    float32, for ranges of unequal length (n_blocks capped at B)."""
    n_blocks = min(n_blocks, B)
    rng = np.random.RandomState(B + n_blocks)
    for dtype, tdt in ((np.float64, F64), (np.float32, F32)):
        sq = (rng.randn(B, 2) ** 2 * 10.0 ** rng.randint(-6, 6, (B, 1))
              ).astype(dtype)
        owned = PK._block_index(B, n_blocks, PK.SOLVE_THREADS, "cpu")
        got = PK._grid_sum(torch.tensor(sq, dtype=tdt), owned)
        want = _kernel_order_sum(sq, n_blocks, PK.SOLVE_THREADS)
        assert got.dtype == tdt and got.item() == float(want)
        if n_blocks == 1:
            # The one-block order before the grid, to the bit.
            old = PK._tree_sum(PK._owned_sums(torch.tensor(sq, dtype=tdt),
                                              PK.SOLVE_THREADS))
            assert torch.equal(got, old)


@pytest.mark.parametrize("B,n_blocks", [(200, 5), (200, 13), (1024, 64),
                                        (37, 2)])
def test_grid_sum_in_tile_units(B, n_blocks):
    """K2's batch route: a block owns whole 16-row tiles (the last padded),
    its samples the tiles' rows below B."""
    e = PK._block_bounds(B, n_blocks, PK.TILE_ROWS)
    assert e[0] == 0 and e[-1] == B
    assert all(x % PK.TILE_ROWS == 0 for x in e[:-1])
    sq = np.random.RandomState(B).randn(B, 3) ** 2
    owned = PK._block_index(B, n_blocks, PK.SOLVE_THREADS, "cpu",
                            PK.TILE_ROWS)
    got = PK._grid_sum(torch.tensor(sq), owned)
    assert got.item() == _kernel_order_sum(sq, n_blocks, PK.SOLVE_THREADS,
                                           PK.TILE_ROWS)


def test_solve_blocks_on_the_cpu_is_one():
    assert PK.solve_blocks(4096, "cpu") == 1
    assert PK.solve_blocks(4096, "cpu", PK.TILE_ROWS) == 1


# ---------------------------------------------------------------------------
# n_blocks = 1 keeps the one-block bits
# ---------------------------------------------------------------------------

def _mlp(width=16, seed=3, B=200):
    """A 2 -> width -> 2 tanh MLP on y^3 and B states, float64."""
    rng = np.random.RandomState(seed)
    dims = [(2, width), (width, 2)]
    W = [(torch.tensor(rng.randn(i, o) * 0.5 / np.sqrt(i)),
          torch.tensor(rng.randn(o) * 0.05)) for i, o in dims]
    warr, pd = PK.pack_mlp_weights(W, F64)
    return W, warr, pd, torch.tensor(rng.randn(B, 2))


def _digest(out, st):
    h = hashlib.sha256(out.numpy().tobytes())
    h.update(str(st.tolist()).encode())
    return h.hexdigest()[:16]


#: sha256 prefixes of (out, stats) from the plain versions before the grid.
FINGERPRINTS = {"k2": ("80425c72417d8e68", [144, 20, 4, 0]),
                "k2_mixed": ("e7bdcfe999a1fc5e", [30, 5, 0, 0]),
                "k11": ("83f3e91d483eed28", [175, 84, 7, 0])}


def _fingerprint_runs(n_blocks):
    _, warr, pd, y0 = _mlp()
    t = torch.linspace(0.0, 5.0, 6, dtype=F64)
    kw = dict(activation="tanh", input_power=3)
    f0 = PA._f0(warr, pd, y0, t[0], 1.0, "tanh", "identity", 3, False)
    runs = {"k2": PK.mlp_solve_plain(warr, pd, y0, t, 0.05, 1e-6, 1e-8, 1.0,
                                     f0=f0, n_blocks=n_blocks, **kw),
            "k11": PA.mlp_solve_vcabm_plain(warr, pd, y0, t, 0.02, 1e-6,
                                            1e-8, 1.0, f0=f0,
                                            n_blocks=n_blocks, **kw)}
    rng = np.random.RandomState(5)
    W = [(torch.tensor(rng.randn(i, o) / np.sqrt(i)),
          torch.tensor(rng.randn(o) * 0.05)) for i, o in ((32, 64), (64, 32))]
    warr, pd = PK.pack_mlp_weights(W, F64)
    y = torch.tensor(rng.randn(200, 32) * 0.5)
    t = torch.linspace(0.0, 1.0, 3, dtype=F64)
    f0 = PK._net_plain(warr, pd, "tanh", "identity", 1, False)(t[0], y)
    runs["k2_mixed"] = PK.mlp_solve_plain(
        warr, pd, y, t, 0.05, 1e-5, 1e-7, 1.0, f0=f0, n_blocks=n_blocks,
        tiers=PK.layer_tiers(pd, "auto", "mixed"))
    return runs


@pytest.mark.parametrize("n_blocks", [1, None])
def test_one_block_keeps_the_old_bits(n_blocks):
    """At n_blocks = 1 (and by default on the CPU) K2's plain version on
    the narrow and batch routes and K11's give bitwise the results of the
    one-block plain versions before the grid."""
    for name, (out, st) in _fingerprint_runs(n_blocks).items():
        assert (_digest(out, st), st.tolist()) == FINGERPRINTS[name], name


# ---------------------------------------------------------------------------
# Grids against the JAX reference, float64
# ---------------------------------------------------------------------------

GRIDS = [2, 5, 132]
_T = np.linspace(0.0, 5.0, 6)


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """The JAX reference's (ys [T, B, D], stats) of each problem, in
    interpret mode (computed once)."""
    W, _, _, y0 = _mlp()
    jw, jd = JK.pad_mlp_weights([(jnp.asarray(a.numpy()),
                                  jnp.asarray(b.numpy())) for a, b in W],
                                jnp.float64)
    y0 = y0.numpy()
    kw = dict(activation="tanh", input_power=3)
    if kind == "k2":
        f0 = PA._f0(*_mlp()[1:3], torch.tensor(y0), 0.0, 1.0, "tanh",
                    "identity", 3, False).numpy()
        out, st = JK.mlp_solve(jw, jd, jnp.asarray(y0.T), jnp.asarray(_T),
                               0.05, 1e-6, 1e-8, 1.0, f0=jnp.asarray(f0.T),
                               interpret=True, pack=1, **kw)
        return np.asarray(out).transpose(0, 2, 1), [int(x) for x in st]
    if kind == "k11":
        out, st = JPV.mlp_solve_vcabm(jw, jd, jnp.asarray(y0.T),
                                      jnp.asarray(_T), 0.02, 1e-6, 1e-8,
                                      jnp.asarray(1.0), interpret=True,
                                      pack=1, **kw)
        return np.asarray(out).transpose(0, 2, 1), [int(x) for x in st]
    method = {"plan_k2": "dopri5", "plan_k11": "adams"}[kind]
    jW = [(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())) for a, b in W]
    r = JF.solve_fused(lambda t, y: jnp.tanh((y ** 3) @ jW[0][0] + jW[0][1])
                       @ jW[1][0] + jW[1][1], jnp.asarray(y0),
                       jnp.asarray(_T), method=method, interpret=True,
                       rtol=1e-6, atol=1e-8, first_step=0.02)
    return np.asarray(r.ys), [int(x) for x in r.stats]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("n_blocks", GRIDS)
def test_k2_grid_matches_reference(n_blocks):
    """K2's MLP route at n_blocks against the reference's `mlp_solve`:
    identical stats, ys within 1e-10."""
    _, warr, pd, y0 = _mlp()
    t = torch.tensor(_T)
    f0 = PA._f0(warr, pd, y0, t[0], 1.0, "tanh", "identity", 3, False)
    out, st = PK.mlp_solve(warr, pd, y0, t, 0.05, 1e-6, 1e-8, 1.0, f0=f0,
                           activation="tanh", input_power=3,
                           n_blocks=n_blocks)
    ref, rst = _reference("k2")
    assert st.tolist() == rst and st[3].item() == 0
    assert _rel(out.numpy(), ref) < 1e-10


@pytest.mark.parametrize("n_blocks", GRIDS)
def test_k11_grid_matches_reference(n_blocks):
    """K11's MLP route at n_blocks, first step pinned at 0.02, against the
    reference's `mlp_solve_vcabm`: identical stats, ys within 1e-9, and
    the order sequence of the one-block plain version."""
    _, warr, pd, y0 = _mlp()
    t = torch.tensor(_T)
    out, st = PA.mlp_solve_vcabm(warr, pd, y0, t, 0.02, 1e-6, 1e-8, 1.0,
                                 activation="tanh", input_power=3,
                                 n_blocks=n_blocks)
    ref, rst = _reference("k11")
    assert st.tolist() == rst and st[3].item() == 0
    assert _rel(out.numpy(), ref) < 1e-9
    # The grid changes no decision: the same orders as one block.
    assert _orders(n_blocks) == _orders(1)


def _orders(n_blocks):
    """The (order, accepted) sequence of K11's plain version at n_blocks,
    read off its step-size calls (`_vcabm_dt`)."""
    _, warr, pd, y0 = _mlp()
    seen = []
    orig = PA._vcabm_dt

    def spy(dt, ratio, order, accepted, *a):
        seen.append((order, accepted))
        return orig(dt, ratio, order, accepted, *a)

    PA._vcabm_dt = spy
    try:
        PA.mlp_solve_vcabm(warr, pd, y0, torch.tensor(_T), 0.02, 1e-6, 1e-8,
                           1.0, activation="tanh", input_power=3,
                           n_blocks=n_blocks)
    finally:
        PA._vcabm_dt = orig
    return seen


def _fused_at(monkeypatch, n_blocks, method):
    """`fast.solve_fused` of the MLP written as plain PyTorch, its plan
    launch (K2's or K11's plain version on the CPU) at n_blocks."""
    W, _, _, y0 = _mlp()
    name = "plan_solve_vcabm" if method == "adams" else "plan_solve"
    calls = []
    orig = getattr(CP, name)

    def at_grid(*a, **k):
        calls.append(k.get("n_blocks"))
        return orig(*a, **{**k, "n_blocks": n_blocks})

    monkeypatch.setattr(CP, name, at_grid)
    r = PF.solve_fused(lambda t, y: torch.tanh((y ** 3) @ W[0][0] + W[0][1])
                       @ W[1][0] + W[1][1], y0, torch.tensor(_T),
                       method=method, rtol=1e-6, atol=1e-8, first_step=0.02)
    assert calls == [None]
    return r


@pytest.mark.parametrize("n_blocks", GRIDS)
def test_plan_k2_grid_matches_reference(monkeypatch, n_blocks):
    """K14 in K2 at n_blocks (through `fast.solve_fused`) against the
    reference's `solve_fused`: identical stats, ys within 1e-10."""
    r = _fused_at(monkeypatch, n_blocks, "dopri5")
    ref, rst = _reference("plan_k2")
    assert [int(x) for x in r.stats] == rst and r.stats.status == 0
    assert _rel(r.ys.numpy(), ref) < 1e-10


@pytest.mark.parametrize("n_blocks", GRIDS)
def test_plan_k11_grid_matches_reference(monkeypatch, n_blocks):
    """K14 in K11 at n_blocks (first step pinned at 0.02) against the
    reference's `solve_fused(method='adams')`: identical stats, ys within
    1e-9."""
    r = _fused_at(monkeypatch, n_blocks, "adams")
    ref, rst = _reference("plan_k11")
    assert [int(x) for x in r.stats] == rst and r.stats.status == 0
    assert _rel(r.ys.numpy(), ref) < 1e-9


def test_coupled_plan_refuses_a_grid_before_any_launch():
    """A coupled plan's K2 solve meets the block inside a stage: it runs
    on one block, and asking for more raises ValueError before the plain
    version (or a launch) is reached."""
    from tfdiffeq_tpu_torch.ops import plan_bridge as PB
    y0 = torch.tensor(np.random.RandomState(2).randn(16, 3))
    t = torch.linspace(0.0, 1.0, 3, dtype=F64)
    plan, consts = PB.build_plan(lambda tt, y: torch.tanh(y)
                                 - 0.5 * (y - y.mean(0)), t[0], y0)
    packed = PB.pack_consts(plan, consts, F64)
    assert plan.batch_coupled and CP.plan_blocks(plan, 16, "cpu") == 1
    g = CP.plan_rhs(plan, packed, torch.tensor(1.0, dtype=F64))
    f0 = g(t[0], y0)
    reached = []
    orig = CP.plan_solve_plain
    CP.plan_solve_plain = lambda *a, **k: reached.append(1)
    try:
        with pytest.raises(ValueError, match="one block"):
            CP.plan_solve(plan, packed, y0, t, 0.05, 1e-6, 1e-8, 1.0, f0,
                          n_blocks=2)
    finally:
        CP.plan_solve_plain = orig
    assert not reached
    out, st = CP.plan_solve(plan, packed, y0, t, 0.05, 1e-6, 1e-8, 1.0, f0,
                            n_blocks=1)
    assert st[3].item() == 0 and torch.isfinite(out).all()
