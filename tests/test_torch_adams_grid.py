"""PyTorch port: the plain version of fixed_adams' K10 on its grid.

fixed_adams' K10 (the whole fixed-step Adams solve with the AM corrector)
runs on a cooperative grid of `n_blocks` blocks, block k owning the
samples [k B / n, (k + 1) B / n), the batch meeting once a corrector
iteration for the convergence norm: the only thing the grid changes is the
order of that norm's sum (each block's threads' in-order sums, the block's
fixed tree, then the blocks' shares in block order). Its plain version
(`cuda_adams.adams_solve_plain`) repeats that order for any n_blocks, one
block on the CPU by default. explicit_adams has no batch sum and no grid.
Held here, with no card:

- the corrector norm's sum (`cuda_kernels._grid_sum` over `_block_index`
  with K10's 512 threads) against an explicit Python loop of the kernel's
  order, for ragged ranges (B in {1, 7, 200, 4096}, n_blocks in {1, 2, 3,
  132} capped at B), in float64 and float32: bitwise;
- `mlp_solve_adams` and `plan_solve_adams` (fixed_adams) at n_blocks = 1
  and by default: bitwise the results before the grid (float64
  fingerprints of a small problem, taken from the tree before the change);
- at n_blocks in {2, 5, 132}, float64, B = 200 over a span of 5 on a
  60-step grid, the MLP route against the reference's
  `pallas_fixed.mlp_solve_adams` and the plan route (through
  `fast.solve_fused`) against the reference's `solve_fused(method=
  'fixed_adams')`, both in interpret mode: identical stats and ys within
  1e-10. K10's stats do not depend on the norm (nfe and steps count the
  grid), and the norm's order moves only its last bits: a corrector whose
  norm sat within that of 1 would stop one iteration apart, moving y by the
  corrector's last update, far less than 1e-10 here, where the norms stay
  away from 1; what remains is the networks' own last-bit roundoff grown
  over 60 steps;
- a bad n_blocks raises ValueError before any solve.
"""

import functools
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfdiffeq_tpu import fast as JF
from tfdiffeq_tpu.ops import pallas_fixed as JPF
from tfdiffeq_tpu.ops.pallas_kernels import pad_mlp_weights
from tfdiffeq_tpu_torch import fast as PF
from tfdiffeq_tpu_torch.ops import cuda_adams as PA, cuda_kernels as PK, \
    cuda_plan as CP, plan_bridge as PB
from tfdiffeq_tpu_torch.solvers.fixed_grid import uniform_grid

F64, F32 = torch.float64, torch.float32


# ---------------------------------------------------------------------------
# The corrector norm's sum against the kernel's order written out
# ---------------------------------------------------------------------------

def _kernel_order_sum(sq: np.ndarray, n_blocks: int, threads: int):
    """K10's corrector sum of sq [B, D], one value at a time in sq's dtype:
    block k owns [e_k, e_k+1), e_k = k B // n; its thread i adds the D
    values of samples e_k + i, e_k + i + threads, ... in order from 0; the
    block's `block_sum` tree red[i] += red[i + s] for s = threads / 2,
    ..., 1; the shares added in block order (grid_shares)."""
    B = sq.shape[0]
    e = [k * B // n_blocks for k in range(n_blocks + 1)]
    zero = sq.dtype.type(0)
    shares = []
    for k in range(n_blocks):
        red = [zero] * threads
        for i in range(threads):
            acc = zero
            for b in range(e[k] + i, e[k + 1], threads):
                for d in range(sq.shape[1]):
                    acc = acc + sq[b, d]
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
def test_corrector_norm_is_the_kernels_order(B, n_blocks):
    """The sum `adams_solve_plain` takes for the corrector's norm is bitwise
    the kernel's order written out, float64 and float32, for ranges of
    unequal length (n_blocks capped at B); at one block it is the order
    before the grid."""
    n_blocks = min(n_blocks, B)
    rng = np.random.RandomState(B + 3 * n_blocks)
    for dtype, tdt in ((np.float64, F64), (np.float32, F32)):
        sq = (rng.randn(B, 2) ** 2 * 10.0 ** rng.randint(-6, 6, (B, 1))
              ).astype(dtype)
        owned = PK._block_index(B, n_blocks, PA.ADAMS_THREADS, "cpu")
        got = PK._grid_sum(torch.tensor(sq, dtype=tdt), owned)
        want = _kernel_order_sum(sq, n_blocks, PA.ADAMS_THREADS)
        assert got.dtype == tdt and got.item() == float(want)
        if n_blocks == 1:
            old = PK._tree_sum(PK._owned_sums(torch.tensor(sq, dtype=tdt),
                                              PA.ADAMS_THREADS))
            assert torch.equal(got, old)


# ---------------------------------------------------------------------------
# n_blocks = 1 keeps the one-block bits
# ---------------------------------------------------------------------------

_T = np.linspace(0.0, 5.0, 6)
_STEPS = 60


def _mlp(width=16, seed=3, B=200):
    """A 2 -> width -> 2 tanh MLP on y^3 and B states, float64."""
    rng = np.random.RandomState(seed)
    dims = [(2, width), (width, 2)]
    W = [(torch.tensor(rng.randn(i, o) * 0.5 / np.sqrt(i)),
          torch.tensor(rng.randn(o) * 0.05)) for i, o in dims]
    warr, pd = PK.pack_mlp_weights(W, F64)
    return W, warr, pd, torch.tensor(rng.randn(B, 2))


def _torch_f(W):
    return lambda t, y: (torch.tanh((y ** 3) @ W[0][0] + W[0][1]) @ W[1][0]
                         + W[1][1])


def _digest(out, st):
    h = hashlib.sha256(out.numpy().tobytes())
    h.update(str(st.tolist()).encode())
    return h.hexdigest()[:16]


#: sha256 prefixes of (out, stats) from the plain version before the grid:
#: fixed_adams at max_iters 4 and 2 on the MLP route, and the same function
#: as a plan (the same products in the same order, so the same bits).
FINGERPRINTS = {"mlp_iters4": ("3d3da8f33c8bd81e", [298, 60, 0, 0]),
                "mlp_iters2": ("129cbc84e656b51c", [184, 60, 0, 0]),
                "plan": ("3d3da8f33c8bd81e", [298, 60, 0, 0])}


def _runs(n_blocks):
    W, warr, pd, y0 = _mlp()
    t = torch.tensor(_T)
    grid = uniform_grid(t[0], t[-1], _STEPS)
    runs = {}
    for iters in (4, 2):
        runs[f"mlp_iters{iters}"] = PA.mlp_solve_adams(
            warr, pd, y0, t, grid, 1e-6, 1e-8, 1.0, activation="tanh",
            input_power=3, max_iters=iters, n_blocks=n_blocks)
    plan, consts = PB.build_plan(_torch_f(W), t[0], y0)
    packed = PB.pack_consts(plan, consts, F64)
    f0 = CP.plan_rhs(plan, packed, torch.tensor(1.0, dtype=F64))(t[0], y0)
    runs["plan"] = CP.plan_solve_adams(plan, packed, y0, t, grid, 1e-6,
                                       1e-8, 1.0, f0, n_blocks=n_blocks)
    return runs


@pytest.mark.parametrize("n_blocks", [1, None])
def test_one_block_keeps_the_old_bits(n_blocks):
    """At n_blocks = 1 (and by default on the CPU) fixed_adams' plain K10
    on the MLP and plan routes gives bitwise the results of the one-block
    plain version before the grid."""
    for name, (out, st) in _runs(n_blocks).items():
        assert (_digest(out, st), st.tolist()) == FINGERPRINTS[name], name


# ---------------------------------------------------------------------------
# Grids against the JAX reference, float64
# ---------------------------------------------------------------------------

GRIDS = [2, 5, 132]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """The JAX reference's (ys [T, B, D], stats) in interpret mode
    (computed once)."""
    W, _, _, y0 = _mlp()
    Wn = [(a.numpy(), b.numpy()) for a, b in W]
    y0 = y0.numpy()
    if kind == "mlp":
        jw, jd = pad_mlp_weights([(jnp.asarray(a), jnp.asarray(b))
                                  for a, b in Wn], jnp.float64)
        grid = np.linspace(_T[0], _T[-1], _STEPS + 1)
        out, st = JPF.mlp_solve_adams(jw, jd, jnp.asarray(y0.T),
                                      jnp.asarray(_T), jnp.asarray(grid),
                                      1e-6, 1e-8, jnp.asarray(1.0),
                                      activation="tanh", input_power=3,
                                      interpret=True, pack=1)
        return np.asarray(out).transpose(0, 2, 1), [int(x) for x in st]
    jW = [(jnp.asarray(a), jnp.asarray(b)) for a, b in Wn]
    r = JF.solve_fused(lambda t, y: jnp.tanh((y ** 3) @ jW[0][0] + jW[0][1])
                       @ jW[1][0] + jW[1][1], jnp.asarray(y0),
                       jnp.asarray(_T), method="fixed_adams", interpret=True,
                       rtol=1e-6, atol=1e-8, num_steps=_STEPS)
    return np.asarray(r.ys), [int(x) for x in r.stats]


@pytest.mark.parametrize("n_blocks", GRIDS)
def test_mlp_grid_matches_reference(n_blocks):
    """fixed_adams' K10 on the MLP route at n_blocks against the
    reference's `mlp_solve_adams`: identical stats, ys within 1e-10."""
    _, warr, pd, y0 = _mlp()
    t = torch.tensor(_T)
    out, st = PA.mlp_solve_adams(warr, pd, y0, t,
                                 uniform_grid(t[0], t[-1], _STEPS), 1e-6,
                                 1e-8, 1.0, activation="tanh", input_power=3,
                                 n_blocks=n_blocks)
    ref, rst = _reference("mlp")
    assert st.tolist() == rst and st[3].item() == 0
    assert _rel(out.numpy(), ref) < 1e-10


@pytest.mark.parametrize("n_blocks", GRIDS)
def test_plan_grid_matches_reference(monkeypatch, n_blocks):
    """K14 in fixed_adams' K10 at n_blocks (through `fast.solve_fused`,
    whose plan launch is held at the grid) against the reference's
    `solve_fused(method='fixed_adams')`: identical stats, ys within
    1e-10."""
    W, _, _, y0 = _mlp()
    calls = []
    orig = CP.plan_solve_adams

    def at_grid(*a, **k):
        calls.append(k.get("n_blocks"))
        return orig(*a, **{**k, "n_blocks": n_blocks})

    monkeypatch.setattr(CP, "plan_solve_adams", at_grid)
    r = PF.solve_fused(_torch_f(W), y0, torch.tensor(_T),
                       method="fixed_adams", rtol=1e-6, atol=1e-8,
                       num_steps=_STEPS)
    assert calls == [None]
    ref, rst = _reference("plan")
    assert [int(x) for x in r.stats] == rst and r.stats.status == 0
    assert _rel(r.ys.numpy(), ref) < 1e-10


@pytest.mark.parametrize("bad", [0, -3, 2.0, "4"])
def test_bad_n_blocks_raises_before_any_solve(monkeypatch, bad):
    """A bad n_blocks raises ValueError on the MLP and plan routes and in
    the plain engine, before any evaluation."""
    W, warr, pd, y0 = _mlp(B=8)
    t = torch.tensor(_T)
    grid = uniform_grid(t[0], t[-1], 10)

    def never(*a, **k):
        raise AssertionError("the solve ran")

    monkeypatch.setattr(PA, "hermite_drain_plain", never)
    with pytest.raises(ValueError, match="n_blocks"):
        PA.mlp_solve_adams(warr, pd, y0, t, grid, 1e-6, 1e-8, 1.0,
                           n_blocks=bad)
    with pytest.raises(ValueError, match="n_blocks"):
        PA.adams_solve_plain(lambda s, y: -y, y0, -y0, t, grid, 1e-6, 1e-8,
                             n_blocks=bad)
    plan, consts = PB.build_plan(_torch_f(W), t[0], y0)
    packed = PB.pack_consts(plan, consts, F64)
    with pytest.raises(ValueError, match="n_blocks"):
        CP.plan_solve_adams(plan, packed, y0, t, grid, 1e-6, 1e-8, 1.0, y0,
                            n_blocks=bad)
