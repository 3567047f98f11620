"""Fixed-step Adams–Bashforth (explicit) and Adams–Bashforth–Moulton
(predictor–corrector) solvers, orders 1..12: `explicit_adams` and
`fixed_adams`.

Counterpart of `tfdiffeq_tpu/solvers/fixed_adams.py`, with the same
arithmetic in the same order. The reference walks the grid with one
`lax.scan`; here the walk is an eager host loop over the grid intervals
(times on the host, the state on its device):

- the coefficient tables are generated exactly at import time by
  integrating Lagrange basis polynomials with `fractions.Fraction`, as the
  reference generates them (`BASHFORTH_TABLE`, `MOULTON_TABLE`, [12, 12]);
- the first `max_order - 1` steps are an RK4 bootstrap (`ops/rk`) that
  reuses RK4's end derivative; then the AB predictor over the live history
  `min(n + 1, max_order)` and, for `fixed_adams`, `max_iters` corrector
  iterations, each masked by the convergence of the RMS of
  (y_next - y_cur) / scale over the whole state. NFE counts every
  evaluation: 4 a bootstrap step, 1 an `explicit_adams` step,
  `max_iters + 1` a `fixed_adams` step, and f0 once;
- on the default grid (the requested times) the step ends are the outputs;
  on a finer grid (`num_steps`, `step_size`, `grid_constructor`) the
  outputs are cubic-Hermite interpolated from the node states and
  derivatives.

Like the reference, the coefficients assume a uniform grid.
"""

from __future__ import annotations

from fractions import Fraction as Fr
from typing import List

import numpy as np
import torch

from ..ops.norms import rms_norm
from ..ops.rk import runge_kutta_step
from ..ops.tableaus import RK4
from .base import CanonicalProblem, SolveResult, SolverStats, hermite_interp_at
from .fixed_grid import build_grid_from_options

MAX_ORDER = 12


def _poly_mul(p: List[Fr], q: List[Fr]) -> List[Fr]:
    out = [Fr(0)] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            out[i + j] += a * b
    return out


def _lagrange_integral_01(nodes: List[Fr], j: int) -> Fr:
    """Integral over [0, 1] of the Lagrange basis polynomial L_j(s) through
    the given nodes."""
    num = [Fr(1)]
    denom = Fr(1)
    for i, xi in enumerate(nodes):
        if i == j:
            continue
        num = _poly_mul(num, [-xi, Fr(1)])  # (s - xi)
        denom *= (nodes[j] - xi)
    integral = sum(c / (p + 1) for p, c in enumerate(num))
    return integral / denom


def _bashforth_row(k: int) -> List[Fr]:
    """AB-k weights: y_{n+1} = y_n + h * sum_j beta_j f_{n-j}."""
    nodes = [Fr(-i) for i in range(k)]
    return [_lagrange_integral_01(nodes, j) for j in range(k)]


def _moulton_row(k: int) -> List[Fr]:
    """AM-k weights: y_{n+1} = y_n + h (g_0 f_{n+1} + sum_{m>=1} g_m
    f_{n+1-m})."""
    nodes = [Fr(1 - m) for m in range(k)]
    return [_lagrange_integral_01(nodes, m) for m in range(k)]


def _build_table(row_fn) -> np.ndarray:
    table = np.zeros((MAX_ORDER, MAX_ORDER), dtype=np.float64)
    for k in range(1, MAX_ORDER + 1):
        table[k - 1, :k] = [float(x) for x in row_fn(k)]
    return table


BASHFORTH_TABLE = _build_table(_bashforth_row)   # [12, 12]
MOULTON_TABLE = _build_table(_moulton_row)       # [12, 12]


def check_max_order(max_order) -> int:
    max_order = int(max_order)
    if not 1 <= max_order <= MAX_ORDER:
        raise ValueError(f"max_order must be in [1, {MAX_ORDER}]")
    return max_order


def solve_fixed_adams(prob: CanonicalProblem, options: dict, rtol, atol, *,
                      implicit: bool) -> SolveResult:
    y0, tau = prob.y0, prob.tau
    dtype, dev = prob.dtype, y0.device
    T = tau.shape[0]
    max_order = check_max_order(options.get("max_order", 4))
    max_iters = int(options.get("max_iters", 4)) if implicit else 0

    grid = build_grid_from_options(prob.sign * tau, options, prob)
    grid_is_t = grid is None
    grid = tau if grid_is_t else grid
    G = grid.shape[0]
    if G < 2:
        return SolveResult(y0[None].expand((T,) + tuple(y0.shape)).clone(),
                           SolverStats(0, 0, 0, 0))

    rdt = torch.empty((), dtype=dtype).real.dtype
    ab = torch.tensor(BASHFORTH_TABLE[:max_order, :max_order], dtype=dtype,
                      device=dev)
    am = torch.tensor(MOULTON_TABLE[:max_order, :max_order], dtype=dtype,
                      device=dev)
    rtol = torch.as_tensor(rtol, dtype=rdt).to(dev)
    atol = torch.as_tensor(atol, dtype=rdt).to(dev)
    func = prob.func

    f0 = func(grid[0], y0)
    # hist[j] = f_{current - j}, zero where the history is not filled yet.
    hist = torch.zeros((max_order,) + tuple(y0.shape), dtype=dtype,
                       device=dev)
    hist[0] = f0
    # Startup: the first max_order - 1 steps are RK4 (O(h^5) local) instead
    # of the reference lineage's order ramp, as in the JAX package.
    bootstrap = max_order - 1
    y, nfe = y0, 1
    ys, fs = [y0], [f0]
    for n in range(G - 1):
        t0, t1 = grid[n], grid[n + 1]
        dt = t1 - t0
        dt_y = dt.to(dtype).to(dev)
        if n < bootstrap:
            # RK4 is not FSAL: its step already evaluated f(t1, y1).
            res = runge_kutta_step(func, y, hist[0], t0, dt, RK4)
            y1, f1, n_evals = res.y1, res.f1, res.n_evals
        else:
            k_eff = min(n + 1, max_order)        # usable history length
            y_pred = y + dt_y * torch.tensordot(ab[k_eff - 1], hist, dims=1)
            if not implicit:
                y1, f1, n_evals = y_pred, func(t1, y_pred), 1
            else:
                gamma = am[k_eff - 1]
                # Corrector history part: g_1 f_n + g_2 f_{n-1} + ...
                base = y + dt_y * torch.tensordot(gamma[1:], hist[:-1],
                                                  dims=1)
                y_cur, done = y_pred, False
                for _ in range(max_iters):
                    f_new = func(t1, y_cur)
                    y_next = base + dt_y * gamma[0] * f_new
                    scale = atol + rtol * torch.maximum(torch.abs(y_cur),
                                                        torch.abs(y_next))
                    delta = rms_norm((y_next - y_cur) / scale)
                    # A converged state stops updating.
                    y_cur = y_cur if done else y_next
                    done = done or bool(delta <= 1.0)
                y1, f1, n_evals = y_cur, func(t1, y_cur), max_iters + 1
        hist = torch.cat([f1[None], hist[:-1]])
        y, nfe = y1, nfe + n_evals
        ys.append(y1)
        fs.append(f1)

    if grid_is_t:
        out = torch.stack(ys)
    else:
        out = hermite_interp_at(grid, torch.stack(ys), torch.stack(fs), tau)
        out[0] = y0
    return SolveResult(out, SolverStats(nfe, G - 1, 0, 0))


def _explicit(prob, options, rtol, atol):
    return solve_fixed_adams(prob, options, rtol, atol, implicit=False)


def _implicit(prob, options, rtol, atol):
    return solve_fixed_adams(prob, options, rtol, atol, implicit=True)


# Register under the reference's names ('explicit_adams' = Adams–Bashforth,
# 'fixed_adams' = Adams–Bashforth–Moulton) and option allowlist; 'fuse' is
# refused in odeint.py.
from ..odeint import register_solver  # noqa: E402

_ADAMS_GRID_OPTIONS = {"max_order", "max_iters", "step_size", "num_steps",
                       "grid_constructor", "fuse"}
register_solver("explicit_adams", "custom", _explicit,
                allowed=_ADAMS_GRID_OPTIONS)
register_solver("fixed_adams", "custom", _implicit,
                allowed=_ADAMS_GRID_OPTIONS)
