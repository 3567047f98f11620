"""Fixed-grid explicit solvers: euler, midpoint, rk4 and rk4_38.

Counterpart of `tfdiffeq_tpu/solvers/fixed_grid.py`. The reference walks
the grid with one `lax.scan`; here the walk is an eager host loop over the
grid intervals (times on the host, the state on its device), with the same
arithmetic in the same order:

- each step is `ops/rk.runge_kutta_step` from the chained derivative: the
  end derivative f1 = f(t0 + dt, y0 + delta) of one step is the next
  step's f0, so a step costs `stages` evaluations and a solve
  NFE = 1 + stages * (G - 1);
- the state accumulates Kahan-compensated;
- on the default grid (the requested times themselves) the step ends are
  the outputs; on a finer grid the outputs are cubic-Hermite interpolated
  onto the requested times from the node states and derivatives.

`step_fn(func, t0, dt, y) -> (y1, f0, n_evals[, delta])` replaces the
tableau step (the hook hypersolvers plug into): f0 = func(t0, y) feeds the
interpolation, and every evaluation the step makes is counted.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.rk import kahan_add, runge_kutta_step
from ..ops.tableaus import ButcherTableau
from .base import CanonicalProblem, SolveResult, SolverStats, hermite_interp_at

Tensor = torch.Tensor


def _tableau_step(tableau: ButcherTableau):
    """One fixed step y(t0) -> y(t0 + dt) of an explicit tableau.

    Returns (y1, f0, n_evals, delta, f1): f1 = func(t0 + dt, y1), which the
    non-FSAL step computes anyway, is chained into the next step's f0.
    """

    def step(func, t0, dt, y, f0=None):
        n = tableau.stages
        if f0 is None:
            f0 = func(t0, y)
            n += 1
        res = runge_kutta_step(func, y, f0, t0, dt, tableau)
        return res.y1, f0, n, res.delta, res.f1

    return step


def solve_fixed_grid(prob: CanonicalProblem, tableau: ButcherTableau,
                     grid: Optional[Tensor] = None,
                     step_fn: Optional[Callable] = None) -> SolveResult:
    """Integrate on a fixed grid (default: the requested times themselves).

    `grid`, if given, is an increasing host tensor in tau-space covering
    [tau[0], tau[-1]] (the reference's `grid_constructor` contract).
    """
    y0, tau = prob.y0, prob.tau
    T = tau.shape[0]
    grid_is_t = grid is None
    grid = tau if grid_is_t else torch.as_tensor(grid).to("cpu", tau.dtype)
    G = grid.shape[0]
    if G < 2:
        # Nothing to integrate: every output is y0.
        return SolveResult(y0[None].expand((T,) + tuple(y0.shape)).clone(),
                           SolverStats(0, 0, 0, 0))

    calls = [0]

    def func(t, y):
        calls[0] += 1
        return prob.func(t, y)

    chained = step_fn is None
    step = _tableau_step(tableau) if chained else step_fn
    y, comp = y0, torch.zeros_like(y0)
    f_prev = func(grid[0], y0) if chained else None
    ys, fs = [y0], []
    for i in range(G - 1):
        t0, t1 = grid[i], grid[i + 1]
        if chained:
            _, f0, _, delta, f1 = step(func, t0, t1 - t0, y, f_prev)
            # Kahan: long float32 grids otherwise accumulate a sqrt(n)-ulp
            # random walk in the state.
            y, comp = kahan_add(y, comp, delta)
            f_prev = f1
        else:
            out = step(func, t0, t1 - t0, y)
            y, f0 = out[0], out[1]
        ys.append(y)
        fs.append(f0)

    if grid_is_t:
        out = torch.stack(ys)
    else:
        if not chained:
            f_prev = func(grid[-1], y)
        out = hermite_interp_at(grid, torch.stack(ys),
                                torch.stack(fs + [f_prev]), tau)
        out[0] = y0
    return SolveResult(out, SolverStats(calls[0], G - 1, 0, 0))


def uniform_grid(start: Tensor, stop: Tensor, n: int) -> Tensor:
    """n + 1 equally spaced host times from start to stop in their dtype,
    computed as the reference's `jnp.linspace` computes them:
    start * (1 - i/n) + stop * (i/n), the last point exactly stop."""
    step = torch.arange(n, dtype=start.dtype) / torch.tensor(
        float(n), dtype=start.dtype)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def build_grid_from_options(t, options: dict,
                            prob: CanonicalProblem) -> Optional[Tensor]:
    """Resolve the reference's grid options to a host grid in tau-space.

    `grid_constructor(func, y0, t) -> grid` is called with the caller's own
    func, y0 and t; `step_size` gives ceil(span / h) uniform steps and
    `num_steps` n uniform steps (n + 1 points from tau[0] to tau[-1]).
    None: the default grid, t itself.
    """
    grid_constructor = options.get("grid_constructor")
    step_size = options.get("step_size")
    num_steps = options.get("num_steps")
    if grid_constructor is None and step_size is None and num_steps is None:
        return None
    tau = prob.tau
    if num_steps is not None:
        n = int(num_steps)
        if n < 1:
            raise ValueError(f"num_steps must be >= 1, got {n}")
        return uniform_grid(tau[0], tau[-1], n)
    if grid_constructor is not None:
        grid = torch.as_tensor(grid_constructor(prob.user_func, prob.user_y0,
                                                torch.as_tensor(t)))
        return prob.sign * grid.detach().to("cpu", prob.time_dtype)
    t_np = torch.as_tensor(t).detach().cpu().to(torch.float64).numpy()
    span = abs(float(t_np[-1] - t_np[0]))
    return uniform_grid(tau[0], tau[-1], steps_for_size(span, step_size))


def steps_for_size(span: float, step_size) -> int:
    """Steps of at most `step_size` over `span`: ceil(span / h), at least
    1 (the reference's rule, with its 1e-12 guard against a ceil that
    roundoff pushes up)."""
    return max(1, int(np.ceil(span / float(step_size) - 1e-12)))
