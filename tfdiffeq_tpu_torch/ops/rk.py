"""Explicit Runge–Kutta stage evaluation and dense-output interpolation.

Counterpart of `tfdiffeq_tpu/ops/rk.py`, with the same arithmetic in the
same order, so that float64 solves agree with the reference step for step:
a stage state is y0 + dt * sum(c_i * k_i) with zero coefficients skipped,
and the dense output is the quartic through the 4th-order midpoint (or the
cubic Hermite when a tableau has no midpoint weights), stored as five
coefficient tensors for the scaled variable x = (t - t0) / dt:

    p(x) = (((A x + B) x + C) x + D) x + E

Kahan accumulation lives with the caller (solvers/adaptive.py), which
receives the exact weighted stage sum `delta` from `runge_kutta_step`.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .tableaus import ButcherTableau

Tensor = torch.Tensor


class RKStepResult(NamedTuple):
    y1: Tensor              # solution at t0 + dt
    f1: Tensor              # derivative at (t0 + dt, y1)
    y_err: Tensor           # embedded error estimate
    k: List[Tensor]         # stage derivatives
    n_evals: int            # fresh evaluations of func
    delta: Optional[Tensor] = None   # y1 - y0 as the weighted stage sum


def _weighted(coeffs, k_list) -> Optional[Tensor]:
    """sum(coeffs[i] * k[i]) over nonzero coefficients, or None."""
    acc = None
    for c, k in zip(coeffs, k_list):
        if c == 0.0:
            continue
        term = c * k
        acc = term if acc is None else acc + term
    return acc


def _combine(y0: Tensor, dt: Tensor, coeffs, k_list) -> Tensor:
    """y0 + dt * sum(coeffs[i] * k[i])."""
    acc = _weighted(coeffs, k_list)
    return y0 if acc is None else y0 + dt * acc


def _weighted_sum(dt: Tensor, coeffs, k_list) -> Tensor:
    """dt * sum(coeffs[i] * k[i])."""
    acc = _weighted(coeffs, k_list)
    return torch.zeros_like(k_list[0]) if acc is None else dt * acc


def runge_kutta_step(func: Callable[[Tensor, Tensor], Tensor], y0: Tensor,
                     f0: Tensor, t0: Tensor, dt: Tensor,
                     tableau: ButcherTableau) -> RKStepResult:
    """One explicit RK step from (t0, y0) with the derivative cache f0.

    t0 and dt are 0-d tensors in the time dtype; stage states are combined
    in the state dtype (dt is cast once, as the reference does).
    """
    dt_y = dt.to(y0.dtype)
    k_list = [f0]
    for i in range(1, tableau.stages):
        ti = t0 + dt * tableau.c[i]
        yi = _combine(y0, dt_y, tableau.a[i - 1], k_list)
        k_list.append(func(ti, yi))

    # FSAL tableaus: the last stage is f(t0 + dt, y1), free for the next step.
    delta = _weighted_sum(dt_y, tableau.b_sol, k_list)
    y1 = y0 + delta
    if tableau.fsal:
        f1 = k_list[-1]
        n_evals = tableau.stages - 1
    else:
        f1 = func(t0 + dt, y1)
        n_evals = tableau.stages
    if tableau.b_err:
        y_err = _weighted_sum(dt_y, tableau.b_err, k_list)
    else:
        y_err = torch.zeros_like(y0)
    return RKStepResult(y1, f1, y_err, k_list, n_evals, delta)


Coeffs = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]


def interp_fit_quartic(y0: Tensor, y1: Tensor, y_mid: Tensor, f0: Tensor,
                       f1: Tensor, dt: Tensor) -> Coeffs:
    """4th-order polynomial with p(0)=y0, p(1)=y1, p(1/2)=y_mid,
    p'(0)=dt*f0, p'(1)=dt*f1."""
    df0 = dt * f0
    df1 = dt * f1
    r1 = y1 - y0 - df0
    r2 = df1 - df0
    r3 = 16.0 * (y_mid - y0) - 8.0 * df0
    a = r3 + 2.0 * r2 - 8.0 * r1
    b = r2 - 2.0 * r1 - 2.0 * a
    c = r1 - a - b
    return a, b, c, df0, y0


def interp_fit_cubic_hermite(y0: Tensor, y1: Tensor, f0: Tensor, f1: Tensor,
                             dt: Tensor) -> Coeffs:
    """3rd-order Hermite interpolant (for tableaus without c_mid)."""
    df0 = dt * f0
    df1 = dt * f1
    b = 2.0 * (y0 - y1) + df0 + df1
    c = 3.0 * (y1 - y0) - 2.0 * df0 - df1
    return torch.zeros_like(y0), b, c, df0, y0


def interp_fit(tableau: ButcherTableau, y0: Tensor, y1: Tensor, f0: Tensor,
               f1: Tensor, k: List[Tensor], dt: Tensor) -> Coeffs:
    """Dense-output coefficients for one accepted step: the tableau's
    4th-order midpoint when it has one, else cubic Hermite."""
    if tableau.c_mid is not None:
        y_mid = _combine(y0, dt, tableau.c_mid, k)
        return interp_fit_quartic(y0, y1, y_mid, f0, f1, dt)
    return interp_fit_cubic_hermite(y0, y1, f0, f1, dt)


def interp_evaluate(coeffs: Coeffs, t0: Tensor, dt: Tensor, t: Tensor
                    ) -> Tensor:
    """Evaluate the dense output at time(s) t (0-d or [T], on the host).

    Returns [*state] or [T, *state] on the coefficients' device.
    """
    a, b, c, d, e = coeffs
    x = ((t - t0) / dt).to(device=a.device, dtype=a.dtype)
    if x.ndim:
        x = x.reshape(x.shape + (1,) * a.ndim)
    return (((a * x + b) * x + c) * x + d) * x + e


def kahan_add(y: Tensor, comp: Tensor, delta: Tensor) -> Tuple[Tensor, Tensor]:
    """Compensated y + delta: returns (y_new, comp_new). Removes the
    sqrt(n_steps)-ulp random walk of plain float32 accumulation."""
    adj = delta - comp
    y_new = y + adj
    return y_new, (y_new - y) - adj
